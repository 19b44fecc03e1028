"""The port's fork choice (`lodestar_tpu_torch.fork_choice` and its
`proto_array`) against the JAX package's.

Tolerance: none. Each scenario of the JAX package's
`tests/fork_choice/test_proto_array.py` runs through both packages, with the
JAX test's own assertions, and every observation of the two runs must be
equal: heads, every proto node's fields (weights, best child and best
descendant included), deltas, pruned nodes and the error class of a reject.
`compute_deltas` is also held against the JAX package's on seeded random
votes, balances, equivocations and vote moves.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")
SPE = 8  # slots per epoch for these scenarios


def fc_module(root: str):
    return importlib.import_module(f"{root}.fork_choice")


def _root(i: int) -> str:
    # offset by 1: the all-zero root is the genesis alias, never a real block
    return "0x" + (i + 1).to_bytes(32, "big").hex()


def _block(m, i: int, parent: int | None, slot: int | None = None, je: int = 0, fe: int = 0):
    return m.ProtoBlock(
        slot=slot if slot is not None else i,
        block_root=_root(i),
        parent_root=_root(parent) if parent is not None else _root(10**9),
        state_root=_root(i),
        target_root=_root(i),
        justified_epoch=je,
        justified_root=_root(0),
        finalized_epoch=fe,
        finalized_root=_root(0),
        unrealized_justified_epoch=je,
        unrealized_finalized_epoch=fe,
    )


def node_fields(node) -> tuple:
    """Every field of a proto node, enums by value."""
    return tuple((k, v.value if hasattr(v, "value") else v) for k, v in sorted(vars(node).items()))


def nodes(arr) -> list:
    return [node_fields(n) for n in arr.nodes] + [sorted(arr.indices.items())]


def _new_array(m, genesis: int = 0):
    return m.ProtoArray.initialize(_block(m, genesis, None, slot=0), current_slot=0,
                                   slots_per_epoch=SPE)


def _score(m, arr, deltas, current_slot, justified_epoch=0, justified=0):
    arr.apply_score_changes(
        deltas=deltas, proposer_boost=None, justified_epoch=justified_epoch,
        justified_root=_root(justified), finalized_epoch=0, finalized_root=_root(0),
        current_slot=current_slot,
    )


# -- proto array --------------------------------------------------------------


def sc_linear_chain_head_is_tip(m, obs):
    arr = _new_array(m)
    for i in range(1, 5):
        arr.on_block(_block(m, i, i - 1), current_slot=i)
    _score(m, arr, [0] * 5, 5)
    head = arr.find_head(_root(0), current_slot=5)
    assert head == _root(4)
    obs += [head, nodes(arr)]


def sc_votes_flip_between_forks(m, obs):
    # 0 <- 1 <- 2 (fork a)
    #        <- 3 (fork b)
    arr = _new_array(m)
    arr.on_block(_block(m, 1, 0), 1)
    arr.on_block(_block(m, 2, 1), 2)
    arr.on_block(_block(m, 3, 1, slot=2), 2)

    def score(d2, d3):
        deltas = [0] * len(arr.indices)
        deltas[arr.indices[_root(2)]] = d2
        deltas[arr.indices[_root(3)]] = d3
        _score(m, arr, deltas, 3)

    score(10, 5)
    obs.append(arr.find_head(_root(0), 3))
    assert obs[-1] == _root(2)
    score(0, 10)  # fork b overtakes: 10 vs 15
    obs.append(arr.find_head(_root(0), 3))
    assert obs[-1] == _root(3)
    obs.append(nodes(arr))


def sc_tie_breaks_by_root_ordering(m, obs):
    arr = _new_array(m)
    arr.on_block(_block(m, 1, 0), 1)
    arr.on_block(_block(m, 2, 0, slot=1), 1)
    _score(m, arr, [0, 0, 0], 2)
    # equal weight: higher root wins (reference protoArray.ts:668)
    obs.append(arr.find_head(_root(0), 2))
    assert obs[-1] == _root(2)
    obs.append(nodes(arr))


def sc_ffg_viability_filters_wrong_justified_epoch(m, obs):
    arr = _new_array(m)
    viable = _block(m, 1, 0, slot=2 * SPE + 1, je=1)
    arr.on_block(viable, 2 * SPE + 1)
    stale = _block(m, 2, 0, slot=2 * SPE + 1, je=0)
    stale.unrealized_justified_epoch = 0
    arr.on_block(stale, 2 * SPE + 1)
    _score(m, arr, [0, 1, 100], 2 * SPE + 2, justified_epoch=1)
    obs.append(arr.find_head(_root(0), 2 * SPE + 2))
    assert obs[-1] == _root(1)
    obs.append(nodes(arr))


def sc_invalid_execution_zeroes_weight_and_filters(m, obs):
    arr = _new_array(m)
    b1 = _block(m, 1, 0)
    b1.execution_status = m.ExecutionStatus.SYNCING
    b1.execution_payload_block_hash = "0xee"
    arr.on_block(b1, 1)
    arr.on_block(_block(m, 2, 0, slot=1), 1)
    _score(m, arr, [0, 100, 1], 2)
    obs.append(arr.find_head(_root(0), 2))
    assert obs[-1] == _root(1)
    arr.invalidate(_root(1), 2)
    _score(m, arr, [0, 0, 0], 2)
    node = arr.get_block(_root(1))
    assert node is not None and node.weight == 0
    obs.append(arr.find_head(_root(0), 2))
    assert obs[-1] == _root(2)
    obs.append(nodes(arr))


def sc_prune_reindexes(m, obs):
    arr = _new_array(m)
    for i in range(1, 6):
        arr.on_block(_block(m, i, i - 1), i)
    removed = arr.maybe_prune(_root(3))
    assert [n.block_root for n in removed] == [_root(0), _root(1), _root(2)]
    assert arr.indices[_root(3)] == 0
    obs.append([node_fields(n) for n in removed])
    _score(m, arr, [0, 0, 0], 6, justified=3)
    obs.append(arr.find_head(_root(3), 6))
    assert obs[-1] == _root(5)
    # parent links below finalization cleared
    assert arr.get_block(_root(3)).parent is None
    obs.append(nodes(arr))


def sc_on_block_rejects_invalid_execution(m, obs):
    arr = _new_array(m)
    bad = _block(m, 1, 0)
    bad.execution_status = m.ExecutionStatus.INVALID
    with pytest.raises(m.ProtoArrayError) as ei:
        arr.on_block(bad, 1)
    obs += [type(ei.value).__name__, str(ei.value), nodes(arr)]


# -- compute_deltas -----------------------------------------------------------


def _fc_pair(m):
    arr = _new_array(m)
    arr.on_block(_block(m, 1, 0), 1)
    arr.on_block(_block(m, 2, 0, slot=1), 1)
    return arr


def sc_compute_deltas_applies_new_votes(m, obs):
    arr = _fc_pair(m)
    votes = m.VoteTracker()
    for vi in range(4):
        votes.process_attestation(vi, _root(1), 1)
    for vi in range(4, 10):
        votes.process_attestation(vi, _root(2), 1)
    bal = np.full(10, 7, dtype=np.int64)
    deltas = m.compute_deltas(arr.indices, votes, bal, bal)
    assert deltas[arr.indices[_root(1)]] == 4 * 7
    assert deltas[arr.indices[_root(2)]] == 6 * 7
    deltas2 = m.compute_deltas(arr.indices, votes, bal, bal)  # no changes -> all zero
    assert all(d == 0 for d in deltas2)
    obs += [deltas, deltas2, votes.current.tolist()]


def sc_compute_deltas_vote_moves(m, obs):
    arr = _fc_pair(m)
    votes = m.VoteTracker()
    votes.process_attestation(0, _root(1), 1)
    bal = np.array([5], dtype=np.int64)
    obs.append(m.compute_deltas(arr.indices, votes, bal, bal))
    votes.process_attestation(0, _root(2), 2)
    deltas = m.compute_deltas(arr.indices, votes, bal, bal)
    assert deltas[arr.indices[_root(1)]] == -5
    assert deltas[arr.indices[_root(2)]] == 5
    obs.append(deltas)


def sc_compute_deltas_balance_change(m, obs):
    arr = _fc_pair(m)
    votes = m.VoteTracker()
    votes.process_attestation(0, _root(1), 1)
    old = np.array([5], dtype=np.int64)
    obs.append(m.compute_deltas(arr.indices, votes, old, old))
    new = np.array([9], dtype=np.int64)
    deltas = m.compute_deltas(arr.indices, votes, old, new)
    assert deltas[arr.indices[_root(1)]] == 4  # -5 +9 on same node
    obs.append(deltas)


def sc_compute_deltas_equivocation_discounts_once(m, obs):
    arr = _fc_pair(m)
    votes = m.VoteTracker()
    votes.process_attestation(0, _root(1), 1)
    bal = np.array([5], dtype=np.int64)
    obs.append(m.compute_deltas(arr.indices, votes, bal, bal))
    votes.mark_equivocation(0)
    deltas = m.compute_deltas(arr.indices, votes, bal, bal)
    assert deltas[arr.indices[_root(1)]] == -5
    deltas2 = m.compute_deltas(arr.indices, votes, bal, bal)  # only once
    assert all(d == 0 for d in deltas2)
    votes.process_attestation(0, _root(2), 3)  # the equivocator is ignored
    deltas3 = m.compute_deltas(arr.indices, votes, bal, bal)
    assert all(d == 0 for d in deltas3)
    obs += [deltas, deltas2, deltas3]


def sc_compute_deltas_old_vote_ignored(m, obs):
    arr = _fc_pair(m)
    votes = m.VoteTracker()
    votes.process_attestation(0, _root(2), 5)
    votes.process_attestation(0, _root(1), 4)  # older target epoch: ignored
    bal = np.array([3], dtype=np.int64)
    deltas = m.compute_deltas(arr.indices, votes, bal, bal)
    assert deltas[arr.indices[_root(2)]] == 3
    assert deltas[arr.indices[_root(1)]] == 0
    obs.append(deltas)


# -- ForkChoice wrapper -------------------------------------------------------


def _forkchoice(m, n_validators: int = 10, balance: int = 32):
    return m.ForkChoice.from_anchor(
        _block(m, 0, None, slot=0),
        current_slot=1,
        justified_balances=np.full(n_validators, balance, dtype=np.int64),
        slots_per_epoch=SPE,
    )


def sc_forkchoice_votes_drive_head(m, obs):
    fc = _forkchoice(m)
    fc.on_block(_block(m, 1, 0))
    fc.on_block(_block(m, 2, 0, slot=1))
    fc.on_attestation([0, 1, 2], _root(1), 1, slot=0)
    fc.on_attestation([3, 4, 5, 6], _root(2), 1, slot=0)
    obs.append(fc.update_head())
    assert obs[-1] == _root(2)
    # supermajority flips to fork 1
    fc.on_attestation([3, 4, 5, 6, 7, 8, 9], _root(1), 2, slot=0)
    obs.append(fc.update_head())
    assert obs[-1] == _root(1)
    obs.append(nodes(fc.proto_array))


def sc_forkchoice_future_attestations_queue_until_tick(m, obs):
    fc = _forkchoice(m)
    fc.on_block(_block(m, 1, 0))
    fc.on_block(_block(m, 2, 0, slot=1))
    fc.on_attestation([0], _root(1), 1, slot=0)
    fc.on_attestation([1, 2, 3], _root(2), 1, slot=5)  # future slot: queued
    obs.append(fc.update_head())
    assert obs[-1] == _root(1)
    obs.append([(a.slot, a.attesting_indices, a.block_root) for a in fc.queued_attestations])
    fc.on_tick(6)
    obs.append(fc.update_head())
    assert obs[-1] == _root(2)
    obs.append(nodes(fc.proto_array))


def sc_forkchoice_proposer_boost(m, obs):
    # committee weight = 80*32/8 = 320; boost = 128 > one attester's 32
    fc = _forkchoice(m, n_validators=80, balance=32)
    fc.on_block(_block(m, 1, 0))
    fc.on_attestation([0], _root(1), 1, slot=0)
    obs.append(fc.update_head())
    assert obs[-1] == _root(1)
    # timely block on a competing fork gets boosted above one attester
    fc.on_tick(2)
    fc.on_block(_block(m, 2, 0, slot=2), is_timely=True)
    obs += [fc.update_head(), fc.proposer_boost_root, nodes(fc.proto_array)]
    assert obs[-3] == _root(2)
    # boost expires at the next slot; the vote still stands
    fc.on_tick(3)
    obs.append(fc.update_head())
    assert obs[-1] == _root(1)
    obs.append(nodes(fc.proto_array))


def sc_forkchoice_finalization_prunes(m, obs):
    fc = _forkchoice(m)
    # realistic slots: the finalized block sits at the epoch-1 boundary
    # (slot 8) and its descendants come after it
    for i, slot in [(1, 4), (2, SPE), (3, SPE + 4), (4, 2 * SPE)]:
        fc.current_slot = max(fc.current_slot, slot + 1)
        fc.on_block(_block(m, i, i - 1, slot=slot))
    obs.append([n.block_root for n in fc.get_all_ancestor_blocks(_root(4))])
    fc.finalized = m.Checkpoint(1, _root(2))
    removed = fc.prune()
    assert [n.block_root for n in removed] == [_root(0), _root(1)]
    fc.justified = m.Checkpoint(0, _root(2))
    obs += [[node_fields(n) for n in removed], fc.update_head(), nodes(fc.proto_array)]
    assert obs[-2] == _root(4)


def sc_forkchoice_rejects_unknown_parent_and_backwards_clock(m, obs):
    fc = _forkchoice(m)
    for fn, args in ((fc.on_block, (_block(m, 5, 4),)), (fc.on_tick, (0,))):
        with pytest.raises(m.ForkChoiceError) as ei:
            fn(*args)
        obs.append((type(ei.value).__name__, str(ei.value)))


def sc_forkchoice_attester_slashing_discounts(m, obs):
    fc = _forkchoice(m)
    fc.on_block(_block(m, 1, 0))
    fc.on_block(_block(m, 2, 0, slot=1))
    fc.on_attestation([0, 1, 2], _root(1), 1, slot=0)
    fc.on_attestation([3, 4], _root(2), 1, slot=0)
    obs.append(fc.update_head())
    fc.on_attester_slashing([0, 1])
    fc.on_attestation([0, 1], _root(2), 2, slot=0)  # equivocators' new votes ignored
    obs += [fc.update_head(), nodes(fc.proto_array), fc.votes.equivocating.tolist()]
    assert obs[-3] == _root(2)
    obs.append([n.block_root for n in fc.get_all_non_ancestor_blocks(_root(2))])


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_fork_choice_scenario_agrees(case):
    runs = []
    for root in ROOTS:
        obs = []
        SCENARIOS[case](fc_module(root), obs)
        runs.append(obs)
    assert runs[1] == runs[0]


@pytest.mark.parametrize("seed", range(6))
def test_compute_deltas_agrees_on_random_votes(seed):
    """Seeded random votes over a random tree, balance changes, equivocations
    and vote moves, three rounds of `compute_deltas` through both packages:
    equal deltas and vote state each round."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(2, 40))
    n_val = int(rng.integers(1, 500))
    parents = [None] + [int(rng.integers(0, i)) for i in range(1, n_blocks)]
    rounds = []
    for _ in range(3):
        votes = [(int(v), int(rng.integers(-1, n_blocks + 2)), int(rng.integers(0, 6)))
                 for v in rng.integers(0, n_val, size=int(rng.integers(0, 3 * n_val)))]
        rounds.append({
            "votes": votes,
            "equiv": [int(v) for v in rng.integers(0, n_val, size=int(rng.integers(0, 4)))],
            "old": rng.integers(0, 64, size=int(rng.integers(0, n_val + 5))),
            "new": rng.integers(0, 64, size=int(rng.integers(0, n_val + 5))),
        })
    seen = []
    for root in ROOTS:
        m = fc_module(root)
        arr = _new_array(m)
        for i in range(1, n_blocks):
            arr.on_block(_block(m, i, parents[i]), i)
        tracker = m.VoteTracker()
        out = []
        for r in rounds:
            for v, b, epoch in r["votes"]:
                # b == -1 votes the zero hash, b >= n_blocks an unknown root
                tracker.process_attestation(v, m.HEX_ZERO_HASH if b < 0 else _root(b), epoch)
            for v in r["equiv"]:
                tracker.mark_equivocation(v)
            deltas = m.compute_deltas(arr.indices, tracker, r["old"].astype(np.int64),
                                      r["new"].astype(np.int64))
            out.append((deltas, tracker.current.tolist(), tracker.next.tolist(),
                        tracker.next_epoch.tolist(), tracker.equivocating.tolist()))
        seen.append(out)
    assert seen[1] == seen[0]
