"""The committed spec vectors (`tests/spec/vectors`, the official
consensus-spec-tests layout) through the port's own `spec_test` runner and
state transition: `lodestar_tpu_torch.spec_test` walks the tree and
`RUNNERS` below, which mirror the JAX package's executors
(`tests/spec/test_stf_executors.py`), run each case on the port's modules.

Every runner and handler in the tree is claimed, or `run_spec_tests`
raises (`test_the_tree_is_exhaustive`); no runner is skipped. The cases
are split between this file (bls, ssz_static, shuffling, rewards,
epoch_processing, fork_choice) and `test_torch_spec_vectors_blocks.py`
(operations, sanity, finality) so that xdist's `loadfile` runs the halves
on two workers; together they run every case of the tree. The tolerance is the vectors': equal bytes,
roots and verdicts. The port's HTR device is the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from lodestar_tpu_torch import params
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.spec_test import SkipOpts, SpecCase, iterate_spec_tests, run_spec_tests
from lodestar_tpu_torch.state_transition import (
    EpochContext,
    process_slots,
    state_transition,
)
from lodestar_tpu_torch.state_transition import block as B
from lodestar_tpu_torch.state_transition import epoch as E
from lodestar_tpu_torch.types import ssz_types

VECTORS = os.path.join(os.path.dirname(__file__), "spec", "vectors", "tests")
SKIP = SkipOpts()  # no runner is skipped
BLOCK_RUNNERS = ("operations", "sanity", "finality")  # the other file's half


@pytest.fixture(scope="module", autouse=True)
def minimal_cpu():
    from lodestar_tpu_torch.ssz import device_htr as dh

    prev = params.active_preset()
    params.set_active_preset("minimal")
    prev_mode = dh.configure_device_htr(mode="on", device="cpu")
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    dh.configure_device_htr(mode=prev_mode, device="cuda")
    params.set_active_preset(prev)


def _b(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr[2:] if hexstr.startswith("0x") else hexstr)


def _t():
    return ssz_types()


def _load_state(case, stem):
    return getattr(_t(), case.fork).BeaconState.deserialize(case.load(stem))


def _expect_post(case, post_state) -> None:
    typ = getattr(_t(), case.fork).BeaconState
    assert typ.serialize(post_state) == case.load("post"), f"{case.test_id}: post-state bytes"


def _expect_reject_or_post(case, fn) -> None:
    """Valid cases (with a post) apply; invalid cases (without) raise."""
    has_post = "post.ssz" in case.files()
    try:
        out = fn()
    except Exception:
        assert not has_post, f"{case.test_id}: valid case raised"
        return
    assert has_post, f"{case.test_id}: invalid case did not raise"
    _expect_post(case, out)


# --- bls ----------------------------------------------------------------------


def _bls_check(fn, args):
    def run(case):
        data = case.load("data")
        assert fn(*args(data["input"])) is data["output"], case.test_id

    return run


def _bls_aggregate(case):
    data = case.load("data")
    sigs = [_b(s) for s in data["input"]]
    if data["output"] is None:
        with pytest.raises(Exception):
            api.aggregate_signatures(sigs)
        return
    assert api.aggregate_signatures(sigs) == _b(data["output"])


def _bls_sign(case):
    data = case.load("data")
    sk = api.SecretKey(int.from_bytes(_b(data["input"]["privkey"]), "big"))
    assert api.sign(sk, _b(data["input"]["message"])) == _b(data["output"])


def _bls_batch_verify(case):
    from lodestar_tpu_torch.models.batch_verify import verify_signature_sets_device

    i = case.load("data")["input"]
    sets = [api.SignatureSet(pubkey=_b(p), message=_b(m), signature=_b(s))
            for p, m, s in zip(i["pubkeys"], i["messages"], i["signatures"])]
    want = case.load("data")["output"]
    assert api.verify_signature_sets(sets) is want, f"{case.test_id} (oracle)"
    assert verify_signature_sets_device(sets, device="cpu") is want, f"{case.test_id} (device)"


def _pks(i):
    return [_b(p) for p in i["pubkeys"]]


BLS = {
    "sign": _bls_sign,
    "verify": _bls_check(api.verify, lambda i: (_b(i["pubkey"]), _b(i["message"]),
                                                _b(i["signature"]))),
    "aggregate": _bls_aggregate,
    "fast_aggregate_verify": _bls_check(api.fast_aggregate_verify, lambda i: (
        _pks(i), _b(i["message"]), _b(i["signature"]))),
    "eth_fast_aggregate_verify": _bls_check(api.eth_fast_aggregate_verify, lambda i: (
        _pks(i), _b(i["message"]), _b(i["signature"]))),
    "aggregate_verify": _bls_check(api.aggregate_verify, lambda i: (
        _pks(i), [_b(m) for m in i["messages"]], _b(i["signature"]))),
    "batch_verify": _bls_batch_verify,
}


# --- state transition ---------------------------------------------------------


def _operation(op_stem, type_name, apply_fn):
    def run(case):
        pre = _load_state(case, "pre")
        op = getattr(_t(), type_name).deserialize(case.load(op_stem))
        _expect_reject_or_post(case, lambda: (apply_fn(pre, op), pre)[1])

    return run


def _ctx(state):
    return EpochContext(state)


def _block_header(case):
    pre = _load_state(case, "pre")
    block = _t().phase0.BeaconBlock.deserialize(case.load("block"))
    _expect_reject_or_post(case, lambda: (B.process_block_header(pre, block, _ctx(pre)), pre)[1])


OPERATIONS = {
    "attestation": _operation("attestation", "Attestation", lambda s, op: B.process_attestation(
        s, op, _ctx(s), verify_signatures=True)),
    "proposer_slashing": _operation("proposer_slashing", "ProposerSlashing",
                                    lambda s, op: B.process_proposer_slashing(
                                        s, op, _ctx(s), verify_signatures=True)),
    "attester_slashing": _operation("attester_slashing", "AttesterSlashing",
                                    lambda s, op: B.process_attester_slashing(
                                        s, op, _ctx(s), verify_signatures=True)),
    "block_header": _block_header,
    "deposit": _operation("deposit", "Deposit", lambda s, op: B.process_deposit(s, op, _ctx(s))),
    "voluntary_exit": _operation("voluntary_exit", "SignedVoluntaryExit",
                                 lambda s, op: B.process_voluntary_exit(
                                     s, op, _ctx(s), verify_signatures=True)),
}

# the spec's phase0 process_epoch order (official run_epoch_processing_with:
# every step up to and including the handler's)
EPOCH_PIPELINE = (
    "justification_and_finalization", "rewards_and_penalties", "registry_updates", "slashings",
    "eth1_data_reset", "effective_balance_updates", "slashings_reset", "randao_mixes_reset",
    "historical_roots_update", "participation_record_updates",
)


def apply_epoch_step(state, handler: str) -> None:
    ep = E.before_process_epoch(state, EpochContext(state))
    for name in EPOCH_PIPELINE:
        getattr(E, f"process_{name}")(state, ep)
        if name == handler:
            return
    raise KeyError(handler)


def _epoch_handler(name):
    def run(case):
        pre = _load_state(case, "pre")
        apply_epoch_step(pre, name)
        _expect_post(case, pre)

    return run


def _sanity_slots(case):
    pre = _load_state(case, "pre")
    process_slots(pre, int(pre.slot) + int(case.load("slots")))
    _expect_post(case, pre)


def _blocks(case):
    def run():
        state = _load_state(case, "pre")
        signed_type = getattr(_t(), case.fork).SignedBeaconBlock
        for i in range(int(case.load("meta")["blocks_count"])):
            state = state_transition(state, signed_type.deserialize(case.load(f"blocks_{i}")),
                                     verify_signatures=True)
        return state

    _expect_reject_or_post(case, run)


def _shuffling(case):
    from lodestar_tpu_torch.state_transition.shuffle import compute_shuffled_index, shuffle_list

    m = case.load("mapping")
    seed, count = _b(m["seed"]), int(m["count"])
    mapping = [int(x) for x in m["mapping"]]
    assert [compute_shuffled_index(i, count, seed) for i in range(count)] == mapping
    inverse = [0] * count
    for i, j in enumerate(mapping):
        inverse[j] = i
    assert list(map(int, shuffle_list(np.arange(count), seed))) == inverse


def _rewards(case):
    pre = _load_state(case, "pre")
    want_rewards = [0] * len(pre.validators)
    want_penalties = [0] * len(pre.validators)
    for comp in case.load("deltas").values():
        for i, r in enumerate(comp["rewards"]):
            want_rewards[i] += int(r)
        for i, p in enumerate(comp["penalties"]):
            want_penalties[i] += int(p)
    rewards, penalties = E.get_attestation_deltas(pre, E.before_process_epoch(pre, _ctx(pre)))
    assert list(map(int, rewards)) == want_rewards
    assert list(map(int, penalties)) == want_penalties


def _ssz_static(case):
    t = _t()
    forked = case.handler in ("BeaconBlock", "BeaconState")
    typ = getattr(t.phase0 if forked else t, case.handler)
    data = case.load("serialized")
    value = typ.deserialize(data)
    assert typ.hash_tree_root(value) == _b(case.load("roots")["root"]), case.test_id
    assert typ.serialize(value) == data, case.test_id


def _ssz_static_handlers():
    root = os.path.join(VECTORS, "minimal", "phase0", "ssz_static")
    return {name: _ssz_static for name in sorted(os.listdir(root))}


def _fork_choice_get_head(case):
    """The port's ForkChoice from the case's anchor and balances, then its
    steps (tick, block, attestation, head check), as the JAX package's
    executor (`tests/spec/test_stf_executors.py` `_fork_choice_handler`)."""
    from lodestar_tpu_torch.fork_choice import ForkChoice
    from lodestar_tpu_torch.fork_choice.proto_array import HEX_ZERO_HASH, ProtoBlock

    anchor = case.load("anchor")
    balances = np.asarray([int(b) for b in case.load("balances")], dtype=np.int64)

    def proto(b):
        return ProtoBlock(
            slot=int(b["slot"]),
            block_root=b["root"],
            parent_root=b["parent"],
            state_root=HEX_ZERO_HASH,
            target_root=b["root"],
            justified_epoch=0,
            justified_root=anchor["root"],
            finalized_epoch=0,
            finalized_root=anchor["root"],
        )

    fc = ForkChoice.from_anchor(proto(anchor), current_slot=0, justified_balances=balances,
                                slots_per_epoch=params.active_preset().SLOTS_PER_EPOCH)
    checks = 0
    for step in case.load("steps"):
        if "tick" in step:
            fc.on_tick(int(step["tick"]))
        elif "block" in step:
            fc.on_block(proto(step["block"]))
        elif "attestation" in step:
            a = step["attestation"]
            fc.on_attestation(
                [int(i) for i in a["indices"]], a["root"], int(a["target_epoch"]), int(a["slot"])
            )
        elif "checks" in step:
            head = fc.update_head()
            assert head == step["checks"]["head"], (
                f"{case.test_id}: head {head} != {step['checks']['head']}"
            )
            checks += 1
    assert checks, f"{case.test_id}: no head check"


RUNNERS = {
    "bls": BLS,
    "operations": OPERATIONS,
    "epoch_processing": {name: _epoch_handler(name) for name in EPOCH_PIPELINE},
    "sanity": {"slots": _sanity_slots, "blocks": _blocks},
    "finality": {"finality": _blocks},
    "shuffling": {"core": _shuffling},
    "rewards": {"basic": _rewards},
    "ssz_static": _ssz_static_handlers(),
    "fork_choice": {"get_head": _fork_choice_get_head},
}

CASES = iterate_spec_tests(VECTORS, SKIP)
HERE = [c for c in CASES if c.runner not in BLOCK_RUNNERS]


def run_case(case: SpecCase) -> None:
    RUNNERS[case.runner][case.handler](case)


@pytest.mark.parametrize("case", HERE, ids=[c.test_id for c in HERE])
def test_spec_case(case):
    run_case(case)


def test_the_tree_is_exhaustive():
    """run_spec_tests claims every runner and handler of the tree (no
    runner skipped), the two files' halves cover every case it walks, and
    an unknown runner or handler is an error, not a skip."""
    walked = []
    claimed = {r: {h: walked.append for h in hs} for r, hs in RUNNERS.items()}
    n = run_spec_tests(VECTORS, claimed, SKIP)
    assert n == len(walked) == len(CASES) == 106
    assert {c.runner for c in CASES} == set(RUNNERS)
    assert [c.test_id for c in walked] == [c.test_id for c in CASES]
    rest = [c for c in CASES if c.runner in BLOCK_RUNNERS]
    assert len(HERE) + len(rest) == len(CASES) and HERE and rest
    assert len(iterate_spec_tests(VECTORS)) == len(CASES)
    assert [c.test_id for c in CASES if c.runner == "fork_choice"]
    with pytest.raises(KeyError, match="unknown spec-test runner"):
        run_spec_tests(VECTORS, {r: hs for r, hs in claimed.items() if r != "rewards"}, SKIP)
    with pytest.raises(KeyError, match="unknown spec-test handler"):
        run_spec_tests(VECTORS, {**claimed, "sanity": {"slots": walked.append}}, SKIP)
    with pytest.raises(KeyError, match="unknown spec-test runner"):
        run_spec_tests(VECTORS, {r: hs for r, hs in claimed.items() if r != "fork_choice"})


def test_spec_case_loads_like_the_jax_runner():
    """The port's SpecCase loads each file as the JAX package's does."""
    from lodestar_tpu.spec_test import SkipOpts as JSkipOpts
    from lodestar_tpu.spec_test import iterate_spec_tests as j_iterate

    jcases = j_iterate(VECTORS, JSkipOpts())
    assert [c.test_id for c in jcases] == [c.test_id for c in CASES]
    for jc, c in zip(jcases[::9], CASES[::9]):
        assert c.files() == jc.files()
        for name in c.files():
            stem = name.rsplit(".", 1)[0]
            assert c.load(stem) == jc.load(stem), f"{c.test_id}: {name}"
