"""The port's consensus state transition (`lodestar_tpu_torch.state_transition`
and its `util`, `shuffle`, `cache`, `epoch`, `block`, `genesis` and
`signature_sets`) against the JAX package's, phase0, minimal preset.

Tolerance: none. Each scenario of the JAX package's
`tests/state_transition/test_{state_transition,shuffle,signature_sets}.py`
runs through both packages (`Pkg`), and the two runs' observations must be
equal: every state as its SSZ bytes, every block built as its bytes, every
reject as its exception class and message, every signature set field for
field. Both runs start from the JAX package's genesis carried into the
port as SSZ bytes; the port's own genesis is compared with it bytes-equal.
Also: the committed operation vectors through both packages, and a block
made by the JAX package imported by the port from its bytes. (The block's
sets through the port's device verify are in
`test_torch_state_transition_forks.py`, which has the time to spare for
the JAX program's compile.)

The port's HTR device is the CPU (`configure_device_htr(mode="on",
device="cpu")`): the state roots go through its tracker; one scenario sets
`DEVICE_MIN_FLUSH_PAIRS = 1` so that every tree level is launched.
"""

from __future__ import annotations

import functools
import importlib
import os

import numpy as np
import pytest
import torch

N_VALIDATORS = 64
ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")
VECTORS = os.path.join(os.path.dirname(__file__), "spec", "vectors", "tests")

_MODULES = {
    "params": "params", "ssz": "ssz", "types": "types", "config": "config",
    "bls": "crypto.bls.api", "st": "state_transition", "util": "state_transition.util",
    "shuffle": "state_transition.shuffle", "cache": "state_transition.cache",
    "epoch": "state_transition.epoch", "block": "state_transition.block",
    "genesis": "state_transition.genesis", "sets": "state_transition.signature_sets",
    "altair": "state_transition.altair", "bellatrix": "state_transition.bellatrix",
    "capella": "state_transition.capella", "deneb": "state_transition.deneb",
}


class Pkg:
    """One package's state-transition modules under the JAX package's names,
    with the minimal preset and its SSZ types."""

    def __init__(self, root: str):
        self.root = root
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))
        self.p = self.params.MINIMAL
        self.t = self.types.ssz_types(self.p)

    def state(self, data: bytes, fork: str = "phase0"):
        return getattr(self.t, fork).BeaconState.deserialize(data)


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> Pkg:
    return Pkg(root)


class Obs:
    """What one run of a scenario saw, in order."""

    def __init__(self):
        self.seen = []

    def add(self, label, value):
        if hasattr(value, "type") and hasattr(value.type, "serialize"):
            value = (value.type.name, value.type.serialize(value))
        elif isinstance(value, np.ndarray):
            value = value.tolist()
        elif isinstance(value, list) and value and hasattr(value[0], "signature"):
            value = [(bytes(s.pubkey), bytes(s.message), bytes(s.signature)) for s in value]
        self.seen.append((label, value))
        return value

    def call(self, label, fn, *args, **kwargs):
        """fn's result, or None with its exception's class and message noted."""
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the reject is the observation
            self.seen.append((label, ("raises", type(e).__name__, str(e))))
            return None
        self.seen.append((label, "ok"))
        return out


def both(scenario, *args):
    """Run `scenario(pkg, obs, *args)` through the JAX package, then the port;
    their observations must be equal. Returns the port's."""
    runs = []
    for root in ROOTS:
        obs = Obs()
        scenario(pkg(root), obs, *args)
        runs.append(obs.seen)
    jax_seen, port_seen = runs
    assert [label for label, _ in port_seen] == [label for label, _ in jax_seen]
    for (label, got), (_, want) in zip(port_seen, jax_seen):
        assert got == want, f"{scenario.__name__}: {label} differs"
    return port_seen


def observed(seen, label):
    return [v for k, v in seen if k == label]


@pytest.fixture(scope="module", autouse=True)
def minimal_cpu():
    """Both packages on the minimal preset; the port's HTR device on the CPU."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    prev = [pkg(r).params.active_preset() for r in ROOTS]
    for r in ROOTS:
        pkg(r).params.set_active_preset("minimal")
    prev_mode = dh.configure_device_htr(mode="on", device="cpu")
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev_threads)
    dh.configure_device_htr(mode=prev_mode, device="cuda")
    for r, p in zip(ROOTS, prev):
        pkg(r).params.set_active_preset(p)


@functools.lru_cache(maxsize=None)
def genesis_bytes(n: int, fork_version: bytes = b"\x00\x00\x00\x00") -> bytes:
    """The JAX package's interop genesis, as SSZ bytes."""
    j = pkg("lodestar_tpu")
    g = j.genesis.create_interop_genesis_state(n, p=j.p, genesis_fork_version=fork_version)
    return g.type.serialize(g)


@functools.lru_cache(maxsize=None)
def secret_keys(root: str, n: int):
    return pkg(root).genesis.interop_secret_keys(n)


# --- block builders, as the JAX package's tests build them ------------------


def sign_block(pk, state, block, sk, fork="phase0"):
    domain = pk.util.get_domain(state, pk.params.DOMAIN_BEACON_PROPOSER)
    root = pk.util.compute_signing_root(getattr(pk.t, fork).BeaconBlock, block, domain)
    return pk.bls.sign(sk, root)


def empty_block_at(pk, state, slot, sks, *, cfg=None, fork="phase0", fill_state_root=True):
    """A valid signed empty block for `slot` on top of `state` (not mutated)."""
    p, t = pk.p, pk.t
    work = state.copy()
    ctx = pk.st.process_slots(work, slot, p, cfg)
    proposer = ctx.get_beacon_proposer(slot)
    ns = getattr(t, fork)
    block = ns.BeaconBlock.default()
    block.slot = slot
    block.proposer_index = proposer
    block.parent_root = t.BeaconBlockHeader.hash_tree_root(work.latest_block_header)
    domain = pk.util.get_domain(work, pk.params.DOMAIN_RANDAO)
    block.body.randao_reveal = pk.bls.sign(sks[proposer], pk.util.compute_signing_root(
        pk.ssz.uint64, slot // p.SLOTS_PER_EPOCH, domain))
    block.body.eth1_data = work.eth1_data
    if fill_state_root:
        post = work.copy()
        pk.st.process_block(post, block, pk.cache.EpochContext(post, p), verify_signatures=False,
                            cfg=cfg)
        block.state_root = post.type.hash_tree_root(post)
    signed = ns.SignedBeaconBlock.default()
    signed.message = block
    signed.signature = sign_block(pk, work, block, sks[proposer], fork)
    return signed


def attest_slots(pk, state, ctx, slots, target_epoch=None):
    """An attestation of every committee of each slot in `slots` (all in
    history), every member attesting."""
    p, t = pk.p, pk.t
    atts = []
    for slot in slots:
        epoch = slot // p.SLOTS_PER_EPOCH
        for ci in range(ctx.get_committee_count_per_slot(epoch)):
            committee = ctx.get_beacon_committee(slot, ci)
            att = t.Attestation.default()
            att.aggregation_bits = [True] * len(committee)
            d = att.data
            d.slot = slot
            d.index = ci
            d.beacon_block_root = pk.util.get_block_root_at_slot(state, slot, p)
            d.source = state.current_justified_checkpoint
            tgt = t.Checkpoint.default()
            tgt.epoch = epoch if target_epoch is None else target_epoch
            tgt.root = pk.util.get_block_root(state, tgt.epoch, p)
            d.target = tgt
            atts.append(att)
    return atts


def sign_attestation(pk, state, ctx, att, sks):
    """The committee's aggregate signature over the attestation data."""
    t = pk.t
    committee = ctx.get_beacon_committee(int(att.data.slot), int(att.data.index))
    domain = pk.util.get_domain(state, pk.params.DOMAIN_BEACON_ATTESTER,
                                int(att.data.target.epoch))
    root = pk.util.compute_signing_root(t.AttestationData, att.data, domain)
    att.signature = pk.bls.aggregate_signatures([pk.bls.sign(sks[int(i)], root)
                                                 for i in committee])
    return att


def attested_block(pk, state, slot, sks):
    """A signed phase0 block at `slot` carrying a signed attestation of every
    committee of the slots before it in its epoch window."""
    p, t = pk.p, pk.t
    work = state.copy()
    ctx = pk.st.process_slots(work, slot, p)
    signed = empty_block_at(pk, state, slot, sks, fill_state_root=False)
    block = signed.message
    lo = max(1, slot - p.SLOTS_PER_EPOCH)
    block.body.attestations = [sign_attestation(pk, work, ctx, a, sks)
                               for a in attest_slots(pk, work, ctx, range(lo, slot))]
    post = work.copy()
    pk.st.process_block(post, block, pk.cache.EpochContext(post, p), verify_signatures=False)
    block.state_root = post.type.hash_tree_root(post)
    signed.signature = sign_block(pk, work, block, sks[int(block.proposer_index)])
    return signed, work, ctx


# --- genesis, committees, shuffling ------------------------------------------


def test_port_genesis_equals_the_jax_genesis():
    port = pkg("lodestar_tpu_torch")
    assert [k.scalar for k in secret_keys("lodestar_tpu_torch", N_VALIDATORS)] == [
        k.scalar for k in secret_keys("lodestar_tpu", N_VALIDATORS)]
    g = port.genesis.create_interop_genesis_state(N_VALIDATORS, p=port.p)
    assert g.type.serialize(g) == genesis_bytes(N_VALIDATORS)
    assert port.genesis.interop_pubkeys(4) == pkg("lodestar_tpu").genesis.interop_pubkeys(4)


def scenario_committees(pk, obs):
    p = pk.p
    g = pk.state(genesis_bytes(N_VALIDATORS))
    ctx = pk.cache.EpochContext(g, p)
    obs.add("active", ctx.current_shuffling.active_indices)
    for slot in range(p.SLOTS_PER_EPOCH):
        obs.add("proposer", ctx.get_beacon_proposer(slot))
        for c in range(ctx.get_committee_count_per_slot(ctx.current_epoch)):
            obs.add("committee", ctx.get_beacon_committee(slot, c))
    obs.add("total_active", pk.util.get_total_active_balance(g))


def test_committees_partition_validators():
    seen = both(scenario_committees)
    members = [i for c in observed(seen, "committee") for i in c]
    assert sorted(members) == list(range(N_VALIDATORS))


def scenario_shuffle(pk, obs):
    p = pk.params.active_preset()
    for n in (1, 2, 7, 33, 257):
        seed = bytes([n % 256]) * 32
        obs.add(f"unshuffle {n}", pk.shuffle.unshuffle_list(np.arange(n, dtype=np.int64) + 100,
                                                            seed, p))
        obs.add(f"index {n}", [pk.shuffle.compute_shuffled_index(i, n, seed, p)
                               for i in range(n)])
    eb = np.full(64, p.MAX_EFFECTIVE_BALANCE, dtype=np.int64)
    eb[:32] = 0
    obs.add("proposers", [pk.shuffle.compute_proposer_index(eb, np.arange(64, dtype=np.int64),
                                                            bytes([s]) * 32, p)
                          for s in range(40)])


def test_shuffle_and_proposer_selection():
    seen = both(scenario_shuffle)
    assert all(c >= 32 for c in observed(seen, "proposers")[0])


# --- slots, epochs and blocks -------------------------------------------------


def scenario_slots_across_epoch(pk, obs):
    p = pk.p
    state = pk.state(genesis_bytes(N_VALIDATORS))
    ctx = pk.st.process_slots(state, p.SLOTS_PER_EPOCH + 1, p)
    obs.add("epoch", ctx.current_epoch)
    obs.add("state", state)
    obs.call("backwards", pk.st.process_slots, state, 1, p)


def test_process_slots_across_epoch_boundary():
    seen = both(scenario_slots_across_epoch)
    assert observed(seen, "backwards")[0][1] == "StateTransitionError"


def test_process_slots_with_every_level_launched(monkeypatch):
    """The same scenario with every tree level of the port's state roots
    launched on the CPU device (no level left to the host's hashlib)."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    monkeypatch.setattr(dh, "DEVICE_MIN_FLUSH_PAIRS", 1)
    before = dh.launch_count()
    both(scenario_slots_across_epoch)
    assert dh.launch_count() > before


def scenario_signed_empty_block(pk, obs):
    p = pk.p
    g = pk.state(genesis_bytes(N_VALIDATORS))
    sks = secret_keys(pk.root, N_VALIDATORS)
    signed = empty_block_at(pk, g, 1, sks)
    obs.add("block", signed)
    post = obs.call("import", pk.st.state_transition, g, signed, p)
    obs.add("post", post)
    obs.add("pre untouched", g)

    bad = signed.copy()
    bad.signature = bytes(96)
    obs.call("bad proposer signature", pk.st.state_transition, g, bad, p)

    bad = signed.copy()
    bad.message.state_root = b"\xbe" * 32
    bad.signature = sign_block(pk, g, bad.message, sks[int(bad.message.proposer_index)])
    obs.call("wrong state root", pk.st.state_transition, g, bad, p)

    bad = signed.copy()
    wrong = (int(bad.message.proposer_index) + 1) % N_VALIDATORS
    bad.message.proposer_index = wrong
    bad.signature = sign_block(pk, g, bad.message, sks[wrong])
    obs.call("wrong proposer", pk.st.state_transition, g, bad, p, verify_state_root=False)


def test_signed_empty_block_and_its_rejects():
    seen = both(scenario_signed_empty_block)
    assert observed(seen, "import") == ["ok"]
    assert observed(seen, "bad proposer signature")[0][1] == "StateTransitionError"
    assert observed(seen, "wrong state root")[0][1] == "StateTransitionError"
    assert observed(seen, "wrong proposer")[0][1] == "BlockProcessError"


def test_jax_block_imported_by_the_port_from_bytes():
    """A block built and signed by the JAX package, its pre-state and the
    block carried into the port as SSZ bytes: equal post-state bytes."""
    j, port = pkg("lodestar_tpu"), pkg("lodestar_tpu_torch")
    g = j.state(genesis_bytes(N_VALIDATORS))
    signed, _, _ = attested_block(j, g, 3, secret_keys("lodestar_tpu", N_VALIDATORS))
    want = j.st.state_transition(g, signed, j.p)
    got = port.st.state_transition(
        port.state(genesis_bytes(N_VALIDATORS)),
        port.t.phase0.SignedBeaconBlock.deserialize(signed.type.serialize(signed)), port.p)
    assert got.type.serialize(got) == want.type.serialize(want)
    assert len(signed.message.body.attestations) > 0


def scenario_attestations_justify(pk, obs):
    p = pk.p
    state = pk.state(genesis_bytes(N_VALIDATORS))
    pk.st.process_slots(state, p.SLOTS_PER_EPOCH - 1, p)
    ctx = pk.cache.EpochContext(state, p)
    for att in attest_slots(pk, state, ctx, range(0, state.slot)):
        obs.call("attestation", pk.block.process_attestation, state, att, ctx,
                 verify_signatures=False)
    obs.add("epoch 0 attested", state)
    pk.st.process_slots(state, p.SLOTS_PER_EPOCH + 1, p)
    obs.add("rotated", state)
    pk.st.process_slots(state, 2 * p.SLOTS_PER_EPOCH - 1, p)
    ctx = pk.cache.EpochContext(state, p)
    for att in attest_slots(pk, state, ctx, range(p.SLOTS_PER_EPOCH, state.slot)):
        obs.call("attestation", pk.block.process_attestation, state, att, ctx,
                 verify_signatures=False)
    pk.st.process_slots(state, 3 * p.SLOTS_PER_EPOCH + 1, p)
    obs.add("justified", int(state.current_justified_checkpoint.epoch))
    obs.add("state", state)
    ep_state = state.copy()
    ep = pk.epoch.before_process_epoch(ep_state, pk.cache.EpochContext(ep_state, p))
    rewards, penalties = pk.epoch.get_attestation_deltas(ep_state, ep)
    obs.add("rewards", rewards)
    obs.add("penalties", penalties)


def test_attestations_drive_justification_and_rewards():
    seen = both(scenario_attestations_justify)
    assert observed(seen, "justified")[0] >= 1
    assert "ok" in observed(seen, "attestation")


def scenario_effective_balance(pk, obs):
    p = pk.p
    g = pk.state(genesis_bytes(N_VALIDATORS))
    s = g.copy()
    s.balances[0] = p.MAX_EFFECTIVE_BALANCE // 2
    pk.st.process_slots(s, p.SLOTS_PER_EPOCH, p)
    obs.add("dropped", s)
    s = g.copy()
    s.balances[1] -= 1
    pk.st.process_slots(s, p.SLOTS_PER_EPOCH, p)
    obs.add("within hysteresis", s)


def test_effective_balance_hysteresis():
    both(scenario_effective_balance)


def scenario_voluntary_exit(pk, obs):
    p, t = pk.p, pk.t
    state = pk.state(genesis_bytes(N_VALIDATORS))
    sks = secret_keys(pk.root, N_VALIDATORS)
    pk.st.process_slots(state, p.SHARD_COMMITTEE_PERIOD * p.SLOTS_PER_EPOCH, p)
    ctx = pk.cache.EpochContext(state, p)
    exit_ = t.VoluntaryExit.default()
    exit_.epoch = p.SHARD_COMMITTEE_PERIOD
    exit_.validator_index = 5
    signed = t.SignedVoluntaryExit.default()
    signed.message = exit_
    domain = pk.util.get_domain(state, pk.params.DOMAIN_VOLUNTARY_EXIT, exit_.epoch)
    signed.signature = pk.bls.sign(sks[5], pk.util.compute_signing_root(t.VoluntaryExit, exit_,
                                                                        domain))
    obs.add("exit sets", [pk.sets.voluntary_exit_signature_set(state, signed, ctx)])
    obs.call("exit", pk.block.process_voluntary_exit, state, signed, ctx, verify_signatures=True)
    obs.add("exited", state)
    obs.call("double exit", pk.block.process_voluntary_exit, state, signed, ctx,
             verify_signatures=False)


def test_voluntary_exit_lifecycle():
    seen = both(scenario_voluntary_exit)
    assert observed(seen, "exit") == ["ok"]
    assert observed(seen, "double exit")[0][1] == "BlockProcessError"


def _header(pk, idx, byte):
    h = pk.t.BeaconBlockHeader.default()
    h.proposer_index = idx
    h.body_root = bytes([byte]) * 32
    return h


def scenario_slashings(pk, obs):
    p, t = pk.p, pk.t
    g = pk.state(genesis_bytes(N_VALIDATORS))
    sks = secret_keys(pk.root, N_VALIDATORS)
    state = g.copy()
    pk.st.process_slots(state, 1, p)
    ctx = pk.cache.EpochContext(state, p)
    idx = 7
    domain = pk.util.get_domain(state, pk.params.DOMAIN_BEACON_PROPOSER, 0)
    slashing = t.ProposerSlashing.default()
    for fname, byte in (("signed_header_1", 1), ("signed_header_2", 2)):
        sh = t.SignedBeaconBlockHeader.default()
        sh.message = _header(pk, idx, byte)
        sh.signature = pk.bls.sign(sks[idx], pk.util.compute_signing_root(
            t.BeaconBlockHeader, sh.message, domain))
        setattr(slashing, fname, sh)
    obs.add("proposer slashing sets", pk.sets.proposer_slashing_signature_sets(
        state, slashing, ctx))
    work = state.copy()
    obs.call("proposer slashing", pk.block.process_proposer_slashing, work, slashing, ctx,
             verify_signatures=True)
    obs.add("proposer slashed", work)
    obs.call("proposer slashing again", pk.block.process_proposer_slashing, work, slashing, ctx,
             verify_signatures=False)
    same = slashing.copy()
    same.signed_header_2 = same.signed_header_1
    obs.call("identical headers", pk.block.process_proposer_slashing, state.copy(), same, ctx,
             verify_signatures=False)

    # a double vote of one committee: two attestations of slot 0 with
    # different block roots, each signed by the whole committee
    atts = attest_slots(pk, state, ctx, [0])
    a1 = atts[0]
    a2 = a1.copy()
    a2.data.beacon_block_root = b"\x55" * 32
    indexed = []
    for a in (a1, a2):
        sign_attestation(pk, state, ctx, a, sks)
        indexed.append(pk.block.get_indexed_attestation(a, ctx))
    als = t.AttesterSlashing.default()
    als.attestation_1, als.attestation_2 = indexed
    obs.add("attester slashing sets", pk.sets.attester_slashing_signature_sets(state, als, ctx))
    work = state.copy()
    obs.call("attester slashing", pk.block.process_attester_slashing, work, als, ctx,
             verify_signatures=True)
    obs.add("attesters slashed", work)
    not_slashable = t.AttesterSlashing.default()
    not_slashable.attestation_1 = not_slashable.attestation_2 = indexed[0]
    obs.call("same vote twice", pk.block.process_attester_slashing, state.copy(), not_slashable,
             ctx, verify_signatures=False)


def test_proposer_and_attester_slashings():
    seen = both(scenario_slashings)
    assert observed(seen, "proposer slashing") == ["ok"]
    assert observed(seen, "attester slashing") == ["ok"]
    for label in ("proposer slashing again", "identical headers", "same vote twice"):
        assert observed(seen, label)[0][1] == "BlockProcessError", label


# --- the committed operation vectors through both packages --------------------

_OPS = {
    "attestation": ("Attestation", "process_attestation", True),
    "attester_slashing": ("AttesterSlashing", "process_attester_slashing", True),
    "deposit": ("Deposit", "process_deposit", False),
    "proposer_slashing": ("ProposerSlashing", "process_proposer_slashing", True),
    "voluntary_exit": ("SignedVoluntaryExit", "process_voluntary_exit", True),
}


def _op_cases():
    from lodestar_tpu_torch.spec_test import iterate_spec_tests

    return [c for c in iterate_spec_tests(VECTORS)
            if c.runner == "operations" and (c.handler in _OPS or c.handler == "block_header")]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c.test_id)
def test_operation_vector(case):
    def scenario(pk, obs):
        pre = pk.state(case.load("pre"))
        ctx = pk.cache.EpochContext(pre, pk.p)
        if case.handler == "block_header":
            block = pk.t.phase0.BeaconBlock.deserialize(case.load("block"))
            obs.call("apply", pk.block.process_block_header, pre, block, ctx)
        else:
            type_name, fn, signed = _OPS[case.handler]
            op = getattr(pk.t, type_name).deserialize(case.load(case.handler))
            kwargs = {"verify_signatures": True} if signed else {}
            obs.call("apply", getattr(pk.block, fn), pre, op, ctx, **kwargs)
        obs.add("post", pre)

    seen = both(scenario)
    if "post.ssz" in case.files():
        assert observed(seen, "apply") == ["ok"]
        assert observed(seen, "post")[0][1] == case.load("post")
    else:
        assert observed(seen, "apply")[0][0] == "raises"


# --- signature sets -----------------------------------------------------------


def scenario_block_sets(pk, obs):
    p = pk.p
    g = pk.state(genesis_bytes(N_VALIDATORS))
    sks = secret_keys(pk.root, N_VALIDATORS)
    signed = empty_block_at(pk, g, 1, sks)
    pre = g.copy()
    ctx = pk.st.process_slots(pre, 1, p)
    sets = pk.sets.get_block_signature_sets(pre, signed, ctx)
    obs.add("empty block sets", sets)
    obs.add("oracle", pk.bls.verify_signature_sets(sets))
    bad = signed.copy()
    bad.message.body.randao_reveal = bytes(96)
    bad_sets = pk.sets.get_block_signature_sets(pre, bad, ctx)
    obs.add("tampered sets", bad_sets)
    obs.add("tampered oracle", pk.bls.verify_signature_sets(bad_sets))
    obs.add("without proposer", pk.sets.get_block_signature_sets(pre, signed, ctx,
                                                                 include_proposer=False))
    free = pk.st.state_transition(g, signed, p, verify_signatures=False,
                                  verify_proposer_signature=False)
    full = pk.st.state_transition(g, signed, p)
    obs.add("signature-free post", free)
    obs.add("inline post", full)

    signed, work, ctx = attested_block(pk, g, 4, sks)
    obs.add("attested block", signed)
    obs.add("attested sets", pk.sets.get_block_signature_sets(work, signed, ctx))


def test_traced_spans_the_signature_set_producer():
    """`tracing.traced` (the port's copy): `get_block_signature_sets` passes
    straight through with tracing off and records its "signature_sets"
    span inside a trace, as the JAX package's does."""
    spans = {}
    for root in ROOTS:
        pk = pkg(root)
        tracing = importlib.import_module(f"{root}.tracing")
        g = pk.state(genesis_bytes(N_VALIDATORS))
        signed = empty_block_at(pk, g, 1, secret_keys(root, N_VALIDATORS), fill_state_root=False)
        pre = g.copy()
        ctx = pk.st.process_slots(pre, 1, pk.p)
        tracing.reset()
        try:
            assert len(pk.sets.get_block_signature_sets(pre, signed, ctx)) == 2
            tracing.configure(enabled=True)
            with tracing.root("block_import", slot=1):
                pk.sets.get_block_signature_sets(pre, signed, ctx)
            (trace,) = tracing.get_tracer().traces_for_slot(1)
            spans[root] = sorted(s.name for s in trace.spans)
        finally:
            tracing.reset()
    assert spans[ROOTS[1]] == spans[ROOTS[0]]
    assert "signature_sets" in spans[ROOTS[1]]
    assert pkg(ROOTS[1]).sets.get_block_signature_sets.__name__ == "get_block_signature_sets"


def test_block_signature_sets():
    seen = both(scenario_block_sets)
    assert len(observed(seen, "empty block sets")[0]) == 2
    assert observed(seen, "oracle") == [True]
    assert observed(seen, "tampered oracle") == [False]
    assert observed(seen, "signature-free post") == observed(seen, "inline post")
    assert 2 < len(observed(seen, "attested sets")[0]) <= 8



# --- the on-card block phase's import, on the CPU -----------------------------


def test_chip_smoke_block_import_on_the_cpu():
    """`chip_smoke.py` phase 10's block builder and import (the shape of the
    JAX package's chain.py block import) at the minimal preset on the CPU:
    the pool's verdict True, the post-state root the block's, and the post
    state and the signature sets equal to the JAX package's
    `state_transition` and `get_block_signature_sets` on the same bytes."""
    import chip_smoke

    j, port = pkg(ROOTS[0]), pkg(ROOTS[1])
    cfg = chip_smoke.block_chain_config()
    jcfg = j.config.mainnet_chain_config().replace(ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=1,
                                                   CAPELLA_FORK_EPOCH=1)
    genesis = port.state(genesis_bytes(N_VALIDATORS))
    slot = port.p.SLOTS_PER_EPOCH + 1
    signed, _, _ = chip_smoke.build_block(genesis, secret_keys(port.root, N_VALIDATORS), port.p,
                                          cfg, slot, attest_from=slot - 1)
    res, sets, post = chip_smoke.on_pool("cpu", lambda pool, ex: chip_smoke.import_block(
        pool, ex, genesis, signed, port.p, cfg))
    assert res["verdict"] is True and res["error"] is None and res["n_sets"] == 4

    jsigned = j.t.capella.SignedBeaconBlock.deserialize(signed.type.serialize(signed))
    jpre = j.state(genesis_bytes(N_VALIDATORS))
    want = j.st.state_transition(jpre, jsigned, j.p, jcfg)
    assert post.type.serialize(post) == want.type.serialize(want)
    jwork = jpre.copy()
    jctx = j.st.process_slots(jwork, slot, j.p, jcfg)
    jsets = j.sets.get_block_signature_sets(jwork, jsigned, jctx)
    assert chip_smoke.set_fields(sets) == chip_smoke.set_fields(jsets)
