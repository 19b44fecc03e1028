"""The port's beacon chain (`lodestar_tpu_torch.chain`: `chain`, `regen`,
`archiver`, `validation`, `produce_block`, `op_pools`, `sync_pools`,
`clock`; `utils.queue`; `slo`'s span helpers) against the JAX package's,
minimal preset.

Tolerance: none. Each scenario of the JAX package's
`tests/chain/test_{chain,regen_archiver,produce_block,validation,sync_pools}.py`
and the parts of `test_runtime.py` without metrics (clock, op pools, seen
caches) runs through both packages (`both`), with the JAX test's own
assertions, and the two runs' observations must be equal: every state and
block as its SSZ bytes, the db's contents as bytes, heads and every
fork-choice node's fields, every reject as its exception class, message and
`BlockErrorCode` or `GossipAction`, and every signature set field for
field. Genesis and the imported blocks are the JAX package's, carried into
the port as SSZ bytes; blocks each package produces or signs are compared
as bytes. Also: the span names of one `process_block` trace, an import whose
verifier raises (rejected, `verifier_outage` set), and one import through
the port's `BlsDeviceVerifierPool(device="cpu")`, one size-8 batch, against
the JAX package's oracle verdict.

The port's HTR device is the CPU (`configure_device_htr(mode="on",
device="cpu")`): the chain's state roots go through its tracker.
"""

from __future__ import annotations

import asyncio
import enum
import functools
import hashlib
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from .test_torch_fork_choice import node_fields

N = 32  # validators, as the JAX package's chain tests
N_SYNC = 16  # validators of the sync-committee scenarios
ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")

_MODULES = {
    "params": "params", "ssz": "ssz", "types": "types", "config": "config",
    "api": "crypto.bls.api", "bls": "chain.bls", "chain": "chain.chain", "db": "db",
    "validation": "chain.validation", "produce": "chain.produce_block", "regen": "chain.regen",
    "op_pools": "chain.op_pools", "sync_pools": "chain.sync_pools", "clock": "chain.clock",
    "queue": "utils.queue", "st": "state_transition", "util": "state_transition.util",
    "gen": "state_transition.genesis", "tracing": "tracing", "slo": "slo",
}


class Pkg:
    """One package's chain modules under the JAX package's names, with the
    minimal preset and its SSZ types."""

    def __init__(self, root: str):
        self.root = root
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))
        self.p = self.params.MINIMAL
        self.t = self.types.ssz_types(self.p)

    def genesis(self, n: int = N):
        return self.t.phase0.BeaconState.deserialize(genesis_bytes(n))

    def blocks(self, n: int):
        return [self.t.phase0.SignedBeaconBlock.deserialize(b) for b in block_bytes(n)]

    def new_chain(self, genesis=None, verifier=None, slot: int = 1, **kw):
        return self.chain.BeaconChain(
            anchor_state=genesis if genesis is not None else self.genesis(),
            bls_verifier=verifier if verifier is not None else self.bls.BlsVerifierMock(True),
            db=self.db.MemoryDbController(),
            current_slot=slot,
            **kw,
        )


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> Pkg:
    return Pkg(root)


@functools.lru_cache(maxsize=None)
def secret_keys(root: str, n: int = N):
    return pkg(root).gen.interop_secret_keys(n)


@functools.lru_cache(maxsize=None)
def genesis_bytes(n: int) -> bytes:
    """The JAX package's interop genesis, as SSZ bytes."""
    j = pkg(ROOTS[0])
    g = j.gen.create_interop_genesis_state(n, p=j.p)
    return g.type.serialize(g)


@functools.lru_cache(maxsize=None)
def block_bytes(n: int) -> tuple:
    """n consecutive signed empty blocks from the JAX genesis, built as the
    JAX package's chain tests build them, as SSZ bytes."""
    from .state_transition.test_state_transition import _empty_block_at

    j = pkg(ROOTS[0])
    state, out = j.genesis(), []
    for slot in range(1, n + 1):
        signed = _empty_block_at(state, slot, secret_keys(ROOTS[0]), j.p)
        out.append(signed.type.serialize(signed))
        state = j.st.state_transition(state, signed, j.p, verify_signatures=False,
                                      verify_proposer_signature=False)
    return tuple(out)


def norm(value):
    """An observation in terms both packages share: SSZ values as their type
    name and bytes, signature sets as their fields' bytes, enum members as
    their class and member names, arrays as lists."""
    if hasattr(value, "type") and hasattr(value.type, "serialize"):
        return (value.type.name, value.type.serialize(value))
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "signature") and hasattr(value, "pubkey") and hasattr(value, "message"):
        return (bytes(value.pubkey), bytes(value.message), bytes(value.signature))
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.name)
    if isinstance(value, (list, tuple)):
        return type(value)(norm(v) for v in value)
    return value


class Obs:
    """What one run of a scenario saw, in order."""

    def __init__(self):
        self.seen = []

    def add(self, label, value):
        value = norm(value)
        self.seen.append((label, value))
        return value

    def chain(self, label, chain):
        """The chain's head, fork-choice nodes, votes and db contents."""
        fc = chain.fork_choice
        self.add(label, (
            fc.head, [node_fields(n) for n in fc.proto_array.nodes],
            fc.votes.current.tolist(), (fc.justified.epoch, fc.justified.root),
            (fc.finalized.epoch, fc.finalized.root),
            list(chain.blocks_db.db.entries_stream()),
        ))

    def reject(self, label, err):
        self.add(label, (type(err).__name__, str(err), getattr(err, "code", None),
                         getattr(getattr(err, "action", None), "value", None),
                         getattr(err, "verifier_outage", None)))

    async def call(self, label, coro):
        """The coroutine's result, or its exception noted as a reject."""
        try:
            out = await coro
        except Exception as e:  # noqa: BLE001 - the reject is the observation
            self.reject(label, e)
            return e
        self.add(label, "ok")
        return out

    def call_sync(self, label, fn, *args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the reject is the observation
            self.reject(label, e)
            return e
        self.add(label, "ok")
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


def block_root(P, signed) -> bytes:
    return signed.message.type.hash_tree_root(signed.message)


async def import_all(chain, blocks):
    for b in blocks:
        await chain.process_block(b)


# --- chain (tests/chain/test_chain.py) ----------------------------------------


def sc_import_chain_advances_head(P, obs):
    chain = P.new_chain(slot=3)
    blocks = P.blocks(3)
    events = []
    chain.on("block", lambda root, blk: events.append(("block", root)))
    chain.on("head", lambda head: events.append(("head", head)))
    asyncio.run(import_all(chain, blocks))
    assert chain.head_root == block_root(P, blocks[-1])
    assert len([e for e in events if e[0] == "block"]) == 3
    st = chain.get_head_state()
    assert st.slot == 3
    obs.add("events", events)
    obs.add("head state", st)
    obs.chain("chain", chain)
    for b in blocks:
        got = chain.get_block_by_root(block_root(P, b))
        obs.add("block by root", got)
        assert got.type.serialize(got) == b.type.serialize(b)


def sc_sanity_checks(P, obs):
    chain = P.new_chain(slot=2)
    blocks = P.blocks(2)

    async def go():
        await chain.process_block(blocks[0])
        e = await obs.call("duplicate", chain.process_block(blocks[0]))
        assert e.code == P.chain.BlockErrorCode.ALREADY_KNOWN
        orphan = blocks[1].copy()
        orphan.message.parent_root = b"\x77" * 32
        e = await obs.call("unknown parent", chain.process_block(orphan))
        assert e.code == P.chain.BlockErrorCode.PARENT_UNKNOWN
        future = blocks[1].copy()
        future.message.slot = 99
        e = await obs.call("future slot", chain.process_block(future))
        assert e.code == P.chain.BlockErrorCode.FUTURE_SLOT

    asyncio.run(go())
    obs.chain("chain", chain)


def sc_invalid_signature_rejected_by_pipeline(P, obs):
    chain = P.new_chain(verifier=P.bls.BlsVerifierMock(False), slot=1)
    blocks = P.blocks(1)
    e = asyncio.run(obs.call("import", chain.process_block(blocks[0])))
    assert e.code == P.chain.BlockErrorCode.INVALID_SIGNATURES
    assert e.action is P.validation.GossipAction.REJECT
    # the rejected block enters neither fork choice nor the db
    root = block_root(P, blocks[0])
    assert not chain.fork_choice.proto_array.has_block("0x" + root.hex())
    assert chain.blocks_db.get_binary(root) is None
    obs.chain("chain", chain)


def sc_verifier_error_fails_closed(P, obs):
    class Down(P.bls.IBlsVerifier):
        async def verify_signature_sets(self, sets, opts=None):
            raise RuntimeError("lane down")

        def can_accept_work(self):
            return True

        async def close(self):
            return None

    chain = P.new_chain(verifier=Down(), slot=1)
    e = asyncio.run(obs.call("import", chain.process_block(P.blocks(1)[0])))
    assert e.code == P.chain.BlockErrorCode.INVALID_SIGNATURES and e.verifier_outage is True
    obs.chain("chain", chain)


def sc_state_root_mismatch_rejected(P, obs):
    chain = P.new_chain(slot=1)
    bad = P.blocks(1)[0].copy()
    bad.message.state_root = b"\x13" * 32
    e = asyncio.run(obs.call("import", chain.process_block(bad)))
    assert e.code == P.chain.BlockErrorCode.INVALID_STATE_TRANSITION
    obs.chain("chain", chain)


def sc_real_oracle_verifier_end_to_end(P, obs):
    """One block through the pipeline with real signature verification."""
    chain = P.new_chain(verifier=P.bls.BlsSingleThreadVerifier(), slot=1)
    root = asyncio.run(chain.process_block(P.blocks(1)[0]))
    assert chain.head_root == root
    obs.add("root", root)
    obs.chain("chain", chain)


def sc_regen_replays_from_db(P, obs):
    genesis = P.genesis()
    chain = P.new_chain(genesis, slot=2)
    asyncio.run(import_all(chain, P.blocks(2)))
    # forget hot states but the anchor; regen must replay from db blocks
    header = genesis.latest_block_header.copy()
    header.state_root = genesis.type.hash_tree_root(genesis)
    anchor_root = P.t.BeaconBlockHeader.hash_tree_root(header)
    chain.state_cache.prune_except({anchor_root})
    st = chain.get_state_by_block_root(chain.head_root)
    assert st.slot == 2
    obs.add("replayed", st)
    obs.add("root", P.st.state_hash_tree_root(st))
    e = obs.call_sync("unknown root", chain.get_state_by_block_root, b"\x42" * 32)
    assert e.code == P.chain.BlockErrorCode.PRESTATE_MISSING


def sc_process_block_span_names(P, obs):
    """One traced import: the span names of its trace. The port's state roots
    run on the value path here (HTR mode "off"), as the JAX package's do on
    the CPU; on the tracker (mode "on") the port's trace has the same names
    plus one `state_htr` span a root."""
    from lodestar_tpu_torch.ssz import device_htr as dh

    tr = P.tracing

    def traced_names():
        tr.reset()
        tr.configure(enabled=True, slow_slot_ms=1e9)
        try:
            asyncio.run(P.new_chain(slot=1).process_block(P.blocks(1)[0]))
            trace = tr.get_tracer().ring[-1]
            return trace.name, trace.slot, sorted(s.name for s in trace.spans)
        finally:
            tr.reset()

    prev = dh.configure_device_htr(mode="off")
    try:
        name, slot, names = traced_names()
    finally:
        dh.configure_device_htr(mode=prev)
    obs.add("trace", (name, slot, names))
    assert {"process_block", "pre_state_regen", "bls_verify", "state_transition",
            "hash_tree_root", "persist_block", "fork_choice", "attestation_ops",
            "find_head"} <= set(names)
    if P.root == ROOTS[1]:
        on = traced_names()[2]
        assert [n for n in on if n != "state_htr"] == names and "state_htr" in on


# --- block production (tests/chain/test_produce_block.py) ----------------------


def sign_block(P, state, block, sk):
    signed = P.t.phase0.SignedBeaconBlock.default()
    signed.message = block
    signed.signature = P.api.sign(sk, P.util.compute_signing_root(
        P.t.phase0.BeaconBlock, block, P.util.get_domain(state, P.params.DOMAIN_BEACON_PROPOSER)))
    return signed


def sc_produced_block_imports_with_full_verification(P, obs):
    sks = secret_keys(P.root)
    genesis = P.genesis()
    chain = P.new_chain(genesis, verifier=P.bls.BlsSingleThreadVerifier(), slot=1)
    work = genesis.copy()
    ctx = P.st.process_slots(work, 1, P.p)
    proposer = ctx.get_beacon_proposer(1)
    reveal = P.api.sign(sks[proposer], P.util.compute_signing_root(
        P.ssz.uint64, 0, P.util.get_domain(work, P.params.DOMAIN_RANDAO)))
    block = P.produce.produce_block(chain, slot=1, randao_reveal=reveal, graffiti=b"lodestar-tpu")
    assert block.proposer_index == proposer
    assert bytes(block.body.graffiti).startswith(b"lodestar-tpu")
    obs.add("produced", block)
    signed = sign_block(P, work, block, sks[proposer])
    root = asyncio.run(chain.process_block(signed))
    assert chain.head_root == root
    obs.chain("chain", chain)


def sc_produced_block_packs_pool_operations(P, obs):
    genesis = P.genesis()
    chain = P.new_chain(genesis, slot=2)
    work = genesis.copy()
    ctx = P.st.process_slots(work, 1, P.p)
    committee = ctx.get_beacon_committee(1, 0)
    att = P.t.Attestation.default()
    att.data.slot = 1
    att.data.index = 0
    att.data.beacon_block_root = chain.head_root
    att.data.target.epoch = 0
    att.data.target.root = P.util.get_block_root(work, 0, P.p)
    att.data.source = work.current_justified_checkpoint
    bits = [False] * len(committee)
    bits[0] = True
    att.aggregation_bits = bits
    obs.add("inserted", chain.aggregated_attestation_pool.add(
        att, P.t.AttestationData.hash_tree_root(att.data)))
    block = P.produce.produce_block(chain, slot=2, randao_reveal=bytes(96))
    assert len(block.body.attestations) == 1
    assert bytes(block.body.attestations[0].data.beacon_block_root) == chain.head_root
    obs.add("produced", block)
    data = P.produce.make_attestation_data(chain, 2, 0)
    obs.add("attestation data", data)
    state, _ = P.produce.dial_to_slot(genesis, 3, P.p)
    obs.add("dialed", state)


# --- gossip validation (tests/chain/test_validation.py) ------------------------


def validation_chain(P):
    chain = P.new_chain(slot=2)
    asyncio.run(import_all(chain, P.blocks(2)))
    return chain


def gossip_attestation(P, chain, *, vi_bit=0, slot=2, sign=True):
    """A one-bit attestation of committee 0 at `slot` on the head, as the
    JAX package's validation tests build it."""
    work = chain.get_head_state().copy()
    if slot > work.slot:
        P.st.process_slots(work, slot, P.p)
    ctx = P.st.EpochContext(work, P.p)
    committee = ctx.get_beacon_committee(slot, 0)
    att = P.t.Attestation.default()
    att.data = P.produce.make_attestation_data(chain, slot, 0)
    bits = [False] * len(committee)
    bits[vi_bit] = True
    att.aggregation_bits = bits
    if sign:
        domain = P.util.get_domain(work, P.params.DOMAIN_BEACON_ATTESTER, att.data.target.epoch)
        root = P.util.compute_signing_root(P.t.AttestationData, att.data, domain)
        att.signature = P.api.sign(secret_keys(P.root)[int(committee[vi_bit])], root)
    return att


def signed_aggregate(P, chain, slot, index, sks, aggregator=None):
    """A SignedAggregateAndProof of committee `index` at `slot` on the head,
    every member attesting, its aggregate signed with the sum of the
    members' keys, by the first member whose selection proof
    `is_aggregator` accepts (or by `aggregator`, accepted or not)."""
    work = chain.get_head_state().copy()
    if slot > work.slot:
        P.st.process_slots(work, slot, P.p)
    ctx = P.st.EpochContext(work, P.p)
    committee = [int(i) for i in ctx.get_beacon_committee(slot, index)]
    data = P.produce.make_attestation_data(chain, slot, index)
    epoch = int(data.target.epoch)
    att = P.t.Attestation.default()
    att.data = data
    att.aggregation_bits = [True] * len(committee)
    r = importlib.import_module(f"{P.root}.crypto.bls.fields").R
    summed = P.api.SecretKey(sum(sks[i].scalar for i in committee) % r)
    att.signature = P.api.sign(summed, P.util.compute_signing_root(
        P.t.AttestationData, data, P.util.get_domain(work, P.params.DOMAIN_BEACON_ATTESTER, epoch)))
    sel_root = P.util.compute_signing_root(
        P.ssz.uint64, slot, P.util.get_domain(work, P.params.DOMAIN_SELECTION_PROOF, epoch))
    for vi in committee if aggregator is None else [aggregator]:
        proof = P.api.sign(sks[vi], sel_root)
        if aggregator is not None or P.validation.is_aggregator(len(committee), proof):
            break
    agg = P.t.AggregateAndProof.default()
    agg.aggregator_index = vi
    agg.aggregate = att
    agg.selection_proof = proof
    signed = P.t.SignedAggregateAndProof.default()
    signed.message = agg
    signed.signature = P.api.sign(sks[vi], P.util.compute_signing_root(
        P.t.AggregateAndProof, agg,
        P.util.get_domain(work, P.params.DOMAIN_AGGREGATE_AND_PROOF, epoch)))
    return signed



def sc_attestation_accepts_and_yields_verifiable_set(P, obs):
    chain = validation_chain(P)
    att = gossip_attestation(P, chain)
    obs.add("attestation", att)
    res = P.validation.validate_gossip_attestation(chain, att)
    assert len(res.attesting_indices) == 1
    obs.add("indices", res.attesting_indices)
    obs.add("sets", res.signature_sets)
    obs.add("oracle", P.api.verify_signature_sets(res.signature_sets))
    assert observed(obs.seen, "oracle") == [True]


def sc_attestation_first_seen_dedup(P, obs):
    chain = validation_chain(P)
    att = gossip_attestation(P, chain, vi_bit=1)
    res = P.validation.validate_gossip_attestation(chain, att)
    # seen-cache registration waits for the signature: before it, a
    # duplicate is not ignored
    P.validation.validate_gossip_attestation(chain, att)
    res.register_seen()
    e = obs.call_sync("duplicate", P.validation.validate_gossip_attestation, chain, att)
    assert e.action is P.validation.GossipAction.IGNORE


def sc_attestation_rejects_multi_bit(P, obs):
    chain = validation_chain(P)
    att = gossip_attestation(P, chain, sign=False)
    bits = list(att.aggregation_bits)
    bits[2] = True
    att.aggregation_bits = bits
    e = obs.call_sync("two bits", P.validation.validate_gossip_attestation, chain, att)
    assert e.action is P.validation.GossipAction.REJECT


def sc_attestation_ignores_unknown_root(P, obs):
    chain = validation_chain(P)
    att = gossip_attestation(P, chain, vi_bit=3, sign=False)
    att.data.beacon_block_root = b"\x5c" * 32
    e = obs.call_sync("unknown root", P.validation.validate_gossip_attestation, chain, att)
    assert e.action is P.validation.GossipAction.IGNORE


def sc_block_gossip_checks(P, obs):
    chain = validation_chain(P)
    blocks = P.blocks(2)
    v = P.validation.validate_gossip_block
    obs.call_sync("known", v, chain, blocks[-1])
    fut = blocks[-1].copy()
    fut.message.slot = 50
    obs.call_sync("future", v, chain, fut)
    orphan = blocks[-1].copy()
    orphan.message.slot = 2
    orphan.message.parent_root = b"\x99" * 32
    obs.call_sync("orphan", v, chain, orphan)
    assert [r[0] for _, r in obs.seen] == ["GossipValidationError"] * 3


def sc_aggregate_and_proof_accept_dedup_reject(P, obs):
    chain = validation_chain(P)
    sks = secret_keys(P.root)
    signed = signed_aggregate(P, chain, 2, 0, sks)
    obs.add("aggregate", signed)
    res = P.validation.validate_gossip_aggregate_and_proof(chain, signed)
    obs.add("indices", res.attesting_indices)
    obs.add("sets", res.signature_sets)
    obs.add("oracle", P.api.verify_signature_sets(res.signature_sets))
    assert observed(obs.seen, "oracle") == [True] and len(res.signature_sets) == 3
    res.register_seen()
    e = obs.call_sync("again", P.validation.validate_gossip_aggregate_and_proof, chain, signed)
    assert e.action is P.validation.GossipAction.IGNORE and "already seen aggregator" in str(e)
    stranger = signed.copy()
    stranger.message.aggregator_index = N - 1  # not in the committee
    obs.call_sync("not in committee", P.validation.validate_gossip_aggregate_and_proof,
                  chain, stranger)
    unknown = signed.copy()
    unknown.message.aggregate.data.beacon_block_root = b"\x5d" * 32
    obs.call_sync("unknown root", P.validation.validate_gossip_aggregate_and_proof,
                  chain, unknown)


def sc_blobs_sidecar_slot_mismatch_rejected(P, obs):
    chain = P.new_chain(slot=2)
    coupled = P.t.deneb.SignedBeaconBlockAndBlobsSidecar.default()
    coupled.beacon_block.message.slot = 1
    coupled.beacon_block.message.parent_root = chain.head_root
    coupled.blobs_sidecar.beacon_block_slot = 9  # mismatch
    e = obs.call_sync("mismatch", P.validation.validate_gossip_block_and_blobs_sidecar,
                      chain, coupled)
    assert "slot mismatch" in str(e)


# --- regen, archiver, queue (tests/chain/test_regen_archiver.py) ---------------


def sc_queue_fifo_runs_in_order_and_rejects_overflow(P, obs):
    ran = []

    async def go():
        gate = asyncio.Event()

        async def job(i):
            await gate.wait()
            ran.append(i)
            return i * 10

        q = P.queue.JobItemQueue(job, max_length=3)
        tasks = [asyncio.ensure_future(q.push(i)) for i in range(3)]
        await asyncio.sleep(0)  # all three enqueued = full
        with pytest.raises(P.queue.QueueError) as ei:
            await q.push(99)
        obs.reject("overflow", ei.value)
        gate.set()
        return await asyncio.gather(*tasks)

    results = asyncio.run(go())
    assert results == [0, 10, 20] and ran == [0, 1, 2]
    obs.add("ran", (results, ran))


def sc_queue_lifo_drops_oldest_and_serves_newest_first(P, obs):
    ran = []

    async def go():
        gate = asyncio.Event()

        async def job(i):
            await gate.wait()
            ran.append(i)
            return i

        q = P.queue.JobItemQueue(job, max_length=2, queue_type=P.queue.QueueType.LIFO)
        t0 = asyncio.ensure_future(q.push(0))
        for _ in range(3):  # let the runner pop job 0 and block on the gate
            await asyncio.sleep(0)
        assert q.job_len == 1
        t1 = asyncio.ensure_future(q.push(1))
        t2 = asyncio.ensure_future(q.push(2))
        await asyncio.sleep(0)  # queue = [1, 2], full
        t3 = asyncio.ensure_future(q.push(3))  # drops the oldest queued (1)
        gate.set()
        await asyncio.gather(t0, t2, t3)
        with pytest.raises(P.queue.QueueError) as ei:
            await t1
        obs.reject("dropped", ei.value)

    asyncio.run(go())
    assert 1 not in ran and ran.index(3) < ran.index(2)
    obs.add("ran", ran)


def sc_queue_propagates_job_exception_and_keeps_draining(P, obs):
    def job(i):
        if i == 1:
            raise ValueError("boom")
        return i

    q = P.queue.JobItemQueue(job, max_length=10)

    async def go():
        return await asyncio.gather(*[asyncio.ensure_future(q.push(i)) for i in range(3)],
                                    return_exceptions=True)

    r = asyncio.run(go())
    assert r[0] == 0 and r[2] == 2 and isinstance(r[1], ValueError)
    obs.add("results", [x if not isinstance(x, Exception) else repr(x) for x in r])


def sc_checkpoint_cache_prunes_old_epochs(P, obs):
    c = P.regen.CheckpointStateCache(max_epochs=3)
    for e in range(6):
        c.add(e, b"\x01" * 32, f"state{e}")
    assert c.get(0, b"\x01" * 32) is None
    assert c.get(5, b"\x01" * 32) == "state5"
    obs.add("len", len(c))
    c.prune_finalized(5)
    obs.add("pruned", (len(c), c.get_latest(b"\x01" * 32, max_epoch=10)))
    assert observed(obs.seen, "pruned") == [(1, "state5")]


def sc_regen_get_state_and_checkpoint_state(P, obs):
    chain = P.new_chain(slot=3)
    blocks = P.blocks(3)

    async def go():
        await import_all(chain, blocks)
        root = block_root(P, blocks[-1])
        st = await chain.regen.get_state(root)
        assert st.slot == 3
        chain.state_cache._by_root.pop(root, None)  # force a replay through the queue
        st2 = await chain.regen.get_state(root)
        assert st2.type.hash_tree_root(st2) == st.type.hash_tree_root(st)
        obs.add("replayed", st2)
        cp_state = await chain.regen.get_checkpoint_state(1, root)
        assert cp_state.slot == P.p.SLOTS_PER_EPOCH
        obs.add("checkpoint state", cp_state)
        assert chain.regen.get_checkpoint_state_sync(1, root) is cp_state
        assert chain.regen.can_accept_work()
        assert chain.regen.job_len < P.regen.REGEN_CAN_ACCEPT_WORK_THRESHOLD

    asyncio.run(go())


def sc_regen_get_pre_state_dials_to_block_slot(P, obs):
    chain = P.new_chain(slot=6)
    blocks = P.blocks(2)

    async def go():
        await import_all(chain, blocks)
        fake = P.t.phase0.BeaconBlock.default()
        fake.slot = 6
        fake.parent_root = block_root(P, blocks[-1])
        pre = await chain.regen.get_pre_state(fake)
        assert pre.slot == 6
        obs.add("pre", pre)

    asyncio.run(go())


def sc_archiver_migrates_finalized_blocks(P, obs):
    """The archiver driven with a finalized checkpoint over an imported
    chain: canonical blocks move to the cold bucket with root indexes, and
    hot lookups fall through to the archive."""
    p = P.p
    db = P.db.MemoryDbController()
    chain = P.chain.BeaconChain(anchor_state=P.genesis(), bls_verifier=P.bls.BlsVerifierMock(True),
                                db=db, current_slot=p.SLOTS_PER_EPOCH + 1,
                                archive_state_epoch_frequency=0)
    blocks = P.blocks(p.SLOTS_PER_EPOCH)
    asyncio.run(import_all(chain, blocks))
    root_1 = block_root(P, blocks[0])
    head = chain.head_root
    chain.archiver.on_finalized(SimpleNamespace(epoch=1, root=head))
    assert chain.blocks_db.get_binary(root_1) is None
    obs.add("db", list(db.entries_stream()))
    got = chain.get_block_by_root(root_1)
    assert block_root(P, got) == root_1
    obs.add("by root", got)
    got2 = chain.archiver.get_archived_block_by_slot(int(blocks[0].message.slot))
    assert got2.type.serialize(got2) == blocks[0].type.serialize(blocks[0])
    st = chain.state_cache.get(head)
    archived = chain.archiver.get_archived_state_by_slot(int(st.slot))
    assert archived.type.hash_tree_root(archived) == st.type.hash_tree_root(st)
    obs.add("archived state", archived)
    assert chain.archiver.get_archived_state_at_or_before(10**6).slot == st.slot
    by_root = chain.archiver.get_archived_state_by_root(st.type.hash_tree_root(st))
    assert by_root is not None and by_root.slot == st.slot
    chain.state_cache._by_root.pop(head, None)
    fin = chain.get_finalized_state()
    assert fin is not None and int(fin.slot) <= int(st.slot) + 1
    obs.add("finalized state", fin)


# --- sync-committee pools (tests/chain/test_sync_pools.py) --------------------


@functools.lru_cache(maxsize=None)
def altair_state_bytes() -> bytes:
    j = pkg(ROOTS[0])
    far = 2**64 - 1
    cfg = j.config.minimal_chain_config().replace(
        ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=far, CAPELLA_FORK_EPOCH=far, DENEB_FORK_EPOCH=far)
    state = j.gen.create_interop_genesis_state(N_SYNC, p=j.p,
                                                   genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    j.st.process_slots(state, j.p.SLOTS_PER_EPOCH, j.p, cfg)
    return state.type.serialize(state)


def altair_state(P):
    return P.t.altair.BeaconState.deserialize(altair_state_bytes())


def _signing_root(block_root: bytes, domain: bytes) -> bytes:
    return hashlib.sha256(block_root + domain).digest()


def _sign_subnet(P, state, subnet, root, slot):
    """Signed SyncCommitteeMessages of every member of the subnet's
    subcommittee: [(msg, index in the subcommittee)]."""
    sks = secret_keys(P.root, N_SYNC)
    sub = P.p.SYNC_COMMITTEE_SIZE // P.params.SYNC_COMMITTEE_SUBNET_COUNT
    pks = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    domain = P.util.get_domain(state, P.params.DOMAIN_SYNC_COMMITTEE, slot // P.p.SLOTS_PER_EPOCH)
    by_pk = {sk.to_pubkey(): i for i, sk in enumerate(sks)}
    out = []
    for i, pk in enumerate(pks[subnet * sub:(subnet + 1) * sub]):
        msg = P.t.SyncCommitteeMessage.default()
        msg.slot = slot
        msg.beacon_block_root = root
        msg.validator_index = by_pk[pk]
        msg.signature = P.api.sign(sks[by_pk[pk]], _signing_root(root, domain))
        out.append((msg, i))
    return out


def _fake_chain(P, state, current_slot):
    return SimpleNamespace(
        p=P.p, get_head_state=lambda: state,
        fork_choice=SimpleNamespace(current_slot=current_slot),
        seen_sync_messages=P.sync_pools.SeenSlotKeyed(),
        seen_sync_aggregators=P.sync_pools.SeenSlotKeyed(),
    )


def sc_message_pool_aggregates_into_contribution(P, obs):
    state = altair_state(P)
    root, slot = b"\x07" * 32, int(state.slot)
    pool = P.sync_pools.SyncCommitteeMessagePool(P.p)
    msgs = _sign_subnet(P, state, 0, root, slot)
    obs.add("added", [pool.add(0, m, i) for m, i in msgs] + [pool.add(0, *msgs[0])])
    c = pool.get_contribution(0, slot, root)
    assert all(c.aggregation_bits)
    obs.add("contribution", c)
    assert pool.get_contribution(1, slot, b"\x08" * 32) is None
    pool.prune(slot + 10)
    assert pool.get_contribution(0, slot, root) is None


def sc_contribution_pool_merges_full_sync_aggregate(P, obs):
    state = altair_state(P)
    root, slot = b"\x09" * 32, int(state.slot)
    msg_pool = P.sync_pools.SyncCommitteeMessagePool(P.p)
    contrib_pool = P.sync_pools.SyncContributionAndProofPool(P.p)
    outcomes = []
    for subnet in range(P.params.SYNC_COMMITTEE_SUBNET_COUNT):
        for msg, idx in _sign_subnet(P, state, subnet, root, slot):
            msg_pool.add(subnet, msg, idx)
        contribution = msg_pool.get_contribution(subnet, slot, root)
        cp = P.t.ContributionAndProof.default()
        cp.contribution = contribution
        outcomes.append(contrib_pool.add(cp))
        worse = contribution.copy()
        bits = list(worse.aggregation_bits)
        bits[0] = False
        worse.aggregation_bits = bits
        cp2 = P.t.ContributionAndProof.default()
        cp2.aggregator_index = 1
        cp2.contribution = worse
        outcomes.append(contrib_pool.add(cp2))
    obs.add("outcomes", outcomes)
    agg = contrib_pool.get_sync_aggregate(slot, root)
    assert all(agg.sync_committee_bits)
    obs.add("aggregate", agg)
    all_pks = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    domain = P.util.get_domain(state, P.params.DOMAIN_SYNC_COMMITTEE, slot // P.p.SLOTS_PER_EPOCH)
    assert P.api.eth_fast_aggregate_verify(all_pks, _signing_root(root, domain),
                                           bytes(agg.sync_committee_signature))
    empty = contrib_pool.get_sync_aggregate(slot, b"\x0a" * 32)
    assert bytes(empty.sync_committee_signature) == P.sync_pools.G2_INFINITY
    obs.add("empty", empty)


def sc_validate_sync_committee_message(P, obs):
    state = altair_state(P)
    slot = int(state.slot)
    chain = _fake_chain(P, state, slot)
    msg, idx = _sign_subnet(P, state, 0, b"\x0b" * 32, slot)[0]
    v = P.validation.validate_sync_committee_message
    res = v(chain, msg, 0)
    assert idx in res.indices_in_subcommittee
    obs.add("sets", res.signature_sets)
    v(chain, msg, 0)  # not seen yet
    res.register_seen()
    obs.call_sync("again", v, chain, msg, 0)
    obs.call_sync("stale", v, _fake_chain(P, state, slot + 5), msg, 0)
    for subnet in range(1, P.params.SYNC_COMMITTEE_SUBNET_COUNT):
        obs.call_sync(f"subnet {subnet}", v, _fake_chain(P, state, slot), msg, subnet)


def sc_validate_sync_committee_contribution(P, obs):
    state = altair_state(P)
    slot = int(state.slot)
    root = b"\x0c" * 32
    epoch = slot // P.p.SLOTS_PER_EPOCH
    sks = secret_keys(P.root, N_SYNC)
    pool = P.sync_pools.SyncCommitteeMessagePool(P.p)
    for msg, idx in _sign_subnet(P, state, 0, root, slot):
        pool.add(0, msg, idx)
    contribution = pool.get_contribution(0, slot, root)
    sel = P.t.SyncAggregatorSelectionData.default()
    sel.slot = slot
    sel.subcommittee_index = 0
    sel_root = P.util.compute_signing_root(P.t.SyncAggregatorSelectionData, sel, P.util.get_domain(
        state, P.params.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch))
    sub = P.p.SYNC_COMMITTEE_SIZE // P.params.SYNC_COMMITTEE_SUBNET_COUNT
    by_pk = {sk.to_pubkey(): i for i, sk in enumerate(sks)}
    for pk in [bytes(pk) for pk in state.current_sync_committee.pubkeys][:sub]:
        proof = P.api.sign(sks[by_pk[pk]], sel_root)
        if P.validation.is_sync_committee_aggregator(proof, P.p):
            ai = by_pk[pk]
            break
    cp = P.t.ContributionAndProof.default()
    cp.aggregator_index = ai
    cp.contribution = contribution
    cp.selection_proof = proof
    signed = P.t.SignedContributionAndProof.default()
    signed.message = cp
    signed.signature = P.api.sign(sks[ai], P.util.compute_signing_root(
        P.t.ContributionAndProof, cp,
        P.util.get_domain(state, P.params.DOMAIN_CONTRIBUTION_AND_PROOF, epoch)))
    v = P.validation.validate_sync_committee_contribution
    chain = _fake_chain(P, state, slot)
    res = v(chain, signed)
    assert len(res.signature_sets) == 3
    obs.add("sets", res.signature_sets)
    res.register_seen()
    obs.call_sync("again", v, chain, signed)
    bad = signed.copy()
    bad.message.contribution.aggregation_bits = [False] * sub
    obs.call_sync("empty bits", v, _fake_chain(P, state, slot), bad)


# --- clock, op pools, seen caches (tests/chain/test_runtime.py) ----------------


class FakeTime:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def sc_clock_slot_epoch_math_and_disparity(P, obs):
    ft = FakeTime(100 + 12 * 19 + 3)
    clock = P.clock.Clock(genesis_time=100, seconds_per_slot=12, slots_per_epoch=8, time_fn=ft)
    obs.add("now", (clock.current_slot, clock.current_epoch, clock.time_at_slot(19),
                    clock.sec_from_slot(19)))
    assert clock.current_slot == 19 and clock.current_epoch == 2
    ft.t = 100 + 12 * 5 + 11.8  # 200 ms before slot 6
    obs.add("disparity", (clock.current_slot, clock.current_slot_with_gossip_disparity,
                          [clock.is_current_slot_given_gossip_disparity(s) for s in (5, 6, 7)]))
    assert clock.current_slot_with_gossip_disparity == 6
    ft.t = 100 + 12 * 5 + 2
    obs.add("past", (clock.current_slot_with_gossip_disparity,
                     clock.slot_with_future_tolerance(0.5), clock.slot_with_past_tolerance(3)))
    ft.t = 50  # before genesis
    obs.add("clamped", clock.current_slot)
    assert clock.current_slot == 0


def _att(P, slot=1, bit=0, nbits=4, sig=b"\x01"):
    att = P.t.Attestation.default()
    att.data.slot = slot
    bits = [False] * nbits
    bits[bit] = True
    att.aggregation_bits = bits
    att.signature = sig * 96
    return att


def sc_attestation_pool_naive_aggregation(P, obs):
    root = b"\x11" * 32
    pool = P.op_pools.AttestationPool()
    real = P.op_pools.aggregate_signatures
    P.op_pools.aggregate_signatures = lambda sigs: bytes(96)  # no G2 aggregation cost
    try:
        obs.add("outcomes", [pool.add(_att(P, bit=0), root), pool.add(_att(P, bit=2, sig=b"\x02"),
                                                                       root),
                             pool.add(_att(P, bit=0), root)])
        agg = pool.get_aggregate(1, root)
    finally:
        P.op_pools.aggregate_signatures = real
    assert agg.aggregation_bits == [True, False, True, False]
    obs.add("aggregate", agg)
    pool.prune(clock_slot=10)
    obs.add("old", (pool.add(_att(P, slot=2), root), pool.attestation_count()))


def sc_aggregated_pool_block_packing(P, obs):
    pool = P.op_pools.AggregatedAttestationPool()
    att1 = _att(P, slot=1, bit=0)
    obs.add("added", [pool.add(att1, b"\x01" * 32), pool.add(_att(P, slot=1, bit=1), b"\x02" * 32)])
    state = P.t.phase0.BeaconState.default()
    state.slot = 2
    out = pool.get_attestations_for_block(state, P.p)
    assert len(out) == 2
    obs.add("packed", [a.type.serialize(a) for a in out])
    obs.add("subset", pool.add(att1, b"\x01" * 32))


def sc_op_pool_dedup_and_packing(P, obs):
    pool = P.op_pools.OpPool()
    ex = P.t.SignedVoluntaryExit.default()
    ex.message.validator_index = 3
    pool.insert_voluntary_exit(ex)
    pool.insert_voluntary_exit(ex)
    assert pool.has_exit(3)
    state = P.t.phase0.BeaconState.default()
    vals = []
    for _ in range(5):
        v = P.t.Validator.default()
        v.exit_epoch = P.params.FAR_FUTURE_EPOCH
        v.withdrawable_epoch = P.params.FAR_FUTURE_EPOCH
        vals.append(v)
    state.validators = vals
    atts, props, exits = pool.get_slashings_and_exits(state, P.p)
    assert exits == [ex]
    obs.add("packed", (len(atts), len(props), [e.type.serialize(e) for e in exits]))
    state.validators[3].exit_epoch = 5
    pool.prune_all(state)
    obs.add("pruned", pool.has_exit(3))


def sc_seen_caches(P, obs):
    seen = P.op_pools.SeenAttesters()
    obs.add("before", seen.is_known(1, 42))
    seen.add(1, 42)
    obs.add("after", seen.is_known(1, 42))
    seen.prune(finalized_epoch=2)
    obs.add("pruned", seen.is_known(1, 42))
    obs.call_sync("below finalized", seen.add, 1, 7)
    aggs = P.op_pools.SeenAggregators()
    aggs.add(3, 9)
    slots = P.sync_pools.SeenSlotKeyed()
    slots.add(5, 1, 0)
    obs.add("aggregators", (aggs.is_known(3, 9), aggs.is_known(3, 8), slots.is_known(5, 1, 0)))
    slots.prune(6)
    obs.add("slot keyed pruned", slots.is_known(5, 1, 0))


def sc_slo_slack_helpers(P, obs):
    """`slo.slack_ms` (the chain's bls_verify span attribute) and the dump
    helpers, on a fake clock."""
    slo, cls = P.slo, importlib.import_module(f"{P.root}.scheduler").PriorityClass
    slo.reset_slo()
    obs.add("inactive", (slo.slack_ms(cls.API, 3), slo.slow_slot_slack(), slo.SLO_STAGES))
    try:
        slo.configure_slo(genesis_time=1000.0, seconds_per_slot=12, time_fn=lambda: 1000.0 + 40.5)
        obs.add("active", (slo.slack_ms(cls.GOSSIP_BLOCK, 3), slo.slack_ms(cls.API),
                           slo.slow_slot_slack(), slo.debug_view()["now"]))
    finally:
        slo.reset_slo()


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_chain_scenario_agrees(case):
    both(SCENARIOS[case])


def test_import_through_the_port_pool_on_the_cpu():
    """One import through the port's `BlsDeviceVerifierPool(device="cpu")`:
    the block's 2 sets in one size-8 batch on the CPU lane, verdict True as
    the JAX package's oracle gives it; the chain's head, nodes and db then
    equal a JAX chain's that imported the same block."""
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool
    from lodestar_tpu_torch.models import batch_verify as bv

    j, port = pkg(ROOTS[0]), pkg(ROOTS[1])

    async def run(P, verifier):
        chain = P.new_chain(verifier=verifier, slot=1)
        root = await chain.process_block(P.blocks(1)[0])
        if hasattr(verifier, "close"):
            await verifier.close()
        obs = Obs()
        obs.chain("chain", chain)
        return root, obs.seen

    sent = []
    pool = BlsDeviceVerifierPool(device="cpu")
    lane = pool.mesh.lanes[0]
    real = lane.verify_fn

    def counted(sets, *args, **kwargs):
        sent.append(len(sets))
        return real(sets, *args, **kwargs)

    lane.verify_fn = counted
    got = asyncio.run(run(port, pool))
    want = asyncio.run(run(j, j.bls.BlsSingleThreadVerifier()))
    assert got == want
    assert sent == [2] and bv.pad_pow2(2) == 8 and lane.launches == 1


def test_chip_smoke_gossip_objects_agree():
    """`chip_smoke.py` phase 10b's gossip helpers on the port's chain give the
    bytes this file's helpers give through either package: the
    SignedAggregateAndProof of a committee and a one-member attestation."""
    import chip_smoke

    made = {}
    for root in ROOTS:
        P = pkg(root)
        chain = validation_chain(P)
        sks = secret_keys(root)
        made[root] = [norm(signed_aggregate(P, chain, 2, 0, sks)),
                      norm(gossip_attestation(P, chain, vi_bit=1))]
    port = pkg(ROOTS[1])
    chain = validation_chain(port)
    sks = secret_keys(ROOTS[1])
    smoke = [norm(chip_smoke.signed_aggregate(chain, sks, 2, 0)),
             norm(chip_smoke.single_attestation(chain, sks, 2, 0, member=1))]
    assert smoke == made[ROOTS[1]] == made[ROOTS[0]]


def test_state_root_error_rejects_the_import(monkeypatch):
    """A departure, recorded in ROADMAP Queue 3: the state-root tracker's
    error during an import. The JAX package's tracker degrades to the value
    path and the block imports; the port's re-raises (no device fallback),
    so `process_block` raises the tracker's error, not a `BlockError`, and
    the block reaches neither fork choice nor the db."""
    from lodestar_tpu.ssz import device_htr as j_dh
    from lodestar_tpu.state_transition import htr as j_htr
    from lodestar_tpu_torch.state_transition import htr as p_htr

    def boom(self, state):
        raise RuntimeError("injected tracker bug")

    monkeypatch.setattr(j_htr.StateRootTracker, "root", boom)
    monkeypatch.setattr(p_htr.StateRootTracker, "root", boom)
    prev = j_dh.configure_device_htr(mode="on")
    try:
        j = pkg(ROOTS[0])
        jchain = j.new_chain(slot=1)
        root = asyncio.run(jchain.process_block(j.blocks(1)[0]))
        assert jchain.head_root == root
    finally:
        j_dh.configure_device_htr(mode=prev)
    port = pkg(ROOTS[1])
    chain = port.new_chain(slot=1)
    head = chain.head_root
    with pytest.raises(RuntimeError, match="injected tracker bug"):
        asyncio.run(chain.process_block(port.blocks(1)[0]))
    assert chain.head_root == head and len(chain.fork_choice.proto_array.nodes) == 1
    assert list(chain.blocks_db.db.entries_stream()) == []
