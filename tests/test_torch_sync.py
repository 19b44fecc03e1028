"""The port's sync (`lodestar_tpu_torch.sync`: `range_sync`, `backfill`,
`unknown_block`) against the JAX package's, minimal preset.

Tolerance: none. Each scenario of the JAX package's `tests/sync/test_sync.py`
runs through both packages (`both`), with the JAX test's own assertions, and
the two runs' observations must be equal: the `SyncResult` (completed, blocks
processed, the failed batch's status and attempts), the scripted network's
call log, the peers downscored, the head root, fork-choice nodes and the db's
bytes, the blocks persisted, and every error as its class and message.

Also: the departure of the port's backfill and unknown-block sync (ROADMAP
Queue 3), which type a block by its slot's fork where the JAX package types
every block as phase0 (on altair blocks the JAX package reports broken
linkage or a wrong root, the port syncs them); and, on a "cpu" lane of the
port's `BlsDeviceVerifierPool`, a range sync of 4 blocks and a backfill job
(valid, then one signature changed) with verdicts equal to the
`BlsSingleThreadVerifier`'s, and an injected device error that reaches range
sync as the verifier-outage pause (no downscore, attempts untouched).
"""

from __future__ import annotations

import asyncio

import pytest

from .test_torch_chain import ROOTS, Obs
from .test_torch_chain import minimal_cpu  # noqa: F401 - this module's fixture too
from .test_torch_network import (
    FORK_SLOTS,
    blocks16,
    both,
    chain_obs,
    fork_chain,
    fork_config,
    genesis16,
    new_chain,
    pkg,
)

N_BLOCKS = 12  # the JAX sync tests' chain


class ScriptedNetwork:
    """Serves a canonical chain; peers can be scripted to fail or lie (the
    JAX test's, for either package)."""

    def __init__(self, blocks, *, flaky_peers=(), lying_peers=()):
        self.blocks = blocks
        self.flaky = set(flaky_peers)
        self.lying = set(lying_peers)
        self.calls = []

    async def blocks_by_range(self, peer, start, count):
        self.calls.append((peer, start, count))
        if peer in self.flaky:
            raise ConnectionError("peer unreachable")
        out = [b for b in self.blocks if start <= b.message.slot < start + count]
        if peer in self.lying:
            out = [b.copy() for b in out]
            for b in out:
                b.message.state_root = b"\x13" * 32
        return out

    async def blocks_by_root(self, peer, roots):
        self.calls.append((peer, "by_root", [bytes(r) for r in roots]))
        by_root = {b.message.type.hash_tree_root(b.message): b for b in self.blocks}
        return [by_root[r] for r in roots if r in by_root]


def result_obs(obs, label, res):
    fb = res.failed_batch
    obs.add(label, (res.completed, res.processed_blocks, None if fb is None else (
        fb.start_slot, fb.count, fb.status, fb.download_attempts, fb.processing_attempts,
        fb.peer, len(fb.blocks))))


def anchor_root(P, genesis):
    header = genesis.latest_block_header.copy()
    header.state_root = genesis.type.hash_tree_root(genesis)
    return P.t.BeaconBlockHeader.hash_tree_root(header)


# --- tests/sync/test_sync.py --------------------------------------------------


def sc_range_sync_happy_path(P, obs):
    chain = new_chain(P, genesis16(P), slot=12)
    net = ScriptedNetwork(blocks16(P, N_BLOCKS))
    rs = P.range_sync.RangeSync(chain=chain, network=net, peers=["p1", "p2"])
    res = asyncio.run(rs.sync(1, 12))
    assert res.completed and res.processed_blocks == 12
    assert chain.get_head_state().slot == 12
    result_obs(obs, "result", res)
    obs.add("calls", net.calls)
    chain_obs(obs, "chain", chain)


def sc_range_sync_rotates_off_flaky_peer(P, obs):
    chain = new_chain(P, genesis16(P), slot=12)
    net = ScriptedNetwork(blocks16(P, N_BLOCKS), flaky_peers={"bad"})
    downscored = []
    rs = P.range_sync.RangeSync(chain=chain, network=net, peers=["bad", "good"],
                                on_peer_downscore=lambda peer, reason: downscored.append(
                                    (peer, reason)))
    res = asyncio.run(rs.sync(1, 12))
    assert res.completed
    assert "bad" in [p for p, _ in downscored]
    result_obs(obs, "result", res)
    obs.add("calls", net.calls)
    obs.add("downscored", downscored)
    obs.add("head", chain.head_root)


def sc_range_sync_invalid_segment_retries_then_fails(P, obs):
    chain = new_chain(P, genesis16(P), slot=12)
    net = ScriptedNetwork(blocks16(P, N_BLOCKS), lying_peers={"liar1", "liar2"})
    downscored = []
    rs = P.range_sync.RangeSync(chain=chain, network=net, peers=["liar1", "liar2"],
                                on_peer_downscore=lambda peer, reason: downscored.append(
                                    (peer, reason)))
    res = asyncio.run(rs.sync(1, 12))
    assert not res.completed
    assert res.failed_batch is not None
    assert res.failed_batch.processing_attempts == 3
    result_obs(obs, "result", res)
    obs.add("calls", net.calls)
    obs.add("downscored", downscored)
    chain_obs(obs, "chain", chain)


def sc_unknown_block_sync_walks_parents(P, obs):
    chain = new_chain(P, genesis16(P), slot=12)
    blocks = blocks16(P, N_BLOCKS)
    asyncio.run(chain.process_block(blocks[0]))
    asyncio.run(chain.process_block(blocks[1]))
    root5 = P.t.phase0.BeaconBlock.hash_tree_root(blocks[4].message)
    net = ScriptedNetwork(blocks)
    ub = P.sync.UnknownBlockSync(chain=chain, network=net, peers=["p1"])
    imported = asyncio.run(ub.resolve(root5))
    assert imported == 3
    assert chain.fork_choice.proto_array.has_block("0x" + root5.hex())
    obs.add("imported", imported)
    obs.add("calls", net.calls)
    chain_obs(obs, "chain", chain)
    try:
        asyncio.run(ub.resolve(b"\x42" * 32))
    except RuntimeError as e:
        obs.add("unknown root", (type(e).__name__, str(e)))


def _backfill(P, blocks, verifier, batch_slots, terminal_root=None, net_cls=None):
    genesis = genesis16(P)
    chain = new_chain(P, genesis, slot=12)
    net = (net_cls or ScriptedNetwork)(blocks[:-1])
    bf = P.sync.BackfillSync(chain=chain, network=net, bls_verifier=verifier, peers=["p1"],
                             anchor_state=genesis, batch_slots=batch_slots)
    root = anchor_root(P, genesis) if terminal_root is None else terminal_root
    return chain, net, bf, asyncio.run(bf.backfill(blocks[-1], until_slot=0, terminal_root=root))


def sc_backfill_verifies_linkage_and_signatures(P, obs):
    blocks = blocks16(P, N_BLOCKS)
    chain, net, _, persisted = _backfill(P, blocks, P.bls.BlsSingleThreadVerifier(), 4)
    assert persisted == 11
    assert chain.blocks_db.get(P.t.phase0.BeaconBlock.hash_tree_root(blocks[0].message)) \
        is not None
    obs.add("persisted", persisted)
    obs.add("calls", net.calls)
    obs.add("db", list(chain.blocks_db.db.entries_stream()))


def sc_backfill_truncated_range_leaves_no_hole(P, obs):
    class TruncatingNetwork(ScriptedNetwork):
        async def blocks_by_range(self, peer, start, count):
            out = await super().blocks_by_range(peer, start, count)
            return out[len(out) // 2:] if len(out) > 1 else out

    blocks = blocks16(P, N_BLOCKS)
    chain, net, _, persisted = _backfill(P, blocks, P.bls.BlsVerifierMock(True), 8,
                                         net_cls=TruncatingNetwork)
    assert persisted == 11
    obs.add("persisted", persisted)
    obs.add("calls", net.calls)
    obs.add("db", list(chain.blocks_db.db.entries_stream()))


def sc_backfill_rejects_broken_linkage(P, obs):
    blocks = blocks16(P, N_BLOCKS)
    tampered = [b.copy() for b in blocks[:-1]] + [blocks[-1]]
    tampered[5].message.parent_root = b"\x66" * 32
    with pytest.raises(P.backfill.BackfillError, match="linkage") as ei:
        _backfill(P, tampered, P.bls.BlsVerifierMock(True), 32, terminal_root=b"\x00" * 32)
    obs.add("error", (type(ei.value).__name__, str(ei.value)))
    with pytest.raises(P.backfill.BackfillError, match="no blocks") as ei:
        _backfill(P, blocks[-1:], P.bls.BlsVerifierMock(True), 4,
                  terminal_root=b"\x00" * 32)
    obs.add("empty range", (type(ei.value).__name__, str(ei.value)))
    with pytest.raises(P.backfill.BackfillError, match="signature") as ei:
        _backfill(P, blocks, P.bls.BlsVerifierMock(False), 32)
    obs.add("bad batch", (type(ei.value).__name__, str(ei.value)))


def _outage_verifier(P):
    class _OutageVerifier(P.interface.IBlsVerifier):
        async def verify_signature_sets(self, sets, opts=None):
            raise RuntimeError("verifier stack down")

        def in_outage(self):
            return True

        def can_accept_work(self):
            return True

        async def close(self):
            return None

    return _OutageVerifier()


def sc_range_sync_verifier_outage_pauses_without_downscoring(P, obs):
    chain = new_chain(P, genesis16(P), verifier=_outage_verifier(P), slot=12)
    net = ScriptedNetwork(blocks16(P, N_BLOCKS))
    downscored = []
    rs = P.range_sync.RangeSync(chain=chain, network=net, peers=["honest"],
                                on_peer_downscore=lambda peer, reason: downscored.append(peer))
    res = asyncio.run(rs.sync(1, 12))
    assert not res.completed
    assert downscored == []
    assert res.failed_batch is not None
    assert res.failed_batch.processing_attempts == 0
    assert res.failed_batch.status is P.sync.BatchStatus.AWAITING_PROCESSING
    result_obs(obs, "result", res)
    obs.add("calls", net.calls)
    chain_obs(obs, "chain", chain)


SCENARIOS = {name[3:]: fn for name, fn in list(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_sync_scenario_agrees(case):
    both(SCENARIOS[case])


def test_sync_constants_agree():
    j, p = pkg(ROOTS[0]), pkg(ROOTS[1])
    names = ("EPOCHS_PER_BATCH", "MAX_BATCH_DOWNLOAD_ATTEMPTS", "MAX_BATCH_PROCESSING_ATTEMPTS",
             "BATCH_BUFFER_SIZE")
    assert [getattr(p.range_sync, n) for n in names] == [getattr(j.range_sync, n) for n in names]
    assert [s.value for s in p.sync.BatchStatus] == [s.value for s in j.sync.BatchStatus]
    assert p.sync.unknown_block.MAX_PARENT_DEPTH == j.sync.unknown_block.MAX_PARENT_DEPTH


# --- the departure: blocks typed by fork --------------------------------------


def test_backfill_and_unknown_block_type_blocks_by_fork():
    """On the fork-crossing chain (phase0 slots 1-7, altair 8-10): the JAX
    package's backfill hashes the altair anchor's parent with the phase0 type
    and reports broken linkage, and its unknown-block sync refuses an altair
    block as the wrong block for its root; the port's backfill persists the 9
    blocks below the anchor, each as its fork's bytes, and its unknown-block
    sync imports the 3 blocks above the known head."""
    def run(P):
        genesis, blocks = fork_chain(P)
        cfg = fork_config(P)
        chain = new_chain(P, genesis, slot=FORK_SLOTS, cfg=cfg, p=P.p)
        synced = new_chain(P, genesis, slot=FORK_SLOTS, cfg=cfg, p=P.p)
        for b in blocks:
            asyncio.run(synced.process_block(b))
        # the checkpoint state: its fork (altair, previous version phase0's)
        # gives each epoch's proposer domain
        bf = P.sync.BackfillSync(chain=chain, network=ScriptedNetwork(blocks[:-1]),
                                 bls_verifier=P.bls.BlsSingleThreadVerifier(), peers=["p1"],
                                 anchor_state=synced.get_head_state(), batch_slots=4)
        out = {}
        try:
            out["backfill"] = asyncio.run(bf.backfill(
                blocks[-1], until_slot=0, terminal_root=anchor_root(P, genesis)))
        except P.backfill.BackfillError as e:
            out["backfill"] = str(e)
        out["db"] = {k: v for k, v in chain.blocks_db.db.entries_stream()}
        fresh = new_chain(P, genesis, slot=FORK_SLOTS, cfg=cfg, p=P.p)
        for b in blocks[:7]:
            asyncio.run(fresh.process_block(b))
        ub = P.sync.UnknownBlockSync(chain=fresh, network=ScriptedNetwork(blocks),
                                     peers=["p1"])
        head = blocks[-1].message.type.hash_tree_root(blocks[-1].message)
        try:
            out["unknown"] = asyncio.run(ub.resolve(head))
        except RuntimeError as e:
            out["unknown"] = str(e)
        out["head"] = fresh.head_root
        return out, blocks

    want, _ = run(pkg(ROOTS[0]))
    got, blocks = run(pkg(ROOTS[1]))
    assert want["backfill"] == "chain linkage broken at slot 9" and want["db"] == {}
    assert want["unknown"] == "peer served wrong block for root"
    assert got["backfill"] == 9 and got["unknown"] == 3
    assert got["head"] == blocks[-1].message.type.hash_tree_root(blocks[-1].message)
    by_bytes = {b.type.serialize(b) for b in blocks[:-1]}
    assert set(got["db"].values()) == by_bytes


# --- the port's pool on a "cpu" lane ------------------------------------------


async def _backfill_async(P, blocks, verifier, batch_slots):
    genesis = genesis16(P)
    chain = new_chain(P, genesis, slot=12)
    bf = P.sync.BackfillSync(chain=chain, network=ScriptedNetwork(blocks[:-1]),
                             bls_verifier=verifier, peers=["p1"], anchor_state=genesis,
                             batch_slots=batch_slots)
    persisted = await bf.backfill(blocks[-1], until_slot=0, terminal_root=anchor_root(P, genesis))
    return chain, persisted


def _counted_cpu_pool():
    """The port's pool on one "cpu" lane, its lane's batch sizes recorded."""
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

    sent = []
    pool = BlsDeviceVerifierPool(device="cpu")
    lane = pool.mesh.lanes[0]
    real = lane.verify_fn

    def counted(sets, *args, **kwargs):
        sent.append(len(sets))
        return real(sets, *args, **kwargs)

    lane.verify_fn = counted
    return pool, lane, sent


def test_range_sync_and_backfill_through_the_port_pool_on_the_cpu():
    """RangeSync of 4 blocks (4 imports at RANGE_SYNC, one size-8 batch
    each) and BackfillSync jobs (one BACKFILL job of the 3 proposer
    signatures below the slot-4 anchor, valid, then with one signature
    changed) through `BlsDeviceVerifierPool(device="cpu")`: heads, db bytes
    and verdicts equal to the same runs on the JAX package's
    `BlsSingleThreadVerifier`."""
    async def runs(P, make_verifier):
        verifier, lane, sent = make_verifier()
        blocks = blocks16(P, 4)
        obs = Obs()
        try:
            chain = new_chain(P, genesis16(P), verifier=verifier, slot=4)
            res = await P.range_sync.RangeSync(
                chain=chain, network=ScriptedNetwork(blocks), peers=["p1"]).sync(1, 4)
            result_obs(obs, "range sync", res)
            chain_obs(obs, "chain", chain)
            bad = [b.copy() for b in blocks]
            sig = bytearray(bytes(bad[1].signature))
            sig[5] ^= 1
            bad[1].signature = bytes(sig)
            for label, segment in (("backfill", blocks), ("tampered", bad)):
                try:
                    chain2, persisted = await _backfill_async(P, segment, verifier, 32)
                except P.backfill.BackfillError as e:
                    obs.add(label, str(e))
                else:
                    obs.add(label, (persisted, list(chain2.blocks_db.db.entries_stream())))
        finally:
            await verifier.close()
        return obs.seen, lane, sent

    def oracle(P):
        return lambda: (P.bls.BlsSingleThreadVerifier(), None, None)

    got, lane, sent = asyncio.run(runs(pkg(ROOTS[1]), _counted_cpu_pool))
    want = asyncio.run(runs(pkg(ROOTS[0]), oracle(pkg(ROOTS[0]))))[0]
    assert got == want
    assert want[0][1][:2] == (True, 4) and want[2][1][0] == 3
    assert want[3][1] == "segment proposer-signature batch invalid"
    assert sent[:5] == [2, 2, 2, 2, 3] and lane.launches >= 6


def test_device_error_in_the_pool_pauses_range_sync():
    """A device error in the pool's lane: the import's rejection carries
    `verifier_outage`, so range sync pauses the round (batch AWAITING_PROCESSING,
    no processing attempt spent) and downscores no peer, as the JAX package's
    outage verifier does; no verdict is served from the CPU."""
    port, j = pkg(ROOTS[1]), pkg(ROOTS[0])
    calls = []

    def broken_pool():
        pool, lane, _ = _counted_cpu_pool()

        def broken(sets, *args, **kwargs):
            calls.append(len(sets))
            raise RuntimeError("injected device error")

        lane.verify_fn = broken
        return pool

    async def run(P, make_verifier):
        verifier = make_verifier()
        try:
            chain = new_chain(P, genesis16(P), verifier=verifier, slot=4)
            downscored = []
            res = await P.range_sync.RangeSync(
                chain=chain, network=ScriptedNetwork(blocks16(P, 4)), peers=["honest"],
                on_peer_downscore=lambda peer, reason: downscored.append(peer)).sync(1, 4)
        finally:
            await verifier.close()
        obs = Obs()
        result_obs(obs, "result", res)
        obs.add("downscored", downscored)
        chain_obs(obs, "chain", chain)
        return obs.seen, res

    got, res = asyncio.run(run(port, broken_pool))
    want, _ = asyncio.run(run(j, lambda: _outage_verifier(j)))
    assert got == want
    assert res.failed_batch.status is port.sync.BatchStatus.AWAITING_PROCESSING
    assert res.failed_batch.processing_attempts == 0 and not res.completed
    assert calls


# --- chip_smoke.py phase 10c's helpers, on the CPU ----------------------------


def test_chip_smoke_segment_is_valid_for_the_jax_package():
    """`chip_smoke.build_segment` at the minimal preset (altair, bellatrix and
    capella at epoch 1): 4 Capella blocks at slots 14-17 on the 16-validator
    genesis, across the epoch boundary at 16. The JAX package's
    `state_transition`, signatures verified, accepts each block's bytes in
    turn, and its post-states' roots are the blocks' state roots."""
    import chip_smoke

    j, port = pkg(ROOTS[0]), pkg(ROOTS[1])
    cfg = chip_smoke.block_chain_config()
    jcfg = j.config.mainnet_chain_config().replace(ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=1,
                                                   CAPELLA_FORK_EPOCH=1)
    sks = [port.api.SecretKey(sk.scalar) for sk in pkg(ROOTS[0]).gen.interop_secret_keys(16)]
    blocks = chip_smoke.build_segment(genesis16(port), sks, port.p, cfg, range(14, 18))
    assert [int(b.message.slot) for b in blocks] == [14, 15, 16, 17]
    state = genesis16(j)
    for b in blocks:
        jsigned = j.t.capella.SignedBeaconBlock.deserialize(b.type.serialize(b))
        state = j.st.state_transition(state, jsigned, j.p, jcfg)
        assert state.type.hash_tree_root(state) == bytes(b.message.state_root)
    assert bytes(blocks[0].message.parent_root) == anchor_root(j, genesis16(j))
