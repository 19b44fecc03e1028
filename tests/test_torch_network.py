"""The port's network layer (`lodestar_tpu_torch.network`: `gossip`, `peers`,
`reqresp_node`, `processor`) against the JAX package's, minimal preset.

Tolerance: none. Each scenario of the JAX package's
`tests/network/test_network.py` and `tests/network/test_processor.py` runs
through both packages (`both`), with the JAX test's own assertions, and the
two runs' observations must be equal: topic strings and message ids, what the
bus delivered and deduplicated, peer scores on a fake clock, chains as their
heads, fork-choice nodes and db bytes, and the processor's `processed`,
`errors`, queue lengths, drops and the peers it reported. Beside them: the
two-node range sync over 127.0.0.1 with the server from one package and the
client from the other, both ways, on phase0 blocks over blocks-by-range v1
and on a chain that crosses phase0 -> altair over v2 (fork-digest context
bytes); the head roots must be equal and each synced block's bytes the
server's.

Blocks and genesis are the JAX package's, carried into the port as SSZ bytes;
the port's HTR device is the CPU (the chain's fixture, imported below).
"""

from __future__ import annotations

import asyncio
import functools
import importlib

import pytest

from .test_torch_chain import (  # noqa: F401 - minimal_cpu is this module's fixture too
    ROOTS,
    Obs,
    genesis_bytes,
    minimal_cpu,
    norm,
    secret_keys,
)
from .test_torch_chain import both as chain_both
from .test_torch_chain import pkg as chain_pkg

N = 16  # validators, as the JAX package's network and sync tests
FORK_SLOTS = 10  # the fork-crossing chain: phase0 slots 1-7, altair 8-10
_MODULES = {
    "network": "network", "peers": "network.peers", "processor": "network.processor",
    "node": "network.reqresp_node", "reqresp": "reqresp", "sync": "sync",
    "range_sync": "sync.range_sync", "backfill": "sync.backfill", "snappy": "utils.snappy",
    "interface": "chain.bls.interface", "sched": "scheduler",
}


def pkg(root: str):
    """The chain file's package rig with the network and sync modules added."""
    P = chain_pkg(root)
    for attr, name in _MODULES.items():
        if not hasattr(P, attr):
            setattr(P, attr, importlib.import_module(f"{root}.{name}"))
    return P


def both(scenario, *args):
    """The chain file's `both`, with the network and sync modules loaded."""
    for root in ROOTS:
        pkg(root)
    return chain_both(scenario, *args)


def _block_at(P, state, slot, sks, cfg=None):
    """A signed empty block of the state's fork at `slot` on `state` (not
    mutated): randao reveal, eth1 data, an empty sync aggregate from altair
    on, its state root, its proposer's signature."""
    block_mod = importlib.import_module(f"{P.root}.state_transition.block")
    work = state.copy()
    ctx = P.st.process_slots(work, slot, P.p, cfg) if cfg else P.st.process_slots(work, slot, P.p)
    fork = block_mod.fork_of(work)
    ns = getattr(P.t, fork)
    proposer = ctx.get_beacon_proposer(slot)
    block = ns.BeaconBlock.default()
    block.slot = slot
    block.proposer_index = proposer
    block.parent_root = P.t.BeaconBlockHeader.hash_tree_root(work.latest_block_header)
    block.body.randao_reveal = P.api.sign(sks[proposer], P.util.compute_signing_root(
        P.ssz.uint64, slot // P.p.SLOTS_PER_EPOCH, P.util.get_domain(work, P.params.DOMAIN_RANDAO)))
    block.body.eth1_data = work.eth1_data
    if fork != "phase0":
        block.body.sync_aggregate.sync_committee_bits = [False] * P.p.SYNC_COMMITTEE_SIZE
        block.body.sync_aggregate.sync_committee_signature = P.api.G2_INFINITY
    post = work.copy()
    P.st.process_block(post, block, P.st.EpochContext(post, P.p), verify_signatures=False, cfg=cfg)
    block.state_root = post.type.hash_tree_root(post)
    signed = ns.SignedBeaconBlock.default()
    signed.message = block
    signed.signature = P.api.sign(sks[proposer], P.util.compute_signing_root(
        ns.BeaconBlock, block, P.util.get_domain(work, P.params.DOMAIN_BEACON_PROPOSER)))
    return signed, post


@functools.lru_cache(maxsize=None)
def chain_bytes(n: int) -> tuple:
    """n consecutive signed phase0 blocks on the JAX package's 16-validator
    interop genesis, as SSZ bytes."""
    j = pkg(ROOTS[0])
    state, sks, out = j.t.phase0.BeaconState.deserialize(genesis_bytes(N)), secret_keys(
        ROOTS[0], N), []
    for slot in range(1, n + 1):
        signed, state = _block_at(j, state, slot, sks)
        out.append(signed.type.serialize(signed))
    return tuple(out)


def genesis16(P):
    return P.t.phase0.BeaconState.deserialize(genesis_bytes(N))


def blocks16(P, n):
    return [P.t.phase0.SignedBeaconBlock.deserialize(b) for b in chain_bytes(n)]


def fork_config(P):
    """Minimal chain config with altair at epoch 1 (slot 8), no later fork."""
    far = 2**64 - 1
    return P.config.minimal_chain_config().replace(
        ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=far, CAPELLA_FORK_EPOCH=far,
        DENEB_FORK_EPOCH=far)


@functools.lru_cache(maxsize=None)
def fork_chain_bytes() -> tuple:
    """(genesis, [(fork, block)]) of the fork-crossing chain, built by the
    JAX package, as SSZ bytes."""
    j = pkg(ROOTS[0])
    cfg = fork_config(j)
    genesis = j.gen.create_interop_genesis_state(
        N, p=j.p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    state, sks, out = genesis, secret_keys(ROOTS[0], N), []
    for slot in range(1, FORK_SLOTS + 1):
        signed, state = _block_at(j, state, slot, sks, cfg)
        fork = "phase0" if signed.type is j.t.phase0.SignedBeaconBlock else "altair"
        out.append((fork, signed.type.serialize(signed)))
    return genesis.type.serialize(genesis), tuple(out)


def fork_chain(P):
    g, blocks = fork_chain_bytes()
    return (P.t.phase0.BeaconState.deserialize(g),
            [getattr(P.t, fork).SignedBeaconBlock.deserialize(b) for fork, b in blocks])


def new_chain(P, genesis, verifier=None, slot=1, **kw):
    return P.chain.BeaconChain(
        anchor_state=genesis,
        bls_verifier=verifier if verifier is not None else P.bls.BlsVerifierMock(True),
        db=P.db.MemoryDbController(), current_slot=slot, **kw)


def chain_obs(obs, label, chain):
    fc = chain.fork_choice
    obs.add(label, (fc.head, [(n.block_root, n.parent, n.slot) for n in fc.proto_array.nodes],
                    list(chain.blocks_db.db.entries_stream())))


# --- gossip and peers (tests/network/test_network.py) -------------------------


def sc_topic_naming(P, obs):
    t = P.network.GossipTopic("beacon_block", bytes.fromhex("deadbeef"))
    assert obs.add("topic", str(t)) == "/eth2/deadbeef/beacon_block/ssz_snappy"
    assert obs.add("string", P.network.topic_string("beacon_attestation_3", b"\x00" * 4)) == \
        "/eth2/00000000/beacon_attestation_3/ssz_snappy"


def sc_message_id_domains(P, obs):
    payload = b"hello gossip" * 10
    valid = P.network.compute_message_id(P.snappy.compress(payload))
    invalid = P.network.compute_message_id(b"\xff not snappy")
    assert len(valid) == 20 and len(invalid) == 20 and valid != invalid
    assert P.network.compute_message_id(P.snappy.compress(payload)) == valid
    obs.add("ids", (valid, invalid))
    block = blocks16(P, 1)[0]
    obs.add("block id", P.network.compute_message_id(
        P.snappy.compress(block.type.serialize(block))))


def sc_bus_fanout_and_dedup(P, obs):
    async def go():
        bus = P.network.GossipBus()
        topic = P.network.GossipTopic("beacon_block", b"\x00" * 4)
        got_a, got_b = [], []

        async def on_a(data, frm):
            got_a.append((data, frm))

        async def on_b(data, frm):
            got_b.append((data, frm))

        bus.subscribe(topic, "a", on_a)
        bus.subscribe(topic, "b", on_b)
        n = await bus.publish(topic, b"block-bytes", from_peer="a")
        assert n == 1
        assert got_b == [(b"block-bytes", "a")] and got_a == []
        assert await bus.publish(topic, b"block-bytes", from_peer="b") == 0
        assert bus.deduped == 1
        bus.unsubscribe(topic, "b")
        n2 = await bus.publish(topic, b"other-bytes", from_peer="c")
        obs.add("bus", (n, n2, got_a, got_b, bus.delivered, bus.deduped))

    asyncio.run(go())


def sc_two_nodes_gossip_block_import(P, obs):
    async def go():
        genesis = genesis16(P)
        node_a, node_b = new_chain(P, genesis), new_chain(P, genesis)
        bus = P.network.GossipBus()
        topic = P.network.GossipTopic("beacon_block", b"\x00" * 4)

        async def b_on_block(data, frm):
            signed = P.t.phase0.SignedBeaconBlock.deserialize(data)
            P.validation.validate_gossip_block(node_b, signed)
            await node_b.process_block(signed)

        bus.subscribe(topic, "b", b_on_block)
        signed = blocks16(P, 1)[0]
        await node_a.process_block(signed)
        await bus.publish(topic, P.t.phase0.SignedBeaconBlock.serialize(signed), from_peer="a")
        assert node_b.head_root == node_a.head_root
        chain_obs(obs, "node b", node_b)

    asyncio.run(go())


def sc_peer_scoring_decay_and_thresholds(P, obs):
    now = [0.0]
    peers = P.peers
    score = peers.PeerScore(time_fn=lambda: now[0])
    score.apply(peers.PeerAction.MID_TOLERANCE_ERROR)
    score.apply(peers.PeerAction.MID_TOLERANCE_ERROR)
    assert score.score == pytest.approx(-10.0)
    assert score.state is peers.ScoreState.HEALTHY
    seen = [(score.score, score.state)]
    for dt in (600, 1, 3600):
        now[0] += dt
        seen.append((score.score, score.state))
    assert seen[1][0] == pytest.approx(-5.0, rel=0.01)
    for action in (peers.PeerAction.LOW_TOLERANCE_ERROR, peers.PeerAction.HIGH_TOLERANCE_ERROR,
                   peers.PeerAction.FATAL):
        score.apply(action)
        seen.append((score.score, score.state))
    assert score.state is peers.ScoreState.BANNED
    obs.add("scores", seen)


def sc_peer_manager_prunes_worst(P, obs):
    now = [0.0]
    peers = P.peers
    pm = peers.PeerManager(target_peers=2, time_fn=lambda: now[0])
    for pid in ("p1", "p2", "p3"):
        pm.on_connect(pid)
    pm.report_peer("p2", peers.PeerAction.MID_TOLERANCE_ERROR)
    obs.add("best", pm.best_peers())
    pm.heartbeat()
    assert sorted(pm.connected_peers()) == ["p1", "p3"]
    state = pm.report_peer("p1", peers.PeerAction.FATAL)
    assert state is peers.ScoreState.BANNED
    assert pm.connected_peers() == ["p3"]
    pm.on_disconnect("p3")
    obs.add("left", (state, pm.connected_peers(), pm.best_peers(1)))


# --- processor (tests/network/test_processor.py) ------------------------------


def queues_obs(proc):
    return {t: (len(q), q.dropped) for t, q in sorted(proc.queues.items())}


def sc_queue_policies(P, obs):
    pr = P.processor
    lifo = pr._TopicQueue(2, "LIFO")
    pushed = [lifo.push(pr.PendingItem("t", i, "")) for i in range(3)]
    assert lifo.dropped == 1
    popped = [lifo.pop().message, lifo.pop().message, lifo.pop()]
    assert popped[:2] == [2, 1]
    fifo = pr._TopicQueue(2, "FIFO")
    pushed += [fifo.push(pr.PendingItem("t", i, "")) for i in range(3)]
    assert pushed[-1] is False
    popped += [fifo.pop().message, len(fifo), fifo.dropped]
    assert popped[3] == 0
    obs.add("queues", (pushed, popped, lifo.dropped))
    obs.add("opts", (pr.GOSSIP_QUEUE_OPTS, pr.EXECUTE_ORDER, sorted(pr.BYPASS_BACKPRESSURE),
                     pr.MAX_JOBS_SUBMITTED_PER_TICK))


def sc_backpressure_gates_all_but_blocks(P, obs):
    chain = new_chain(P, genesis16(P), slot=2)

    async def go():
        calls = []

        async def h_block(m, peer):
            calls.append("block")

        async def h_att(m, peer):
            calls.append("att")

        proc = P.processor.NetworkProcessor(
            chain, handlers={"beacon_block": h_block, "beacon_attestation": h_att})
        proc.push("beacon_block", object())
        proc.push("beacon_attestation", object())
        assert not proc.push("no_such_topic", object())
        chain.bls.can_accept_work = lambda: False
        n = await proc.execute_work()
        assert n == 1 and calls == ["block"]
        obs.add("gated", (n, list(calls), proc.pending, queues_obs(proc)))
        chain.bls.can_accept_work = lambda: True
        n2 = await proc.execute_work()
        assert n2 == 1 and calls == ["block", "att"]
        obs.add("drained", (n2, list(calls), proc.pending, proc.processed, proc.errors))

    asyncio.run(go())


def sc_default_handlers_end_to_end(P, obs):
    genesis = genesis16(P)
    sks = secret_keys(P.root, N)
    chain = new_chain(P, genesis, slot=2)
    t = P.t
    proc = P.processor.NetworkProcessor(chain)
    assert proc.push("beacon_block", blocks16(P, 1)[0])

    async def go():
        n = await proc.execute_work()
        assert n == 1 and proc.errors == 0
        assert chain.get_head_state().slot == 1
        state = chain.get_head_state()
        ctx = P.st.EpochContext(state, P.p)
        committee = ctx.get_beacon_committee(1, 0)
        data = P.produce.make_attestation_data(chain, 1, 0)
        att = t.Attestation.default()
        bits = [False] * len(committee)
        bits[0] = True
        att.aggregation_bits = bits
        att.data = data
        vi = int(committee[0])
        domain = P.util.get_domain(state, P.params.DOMAIN_BEACON_ATTESTER, data.target.epoch)
        att.signature = P.api.sign(sks[vi], P.util.compute_signing_root(
            t.AttestationData, data, domain))
        assert proc.push("beacon_attestation", att)
        n2 = await proc.execute_work()
        assert n2 == 1 and proc.errors == 0, f"errors={proc.errors}"
        root = t.AttestationData.hash_tree_root(data)
        agg = chain.attestation_pool.get_aggregate(1, root)
        assert agg is not None
        obs.add("pooled", agg)
        obs.add("counts", (n, n2, proc.processed, proc.errors, queues_obs(proc)))
        obs.add("votes", chain.fork_choice.votes.current.tolist())
        chain_obs(obs, "chain", chain)

    asyncio.run(go())


class _Count:
    def __init__(self):
        self.n = {}

    def labels(self, *key):
        n = self.n

        class _One:
            def inc(self, by=1):
                n[key] = n.get(key, 0) + by

            def set(self, value):
                n[key] = value

        return _One()

    def inc(self, by=1):
        self.n[()] = self.n.get((), 0) + by

    def set(self, value):
        self.n[()] = value


class FakeMetrics:
    """The duck-typed metrics the processor and `DegradingBlsVerifier` touch."""

    def __init__(self):
        self.resilience = type("R", (), {})()
        for name in ("outage_unscored", "shed", "fallback_active", "fallback_verifications",
                     "fallback_skipped"):
            setattr(self.resilience, name, _Count())
        self.sched = type("S", (), {"shed_total": _Count()})()

    def seen(self):
        r = self.resilience
        return {k: getattr(r, k).n for k in sorted(vars(r))} | {"sched": self.sched.shed_total.n}


def sc_verifier_outage_rejections_do_not_downscore_peers(P, obs):
    genesis = genesis16(P)

    class _Erring(P.interface.IBlsVerifier):
        async def verify_signature_sets(self, sets, opts=None):
            raise RuntimeError("offload down")

        def can_accept_work(self):
            return True

        async def close(self):
            return None

    async def go():
        reports = []
        chain = new_chain(P, genesis, verifier=P.bls.BlsVerifierMock(False), slot=2, p=P.p)
        proc = P.processor.NetworkProcessor(chain, report_peer=lambda peer, why: reports.append(
            (peer, why)))
        proc.push("beacon_block", blocks16(P, 1)[0], peer="peerA")
        await proc.execute_work()
        assert proc.errors == 1
        assert [p for p, _ in reports] == ["peerA"]
        obs.add("invalid", (proc.processed, proc.errors, reports))

        reports2 = []
        metrics = FakeMetrics()
        deg = P.bls.DegradingBlsVerifier([("offload", _Erring())], metrics=metrics.resilience)
        chain2 = new_chain(P, genesis, verifier=deg, slot=2, p=P.p)
        proc2 = P.processor.NetworkProcessor(
            chain2, metrics=metrics, report_peer=lambda peer, why: reports2.append(peer))
        proc2.push("beacon_block", blocks16(P, 1)[0], peer="peerB")
        await proc2.execute_work()
        assert proc2.errors == 1
        assert deg.in_outage()
        assert reports2 == []
        assert metrics.resilience.outage_unscored.n == {(): 1}
        obs.add("outage", (proc2.processed, proc2.errors, reports2, metrics.seen()))

        # a backpressured tick counts its shed topics once, by launch class
        proc3 = P.processor.NetworkProcessor(chain2, metrics=metrics)
        chain2.bls.can_accept_work = lambda: False
        proc3.push("beacon_attestation", object())
        proc3.push("voluntary_exit", object())
        obs.add("shed", (await proc3.execute_work(), metrics.seen(), queues_obs(proc3)))

    asyncio.run(go())


SCENARIOS = {name[3:]: fn for name, fn in list(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_network_scenario_agrees(case):
    both(SCENARIOS[case])


# --- two-node range sync over TCP ---------------------------------------------


class WireNet:
    """RangeSync's network over req/resp blocks-by-range (`version` 1 or 2)."""

    def __init__(self, C, client, dial, version=1):
        self.C, self.client, self.dial, self.version = C, client, dial, version
        self.got = []

    async def blocks_by_range(self, peer, start, count):
        req = self.C.t.BeaconBlocksByRangeRequest.default()
        req.start_slot, req.count, req.step = start, count, 1
        out = await self.client.send_request(
            self.dial, f"/eth2/beacon_chain/req/beacon_blocks_by_range/{self.version}/ssz_snappy",
            req)
        self.got += [(b.type.name, b.type.serialize(b)) for b in out]
        return out


async def serve(node):
    server = await asyncio.start_server(
        lambda r, w: node.handle_stream(r, w, "client"), "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]

    async def dial():
        return await asyncio.open_connection("127.0.0.1", port)

    return server, dial


async def two_node_sync(S, C, *, fork_crossing=False):
    """Server package S serves its chain; a fresh chain of package C range-syncs
    from it over 127.0.0.1. Returns what the client saw."""
    seen = Obs()
    if fork_crossing:
        sg, sblocks = fork_chain(S)
        cg, _ = fork_chain(C)
        skw, ckw = {"cfg": fork_config(S), "p": S.p}, {"cfg": fork_config(C), "p": C.p}
        target, version = FORK_SLOTS, 2
    else:
        sg, sblocks, cg = genesis16(S), blocks16(S, 4), genesis16(C)
        skw = ckw = {}
        target, version = 4, 1
    server_chain = new_chain(S, sg, slot=target, **skw)
    for b in sblocks:
        await server_chain.process_block(b)
    node = S.node.ReqRespBeaconNode(server_chain)
    server, dial = await serve(node)
    try:
        fresh = new_chain(C, cg, slot=target, **ckw)
        client = C.node.ReqRespBeaconNode(fresh) if fork_crossing else C.reqresp.ReqResp()
        status = (await client.send_request(
            dial, "/eth2/beacon_chain/req/status/1/ssz_snappy", C.t.Status.default()))[0]
        assert status.head_slot == target
        seen.add("status", status)
        net = WireNet(C, client, dial, version)
        res = await C.range_sync.RangeSync(chain=fresh, network=net, peers=["srv"]).sync(
            1, target)
        assert res.completed
        assert fresh.head_root == server_chain.head_root
        seen.add("result", (res.completed, res.processed_blocks, fresh.head_root))
        seen.add("blocks", net.got)
        assert [b for _, b in net.got] == [b.type.serialize(b) for b in sblocks]
        if fork_crossing:
            v1 = WireNet(C, client, dial, 1)
            await v1.blocks_by_range("srv", 1, target)
            seen.add("v1 stops at altair", len(v1.got))
            assert len(v1.got) == 7
            seen.add("digests", [client._fork_to_digest(f) for f in ("phase0", "altair")])
        chain_obs(seen, "client chain", fresh)
    finally:
        server.close()
    return seen.seen


PAIRS = [(ROOTS[0], ROOTS[1]), (ROOTS[1], ROOTS[0])]
PAIR_IDS = ["jax_server-port_client", "port_server-jax_client"]


@pytest.mark.parametrize("server,client", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("fork_crossing", [False, True], ids=["phase0_v1", "altair_v2"])
def test_two_node_range_sync_across_packages(server, client, fork_crossing):
    """The JAX test's two-node sync (`test_reqresp_beacon_node_serves_chain`)
    with the server from one package and the client from the other: what the
    client saw equals what a JAX client saw of a JAX server."""
    want = asyncio.run(two_node_sync(pkg(ROOTS[0]), pkg(ROOTS[0]), fork_crossing=fork_crossing))
    got = asyncio.run(two_node_sync(pkg(server), pkg(client), fork_crossing=fork_crossing))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert g == w, f"{label} differs"


def test_reqresp_node_handlers_agree():
    """Every handler of `ReqRespBeaconNode` on the fork-crossing chain, both
    packages' servers asked by the port's client: status, ping, metadata,
    blocks by range and by root (v1 and v2), goodbye, blobs by range, and the
    light-client protocols' error chunks (no light-client server)."""
    async def ask(S):
        sg, sblocks = fork_chain(S)
        chain = new_chain(S, sg, slot=FORK_SLOTS, cfg=fork_config(S), p=S.p)
        for b in sblocks:
            await chain.process_block(b)
        node = S.node.ReqRespBeaconNode(chain, metadata_seq=3)
        server, dial = await serve(node)
        C = pkg(ROOTS[1])
        cg, _ = fork_chain(C)
        client = C.node.ReqRespBeaconNode(new_chain(C, cg, cfg=fork_config(C), p=C.p))
        out = []

        async def call(name, version, req):
            pid = f"/eth2/beacon_chain/req/{name}/{version}/ssz_snappy"
            try:
                got = await client.send_request(dial, pid, req)
            except C.reqresp.ResponseError as e:
                out.append((name, version, "error", e.status, str(e)))
            else:
                out.append((name, version, norm(got)))

        roots = [b.message.type.hash_tree_root(b.message) for b in sblocks]
        rng = C.t.BeaconBlocksByRangeRequest.default()
        rng.start_slot, rng.count, rng.step = 3, 6, 1
        bad = C.t.BeaconBlocksByRangeRequest.default()
        bad.start_slot, bad.count, bad.step = 3, 6, 2
        await call("status", 1, C.t.Status.default())
        await call("ping", 1, 5)
        await call("metadata", 1, None)
        await call("goodbye", 1, 1)
        for version in (1, 2):
            await call("beacon_blocks_by_range", version, rng)
            await call("beacon_blocks_by_range", version, bad)
            await call("beacon_blocks_by_root", version, [roots[1], roots[8], b"\x09" * 32])
        blobs = C.t.deneb.BlobsSidecarsByRangeRequest.default()
        blobs.start_slot, blobs.count = 1, 10
        await call("blobs_sidecars_by_range", 1, blobs)
        await call("light_client_bootstrap", 1, roots[0])
        await call("light_client_finality_update", 1, None)
        await call("light_client_optimistic_update", 1, None)
        server.close()
        return out

    want = asyncio.run(ask(pkg(ROOTS[0])))
    got = asyncio.run(ask(pkg(ROOTS[1])))
    assert got == want
    assert any(r[2] == "error" for r in want) and len(want) == 14


def test_chip_smoke_wire_falls_back_to_memory_streams(monkeypatch):
    """`chip_smoke.open_wire` where the host refuses a loopback socket: the
    in-memory stream pairs carry req/resp streams as TCP does, and the
    transport is named."""
    import chip_smoke

    P = pkg(ROOTS[1])

    async def refused(*args, **kwargs):
        raise OSError("loopback refused")

    async def go(refuse):
        if refuse:
            monkeypatch.setattr(asyncio, "start_server", refused)
        genesis, blocks = fork_chain(P)
        chain = new_chain(P, genesis, slot=FORK_SLOTS, cfg=fork_config(P), p=P.p)
        for b in blocks:
            await chain.process_block(b)
        dial, transport, close = await chip_smoke.open_wire(P.node.ReqRespBeaconNode(chain))
        try:
            status = (await P.node.ReqRespBeaconNode(chain).send_request(
                dial, "/eth2/beacon_chain/req/status/1/ssz_snappy", P.t.Status.default()))[0]
            net = chip_smoke.WireNet(P.node.ReqRespBeaconNode(chain), dial, P.t)
            got = await net.blocks_by_range("server", 7, 3)
        finally:
            close()
        return transport, norm(status), norm(got), [d[:3] for d in net.downloads]

    tcp = asyncio.run(go(False))
    memory = asyncio.run(go(True))
    assert tcp[0] == "tcp 127.0.0.1" and memory[0] == "in-memory streams"
    assert memory[1:] == tcp[1:] and tcp[3] == [(7, 3, 3)]
