"""The port's gossipsub (`lodestar_tpu_torch.network.gossipsub`) against the
JAX package's.

Tolerance: none. `encode_rpc` is compared byte for byte on seeded RPCs and
each package decodes the other's; the routers of the JAX test file
(`tests/network/test_gossipsub.py`) run over real sockets on 127.0.0.1 with
the packages mixed in one network: a three-node relay in a line, a rejecting
middle node (penalty, no propagation), IWANT served from the message cache
and its expiry, each run's observations equal to an all-JAX run's; and the P3
mesh-delivery penalty under one injected `time_fn`, where every score, mesh
and captured P3b penalty must be equal between the packages.
"""

from __future__ import annotations

import asyncio
import importlib
import random
from types import SimpleNamespace

import pytest

from .test_torch_chain import ROOTS

TOPIC = "/eth2/00000000/beacon_block/ssz_snappy"
J, T = ROOTS
NAMES = {J: "jax", T: "port"}


def gs(root: str) -> SimpleNamespace:
    return SimpleNamespace(
        gossipsub=importlib.import_module(f"{root}.network.gossipsub"),
        host=importlib.import_module(f"{root}.network.transport.host"),
        snappy=importlib.import_module(f"{root}.utils.snappy"),
    )


def _ids(layout):
    return "-".join(NAMES[r] for r in layout)


# --- the RPC codec ------------------------------------------------------------


def _random_rpc(rng):
    def mid():
        return rng.randbytes(20)

    def topic():
        return f"/eth2/{rng.randbytes(4).hex()}/t{rng.randrange(100)}/ssz_snappy"

    return dict(
        subscriptions=[(rng.random() < 0.5, topic()) for _ in range(rng.randrange(3))],
        publish=[(topic(), rng.randbytes(rng.randrange(0, 300))) for _ in range(rng.randrange(3))],
        ihave=[(topic(), [mid() for _ in range(rng.randrange(1, 4))])
               for _ in range(rng.randrange(3))],
        iwant=[mid() for _ in range(rng.randrange(3))],
        graft=[topic() for _ in range(rng.randrange(3))],
        prune=[(topic(), rng.randrange(0, 300)) for _ in range(rng.randrange(3))],
    )


def test_rpc_codec_is_bytes_equal_and_decodes_across():
    j, t = gs(J).gossipsub, gs(T).gossipsub
    rng = random.Random(11)
    cases = [dict(subscriptions=[(True, "a"), (False, "b")], publish=[("t", b"payload")],
                  ihave=[("t", [b"\x01" * 20, b"\x02" * 20])], iwant=[b"\x03" * 20],
                  graft=["t"], prune=[("u", 60)])] + [_random_rpc(rng) for _ in range(30)]
    for rpc in cases:
        raw = t.encode_rpc(**rpc)
        assert raw == j.encode_rpc(**rpc)
        want = {k: v for k, v in rpc.items()}
        for dec in (t.decode_rpc(raw), j.decode_rpc(raw)):
            assert dec == want
    assert t.PROTOCOL_ID == j.PROTOCOL_ID == "/meshsub/1.1.0"
    assert vars(t.GossipParams).keys() == vars(j.GossipParams).keys()
    for k in vars(j.GossipParams):
        if k.isupper():
            assert getattr(t.GossipParams, k) == getattr(j.GossipParams, k)


# --- routers over sockets, packages mixed -------------------------------------


async def _mk_router(root, handler=None):
    m = gs(root)
    host = m.host.Libp2pHost()
    router = m.gossipsub.GossipSub(host)

    async def validator(topic, raw, peer):
        try:
            return "accept", m.snappy.decompress(raw)
        except Exception:
            return "reject", b""

    router.set_validator(validator)
    await host.listen()
    await router.subscribe(TOPIC, handler)
    return host, router


async def _line(layout, *, reject_middle=False):
    """a - b - c in a line; a publishes. What b and c received, the dedup of a
    republish, and the middle node's metrics and penalty of a."""
    got_b, got_c = [], []

    async def on_b(ssz, peer):
        got_b.append(ssz)

    async def on_c(ssz, peer):
        got_c.append(ssz)

    ha, ga = await _mk_router(layout[0])
    hb, gb = await _mk_router(layout[1], on_b)
    hc, gc = await _mk_router(layout[2], on_c)
    if reject_middle:
        async def reject_all(topic, raw, peer):
            return "reject", b""

        gb.set_validator(reject_all)
    await ha.connect("127.0.0.1", hb.listen_port)
    await hb.connect("127.0.0.1", hc.listen_port)
    for _ in range(50):  # the subscription exchange, both ways on both links
        if (TOPIC in gb.peer_topics.get(ha.peer_id, ()) and TOPIC in ga.peer_topics.get(
                hb.peer_id, ()) and TOPIC in gc.peer_topics.get(hb.peer_id, ())
                and TOPIC in gb.peer_topics.get(hc.peer_id, ())):
            break
        await asyncio.sleep(0.02)
    for g in (ga, gb, gc):
        await g.heartbeat()
    await asyncio.sleep(0.1)
    meshes = [sorted(len(g.mesh[TOPIC]) for g in (ga, gb, gc))]
    payload = b"invalid-payload" if reject_middle else b"block-ssz-bytes"
    sent = await ga.publish(TOPIC, payload)
    for _ in range(40):
        if (got_b and got_c) or (reject_middle and gb.metrics["rejected"]):
            break
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.2 if reject_middle else 0.05)
    out = {
        "sent": sent, "got_b": got_b, "got_c": got_c, "meshes": meshes,
        "b_metrics": dict(gb.metrics), "c_metrics": dict(gc.metrics),
        "republish": await ga.publish(TOPIC, payload),
        "a_invalid_at_b": gb.scores[ha.peer_id].topic(TOPIC).invalid,
    }
    for h in (ha, hb, hc):
        await h.close()
    return out


LINES = [(J, J, J), (T, T, T), (J, T, J), (T, J, T), (T, T, J)]


@pytest.mark.parametrize("layout", LINES, ids=[_ids(x) for x in LINES])
def test_publish_relays_along_a_line(layout):
    want = asyncio.run(_line((J, J, J)))
    got = asyncio.run(_line(layout))
    assert got == want
    assert want["got_b"] == [b"block-ssz-bytes"] and want["got_c"] == [b"block-ssz-bytes"]
    assert want["sent"] >= 1 and want["republish"] == 0


@pytest.mark.parametrize("layout", LINES[1:4], ids=[_ids(x) for x in LINES[1:4]])
def test_reject_penalizes_and_does_not_propagate(layout):
    want = asyncio.run(_line((J, J, J), reject_middle=True))
    got = asyncio.run(_line(layout, reject_middle=True))
    assert got == want
    assert want["got_c"] == [] and want["b_metrics"]["rejected"] == 1
    assert want["a_invalid_at_b"] > 0


async def _iwant(ra, rb):
    ha, ga = await _mk_router(ra)
    hb, gb = await _mk_router(rb)
    await ha.connect("127.0.0.1", hb.listen_port)
    for _ in range(50):
        if TOPIC in ga.peer_topics.get(hb.peer_id, ()) and TOPIC in gb.peer_topics.get(
                ha.peer_id, ()):
            break
        await asyncio.sleep(0.02)
    for g in (ga, gb):
        await g.heartbeat()
    await ga.publish(TOPIC, b"payload-1")
    for _ in range(40):
        if gb.mcache_index:
            break
        await asyncio.sleep(0.05)
    msg_id = next(iter(gb.mcache_index))
    before = gb.metrics["iwant_served"]
    await gb._on_iwant(ha.peer_id, [msg_id])
    served = gb.metrics["iwant_served"] - before
    await asyncio.sleep(0.1)
    dup_at_a = ga.metrics["duplicates"]
    for _ in range(gb.p.MCACHE_LEN + 1):
        await gb.heartbeat()
    out = (msg_id, served, dup_at_a, msg_id in gb.mcache_index, gb.mcache_index.get(msg_id))
    await ha.close()
    await hb.close()
    return out


@pytest.mark.parametrize("ra,rb", [(J, T), (T, J), (T, T)],
                         ids=["jax-port", "port-jax", "port-port"])
def test_iwant_is_served_from_the_mcache(ra, rb):
    want = asyncio.run(_iwant(J, J))
    got = asyncio.run(_iwant(ra, rb))
    assert got == want
    assert want[1] == 1 and want[2] == 1 and want[3] is False


# --- P3 under one clock -------------------------------------------------------


class _FakeHost:
    on_peer_connect = None
    on_peer_disconnect = None

    def set_handler(self, *_):
        pass


def _p3_run(root):
    """The JAX test's lazy-peer scenario, every score read on the way."""
    m = gs(root).gossipsub
    clock = [0.0]
    router = m.GossipSub(_FakeHost(), time_fn=lambda: clock[0])
    router.set_topic_params(TOPIC, m.TopicScoreParams(
        topic_weight=0.5, mesh_deliveries_weight=-0.5, mesh_deliveries_threshold=4.0,
        mesh_deliveries_activation_sec=5.0, mesh_failure_weight=-0.5))
    router.topics.add(TOPIC)
    router.mesh[TOPIC] = {"lazy", "good"}
    for pid in ("lazy", "good"):
        sc = router.scores[pid] = m._PeerScore()
        sc.graft(TOPIC, clock[0])
    router.scores["good"].topic(TOPIC).mesh_deliveries = 10.0
    router.scores["good"].topic(TOPIC).first_deliveries = 10.0
    seen = []
    for now in (0.0, 4.0, 10.0):
        clock[0] = now
        seen.append((now, router._score("good"), router._score("lazy")))
    asyncio.run(router.heartbeat())
    ts = router.scores["lazy"].topic(TOPIC)
    seen.append((sorted(router.mesh[TOPIC]), ts.mesh_failure, ts.mesh_since,
                 router._score("lazy"), router._score("good")))
    clock[0] = 20.0
    asyncio.run(router.heartbeat())
    seen.append((router._score("lazy"), router._score("good"),
                 router.scores["good"].topic(TOPIC).mesh_deliveries))
    kinds = ("beacon_block", "beacon_aggregate_and_proof", "beacon_attestation_3",
             "sync_committee_1", "voluntary_exit")
    seen.append([tuple(getattr(m.eth2_topic_score_params(k), f)
                       for f in m.TopicScoreParams.__slots__) for k in kinds])
    return seen


def test_p3_penalty_prunes_a_lazy_peer_with_equal_scores():
    want, got = _p3_run(J), _p3_run(T)
    assert got == want
    assert want[2][1] > 0 and want[2][2] < 0
    assert want[3][0] == ["good"] and want[3][1] > 0 and want[3][3] < 0
