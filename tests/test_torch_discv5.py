"""The port's discv5 (`lodestar_tpu_torch.network.discv5`), `discovery` and
`subnets` against the JAX package's.

Tolerance: none. ENR content is compared byte for byte from one secp256k1
key (the RLP of seq and pairs that the v4 scheme signs, the node id, the
encoding of one record); ECDSA draws a fresh nonce, so the signatures differ
and each package verifies the other's, and a tampered pair fails in both.
`log2_distance` and the discv5 v5.1 ECDH vector agree. Over UDP on
127.0.0.1, with the packages in both roles: the WHOAREYOU -> handshake ->
PING/PONG flow and FINDNODE, a three-node discovery through a bootnode with
the packages mixed (seeded keys: a node in a distance band the bootstrap
asks for is found, one outside them is not), and junk datagrams ignored. The subnet-aware ordering of
ENRs by `attnets` (`Libp2pBeaconNetwork.enr_has_attnet`), and the subnets
and discovery scenarios of `tests/network/test_subnets_discovery_builder.py`
(its builder test runs in `tests/test_torch_execution.py`): the attnets lifecycle under
one seeded `random.Random`, syncnets with the metadata sequence, and
subnet-matched dialing, each event log equal between the packages.
"""

from __future__ import annotations

import asyncio
import importlib
import itertools
import random
from types import SimpleNamespace

import pytest
from cryptography.hazmat.primitives.asymmetric import ec

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages

J, T = ROOTS
NAMES = {J: "jax", T: "port"}
PAIRS = list(itertools.product(ROOTS, ROOTS))
PAIR_IDS = [f"{NAMES[a]}-{NAMES[b]}" for a, b in PAIRS]
_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def dv(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{
        name: importlib.import_module(f"{root}.{mod}") for name, mod in (
            ("discv5", "network.discv5"), ("discovery", "network.discovery"),
            ("subnets", "network.subnets"), ("service", "network.service"),
            ("params", "params"))})


def _key(rng):
    return ec.derive_private_key(rng.randrange(1, _ORDER), ec.SECP256K1())


# --- ENRs ---------------------------------------------------------------------


def test_enr_content_is_bytes_equal_and_signatures_verify_across():
    j, t = dv(J).discv5, dv(T).discv5
    rng = random.Random(778)
    for i in range(4):
        key = _key(rng)
        extra = {b"eth2": rng.randbytes(16), b"attnets": rng.randbytes(8)} if i else None
        ej = j.Enr.create(key, ip="127.0.0.1", udp_port=9000 + i, tcp_port=9100 + i, extra=extra)
        et = t.Enr.create(key, ip="127.0.0.1", udp_port=9000 + i, tcp_port=9100 + i, extra=extra)
        assert (et.seq, et.pairs) == (ej.seq, ej.pairs)
        assert j.rlp_encode(et._content()) == j.rlp_encode(ej._content())
        assert et.node_id == ej.node_id and et.udp_endpoint == ej.udp_endpoint
        # each package reads and verifies the other's record
        assert j.Enr.decode(et.encode()).verify() and t.Enr.decode(ej.encode()).verify()
        back = t.Enr.decode(ej.encode())
        assert back.encode() == ej.encode() and back.node_id == ej.node_id
        same = t.Enr(seq=ej.seq, pairs=ej.pairs, signature=ej.signature)
        assert same.encode() == ej.encode()
        for E, rec in ((j.Enr, et), (t.Enr, ej)):
            bad = E(seq=rec.seq, pairs={**rec.pairs, b"udp": b"\x00\x01"},
                    signature=rec.signature)
            assert not bad.verify()


def test_log2_distance_agrees():
    j, t = dv(J).discv5, dv(T).discv5
    rng = random.Random(5)
    a = b"\x00" * 32
    assert t.log2_distance(a, a) == 0
    assert t.log2_distance(a, b"\x00" * 31 + b"\x01") == 1
    assert t.log2_distance(a, b"\x80" + b"\x00" * 31) == 256
    for _ in range(64):
        x = rng.randbytes(32)
        k = rng.randrange(33)  # a shared prefix of k bytes
        y = x[:k] + rng.randbytes(32 - k)
        assert t.log2_distance(x, y) == j.log2_distance(x, y)


def test_ecdh_spec_vector_in_both_packages():
    secret_key = int("fb757dc581730490a1d7a00deea65e9b1936924caaea8f44d476014856b68736", 16)
    public_key = bytes.fromhex(
        "039961e4c2356d61bedb83052c115d311acb3a96f5777296dcf297351130266231")
    want = bytes.fromhex("033b11a2a1f214567e1537ce5e509ffd9b21373247f2a3ff6841f4976f53165e7e")
    sk = ec.derive_private_key(secret_key, ec.SECP256K1())
    pk = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), public_key)
    for root in ROOTS:
        got = dv(root).discv5._ecdh_compressed(sk, pk)
        assert got == want and got[1:] == sk.exchange(ec.ECDH(), pk)


# --- the UDP protocol across packages -----------------------------------------


async def _ping_findnode(ra, rb):
    a, b = dv(ra).discv5.Discv5Node(), dv(rb).discv5.Discv5Node()
    await a.start()
    await b.start()
    try:
        out = [await a.ping(b.enr), b.enr.node_id in a.sessions, a.enr.node_id in b.sessions,
               a.enr.node_id in b.table]
        found = await b.find_node(b.table[a.enr.node_id], [0])
        out.append([e.node_id == a.enr.node_id for e in found])
        # and the other way round over the same sessions
        out.append(await b.ping(a.enr))
    finally:
        await a.stop()
        await b.stop()
    return out


@pytest.mark.parametrize("ra,rb", PAIRS, ids=PAIR_IDS)
def test_handshake_ping_findnode_across_packages(ra, rb):
    assert asyncio.run(_ping_findnode(ra, rb)) == [True, True, True, True, [True], True]


SEED_B, SEED_A = 1, 2  # log2_distance(A, B) = 256: A asks B for the bands 253-256
SEED_NEAR_C = 3  # log2_distance(B, C) = 255, a band that A asks for
SEED_FAR_C = 6  # log2_distance(B, C) = 250: below 253, and not d(A, B) or d(A, B) - 1


def _node(root, seed, **kw):
    return dv(root).discv5.Discv5Node(private_key=_key(random.Random(seed)), **kw)


async def _three(rb, rc, ra, seed_c=SEED_NEAR_C):
    b = _node(rb, SEED_B)
    await b.start()
    c = _node(rc, seed_c, bootnodes=[])
    await c.start()
    try:
        out = [await c.ping(b.enr)]
        a = _node(ra, SEED_A, bootnodes=[b.enr])
        await a.start()
        try:
            log2 = dv(ra).discv5.log2_distance
            out.append((log2(a.node_id, b.node_id), log2(b.node_id, c.node_id)))
            out.append(await a.bootstrap(rounds=2))  # the table's size
            out.append(c.enr.node_id in a.table)
            if out[-1]:
                out.append(await a.ping(a.table[c.enr.node_id]))
            ids = {e.node_id for e in a.enr_source()}
            out.append({b.enr.node_id, c.enr.node_id} <= ids)
        finally:
            await a.stop()
    finally:
        await b.stop()
        await c.stop()
    return out


THREES = [(J, T, T), (T, J, J), (T, T, J), (J, J, T)]
THREE_IDS = ["-".join(NAMES[r] for r in x) for x in THREES]


@pytest.mark.parametrize("layout", THREES, ids=THREE_IDS)
def test_three_node_discovery_with_the_packages_mixed(layout):
    """C is known to B only; A, with B as its bootnode, finds C through
    FINDNODE at B and then talks to C directly (layout: B, C, A). The keys
    are seeded, so that C lies in a distance band that A's bootstrap asks B
    for, and every run is the same."""
    assert asyncio.run(_three(*layout)) == [True, (256, 255), 2, True, True, True]


@pytest.mark.parametrize("layout", THREES, ids=THREE_IDS)
def test_three_node_discovery_misses_a_node_outside_the_asked_bands(layout):
    """The same three nodes, with C at log2 distance 250 from B: A's bootstrap
    asks B only for the bands 253-256, d(A, B) and d(A, B) - 1, so neither
    package finds C in two rounds (the reference's behaviour, kept)."""
    got = asyncio.run(_three(*layout, seed_c=SEED_FAR_C))
    assert got == [True, (256, 250), 1, False, False]


async def _garbage(ra, rb):
    a = dv(ra).discv5.Discv5Node()
    await a.start()
    try:
        loop = asyncio.get_running_loop()
        transport, _ = await loop.create_datagram_endpoint(
            asyncio.DatagramProtocol, remote_addr=("127.0.0.1", a.port))
        transport.sendto(b"\x00" * 7)
        transport.sendto(b"garbage-....-" * 10)
        transport.sendto(bytes(63) + b"\x01")
        transport.close()
        await asyncio.sleep(0.2)
        b = dv(rb).discv5.Discv5Node()
        await b.start()
        try:
            return await b.ping(a.enr), len(a.table)
        finally:
            await b.stop()
    finally:
        await a.stop()


@pytest.mark.parametrize("ra,rb", [(T, J), (T, T)], ids=["port-jax", "port-port"])
def test_junk_datagrams_are_ignored(ra, rb):
    assert asyncio.run(_garbage(ra, rb)) == asyncio.run(_garbage(J, J)) == (True, 1)


def test_attnets_candidate_ordering_agrees():
    orders = []
    for root in ROOTS:
        m = dv(root)
        has = m.service.Libp2pBeaconNetwork.enr_has_attnet
        key = _key(random.Random(3))
        enrs = [m.discv5.Enr.create(key, ip="127.0.0.1", udp_port=i + 1, tcp_port=i + 1,
                                    extra={b"attnets": bits} if bits is not None else None)
                for i, bits in enumerate([b"\x00" * 8, bytes([0b00001000]) + b"\x00" * 7, None,
                                          random.Random(7).randbytes(8)])]
        for e in enrs:
            assert not has(e, 64)
        orders.append([[has(e, s) for s in range(64)] for e in enrs])
        wanted = {3}
        ordered = sorted(enrs, key=lambda e: not any(has(e, s) for s in wanted))
        orders.append([enrs.index(e) for e in ordered])
    assert orders[0] == orders[2] and orders[1] == orders[3]
    assert orders[1][0] == 1, "the subnet peer must dial first"


# --- subnets and discovery (tests/network/test_subnets_discovery_builder.py) --


class _Recorder:
    def __init__(self):
        self.subscribed = set()
        self.events = []

    def subscribe(self, subnet):
        self.subscribed.add(subnet)
        self.events.append(("sub", subnet))

    def unsubscribe(self, subnet):
        self.subscribed.discard(subnet)
        self.events.append(("unsub", subnet))


def _attnets_run(root, seed):
    m = dv(root)
    S, p = m.subnets, m.params.active_preset()
    rng = random.Random(seed)
    rec, md = _Recorder(), S.MetadataController()
    svc = S.AttnetsService(subscriber=rec, metadata=md, p=p, rand_fn=rng.randint,
                           shuffle_fn=rng.shuffle)
    epoch_slots = S.EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION * p.SLOTS_PER_EPOCH
    seen = []
    slot = 10
    for step in range(12):
        svc.on_slot(slot)
        subs = [S.CommitteeSubscription(validator_index=rng.randrange(8),
                                        subnet=rng.randrange(64), slot=slot + rng.randrange(1, 4),
                                        is_aggregator=rng.random() < 0.5)
                for _ in range(rng.randrange(0, 3))]
        svc.add_committee_subscriptions(subs)
        seen.append((slot, sorted(rec.subscribed), md.seq_number, list(md.attnets),
                     svc.random_subnets.active(slot),
                     [svc.should_process(s.subnet, s.slot) for s in subs]))
        slot += rng.choice([1, 2, 5, epoch_slots // 2, epoch_slots])
    return seen, rec.events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attnets_lifecycle_equal_under_a_seeded_random(seed):
    want, got = _attnets_run(J, seed), _attnets_run(T, seed)
    assert got == want
    assert want[1] and any(step[4] for step in want[0])


def _syncnets_run(root):
    m = dv(root)
    S = m.subnets
    rec, md = _Recorder(), S.MetadataController()
    svc = S.SyncnetsService(subscriber=rec, metadata=md, p=m.params.active_preset())
    svc.on_slot(1)
    svc.add_sync_committee_subscriptions(
        [S.CommitteeSubscription(validator_index=1, subnet=2, slot=100, is_aggregator=False),
         S.CommitteeSubscription(validator_index=4, subnet=0, slot=40, is_aggregator=True)])
    seen = [(sorted(rec.subscribed), md.seq_number, list(md.syncnets))]
    for slot in (41, 101):
        svc.on_slot(slot)
        seen.append((sorted(rec.subscribed), md.seq_number, list(md.syncnets)))
    return seen, rec.events


def test_syncnets_and_metadata_seq_agree():
    want, got = _syncnets_run(J), _syncnets_run(T)
    assert got == want
    assert want[0][0][:2] == ([0, 2], 1) and want[0][-1][:2] == ([], 3)


def _discovery_run(root):
    m = dv(root)
    D, n = m.discovery, m.params.ATTESTATION_SUBNET_COUNT
    records = [D.EnrRecord(node_id=name, attnets=[i in nets for i in range(n)])
               for name, nets in (("a", {3}), ("b", {4}), ("c", {3, 4}), ("d", {9}))]
    clock, dialed = [0.0], []
    disc = D.PeerDiscovery(enr_source=lambda: records, dial=lambda r: dialed.append(r.node_id),
                           connected=lambda: {"a"}, time_fn=lambda: clock[0])
    seen = [disc.discover_peers([D.SubnetRequest("attnet", 3, 1),
                                 D.SubnetRequest("attnet", 4, 1)]), list(dialed)]
    seen.append(disc.discover_peers([D.SubnetRequest("attnet", 4, 1)]))
    clock[0] = D.PeerDiscovery.DIAL_RETRY_SECONDS + 1
    seen += [disc.discover_peers([D.SubnetRequest("attnet", 4, 2)]), list(dialed)]
    disc.on_peer_connected("c")
    seen.append(disc.discover_peers([D.SubnetRequest("attnet", 9, 1)]))
    return seen


def test_peer_discovery_matches_subnets_alike():
    want, got = _discovery_run(J), _discovery_run(T)
    assert got == want
    assert want[0] == len(want[1]) and set(want[1]) <= {"b", "c"}
