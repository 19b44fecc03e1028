"""The port's libp2p transport (`lodestar_tpu_torch.network.transport`:
`identity`, `multistream`, `noise`, `mplex`, `host`) and `prover.mpt` against
the JAX package's.

Tolerance: none. Where the output is deterministic it is compared byte for
byte: peer ids, protobuf keys and Ed25519 signatures from one seed, base58,
the multistream lines and the mplex frames of a scripted exchange, keccak-256
and RLP on seeded inputs, and the verdict of `verify_mpt_proof` on a built
proof. Where it is not (noise XX draws fresh ephemeral and static keys), the
two packages run against each other over 127.0.0.1 in both roles: the
handshake, the channel (a payload of 256 KiB split into 65,519-byte noise
frames that the other package reads frame by frame), a peer-id mismatch
refused with `NoiseError`, host streams by protocol, and req/resp blocks by
range v2 between a host of each package (the JAX test file's scenarios,
`tests/network/test_transport.py`).
"""

from __future__ import annotations

import asyncio
import importlib
import itertools
import random
from types import SimpleNamespace

import pytest

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - this module's fixture too
from .test_torch_network import FORK_SLOTS, fork_chain, fork_config, new_chain, pkg

PAIRS = list(itertools.product(ROOTS, ROOTS))
NAMES = {ROOTS[0]: "jax", ROOTS[1]: "port"}
PAIR_IDS = [f"{NAMES[a]}-{NAMES[b]}" for a, b in PAIRS]
BLOCKS_BY_RANGE_V2 = "/eth2/beacon_chain/req/beacon_blocks_by_range/2/ssz_snappy"
STATUS = "/eth2/beacon_chain/req/status/1/ssz_snappy"


def tr(root: str) -> SimpleNamespace:
    """One package's transport modules and `prover.mpt`."""
    names = ("identity", "multistream", "noise", "mplex", "host")
    mods = {n: importlib.import_module(f"{root}.network.transport.{n}") for n in names}
    mods["mpt"] = importlib.import_module(f"{root}.prover.mpt")
    mods["transport"] = importlib.import_module(f"{root}.network.transport")
    return SimpleNamespace(**mods)


# --- identity and peer ids ----------------------------------------------------


def test_peer_ids_and_base58_are_bytes_equal():
    j, t = tr(ROOTS[0]), tr(ROOTS[1])
    rng = random.Random(15)
    raws = [b"", b"\x00\x00abc", b"hello world", bytes(range(32))] + [
        rng.randbytes(rng.randrange(1, 48)) for _ in range(16)]
    for raw in raws:
        assert t.identity.b58encode(raw) == j.identity.b58encode(raw)
        assert t.identity.b58decode(j.identity.b58encode(raw)) == raw
    for seed in [b"\x01" * 32, b"\x02" * 32] + [rng.randbytes(32) for _ in range(4)]:
        a, b = t.identity.Identity.from_seed(seed), j.identity.Identity.from_seed(seed)
        assert a.peer_id == b.peer_id and a.pubkey_raw == b.pubkey_raw
        assert a.pubkey_protobuf() == b.pubkey_protobuf()
        assert t.identity.peer_id_from_pubkey(a.pubkey_raw) == a.peer_id
        assert t.identity.b58decode(a.peer_id)[:2] == b"\x00\x24"
        data = b"noise-libp2p-static-key:" + seed
        sig = a.sign(data)
        assert sig == b.sign(data)  # Ed25519 is deterministic
        assert j.identity.verify_identity_sig(a.pubkey_protobuf(), sig, data) == a.peer_id
        assert t.identity.verify_identity_sig(b.pubkey_protobuf(), sig, data) == a.peer_id
        assert t.identity.verify_identity_sig(b.pubkey_protobuf(), sig, data + b"x") is None
    assert t.transport.peer_id_from_pubkey is t.identity.peer_id_from_pubkey


# --- multistream and mplex frames ---------------------------------------------


class _Channel:
    """An in-memory message channel; what each end sends is logged."""

    def __init__(self):
        self.queues = (asyncio.Queue(), asyncio.Queue())
        self.sent = ([], [])

    def end(self, side: int):
        async def send(data: bytes) -> None:
            self.sent[side].append(bytes(data))
            await self.queues[1 - side].put(bytes(data))

        async def recv() -> bytes:
            return await self.queues[side].get()

        return send, recv


async def _negotiate(dialer, listener, proposal, supported):
    ch = _Channel()
    send0, recv0 = ch.end(0)
    send1, recv1 = ch.end(1)
    task = asyncio.ensure_future(listener.negotiate_in(send1, recv1, supported))
    try:
        out = await dialer.negotiate_out(send0, recv0, proposal)
    except dialer.NegotiationError as e:
        out = ("refused", str(e))
    await asyncio.sleep(0)
    if task.done():
        got = task.result()
    else:
        task.cancel()
        got = "waiting"
    return out, got, ch.sent


@pytest.mark.parametrize("dialer,listener", PAIRS, ids=PAIR_IDS)
def test_multistream_lines_are_bytes_equal(dialer, listener):
    """A scripted negotiation, accepted and refused ("na"), dialer from one
    package and listener from the other: the lines on the wire and the
    outcomes equal a JAX-JAX run."""
    def run(d, l):
        md, ml = tr(d).multistream, tr(l).multistream
        return [asyncio.run(_negotiate(md, ml, "/eth2/p/1", {"/eth2/p/1", "/x/2"})),
                asyncio.run(_negotiate(md, ml, "/nope/1", {"/eth2/p/1"}))]

    want, got = run(ROOTS[0], ROOTS[0]), run(dialer, listener)
    assert got == want
    assert want[0][:2] == (b"", ("/eth2/p/1", b""))
    assert want[1][0][0] == "refused" and want[1][1] == "waiting"
    m = tr(ROOTS[1]).multistream
    for line in ("/multistream/1.0.0", "na", "/mplex/6.7.0", "x" * 200):
        assert m.encode_ms(line) == tr(ROOTS[0]).multistream.encode_ms(line)
        assert m.decode_ms(m.encode_ms(line)) == (line, len(m.encode_ms(line)))


class _FakeNoise:
    """The noise channel under an `Mplex`: whole messages, each logged."""

    def __init__(self, inbox, outbox, log):
        self.inbox, self.outbox, self.log = inbox, outbox, log

    async def write_msg(self, data: bytes) -> None:
        self.log.append(bytes(data))
        await self.outbox.put(bytes(data))

    async def read_msg(self) -> bytes:
        data = await self.inbox.get()
        if data is None:
            raise asyncio.IncompleteReadError(b"", 1)
        return data

    def close(self) -> None:
        self.outbox.put_nowait(None)


async def _mplex_script(a_root, b_root):
    """Initiator mux of package a, responder of package b: three streams, one
    echoed and half-closed, one reset, one with a 40 KiB payload."""
    a_mod, b_mod = tr(a_root).mplex, tr(b_root).mplex
    qa, qb, logs = asyncio.Queue(), asyncio.Queue(), ([], [])
    seen = []

    async def on_stream(st):
        data = await st.read()
        seen.append((st.sid, st.initiator, data[:8], len(data)))
        st.write(b"<" + data[:8] + b">")
        await st.drain()
        st.write_eof()

    a = a_mod.Mplex(_FakeNoise(qa, qb, logs[0]), is_initiator=True)
    b = b_mod.Mplex(_FakeNoise(qb, qa, logs[1]), is_initiator=False, on_stream=on_stream)
    a.start()
    b.start()
    out = []
    s1 = a.open_stream()
    s1.write(b"hello mplex")
    await s1.drain()
    out.append(await s1.readexactly(10))
    s1.write_eof()
    s2 = a.open_stream()
    s2.write(b"\x07" * 40960)
    await s2.drain()
    out.append(await s2.readexactly(10))
    s3 = a.open_stream()
    s3.reset()
    await asyncio.sleep(0.05)
    out.append((s1.sid, s2.sid, s3.sid, s1.at_eof()))
    a.close()
    b.close()
    await asyncio.sleep(0)
    # the streams on the wire: each side's messages concatenated (how frames
    # group into messages depends on when the flush task runs)
    return out, seen, [b"".join(log) for log in logs]


@pytest.mark.parametrize("a_root,b_root", PAIRS, ids=PAIR_IDS)
def test_mplex_frames_are_bytes_equal(a_root, b_root):
    want = asyncio.run(_mplex_script(ROOTS[0], ROOTS[0]))
    got = asyncio.run(_mplex_script(a_root, b_root))
    assert got == want
    out, seen, _ = want
    assert out[:2] == [b"<hello mp>", b"<" + b"\x07" * 8 + b">"]
    assert [s[0] for s in seen] == [1, 3] and seen[1][3] == 40960
    t = tr(ROOTS[1]).mplex
    assert (t._MAX_BUFFERED, t._MAX_FRAME) == (tr(ROOTS[0]).mplex._MAX_BUFFERED,
                                               tr(ROOTS[0]).mplex._MAX_FRAME)


# --- noise XX across packages -------------------------------------------------


async def _noise_pair(init_root, resp_root):
    ti, tresp = tr(init_root), tr(resp_root)
    alice, bob = ti.identity.Identity(), tresp.identity.Identity()
    server_conn, frames = {}, []

    async def on_conn(reader, writer):
        conn = server_conn["conn"] = await tresp.noise.noise_handshake(
            reader, writer, bob, initiator=False)
        try:
            while True:
                msg = await conn.read_msg()
                frames.append(len(msg))
                await conn.write_msg(msg)  # verbatim echo, frame by frame
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    conn = await ti.noise.noise_handshake(reader, writer, alice, initiator=True,
                                          expected_peer=bob.peer_id)
    out = [conn.remote_peer == bob.peer_id]
    await conn.write_msg(b"hello noise")
    out.append(await conn.read_msg())
    out.append(server_conn["conn"].remote_peer == alice.peer_id)
    blob = bytes(range(256)) * 1024  # 256 KiB -> 5 noise frames
    await conn.write_msg(blob)
    got = b""
    while len(got) < len(blob):
        got += await conn.read_msg()
    out += [got == blob, list(frames)]
    conn.close()
    server.close()
    return out


@pytest.mark.parametrize("init_root,resp_root", PAIRS, ids=PAIR_IDS)
def test_noise_handshake_and_channel_across_packages(init_root, resp_root):
    got = asyncio.run(_noise_pair(init_root, resp_root))
    cap = tr(ROOTS[1]).noise.NoiseConnection.MAX_PLAINTEXT
    assert cap == tr(ROOTS[0]).noise.NoiseConnection.MAX_PLAINTEXT == 65519
    assert got == [True, b"hello noise", True, True, [11, cap, cap, cap, cap, 68]]


async def _mismatch(init_root, resp_root):
    ti, tresp = tr(init_root), tr(resp_root)
    alice, bob, mallory = ti.identity.Identity(), ti.identity.Identity(), tresp.identity.Identity()
    refused = []

    async def on_conn(reader, writer):
        try:
            await tresp.noise.noise_handshake(reader, writer, mallory, initiator=False)
        except tresp.noise.NoiseError as e:
            refused.append(str(e))
        except (asyncio.IncompleteReadError, ConnectionError):
            refused.append("closed")

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        await ti.noise.noise_handshake(reader, writer, alice, initiator=True,
                                       expected_peer=bob.peer_id)
    except ti.noise.NoiseError as e:
        error = str(e)
    else:
        error = None
    writer.close()
    server.close()
    return error, mallory.peer_id, bob.peer_id


@pytest.mark.parametrize("init_root,resp_root", PAIRS, ids=PAIR_IDS)
def test_noise_peer_mismatch_is_refused(init_root, resp_root):
    error, got, want = asyncio.run(_mismatch(init_root, resp_root))
    assert error == f"peer id mismatch: got {got}, want {want}"


# --- host streams and req/resp over the host ----------------------------------


async def _host_pair(r1, r2):
    h1, h2 = tr(r1).host.Libp2pHost(), tr(r2).host.Libp2pHost()

    async def echo_handler(stream, peer_id):
        data = await stream.readexactly(5)
        stream.write(b"<" + data + b">")
        await stream.drain()
        stream.write_eof()

    h2.set_handler("/test/echo/1", echo_handler)
    port = await h2.listen()
    await h1.connect("127.0.0.1", port, expected_peer=h2.peer_id)
    out = [h2.peer_id in h1.peers()]

    async def one(i):
        s = await h1.new_stream(h2.peer_id, "/test/echo/1")
        payload = f"ms{i:03d}".encode()
        s.write(payload)
        await s.drain()
        got = await s.readexactly(7)
        s.close()
        return got == b"<" + payload + b">", s.protocol

    out.append(await asyncio.gather(*[one(i) for i in range(8)]))
    try:
        await asyncio.wait_for(h1.new_stream(h2.peer_id, "/nope/1"), 5)
    except (ConnectionError, asyncio.TimeoutError) as e:
        out.append(type(e).__name__)
    await asyncio.sleep(0.05)
    out.append(h1.peer_id in h2.peers())
    await h1.close()
    await h2.close()
    return out


@pytest.mark.parametrize("r1,r2", PAIRS, ids=PAIR_IDS)
def test_host_streams_by_protocol_across_packages(r1, r2):
    got = asyncio.run(_host_pair(r1, r2))
    assert got == [True, [(True, "/test/echo/1")] * 8, "NegotiationError", True]


async def _reqresp_over_hosts(S, C):
    """Package S's fork-crossing chain (phase0 slots 1-7, altair 8-10) served
    by `ReqRespBeaconNode` on S's host; package C's host dials it and asks
    status v1 and blocks by range v2 (a fork digest before each block)."""
    genesis, blocks = fork_chain(S)
    chain = new_chain(S, genesis, slot=FORK_SLOTS, cfg=fork_config(S), p=S.p)
    for b in blocks:
        await chain.process_block(b)
    node = S.node.ReqRespBeaconNode(chain)
    server = tr(S.root).host.Libp2pHost()

    async def serve(stream, peer_id):
        await node.handle_stream(stream, stream, peer_id=peer_id)

    for pid in (STATUS, BLOCKS_BY_RANGE_V2):
        server.set_handler(pid, serve)
    port = await server.listen()
    host = tr(C.root).host.Libp2pHost()
    await host.connect("127.0.0.1", port)
    client = C.node.ReqRespBeaconNode(
        new_chain(C, fork_chain(C)[0], slot=FORK_SLOTS, cfg=fork_config(C), p=C.p))

    def dial(pid):
        async def open_stream():
            s = await host.new_stream(server.peer_id, pid)
            return s, s
        return open_stream

    status = (await client.send_request(dial(STATUS), STATUS, client.local_status()))[0]
    req = C.t.BeaconBlocksByRangeRequest.default()
    req.start_slot, req.count, req.step = 1, FORK_SLOTS, 1
    got = await client.send_request(dial(BLOCKS_BY_RANGE_V2), BLOCKS_BY_RANGE_V2, req)
    await host.close()
    await server.close()
    return int(status.head_slot), [(b.type.name, b.type.serialize(b)) for b in got]


@pytest.mark.parametrize("server,client", [(ROOTS[0], ROOTS[1]), (ROOTS[1], ROOTS[0])],
                         ids=["jax_server-port_client", "port_server-jax_client"])
def test_reqresp_blocks_by_range_v2_over_hosts(server, client):
    head, got = asyncio.run(_reqresp_over_hosts(pkg(server), pkg(client)))
    assert head == FORK_SLOTS
    assert got == [(b.type.name, b.type.serialize(b)) for b in fork_chain(pkg(server))[1]]


# --- keccak-256, RLP and Merkle-Patricia proofs -------------------------------


def test_keccak_and_rlp_are_bytes_equal():
    j, t = tr(ROOTS[0]).mpt, tr(ROOTS[1]).mpt
    rng = random.Random(1559)
    for n in [0, 1, 31, 32, 55, 56, 135, 136, 137, 272, 500, 1024]:
        data = rng.randbytes(n)
        assert t.keccak256(data) == j.keccak256(data)
    assert t.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")

    def item(depth):
        if depth == 0 or rng.random() < 0.4:
            return rng.choice([rng.randbytes(rng.randrange(0, 70)), rng.randrange(0, 2**64)])
        return [item(depth - 1) for _ in range(rng.randrange(0, 5))]

    for _ in range(40):
        value = item(3)
        enc = t.rlp_encode(value)
        assert enc == j.rlp_encode(value)
        assert t.rlp_decode(enc) == j.rlp_decode(enc)
    for bad in (b"\x81\x01", b"\x83do", b"\xc2\x83"):
        with pytest.raises(t.MptError):
            t.rlp_decode(bad)
        with pytest.raises(j.MptError):
            j.rlp_decode(bad)


def test_verify_mpt_proof_agrees():
    from .prover.test_prover import _TrieBuilder

    j, t = tr(ROOTS[0]).mpt, tr(ROOTS[1]).mpt
    items = {j.keccak256(bytes([i])): j.rlp_encode([b"v%d" % i]) for i in range(20)}
    trie = _TrieBuilder(items)
    for key in list(items) + [j.keccak256(b"absent")]:
        proof = trie.prove(key)
        assert t.verify_mpt_proof(trie.root, key, proof) == j.verify_mpt_proof(
            trie.root, key, proof) == items.get(key)
    key = j.keccak256(bytes([0]))
    with pytest.raises(t.MptError) as got:
        t.verify_mpt_proof(b"\x00" * 32, key, trie.prove(key))
    with pytest.raises(j.MptError) as want:
        j.verify_mpt_proof(b"\x00" * 32, key, trie.prove(key))
    assert str(got.value) == str(want.value)
