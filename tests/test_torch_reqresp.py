"""The port's snappy codecs and req/resp engine (`lodestar_tpu_torch.utils.snappy`,
`lodestar_tpu_torch.reqresp`) against the JAX package's, minimal preset.

Tolerance: none. Each scenario of the JAX package's `tests/utils/test_snappy.py`
and `tests/reqresp/test_reqresp.py` runs through both packages (`both`), with
the JAX test's own assertions, and the two runs' observations must be equal:
compressed block and frame bytes, decoded payloads, checksums, every raised
exception as its class name and message, every response as its SSZ bytes and
every error chunk as its status. Beside them: a seeded corpus (random,
repetitive, the SSZ bytes of blocks) compressed bytes-equal in block and frame
format, each package decompressing the other's bytes, request and response
chunks bytes-equal on the wire, and each package's client against the other's
server over 127.0.0.1 (status, blocks by range, an error chunk, a rate limit).
"""

from __future__ import annotations

import asyncio
import functools
import importlib
import random

import pytest

ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")
_MODULES = {
    "params": "params", "ssz": "ssz", "types": "types", "snappy": "utils.snappy",
    "reqresp": "reqresp", "encoding": "reqresp.encoding", "limiter": "reqresp.rate_limiter",
}


class Pkg:
    """One package's snappy and req/resp modules under the JAX package's names."""

    def __init__(self, root: str):
        self.root = root
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))

    @property
    def t(self):
        return self.types.ssz_types()


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> Pkg:
    return Pkg(root)


def norm(value):
    """SSZ values as (type name, bytes); lists element by element."""
    if hasattr(value, "type") and hasattr(value.type, "serialize"):
        return (value.type.name, value.type.serialize(value))
    if isinstance(value, (list, tuple)):
        return type(value)(norm(v) for v in value)
    return value


class Obs:
    def __init__(self):
        self.seen = []

    def add(self, label, value):
        self.seen.append((label, norm(value)))
        return value

    def raises(self, label, fn, *args):
        """Call fn; note its exception's class name and message (or "ok")."""
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 - the exception is the observation
            self.add(label, (type(e).__name__, str(e)))
            return e
        self.add(label, ("ok", out))
        return out


def both(scenario, *args):
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


@pytest.fixture(scope="module", autouse=True)
def minimal_preset():
    prev = [pkg(r).params.active_preset() for r in ROOTS]
    for r in ROOTS:
        pkg(r).params.set_active_preset("minimal")
    yield
    for r, p in zip(ROOTS, prev):
        pkg(r).params.set_active_preset(p)


def _pid(name, version=1):
    return f"/eth2/beacon_chain/req/{name}/{version}/ssz_snappy"


# --- snappy (tests/utils/test_snappy.py) --------------------------------------


def sc_crc32c_known_vectors(P, obs):
    S = P.snappy
    assert S.crc32c(b"") == 0x00000000
    assert S.crc32c(b"123456789") == 0xE3069283
    assert S.crc32c(bytes(32)) == 0x8A9136AA
    rng = random.Random(7)
    data = [rng.randbytes(n) for n in (1, 31, 32, 33, 1000, 65537)]
    obs.add("crc32c", [S.crc32c(d) for d in data])
    obs.add("masked", [S._masked_crc(d) for d in data])


def sc_block_roundtrip_various(P, obs):
    S = P.snappy
    rng = random.Random(0)
    cases = [
        b"",
        b"a",
        b"abcabcabcabcabcabcabc" * 10,
        bytes(rng.randbytes(100)),
        bytes(rng.randbytes(70000)),
        (b"0123456789abcdef" * 5000),
    ]
    for i, data in enumerate(cases):
        packed = obs.add(f"compress {i}", S.compress(data))
        assert S.decompress(packed) == data


def sc_compression_actually_compresses(P, obs):
    data = b"the quick brown fox " * 500
    packed = obs.add("compressed", P.snappy.compress(data))
    assert len(packed) < len(data) // 3


def sc_decompress_handles_all_copy_forms(P, obs):
    payload = bytes([len(b"abcd") - 1 << 2]) + b"abcd"
    copy1 = bytes([0b01 | ((4 - 4) << 2) | ((4 >> 8) << 5), 4])
    copy2 = bytes([0b10 | ((8 - 1) << 2)]) + (4).to_bytes(2, "little")
    blob = bytes([16]) + payload + copy1 + copy2
    assert obs.add("decoded", P.snappy.decompress(blob)) == b"abcd" * 4


def sc_corruption_detected(P, obs):
    S = P.snappy
    data = S.compress(b"hello world" * 100)
    for label, bad in (("cut", data[:-3]), ("truncated literal", b"\x05\x0f"),
                       ("bad offset", b"\x08\x00a\x0d\x09"), ("no varint end", b"\xff" * 6),
                       ("empty", b"")):
        e = obs.raises(label, S.decompress, bad)
        if label != "empty":
            assert isinstance(e, S.SnappyError)


def sc_frame_roundtrip_and_checksum(P, obs):
    S = P.snappy
    rng = random.Random(1)
    for i, data in enumerate((b"", b"tiny", rng.randbytes(200_000))):
        framed = obs.add(f"framed {i}", S.frame_compress(data))
        assert S.frame_decompress(framed) == data
    framed = bytearray(S.frame_compress(b"checksummed data" * 100))
    framed[-1] ^= 0xFF
    assert isinstance(obs.raises("flipped", S.frame_decompress, bytes(framed)), S.SnappyError)
    good = S.frame_compress(b"x" * 100)
    for label, bad in (("no stream id", good[10:]), ("cut header", good[:12]),
                       ("cut body", good[:-1]), ("unskippable", good[:10] + b"\x05\x00\x00\x00")):
        assert isinstance(obs.raises(label, S.frame_decompress, bad), S.SnappyError)


SNAPPY = {name[3:]: fn for name, fn in list(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(SNAPPY))
def test_snappy_scenario_agrees(case):
    both(SNAPPY[case])


@functools.lru_cache(maxsize=None)
def corpus() -> dict:
    """Seeded inputs: random bytes of several sizes, repetitive text, a
    phase0 block of 16 attestations and a default Capella block as SSZ."""
    j = pkg(ROOTS[0])
    t = j.types.ssz_types(j.params.MINIMAL)
    rng = random.Random(2024)
    block = t.phase0.SignedBeaconBlock.default()
    block.message.slot = 12345
    atts = []
    for i in range(16):
        att = t.Attestation.default()
        att.aggregation_bits = [bool(rng.getrandbits(1)) for _ in range(8)]
        att.data.slot = i
        att.data.beacon_block_root = rng.randbytes(32)
        att.signature = rng.randbytes(96)
        atts.append(att)
    block.message.body.attestations = atts
    capella = t.capella.SignedBeaconBlock.default()
    capella.message.slot = 77
    return {
        "random_64": rng.randbytes(64),
        "random_4k": rng.randbytes(4096),
        "random_100k": rng.randbytes(100_000),
        "zeros_70k": bytes(70_000),
        "text": b"lodestar gossip " * 777 + b"tail",
        "ramp": bytes(i % 251 for i in range(30_000)),
        "phase0_block": block.type.serialize(block),
        "capella_block": capella.type.serialize(capella),
    }


@pytest.mark.parametrize("name", sorted(corpus()))
def test_corpus_bytes_equal_and_cross_decoded(name):
    data = corpus()[name]
    j, p = pkg(ROOTS[0]).snappy, pkg(ROOTS[1]).snappy
    block, frame = j.compress(data), j.frame_compress(data)
    assert p.compress(data) == block
    assert p.frame_compress(data) == frame
    assert p.decompress(block) == data and j.decompress(p.compress(data)) == data
    assert p.frame_decompress(frame) == data and j.frame_decompress(p.frame_compress(data)) == data
    assert p.crc32c(data) == j.crc32c(data)


# --- req/resp encoding --------------------------------------------------------


class _Sink:
    """A stream writer that keeps what was written."""

    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        return None


def _reader(data: bytes) -> asyncio.StreamReader:
    r = asyncio.StreamReader()
    r.feed_data(data)
    r.feed_eof()
    return r


def test_request_and_response_chunks_bytes_equal():
    """write_request and write_response_chunk (with and without a fork
    digest, and an error chunk) give the same bytes in both packages, and
    each package reads the other's."""
    payloads = [b"", b"\x01" * 84, corpus()["phase0_block"], corpus()["random_100k"]]

    async def wire(E):
        req, resp = _Sink(), _Sink()
        for data in payloads:
            await E.write_request(req, data)
            await E.write_response_chunk(resp, 0, data)
            await E.write_response_chunk(resp, 0, data, context=b"\xaa\xbb\xcc\xdd")
        await E.write_response_chunk(resp, 1, b"cannot serve that range")
        await E.write_response_chunk(resp, 139, b"")
        return bytes(req.data), bytes(resp.data)

    async def read(E, req_bytes, resp_bytes):
        r = _reader(req_bytes)
        reqs = [await E.read_request(r) for _ in payloads]
        chunks = []
        plain = _reader(resp_bytes)
        # chunks with a context carry 4 bytes after the result byte: read in
        # the writer's order, alternating context lengths
        for _ in payloads:
            for ctx_len in (0, 4):
                it = E.read_response_chunks(plain, context_len=ctx_len)
                chunks.append(await it.__anext__())
        async for chunk in E.read_response_chunks(plain):
            chunks.append(chunk)
        return reqs, chunks

    j, p = pkg(ROOTS[0]).encoding, pkg(ROOTS[1]).encoding
    jw, pw = asyncio.run(wire(j)), asyncio.run(wire(p))
    assert pw == jw
    want = asyncio.run(read(j, *jw))
    assert want[0] == payloads
    assert asyncio.run(read(p, *jw)) == want
    assert asyncio.run(read(j, *pw)) == want
    assert want[1][-2:] == [(1, b"", b"cannot serve that range"), (139, b"", b"")]


# --- req/resp over TCP (tests/reqresp/test_reqresp.py) ------------------------


async def _serve(rr):
    server = await asyncio.start_server(
        lambda r, w: rr.handle_stream(r, w, peer_id="test-peer"), "127.0.0.1", 0
    )
    port = server.sockets[0].getsockname()[1]

    async def dial():
        return await asyncio.open_connection("127.0.0.1", port)

    return server, dial


def _status_handler(P):
    async def on_status(req, peer):
        assert req.head_slot == 42
        resp = P.t.Status.default()
        resp.head_slot = 99
        resp.finalized_root = b"\x05" * 32
        yield resp

    return on_status


def _range_handler(P):
    async def on_range(req, peer):
        for slot in range(req.start_slot, req.start_slot + req.count):
            b = P.t.phase0.SignedBeaconBlock.default()
            b.message.slot = slot
            b.signature = bytes([slot % 256]) * 96
            yield b

    return on_range


def _bad_handler(P):
    async def bad(req, peer):
        raise P.reqresp.ReqRespError("cannot serve that range")
        yield  # pragma: no cover

    return bad


def _ping_handler(P):
    async def on_ping(req, peer):
        yield 1

    return on_ping


def _requests(C):
    """The client package's requests: status, range, the bad range."""
    status = C.t.Status.default()
    status.head_slot = 42
    rng = C.t.BeaconBlocksByRangeRequest.default()
    rng.start_slot, rng.count, rng.step = 5, 4, 1
    return status, rng, C.t.BeaconBlocksByRangeRequest.default()


async def _exchange(S, C, obs):
    """Server package S, client package C over 127.0.0.1: status, blocks
    by range, a handler error and a rate limit, as the JAX tests run them."""
    node = S.reqresp.ReqResp()
    node.register_handler(_pid("status"), _status_handler(S))
    node.register_handler(_pid("beacon_blocks_by_range"), _range_handler(S))
    node.register_handler(_pid("beacon_blocks_by_root"), _bad_handler(S))
    node.register_handler(_pid("ping"), _ping_handler(S),
                          quota=S.reqresp.RateLimiterQuota(quota=2, period_sec=60))
    server, dial = await _serve(node)
    try:
        client = C.reqresp.ReqResp()
        status, rng, _ = _requests(C)
        out = obs.add("status", await client.send_request(dial, _pid("status"), status))
        assert len(out) == 1 and out[0].head_slot == 99
        out = obs.add("range", await client.send_request(dial, _pid("beacon_blocks_by_range"), rng))
        assert [b.message.slot for b in out] == [5, 6, 7, 8]
        with pytest.raises(C.reqresp.ResponseError) as ei:
            await client.send_request(dial, _pid("beacon_blocks_by_root"), [b"\x01" * 32])
        obs.add("error chunk", (ei.value.status, str(ei.value)))
        assert ei.value.status == C.reqresp.RespStatus.INVALID_REQUEST
        obs.add("ping", [await client.send_request(dial, _pid("ping"), 7) for _ in range(2)])
        with pytest.raises(C.reqresp.ResponseError) as ei:
            await client.send_request(dial, _pid("ping"), 7)
        obs.add("rate limited", (ei.value.status, str(ei.value)))
        assert ei.value.status == C.reqresp.RespStatus.RATE_LIMITED
        with pytest.raises(C.reqresp.ResponseError) as ei:
            await client.send_request(dial, _pid("metadata", 2), None)
        obs.add("unhandled protocol", ei.value.status)
    finally:
        server.close()


@pytest.mark.parametrize("server,client", [(s, c) for s in ROOTS for c in ROOTS],
                         ids=lambda r: r.replace("lodestar_tpu", "jax").replace("jax_torch", "port"))
def test_client_against_server_over_tcp(server, client):
    """Each package's client against each package's server on 127.0.0.1:
    every response's SSZ bytes and every error chunk equal to the JAX pair's."""
    want = Obs()
    asyncio.run(_exchange(pkg(ROOTS[0]), pkg(ROOTS[0]), want))
    got = Obs()
    asyncio.run(_exchange(pkg(server), pkg(client), got))
    assert got.seen == want.seen


def sc_status_roundtrip(P, obs):
    async def go():
        node = P.reqresp.ReqResp()
        node.register_handler(_pid("status"), _status_handler(P))
        server, dial = await _serve(node)
        client = P.reqresp.ReqResp()
        req = P.t.Status.default()
        req.head_slot = 42
        out = obs.add("status", await client.send_request(dial, _pid("status"), req))
        assert len(out) == 1 and out[0].head_slot == 99
        server.close()

    asyncio.run(go())


def sc_blocks_by_range_streams_chunks(P, obs):
    async def go():
        node = P.reqresp.ReqResp()
        node.register_handler(_pid("beacon_blocks_by_range"), _range_handler(P))
        server, dial = await _serve(node)
        client = P.reqresp.ReqResp()
        req = P.t.BeaconBlocksByRangeRequest.default()
        req.start_slot, req.count, req.step = 5, 4, 1
        out = obs.add("blocks", await client.send_request(
            dial, _pid("beacon_blocks_by_range"), req))
        assert [b.message.slot for b in out] == [5, 6, 7, 8]
        server.close()

    asyncio.run(go())


def sc_handler_error_becomes_error_chunk(P, obs):
    async def go():
        node = P.reqresp.ReqResp()
        node.register_handler(_pid("beacon_blocks_by_range"), _bad_handler(P))
        server, dial = await _serve(node)
        client = P.reqresp.ReqResp()
        req = P.t.BeaconBlocksByRangeRequest.default()
        with pytest.raises(P.reqresp.ResponseError) as ei:
            await client.send_request(dial, _pid("beacon_blocks_by_range"), req)
        assert ei.value.status == P.reqresp.RespStatus.INVALID_REQUEST
        obs.add("error", (ei.value.status, str(ei.value)))
        server.close()

    asyncio.run(go())


def sc_rate_limited(P, obs):
    async def go():
        node = P.reqresp.ReqResp()
        node.register_handler(_pid("ping"), _ping_handler(P),
                              quota=P.reqresp.RateLimiterQuota(quota=2, period_sec=60))
        server, dial = await _serve(node)
        client = P.reqresp.ReqResp()
        obs.add("first", await client.send_request(dial, _pid("ping"), 7))
        obs.add("second", await client.send_request(dial, _pid("ping"), 7))
        with pytest.raises(P.reqresp.ResponseError) as ei:
            await client.send_request(dial, _pid("ping"), 7)
        assert ei.value.status == P.reqresp.RespStatus.RATE_LIMITED
        obs.add("third", (ei.value.status, str(ei.value)))
        server.close()

    asyncio.run(go())


def sc_token_bucket_refills(P, obs):
    now = [0.0]
    rl = P.limiter.RateLimiter(P.reqresp.RateLimiterQuota(quota=2, period_sec=10),
                               time_fn=lambda: now[0])
    seen = [rl.allows("p"), rl.allows("p"), rl.allows("p")]
    now[0] += 5.0
    seen += [rl.allows("p"), rl.allows("p"), rl.allows("q")]
    now[0] += 700.0
    rl.prune()
    seen.append(sorted(rl._buckets))
    obs.add("allows", seen)
    assert seen[:6] == [True, True, False, True, False, True]


REQRESP = {name[3:]: fn for name, fn in list(globals().items())
           if name.startswith("sc_") and name[3:] not in SNAPPY}


@pytest.mark.parametrize("case", sorted(REQRESP))
def test_reqresp_scenario_agrees(case):
    both(REQRESP[case])


def _type_name(typ):
    if typ is None or getattr(typ, "name", None):
        return getattr(typ, "name", None)
    return type(typ).__name__, sorted((k, v) for k, v in vars(typ).items()
                                      if isinstance(v, (int, str)))


def test_protocol_table_agrees():
    """Both packages' protocol tables: ids, chunk limits, context modes and
    each fork's response type by name."""
    def table(P):
        proto = importlib.import_module(f"{P.root}.reqresp.protocols")
        out = []
        for pid, pr in sorted(proto.BEACON_PROTOCOLS.items()):
            forks = [_type_name(pr.resolve_response_type(f)) for f in ("phase0", "altair", "capella")]
            req = pr.request_type() if pr.request_type is not None else None
            out.append((pid, pr.max_response_chunks, pr.context, pr.fork_invariant,
                        _type_name(req), forks))
        with pytest.raises(KeyError):
            proto.protocol_by_id("/eth2/beacon_chain/req/nope/1/ssz_snappy")
        return out

    assert table(pkg(ROOTS[1])) == table(pkg(ROOTS[0]))
