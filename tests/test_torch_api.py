"""The port's Beacon REST API (`lodestar_tpu_torch.api`: `BeaconApiClient`,
`BeaconApiImpl`, `EventStream`, `RestServer`, `ROUTES`,
`BeaconRestApiServer`) against the JAX package's, minimal preset.

Tolerance: none. The JAX package's `tests/api/test_rest_api.py` and
`test_events_sse.py` run on the port (`port_copy`). Their helpers come from
sibling JAX test modules through relative imports, so they stay the JAX
package's: `port_copy_bridged` rebinds each to its `bridged` self, which
carries the port's states, keys, preset and config into the JAX package
and the blocks it builds back, as SSZ bytes. (`test_api_expanded.py`,
`test_flare.py` and `tests/light_client/test_client_loop.py` each define a
fixture `env` or take minutes, so each has a file of its own:
`tests/test_torch_api_expanded.py`, `tests/test_torch_flare.py`,
`tests/test_torch_client_loop.py`.) Beside them, both packages' servers over
the same Altair chain (the JAX package's genesis and three blocks with full
sync aggregates, as SSZ bytes, a `LightClientServer` attached, mock
verifier):

* every GET route of `ROUTES` (checked against the table) and its error
  paths, and the POST routes' error paths and recording routes, give equal
  status codes and equal JSON;
* a block produced over REST is the same JSON in both; published to both,
  the replies, heads, state roots and SSE frames on head and block are
  equal, and so is the 400 of publishing it again;
* a block whose sync aggregate is forged, published over REST, imports in
  the JAX chain and is refused by the port's (ROADMAP Queue 3).
"""

from __future__ import annotations

import importlib

import pytest

from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

J, T = "lodestar_tpu", "lodestar_tpu_torch"


def crossed(value, root):
    """An SSZ container of one package as the same container of `root`'s,
    through its bytes (typed by its fork)."""
    types = importlib.import_module(f"{root}.types")
    params = importlib.import_module(f"{root}.params")
    block = importlib.import_module(f"{root}.state_transition.block")
    fork = block.fork_of(value)
    name = value.type.name
    base = name[: -len(fork)] if name.lower().endswith(fork) else name
    ns = getattr(types.ssz_types(params.MINIMAL), fork)
    return getattr(ns, base).deserialize(value.type.serialize(value))


def bridged(helper):
    """The JAX test helper `helper` for the port's values: its SSZ arguments
    and secret keys cross into the JAX package, the preset and chain config
    become the JAX package's, and what it returns crosses back."""
    jparams = importlib.import_module(f"{J}.params")
    jconfig = importlib.import_module(f"{J}.config")
    japi = importlib.import_module(f"{J}.crypto.bls.api")

    def to_jax(arg):
        if hasattr(arg, "type") and hasattr(arg.type, "serialize"):
            return crossed(arg, J)
        if isinstance(arg, list) and arg and hasattr(arg[0], "to_pubkey"):
            return [japi.SecretKey.from_bytes(sk.scalar.to_bytes(32, "big")) for sk in arg]
        if type(arg).__name__ == "BeaconPreset":
            return jparams.MINIMAL
        if type(arg).__name__ == "ChainConfig":
            return jconfig.ChainConfig(**{f: getattr(arg, f) for f in arg.__dataclass_fields__})
        return arg

    def to_port(out):
        if isinstance(out, list):
            return [to_port(v) for v in out]
        return crossed(out, T)

    def fn(*args, **kwargs):
        return to_port(helper(*[to_jax(a) for a in args],
                              **{k: to_jax(v) for k, v in kwargs.items()}))

    fn.__name__ = helper.__name__
    return fn


def port_copy_bridged(modname: str, into: dict, helpers: tuple, names=None):
    """`port_copy` of a JAX test module whose helpers come from sibling JAX
    test modules (a relative import keeps them the JAX package's): each
    helper named in `helpers` is rebound to its `bridged` self."""
    module = port_copy(modname, into, names=names)
    for name in helpers:
        setattr(module, name, bridged(getattr(module, name)))
    return module


port_copy_bridged("tests.api.test_rest_api", globals(), ("_chain_of_blocks",))
port_copy_bridged("tests.api.test_events_sse", globals(), ("_empty_block_at",))


# --- every route through both packages' servers ----------------------------------


def http(url: str, path: str, method: str = "GET", body=None):
    """(status, JSON or None) of one request; an HTTP error is a status."""
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


def serve_both():
    """Each package's `BeaconChain` (mock verifier) over the JAX package's
    Altair genesis and its three blocks with full sync aggregates, as SSZ
    bytes, with a `LightClientServer` attached, behind its own REST server:
    ({root: (chain, base url, block roots)}, servers)."""
    import asyncio

    from .test_torch_light_client import chain_bytes, pkg

    gbytes, bbytes = chain_bytes()
    out, servers = {}, []
    for root in (J, T):
        P = pkg(root)
        api = importlib.import_module(f"{root}.api")
        genesis = P.t.altair.BeaconState.deserialize(gbytes)
        chain = P.chain.BeaconChain(anchor_state=genesis, bls_verifier=P.bls.BlsVerifierMock(True),
                                    db=P.db.MemoryDbController(), cfg=P.cfg(), current_slot=4)
        chain.light_client_server = P.server.LightClientServer(chain)
        blocks = [P.t.altair.SignedBeaconBlock.deserialize(b) for b in bbytes]

        async def go(chain=chain, blocks=blocks):
            for signed in blocks:
                await chain.process_block(signed)

        asyncio.run(go())
        server = api.BeaconRestApiServer(api.BeaconApiImpl(chain), port=0)
        server.start()
        servers.append(server)
        roots = [P.t.altair.BeaconBlock.hash_tree_root(b.message) for b in blocks]
        out[root] = (chain, f"http://127.0.0.1:{server.port}", roots)
    return out, servers


@pytest.fixture(scope="module")
def both_servers():
    out, servers = serve_both()
    yield out
    for server in servers:
        server.stop()


def get_paths(chain, roots):
    """A path for each GET route of `ROUTES` with data behind it, and the
    error paths: unknown ids, roots and routes, bad queries."""
    head = chain.get_head_state()
    state_root = "0x" + head.type.hash_tree_root(head).hex()
    r1, r3 = "0x" + roots[0].hex(), "0x" + roots[2].hex()
    pk0 = "0x" + bytes(head.validators[0].pubkey).hex()
    unknown = "0x" + "77" * 32
    out = ["/eth/v1/beacon/genesis", "/eth/v1/beacon/headers", "/eth/v1/beacon/headers?slot=2",
           f"/eth/v1/beacon/headers?parent_root={r1}", "/eth/v1/beacon/headers?slot=9"]
    for block_id in ("head", "1", "3", r3, unknown, "9", "genesis"):
        out += [f"/eth/v1/beacon/headers/{block_id}", f"/eth/v2/beacon/blocks/{block_id}",
                f"/eth/v1/beacon/blocks/{block_id}/root",
                f"/eth/v1/beacon/blocks/{block_id}/attestations"]
    for state_id in ("head", "finalized", "genesis", state_root, "2", unknown, "bogus"):
        out += [f"/eth/v1/beacon/states/{state_id}/{leaf}"
                for leaf in ("finality_checkpoints", "fork", "root", "committees",
                             "sync_committees", "validators", "validators/0",
                             "validator_balances")]
    out += ["/eth/v1/beacon/states/head/committees?epoch=0",
            "/eth/v1/beacon/states/head/committees?epoch=5",
            "/eth/v1/beacon/states/head/committees?slot=3&index=0",
            f"/eth/v1/beacon/states/head/validators/{pk0}",
            "/eth/v1/beacon/states/head/validators/99999",
            "/eth/v1/beacon/states/head/validators/x0",
            f"/eth/v1/beacon/states/head/validator_balances?id=0,3,{pk0}",
            "/eth/v1/beacon/states/head/validator_balances?id=zz"]
    out += [f"/eth/v1/beacon/pool/{name}" for name in (
        "attestations", "attester_slashings", "proposer_slashings", "voluntary_exits",
        "bls_to_execution_changes")]
    out += [f"/eth/v1/beacon/light_client/bootstrap/{r1}",
            f"/eth/v1/beacon/light_client/bootstrap/{unknown}",
            "/eth/v1/beacon/light_client/updates?start_period=0&count=1",
            "/eth/v1/beacon/light_client/updates?start_period=3&count=2",
            "/eth/v1/beacon/light_client/optimistic_update",
            "/eth/v1/beacon/light_client/finality_update"]
    out += ["/eth/v0/beacon/proof/state/head?gindex=52,34", "/eth/v0/beacon/proof/state/head",
            "/eth/v0/beacon/proof/state/finalized?gindex=35"]
    reveal = "0x" + "c0" + "00" * 95
    out += [f"/eth/v2/validator/blocks/4?randao_reveal={reveal}&graffiti=0x" + "ab" * 32,
            f"/eth/v2/validator/blocks/4?randao_reveal={reveal}&graffiti=parity",
            "/eth/v2/validator/blocks/4",
            "/eth/v1/validator/duties/proposer/0", "/eth/v1/validator/duties/proposer/1",
            "/eth/v1/validator/duties/proposer/7",
            "/eth/v1/validator/attestation_data?slot=4&committee_index=0",
            "/eth/v1/validator/attestation_data?slot=4",
            f"/eth/v1/validator/aggregate_attestation?slot=3&attestation_data_root={unknown}",
            "/eth/v1/validator/sync_committee_contribution?slot=3&subcommittee_index=0"
            f"&beacon_block_root={r3}",
            "/eth/v1/events?topics=nonsense"]
    out += [f"/eth/v1/node/{leaf}" for leaf in ("health", "version", "syncing", "identity",
                                                 "peers", "peers/16Uiu2NOPE", "peer_count")]
    out += ["/eth/v2/debug/beacon/states/head", "/eth/v2/debug/beacon/states/genesis",
            "/eth/v1/debug/beacon/heads", "/eth/v2/debug/beacon/heads", "/eth/v0/debug/forkchoice",
            "/eth/v0/debug/traces", "/eth/v0/debug/traces?count=x", "/eth/v0/debug/traces/3",
            "/eth/v0/debug/launches", "/eth/v0/debug/launches?count=soon",
            "/eth/v0/debug/launches?program=no_such_prog", "/eth/v0/debug/slo",
            "/eth/v1/config/spec", "/eth/v1/config/fork_schedule",
            "/eth/v1/config/deposit_contract", "/eth/v1/nonsense", "/eth/v2/validator/blocks/x"]
    return out


def test_every_get_route_gives_the_same_status_and_json(both_servers):
    """Every GET route of `ROUTES` (the SSE stream's refusal included) and
    their error paths: equal status codes and equal JSON from both packages'
    servers over the same chain."""
    import re

    from lodestar_tpu import telemetry as jtel
    from lodestar_tpu_torch import telemetry as ttel
    from lodestar_tpu_torch.api.server import ROUTES

    for tel in (jtel, ttel):
        tel.reset_launch_telemetry()
    chain, _, roots = both_servers[T]
    paths = get_paths(chain, roots)
    get_routes = {pattern for method, pattern, _ in ROUTES if method == "GET"}
    hit = {pattern for pattern in get_routes for path in paths
           if re.match("^" + pattern + "$", path.split("?")[0])}
    assert hit == get_routes, f"routes without a probe: {sorted(get_routes - hit)}"
    statuses = set()
    for path in paths:
        want = http(both_servers[J][1], path)
        got = http(both_servers[T][1], path)
        assert got == want, path
        statuses.add(want[0])
    assert statuses >= {200, 400, 404, 500, 501}


def post_probes(chain):
    """POST routes with a body each package treats alike: the error paths
    (malformed JSON, bodies that do not decode, duties for a bad epoch) and
    the routes that only record."""
    return [
        ("/eth/v1/beacon/blocks", {}),
        ("/eth/v1/beacon/blocks", {"message": {"slot": "4"}}),
        ("/eth/v1/beacon/blocks", b"{not json"),
        ("/eth/v1/beacon/pool/voluntary_exits", {"bogus": 1}),
        ("/eth/v1/beacon/pool/attester_slashings", {}),
        ("/eth/v1/beacon/pool/proposer_slashings", {}),
        ("/eth/v1/beacon/pool/bls_to_execution_changes", {"message": {}}),
        ("/eth/v1/beacon/pool/sync_committees", [{}]),
        ("/eth/v1/validator/duties/attester/0", [str(i) for i in range(16)]),
        ("/eth/v1/validator/duties/attester/0", ["x"]),
        ("/eth/v1/validator/duties/sync/0", [0, 1, 5]),
        ("/eth/v1/validator/duties/sync/64", [0]),
        ("/eth/v1/validator/liveness/0", ["1", "2"]),
        ("/eth/v1/validator/aggregate_and_proofs", []),
        ("/eth/v1/validator/contribution_and_proofs", []),
        ("/eth/v1/validator/beacon_committee_subscriptions",
         [{"committee_index": 0, "slot": 4, "is_aggregator": True}]),
        ("/eth/v1/validator/sync_committee_subscriptions", []),
        ("/eth/v1/validator/prepare_beacon_proposer",
         [{"validator_index": "1", "fee_recipient": "0x" + "aa" * 20}]),
        ("/eth/v1/validator/register_validator",
         [{"message": {"pubkey": "0x" + "bb" * 48}, "signature": "0x" + "00" * 96}]),
    ]


def test_post_routes_give_the_same_status_and_json(both_servers):
    for path, body in post_probes(both_servers[T][0]):
        want = http(both_servers[J][1], path, "POST", body)
        got = http(both_servers[T][1], path, "POST", body)
        assert got == want, path
    for root in (J, T):
        assert both_servers[root][0].proposer_preparation == {1: "0x" + "aa" * 20}


def test_publish_and_sse_events_are_equal():
    """A block produced over REST by both packages' servers (the same JSON),
    published to both: the same replies, heads and state roots, and the same
    SSE frames on head and block; republished, the same 400."""
    import time

    import chip_smoke

    servers_of, servers = serve_both()
    try:
        streams = {root: chip_smoke.SseConsumer(server.port)
                   for root, server in zip((J, T), servers)}
        reveal = "0x" + "c0" + "00" * 95
        produced = {root: http(url, f"/eth/v2/validator/blocks/4?randao_reveal={reveal}")
                    for root, (_, url, _) in servers_of.items()}
        assert produced[T] == produced[J] and produced[T][0] == 200
        signed = {"message": produced[J][1]["data"], "signature": "0x" + "c0" + "00" * 95}
        for _ in range(2):
            replies = [http(url, "/eth/v1/beacon/blocks", "POST", signed)
                       for _, url, _ in servers_of.values()]
            assert replies[1] == replies[0]
        assert replies[0][0] == 400 and "ALREADY_KNOWN" in replies[0][1]["message"]
        deadline = time.time() + 10
        while time.time() < deadline and any(len(c.frames) < 2 for c in streams.values()):
            time.sleep(0.05)
        assert streams[T].frames == streams[J].frames
        assert sorted(e for e, _ in streams[T].frames) == ["block", "head"]
        heads = []
        for chain, _, _ in servers_of.values():
            head = chain.get_head_state()
            heads.append((chain.head_root, head.type.hash_tree_root(head), int(head.slot)))
        assert heads[1] == heads[0] and heads[0][2] == 4
    finally:
        for server in servers:
            server.stop()
    for stream in streams.values():
        stream.thread.join(15)
        assert not stream.thread.is_alive()


def _publish(root, gbytes, raw):
    """`raw` (an Altair block's bytes) published over REST to a fresh chain of
    `root` on its host oracle: (status, JSON), whether the head moved, and
    the head and its state's root."""
    from .test_torch_light_client import pkg

    P = pkg(root)
    api = importlib.import_module(f"{root}.api")
    json_mod = importlib.import_module(f"{root}.ssz.json")
    chain = P.chain.BeaconChain(anchor_state=P.t.altair.BeaconState.deserialize(gbytes),
                                bls_verifier=P.bls.BlsSingleThreadVerifier(),
                                db=P.db.MemoryDbController(), cfg=P.cfg(), current_slot=1)
    before = chain.head_root
    server = api.BeaconRestApiServer(api.BeaconApiImpl(chain), port=0)
    server.start()
    try:
        body = json_mod.to_json(P.t.altair.SignedBeaconBlock,
                                P.t.altair.SignedBeaconBlock.deserialize(raw))
        reply = http(f"http://127.0.0.1:{server.port}", "/eth/v1/beacon/blocks", "POST", body)
    finally:
        server.stop()
    head = chain.get_head_state()
    return reply, chain.head_root != before, (chain.head_root, head.type.hash_tree_root(head))


def test_forged_sync_aggregate_over_rest_imports_in_jax_and_is_refused_by_the_port():
    """The departure of `get_block_signature_sets` (ROADMAP Queue 3) at the
    REST seam: a block whose sync aggregate is signed over another root,
    published to each package's server (chains on their host oracle), is
    imported by the JAX chain (200) and refused by the port's (400,
    INVALID_SIGNATURES, head unchanged); the valid block imports in both,
    with the same head and state root."""
    from .test_torch_block_sets import altair_blocks

    gbytes, valid, forged = altair_blocks()
    jax_reply, jax_moved, _ = _publish(J, gbytes, forged["root"])
    assert (jax_reply, jax_moved) == ((200, {}), True)
    (status, reply), moved, _ = _publish(T, gbytes, forged["root"])
    assert status == 400 and reply["message"].startswith("INVALID_SIGNATURES") and not moved
    jax_valid, port_valid = _publish(J, gbytes, valid), _publish(T, gbytes, valid)
    assert port_valid == jax_valid and port_valid[:2] == ((200, {}), True)
