"""The port's light client (`lodestar_tpu_torch.light_client` and its
`client`), its server on the chain (`chain.light_client_server`) and the
Beacon API JSON codec (`ssz.json`) against the JAX package's, minimal
preset.

Tolerance: none. The three cases of the JAX package's
`tests/light_client/test_light_client.py` run on the port (`port_copy`: the
JAX test module with its imports rewritten to the port, assertions
unchanged, collected here as `test_port_*`). The scenario of
`tests/light_client/test_server.py` runs through both packages: an Altair
chain of 16 validators (altair at genesis) whose three blocks carry real
sync aggregates (built by the JAX test's `_altair_block`, carried into
each package as SSZ bytes) is imported by each package's `BeaconChain`
with a `LightClientServer` attached; every bootstrap and update either
server builds serializes byte for byte as the other's, and a store in
each package built from the bootstrap validates and applies the optimistic
update to the same headers. A tampered branch, signature, attested header
or participation is rejected in both with the same message;
`is_better_update` agrees on every pair; `to_json` gives the same JSON and
`from_json` of either package's JSON gives the same bytes in the other.
The `Lightclient` over an in-process JSON adapter (the REST shape its
docstring names) on each package's server, with each package's client,
reaches the same status, headers and head events, and refuses an unknown
root and a tampered bootstrap. `tests/network/test_lc_reqresp.py`'s
scenario runs over TCP on 127.0.0.1 through the port and with the
packages mixed (the JAX client against the port's node and the port's
client against the JAX node): every response is the same bytes and every
error chunk the same class as between two JAX peers.

`tests/light_client/test_client_loop.py` drives the client through the
JAX package's REST API (`api`), which the port has not ported yet (ROADMAP
Queue 1, item 6); it waits for that item. Phase 10e of `chip_smoke.py`
(`lc_run`) also runs here on the CPU at the minimal preset, on the port's
oracle verifier.
"""

from __future__ import annotations

import asyncio
import functools
import importlib

import pytest

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

port_copy("tests.light_client.test_light_client", globals())

J, T = ROOTS
N = 16
FAR = 2**64 - 1
NAMES = {J: "jax", T: "port"}

_MODULES = {
    "params": "params", "types": "types", "config": "config", "chain": "chain.chain",
    "bls": "chain.bls", "db": "db", "lc": "light_client", "client": "light_client.client",
    "server": "chain.light_client_server", "json": "ssz.json", "reqresp": "reqresp",
    "rr": "reqresp.reqresp", "node": "network.reqresp_node",
}


class Pkg:
    def __init__(self, root):
        self.root = root
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))
        self.p = self.params.MINIMAL
        self.t = self.types.ssz_types(self.p)

    def cfg(self):
        return self.config.minimal_chain_config().replace(
            ALTAIR_FORK_EPOCH=0, BELLATRIX_FORK_EPOCH=FAR, CAPELLA_FORK_EPOCH=FAR,
            DENEB_FORK_EPOCH=FAR)


@functools.lru_cache(maxsize=None)
def pkg(root) -> Pkg:
    return Pkg(root)


@functools.lru_cache(maxsize=None)
def chain_bytes():
    """The JAX package's Altair genesis and three blocks with full sync
    aggregates at slots 1-3 (the JAX test's `_altair_block`), as SSZ bytes."""
    from lodestar_tpu.state_transition import state_transition
    from lodestar_tpu.state_transition.altair import upgrade_to_altair
    from lodestar_tpu.state_transition.genesis import (
        create_interop_genesis_state,
        interop_secret_keys,
    )

    from .state_transition.test_altair import _altair_block

    j = pkg(J)
    p, cfg = j.p, j.cfg()
    sks = interop_secret_keys(N)
    genesis = upgrade_to_altair(
        create_interop_genesis_state(N, p=p, genesis_fork_version=cfg.GENESIS_FORK_VERSION),
        cfg, p)
    state, blocks = genesis, []
    for slot in (1, 2, 3):
        signed = _altair_block(state, slot, sks, p, cfg)
        blocks.append(signed.type.serialize(signed))
        state = state_transition(state, signed, p, cfg, verify_signatures=False,
                                 verify_proposer_signature=False)
    return genesis.type.serialize(genesis), tuple(blocks)


@functools.lru_cache(maxsize=None)
def served(root):
    """(chain, server, genesis, block roots) of `root`'s package: the blocks
    imported by its `BeaconChain` (mock verifier) with its server attached."""
    P = pkg(root)
    gbytes, bbytes = chain_bytes()
    genesis = P.t.altair.BeaconState.deserialize(gbytes)
    chain = P.chain.BeaconChain(anchor_state=genesis, bls_verifier=P.bls.BlsVerifierMock(True),
                                db=P.db.MemoryDbController(), cfg=P.cfg(), current_slot=3)
    server = P.server.LightClientServer(chain)
    chain.light_client_server = server
    blocks = [P.t.altair.SignedBeaconBlock.deserialize(b) for b in bbytes]

    async def go():
        for signed in blocks:
            await chain.process_block(signed)

    asyncio.run(go())
    roots = [P.t.altair.BeaconBlock.hash_tree_root(b.message) for b in blocks]
    assert chain.head_root == roots[-1]
    return chain, server, genesis, roots


def ser(value):
    return None if value is None else value.type.serialize(value)


def gvr_fork(genesis):
    return bytes(genesis.genesis_validators_root), bytes(genesis.fork.current_version)


# --- the server (tests/light_client/test_server.py) ---------------------------


def test_server_updates_are_bytes_equal_and_verify_in_both():
    seen = []
    for root in ROOTS:
        P = pkg(root)
        chain, server, genesis, roots = served(root)
        boots = [server.get_bootstrap(r) for r in roots]
        update = server.get_optimistic_update()
        assert update is not None and server.get_finality_update() is None
        assert len(boots[-1].current_sync_committee.pubkeys) == P.p.SYNC_COMMITTEE_SIZE
        store = P.lc.LightClientStore(finalized_header=boots[-1].header,
                                      current_sync_committee=boots[-1].current_sync_committee,
                                      p=P.p)
        P.lc.validate_light_client_update(store, update, *gvr_fork(genesis), P.p)
        store.process_update(update, *gvr_fork(genesis))
        assert store.optimistic_header.beacon.slot == update.attested_header.beacon.slot
        seen.append(([ser(b) for b in boots], ser(update),
                      [ser(u) for u in server.get_updates(0, 2)],
                      ser(store.optimistic_header), ser(store.finalized_header),
                      ser(store.best_valid_update)))
    assert seen[1] == seen[0]
    assert seen[0][2], "best-by-period tracked"


def _tampered(P, update):
    out = []
    bad = update.copy()
    bad.next_sync_committee_branch = [b"\x00" * 32] * len(update.next_sync_committee_branch)
    out.append(("branch", bad))
    bad = update.copy()
    sig = bytearray(bytes(update.sync_aggregate.sync_committee_signature))
    sig[40] ^= 0x01
    bad.sync_aggregate.sync_committee_signature = bytes(sig)
    out.append(("signature byte", bad))
    bad = update.copy()
    bad.attested_header.beacon.proposer_index = 999
    out.append(("attested header", bad))
    bad = update.copy()
    bad.sync_aggregate.sync_committee_bits = [False] * P.p.SYNC_COMMITTEE_SIZE
    out.append(("no participant", bad))
    bad = update.copy()
    bad.signature_slot = 8 * P.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD * 3
    out.append(("uncovered period", bad))
    return out


def test_tampered_updates_are_rejected_in_both():
    seen = []
    for root in ROOTS:
        P = pkg(root)
        _, server, genesis, roots = served(root)
        boot = server.get_bootstrap(roots[0])
        store = P.lc.LightClientStore(finalized_header=boot.header,
                                      current_sync_committee=boot.current_sync_committee, p=P.p)
        rejects = []
        for label, bad in _tampered(P, server.get_optimistic_update()):
            with pytest.raises(P.lc.LightClientError) as e:
                P.lc.validate_light_client_update(store, bad, *gvr_fork(genesis), P.p)
            rejects.append((label, str(e.value)))
        seen.append(rejects)
    assert seen[1] == seen[0]
    assert [m for _, m in seen[0]][:2] == ["invalid next-sync-committee branch",
                                          "invalid sync aggregate signature"]


def test_is_better_update_agrees_on_every_pair():
    seen = []
    for root in ROOTS:
        P = pkg(root)
        _, server, _, _ = served(root)
        full = server.get_optimistic_update()
        variants = [full]
        for n in (P.p.SYNC_COMMITTEE_SIZE // 2, P.p.SYNC_COMMITTEE_SIZE * 2 // 3 + 1, 1):
            v = full.copy()
            v.sync_aggregate.sync_committee_bits = [i < n for i in range(P.p.SYNC_COMMITTEE_SIZE)]
            variants.append(v)
        older = full.copy()
        older.attested_header.beacon.slot = 1
        final = full.copy()
        final.finalized_header.beacon.slot = 8
        variants += [older, final]
        seen.append([[P.lc.is_better_update(a, b) for b in variants] for a in variants])
        assert P.lc.sync_committee_period(P.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD, P.p) == 1
    assert seen[1] == seen[0]


# --- ssz.json ------------------------------------------------------------------


def test_json_agrees_and_round_trips_across_the_packages():
    jp, tp = pkg(J), pkg(T)
    _, jserver, _, jroots = served(J)
    _, tserver, _, troots = served(T)
    pairs = [(jserver.get_bootstrap(jroots[1]), tserver.get_bootstrap(troots[1]), "LightClientBootstrap"),
             (jserver.get_optimistic_update(), tserver.get_optimistic_update(), "LightClientUpdate")]
    for jv, tv, name in pairs:
        jtyp, ttyp = getattr(jp.t, name), getattr(tp.t, name)
        jjson, tjson = jp.json.to_json(jtyp, jv), tp.json.to_json(ttyp, tv)
        assert tjson == jjson
        assert ttyp.serialize(tp.json.from_json(ttyp, jjson)) == jtyp.serialize(jv)
        assert jtyp.serialize(jp.json.from_json(jtyp, tjson)) == ttyp.serialize(tv)
    # every kind of field: uints as strings, booleans, byte vectors and lists,
    # bitfields, lists of containers
    block = tp.t.altair.SignedBeaconBlock.deserialize(chain_bytes()[1][0])
    typ = tp.t.altair.SignedBeaconBlock
    data = tp.json.to_json(typ, block)
    assert data == jp.json.to_json(jp.t.altair.SignedBeaconBlock,
                                   jp.t.altair.SignedBeaconBlock.deserialize(chain_bytes()[1][0]))
    assert typ.serialize(tp.json.from_json(typ, data)) == chain_bytes()[1][0]
    assert data["message"]["slot"] == "1"
    for P in (jp, tp):
        assert P.json.from_json(P.t.Checkpoint.fields[0][1], "7") == 7
        with pytest.raises(TypeError, match="unsupported type"):
            P.json.to_json(object(), 1)


# --- the Lightclient over an in-process JSON adapter ---------------------------


class JsonAdapter:
    """The client's REST-shaped transport over a `LightClientServer` in the
    same process: each answer through the server package's `to_json`, a
    missing update as a raise (the 404)."""

    def __init__(self, P, server):
        self.P, self.server = P, server

    def _json(self, name, value):
        return self.P.json.to_json(getattr(self.P.t, name), value)

    def get_lc_bootstrap(self, root_hex):
        boot = self.server.get_bootstrap(bytes.fromhex(root_hex[2:]))
        if boot is None:
            raise KeyError(root_hex)
        return {"data": self._json("LightClientBootstrap", boot)}

    def get_lc_updates(self, start_period, count):
        return {"data": [{"data": self._json("LightClientUpdate", u)}
                         for u in self.server.get_updates(start_period, count)]}

    def get_lc_finality_update(self):
        u = self.server.get_finality_update()
        if u is None:
            raise KeyError("no finality update")
        return {"version": "altair", "data": self._json("LightClientUpdate", u)}

    def get_lc_optimistic_update(self):
        u = self.server.get_optimistic_update()
        if u is None:
            raise KeyError("no optimistic update")
        return {"version": "altair", "data": self._json("LightClientUpdate", u)}


COMBOS = [(J, T), (T, J), (T, T)]


@pytest.mark.parametrize("client_root,server_root", COMBOS + [(J, J)],
                         ids=[f"{NAMES[c]}-client-{NAMES[s]}-server" for c, s in COMBOS + [(J, J)]])
def test_lightclient_over_json_reaches_the_same_head(client_root, server_root):
    C, S = pkg(client_root), pkg(server_root)
    chain, server, genesis, roots = served(server_root)
    adapter = JsonAdapter(S, server)

    def client(transport):
        return C.client.Lightclient(transport=transport, genesis_validators_root=gvr_fork(genesis)[0],
                                    fork_version=gvr_fork(genesis)[1], p=C.p)

    lc = client(adapter)
    assert lc.status == C.client.RunStatusCode.UNINITIALIZED
    lc.bootstrap(roots[0])
    heads = []
    lc.on_head(lambda h: heads.append(int(h.beacon.slot)))
    applied = lc.sync_to_head()
    lc.poll_head()
    got = (lc.status, lc.finalized_slot, lc.head_slot, applied, heads,
           C.t.LightClientHeader.serialize(lc.store.optimistic_header))
    assert got[:5] == (C.client.RunStatusCode.STARTED, 1, 2, 1, [2])

    with pytest.raises(Exception):
        client(adapter).bootstrap(b"\x13" * 32)

    class Tamper(JsonAdapter):
        def get_lc_bootstrap(self, root_hex):
            out = super().get_lc_bootstrap(root_hex)
            branch = list(out["data"]["current_sync_committee_branch"])
            branch[0] = "0x" + "ee" * 32
            out["data"]["current_sync_committee_branch"] = branch
            return out

    with pytest.raises(C.lc.LightClientError, match="branch"):
        client(Tamper(S, server)).bootstrap(roots[0])
    reference = pkg(J).client.Lightclient(transport=JsonAdapter(pkg(J), served(J)[1]),
                                          genesis_validators_root=gvr_fork(genesis)[0],
                                          fork_version=gvr_fork(genesis)[1], p=pkg(J).p)
    reference.bootstrap(served(J)[3][0])
    reference.sync_to_head()
    reference.poll_head()
    assert got[-1] == pkg(J).t.LightClientHeader.serialize(reference.store.optimistic_header)


# --- light-client req/resp over TCP (tests/network/test_lc_reqresp.py) ---------


def _pid(name):
    return f"/eth2/beacon_chain/req/{name}/1/ssz_snappy"


async def _exchange(client_root, server_root):
    """Every request of the JAX test from `client_root`'s `ReqResp` to
    `server_root`'s node: the responses as bytes, the errors as class and
    message."""
    C = pkg(client_root)
    chain, _, _, roots = served(server_root)
    node = pkg(server_root).node.ReqRespBeaconNode(chain)
    server = await asyncio.start_server(lambda r, w: node.handle_stream(r, w, "client"),
                                        "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]

    async def dial():
        return await asyncio.open_connection("127.0.0.1", port)

    client = C.reqresp.ReqResp()
    out = []

    async def ask(name, req):
        try:
            got = await client.send_request(dial, _pid(name), req)
            out.append((name, [ser(v) for v in got]))
        except C.rr.ResponseError as e:
            out.append((name, type(e).__name__, str(e)))

    await ask("light_client_bootstrap", roots[-1])
    req = C.t.LightClientUpdatesByRange.default()
    req.start_period, req.count = 0, 2
    await ask("light_client_updates_by_range", req)
    req = C.t.LightClientUpdatesByRange.default()
    req.start_period, req.count = 0, 2**64 - 1  # clamped to the protocol's chunk cap
    await ask("light_client_updates_by_range", req)
    await ask("light_client_optimistic_update", None)
    await ask("light_client_finality_update", None)
    await ask("light_client_bootstrap", b"\x99" * 32)
    # no wait_closed(): 3.12 waits for in-flight handlers
    server.close()
    return out


@pytest.mark.parametrize("client_root,server_root", COMBOS,
                         ids=[f"{NAMES[c]}-client-{NAMES[s]}-node" for c, s in COMBOS])
def test_light_client_protocols_over_tcp(client_root, server_root):
    got = asyncio.run(_exchange(client_root, server_root))
    want = asyncio.run(_exchange(J, J))
    assert got == want
    boot, updates, capped, opt, fin, unknown = got
    assert len(boot[1]) == 1 and updates[1] and capped[1] == updates[1] and opt[1]
    assert fin[1] == "ResponseError" and "finality" in fin[2]
    assert unknown[1] == "ResponseError"


# --- chip_smoke.py phase 10e on the CPU ----------------------------------------


def test_phase_10e_scenario_on_the_cpu():
    """`chip_smoke.lc_run` at the minimal preset on the port's oracle
    verifier (the on-card test is `tests/test_torch_light_client_cuda.py`):
    a chain of 64 validators with capella at epoch 1 at head slot 11, four
    blocks with full sync aggregates imported (3 sets each), the forged one
    rejected INVALID_SIGNATURES, a `Lightclient` over req/resp on TCP at
    the last good block's parent, the forged update refused."""
    import chip_smoke
    from lodestar_tpu_torch.chain.bls import BlsSingleThreadVerifier

    from .test_torch_light_client_cuda import PRELUDE, SLOTS, _outcome, _run

    assert (PRELUDE, SLOTS) == (range(10, 12), range(12, 17))
    out, _ = _run(BlsSingleThreadVerifier)
    assert _outcome(out) == (["imported"] * 4, "INVALID_SIGNATURES", [[3]] * 4, 1, 14, 12,
                             "LightClientError: invalid sync aggregate signature")
    assert chip_smoke.LC_BLOCKS == 4
