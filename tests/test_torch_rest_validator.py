"""The port's `RestValidator` against the JAX package's, over both
packages' Beacon REST servers, minimal preset.

Tolerance: none.

* Duty parity: the same interop keys (the two slots' proposers and
  attesters, of 16 validators) in each package's `RestValidator`, each
  against its own package's server over an Altair genesis (the JAX
  package's, as SSZ bytes) on a mock verifier, for two slots: the signed
  blocks, attestations, sync-committee messages and contributions are equal
  as SSZ bytes, and so are the heads, the head states' roots and the
  slashing-protection interchange each store exports.
* Wire compatibility: the port's validator against the JAX server, and the
  JAX validator against the port's server, give the same bytes again.

The pool's duty loop and phase 10f's scenario are in
`tests/test_torch_rest_scenario.py`.
"""

from __future__ import annotations

import functools
import importlib
import json

import pytest

from .test_torch_chain import ROOTS
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages

J, T = ROOTS
N = 16
FAR = 2**64 - 1
DUTY_SLOTS = (1, 2)

_MODULES = {
    "params": "params", "types": "types", "config": "config", "chain": "chain.chain",
    "bls": "chain.bls", "db": "db", "gen": "state_transition.genesis",
    "altair": "state_transition.altair", "api": "api", "validator": "validator",
    "rest": "validator.rest_client",
}


class Pkg:
    def __init__(self, root):
        self.root = root
        for attr, name in _MODULES.items():
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))
        self.p = self.params.MINIMAL
        self.t = self.types.ssz_types(self.p)

    def cfg(self, altair=0):
        return self.config.minimal_chain_config().replace(
            ALTAIR_FORK_EPOCH=altair, BELLATRIX_FORK_EPOCH=FAR, CAPELLA_FORK_EPOCH=FAR,
            DENEB_FORK_EPOCH=FAR)


@functools.lru_cache(maxsize=None)
def pkg(root) -> Pkg:
    return Pkg(root)


@functools.lru_cache(maxsize=None)
def genesis_bytes(altair: bool) -> bytes:
    """The JAX package's interop genesis of N validators, upgraded to Altair
    at genesis when `altair`, as SSZ bytes."""
    j = pkg(J)
    cfg = j.cfg(0 if altair else FAR)
    g = j.gen.create_interop_genesis_state(N, p=j.p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    if altair:
        g = j.altair.upgrade_to_altair(g, cfg, j.p)
    return g.type.serialize(g)


def ser(value):
    return value.type.serialize(value)


@functools.lru_cache(maxsize=None)
def duty_keys() -> tuple:
    """The validators of the duty runs: each slot's proposer and attesters
    (on the JAX package's Altair genesis)."""
    from lodestar_tpu.chain.produce_block import dial_to_slot

    j = pkg(J)
    genesis = j.t.altair.BeaconState.deserialize(genesis_bytes(True))
    keys = set()
    for slot in DUTY_SLOTS:
        _, ctx = dial_to_slot(genesis, slot, j.p, j.cfg())
        keys.add(int(ctx.get_beacon_proposer(slot)))
        keys.update(int(v) for c in range(ctx.get_committee_count_per_slot(0))
                    for v in ctx.get_beacon_committee(slot, c))
    return tuple(sorted(keys))


@functools.lru_cache(maxsize=None)
def duty_run(client_root: str, server_root: str) -> tuple:
    """`client_root`'s `RestValidator` with the keys of `duty_keys` against
    `server_root`'s server (mock verifier) for DUTY_SLOTS: per slot the
    block, attestations, sync messages and contributions as bytes, the head
    and its state's root; then the store's interchange as JSON."""
    S, C = pkg(server_root), pkg(client_root)
    genesis = S.t.altair.BeaconState.deserialize(genesis_bytes(True))
    chain = S.chain.BeaconChain(anchor_state=genesis, bls_verifier=S.bls.BlsVerifierMock(True),
                                db=S.db.MemoryDbController(), cfg=S.cfg(), current_slot=0)
    server = S.api.BeaconRestApiServer(S.api.BeaconApiImpl(chain), port=0)
    server.start()
    try:
        gvr = bytes(genesis.genesis_validators_root)
        store = C.validator.ValidatorStore(
            C.config.create_beacon_config(C.cfg(), gvr),
            C.validator.SlashingProtection(C.db.MemoryDbController()),
            [C.gen.interop_secret_keys(N)[i] for i in duty_keys()], C.p)
        rv = C.rest.RestValidator(
            client=C.api.BeaconApiClient(f"http://127.0.0.1:{server.port}"), store=store, p=C.p)
        seen = []
        for slot in DUTY_SLOTS:
            chain.on_slot(slot)
            out = rv.run_slot_duties(slot)
            head = chain.get_head_state()
            seen.append((ser(out["proposed"]), [ser(a) for a in out["attestations"]],
                         [ser(m) for m in out["sync_messages"]],
                         [ser(c) for c in out["sync_contributions"]],
                         chain.head_root, head.type.hash_tree_root(head)))
        interchange = json.dumps(store.slashing.export_interchange(gvr, store.pubkeys))
        return tuple(seen), interchange
    finally:
        server.stop()


def test_duties_are_byte_equal_between_the_packages():
    jax_run, port_run = duty_run(J, J), duty_run(T, T)
    for slot, (want, got) in zip(DUTY_SLOTS, zip(jax_run[0], port_run[0])):
        block, atts, msgs, contributions, head, root = got
        assert atts and msgs and contributions, f"slot {slot}: a duty produced nothing"
        assert got == want, f"slot {slot} differs"
    assert port_run[1] == jax_run[1]
    assert sum(len(d["signed_blocks"]) for d in json.loads(port_run[1])["data"]) == 2


@pytest.mark.parametrize("client_root,server_root", [(T, J), (J, T)],
                         ids=["port-validator-jax-server", "jax-validator-port-server"])
def test_validators_and_servers_of_the_two_packages_interoperate(client_root, server_root):
    assert duty_run(client_root, server_root) == duty_run(J, J)
