"""The port's network service (`lodestar_tpu_torch.network.service`
`Libp2pBeaconNetwork`) against the JAX package's, minimal preset.

Tolerance: none. Two scenarios:

* `tests/network/test_discv5_integration.py`'s three services with the
  packages mixed: C and A know only B's ENR, find each other through discv5
  over UDP and dial over TCP + noise + mplex; every ENR carries the fork
  digest.
* A CPU rehearsal of `chip_smoke.py` phase 10d (`chip_smoke.p2p_run`, the
  phase's own code): an interop genesis of 64 validators with altair,
  bellatrix and capella at epoch 1, and Capella blocks at slots 10-13 built
  on it (`chip_smoke.build_segment`). Service A over a chain with a mock
  verifier, service B over a chain whose verifier is the port's
  `BlsDeviceVerifierPool` on one "cpu" lane; B finds A through discv5, runs
  the status handshake, range-syncs slots 10-11 over blocks-by-range v2 on an
  mplex stream inside the noise channel, imports the slot-12 block that A
  publishes on gossipsub through its `NetworkProcessor`, verifies an
  aggregate of slot 11 (True), rejects the slot-13 block with one byte of its
  proposer signature changed on the pool's False verdict (its head stays at
  12), and both services stop with a goodbye and no task left. The same
  scenario through two JAX services (B on the JAX package's
  `BlsSingleThreadVerifier`, the blocks and the aggregate the same bytes)
  must give the same status, meshes, range-sync result, verdicts, outcomes,
  processed counts and head roots. Two blocks are range-synced here, where
  the card runs four, to keep the pool's plain path (~6 s a size-8 batch on
  one ATen thread) inside the file's time.
"""

from __future__ import annotations

import asyncio
import functools
import importlib
from types import SimpleNamespace

import pytest

import chip_smoke

from .test_torch_chain import ROOTS, pkg
from .test_torch_chain import minimal_cpu  # noqa: F401 - this module's fixture too

J, T = ROOTS
NAMES = {J: "jax", T: "port"}
N = 64
SLOTS = range(10, 14)  # two range-synced, one gossiped, one tampered with


def net_modules(root):
    """`chip_smoke.p2p_modules` for either package."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        service=mod("network.service"), processor=mod("network.processor"),
        range_sync=mod("sync.range_sync"), gossipsub=mod("network.gossipsub"),
        host=mod("network.transport.host"), mplex=mod("network.transport.mplex"),
        noise=mod("network.transport.noise"))


def chain_config(P):
    """`chip_smoke.block_chain_config` in package P."""
    return P.config.mainnet_chain_config().replace(
        ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=1, CAPELLA_FORK_EPOCH=1)


@functools.lru_cache(maxsize=None)
def scenario_bytes():
    """(genesis, [(fork, block)]) built by the port on the host, as SSZ bytes."""
    P = pkg(T)
    cfg = chip_smoke.block_chain_config()
    sks = P.gen.interop_secret_keys(N)
    with chip_smoke.host_only_htr():
        genesis = P.gen.create_interop_genesis_state(
            N, p=P.p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        blocks = chip_smoke.build_segment(genesis, sks, P.p, cfg, SLOTS)
    return genesis.type.serialize(genesis), tuple(
        ("capella", b.type.serialize(b)) for b in blocks)


def _chain(P, verifier):
    g, _ = scenario_bytes()
    return P.chain.BeaconChain(
        anchor_state=P.t.phase0.BeaconState.deserialize(g), bls_verifier=verifier,
        db=P.db.MemoryDbController(), p=P.p, cfg=chain_config(P), current_slot=SLOTS[0] - 1)


async def _rehearse(P, verifier, make_aggregate):
    blocks = [getattr(P.t, fork).SignedBeaconBlock.deserialize(b)
              for fork, b in scenario_bytes()[1]]
    a_chain, b_chain = _chain(P, P.bls.BlsVerifierMock(True)), _chain(P, verifier)
    try:
        out = await chip_smoke.p2p_run(net_modules(P.root), a_chain, b_chain, blocks,
                                       make_aggregate, wait_s=120.0)
    finally:
        await verifier.close()
    return out


def _seen(out):
    """What both packages must agree on."""
    return {
        "status": out["a"]["status"], "mesh_peers": out["a"]["mesh_peers"],
        "discovered": (out["a"]["discovered_a"], out["a"]["dialed"][:1]),
        "range": (out["b"]["completed"], out["b"]["processed"], out["b"]["head_root"],
                  [n for _, n in out["b"]["downloads"]]),
        "gossip": [(name, out[name]["pool_verdicts"], out[name]["outcome"], out[name]["sets"],
                    out[name]["head_slot"]) for name in ("c_block", "c_aggregate", "d")],
        "heads": out["heads"], "verdicts": out["verdicts"], "processor": out["processor"],
        "goodbyes": len(out["e"]["goodbyes"]), "pending": out["e"]["pending"],
    }


def test_phase_10d_rehearsal_agrees_with_the_jax_services():
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool

    port, j = pkg(T), pkg(J)
    sks = port.gen.interop_secret_keys(N)
    agg = {}

    def port_aggregate(chain):
        signed = chip_smoke.signed_aggregate(chain, sks, SLOTS[1], 0)
        agg["bytes"] = signed.type.serialize(signed)
        return signed

    got = asyncio.run(_rehearse(port, BlsDeviceVerifierPool(device="cpu"), port_aggregate))
    want = asyncio.run(_rehearse(
        j, j.bls.BlsSingleThreadVerifier(),
        lambda chain: j.t.SignedAggregateAndProof.deserialize(agg["bytes"])))
    assert _seen(got) == _seen(want)
    blocks = [getattr(port.t, f).SignedBeaconBlock.deserialize(b) for f, b in scenario_bytes()[1]]
    root12 = blocks[2].message.type.hash_tree_root(blocks[2].message).hex()
    assert got["heads"] == {"A": root12, "B": root12}
    assert got["verdicts"] == [True, True, True, True, False]
    assert got["processor"] == {"processed": 2, "errors": 1}
    assert got["a"]["status"]["head_slot"] == 0 and got["b"]["processed"] == 2
    assert [got[k]["outcome"] for k in ("c_block", "c_aggregate", "d")] == [
        "processed", "processed", "error"]
    wire = got["e"]["wire"]
    assert all(w["noise_frames"] > 0 and w["bytes"] > 0 for w in wire.values())
    assert wire["B"]["mplex_streams"] >= 3  # gossipsub, status, blocks by range
    assert got["e"]["goodbyes"] and not got["e"]["pending"]


# --- discv5 drives libp2p dials (tests/network/test_discv5_integration.py) ----


class _NodeStub:
    def __init__(self):
        self.pushed = []

    def on_gossip(self, kind, msg, peer=""):
        self.pushed.append((kind, peer))
        return True


def _small_chain(P):
    far = 2**64 - 1
    cfg = P.config.minimal_chain_config().replace(
        ALTAIR_FORK_EPOCH=far, BELLATRIX_FORK_EPOCH=far, CAPELLA_FORK_EPOCH=far,
        DENEB_FORK_EPOCH=far)
    return P.chain.BeaconChain(anchor_state=P.genesis(8), bls_verifier=P.bls.BlsVerifierMock(True),
                               db=P.db.MemoryDbController(), cfg=cfg, current_slot=1)


async def _three_services(layout):
    """B is the DHT bootnode; C and A know only B's ENR (layout: B, C, A)."""
    rb, rc, ra = (pkg(r) for r in layout)
    nets = []
    try:
        b = net_modules(rb.root).service.Libp2pBeaconNetwork(
            node=_NodeStub(), chain=_small_chain(rb), discv5_port=0)
        nets.append(b)
        await b.start()
        c = net_modules(rc.root).service.Libp2pBeaconNetwork(
            node=_NodeStub(), chain=_small_chain(rc), discv5_port=0,
            discv5_bootnodes=[b.discv5.enr])
        nets.append(c)
        await c.start()
        a = net_modules(ra.root).service.Libp2pBeaconNetwork(
            node=_NodeStub(), chain=_small_chain(ra), discv5_port=0,
            discv5_bootnodes=[b.discv5.enr])
        nets.append(a)
        await a.start()
        for _ in range(30):
            for net in (b, c, a):
                await net.discv5.bootstrap(rounds=1)
            if c.host.peer_id in a.host.peers() and b.host.peer_id in a.host.peers():
                break
            for net in (a, c):  # one manual discovery pass, as the loop runs it
                for enr in net.discv5.enr_source():
                    if enr.node_id == net.discv5.node_id:
                        continue
                    tcp, ep = enr.pairs.get(b"tcp"), enr.udp_endpoint
                    if not tcp or ep is None:
                        continue
                    try:
                        await net.host.connect(ep[0], int.from_bytes(tcp, "big"))
                    except Exception:  # noqa: BLE001 - a refused dial is retried next pass
                        pass
            await asyncio.sleep(0.1)
        return (c.host.peer_id in a.host.peers(), b.host.peer_id in a.host.peers(),
                any(e.pairs.get(b"eth2") == a.current_fork_digest()
                    for e in a.discv5.enr_source() if e.node_id != a.discv5.node_id))
    finally:
        for net in nets:
            await net.stop()


LAYOUTS = [(J, T, T), (T, J, T), (T, T, J), (T, T, T)]


@pytest.mark.parametrize("layout", LAYOUTS, ids=["-".join(NAMES[r] for r in x) for x in LAYOUTS])
def test_discv5_drives_libp2p_dials(layout):
    assert asyncio.run(_three_services(layout)) == (True, True, True)
