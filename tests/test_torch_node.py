"""The port's beacon node (`lodestar_tpu_torch.node`: `BeaconNodeOptions`,
`BeaconNode`, `checkpoint_sync`, `notifier`) against the JAX package's
(`lodestar_tpu.node`), minimal preset, on the CPU.

Tolerance: none; states compare by their roots, checkpoints by epoch and
root. The JAX package's `tests/node/test_notifier.py` and
`tests/node/test_checkpoint_sync.py` run on the port (`port_copy`; the
second's `_empty_block_at` comes from a sibling JAX test module, so it is
`bridged`), their assertions unchanged. The port's node verifies on CUDA
unless told otherwise, so a fixture of this file hands the copied tests a
`BeaconNodeOptions` whose `device` defaults to "cpu" (in the port's
`node` module and the copied modules' namespaces, for the test's length);
the program gets no new default. (`tests/node/test_device_verifier_runtime.py`
takes ~1 min of CPU verifies and has a file of its own,
`tests/test_torch_node_verifier.py`; the two-process sync is in
`tests/test_torch_two_process.py`, the dev run in `tests/test_torch_cli_dev.py`.)
Beside them:

* every `BeaconNodeOptions` validation error is the JAX package's message,
  and the options' stored values are the JAX package's, apart from the
  port's `device` and `use_device_verifier`'s default (None, "the
  device's default");
* the verifier each package's node chooses (the oracle, the pool, the
  offload chain with its layers) is the same, with `device="cpu"` on the
  port's side; on "cuda" (CUDA's check and the pool stood in for), the
  offload chain with `offload_fallback="device"` ends at the card's pool,
  with no host oracle after it;
* without CUDA, `BeaconNode.init` with default options raises before it
  opens its db, binds a server or starts a thread;
* checkpoint sync across the packages: each package's
  `fetch_checkpoint_state` over REST from the other package's server gives
  the state root of the serving chain's head; each package's
  `load_anchor_state_from_db` reads the write-ahead log the other
  package's archiver wrote, and gets the archived state's root.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import os
import threading

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import node as NODE

from .test_torch_api import bridged
from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

J, T = "lodestar_tpu", "lodestar_tpu_torch"
PortOptions = NODE.BeaconNodeOptions


class CpuOptions(PortOptions):
    """The port's `BeaconNodeOptions` with `device="cpu"` unless given."""

    def __init__(self, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)


COPIED = [
    port_copy("tests.node.test_notifier", globals()),
    port_copy("tests.node.test_checkpoint_sync", globals()),
]
COPIED[1]._empty_block_at = bridged(COPIED[1]._empty_block_at)


@contextlib.contextmanager
def jax_node_settings_restored():
    """`chip_smoke.node_settings_restored` for the JAX package: the settings
    its `BeaconNode.init` reconfigures process-wide (the preset, prep and
    single-launch modes, prep metrics, HTR mode and metrics, launch
    telemetry, the KZG fallback counter, the SLO accountant), saved on
    entry and put back on exit, so a later test in the process (the
    launch-ledger comparison of `tests/test_torch_utils_gaps.py`, for one)
    does not find a JAX node's SLO model."""
    mods = {m: importlib.import_module(f"{J}.{m}") for m in
            ("models.batch_verify", "ops.prep", "ssz.device_htr", "telemetry", "crypto.kzg",
             "slo", "params")}
    acct = mods["slo"]._ACCT
    fields = [(mods["models.batch_verify"], "_prep_mode"),
              (mods["models.batch_verify"], "_prep_metrics"),
              (mods["models.batch_verify"], "_single_launch_mode"),
              (mods["ops.prep"], "_launch_counter"), (mods["ssz.device_htr"], "_htr_mode"),
              (mods["ssz.device_htr"], "_htr_metrics"), (mods["telemetry"], "_mode"),
              (mods["telemetry"], "_metrics"), (mods["telemetry"], "_ledger"),
              (mods["crypto.kzg"], "_kzg_fallback_counter"), (acct, "model"),
              (acct, "metrics"), (acct, "slack_floor_s"), (acct, "monotonic_ns")]
    saved = [getattr(obj, name) for obj, name in fields]
    preset = mods["params"].active_preset()
    try:
        yield
    finally:
        for (obj, name), value in zip(fields, saved):
            setattr(obj, name, value)
        mods["params"].set_active_preset(preset)


@pytest.fixture(autouse=True)
def node_on_cpu(monkeypatch):
    """The copied tests' nodes on the CPU; the process-global settings the
    nodes of both packages change put back after each test."""
    monkeypatch.setattr(NODE, "BeaconNodeOptions", CpuOptions)
    for module in COPIED:
        if hasattr(module, "BeaconNodeOptions"):
            monkeypatch.setattr(module, "BeaconNodeOptions", CpuOptions)
    with chip_smoke.node_settings_restored(), jax_node_settings_restored():
        yield


def node(root):
    return importlib.import_module(f"{root}.node")


def options(root, **kwargs):
    if root == T:
        kwargs.setdefault("device", "cpu")
        return PortOptions(**kwargs)
    return node(J).BeaconNodeOptions(**kwargs)


# --- options -------------------------------------------------------------------

INVALID = {
    "offload_fallback": {"offload_fallback": "gpu"},
    "offload_audit_via": {"offload_audit_via": "peer"},
    "bls_device_prep": {"bls_device_prep": "always"},
    "bls_pipeline": {"bls_pipeline": "bogus"},
    "bls_single_launch": {"bls_single_launch": "once"},
    "htr_device": {"htr_device": "tpu"},
    "bls_mesh": {"bls_mesh": "all"},
    "offload_tenant": {"offload_tenant": "x" * 300},
    "offload_tenant_empty": {"offload_tenant": ""},
    "launch_telemetry": {"launch_telemetry": "loud"},
    "slo_slack_floor_ms": {"slo_slack_floor_ms": -1.0},
}


def error_of(root, kwargs):
    try:
        options(root, **kwargs)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(INVALID))
def test_option_errors_are_the_jax_ones(case):
    want = error_of(J, INVALID[case])
    assert want is not None and want[0] == "ValueError"
    assert error_of(T, INVALID[case]) == want


def test_option_values_are_the_jax_ones():
    kwargs = {"offload_endpoints": ["127.0.0.1:1"], "offload_hedge_delay_ms": 0,
              "offload_quarantine_cooloff_s": 0, "bootnodes": [("127.0.0.1", 9000)],
              "offload_tenant": "alice", "slo_slack_floor_ms": 5.0}
    for kw in ({}, kwargs):
        jax, port = vars(options(J, **kw)), vars(options(T, **kw))
        assert port.pop("device") == "cpu"
        assert jax.pop("use_device_verifier") is False and port.pop("use_device_verifier") is None
        jax.pop("on_shutdown_request"), port.pop("on_shutdown_request")
        assert port == jax
    assert PortOptions().device == "cuda"
    with pytest.raises(ValueError, match=r"device must be one of \('cuda', 'cpu'\), got 'tpu'"):
        PortOptions(device="tpu")


# --- the verifier a node chooses -----------------------------------------------

CHOICES = {
    "default": {},
    "device_verifier": {"use_device_verifier": True},
    "oracle": {"use_device_verifier": False},
    "offload_cpu": {"offload_endpoints": ["127.0.0.1:9"], "offload_audit_rate": 0.0},
    "offload_device": {"offload_endpoints": ["127.0.0.1:9"], "offload_fallback": "device",
                       "offload_audit_rate": 0.0},
    "offload_none": {"offload_endpoints": ["127.0.0.1:9"], "offload_fallback": "none",
                     "offload_audit_rate": 0.0},
}


def chosen(root, kwargs):
    """The class of the node's verifier and, for a degradation chain, its
    layers' names and classes."""
    genesis = importlib.import_module(f"{root}.state_transition.genesis")
    params = importlib.import_module(f"{root}.params")

    async def go():
        n = await node(root).BeaconNode.init(
            anchor_state=genesis.create_interop_genesis_state(8, p=params.MINIMAL),
            opts=options(root, rest_enabled=False, manual_clock=True, **kwargs),
            p=params.MINIMAL, time_fn=lambda: 0.0)
        try:
            bls = n.bls
            layers = [(name, type(layer).__name__) for name, layer in getattr(bls, "layers", [])]
            lanes = ([str(lane.device) for lane in bls.mesh.lanes]
                     if root == T and hasattr(bls, "mesh") else [])
            return type(bls).__name__, layers, lanes
        finally:
            await n.close()

    return asyncio.run(go())


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_the_node_chooses_the_jax_packages_verifier(case):
    jax_kind, jax_layers, _ = chosen(J, CHOICES[case])
    port_kind, port_layers, lanes = chosen(T, CHOICES[case])
    assert (port_kind, port_layers) == (jax_kind, jax_layers)
    if port_kind == "BlsDeviceVerifierPool":
        assert lanes == ["cpu"]
    want = {"default": "BlsSingleThreadVerifier", "oracle": "BlsSingleThreadVerifier",
            "device_verifier": "BlsDeviceVerifierPool", "offload_none": "BlsOffloadClient"}
    assert port_kind == want.get(case, "DegradingBlsVerifier")


class PoolStandIn:
    """Takes the place of `BlsDeviceVerifierPool` where there is no card."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    async def close(self):
        pass


@pytest.mark.parametrize("fallback,layers", [
    ("device", [("offload", "BlsOffloadClient"), ("device_pool", "PoolStandIn")]),
    ("cpu", [("offload", "BlsOffloadClient"), ("cpu", "BlsSingleThreadVerifier")]),
])
def test_the_cuda_offload_chain_ends_at_the_cards_pool(monkeypatch, fallback, layers):
    """On "cuda", `offload_fallback="device"` ends the degradation chain at
    the card's pool, with no host oracle after it (a departure from the JAX
    chain); "cpu" keeps offload, then the oracle. CUDA's check and the pool
    are stood in for, so the node's choice runs here."""
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.chain import bls as t_bls
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.state_transition.genesis import create_interop_genesis_state

    monkeypatch.setattr(bv, "resolve_device", torch.device)
    monkeypatch.setattr(t_bls, "BlsDeviceVerifierPool", PoolStandIn)

    async def go():
        n = await NODE.BeaconNode.init(
            anchor_state=create_interop_genesis_state(8, p=params.MINIMAL),
            opts=PortOptions(rest_enabled=False, manual_clock=True, htr_device="off",
                             offload_endpoints=["127.0.0.1:9"], offload_fallback=fallback,
                             offload_audit_rate=0.0),
            p=params.MINIMAL, time_fn=lambda: 0.0)
        try:
            return [(name, type(layer).__name__) for name, layer in n.bls.layers], n.bls.layers
        finally:
            await n.close()

    with chip_smoke.node_settings_restored():
        names, chain = asyncio.run(go())
    assert names == layers
    if fallback == "device":
        assert chain[-1][1].kwargs["device"] is None  # one lane on each visible GPU


# --- no CUDA, no node ------------------------------------------------------------


def test_default_options_raise_without_cuda_before_anything_starts(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from lodestar_tpu_torch import params
    from lodestar_tpu_torch.state_transition.genesis import create_interop_genesis_state

    rest, metrics = chip_smoke.free_port(), chip_smoke.free_port()
    wal = tmp_path / "db" / "wal.log"
    before = {th.ident for th in threading.enumerate()}
    opts = PortOptions(db_path=str(wal), rest_port=rest, metrics_enabled=True,
                       metrics_port=metrics)
    assert opts.device == "cuda" and opts.use_device_verifier is None

    async def go():
        await NODE.BeaconNode.init(
            anchor_state=create_interop_genesis_state(8, p=params.MINIMAL), opts=opts,
            p=params.MINIMAL)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(go())
    assert {th.ident for th in threading.enumerate()} == before
    assert not chip_smoke.listening(rest) and not chip_smoke.listening(metrics)
    assert not os.path.exists(tmp_path / "db")


# --- checkpoint sync across the packages -------------------------------------------


def serving_chain(root):
    """`_import_chain` of the package's copy of the JAX test module: a
    3-block chain on a mock verifier, behind a REST server of its own."""
    module = COPIED[1] if root == T else importlib.import_module("tests.node.test_checkpoint_sync")
    genesis = importlib.import_module(f"{root}.state_transition.genesis")
    params = importlib.import_module(f"{root}.params")
    api = importlib.import_module(f"{root}.api")
    chain = module._import_chain(params.MINIMAL, genesis.interop_secret_keys(16), 3)
    server = api.BeaconRestApiServer(api.BeaconApiImpl(chain), port=0)
    server.start()
    return chain, server


def state_root(state):
    return bytes(state.type.hash_tree_root(state))


@pytest.mark.parametrize("server_root,client_root", [(J, T), (T, J)])
def test_checkpoint_sync_over_rest_across_the_packages(server_root, client_root):
    chain, server = serving_chain(server_root)
    try:
        sync = importlib.import_module(f"{client_root}.node.checkpoint_sync")
        client = importlib.import_module(f"{client_root}.api.client")
        params = importlib.import_module(f"{client_root}.params")
        url = f"http://127.0.0.1:{server.port}"
        state = sync.fetch_checkpoint_state(client.BeaconApiClient(url), state_id="head",
                                            p=params.MINIMAL, current_slot=5)
        assert int(state.slot) == 3
        assert state_root(state) == state_root(chain.get_head_state())
        with pytest.raises(sync.CheckpointSyncError, match="future"):
            sync.fetch_checkpoint_state(client.BeaconApiClient(url), state_id="head",
                                        p=params.MINIMAL, current_slot=1)
    finally:
        server.stop()


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
def test_anchor_state_from_the_other_packages_db(writer, reader, tmp_path):
    """A chain of `writer`'s archives its finalized state into a file db
    (as in the JAX `test_restart_from_db`); `reader`'s
    `load_anchor_state_from_db` over the same write-ahead log returns a
    state with the archived one's root."""
    W = {m: importlib.import_module(f"{writer}.{m}") for m in
         ("params", "db", "chain.chain", "chain.bls", "state_transition",
          "state_transition.genesis")}
    p = W["params"].MINIMAL
    sks = W["state_transition.genesis"].interop_secret_keys(16)
    genesis = W["state_transition.genesis"].create_interop_genesis_state(16, p=p)
    wal = str(tmp_path / "wal.log")
    db = W["db"].FileDbController(wal)
    chain = W["chain.chain"].BeaconChain(
        anchor_state=genesis, bls_verifier=W["chain.bls"].BlsVerifierMock(True), db=db,
        current_slot=p.SLOTS_PER_EPOCH + 1, archive_state_epoch_frequency=0)
    make_block = (importlib.import_module("tests.state_transition.test_state_transition")
                  ._empty_block_at if writer == J else COPIED[1]._empty_block_at)
    state, blocks = genesis, []
    for slot in range(1, p.SLOTS_PER_EPOCH + 1):
        b = make_block(state, slot, sks, p)
        blocks.append(b)
        state = W["state_transition"].state_transition(
            state, b, p, verify_signatures=False, verify_proposer_signature=False)

    async def go():
        for b in blocks:
            await chain.process_block(b)

    asyncio.run(go())
    head = chain.head_root

    class _CP:
        epoch = 1
        root = head

    chain.archiver.on_finalized(_CP())
    db.close()
    archived = state_root(chain.state_cache.get(head))

    R = {m: importlib.import_module(f"{reader}.{m}") for m in
         ("params", "db", "node.checkpoint_sync")}
    db2 = R["db"].FileDbController(wal)
    try:
        anchor = R["node.checkpoint_sync"].load_anchor_state_from_db(db2, R["params"].MINIMAL)
        assert anchor is not None and int(anchor.slot) == p.SLOTS_PER_EPOCH
        assert state_root(anchor) == archived
    finally:
        db2.close()
