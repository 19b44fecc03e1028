"""Import hygiene of the PyTorch/CUDA port.

* Every module of `lodestar_tpu_torch` imports in a fresh interpreter where
  `jax`, `lodestar_tpu`, `grpc`, `yaml` and `prometheus_client` cannot be
  imported, and importing builds and loads no kernel and no native host
  library, starts no thread, builds no graph (HTR graphs included), makes no
  SHA-256 constant a tensor and initializes no CUDA context.
* No module of the port, and not `chip_smoke.py`, imports `jax` or
  `lodestar_tpu` (checked on the syntax tree; the top-level name is
  compared exactly, since `lodestar_tpu_torch` starts with the same
  letters).
* Without a GPU, the entry point refuses to run rather than carry on
  quietly on the CPU, and `chip_smoke.py` fails and prints no result.
"""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "lodestar_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "lodestar_tpu"}

_SNIPPET = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None           # any `import jax` now raises ImportError
sys.modules["lodestar_tpu"] = None  # and so does any import of the JAX package
sys.modules["grpc"] = None          # and grpc: the offload host imports without it
sys.modules["yaml"] = None          # and PyYAML: spec_test reads .yaml only when a case has one
sys.modules["prometheus_client"] = None  # and the metrics registry's library: built at first use
import threading
threads_before = threading.active_count()
import lodestar_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lodestar_tpu_torch.__path__, "lodestar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from lodestar_tpu_torch.ops import fp_cuda, prep
assert fp_cuda._lib is None, "a kernel library was loaded at import"
assert prep._const_on.cache_info().currsize == 0, "a prep constant was put on a device at import"
from lodestar_tpu_torch.models import batch_verify
assert batch_verify._neg_g1_on.cache_info().currsize == 0, "-g1 was put on a device at import"
assert not batch_verify._SINGLE_LAUNCH_GRAPHS.graphs, "a graph was captured at import"
from lodestar_tpu_torch.ssz import device_htr
from lodestar_tpu_torch.ops import sha256
assert not device_htr.HTR_GRAPHS.graphs and not device_htr.ROOT_GRAPHS.graphs, \
    "an HTR graph was built at import"
assert device_htr.launch_count() == 0, "an HTR level was launched at import"
assert not [k for k, v in vars(sha256).items() if isinstance(v, torch.Tensor)], \
    "a SHA-256 constant was made a tensor at import"
from lodestar_tpu_torch.crypto import kzg
assert not kzg._MSM_GRAPHS.graphs and not kzg._PAIRING_GRAPHS.graphs, \
    "a KZG graph was captured at import"
assert kzg._points_on.cache_info().currsize == 0, "the KZG setup was put on a device at import"
assert kzg.load_trusted_setup.cache_info().currsize == 0, "the KZG setup was parsed at import"
assert not torch.cuda.is_initialized(), "CUDA was initialized at import"
from lodestar_tpu_torch import native
from lodestar_tpu_torch.native import bls as native_bls
from lodestar_tpu_torch.ssz import hash as ssz_hash
assert native._lib is None and not native._load_failed, "the SHA-256 library was loaded at import"
assert native_bls._lib is None and not native_bls._load_failed, "the BLS library was loaded at import"
assert native_bls._warm_thread is None, "the BLS warm-up started at import"
assert not ssz_hash._native_probed, "the host hasher was probed at import"
assert threading.active_count() == threads_before, "a thread was started at import"
print("imported", len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SNIPPET], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    # ops.prep, telemetry, and the serving modules: chain.bls.{interface,mesh,pool},
    # scheduler.{core,occupancy}, slo, tracing, logger, utils, offload.resilience,
    # crypto.bls.pairing; and the HTR slice: ops.sha256, params, types, ssz and its
    # six modules, state_transition and its htr; and the KZG slice: ops.msm, crypto.kzg;
    # and the offload host: offload.tenancy, offload.server, chain.bls.fallback; and the
    # offload client: offload.client, offload.audit, testing, testing.clock, testing.faults;
    # and the sharded road's testing.mesh; and the state transition: config,
    # spec_test, and state_transition's util, shuffle, cache, epoch, block,
    # altair, bellatrix, capella, deneb, genesis and signature_sets; and the
    # chain: utils.queue, fork_choice and its proto_array, db and its schema,
    # controller and repository, chain's op_pools, sync_pools, clock, regen,
    # archiver, validation, produce_block and chain; and the network side:
    # utils.snappy, reqresp and its encoding, protocols, rate_limiter and
    # reqresp, network and its gossip, peers, reqresp_node and processor, sync
    # and its range_sync, backfill and unknown_block; and the libp2p side: prover
    # and its mpt, network.transport and its identity, multistream, noise, mplex
    # and host, network's gossipsub, discv5, discovery, subnets and service; and
    # ssz.json, light_client and its client, chain.light_client_server,
    # testing.fleet and tracing.export; and metrics and its monitoring and
    # validator_monitor, native and its bls, execution and its engine, eth1,
    # eth1_tracker and builder; and api and its client, impl and server,
    # validator and its slashing_protection, store, keystore, doppelganger,
    # keymanager and rest_client, and flare; and node and its checkpoint_sync
    # and notifier, cli and __main__ (which runs the CLI only as __main__)
    assert "imported" in proc.stdout and int(proc.stdout.split()[-1]) >= 145


def _imported_top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 104
    serving = {"chain/bls/pool.py", "chain/bls/mesh.py", "chain/bls/interface.py",
               "scheduler/core.py", "scheduler/occupancy.py", "slo.py", "tracing/__init__.py",
               "logger.py", "utils/__init__.py", "offload/resilience.py",
               "crypto/bls/pairing.py"}
    htr = {"ops/sha256.py", "params/__init__.py", "types/__init__.py", "ssz/__init__.py",
           "ssz/hash.py", "ssz/merkle.py", "ssz/types.py", "ssz/batch.py", "ssz/tree.py",
           "ssz/device_htr.py", "state_transition/__init__.py", "state_transition/htr.py"}
    kzg = {"ops/msm.py", "crypto/kzg.py"}
    offload = {"offload/__init__.py", "offload/tenancy.py", "offload/server.py",
               "offload/client.py", "offload/audit.py", "testing/__init__.py",
               "testing/clock.py", "testing/faults.py"}
    sharded = {"testing/mesh.py"}
    stf = {"config/__init__.py", "spec_test/__init__.py"} | {
        f"state_transition/{m}.py" for m in ("util", "shuffle", "cache", "epoch", "block",
                                             "altair", "bellatrix", "capella", "deneb",
                                             "genesis", "signature_sets")}
    chain = {"utils/queue.py", "fork_choice/__init__.py", "fork_choice/proto_array.py",
             "db/__init__.py", "db/schema.py", "db/controller.py", "db/repository.py"} | {
        f"chain/{m}.py" for m in ("op_pools", "sync_pools", "clock", "regen", "archiver",
                                  "validation", "produce_block", "chain")}
    network = {"utils/snappy.py", "reqresp/__init__.py", "reqresp/encoding.py",
               "reqresp/protocols.py", "reqresp/rate_limiter.py", "reqresp/reqresp.py",
               "network/__init__.py", "network/gossip.py", "network/peers.py",
               "network/reqresp_node.py", "network/processor.py", "sync/__init__.py",
               "sync/range_sync.py", "sync/backfill.py", "sync/unknown_block.py"}
    assert len(network) == 15
    p2p = {"prover/__init__.py", "prover/mpt.py", "network/transport/__init__.py"} | {
        f"network/transport/{m}.py" for m in ("identity", "multistream", "noise", "mplex",
                                              "host")} | {
        f"network/{m}.py" for m in ("gossipsub", "discv5", "discovery", "subnets", "service")}
    assert len(p2p) == 13
    light = {"ssz/json.py", "light_client/__init__.py", "light_client/client.py",
             "chain/light_client_server.py", "testing/fleet.py", "tracing/export.py"}
    host = {"metrics/__init__.py", "metrics/monitoring.py", "metrics/validator_monitor.py",
            "native/__init__.py", "native/bls.py", "execution/__init__.py",
            "execution/engine.py", "execution/eth1.py", "execution/eth1_tracker.py",
            "execution/builder.py"}
    api_validator = {"api/__init__.py", "api/client.py", "api/impl.py", "api/server.py",
                     "flare.py"} | {
        f"validator/{m}.py" for m in ("__init__", "slashing_protection", "store", "keystore",
                                      "doppelganger", "keymanager", "rest_client")}
    assert len(api_validator) == 12
    node_cli = {"node/__init__.py", "node/checkpoint_sync.py", "node/notifier.py", "cli.py",
                "__main__.py"}
    assert (serving | htr | kzg | offload | sharded | stf | chain | network | p2p | light | host
            | api_validator | node_cli) <= {
        str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    bad = [
        f"{f.relative_to(REPO)}:{line} imports {name}"
        for f in files
        for name, line in _imported_top_levels(f)
        if name in FORBIDDEN
    ]
    assert not bad, "\n".join(bad)
    # the check itself tells the port's name from the JAX package's
    assert "lodestar_tpu_torch" not in FORBIDDEN


def test_kzg_reads_the_ports_own_trusted_setup():
    """`crypto/kzg.py` reads the setup file beside it, a byte-equal copy of
    the JAX package's, and names no path of the JAX package."""
    from lodestar_tpu_torch.crypto import kzg

    own = PORT / "crypto" / "trusted_setup.bin"
    assert pathlib.Path(kzg.SETUP_PATH) == own and own.is_file()
    default = inspect.signature(kzg.load_trusted_setup).parameters["path"].default
    assert pathlib.Path(default) == own
    assert own.read_bytes() == (REPO / "lodestar_tpu" / "crypto" / "trusted_setup.bin").read_bytes()
    assert "lodestar_tpu/" not in (PORT / "crypto" / "kzg.py").read_text()


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from lodestar_tpu_torch.models import batch_verify as bv

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bv.verify_signature_sets_device([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bv.resolve_device("cuda")
    assert bv.resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
