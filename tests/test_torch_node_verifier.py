"""The JAX package's `tests/node/test_device_verifier_runtime.py` on the port
(`port_copy`), minimal preset, on the CPU: a `BeaconNode` with
`use_device_verifier=True` verifies through `BlsDeviceVerifierPool` on the
port's device model (here its plain PyTorch path, ~7 s a size-8 batch),
rejects a tampered block, and the offload service verifies through it.

Tolerance: none; the assertions are the JAX test's. The port's node and
`verify_signature_sets_device` run on CUDA unless told otherwise, so a
fixture of this file hands the copied tests a `BeaconNodeOptions` whose
`device` defaults to "cpu" and a `verify_signature_sets_device` whose
`device` does (in the port's modules, for the test's length); the program
gets no new default. One case is written out here:
`test_device_pool_is_the_node_verifier` asserts that the pool keeps the
JAX package's `verify_signature_sets_device` as `_verify_fn`; the port's
pool keeps no such attribute (its lanes call the device model per lane),
so the case here asserts instead that every lane of the node's pool runs
`models.batch_verify`'s lane verify on the node's device, no function
injected. The card's version is `tests/test_torch_node_cuda.py`.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import node as NODE
from lodestar_tpu_torch.models import batch_verify as bv

from .test_torch_node import CpuOptions
from .test_torch_utils_gaps import port_copy

REAL_VERIFY = bv.verify_signature_sets_device


def verify_on_cpu(sets, device="cpu", prep=None):
    return REAL_VERIFY(sets, device=device, prep=prep)


COPIED = port_copy(
    "tests.node.test_device_verifier_runtime", globals(),
    names={"test_device_pool_rejects_tampered_block", "test_device_pool_through_grpc_offload",
           "test_offload_server_restart_reconnects"})


@pytest.fixture(scope="module", autouse=True)
def one_aten_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def node_on_cpu(monkeypatch):
    monkeypatch.setattr(NODE, "BeaconNodeOptions", CpuOptions)
    monkeypatch.setattr(COPIED, "BeaconNodeOptions", CpuOptions)
    monkeypatch.setattr(bv, "verify_signature_sets_device", verify_on_cpu)
    with chip_smoke.node_settings_restored():
        yield


def test_port_device_pool_is_the_node_verifier(minimal_preset):
    """The JAX case, with the pool's verify function checked lane by lane."""

    async def run():
        build = COPIED._mk_node_and_validator(minimal_preset, use_device=True)
        node, validator = await build()
        assert isinstance(node.bls, COPIED.BlsDeviceVerifierPool)
        # every lane runs the port's device model on the node's device
        lanes = node.bls.mesh.lanes
        assert len(lanes) == 1 and str(lanes[0].device) == "cpu"
        assert lanes[0].verify_fn.__qualname__ == bv.make_lane_verify_fn(0, "cpu").__qualname__
        assert lanes[0].verify_fn.__module__ == bv.__name__

        before = dict(node.bls.metrics)
        for slot in (1, 2):
            node.chain.fork_choice.on_tick(slot)
            out = await validator.run_slot_duties(slot)
            assert out["proposed"] is not None
        head = node.chain.get_head_state()
        assert head.slot == 2

        atts = out["attestations"]
        assert atts
        node.on_gossip("beacon_attestation", (atts[0], 0), peer="p1")
        await node.processor.execute_work()

        from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
        from lodestar_tpu_torch.models.batch_verify import make_synthetic_sets

        ok = await node.bls.verify_signature_sets(
            make_synthetic_sets(3, seed=31), VerifySignatureOpts(batchable=True)
        )
        assert ok

        after = node.bls.metrics
        assert after["sig_sets_started"] > before["sig_sets_started"], (
            "block verification did not flow through the device pool"
        )
        assert after["batch_sigs_success"] >= 3, "RLC batch path did not run"
        assert after["errors"] == 0
        await node.close()

    asyncio.run(run())
