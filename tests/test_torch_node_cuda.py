"""The port's beacon node and CLI on a card, at the minimal preset.

* `BeaconNode.init` with default options (`device="cuda"`) takes the CUDA
  `BlsDeviceVerifierPool` as its verifier; two slots of an in-process
  validator's duties import their blocks through it (one class-8 replay
  each), and a block whose signature has a byte changed is rejected: the
  JAX package's `tests/node/test_device_verifier_runtime.py` on the card.
* Two processes of the port's CLI, both on the card: `dev` serving P2P and
  `beacon --dev-genesis --bootnode` range-syncing from it to slot 10 across
  the altair fork (the JAX package's `tests/node/test_two_process_sync.py`).
  Each process builds its pool and captures its own class-8 graph on first
  use, from the pool's lane thread (20-60 s on an H100), and the dev
  process stalls at its first block for that capture, then catches up with
  the wall clock. So the syncing process starts once the dev process has
  printed slot 5 (not 8 s after it: its head would still be at genesis,
  and there would be nothing to range-sync), the dev node lingers 150 s
  instead of 30, the syncing process gets 420 s instead of 240 and the dev
  process 300 s instead of 120 after it.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_node_cuda.py -q
"""

import asyncio
import copy
import os
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_minimal():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the node's default verifier runs only on a GPU")
    with chip_smoke.node_settings_restored():
        params.set_active_preset("minimal")
        yield params.active_preset()


@pytest.mark.cuda
def test_default_node_verifies_blocks_on_the_card(cuda_minimal):
    from lodestar_tpu_torch.chain.chain import BlockError
    from lodestar_tpu_torch.cli import dev_chain_config
    from lodestar_tpu_torch.config import create_beacon_config
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.node import BeaconNode, BeaconNodeOptions
    from lodestar_tpu_torch.state_transition.genesis import (
        create_interop_genesis_state,
        interop_secret_keys,
    )
    from lodestar_tpu_torch.validator import SlashingProtection, Validator, ValidatorStore

    p = cuda_minimal
    cc = dev_chain_config()
    sks = interop_secret_keys(8)
    genesis = create_interop_genesis_state(8, p=p, genesis_fork_version=cc.GENESIS_FORK_VERSION)

    async def run():
        node = await BeaconNode.init(
            anchor_state=genesis, chain_config=cc,
            opts=BeaconNodeOptions(rest_enabled=False, manual_clock=True),
            p=p, time_fn=lambda: 0.0)
        try:
            assert chip_smoke.verifier_kind(node.bls) == "pool:cuda"
            store = ValidatorStore(create_beacon_config(cc, bytes(genesis.genesis_validators_root)),
                                   SlashingProtection(MemoryDbController()), sks, p)
            validator = Validator(chain=node.chain, store=store, p=p)
            before = chip_smoke.bls_replays(torch.device("cuda", 0))
            for slot in (1, 2):
                node.chain.fork_choice.on_tick(slot)
                out = await validator.run_slot_duties(slot)
                assert out["proposed"] is not None
            assert node.chain.get_head_state().slot == 2
            after = chip_smoke.bls_replays(torch.device("cuda", 0))
            assert after.get(8, 0) - before.get(8, 0) == 2
            assert node.bls.metrics["errors"] == 0

            bad = copy.deepcopy(out["proposed"])
            sig = bytearray(bytes(bad.signature))
            sig[10] ^= 0xFF
            bad.signature = bytes(sig)
            bad.message.slot = 3
            node.chain.fork_choice.on_tick(3)
            with pytest.raises(BlockError):
                await node.chain.process_block(bad)
            assert node.chain.get_head_state().slot == 2
            assert (bv._SINGLE_LAUNCH_GRAPHS.graphs[(0, 8)].replays
                    == after[8] + 1), "the tampered block was not verified on the card"
        finally:
            await node.close()

    asyncio.run(run())


@pytest.mark.cuda
def test_two_processes_of_the_port_sync_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: both processes verify on the GPU")
    port = chip_smoke.free_port()
    genesis_time = int(time.time()) + 3
    slots, target = 14, 10
    env = {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1"}
    a_log, b_log = open(tmp_path / "a.log", "w"), open(tmp_path / "b.log", "w")
    a = subprocess.Popen(
        [sys.executable, "-m", "lodestar_tpu_torch", "dev", "--validators", "16",
         "--slots", str(slots), "--slot-time", "1", "--p2p-port", str(port),
         "--genesis-time", str(genesis_time), "--linger", "150", "--altair-epoch", "1"],
        cwd=REPO, env=env, stdout=a_log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 300
        while "slot   5:" not in (tmp_path / "a.log").read_text():
            assert a.poll() is None and time.time() < deadline, (tmp_path / "a.log").read_text()
            time.sleep(0.5)
        b = subprocess.Popen(
            [sys.executable, "-m", "lodestar_tpu_torch", "beacon", "--preset", "minimal",
             "--dev-genesis", "--genesis-validators", "16", "--genesis-time", str(genesis_time),
             "--slot-time", "1", "--bootnode", f"127.0.0.1:{port}", "--rest-port", "0",
             "--sync-target", str(target), "--altair-epoch", "1"],
            cwd=REPO, env=env, stdout=b_log, stderr=subprocess.STDOUT)
        try:
            rc_b = b.wait(timeout=420)
        finally:
            if b.poll() is None:
                b.kill()
        rc_a = a.wait(timeout=300)
    finally:
        if a.poll() is None:
            a.kill()
        a_log.close()
        b_log.close()
    a_out, b_out = (tmp_path / "a.log").read_text(), (tmp_path / "b.log").read_text()
    assert rc_b == 0, f"B failed to sync:\n--- B ---\n{b_out[-4000:]}\n--- A ---\n{a_out[-4000:]}"
    assert rc_a == 0, a_out[-4000:]
    assert f"sync target {target} reached" in b_out
    assert "range sync done" in b_out
    assert "head slot" in b_out
    assert f"dev chain done: head slot {slots}" in a_out
