"""`chip_smoke.py` phase 10f's scenario (`chip_smoke.rest_run`) on a card,
at the minimal preset: one slot of a `RestValidator`'s duties over the
port's Beacon REST API on a chain of 64 interop validators with altair,
bellatrix and capella at epoch 1 (head at slot 11), the chain's verifier
`BlsDeviceVerifierPool` on cuda:0 on an event loop attached as
`chain.loop` (its HTR device the card): the block, each attestation, each
sync-committee message and each contribution one pool job, each job one
class-8 replay, no eager launch and no capture; the forged attestation and
the block signed with another key refused with HTTP 400 after one replay
each; the SSE events; the server stopped with nothing left running. The
same scenario on the port's `BlsSingleThreadVerifier` (the host oracle)
gives the same duties, verdicts, replies and events.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_api_cuda.py -q
"""

import asyncio

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import params
from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, BlsSingleThreadVerifier
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import fp_cuda
from lodestar_tpu_torch.ssz import device_htr as dh

SLOTS = range(12, 13)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pool's replays run only on a GPU")
    prev_preset = params.active_preset()
    params.set_active_preset("minimal")
    prev_dev, prev_min = dh._htr_device, dh.DEVICE_MIN_FLUSH_PAIRS
    prev = dh.configure_device_htr(mode="on")
    dh.DEVICE_MIN_FLUSH_PAIRS = 64
    yield torch.device("cuda", torch.cuda.current_device())
    dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    dh.configure_device_htr(mode=prev, device=prev_dev)
    params.set_active_preset(prev_preset)


def rest_chain():
    """`chip_smoke.py`'s minimal-preset stand-in for phase 10e's chain: 64
    interop validators, altair, bellatrix and capella at epoch 1, two blocks
    at slots 10-11 imported on a mock verifier. Returns (chain, keys, preset,
    config)."""
    from lodestar_tpu_torch.chain.bls import BlsVerifierMock
    from lodestar_tpu_torch.chain.chain import BeaconChain
    from lodestar_tpu_torch.db import MemoryDbController
    from lodestar_tpu_torch.state_transition.genesis import (
        create_interop_genesis_state,
        interop_secret_keys,
    )

    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    sks = interop_secret_keys(64)
    with chip_smoke.host_only_htr():
        genesis = create_interop_genesis_state(64, p=p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        prelude = chip_smoke.build_segment(genesis, sks, p, cfg, range(10, 12))
    chain = BeaconChain(anchor_state=genesis.copy(), bls_verifier=BlsVerifierMock(True),
                        db=MemoryDbController(), p=p, cfg=cfg, current_slot=11)

    async def go():
        for signed in prelude:
            await chain.process_block(signed)

    asyncio.run(go())
    return chain, sks, p, cfg


def rest_outcome(out):
    """What phase 10f's checks read: per slot the duties' counts, the pool
    jobs of each request by route, the forgeries' replies, the SSE slots and
    the oracle's verdicts."""
    per_request = [(r["slot"], r["method"], r["path"], r["jobs"]) for r in out["records"]]
    return ([(len(o["attestations"]), len(o["sync_messages"]), len(o["sync_contributions"]),
              o["block_sync_bits"]) for o in out["outs"]], per_request,
            out["forged_attestation"], out["forged_block"].split(":")[:3], out["sse"],
            all(ok for _, ok in out["oracle"]))


@pytest.mark.cuda
def test_rest_duty_slot_on_the_card_equals_the_oracle(cuda_device):
    bv.warm_single_launch([8], device=cuda_device)
    steps, totals, classes = {}, dict.fromkeys(fp_cuda.KERNELS, 0), set()

    def step(name):
        return chip_smoke.CountedStep(cuda_device, steps, totals, classes, name)

    captures = bv._SINGLE_LAUNCH_GRAPHS.captures
    chain, sks, p, cfg = rest_chain()
    on_card = chip_smoke.rest_run(chain, sks, p, cfg, SLOTS,
                                  lambda: BlsDeviceVerifierPool(device=cuda_device), step=step)
    chain, sks, p, cfg = rest_chain()
    on_host = chip_smoke.rest_run(chain, sks, p, cfg, SLOTS, BlsSingleThreadVerifier)
    assert rest_outcome(on_card) == rest_outcome(on_host)
    for r in on_card["records"]:
        replays = steps[r["step"]]["replays_by_class"]
        assert replays == ({8: len(r["jobs"])} if r["jobs"] else {}), (r["method"], r["path"])
    assert sum(len(r["jobs"]) for r in on_card["records"]) >= 8
    assert not any(v for s in steps.values() for v in s["fp_eager"].values())
    assert all(totals[k] > 0 for k in fp_cuda.KERNELS)
    assert bv._SINGLE_LAUNCH_GRAPHS.captures == captures
    assert not chip_smoke.server_threads()
