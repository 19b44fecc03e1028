"""`chip_smoke.py` phase 10d's scenario (`chip_smoke.p2p_run`) on a card, at
the minimal preset: an interop genesis of 64 validators with altair,
bellatrix and capella at epoch 1, and Capella blocks at slots 10-15 built on
it (`chip_smoke.build_segment`). Service A over a chain with a mock verifier;
service B over a chain whose verifier is `BlsDeviceVerifierPool` on cuda:0
(its HTR device the card). B finds A through discv5 over UDP, dials it (TCP,
multistream, noise XX, mplex), range-syncs slots 10-13 from it over
blocks-by-range v2 (4 imports, one class-8 replay each), imports the slot-14
block A publishes on gossipsub (one class-8 replay), verifies an aggregate of
slot 13 (True, one class-8 replay) and rejects the slot-15 block with one
byte of its proposer signature changed (False, one class-8 replay, head at
14). No step launches a kernel eagerly; discovery and the stop replay
nothing. The same scenario with B on the port's `BlsSingleThreadVerifier`
(the host oracle) gives the same heads, verdicts and processor counts.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_p2p_cuda.py -q
"""

import asyncio

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import params
from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, BlsSingleThreadVerifier, BlsVerifierMock
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.db import MemoryDbController
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import fp_cuda
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.state_transition.genesis import (
    create_interop_genesis_state,
    interop_secret_keys,
)

N = 64
SLOTS = range(10, 16)  # four range-synced, one gossiped, one tampered with


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


def _run(dev, make_verifier, step=None):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    sks = interop_secret_keys(N)
    with chip_smoke.host_only_htr():
        genesis = create_interop_genesis_state(N, p=p,
                                               genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        blocks = chip_smoke.build_segment(genesis, sks, p, cfg, SLOTS)

    def chain(verifier):
        return BeaconChain(anchor_state=genesis.copy(), bls_verifier=verifier,
                           db=MemoryDbController(), p=p, cfg=cfg, current_slot=SLOTS[0] - 1)

    async def run():
        verifier = make_verifier()
        try:
            return await chip_smoke.p2p_run(
                chip_smoke.p2p_modules(), chain(BlsVerifierMock(True)), chain(verifier), blocks,
                lambda c: chip_smoke.signed_aggregate(c, sks, SLOTS[3], 0), step=step)
        finally:
            await verifier.close()

    return asyncio.run(run()), blocks


@pytest.mark.cuda
def test_p2p_scenario_on_the_card_equals_the_oracle(cuda_device):
    bv.warm_single_launch([8], device=cuda_device)
    steps, totals, classes = {}, dict.fromkeys(fp_cuda.KERNELS, 0), set()

    def step(name):
        return chip_smoke.CountedStep(cuda_device, steps, totals, classes, name)

    captures = bv._SINGLE_LAUNCH_GRAPHS.captures
    on_card, blocks = _run(cuda_device, lambda: BlsDeviceVerifierPool(device=cuda_device), step)
    on_host, _ = _run(cuda_device, BlsSingleThreadVerifier)
    for key in ("heads", "verdicts", "processor"):
        assert on_card[key] == on_host[key]
    gossiped = blocks[4].message.type.hash_tree_root(blocks[4].message).hex()
    assert on_card["heads"] == {"A": gossiped, "B": gossiped}
    assert on_card["verdicts"] == [True] * 6 + [False]
    assert on_card["processor"] == {"processed": 2, "errors": 1}
    assert {name: s["replays_by_class"] for name, s in steps.items()} == {
        "a": {}, "b": {8: 4}, "c_block": {8: 1}, "c_aggregate": {8: 1}, "d": {8: 1}}
    assert not any(v for s in steps.values() for v in s["fp_eager"].values())
    assert all(totals[k] > 0 for k in fp_cuda.KERNELS)
    assert bv._SINGLE_LAUNCH_GRAPHS.captures == captures
