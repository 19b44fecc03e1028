"""`chip_smoke.py` phase 10e's scenario (`chip_smoke.lc_run`) on a card, at
the minimal preset: an interop genesis of 64 validators with altair,
bellatrix and capella at epoch 1, a chain at head slot 11 (two blocks with
empty sync aggregates, imported with a mock verifier), then on a verifier
that is `BlsDeviceVerifierPool` on cuda:0 (its HTR device the card): (a)
four Capella blocks at slots 12-15 whose sync aggregates carry the whole
32-member committee, each imported in one class-8 replay of its three sets
(proposer, randao, the sync committee's), (b) a block at slot 16 whose
aggregate is signed over another root, rejected INVALID_SIGNATURES after
one class-8 replay with the head and the server's updates unchanged, and
(c) a `Lightclient` over req/resp on 127.0.0.1 bootstrapping from the
slot-12 block, following the optimistic head to slot 14 and refusing an
update with one signature byte changed, with no replay. No step launches a
kernel eagerly and no BLS graph is captured. The same scenario on the
port's `BlsSingleThreadVerifier` (the host oracle) gives the same verdicts,
heads and light-client headers.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_light_client_cuda.py -q
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
PRELUDE = range(10, 12)  # empty aggregates, imported with a mock verifier
SLOTS = range(12, 17)  # four full aggregates, then one over another root


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


def _run(make_verifier, step=None):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    sks = interop_secret_keys(N)
    with chip_smoke.host_only_htr():
        genesis = create_interop_genesis_state(N, p=p,
                                               genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        prelude = chip_smoke.build_segment(genesis, sks, p, cfg, PRELUDE)
    chain = BeaconChain(anchor_state=genesis.copy(), bls_verifier=BlsVerifierMock(True),
                        db=MemoryDbController(), p=p, cfg=cfg, current_slot=PRELUDE[-1])

    async def run():
        for signed in prelude:
            await chain.process_block(signed)
        sync = {s: "full" for s in SLOTS[:-1]}
        sync[SLOTS[-1]] = chip_smoke.LC_FORGED_ROOT
        with chip_smoke.host_only_htr():
            blocks = chip_smoke.build_segment(chain.get_head_state(), sks, p, cfg, SLOTS,
                                              sync=sync)
        chain.bls = make_verifier()
        try:
            return await chip_smoke.lc_run(chain, blocks[:-1], blocks[-1], p, cfg, step=step)
        finally:
            await chain.bls.close()

    out = asyncio.run(run())
    return out, chain.head_root


def _outcome(out):
    c = out["c"]
    return ([r["verdict"] for r in out["imports"]], out["forged"]["verdict"],
            [r["sets"] for r in out["imports"]], c["applied"], c["head_slot"],
            c["finalized_slot"], c["forged_update"])


@pytest.mark.cuda
def test_lightclient_scenario_on_the_card_equals_the_oracle(cuda_device):
    bv.warm_single_launch([8], device=cuda_device)
    steps, totals, classes = {}, dict.fromkeys(fp_cuda.KERNELS, 0), set()

    def step(name):
        return chip_smoke.CountedStep(cuda_device, steps, totals, classes, name)

    captures = bv._SINGLE_LAUNCH_GRAPHS.captures
    on_card, head_card = _run(lambda: BlsDeviceVerifierPool(device=cuda_device), step)
    on_host, head_host = _run(BlsSingleThreadVerifier)
    assert _outcome(on_card) == _outcome(on_host)
    assert head_card == head_host
    assert _outcome(on_card)[:2] == (["imported"] * 4, "INVALID_SIGNATURES")
    assert (on_card["c"]["head_slot"], on_card["c"]["finalized_slot"]) == (14, 12)
    assert {name: s["replays_by_class"] for name, s in steps.items()} == {
        "a1": {8: 1}, "a2": {8: 1}, "a3": {8: 1}, "a4": {8: 1}, "b": {8: 1}, "c": {}}
    assert not any(v for s in steps.values() for v in s["fp_eager"].values())
    assert all(totals[k] > 0 for k in fp_cuda.KERNELS)
    assert bv._SINGLE_LAUNCH_GRAPHS.captures == captures
