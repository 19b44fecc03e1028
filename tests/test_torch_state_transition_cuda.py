"""The block import of `chip_smoke.py` phase 10 on a card, at the minimal
preset: an interop genesis of 64 validators, altair, bellatrix and capella
at epoch 1, and a Capella block at slot 9 with the attestations of slot 8.
Imported on cuda:0 (the state roots through the HTR device on the card,
every level of 64 pairs or more launched; the sets through the verifier
pool's single-launch replay) and on the CPU (the plain versions): equal
verdicts (True, and False with two attestations' signatures swapped),
equal post-state bytes, each root the block's.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_state_transition_cuda.py -q
"""

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import params
from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.state_transition.genesis import (
    create_interop_genesis_state,
    interop_secret_keys,
)

N = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the import's replays run only on a GPU")
    prev_preset = params.active_preset()
    params.set_active_preset("minimal")
    prev_dev, prev_min = dh._htr_device, dh.DEVICE_MIN_FLUSH_PAIRS
    prev = dh.configure_device_htr(mode="auto")
    dh.DEVICE_MIN_FLUSH_PAIRS = 64
    yield torch.device("cuda", torch.cuda.current_device())
    dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    dh.configure_device_htr(mode=prev, device=prev_dev)
    params.set_active_preset(prev_preset)


def _import(device, genesis, signed, p, cfg, swapped_sets):
    """The import on `device` (HTR and pool), then the swapped sets' verdict."""
    dh.configure_device_htr(device=device)

    async def run(pool, executor):
        res, sets, post = await chip_smoke.import_block(pool, executor, genesis, signed, p, cfg)
        swapped = await pool.verify_signature_sets(swapped_sets(sets))
        return res, post, swapped

    return chip_smoke.on_pool(device, run)


@pytest.mark.cuda
def test_block_import_on_the_card_equals_the_cpu(cuda_device):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    sks = interop_secret_keys(N)
    genesis = create_interop_genesis_state(N, p=p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    slot = p.SLOTS_PER_EPOCH + 1
    signed, _, _ = chip_smoke.build_block(genesis, sks, p, cfg, slot, attest_from=slot - 1)

    def swapped_sets(sets):
        out = list(sets)
        out[2] = bls.SignatureSet(sets[2].pubkey, sets[2].message, sets[3].signature)
        out[3] = bls.SignatureSet(sets[3].pubkey, sets[3].message, sets[2].signature)
        return out

    launches = dh.launch_count()
    on_card, post_card, swapped_card = _import(cuda_device, genesis, signed, p, cfg, swapped_sets)
    assert dh.launch_count() > launches  # the state roots went through the card
    on_cpu, post_cpu, swapped_cpu = _import("cpu", genesis, signed, p, cfg, swapped_sets)
    assert on_card["verdict"] is on_cpu["verdict"] is True
    assert swapped_card is swapped_cpu is False
    assert on_card["root"] == on_cpu["root"] == bytes(signed.message.state_root)
    assert on_card["error"] is on_cpu["error"] is None
    assert post_card.type.serialize(post_card) == post_cpu.type.serialize(post_cpu)
    assert on_card["n_sets"] == on_cpu["n_sets"] == 4
