"""The port's `BeaconChain` on a card, at the minimal preset: an interop
genesis of 64 validators, altair, bellatrix and capella at epoch 1, and three
Capella blocks at slots 9-11, produced on the host (`produce_block`, the
pools filled with one `chip_smoke.signed_aggregate` of each committee of the
slot before, so blocks 10 and 11 carry 2 attestations each). Imported by a
chain whose verifier pool and HTR device are cuda:0 (the sets through the
pool's single-launch replays, every state-root level of 64 pairs or more
launched on the card) and by one whose pool and HTR device are the CPU (the
plain versions): equal heads, equal post-state roots (each the block's),
equal fork-choice nodes and equal db bytes.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chain_cuda.py -q
"""

import asyncio

import pytest
import torch

import chip_smoke
from lodestar_tpu_torch import params, ssz
from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, BlsVerifierMock
from lodestar_tpu_torch.chain.chain import BeaconChain
from lodestar_tpu_torch.chain.produce_block import dial_to_slot, produce_block
from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.db import MemoryDbController
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.state_transition import EpochContext, state_hash_tree_root
from lodestar_tpu_torch.state_transition.genesis import (
    create_interop_genesis_state,
    interop_secret_keys,
)
from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain

N = 64
SLOTS = (9, 10, 11)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the chain's replays run only on a GPU")
    prev_preset = params.active_preset()
    params.set_active_preset("minimal")
    prev_dev, prev_min = dh._htr_device, dh.DEVICE_MIN_FLUSH_PAIRS
    prev = dh.configure_device_htr(mode="on")
    dh.DEVICE_MIN_FLUSH_PAIRS = 64
    yield torch.device("cuda", torch.cuda.current_device())
    dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    dh.configure_device_htr(mode=prev, device=prev_dev)
    params.set_active_preset(prev_preset)


def _chain(genesis, p, cfg, verifier, slot):
    return BeaconChain(anchor_state=genesis, bls_verifier=verifier, db=MemoryDbController(), p=p,
                       cfg=cfg, current_slot=slot)


def _produce(genesis, sks, p, cfg):
    """The three signed blocks, produced and imported on the host."""
    dh.configure_device_htr(device="cpu")
    chain = _chain(genesis, p, cfg, BlsVerifierMock(True), SLOTS[0])
    blocks = []
    for slot in SLOTS:
        chain.on_slot(slot)
        if blocks:
            prev = slot - 1
            committees = EpochContext(chain.get_head_state(), p).get_committee_count_per_slot(
                prev // p.SLOTS_PER_EPOCH)
            for ci in range(committees):
                agg = chip_smoke.signed_aggregate(chain, sks, prev, ci).message.aggregate
                chain.aggregated_attestation_pool.add(
                    agg, chain.types.AttestationData.hash_tree_root(agg.data))
        work, ctx = dial_to_slot(chain.get_head_state(), slot, p, cfg)
        proposer = ctx.get_beacon_proposer(slot)
        reveal = bls.sign(sks[proposer], compute_signing_root(
            ssz.uint64, slot // p.SLOTS_PER_EPOCH, get_domain(work, params.DOMAIN_RANDAO)))
        block = produce_block(chain, slot=slot, randao_reveal=reveal)
        signed = chip_smoke.sign_block(block, sks[proposer], work, p)
        asyncio.run(chain.process_block(signed))
        blocks.append(signed)
    return blocks


def _import(device, genesis, blocks, p, cfg):
    """The blocks through a chain whose pool and HTR device are `device`."""
    dh.configure_device_htr(device=device)

    async def run():
        pool = BlsDeviceVerifierPool(device=device)
        chain = _chain(genesis, p, cfg, pool, SLOTS[-1])
        try:
            roots = [await chain.process_block(b) for b in blocks]
        finally:
            await pool.close()
        states = [chain.get_state_by_block_root(r) for r in roots]
        return {
            "roots": roots, "head": chain.head_root,
            "state_roots": [state_hash_tree_root(st) for st in states],
            "nodes": [sorted(vars(n).items(), key=str) for n in chain.fork_choice.proto_array.nodes],
            "db": list(chain.blocks_db.db.entries_stream()),
        }

    return asyncio.run(run())


@pytest.mark.cuda
def test_chain_on_the_card_equals_the_cpu(cuda_device):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    sks = interop_secret_keys(N)
    genesis = create_interop_genesis_state(N, p=p, genesis_fork_version=cfg.GENESIS_FORK_VERSION)
    blocks = _produce(genesis, sks, p, cfg)
    assert [len(b.message.body.attestations) for b in blocks] == [0, 2, 2]

    launches = dh.launch_count()
    on_card = _import(cuda_device, genesis, blocks, p, cfg)
    assert dh.launch_count() > launches  # the state roots went through the card
    on_cpu = _import("cpu", genesis, blocks, p, cfg)
    assert on_card == on_cpu
    assert on_card["head"] == on_card["roots"][-1]
    assert on_card["state_roots"] == [bytes(b.message.state_root) for b in blocks]
    assert len(on_card["db"]) == len(blocks)
