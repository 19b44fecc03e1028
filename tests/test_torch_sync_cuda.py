"""The port's sync on a card, at the minimal preset: an interop genesis of 64
validators with altair, bellatrix and capella at epoch 1, and 4 Capella
blocks at slots 10-13 on it (`chip_smoke.build_segment`; slots 1-9 empty)
that a serving chain imports and serves through `ReqRespBeaconNode` on
127.0.0.1. A fresh chain whose verifier
is `BlsDeviceVerifierPool` on cuda:0 (its HTR device the card) range-syncs
them over blocks-by-range v2 (4 imports at RANGE_SYNC, one class-8 replay
each), and a third chain backfills the window below the slot-13 block as one
BACKFILL job (3 sets, one class-8 replay), then the window with one proposer
signature changed (rejected, nothing persisted). The same runs on the port's
`BlsSingleThreadVerifier` (the host oracle) must give the same results,
heads and db bytes. A device error injected into the pool's lanes must
reach range sync as the verifier-outage pause: no downscore, no processing
attempt spent.

Tolerance: none. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sync_cuda.py -q
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
from lodestar_tpu_torch.network.reqresp_node import ReqRespBeaconNode
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.state_transition.genesis import (
    create_interop_genesis_state,
    interop_secret_keys,
)
from lodestar_tpu_torch.sync import BackfillSync, BatchStatus, RangeSync
from lodestar_tpu_torch.sync.backfill import BackfillError

N = 64
SLOTS = range(10, 14)


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


def _chain(state, p, cfg, verifier, slot):
    return BeaconChain(anchor_state=state.copy(), bls_verifier=verifier, db=MemoryDbController(),
                       p=p, cfg=cfg, current_slot=slot)


def _setup(p, cfg):
    """(genesis, the genesis block's root, the segment's blocks), built on the
    host. The chains anchor at genesis, as `chip_smoke.py` phase 10c's do."""
    sks = interop_secret_keys(N)
    with chip_smoke.host_only_htr():
        genesis = create_interop_genesis_state(N, p=p,
                                               genesis_fork_version=cfg.GENESIS_FORK_VERSION)
        root = _chain(genesis, p, cfg, None, SLOTS[0]).head_root
    return genesis, root, chip_smoke.build_segment(genesis, sks, p, cfg, SLOTS)


def _sync(anchor, root, blocks, p, cfg, make_verifier, broken=False):
    """Range sync, backfill and the tampered backfill over the wire; what each
    gave. With `broken`, the verifier's lanes raise and only range sync runs."""
    last = SLOTS[-1]

    async def run():
        serving = _chain(anchor, p, cfg, BlsVerifierMock(True), last)
        for b in blocks:
            await serving.process_block(b)
        dial, _, close = await chip_smoke.open_wire(ReqRespBeaconNode(serving))
        verifier = make_verifier()
        calls = []
        if broken:
            def fault(*args, **kwargs):
                calls.append(1)
                raise RuntimeError("injected device error")

            for lane in verifier.mesh.lanes:
                lane.verify_fn = fault
                lane.verify_prepared_fn = fault
        out = {}
        try:
            fresh = _chain(anchor, p, cfg, verifier, last)
            client = ReqRespBeaconNode(fresh)
            downscored = []
            res = await RangeSync(chain=fresh, network=chip_smoke.WireNet(client, dial, fresh.types),
                                  peers=["server"],
                                  on_peer_downscore=lambda peer, why: downscored.append(peer)
                                  ).sync(SLOTS[0], last)
            fb = res.failed_batch
            out["range"] = (res.completed, res.processed_blocks, downscored, fresh.head_root,
                            None if fb is None else (fb.status, fb.processing_attempts))
            if broken:
                out["calls"] = len(calls)
                return out

            class Tampered(chip_smoke.WireNet):
                async def blocks_by_range(self, peer, start, count):
                    got = [b.copy() for b in await super().blocks_by_range(peer, start, count)]
                    sig = bytearray(bytes(got[1].signature))
                    sig[40] ^= 1
                    got[1].signature = bytes(sig)
                    return got

            head_state = fresh.get_head_state()
            for label, net in (("backfill", chip_smoke.WireNet(client, dial, fresh.types)),
                               ("tampered", Tampered(client, dial, fresh.types))):
                third = _chain(head_state, p, cfg, None, last)
                try:
                    persisted = await BackfillSync(
                        chain=third, network=net, bls_verifier=verifier, peers=["server"],
                        anchor_state=head_state, batch_slots=len(blocks),
                    ).backfill(blocks[-1], terminal_root=root)
                except BackfillError as e:
                    persisted = str(e)
                out[label] = (persisted, list(third.blocks_db.db.entries_stream()))
        finally:
            close()
            await verifier.close()
        return out

    return asyncio.run(run())


def _replays(dev):
    return {size: g.replays for (idx, size), g in bv._SINGLE_LAUNCH_GRAPHS.graphs.items()
            if idx == dev.index}


@pytest.mark.cuda
def test_sync_on_the_card_equals_the_oracle(cuda_device):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    anchor, root, blocks = _setup(p, cfg)
    bv.warm_single_launch([8], device=cuda_device)
    before = _replays(cuda_device)
    on_card = _sync(anchor, root, blocks, p, cfg,
                    lambda: BlsDeviceVerifierPool(device=cuda_device))
    after = _replays(cuda_device)
    on_host = _sync(anchor, root, blocks, p, cfg, BlsSingleThreadVerifier)
    assert on_card == on_host
    assert on_card["range"][:3] == (True, len(blocks), [])
    assert on_card["range"][3] == blocks[-1].message.type.hash_tree_root(blocks[-1].message)
    assert on_card["backfill"][0] == len(blocks) - 1
    assert on_card["tampered"] == ("segment proposer-signature batch invalid", [])
    # 4 imports, the backfill job and the tampered job: class-8 replays only
    grown = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert list(grown) == [8] and grown[8] >= len(blocks) + 2


@pytest.mark.cuda
def test_device_error_pauses_range_sync_on_the_card(cuda_device):
    p, cfg = params.MINIMAL, chip_smoke.block_chain_config()
    anchor, root, blocks = _setup(p, cfg)
    out = _sync(anchor, root, blocks, p, cfg,
                lambda: BlsDeviceVerifierPool(device=cuda_device), broken=True)
    completed, processed, downscored, head, failed = out["range"]
    assert not completed and processed == 0 and downscored == []
    assert failed == (BatchStatus.AWAITING_PROCESSING, 0)
    assert head == root and out["calls"] >= 1
