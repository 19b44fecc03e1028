"""The single-launch verify on a card: the CUDA-graph replay of the body
against the same body run eagerly on the card, on the same inputs and
blinding bits.

Tolerance: none (equal bools). Valid, swapped-signature and invalid-point
batches of one size class replay one captured graph in alternating order,
each with fresh bits; a batch of another size class captures a graph of
its own. Every test here carries the `cuda` marker and skips where
`torch.cuda.is_available()` is false. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_single_launch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu_torch import graphs
from lodestar_tpu_torch.crypto.bls import curve as C
from lodestar_tpu_torch.crypto.bls import fields as F
from lodestar_tpu_torch.crypto.bls import serdes
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import prep as dp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs capture and replay only on a GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _rand_fp(r):
    while True:
        v = int.from_bytes(r.bytes(48), "big")
        if v < F.P:
            return v


def _batches():
    sets = bv.make_synthetic_sets(4, seed=21)
    swapped = list(sets)
    swapped[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    swapped[1] = dataclasses.replace(sets[1], signature=sets[0].signature)
    r = np.random.default_rng(8)
    while True:  # an x off the curve, well formed
        x = _rand_fp(r)
        if F.fp_sqrt((x * x * x + 4) % F.P) is None:
            break
    pk = bytearray(x.to_bytes(48, "big"))
    pk[0] |= 0x80
    while True:  # a point on the twist, off the G2 subgroup
        x2 = (_rand_fp(r), _rand_fp(r))
        y2 = F.fp2_sqrt(C.g2_rhs(x2))
        if y2 is not None and not C.g2_in_subgroup((x2, y2)):
            break
    invalid = list(sets)
    invalid[1] = dataclasses.replace(sets[1], pubkey=bytes(pk))
    invalid[2] = dataclasses.replace(sets[2], signature=serdes.g2_to_bytes((x2, y2)))
    return {"valid": sets, "swapped": swapped, "invalid": invalid}


def _eager(si, dev):
    args = (*si.arrays, si.bits, si.mask)
    out = bv._single_launch_verify(*(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                     for a in args))
    return tuple(bool(t) for t in out)


@pytest.mark.cuda
def test_replay_matches_eager_body(cuda_device):
    batches = _batches()
    cache = bv._SINGLE_LAUNCH_GRAPHS
    key = (cuda_device.index, 8)
    want = {"valid": (True, True), "swapped": (False, True), "invalid": (False, False)}
    before = cache.graphs[key].replays if key in cache.graphs else 0
    for name in ("valid", "swapped", "invalid", "valid", "swapped", "invalid", "valid"):
        si = bv.prepare_single_launch_inputs(batches[name])  # fresh bits each time
        base = dp.prep_launches_total()
        replayed = cache(cuda_device, *si.arrays, si.bits, si.mask)
        assert dp.prep_launches_total() == base  # the cache itself is not the counted seam
        assert all(t.shape == () and t.dtype == torch.bool for t in replayed)
        got = tuple(bool(t) for t in replayed)
        assert got == _eager(si, cuda_device) == want[name], name
    g = cache.graphs[key]
    assert g.replays == before + 7 and g.nodes > 0
    assert all(g.launches[k] > 0 for k in g.launches)  # every Fp kernel is in the graph


@pytest.mark.cuda
def test_entry_point_is_one_replay(cuda_device):
    batches = _batches()
    cache = bv._SINGLE_LAUNCH_GRAPHS
    assert bv.single_launch_active(device=cuda_device)
    for name, want in (("valid", True), ("swapped", False), ("invalid", False)):
        base = dp.prep_launches_total()
        before = dict(graphs.REPLAYED)
        assert bv.verify_signature_sets_device(batches[name], device=cuda_device) is want
        assert dp.prep_launches_total() - base == dp.SINGLE_LAUNCH_BUDGET
        g = cache.graphs[(cuda_device.index, 8)]
        assert {k: graphs.REPLAYED[k] - before[k] for k in before} == g.launches


@pytest.mark.cuda
def test_second_size_class_captures_its_own_graph(cuda_device):
    cache = bv._SINGLE_LAUNCH_GRAPHS
    sets = bv.make_synthetic_sets(9, seed=22)  # size class 16
    assert bv.verify_sets_single_launch(sets, device=cuda_device) is True
    small = cache.graphs.get((cuda_device.index, 8))
    big = cache.graphs[(cuda_device.index, 16)]
    assert big is not small and big.replays == 1
    assert big.inputs[0].shape[0] == 16
    bad = list(sets)
    bad[8] = dataclasses.replace(sets[8], signature=sets[7].signature)
    assert bv.verify_sets_single_launch(bad, device=cuda_device) is False
    assert big.replays == 2
