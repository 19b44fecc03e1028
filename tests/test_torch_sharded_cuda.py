"""The sharded verify on a card: `verify_signature_sets_sharded` over the
shard devices `chip_smoke.py` uses (every visible GPU when there are more
than one, else cuda:0 twice), each shard one replay of its (device, shard
class) graph and the finish one replay, against `verify_sets_single_launch`
on the same sets and blinding bits.

Tolerance: none (equal bools). 8 valid sets (two shards of 4 on one GPU)
and the same sets with two signatures swapped; each sharded verify makes
n_shards + 1 counted dispatches. After `warm_sharded` a verify of its size
captures no graph. Every test here carries the `cuda` marker
and skips where `torch.cuda.is_available()` is false. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import prep as dp


@pytest.fixture
def shard_devices():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the shard graphs capture and replay only on a GPU")
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [torch.device("cuda", 0)] * 2


def _bits(n, size, seed):
    r = np.random.default_rng(seed)
    bits = np.zeros((size, bv.COEFF_BITS), dtype=np.int32)
    bits[0, -1] = 1
    bits[1:n] = r.integers(0, 2, size=(n - 1, bv.COEFF_BITS), dtype=np.int32)
    bits[1:n, 0] = 1
    return bits


@pytest.mark.cuda
def test_sharded_equals_the_single_launch(shard_devices):
    prev = bv.configure_single_launch("auto")
    try:
        sets = bv.make_synthetic_sets(8, seed=31)
        swapped = list(sets)
        swapped[2] = dataclasses.replace(sets[2], signature=sets[6].signature)
        swapped[6] = dataclasses.replace(sets[6], signature=sets[2].signature)
        size = bv._sharded_size(len(sets), len(shard_devices))
        for batch, want in ((sets, True), (swapped, False)):
            bits = _bits(len(batch), size, 3)
            base = dp.prep_launches_total()
            got = bv.verify_signature_sets_sharded(batch, shard_devices, coeff_bits=bits)
            assert dp.prep_launches_total() - base == len(shard_devices) + 1
            single = bv.verify_sets_single_launch(batch, device=shard_devices[0],
                                                  coeff_bits=bits[:8])
            assert got is single is want
    finally:
        bv.configure_single_launch(prev)


@pytest.mark.cuda
def test_warm_sharded_leaves_nothing_to_capture(shard_devices):
    prev = bv.configure_single_launch("auto")
    try:
        sets = bv.make_synthetic_sets(8, seed=37)
        warmed = bv.warm_sharded(shard_devices, [len(sets)])
        assert all(kind in ("shard", "finish") for kind, _idx, _cls in warmed)
        before = bv._SHARD_GRAPHS.captures + bv._SHARD_FINISH_GRAPHS.captures
        assert bv.verify_signature_sets_sharded(sets, shard_devices) is True
        assert bv._SHARD_GRAPHS.captures + bv._SHARD_FINISH_GRAPHS.captures == before
    finally:
        bv.configure_single_launch(prev)
