"""The HTR level and tree graphs on a card: one replay of a captured CUDA
graph of `ops.sha256.hash_pairs_bytes` (or `merkle_root_bytes`) against the
same function run eagerly (on the card and on the CPU) and against hashlib.

Tolerance: none (equal bytes). Pair classes 8 and 2,048, and a non-pow2
batch of 1,000 pairs padded to class 1,024; a second call of a class
replays its graph without a capture. Every test here carries the `cuda`
marker and skips where `torch.cuda.is_available()` is false. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_htr_cuda.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.ops import sha256
from lodestar_tpu_torch.ssz import device_htr as dh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs capture and replay only on a GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    prev_dev = dh._htr_device
    prev = dh.configure_device_htr(mode="on", device=dev)
    yield dev
    dh.configure_device_htr(mode=prev, device=prev_dev)


def _pairs(n, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=(2 * n, 32), dtype=np.uint8)
    data[1] = 0xFF  # every word at 2^32 - 1: the adds wrap
    return data


def _hashlib_level(data):
    return np.frombuffer(b"".join(hashlib.sha256(data[2 * i:2 * i + 2].tobytes()).digest()
                                  for i in range(data.shape[0] // 2)),
                         dtype=np.uint8).reshape(-1, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [8, 2048, 1000])
def test_level_replay_equals_eager_and_hashlib(cuda_device, pairs):
    data = _pairs(pairs, seed=pairs)
    got = dh._device_level(data)
    size = dh.pad_pow2_pairs(pairs)
    g = dh.HTR_GRAPHS.graphs[(cuda_device.index, 2 * size)]
    assert g.replays >= 1
    eager_cpu = sha256.hash_pairs_bytes(torch.from_numpy(data)).numpy()
    eager_card = sha256.hash_pairs_bytes(torch.from_numpy(data).to(cuda_device)).cpu().numpy()
    assert np.array_equal(got, eager_cpu)
    assert np.array_equal(got, eager_card)
    assert np.array_equal(got, _hashlib_level(data))


@pytest.mark.cuda
def test_second_call_replays_without_capture(cuda_device):
    first, second = _pairs(8, seed=1), _pairs(8, seed=2)
    dh._device_level(first)
    g = dh.HTR_GRAPHS.graphs[(cuda_device.index, 16)]
    captures, replays, launches = dh.HTR_GRAPHS.captures, g.replays, dh.launch_count()
    got = dh._device_level(second)
    assert dh.HTR_GRAPHS.captures == captures
    assert g.replays == replays + 1
    assert dh.launch_count() == launches + 1
    assert np.array_equal(got, _hashlib_level(second))


@pytest.mark.cuda
def test_tree_graph_equals_hashlib(cuda_device):
    chunks = np.random.default_rng(3).integers(0, 256, size=(1024, 32), dtype=np.uint8)
    level = chunks
    while level.shape[0] > 1:
        level = _hashlib_level(level)
    assert dh.merkle_root(chunks) == level[0].tobytes()
    captures = dh.ROOT_GRAPHS.captures
    assert dh.merkle_root(chunks) == level[0].tobytes()
    assert dh.ROOT_GRAPHS.captures == captures
