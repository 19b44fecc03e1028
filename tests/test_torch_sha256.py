"""The port's batched SHA-256 (`lodestar_tpu_torch.ops.sha256`) held against
`lodestar_tpu.ops.sha256` and hashlib on the CPU.

Tolerance: none (equal words and bytes). Inputs are numpy-seeded words at
N = 1, 3, 64 and 1000 messages, each batch with one all-0xFF message so
every add wraps at 2^32. The JAX side jit-compiles one program per
function and N (~0.5 s each on the CPU).
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from lodestar_tpu.ops import sha256 as jsha
from lodestar_tpu_torch.ops import sha256 as S

SIZES = (1, 3, 64, 1000)


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread: the tensors are small and the test processes many."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _words(rows, cols, seed):
    w = np.random.default_rng(seed).integers(0, 2**32, size=(rows, cols), dtype=np.uint32)
    w[0] = 0xFFFFFFFF
    return w


def _t(words):
    return torch.from_numpy(np.asarray(words).astype(np.int64))


def _hashlib_digests(blocks):
    data = np.asarray(blocks, dtype=np.uint32).astype(">u4").tobytes()
    return b"".join(hashlib.sha256(data[i * 64:(i + 1) * 64]).digest()
                    for i in range(len(data) // 64))


def test_constants_equal_the_jax_packages():
    assert S.IV == jsha.IV
    assert S.K == jsha.K
    assert S._PAD_64 == jsha._PAD_64


@pytest.mark.parametrize("n", SIZES)
def test_hash_pairs(n):
    nodes = _words(2 * n, 8, seed=n)
    got = S.hash_pairs(_t(nodes))
    want = np.asarray(jsha.merkle_level(nodes))
    assert got.dtype == torch.int64 and got.shape == (n, 8)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert S.bytes_from_words(got) == _hashlib_digests(nodes)
    # the byte body the level graphs run
    data = torch.from_numpy(np.frombuffer(nodes.astype(">u4").tobytes(), np.uint8).reshape(-1, 32))
    assert S.hash_pairs_bytes(data).numpy().tobytes() == _hashlib_digests(nodes)


@pytest.mark.parametrize("n", SIZES)
def test_digest_64bytes_batch(n):
    blocks = _words(n, 16, seed=100 + n)
    got = S.digest_64bytes_batch(_t(blocks))
    want = np.asarray(jax.jit(jsha.digest_64bytes_batch)(blocks))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert S.bytes_from_words(got) == _hashlib_digests(blocks)


@pytest.mark.parametrize("n", SIZES)
def test_sha256_compress(n):
    state = _words(n, 8, seed=200 + n)
    blocks = _words(n, 16, seed=300 + n)
    got = S.sha256_compress(_t(state), _t(blocks))
    want = np.asarray(jax.jit(jsha.sha256_compress)(state, blocks))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # from the IV, one compression of the data block, one of the padding
    iv = np.tile(np.asarray(S.IV, dtype=np.uint32), (n, 1))
    pad = np.tile(np.asarray(S._PAD_64, dtype=np.uint32), (n, 1))
    two = S.sha256_compress(S.sha256_compress(_t(iv), _t(blocks)), _t(pad))
    assert S.bytes_from_words(two) == _hashlib_digests(blocks)


def _naive_root(data):
    level = [data[i * 32:(i + 1) * 32] for i in range(len(data) // 32)]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


@pytest.mark.parametrize("depth", range(7))
def test_merkle_root_device(depth):
    data = np.random.default_rng(depth).integers(0, 256, size=32 << depth, dtype=np.uint8).tobytes()
    want = _naive_root(data)
    root = S.merkle_root_device(_t(S.words_from_bytes(data)))
    assert root.shape == (8,)
    assert S.bytes_from_words(root) == want
    chunks = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(-1, 32).copy())
    assert S.merkle_root_bytes(chunks).numpy().tobytes() == want


def test_non_pow2_rejected():
    with pytest.raises(ValueError):
        S.merkle_root_device(torch.zeros((3, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        S.merkle_root_bytes(torch.zeros((6, 32), dtype=torch.uint8))


def test_word_roundtrip():
    data = np.random.default_rng(5).integers(0, 256, size=96, dtype=np.uint8).tobytes()
    words = S.words_from_bytes(data)
    assert np.array_equal(words, jsha.words_from_bytes(data))
    assert S.bytes_from_words(words) == data == jsha.bytes_from_words(words)
    assert S.bytes_from_words(_t(words)) == data
    t = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(3, 32).copy())
    rows = S._pack_words(t)
    assert np.array_equal(rows.t().numpy(), words.astype(np.int64))
    assert torch.equal(S._unpack_words(rows), t)
    with pytest.raises(ValueError):
        S.words_from_bytes(b"\x00" * 33)
