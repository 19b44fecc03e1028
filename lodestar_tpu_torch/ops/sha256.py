"""Batched SHA-256 merkle hashing in plain PyTorch.

The port of `lodestar_tpu.ops.sha256`: every entry point takes a batch
axis N and runs all N compressions in lockstep as (N,)-vector word ops.
A merkle level is N 64-byte messages (left || right), one data block and
one constant padding block each, so a level costs two compressions.

Words are int64 tensors holding values in [0, 2^32). PyTorch has no
uint32 arithmetic (add, shifts and `~` raise for `torch.uint32`), and an
int32 word would need two's-complement wrap on add and a masked
emulation of every logical right shift. In int64 a sum of five words
cannot overflow, a right shift of a non-negative value is logical, and a
left shift by less than 32 stays below 2^63, so each rotation or sum
needs one mask with 0xFFFFFFFF at its end and nothing else. The price is
twice the bytes of an int32 word per elementwise kernel.

On a CUDA device each call is hundreds of small elementwise kernels per
compression; `ssz.device_htr` runs each pow-2 pair class as one CUDA
graph (`graphs.GraphCache`). Nothing here syncs with the host or copies
from host memory, so both `hash_pairs` and `merkle_root_device` can be
captured: every constant (IV, K, and the padding block's schedule folded
into K) enters as a Python scalar kernel argument, so no constant table
is ever put on a device. The byte-to-word packing runs on the device too
(`hash_pairs_bytes`, `merkle_root_bytes`): a graph copies bytes in and
reads bytes back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "IV",
    "K",
    "sha256_compress",
    "hash_pairs",
    "hash_pairs_bytes",
    "digest_64bytes_batch",
    "merkle_root_device",
    "merkle_root_bytes",
    "words_from_bytes",
    "bytes_from_words",
]

MASK = 0xFFFFFFFF


def _icbrt(n: int) -> int:
    """Integer cube root by Newton iteration."""
    if n == 0:
        return 0
    x = 1 << ((n.bit_length() + 2) // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _first_primes(count: int) -> list[int]:
    primes, n = [], 2
    while len(primes) < count:
        if all(n % p for p in primes if p * p <= n):
            primes.append(n)
        n += 1
    return primes


_PRIMES = _first_primes(64)
# IV[i] = floor(frac(sqrt(p_i)) * 2^32); K[t] = floor(frac(cbrt(p_t)) * 2^32)
IV = tuple(math.isqrt(p << 64) & MASK for p in _PRIMES[:8])
K = tuple(_icbrt(p << 96) & MASK for p in _PRIMES)

# FIPS 180-4 known-answer pin for the derived constants (checked end to end
# against hashlib in tests/test_torch_sha256.py)
assert IV[0] == 0x6A09E667 and K[0] == 0x428A2F98 and K[63] == 0xC67178F2

# Constant second block: padding for a 64-byte message (0x80 marker, then
# zeros, then the 64-bit bit-length 512).
_PAD_64 = (0x80000000,) + (0,) * 14 + (512,)


def _rotr3(x, r1: int, r2: int, r3: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) of 32-bit words, one mask."""
    return (((x >> r1) | (x << (32 - r1))) ^ ((x >> r2) | (x << (32 - r2)))
            ^ ((x >> r3) | (x << (32 - r3)))) & MASK


def _sigma(x, r1: int, r2: int, s: int):
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s): a message-schedule sigma."""
    return (((x >> r1) | (x << (32 - r1))) ^ ((x >> r2) | (x << (32 - r2))) ^ (x >> s)) & MASK


def _schedule_word(w: list, t: int):
    """w[t] for t >= 16 from the 16 words before it."""
    return (w[t - 16] + _sigma(w[t - 15], 7, 18, 3) + w[t - 7] + _sigma(w[t - 2], 17, 19, 10)) & MASK


def _pad_schedule() -> tuple[int, ...]:
    w = list(_PAD_64)
    for t in range(16, 64):
        w.append(_schedule_word(w, t))
    return tuple(w)


# K[t] + w[t] of the padding block: its schedule is the same for every message
_KW_PAD = tuple((k + w) & MASK for k, w in zip(K, _pad_schedule()))


def _rounds(state: list, w: list | None):
    """The 64 rounds and the feed-forward over word rows (tensors or ints).

    `w` is the data block's 16 rows, extended to 64 as the rounds consume
    them (a rolling schedule); None is the constant padding block."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if w is None:
            kw = _KW_PAD[t]
        else:
            if t >= 16:
                w.append(_schedule_word(w, t))
                w[t - 16] = None  # the schedule needs only the last 16 words
            kw = w[t] + K[t]
        t1 = h + _rotr3(e, 6, 11, 25) + (g ^ (e & (f ^ g))) + kw
        t2 = _rotr3(a, 2, 13, 22) + ((a & (b | c)) | (b & c))
        a, b, c, d, e, f, g, h = (t1 + t2) & MASK, a, b, c, (d + t1) & MASK, e, f, g
    return [(s + v) & MASK for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression over a batch.

    state: (N, 8) int64 words; block: (N, 16) int64 big-endian words, all
    in [0, 2^32). Returns (N, 8) int64."""
    rows = list(block.t().contiguous().unbind(0))
    return torch.stack(_rounds(list(state.t().contiguous().unbind(0)), rows), dim=1)


def _digest_rows(rows: list) -> list:
    """Digests of 64-byte messages given as 16 word rows: 8 word rows."""
    return _rounds(_rounds(list(IV), rows), None)


def digest_64bytes_batch(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 digests of N 64-byte messages: (N, 16) int64 -> (N, 8) int64."""
    return torch.stack(_digest_rows(list(blocks.t().contiguous().unbind(0))), dim=1)


def hash_pairs(nodes: torch.Tensor) -> torch.Tensor:
    """Hash adjacent node pairs: (2N, 8) int64 -> (N, 8) int64.

    The merkle level primitive: node[2i] || node[2i+1] is one 64-byte
    message per output node."""
    return digest_64bytes_batch(nodes.reshape(-1, 16))


def _pack_words(data: torch.Tensor) -> torch.Tensor:
    """(M, 4k) uint8 big-endian bytes -> (k, M) int64 word rows."""
    m = data.shape[0]
    b = data.reshape(m, -1, 4).permute(2, 1, 0).contiguous()  # (4, k, M) bytes
    w = b[0].to(torch.int64)
    for i in (1, 2, 3):  # in place: no int64 temporary of the whole block
        w <<= 8
        w |= b[i]
    return w


def _unpack_words(rows: torch.Tensor) -> torch.Tensor:
    """(k, M) int64 word rows -> (M, 4k) uint8 big-endian bytes."""
    b = torch.stack([((rows >> s) & 0xFF).to(torch.uint8) for s in (24, 16, 8, 0)])  # (4, k, M)
    return b.permute(2, 1, 0).reshape(rows.shape[1], -1)


def hash_pairs_bytes(data: torch.Tensor) -> torch.Tensor:
    """One merkle level on bytes: (2N, 32) uint8 -> (N, 32) uint8, the
    packing into words and back on the tensors' device."""
    rows = list(_pack_words(data.reshape(-1, 64)).unbind(0))
    return _unpack_words(torch.stack(_digest_rows(rows), dim=0))


def _check_pow2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError("chunk count must be a power of two")
    return n.bit_length() - 1


def merkle_root_device(chunks: torch.Tensor) -> torch.Tensor:
    """Merkle root of a power-of-two batch of 32-byte chunks.

    chunks: (N, 8) int64 words with N a power of two. Returns (8,) int64.
    Each level is one batched double compression."""
    level = chunks
    for _ in range(_check_pow2(chunks.shape[0])):
        level = hash_pairs(level)
    return level[0]


def merkle_root_bytes(data: torch.Tensor) -> torch.Tensor:
    """`merkle_root_device` on bytes: (N, 32) uint8 chunks, N a power of
    two -> (1, 32) uint8 root, packed and unpacked on the device."""
    return _unpack_words(merkle_root_device(_pack_words(data).t())[:, None])


def words_from_bytes(data: bytes) -> np.ndarray:
    """Big-endian uint32 view of 32-byte-aligned data: (len/32, 8)."""
    if len(data) % 32:
        raise ValueError("data must be a multiple of 32 bytes")
    return np.frombuffer(data, dtype=">u4").astype(np.uint32).reshape(-1, 8)


def bytes_from_words(words) -> bytes:
    """Inverse of words_from_bytes (numpy words, or int64 words on the CPU)."""
    return np.asarray(words).astype(">u4").tobytes()
