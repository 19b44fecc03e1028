"""Swap-or-not shuffling + proposer selection.

Reference `state-transition/src/util/shuffle.ts` (in-place Fisher-Yates-
free swap-or-not over as-sha256) — here the whole permutation is computed
**vectorized**: per round, one numpy pass computes every index's flip and
one hashlib sweep covers all 256-position blocks, so shuffling V
validators costs 90 rounds × ceil(V/256) hashes with no per-validator
Python loop. (The block hashes are independent → a natural later target
for the batched device SHA-256 kernel, `ops/sha256.py`.)

`compute_proposer_index` implements the spec's effective-balance
rejection sampling over the shuffled order.

The port of `lodestar_tpu.state_transition.shuffle` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

import numpy as np

from lodestar_tpu_torch.params import BeaconPreset, active_preset

from .util import uint_to_bytes

__all__ = ["unshuffle_list", "compute_shuffled_index", "compute_proposer_index"]


def _round_pivot(seed: bytes, r: int, n: int) -> int:
    return int.from_bytes(hashlib.sha256(seed + bytes([r])).digest()[:8], "little") % n


def _round_source_bits(seed: bytes, r: int, n: int) -> np.ndarray:
    """Bit array of length n*? covering positions 0..n-1: bit(position) of
    hash(seed + r + position//256)."""
    n_blocks = (n + 255) // 256
    digests = b"".join(
        hashlib.sha256(seed + bytes([r]) + uint_to_bytes(block, 4)).digest()
        for block in range(n_blocks)
    )
    bytes_arr = np.frombuffer(digests, dtype=np.uint8)
    bits = np.unpackbits(bytes_arr, bitorder="little")
    return bits  # length n_blocks * 256


def shuffle_list(indices: np.ndarray, seed: bytes, p: BeaconPreset | None = None) -> np.ndarray:
    """Forward spec shuffle: out[compute_shuffled_index(i)] == in[i] has
    the property that the spec committee assignment uses
    in[compute_shuffled_index(i)], i.e. we apply the permutation to the
    value array directly (one round = one gather)."""
    p = p or active_preset()
    n = len(indices)
    if n <= 1:
        return indices.copy()
    perm = np.arange(n, dtype=np.int64)  # perm[i] = original position now at i... built inverse
    # compute_shuffled_index maps i -> j; building the full map per round:
    idx = np.arange(n, dtype=np.int64)
    for r in range(p.SHUFFLE_ROUND_COUNT):
        pivot = _round_pivot(seed, r, n)
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        bits = _round_source_bits(seed, r, n)
        bit = bits[position]
        idx = np.where(bit == 1, flip, idx)
    # idx[i] = shuffled index of original i ; committee wants value at
    # shuffled position: out[i] = indices[k] where idx[k] == i
    out = np.empty(n, dtype=indices.dtype)
    out[idx] = indices
    return out


def unshuffle_list(indices: np.ndarray, seed: bytes, p: BeaconPreset | None = None) -> np.ndarray:
    """The permutation the spec's get_beacon_committee consumes:
    result[i] = indices[compute_shuffled_index(i)] — equivalently the
    inverse application of shuffle_list (reference unshuffleList, which
    runs the rounds backwards for the same effect)."""
    p = p or active_preset()
    n = len(indices)
    if n <= 1:
        return indices.copy()
    idx = np.arange(n, dtype=np.int64)
    for r in range(p.SHUFFLE_ROUND_COUNT):
        pivot = _round_pivot(seed, r, n)
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        bits = _round_source_bits(seed, r, n)
        bit = bits[position]
        idx = np.where(bit == 1, flip, idx)
    # idx[i] = compute_shuffled_index(i); gather:
    return indices[idx]


def compute_shuffled_index(index: int, index_count: int, seed: bytes, p: BeaconPreset | None = None) -> int:
    """Single-index spec function (used by tests to pin the vectorized
    path; O(rounds))."""
    p = p or active_preset()
    assert index < index_count
    idx = index
    for r in range(p.SHUFFLE_ROUND_COUNT):
        pivot = _round_pivot(seed, r, index_count)
        flip = (pivot + index_count - idx) % index_count
        position = max(idx, flip)
        source = hashlib.sha256(seed + bytes([r]) + uint_to_bytes(position // 256, 4)).digest()
        byte = source[(position % 256) // 8]
        bit = (byte >> (position % 8)) % 2
        idx = flip if bit else idx
    return idx


def compute_proposer_index(
    effective_balances: np.ndarray,
    indices: np.ndarray,
    seed: bytes,
    p: BeaconPreset | None = None,
) -> int:
    """Spec compute_proposer_index: walk candidates in shuffled order,
    accept with probability effective_balance / MAX_EFFECTIVE_BALANCE via
    random-byte rejection."""
    p = p or active_preset()
    if len(indices) == 0:
        raise ValueError("no active validators")
    total = len(indices)
    i = 0
    while True:
        candidate = indices[compute_shuffled_index(i % total, total, seed, p)]
        rand = hashlib.sha256(seed + uint_to_bytes(i // 32)).digest()[i % 32]
        if int(effective_balances[candidate]) * 255 >= p.MAX_EFFECTIVE_BALANCE * rand:
            return int(candidate)
        i += 1
