"""Vectorized merkleization of homogeneous value batches.

The reference hashes each Validator container root one-by-one through
as-sha256 inside persistent-merkle-tree; on a device the right shape is the
transpose — build the (N, fields) leaf matrix on host with numpy column
ops, then run log2(fields) *batched* hash levels over the whole list at
once (`packages/state-transition/test/perf/hashing.test.ts` is the perf
pin this accelerates; see also SURVEY §7 hard part 4).

`batch_container_roots` covers any container whose fields are basic
uints/booleans, small byte-vectors, or byte-vectors up to 64 bytes
(Validator, AttestationData, Checkpoint, Withdrawal, ...); containers
with nested composite fields fall back to the scalar path per element.
"""

from __future__ import annotations

import numpy as np

from .merkle import next_pow_of_two
from .types import Boolean, ByteVector, Container, Uint

__all__ = ["batch_container_roots", "pack_basic_chunks"]


def _level_hash(data):
    """One merkle level through the shared device/CPU selection hook
    (`ssz.device_htr.hash_level`) so list merkleization and the dirty
    collector ride one backend switch. Identical to `hash_nodes` with
    the device HTR mode off."""
    from . import device_htr

    return device_htr.hash_level(data)


def _field_roots_column(ftype, values, getter) -> np.ndarray | None:
    """(N, 32) root column for one field, or None if not vectorizable."""
    n = len(values)
    if isinstance(ftype, Uint):
        out = np.zeros((n, 32), dtype=np.uint8)
        # vector path for the common u64 case; object ints for u128/u256
        if ftype.byte_len <= 8:
            arr = np.fromiter((getter(v) for v in values), dtype=np.uint64, count=n)
            out[:, : ftype.byte_len] = (
                arr[:, None] >> (8 * np.arange(ftype.byte_len, dtype=np.uint64))
            ).astype(np.uint8)
        else:
            for i, v in enumerate(values):
                out[i, : ftype.byte_len] = np.frombuffer(
                    int(getter(v)).to_bytes(ftype.byte_len, "little"), dtype=np.uint8
                )
        return out
    if isinstance(ftype, Boolean):
        out = np.zeros((n, 32), dtype=np.uint8)
        out[:, 0] = np.fromiter((1 if getter(v) else 0 for v in values), dtype=np.uint8, count=n)
        return out
    if isinstance(ftype, ByteVector) and ftype.length <= 32:
        out = np.zeros((n, 32), dtype=np.uint8)
        buf = b"".join(getter(v) for v in values)
        out[:, : ftype.length] = np.frombuffer(buf, dtype=np.uint8).reshape(n, ftype.length)
        return out
    if isinstance(ftype, ByteVector) and ftype.length <= 64:
        # two chunks -> one batched hash level
        chunks = np.zeros((n, 64), dtype=np.uint8)
        buf = b"".join(getter(v) for v in values)
        chunks[:, : ftype.length] = np.frombuffer(buf, dtype=np.uint8).reshape(n, ftype.length)
        return _level_hash(chunks.reshape(2 * n, 32))
    return None


def batch_container_roots(ctype: Container, values) -> np.ndarray | None:
    """hash_tree_root of N container values as one batched computation.

    Returns (N, 32) uint8 roots, or None when a field type is outside the
    vectorizable subset (caller falls back to scalar hashing).
    """
    n = len(values)
    if n == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    cols = []
    for fname, ftype in ctype.fields:
        col = _field_roots_column(ftype, values, lambda v, f=fname: getattr(v, f))
        if col is None:
            return None
        cols.append(col)
    width = next_pow_of_two(len(cols))
    # (N, width, 32) leaf matrix, zero-padded to the field power of two
    leaves = np.zeros((n, width, 32), dtype=np.uint8)
    for j, col in enumerate(cols):
        leaves[:, j, :] = col
    level = leaves.reshape(n * width, 32)
    while width > 1:
        level = _level_hash(level)
        width //= 2
    return level.reshape(n, 32)


def pack_basic_chunks(elem, values) -> np.ndarray:
    """Pack a basic-element sequence into (ceil(N*size/32), 32) chunks with
    numpy (the vectorized equivalent of serialize+pack_bytes)."""
    size = elem.fixed_size()
    n = len(values)
    if n == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    total = n * size
    out = np.zeros((-(-total // 32), 32), dtype=np.uint8)
    flat = out.reshape(-1)
    if isinstance(elem, Uint) and elem.byte_len <= 8:
        arr = np.fromiter((int(v) for v in values), dtype=np.uint64, count=n)
        bytes_mat = (
            arr[:, None] >> (8 * np.arange(size, dtype=np.uint64))
        ).astype(np.uint8)
        flat[:total] = bytes_mat.reshape(-1)
    elif isinstance(elem, Boolean):
        flat[:total] = np.fromiter((1 if v else 0 for v in values), dtype=np.uint8, count=n)
    else:
        buf = b"".join(elem.serialize(v) for v in values)
        flat[:total] = np.frombuffer(buf, dtype=np.uint8)
    return out
