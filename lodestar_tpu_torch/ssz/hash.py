"""Hashing backend for SSZ merkleization: the host for small levels, the
device for large ones.

The port of `lodestar_tpu.ssz.hash`, with the same routing rule: a single
64-byte digest is far cheaper on the host than a device round trip, so
only levels with at least `DEVICE_MIN_PAIRS` pairs go to the device (the
HTR device of `ssz.device_htr`). On the host, levels of two or more pairs
go to the native C++ batch hasher (`lodestar_tpu_torch.native`) when it
builds and loads, and to `hashlib` otherwise, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

# Below this many pairs a level is hashed with hashlib; at or above it, on
# the device (tunable for the deployment's interconnect).
DEVICE_MIN_PAIRS = int(os.environ.get("LODESTAR_TPU_HASH_MIN_PAIRS", "2048"))


# The C++ batch hasher (SHA-NI / threaded) removes the per-pair Python
# overhead; probed once, None if the toolchain or the build is absent.
_native_hash_pairs = None
_native_probed = False


def _native():
    global _native_hash_pairs, _native_probed
    if not _native_probed:
        _native_probed = True
        try:
            from lodestar_tpu_torch import native

            if native.sha256_available():
                _native_hash_pairs = native.hash_pairs
        except Exception:
            _native_hash_pairs = None
    return _native_hash_pairs


def hash_nodes_cpu(data: np.ndarray) -> np.ndarray:
    """Hash adjacent 32-byte node pairs on the host. data: (2N, 32) uint8
    -> (N, 32) uint8. The native batch hasher from 4 rows up when it is
    built, else a hashlib loop."""
    fn = _native()
    if fn is not None and data.shape[0] >= 4:
        return fn(data)
    return hash_nodes_hashlib(data)


def hash_nodes_hashlib(data: np.ndarray) -> np.ndarray:
    """Hash adjacent 32-byte node pairs with a hashlib loop (the host
    hasher without the native library)."""
    n = data.shape[0] // 2
    buf = data.tobytes()  # single copy
    sha = hashlib.sha256
    digests = b"".join(sha(buf[i * 64 : (i + 1) * 64]).digest() for i in range(n))
    return np.frombuffer(digests, dtype=np.uint8).reshape(n, 32)


def hash_nodes_device(data: np.ndarray) -> np.ndarray:
    """Hash adjacent 32-byte node pairs on the HTR device. data: (2N, 32)
    uint8. Routed through the counted `device_htr._device_level` seam so
    size-class padding, the launch counter and launch telemetry all ride
    the one dispatch site (lazy import: device_htr imports this module)."""
    from .device_htr import _device_level

    return _device_level(data)


def hash_nodes(data: np.ndarray) -> np.ndarray:
    """Hash adjacent 32-byte node pairs, choosing the backend by batch size."""
    if data.shape[0] // 2 >= DEVICE_MIN_PAIRS:
        return hash_nodes_device(data)
    return hash_nodes_cpu(data)


def sha256_digest(data: bytes) -> bytes:
    """Single host-side digest (gossip ids, shuffling seeds, small objects)."""
    return hashlib.sha256(data).digest()


# Zero-subtree hash ladder: ZERO_HASHES[d] is the root of a depth-d tree of
# zero chunks. Lets merkleize() handle huge list limits without hashing
# virtual zeros (same trick as persistent-merkle-tree's zeroNode cache).
_MAX_DEPTH = 64
ZERO_HASHES: list[bytes] = [b"\x00" * 32]
for _ in range(_MAX_DEPTH):
    ZERO_HASHES.append(hashlib.sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]).digest())
