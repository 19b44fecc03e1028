"""Native (C++) host components, loaded via ctypes.

The reference leans on native packages for its host hot loops
(@chainsafe/as-sha256 WASM, leveldown C++): this package holds small C++
sources compiled on first use with `g++` and bound through ctypes. If the
toolchain or the build is unavailable, consumers take the pure-Python
paths.

Current components:
* sha256_batch: batched pair-hashing for host merkle levels (SHA-NI when
  the CPU has it, portable scalar otherwise, threaded for large batches).
  Consumed by `lodestar_tpu_torch.ssz.hash.hash_nodes_cpu`.
* bls (`native/bls.py`): the host road of batch-verify input prep.

The port of `lodestar_tpu.native`. Importing it builds nothing: the
library is compiled on the first `load_sha256()` into `native/_build/`
(listed in .gitignore), not beside the sources as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["sha256_available", "sha256_backend", "hash_pairs", "load_sha256", "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
_SRC = os.path.join(_DIR, "sha256_batch.cpp")
_SO = os.path.join(BUILD_DIR, "libsha256batch.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def build_shared(sources: list[str], target: str, timeout: float) -> bool:
    """Compile `sources[0]` into the shared library `target` with g++ unless
    it is newer than every file of `sources`. The compiler writes a per-pid
    temp file that is renamed into place, so concurrent builders (several
    node processes, pytest-xdist workers) never load each other's
    half-written output. Returns success."""
    try:
        if os.path.exists(target) and os.path.getmtime(target) >= max(
            os.path.getmtime(s) for s in sources
        ):
            return True
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", sources[0], "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, timeout=timeout)
            if res.returncode != 0:
                return False
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_sha256():
    """The loaded ctypes lib, or None if build/load failed (cached)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        # one g++ build per process on purpose: a second caller waits for the library
        # lint: allow(blocking-under-lock) — the build is the lock's whole purpose
        if not build_shared([_SRC], _SO, timeout=120):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.sha256_pairs.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.sha256_pairs.restype = None
            lib.sha256_backend.argtypes = []
            lib.sha256_backend.restype = ctypes.c_int
            _lib = lib
        except OSError:
            _load_failed = True
            return None
    return _lib


def sha256_available() -> bool:
    return load_sha256() is not None


def sha256_backend() -> str:
    """'shani' | 'scalar' | 'unavailable'."""
    lib = load_sha256()
    if lib is None:
        return "unavailable"
    return "shani" if lib.sha256_backend() == 1 else "scalar"


def hash_pairs(data: np.ndarray) -> np.ndarray:
    """SHA-256 of adjacent 32-byte node pairs. data: (2N, 32) uint8 ->
    (N, 32) uint8. Caller must have checked sha256_available()."""
    lib = load_sha256()
    n = data.shape[0] // 2
    src = np.ascontiguousarray(data[: 2 * n], dtype=np.uint8)
    out = np.empty((n, 32), dtype=np.uint8)
    lib.sha256_pairs(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
