"""ctypes bindings for the native host BLS library (bls_host.cpp).

The C++ half of batch verification host prep: decompression + subgroup
checks + hash-to-G2, emitting device-layout Montgomery limb arrays
directly. Falls back gracefully (callers check `available()`), with the
pure-Python oracle as the correctness anchor.

The port of `lodestar_tpu.native.bls`. Importing it builds nothing and
starts no thread: the library is compiled into `native/_build/` on the
first `available()` or prep call, or by `warm_up()` from a thread of its
own (the verifier pool calls it at start when prep is pinned "off"). The
JAX module starts that warm-up thread at import.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import BUILD_DIR, build_shared

__all__ = [
    "available",
    "warm_up",
    "prepare_sets_native",
    "hash_to_g2_native",
    "g1_decompress_check_native",
    "g2_decompress_check_native",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bls_host.cpp")
_HDR = os.path.join(_DIR, "bls_host_constants.h")
_SO = os.path.join(BUILD_DIR, "libblshost.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _load():
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
        if not build_shared([_SRC, _HDR], _SO, timeout=180):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.bls_prepare_sets.argtypes = [
                ctypes.c_uint64, u8p, u8p, u8p, i32p, i32p, i32p, ctypes.c_int,
            ]
            lib.bls_prepare_sets.restype = ctypes.c_int
            lib.bls_hash_to_g2_bytes.argtypes = [u8p, ctypes.c_uint64, u8p]
            lib.bls_hash_to_g2_bytes.restype = ctypes.c_int
            lib.bls_g1_decompress_check.argtypes = [u8p, u8p]
            lib.bls_g1_decompress_check.restype = ctypes.c_int
            lib.bls_g2_decompress_check.argtypes = [u8p, u8p]
            lib.bls_g2_decompress_check.restype = ctypes.c_int
            lib.bls_host_selftest.argtypes = []
            lib.bls_host_selftest.restype = ctypes.c_int
            if lib.bls_host_selftest() != 0:
                _load_failed = True
                return None
            _lib = lib
        except OSError:
            _load_failed = True
            return None
    return _lib


def available() -> bool:
    return _load() is not None


_warm_thread: threading.Thread | None = None


def warm_up() -> threading.Thread:
    """Build and load the library off the hot path, on a daemon thread
    started once: the first signature batch of a fresh process must not
    stall behind a synchronous g++ compile (the verification path calls
    prepare_sets_native under deadline pressure). Returns the thread."""
    global _warm_thread
    with _lock:
        if _warm_thread is None:
            _warm_thread = threading.Thread(target=_load, name="bls-host-warmup", daemon=True)
            _warm_thread.start()
    return _warm_thread


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def prepare_sets_native(pubkeys: list[bytes], messages: list[bytes], signatures: list[bytes]):
    """Full host prep for n sets (32-byte messages). Returns
    ((pk_x, pk_y), (h_x, h_y), (sig_x, sig_y)) device-layout int32 limb
    arrays, or None if any set is structurally invalid."""
    lib = _load()
    n = len(pubkeys)
    if lib is None or n == 0:
        return None
    if any(len(m) != 32 for m in messages):
        return None  # native path is specialized to 32-byte signing roots
    pks = np.frombuffer(b"".join(pubkeys), dtype=np.uint8)
    sigs = np.frombuffer(b"".join(signatures), dtype=np.uint8)
    msgs = np.frombuffer(b"".join(messages), dtype=np.uint8)
    if pks.size != 48 * n or sigs.size != 96 * n or msgs.size != 32 * n:
        return None
    pk_out = np.empty((n, 2, 33), dtype=np.int32)
    h_out = np.empty((n, 2, 2, 33), dtype=np.int32)
    sig_out = np.empty((n, 2, 2, 33), dtype=np.int32)
    rc = lib.bls_prepare_sets(
        ctypes.c_uint64(n), _u8(pks), _u8(sigs), _u8(msgs),
        _i32(pk_out), _i32(h_out), _i32(sig_out), 0,
    )
    if rc != 0:
        return None
    # pk_out rows are (x, y); h/sig rows are ((x0,x1),(y0,y1))
    return (
        (np.ascontiguousarray(pk_out[:, 0]), np.ascontiguousarray(pk_out[:, 1])),
        (np.ascontiguousarray(h_out[:, 0]), np.ascontiguousarray(h_out[:, 1])),
        (np.ascontiguousarray(sig_out[:, 0]), np.ascontiguousarray(sig_out[:, 1])),
    )


def hash_to_g2_native(msg: bytes):
    """-> affine ((x0, x1), (y0, y1)) ints, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(192, dtype=np.uint8)
    buf = np.frombuffer(msg, dtype=np.uint8) if msg else np.empty(0, dtype=np.uint8)
    rc = lib.bls_hash_to_g2_bytes(_u8(buf), ctypes.c_uint64(len(msg)), _u8(out))
    if rc != 0:
        return None
    vals = [int.from_bytes(out[i * 48 : (i + 1) * 48].tobytes(), "big") for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def g1_decompress_check_native(data: bytes):
    """-> (x, y) ints | 'infinity' | None (invalid/unavailable)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(96, dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib.bls_g1_decompress_check(_u8(buf), _u8(out))
    if rc == 1:
        return "infinity"
    if rc != 0:
        return None
    x = int.from_bytes(out[:48].tobytes(), "big")
    y = int.from_bytes(out[48:].tobytes(), "big")
    return (x, y)


def g2_decompress_check_native(data: bytes):
    lib = _load()
    if lib is None:
        return None
    out = np.empty(192, dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib.bls_g2_decompress_check(_u8(buf), _u8(out))
    if rc == 1:
        return "infinity"
    if rc != 0:
        return None
    vals = [int.from_bytes(out[i * 48 : (i + 1) * 48].tobytes(), "big") for i in range(4)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))
