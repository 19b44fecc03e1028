"""The five base-field product kernels of the relaxed Fp core, in CUDA.

Counterpart of ``lodestar_tpu/ops/fp_pallas.py``: the same five entry
points (`mul_acc`, `sq_acc`, `redc`, `mont_mul`, `mont_sq`), bit-identical
to the plain versions ``fp.plain_*``. The kernels are hand-written CUDA
C++ for Hopper (``csrc/fp_kernels.cu``, ``sm_90a``): `mul_acc` and `redc`
give each row four threads, one column range each, in persistent blocks
that stream 32-row tiles through bulk asynchronous copies; `sq_acc`,
`mont_mul` and `mont_sq` run one thread per row. See the source for what
bounds each kernel on an H100.

Each wrapper launches its kernel and raises if the build or the launch
fails or the tensors are not on a CUDA device; it has no other path.
``ops/fp.py`` routes: CPU tensors to its plain versions, all others
here. Each launch adds one to ``LAUNCHES[name]`` and to
``ROWS[name][n]`` for its row count n.

Timing: ``chip_smoke.py`` phase 3 gives each kernel's device time at the
row counts the main path launches it at, by capturing 50 launches in one
CUDA graph and timing the replays with CUDA events, so the wrapper's host
work (checks, allocation, the ctypes call; tens of microseconds) is not in
the figure.

Build: on first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``ops/_build/`` (listed in .gitignore),
named by the source's hash; it is loaded with ctypes. Nothing is built or
imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "ROWS",
    "reset_launches",
    "build",
    "mul_acc",
    "sq_acc",
    "redc",
    "mont_mul",
    "mont_sq",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "fp_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "--expt-relaxed-constexpr",  # constexpr tables (column ranges) in device code
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

LIMBS, ACC_LIMBS = 33, 66  # an Fp element and a product accumulator
KERNELS = ("mul_acc", "sq_acc", "redc", "mont_mul", "mont_sq")
# launches of each kernel since the last reset (one per wrapper launch),
# and the same launches counted by row count: ROWS[name][n]
LAUNCHES = dict.fromkeys(KERNELS, 0)
ROWS = {k: {} for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        ROWS[k].clear()


# --- build and load ------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the Fp kernels cannot be built")
    return found


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfp_kernels_{digest}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this source was not built yet) and return
    the library path. Raises with nvcc's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            for name, nptr in (("mul_acc", 3), ("sq_acc", 2), ("redc", 2),
                               ("mont_mul", 3), ("mont_sq", 2)):
                fn = getattr(lib, f"lodestar_fp_{name}")
                fn.argtypes = [vp] * nptr + [i64, vp]
                fn.restype = ctypes.c_int
            lib.lodestar_fp_error_string.argtypes = [ctypes.c_int]
            lib.lodestar_fp_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _launch(name: str, args, in_limbs: int, out_limbs: int):
    """Flatten to (N, limbs) contiguous int32 rows, launch on the current
    stream, restore the leading shape. Raises on any refused launch."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for x in args:
        if x.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: expects int32 limbs, got {x.dtype}")
        if x.shape[-1] != in_limbs:
            raise ValueError(f"{name}: expects (..., {in_limbs}) limbs, got {tuple(x.shape)}")
    lib = _load()
    lead = args[0].shape[:-1]
    rows = [x.reshape(-1, in_limbs).contiguous() for x in args]
    n = rows[0].shape[0]
    out = torch.empty((n, out_limbs), dtype=torch.int32, device=dev)
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"lodestar_fp_{name}")(
            *[x.data_ptr() for x in rows], out.data_ptr(), n, stream
        )
        if rc != 0:
            msg = lib.lodestar_fp_error_string(rc).decode()
            raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
        LAUNCHES[name] += 1
        ROWS[name][n] = ROWS[name].get(n, 0) + 1
    return out.reshape(*lead, out_limbs)


# --- the five wrappers -------------------------------------------------------


def mul_acc(a, b):
    """(.., 33) x (.., 33) -> (.., 66) product accumulator."""
    return _launch("mul_acc", torch.broadcast_tensors(a, b), LIMBS, ACC_LIMBS)


def sq_acc(a):
    return _launch("sq_acc", (a,), LIMBS, ACC_LIMBS)


def redc(t):
    """(.., 66) accumulator -> (.., 33) Montgomery-reduced element."""
    return _launch("redc", (t,), ACC_LIMBS, LIMBS)


def mont_mul(a, b):
    return _launch("mont_mul", torch.broadcast_tensors(a, b), LIMBS, LIMBS)


def mont_sq(a):
    return _launch("mont_sq", (a,), LIMBS, LIMBS)
