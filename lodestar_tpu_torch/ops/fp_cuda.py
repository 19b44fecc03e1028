"""The five base-field product kernels of the relaxed Fp core, in CUDA.

Counterpart of ``lodestar_tpu/ops/fp_pallas.py``: the same five entry
points (`mul_acc`, `sq_acc`, `redc`, `mont_mul`, `mont_sq`), bit-identical
to the plain versions ``fp.plain_*``. The kernels are hand-written CUDA
C++ for Hopper (``csrc/fp_kernels.cu``, ``sm_90a``): `mul_acc` gives each
row four threads, one column range each; `redc`, `mont_mul` and
`mont_sq` give each row eight threads (16-row tiles) up to 16 rows per SM,
else four (32-row tiles), all threads of a block on one code path, their
shares meeting by shared-memory atomic adds (a `redc` launch of more than
five 32-row tiles per SM runs `mul_acc`'s split instead); all four stream
their tiles through bulk asynchronous copies in persistent blocks. `mont_mul` and
`mont_sq` keep each row's 66-limb product in shared memory and reduce it
there. A launch of one tile or less takes a one-block path with plain
loads and stores, and a `mont_mul` or `mont_sq` launch of one row (the
Fermat chains) a path that puts all 128 threads of a block on that row.
`sq_acc` runs one thread per row. See the source for what bounds each
kernel on an H100.

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
imported from CUDA when this module is imported. ``build(source=...)``,
``load_library`` and ``launch(..., lib=...)`` also build, load and launch
another checkout's copy of the source, to time it beside this one.
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
    "load_library",
    "launch",
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
# each kernel's operand count and the limbs of an operand row and an output row
_SHAPES = {
    "mul_acc": (2, LIMBS, ACC_LIMBS),
    "sq_acc": (1, LIMBS, ACC_LIMBS),
    "redc": (1, ACC_LIMBS, LIMBS),
    "mont_mul": (2, LIMBS, LIMBS),
    "mont_sq": (1, LIMBS, LIMBS),
}
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


def library_path(source: str = SOURCE) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfp_kernels_{digest}.so")


def build(verbose: bool = False, source: str = SOURCE) -> str:
    """Compile the kernels of `source` (if that source was not built yet)
    and return the library path. Raises with nvcc's output on failure."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load_library(path: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points."""
    lib = ctypes.CDLL(path)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, (arity, _, _) in _SHAPES.items():
        fn = getattr(lib, f"lodestar_fp_{name}")
        fn.argtypes = [vp] * (arity + 1) + [i64, vp]
        fn.restype = ctypes.c_int
    lib.lodestar_fp_error_string.argtypes = [ctypes.c_int]
    lib.lodestar_fp_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = load_library(build())
    return _lib


def launch(name: str, *args, lib=None):
    """Kernel `name` of `lib` (default: this source's build) on operands of
    one shape: flatten to (N, limbs) contiguous int32 rows, launch on the
    current stream, restore the leading shape. Raises on any refused
    launch."""
    _, in_limbs, out_limbs = _SHAPES[name]
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
    lib = _load() if lib is None else lib
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
    return launch("mul_acc", *torch.broadcast_tensors(a, b))


def sq_acc(a):
    return launch("sq_acc", a)


def redc(t):
    """(.., 66) accumulator -> (.., 33) Montgomery-reduced element."""
    return launch("redc", t)


def mont_mul(a, b):
    return launch("mont_mul", *torch.broadcast_tensors(a, b))


def mont_sq(a):
    return launch("mont_sq", a)
