"""CUDA graphs of one function, one per (device, size class).

The port's counterpart of ``jax.jit``'s executable cache for the
single-launch verify: the JAX package compiles one resident program per
pow-2 size class; here the function runs once eagerly, is captured once as
a ``torch.cuda.CUDAGraph`` and is replayed for every later batch of that
class. A replay issues the whole chain (hundreds of thousands of kernels)
with one host call, so the host's per-call PyTorch dispatch is paid once
per size class instead of once per batch.

Per graph:

* static input buffers, one per input array; a call copies its numpy
  arrays into them, replays, and reads the outputs back to the host;
* one eager warm-up run of the function on a side stream before the
  capture, which fills the per-device constant caches (a copy from host
  memory during a capture would fail it) and loads the kernel library;
* the capture under ``capture_error_mode="global"``, so a hidden host sync
  or pageable copy raises instead of being recorded; the graph is kept
  (``keep_graph=True``) so its node count can be read before it is
  instantiated, and the capture and the instantiation are timed apart;
* a private memory pool of its own: size classes replay in any order, so
  no two graphs may share intermediate buffers.

One lock per cache is held from the copy of the inputs until the outputs
are on the host: the static buffers are shared, and a capture must not see
another thread's CUDA calls. A capture or replay error raises; nothing
falls back to eager code.

Counts: the Fp kernel wrappers (``ops/fp_cuda.py``) count a launch where
they enqueue it, which during a capture is the recording of a graph node.
Each graph keeps the launches its capture recorded (``rows``, the
``fp_cuda.ROWS`` delta), and every replay adds them to ``REPLAYED``.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from .ops import fp_cuda

__all__ = ["REPLAYED", "reset_replayed", "Graph", "GraphCache"]

#: Fp kernel launches made by graph replays since the last reset, by kernel
REPLAYED = dict.fromkeys(fp_cuda.KERNELS, 0)


def reset_replayed() -> None:
    for k in fp_cuda.KERNELS:
        REPLAYED[k] = 0


def _rows_since(before):
    return {k: {n: c - before[k].get(n, 0) for n, c in sorted(fp_cuda.ROWS[k].items())
                if c > before[k].get(n, 0)}
            for k in fp_cuda.KERNELS}


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a kept, captured graph (``cuGraphGetNodes`` of libcuda)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    return n.value


class Graph:
    """One captured graph with its static buffers, counts and timings."""

    __slots__ = ("graph", "inputs", "outputs", "rows", "launches", "nodes", "capture_s",
                 "instantiate_s", "pool_bytes", "replays")

    def replay(self, arrays) -> tuple:
        for buf, a in zip(self.inputs, arrays):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(f"graph input {tuple(t.shape)}/{t.dtype} does not match the "
                                 f"captured {tuple(buf.shape)}/{buf.dtype}")
            buf.copy_(t)
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            REPLAYED[k] += n
        return tuple(t.cpu() for t in self.outputs)  # the host waits for the replay here


class GraphCache:
    """`fn` (tensors in, a tuple of tensors out, no host sync inside) as one
    CUDA graph per (device index, size class); the size class is the
    leading dimension of the first input."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = fn.__name__  # the dispatch seam's program name
        self.graphs: dict[tuple[int, int], Graph] = {}  # guarded by: lock
        self.lock = threading.Lock()

    def __call__(self, device, *arrays):
        """Numpy arrays in; `fn`'s outputs, replayed on `device`, as host
        tensors. The first call of a size class captures its graph."""
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs replay on a CUDA device, got {dev}")
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        key = (idx, int(arrays[0].shape[0]))
        with self.lock, torch.cuda.device(idx):
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = self._capture(torch.device("cuda", idx), arrays)
            return g.replay(arrays)

    def _capture(self, dev, arrays) -> Graph:
        g = Graph()
        g.inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*g.inputs)  # warm-up: constants onto the device, library loaded
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)

        before = {k: dict(v) for k, v in fp_cuda.ROWS.items()}
        torch.cuda.empty_cache()  # as the capture's entry does, so the pool's growth shows
        reserved = torch.cuda.memory_reserved(dev)
        g.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(g.graph, pool=torch.cuda.graph_pool_handle(),
                              capture_error_mode="global"):
            g.outputs = tuple(self.fn(*g.inputs))
        g.capture_s = time.perf_counter() - t0
        g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        g.rows = _rows_since(before)
        g.launches = {k: sum(r.values()) for k, r in g.rows.items()}
        g.nodes = _node_count(g.graph)
        t0 = time.perf_counter()
        g.graph.instantiate()
        g.instantiate_s = time.perf_counter() - t0
        g.replays = 0
        return g
