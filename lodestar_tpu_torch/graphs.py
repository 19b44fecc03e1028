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
  arrays into them, replays, and reads the outputs back to the host, all
  on a stream of the graph's own, so replays of different size classes
  from different threads do not queue behind each other on the card. An
  input that is already a tensor on the graph's device (a constant cached
  per device, such as the KZG trusted setup's limbs) is its own static
  buffer: the capture reads it in place, and every later call must pass
  that same tensor, which is not copied;
* one eager warm-up run of the function on a side stream before the
  capture, which fills the per-device constant caches (a copy from host
  memory during a capture would fail it) and loads the kernel library;
* the capture under ``capture_error_mode="thread_local"``: a hidden host
  sync or pageable copy in the capturing thread raises instead of being
  recorded, while other threads go on launching work on their own
  streams (PyTorch's streams are non-blocking, so their work does not join
  the capture); the graph is kept (``keep_graph=True``) so its node count
  can be read before it is instantiated, and the capture and the
  instantiation are timed apart;
* a private memory pool of its own: size classes replay in any order, so
  no two graphs may share intermediate buffers.

Locks: each (device, size class) has its own lock, held from the copy of
the inputs until the outputs are on the host (the static buffers are
shared) and through that class's capture; captures on one device are
exclusive (one lock per device). A replay of one class never waits for a
replay or a capture of another. A capture or replay error raises; nothing
falls back to eager code.

Counts: the Fp kernel wrappers (``ops/fp_cuda.py``) count a launch where
they enqueue it, which during a capture is the recording of a graph node.
Each graph keeps the launches its capture recorded (``rows``, counted by
the capturing thread's `fp_cuda.tally`, so another thread's eager
launches meanwhile are not booked to the graph), and every replay adds
them to ``REPLAYED``. `GraphCache.warm` captures the classes a server
will launch before it serves.
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
REPLAYED = dict.fromkeys(fp_cuda.KERNELS, 0)  # guarded by: _replayed_lock
_replayed_lock = threading.Lock()


def reset_replayed() -> None:
    with _replayed_lock:
        for k in fp_cuda.KERNELS:
            REPLAYED[k] = 0


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a kept, captured graph (``cuGraphGetNodes`` of libcuda)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    return n.value


class Graph:
    """One captured graph with its static buffers, stream, counts and
    timings."""

    __slots__ = ("graph", "inputs", "outputs", "stream", "rows", "launches", "nodes",
                 "capture_s", "instantiate_s", "pool_bytes", "replays")

    def replay(self, arrays) -> tuple:
        """Copy in, replay, read back; the caller holds the class's lock."""
        with torch.cuda.stream(self.stream):
            for buf, a in zip(self.inputs, arrays):
                if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                    if a is not buf:
                        raise ValueError("a device-resident graph input must be the tensor "
                                         "the graph was captured with")
                    continue
                t = torch.from_numpy(np.ascontiguousarray(a))
                if t.shape != buf.shape or t.dtype != buf.dtype:
                    raise ValueError(f"graph input {tuple(t.shape)}/{t.dtype} does not match the "
                                     f"captured {tuple(buf.shape)}/{buf.dtype}")
                buf.copy_(t)
            self.graph.replay()
            self.replays += 1
            with _replayed_lock:
                for k, n in self.launches.items():
                    REPLAYED[k] += n
            return tuple(t.cpu() for t in self.outputs)  # the host waits for the replay here

    def info(self) -> dict:
        return {"capture_s": self.capture_s, "instantiate_s": self.instantiate_s,
                "nodes": self.nodes, "pool_bytes": self.pool_bytes, "rows": self.rows}


class GraphCache:
    """`fn` (tensors in, a tuple of tensors out, no host sync inside) as one
    CUDA graph per (device index, size class); the size class is the
    leading dimension of the first input."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = fn.__name__  # the dispatch seam's program name
        self.graphs: dict[tuple[int, int], Graph] = {}  # guarded by: _table_lock
        self.captures = 0  # graphs captured since construction; guarded by: _table_lock
        self._table_lock = threading.Lock()
        self._class_locks: dict[tuple[int, int], threading.Lock] = {}  # guarded by: _table_lock
        self._device_locks: dict[int, threading.Lock] = {}  # guarded by: _table_lock

    def _locks(self, key) -> tuple[threading.Lock, threading.Lock]:
        with self._table_lock:
            return (self._class_locks.setdefault(key, threading.Lock()),
                    self._device_locks.setdefault(key[0], threading.Lock()))

    @staticmethod
    def _index(device) -> int:
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs replay on a CUDA device, got {dev}")
        return torch.cuda.current_device() if dev.index is None else dev.index

    def _graph(self, idx: int, arrays) -> tuple[Graph, threading.Lock]:
        """The graph of `arrays`' class on device `idx`, captured first if
        there is none, and its class lock (held on return)."""
        key = (idx, int(arrays[0].shape[0]))
        class_lock, device_lock = self._locks(key)
        class_lock.acquire()
        try:
            with self._table_lock:
                g = self.graphs.get(key)
            if g is None:
                with device_lock, torch.cuda.device(idx):  # captures on a device are exclusive
                    g = self._capture(torch.device("cuda", idx), arrays)
                with self._table_lock:
                    self.graphs[key] = g
                    self.captures += 1
        except BaseException:
            class_lock.release()
            raise
        return g, class_lock

    def __call__(self, device, *arrays):
        """Numpy arrays (or device-resident tensors, see the module
        docstring) in; `fn`'s outputs, replayed on `device`, as host
        tensors. The first call of a size class captures its graph."""
        idx = self._index(device)
        g, class_lock = self._graph(idx, arrays)
        try:
            with torch.cuda.device(idx):
                return g.replay(arrays)
        finally:
            class_lock.release()

    def warm(self, device, classes, make_inputs) -> dict[int, dict]:
        """Capture the graph of every size class in `classes` that has none
        yet on `device` (eager warm-up, capture, instantiation; no replay),
        `make_inputs(size)` giving numpy inputs of that class. Returns
        {class: Graph.info()} for the classes captured here."""
        idx = self._index(device)
        out = {}
        for size in classes:
            with self._table_lock:
                have = (idx, size) in self.graphs
            if have:
                continue
            g, class_lock = self._graph(idx, make_inputs(size))
            class_lock.release()
            out[size] = g.info()
        return out

    def _capture(self, dev, arrays) -> Graph:
        g = Graph()
        g.inputs = [a if isinstance(a, torch.Tensor) and a.device == dev
                    else torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        g.stream = torch.cuda.Stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*g.inputs)  # warm-up: constants onto the device, library loaded
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)

        torch.cuda.empty_cache()  # as the capture's entry does, so the pool's growth shows
        reserved = torch.cuda.memory_reserved(dev)
        g.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with fp_cuda.tally() as rows, torch.cuda.graph(
                g.graph, pool=torch.cuda.graph_pool_handle(), capture_error_mode="thread_local"):
            g.outputs = tuple(self.fn(*g.inputs))
        g.capture_s = time.perf_counter() - t0
        g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        g.rows = {k: dict(sorted(r.items())) for k, r in rows.items()}
        g.launches = {k: sum(r.values()) for k, r in g.rows.items()}
        g.nodes = _node_count(g.graph)
        t0 = time.perf_counter()
        g.graph.instantiate()
        g.instantiate_s = time.perf_counter() - t0
        g.replays = 0
        return g
