"""Device hashTreeRoot: dirty-subtree collector with one batched SHA-256
launch per tree level.

The port of `lodestar_tpu.ssz.device_htr`. Mutated chunks (recorded by the
tree views' dirty tracking or diffed by the state-root tracker in
`state_transition/htr.py`) are collected with their sibling roots into
level-ordered pair batches and flushed through `ops.sha256` with **one
device launch per tree level**, however many fields or subtrees went
dirty. Batches are padded to power-of-two pair classes (at least 8).

On a CUDA device a launch is one replay of a CUDA graph of
`ops.sha256.hash_pairs_bytes`, captured once per (device, pair class) by
`graphs.GraphCache`: the graph copies the level's bytes in, packs them
into words, runs both compressions and reads the digests' bytes back. On
another device (the CPU in the tests) the same function runs eagerly.
`merkle_root` does the same for a whole tree, one graph per depth.

No degradation: a device error raises out of `hash_level`,
`DirtyCollector.flush` and everything above them. The JAX package
recomputes on the CPU hasher instead; the port has no fallback anywhere.
The size rule is not a fallback: a level under `DEVICE_MIN_FLUSH_PAIRS`
pairs (default `ssz.hash.DEVICE_MIN_PAIRS`, 2048) is hashed on the host
with hashlib in either package.

Mode and device are process-global (`configure_device_htr`): "auto"
hashes on the device when the HTR device is CUDA, "on" forces the device
path (on any device), "off" keeps the collector on the host. The HTR
device defaults to CUDA and a launch raises when CUDA is missing; pass
`device="cpu"` to run the plain PyTorch hashing eagerly on the CPU.

Importing this module builds no graph and puts nothing on a device.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

import numpy as np
import torch

from .. import telemetry
from ..graphs import GraphCache
from ..models.batch_verify import resolve_device
from ..ops import sha256
from .hash import hash_nodes_cpu

__all__ = [
    "HTR_MODES",
    "configure_device_htr",
    "device_htr_active",
    "DirtyCollector",
    "compute_root_node",
    "hash_level",
    "launch_count",
    "merkle_root",
    "pad_pow2_pairs",
]

HTR_MODES = ("auto", "on", "off")

# Process-global placement mode, device and metrics sink, set at node init
# by `configure_device_htr` (tests flip them around calls). Reads race
# benignly: a flush sees the old or the new value, both give correct roots.
_htr_mode = "auto"  # guarded by: config-time
_htr_device = torch.device("cuda")  # guarded by: config-time
_htr_metrics = None  # guarded by: config-time

# Device-level launches issued by this module: every padded level and every
# whole-tree root. Tests assert the one-launch-per-level invariant by
# diffing it around a flush.
_launch_count = 0  # guarded by: _count_lock
_count_lock = threading.Lock()

#: pad every device batch to a power-of-two pair count of at least this,
#: so the number of distinct graphs stays logarithmic in the largest level
_MIN_PAIR_CLASS = 8

#: below this many pairs a level stays on the host hasher even when the
#: device is selected: a tiny level is far cheaper as a few host digests
#: than as a padded launch (the asymmetry of ssz.hash.DEVICE_MIN_PAIRS,
#: which is the default). None = follow ssz.hash.DEVICE_MIN_PAIRS.
DEVICE_MIN_FLUSH_PAIRS: int | None = None  # guarded by: config-time



def hash_pairs_level(data: torch.Tensor) -> tuple[torch.Tensor]:
    """A level's graph body: (2P, 32) uint8 -> ((P, 32) uint8,)."""
    return (sha256.hash_pairs_bytes(data),)


def merkle_root_tree(data: torch.Tensor) -> tuple[torch.Tensor]:
    """A tree's graph body: (2^d, 32) uint8 chunks -> ((1, 32) uint8 root,)."""
    return (sha256.merkle_root_bytes(data),)


#: one graph per (device, pair class) of a level, keyed by its 2 x pairs rows
HTR_GRAPHS = GraphCache(hash_pairs_level)
#: one graph per (device, depth) of a whole tree, keyed by its 2^depth chunks
ROOT_GRAPHS = GraphCache(merkle_root_tree)


def _min_flush_pairs() -> int:
    if DEVICE_MIN_FLUSH_PAIRS is not None:
        return DEVICE_MIN_FLUSH_PAIRS
    from .hash import DEVICE_MIN_PAIRS

    return DEVICE_MIN_PAIRS


def configure_device_htr(mode: str | None = None, metrics=None, device=None) -> str:
    """Set the process-wide HTR mode, metrics sink (the lodestar_ssz_htr_*
    family: `launches`, `flushes`, `dirty_chunks`, `seconds`) and/or
    device. Returns the PREVIOUS mode so callers can save and restore."""
    global _htr_mode, _htr_metrics, _htr_device
    prev = _htr_mode
    if mode is not None:
        if mode not in HTR_MODES:
            raise ValueError(f"htr_device must be one of {HTR_MODES}, got {mode!r}")
        _htr_mode = mode
    if metrics is not None:
        _htr_metrics = metrics
    if device is not None:
        _htr_device = torch.device(device)
    return prev


def device_htr_active(mode: str | None = None, device=None) -> bool:
    """Resolve an HTR mode ("auto" follows the device: CUDA -> device
    hashing, as `models.batch_verify.device_prep_active` does)."""
    mode = mode or _htr_mode
    if mode not in HTR_MODES:
        raise ValueError(f"htr_device must be one of {HTR_MODES}, got {mode!r}")
    if mode == "auto":
        return torch.device(_htr_device if device is None else device).type == "cuda"
    return mode == "on"


def launch_count() -> int:
    """Device launches issued by this module since import."""
    return _launch_count


def pad_pow2_pairs(n: int) -> int:
    """Size class for an n-pair batch: next power of two >= max(n, 8)."""
    n = max(n, _MIN_PAIR_CLASS)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _count() -> float:
    """Book one launch (the counter and the metrics sink); returns the
    telemetry start time, 0.0 when launch telemetry is off."""
    global _launch_count
    with _count_lock:
        _launch_count += 1
    m = _htr_metrics
    if m is not None:
        m.launches.inc()
    return time.perf_counter() if telemetry.launch_telemetry_active() else 0.0


def _run(cache: GraphCache, data: np.ndarray) -> np.ndarray:
    """`cache`'s function on `data`'s bytes on the HTR device: one graph
    replay on CUDA, eagerly elsewhere. Raises when CUDA is the device and
    missing."""
    dev = resolve_device(_htr_device)
    data = np.ascontiguousarray(data)
    if dev.type == "cuda":
        (out,) = cache(dev, data)
    else:
        (out,) = cache.fn(torch.from_numpy(data).to(dev))
    return out.cpu().numpy()


def _device_level(data: np.ndarray) -> np.ndarray:
    """One merkle level on the device: (2N, 32) uint8 -> (N, 32) uint8,
    padded to a power-of-two pair class (pad pairs repeat pair 0; their
    digests are computed and discarded)."""
    n = data.shape[0] // 2
    size = pad_pow2_pairs(n)
    if size != n:
        padded = np.empty((2 * size, 32), dtype=np.uint8)
        padded[: 2 * n] = data
        padded[2 * n :] = np.tile(data[:2], (size - n, 1))
        data = padded
    t0 = _count()
    roots = _run(HTR_GRAPHS, data)
    if t0:
        telemetry.record_launch("merkle_level", size, time.perf_counter() - t0)
    return roots[:n]


def merkle_root(data: np.ndarray) -> bytes:
    """Root of a complete tree over (N, 32) uint8 chunks, N a power of
    two, as ONE device launch (one graph per depth on CUDA)."""
    sha256._check_pow2(data.shape[0])
    t0 = _count()
    root = _run(ROOT_GRAPHS, data)
    if t0:
        telemetry.record_launch("merkle_root", data.shape[0], time.perf_counter() - t0)
    return root.tobytes()


def hash_level(data: np.ndarray) -> np.ndarray:
    """One merkle level through the shared backend switch: the device (padded
    pair classes) when HTR placement is active AND the level has at least
    `DEVICE_MIN_FLUSH_PAIRS` pairs, else `ssz.hash.hash_nodes`. `ssz.batch`
    routes its levels here so list merkleization and the dirty collector
    share one backend selection. A device error raises."""
    from .hash import hash_nodes

    if data.shape[0] // 2 >= _min_flush_pairs() and device_htr_active():
        return _device_level(data)
    return hash_nodes(data)


class _StackJob:
    """A retained level stack (power-of-two row counts, leaf level first)
    plus the dirty leaf rows whose ancestor paths must re-hash. The
    collector owns writing levels[k>=1]; level 0 was already updated by
    the caller (leaf chunks are inputs, not outputs)."""

    __slots__ = ("levels", "dirty")

    def __init__(self, levels: list[np.ndarray], dirty: np.ndarray):
        self.levels = levels  # guarded by: flush-thread (one thread per root call)
        self.dirty = np.asarray(dirty, dtype=np.int64)  # guarded by: flush-thread


class _NodeJob:
    """Unhashed `ssz.tree.Node`s grouped by dirty-subgraph height (the
    grouping `tree.compute_root` computes): height h nodes hash in
    launch h, after every dirty child (height < h) has its root."""

    __slots__ = ("groups",)

    def __init__(self, groups: dict[int, list]):
        self.groups = groups  # guarded by: flush-thread (one thread per root call)


class DirtyCollector:
    """Collects dirty subtrees from any number of sources (tree-view node
    walks, state-tracker level stacks) and flushes them with ONE level
    launch per tree level.

    A collector is built, fed, flushed and read on one thread per
    hash_tree_root call; instances are never shared."""

    def __init__(self) -> None:
        self.stack_jobs: list[_StackJob] = []
        self.node_jobs: list[_NodeJob] = []
        self.launches = 0
        self.levels = 0
        self.dirty_chunks = 0
        self.backend = "cpu"

    # -- feeding ---------------------------------------------------------------

    def add_stack_job(self, levels: list[np.ndarray], dirty: Iterable[int]) -> None:
        dirty = np.asarray(sorted(set(int(i) for i in dirty)), dtype=np.int64)
        if dirty.size == 0:
            return
        self.dirty_chunks += int(dirty.size)
        self.stack_jobs.append(_StackJob(levels, dirty))

    def add_node_job(self, groups: dict[int, list], dirty_chunks: int | None = None) -> None:
        if not groups:
            return
        # exact mutated-chunk count when the caller tracked it (the tree
        # views' dirty-gindex sets); else estimated from the height-1
        # pair inputs of the unhashed frontier
        self.dirty_chunks += (
            dirty_chunks if dirty_chunks is not None else 2 * len(groups.get(1, ()))
        )
        self.node_jobs.append(_NodeJob(groups))

    # -- flushing --------------------------------------------------------------

    def _max_level(self) -> int:
        lv = 0
        for j in self.stack_jobs:
            lv = max(lv, len(j.levels) - 1)
        for j in self.node_jobs:
            if j.groups:
                lv = max(lv, max(j.groups))
        return lv

    def _flush_with(self, level_fn, count_launches: bool) -> None:
        """Re-hash every dirty path bottom-up, one `level_fn` call per
        level. `count_launches` is True on the device pass only."""
        max_level = self._max_level()
        self.levels = max_level
        # per stack job: dirty node indices at the current level
        frontiers = [j.dirty for j in self.stack_jobs]
        for lvl in range(1, max_level + 1):
            chunks: list[np.ndarray] = []
            sinks: list[tuple] = []  # ("stack", job, parents) | ("node", nodes)
            for ji, job in enumerate(self.stack_jobs):
                if lvl >= len(job.levels) or frontiers[ji].size == 0:
                    continue
                parents = np.unique(frontiers[ji] >> 1)
                below = job.levels[lvl - 1]
                pair_idx = np.empty(2 * parents.size, dtype=np.int64)
                pair_idx[0::2] = 2 * parents
                pair_idx[1::2] = 2 * parents + 1
                chunks.append(below[pair_idx])
                sinks.append(("stack", ji, parents))
                frontiers[ji] = parents
            for job in self.node_jobs:
                nodes = job.groups.get(lvl)
                if not nodes:
                    continue
                data = np.empty((2 * len(nodes), 32), dtype=np.uint8)
                for i, n in enumerate(nodes):
                    data[2 * i] = np.frombuffer(n.left._root, dtype=np.uint8)
                    data[2 * i + 1] = np.frombuffer(n.right._root, dtype=np.uint8)
                chunks.append(data)
                sinks.append(("node", nodes))
            if not chunks:
                continue
            data = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)
            # the size asymmetry applies per level on the device pass too: a
            # sparse flush's 1-2-pair tail levels are far cheaper as host
            # digests (the invariant is "at most one DEVICE launch per level")
            if count_launches and data.shape[0] // 2 < _min_flush_pairs():
                roots = hash_nodes_cpu(data)
            else:
                roots = level_fn(data)
                if count_launches:
                    self.launches += 1
            off = 0
            for sink in sinks:
                if sink[0] == "stack":
                    _, ji, parents = sink
                    self.stack_jobs[ji].levels[lvl][parents] = roots[off : off + parents.size]
                    off += parents.size
                else:
                    _, nodes = sink
                    for i, n in enumerate(nodes):
                        n._root = roots[off + i].tobytes()
                    off += len(nodes)

    def flush(self) -> dict:
        """One collector flush: at most one level launch per tree level
        across EVERY job. A device error raises (the jobs' levels are then
        partly written; the caller drops them). Returns the flush stats."""
        t0 = time.monotonic()
        self.launches = 0
        if device_htr_active():
            self.backend = "device"
            self._flush_with(_device_level, count_launches=True)
        else:
            self.backend = "cpu"
            self._flush_with(hash_nodes_cpu, count_launches=False)
        stats = {
            "backend": self.backend,
            "levels": self.levels,
            "launches": self.launches,
            "dirty_chunks": self.dirty_chunks,
            "seconds": time.monotonic() - t0,
        }
        m = _htr_metrics
        if m is not None:
            # launches are counted at the dispatch site (_device_level) so
            # hash_level and collector launches share one metric
            m.flushes.labels(self.backend).inc()
            m.dirty_chunks.inc(self.dirty_chunks)
            m.seconds.labels(self.backend).observe(stats["seconds"])
        return stats


def compute_root_node(node, dirty_hint: int | None = None) -> bytes:
    """Root of an `ssz.tree.Node`, flushing its dirty subtrees through a
    collector (one launch per level). `dirty_hint` is the caller's
    mutated-chunk count, for the dirty-chunks metric."""
    if node._root is not None:
        return node._root
    # lazy import: tree.py lazily imports this module for routing
    from .tree import collect_unhashed

    coll = DirtyCollector()
    coll.add_node_job(collect_unhashed(node), dirty_chunks=dirty_hint)
    coll.flush()
    return node._root
