"""State hashTreeRoot through the dirty-subtree collector.

The port of `lodestar_tpu.state_transition.htr`.

The reference keeps the BeaconState tree-backed so `hashTreeRoot` after
a slot's mutations re-hashes only dirty paths
(`packages/state-transition/src/stateTransition.ts:100`). Our transition
functions mutate plain typed values (vectorized numpy epoch loops write
whole lists back; block ops poke single elements in place), so instead
of intercepting every mutation this module *diffs*: each big state field
keeps its packed chunk (or element-root) snapshot plus the full retained
merkle level stack from the previous root, and a vectorized numpy
compare yields exactly the dirty chunk rows. Dirty paths from EVERY
field are flushed through ONE `ssz.device_htr.DirtyCollector` — at most
one batched `hash_pairs` launch per tree level per `hash_tree_root`
call, on the device when the HTR mode selects it (one CUDA-graph
replay per level on the card).

Field strategies:

* **packed** — basic-element lists/vectors (balances, slashings,
  inactivity scores, participation flags) and 32-byte-element
  lists/vectors (block/state/historical roots, randao mixes): chunks
  rebuilt with numpy column packs (cheap byte work, no hashing), diffed
  against the snapshot, dirty rows re-rooted through the retained stack.
* **composite list** — containers whose fields are all
  uints/booleans/byte-vectors (validators, eth1 data votes, historical
  summaries): a per-element serialization fingerprint matrix finds the
  mutated elements, `ssz.batch.batch_container_roots` re-roots ONLY
  those (vectorized, its levels ride the same backend switch), and the
  element-root level stack re-hashes the dirty paths.
* **small** — everything else (header, checkpoints, sync committees,
  execution payload headers, pending-attestation lists): a serialized
  fingerprint gates a full re-root; serialization is strictly cheaper
  than hashing, so an unchanged field costs zero hashes.

No degradation: a device error raises out of the collector, and any
error of the tracker (a device fault or a bug) drops the tracker and
re-raises. The JAX package serves the value path `type.hash_tree_root`
instead; the port has no fallback anywhere. The next root of the state
builds a fresh tracker, so nothing partial is ever grafted.

The tracker rides in the state value's `__dict__` under a non-field
key, so `copy()` (fresh tracking for the post-state), fork upgrades
(`__dict__.clear()` drops it), equality, and serialization (all iterate
`_field_names`) are oblivious to it.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import tracing
from ..ssz import device_htr
from ..ssz.batch import batch_container_roots, pack_basic_chunks
from ..ssz.hash import ZERO_HASHES
from ..ssz.merkle import merkleize, mix_in_length, next_pow_of_two
from ..ssz.types import (
    Boolean,
    ByteVector,
    Container,
    List,
    Uint,
    Vector,
)

__all__ = ["state_hash_tree_root", "drop_tracker", "StateRootTracker"]

_TRACKER_KEY = "_htr_tracker"


# --- retained level stack ----------------------------------------------------


class _StackRoot:
    """Merkle level stack over power-of-two-padded chunk rows, retained
    across calls. Levels above the real-chunk region are prefilled with
    the zero-subtree ladder so virtual-zero padding is never hashed."""

    __slots__ = ("levels", "_top_depth")

    def __init__(self) -> None:
        self.levels: list[np.ndarray] | None = None  # guarded by: stf-thread (a state is advanced by one thread at a time; tracker state is per-state)
        self._top_depth = 0  # guarded by: stf-thread (same confinement as levels)

    def update(self, chunks: np.ndarray, collector: device_htr.DirtyCollector) -> None:
        """Diff `chunks` (C, 32) against the snapshot and enqueue the
        dirty rows; level 0 is replaced in place (leaf chunks are the
        collector's inputs)."""
        c = chunks.shape[0]
        pow2 = next_pow_of_two(max(c, 1))
        padded = np.zeros((pow2, 32), dtype=np.uint8)
        if c:
            padded[:c] = chunks
        depth = pow2.bit_length() - 1
        if self.levels is None or self.levels[0].shape[0] != pow2:
            self.levels = [padded] + [
                np.tile(
                    np.frombuffer(ZERO_HASHES[k], dtype=np.uint8), (pow2 >> k, 1)
                )
                for k in range(1, depth + 1)
            ]
            self._top_depth = depth
            dirty = np.arange(c, dtype=np.int64)
        else:
            dirty = np.nonzero(np.any(self.levels[0] != padded, axis=1))[0]
            self.levels[0] = padded
        if dirty.size:
            collector.add_stack_job(self.levels, dirty)

    def top(self) -> bytes:
        """Root of the real-chunk power-of-two region (valid after the
        collector flush)."""
        return self.levels[-1][0].tobytes() if self._top_depth else self.levels[0][0].tobytes()

    def fold_to(self, depth: int) -> bytes:
        """Fold the stack top up with zero subtrees to `depth` (the SSZ
        limit padding — O(log limit) host hashes)."""
        node = self.top()
        for d in range(self._top_depth, depth):
            node = hashlib.sha256(node + ZERO_HASHES[d]).digest()
        return node


def _limit_depth(limit_chunks: int) -> int:
    return (next_pow_of_two(max(limit_chunks, 1)) - 1).bit_length()


# --- field strategies --------------------------------------------------------


class _SmallField:
    """Serialized-fingerprint cache: unchanged bytes -> cached root."""

    __slots__ = ("ftype", "_blob", "_root")

    def __init__(self, ftype) -> None:
        self.ftype = ftype
        self._blob: bytes | None = None  # guarded by: stf-thread (per-state tracker, single advancing thread)
        self._root = b""  # guarded by: stf-thread (per-state tracker, single advancing thread)

    def prepare(self, value, collector) -> None:
        blob = self.ftype.serialize(value)
        if blob != self._blob:
            self._blob = blob
            self._root = self.ftype.hash_tree_root(value)

    def finish(self) -> bytes:
        return self._root


class _PackedField:
    """Basic-element or 32-byte-element list/vector: numpy chunk pack +
    snapshot diff + retained stack."""

    __slots__ = ("ftype", "elem", "_stack", "_len", "_is_list", "_depth", "_root")

    def __init__(self, ftype) -> None:
        self.ftype = ftype
        self.elem = ftype.elem
        self._stack = _StackRoot()
        self._len = 0  # guarded by: stf-thread (per-state tracker, single advancing thread)
        self._is_list = isinstance(ftype, List)
        if self._is_list:
            if isinstance(self.elem, (Uint, Boolean)):
                limit_chunks = -(-ftype.limit * self.elem.fixed_size() // 32)
            else:
                limit_chunks = ftype.limit
        else:
            if isinstance(self.elem, (Uint, Boolean)):
                limit_chunks = -(-ftype.length * self.elem.fixed_size() // 32)
            else:
                limit_chunks = ftype.length
        self._depth = _limit_depth(limit_chunks)
        self._root = b""  # guarded by: stf-thread (per-state tracker, single advancing thread)

    def _chunks(self, values) -> np.ndarray:
        if isinstance(self.elem, (Uint, Boolean)):
            return pack_basic_chunks(self.elem, values)
        n = len(values)
        out = np.zeros((n, 32), dtype=np.uint8)
        if n:
            ln = self.elem.length
            out[:, :ln] = np.frombuffer(
                b"".join(bytes(v) for v in values), dtype=np.uint8
            ).reshape(n, ln)
        return out

    def prepare(self, value, collector) -> None:
        self._len = len(value)
        self._stack.update(self._chunks(value), collector)

    def finish(self) -> bytes:
        root = self._stack.fold_to(self._depth)
        self._root = mix_in_length(root, self._len) if self._is_list else root
        return self._root


def _vectorizable(ctype: Container) -> bool:
    return all(
        isinstance(t, (Uint, Boolean)) or (isinstance(t, ByteVector) and t.length <= 64)
        for _, t in ctype.fields
    )


class _CompositeListField:
    """List of flat containers: per-element fingerprint matrix finds
    mutated elements; only those re-root (vectorized); the element-root
    stack re-hashes dirty paths."""

    __slots__ = ("ftype", "elem", "_stack", "_fp", "_roots", "_len", "_depth")

    def __init__(self, ftype: List) -> None:
        self.ftype = ftype
        self.elem = ftype.elem
        self._stack = _StackRoot()
        self._fp: np.ndarray | None = None  # guarded by: stf-thread (per-state tracker, single advancing thread)
        self._roots: np.ndarray | None = None  # guarded by: stf-thread (per-state tracker, single advancing thread)
        self._len = 0  # guarded by: stf-thread (per-state tracker, single advancing thread)
        self._depth = _limit_depth(ftype.limit)

    def _fingerprint(self, values) -> np.ndarray:
        n = len(values)
        cols: list[np.ndarray] = []
        for fname, ft in self.elem.fields:
            if isinstance(ft, Uint) and ft.byte_len <= 8:
                arr = np.fromiter(
                    (getattr(v, fname) for v in values), dtype=np.uint64, count=n
                )
                cols.append(
                    (arr[:, None] >> (8 * np.arange(ft.byte_len, dtype=np.uint64))).astype(
                        np.uint8
                    )
                )
            elif isinstance(ft, Uint):
                col = np.zeros((n, ft.byte_len), dtype=np.uint8)
                for i, v in enumerate(values):
                    col[i] = np.frombuffer(
                        int(getattr(v, fname)).to_bytes(ft.byte_len, "little"),
                        dtype=np.uint8,
                    )
                cols.append(col)
            elif isinstance(ft, Boolean):
                cols.append(
                    np.fromiter(
                        (1 if getattr(v, fname) else 0 for v in values),
                        dtype=np.uint8,
                        count=n,
                    )[:, None]
                )
            else:  # ByteVector
                cols.append(
                    np.frombuffer(
                        b"".join(bytes(getattr(v, fname)) for v in values),
                        dtype=np.uint8,
                    ).reshape(n, ft.length)
                    if n
                    else np.zeros((0, ft.length), dtype=np.uint8)
                )
        return np.concatenate(cols, axis=1) if cols else np.zeros((n, 0), dtype=np.uint8)

    def prepare(self, value, collector) -> None:
        n = len(value)
        pow2 = next_pow_of_two(max(n, 1))
        fp = self._fingerprint(value)
        fp_padded = np.zeros((pow2, fp.shape[1]), dtype=np.uint8)
        if n:
            fp_padded[:n] = fp
        if (
            self._fp is None
            or self._fp.shape != fp_padded.shape
            or self._roots is None
        ):
            dirty = np.arange(n, dtype=np.int64)
            self._roots = np.zeros((pow2, 32), dtype=np.uint8)
        else:
            changed = np.nonzero(np.any(self._fp != fp_padded, axis=1))[0]
            # rows crossing the old/new length boundary are forced dirty:
            # a default element can serialize to all zeros (fingerprint
            # indistinguishable from list padding) yet roots nonzero
            lo, hi = min(self._len, n), max(self._len, n)
            dirty = np.union1d(changed, np.arange(lo, hi, dtype=np.int64))
        self._fp = fp_padded
        self._len = n
        in_range = dirty[dirty < n]
        if in_range.size:
            sub = [value[int(i)] for i in in_range]
            roots = batch_container_roots(self.elem, sub)
            if roots is None:  # non-vectorizable value snuck in: scalar path
                roots = np.frombuffer(
                    b"".join(self.elem.hash_tree_root(v) for v in sub), dtype=np.uint8
                ).reshape(len(sub), 32)
            self._roots[in_range] = roots
        removed = dirty[dirty >= n]
        if removed.size:
            self._roots[removed] = 0
        self._stack.update(self._roots[:n], collector)

    def finish(self) -> bytes:
        return mix_in_length(self._stack.fold_to(self._depth), self._len)


def _strategy_for(ftype):
    if isinstance(ftype, (List, Vector)):
        elem = getattr(ftype, "elem", None)
        if isinstance(elem, (Uint, Boolean)):
            return _PackedField(ftype)
        if isinstance(elem, ByteVector) and elem.length <= 32:
            return _PackedField(ftype)
        if isinstance(ftype, List) and isinstance(elem, Container) and _vectorizable(elem):
            return _CompositeListField(ftype)
    return _SmallField(ftype)


# --- the tracker -------------------------------------------------------------


class StateRootTracker:
    """Per-state incremental rooter: one collector flush (at most one
    batched hash launch per tree level) per `root()` call."""

    def __init__(self, ctype: Container) -> None:
        self.ctype = ctype
        self._fields = [(fname, _strategy_for(ft)) for fname, ft in ctype.fields]

    def root(self, state) -> tuple[bytes, dict]:
        collector = device_htr.DirtyCollector()
        for fname, strat in self._fields:
            strat.prepare(getattr(state, fname), collector)
        stats = collector.flush()
        roots = b"".join(strat.finish() for _, strat in self._fields)
        top = merkleize(np.frombuffer(roots, dtype=np.uint8).reshape(-1, 32))
        return top, stats


# --- entry point -------------------------------------------------------------


def drop_tracker(state) -> None:
    """Detach the incremental-root tracker from a state that is going
    dormant (e.g. entering the chain's StateCache). Every cache
    consumer copies before mutating — and `copy()` drops the tracker —
    so a cached state's snapshots and level stacks are dead weight
    (at 1M validators: hundreds of MB per state) that would otherwise
    be pinned for the cache's lifetime. Rooting the state again simply
    rebuilds tracking from scratch."""
    state.__dict__.pop(_TRACKER_KEY, None)


def state_hash_tree_root(state, *, transient: bool = False) -> bytes:
    """hash_tree_root of a BeaconState: the dirty-subtree collector when the
    device HTR mode is active, the plain value path otherwise. Any error of
    the tracker drops it and re-raises.

    `transient=True` marks a ONE-SHOT root on a throwaway or dormant
    state (block production's state-root dial, archive-replay header
    backfill): a warm tracker is still used, but a cold one is NOT
    built: cold-building per-field snapshots and level stacks (hundreds
    of MB at 1M validators) just to discard them is pure churn."""
    ctype = state.type
    if not device_htr.device_htr_active():
        return ctype.hash_tree_root(state)
    tracker = state.__dict__.get(_TRACKER_KEY)
    if transient and (tracker is None or tracker.ctype is not ctype):
        return ctype.hash_tree_root(state)
    try:
        if tracker is None or tracker.ctype is not ctype:
            tracker = StateRootTracker(ctype)
            state.__dict__[_TRACKER_KEY] = tracker
        with tracing.span("state_htr") as sp:
            root, stats = tracker.root(state)
            if sp:
                sp.set(
                    layer=stats["backend"],
                    dirty_chunks=stats["dirty_chunks"],
                    levels=stats["levels"],
                    launches=stats["launches"],
                )
        return root
    except BaseException:
        # the tracker's snapshots and level stacks may be half updated
        state.__dict__.pop(_TRACKER_KEY, None)
        raise
