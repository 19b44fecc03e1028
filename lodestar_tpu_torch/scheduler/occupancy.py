"""Occupancy accounting + graded admission for one device backend.

The PyTorch port's copy of ``lodestar_tpu/scheduler/occupancy.py``.

`OccupancyTracker` answers the ROADMAP question "busy-ns per wall-ns":
launches bracket themselves with `with tracker.launch():`; between
transitions the tracker folds the interval's busy fraction (1.0 while
any launch is active, overlaps don't double-count) into an exponentially
weighted moving average with time constant `tau_s`. Thread-safe — the
BLS pool launches from executor threads, the offload server from gRPC
worker threads, and Status RPCs read concurrently.

`AdmissionController` turns occupancy + queue depth + an optional
can-accept callable into the three-state admission signal the offload
Status frame carries: ACCEPT (all work), SHED_BULK (urgent classes only
— bulk should go to a less-loaded host), REJECT (nothing).
"""

from __future__ import annotations

import enum
import math
import threading
import time
from contextlib import contextmanager

from .core import BULK_CLASSES, PriorityClass

__all__ = ["OccupancyTracker", "AdmissionController", "AdmissionState"]

DEFAULT_TAU_S = 10.0
DEFAULT_SHED_BULK_AT = 0.75  # EWMA occupancy fraction
DEFAULT_REJECT_AT = 0.95


class AdmissionState(enum.IntEnum):
    ACCEPT = 0
    SHED_BULK = 1
    REJECT = 2

    @property
    def label(self) -> str:
        return self.name.lower()


class OccupancyTracker:
    """EWMA busy-fraction of one device pipeline (0.0 idle .. 1.0 pinned)."""

    def __init__(self, *, tau_s: float = DEFAULT_TAU_S, time_fn=time.monotonic_ns) -> None:
        self._tau_ns = tau_s * 1e9
        self._time_fn = time_fn
        self._lock = threading.Lock()
        self._active = 0  # guarded by: _lock
        self._ewma = 0.0  # guarded by: _lock
        self._last_ns = time_fn()  # guarded by: _lock
        self.busy_ns_total = 0  # guarded by: _lock — lifetime busy integral (debug/tests)

    def _advance(self, now_ns: int) -> None:  # lint: allow(lock-discipline) — internal fold step; every caller (begin/end/occupancy) holds _lock
        dt = now_ns - self._last_ns
        if dt <= 0:
            return
        busy = 1.0 if self._active > 0 else 0.0
        if busy:
            self.busy_ns_total += dt
        keep = math.exp(-dt / self._tau_ns)
        self._ewma = self._ewma * keep + busy * (1.0 - keep)
        self._last_ns = now_ns

    def begin(self) -> None:
        with self._lock:
            self._advance(self._time_fn())
            self._active += 1

    def end(self) -> None:
        with self._lock:
            self._advance(self._time_fn())
            self._active = max(0, self._active - 1)

    @contextmanager
    def launch(self):
        self.begin()
        try:
            yield self
        finally:
            self.end()

    def occupancy(self) -> float:
        with self._lock:
            self._advance(self._time_fn())
            return self._ewma

    def occupancy_permille(self) -> int:
        return max(0, min(1000, int(round(self.occupancy() * 1000.0))))


class AdmissionController:
    """Graded admission from occupancy + depth (+ a hard veto callable).

    REJECT: the veto says no, occupancy >= reject_at, or depth >=
    reject_depth. SHED_BULK: occupancy >= shed_bulk_at or depth >=
    shed_bulk_depth. ACCEPT otherwise.
    """

    def __init__(
        self,
        occupancy: OccupancyTracker,
        *,
        shed_bulk_at: float = DEFAULT_SHED_BULK_AT,
        reject_at: float = DEFAULT_REJECT_AT,
        depth_fn=None,
        shed_bulk_depth: int = 256,
        reject_depth: int = 1024,
        can_accept=None,
    ) -> None:
        self.occupancy = occupancy
        self.shed_bulk_at = shed_bulk_at
        self.reject_at = reject_at
        self._depth_fn = depth_fn or (lambda: 0)
        self.shed_bulk_depth = shed_bulk_depth
        self.reject_depth = reject_depth
        self._can_accept = can_accept or (lambda: True)

    def state(self) -> AdmissionState:
        if not self._can_accept():
            return AdmissionState.REJECT
        occ = self.occupancy.occupancy()
        depth = self._depth_fn()
        if occ >= self.reject_at or depth >= self.reject_depth:
            return AdmissionState.REJECT
        if occ >= self.shed_bulk_at or depth >= self.shed_bulk_depth:
            return AdmissionState.SHED_BULK
        return AdmissionState.ACCEPT

    def admits(self, cls: PriorityClass) -> bool:
        state = self.state()
        if state is AdmissionState.REJECT:
            return False
        if state is AdmissionState.SHED_BULK:
            return PriorityClass(cls) not in BULK_CLASSES
        return True
