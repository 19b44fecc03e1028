"""SimClock: monotonic virtual time for deterministic fault tests.

The PyTorch port's copy of ``lodestar_tpu/testing/clock.py``. A chaos
harness's determinism contract is that `run(seed=S)` produces an
identical fault schedule and verdict ledger twice. Real wall time
breaks that instantly — a 2 ms scheduling hiccup moves an SLO slack
sample, a breaker reset window, or a latency fault past a deadline.
SimClock replaces every clock READ with a lock-guarded
virtual counter that only `advance()`/`sleep()` move, injected through
the seams the production code already exposes:

* `SlotDeadlineModel(time_fn=clock.time)` — wall-clock slot math
* `configure_slo(..., time_fn=clock.time, monotonic_ns_fn=clock.monotonic_ns)`
* `PriorityWorkQueue(time_fn=clock.monotonic_ns)` — aging/queue-wait
* `CircuitBreaker(clock=clock.monotonic)` / `BlsOffloadClient(breaker_clock=...)`
* `FaultInjector(sleep_fn=clock.sleep)` — injected latency advances
  virtual time instead of stalling the test for real

Unset (the production default everywhere), each seam falls back to the
real `time` module — SimClock is a pure test-side construct and never
appears on a production code path.

The clock is deliberately simple: no waiters, no scheduling. A harness
drives work SEQUENTIALLY and advances time at explicit points
(per-job cost, slot boundaries), which is exactly what makes two runs
bit-identical. `sleep()` advances the clock and returns immediately —
virtual time passes, real time does not.
"""

from __future__ import annotations

import threading

__all__ = ["SimClock"]


class SimClock:
    """Monotonic virtual time. `time()`/`monotonic()` share one counter
    (the sim has no separate epochs — genesis anchors at `start`)."""

    def __init__(self, start: float = 0.0) -> None:
        self._lock = threading.Lock()
        self._now = float(start)

    # -- reads (drop-in for time.time / time.monotonic / monotonic_ns) --------

    def time(self) -> float:
        with self._lock:
            return self._now

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def monotonic_ns(self) -> int:
        with self._lock:
            return int(round(self._now * 1e9))

    # -- writes ----------------------------------------------------------------

    def advance(self, seconds: float) -> float:
        """Move time forward (never backward); returns the new now."""
        with self._lock:
            self._now += max(0.0, float(seconds))
            return self._now

    def advance_to(self, when: float) -> float:
        """Jump to an absolute virtual instant (no-op if already past)."""
        with self._lock:
            self._now = max(self._now, float(when))
            return self._now

    def sleep(self, seconds: float) -> None:
        """Drop-in for `time.sleep` through the fault injector's seam:
        advances virtual time, returns immediately in real time."""
        self.advance(seconds)

    def __repr__(self) -> str:  # debugging aid in ledger dumps
        return f"SimClock(t={self.time():.6f})"
