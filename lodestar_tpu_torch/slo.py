"""Slot-deadline SLO accounting: remaining-slack stamps on every
verification job.

The PyTorch port's copy of the parts of ``lodestar_tpu/slo`` the verifier
pool calls: `SlotDeadlineModel` (per-priority-class deadlines anchored at
the chain's ``genesis_time``: a gossip block by 1/3 slot, a gossip
attestation by 2/3 slot, an API submission by the end of the slot,
multi-slot budgets for sync and backfill), the process-global accountant
(`configure_slo` / `reset_slo` and the `job_*` lifecycle hooks) and its
`wait_budget` profile, which splits each job's life into four legs (buffer
wait, queue wait, staging, device launch) from its own monotonic stamps;
and the chain's span and dump helpers (`slack_ms`, `debug_view`,
`slow_slot_slack`).
Deadlines are wall-clock, every duration leg monotonic. Unconfigured, each
hook costs one None check. Stdlib only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

from .scheduler import PriorityClass

__all__ = [
    "DEADLINE_FRACTIONS",
    "SLO_STAGES",
    "WAIT_LEGS",
    "SlotDeadlineModel",
    "JobSlo",
    "configure_slo",
    "reset_slo",
    "slo_active",
    "job_begin",
    "job_flushed",
    "job_dequeued",
    "job_launch",
    "job_verdict",
    "wait_budget",
    "slack_ms",
    "debug_view",
    "slow_slot_slack",
]

#: per-class deadline as a fraction of (or multiple of) the slot
#: length, measured from the start of the job's anchor slot. The
#: gossip cutoffs mirror the honest-validator timeline: attesters vote
#: at 1/3 slot (a block verified later missed its attestations),
#: aggregates are due at 2/3 slot. API work is useful until the slot
#: rolls over. Sync/backfill have no protocol deadline; the multi-slot
#: budgets make "eventually" a measurable bound instead of a shrug.
DEADLINE_FRACTIONS: dict[PriorityClass, float] = {
    PriorityClass.GOSSIP_BLOCK: 1.0 / 3.0,
    PriorityClass.GOSSIP_ATTESTATION: 2.0 / 3.0,
    PriorityClass.API: 1.0,
    PriorityClass.RANGE_SYNC: 8.0,
    PriorityClass.BACKFILL: 32.0,
}

#: lifecycle stages a slack sample is labelled with
SLO_STAGES = ("enqueue", "dispatch", "verdict")

#: the four legs that partition added→verdict (see `wait_budget`)
WAIT_LEGS = ("buffer", "queue", "stage", "launch")

#: ring depth per (class, leg) quantile window — enough for stable
#: p99 at steady state, bounded so an idle class costs nothing
_SAMPLE_WINDOW = 512

_NS = 1e-9


class SlotDeadlineModel:
    """Genesis-anchored per-class deadlines (``chain/clock.py`` math).

    The injectable ``time_fn`` keeps every test deterministic; the
    wall clock is read through it exclusively.
    """

    def __init__(
        self,
        *,
        genesis_time: float,
        seconds_per_slot: int,
        slots_per_epoch: int = 32,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        if seconds_per_slot <= 0:
            raise ValueError(f"seconds_per_slot must be positive, got {seconds_per_slot}")
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.slots_per_epoch = slots_per_epoch
        self._time = time_fn

    def now(self) -> float:
        return self._time()

    @property
    def current_slot(self) -> int:
        return max(0, int(self._time() - self.genesis_time) // self.seconds_per_slot)

    def time_at_slot(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def deadline_for(self, cls: PriorityClass, slot: int | None = None) -> float:
        """Absolute wall-clock deadline for `cls` work anchored at
        `slot` (the job's subject slot — a block's slot, not the slot
        the work happened to arrive in). ``slot=None`` anchors at the
        current slot, the right call for work with no subject slot
        (API batches, attestation aggregates)."""
        anchor = self.current_slot if slot is None else slot
        return self.time_at_slot(anchor) + DEADLINE_FRACTIONS[cls] * self.seconds_per_slot

    def slack_s(self, cls: PriorityClass, slot: int | None = None, now: float | None = None) -> float:
        """Remaining slack in seconds (negative = past the deadline)."""
        t = self._time() if now is None else now
        return self.deadline_for(cls, slot) - t


class JobSlo:
    """Per-job slack/leg ledger: monotonic stamps at each lifecycle
    edge plus the absolute deadline frozen at enqueue (so every stage
    measures against the same anchor). `done` makes verdict recording
    idempotent — a job future resolves once, but belt and braces."""

    __slots__ = (
        "cls",
        "slot",
        "deadline_s",
        "t_added_ns",
        "t_flush_ns",
        "t_dequeue_ns",
        "t_launch_ns",
        "queue_wait_ns",
        "done",
    )

    def __init__(self, cls: PriorityClass, slot: int | None, deadline_s: float, now_ns: int):
        self.cls = cls
        self.slot = slot
        self.deadline_s = deadline_s
        self.t_added_ns = now_ns
        # unbuffered jobs never flush: the buffer leg collapses to 0
        self.t_flush_ns = now_ns
        self.t_dequeue_ns = now_ns
        self.t_launch_ns = now_ns
        self.queue_wait_ns = 0
        self.done = False


class _SloAccountant:
    """Process-global slack/SLI/wait-budget state behind one lock.

    All mutation paths are O(1) appends/increments; the quantile fold
    happens only when a debug endpoint or profiler asks."""

    def __init__(self) -> None:
        self.model: SlotDeadlineModel | None = None
        self.slack_floor_s = 0.0
        # injectable monotonic source, so a caller on virtual time can
        # stamp job legs on it
        self.monotonic_ns: Callable[[], int] = time.monotonic_ns
        self._lock = threading.Lock()
        # (class, leg) -> ring of leg durations (seconds)
        self._legs: dict[tuple[PriorityClass, str], deque] = {}
        # class -> ring of end-to-end durations (seconds)
        self._e2e: dict[PriorityClass, deque] = {}
        # class -> ring of verdict-stage slack samples (seconds)
        self._slack: dict[PriorityClass, deque] = {}
        self._good: dict[PriorityClass, int] = {c: 0 for c in PriorityClass}
        self._total: dict[PriorityClass, int] = {c: 0 for c in PriorityClass}
        self._miss: dict[PriorityClass, int] = {c: 0 for c in PriorityClass}

    def _ring(self, table: dict, key) -> deque:
        ring = table.get(key)
        if ring is None:
            ring = table[key] = deque(maxlen=_SAMPLE_WINDOW)
        return ring

    def record_verdict(self, js: JobSlo, ok: bool, now_ns: int, slack_s: float) -> None:
        with self._lock:
            if js.done:
                return
            js.done = True
            cls = js.cls
            self._ring(self._legs, (cls, "buffer")).append(
                max(0, js.t_flush_ns - js.t_added_ns) * _NS
            )
            self._ring(self._legs, (cls, "queue")).append(
                max(0, js.t_dequeue_ns - js.t_flush_ns) * _NS
            )
            self._ring(self._legs, (cls, "stage")).append(
                max(0, js.t_launch_ns - js.t_dequeue_ns) * _NS
            )
            self._ring(self._legs, (cls, "launch")).append(
                max(0, now_ns - js.t_launch_ns) * _NS
            )
            self._ring(self._e2e, cls).append(max(0, now_ns - js.t_added_ns) * _NS)
            self._ring(self._slack, cls).append(slack_s)
            met = slack_s >= self.slack_floor_s
            self._total[cls] += 1
            if ok and met:
                self._good[cls] += 1
            if not met:
                self._miss[cls] += 1

    # -- read side ------------------------------------------------------------

    def wait_budget(self) -> dict:
        """Per-class latency decomposition: quantiles for each leg and
        end-to-end, plus the SLI counters. The four legs share stamp
        pairs with end-to-end (buffer+queue+stage+launch telescopes to
        verdict-added), so a mean leg sum matches the mean end-to-end
        span up to ring-window skew."""
        model = self.model
        out: dict = {
            "enabled": model is not None,
            "slack_floor_ms": self.slack_floor_s * 1000.0,
            "deadline_model": None,
            "classes": {},
        }
        if model is not None:
            out["deadline_model"] = {
                "genesis_time": model.genesis_time,
                "seconds_per_slot": model.seconds_per_slot,
                "slots_per_epoch": model.slots_per_epoch,
                "deadline_fractions": {
                    c.label: DEADLINE_FRACTIONS[c] for c in PriorityClass
                },
            }
        with self._lock:
            for cls in PriorityClass:
                if self._total[cls] == 0 and cls not in self._e2e:
                    continue
                legs = {
                    leg: _quantiles(self._legs.get((cls, leg)))
                    for leg in WAIT_LEGS
                }
                out["classes"][cls.label] = {
                    "legs": legs,
                    "end_to_end": _quantiles(self._e2e.get(cls)),
                    "leg_sum_mean_ms": round(
                        sum(legs[leg]["mean_ms"] for leg in WAIT_LEGS), 4
                    ),
                    "slack": _quantiles(self._slack.get(cls), unit_ms=False),
                    "sli": {
                        "good": self._good[cls],
                        "total": self._total[cls],
                        "miss": self._miss[cls],
                    },
                }
        return out

    def slow_slot_slack(self) -> dict:
        """Per-class remaining slack right now — the snapshot a slow-slot
        dump embeds so 'did we still make the deadline' needs no
        metrics query."""
        model = self.model
        if model is None:
            return {}
        slot = model.current_slot
        now = model.now()
        return {
            "slot": slot,
            "slack_s": {
                c.label: round(model.slack_s(c, slot, now), 4) for c in PriorityClass
            },
        }


def _quantiles(ring: deque | None, unit_ms: bool = True) -> dict:
    scale = 1000.0 if unit_ms else 1.0
    suffix = "_ms" if unit_ms else "_s"
    if not ring:
        return {f"p50{suffix}": 0.0, f"p90{suffix}": 0.0, f"p99{suffix}": 0.0,
                f"mean{suffix}": 0.0, "count": 0}
    xs = sorted(ring)
    n = len(xs)

    def q(p: float) -> float:
        return round(xs[min(n - 1, int(p * n))] * scale, 4)

    return {
        f"p50{suffix}": q(0.50),
        f"p90{suffix}": q(0.90),
        f"p99{suffix}": q(0.99),
        f"mean{suffix}": round(sum(xs) / n * scale, 4),
        "count": n,
    }


_ACCT = _SloAccountant()


def configure_slo(
    *,
    enabled: bool = True,
    genesis_time: float | None = None,
    seconds_per_slot: int = 12,
    slots_per_epoch: int = 32,
    slack_floor_ms: float = 0.0,
    time_fn: Callable[[], float] = time.time,
    monotonic_ns_fn: Callable[[], int] = time.monotonic_ns,
) -> None:
    """(Re)configure the process-global accountant. Disabled or
    genesis-less: every job hook degrades to a single None
    check. `monotonic_ns_fn` pairs with `time_fn` when the caller runs
    on virtual time: wall-clock deadlines and job-leg
    stamps must advance together or leg durations go negative."""
    if enabled and genesis_time is not None:
        _ACCT.model = SlotDeadlineModel(
            genesis_time=genesis_time,
            seconds_per_slot=seconds_per_slot,
            slots_per_epoch=slots_per_epoch,
            time_fn=time_fn,
        )
    else:
        _ACCT.model = None
    _ACCT.slack_floor_s = slack_floor_ms / 1000.0
    _ACCT.monotonic_ns = monotonic_ns_fn


def reset_slo() -> None:
    """Test isolation: drop the model and all rings."""
    _ACCT.model = None
    _ACCT.slack_floor_s = 0.0
    _ACCT.monotonic_ns = time.monotonic_ns
    with _ACCT._lock:
        _ACCT._legs.clear()
        _ACCT._e2e.clear()
        _ACCT._slack.clear()
        for c in PriorityClass:
            _ACCT._good[c] = 0
            _ACCT._total[c] = 0
            _ACCT._miss[c] = 0


def slo_active() -> bool:
    return _ACCT.model is not None


# -- per-job lifecycle hooks (pool-facing) ------------------------------------


def job_begin(priority: PriorityClass, slot: int | None = None) -> JobSlo | None:
    """Called at enqueue. Freezes the job's absolute deadline (anchored
    at the subject `slot` when the caller knows it). Returns None when the accountant is inactive —
    the None is the whole disabled-path cost."""
    model = _ACCT.model
    if model is None:
        return None
    cls = PriorityClass(priority)
    deadline = model.deadline_for(cls, slot)
    return JobSlo(cls, slot, deadline, _ACCT.monotonic_ns())


def job_flushed(js: JobSlo | None) -> None:
    """Batchable job left the accumulation buffer for the queue."""
    if js is not None:
        js.t_flush_ns = _ACCT.monotonic_ns()


def job_dequeued(js: JobSlo | None, waited_ns: int = 0) -> None:
    """Scheduler handed the job to a worker."""
    if js is None:
        return
    js.t_dequeue_ns = _ACCT.monotonic_ns()
    js.queue_wait_ns = waited_ns


def job_launch(js: JobSlo | None) -> None:
    """Staging done, device launch starting."""
    if js is not None:
        js.t_launch_ns = _ACCT.monotonic_ns()


def job_verdict(js: JobSlo | None, ok: bool) -> None:
    """Job future resolved (exactly once per job — the caller hooks the
    future's done-callback, which fires once regardless of how many
    batch retries the verdict took). `ok=False` covers both invalid
    signatures and rejected jobs; cancellation should not reach here."""
    if js is None:
        return
    model = _ACCT.model
    slack = (js.deadline_s - model.now()) if model is not None else 0.0
    _ACCT.record_verdict(js, ok, _ACCT.monotonic_ns(), slack)


# -- span/dump helpers ---------------------------------------------------------


def slack_ms(priority: PriorityClass, slot: int | None = None) -> float | None:
    """Remaining slack in ms for span attributes; None when inactive."""
    model = _ACCT.model
    if model is None:
        return None
    return round(model.slack_s(PriorityClass(priority), slot) * 1000.0, 3)


def wait_budget() -> dict:
    """The machine-readable per-class wait-budget profile (see
    `_SloAccountant.wait_budget`)."""
    return _ACCT.wait_budget()


def debug_view() -> dict:
    """`GET /eth/v0/debug/slo` payload: the wait budget plus the live
    slack snapshot."""
    out = _ACCT.wait_budget()
    out["now"] = _ACCT.slow_slot_slack()
    return out


def slow_slot_slack() -> dict:
    """Per-class remaining slack at call time (slow-slot dump payload);
    empty dict when inactive."""
    return _ACCT.slow_slot_slack()
