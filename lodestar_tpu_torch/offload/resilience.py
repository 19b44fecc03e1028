"""Offload resilience primitives: circuit breakers + deadline budgets.

The PyTorch port's copy of ``lodestar_tpu/offload/resilience.py``, with the
same constants and the same state machine. The breaker is the wedge
detector of each verifier-mesh lane and the per-endpoint breaker of the
offload client (`offload/client.py`):

* `CircuitBreaker` — closed -> open -> half-open. Consecutive failures
  open the breaker; after an exponential-with-jitter reset delay
  (`utils.backoff_delay`) ONE trial is admitted (half-open); success
  closes the breaker, failure re-opens it with a longer delay. A
  successful Status probe releases the open-wait early
  (`note_probe_success`). `try_acquire` hands out a generation token and
  `record_success` / `record_failure` ignore outcomes whose token is
  stale; tokenless calls (the pool's lanes gate on `is_open` alone) keep
  the window rule.
* Quarantine — `quarantine(cooloff_s)` forces the breaker open with a
  flag that a probe recovery does NOT release (quarantine means the
  endpoint LIED, which transport health says nothing about), until the
  cool-off elapses (then one half-open trial re-earns trust) or
  `unquarantine()`.
* `deadline_for` — class-aware RPC deadline budgets (`CLASS_DEADLINE_S`),
  split by the client across its hedged retry (`HEDGE_CLASSES`), and the
  true-hedge trigger delay `DEFAULT_HEDGE_DELAY_MS`.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable

from ..scheduler import PriorityClass
from ..utils import backoff_delay

__all__ = [
    "BreakerState",
    "CircuitBreaker",
    "CLASS_DEADLINE_S",
    "HEDGE_CLASSES",
    "DEFAULT_HEDGE_DELAY_MS",
    "DEFAULT_FAILURE_THRESHOLD",
    "DEFAULT_RESET_TIMEOUT_S",
    "DEFAULT_MAX_RESET_TIMEOUT_S",
    "DEFAULT_QUARANTINE_COOLOFF_S",
    "deadline_for",
]

#: breaker defaults (the JAX package's). Threshold tuned so one flaky call
#: doesn't open the breaker but a dead host opens within one gossip burst.
DEFAULT_FAILURE_THRESHOLD = 5
DEFAULT_RESET_TIMEOUT_S = 2.0
DEFAULT_MAX_RESET_TIMEOUT_S = 30.0

#: quarantine cool-off after a Byzantine event (offload/audit.py). Long
#: by design: a helper caught lying is not a flapping transport — 15
#: minutes keeps an operator in the loop while still self-healing
#: unattended deployments. 0/None = quarantined until unquarantine().
DEFAULT_QUARANTINE_COOLOFF_S = 900.0


class BreakerState(enum.IntEnum):
    """Gauge-friendly encoding: 0 closed / 1 half-open / 2 open."""

    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2

    @property
    def label(self) -> str:
        return self.name.lower()


#: per-launch-class RPC deadline budget (seconds), covering ALL attempts
#: — the client splits it across the hedged retry, so GOSSIP_BLOCK's 2s
#: bounds the whole verification leg well inside the 4s attestation
#: deadline; bulk classes keep the old generous flat timeout. The JAX
#: package's values, tuned on a TPU; PERF.md §7 holds them against the
#: H100's replay times.
CLASS_DEADLINE_S: dict[PriorityClass, float] = {
    PriorityClass.GOSSIP_BLOCK: 2.0,
    PriorityClass.GOSSIP_ATTESTATION: 4.0,
    PriorityClass.API: 10.0,
    PriorityClass.RANGE_SYNC: 30.0,
    PriorityClass.BACKFILL: 30.0,
}

#: classes whose failed RPC is retried once on a second healthy endpoint
#: (the deadline budget covers two attempts; bulk work just fails over
#: to the degradation chain / next submission instead)
HEDGE_CLASSES = frozenset({PriorityClass.GOSSIP_BLOCK, PriorityClass.GOSSIP_ATTESTATION})

#: true-hedge trigger delay: how long the first hedge-class RPC may stay
#: pending before the client fires a CONCURRENT second attempt on a
#: sibling endpoint (client.py's hedged path; None/unset keeps the
#: sequential retry-after-failure behavior). The JAX package's value.
DEFAULT_HEDGE_DELAY_MS = 30.0


def deadline_for(
    priority: PriorityClass,
    *,
    cap: float | None = None,
    deadlines: dict[PriorityClass, float] | None = None,
) -> float:
    """The RPC deadline for one attempt of `priority`-class work, capped
    at `cap` (a caller-configured flat timeout stays an upper bound so
    explicit tight timeouts — e.g. tests against dead endpoints — win)."""
    d = (deadlines or CLASS_DEADLINE_S).get(priority, CLASS_DEADLINE_S[PriorityClass.API])
    if cap is not None:
        d = min(d, cap)
    return d


class CircuitBreaker:
    """Closed → open → half-open breaker, thread-safe.

    Executor threads record outcomes while the event loop, the client's
    probe thread and scrapers read the state, so every state read/write
    holds the internal lock. `on_transition(old, new)` fires
    outside the lock — metric/log sinks must not re-enter.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        reset_timeout_s: float = DEFAULT_RESET_TIMEOUT_S,
        max_reset_timeout_s: float = DEFAULT_MAX_RESET_TIMEOUT_S,
        jitter: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[BreakerState, BreakerState], None] | None = None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.max_reset_timeout_s = max_reset_timeout_s
        self.jitter = jitter
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED  # guarded by: _lock
        self._failures = 0  # guarded by: _lock — consecutive, resets on success
        self._open_streak = 0  # guarded by: _lock — consecutive opens -> exponential reset delay
        self._retry_at = 0.0  # guarded by: _lock
        self._trial_inflight = False  # guarded by: _lock
        # generation token: bumped on EVERY state transition, handed out
        # by try_acquire; outcomes carrying a stale token are ignored
        self._epoch = 1  # guarded by: _lock
        # Byzantine quarantine (offload/audit.py): forced-open with a
        # flag probe recoveries don't release; _retry_at holds the
        # cool-off deadline (inf = until unquarantine())
        self._quarantined = False  # guarded by: _lock

    # -- queries ---------------------------------------------------------------

    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    @property
    def is_quarantined(self) -> bool:
        """True while the quarantine cool-off still gates the endpoint.
        Once the cool-off elapses the breaker behaves like any OPEN
        breaker past its delay (one half-open trial re-earns trust);
        the flag itself is cleared lazily by that trial."""
        with self._lock:
            return self._quarantined and self._clock() < self._retry_at

    @property
    def is_open(self) -> bool:
        """True while the breaker refuses NEW work outright (open and
        the reset delay has not elapsed). Cheap routing predicate — does
        not mutate state or consume the half-open trial slot."""
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return False
            if self._state is BreakerState.HALF_OPEN:
                return self._trial_inflight
            return self._clock() < self._retry_at

    def seconds_until_trial(self) -> float:
        with self._lock:
            if self._state is not BreakerState.OPEN:
                return 0.0
            return max(0.0, self._retry_at - self._clock())

    # -- admission -------------------------------------------------------------

    def try_acquire(self) -> int | None:
        """May a request be issued now? Returns a generation TOKEN (a
        truthy int — existing boolean callers keep working) when
        admitted, None when refused. Pass the token back to
        record_success/record_failure so the outcome is matched to this
        attempt: outcomes from a stale generation (the breaker
        transitioned since) are ignored instead of perturbing a trial.

        CLOSED always admits. OPEN past its reset delay flips to
        HALF_OPEN and admits exactly one trial; the trial slot is held
        until record_success/record_failure."""
        fire: tuple[BreakerState, BreakerState] | None = None
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return self._epoch
            if self._state is BreakerState.OPEN and self._clock() >= self._retry_at:
                fire = (self._state, BreakerState.HALF_OPEN)
                self._state = BreakerState.HALF_OPEN
                self._epoch += 1
                self._quarantined = False  # cool-off elapsed: trial re-earns trust
                self._trial_inflight = True
                token = self._epoch
            elif self._state is BreakerState.HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return self._epoch
            else:
                return None
        self._emit(fire)
        return token

    # -- outcomes --------------------------------------------------------------

    def record_success(self, token: int | None = None) -> None:
        fire: tuple[BreakerState, BreakerState] | None = None
        with self._lock:
            if token is not None and token != self._epoch:
                # stale generation: the breaker transitioned since this
                # attempt was admitted (e.g. opened under it) — a
                # long-delayed success from before the failures is not
                # evidence about the endpoint NOW
                return
            self._failures = 0
            if self._state is BreakerState.OPEN and self._clock() < self._retry_at:
                # a STALE success: an RPC issued before the breaker
                # opened, landing inside the reset window. Not trial
                # evidence — closing here would resume full traffic to a
                # host that just produced `failure_threshold` consecutive
                # failures. (Past the window it IS trial-equivalent: the
                # pool gates on is_open alone and never runs try_acquire.)
                return
            self._trial_inflight = False
            if self._state is not BreakerState.CLOSED:
                fire = (self._state, BreakerState.CLOSED)
                self._state = BreakerState.CLOSED
                self._epoch += 1
                self._quarantined = False
                self._open_streak = 0
        self._emit(fire)

    def record_failure(self, token: int | None = None) -> None:
        fire: tuple[BreakerState, BreakerState] | None = None
        with self._lock:
            if token is not None and token != self._epoch:
                # stale generation: a failure from a pre-open RPC must
                # not re-open the breaker mid-trial (it would discard
                # the in-flight trial's success) nor double-count into a
                # fresh CLOSED streak — the attempt it belongs to
                # already resolved its era
                return
            self._trial_inflight = False
            self._failures += 1
            # a failure while OPEN past the reset delay is a failed trial
            # too: callers that gate on is_open alone (the pool's wedge
            # check never calls try_acquire) let work through once the
            # delay elapses — without re-arming here the breaker would
            # stop gating forever after its first reset window
            should_open = (
                self._state is BreakerState.HALF_OPEN
                or (self._state is BreakerState.OPEN and self._clock() >= self._retry_at)
                or (
                    self._state is BreakerState.CLOSED
                    and self._failures >= self.failure_threshold
                )
            )
            if should_open:
                if self._state is not BreakerState.OPEN:
                    fire = (self._state, BreakerState.OPEN)
                delay = backoff_delay(
                    self._open_streak,
                    base=self.reset_timeout_s,
                    max_delay=self.max_reset_timeout_s,
                    jitter=self.jitter,
                )
                self._open_streak += 1
                self._state = BreakerState.OPEN
                self._epoch += 1
                self._quarantined = False  # a plain failure era replaces quarantine
                self._retry_at = self._clock() + delay
        self._emit(fire)

    def note_probe_success(self) -> None:
        """Out-of-band evidence the endpoint is back (a Status probe
        answered): release the open-wait so the next verify becomes the
        half-open trial instead of sitting out the full reset delay.
        A QUARANTINED breaker is exempt: quarantine means the endpoint
        lied while its transport was perfectly healthy — a live Status
        probe is exactly zero evidence against that."""
        with self._lock:
            if self._state is BreakerState.OPEN and not self._quarantined:
                self._retry_at = self._clock()

    # -- quarantine ------------------------------------------------------------

    def quarantine(self, cooloff_s: float | None = None) -> None:
        """Force the breaker open for a Byzantine event (offload/audit):
        no trials, no probe release, until `cooloff_s` elapses (then ONE
        half-open trial re-earns trust) or unquarantine(). None/0 means
        quarantined indefinitely — operator action required."""
        fire: tuple[BreakerState, BreakerState] | None = None
        with self._lock:
            if self._state is not BreakerState.OPEN:
                fire = (self._state, BreakerState.OPEN)
            self._state = BreakerState.OPEN
            self._epoch += 1  # in-flight outcomes from before the event are void
            self._quarantined = True
            self._trial_inflight = False
            self._retry_at = (
                self._clock() + cooloff_s if cooloff_s else float("inf")
            )
        self._emit(fire)

    def unquarantine(self) -> None:
        """Operator lift: drop the flag and the cool-off so the next
        request becomes the half-open trial — the endpoint still re-earns
        CLOSED through a successful trial rather than being trusted
        outright."""
        with self._lock:
            if not self._quarantined:
                return
            self._quarantined = False
            self._retry_at = self._clock()

    # -- internals -------------------------------------------------------------

    def _emit(self, fire: tuple[BreakerState, BreakerState] | None) -> None:
        if fire is not None and self._on_transition is not None:
            try:
                self._on_transition(*fire)
            except Exception:
                pass  # metric/log sink errors must never affect admission
