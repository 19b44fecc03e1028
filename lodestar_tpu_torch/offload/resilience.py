"""Circuit breaker: the wedge detector of each verifier-mesh lane.

The PyTorch port's copy of `BreakerState` and `CircuitBreaker` from
``lodestar_tpu/offload/resilience.py``: a closed -> open -> half-open
state machine. Consecutive failures open the breaker; after an
exponential-with-jitter reset delay (`utils.backoff_delay`) ONE trial is
admitted (half-open); success closes the breaker, failure re-opens it
with a longer delay. `try_acquire` hands out a generation token and
`record_success` / `record_failure` ignore outcomes whose token is stale;
tokenless calls (the pool's lanes gate on `is_open` alone) keep the
window rule. The quarantine and probe-release of the offload client are
not copied.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable

from ..utils import backoff_delay

__all__ = [
    "BreakerState",
    "CircuitBreaker",
    "DEFAULT_FAILURE_THRESHOLD",
    "DEFAULT_RESET_TIMEOUT_S",
    "DEFAULT_MAX_RESET_TIMEOUT_S",
]

#: breaker defaults (the JAX package's). Threshold tuned so one flaky call
#: doesn't open the breaker but a dead host opens within one gossip burst.
DEFAULT_FAILURE_THRESHOLD = 5
DEFAULT_RESET_TIMEOUT_S = 2.0
DEFAULT_MAX_RESET_TIMEOUT_S = 30.0


class BreakerState(enum.IntEnum):
    """Gauge-friendly encoding: 0 closed / 1 half-open / 2 open."""

    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2

    @property
    def label(self) -> str:
        return self.name.lower()


class CircuitBreaker:
    """Closed → open → half-open breaker, thread-safe.

    Executor threads record launch outcomes while the event loop and
    scrapers read the state, so every state read/write holds the
    internal lock. `on_transition(old, new)` fires
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

    # -- queries ---------------------------------------------------------------

    def state(self) -> BreakerState:
        with self._lock:
            return self._state

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
                self._retry_at = self._clock() + delay
        self._emit(fire)

    # -- internals -------------------------------------------------------------

    def _emit(self, fire: tuple[BreakerState, BreakerState] | None) -> None:
        if fire is not None and self._on_transition is not None:
            try:
                self._on_transition(*fire)
            except Exception:
                pass  # metric/log sink errors must never affect admission
