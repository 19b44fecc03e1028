"""Multi-tenant admission + stride-fair service scheduling for the
offload server.

The PyTorch port's copy of ``lodestar_tpu/offload/tenancy.py``: the same
weights, depths, grant order and sheds. The `metrics` argument stays
duck-typed (`quota_weight`, `shed`, `inflight`, each with `.labels`).

One TPU host serves MANY beacon nodes ("the millions-of-users shape: a
verification service, not a sidecar" — ROADMAP). Without an enforcement
point, one greedy tenant saturates the device and starves everyone: the
graded ACCEPT/SHED_BULK/REJECT Status frame is advisory, and a
misbehaving client simply ignores it. `TenantScheduler` is the
enforcement point, layered UNDER the existing graded admission:

* **Identity**: verify frames carry a tenant trailer (legacy frames
  account to `DEFAULT_TENANT`), so quotas attach to the wire identity,
  not the transport address.
* **Admission quotas**: per-tenant depth grading — a tenant whose
  pending+running work reaches `shed_depth` has its BULK classes shed,
  at `reject_depth` everything sheds. Sheds answer with the shed frame
  (`encode_shed`) so a new client fails over without charging the
  endpoint's breaker; a legacy client fails closed on the unknown frame.
* **Stride-fair service**: admitted requests compete for `slots`
  concurrent backend executions. Grants follow stride scheduling over
  tenants (weights = quota shares, same scheme as the device launch
  queue, Waldspurger & Weihl '95): under sustained over-admission each
  tenant's served share tracks its weight, and a tenant waking from
  idle joins at the service frontier (idle time earns no burst credit).
  WITHIN a tenant, grants go most-urgent-first then FIFO — so a greedy
  sibling cannot starve another tenant's gossip-class work, and a
  tenant's own bulk backlog cannot starve its own gossip either.

Thread-model: gRPC worker threads call `admit()` then block in
`acquire()` until granted (or timed out → shed), run the backend, and
`release()`. All state lives under one condition variable; the fair
pick is recomputed by each waiter when the condition wakes, so there is
no separate scheduler thread.
"""

from __future__ import annotations

import itertools
import threading
import time

from ..scheduler import BULK_CLASSES, AdmissionState, PriorityClass

__all__ = [
    "TenantScheduler",
    "parse_tenant_weights",
    "DEFAULT_TENANT_WEIGHT",
    "DEFAULT_TENANT_SHED_DEPTH",
    "DEFAULT_TENANT_REJECT_DEPTH",
    "DEFAULT_ACQUIRE_TIMEOUT_S",
]

DEFAULT_TENANT_WEIGHT = 1
#: per-tenant pending+running depth at which bulk classes shed
DEFAULT_TENANT_SHED_DEPTH = 64
#: per-tenant pending+running depth at which everything sheds
DEFAULT_TENANT_REJECT_DEPTH = 256
#: a request parked past this in the grant queue sheds instead of
#: pinning a gRPC worker forever (the client's own RPC deadline is
#: typically far shorter)
DEFAULT_ACQUIRE_TIMEOUT_S = 30.0

_STRIDE_SCALE = 1 << 20


def parse_tenant_weights(specs) -> dict[str, int]:
    """Parse repeatable `name=weight` CLI specs into a weight map."""
    out: dict[str, int] = {}
    for spec in specs or ():
        name, sep, w = str(spec).partition("=")
        if not sep or not name or not w.isdigit() or int(w) < 1:
            raise ValueError(f"tenant weight must be NAME=POSITIVE_INT, got {spec!r}")
        out[name] = int(w)
    return out


class _Waiter:
    __slots__ = ("tenant", "priority", "seq", "granted")

    def __init__(self, tenant: str, priority: PriorityClass, seq: int):
        self.tenant = tenant
        self.priority = priority
        self.seq = seq
        self.granted = False  # guarded by: _lock [shared] — waiter state owned by the scheduler lock


class TenantScheduler:
    """Cross-tenant stride-fair slot scheduler + per-tenant admission."""

    def __init__(
        self,
        *,
        slots: int = 1,
        weights: dict[str, int] | None = None,
        default_weight: int = DEFAULT_TENANT_WEIGHT,
        shed_depth: int = DEFAULT_TENANT_SHED_DEPTH,
        reject_depth: int = DEFAULT_TENANT_REJECT_DEPTH,
        acquire_timeout_s: float = DEFAULT_ACQUIRE_TIMEOUT_S,
        metrics=None,
        time_fn=time.monotonic,
    ) -> None:
        self._lock = threading.Condition()
        self._slots = max(1, int(slots))
        self._weights = dict(weights or {})
        self._default_weight = max(1, int(default_weight))
        self.shed_depth = shed_depth
        self.reject_depth = reject_depth
        self.acquire_timeout_s = acquire_timeout_s
        self._metrics = metrics
        self._time_fn = time_fn
        self._active = 0  # guarded by: _lock — slots in use
        self._pass: dict[str, int] = {}  # guarded by: _lock — stride pass per tenant
        self._vtime = 0  # guarded by: _lock — service frontier
        self._waiters: list[_Waiter] = []  # guarded by: _lock — grant queue
        self._seq = itertools.count()  # guarded by: _lock
        self._running: dict[str, int] = {}  # guarded by: _lock — granted per tenant
        self._closed = False  # guarded by: _lock
        # observability counters (tests + Status); metrics mirror them
        self.served: dict[str, int] = {}  # guarded by: _lock
        self.shed: dict[str, int] = {}  # guarded by: _lock
        if metrics is not None:
            for tenant, w in self._weights.items():
                metrics.quota_weight.labels(tenant).set(w)

    # -- config reads ----------------------------------------------------------

    def weight(self, tenant: str) -> int:
        return self._weights.get(tenant, self._default_weight)

    def tenants_seen(self) -> list[str]:
        with self._lock:
            return sorted(set(self.served) | set(self.shed) | set(self._weights))

    def depth(self, tenant: str | None = None) -> int:
        """Pending + running work, one tenant or all (Status queue_depth)."""
        with self._lock:
            if tenant is None:
                return len(self._waiters) + self._active
            return self._depth_locked(tenant)

    def _depth_locked(self, tenant: str) -> int:  # lint: allow(lock-discipline) — every caller holds _lock
        pending = sum(1 for w in self._waiters if w.tenant == tenant)
        return pending + self._running.get(tenant, 0)

    # -- admission -------------------------------------------------------------

    def admission_for(self, tenant: str) -> AdmissionState:
        """Per-tenant graded admission from this tenant's depth against
        its quota depths (the global occupancy grading stays with the
        server's AdmissionController — this layers the per-tenant cap)."""
        with self._lock:
            depth = self._depth_locked(tenant)
        if depth >= self.reject_depth:
            return AdmissionState.REJECT
        if depth >= self.shed_depth:
            return AdmissionState.SHED_BULK
        return AdmissionState.ACCEPT

    def admits(self, tenant: str, priority: PriorityClass) -> bool:
        state = self.admission_for(tenant)
        if state is AdmissionState.REJECT:
            return False
        if state is AdmissionState.SHED_BULK:
            return PriorityClass(priority) not in BULK_CLASSES
        return True

    def count_shed(self, tenant: str, priority: PriorityClass, reason: str) -> None:
        with self._lock:
            self.shed[tenant] = self.shed.get(tenant, 0) + 1
        m = self._metrics
        if m is not None:
            m.shed.labels(tenant, reason).inc()

    # -- stride grants ---------------------------------------------------------

    def _grant_head(self) -> "_Waiter | None":  # lint: allow(lock-discipline) — every caller holds _lock
        """The waiter the fair order serves next: tenant with the
        smallest stride pass among tenants with waiters (ties to the
        longest-waiting tenant head), then most-urgent-first / FIFO
        within that tenant."""
        if not self._waiters:
            return None
        tenants = {}
        for w in self._waiters:
            best = tenants.get(w.tenant)
            if best is None or (w.priority, w.seq) < (best.priority, best.seq):
                tenants[w.tenant] = w
        # equal passes (common right after an idle rejoin at the
        # frontier) break toward the more urgent head first — a gossip
        # job must not lose the tie to a bulk backlog — then FIFO
        pick_tenant = min(
            tenants,
            key=lambda t: (
                self._pass.get(t, 0),
                tenants[t].priority,
                tenants[t].seq,
            ),
        )
        return tenants[pick_tenant]

    def _advance(self, tenant: str) -> None:  # lint: allow(lock-discipline) — every caller holds _lock
        cur = self._pass.get(tenant, 0)
        self._pass[tenant] = cur + _STRIDE_SCALE // self.weight(tenant)
        self._vtime = max(self._vtime, self._pass[tenant])

    def acquire(
        self,
        tenant: str,
        priority: PriorityClass = PriorityClass.API,
        timeout_s: float | None = None,
    ) -> bool:
        """Block until granted a service slot in stride-fair order.
        False = shed (timeout or scheduler closed) — the caller answers
        with the shed frame. Every True MUST be paired with release()."""
        timeout = self.acquire_timeout_s if timeout_s is None else timeout_s
        deadline = self._time_fn() + timeout
        with self._lock:
            if self._closed:
                return False
            # a tenant waking from idle joins at the service frontier —
            # idle time earns no burst credit (same rule as the launch
            # queue's class passes)
            if tenant not in self._pass or (
                self._running.get(tenant, 0) == 0
                and not any(w.tenant == tenant for w in self._waiters)
            ):
                active = [
                    self._pass.get(t, 0)
                    for t in set(w.tenant for w in self._waiters)
                    | set(t for t, n in self._running.items() if n > 0)
                ]
                floor = min(active) if active else self._vtime
                self._pass[tenant] = max(self._pass.get(tenant, 0), floor)
            me = _Waiter(tenant, PriorityClass(priority), next(self._seq))
            self._waiters.append(me)
            # deterministic baton passing: grants happen at state
            # transitions (enqueue/release/departure), performed by
            # WHATEVER thread drives the transition — a granted waiter
            # merely observes me.granted when it wakes. Relying on the
            # head's own thread to wake and self-grant instead admits a
            # starvation resonance: a head parked in wait() can miss
            # its window while hot siblings churn the queue.
            self._grant_ready()
            while not me.granted:
                if self._closed:
                    break
                remaining = deadline - self._time_fn()
                if remaining <= 0:
                    break
                # lint: allow(blocking-under-lock) — Condition.wait RELEASES the lock while parked; contenders proceed
                self._lock.wait(min(remaining, 0.5))
            if me.granted:
                return True
            # timed out / closed: withdraw; our departure may make a
            # different tenant's head grantable
            if me in self._waiters:
                self._waiters.remove(me)
            self._grant_ready()
            return False

    def _grant_ready(self) -> None:  # lint: allow(lock-discipline) — every caller holds _lock
        """Hand free slots to fair-order heads until slots or waiters
        run out; wake everyone iff something changed."""
        granted_any = False
        while self._active < self._slots:
            head = self._grant_head()
            if head is None:
                break
            self._waiters.remove(head)
            head.granted = True
            granted_any = True
            self._active += 1
            self._running[head.tenant] = self._running.get(head.tenant, 0) + 1
            self._advance(head.tenant)
            self.served[head.tenant] = self.served.get(head.tenant, 0) + 1
            m = self._metrics
            if m is not None:
                m.inflight.labels(head.tenant).inc()
        if granted_any:
            self._lock.notify_all()

    def release(self, tenant: str) -> None:
        with self._lock:
            self._active = max(0, self._active - 1)
            self._running[tenant] = max(0, self._running.get(tenant, 0) - 1)
            m = self._metrics
            if m is not None:
                m.inflight.labels(tenant).dec()
            self._grant_ready()
            self._lock.notify_all()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- views -----------------------------------------------------------------

    def served_shares(self) -> dict[str, float]:
        """Fraction of total grants per tenant (the fairness test's
        observable)."""
        with self._lock:
            total = sum(self.served.values())
            if not total:
                return {}
            return {t: n / total for t, n in self.served.items()}
