"""Offload client: IBlsVerifier over the gRPC channel.

The PyTorch port's copy of ``lodestar_tpu/offload/client.py``: the same
routing, deadlines, hedging, breakers, digest checks, span grafting and
audit touchpoint, with the same constants and the same request frames
(bytes-equal, tenant trailer included). Its departures are at the end of
this docstring.

Drop-in replacement for the in-process pools — a BeaconChain configured
with this verifier ships its signature batches to the accelerator host.
Transport failures fail CLOSED: verify_signature_sets raises, the block
import rejects, nothing ever resolves valid on error (reference
`multithread/index.ts:386-393`).

Admission control is LOCAL: the hot
path's `can_accept_work` reads an in-process outstanding-job counter and
cached per-endpoint health — the reference's jobsWorkers counter
semantics (`multithread/index.ts:143-149`, MAX_JOBS) — instead of
issuing a blocking Status RPC per gossip batch. Health is refreshed by a
background probe, and a failed channel is re-dialed with exponential
backoff, so a restarted offload server is picked back up without
operator action.

Multi-endpoint routing: `target` may be one `host:port` or a list. The
probe decodes each server's occupancy Status frame (`decode_status`;
legacy single-byte servers still parse) and every job routes by launch
class — bulk classes (range sync, backfill) avoid SHED_BULK endpoints,
everything avoids REJECT, and ties break toward the least-occupied
server. One saturated host therefore sheds its backfill traffic onto an
idle peer while gossip keeps flowing to both.

Resilience (`offload/resilience.py`): every endpoint carries a circuit
breaker — consecutive verify failures open it and the hot path skips
the endpoint IMMEDIATELY (no dial, no deadline wait) instead of paying
a timeout per block until the probe loop notices; after an exponential
reset delay one half-open trial re-closes or re-opens it. RPC deadlines
are class-aware budgets (`CLASS_DEADLINE_S`): a gossip-block verify
gets 2s and ONE hedged retry on a second endpoint, bulk work keeps the
generous flat timeout. Verdict frames are digest-checked
(`decode_verdict(request=...)`) so a corrupt or spliced reply fails
closed instead of decoding as a verdict. All endpoint state
transitions go through `self._lock`; the probe thread wakes via an
event and is joined on close. With `lodestar_resilience_*` metrics
attached, routed/failover/hedge counts and breaker states export per
endpoint. Breaker outcomes are token-matched: every issued RPC carries
the generation token its `try_acquire` handed out, so a stale pre-open
RPC's late outcome cannot re-open the breaker mid-trial or discard the
trial's success.

Byzantine auditing (`offload/audit.py`): when an `OffloadAuditor` is
attached, every offload-served verdict is offered to its seeded sampler
(one coin flip + a non-blocking queue put — the hot path never waits on
re-verification) and routing becomes trust-aware: the trust EWMA folds
CONTINUOUSLY into the occupancy rank (`_occupancy_key`) — every
contradiction shifts load away gradually, and at trust below
`TRUST_ROUTE_THRESHOLD` the penalty exceeds the whole occupancy scale,
so a sub-threshold endpoint serves only when every trusted sibling is
pinned or gone (the old binary demotion as the limit case). A
QUARANTINED endpoint (caught lying by the auditor's independent
re-check) is skipped like any circuit-open endpoint — but its breaker
ignores probe recoveries until the cool-off elapses or
`unquarantine_endpoint` (the `--offload-unquarantine` admin action)
lifts it.

Multi-tenant + fleet routing: `tenant=` stamps the client's
identity (and the job's launch class) onto verify frames toward
servers that advertised the capability, so the host's per-tenant
quotas and stride-fair scheduling attach to wire identity. The Status
mesh trailer feeds routing a FLEET view: occupancy is the server's
healthy-chip aggregate and in-flight work is normalized by advertised
chip capacity, so one 8-chip host outranks a single-die host at equal
die load. A server-side admission shed (`OffloadShed`) fails the job
closed but does NOT charge the endpoint's breaker — hedge-class work
immediately fails over to a sibling.

Departures from the JAX package's client:

(e) grpc is not imported at module import, and a target is dialed
    lazily. The JAX `_connect` opens `grpc.insecure_channel` for every
    target, even one whose stubs `transport_wrapper` replaces (the
    port's `server.local_transports`). Here each endpoint holds a
    `_LazyChannel`: the stubs handed to the wrapper import grpc and open
    the channel on their FIRST call. So a target that `local_transports`
    serves never dials, and a host without grpc drives the client
    in-process. A target that really must dial on such a host raises
    the ImportError out of `verify_signature_sets` (the breaker's
    outcome still resolves); it is not turned into a verdict or an
    `OffloadError`, and the probe marks the endpoint unhealthy and logs
    it. Transport errors are caught as `offload.transport_errors()`:
    the port's `TransportError` (the fault harness raises it), plus
    `grpc.RpcError` once grpc is imported.
(f) `metrics=` stays duck-typed (None by default): the JAX package's
    `ResilienceMetrics` needs `prometheus_client`, which the port does
    not use.

Deadlines in-process: on a socket the class deadline is gRPC's — a call
past it raises DEADLINE_EXCEEDED at the client, which fails over or
hedges, and the server sees the same deadline through `time_remaining()`.
Over `local_transports` (`LocalStub`) nothing cuts a call at its
deadline: the server reads `time_remaining()` only for its slot-wait shed
(`slot_wait_margin_s`), so a slow backend launch returns LATE with its
verdict instead of raising, the sequential path's next attempt starts
only after it, and the concurrent hedge's first attempt keeps running
after the hedge wins (its outcome still lands in the breaker and the
auditor). No timer is added for this: the JAX client has none either.
"""

from __future__ import annotations

import asyncio
import threading
import time

from .. import tracing
from ..chain.bls.interface import IBlsVerifier, VerifySignatureOpts
from ..crypto.bls.api import SignatureSet
from ..logger import get_logger
from ..scheduler import BULK_CLASSES, AdmissionState, PriorityClass

from . import (
    OffloadError,
    OffloadShed,
    decode_status,
    decode_verdict,
    encode_sets,
    encode_tenant_trailer,
    transport_errors,
    validate_tenant,
)
from .audit import TRUST_ROUTE_THRESHOLD
from .resilience import (
    CLASS_DEADLINE_S,
    DEFAULT_FAILURE_THRESHOLD,
    DEFAULT_MAX_RESET_TIMEOUT_S,
    DEFAULT_QUARANTINE_COOLOFF_S,
    DEFAULT_RESET_TIMEOUT_S,
    HEDGE_CLASSES,
    BreakerState,
    CircuitBreaker,
    deadline_for,
)
from .server import STATUS_METHOD, VERIFY_METHOD

__all__ = ["BlsOffloadClient"]

DEFAULT_TIMEOUT_S = 30.0
MAX_OUTSTANDING_JOBS = 512  # reference MAX_JOBS (`multithread/index.ts:62`)
HEALTH_PROBE_INTERVAL_S = 2.0
RECONNECT_BACKOFF_S = (0.5, 1.0, 2.0, 4.0, 8.0)  # then stays at the max

_UNKNOWN_OCCUPANCY = 500  # rank servers that never reported between idle and pinned

#: sentinel distinguishing "caller didn't specify a cool-off" from an
#: explicit None (= indefinite quarantine, operator lift required)
_UNSET_COOLOFF: object = object()


def _identity(b: bytes) -> bytes:
    return b


class _LazyChannel:
    """A target's gRPC channel, opened on the first call of one of its
    stubs (departure (e)): grpc is imported there, not at module import,
    so a target whose stubs the transport wrapper replaces never dials.
    `close()` closes the channel if it was opened; a stub that already
    holds the closed channel's callable then fails like a call on a
    closed gRPC channel."""

    def __init__(self, target: str) -> None:
        self.target = target
        self._lock = threading.Lock()
        self._channel = None  # guarded by: _lock
        self._closed = False  # guarded by: _lock

    def stub(self, method: str) -> "_LazyStub":
        return _LazyStub(self, method)

    def open(self):
        with self._lock:
            if self._channel is None:
                if self._closed:
                    raise ValueError("Cannot invoke RPC on closed channel!")
                import grpc  # ImportError on a host without grpc: raised as it is

                self._channel = grpc.insecure_channel(self.target)
            return self._channel

    def close(self) -> None:
        with self._lock:
            channel, self._channel, self._closed = self._channel, None, True
        if channel is not None:
            channel.close()


class _LazyStub:
    """The unary-unary callable shapes the client uses (`__call__` and
    `.with_call`) over a `_LazyChannel`: the channel's multicallable is
    made on the first call and kept."""

    def __init__(self, channel: _LazyChannel, method: str) -> None:
        self._channel = channel
        self._method = method
        self._call = None

    def _multicallable(self):
        if self._call is None:
            self._call = self._channel.open().unary_unary(
                self._method, request_serializer=_identity, response_deserializer=_identity
            )
        return self._call

    def __call__(self, request: bytes, timeout=None, metadata=None):
        return self._multicallable()(request, timeout=timeout, metadata=metadata)

    def with_call(self, request: bytes, timeout=None, metadata=None):
        return self._multicallable().with_call(request, timeout=timeout, metadata=metadata)


class _Endpoint:
    """One server: channel + stubs + probe-refreshed load/health state.

    Mutable routing state (healthy/admission/occupancy/outstanding) is
    written ONLY under the owning client's `_lock`; the breaker has its
    own internal lock."""

    __slots__ = (
        "target",
        "channel",
        "verify",
        "status",
        "healthy",
        "consecutive_failures",
        "outstanding",
        "occupancy_permille",
        "queue_depth",
        "admission",
        "extended",
        "breaker",
        "digest_seen",
        "was_quarantined",
        "capacity",
        "chips_wedged",
        "tenant_capable",
    )

    def __init__(self, target: str, breaker: CircuitBreaker):
        self.target = target
        self.channel = None
        self.verify = None
        self.status = None
        self.healthy = True  # guarded by: _lock [shared] — optimistic until the first probe
        self.consecutive_failures = 0  # guarded by: probe-thread (single owner)
        self.outstanding = 0  # guarded by: _lock [shared]
        self.occupancy_permille: int | None = None  # guarded by: _lock [shared]
        self.queue_depth: int | None = None  # guarded by: _lock [shared]
        self.admission = AdmissionState.ACCEPT  # guarded by: _lock [shared]
        self.extended = False  # guarded by: _lock [shared]
        self.breaker = breaker
        # sticky: once this server has spoken the digest-checked verdict
        # format, a bare legacy frame is a truncation/downgrade, not compat
        self.digest_seen = False  # guarded by: _lock [shared]
        # set when THIS client quarantined the endpoint: gates the
        # rehabilitation cleanup so a fresh CLOSED endpoint at startup
        # can't wipe a persisted record before the node re-applies it
        self.was_quarantined = False  # guarded by: _lock [shared]
        # fleet view from the Status mesh trailer: advertised serving
        # capacity in chips (wedged chips dropped), wedged-chip count,
        # and whether verify frames may carry the tenant trailer.
        # tenant_capable is STICKY one-way like digest_seen: once the
        # server advertised it, a bare probe (or downgrade) must not
        # strip tenant identity off subsequent frames
        self.capacity = 1  # guarded by: _lock [shared]
        self.chips_wedged = 0  # guarded by: _lock [shared]
        self.tenant_capable = False  # guarded by: _lock [shared]

    def state(self) -> dict:  # lint: allow(lock-discipline) — sole caller is endpoint_states(), which holds the owning client's _lock
        return {
            "target": self.target,
            "healthy": self.healthy,
            "outstanding": self.outstanding,
            "occupancy_permille": self.occupancy_permille,
            "queue_depth": self.queue_depth,
            "admission": self.admission.label,
            "extended": self.extended,
            "breaker": self.breaker.state().label,
            "capacity": self.capacity,
            "chips_wedged": self.chips_wedged,
            "tenant_capable": self.tenant_capable,
        }


#: permille-scale routing penalty at zero trust. Derived from the route
#: threshold so the continuous fold preserves the old binary demotion in
#: the limit: at trust == TRUST_ROUTE_THRESHOLD the penalty equals the
#: full occupancy scale (1000) — a sub-threshold endpoint ranks behind
#: ANY fully-trusted endpoint, however loaded — while trust between the
#: threshold and 1.0 shifts load away GRADUALLY as contradictions
#: accumulate instead of at a cliff.
TRUST_PENALTY_SPAN = int(round(1000.0 / (1.0 - TRUST_ROUTE_THRESHOLD)))


def _occupancy_key(ep: _Endpoint, trust: float = 1.0) -> tuple[int, int]:  # lint: allow(lock-discipline) — sort key for _pick_endpoint, which holds the client's _lock
    """Routing rank: fleet occupancy + continuous trust penalty first,
    then in-flight jobs normalized by the endpoint's advertised chip
    capacity — an 8-chip host with 8 outstanding jobs has the headroom
    of a single-die host with 1."""
    occ = (
        ep.occupancy_permille if ep.occupancy_permille is not None else _UNKNOWN_OCCUPANCY
    )
    penalty = int((1.0 - max(0.0, min(1.0, trust))) * TRUST_PENALTY_SPAN)
    cap = max(1, ep.capacity)
    return (occ + penalty, (ep.outstanding * 1000) // cap)


class BlsOffloadClient(IBlsVerifier):
    def __init__(
        self,
        target: str | list[str] | tuple[str, ...],
        *,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        max_outstanding: int = MAX_OUTSTANDING_JOBS,
        probe_interval_s: float = HEALTH_PROBE_INTERVAL_S,
        breaker_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        breaker_reset_s: float = DEFAULT_RESET_TIMEOUT_S,
        breaker_max_reset_s: float = DEFAULT_MAX_RESET_TIMEOUT_S,
        class_deadlines: dict[PriorityClass, float] | None = None,
        hedge_classes: frozenset[PriorityClass] | None = None,
        hedge_delay_ms: float | None = None,
        metrics=None,
        transport_wrapper=None,
        auditor=None,
        quarantine_cooloff_s: float | None = DEFAULT_QUARANTINE_COOLOFF_S,
        tenant: str | None = None,
        breaker_clock=None,
    ) -> None:
        targets = [target] if isinstance(target, str) else list(target)
        if not targets:
            raise ValueError("at least one offload target required")
        self.target = targets[0]  # primary, kept for single-endpoint callers
        self.targets = targets
        self.timeout_s = timeout_s
        self.max_outstanding = max_outstanding
        self.probe_interval_s = probe_interval_s
        self.log = get_logger(name="lodestar.offload.client")
        # duck-typed resilience metrics (routed, failovers, hedges,
        # hedge_wins, shed, breaker_state, breaker_transitions) or None
        self._metrics = metrics
        # fault-injection seam (testing/faults.py): called as
        # wrapper(target, method_name, callable) -> callable around every
        # stub the client dials
        self._transport_wrapper = transport_wrapper
        # OffloadAuditor (offload/audit.py) or None: sampled verdicts are
        # cross-verified off the hot path; Byzantine events quarantine
        # the endpoint through the callback bound here
        self._auditor = auditor
        self.quarantine_cooloff_s = quarantine_cooloff_s
        # multi-tenant identity stamped onto verify frames — but only
        # toward endpoints whose Status advertised the capability, so a
        # legacy server keeps seeing bit-exact legacy frames. Validated
        # HERE: a bad identity (empty, >255 bytes) must be a startup
        # error, not a per-verify outage
        if tenant is not None:
            validate_tenant(tenant)
        self.tenant = tenant
        if auditor is not None:
            auditor.bind(self.quarantine_endpoint)
        self._class_deadlines = dict(class_deadlines or CLASS_DEADLINE_S)
        self._hedge_classes = HEDGE_CLASSES if hedge_classes is None else hedge_classes
        # true-hedge trigger (--offload-hedge-delay-ms): with a delay
        # set, a hedge-class RPC still pending past it fires a CONCURRENT
        # second attempt and the first answer wins. None (the default)
        # keeps the sequential retry-after-failure behavior.
        if hedge_delay_ms is not None and hedge_delay_ms < 0:
            raise ValueError(f"hedge_delay_ms must be >= 0, got {hedge_delay_ms}")
        self._hedge_delay_s = None if hedge_delay_ms is None else hedge_delay_ms / 1000.0
        self._lock = threading.Lock()
        self._outstanding = 0  # guarded by: _lock
        self._closed = False  # guarded by: close-only (one-way flag; stale readers make one last doomed RPC)
        self._wake = threading.Event()  # close() wakes the probe thread
        self._endpoints = []
        for t in targets:
            ep = _Endpoint(
                t,
                CircuitBreaker(
                    failure_threshold=breaker_threshold,
                    reset_timeout_s=breaker_reset_s,
                    max_reset_timeout_s=breaker_max_reset_s,
                    # injectable for deterministic tests (SimClock);
                    # None keeps the real monotonic clock
                    clock=breaker_clock if breaker_clock is not None else time.monotonic,
                ),
            )
            # the closure must not take self._lock: breaker transitions
            # fire while the verify thread may hold it -> metrics/log only
            ep.breaker._on_transition = self._breaker_transition_sink(ep)
            self._endpoints.append(ep)
        for ep in self._endpoints:
            self._connect(ep)
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="offload-health-probe", daemon=True
        )
        self._probe_thread.start()

    # -- channel lifecycle ----------------------------------------------------

    def _connect(self, ep: _Endpoint) -> None:
        # lazy: nothing dials until a stub is called (departure (e))
        ep.channel = _LazyChannel(ep.target)
        verify = ep.channel.stub(VERIFY_METHOD)
        status = ep.channel.stub(STATUS_METHOD)
        if self._transport_wrapper is not None:
            verify = self._transport_wrapper(ep.target, "verify", verify)
            status = self._transport_wrapper(ep.target, "status", status)
        ep.verify = verify
        ep.status = status

    def _reconnect(self, ep: _Endpoint) -> None:
        try:
            ep.channel.close()
        except Exception:
            pass
        self._connect(ep)

    def _breaker_transition_sink(self, ep: _Endpoint):
        def sink(old: BreakerState, new: BreakerState) -> None:
            level = self.log.warn if new is BreakerState.OPEN else self.log.info
            level(
                "offload breaker transition",
                {"target": ep.target, "from": old.label, "to": new.label},
            )
            m = self._metrics
            if m is not None:
                m.breaker_state.labels(ep.target).set(int(new))
                m.breaker_transitions.labels(ep.target, new.label).inc()

        return sink

    def _probe_one(self, ep: _Endpoint) -> bool:
        """One Status probe. Returns False only on TRANSPORT failure —
        a live server reporting REJECT is unhealthy for routing purposes
        (ep.healthy False) but its channel is fine: no reconnect, no
        backoff, keep probing at the normal cadence so recovery from a
        transient occupancy spike is noticed within one interval. Probes
        run serially on the one probe thread, so the timeout tracks the
        probe interval — a blackholed endpoint delays its siblings'
        refresh by at most one short timeout, not a full 2s."""
        timeout = min(2.0, max(0.5, self.probe_interval_s))
        try:
            out = ep.status(b"", timeout=timeout)
            frame = decode_status(out)
        except (*transport_errors(), OffloadError):
            with self._lock:
                ep.healthy = False
            return False
        except ImportError as e:
            # a target that must dial, on a host without grpc (departure
            # (e)): unreachable from here, said in the log; a verify
            # routed to it raises the ImportError to its caller
            if ep.consecutive_failures == 0:
                self.log.error(
                    "offload target needs grpc to dial", {"target": ep.target, "error": str(e)}
                )
            with self._lock:
                ep.healthy = False
            return False
        # transport up; the binary gate keeps the old health semantics
        # (a server that REJECTs everything counts as not-accepting).
        # A transport RECOVERY (failed probes, then success) releases an
        # open breaker's reset wait: the next verify becomes the
        # half-open trial immediately, so a restarted server is
        # re-adopted within one probe interval. A probe that never
        # failed is NOT recovery evidence — a gray-failing server
        # (Status up, verify sick) must keep its exponential trial
        # schedule, not get a fresh trial per probe interval.
        if ep.consecutive_failures > 0:
            ep.breaker.note_probe_success()
        with self._lock:
            was_healthy = ep.healthy
            ep.healthy = frame.can_accept
            ep.admission = frame.admission
            ep.occupancy_permille = frame.occupancy_permille
            ep.queue_depth = frame.queue_depth
            ep.extended = frame.extended
            # fleet view: a wedged/quarantined chip drops out of the
            # advertised capacity within one probe interval
            ep.capacity = frame.capacity
            ep.chips_wedged = sum(1 for c in frame.chips if c.wedged)
            if frame.tenant_capable:
                ep.tenant_capable = True  # sticky, like digest_seen
        if not was_healthy and frame.can_accept:
            self.log.info(f"offload service {ep.target} is back")
        # the quarantine gauge is event-driven on entry but a cool-off
        # expires LAZILY (the next trial clears the flag with no client
        # code running) — refresh it here so the dashboard converges
        # within one probe interval of the self-heal, and drop the
        # persisted record once the endpoint re-earned CLOSED (else
        # every restart re-imposes a quarantine the cool-off contract
        # already resolved)
        if self._auditor is not None:
            quarantined = ep.breaker.is_quarantined
            rehabilitated = False
            with self._lock:
                if (
                    ep.was_quarantined
                    and not quarantined
                    and ep.breaker.state() is BreakerState.CLOSED
                ):
                    ep.was_quarantined = False
                    rehabilitated = True
            # auditor calls outside the client lock: note_rehabilitated
            # does file I/O and must not stall the hot path's routing
            self._auditor.note_quarantine(ep.target, quarantined)
            if rehabilitated:
                self._auditor.note_rehabilitated(ep.target)
        return True

    def _probe_loop(self) -> None:
        """Background status probe + reconnect-with-backoff. Runs in its
        own thread so the asyncio loop and the hot path never wait on it.
        Each endpoint keeps its OWN next-probe deadline — healthy ones
        refresh every probe_interval_s, failed ones back off individually
        — so one dead endpoint's probe timeouts neither stall the healthy
        endpoints' occupancy refresh nor get re-dialed ahead of their
        backoff. close() sets `_wake`, so the loop exits promptly instead
        of sleeping out the interval against a closed channel."""
        # indexed by endpoint position: duplicate targets stay independent
        next_at = [0.0] * len(self._endpoints)
        while not self._closed:
            now = time.monotonic()
            for i, ep in enumerate(self._endpoints):
                if now < next_at[i]:
                    continue
                if self._probe_one(ep):
                    ep.consecutive_failures = 0
                    next_at[i] = time.monotonic() + self.probe_interval_s
                else:
                    idx = min(ep.consecutive_failures, len(RECONNECT_BACKOFF_S) - 1)
                    ep.consecutive_failures += 1
                    if self._closed:
                        return
                    # never tear down a channel with verifications in
                    # flight: a transient probe timeout must not abort
                    # valid work — in-flight RPCs fail (or succeed) on
                    # their own merits. The lock covers the read only:
                    # a check-then-act window remains in which the hot
                    # path admits an RPC onto the channel _reconnect is
                    # about to close. That RPC fails into the breaker /
                    # hedge / degradation machinery rather than
                    # silently, and the window only exists for an
                    # endpoint that just failed a probe, which routing
                    # already deprioritizes.
                    with self._lock:
                        idle = ep.outstanding == 0
                    if idle:
                        self._reconnect(ep)
                    next_at[i] = time.monotonic() + RECONNECT_BACKOFF_S[idx]
            if self._closed:
                return
            wake = min(next_at) - time.monotonic()
            self._wake.wait(min(self.probe_interval_s, max(0.02, wake)))

    # -- routing ---------------------------------------------------------------

    def _trust(self, target: str) -> float:
        """Audit trust EWMA for routing (1.0 when no auditor runs)."""
        return 1.0 if self._auditor is None else self._auditor.trust_value(target)

    def _pick_endpoint(
        self, priority: PriorityClass, exclude: tuple[_Endpoint, ...] = ()
    ) -> tuple[_Endpoint, int | None] | None:
        """Least-occupied closed-breaker healthy endpoint whose admission
        state admits this class; bulk work skips SHED_BULK servers while
        any endpoint still ACCEPTs. Degrades to any-healthy, then to any
        closed-breaker endpoint (the verify RPC then fails closed on its
        own). Endpoints whose breaker is open are skipped WITHOUT dialing
        — quarantined ones stay skipped through their whole cool-off —
        and when none is closed, at most one half-open trial is
        admitted; None means every endpoint is circuit-open (caller
        fails fast and the degradation chain takes over). Returns the
        endpoint plus the breaker generation token its admission handed
        out, so the RPC's outcome is matched to this exact attempt.

        Trust-aware: with an auditor attached, the trust EWMA folds
        continuously into the occupancy rank — load shifts away
        gradually as contradictions accumulate, and a sub-threshold
        endpoint serves only when every trusted candidate is pinned or
        gone. (Quarantine handles the caught-lying case outright; low
        trust covers the gray zone of arbitrated helper-vs-helper
        disagreements.)

        Recovery: an OPEN endpoint whose reset delay elapsed gets its
        half-open trial EVEN while closed endpoints exist — otherwise a
        briefly-dead endpoint stays circuit-open forever once a sibling
        absorbs all traffic. The breaker's exponential schedule caps the
        cost at one trial request per reset window, only probe-healthy
        endpoints are trialed, and only a first-attempt HEDGE-class
        request is spent as the canary — it retries on a known-good
        endpoint if the trial fails, so no caller-visible error is
        burned on probing (non-hedge classes still trial when no closed
        endpoint exists at all, where there is nothing to lose)."""
        with self._lock:
            pool = [ep for ep in self._endpoints if ep not in exclude]
            if not pool:
                return None
            closed = [ep for ep in pool if ep.breaker.state() is BreakerState.CLOSED]
            if not exclude and priority in self._hedge_classes and len(closed) < len(pool):
                for ep in pool:
                    if (
                        ep not in closed
                        and ep.healthy
                        and ep.breaker.seconds_until_trial() == 0.0
                    ):
                        token = ep.breaker.try_acquire()
                        if token is not None:
                            return ep, token
            if closed:
                healthy = [ep for ep in closed if ep.healthy]
                cands = [ep for ep in healthy if ep.admission is not AdmissionState.REJECT]
                if priority in BULK_CLASSES:
                    accepting = [
                        ep for ep in cands if ep.admission is AdmissionState.ACCEPT
                    ]
                    if accepting:
                        cands = accepting
                if not cands:
                    cands = healthy or closed
                # the chosen breaker can open between the state() read
                # and acquisition (outcomes land without the client
                # lock): retry the NEXT-best candidate so the healthy/
                # admission filters still hold, rather than falling
                # straight to the unfiltered trial scan. Trust folds
                # into the rank CONTINUOUSLY (see _occupancy_key):
                # contradictions shift load away gradually, and a
                # sub-threshold endpoint serves only when every
                # fully-trusted sibling is pinned or gone.
                while cands:
                    best = min(
                        cands, key=lambda e: _occupancy_key(e, self._trust(e.target))
                    )
                    token = best.breaker.try_acquire()
                    if token is not None:
                        return best, token
                    cands = [ep for ep in cands if ep is not best]
            # no closed breaker admitted work: probe the least-loaded
            # endpoint that admits a half-open trial (try_acquire
            # consumes the slot)
            for ep in sorted(
                pool, key=lambda e: _occupancy_key(e, self._trust(e.target))
            ):
                token = ep.breaker.try_acquire()
                if token is not None:
                    return ep, token
            return None

    def endpoint_states(self) -> list[dict]:
        """Probe-refreshed view per endpoint (debugging/metrics/tests)."""
        with self._lock:
            out = []
            for ep in self._endpoints:
                st = ep.state()
                st["quarantined"] = ep.breaker.is_quarantined
                st["trust"] = round(self._trust(ep.target), 4)
                out.append(st)
            return out

    def quarantine_endpoint(
        self, target: str, cooloff_s: "float | None" = _UNSET_COOLOFF, reason: str = ""
    ) -> bool:
        """Byzantine quarantine (the auditor's bound callback, also an
        admin/test entry point): force the endpoint's breaker open with
        the quarantine flag — skipped by routing, immune to probe
        recoveries — until the cool-off elapses or unquarantine. The
        endpoint's in-flight work fails over through normal resilience
        (hedge/degradation chain); nothing is aborted mid-RPC.

        `cooloff_s=None` means INDEFINITE (an auditor configured for
        operator-only lifts passes it through verbatim); omitting the
        argument uses the client's configured cool-off."""
        cool = self.quarantine_cooloff_s if cooloff_s is _UNSET_COOLOFF else cooloff_s
        hit = False
        with self._lock:
            # breaker calls are safe under the client lock (its
            # transition sink is metrics/log only, per the init comment)
            for ep in self._endpoints:
                if ep.target == target:
                    ep.breaker.quarantine(cool)
                    ep.was_quarantined = True
                    hit = True
        if hit:
            self.log.error(
                "offload endpoint QUARANTINED",
                {"target": target, "cooloff_s": cool, "reason": reason or "admin"},
            )
            if self._auditor is not None:
                self._auditor.note_quarantine(target, True)
        return hit

    def unquarantine_endpoint(self, target: str) -> bool:
        """Operator lift (--offload-unquarantine): clears the flag and
        cool-off; the endpoint still re-earns CLOSED through one
        half-open trial. Also clears the persisted quarantine record so
        a restart doesn't re-apply it."""
        hit = False
        with self._lock:
            for ep in self._endpoints:
                if ep.target == target:
                    ep.was_quarantined = False  # lift handles the persistence
                    if ep.breaker.is_quarantined:
                        ep.breaker.unquarantine()
                        hit = True
        if hit:
            self.log.warn("offload endpoint quarantine lifted", {"target": target})
        if self._auditor is not None:
            self._auditor.note_quarantine(target, False)
            self._auditor.clear_quarantine(target)
        return hit

    def _deadline_for(self, priority: PriorityClass) -> float:
        return deadline_for(priority, cap=self.timeout_s, deadlines=self._class_deadlines)

    # -- IBlsVerifier ----------------------------------------------------------

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        """One RPC per job; blocking stub call moved off the event loop.
        Raises OffloadError on transport/server error (fail closed). The
        RPC deadline is the class budget; hedge-class work that fails on
        its first endpoint retries ONCE on a different one before the
        error propagates (to the degradation chain, when configured)."""
        n_sets = len(sets)
        priority = (
            PriorityClass(opts.priority)
            if opts is not None and opts.priority is not None
            else PriorityClass.API
        )
        frame = encode_sets(list(sets))
        # tenant-stamped variant for capable endpoints: the trailer is
        # a pure suffix, so the set bytes are serialized once (a hedge
        # pair may legitimately send different framings; each attempt
        # digest-checks against the exact bytes it sent)
        frame_tenant = (
            frame + encode_tenant_trailer(self.tenant, priority)
            if self.tenant is not None
            else None
        )
        deadline = self._deadline_for(priority)
        # trace context rides the call's metadata so server-side device
        # spans come home in trailing metadata and stitch under this RPC;
        # captured here because the executor thread has no contextvars
        trace_hdr = tracing.context_header()
        trace_parent = tracing.current()

        # hedge only when a second endpoint is actually USABLE right now
        # — splitting the budget against a circuit-open sibling would
        # halve the only viable attempt's deadline for nothing
        with self._lock:
            usable = sum(
                1 for ep in self._endpoints if ep.healthy and not ep.breaker.is_open
            )
        if (
            self._hedge_delay_s is not None
            and priority in self._hedge_classes
            and usable > 1
        ):
            # true hedging: concurrent second attempt after the delay,
            # first answer wins, full budget per attempt (no splitting)
            return await self._verify_hedged(
                frame, frame_tenant, n_sets, priority, deadline, trace_hdr, trace_parent
            )
        max_attempts = 2 if priority in self._hedge_classes and usable > 1 else 1
        tried: tuple[_Endpoint, ...] = ()
        last_err: OffloadError | None = None
        loop = asyncio.get_event_loop()
        t_start = time.monotonic()
        attempt = 0
        # error attempts are bounded by max_attempts; a server-side
        # admission SHED does NOT consume one — the endpoint explicitly
        # told us to go elsewhere, so EVERY class may try a sibling
        # (bounded by the untried-endpoint pool via `exclude` and by
        # the class deadline, not by the hedge budget)
        while attempt < max_attempts:
            # the class budget covers ALL attempts — a slow-but-alive
            # first endpoint must not double the stated slot-deadline
            # bound. The first attempt gets an equal share; a later one
            # gets whatever the earlier left (a fast transport failure
            # donates its unused share to the hedge).
            remaining = deadline - (time.monotonic() - t_start)
            if remaining <= 0:
                break
            attempt_deadline = min(deadline / max_attempts, remaining) if not tried else remaining
            picked = self._pick_endpoint(priority, exclude=tried)
            if picked is None:
                break
            ep, token = picked
            if attempt > 0:
                # a genuine hedge: a prior attempt FAILED and this class
                # earned a retry. A shed-driven sibling attempt is not a
                # hedge (it is logged in the shed handler) — counting it
                # here would make shed storms read as hedge storms
                self._note_hedge(tried[0], ep, priority, trace_parent)
            tried = tried + (ep,)
            m = self._metrics
            if m is not None:
                m.routed.labels(ep.target).inc()
            with self._lock:
                self._outstanding += 1
                ep.outstanding += 1
            # tenant-stamped frame only toward capable endpoints: a
            # legacy server keeps seeing the bit-exact legacy frame
            use_frame = (
                frame_tenant
                # lint: allow(lock-discipline) — one-way sticky capability bit: a stale False sends one more legacy frame, which every server parses
                if frame_tenant is not None and ep.tenant_capable
                else frame
            )
            try:
                verdict = await loop.run_in_executor(
                    None,
                    self._call_endpoint,
                    ep, token, use_frame, n_sets, priority, attempt_deadline, trace_hdr, trace_parent,
                )
                if attempt > 0 and m is not None:
                    m.hedge_wins.labels(priority.label).inc()
                return verdict
            except OffloadShed as e:
                # the server refused admission (tenant quota/overload):
                # fail over without charging the endpoint — it is alive
                last_err = e
                self.log.info(
                    "offload shed failover",
                    {"from": ep.target, "class": priority.label, "reason": str(e)[:80]},
                )
                if m is not None:
                    m.shed.labels("server_shed").inc()
            except OffloadError as e:
                last_err = e
                attempt += 1
                if m is not None:
                    m.failovers.labels(ep.target).inc()
            finally:
                with self._lock:
                    self._outstanding -= 1
                    ep.outstanding -= 1
        if last_err is not None:
            raise last_err
        raise OffloadError("no offload endpoint admits work (all breakers open)")

    def _launch_attempt(
        self,
        loop,
        ep: "_Endpoint",
        token: "int | None",
        frame: bytes,
        frame_tenant: "bytes | None",
        n_sets: int,
        priority: PriorityClass,
        attempt_deadline: float,
        trace_hdr,
        trace_parent,
    ):
        """Launch one verify attempt on the executor WITHOUT awaiting it
        (the hedged path races these). Outstanding counters settle in a
        done-callback so a discarded loser still balances the books, and
        its exception is retrieved there — breaker/audit accounting for
        losers already happened inside `_call_endpoint` on the executor
        thread, so discarding the future drops only the verdict."""
        if self._metrics is not None:
            self._metrics.routed.labels(ep.target).inc()
        use_frame = (
            frame_tenant
            # lint: allow(lock-discipline) — one-way sticky capability bit: a stale False sends one more legacy frame, which every server parses
            if frame_tenant is not None and ep.tenant_capable
            else frame
        )
        with self._lock:
            self._outstanding += 1
            ep.outstanding += 1
        fut = loop.run_in_executor(
            None,
            self._call_endpoint,
            ep, token, use_frame, n_sets, priority, attempt_deadline, trace_hdr, trace_parent,
        )

        def _settle(f, ep=ep):
            with self._lock:
                self._outstanding -= 1
                ep.outstanding -= 1
            if not f.cancelled():
                f.exception()  # retrieved so a discarded loser never warns

        fut.add_done_callback(_settle)
        return fut

    async def _verify_hedged(
        self,
        frame: bytes,
        frame_tenant: "bytes | None",
        n_sets: int,
        priority: PriorityClass,
        deadline: float,
        trace_hdr,
        trace_parent,
    ) -> bool:
        """True hedged request: the primary attempt gets the FULL class
        budget; if it is still in flight past the hedge delay, a second
        concurrent attempt fires on a different endpoint and the first
        verdict wins. The loser is discarded, not interrupted — executor
        RPCs cannot be cancelled mid-flight, so its breaker and audit
        accounting (inside `_call_endpoint`) stand while its verdict is
        dropped. At most ONE delay-triggered hedge fires per job; a
        server-side shed spawns a replacement without consuming the
        error budget (the endpoint explicitly redirected us), a
        transport/server error consumes one of two error attempts —
        the same failover bound as the sequential path."""
        loop = asyncio.get_event_loop()
        t_start = time.monotonic()
        m = self._metrics
        tried: tuple[_Endpoint, ...] = ()
        ep_of: dict = {}
        pending: set = set()
        hedge_fired = False
        hedge_fut = None  # the delay-triggered attempt, if one fired
        error_attempts = 0
        last_err: OffloadError | None = None

        def _launch():
            nonlocal tried
            picked = self._pick_endpoint(priority, exclude=tried)
            if picked is None:
                return None
            ep, token = picked
            tried = tried + (ep,)
            remaining = deadline - (time.monotonic() - t_start)
            fut = self._launch_attempt(
                loop, ep, token, frame, frame_tenant, n_sets,
                priority, remaining, trace_hdr, trace_parent,
            )
            ep_of[fut] = ep
            pending.add(fut)
            return fut

        primary = _launch()
        if primary is None:
            raise OffloadError("no offload endpoint admits work (all breakers open)")
        while pending:
            remaining = deadline - (time.monotonic() - t_start)
            if remaining <= 0:
                break
            timeout = (
                remaining
                if hedge_fired
                else min(remaining, self._hedge_delay_s)
            )
            done, still = await asyncio.wait(
                pending, timeout=timeout, return_when=asyncio.FIRST_COMPLETED
            )
            pending.clear()
            pending.update(still)
            if not done:
                # hedge delay elapsed with the primary still in flight:
                # fire AT MOST one delay-triggered hedge (further waits
                # run out the remaining budget on whatever is in flight)
                if not hedge_fired:
                    hedge_fired = True
                    prev = tried[0]
                    fut = _launch()
                    if fut is not None:
                        hedge_fut = fut
                        self._note_hedge(prev, ep_of[fut], priority, trace_parent)
                continue
            winners = [f for f in done if f.exception() is None]
            if winners:
                # both may land in the same wake-up: prefer the primary
                # so hedge_wins counts only races the hedge actually won
                # (an error-failover replacement winning is a failover,
                # already counted as one, not a hedge win)
                win = primary if primary in winners else winners[0]
                if win is hedge_fut and m is not None:
                    m.hedge_wins.labels(priority.label).inc()
                return win.result()
            for fut in done:
                err = fut.exception()
                ep = ep_of[fut]
                if isinstance(err, OffloadShed):
                    # admission refusal: fail over without charging the
                    # endpoint or the error budget — bounded by the
                    # untried-endpoint pool via `tried`
                    last_err = err
                    self.log.info(
                        "offload shed failover",
                        {"from": ep.target, "class": priority.label, "reason": str(err)[:80]},
                    )
                    if m is not None:
                        m.shed.labels("server_shed").inc()
                    if not pending:
                        _launch()
                elif isinstance(err, OffloadError):
                    last_err = err
                    error_attempts += 1
                    if m is not None:
                        m.failovers.labels(ep.target).inc()
                    if not pending and error_attempts < 2:
                        _launch()
                else:
                    raise err
        if last_err is not None:
            raise last_err
        raise OffloadError("offload verify budget exhausted before any verdict")

    def _note_hedge(
        self, first: _Endpoint, second: _Endpoint, priority: PriorityClass, trace_parent
    ) -> None:
        self.log.info(
            "offload hedge retry",
            {"from": first.target, "to": second.target, "class": priority.label},
        )
        if self._metrics is not None:
            self._metrics.hedges.labels(priority.label).inc()
        if trace_parent is not None:
            now = time.monotonic_ns()
            tracing.record(
                trace_parent, "offload_hedge", now, now,
                {"from": first.target, "to": second.target, "class": priority.label},
            )

    def _call_endpoint(
        self,
        ep: _Endpoint,
        token: int | None,
        frame: bytes,
        n_sets: int,
        priority: PriorityClass,
        deadline: float,
        trace_hdr,
        trace_parent,
    ) -> bool:
        """One verify RPC on `ep` (runs on an executor thread). Breaker
        outcome and endpoint health are recorded on every exit path,
        token-matched to the attempt that acquired admission — a stale
        pre-open RPC resolving late cannot perturb a half-open trial."""
        # clock reads only on the traced path: untraced RPCs pay just
        # the trace_hdr None-checks
        t0 = time.monotonic_ns() if trace_hdr is not None else 0
        grpc_call = None
        err: str | None = None
        try:
            if trace_hdr is not None:
                resp, grpc_call = ep.verify.with_call(
                    frame,
                    timeout=deadline,
                    metadata=((tracing.TRACE_CONTEXT_KEY, trace_hdr),),
                )
            else:
                resp = ep.verify(frame, timeout=deadline)
            # may raise OffloadError: server error frame, malformed frame,
            # or a digest that doesn't bind this request to this verdict —
            # trailing spans still came home and must be grafted below
            # lint: allow(lock-discipline) — executor-thread read of a one-way sticky flag: a stale False only re-admits legacy framing for an RPC already in flight
            verdict = decode_verdict(resp, request=frame, require_digest=ep.digest_seen)
            ep.breaker.record_success(token)
            with self._lock:
                ep.healthy = True
                if len(resp) > 1:
                    ep.digest_seen = True
            # Byzantine audit touchpoint: one seeded coin flip and a
            # non-blocking enqueue — re-verification happens on the
            # auditor's own thread, never on this (hot-path) one
            if self._auditor is not None:
                self._auditor.observe(
                    ep.target, frame, n_sets, verdict, priority, trace_hdr
                )
            return verdict
        except transport_errors() as e:
            err = str(e.code())
            ep.breaker.record_failure(token)
            with self._lock:
                ep.healthy = False  # probe loop takes over reconnection
            raise OffloadError(f"offload transport: {e.code()}") from e
        except OffloadShed as e:
            # admission shed: the transport and server both answered —
            # a half-open trial PASSED; only the admission said no.
            # Charging the breaker here would blacklist a merely-busy
            # endpoint exactly when siblings need its eventual headroom
            err = f"shed: {e}"[:120]
            ep.breaker.record_success(token)
            raise
        except OffloadError as e:
            err = str(e)[:120]
            # a server answering with error/corrupt frames is sick even
            # though its transport is up: count toward the breaker
            ep.breaker.record_failure(token)
            raise
        except ImportError as e:
            # a dialed target on a host without grpc (departure (e)): the
            # caller's setup, not a verdict and not a transport fault —
            # raised as it is, with the breaker outcome resolved
            err = f"{type(e).__name__}: {e}"[:120]
            ep.breaker.record_failure(token)
            raise
        except Exception as e:
            # anything else (e.g. 'Cannot invoke RPC on closed channel'
            # racing a probe-thread reconnect) MUST still resolve the
            # breaker outcome — a leaked half-open trial slot would
            # blacklist the endpoint forever — and fails closed like
            # every other offload error
            err = f"{type(e).__name__}: {e}"[:120]
            ep.breaker.record_failure(token)
            raise OffloadError(err) from e
        finally:
            # the RPC span is recorded on EVERY exit path — a failing
            # slot's trace is exactly the one that needs its offload leg
            if trace_hdr is not None:
                attrs = {
                    "sets": n_sets,
                    "target": ep.target,
                    "class": priority.label,
                    "deadline_s": deadline,
                }
                if err is not None:
                    attrs["error"] = err
                rpc_span = tracing.record(
                    trace_parent, "offload_rpc", t0, time.monotonic_ns(), attrs
                )
                if grpc_call is not None:
                    try:
                        for k, v in grpc_call.trailing_metadata() or ():
                            if k == tracing.TRACE_SPANS_KEY:
                                tracing.graft_remote_spans(rpc_span, v, t0)
                    except Exception:
                        pass  # tracing must never mask the verdict/error

    def is_down(self) -> bool:
        """True when NO endpoint is viable (unhealthy or circuit-open) —
        the degradation chain's signal to route around this layer.
        Distinct from `can_accept_work`: a saturated-but-alive client is
        NOT down (the processor should shed, not silently degrade every
        gossip verify onto a slower fallback layer)."""
        if self._closed:
            return True
        # lint: allow(lock-discipline) — lock-free hot-path read; a stale healthy bit costs one misrouted admission check, never a verdict
        return not any(ep.healthy and not ep.breaker.is_open for ep in self._endpoints)

    def can_accept_work(self) -> bool:
        """RPC-free admission: in-process outstanding-job counter below the
        cap AND some endpoint both probe-healthy and not circuit-open.
        Sheds load rather than queueing against dead or saturated
        services. The cap is per endpoint (reference MAX_JOBS per pool),
        so adding offload servers adds admitted concurrency."""
        # lint: allow(lock-discipline) — lock-free hot-path read (GIL-atomic int); a torn-by-one count moves admission by one job
        if self._outstanding >= self.max_outstanding * len(self._endpoints):
            return False
        return not self.is_down()

    async def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._auditor is not None:
            # the audit worker may be mid-re-verification (seconds of
            # CPU on a bulk frame): join it off the event loop, same
            # treatment as the probe join below
            await asyncio.get_event_loop().run_in_executor(None, self._auditor.close)
        probe = self._probe_thread
        if probe.is_alive() and probe is not threading.current_thread():
            # probe RPC timeouts are <= 2s, so the join is bounded; run it
            # off the event loop
            await asyncio.get_event_loop().run_in_executor(None, probe.join, 5.0)
        for ep in self._endpoints:
            try:
                ep.channel.close()
            except Exception:
                pass
