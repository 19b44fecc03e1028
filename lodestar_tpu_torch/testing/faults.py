"""Fault-injection harness for the BLS offload path.

The PyTorch port's copy of ``lodestar_tpu/testing/faults.py``: the same
kinds, rules, windows, seeded draws, schedule export and replay.

The resilience layer's claims — fail-closed under every transport
fault, breaker-fast failover, sound degradation — are only as good as
the faults they were proven against. This module is the deterministic
seam that delivers those faults:

* `FaultInjector.wrap_transport` plugs into `BlsOffloadClient`'s
  `transport_wrapper` hook (alone, or as `local_transports(...,
  wrap=...)` in front of an in-process server) and intercepts every stub
  call the client makes: added latency, deadline blow-through,
  UNAVAILABLE / connection-reset, error frames, full partitions, and
  corrupt or verdict-flipped reply frames.
* `FaultInjector.wrap_backend` wraps a server-side verify backend with
  latency / exception faults (the server turns backend exceptions into
  error frames — the reply-path fault class).
* `partition(target)` / `heal(target)` toggle hard partitions at
  runtime, so an integration test can cut every offload endpoint
  mid-chain and watch the degradation chain keep block import alive.

Injected transport errors without grpc (the one design change): the JAX
file imports grpc at the top and its `InjectedRpcError` subclasses
`grpc.RpcError`, carrying `grpc.StatusCode`s. Here `InjectedRpcError`
subclasses the port's `offload.TransportError` and carries
`offload.StatusCode`s, whose names (and str) are gRPC's; the port's client
catches `offload.transport_errors()` — `TransportError`, plus
`grpc.RpcError` once grpc is imported. So this module, and a client
driven through it in-process, need no grpc.

Determinism: faults fire by per-(target, method) call index against
`FaultRule` windows; probabilistic rules draw from one seeded
`random.Random`, so a chaos soak replays exactly from its seed (under
concurrency the interleaving of coin draws can vary — schedule-window
rules stay exact regardless).

Replayable traces: `schedule()` exports the faults that actually fired
as exact (target, method, call_index) records, and
`FaultInjector.from_trace()` rebuilds an injector whose rules pin every
one of those records to its exact call index — a failed probabilistic
chaos run's fault schedule becomes a deterministic pinned regression
test, independent of RNG draw interleaving. (Payload-level corruption
bytes for CORRUPT_VERDICT still come from the replay injector's own
seeded RNG; the schedule — which fault, on which edge, at which call —
replays exactly.)

Virtual time: `sleep_fn` (default `time.sleep`) is the seam a harness
points at `SimClock.sleep`, so injected latency advances the
simulation's virtual clock instead of stalling the test for real.

Verdict-flip scope: `FLIP_VERDICT` flips the verdict byte of a
well-formed reply IN FLIGHT — the digest check (`decode_verdict`)
catches it and the client fails closed. `LIE_VERDICT` is the byzantine
SERVER: it flips the verdict AND recomputes the digest over the lie,
producing a frame that is indistinguishable from an honest verdict at
the protocol layer — by construction NOTHING in the framing catches
it; only independent re-verification (the audit subsystem's 2G2T-style
random cross-checks, `offload/audit.py`) can.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass

from ..offload import StatusCode, TransportError, encode_verdict

__all__ = ["FaultKind", "FaultRule", "FaultInjector", "InjectedRpcError"]


class FaultKind(enum.Enum):
    LATENCY = "latency"  # sleep delay_s, then proceed (deadline honored)
    DEADLINE = "deadline"  # the RPC blows through its deadline
    UNAVAILABLE = "unavailable"  # transport refuses the call
    RESET = "reset"  # connection reset mid-call
    ERROR_FRAME = "error_frame"  # server answers with an error frame
    CORRUPT_VERDICT = "corrupt_verdict"  # seeded bit-flip/truncation of the reply
    FLIP_VERDICT = "flip_verdict"  # flip the verdict byte, leave the digest
    LIE_VERDICT = "lie_verdict"  # byzantine: flip the verdict AND re-sign the lie
    PARTITION = "partition"  # every call to the target fails instantly


#: kinds the backend wrapper understands (transport-only kinds are
#: rejected loudly rather than silently ignored)
_BACKEND_KINDS = frozenset(
    {FaultKind.LATENCY, FaultKind.DEADLINE, FaultKind.ERROR_FRAME}
)


class InjectedRpcError(TransportError):
    """A `TransportError` the client's transport-error path accepts,
    carrying the injected status code."""


@dataclass(frozen=True)
class FaultRule:
    """One scheduled fault. Matches calls whose per-(target, method)
    index lies in [first_call, last_call] (inclusive; None = open-ended)
    against the given targets/methods (None = all), then fires with
    `probability` using the injector's seeded RNG."""

    kind: FaultKind
    first_call: int = 0
    last_call: int | None = None
    probability: float = 1.0
    delay_s: float = 0.0
    targets: frozenset[str] | None = None
    methods: frozenset[str] | None = None

    def matches(self, target: str, method: str, call_index: int) -> bool:
        if self.targets is not None and target not in self.targets:
            return False
        if self.methods is not None and method not in self.methods:
            return False
        if call_index < self.first_call:
            return False
        if self.last_call is not None and call_index > self.last_call:
            return False
        return True


@dataclass
class _CallRecord:
    target: str
    method: str
    call_index: int
    fault: FaultKind | None
    delay_s: float = 0.0


class FaultInjector:
    """Seeded, scheduled fault delivery through the offload seams."""

    def __init__(
        self,
        rules: tuple[FaultRule, ...] | list[FaultRule] = (),
        seed: int = 0,
        *,
        sleep_fn=None,
    ):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, str], int] = {}
        self._partitioned: set[str] = set()
        self.calls: list[_CallRecord] = []
        self.injected: dict[FaultKind, int] = {k: 0 for k in FaultKind}
        # latency/deadline sleeps go through this seam so a virtual
        # clock (testing/clock.SimClock) can absorb them deterministically
        self._sleep = time.sleep if sleep_fn is None else sleep_fn

    @classmethod
    def from_trace(cls, trace: dict, *, sleep_fn=None) -> "FaultInjector":
        """Rebuild an injector from `export_trace()` output: every
        recorded fault becomes an exact-window rule (first_call ==
        last_call == its call index, pinned to its edge), so the replay
        fires the identical fault schedule with NO probabilistic draws —
        the pinned-regression constructor for a failed chaos run."""
        rules = [
            FaultRule(
                kind=FaultKind(ev["kind"]),
                first_call=int(ev["call_index"]),
                last_call=int(ev["call_index"]),
                delay_s=float(ev.get("delay_s", 0.0)),
                targets=frozenset({ev["target"]}),
                methods=frozenset({ev["method"]}),
            )
            for ev in trace.get("schedule", ())
        ]
        return cls(rules, seed=int(trace.get("seed", 0)), sleep_fn=sleep_fn)

    # -- runtime partition control --------------------------------------------

    def partition(self, target: str = "*") -> None:
        """Cut `target` (or every target) off: all calls fail instantly
        with UNAVAILABLE until heal()."""
        with self._lock:
            self._partitioned.add(target)

    def heal(self, target: str = "*") -> None:
        with self._lock:
            self._partitioned.discard(target)
            if target == "*":
                self._partitioned.clear()

    def is_partitioned(self, target: str) -> bool:
        with self._lock:
            return "*" in self._partitioned or target in self._partitioned

    # -- bookkeeping -----------------------------------------------------------

    def calls_to(self, target: str, method: str | None = None) -> int:
        with self._lock:
            return sum(
                1
                for c in self.calls
                if c.target == target and (method is None or c.method == method)
            )

    def _next_fault(self, target: str, method: str) -> tuple[FaultKind | None, FaultRule | None, int]:
        """Advance the per-(target, method) call counter and decide the
        fault (first matching rule wins) for this call."""
        with self._lock:
            key = (target, method)
            idx = self._counters.get(key, 0)
            self._counters[key] = idx + 1
            if "*" in self._partitioned or target in self._partitioned:
                self.calls.append(_CallRecord(target, method, idx, FaultKind.PARTITION))
                self.injected[FaultKind.PARTITION] += 1
                return FaultKind.PARTITION, None, idx
            for rule in self.rules:
                if rule.matches(target, method, idx) and (
                    rule.probability >= 1.0 or self._rng.random() < rule.probability
                ):
                    self.calls.append(
                        _CallRecord(target, method, idx, rule.kind, rule.delay_s)
                    )
                    self.injected[rule.kind] += 1
                    return rule.kind, rule, idx
            self.calls.append(_CallRecord(target, method, idx, None))
            return None, None, idx

    # -- trace export / replay -------------------------------------------------

    def schedule(self) -> list[dict]:
        """The faults that actually FIRED, in firing order, as exact
        (target, method, call_index) records — the SCHEDULE artifact a
        chaos ledger embeds and `from_trace()` replays. Pure data
        (JSON-able), stable field order, no RNG state."""
        with self._lock:
            return [
                {
                    "target": c.target,
                    "method": c.method,
                    "call_index": c.call_index,
                    "kind": c.fault.value,
                    "delay_s": c.delay_s,
                }
                for c in self.calls
                if c.fault is not None
            ]

    def export_trace(self) -> dict:
        """Self-contained replay artifact: the seed (for payload-level
        corruption draws) plus the exact fault schedule. Feed the dict —
        or its JSON round-trip — to `FaultInjector.from_trace()`."""
        return {"seed": self.seed, "schedule": self.schedule()}

    def _corrupt(self, data: bytes) -> bytes:
        """Seeded corruption: flip one bit, truncate, or extend."""
        with self._lock:
            mode = self._rng.randrange(3)
            if mode == 0 and data:  # bit flip
                i = self._rng.randrange(len(data))
                bit = 1 << self._rng.randrange(8)
                return data[:i] + bytes([data[i] ^ bit]) + data[i + 1 :]
            if mode == 1 and len(data) > 1:  # truncate
                return data[: self._rng.randrange(1, len(data))]
            return data + bytes([self._rng.randrange(256)])  # extend

    # -- transport seam --------------------------------------------------------

    def wrap_transport(self, target: str, method: str, fn):
        """`BlsOffloadClient(transport_wrapper=injector.wrap_transport)`
        — returns a callable supporting both `__call__` and `.with_call`
        (the shapes `grpc.UnaryUnaryMultiCallable` exposes that the
        client uses)."""
        return _FaultyCallable(self, target, method, fn)

    def _pre_call(
        self, target: str, method: str, timeout: float | None, request: bytes = b""
    ):
        """Faults decided before the wire: may sleep, may raise. Returns
        (response_override, response_mutator). `request` feeds the
        LIE_VERDICT mutator — a byzantine server signs its lie over the
        request it actually received."""
        kind, rule, _idx = self._next_fault(target, method)
        if kind is None:
            return None, None
        if kind is FaultKind.PARTITION:
            raise InjectedRpcError(StatusCode.UNAVAILABLE, f"injected partition of {target}")
        if kind is FaultKind.UNAVAILABLE:
            raise InjectedRpcError(StatusCode.UNAVAILABLE, "injected UNAVAILABLE")
        if kind is FaultKind.RESET:
            raise InjectedRpcError(
                StatusCode.UNAVAILABLE, "injected connection reset"
            )
        if kind is FaultKind.DEADLINE:
            # simulated blow-through: the caller sees DEADLINE_EXCEEDED
            # after rule.delay_s of wall time (virtual when a SimClock
            # owns the sleep seam, real — and kept small — in tests)
            if rule is not None and rule.delay_s:
                self._sleep(rule.delay_s)
            raise InjectedRpcError(StatusCode.DEADLINE_EXCEEDED, "injected deadline")
        if kind is FaultKind.LATENCY:
            delay = rule.delay_s if rule is not None else 0.0
            if timeout is not None and delay >= timeout:
                self._sleep(timeout)
                raise InjectedRpcError(
                    StatusCode.DEADLINE_EXCEEDED, "injected latency past deadline"
                )
            self._sleep(delay)
            return None, None
        if kind is FaultKind.ERROR_FRAME:
            return encode_verdict(None, error="injected server error"), None
        if kind is FaultKind.CORRUPT_VERDICT:
            return None, self._corrupt
        if kind is FaultKind.FLIP_VERDICT:
            return None, _flip_verdict_byte
        if kind is FaultKind.LIE_VERDICT:
            return None, lambda data: _lie_verdict(data, request)
        return None, None

    # -- backend seam ----------------------------------------------------------

    def wrap_backend(self, verify_fn, target: str = "backend"):
        """Wrap a server-side verify backend (or a local pool's
        verify_fn). Backend faults become error frames at the server /
        rejected jobs at the pool — the fail-closed reply path."""
        for rule in self.rules:
            if (
                rule.methods is not None
                and "backend" in rule.methods
                and rule.kind not in _BACKEND_KINDS
            ):
                raise ValueError(
                    f"{rule.kind} is a transport fault; the backend seam supports "
                    f"{sorted(k.value for k in _BACKEND_KINDS)}"
                )

        def wrapped(sets):
            kind, rule, _idx = self._next_fault(target, "backend")
            if kind in (FaultKind.LATENCY, FaultKind.DEADLINE):
                self._sleep(rule.delay_s if rule is not None else 0.0)
                if kind is FaultKind.DEADLINE:
                    raise TimeoutError("injected backend deadline blow-through")
            elif kind is not None:
                raise RuntimeError(f"injected backend fault: {kind.value}")
            return verify_fn(sets)

        return wrapped


def _flip_verdict_byte(data: bytes) -> bytes:
    """Flip ok<->invalid on a well-formed verdict frame, leaving the
    rest (digest included) untouched — the fault the digest check must
    catch. Error frames pass through (already fail-closed)."""
    if data and data[0] in (0, 1):
        return bytes([1 - data[0]]) + data[1:]
    return data


def _lie_verdict(data: bytes, request: bytes) -> bytes:
    """The byzantine helper: flip the verdict and RE-SIGN the lie — the
    digest is recomputed over (request || lied_verdict), so the frame
    passes every protocol-layer check (`decode_verdict` accepts it).
    Distinct from FLIP_VERDICT, which framing catches: this fault is
    only detectable by independently re-verifying the signature sets
    (offload/audit.py). Legacy 1-byte verdicts just flip (no digest to
    forge); error frames pass through (already fail-closed)."""
    if not data or data[0] not in (0, 1):
        return data
    lied = 1 - data[0]
    if len(data) == 1:
        return bytes([lied])
    return encode_verdict(bool(lied), request=request)


class _FaultyCallable:
    """Stub wrapper: fault gate in front of the real call, response
    mutation behind it."""

    def __init__(self, injector: FaultInjector, target: str, method: str, fn):
        self._injector = injector
        self._target = target
        self._method = method
        self._fn = fn

    def __call__(self, request: bytes, timeout: float | None = None, metadata=None):
        override, mutate = self._injector._pre_call(
            self._target, self._method, timeout, request
        )
        if override is not None:
            return override
        kwargs = {"timeout": timeout}
        if metadata is not None:
            kwargs["metadata"] = metadata
        resp = self._fn(request, **kwargs)
        return mutate(resp) if mutate is not None else resp

    def with_call(self, request: bytes, timeout: float | None = None, metadata=None):
        override, mutate = self._injector._pre_call(
            self._target, self._method, timeout, request
        )
        if override is not None:
            return override, _NullCall()
        kwargs = {"timeout": timeout}
        if metadata is not None:
            kwargs["metadata"] = metadata
        resp, call = self._fn.with_call(request, **kwargs)
        return (mutate(resp) if mutate is not None else resp), call


class _NullCall:
    """Stands in for a grpc.Call when the injector short-circuited the
    wire: no trailing metadata came home."""

    def trailing_metadata(self):
        return ()
