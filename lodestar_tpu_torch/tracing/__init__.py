"""Per-slot pipeline span tracing, as far as the verifier pool uses it.

The PyTorch port's copy of the core of ``lodestar_tpu/tracing``: explicit
`Span` objects (monotonic-clock timed, parent/child linked,
attribute-carrying) stitched into a `Trace`, the current span in a
`contextvars.ContextVar` (asyncio-safe), completed traces in a ring buffer
(`Tracer.ring`), a slow-trace log line naming the `critical_path`, and
`record` for spans timed on another thread (the pool's executor threads,
where `run_in_executor` does not carry the contextvar). Disabled, every
call site costs one flag check and gets a shared no-op span. Stdlib only.

Cross-process propagation for the offload host (`offload/server.py`) is
copied too: the caller's trace context rides the verify RPC's metadata
(`context_header`, key `TRACE_CONTEXT_KEY`), the server records its spans
on a `RemoteSpanRecorder` relative to its own start and ships them home
in trailing metadata (key `TRACE_SPANS_KEY`) as the JAX package's JSON
payload, and the client grafts them under its RPC span
(`graft_remote_spans`); a client of either package reads the other's
payload. `traced` is the decorator form of `span` (the state transition's
signature-set producer wears it). A slow trace is also written as a Chrome
`trace_event` JSON file into `export_dir` when one is set, with its
retention (`export.prune_export_dir`), as in the JAX package. The metric
bridge is the JAX package's: a tracer given a `TraceMetrics` (`metrics=`,
from ``lodestar_tpu_torch.metrics``) feeds every completed trace's spans
into the lodestar_trace_* families and counts its slow slots; a slow-slot
dump also carries the event loop's last lag sample (`lag_ms_supplier`,
`metrics.monitoring.EventLoopLagSampler.last_lag_ms`) and the slot's
device launches (`launches_supplier`, `telemetry.slow_slot_launches`)
when they are configured.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import json
import threading
import time
from collections import deque

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "configure",
    "get_tracer",
    "reset",
    "span",
    "traced",
    "root",
    "current",
    "discard",
    "keep",
    "record",
    "critical_path",
    "current_log_ctx",
    "context_header",
    "parse_context_header",
    "RemoteSpanRecorder",
    "remote_recorder",
    "graft_remote_spans",
    "TRACE_CONTEXT_KEY",
    "TRACE_SPANS_KEY",
]

# gRPC metadata keys: context flows caller→callee, completed server
# spans flow back in trailing metadata ("-bin" keys carry raw bytes)
TRACE_CONTEXT_KEY = "x-lodestar-trace"
TRACE_SPANS_KEY = "x-lodestar-trace-spans-bin"

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "lodestar_trace_span", default=None
)
_trace_ids = itertools.count(1)  # CPython next() is atomic under the GIL


class Span:
    """One timed region. Also its own context manager: `with` pushes it
    as the current span (contextvar) and completes it on exit."""

    __slots__ = (
        "trace",
        "name",
        "span_id",
        "parent_id",
        "start_ns",
        "end_ns",
        "attrs",
        "tid",
        "_token",
    )

    def __init__(
        self,
        trace: "Trace",
        name: str,
        span_id: int,
        parent_id: int | None,
        start_ns: int | None = None,
    ):
        self.trace = trace
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.attrs: dict | None = None
        self.tid = threading.get_ident()
        self._token = None

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    @property
    def duration_ms(self) -> float:
        if self.start_ns is None or self.end_ns is None:
            return 0.0
        return (self.end_ns - self.start_ns) / 1e6

    def __bool__(self) -> bool:  # noop spans are falsy; real spans truthy
        return True

    def __enter__(self) -> "Span":
        if self.start_ns is None:
            self.start_ns = time.monotonic_ns()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end_ns = time.monotonic_ns()
        if exc is not None:
            self.set(error=f"{type(exc).__name__}: {exc}"[:200])
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self.trace._complete_span(self)
        return False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.span_id}, parent={self.parent_id}, {self.duration_ms:.3f}ms)"


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path returns this one
    preallocated singleton, so instrumentation costs a flag check only."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self

    def __bool__(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Trace:
    """One stitched tree of spans, usually a slot's block import."""

    def __init__(self, trace_id: str, name: str, slot: int | None):
        self.trace_id = trace_id
        self.name = name
        self.slot = slot
        self.spans: list[Span] = []  # completion order
        self.root: Span | None = None
        self.discarded = False  # dropped on completion (no pipeline ran)
        # bulk traces (a range-sync batch over many blocks) are exempt
        # from the per-slot slow policy + pipeline histogram: a routine
        # 30-block batch is not a slow SLOT and must not spam warn logs,
        # export files, or the block-pipeline latency distribution
        self.bulk = False
        self.start_ns = time.monotonic_ns()
        self.end_ns: int | None = None
        self._lock = threading.Lock()
        self._next_span_id = 0

    def _new_span_id(self) -> int:
        with self._lock:
            self._next_span_id += 1
            return self._next_span_id

    def _complete_span(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    @property
    def duration_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) / 1e6

    def to_dict(self) -> dict:
        """JSON-friendly view, span starts relative to the trace start."""
        with self._lock:
            spans = list(self.spans)
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "slot": self.slot,
            "duration_ms": round(self.duration_ms, 3),
            "spans": [
                {
                    "name": s.name,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "start_ms": round((s.start_ns - self.start_ns) / 1e6, 3),
                    "duration_ms": round(s.duration_ms, 3),
                    "attrs": s.attrs or {},
                }
                for s in spans
            ],
        }


def critical_path(trace: Trace) -> list[Span]:
    """Root-to-leaf walk always descending into the longest child — the
    chain of spans that explains where the slot's wall-clock went."""
    with trace._lock:
        spans = list(trace.spans)
    if trace.root is None:
        return []
    children: dict[int | None, list[Span]] = {}
    for s in spans:
        if s is not trace.root:
            children.setdefault(s.parent_id, []).append(s)
    path = [trace.root]
    node = trace.root
    while True:
        kids = children.get(node.span_id)
        if not kids:
            return path
        node = max(kids, key=lambda s: s.end_ns - s.start_ns if s.end_ns else 0)
        path.append(node)


class Tracer:
    """Owns the enabled flag, the completed-trace ring buffer and the
    slow-slot policy. One module-global instance (`get_tracer()`) serves
    the whole process; tests may build their own."""

    def __init__(self, *, enabled: bool = False, slow_slot_ms: float = 2000.0,
                 export_dir: str | None = None, export_max_files: int | None = 256,
                 export_max_age_s: float | None = None, ring_size: int = 64,
                 metrics=None, lag_ms_supplier=None, launches_supplier=None):
        self.enabled = enabled
        self.slow_slot_ms = slow_slot_ms
        self.export_dir = export_dir
        # retention for --tracing-export-dir: a long-running node's slow
        # slots must not grow the directory unbounded
        self.export_max_files = export_max_files
        self.export_max_age_s = export_max_age_s
        self.ring: deque[Trace] = deque(maxlen=ring_size)
        self.metrics = metrics  # metrics.TraceMetrics or None
        # () -> float|None: last event-loop lag sample in ms, surfaced in
        # slow-slot dumps (EventLoopLagSampler wires itself in here)
        self.lag_ms_supplier = lag_ms_supplier
        # () -> list|None: the slot's device launches (telemetry ledger)
        self.launches_supplier = launches_supplier
        self.slow_slot_dumps = 0
        self.last_slow_dump: dict | None = None
        self._lock = threading.Lock()
        self._log = None  # lazy: the logger imports tracing for %(trace_ctx)s

    # -- span creation --------------------------------------------------------

    def root(self, name: str, slot: int | None = None, bulk: bool = False):
        """Start a trace (becomes a plain child span if one is already
        active, so nested pipelines stitch instead of fragmenting).
        Exiting a fresh root completes the trace (ring + slow-slot
        policy + metrics). `bulk` marks many-block aggregate traces that
        skip the per-slot slow policy and pipeline histogram."""
        if not self.enabled:
            return NOOP_SPAN
        parent = _current_span.get()
        if parent is not None:
            return self._child(parent, name)
        trace = Trace(f"{next(_trace_ids):08x}", name, slot)
        trace.bulk = bulk
        # lint: allow(span-discipline) — tracer-internal construction: the returned _RootCtx is the context manager callers `with`
        span = Span(trace, name, trace._new_span_id(), None)
        trace.root = span
        return _RootCtx(self, span)

    def span(self, name: str, parent: Span | None = None):
        """Child span of `parent` (defaults to the contextvar's current
        span). No active trace → no-op: spans only exist inside a trace."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _current_span.get()
        if parent is None or isinstance(parent, _NoopSpan):
            return NOOP_SPAN
        return self._child(parent, name)

    def _child(self, parent: Span, name: str) -> Span:
        trace = parent.trace
        # lint: allow(span-discipline) — tracer-internal construction: span()/root() hand this out for the caller to `with`
        return Span(trace, name, trace._new_span_id(), parent.span_id)

    def record(
        self,
        parent: Span | None,
        name: str,
        start_ns: int,
        end_ns: int,
        attrs: dict | None = None,
    ) -> Span | None:
        """Attach an already-timed span under `parent` — the cross-thread
        path (BLS executor, offload RPC) where `with` blocks can't carry
        the contextvar."""
        if parent is None or isinstance(parent, _NoopSpan):
            return None
        trace = parent.trace
        # lint: allow(span-discipline) — record() is the documented pre-timed escape hatch: start/end are explicit, _complete_span closes it
        span = Span(trace, name, trace._new_span_id(), parent.span_id, start_ns)
        span.end_ns = end_ns
        if attrs:
            span.attrs = dict(attrs)
        trace._complete_span(span)
        return span

    # -- completion policy ----------------------------------------------------

    def on_trace_complete(self, trace: Trace) -> None:
        if trace.discarded:
            return  # no pipeline ran: keep the ring for traces of real work
        trace.end_ns = trace.root.end_ns if trace.root is not None else time.monotonic_ns()
        with self._lock:
            self.ring.append(trace)
        m = self.metrics
        if m is not None:
            try:
                m.traces_completed.inc()
                if not trace.bulk:
                    m.block_pipeline_time.observe(trace.duration_ms / 1000.0)
                for s in trace.spans:
                    m.span_duration.labels(span=s.name).observe(
                        max(0.0, s.duration_ms / 1000.0)
                    )
            except Exception:
                pass  # metric bridge must never break the pipeline
        if trace.duration_ms > self.slow_slot_ms and not trace.bulk:
            self._dump_slow(trace)

    def _dump_slow(self, trace: Trace) -> None:
        """At most one dump per completed trace: a structured log line with
        the critical path, plus an optional Chrome-trace file."""
        path = critical_path(trace)
        path_str = " > ".join(f"{s.name} {s.duration_ms:.1f}ms" for s in path)
        info = {
            "slot": trace.slot,
            "trace_id": trace.trace_id,
            "duration_ms": round(trace.duration_ms, 1),
            "threshold_ms": self.slow_slot_ms,
            "critical_path": path_str,
            "spans": len(trace.spans),
        }
        if self.lag_ms_supplier is not None:
            # loop starvation vs device slowness: the lag sample says which
            try:
                lag_ms = self.lag_ms_supplier()
                if lag_ms is not None:
                    info["event_loop_lag_ms"] = round(lag_ms, 3)
            except Exception:
                pass  # the dump must never fail on an optional probe
        if self.launches_supplier is not None:
            # the slot's device launches (program/size/wall/first call):
            # a first-call stall vs a dispatch storm is readable from the dump
            try:
                launches = self.launches_supplier()
                if launches is not None:
                    info["device_launches"] = launches
            except Exception:
                pass  # the dump must never fail on an optional probe
        with self._lock:
            self.slow_slot_dumps += 1
            self.last_slow_dump = info
        if self.metrics is not None:
            try:
                self.metrics.slow_slots.inc()
            except Exception:
                pass
        if self._log is None:
            from ..logger import get_logger

            self._log = get_logger(name="lodestar.tracing")
        self._log.warn(f"slow slot {trace.slot}", info)
        if self.export_dir:
            try:
                import os

                from .export import prune_export_dir, write_chrome_trace

                os.makedirs(self.export_dir, exist_ok=True)
                out = os.path.join(
                    self.export_dir, f"slot{trace.slot}_{trace.trace_id}.json"
                )
                write_chrome_trace(out, [trace])
                prune_export_dir(
                    self.export_dir,
                    max_files=self.export_max_files,
                    max_age_s=self.export_max_age_s,
                )
            except Exception:
                pass  # export failures must never fail the import pipeline

    # -- queries --------------------------------------------------------------

    def traces_for_slot(self, slot: int) -> list[Trace]:
        with self._lock:
            return [t for t in self.ring if t.slot == slot]

    def recent_traces(self, n: int = 16) -> list[Trace]:
        if n <= 0:
            return []  # [-0:] would return the whole ring
        with self._lock:
            return list(self.ring)[-n:]


# -- module-global tracer + thin fast-path functions ---------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure(
    *,
    enabled: bool | None = None,
    slow_slot_ms: float | None = None,
    export_dir: str | None = None,
    export_max_files: int | None = None,
    export_max_age_s: float | None = None,
    ring_size: int | None = None,
    metrics=None,
    lag_ms_supplier=None,
    launches_supplier=None,
) -> Tracer:
    """Mutate the global tracer in place (callers hold no stale refs)."""
    t = _TRACER
    if enabled is not None:
        t.enabled = enabled
    if slow_slot_ms is not None:
        t.slow_slot_ms = slow_slot_ms
    if export_dir is not None:
        t.export_dir = export_dir
    if export_max_files is not None:
        t.export_max_files = export_max_files
    if export_max_age_s is not None:
        t.export_max_age_s = export_max_age_s
    if ring_size is not None:
        with t._lock:
            t.ring = deque(t.ring, maxlen=ring_size)
    if metrics is not None:
        t.metrics = metrics
    if lag_ms_supplier is not None:
        t.lag_ms_supplier = lag_ms_supplier
    if launches_supplier is not None:
        t.launches_supplier = launches_supplier
    return t


def reset() -> Tracer:
    """Fresh disabled global tracer (test isolation)."""
    global _TRACER
    _TRACER = Tracer()
    return _TRACER


def span(name: str, parent: Span | None = None):
    if not _TRACER.enabled:
        return NOOP_SPAN
    return _TRACER.span(name, parent)


def root(name: str, slot: int | None = None, bulk: bool = False):
    if not _TRACER.enabled:
        return NOOP_SPAN
    return _TRACER.root(name, slot, bulk=bulk)


class _RootCtx:
    """Wraps a root span so exiting it completes the whole trace."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: Tracer, span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        out = self.span.__exit__(exc_type, exc, tb)
        self.tracer.on_trace_complete(self.span.trace)
        return out

    def set(self, **attrs):
        self.span.set(**attrs)
        return self

    def __bool__(self) -> bool:
        return True


def traced(name: str):
    """Decorator form of `span(name)`: times the wrapped call when a
    trace is active, passes straight through (one flag check) otherwise."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _TRACER.enabled:
                return fn(*args, **kwargs)
            with _TRACER.span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def current() -> Span | None:
    """The active span, or None (also None when tracing is disabled —
    callers capture this to parent cross-thread spans explicitly)."""
    if not _TRACER.enabled:
        return None
    return _current_span.get()


def discard() -> None:
    """Mark the active trace to be dropped on completion — for pipelines
    that turn out to be no-ops (gossip IGNORE/REJECT before import), so
    sub-millisecond non-traces don't flood the ring or skew the
    block-pipeline histograms."""
    if not _TRACER.enabled:
        return
    sp = _current_span.get()
    if sp is not None:
        sp.trace.discarded = True


def keep() -> None:
    """Clear a pending discard on the active trace. An outer root that
    aggregates nested pipelines (a range-sync batch over process_block
    calls) owns its own completion: one ALREADY_KNOWN duplicate mid-batch
    discards per the nested pipeline's policy, and the batch root calls
    keep() at the end so the batch trace still lands in the ring."""
    if not _TRACER.enabled:
        return
    sp = _current_span.get()
    if sp is not None:
        sp.trace.discarded = False


def record(
    parent: Span | None, name: str, start_ns: int, end_ns: int, attrs: dict | None = None
):
    return _TRACER.record(parent, name, start_ns, end_ns, attrs)


def current_log_ctx() -> str:
    """Log-format fragment for %(trace_ctx)s: ' [trace=<id>]' while a
    span is active, '' otherwise (and always '' when tracing is off)."""
    if not _TRACER.enabled:
        return ""
    sp = _current_span.get()
    if sp is None:
        return ""
    return f" [trace={sp.trace.trace_id}]"


# -- cross-process propagation (offload gRPC) ----------------------------------


def context_header() -> str | None:
    """Serialized trace context for gRPC metadata: 'trace_id:span_id:slot'."""
    if not _TRACER.enabled:
        return None
    sp = _current_span.get()
    if sp is None:
        return None
    slot = sp.trace.slot if sp.trace.slot is not None else ""
    return f"{sp.trace.trace_id}:{sp.span_id}:{slot}"


def parse_context_header(header: str) -> tuple[str, int, int | None] | None:
    try:
        trace_id, span_id, slot = header.split(":", 2)
        return trace_id, int(span_id), (int(slot) if slot else None)
    except (ValueError, AttributeError):
        return None


class RemoteSpanRecorder:
    """Server-side recorder: collects spans relative to its own creation
    and serializes them for the trailing-metadata trip home. Independent
    of the server process's global tracer — the caller's header is the
    enable signal."""

    __slots__ = ("origin_ns", "spans", "_lock", "_next_id")

    def __init__(self):
        self.origin_ns = time.monotonic_ns()
        self.spans: list[dict] = []
        self._lock = threading.Lock()
        self._next_id = itertools.count(1)

    def span(self, name: str, **attrs) -> "_RemoteSpanCtx":
        return _RemoteSpanCtx(self, name, attrs)

    def _add(self, name: str, start_ns: int, end_ns: int, attrs: dict) -> None:
        with self._lock:
            self.spans.append(
                {
                    "id": next(self._next_id),
                    "name": name,
                    "offset_ns": start_ns - self.origin_ns,
                    "dur_ns": end_ns - start_ns,
                    "attrs": attrs or {},
                }
            )

    def serialize(self) -> bytes:
        with self._lock:
            return json.dumps(self.spans, separators=(",", ":")).encode()


class _RemoteSpanCtx:
    __slots__ = ("rec", "name", "attrs", "start_ns")

    def __init__(self, rec: RemoteSpanRecorder, name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.attrs["error"] = f"{type(exc).__name__}: {exc}"[:200]
        self.rec._add(self.name, self.start_ns, time.monotonic_ns(), self.attrs)
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self


class _NoopRemoteRecorder:
    __slots__ = ()

    def span(self, name: str, **attrs):
        return NOOP_SPAN

    def serialize(self) -> bytes | None:
        return None


_NOOP_REMOTE = _NoopRemoteRecorder()


def remote_recorder(header: str | None):
    """Server entry: a live recorder when the caller sent a trace
    context header, a shared no-op otherwise."""
    if header and parse_context_header(header) is not None:
        return RemoteSpanRecorder()
    return _NOOP_REMOTE


def graft_remote_spans(parent: Span | None, payload: bytes, anchor_start_ns: int) -> int:
    """Client side: rebase serialized server spans under the local RPC
    span. Server offsets are relative to its handling start; anchoring
    them at the client RPC start keeps ordering honest (network skew
    shows up as the gap between the RPC span and its children). Returns
    the number of grafted spans."""
    if parent is None or isinstance(parent, _NoopSpan) or not payload:
        return 0
    try:
        items = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError):
        return 0
    n = 0
    for item in items:
        try:
            start = anchor_start_ns + int(item["offset_ns"])
            attrs = dict(item.get("attrs") or {})
            attrs["remote"] = True
            _TRACER.record(parent, str(item["name"]), start, start + int(item["dur_ns"]), attrs)
            n += 1
        except (KeyError, TypeError, ValueError):
            continue
    return n
