"""Chrome `trace_event` export for completed pipeline traces.

The output is the Trace Event Format's JSON-object form ("traceEvents"
array of "ph":"X" complete events, microsecond timestamps) — load it in
chrome://tracing or https://ui.perfetto.dev unmodified. One process row
per trace (pid = slot when known), one thread row per originating
thread, so the BLS executor / offload spans render on their own tracks
under the slot they belong to.

The port of `lodestar_tpu.tracing.export` (stdlib only, as there).
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable

from . import Span, Trace

__all__ = ["to_chrome_trace", "write_chrome_trace", "prune_export_dir"]


def _event(trace: Trace, span: Span, pid: int) -> dict:
    args = dict(span.attrs or {})
    args["span_id"] = span.span_id
    if span.parent_id is not None:
        args["parent_id"] = span.parent_id
    end_ns = span.end_ns if span.end_ns is not None else span.start_ns
    return {
        "name": span.name,
        "cat": "lodestar",
        "ph": "X",
        "ts": span.start_ns / 1e3,  # trace-event timestamps are in µs
        "dur": max(0.0, (end_ns - span.start_ns) / 1e3),
        "pid": pid,
        "tid": span.tid,
        "args": args,
    }


def to_chrome_trace(traces: Iterable[Trace]) -> dict:
    events: list[dict] = []
    seen_pids: set[int] = set()
    for i, trace in enumerate(traces):
        # one process row PER TRACE: competing blocks at the same slot
        # (short reorg / equivocation) must not merge into one track, so
        # colliding slots fall back to a synthetic distinct pid
        pid = trace.slot if trace.slot is not None else 0
        if pid in seen_pids:
            pid = 1_000_000 + i  # i is unique per call
            while pid in seen_pids:
                pid += 1_000_000
        seen_pids.add(pid)
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": f"slot {trace.slot} ({trace.name} {trace.trace_id})"},
            }
        )
        with trace._lock:
            spans = list(trace.spans)
        events.extend(
            _event(trace, s, pid) for s in spans if s.start_ns is not None
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, traces: Iterable[Trace]) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(traces), f, indent=1)
        f.write("\n")
    return path


def prune_export_dir(
    path: str,
    *,
    max_files: int | None = None,
    max_age_s: float | None = None,
    now: float | None = None,
) -> list[str]:
    """Retention for a --tracing-export-dir: delete trace JSONs older
    than `max_age_s`, then the oldest (by mtime) beyond `max_files`, so a
    long-running node's slow slots can't grow the directory unbounded.
    Only touches the tracer's own `slot<N>_<trace_id>.json` output —
    unrelated JSON an operator keeps in the same directory is never
    pruned. Returns the removed paths; unlink races with an external
    cleaner are ignored. `max_files`/`max_age_s` of None or <= 0 mean
    unlimited (the usual CLI convention for 0)."""
    import fnmatch

    if max_files is not None and max_files <= 0:
        max_files = None
    if max_age_s is not None and max_age_s <= 0:
        max_age_s = None

    try:
        names = os.listdir(path)
    except OSError:
        return []
    entries: list[tuple[float, str]] = []
    for name in names:
        if not fnmatch.fnmatch(name, "slot*_*.json"):
            continue
        full = os.path.join(path, name)
        try:
            entries.append((os.path.getmtime(full), full))
        except OSError:
            continue
    entries.sort()  # oldest first
    now = time.time() if now is None else now
    removed: list[str] = []

    def _unlink(full: str) -> None:
        try:
            os.unlink(full)
            removed.append(full)
        except OSError:
            pass

    if max_age_s is not None:
        fresh = []
        for mtime, full in entries:
            if now - mtime > max_age_s:
                _unlink(full)
            else:
                fresh.append((mtime, full))
        entries = fresh
    if max_files is not None and len(entries) > max_files:
        for _mtime, full in entries[: len(entries) - max_files]:
            _unlink(full)
    return removed
