"""Launch telemetry at the port's counted dispatch seam (stdlib only).

The port's own copy of the five functions of ``lodestar_tpu.telemetry``
that ``ops/prep.py``'s ``_dispatch`` calls: ``launch_telemetry_active``,
``size_class_of``, ``launch_size_class``, ``program_name`` and
``record_launch``, with the module state they read. Nothing else of that
module is copied: there is no metrics sink, debug route or slow-slot
dump in the port yet, so the mode is "auto" and telemetry stays off
unless a caller sets ``_mode`` to "on" (tests do).

What a record holds: the host wall seconds inside the dispatch call (on
the card the stages run eagerly and asynchronously, so this is issue
time plus any host sync the stage makes, not device time), the program
name, the pow-2 size class of the padded batch, and a first-call flag
per (program, size class).
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = [
    "launch_telemetry_active",
    "size_class_of",
    "launch_size_class",
    "program_name",
    "record_launch",
]

_mode = "auto"  # "on", "off" or "auto" (on once a metrics sink is installed)
_metrics = None  # a sink with launch_seconds / compile_* metrics, or None

_lock = threading.Lock()
_ledger: deque = deque(maxlen=256)  # guarded by: _lock
_seen_keys: set = set()  # guarded by: _lock; (program, size_class) first-call keys
_seq = 0  # guarded by: _lock; monotonic dispatch sequence number


def launch_telemetry_active() -> bool:
    """Whether the dispatch seam should pay the clock reads: "on" always,
    "off" never, "auto" once a metrics sink is installed."""
    if _mode == "on":
        return True
    if _mode == "off":
        return False
    return _metrics is not None


def size_class_of(n: int, floor: int = 8) -> int:
    """Pow-2 size class of a raw batch size (the bucketing of
    ``ops/prep.pad_pow2``)."""
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


def launch_size_class(args) -> int:
    """Leading-axis size of the first array-shaped thing in `args`
    (recursing into tuples and lists: stages take point tuples); 0 when
    nothing array-shaped is found."""
    for a in args:
        shape = getattr(a, "shape", None)
        if shape:
            return int(shape[0])
        if isinstance(a, (tuple, list)) and a:
            n = launch_size_class(a)
            if n:
                return n
    return 0


def program_name(program) -> str:
    """The dispatched callable's name."""
    name = getattr(program, "__name__", None)
    if name:
        return name
    return type(program).__name__


def record_launch(
    program: str,
    size_class: int,
    seconds: float,
    *,
    lane: str | None = None,
) -> dict | None:
    """Record one dispatch in the ledger (and the metrics sink, when one
    is installed). The first dispatch of a (program, size class) is
    flagged `compile`. Returns the ledger entry, or None when inactive."""
    if not launch_telemetry_active():
        return None
    global _seq
    key = (program, size_class)
    with _lock:
        _seq += 1
        compile_ = key not in _seen_keys
        _seen_keys.add(key)
        entry = {
            "seq": _seq,
            "program": program,
            "size_class": size_class,
            "seconds": seconds,
            "lane": lane,
            "compile": compile_,
            "t_mono_ns": time.monotonic_ns(),
        }
        _ledger.append(entry)
    m = _metrics
    if m is not None:
        try:
            m.launch_seconds.labels(program, str(size_class)).observe(seconds)
            if compile_:
                m.compile_misses.labels(program).inc()
                m.compile_seconds.inc(seconds)
            else:
                m.compile_hits.labels(program).inc()
        except Exception:
            pass  # the metric bridge must never fail a dispatch
    return entry
