"""Launch telemetry at the port's counted dispatch seams (stdlib only).

The port's copy of ``lodestar_tpu.telemetry``: the seam functions
(``launch_telemetry_active``, ``size_class_of``, ``launch_size_class``,
``program_name``, ``record_launch``) and the ledger half
(``configure_launch_telemetry``, ``launch_ledger``, ``launch_totals``,
``known_programs``, ``slow_slot_launches``, ``reset_launch_telemetry``).
The seams that report here are ``ops/prep.py``'s ``_dispatch`` (every prep
stage), ``ssz/device_htr.py`` (every Merkle level and root graph) and
``chain/bls/mesh.py``'s lane launch (every verify a lane serves).

What a record holds: the host wall seconds inside the dispatch call (on
the card the stages run eagerly and asynchronously, so this is issue
time plus any host sync the stage makes, not device time), the program
name, the pow-2 size class of the padded batch, the lane when known, and
a first-call flag per (program, size class).

Mode (process-global): "auto" records once a metrics sink is installed,
"on" records without one (a bounded in-process ledger and counters; tests
and scripts), "off" records nothing. The port has no metrics module yet,
so a sink is whatever object with the ``launch_seconds`` and
``compile_*`` families a caller installs.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = [
    "TELEMETRY_MODES",
    "DEFAULT_LEDGER_SIZE",
    "configure_launch_telemetry",
    "launch_telemetry_active",
    "record_launch",
    "launch_size_class",
    "size_class_of",
    "program_name",
    "launch_ledger",
    "launch_totals",
    "known_programs",
    "slow_slot_launches",
    "reset_launch_telemetry",
]

TELEMETRY_MODES = ("auto", "on", "off")

#: ledger bound: big enough to hold every dispatch of a slow slot
#: (a worst-case import is tens of launches), small enough that the
#: debug route and the slow-slot dump stay cheap to serialize
DEFAULT_LEDGER_SIZE = 256

_mode = "auto"  # guarded by: config-time (node init / test setup writes; hot-path reads tolerate either value)
_metrics = None  # guarded by: config-time (DeviceLaunchMetrics slot, set once at node init)

_lock = threading.Lock()
_ledger: deque = deque(maxlen=DEFAULT_LEDGER_SIZE)  # guarded by: _lock
_seen_keys: set = set()  # guarded by: _lock — (program, size_class) compile-detection keys
_seq = 0  # guarded by: _lock — monotonic dispatch sequence number
_compiles = 0  # guarded by: _lock — first-call dispatches observed


def configure_launch_telemetry(
    mode: str | None = None, metrics=None, ledger_size: int | None = None
) -> str:
    """Set the process-wide telemetry mode and/or install the
    `lodestar_device_launch_*` metric family (node init; tests flip the
    mode around calls). Returns the PREVIOUS mode so callers can
    save/restore."""
    global _mode, _metrics, _ledger
    prev = _mode
    if mode is not None:
        if mode not in TELEMETRY_MODES:
            raise ValueError(
                f"launch_telemetry must be one of {TELEMETRY_MODES}, got {mode!r}"
            )
        _mode = mode
    if metrics is not None:
        _metrics = metrics
    if ledger_size is not None:
        with _lock:
            _ledger = deque(_ledger, maxlen=ledger_size)
    return prev


def launch_telemetry_active() -> bool:
    """Whether the dispatch seams should pay the clock reads: "on"
    always, "off" never, "auto" once a metrics sink is installed (the
    node installs one at init; bare library use stays free)."""
    if _mode == "on":
        return True
    if _mode == "off":
        return False
    return _metrics is not None


def size_class_of(n: int, floor: int = 8) -> int:
    """Pow-2 size-class bucketing for a raw batch size — the same
    shape-bucket the compile caches key on (`ops/prep.pad_pow2`,
    reimplemented here so jax-free seams like chain/bls/mesh.py can
    label without importing the ops layer)."""
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


def launch_size_class(args) -> int:
    """Leading-axis size of the first array-shaped thing in `args`
    (recursing into tuples/lists — device programs take point tuples).
    The dispatch seams hand padded arrays in, so this IS the size
    class; returns 0 when nothing array-shaped is found."""
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
    """Stable identity label for a dispatched callable (jit wrappers
    preserve `__name__` via functools.wraps)."""
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
    """Record one device dispatch: ledger entry + metric observations.

    Compile detection is first-call-per-(program, size_class): the jit
    caches hold one executable per key, so the first dispatch of a key
    in this process carries trace+compile (or the persistent-cache
    load) and is counted as a miss; every later dispatch of the key is
    a hit. Returns the ledger entry (tests), or None when inactive."""
    if not launch_telemetry_active():
        return None
    global _seq, _compiles
    key = (program, size_class)
    with _lock:
        _seq += 1
        compile_ = key not in _seen_keys
        _seen_keys.add(key)
        if compile_:
            _compiles += 1
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
            pass  # the metric bridge must never fail a device dispatch
    return entry


def launch_ledger(n: int | None = None) -> list[dict]:
    """The most recent `n` ledger entries (all when None), oldest
    first. Entries are copies — callers can't corrupt the ledger."""
    with _lock:
        entries = list(_ledger)
    if n is not None and n >= 0:
        entries = entries[-n:] if n else []
    return [dict(e) for e in entries]


def launch_totals() -> dict:
    """Cumulative view for the debug route: dispatch count, compile
    count, distinct (program, size_class) keys, and per-program launch
    counts over the CURRENT ledger window (the full-history numbers
    are the Prometheus counters)."""
    with _lock:
        entries = list(_ledger)
        seq = _seq
        compiles = _compiles
        keys = len(_seen_keys)
    by_program: dict[str, int] = {}
    for e in entries:
        by_program[e["program"]] = by_program.get(e["program"], 0) + 1
    return {
        "launches": seq,
        "compiles": compiles,
        "distinct_keys": keys,
        "ledger_entries": len(entries),
        "ledger_by_program": by_program,
    }


def known_programs() -> set[str]:
    """Program names that have dispatched at least once in this process
    (the compile-detection key universe) — the validation set for the
    debug route's `?program=` filter."""
    with _lock:
        return {k[0] for k in _seen_keys}


def slow_slot_launches(n: int = 12) -> dict:
    """Compact launch view for slow-slot dumps: the trailing `n`
    dispatches as one-line strings plus the cumulative counts — a slow
    slot names its launches without a second query. When the SLO layer
    is configured, the dump also names the per-class remaining deadline
    slack at dump time ("did we still make the cutoff" inline)."""
    entries = launch_ledger(n)
    recent = [
        "{program}/{size_class} {ms:.1f}ms{lane}{comp}".format(
            program=e["program"],
            size_class=e["size_class"],
            ms=e["seconds"] * 1000.0,
            lane=f" @{e['lane']}" if e["lane"] else "",
            comp=" [compile]" if e["compile"] else "",
        )
        for e in entries
    ]
    with _lock:
        out = {"launches_total": _seq, "compiles_total": _compiles, "recent": recent}
    # lazy one-way import (slo never imports telemetry); stdlib only on
    # both sides
    from lodestar_tpu_torch import slo

    slack = slo.slow_slot_slack()
    if slack:
        out["deadline_slack"] = slack
    return out


def reset_launch_telemetry() -> None:
    """Fresh disabled-ish state (test isolation): mode back to auto,
    metrics detached, ledger/keys/counters cleared."""
    global _mode, _metrics, _ledger, _seq, _compiles
    with _lock:
        _mode = "auto"
        _metrics = None
        _ledger = deque(maxlen=DEFAULT_LEDGER_SIZE)
        _seen_keys.clear()
        _seq = 0
        _compiles = 0
