"""Structured logging with per-module child loggers.

The PyTorch port's copy of ``lodestar_tpu/logger``.

Counterpart of the reference `packages/logger/src` (`node.ts:66`
getNodeLogger, `winston.ts:11-29` per-module level overrides). Built on
stdlib logging: one root "lodestar" logger, `child(module=...)` loggers
carrying a module tag, per-module level overrides, optional file output.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass, field

__all__ = ["LoggerOpts", "get_logger", "get_empty_logger", "LodestarLogger"]

_FORMAT = "%(asctime)s %(levelname)-5s [%(module_tag)s]%(trace_ctx)s %(message)s"

# winston-style names used by the reference map onto stdlib levels
_LEVEL_ALIASES = {"verbose": "DEBUG", "trace": "DEBUG", "warn": "WARNING", "fatal": "CRITICAL"}


def _level(name: str) -> str:
    return _LEVEL_ALIASES.get(name.lower(), name.upper())


_trace_ctx_fn = None


def _trace_ctx() -> str:
    """' [trace=<id>]' while a pipeline span is active in this context,
    '' otherwise — log lines emitted inside a traced slot carry its id.
    Lazy import (cached after first success): the tracing package logs
    through THIS module, so the dependency must stay one-way at import
    time; after that every record pays one call + flag check."""
    global _trace_ctx_fn
    fn = _trace_ctx_fn
    if fn is None:
        try:
            from .tracing import current_log_ctx as fn
        except Exception:
            return ""
        _trace_ctx_fn = fn
    return fn()


class _ModuleTagFilter(logging.Filter):
    def __init__(self, tag: str):
        super().__init__()
        self.tag = tag

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "module_tag"):
            record.module_tag = self.tag
        if not hasattr(record, "trace_ctx"):
            record.trace_ctx = _trace_ctx()
        return True


@dataclass
class LoggerOpts:
    """Mirror of the reference LoggerNodeOpts (level, file, module overrides)."""

    level: str = "info"
    file: str | None = None
    file_level: str = "debug"
    # per-module level overrides, e.g. {"network": "debug"}
    module_levels: dict[str, str] = field(default_factory=dict)


class LodestarLogger:
    """Thin wrapper adding child() with module tags (winston childLogger shape)."""

    def __init__(self, py_logger: logging.Logger, opts: LoggerOpts, tag: str = "node"):
        self._log = py_logger
        self._opts = opts
        self._tag = tag

    def child(self, module: str) -> "LodestarLogger":
        name = f"{self._log.name}.{module}"
        child = logging.getLogger(name)
        override = self._opts.module_levels.get(module)
        if override:
            child.setLevel(_level(override))
        out = LodestarLogger(child, self._opts, module)
        return out

    def _emit(self, level: int, msg: str, meta: dict | None) -> None:
        if meta:
            msg = f"{msg} {' '.join(f'{k}={v}' for k, v in meta.items())}"
        self._log.log(level, msg, extra={"module_tag": self._tag})

    def error(self, msg: str, meta: dict | None = None, exc: BaseException | None = None) -> None:
        if exc is not None:
            msg = f"{msg} - {type(exc).__name__}: {exc}"
        self._emit(logging.ERROR, msg, meta)

    def warn(self, msg: str, meta: dict | None = None) -> None:
        self._emit(logging.WARNING, msg, meta)

    def info(self, msg: str, meta: dict | None = None) -> None:
        self._emit(logging.INFO, msg, meta)

    def debug(self, msg: str, meta: dict | None = None) -> None:
        self._emit(logging.DEBUG, msg, meta)

    def verbose(self, msg: str, meta: dict | None = None) -> None:
        self._emit(logging.DEBUG, msg, meta)


def get_logger(opts: LoggerOpts | None = None, name: str = "lodestar") -> LodestarLogger:
    """Reference getNodeLogger equivalent.

    Calling again with different opts RECONFIGURES the named logger:
    existing handlers installed by this function are replaced, so a later
    call adding `opts.file` (or changing formats/levels) takes full effect
    instead of being silently dropped.
    """
    opts = opts or LoggerOpts()
    log = logging.getLogger(name)
    log.setLevel(_level(opts.level))
    # replace only our own handlers; leave externally-attached ones alone
    for h in [h for h in log.handlers if getattr(h, "_lodestar_managed", False)]:
        log.removeHandler(h)
        h.close()
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(_FORMAT))
    h.addFilter(_ModuleTagFilter("node"))
    h._lodestar_managed = True
    log.addHandler(h)
    if opts.file:
        fh = logging.FileHandler(opts.file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        fh.setLevel(_level(opts.file_level))
        fh.addFilter(_ModuleTagFilter("node"))
        fh._lodestar_managed = True
        log.addHandler(fh)
    return LodestarLogger(log, opts)


def get_empty_logger() -> LodestarLogger:
    """No-op logger (reference getEmptyLogger for tests/browser)."""
    log = logging.getLogger("lodestar.empty")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return LodestarLogger(log, LoggerOpts(level="critical"))
