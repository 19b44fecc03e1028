"""Small helpers the verifier pool and its breakers use; the bounded job
queue the chain's regen runs on is in `utils.queue`.

The PyTorch port's copies of ``lodestar_tpu/utils`` `backoff_delay` and of
``lodestar_tpu/utils/tracing.py`` `trace_region`, the latter on
`torch.profiler` instead of the XLA profiler. Set
``LODESTAR_TPU_TRACE=<dir>`` and every traced region (a verifier-pool batch
launch) writes a Chrome trace of the host and the card into that
directory; unset, the context manager is free (no profiler import).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
from typing import Callable

__all__ = ["backoff_delay", "trace_region", "tracing_enabled"]


def backoff_delay(
    attempt: int,
    *,
    base: float,
    factor: float = 2.0,
    max_delay: float | None = None,
    jitter: float = 0.0,
    rng: Callable[[], float] = random.random,
) -> float:
    """Delay before retry number `attempt` (0-based): exponential
    `base * factor**attempt`, capped at `max_delay`, with up to
    `jitter` fraction of the capped delay SUBTRACTED (jitter spreads a
    fleet of breakers opened by the same outage so they don't re-probe
    the recovering host in lockstep — downward, so the documented cap
    is a true upper bound even at saturation). Used by the circuit
    breaker's half-open schedule."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    delay = base * (factor ** attempt)
    if max_delay is not None:
        delay = min(delay, max_delay)
    if jitter:
        delay -= delay * jitter * rng()
    return delay


_TRACE_DIR = os.environ.get("LODESTAR_TPU_TRACE", "")
# one profiler capture at a time; try-acquire makes the guard atomic across
# executor threads (concurrent regions no-op)
_capture_lock = threading.Lock()


def tracing_enabled() -> bool:
    return bool(_TRACE_DIR)


@contextlib.contextmanager
def trace_region(name: str):
    """`torch.profiler` capture around a device region, written as a Chrome
    trace to ``$LODESTAR_TPU_TRACE/<name>.<pid>.<n>.json``. Nested or
    concurrent regions no-op; so does everything when LODESTAR_TPU_TRACE is
    unset."""
    if not _TRACE_DIR or not _capture_lock.acquire(blocking=False):
        yield
        return
    # profiler failures must never change the traced region's outcome (a
    # raise here would masquerade as e.g. an invalid signature batch)
    try:
        prof = None
        try:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception:
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(_TRACE_DIR, exist_ok=True)
                    global _trace_seq
                    _trace_seq += 1
                    prof.export_chrome_trace(
                        os.path.join(_TRACE_DIR, f"{name}.{os.getpid()}.{_trace_seq}.json"))
                except Exception:
                    pass
    finally:
        _capture_lock.release()


_trace_seq = 0  # guarded by: _capture_lock
