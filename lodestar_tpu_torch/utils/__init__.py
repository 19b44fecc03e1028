"""Cross-cutting helpers: retry, sleep, byte utils, math, and the
profiler region; the bounded job queue the chain's regen runs on is in
`utils.queue`.

The PyTorch port's copies of ``lodestar_tpu/utils`` (counterpart of the
reference `packages/utils/src`: sleep.ts, retry.ts, bytes.ts, math.ts;
`enable_compile_cache` is JAX's compile cache and has no counterpart) and
of ``lodestar_tpu/utils/tracing.py`` `trace_region`, the latter on
`torch.profiler` instead of the XLA profiler. Set
``LODESTAR_TPU_TRACE=<dir>`` and every traced region (a verifier-pool batch
launch) writes a Chrome trace of the host and the card into that
directory; unset, the context manager is free (no profiler import).
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import random
import threading
import time
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")

__all__ = [
    "sleep",
    "backoff_delay",
    "retry",
    "retry_sync",
    "bytes_to_int",
    "int_to_bytes",
    "to_hex",
    "from_hex",
    "xor_bytes",
    "int_div_ceil",
    "bit_length",
    "ErrorAborted",
    "TimeoutError_",
    "trace_region",
    "tracing_enabled",
]


class ErrorAborted(Exception):
    """Operation cancelled by an abort signal (reference utils/errors.ts)."""


TimeoutError_ = asyncio.TimeoutError


async def sleep(seconds: float) -> None:
    await asyncio.sleep(seconds)


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
    is a true upper bound even at saturation). Used by `retry`'s backoff
    mode and the circuit breaker's half-open schedule."""
    if attempt < 0:
        raise ValueError("attempt must be >= 0")
    delay = base * (factor ** attempt)
    if max_delay is not None:
        delay = min(delay, max_delay)
    if jitter:
        delay -= delay * jitter * rng()
    return delay


def _retry_delay_for(
    attempt: int,
    retry_delay: float,
    backoff_factor: float | None,
    max_delay: float | None,
    jitter: float,
) -> float:
    """Fixed delay unless a backoff factor is given (keeps every
    existing fixed-delay caller's behavior bit-for-bit)."""
    if backoff_factor is None:
        return retry_delay
    return backoff_delay(
        attempt, base=retry_delay, factor=backoff_factor, max_delay=max_delay, jitter=jitter
    )


async def retry(
    fn: Callable[[], Awaitable[T]],
    *,
    retries: int = 3,
    retry_delay: float = 0.0,
    backoff_factor: float | None = None,
    max_delay: float | None = None,
    jitter: float = 0.0,
    should_retry: Callable[[Exception], bool] | None = None,
) -> T:
    """Async retry (reference `utils/src/retry.ts`). Default is the
    reference's fixed delay; passing `backoff_factor` switches to
    exponential backoff (`retry_delay * factor**attempt`) with an
    optional `max_delay` cap and `jitter` fraction.

    Only `Exception` is retried: cancellation (CancelledError) and
    KeyboardInterrupt propagate immediately.
    """
    if retries < 1:
        raise ValueError("retries must be >= 1")
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return await fn()
        except Exception as e:
            if should_retry is not None and not should_retry(e):
                raise
            last = e
            if attempt < retries - 1 and retry_delay:
                await asyncio.sleep(
                    _retry_delay_for(attempt, retry_delay, backoff_factor, max_delay, jitter)
                )
    assert last is not None
    raise last


def retry_sync(
    fn: Callable[[], T],
    *,
    retries: int = 3,
    retry_delay: float = 0.0,
    backoff_factor: float | None = None,
    max_delay: float | None = None,
    jitter: float = 0.0,
    should_retry: Callable[[Exception], bool] | None = None,
) -> T:
    if retries < 1:
        raise ValueError("retries must be >= 1")
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:
            if should_retry is not None and not should_retry(e):
                raise
            last = e
            if attempt < retries - 1 and retry_delay:
                time.sleep(
                    _retry_delay_for(attempt, retry_delay, backoff_factor, max_delay, jitter)
                )
    assert last is not None
    raise last


def bytes_to_int(data: bytes, endianness: str = "little") -> int:
    return int.from_bytes(data, endianness)  # type: ignore[arg-type]


def int_to_bytes(value: int, length: int, endianness: str = "little") -> bytes:
    return value.to_bytes(length, endianness)  # type: ignore[arg-type]


def to_hex(data: bytes) -> str:
    return "0x" + data.hex()


def from_hex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def xor_bytes(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def int_div_ceil(a: int, b: int) -> int:
    return -(-a // b)


def bit_length(n: int) -> int:
    return n.bit_length()


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
