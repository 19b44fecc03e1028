"""Bounded async job queues (reference `util/queue/itemQueue.ts:11`,
`util/queue/fnQueue.ts`).

Semantics match the reference: FIFO rejects new work when full (callers
see QueueError and shed load upstream), LIFO drops the OLDEST job to
keep the freshest (gossip attestation policy). One job runs at a time;
the runner yields to the event loop between jobs so a deep queue can't
starve timers/transports (the reference yields every 50ms).

The port of `lodestar_tpu.utils.queue` (host Python and numpy, as there).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Awaitable, Callable

__all__ = ["JobItemQueue", "QueueError", "QueueType"]

_YIELD_EVERY_MS = 50


class QueueType:
    FIFO = "FIFO"
    LIFO = "LIFO"


class QueueError(Exception):
    def __init__(self, code: str = "QUEUE_MAX_LENGTH"):
        super().__init__(code)
        self.code = code


class JobItemQueue:
    """Serialize calls to `fn` through a bounded queue.

    `await queue.push(*args)` resolves with `fn(*args)`'s result (fn may
    be sync or async). `job_len` counts queued + running jobs — the
    regen/BLS `can_accept_work` admission checks read it.
    """

    def __init__(
        self,
        fn: Callable[..., Any | Awaitable[Any]],
        *,
        max_length: int = 256,
        queue_type: str = QueueType.FIFO,
        metrics=None,
    ) -> None:
        self._fn = fn
        self.max_length = max_length
        self.queue_type = queue_type
        self.metrics = metrics
        self._jobs: deque[tuple[asyncio.Future, tuple, float]] = deque()
        self._running = False  # a runner task is alive
        self._active = False  # a job is popped and executing right now
        self._last_yield = 0.0

    @property
    def job_len(self) -> int:
        return len(self._jobs) + (1 if self._active else 0)

    async def push(self, *args):
        if len(self._jobs) + 1 > self.max_length:
            if self.queue_type == QueueType.LIFO:
                dropped_fut, _, _ = self._jobs.popleft()
                if not dropped_fut.done():
                    dropped_fut.set_exception(QueueError("QUEUE_DROPPED_JOB"))
                if self.metrics is not None:
                    self.metrics.dropped_jobs.inc()
            else:
                if self.metrics is not None:
                    self.metrics.rejected_jobs.inc()
                raise QueueError("QUEUE_MAX_LENGTH")
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._jobs.append((fut, args, time.monotonic()))  # LIFO pops from the right
        if not self._running:
            # claim the runner slot synchronously: two pushes in the same
            # tick must not spawn two runners (serialization guarantee)
            self._running = True
            asyncio.ensure_future(self._run())
        return await fut

    async def _run(self) -> None:
        try:
            while self._jobs:
                if self.queue_type == QueueType.LIFO:
                    fut, args, queued_at = self._jobs.pop()
                else:
                    fut, args, queued_at = self._jobs.popleft()
                if fut.done():  # dropped while queued
                    continue
                if self.metrics is not None:
                    self.metrics.job_wait_time.observe(time.monotonic() - queued_at)
                self._active = True
                try:
                    res = self._fn(*args)
                    if asyncio.iscoroutine(res):
                        res = await res
                    if not fut.done():
                        fut.set_result(res)
                except Exception as e:  # propagate to the caller, keep draining
                    if not fut.done():
                        fut.set_exception(e)
                finally:
                    self._active = False
                # cooperative yield (reference itemQueue.ts:107)
                now = time.monotonic()
                if (now - self._last_yield) * 1000 >= _YIELD_EVERY_MS:
                    self._last_yield = now
                    await asyncio.sleep(0)
        finally:
            self._running = False

    def drop_all(self) -> None:
        while self._jobs:
            fut, _, _ = self._jobs.popleft()
            if not fut.done():
                fut.set_exception(QueueError("QUEUE_ABORTED"))
