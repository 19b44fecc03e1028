"""Priority classes + the weighted-fair launch queue.

The PyTorch port's copy of ``lodestar_tpu/scheduler/core.py``.

Scheduling scheme: stride scheduling (a deterministic weighted-fair
policy — Waldspurger & Weihl, OSDI '95). Each class keeps a virtual
"pass"; serving one job advances the class's pass by `STRIDE_SCALE /
weight`. Dequeue picks the non-empty class with the smallest pass,
priority order breaking ties, so with weights 64:16:8:2:1 a saturated
queue serves gossip blocks ~64x as often as backfill without ever
parking backfill forever. A class waking from idle joins at the current
service frontier (min pass over non-empty classes) so idle time earns no
burst credit. On top of fairness, starvation aging: any head-of-line job
that has waited longer than `aging_ms` is served immediately, oldest
first — the hard bound on bulk-class latency.

Asyncio-native and single-loop like the pool it feeds: `put_nowait` /
`get_nowait` run on the event loop; `get` parks on an Event. The
injectable `time_fn` keeps aging deterministic under test.
"""

from __future__ import annotations

import asyncio
import enum
import time
from collections import deque

__all__ = [
    "PriorityClass",
    "PriorityWorkQueue",
    "BULK_CLASSES",
    "DEFAULT_WEIGHTS",
    "DEFAULT_AGING_MS",
]


class PriorityClass(enum.IntEnum):
    """Launch classes, most- to least-urgent. Lower value wins ties."""

    GOSSIP_BLOCK = 0  # slot-deadline block import (gossip, is_timely)
    GOSSIP_ATTESTATION = 1  # gossip attestations/aggregates/sync messages
    API = 2  # REST submissions + direct imports
    RANGE_SYNC = 3  # forward sync segments
    BACKFILL = 4  # historical backfill batches

    @property
    def label(self) -> str:
        return self.name.lower()


#: classes a SHED_BULK admission state turns away
BULK_CLASSES = frozenset({PriorityClass.RANGE_SYNC, PriorityClass.BACKFILL})

#: service shares under saturation (stride = STRIDE_SCALE / weight)
DEFAULT_WEIGHTS: dict[PriorityClass, int] = {
    PriorityClass.GOSSIP_BLOCK: 64,
    PriorityClass.GOSSIP_ATTESTATION: 16,
    PriorityClass.API: 8,
    PriorityClass.RANGE_SYNC: 2,
    PriorityClass.BACKFILL: 1,
}

DEFAULT_AGING_MS = 2000.0  # bulk head-of-line jobs older than this jump the fair order

_STRIDE_SCALE = 1 << 20


class PriorityWorkQueue:
    """Multi-class work queue with stride-fair dequeue and aging.

    Items are opaque; the caller owns result futures / tracing parents.
    With `fifo=True` classes are ignored and arrival order rules — the
    pre-scheduler behavior, kept as the measurable control arm.
    """

    def __init__(
        self,
        *,
        weights: dict[PriorityClass, int] | None = None,
        aging_ms: float = DEFAULT_AGING_MS,
        fifo: bool = False,
        time_fn=time.monotonic_ns,
    ) -> None:
        self.fifo = fifo
        self._time_fn = time_fn
        self._aging_ns = aging_ms * 1e6
        w = dict(DEFAULT_WEIGHTS)
        if weights:
            w.update(weights)
        self._strides = {c: _STRIDE_SCALE // max(1, w[c]) for c in PriorityClass}
        self._pass = {c: 0 for c in PriorityClass}
        self._vtime = 0  # service frontier, survives the queue draining empty
        self._queues: dict[PriorityClass, deque] = {c: deque() for c in PriorityClass}
        self._size = 0
        self._event = asyncio.Event()
        self.starvation_promotions = 0
        self._last_was_promotion = False

    # -- ingress ---------------------------------------------------------------

    def put_nowait(self, item, cls: PriorityClass = PriorityClass.API) -> None:
        cls = PriorityClass(cls)
        q = self._queues[cls]
        if not q and not self.fifo:
            # waking from idle: join at the service frontier, no burst
            # credit — min over active passes, or the persisted frontier
            # when the whole queue had drained
            active = [self._pass[c] for c in PriorityClass if self._queues[c]]
            floor = min(active) if active else self._vtime
            self._pass[cls] = max(self._pass[cls], floor)
        q.append((item, self._time_fn()))
        self._size += 1
        self._event.set()

    # -- egress ----------------------------------------------------------------

    def _select_class(self) -> PriorityClass | None:
        nonempty = [c for c in PriorityClass if self._queues[c]]
        if not nonempty:
            return None
        if self.fifo:
            return min(nonempty, key=lambda c: self._queues[c][0][1])
        now = self._time_fn()
        fair = min(nonempty, key=lambda c: (self._pass[c], c))
        aged = [c for c in nonempty if now - self._queues[c][0][1] >= self._aging_ns]
        if aged:
            chosen = min(aged, key=lambda c: self._queues[c][0][1])
            # aging alternates with the fair pick: a fully-aged bulk
            # backlog under sustained saturation must not degenerate the
            # queue to global FIFO — an arriving urgent job waits out at
            # most ONE promotion before the fair order serves it
            if chosen is not fair and self._last_was_promotion:
                chosen = fair
            if chosen is not fair:
                self._last_was_promotion = True
                self.starvation_promotions += 1
                return chosen
        self._last_was_promotion = False
        return fair

    def get_nowait(
        self, cls: PriorityClass | None = None
    ) -> tuple[object, PriorityClass, int] | None:
        """Pop one item -> (item, class, waited_ns); None when empty.

        With `cls` given, pop from that class only (the pool's same-class
        package drain) — fairness accounting still advances."""
        if cls is not None:
            cls = PriorityClass(cls) if self._queues[PriorityClass(cls)] else None
            if cls is None:
                return None
        else:
            cls = self._select_class()
            if cls is None:
                return None
        item, enq_ns = self._queues[cls].popleft()
        self._size -= 1
        if self._size == 0:
            self._event.clear()
        if not self.fifo:
            self._pass[cls] += self._strides[cls]
            self._vtime = max(self._vtime, self._pass[cls])
        waited_ns = max(0, self._time_fn() - enq_ns)
        return item, cls, waited_ns

    async def get(self) -> tuple[object, PriorityClass, int]:
        while True:
            out = self.get_nowait()
            if out is not None:
                return out
            self._event.clear()
            await self._event.wait()

    def drain(self) -> list[tuple[object, PriorityClass, int]]:
        """Pop everything (shutdown path) in plain class order."""
        out = []
        for c in PriorityClass:
            while self._queues[c]:
                item, enq_ns = self._queues[c].popleft()
                self._size -= 1
                out.append((item, c, max(0, self._time_fn() - enq_ns)))
        self._event.clear()
        return out

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        return self._size

    def depth(self, cls: PriorityClass | None = None) -> int:
        if cls is None:
            return self._size
        return len(self._queues[PriorityClass(cls)])

    def depths(self) -> dict[str, int]:
        return {c.label: len(self._queues[c]) for c in PriorityClass}

    def stats(self) -> dict:
        """One-shot scheduler snapshot (debug):
        per-class depths plus the fairness counters that summarize how
        contended the queue has been so far."""
        return {
            "depths": self.depths(),
            "size": self._size,
            "starvation_promotions": self.starvation_promotions,
            "vtime": self._vtime,
        }
