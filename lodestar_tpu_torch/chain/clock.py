"""Slot/epoch clock (reference `beacon-node/src/util/clock.ts:66`).

Asyncio re-design of the EventEmitter clock: slot/epoch callbacks fire
from one timer task; gossip-disparity helpers mirror the reference's
MAXIMUM_GOSSIP_CLOCK_DISPARITY (500 ms) semantics. A injectable
`time_fn` makes the clock fully deterministic in tests.

The port of `lodestar_tpu.chain.clock` (host Python and numpy, as there).
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable

__all__ = ["Clock", "MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC"]

MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC = 0.5


class Clock:
    def __init__(
        self,
        *,
        genesis_time: int,
        seconds_per_slot: int,
        slots_per_epoch: int,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.slots_per_epoch = slots_per_epoch
        self._time = time_fn
        self._on_slot: list[Callable[[int], None]] = []
        self._on_epoch: list[Callable[[int], None]] = []
        self._task: asyncio.Task | None = None

    # -- pure time math -------------------------------------------------------

    @property
    def current_slot(self) -> int:
        return max(0, int(self._time() - self.genesis_time) // self.seconds_per_slot)

    @property
    def current_epoch(self) -> int:
        return self.current_slot // self.slots_per_epoch

    def time_at_slot(self, slot: int) -> float:
        return self.genesis_time + slot * self.seconds_per_slot

    def sec_from_slot(self, slot: int, to_sec: float | None = None) -> float:
        return (to_sec if to_sec is not None else self._time()) - self.time_at_slot(slot)

    def slot_with_future_tolerance(self, tolerance_sec: float) -> int:
        return max(0, int(self._time() + tolerance_sec - self.genesis_time) // self.seconds_per_slot)

    def slot_with_past_tolerance(self, tolerance_sec: float) -> int:
        return max(0, int(self._time() - tolerance_sec - self.genesis_time) // self.seconds_per_slot)

    @property
    def current_slot_with_gossip_disparity(self) -> int:
        cur = self.current_slot
        next_slot_time = self.time_at_slot(cur + 1)
        if next_slot_time - self._time() < MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC:
            return cur + 1
        return cur

    def is_current_slot_given_gossip_disparity(self, slot: int) -> bool:
        return (
            self.slot_with_past_tolerance(MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC)
            <= slot
            <= self.slot_with_future_tolerance(MAXIMUM_GOSSIP_CLOCK_DISPARITY_SEC)
        )

    # -- events ---------------------------------------------------------------

    def on_slot(self, fn: Callable[[int], None]) -> None:
        self._on_slot.append(fn)

    def on_epoch(self, fn: Callable[[int], None]) -> None:
        self._on_epoch.append(fn)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            cur = self.current_slot
            next_time = self.time_at_slot(cur + 1)
            await asyncio.sleep(max(0.0, next_time - self._time()))
            slot = self.current_slot
            for fn in self._on_slot:
                fn(slot)
            if slot % self.slots_per_epoch == 0:
                for fn in self._on_epoch:
                    fn(slot // self.slots_per_epoch)

    async def wait_for_slot(self, slot: int) -> None:
        while self.current_slot < slot:
            await asyncio.sleep(
                max(0.01, self.time_at_slot(slot) - self._time())
            )
