"""Remote monitoring service (reference
`beacon-node/src/monitoring/service.ts:31-33,123-150`): periodically push
beaconcha.in-style client stats (process + beacon-node records) to a
remote endpoint. Transport injected for testability; scheduling via
asyncio like the reference's setTimeout loop.

The port of `lodestar_tpu.metrics.monitoring`, with its imports rewritten.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import urllib.request

from lodestar_tpu_torch.logger import get_logger

__all__ = ["MonitoringService", "EventLoopLagSampler"]

VERSION = "lodestar-tpu/0.3.0"


class EventLoopLagSampler:
    """Clock-drift sampler behind `ProcessMetrics.event_loop_lag`
    (reference nodeJsUtil monitorEventLoopDelay analogue): sleep a fixed
    interval on the loop and observe how late the wakeup lands — the
    overshoot is exactly the scheduling lag other tasks inflicted. The
    last sample is also surfaced into slow-slot trace dumps (via
    `Tracer.lag_ms_supplier`) so a dump distinguishes an event loop
    starved by Python work from a genuinely slow device pipeline."""

    def __init__(self, histogram=None, *, interval_s: float = 0.5) -> None:
        self.histogram = histogram
        self.interval = interval_s
        self.last_lag_s: float | None = None
        self._task: asyncio.Task | None = None

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
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(self.interval)
            lag = max(0.0, loop.time() - t0 - self.interval)
            self.last_lag_s = lag
            if self.histogram is not None:
                try:
                    self.histogram.observe(lag)
                except Exception:
                    pass  # metric bridge must never kill the sampler

    def last_lag_ms(self) -> float | None:
        return None if self.last_lag_s is None else self.last_lag_s * 1000.0


class MonitoringService:
    def __init__(
        self,
        *,
        endpoint: str,
        chain=None,
        interval_sec: float = 60.0,
        send_fn=None,
    ) -> None:
        self.endpoint = endpoint
        self.chain = chain
        self.interval = interval_sec
        self._send = send_fn or self._http_send
        self._task: asyncio.Task | None = None
        self._start_time = time.time()
        self.log = get_logger(name="lodestar.monitoring")

    # -- stats records (service.ts collectData shape) -------------------------

    def collect(self) -> list[dict]:
        now_ms = int(time.time() * 1000)
        process = {
            "version": 1,
            "timestamp": now_ms,
            "process": "beaconnode",
            "client_name": "lodestar-tpu",
            "client_version": VERSION,
            "cpu_process_seconds_total": int(time.process_time()),
            "memory_process_bytes": _rss_bytes(),
            "sync_eth2_synced": True,
        }
        if self.chain is not None:
            head = self.chain.fork_choice.proto_array.get_block(self.chain.fork_choice.head)
            process.update(
                {
                    "sync_beacon_head_slot": head.slot if head else 0,
                    "slasher_active": False,
                }
            )
        return [process]

    # -- loop -----------------------------------------------------------------

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
        loop = asyncio.get_running_loop()
        while True:
            try:
                # the HTTP push is blocking urllib: keep it off the loop
                await loop.run_in_executor(None, self._send, self.collect())
            except Exception as e:
                self.log.warn(f"monitoring push failed: {e!r}")
            await asyncio.sleep(self.interval)

    def _http_send(self, records: list[dict]) -> None:
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(records).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=10).read()


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0
