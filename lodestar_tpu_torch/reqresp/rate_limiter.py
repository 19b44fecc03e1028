"""Per-peer token-bucket rate limiter (reference
`reqresp/src/rate_limiter/` — quota per protocol per peer + global).

The port of `lodestar_tpu.reqresp.rate_limiter` (host Python, as there).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

__all__ = ["RateLimiterQuota", "RateLimiter"]


@dataclass(frozen=True)
class RateLimiterQuota:
    quota: int  # tokens per period
    period_sec: float


class _Bucket:
    __slots__ = ("tokens", "last")

    def __init__(self, quota: int):
        self.tokens = float(quota)
        self.last = time.monotonic()


class RateLimiter:
    def __init__(self, quota: RateLimiterQuota, *, time_fn=time.monotonic):
        self.quota = quota
        self._time = time_fn
        self._buckets: dict[str, _Bucket] = {}

    def allows(self, peer_id: str, cost: int = 1) -> bool:
        b = self._buckets.get(peer_id)
        now = self._time()
        if b is None:
            b = _Bucket(self.quota.quota)
            b.last = now
            self._buckets[peer_id] = b
        # refill
        b.tokens = min(
            float(self.quota.quota),
            b.tokens + (now - b.last) * self.quota.quota / self.quota.period_sec,
        )
        b.last = now
        if b.tokens >= cost:
            b.tokens -= cost
            return True
        return False

    def prune(self, older_than_sec: float = 600.0) -> None:
        now = self._time()
        for pid in [p for p, b in self._buckets.items() if now - b.last > older_than_sec]:
            del self._buckets[pid]
