"""Peer scoring + manager (reference `network/peers/score.ts`,
`peerManager.ts:126`): exponential-decay score, action penalties,
ban/disconnect thresholds, target-peer maintenance.

The port of `lodestar_tpu.network.peers` (host Python, as there).
"""

from __future__ import annotations

import enum
import math
import time
from dataclasses import dataclass, field

__all__ = ["PeerAction", "PeerScore", "PeerManager", "ScoreState"]

# reference score.ts constants
GOSSIPSUB_NEGATIVE_SCORE_WEIGHT = 1.0
MIN_SCORE = -100.0
MAX_SCORE = 100.0
SCORE_HALFLIFE_SEC = 600.0
BAN_THRESHOLD = -50.0
DISCONNECT_THRESHOLD = -20.0


class PeerAction(enum.Enum):
    # reference PeerAction penalties
    FATAL = -100.0
    LOW_TOLERANCE_ERROR = -10.0
    MID_TOLERANCE_ERROR = -5.0
    HIGH_TOLERANCE_ERROR = -1.0


class ScoreState(enum.Enum):
    HEALTHY = "Healthy"
    DISCONNECT = "Disconnect"
    BANNED = "Banned"


class PeerScore:
    def __init__(self, *, time_fn=time.monotonic):
        self._time = time_fn
        self._score = 0.0
        self._last = time_fn()

    def _decay(self) -> None:
        now = self._time()
        dt = now - self._last
        if dt > 0:
            self._score *= math.exp(-math.log(2) * dt / SCORE_HALFLIFE_SEC)
            self._last = now

    @property
    def score(self) -> float:
        self._decay()
        return self._score

    def apply(self, action: PeerAction) -> None:
        self._decay()
        self._score = max(MIN_SCORE, min(MAX_SCORE, self._score + action.value))

    @property
    def state(self) -> ScoreState:
        s = self.score
        if s <= BAN_THRESHOLD:
            return ScoreState.BANNED
        if s <= DISCONNECT_THRESHOLD:
            return ScoreState.DISCONNECT
        return ScoreState.HEALTHY


@dataclass
class _PeerInfo:
    peer_id: str
    score: PeerScore
    connected: bool = True
    metadata: object | None = None


class PeerManager:
    """Track connected peers, score them, select good peers for sync
    (reference `peerManager.ts` heartbeat: prune to target, ban bad)."""

    def __init__(self, *, target_peers: int = 55, time_fn=time.monotonic):
        self.target_peers = target_peers
        self._time = time_fn
        self._peers: dict[str, _PeerInfo] = {}

    def on_connect(self, peer_id: str) -> None:
        if peer_id not in self._peers:
            self._peers[peer_id] = _PeerInfo(peer_id, PeerScore(time_fn=self._time))
        self._peers[peer_id].connected = True

    def on_disconnect(self, peer_id: str) -> None:
        if peer_id in self._peers:
            self._peers[peer_id].connected = False

    def report_peer(self, peer_id: str, action: PeerAction) -> ScoreState:
        info = self._peers.get(peer_id)
        if info is None:
            return ScoreState.HEALTHY
        info.score.apply(action)
        state = info.score.state
        if state is not ScoreState.HEALTHY:
            info.connected = False  # heartbeat would disconnect/ban
        return state

    def connected_peers(self) -> list[str]:
        return [p.peer_id for p in self._peers.values() if p.connected]

    def best_peers(self, n: int | None = None) -> list[str]:
        peers = sorted(
            (p for p in self._peers.values() if p.connected),
            key=lambda p: p.score.score,
            reverse=True,
        )
        return [p.peer_id for p in peers[: n or self.target_peers]]

    def heartbeat(self) -> None:
        """Prune excess peers, dropping the worst-scored first."""
        connected = sorted(
            (p for p in self._peers.values() if p.connected),
            key=lambda p: p.score.score,
        )
        excess = len(connected) - self.target_peers
        for p in connected[:max(0, excess)]:
            p.connected = False
