"""Gossip topics, encoding and the in-process bus.

The port of `lodestar_tpu.network.gossip` (host Python, as there).
"""

from __future__ import annotations

import asyncio
import hashlib
from dataclasses import dataclass
from typing import Awaitable, Callable

from lodestar_tpu_torch.utils.snappy import SnappyError, compress, decompress

__all__ = ["GossipTopic", "topic_string", "compute_message_id", "GossipBus"]

MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"
MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"


@dataclass(frozen=True)
class GossipTopic:
    kind: str  # beacon_block, beacon_attestation_{subnet}, ...
    fork_digest: bytes

    def __str__(self) -> str:
        return topic_string(self.kind, self.fork_digest)


def topic_string(kind: str, fork_digest: bytes) -> str:
    return f"/eth2/{fork_digest.hex()}/{kind}/ssz_snappy"


def compute_message_id(raw_payload: bytes) -> bytes:
    """Spec gossip message-id over the snappy-compressed payload."""
    try:
        data = decompress(raw_payload)
        domain = MESSAGE_DOMAIN_VALID_SNAPPY
    except SnappyError:
        data = raw_payload
        domain = MESSAGE_DOMAIN_INVALID_SNAPPY
    return hashlib.sha256(domain + data).digest()[:20]


Handler = Callable[[bytes, str], Awaitable[None]]  # (ssz_bytes, from_peer)


class GossipBus:
    """In-process pubsub: nodes subscribe handlers per topic; publishes
    snappy-compress, dedup by message id, and fan out to every OTHER
    subscriber (a node does not hear its own publish), mirroring gossipsub
    delivery semantics for single-process multi-node tests."""

    def __init__(self) -> None:
        self._subs: dict[str, list[tuple[str, Handler]]] = {}
        self._seen: set[bytes] = set()
        self.delivered = 0
        self.deduped = 0

    def subscribe(self, topic: GossipTopic | str, peer_id: str, handler: Handler) -> None:
        self._subs.setdefault(str(topic), []).append((peer_id, handler))

    def unsubscribe(self, topic: GossipTopic | str, peer_id: str) -> None:
        subs = self._subs.get(str(topic), [])
        self._subs[str(topic)] = [(p, h) for p, h in subs if p != peer_id]

    async def publish(self, topic: GossipTopic | str, ssz_bytes: bytes, from_peer: str) -> int:
        raw = compress(ssz_bytes)
        msg_id = compute_message_id(raw)
        if msg_id in self._seen:
            self.deduped += 1
            return 0
        self._seen.add(msg_id)
        count = 0
        for peer_id, handler in self._subs.get(str(topic), []):
            if peer_id == from_peer:
                continue
            await handler(ssz_bytes, from_peer)
            count += 1
        self.delivered += count
        return count
