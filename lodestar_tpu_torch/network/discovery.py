"""Subnet-aware peer discovery coordinator.

Reference `beacon-node/src/network/peers/discover.ts` (PeerDiscovery:
subnet queries against discv5 ENRs' attnets/syncnets bitfields, dialing
until targets are met) and `network/discv5/` (the DHT itself runs in a
worker). The DHT transport is pluggable here: an `enr_source` yields
candidate records (a real discv5 binding in deployment, static
bootnodes/tests otherwise); this module does the subnet matching,
dedup, and dial-budget logic.

The port of `lodestar_tpu.network.discovery` (host Python, as there).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import ATTESTATION_SUBNET_COUNT, SYNC_COMMITTEE_SUBNET_COUNT

__all__ = ["EnrRecord", "PeerDiscovery", "SubnetRequest"]

MAX_DIALS_PER_QUERY = 16


@dataclass
class EnrRecord:
    """The subset of an ENR the peer selector reads (reference
    discv5 ENR 'attnets'/'syncnets' keys, network/metadata.ts)."""

    node_id: str
    multiaddr: str = ""
    attnets: list = field(default_factory=lambda: [False] * ATTESTATION_SUBNET_COUNT)
    syncnets: list = field(default_factory=lambda: [False] * SYNC_COMMITTEE_SUBNET_COUNT)

    def serves(self, kind: str, subnet: int) -> bool:
        nets = self.attnets if kind == "attnet" else self.syncnets
        return bool(nets[subnet]) if 0 <= subnet < len(nets) else False


@dataclass
class SubnetRequest:
    kind: str  # "attnet" | "syncnet"
    subnet: int
    peers_needed: int


class PeerDiscovery:
    """Match subnet needs against discovered ENRs and dial through the
    peer manager (reference discover.ts discoverPeers)."""

    DIAL_RETRY_SECONDS = 30.0

    def __init__(self, *, enr_source, dial, connected, time_fn=None) -> None:
        """enr_source() -> iterable[EnrRecord]; dial(record) -> None;
        connected() -> set of node_ids already connected."""
        import time

        self.enr_source = enr_source
        self.dial = dial
        self.connected = connected
        self.time_fn = time_fn or time.monotonic
        self.log = get_logger(name="lodestar.discovery")
        # node_id -> dial start time: an attempt that neither connects
        # nor reports a disconnect (timeout, crash in dial) becomes
        # retriable after DIAL_RETRY_SECONDS instead of being excluded
        # for the process lifetime
        self._dialing: dict[str, float] = {}

    def on_peer_connected(self, node_id: str) -> None:
        self._dialing.pop(node_id, None)

    def on_peer_disconnected(self, node_id: str) -> None:
        self._dialing.pop(node_id, None)

    def _dial_in_flight(self, node_id: str) -> bool:
        started = self._dialing.get(node_id)
        if started is None:
            return False
        if self.time_fn() - started > self.DIAL_RETRY_SECONDS:
            del self._dialing[node_id]
            return False
        return True

    def discover_peers(self, requests: list[SubnetRequest]) -> int:
        """Dial up to MAX_DIALS_PER_QUERY candidates covering the
        requested subnets, most-needed first. Returns dials issued."""
        if not requests:
            return 0
        needed = {(r.kind, r.subnet): r.peers_needed for r in requests if r.peers_needed > 0}
        if not needed:
            return 0
        connected = set(self.connected())
        dials = 0
        for record in self.enr_source():
            if dials >= MAX_DIALS_PER_QUERY:
                break
            if record.node_id in connected or self._dial_in_flight(record.node_id):
                continue
            serves = [k for k in needed if record.serves(*k)]
            if not serves:
                continue
            self._dialing[record.node_id] = self.time_fn()
            try:
                self.dial(record)
            except Exception as e:
                self._dialing.pop(record.node_id, None)
                self.log.debug("dial failed", {"peer": record.node_id, "error": str(e)})
                continue
            dials += 1
            for k in serves:
                needed[k] -= 1
                if needed[k] <= 0:
                    del needed[k]
            if not needed:
                break
        return dials
