"""Libp2pBeaconNetwork: the node's real network service (reference
`network/network.ts` Network class — the object that owns libp2p,
gossip, reqresp, the peer manager and the subnet subscriptions).

Composition:

* `Libp2pHost` (TCP + noise-XX + mplex) listens and dials
* `GossipSub` runs the eth2 topics; inbound messages are decompressed,
  SSZ-decoded by topic kind (fork resolved from the topic's fork
  digest) and pushed into the node's `NetworkProcessor` queues; decode
  failures REJECT (P4 penalty) and do not propagate
* `ReqRespBeaconNode` protocols are registered as host stream handlers;
  the client side dials `host.new_stream(peer, protocol)`
* `PeerManager` scores peers; a status handshake runs on every connect
  (reference `peerManager.ts` onStatus) and fork-digest-mismatched or
  irrelevant peers are disconnected
* static bootnode dialing stands in for discv5 (`network/discovery.py`
  provides the candidates)

Validation-vs-propagation note: the reference validates gossip BEFORE
propagating (validate-then-forward). Here structurally-invalid payloads
(snappy/SSZ failures) are rejected pre-propagation; semantic validation
happens in the processor's handlers after the queue hop, so a
well-formed-but-invalid message can propagate one hop before its sender
is downscored. Documented trade-off, revisit with inline validators.

The port of `lodestar_tpu.network.service` (host Python, as there).
"""

from __future__ import annotations

import asyncio

from lodestar_tpu_torch.config import FORK_ORDER
from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.reqresp.protocols import BEACON_PROTOCOLS
from lodestar_tpu_torch.types import ssz_types
from lodestar_tpu_torch.utils.snappy import SnappyError, decompress

from .gossip import topic_string
from .gossipsub import GossipSub
from .peers import PeerAction, PeerManager
from .reqresp_node import ReqRespBeaconNode
from .transport import Identity, Libp2pHost

__all__ = ["Libp2pBeaconNetwork", "GOSSIP_KIND_TYPES"]

# topic kind -> (type namespace attr, fork-namespaced?) for decoding.
# Subnet topics (beacon_attestation_N, sync_committee_N) strip the index.
GOSSIP_KIND_TYPES = {
    "beacon_block": "SignedBeaconBlock",
    "beacon_block_and_blobs_sidecar": "SignedBeaconBlockAndBlobsSidecar",
    "beacon_aggregate_and_proof": "SignedAggregateAndProof",
    "beacon_attestation": "Attestation",
    "voluntary_exit": "SignedVoluntaryExit",
    "proposer_slashing": "ProposerSlashing",
    "attester_slashing": "AttesterSlashing",
    "sync_committee_contribution_and_proof": "SignedContributionAndProof",
    "sync_committee": "SyncCommitteeMessage",
    "bls_to_execution_change": "SignedBLSToExecutionChange",
}


def _split_topic(topic: str) -> tuple[bytes, str] | None:
    """'/eth2/<digest>/<name>/ssz_snappy' -> (digest, kind) with subnet
    indices stripped from the kind."""
    parts = topic.split("/")
    if len(parts) != 5 or parts[1] != "eth2" or parts[4] != "ssz_snappy":
        return None
    try:
        digest = bytes.fromhex(parts[2])
    except ValueError:
        return None
    name = parts[3]
    for kind in ("beacon_attestation_", "sync_committee_"):
        if name.startswith(kind) and name[len(kind):].isdigit():
            return digest, kind[:-1]
    return digest, name


class Libp2pBeaconNetwork:
    def __init__(
        self,
        *,
        node,
        chain,
        listen_port: int = 0,
        bootnodes: list[tuple[str, int]] | None = None,
        identity: Identity | None = None,
        subscribe_subnets: int = 2,
        discv5_port: int | None = None,
        discv5_bootnodes: list | None = None,
        target_peers: int = 55,
    ):
        self.node = node
        self.chain = chain
        self.host = Libp2pHost(identity, listen_port=listen_port)
        self.gossip = GossipSub(self.host)
        self.reqresp = ReqRespBeaconNode(chain)
        self.peers = PeerManager()
        self.bootnodes = list(bootnodes or [])
        self.subscribe_subnets = subscribe_subnets
        self.log = get_logger(name="lodestar.network")
        chain.network = self  # node/api surfaces (node identity, peers) read this
        self._digest_to_fork: dict[bytes, str] = {}
        # optional discv5 DHT (None = static bootnodes only)
        self.discv5 = None
        self._discv5_port = discv5_port
        self._discv5_bootnodes = list(discv5_bootnodes or [])
        self.target_peers = target_peers
        self._discovery_task = None
        self._bootnode_task = None
        self.gossip.set_validator(self._validate_gossip)
        self.host.on_peer_connect = self._on_peer_connect
        self.host.on_peer_disconnect = self._on_peer_disconnect
        # reqresp protocols become host stream handlers
        for pid in BEACON_PROTOCOLS:
            if pid in self.reqresp._handlers:
                self.host.set_handler(pid, self._serve_stream)

    # -- lifecycle -------------------------------------------------------------

    async def start(self, host_addr: str = "127.0.0.1") -> int:
        from lodestar_tpu_torch.config import create_beacon_config

        gvr = bytes(self.chain.get_head_state().genesis_validators_root)
        self.beacon_cfg = create_beacon_config(self.chain.cfg, gvr)
        for fork in FORK_ORDER:
            self._digest_to_fork[self.beacon_cfg.fork_digest(fork)] = fork
        # fork-context wiring lives in ReqRespBeaconNode.__init__ (single
        # source); nothing to install here
        port = await self.host.listen(host_addr)
        self.gossip.start()
        await self._subscribe_core_topics()
        for (bhost, bport) in self.bootnodes:
            try:
                await self.host.connect(bhost, bport)
            except Exception as e:
                self.log.warn(f"bootnode {bhost}:{bport} dial failed: {e!r}")
        if self.bootnodes:
            # keep re-dialing static bootnodes while under-peered: a single
            # boot-time attempt loses the peer forever if the remote's event
            # loop was momentarily wedged (e.g. first jit compile of the STF)
            self._bootnode_task = asyncio.ensure_future(self._bootnode_redial_loop())

        # discv5 DHT: advertise our tcp endpoint + fork digest, discover
        # peers' tcp endpoints and keep dialing toward the target
        if self._discv5_port is not None:
            from lodestar_tpu_torch.network.discv5 import Discv5Node

            self.discv5 = Discv5Node(
                ip=host_addr,
                port=self._discv5_port,
                tcp_port=port,
                enr_extra={
                    b"eth2": self.current_fork_digest(),
                    b"attnets": self.attnets_bytes(),
                    b"syncnets": self.syncnets_bytes(),
                },
                bootnodes=self._discv5_bootnodes,
            )
            await self.discv5.start()
            self._discovery_task = asyncio.ensure_future(self._discovery_loop())

        self.log.info(f"p2p listening on {host_addr}:{port} as {self.host.peer_id}")
        return port

    async def _bootnode_redial_loop(self, interval: float = 5.0) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                if len(self.host.peers()) >= max(1, min(self.target_peers, len(self.bootnodes))):
                    continue
                live = {pc.addr for pc in self.host.connections.values()}
                for (bhost, bport) in self.bootnodes:
                    if (bhost, bport) in live:
                        continue  # re-dialing would tear down the live conn
                    try:
                        await self.host.connect(bhost, bport)
                        self.log.info(f"bootnode {bhost}:{bport} connected on retry")
                    except Exception as e:
                        self.log.debug(f"bootnode {bhost}:{bport} redial failed: {e!r}")
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.log.debug(f"bootnode redial loop error: {e!r}")

    async def _discovery_loop(self, interval: float = 5.0) -> None:
        """Bootstrap the DHT while under-peered, then dial discovered
        TCP endpoints (reference peers/discover.ts driving dials from
        discv5 ENRs). Per-node dial backoff prevents both re-dial churn
        of live inbound peers and hammering refusing endpoints."""
        import time as _time

        dialed: dict[bytes, tuple[float, str | None]] = {}
        #   discv5 node id -> (last dial time, connected libp2p peer id)
        DIAL_BACKOFF = 60.0
        while True:
            try:
                if len(self.host.peers()) >= self.target_peers:
                    await asyncio.sleep(interval)
                    continue
                # keep the ENR's fork digest current across transitions
                digest = self.current_fork_digest()
                if self.discv5.enr.pairs.get(b"eth2") != digest:
                    self.discv5.enr.pairs[b"eth2"] = digest
                    self.discv5.enr.seq += 1
                    self.discv5.enr.sign(self.discv5.key)
                await self.discv5.bootstrap(rounds=1)
                now = _time.monotonic()
                # subnet-aware ordering: ENRs advertising attnets we
                # subscribe to dial first (reference peers/discover.ts
                # subnet-driven discovery over ENR attnets bitfields)
                wanted = set(range(min(self.subscribe_subnets, 64)))
                candidates = sorted(
                    self.discv5.enr_source(),
                    key=lambda e: not any(
                        self.enr_has_attnet(e, s) for s in wanted
                    ),
                )
                for enr in candidates:
                    if enr.node_id == self.discv5.node_id:
                        continue
                    if enr.pairs.get(b"eth2", digest) != digest:
                        continue  # wrong fork
                    tcp = enr.pairs.get(b"tcp")
                    ep = enr.udp_endpoint
                    if not tcp or ep is None:
                        continue
                    last, peer_id = dialed.get(enr.node_id, (0.0, None))
                    if peer_id is not None and peer_id in self.host.connections:
                        continue  # already connected to this node
                    if now - last < DIAL_BACKOFF:
                        continue
                    dialed[enr.node_id] = (now, None)
                    try:
                        pc = await self.host.connect(ep[0], int.from_bytes(tcp, "big"))
                        dialed[enr.node_id] = (now, pc.peer_id)
                    except Exception:
                        continue
                    if len(self.host.peers()) >= self.target_peers:
                        break
            except asyncio.CancelledError:
                return
            except Exception as e:
                self.log.debug(f"discovery loop error: {e!r}")
            await asyncio.sleep(interval)

    async def stop(self) -> None:
        if self._discovery_task is not None:
            self._discovery_task.cancel()
            self._discovery_task = None
        if self._bootnode_task is not None:
            self._bootnode_task.cancel()
            self._bootnode_task = None
        if self.discv5 is not None:
            await self.discv5.stop()
            self.discv5 = None
        # goodbye to connected peers (reference goodbyeAndDisconnectAllPeers)
        for peer in list(self.host.peers()):
            try:
                await asyncio.wait_for(self._request(peer, "goodbye", 1), 2.0)
            except Exception:
                pass
        await self.gossip.stop()
        await self.host.close()

    @property
    def peer_id(self) -> str:
        return self.host.peer_id

    def current_fork_digest(self) -> bytes:
        fork = self.chain.fork_name_at_slot(self.chain.fork_choice.current_slot)
        return self.beacon_cfg.fork_digest(fork)

    def attnets_bytes(self) -> bytes:
        """SSZ Bitvector[64] of subscribed attestation subnets — the value
        advertised in the ENR `attnets` pair and in metadata (reference
        `network/metadata.ts:49`)."""
        bits = bytearray(8)
        for subnet in range(min(self.subscribe_subnets, 64)):
            bits[subnet // 8] |= 1 << (subnet % 8)
        return bytes(bits)

    def syncnets_bytes(self) -> bytes:
        """SSZ Bitvector[4] of sync-committee subnets (none yet)."""
        return b"\x00"

    @staticmethod
    def enr_has_attnet(enr, subnet: int) -> bool:
        """Does a discovered ENR advertise attestation subnet `subnet`?"""
        raw = enr.pairs.get(b"attnets")
        if not raw or subnet // 8 >= len(raw):
            return False
        return bool(raw[subnet // 8] & (1 << (subnet % 8)))

    async def _subscribe_core_topics(self) -> None:
        digest = self.current_fork_digest()
        kinds = [
            "beacon_block",
            "beacon_aggregate_and_proof",
            "voluntary_exit",
            "proposer_slashing",
            "attester_slashing",
        ]
        fork = self._digest_to_fork.get(digest)
        if fork not in (None, "phase0", "altair", "bellatrix"):
            kinds.append("bls_to_execution_change")
        if fork == "deneb":
            kinds[0] = "beacon_block_and_blobs_sidecar"
        from lodestar_tpu_torch.network.gossipsub import eth2_topic_score_params

        for kind in kinds:
            topic = topic_string(kind, digest)
            self.gossip.set_topic_params(topic, eth2_topic_score_params(kind))
            await self.gossip.subscribe(topic)
        for subnet in range(self.subscribe_subnets):
            kind = f"beacon_attestation_{subnet}"
            topic = topic_string(kind, digest)
            self.gossip.set_topic_params(topic, eth2_topic_score_params(kind))
            await self.gossip.subscribe(topic)

    # -- gossip ingress --------------------------------------------------------

    async def _validate_gossip(self, topic: str, raw: bytes, peer: str):
        split = _split_topic(topic)
        if split is None:
            return "reject", b""
        digest, kind = split
        fork = self._digest_to_fork.get(digest)
        if fork is None:
            return "reject", b""
        type_name = GOSSIP_KIND_TYPES.get(kind)
        if type_name is None:
            return "ignore", b""
        try:
            ssz = decompress(raw)
        except SnappyError:
            self._report(peer, PeerAction.LOW_TOLERANCE_ERROR)
            return "reject", b""
        t = ssz_types(self.chain.p)
        ns = getattr(t, fork, t)
        typ = getattr(ns, type_name, None) or getattr(t, type_name, None)
        if typ is None:
            return "ignore", b""
        try:
            msg = typ.deserialize(ssz)
        except Exception:
            self._report(peer, PeerAction.LOW_TOLERANCE_ERROR)
            return "reject", b""
        accepted = self.node.on_gossip(kind, msg, peer=peer)
        if not accepted:
            return "ignore", ssz  # queue full: don't propagate stale load
        return "accept", ssz

    # -- reqresp ---------------------------------------------------------------

    async def _serve_stream(self, stream, peer_id: str) -> None:
        await self.reqresp.handle_stream(stream, stream, peer_id=peer_id)

    async def _request(
        self, peer_id: str, name: str, request, max_chunks=None, version: int = 1
    ):
        pid = f"/eth2/beacon_chain/req/{name}/{version}/ssz_snappy"

        async def dial():
            s = await self.host.new_stream(peer_id, pid)
            return s, s

        return await self.reqresp.send_request(dial, pid, request, max_chunks=max_chunks)

    async def _request_versioned(
        self, peer_id: str, name: str, request, max_chunks=None, versions=(2, 1)
    ):
        """Dial the newest protocol version first, fall back ONLY on a
        multistream 'na' (the peer does not speak that version — reference
        dials V2 with V1 fallback for block protocols). Transport faults
        and response errors propagate: falling back on them would let a
        mid-stream failure masquerade as a short valid response."""
        from lodestar_tpu_torch.network.transport.multistream import NegotiationError

        last = None
        for v in versions:
            try:
                return await self._request(
                    peer_id, name, request, max_chunks=max_chunks, version=v
                )
            except NegotiationError as e:
                last = e
        raise last

    async def status(self, peer_id: str):
        out = await self._request(peer_id, "status", self.reqresp.local_status())
        return out[0] if out else None

    async def blocks_by_range(self, peer_id: str, start_slot: int, count: int):
        t = ssz_types(self.chain.p)
        req = t.BeaconBlocksByRangeRequest.default()
        req.start_slot = start_slot
        req.count = count
        req.step = 1
        return await self._request_versioned(peer_id, "beacon_blocks_by_range", req)

    async def blobs_by_range(self, peer_id: str, start_slot: int, count: int):
        t = ssz_types(self.chain.p)
        req = t.BlobsSidecarsByRangeRequest.default()
        req.start_slot = start_slot
        req.count = count
        return await self._request(peer_id, "blobs_sidecars_by_range", req)

    async def blocks_by_root(self, peer_id: str, roots: list[bytes]):
        # request type is List[Bytes32]; the engine serializes the raw list
        return await self._request_versioned(peer_id, "beacon_blocks_by_root", list(roots))

    # -- gossip egress ---------------------------------------------------------

    async def publish(self, kind: str, msg, fork: str | None = None) -> int:
        """Serialize + publish a typed message on the current-fork topic."""
        t = ssz_types(self.chain.p)
        fork = fork or self.chain.fork_name_at_slot(self.chain.fork_choice.current_slot)
        digest = self.beacon_cfg.fork_digest(fork)
        type_name = GOSSIP_KIND_TYPES.get(
            "beacon_attestation" if kind.startswith("beacon_attestation_") else kind
        )
        ns = getattr(t, fork, t)
        typ = getattr(ns, type_name, None) or getattr(t, type_name, None)
        ssz = typ.serialize(msg)
        return await self.gossip.publish(topic_string(kind, digest), ssz)

    async def publish_block(self, signed_block) -> int:
        slot = int(signed_block.message.slot)
        fork = self.chain.fork_name_at_slot(slot)
        if fork == "deneb":
            raise ValueError("deneb blocks publish as beacon_block_and_blobs_sidecar")
        return await self.publish("beacon_block", signed_block, fork=fork)

    # -- peer lifecycle --------------------------------------------------------

    def _report(self, peer_id: str, action: PeerAction) -> None:
        state = self.peers.report_peer(peer_id, action)
        if state.value != "Healthy":
            conn = self.host.connections.get(peer_id)
            if conn is not None:
                conn.close()

    async def _on_peer_connect(self, peer_id: str) -> None:
        self.peers.on_connect(peer_id)
        await self.gossip._on_peer(peer_id)
        # status handshake (reference onStatus): wrong fork -> disconnect
        try:
            remote = await self.status(peer_id)
        except Exception as e:
            self.log.debug(f"status handshake with {peer_id[:8]} failed: {e}")
            return
        if remote is None:
            return
        local = self.reqresp.local_status()
        if int(remote.finalized_epoch) < 0:  # placeholder sanity gate
            self._report(peer_id, PeerAction.FATAL)
        self.log.info(
            f"peer {peer_id[:8]} head_slot={int(remote.head_slot)} "
            f"finalized_epoch={int(remote.finalized_epoch)} "
            f"(local head {int(local.head_slot)})"
        )

    async def _on_peer_disconnect(self, peer_id: str) -> None:
        self.peers.on_disconnect(peer_id)
