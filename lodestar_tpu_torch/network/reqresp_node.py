"""Beacon-node req/resp handlers over the chain.

Reference `beacon-node/src/network/reqresp/ReqRespBeaconNode.ts:61` +
`handlers/index.ts`: status from fork choice, blocksByRange/Root from the
hot db + canonical chain walk, ping/metadata from local state.

The port of `lodestar_tpu.network.reqresp_node` (host Python, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.reqresp import RateLimiterQuota, ReqResp, ReqRespError
from lodestar_tpu_torch.types import ssz_types

__all__ = ["ReqRespBeaconNode", "MAX_REQUEST_BLOCKS_PER_CALL"]

MAX_REQUEST_BLOCKS_PER_CALL = 1024


def _pid(name: str, version: int = 1) -> str:
    return f"/eth2/beacon_chain/req/{name}/{version}/ssz_snappy"


class ReqRespBeaconNode(ReqResp):
    """ReqResp engine with the beacon protocol handlers registered."""

    def __init__(self, chain, *, metadata_seq: int = 0, **kw):
        super().__init__(**kw)
        self.chain = chain
        self._seq = metadata_seq
        # self-configure the ForkDigest context from the chain so every
        # embedding (network service, direct tests) can serve V2/LC chunks
        from lodestar_tpu_torch.config import FORK_ORDER, create_beacon_config

        if getattr(chain, "cfg", None) is None:
            # dev/test chains without a chain config: serve zero-digest
            # context; digest_to_fork stays None so a client half decodes
            # fork-INVARIANT chunks with static types (and refuses
            # fork-variant ones loudly) instead of mis-deserializing
            self.set_fork_context(lambda f: b"\x00\x00\x00\x00", None)
        else:
            gvr = bytes(chain.get_head_state().genesis_validators_root)
            bc = create_beacon_config(chain.cfg, gvr)
            digest_to_fork = {bc.fork_digest(f): f for f in FORK_ORDER}
            self.set_fork_context(bc.fork_digest, digest_to_fork.get)
        self.register_handler(_pid("status"), self._on_status)
        self.register_handler(_pid("ping"), self._on_ping)
        self.register_handler(_pid("metadata"), self._on_metadata)
        self.register_handler(
            _pid("beacon_blocks_by_range"),
            self._on_blocks_by_range_v1,
            quota=RateLimiterQuota(500, 10.0),
        )
        self.register_handler(
            _pid("beacon_blocks_by_root"),
            self._on_blocks_by_root_v1,
            quota=RateLimiterQuota(128, 10.0),
        )
        # V2: ForkDigest-context chunks, fork-resolved types (reference
        # ReqRespBeaconNode BeaconBlocksByRangeV2/RootV2)
        self.register_handler(
            _pid("beacon_blocks_by_range", 2),
            self._on_blocks_by_range_v2,
            quota=RateLimiterQuota(500, 10.0),
        )
        self.register_handler(
            _pid("beacon_blocks_by_root", 2),
            self._on_blocks_by_root_v2,
            quota=RateLimiterQuota(128, 10.0),
        )
        self.register_handler(_pid("goodbye"), self._on_goodbye)
        self.register_handler(
            _pid("blobs_sidecars_by_range"),
            self._on_blobs_by_range,
            quota=RateLimiterQuota(128, 10.0),
        )
        # light-client protocols (reference reqresp/protocols.ts
        # LightClientBootstrap/UpdatesByRange/FinalityUpdate/OptimisticUpdate)
        self.register_handler(
            _pid("light_client_bootstrap"),
            self._on_lc_bootstrap,
            quota=RateLimiterQuota(16, 10.0),
        )
        self.register_handler(
            _pid("light_client_updates_by_range"),
            self._on_lc_updates_by_range,
            quota=RateLimiterQuota(16, 10.0),
        )
        self.register_handler(_pid("light_client_finality_update"), self._on_lc_finality)
        self.register_handler(_pid("light_client_optimistic_update"), self._on_lc_optimistic)

    # -- handlers -------------------------------------------------------------

    def local_status(self):
        t = ssz_types(self.chain.p)
        fc = self.chain.fork_choice
        head = fc.proto_array.get_block(fc.head)
        status = t.Status.default()
        status.finalized_root = bytes.fromhex(fc.finalized.root[2:])
        status.finalized_epoch = fc.finalized.epoch
        status.head_root = bytes.fromhex(head.block_root[2:]) if head else b"\x00" * 32
        status.head_slot = head.slot if head else 0
        return status

    async def _on_status(self, req, peer):
        yield self.local_status()

    async def _on_ping(self, req, peer):
        yield self._seq

    async def _on_metadata(self, req, peer):
        t = ssz_types(self.chain.p)
        md = t.phase0.Metadata.default()
        md.seq_number = self._seq
        net = getattr(self.chain, "network", None)
        if net is not None and hasattr(net, "attnets_bytes"):
            raw = net.attnets_bytes()
            for i in range(len(md.attnets)):
                md.attnets[i] = bool(raw[i // 8] & (1 << (i % 8)))
        yield md

    def _block_fork(self, signed) -> str:
        return self.chain.fork_name_at_slot(int(signed.message.slot))

    def _lc_fork(self, slot: int) -> str:
        """Fork digest fork for light-client chunks: LC containers exist
        from altair on, so phase0-era headers ride the altair digest."""
        fork = self.chain.fork_name_at_slot(int(slot))
        return "altair" if fork == "phase0" else fork

    async def _on_blocks_by_range_v1(self, req, peer):
        """V1: context-free, phase0-typed chunks only. The stream ends at
        the first post-phase0 block (its SSZ layout cannot ride V1) —
        matching the reference's V1-for-phase0-history semantics."""
        async for signed in self._on_blocks_by_range(req, peer):
            if self._block_fork(signed) != "phase0":
                return
            yield signed

    async def _on_blocks_by_root_v1(self, req, peer):
        async for signed in self._on_blocks_by_root(req, peer):
            if self._block_fork(signed) != "phase0":
                continue
            yield signed

    async def _on_blocks_by_range_v2(self, req, peer):
        async for signed in self._on_blocks_by_range(req, peer):
            yield self._block_fork(signed), signed

    async def _on_blocks_by_root_v2(self, req, peer):
        async for signed in self._on_blocks_by_root(req, peer):
            yield self._block_fork(signed), signed

    async def _on_blocks_by_range(self, req, peer):
        if req.count == 0 or req.step != 1:
            raise ReqRespError("invalid range request")
        count = min(req.count, MAX_REQUEST_BLOCKS_PER_CALL)
        lo, hi = req.start_slot, req.start_slot + count
        # canonical walk: collect head-chain nodes within [lo, hi)
        fc = self.chain.fork_choice.proto_array
        node = fc.get_block(self.chain.fork_choice.head)
        wanted = []
        while node is not None and node.slot >= lo:
            if node.slot < hi:
                wanted.append(node)
            node = fc.nodes[node.parent] if node.parent is not None else None
        hot_slots = {n.slot for n in wanted}
        # finalized history lives in the slot-keyed archive after the
        # archiver migrates + fork choice prunes — serve it from there
        # (reference BeaconDb blockArchive range reads)
        for slot in range(lo, hi):
            if slot in hot_slots:
                break  # the hot walk covers the rest of the range
            signed = self.chain.archiver.get_archived_block_by_slot(slot)
            if signed is not None:
                yield signed
        for n in reversed(wanted):
            signed = self.chain.get_block_by_root(bytes.fromhex(n.block_root[2:]))
            if signed is not None:
                yield signed

    async def _on_blocks_by_root(self, req, peer):
        for root in list(req)[:MAX_REQUEST_BLOCKS_PER_CALL]:
            signed = self.chain.get_block_by_root(bytes(root))
            if signed is not None:
                yield signed

    async def _on_goodbye(self, req, peer):
        yield 0  # GoodbyeReason: client shutdown acknowledgment

    async def _on_blobs_by_range(self, req, peer):
        """Coupled sidecars for the canonical chain slice (reference
        BlobsSidecarsByRange): resolve each slot's canonical block root
        (hot walk falling back to the archive root index), then the
        root-keyed sidecar store."""
        count = min(int(req.count), 128)
        lo, hi = int(req.start_slot), int(req.start_slot) + count
        fc = self.chain.fork_choice.proto_array
        node = fc.get_block(self.chain.fork_choice.head)
        roots_by_slot = {}
        while node is not None and node.slot >= lo:
            if node.slot < hi:
                roots_by_slot[node.slot] = bytes.fromhex(node.block_root[2:])
            node = fc.nodes[node.parent] if node.parent is not None else None
        for slot in range(lo, hi):
            root = roots_by_slot.get(slot)
            if root is None:
                signed = self.chain.archiver.get_archived_block_by_slot(slot)
                if signed is None:
                    continue
                ns = getattr(self.chain.types, self.chain.fork_name_at_slot(slot))
                root = ns.BeaconBlock.hash_tree_root(signed.message)
            sidecar = self.chain.get_blobs_sidecar(root)
            if sidecar is not None:
                yield "deneb", sidecar

    # -- light-client protocols ------------------------------------------------

    def _lc(self):
        server = getattr(self.chain, "light_client_server", None)
        if server is None:
            raise ReqRespError("light-client server not enabled")
        return server

    async def _on_lc_bootstrap(self, req, peer):
        from lodestar_tpu_torch.chain.chain import BlockError

        try:
            bootstrap = self._lc().get_bootstrap(bytes(req))
        except (BlockError, KeyError) as e:
            raise ReqRespError(f"unknown bootstrap checkpoint root: {e}") from e
        if bootstrap is None:
            raise ReqRespError("unknown bootstrap checkpoint root")
        yield self._lc_fork(int(bootstrap.header.beacon.slot)), bootstrap

    async def _on_lc_updates_by_range(self, req, peer):
        # clamp the peer-supplied u64 BEFORE get_updates materializes a
        # range over it — an unclamped 2^64 count would spin the event
        # loop. The limit is the protocol table's chunk cap (the spec's
        # MAX_REQUEST_LIGHT_CLIENT_UPDATES), declared once.
        from lodestar_tpu_torch.reqresp.protocols import protocol_by_id

        cap = protocol_by_id(_pid("light_client_updates_by_range")).max_response_chunks
        count = min(int(req.count), cap)
        for update in self._lc().get_updates(int(req.start_period), count):
            yield self._lc_fork(int(update.attested_header.beacon.slot)), update

    async def _on_lc_finality(self, req, peer):
        update = self._lc().get_finality_update()
        if update is None:
            raise ReqRespError("no finality update available")
        yield self._lc_fork(int(update.attested_header.beacon.slot)), update

    async def _on_lc_optimistic(self, req, peer):
        update = self._lc().get_optimistic_update()
        if update is None:
            raise ReqRespError("no optimistic update available")
        yield self._lc_fork(int(update.attested_header.beacon.slot)), update
