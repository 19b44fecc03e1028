"""Range sync: epoch batches, parallel download, serial processing.

Reference `sync/range/`: `SyncChain` builds batches of
EPOCHS_PER_BATCH(=1) epochs (`sync/constants.ts:41`), downloads from many
peers concurrently, but guarantees only one processChainSegment at a time
(`range/chain.ts:104`); failed downloads retry up to 5 times rotating
peers, failed processing retries up to 3 before the chain is dropped
(`sync/constants.ts:8-11`).

The port of `lodestar_tpu.sync.range_sync` (host Python, as there).
"""

from __future__ import annotations

import asyncio
import enum
from dataclasses import dataclass, field

from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import active_preset
from lodestar_tpu_torch.scheduler import PriorityClass

__all__ = ["RangeSync", "Batch", "BatchStatus", "SyncResult"]

EPOCHS_PER_BATCH = 1
MAX_BATCH_DOWNLOAD_ATTEMPTS = 5
MAX_BATCH_PROCESSING_ATTEMPTS = 3
BATCH_BUFFER_SIZE = 5  # download ahead window


class BatchStatus(enum.Enum):
    AWAITING_DOWNLOAD = "AwaitingDownload"
    DOWNLOADING = "Downloading"
    AWAITING_PROCESSING = "AwaitingProcessing"
    PROCESSING = "Processing"
    PROCESSED = "Processed"
    FAILED = "Failed"


@dataclass
class Batch:
    start_slot: int
    count: int
    status: BatchStatus = BatchStatus.AWAITING_DOWNLOAD
    blocks: list = field(default_factory=list)
    download_attempts: int = 0
    processing_attempts: int = 0
    peer: str | None = None


@dataclass
class SyncResult:
    completed: bool
    processed_blocks: int
    failed_batch: Batch | None = None


class RangeSync:
    """Sync the canonical chain from `start_slot` to `target_slot` using
    peers' blocksByRange."""

    def __init__(
        self,
        *,
        chain,
        network,
        peers: list[str],
        on_peer_downscore=None,
    ) -> None:
        self.chain = chain
        self.network = network  # async blocks_by_range(peer, start, count)
        self.peers = list(peers)
        self.on_peer_downscore = on_peer_downscore or (lambda peer, reason: None)
        self.log = get_logger(name="lodestar.sync")
        self._peer_rr = 0

    def _next_peer(self) -> str:
        peer = self.peers[self._peer_rr % len(self.peers)]
        self._peer_rr += 1
        return peer

    async def sync(self, start_slot: int, target_slot: int) -> SyncResult:
        p = active_preset()
        batch_slots = EPOCHS_PER_BATCH * p.SLOTS_PER_EPOCH
        batches = [
            Batch(start_slot=s, count=min(batch_slots, target_slot - s + 1))
            for s in range(start_slot, target_slot + 1, batch_slots)
        ]
        processed = 0
        next_to_process = 0

        async def download(batch: Batch) -> None:
            while batch.download_attempts < MAX_BATCH_DOWNLOAD_ATTEMPTS:
                batch.peer = self._next_peer()
                batch.status = BatchStatus.DOWNLOADING
                batch.download_attempts += 1
                try:
                    blocks = await self.network.blocks_by_range(
                        batch.peer, batch.start_slot, batch.count
                    )
                    batch.blocks = blocks
                    batch.status = BatchStatus.AWAITING_PROCESSING
                    return
                except Exception as e:
                    self.on_peer_downscore(batch.peer, f"download failed: {e!r}")
                    self.log.warn(
                        f"batch download failed (attempt {batch.download_attempts}): {e!r}"
                    )
            batch.status = BatchStatus.FAILED

        while next_to_process < len(batches):
            # keep the download-ahead window full (parallel downloads)
            window = batches[next_to_process : next_to_process + BATCH_BUFFER_SIZE]
            pending = [b for b in window if b.status is BatchStatus.AWAITING_DOWNLOAD]
            if pending:
                await asyncio.gather(*(download(b) for b in pending))

            batch = batches[next_to_process]
            if batch.status is BatchStatus.FAILED:
                return SyncResult(False, processed, failed_batch=batch)

            # serial processing: one segment at a time (range/chain.ts:104).
            # One root span per batch with each block's process_block as a
            # child — head-of-line blocking between sync batches and gossip
            # blocks sharing the verifier pool reads straight off the trace
            batch.status = BatchStatus.PROCESSING
            try:
                with tracing.root("range_sync_batch", slot=batch.start_slot, bulk=True) as bsp:
                    if bsp:
                        bsp.set(
                            start_slot=batch.start_slot,
                            blocks=len(batch.blocks),
                            attempt=batch.processing_attempts + 1,
                            peer=batch.peer or "",
                        )
                    for signed in batch.blocks:
                        from lodestar_tpu_torch.chain.chain import BlockError, BlockErrorCode

                        try:
                            await self.chain.process_block(
                                signed, priority=PriorityClass.RANGE_SYNC
                            )
                            processed += 1
                        except BlockError as e:
                            if e.code == BlockErrorCode.ALREADY_KNOWN:
                                continue
                            raise
                    # a duplicate's nested pipeline may have requested a
                    # discard; the batch trace is ours and stays
                    tracing.keep()
                batch.status = BatchStatus.PROCESSED
                next_to_process += 1
            except Exception as e:
                # same exemption as the gossip processor: a rejection the
                # chain marked as caused by a LOCAL verifier outage says
                # nothing about the peer OR the batch. Re-downloading from
                # another peer cannot help and would burn the attempt
                # budget (terminally failing the batch) within seconds of
                # a transient outage — end this sync round instead; the
                # sync driver re-syncs the gap once the verifier is back.
                if getattr(e, "verifier_outage", False):
                    self.log.warn(
                        "segment rejected during verifier outage: pausing sync "
                        "round, peer not downscored"
                    )
                    batch.status = BatchStatus.AWAITING_PROCESSING
                    return SyncResult(False, processed, failed_batch=batch)
                batch.processing_attempts += 1
                self.on_peer_downscore(batch.peer, f"invalid segment: {e!r}")
                self.log.warn(
                    f"segment processing failed (attempt {batch.processing_attempts}): {e!r}"
                )
                if batch.processing_attempts >= MAX_BATCH_PROCESSING_ATTEMPTS:
                    batch.status = BatchStatus.FAILED
                    return SyncResult(False, processed, failed_batch=batch)
                # redownload from a different peer
                batch.status = BatchStatus.AWAITING_DOWNLOAD
                batch.blocks = []
                batch.download_attempts = 0
        return SyncResult(True, processed)
