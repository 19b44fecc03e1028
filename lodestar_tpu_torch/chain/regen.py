"""State regeneration: queued regen + checkpoint-state cache.

Reference `beacon-node/src/chain/regen/queued.ts:29` (QueuedStateRegenerator:
bounded job queue, canAcceptWork admission at jobLen < 16) and
`chain/stateCache/stateContextCheckpointsCache.ts` (checkpoint states
keyed by epoch:root, pruned to MAX_EPOCHS). The underlying replay is
`BeaconChain.get_state_by_block_root` (chain.py — regen.ts without the
queue); this module adds the scheduling/backpressure layer the gossip
processor gates on (`processor/index.ts:316-330`).

The port of `lodestar_tpu.chain.regen` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.state_transition import process_slots
from lodestar_tpu_torch.utils.queue import JobItemQueue

__all__ = ["CheckpointStateCache", "QueuedStateRegenerator", "RegenCaller"]

REGEN_QUEUE_MAX_LEN = 256
REGEN_CAN_ACCEPT_WORK_THRESHOLD = 16
MAX_CHECKPOINT_EPOCHS = 10


class RegenCaller:
    """Why a state was requested — the reference threads this through for
    metrics attribution (`regen/interface.ts RegenCaller`)."""

    processBlock = "processBlock"
    produceBlock = "produceBlock"
    validateGossipBlock = "validateGossipBlock"
    validateGossipAttestation = "validateGossipAttestation"
    precomputeEpoch = "precomputeEpoch"
    restApi = "restApi"


class CheckpointStateCache:
    """Checkpoint (epoch, root) -> dialed state at the epoch's start
    slot. Insertion-ordered dict doubles as the prune queue."""

    def __init__(self, max_epochs: int = MAX_CHECKPOINT_EPOCHS):
        self.max_epochs = max_epochs
        self._cache: dict[tuple[int, bytes], object] = {}

    @staticmethod
    def _key(epoch: int, root: bytes) -> tuple[int, bytes]:
        return (int(epoch), bytes(root))

    def get(self, epoch: int, root: bytes):
        return self._cache.get(self._key(epoch, root))

    def add(self, epoch: int, root: bytes, state) -> None:
        self._cache[self._key(epoch, root)] = state
        epochs = sorted({e for e, _ in self._cache})
        if len(epochs) > self.max_epochs:
            cutoff = epochs[len(epochs) - self.max_epochs]
            for k in [k for k in self._cache if k[0] < cutoff]:
                del self._cache[k]

    def get_latest(self, root: bytes, max_epoch: int):
        """Most-recent cached state for this block root at or below
        max_epoch (reference getLatest)."""
        best = None
        best_epoch = -1
        for (e, r), st in self._cache.items():
            if r == bytes(root) and best_epoch < e <= max_epoch:
                best, best_epoch = st, e
        return best

    def prune_finalized(self, finalized_epoch: int) -> None:
        for k in [k for k in self._cache if k[0] < finalized_epoch]:
            del self._cache[k]

    def __len__(self) -> int:
        return len(self._cache)


class QueuedStateRegenerator:
    """Async facade over the chain's synchronous regen with a bounded
    FIFO job queue. State requests from gossip validation, block
    production, and the REST API all funnel through here so replay work
    is serialized and sheddable."""

    def __init__(self, chain, max_length: int = REGEN_QUEUE_MAX_LEN):
        self.chain = chain
        self.checkpoint_states = CheckpointStateCache()
        self._queue = JobItemQueue(self._run_job, max_length=max_length)

    def can_accept_work(self) -> bool:
        return self._queue.job_len < REGEN_CAN_ACCEPT_WORK_THRESHOLD

    @property
    def job_len(self) -> int:
        return self._queue.job_len

    # -- sync fast paths (cache hits cost nothing, reference queued.ts
    # checks caches before queueing) --------------------------------------

    def get_cached_state(self, block_root: bytes):
        return self.chain.state_cache.get(bytes(block_root))

    def get_checkpoint_state_sync(self, epoch: int, root: bytes):
        return self.checkpoint_states.get(epoch, root)

    # -- queued paths ------------------------------------------------------

    async def get_state(self, block_root: bytes, caller: str = RegenCaller.restApi):
        """State after the given block (hot-cache hit bypasses the
        queue)."""
        st = self.get_cached_state(block_root)
        if st is not None:
            return st
        return await self._queue.push("state", bytes(block_root), None)

    async def get_pre_state(self, block, caller: str = RegenCaller.processBlock):
        """Pre-state for a block: parent state dialed to the block's
        slot (reference getPreState = getBlockSlotState(parent))."""
        return await self.get_block_slot_state(
            bytes(block.parent_root), int(block.slot), caller
        )

    async def get_block_slot_state(
        self, block_root: bytes, slot: int, caller: str = RegenCaller.processBlock
    ):
        return await self._queue.push("block_slot", bytes(block_root), int(slot))

    async def get_checkpoint_state(
        self, epoch: int, root: bytes, caller: str = RegenCaller.validateGossipAttestation
    ):
        """State of `root` dialed to the start of `epoch` — the
        attestation-target state (reference getCheckpointState)."""
        st = self.checkpoint_states.get(epoch, root)
        if st is not None:
            return st
        p = self.chain.p
        return await self._queue.push("block_slot_cp", bytes(root), int(epoch) * p.SLOTS_PER_EPOCH)

    # -- job runner --------------------------------------------------------

    def _run_job(self, kind: str, block_root: bytes, slot: int | None):
        chain = self.chain
        state = chain.get_state_by_block_root(block_root)
        if kind == "state" or slot is None:
            return state
        if state.slot < slot:
            state = state.copy()
            process_slots(state, slot, chain.p, chain.cfg)
        elif state.slot > slot:
            raise ValueError(f"state at slot {state.slot} is past requested {slot}")
        if kind == "block_slot_cp":
            p = chain.p
            self.checkpoint_states.add(slot // p.SLOTS_PER_EPOCH, block_root, state)
        return state

    def prune_on_finalized(self, finalized_epoch: int) -> None:
        self.checkpoint_states.prune_finalized(finalized_epoch)

    def drop_all(self) -> None:
        self._queue.drop_all()
