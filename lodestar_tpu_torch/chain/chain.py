"""BeaconChain orchestrator + block import pipeline.

Reference `beacon-node/src/chain/chain.ts:88` + `chain/blocks/`:

* sanity checks (known root, finalized horizon, known parent) —
  `verifyBlocksSanityChecks.ts`
* verify: pre-state via the state cache/regen, then the reference's
  parallel split (`verifyBlock.ts:89-111`): signature-free STF and the
  batched signature verification run CONCURRENTLY — the STF on the host
  event loop, the signature sets through the async device verifier pool
  (`asyncio.gather` is the asyncio translation of the Promise.all).
* import: fork-choice onBlock + operation attestations into fork choice
  + head update + hot-db persist + state cache (`importBlock.ts:51`).
* regen: replay blocks from the nearest cached/stored state
  (`chain/regen/regen.ts` without the queue; the job queue lives in
  the caller).

The port of `lodestar_tpu.chain.chain`. Its two device legs are the
verifier it is given and `state_hash_tree_root`; both run on CUDA unless
the caller built them for the CPU, and a device error rejects the import
(no host fallback).
"""

from __future__ import annotations

import threading
from typing import Callable

from lodestar_tpu_torch import slo, tracing
from lodestar_tpu_torch.db import Bucket, DbController, Repository
from lodestar_tpu_torch.fork_choice import Checkpoint, ForkChoice, ProtoBlock
from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.scheduler import PriorityClass
from lodestar_tpu_torch.state_transition import (
    EpochContext,
    compute_epoch_at_slot,
    drop_tracker,
    process_block,
    process_slots,
    state_hash_tree_root,
)
from lodestar_tpu_torch.state_transition.signature_sets import get_block_signature_sets
from lodestar_tpu_torch.state_transition.util import effective_balances_array
from lodestar_tpu_torch.types import ssz_types

from .bls import IBlsVerifier, VerifySignatureOpts
from .op_pools import AggregatedAttestationPool, AttestationPool, OpPool, SeenAttesters

__all__ = ["BeaconChain", "BlockError", "BlockErrorCode"]


class BlockErrorCode:
    ALREADY_KNOWN = "ALREADY_KNOWN"
    PARENT_UNKNOWN = "PARENT_UNKNOWN"
    WOULD_REVERT_FINALIZED = "WOULD_REVERT_FINALIZED"
    PRESTATE_MISSING = "PRESTATE_MISSING"
    INVALID_SIGNATURES = "INVALID_SIGNATURES"
    INVALID_STATE_TRANSITION = "INVALID_STATE_TRANSITION"
    FUTURE_SLOT = "FUTURE_SLOT"


class BlockError(Exception):
    #: set True on rejections produced while the BLS verifier stack was
    #: in outage (every degradation layer erred): the gossip processor
    #: must NOT downscore the sending peer for a local incident
    verifier_outage: bool = False

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code

    @property
    def action(self):
        """Gossip scoring action (mirrors GossipValidationError.action):
        provably-invalid content REJECTs — and downscores the sender —
        while availability/ordering codes (parent unknown, future slot,
        already known) carry no peer evidence."""
        if self.code in (
            BlockErrorCode.INVALID_SIGNATURES,
            BlockErrorCode.INVALID_STATE_TRANSITION,
        ):
            from .validation import GossipAction

            return GossipAction.REJECT
        return None


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


class StateCache:
    """LRU hot-state cache by block root (reference
    `stateCache/stateContextCache.ts`, max 96)."""

    def __init__(self, max_states: int = 96):
        self.max_states = max_states
        self._by_root: dict[bytes, object] = {}

    def get(self, block_root: bytes):
        st = self._by_root.get(block_root)
        if st is not None:
            # refresh LRU position
            self._by_root.pop(block_root)
            self._by_root[block_root] = st
        return st

    def add(self, block_root: bytes, state) -> None:
        # a cached state is dormant: every consumer copies before
        # mutating (and copy() drops the HTR tracker), so its
        # incremental-root snapshots would be pinned dead weight —
        # hundreds of MB per state at the 1M-validator target
        drop_tracker(state)
        self._by_root[block_root] = state
        while len(self._by_root) > self.max_states:
            self._by_root.pop(next(iter(self._by_root)))

    def prune_except(self, keep_roots: set[bytes]) -> None:
        for root in [r for r in self._by_root if r not in keep_roots]:
            del self._by_root[root]


class BeaconChain:
    def __init__(
        self,
        *,
        anchor_state,
        bls_verifier: IBlsVerifier,
        db: DbController,
        p: BeaconPreset | None = None,
        cfg=None,
        genesis_block_root: bytes | None = None,
        current_slot: int | None = None,
        metrics=None,
        archive_state_epoch_frequency: int | None = None,
    ) -> None:
        self.p = p = p or active_preset()
        self.cfg = cfg
        self.bls = bls_verifier
        self.metrics = metrics
        self.log = get_logger(name="lodestar.chain")
        t = ssz_types(p)
        self.types = t

        self.blocks_db: Repository = Repository(db, Bucket.allForks_block, t.phase0.SignedBeaconBlock)
        # coupled early-4844 sidecars, keyed by block root (reference
        # db allForks_blobsSidecar)
        self.blobs_db: Repository = Repository(
            db, Bucket.allForks_blobsSidecar, t.deneb.BlobsSidecar
        )
        self.states_db: Repository = Repository(db, Bucket.allForks_stateArchive, anchor_state.type)

        self.state_cache = StateCache()
        # serializes chain mutations across threads: the asyncio gossip
        # drain (event-loop thread) and the threaded REST server both
        # import blocks/attestations — the structures below have no
        # internal locking (the reference is single-threaded Node.js)
        self.import_lock = threading.RLock()
        from .archiver import DEFAULT_ARCHIVE_STATE_EPOCH_FREQUENCY, Archiver
        from .regen import QueuedStateRegenerator

        self.regen = QueuedStateRegenerator(self)
        self.archiver = Archiver(
            self,
            db,
            DEFAULT_ARCHIVE_STATE_EPOCH_FREQUENCY
            if archive_state_epoch_frequency is None
            else archive_state_epoch_frequency,
        )
        self.attestation_pool = AttestationPool()
        self.aggregated_attestation_pool = AggregatedAttestationPool()
        self.op_pool = OpPool()
        from .sync_pools import (
            SeenSlotKeyed,
            SyncCommitteeMessagePool,
            SyncContributionAndProofPool,
        )

        self.sync_committee_message_pool = SyncCommitteeMessagePool(p)
        self.sync_contribution_pool = SyncContributionAndProofPool(p)
        self.seen_sync_messages = SeenSlotKeyed()
        self.seen_sync_aggregators = SeenSlotKeyed()
        # optional eth1 provider for block production (execution.eth1)
        self.eth1 = None
        # optional light-client server (chain.light_client_server)
        self.light_client_server = None
        self.seen_attesters = SeenAttesters()
        from .op_pools import SeenAggregators, _EpochKeyedSet

        self.seen_aggregators = SeenAggregators()
        self.seen_block_proposers = _EpochKeyedSet()
        # block-INCLUDED attesters tracked separately from the gossip
        # dedup cache (reference SeenBlockAttesters vs SeenAttesters):
        # marking them "seen" for gossip would IGNORE late-arriving
        # legitimate gossip attestations
        self.seen_block_attesters = _EpochKeyedSet()

        # anchor: latest block header of the anchor state defines the root
        header = anchor_state.latest_block_header.copy()
        if bytes(header.state_root) == b"\x00" * 32:
            header.state_root = anchor_state.type.hash_tree_root(anchor_state)
        anchor_root = genesis_block_root or t.BeaconBlockHeader.hash_tree_root(header)
        self.state_cache.add(anchor_root, anchor_state)

        # anchor checkpoint = (epoch of the anchor slot, anchor block
        # root) for BOTH store checkpoints; for a non-genesis anchor the
        # justified epoch is bumped +1 so the chain cannot justify with
        # a block that doesn't also finalize the anchor — head stays at
        # the anchor until a real justification lands (reference
        # `chain/forkChoice/index.ts initializeForkChoice`)
        anchor_epoch = compute_epoch_at_slot(anchor_state.slot, p)
        finalized_cp = Checkpoint(anchor_epoch, _hex(anchor_root))
        justified_cp = Checkpoint(
            anchor_epoch if anchor_epoch == 0 else anchor_epoch + 1, _hex(anchor_root)
        )
        proto = ProtoBlock(
            slot=anchor_state.slot,
            block_root=_hex(anchor_root),
            parent_root=_hex(b"\xff" * 32),
            state_root=_hex(bytes(header.state_root)),
            target_root=_hex(anchor_root),
            justified_epoch=justified_cp.epoch,
            justified_root=justified_cp.root,
            finalized_epoch=finalized_cp.epoch,
            finalized_root=finalized_cp.root,
            unrealized_justified_epoch=justified_cp.epoch,
            unrealized_finalized_epoch=finalized_cp.epoch,
        )
        self.fork_choice = ForkChoice.from_anchor(
            proto,
            current_slot=current_slot if current_slot is not None else anchor_state.slot,
            justified_balances=effective_balances_array(anchor_state),
            slots_per_epoch=p.SLOTS_PER_EPOCH,
        )
        self._subscribers: dict[str, list[Callable]] = {"block": [], "head": [], "finalized": []}

    # -- fork-aware types ------------------------------------------------------

    def fork_name_at_slot(self, slot: int) -> str:
        if self.cfg is None:
            return "phase0"
        from lodestar_tpu_torch.config import fork_name_at_epoch

        return fork_name_at_epoch(self.cfg, slot // self.p.SLOTS_PER_EPOCH)

    def block_type_at_slot(self, slot: int):
        ns = getattr(self.types, self.fork_name_at_slot(slot))
        return ns.BeaconBlock, ns.SignedBeaconBlock

    # -- events ---------------------------------------------------------------

    def on(self, event: str, fn: Callable) -> None:
        self._subscribers[event].append(fn)

    def off(self, event: str, fn: Callable) -> None:
        """Detach a subscriber (safe from other threads — _emit iterates
        a snapshot, so concurrent removal never skips a neighbor)."""
        subs = self._subscribers.get(event, [])
        if fn in subs:
            subs.remove(fn)

    def _emit(self, event: str, *args) -> None:
        for fn in tuple(self._subscribers.get(event, ())):
            fn(*args)

    # -- clock ----------------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        if slot <= self.fork_choice.current_slot:
            return  # a stale timer tick must never rewind the store clock
        prev_epoch = self.fork_choice.current_slot // self.p.SLOTS_PER_EPOCH
        self.fork_choice.on_tick(slot)
        self.attestation_pool.prune(slot)
        self.aggregated_attestation_pool.prune(slot)
        self.sync_committee_message_pool.prune(slot)
        self.sync_contribution_pool.prune(slot)
        self.seen_sync_messages.prune(slot - 3)
        self.seen_sync_aggregators.prune(slot - 3)
        if self.metrics is not None:
            self.metrics.clock_slot.set(slot)
            epoch = slot // self.p.SLOTS_PER_EPOCH
            if epoch > prev_epoch:
                summary = self.metrics.validator_monitor.on_epoch(epoch)
                if summary and summary.get("missed"):
                    self.log.info(
                        f"validator monitor epoch {summary['epoch']}: "
                        f"{summary['attested']} attested, {summary['missed']} missed"
                    )

    # -- block store -----------------------------------------------------------

    def get_block_by_root(self, block_root: bytes):
        """Fork-aware decode from the hot block db, falling through to
        the finalized archive (root index -> slot -> cold bucket). When
        the proto node is gone (pruned orphan), the slot is read straight
        from the serialized block — every SignedBeaconBlock starts
        offset4 | signature96 | message{slot u64le} — so the right fork
        container is still chosen."""
        raw = self.blocks_db.get_binary(block_root)
        if raw is None:
            return self.archiver.get_archived_block_by_root(block_root)
        node = self.fork_choice.proto_array.get_block(_hex(block_root))
        if node is not None:
            slot = node.slot
        elif len(raw) >= 108:
            slot = int.from_bytes(raw[100:108], "little")
        else:
            slot = 0
        _, signed_type = self.block_type_at_slot(slot)
        return signed_type.deserialize(raw)

    # -- regen ----------------------------------------------------------------

    def get_state_by_block_root(self, block_root: bytes):
        """Hot-cache hit or replay from the nearest stored ancestor state
        (reference `regen/regen.ts` getState)."""
        st = self.state_cache.get(block_root)
        if st is not None:
            return st
        # walk ancestors in fork choice until a cached state is found
        chain: list[bytes] = []
        root = block_root
        while True:
            chain.append(root)
            node = self.fork_choice.proto_array.get_block(_hex(root))
            if node is None:
                raise BlockError(BlockErrorCode.PRESTATE_MISSING, _hex(root))
            parent = bytes.fromhex(node.parent_root[2:])
            st = self.state_cache.get(parent)
            if st is not None:
                break
            root = parent
        # replay forward
        for r in reversed(chain):
            signed = self.get_block_by_root(r)
            if signed is None:
                raise BlockError(BlockErrorCode.PRESTATE_MISSING, f"block {_hex(r)} not in db")
            st = self._replay_block(st, signed)
            self.state_cache.add(r, st)
        return st

    def _replay_block(self, pre_state, signed_block):
        post = pre_state.copy()
        block = signed_block.message
        if block.slot > post.slot:
            ctx = process_slots(post, block.slot, self.p, self.cfg)
        else:
            ctx = EpochContext(post, self.p)
        process_block(post, block, ctx, verify_signatures=False, cfg=self.cfg)
        return post

    # -- block import ---------------------------------------------------------

    async def process_block(self, signed_block, *, is_timely: bool = False, priority=None):
        """Full import pipeline for one gossip/sync block. Serialized
        with other chain mutations via import_lock (REST threads vs the
        gossip drain loop). `priority` is the scheduler launch class the
        block's signature batch carries into the device queue; None maps
        to GOSSIP_BLOCK when is_timely (slot-deadline gossip import),
        API otherwise — sync paths pass their own class."""
        with self.import_lock:
            return await self._process_block_locked(
                signed_block, is_timely=is_timely, priority=priority
            )

    # sanity rejections before any pipeline work — their traces are
    # discarded so no-op imports (sync duplicates) don't flood the ring
    _NOOP_IMPORT_CODES = frozenset(
        (
            BlockErrorCode.ALREADY_KNOWN,
            BlockErrorCode.PARENT_UNKNOWN,
            BlockErrorCode.WOULD_REVERT_FINALIZED,
            BlockErrorCode.FUTURE_SLOT,
        )
    )

    async def _process_block_locked(
        self, signed_block, *, is_timely: bool = False, priority=None
    ):
        # root when called directly (sync/REST paths); child span when the
        # gossip processor already opened the slot's block_import trace
        with tracing.root("process_block", slot=int(signed_block.message.slot)):
            try:
                return await self._process_block_traced(
                    signed_block, is_timely=is_timely, priority=priority
                )
            except BlockError as e:
                # the post-verification ALREADY_KNOWN race re-check sets
                # pipeline_ran: that trace measured real device/STF work
                # and must survive for the slow-slot dump
                if e.code in self._NOOP_IMPORT_CODES and not getattr(
                    e, "pipeline_ran", False
                ):
                    tracing.discard()
                raise

    async def _process_block_traced(
        self, signed_block, *, is_timely: bool = False, priority=None
    ):
        if priority is None:
            priority = PriorityClass.GOSSIP_BLOCK if is_timely else PriorityClass.API
        t = self.types
        block = signed_block.message
        block_type, signed_type = self.block_type_at_slot(block.slot)
        block_root = block_type.hash_tree_root(block)

        # 1. sanity (verifyBlocksSanityChecks.ts)
        if self.fork_choice.proto_array.has_block(_hex(block_root)):
            raise BlockError(BlockErrorCode.ALREADY_KNOWN, _hex(block_root))
        finalized_slot = self.fork_choice.finalized.epoch * self.p.SLOTS_PER_EPOCH
        if block.slot <= finalized_slot:
            raise BlockError(
                BlockErrorCode.WOULD_REVERT_FINALIZED, f"slot {block.slot} <= {finalized_slot}"
            )
        if block.slot > self.fork_choice.current_slot:
            raise BlockError(BlockErrorCode.FUTURE_SLOT, f"slot {block.slot}")
        parent_root = bytes(block.parent_root)
        parent = self.fork_choice.proto_array.get_block(_hex(parent_root))
        if parent is None:
            raise BlockError(BlockErrorCode.PARENT_UNKNOWN, _hex(parent_root))

        # 2. pre-state + dial to block slot
        with tracing.span("pre_state_regen"):
            pre_state = self.get_state_by_block_root(parent_root)
            work_state = pre_state.copy()
            if block.slot > work_state.slot:
                ctx = process_slots(work_state, block.slot, self.p, self.cfg)
            else:
                ctx = EpochContext(work_state, self.p)

        # 3. parallel: signature-free STF on this task + batched signature
        # verification through the device pool (verifyBlock.ts:89-111)
        import asyncio

        sets = get_block_signature_sets(work_state, signed_block, ctx, cfg=self.cfg)

        async def run_sigs():
            # own task: ensure_future snapshots the context, so the span
            # stitches under this import's trace; pool jobs capture it as
            # their parent for the buffer-wait/device-launch spans
            with tracing.span("bls_verify") as sp:
                if sp:
                    sp.set(sets=len(sets))
                ok = await self.bls.verify_signature_sets(
                    sets,
                    VerifySignatureOpts(
                        batchable=False, priority=priority, slot=int(block.slot)
                    ),
                )
                if sp:
                    # remaining slot-deadline slack when the verdict
                    # landed (None = SLO layer off) — the slow-slot dump
                    # answers "did we still make the deadline" inline
                    slack = slo.slack_ms(priority, int(block.slot))
                    if slack is not None:
                        sp.set(slack_ms=slack)
                    # DegradingBlsVerifier names the layer that actually
                    # served — a slow-slot dump shows degraded imports.
                    # serving_layer() is a contextvar read: this TASK's
                    # verdict, not whichever import finished last
                    serving = getattr(self.bls, "serving_layer", None)
                    layer = (
                        serving() if callable(serving)
                        else getattr(self.bls, "last_layer", None)
                    )
                    if layer is not None:
                        sp.set(verifier_layer=layer)
                return ok

        sig_task = asyncio.ensure_future(run_sigs())
        stf_parent = tracing.current()  # executor threads don't see contextvars

        def run_stf():
            from lodestar_tpu_torch.state_transition import BlockProcessError, StateTransitionError

            post = work_state  # already copied + dialed
            try:
                with tracing.span("state_transition", parent=stf_parent):
                    process_block(post, block, ctx, verify_signatures=False, cfg=self.cfg)
            except (BlockProcessError, StateTransitionError) as e:
                raise BlockError(BlockErrorCode.INVALID_STATE_TRANSITION, str(e)) from e
            with tracing.span("hash_tree_root", parent=stf_parent):
                # the dirty-subtree collector when --htr-device selects
                # it; the tracker is warm from process_slots on this
                # same post-state, so only the block's mutations flush
                got = state_hash_tree_root(post)
            if got != bytes(block.state_root):
                raise BlockError(BlockErrorCode.INVALID_STATE_TRANSITION, "state root mismatch")
            return post

        stf_task = asyncio.get_event_loop().run_in_executor(None, run_stf)
        results = await asyncio.gather(stf_task, sig_task, return_exceptions=True)
        stf_res, sig_res = results
        if isinstance(stf_res, BaseException):
            # gather(return_exceptions=True) already waited out sig_task;
            # a failing STF still pays for the in-flight verification
            raise stf_res
        if isinstance(sig_res, BaseException):
            # fail closed: a verifier/transport error rejects the block
            # import, it never resolves valid (multithread/index.ts:386-393).
            # A verifier ERROR is never evidence about the block (only a
            # served False verdict is): the rejection is local fail-closed
            # policy, so it is ALWAYS marked as a verifier fault and gossip
            # scoring spares the honest sender (network/processor.py). This
            # is per-rejection state riding the exception itself — no
            # shared flag to race against a concurrently recovering import.
            err = BlockError(
                BlockErrorCode.INVALID_SIGNATURES, f"verifier error: {sig_res!r}"
            )
            err.verifier_outage = True
            raise err
        post_state, sigs_ok = stf_res, sig_res
        if not sigs_ok:
            raise BlockError(BlockErrorCode.INVALID_SIGNATURES, _hex(block_root))

        # 4. import (importBlock.ts:51). Re-check ALREADY_KNOWN: another
        # task may have imported the same block while this one awaited
        # signature verification (asyncio interleaves at awaits; the
        # RLock only excludes across threads)
        if self.fork_choice.proto_array.has_block(_hex(block_root)):
            err = BlockError(BlockErrorCode.ALREADY_KNOWN, _hex(block_root))
            err.pipeline_ran = True
            raise err
        with tracing.span("persist_block"):
            self.blocks_db.put_binary(block_root, signed_type.serialize(signed_block))
            self.state_cache.add(block_root, post_state)

        blk_epoch = compute_epoch_at_slot(block.slot, self.p)
        jc = post_state.current_justified_checkpoint
        fc_cp = post_state.finalized_checkpoint
        proto = ProtoBlock(
            slot=block.slot,
            block_root=_hex(block_root),
            parent_root=_hex(parent_root),
            state_root=_hex(bytes(block.state_root)),
            target_root=_hex(self._target_root(post_state, blk_epoch, block_root)),
            justified_epoch=jc.epoch,
            justified_root=_hex(bytes(jc.root)),
            finalized_epoch=fc_cp.epoch,
            finalized_root=_hex(bytes(fc_cp.root)),
            unrealized_justified_epoch=jc.epoch,
            unrealized_finalized_epoch=fc_cp.epoch,
        )
        prev_finalized = self.fork_choice.finalized.epoch
        with tracing.span("fork_choice"):
            self.fork_choice.on_block(
                proto,
                is_timely=is_timely,
                justified_checkpoint=Checkpoint(jc.epoch, _hex(bytes(jc.root))),
                finalized_checkpoint=Checkpoint(fc_cp.epoch, _hex(bytes(fc_cp.root))),
                justified_balances=effective_balances_array(post_state),
            )

            # operation attestations feed LMD votes (importBlock.ts:130) and
            # the liveness record (doppelganger data source: on-chain activity
            # counts, not just gossip — reference validatorMonitor). Child
            # span: committee computation + monitor bookkeeping dominate
            # here and must not read as fork-choice time in dumps/metrics
            with tracing.span("attestation_ops"):
                blk_proposer_epoch = compute_epoch_at_slot(block.slot, self.p)
                self.seen_block_proposers.add(blk_proposer_epoch, int(block.proposer_index))
                monitor = self.metrics.validator_monitor if self.metrics is not None else None
                if monitor is not None:
                    monitor.on_block_imported(int(block.slot), int(block.proposer_index))
                for att in block.body.attestations:
                    try:
                        attesting = ctx.get_attesting_indices(att.data, att.aggregation_bits)
                    except ValueError:
                        continue
                    for i in attesting:
                        self.seen_block_attesters.add(int(att.data.target.epoch), int(i))
                    if monitor is not None:
                        monitor.on_attestation_in_block(
                            int(att.data.target.epoch),
                            [int(i) for i in attesting],
                            int(block.slot) - int(att.data.slot),
                        )
                    self.fork_choice.on_attestation(
                        [int(i) for i in attesting],
                        _hex(bytes(att.data.beacon_block_root)),
                        att.data.target.epoch,
                        att.data.slot,
                    )

            head = self.fork_choice.update_head()
        if self.light_client_server is not None:
            self.light_client_server.on_imported_block(signed_block, post_state)
        self._emit("block", block_root, signed_block)
        self._emit("head", head)
        if self.metrics is not None:
            self.metrics.head_slot.set(block.slot)
            self.metrics.finalized_epoch.set(fc_cp.epoch)
            self.metrics.justified_epoch.set(jc.epoch)

        if fc_cp.epoch > prev_finalized:
            self._on_finalized(fc_cp)
        return block_root

    def _target_root(self, state, epoch: int, block_root: bytes) -> bytes:
        from lodestar_tpu_torch.state_transition.util import get_block_root

        try:
            return get_block_root(state, epoch, self.p)
        except ValueError:
            return block_root

    def _on_finalized(self, cp) -> None:
        """Archive then prune on finalization (reference `archiver/`):
        block/state migration runs while the dead-fork nodes are still
        in the proto array, then fork choice + caches are pruned."""
        root = bytes(cp.root)
        self.archiver.on_finalized(cp)
        self.fork_choice.prune()
        keep = {bytes.fromhex(n.block_root[2:]) for n in self.fork_choice.proto_array.nodes}
        self.state_cache.prune_except(keep)
        self.regen.prune_on_finalized(cp.epoch)
        for seen in (
            self.seen_attesters,
            self.seen_aggregators,
            self.seen_block_attesters,
            self.seen_block_proposers,
        ):
            seen.prune(cp.epoch)
        st = self.state_cache.get(root)
        if st is not None:
            self.op_pool.prune_all(st)
        self._emit("finalized", cp)

    # -- head accessors -------------------------------------------------------

    @property
    def head_root(self) -> bytes:
        return bytes.fromhex(self.fork_choice.head[2:])

    def get_head_state(self):
        return self.get_state_by_block_root(self.head_root)

    def put_blobs_sidecar(self, sidecar) -> None:
        self.blobs_db.put(bytes(sidecar.beacon_block_root), sidecar)

    def get_blobs_sidecar(self, block_root: bytes):
        return self.blobs_db.get(bytes(block_root))

    def get_finalized_state(self):
        """State at the finalized checkpoint: hot cache, else regen from
        the finalized block (still in fork choice), else replay the
        archived canonical blocks forward from the newest archived state
        — never a silently-stale snapshot. The cold replay can be tens
        of thousands of STF steps (archive cadence), so its result is
        memoized per finalized root."""
        root = bytes.fromhex(self.fork_choice.finalized.root[2:])
        st = self.state_cache.get(root)
        if st is not None:
            return st
        memo = getattr(self, "_finalized_replay_memo", None)
        if memo is not None and memo[0] == root:
            return memo[1]
        try:
            return self.get_state_by_block_root(root)
        except BlockError:
            pass
        node = self.fork_choice.proto_array.get_block(self.fork_choice.finalized.root)
        finalized_slot = (
            node.slot if node is not None else self.fork_choice.finalized.epoch * self.p.SLOTS_PER_EPOCH
        )
        st = self.archiver.get_archived_state_at_or_before(finalized_slot)
        if st is None:
            return None
        for slot in range(int(st.slot) + 1, finalized_slot + 1):
            signed = self.archiver.get_archived_block_by_slot(slot)
            if signed is not None:
                st = self._replay_block(st, signed)
        if int(st.slot) < finalized_slot:
            st = st.copy()
            process_slots(st, finalized_slot, self.p, self.cfg)
        # cache under the block root ONLY if the replay actually reached
        # the finalized block AND stopped at its slot — caching a
        # padded-forward state under the root would poison regen for
        # every descendant between the block's slot and the pad target
        header = st.latest_block_header.copy()
        if bytes(header.state_root) == b"\x00" * 32:
            # transient: rides a tracker left warm by the replay's
            # process_slots, but never cold-builds one for a dormant
            # cached state's single root
            header.state_root = state_hash_tree_root(st, transient=True)
        if (
            int(st.slot) == int(st.latest_block_header.slot)
            and self.types.BeaconBlockHeader.hash_tree_root(header) == root
        ):
            self.state_cache.add(root, st)
        # the memo state is dormant too (replay consumers copy first):
        # drop tracking even when the cache-add condition was skipped
        drop_tracker(st)
        self._finalized_replay_memo = (root, st)
        return st
