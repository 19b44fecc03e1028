"""Gossip processor: bounded per-topic queues + chain backpressure.

Reference `beacon-node/src/network/processor/` — `gossipQueues.ts`
(per-topic maxLength/LIFO-vs-FIFO drop policies), `index.ts:316-330`
(executeWork gated on `bls.canAcceptWork()` + `regen.canAcceptWork()`,
MAX_JOBS_SUBMITTED_PER_TICK, blocks bypass the gate), and
`gossipHandlers.ts` (validate → signature-verify → pools/fork-choice
dispatch). This is the §2c "backpressure scheduling" seam: queue depth
feeds back from device-pipeline occupancy.

The port of `lodestar_tpu.network.processor` (host Python, as there).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from lodestar_tpu_torch import slo, tracing
from lodestar_tpu_torch.logger import get_logger

__all__ = ["NetworkProcessor", "GOSSIP_QUEUE_OPTS", "default_gossip_handlers"]


def _stamp_import_slack(rt, slot: int) -> None:
    """Remaining slot-deadline slack when a gossip block import
    finished, stamped on the `block_import` root span (so a slow-slot
    dump answers "did we still make the attestation cutoff" without a
    metrics query). No-op when tracing or the SLO layer is off."""
    if rt:
        from lodestar_tpu_torch.scheduler import PriorityClass

        slack = slo.slack_ms(PriorityClass.GOSSIP_BLOCK, slot)
        if slack is not None:
            rt.set(slack_ms=slack)

MAX_JOBS_SUBMITTED_PER_TICK = 128

# topic -> (max_length, "FIFO"|"LIFO")  (reference gossipQueues.ts:37-60)
GOSSIP_QUEUE_OPTS: dict[str, tuple[int, str]] = {
    "beacon_block": (1024, "FIFO"),
    "beacon_block_and_blobs_sidecar": (1024, "FIFO"),
    "beacon_aggregate_and_proof": (5120, "LIFO"),
    "beacon_attestation": (24576, "LIFO"),
    "voluntary_exit": (4096, "FIFO"),
    "proposer_slashing": (4096, "FIFO"),
    "attester_slashing": (4096, "FIFO"),
    "sync_committee_contribution_and_proof": (4096, "LIFO"),
    "sync_committee": (4096, "LIFO"),
    "bls_to_execution_change": (4096, "FIFO"),
}

# blocks are processed immediately even under backpressure
# (reference executeGossipWorkOrderObj bypassQueue)
EXECUTE_ORDER = (
    "beacon_block",
    "beacon_block_and_blobs_sidecar",
    "beacon_aggregate_and_proof",
    "beacon_attestation",
    "sync_committee_contribution_and_proof",
    "sync_committee",
    "voluntary_exit",
    "proposer_slashing",
    "attester_slashing",
    "bls_to_execution_change",
)
BYPASS_BACKPRESSURE = {"beacon_block", "beacon_block_and_blobs_sidecar"}

# topic -> sched launch-class label for the shed counter: the BLS-bound
# attestation family sheds verifier work; op-pool topics run the STF
# locally and count as api-class deferral
_TOPIC_SHED_CLASS = {
    topic: (
        "gossip_attestation"
        if topic
        in (
            "beacon_attestation",
            "beacon_aggregate_and_proof",
            "sync_committee",
            "sync_committee_contribution_and_proof",
        )
        else "api"
    )
    for topic in GOSSIP_QUEUE_OPTS
}


@dataclass
class PendingItem:
    topic: str
    message: object
    peer: str
    seen_at: float = field(default_factory=time.monotonic)


class _TopicQueue:
    def __init__(self, max_length: int, kind: str):
        self.max_length = max_length
        self.kind = kind
        self._items: deque[PendingItem] = deque()
        self.dropped = 0

    def push(self, item: PendingItem) -> bool:
        if len(self._items) >= self.max_length:
            if self.kind == "LIFO":
                self._items.popleft()  # drop oldest, keep freshest
                self.dropped += 1
            else:
                self.dropped += 1
                return False  # FIFO rejects new work
        self._items.append(item)
        return True

    def pop(self) -> PendingItem | None:
        if not self._items:
            return None
        return self._items.pop() if self.kind == "LIFO" else self._items.popleft()

    def __len__(self) -> int:
        return len(self._items)


class NetworkProcessor:
    """Queue gossip messages per topic; drain them through injected
    handlers when the chain can accept work."""

    def __init__(self, chain, handlers: dict | None = None, metrics=None, report_peer=None):
        self.chain = chain
        self.handlers = handlers if handlers is not None else default_gossip_handlers(chain)
        self.metrics = metrics
        self.report_peer = report_peer  # (peer_id, reason) -> None; REJECTs downscore
        self.log = get_logger(name="lodestar.processor")
        self.queues = {
            topic: _TopicQueue(max_len, kind)
            for topic, (max_len, kind) in GOSSIP_QUEUE_OPTS.items()
        }
        self.processed = 0
        self.errors = 0

    # -- ingress ---------------------------------------------------------------

    def push(self, topic: str, message, peer: str = "") -> bool:
        q = self.queues.get(topic)
        if q is None:
            return False
        return q.push(PendingItem(topic, message, peer))

    # -- backpressure ----------------------------------------------------------

    def _cannot_accept_reason(self) -> str | None:
        bls = getattr(self.chain, "bls", None)
        if bls is not None and not bls.can_accept_work():
            return "bls_busy"
        regen = getattr(self.chain, "regen", None)
        if regen is not None and not regen.can_accept_work():
            return "regen_busy"
        return None

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- drain -----------------------------------------------------------------

    async def execute_work(self, max_jobs: int = MAX_JOBS_SUBMITTED_PER_TICK) -> int:
        """One drain tick: submit up to max_jobs items in the reference's
        priority order; non-block topics stop when the chain is
        backpressured. Returns jobs executed."""
        submitted = 0
        sched_metrics = getattr(self.metrics, "sched", None)
        shed_topics: set[str] = set()
        shed_reasons: set[str] = set()
        while submitted < max_jobs:
            reason = self._cannot_accept_reason()
            progressed = False
            for topic in EXECUTE_ORDER:
                if reason is not None and topic not in BYPASS_BACKPRESSURE:
                    if len(self.queues[topic]):
                        shed_topics.add(topic)
                        shed_reasons.add(reason)
                    continue
                handler = self.handlers.get(topic)
                if handler is None:
                    continue  # topic not handled: leave items queued (and countable)
                item = self.queues[topic].pop()
                if item is None:
                    continue
                try:
                    await handler(item.message, item.peer)
                    self.processed += 1
                except Exception as e:
                    self.errors += 1
                    self.log.debug(
                        "gossip handler error", {"topic": topic, "error": str(e)[:120]}
                    )
                    # REJECT-class failures downscore the sender
                    # (reference gossipHandlers -> peerManager scoring) —
                    # UNLESS the rejection was produced by a local
                    # verifier outage (degradation chain exhausted): a
                    # valid block rejected because OUR verifier stack is
                    # down says nothing about the peer, and downscoring
                    # during an operator-side incident would shed honest
                    # peers exactly when the node is most fragile
                    if self.report_peer is not None and item.peer:
                        from lodestar_tpu_torch.chain.validation import GossipAction

                        if getattr(e, "action", None) is GossipAction.REJECT:
                            if getattr(e, "verifier_outage", False):
                                resilience = getattr(self.metrics, "resilience", None)
                                if resilience is not None:
                                    # dedicated counter: these are COMPLETED
                                    # rejections, not deferred/shed work —
                                    # they must not inflate the shed panels
                                    resilience.outage_unscored.inc()
                                self.log.warn(
                                    "rejection during verifier outage: peer not downscored",
                                    {"topic": topic, "peer": item.peer},
                                )
                            else:
                                self.report_peer(item.peer, f"{topic}: {e}")
                submitted += 1
                progressed = True
                break  # re-evaluate backpressure + priorities each job
            if not progressed:
                break
        if sched_metrics is not None:
            # once per topic per tick: topics with queued work that
            # backpressure deferred, labeled by their BLS launch class
            for topic in shed_topics:
                sched_metrics.shed_total.labels(_TOPIC_SHED_CLASS[topic]).inc()
        resilience = getattr(self.metrics, "resilience", None)
        if resilience is not None:
            # per-reason shed ticks (bls_busy = offload/pool refusing
            # admission — the client-side routing-metrics view)
            for r in shed_reasons:
                resilience.shed.labels(r).inc()
        return submitted


def import_verified_attestation(chain, res, attestation, aggregated: bool = False) -> None:
    """Post-verification attestation import: register the seen cache,
    pool (naive or aggregated), feed fork-choice votes. The ONE place the
    register-after-verify ordering contract lives — the gossip processor
    and the REST pool endpoint both call it. Holds the chain's import
    lock: REST handler threads and the gossip drain loop would otherwise
    interleave mid-structure."""
    with chain.import_lock:
        _import_verified_attestation_locked(chain, res, attestation, aggregated)


def _import_verified_attestation_locked(chain, res, attestation, aggregated: bool) -> None:
    res.register_seen()
    t = chain.types
    data = attestation.data
    root = t.AttestationData.hash_tree_root(data)
    if aggregated:
        chain.aggregated_attestation_pool.add(attestation, root)
    else:
        chain.attestation_pool.add(attestation, root)
    chain.fork_choice.on_attestation(
        res.attesting_indices,
        "0x" + bytes(data.beacon_block_root).hex(),
        data.target.epoch,
        data.slot,
    )
    if chain.metrics is not None:
        chain.metrics.validator_monitor.on_gossip_attestation(
            int(data.target.epoch), res.attesting_indices
        )


def default_gossip_handlers(chain) -> dict:
    """validate → verify signature sets → pools/fork-choice dispatch
    (reference gossipHandlers.ts:245-281). Handlers raise on REJECT so
    the caller can downscore; IGNOREs return silently."""
    from lodestar_tpu_torch.chain.validation import (
        GossipAction,
        GossipValidationError,
        validate_gossip_aggregate_and_proof,
        validate_gossip_attestation,
        validate_gossip_block,
        validate_sync_committee_contribution,
        validate_sync_committee_message,
    )

    from lodestar_tpu_torch.chain.bls import VerifySignatureOpts
    from lodestar_tpu_torch.scheduler import PriorityClass

    # gossip attestations/aggregates/sync messages share one launch
    # class: urgent enough to outrank sync bulk, never ahead of a block
    _ATT_OPTS = VerifySignatureOpts(priority=PriorityClass.GOSSIP_ATTESTATION)

    async def _verify(sets) -> bool:
        return await chain.bls.verify_signature_sets(sets, _ATT_OPTS)

    async def on_block(message, peer):
        # root span: the whole slot pipeline (gossip validation → BLS →
        # STF → fork choice) stitches under this one trace
        with tracing.root("block_import", slot=int(message.message.slot)) as rt:
            try:
                validate_gossip_block(chain, message)
            except GossipValidationError as e:
                tracing.discard()  # no import ran: keep the trace ring real
                if e.action is GossipAction.REJECT:
                    raise
                return  # duplicates / future / parent-unknown are benign
            await chain.process_block(message, is_timely=True)
            _stamp_import_slack(rt, int(message.message.slot))

    async def on_block_and_blobs(message, peer):
        from lodestar_tpu_torch.chain.validation import validate_gossip_block_and_blobs_sidecar

        with tracing.root("block_import", slot=int(message.beacon_block.message.slot)) as rt:
            try:
                validate_gossip_block_and_blobs_sidecar(chain, message)
            except GossipValidationError as e:
                tracing.discard()
                if e.action is GossipAction.REJECT:
                    raise
                return
            await chain.process_block(message.beacon_block, is_timely=True)
            chain.put_blobs_sidecar(message.blobs_sidecar)
            _stamp_import_slack(rt, int(message.beacon_block.message.slot))

    async def on_attestation(message, peer):
        try:
            res = validate_gossip_attestation(chain, message)
        except GossipValidationError as e:
            if e.action is GossipAction.REJECT:
                raise
            return
        if not await _verify(res.signature_sets):
            raise GossipValidationError(GossipAction.REJECT, "bad attestation signature")
        import_verified_attestation(chain, res, message)

    async def on_aggregate(message, peer):
        try:
            res = validate_gossip_aggregate_and_proof(chain, message)
        except GossipValidationError as e:
            if e.action is GossipAction.REJECT:
                raise
            return
        if not await _verify(res.signature_sets):
            raise GossipValidationError(GossipAction.REJECT, "bad aggregate signatures")
        import_verified_attestation(chain, res, message.message.aggregate, aggregated=True)

    async def on_sync_message(item, peer):
        # item = (subnet, message) — the subnet rides with the topic
        subnet, message = item
        try:
            res = validate_sync_committee_message(chain, message, subnet)
        except GossipValidationError as e:
            if e.action is GossipAction.REJECT:
                raise
            return
        if not await _verify(res.signature_sets):
            raise GossipValidationError(GossipAction.REJECT, "bad sync message signature")
        res.register_seen()
        for pos in res.indices_in_subcommittee:
            chain.sync_committee_message_pool.add(subnet, message, pos)

    async def on_sync_contribution(message, peer):
        try:
            res = validate_sync_committee_contribution(chain, message)
        except GossipValidationError as e:
            if e.action is GossipAction.REJECT:
                raise
            return
        if not await _verify(res.signature_sets):
            raise GossipValidationError(GossipAction.REJECT, "bad contribution signatures")
        res.register_seen()
        chain.sync_contribution_pool.add(message.message)

    # op-pool topics run the SPEC processing (incl. signatures) on a
    # throwaway head-state clone before pooling — a garbage-signature
    # exit/slashing must never enter the pool where block production
    # would package it (reference validation/voluntaryExit.ts etc. route
    # these through the state transition checks)

    def _validation_state():
        return chain.get_head_state().copy()

    async def on_voluntary_exit(message, peer):
        from lodestar_tpu_torch.state_transition import BlockProcessError, EpochContext
        from lodestar_tpu_torch.state_transition.block import process_voluntary_exit

        if chain.op_pool.has_exit(int(message.message.validator_index)):
            return  # [IGNORE] already known
        state = _validation_state()
        try:
            process_voluntary_exit(state, message, EpochContext(state, chain.p), True, chain.cfg)
        except BlockProcessError as e:
            raise GossipValidationError(GossipAction.REJECT, f"invalid exit: {e}") from e
        chain.op_pool.insert_voluntary_exit(message)

    async def on_proposer_slashing(message, peer):
        from lodestar_tpu_torch.state_transition import BlockProcessError, EpochContext
        from lodestar_tpu_torch.state_transition.block import process_proposer_slashing

        state = _validation_state()
        try:
            process_proposer_slashing(state, message, EpochContext(state, chain.p), True, chain.cfg)
        except BlockProcessError as e:
            raise GossipValidationError(GossipAction.REJECT, f"invalid proposer slashing: {e}") from e
        chain.op_pool.insert_proposer_slashing(message)

    async def on_attester_slashing(message, peer):
        from lodestar_tpu_torch.state_transition import BlockProcessError, EpochContext
        from lodestar_tpu_torch.state_transition.block import process_attester_slashing

        state = _validation_state()
        try:
            process_attester_slashing(state, message, EpochContext(state, chain.p), True, chain.cfg)
        except BlockProcessError as e:
            raise GossipValidationError(GossipAction.REJECT, f"invalid attester slashing: {e}") from e
        t = chain.types
        root = t.AttesterSlashing.hash_tree_root(message)
        chain.op_pool.insert_attester_slashing(message, root)

    async def on_bls_change(message, peer):
        from lodestar_tpu_torch.state_transition import BlockProcessError, EpochContext
        from lodestar_tpu_torch.state_transition.capella import process_bls_to_execution_change

        state = _validation_state()
        try:
            process_bls_to_execution_change(
                state, message, EpochContext(state, chain.p), True, chain.cfg
            )
        except BlockProcessError as e:
            raise GossipValidationError(GossipAction.REJECT, f"invalid bls change: {e}") from e
        chain.op_pool.insert_bls_to_execution_change(message)

    return {
        "beacon_block": on_block,
        "beacon_block_and_blobs_sidecar": on_block_and_blobs,
        "beacon_attestation": on_attestation,
        "beacon_aggregate_and_proof": on_aggregate,
        "sync_committee": on_sync_message,
        "sync_committee_contribution_and_proof": on_sync_contribution,
        "voluntary_exit": on_voluntary_exit,
        "proposer_slashing": on_proposer_slashing,
        "attester_slashing": on_attester_slashing,
        "bls_to_execution_change": on_bls_change,
    }
