"""Gossip validation: the spec accept/ignore/reject checks per topic.

Reference `beacon-node/src/chain/validation/` — `validateGossipAttestation`
(`attestation.ts`), `validateGossipAggregateAndProof`
(`aggregateAndProof.ts`), `validateGossipBlock` (`block.ts`). The BLS
checks yield `SignatureSet`s for the batched verifier rather than
verifying inline (the `batchable: true` path of the hot loop,
`attestation.ts:271`).

The port of `lodestar_tpu.chain.validation` (host Python and numpy, as there).
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass

import numpy as np

from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.crypto.bls.api import SignatureSet
from lodestar_tpu_torch.params import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_SELECTION_PROOF,
)
from lodestar_tpu_torch.state_transition import EpochContext, compute_epoch_at_slot
from lodestar_tpu_torch.state_transition.signature_sets import indexed_attestation_signature_set
from lodestar_tpu_torch.state_transition.util import compute_signing_root, get_domain
from lodestar_tpu_torch.types import ssz_types

__all__ = [
    "GossipAction",
    "GossipValidationError",
    "validate_gossip_attestation",
    "validate_gossip_aggregate_and_proof",
    "validate_gossip_block",
    "is_aggregator",
]


class GossipAction(enum.Enum):
    IGNORE = "IGNORE"
    REJECT = "REJECT"


class GossipValidationError(Exception):
    def __init__(self, action: GossipAction, reason: str):
        super().__init__(f"{action.value}: {reason}")
        self.action = action
        self.reason = reason


def _state_dialed_to(chain, block_root: bytes, slot: int):
    """State of `block_root` advanced (copy-on-advance) so its epoch
    covers `slot` — epoch-boundary attestations need next-epoch
    shufflings the block's own post-state doesn't have (the reference
    regen dials to the target epoch, `attestation.ts:394-400`)."""
    from lodestar_tpu_torch.state_transition import compute_epoch_at_slot as epoch_at
    from lodestar_tpu_torch.state_transition import process_slots

    state = chain.get_state_by_block_root(block_root)
    if epoch_at(slot, chain.p) > epoch_at(state.slot, chain.p):
        state = state.copy()
        process_slots(state, slot, chain.p, chain.cfg)
    return state


@dataclass
class AttestationValidationResult:
    """`register_seen` must be called only AFTER the signature sets
    verify — registering earlier lets a bad-signature message censor the
    real one and fake liveness (same contract as the sync-committee
    results below)."""

    indexed_attestation: object
    attesting_indices: list[int]
    signature_sets: list[SignatureSet]
    register_seen: object = lambda: None


def validate_gossip_attestation(
    chain, attestation, subnet_id: int | None = None
) -> AttestationValidationResult:
    """Spec beacon_attestation topic checks (reference `attestation.ts`).
    `chain` provides: clock-ish current slot (fork_choice.current_slot),
    seen_attesters, fork_choice, head state ctx."""
    p = chain.p
    data = attestation.data
    target_epoch = data.target.epoch
    current_slot = chain.fork_choice.current_slot

    # [REJECT] one committee bit set exactly
    bits = list(attestation.aggregation_bits)
    if sum(1 for b in bits if b) != 1:
        raise GossipValidationError(GossipAction.REJECT, "not exactly one aggregation bit")
    # [REJECT] epoch matches slot
    if target_epoch != compute_epoch_at_slot(data.slot, p):
        raise GossipValidationError(GossipAction.REJECT, "target epoch != slot epoch")
    # [IGNORE] propagation window (slot +/- ATTESTATION_PROPAGATION_SLOT_RANGE)
    if not (data.slot <= current_slot <= data.slot + 32):
        raise GossipValidationError(GossipAction.IGNORE, "outside propagation window")
    # [IGNORE] known block root
    head_root_hex = "0x" + bytes(data.beacon_block_root).hex()
    block = chain.fork_choice.proto_array.get_block(head_root_hex)
    if block is None:
        raise GossipValidationError(GossipAction.IGNORE, "unknown beacon block root")
    # [REJECT] target must be the epoch-start ancestor of the attested block
    target_slot = target_epoch * p.SLOTS_PER_EPOCH
    expected_target = chain.fork_choice.proto_array._ancestor_or_none(head_root_hex, target_slot)
    if expected_target is None or bytes.fromhex(expected_target[2:]) != bytes(data.target.root):
        raise GossipValidationError(GossipAction.REJECT, "target is not the block's epoch ancestor")
    state = _state_dialed_to(chain, bytes(data.beacon_block_root), data.slot)
    ctx = EpochContext(state, p)
    try:
        committee = ctx.get_beacon_committee(data.slot, data.index)
    except ValueError as e:
        raise GossipValidationError(GossipAction.REJECT, f"bad committee: {e}") from e
    if len(bits) != len(committee):
        raise GossipValidationError(GossipAction.REJECT, "bits/committee length mismatch")
    attesting = [int(committee[i]) for i, b in enumerate(bits) if b]
    vi = attesting[0]
    # [IGNORE] first-seen per (target epoch, validator)
    if chain.seen_attesters.is_known(target_epoch, vi):
        raise GossipValidationError(GossipAction.IGNORE, "already seen attester")

    from lodestar_tpu_torch.state_transition.block import get_indexed_attestation

    indexed = get_indexed_attestation(attestation, ctx)
    sig_set = indexed_attestation_signature_set(state, indexed, ctx)
    return AttestationValidationResult(
        indexed_attestation=indexed,
        attesting_indices=attesting,
        signature_sets=[sig_set],
        register_seen=lambda: chain.seen_attesters.add(target_epoch, vi),
    )


TARGET_AGGREGATORS_PER_COMMITTEE = 16


def is_aggregator(committee_len: int, slot_signature: bytes) -> bool:
    """Spec is_aggregator: hash(sig) mod max(1, len//TARGET) == 0
    (reference `state-transition/src/util/aggregator.ts`)."""
    modulo = max(1, committee_len // TARGET_AGGREGATORS_PER_COMMITTEE)
    h = hashlib.sha256(slot_signature).digest()
    return int.from_bytes(h[:8], "little") % modulo == 0


def validate_gossip_aggregate_and_proof(chain, signed_agg) -> AttestationValidationResult:
    """beacon_aggregate_and_proof checks (reference `aggregateAndProof.ts`):
    structure + aggregator membership/selection + the three signature
    sets (selection proof, aggregate-and-proof envelope, aggregate)."""
    p = chain.p
    t = ssz_types(p)
    agg = signed_agg.message
    attestation = agg.aggregate
    data = attestation.data
    current_slot = chain.fork_choice.current_slot

    if not (data.slot <= current_slot <= data.slot + 32):
        raise GossipValidationError(GossipAction.IGNORE, "outside propagation window")
    if data.target.epoch != compute_epoch_at_slot(data.slot, p):
        raise GossipValidationError(GossipAction.REJECT, "target epoch != slot epoch")
    root_hex = "0x" + bytes(data.beacon_block_root).hex()
    if chain.fork_choice.proto_array.get_block(root_hex) is None:
        raise GossipValidationError(GossipAction.IGNORE, "unknown beacon block root")
    target_slot = data.target.epoch * p.SLOTS_PER_EPOCH
    expected_target = chain.fork_choice.proto_array._ancestor_or_none(root_hex, target_slot)
    if expected_target is None or bytes.fromhex(expected_target[2:]) != bytes(data.target.root):
        raise GossipValidationError(GossipAction.REJECT, "target is not the block's epoch ancestor")

    state = _state_dialed_to(chain, bytes(data.beacon_block_root), data.slot)
    ctx = EpochContext(state, p)
    try:
        committee = ctx.get_beacon_committee(data.slot, data.index)
    except ValueError as e:
        raise GossipValidationError(GossipAction.REJECT, f"bad committee: {e}") from e
    # [REJECT] aggregator in committee
    if agg.aggregator_index not in [int(i) for i in committee]:
        raise GossipValidationError(GossipAction.REJECT, "aggregator not in committee")
    # [REJECT] selection proof selects the aggregator
    if not is_aggregator(len(committee), bytes(agg.selection_proof)):
        raise GossipValidationError(GossipAction.REJECT, "selection proof does not select")
    # [IGNORE] first aggregate per (target epoch, aggregator)
    if chain.seen_aggregators.is_known(int(data.target.epoch), int(agg.aggregator_index)):
        raise GossipValidationError(GossipAction.IGNORE, "already seen aggregator")

    from lodestar_tpu_torch import ssz
    from lodestar_tpu_torch.state_transition.block import get_indexed_attestation

    aggregator = state.validators[agg.aggregator_index]
    sets = [
        # selection proof over the slot
        SignatureSet(
            pubkey=bytes(aggregator.pubkey),
            message=compute_signing_root(
                ssz.uint64, data.slot, get_domain(state, DOMAIN_SELECTION_PROOF, data.target.epoch)
            ),
            signature=bytes(agg.selection_proof),
        ),
        # aggregate-and-proof envelope
        SignatureSet(
            pubkey=bytes(aggregator.pubkey),
            message=compute_signing_root(
                t.AggregateAndProof, agg, get_domain(state, DOMAIN_AGGREGATE_AND_PROOF, data.target.epoch)
            ),
            signature=bytes(signed_agg.signature),
        ),
    ]
    indexed = get_indexed_attestation(attestation, ctx)
    sets.append(indexed_attestation_signature_set(state, indexed, ctx))
    return AttestationValidationResult(
        indexed_attestation=indexed,
        attesting_indices=[int(i) for i in indexed.attesting_indices],
        signature_sets=sets,
        register_seen=lambda: chain.seen_aggregators.add(
            int(data.target.epoch), int(agg.aggregator_index)
        ),
    )


def validate_gossip_block(chain, signed_block) -> None:
    """beacon_block topic checks (reference `validation/block.ts`)."""
    with tracing.span("gossip_validation") as sp:
        if sp:
            sp.set(topic="beacon_block")
        p = chain.p
        block = signed_block.message
        current_slot = chain.fork_choice.current_slot
        if block.slot > current_slot:
            raise GossipValidationError(GossipAction.IGNORE, "future slot")
        finalized_slot = chain.fork_choice.finalized.epoch * p.SLOTS_PER_EPOCH
        if block.slot <= finalized_slot:
            raise GossipValidationError(GossipAction.IGNORE, "finalized slot")
        root_hex = "0x" + bytes(block.parent_root).hex()
        if chain.fork_choice.proto_array.get_block(root_hex) is None:
            raise GossipValidationError(GossipAction.IGNORE, "parent unknown")
        block_type, _signed = chain.block_type_at_slot(int(block.slot))
        block_root = block_type.hash_tree_root(block)
        if chain.fork_choice.proto_array.has_block("0x" + block_root.hex()):
            raise GossipValidationError(GossipAction.IGNORE, "already known")


# --- sync committee topics ----------------------------------------------------
# Reference `validation/syncCommittee.ts` (sync_committee_{subnet_id}) and
# `validation/syncCommitteeContributionAndProof.ts`.


@dataclass
class SyncCommitteeValidationResult:
    """`register_seen` MUST be called only after the signature sets have
    verified — marking earlier would let a garbage-signature message
    censor the real one for the slot (the reference registers its seen
    caches post-verification)."""

    indices_in_subcommittee: list
    signature_sets: list
    register_seen: object  # () -> None

    @property
    def index_in_subcommittee(self) -> int:
        return self.indices_in_subcommittee[0] if self.indices_in_subcommittee else -1


def _sync_signing_root(block_root: bytes, domain: bytes) -> bytes:
    # SigningData(object_root=Root, domain) root == sha256(root || domain)
    return hashlib.sha256(bytes(block_root) + domain).digest()


# (id(committee), subnet) -> (committee ref, pubkeys, pubkey->positions).
# The strong committee ref keeps the id stable while the entry lives;
# sync committees rotate once per period so a tiny cache suffices.
_SUBCOMMITTEE_CACHE: dict = {}


def _committee_for_slot(state, slot: int, p):
    """The committee that signs sync messages AT `slot`: their aggregate
    lands in the block at slot+1 and verifies against THAT state's
    current committee, so the last slot of every period is signed by the
    rotated (next) committee — matching the duty producer
    (validator/__init__.py _run_sync_duties) and process_sync_aggregate.
    A message whose inclusion period precedes the head state's is
    unverifiable from here (the old committee is gone) — IGNORE it
    rather than REJECT-penalizing an honest boundary peer."""
    period_len = p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD * p.SLOTS_PER_EPOCH
    inclusion_period = (int(slot) + 1) // period_len
    state_period = int(state.slot) // period_len
    if inclusion_period == state_period + 1:
        return state.next_sync_committee
    if inclusion_period < state_period:
        raise GossipValidationError(
            GossipAction.IGNORE, "message from a previous sync-committee period"
        )
    return state.current_sync_committee


def _subcommittee_pubkeys(state, subnet: int, p, slot: int | None = None) -> tuple[list[bytes], dict]:
    from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT

    committee = (
        _committee_for_slot(state, slot, p) if slot is not None else state.current_sync_committee
    )
    key = (id(committee), int(subnet))
    hit = _SUBCOMMITTEE_CACHE.get(key)
    if hit is not None and hit[0] is committee:
        return hit[1], hit[2]
    sub = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    pks = [bytes(pk) for pk in list(committee.pubkeys)[subnet * sub : (subnet + 1) * sub]]
    positions: dict = {}
    for i, pk in enumerate(pks):  # sampled with replacement: dup positions
        positions.setdefault(pk, []).append(i)
    if len(_SUBCOMMITTEE_CACHE) > 64:
        _SUBCOMMITTEE_CACHE.clear()
    _SUBCOMMITTEE_CACHE[key] = (committee, pks, positions)
    return pks, positions


def validate_sync_committee_message(chain, message, subnet: int) -> SyncCommitteeValidationResult:
    """sync_committee_{subnet} topic checks; returns the signature set
    for the batched verifier plus the subcommittee position needed by
    the message pool."""
    p = chain.p
    slot = int(message.slot)
    current_slot = chain.fork_choice.current_slot
    # [IGNORE] message for the current slot (+- one slot of disparity)
    if not (current_slot - 1 <= slot <= current_slot + 1):
        raise GossipValidationError(GossipAction.IGNORE, "not current slot")

    state = chain.get_head_state()
    vi = int(message.validator_index)
    if vi >= len(state.validators):
        raise GossipValidationError(GossipAction.REJECT, "unknown validator index")
    pubkey = bytes(state.validators[vi].pubkey)
    _sub_pks, positions = _subcommittee_pubkeys(state, subnet, p, slot)
    indices = positions.get(pubkey)
    if not indices:
        raise GossipValidationError(GossipAction.REJECT, "validator not in subcommittee")

    # [IGNORE] first message per (slot, validator, subnet)
    if chain.seen_sync_messages.is_known(slot, vi, subnet):
        raise GossipValidationError(GossipAction.IGNORE, "already seen sync message")

    from lodestar_tpu_torch.params import DOMAIN_SYNC_COMMITTEE

    epoch = slot // p.SLOTS_PER_EPOCH
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
    sig_set = SignatureSet(
        pubkey=pubkey,
        message=_sync_signing_root(bytes(message.beacon_block_root), domain),
        signature=bytes(message.signature),
    )
    return SyncCommitteeValidationResult(
        indices_in_subcommittee=list(indices),
        signature_sets=[sig_set],
        register_seen=lambda: chain.seen_sync_messages.add(slot, vi, subnet),
    )


def is_sync_committee_aggregator(selection_proof: bytes, p) -> bool:
    """Spec is_sync_committee_aggregator (reference
    `state-transition/src/util/aggregator.ts isSyncCommitteeAggregator`)."""
    from lodestar_tpu_torch.params import (
        SYNC_COMMITTEE_SUBNET_COUNT,
        TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
    )

    modulo = max(
        1,
        p.SYNC_COMMITTEE_SIZE
        // SYNC_COMMITTEE_SUBNET_COUNT
        // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE,
    )
    h = hashlib.sha256(bytes(selection_proof)).digest()
    return int.from_bytes(h[:8], "little") % modulo == 0


def validate_sync_committee_contribution(chain, signed) -> SyncCommitteeValidationResult:
    """sync_committee_contribution_and_proof topic checks; returns three
    signature sets (selection proof, outer signature, aggregate
    contribution)."""
    from lodestar_tpu_torch.crypto.bls.api import aggregate_pubkeys
    from lodestar_tpu_torch.params import (
        DOMAIN_CONTRIBUTION_AND_PROOF,
        DOMAIN_SYNC_COMMITTEE,
        DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        SYNC_COMMITTEE_SUBNET_COUNT,
    )

    p = chain.p
    t = ssz_types(p)
    cp = signed.message
    contribution = cp.contribution
    slot = int(contribution.slot)
    subnet = int(contribution.subcommittee_index)
    current_slot = chain.fork_choice.current_slot

    if not (current_slot - 1 <= slot <= current_slot + 1):
        raise GossipValidationError(GossipAction.IGNORE, "not current slot")
    if subnet >= SYNC_COMMITTEE_SUBNET_COUNT:
        raise GossipValidationError(GossipAction.REJECT, "bad subcommittee index")
    bits = list(contribution.aggregation_bits)
    if not any(bits):
        raise GossipValidationError(GossipAction.REJECT, "empty contribution")
    if not is_sync_committee_aggregator(bytes(cp.selection_proof), p):
        raise GossipValidationError(GossipAction.REJECT, "selection proof not aggregator")

    state = chain.get_head_state()
    ai = int(cp.aggregator_index)
    if ai >= len(state.validators):
        raise GossipValidationError(GossipAction.REJECT, "unknown aggregator index")
    agg_pubkey = bytes(state.validators[ai].pubkey)
    sub_pks, positions = _subcommittee_pubkeys(state, subnet, p, slot)
    if agg_pubkey not in positions:
        raise GossipValidationError(GossipAction.REJECT, "aggregator not in subcommittee")
    if chain.seen_sync_aggregators.is_known(slot, ai, subnet):
        raise GossipValidationError(GossipAction.IGNORE, "already seen contribution aggregator")

    epoch = slot // p.SLOTS_PER_EPOCH
    sel_data = t.SyncAggregatorSelectionData.default()
    sel_data.slot = slot
    sel_data.subcommittee_index = subnet
    sel_domain = get_domain(state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
    selection_set = SignatureSet(
        pubkey=agg_pubkey,
        message=compute_signing_root(t.SyncAggregatorSelectionData, sel_data, sel_domain),
        signature=bytes(cp.selection_proof),
    )
    outer_domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
    outer_set = SignatureSet(
        pubkey=agg_pubkey,
        message=compute_signing_root(t.ContributionAndProof, cp, outer_domain),
        signature=bytes(signed.signature),
    )
    participating = [sub_pks[i] for i, b in enumerate(bits) if b]
    sync_domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)
    contribution_set = SignatureSet(
        pubkey=aggregate_pubkeys(participating),
        message=_sync_signing_root(bytes(contribution.beacon_block_root), sync_domain),
        signature=bytes(contribution.signature),
    )
    return SyncCommitteeValidationResult(
        indices_in_subcommittee=[],
        signature_sets=[selection_set, outer_set, contribution_set],
        register_seen=lambda: chain.seen_sync_aggregators.add(slot, ai, subnet),
    )


def validate_gossip_block_and_blobs_sidecar(chain, signed_coupled) -> None:
    """beacon_block_and_blobs_sidecar topic (reference
    `validation/blobsSidecar.ts validateGossipBlobsSidecar` + the block
    checks): commitments are valid G1 points, match the payload's blob
    transactions, and the coupled sidecar's aggregate KZG proof verifies
    against the block's commitments."""
    from lodestar_tpu_torch.crypto.bls import curve as _curve
    from lodestar_tpu_torch.crypto.bls.serdes import PointDecodeError, g1_from_bytes
    from lodestar_tpu_torch.crypto.kzg import KzgError, validate_blobs_sidecar
    from lodestar_tpu_torch.state_transition.deneb import (
        verify_kzg_commitments_against_transactions,
    )

    signed_block = signed_coupled.beacon_block
    sidecar = signed_coupled.blobs_sidecar
    block = signed_block.message
    validate_gossip_block(chain, signed_block)

    commitments = [bytes(c) for c in block.body.blob_kzg_commitments]
    # [REJECT] commitments KeyValidate: decodable G1 points IN the
    # subgroup (g1_from_bytes raises on malformed encodings and defers
    # the subgroup check to the caller)
    for i, c in enumerate(commitments):
        try:
            pt = g1_from_bytes(c)
        except PointDecodeError as e:
            raise GossipValidationError(
                GossipAction.REJECT, f"bad KZG commitment {i}: {e}"
            ) from e
        if pt is not None and not _curve.g1_in_subgroup(pt):
            raise GossipValidationError(
                GossipAction.REJECT, f"KZG commitment {i} outside subgroup"
            )
    # [REJECT] commitments match the blob transactions' versioned hashes
    try:
        verify_kzg_commitments_against_transactions(
            list(block.body.execution_payload.transactions), commitments
        )
    except Exception as e:
        raise GossipValidationError(GossipAction.REJECT, f"commitments vs txs: {e}") from e
    # [REJECT] coupled sidecar binds to this block and its proof verifies
    t = chain.types
    block_root = t.deneb.BeaconBlock.hash_tree_root(block)
    try:
        validate_blobs_sidecar(
            int(block.slot), block_root, commitments, sidecar
        )
    except KzgError as e:
        raise GossipValidationError(GossipAction.REJECT, f"blobs sidecar: {e}") from e
