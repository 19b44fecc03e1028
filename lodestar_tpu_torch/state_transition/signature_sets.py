"""Signature-set producers: every BLS check in a block as a SignatureSet.

Reference `state-transition/src/signatureSets/index.ts:26`
(getBlockSignatureSets) — the bridge between the STF and the batched
verifier: instead of verifying inline, the block pipeline collects all
~100 sets per block and ships them to the device batch verifier in one
RLC batch (`verifyBlocksSignatures.ts:16` runs this in parallel with the
signature-free STF, which is why every process_* function here takes
`verify_signatures=False`).

Aggregate sets (attestations, the sync aggregate) pre-aggregate pubkeys on
host, matching the reference's main-thread aggregation
(`multithread/index.ts:152,177`).

The port of `lodestar_tpu.state_transition.signature_sets` (host Python and
numpy, as there), with one departure: as Lodestar's `getBlockSignatureSets`
does, the block's sets also hold, from Altair on, the sync aggregate's set
when it has at least one participant (`sync_committee_signature_set`), and
from Capella on one set per BLS-to-execution change
(`bls_to_execution_change_signature_set`). The JAX package builds neither,
so a chain that verifies through the sets and runs the transition with
`verify_signatures=False` (both packages' `BeaconChain`) never checks them
there; the port's chain does. As in Lodestar, an aggregate with no
participant must carry the point at infinity: any other signature raises
`SignatureSetError` ("Empty sync committee signature is not infinity"),
which the port's chain turns into an INVALID_SIGNATURES rejection. The
JAX transition refuses such a block only with `verify_signatures=True`.
"""

from __future__ import annotations

import hashlib

from lodestar_tpu_torch import ssz, tracing
from lodestar_tpu_torch.config import compute_domain
from lodestar_tpu_torch.crypto.bls.api import G2_INFINITY, SignatureSet, aggregate_pubkeys
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_BLS_TO_EXECUTION_CHANGE,
    DOMAIN_RANDAO,
    DOMAIN_SYNC_COMMITTEE,
    DOMAIN_VOLUNTARY_EXIT,
)
from lodestar_tpu_torch.types import ssz_types

from .cache import EpochContext
from .util import (
    compute_epoch_at_slot,
    compute_signing_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
)

__all__ = [
    "block_proposer_signature_set",
    "randao_signature_set",
    "indexed_attestation_signature_set",
    "voluntary_exit_signature_set",
    "sync_committee_signature_set",
    "bls_to_execution_change_signature_set",
    "get_block_signature_sets",
    "SignatureSetError",
]


def block_proposer_signature_set(state, signed_block, ctx: EpochContext) -> SignatureSet:
    from .block import block_types_for

    block = signed_block.message
    proposer = state.validators[block.proposer_index]
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER, compute_epoch_at_slot(block.slot, ctx.p))
    block_type, _ = block_types_for(state, ctx.p)
    return SignatureSet(
        pubkey=bytes(proposer.pubkey),
        message=compute_signing_root(block_type, block, domain),
        signature=bytes(signed_block.signature),
    )


def randao_signature_set(state, body, ctx: EpochContext) -> SignatureSet:
    epoch = get_current_epoch(state)
    proposer = state.validators[ctx.get_beacon_proposer(state.slot)]
    domain = get_domain(state, DOMAIN_RANDAO)
    return SignatureSet(
        pubkey=bytes(proposer.pubkey),
        message=compute_signing_root(ssz.uint64, epoch, domain),
        signature=bytes(body.randao_reveal),
    )


def indexed_attestation_signature_set(state, indexed, ctx: EpochContext) -> SignatureSet:
    t = ssz_types(ctx.p)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indexed.attesting_indices]
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch)
    return SignatureSet(
        pubkey=aggregate_pubkeys(pubkeys),
        message=compute_signing_root(t.AttestationData, indexed.data, domain),
        signature=bytes(indexed.signature),
    )


def proposer_slashing_signature_sets(state, ps, ctx: EpochContext) -> list[SignatureSet]:
    t = ssz_types(ctx.p)
    proposer = state.validators[ps.signed_header_1.message.proposer_index]
    out = []
    for signed in (ps.signed_header_1, ps.signed_header_2):
        domain = get_domain(
            state, DOMAIN_BEACON_PROPOSER, compute_epoch_at_slot(signed.message.slot, ctx.p)
        )
        out.append(
            SignatureSet(
                pubkey=bytes(proposer.pubkey),
                message=compute_signing_root(t.BeaconBlockHeader, signed.message, domain),
                signature=bytes(signed.signature),
            )
        )
    return out


def attester_slashing_signature_sets(state, als, ctx: EpochContext) -> list[SignatureSet]:
    return [
        indexed_attestation_signature_set(state, indexed, ctx)
        for indexed in (als.attestation_1, als.attestation_2)
    ]


def voluntary_exit_signature_set(state, signed_exit, ctx: EpochContext) -> SignatureSet:
    t = ssz_types(ctx.p)
    validator = state.validators[signed_exit.message.validator_index]
    domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, signed_exit.message.epoch)
    return SignatureSet(
        pubkey=bytes(validator.pubkey),
        message=compute_signing_root(t.VoluntaryExit, signed_exit.message, domain),
        signature=bytes(signed_exit.signature),
    )


class SignatureSetError(ValueError):
    """A block's signature field that no set can express (Lodestar throws
    from its signature-set producers for these)."""


def sync_committee_signature_set(state, sync_aggregate, ctx: EpochContext) -> SignatureSet | None:
    """The sync aggregate's set (reference `getSyncCommitteeSignatureSet`,
    `signatureSets/syncCommittee.ts`): its participants' pubkeys aggregated
    on the host, over the previous slot's block root under
    DOMAIN_SYNC_COMMITTEE at that slot's epoch, as `process_sync_aggregate`
    checks it. None when no member participates and the signature is the
    point at infinity (it needs no pairing); an empty aggregate with any
    other signature raises `SignatureSetError`."""
    bits = list(sync_aggregate.sync_committee_bits)
    pubkeys = [bytes(pk) for pk, bit in zip(state.current_sync_committee.pubkeys, bits) if bit]
    if not pubkeys:
        if bytes(sync_aggregate.sync_committee_signature) != G2_INFINITY:
            raise SignatureSetError("Empty sync committee signature is not infinity")
        return None
    previous_slot = max(int(state.slot), 1) - 1
    domain = get_domain(
        state, DOMAIN_SYNC_COMMITTEE, compute_epoch_at_slot(previous_slot, ctx.p)
    )
    root = get_block_root_at_slot(state, previous_slot, ctx.p)
    return SignatureSet(
        pubkey=aggregate_pubkeys(pubkeys),
        message=hashlib.sha256(root + domain).digest(),
        signature=bytes(sync_aggregate.sync_committee_signature),
    )


def bls_to_execution_change_signature_set(
    state, signed_change, ctx: EpochContext, cfg=None
) -> SignatureSet:
    """One BLS-to-execution change's set (reference
    `getBlsToExecutionChangeSignatureSet`): its domain pinned to the genesis
    fork version, as `capella.process_bls_to_execution_change` signs it."""
    t = ssz_types(ctx.p)
    change = signed_change.message
    genesis_version = cfg.GENESIS_FORK_VERSION if cfg is not None else b"\x00\x00\x00\x00"
    domain = compute_domain(
        DOMAIN_BLS_TO_EXECUTION_CHANGE, genesis_version, bytes(state.genesis_validators_root)
    )
    return SignatureSet(
        pubkey=bytes(change.from_bls_pubkey),
        message=compute_signing_root(t.BLSToExecutionChange, change, domain),
        signature=bytes(signed_change.signature),
    )


@tracing.traced("signature_sets")
def get_block_signature_sets(
    state,
    signed_block,
    ctx: EpochContext,
    *,
    include_proposer: bool = True,
    cfg=None,
) -> list[SignatureSet]:
    """All BLS checks for one block (reference getBlockSignatureSets).
    The state must already be advanced to the block's slot. `cfg` gives the
    genesis fork version of the BLS-to-execution changes' domain (zero
    without it, as in `capella.process_bls_to_execution_change`)."""
    from .block import get_indexed_attestation

    body = signed_block.message.body
    sets: list[SignatureSet] = []
    if include_proposer:
        sets.append(block_proposer_signature_set(state, signed_block, ctx))
    sets.append(randao_signature_set(state, body, ctx))
    for ps in body.proposer_slashings:
        sets.extend(proposer_slashing_signature_sets(state, ps, ctx))
    for als in body.attester_slashings:
        sets.extend(attester_slashing_signature_sets(state, als, ctx))
    for att in body.attestations:
        sets.append(
            indexed_attestation_signature_set(state, get_indexed_attestation(att, ctx), ctx)
        )
    for ex in body.voluntary_exits:
        sets.append(voluntary_exit_signature_set(state, ex, ctx))
    if hasattr(body, "sync_aggregate"):  # altair on
        sync_set = sync_committee_signature_set(state, body.sync_aggregate, ctx)
        if sync_set is not None:
            sets.append(sync_set)
    for change in getattr(body, "bls_to_execution_changes", ()):  # capella on
        sets.append(bls_to_execution_change_signature_set(state, change, ctx, cfg))
    return sets
