"""Signature-set producers: every BLS check in a block as a SignatureSet.

Reference `state-transition/src/signatureSets/index.ts:26`
(getBlockSignatureSets) — the bridge between the STF and the batched
verifier: instead of verifying inline, the block pipeline collects all
~100 sets per block and ships them to the device batch verifier in one
RLC batch (`verifyBlocksSignatures.ts:16` runs this in parallel with the
signature-free STF, which is why every process_* function here takes
`verify_signatures=False`).

Aggregate sets (attestations) pre-aggregate pubkeys on host, matching the
reference's main-thread aggregation (`multithread/index.ts:152,177`).

The port of `lodestar_tpu.state_transition.signature_sets` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch import ssz, tracing
from lodestar_tpu_torch.crypto.bls.api import SignatureSet, aggregate_pubkeys
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
)
from lodestar_tpu_torch.types import ssz_types

from .cache import EpochContext
from .util import (
    compute_epoch_at_slot,
    compute_signing_root,
    get_current_epoch,
    get_domain,
)

__all__ = [
    "block_proposer_signature_set",
    "randao_signature_set",
    "indexed_attestation_signature_set",
    "voluntary_exit_signature_set",
    "get_block_signature_sets",
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


@tracing.traced("signature_sets")
def get_block_signature_sets(
    state,
    signed_block,
    ctx: EpochContext,
    *,
    include_proposer: bool = True,
) -> list[SignatureSet]:
    """All BLS checks for one block (reference getBlockSignatureSets).
    The state must already be advanced to the block's slot."""
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
    return sets
