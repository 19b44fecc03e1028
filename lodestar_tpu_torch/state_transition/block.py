"""Phase0 block processing.

Reference `state-transition/src/block/` (processBlockHeader, processRandao,
processEth1Data, processOperations + per-op functions, slashValidator) —
written from the phase0 consensus spec with the reference's split between
STF-time checks and signature verification: `verify_signatures=False`
defers all BLS checks to the batched signature-set pipeline
(`signature_sets.py`), exactly how the reference's block import runs STF
and signature verification in parallel (`verifyBlock.ts:89-111`).

The port of `lodestar_tpu.state_transition.block` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

import numpy as np

from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_DEPOSIT,
    DOMAIN_RANDAO,
    DOMAIN_VOLUNTARY_EXIT,
    FAR_FUTURE_EPOCH,
    BeaconPreset,
)
from lodestar_tpu_torch.types import ssz_types

from .cache import EpochContext
from .epoch import _initiate_validator_exit
from .util import (
    compute_epoch_at_slot,
    compute_signing_root,
    decrease_balance,
    get_current_epoch,
    get_domain,
    get_previous_epoch,
    get_randao_mix,
    increase_balance,
    is_active_validator,
    is_slashable_validator,
    uint_to_bytes,
)

__all__ = [
    "process_block",
    "process_block_header",
    "process_randao",
    "process_eth1_data",
    "process_operations",
    "process_proposer_slashing",
    "process_attester_slashing",
    "process_attestation",
    "process_deposit",
    "process_voluntary_exit",
    "is_valid_indexed_attestation",
    "get_indexed_attestation",
    "slash_validator",
    "BlockProcessError",
]


class BlockProcessError(Exception):
    pass


def _t(p: BeaconPreset):
    return ssz_types(p)


_FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb")


def fork_of(state) -> str:
    """Fork name from the state container (BeaconStateAltair -> altair)."""
    name = state.type.name.lower()
    for fork in _FORKS:
        if name.endswith(fork):
            return fork
    return "phase0"


def block_types_for(state, p: BeaconPreset):
    """(BeaconBlock, BeaconBlockBody) container types for the state's fork."""
    t = _t(p)
    ns = getattr(t, fork_of(state))
    return ns.BeaconBlock, ns.BeaconBlockBody


def process_block_header(state, block, ctx: EpochContext) -> None:
    p = ctx.p
    t = _t(p)
    if block.slot != state.slot:
        raise BlockProcessError(f"block slot {block.slot} != state slot {state.slot}")
    if block.slot <= state.latest_block_header.slot:
        raise BlockProcessError("block slot not newer than latest header")
    if block.proposer_index != ctx.get_beacon_proposer(block.slot):
        raise BlockProcessError("wrong proposer index")
    if bytes(block.parent_root) != t.BeaconBlockHeader.hash_tree_root(state.latest_block_header):
        raise BlockProcessError("parent root mismatch")

    header = t.BeaconBlockHeader.default()
    header.slot = block.slot
    header.proposer_index = block.proposer_index
    header.parent_root = bytes(block.parent_root)
    header.state_root = b"\x00" * 32  # overwritten at the next slot processing
    header.body_root = block_types_for(state, p)[1].hash_tree_root(block.body)
    state.latest_block_header = header

    proposer = state.validators[block.proposer_index]
    if proposer.slashed:
        raise BlockProcessError("proposer is slashed")


def process_randao(state, body, ctx: EpochContext, verify_signatures: bool = True) -> None:
    p = ctx.p
    epoch = get_current_epoch(state)
    if verify_signatures:
        from lodestar_tpu_torch import ssz

        proposer = state.validators[ctx.get_beacon_proposer(state.slot)]
        domain = get_domain(state, DOMAIN_RANDAO)
        root = compute_signing_root(ssz.uint64, epoch, domain)
        if not bls.verify(bytes(proposer.pubkey), root, bytes(body.randao_reveal)):
            raise BlockProcessError("invalid randao reveal")
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch, p), hashlib.sha256(bytes(body.randao_reveal)).digest()
        )
    )
    state.randao_mixes[epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = mix


def process_eth1_data(state, body, ctx: EpochContext) -> None:
    p = ctx.p
    state.eth1_data_votes.append(body.eth1_data)
    period_len = p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH
    t = _t(p)
    vote_bytes = t.Eth1Data.serialize(body.eth1_data)
    same = sum(
        1 for v in state.eth1_data_votes if t.Eth1Data.serialize(v) == vote_bytes
    )
    if same * 2 > period_len:
        state.eth1_data = body.eth1_data


# -- operations ---------------------------------------------------------------


def _is_slashable_attestation_data(d1, d2, t) -> bool:
    double = (
        t.AttestationData.hash_tree_root(d1) != t.AttestationData.hash_tree_root(d2)
        and d1.target.epoch == d2.target.epoch
    )
    surround = d1.source.epoch < d2.source.epoch and d2.target.epoch < d1.target.epoch
    return double or surround


def is_valid_indexed_attestation(state, indexed, ctx: EpochContext, verify_signature: bool = True) -> bool:
    indices = list(indexed.attesting_indices)
    if not indices or indices != sorted(set(indices)):
        return False
    if any(i >= len(state.validators) for i in indices):
        return False
    if not verify_signature:
        return True
    t = _t(ctx.p)
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, indexed.data.target.epoch)
    root = compute_signing_root(t.AttestationData, indexed.data, domain)
    return bls.fast_aggregate_verify(pubkeys, root, bytes(indexed.signature))


def get_indexed_attestation(attestation, ctx: EpochContext):
    t = _t(ctx.p)
    attesting = ctx.get_attesting_indices(attestation.data, attestation.aggregation_bits)
    idx = t.IndexedAttestation.default()
    idx.attesting_indices = sorted(int(i) for i in attesting)
    idx.data = attestation.data
    idx.signature = bytes(attestation.signature)
    return idx


def slash_validator(state, slashed_index: int, ctx: EpochContext, whistleblower_index: int | None = None, cfg=None) -> None:
    """Fork-aware slashing: the penalty quotient tightens per fork and
    altair+ splits the whistleblower reward by PROPOSER_WEIGHT (reference
    `block/slashValidator.ts:45-58`)."""
    from lodestar_tpu_torch.params import PROPOSER_WEIGHT, WEIGHT_DENOMINATOR

    p = ctx.p
    fork = fork_of(state)
    epoch = get_current_epoch(state)
    churn_quotient = cfg.CHURN_LIMIT_QUOTIENT if cfg is not None else 65536
    min_churn = cfg.MIN_PER_EPOCH_CHURN_LIMIT if cfg is not None else 4
    _initiate_validator_exit(state, slashed_index, p, churn_quotient, min_churn)
    v = state.validators[slashed_index]
    v.slashed = True
    v.withdrawable_epoch = max(v.withdrawable_epoch, epoch + p.EPOCHS_PER_SLASHINGS_VECTOR)
    state.slashings[epoch % p.EPOCHS_PER_SLASHINGS_VECTOR] += v.effective_balance
    if fork == "phase0":
        quotient = p.MIN_SLASHING_PENALTY_QUOTIENT
    elif fork == "altair":
        quotient = p.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    else:
        quotient = p.MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX
    decrease_balance(state, slashed_index, v.effective_balance // quotient)

    proposer_index = ctx.get_beacon_proposer(state.slot)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = v.effective_balance // p.WHISTLEBLOWER_REWARD_QUOTIENT
    if fork == "phase0":
        proposer_reward = whistleblower_reward // p.PROPOSER_REWARD_QUOTIENT
    else:
        proposer_reward = whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, whistleblower_reward - proposer_reward)


def process_proposer_slashing(state, ps, ctx: EpochContext, verify_signatures: bool = True, cfg=None) -> None:
    t = _t(ctx.p)
    h1, h2 = ps.signed_header_1.message, ps.signed_header_2.message
    if h1.slot != h2.slot:
        raise BlockProcessError("proposer slashing: slot mismatch")
    if h1.proposer_index != h2.proposer_index:
        raise BlockProcessError("proposer slashing: proposer mismatch")
    if t.BeaconBlockHeader.hash_tree_root(h1) == t.BeaconBlockHeader.hash_tree_root(h2):
        raise BlockProcessError("proposer slashing: identical headers")
    proposer = state.validators[h1.proposer_index]
    if not is_slashable_validator(proposer, get_current_epoch(state)):
        raise BlockProcessError("proposer slashing: not slashable")
    if verify_signatures:
        for signed in (ps.signed_header_1, ps.signed_header_2):
            domain = get_domain(
                state, DOMAIN_BEACON_PROPOSER, compute_epoch_at_slot(signed.message.slot, ctx.p)
            )
            root = compute_signing_root(t.BeaconBlockHeader, signed.message, domain)
            if not bls.verify(bytes(proposer.pubkey), root, bytes(signed.signature)):
                raise BlockProcessError("proposer slashing: bad signature")
    slash_validator(state, h1.proposer_index, ctx, cfg=cfg)


def process_attester_slashing(state, als, ctx: EpochContext, verify_signatures: bool = True, cfg=None) -> None:
    t = _t(ctx.p)
    a1, a2 = als.attestation_1, als.attestation_2
    if not _is_slashable_attestation_data(a1.data, a2.data, t):
        raise BlockProcessError("attester slashing: not slashable data")
    if not is_valid_indexed_attestation(state, a1, ctx, verify_signatures):
        raise BlockProcessError("attester slashing: attestation 1 invalid")
    if not is_valid_indexed_attestation(state, a2, ctx, verify_signatures):
        raise BlockProcessError("attester slashing: attestation 2 invalid")
    slashed_any = False
    epoch = get_current_epoch(state)
    common = sorted(set(a1.attesting_indices) & set(a2.attesting_indices))
    for index in common:
        if is_slashable_validator(state.validators[index], epoch):
            slash_validator(state, index, ctx, cfg=cfg)
            slashed_any = True
    if not slashed_any:
        raise BlockProcessError("attester slashing: no one slashed")


def process_attestation(state, attestation, ctx: EpochContext, verify_signatures: bool = True) -> None:
    p = ctx.p
    t = _t(p)
    data = attestation.data
    current_epoch = get_current_epoch(state)
    previous_epoch = get_previous_epoch(state)

    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BlockProcessError("attestation: target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, p):
        raise BlockProcessError("attestation: target epoch != slot epoch")
    if not (data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot <= data.slot + p.SLOTS_PER_EPOCH):
        raise BlockProcessError("attestation: inclusion window")
    if data.index >= ctx.get_committee_count_per_slot(data.target.epoch):
        raise BlockProcessError("attestation: committee index out of range")

    committee = ctx.get_beacon_committee(data.slot, data.index)
    if len(attestation.aggregation_bits) != len(committee):
        raise BlockProcessError("attestation: bits/committee length mismatch")

    pending = t.PendingAttestation.default()
    pending.data = data
    pending.aggregation_bits = list(attestation.aggregation_bits)
    pending.inclusion_delay = state.slot - data.slot
    pending.proposer_index = ctx.get_beacon_proposer(state.slot)

    if data.target.epoch == current_epoch:
        if (
            data.source.epoch != state.current_justified_checkpoint.epoch
            or bytes(data.source.root) != bytes(state.current_justified_checkpoint.root)
        ):
            raise BlockProcessError("attestation: wrong current source")
        state.current_epoch_attestations.append(pending)
    else:
        if (
            data.source.epoch != state.previous_justified_checkpoint.epoch
            or bytes(data.source.root) != bytes(state.previous_justified_checkpoint.root)
        ):
            raise BlockProcessError("attestation: wrong previous source")
        state.previous_epoch_attestations.append(pending)

    if not is_valid_indexed_attestation(state, get_indexed_attestation(attestation, ctx), ctx, verify_signatures):
        raise BlockProcessError("attestation: invalid indexed attestation")


def process_deposit(state, deposit, ctx: EpochContext, cfg=None) -> None:
    p = ctx.p
    t = _t(p)
    from lodestar_tpu_torch.ssz.merkle import verify_merkle_branch

    root = t.DepositData.hash_tree_root(deposit.data)
    if not verify_merkle_branch(
        root,
        [bytes(b) for b in deposit.proof],
        state.eth1_deposit_index,
        bytes(state.eth1_data.deposit_root),
    ):
        raise BlockProcessError("deposit: bad merkle proof")
    state.eth1_deposit_index += 1

    pubkey = bytes(deposit.data.pubkey)
    amount = deposit.data.amount
    known = {bytes(v.pubkey): i for i, v in enumerate(state.validators)}
    if pubkey not in known:
        # deposit signature is self-signed (proof of possession): invalid
        # signature -> deposit silently skipped, per spec
        domain = bls_deposit_domain(cfg)
        msg = t.DepositMessage.default()
        msg.pubkey = pubkey
        msg.withdrawal_credentials = bytes(deposit.data.withdrawal_credentials)
        msg.amount = amount
        root = compute_signing_root(t.DepositMessage, msg, domain)
        if not bls.verify(pubkey, root, bytes(deposit.data.signature)):
            return
        v = t.Validator.default()
        v.pubkey = pubkey
        v.withdrawal_credentials = bytes(deposit.data.withdrawal_credentials)
        v.activation_eligibility_epoch = FAR_FUTURE_EPOCH
        v.activation_epoch = FAR_FUTURE_EPOCH
        v.exit_epoch = FAR_FUTURE_EPOCH
        v.withdrawable_epoch = FAR_FUTURE_EPOCH
        v.effective_balance = min(
            amount - amount % p.EFFECTIVE_BALANCE_INCREMENT, p.MAX_EFFECTIVE_BALANCE
        )
        state.validators.append(v)
        state.balances.append(amount)
    else:
        increase_balance(state, known[pubkey], amount)


def bls_deposit_domain(cfg=None) -> bytes:
    from lodestar_tpu_torch.config import compute_domain

    genesis_fork_version = cfg.GENESIS_FORK_VERSION if cfg is not None else bytes(4)
    # deposits are valid across forks: domain uses genesis fork + zero root
    return compute_domain(DOMAIN_DEPOSIT, genesis_fork_version, b"\x00" * 32)


def process_voluntary_exit(state, signed_exit, ctx: EpochContext, verify_signatures: bool = True, cfg=None) -> None:
    p = ctx.p
    t = _t(p)
    exit_ = signed_exit.message
    if exit_.validator_index >= len(state.validators):
        raise BlockProcessError("exit: unknown validator")
    validator = state.validators[exit_.validator_index]
    current_epoch = get_current_epoch(state)
    if not is_active_validator(validator, current_epoch):
        raise BlockProcessError("exit: validator not active")
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        raise BlockProcessError("exit: already exiting")
    if current_epoch < exit_.epoch:
        raise BlockProcessError("exit: not yet valid")
    if current_epoch < validator.activation_epoch + p.SHARD_COMMITTEE_PERIOD:
        raise BlockProcessError("exit: validator too young")
    if verify_signatures:
        domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, exit_.epoch)
        root = compute_signing_root(t.VoluntaryExit, exit_, domain)
        if not bls.verify(bytes(validator.pubkey), root, bytes(signed_exit.signature)):
            raise BlockProcessError("exit: bad signature")
    churn_quotient = cfg.CHURN_LIMIT_QUOTIENT if cfg is not None else 65536
    min_churn = cfg.MIN_PER_EPOCH_CHURN_LIMIT if cfg is not None else 4
    _initiate_validator_exit(state, exit_.validator_index, p, churn_quotient, min_churn)


def process_operations(state, body, ctx: EpochContext, verify_signatures: bool = True, cfg=None) -> None:
    p = ctx.p
    expected_deposits = min(
        p.MAX_DEPOSITS, state.eth1_data.deposit_count - state.eth1_deposit_index
    )
    if len(body.deposits) != expected_deposits:
        raise BlockProcessError(
            f"expected {expected_deposits} deposits, block has {len(body.deposits)}"
        )
    altair_plus = fork_of(state) != "phase0"
    for ps in body.proposer_slashings:
        process_proposer_slashing(state, ps, ctx, verify_signatures, cfg)
    for als in body.attester_slashings:
        process_attester_slashing(state, als, ctx, verify_signatures, cfg)
    if altair_plus:
        from .altair import process_attestation_altair

        for att in body.attestations:
            process_attestation_altair(state, att, ctx, verify_signatures)
    else:
        for att in body.attestations:
            process_attestation(state, att, ctx, verify_signatures)
    for dep in body.deposits:
        process_deposit(state, dep, ctx, cfg)
    for ex in body.voluntary_exits:
        process_voluntary_exit(state, ex, ctx, verify_signatures, cfg)
    if fork_of(state) in ("capella", "deneb"):
        from .capella import process_bls_to_execution_change

        for change in body.bls_to_execution_changes:
            process_bls_to_execution_change(state, change, ctx, verify_signatures, cfg)


def process_block(
    state,
    block,
    ctx: EpochContext,
    verify_signatures: bool = True,
    cfg=None,
    payload_status: str = "valid",
) -> None:
    """Spec process_block, fork-dispatched (reference `block/index.ts:31`).

    Execution-payload processing runs before randao (the payload's
    prev_randao is the mix from the previous block's reveal); capella
    adds withdrawals ahead of the payload; deneb checks blob KZG
    commitment consistency last."""
    fork = fork_of(state)
    process_block_header(state, block, ctx)
    if fork in ("bellatrix", "capella", "deneb"):
        from .bellatrix import is_execution_enabled, process_execution_payload

        body = block.body
        payload = (
            body.execution_payload_header
            if hasattr(body, "execution_payload_header")
            else body.execution_payload
        )
        if is_execution_enabled(state, body, ctx.p):
            if fork in ("capella", "deneb"):
                from .capella import process_withdrawals

                process_withdrawals(state, payload, ctx)
            process_execution_payload(state, payload, ctx, cfg, payload_status)
    process_randao(state, block.body, ctx, verify_signatures)
    process_eth1_data(state, block.body, ctx)
    process_operations(state, block.body, ctx, verify_signatures, cfg)
    if fork != "phase0":
        from .altair import process_sync_aggregate

        process_sync_aggregate(state, block.body.sync_aggregate, ctx, verify_signatures)
    if fork == "deneb" and not hasattr(block.body, "execution_payload_header"):
        from .deneb import process_blob_kzg_commitments

        process_blob_kzg_commitments(block.body)
