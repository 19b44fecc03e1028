"""Altair state transition: participation flags, sync committees,
inactivity scores, and the fork upgrade.

Reference `state-transition/src/block/processAttestationsAltair.ts`,
`processSyncCommittee.ts`, `epoch/processInactivityUpdates.ts`,
`getRewardsAndPenalties.ts`, `processParticipationFlagUpdates.ts`,
`processSyncCommitteeUpdates.ts`, `slot/upgradeStateToAltair.ts` —
written from the altair consensus spec with the same numpy-vectorized
shape as the phase0 epoch machinery (`epoch.py`).

The port of `lodestar_tpu.state_transition.altair` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

import numpy as np

from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_SYNC_COMMITTEE,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    BeaconPreset,
)
from lodestar_tpu_torch.types import ssz_types

from .cache import EpochContext
from .util import (
    compute_epoch_at_slot,
    compute_signing_root,
    decrease_balance,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_domain,
    get_previous_epoch,
    get_randao_mix,
    get_seed,
    increase_balance,
    integer_squareroot,
    uint_to_bytes,
)

__all__ = [
    "TIMELY_SOURCE_FLAG_INDEX",
    "TIMELY_TARGET_FLAG_INDEX",
    "TIMELY_HEAD_FLAG_INDEX",
    "PARTICIPATION_FLAG_WEIGHTS",
    "get_attestation_participation_flag_indices",
    "process_attestation_altair",
    "process_sync_aggregate",
    "get_next_sync_committee",
    "process_inactivity_updates",
    "process_justification_and_finalization_altair",
    "process_rewards_and_penalties_altair",
    "process_participation_flag_updates",
    "process_sync_committee_updates",
    "process_epoch_altair",
    "upgrade_to_altair",
    "AltairEpochStatus",
]

# spec incentivization weights
TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2
TIMELY_SOURCE_WEIGHT = 14
TIMELY_TARGET_WEIGHT = 26
TIMELY_HEAD_WEIGHT = 14
SYNC_REWARD_WEIGHT = 2
PROPOSER_WEIGHT = 8
WEIGHT_DENOMINATOR = 64
PARTICIPATION_FLAG_WEIGHTS = (TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT)
INACTIVITY_SCORE_BIAS = 4
INACTIVITY_SCORE_RECOVERY_RATE = 16


class BlockProcessError(Exception):
    pass


def _base_reward_per_increment(total_active_balance: int, p: BeaconPreset) -> int:
    return (
        p.EFFECTIVE_BALANCE_INCREMENT
        * p.BASE_REWARD_FACTOR
        // integer_squareroot(total_active_balance)
    )


def _base_reward(state, index: int, total_active: int, p: BeaconPreset) -> int:
    increments = state.validators[index].effective_balance // p.EFFECTIVE_BALANCE_INCREMENT
    return increments * _base_reward_per_increment(total_active, p)


# --- attestations -------------------------------------------------------------


def get_attestation_participation_flag_indices(state, data, inclusion_delay: int, p: BeaconPreset):
    """Spec get_attestation_participation_flag_indices."""
    from .block import BlockProcessError as BPE

    if data.target.epoch == get_current_epoch(state):
        justified = state.current_justified_checkpoint
    else:
        justified = state.previous_justified_checkpoint
    is_matching_source = (
        data.source.epoch == justified.epoch
        and bytes(data.source.root) == bytes(justified.root)
    )
    if not is_matching_source:
        raise BPE("attestation: source does not match justified checkpoint")
    try:
        is_matching_target = is_matching_source and bytes(data.target.root) == get_block_root(
            state, data.target.epoch, p
        )
    except ValueError:
        is_matching_target = False
    try:
        is_matching_head = is_matching_target and bytes(
            data.beacon_block_root
        ) == get_block_root_at_slot(state, data.slot, p)
    except ValueError:
        is_matching_head = False

    flags = []
    if is_matching_source and inclusion_delay <= integer_squareroot(p.SLOTS_PER_EPOCH):
        flags.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= p.SLOTS_PER_EPOCH:
        flags.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == p.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(TIMELY_HEAD_FLAG_INDEX)
    return flags


def process_attestation_altair(state, attestation, ctx: EpochContext, verify_signatures: bool = True) -> None:
    """Altair process_attestation: flag updates + proposer micro-reward."""
    from .block import BlockProcessError as BPE
    from .block import get_indexed_attestation, is_valid_indexed_attestation

    p = ctx.p
    data = attestation.data
    current_epoch = get_current_epoch(state)
    previous_epoch = get_previous_epoch(state)
    if data.target.epoch not in (previous_epoch, current_epoch):
        raise BPE("attestation: target epoch out of range")
    if data.target.epoch != compute_epoch_at_slot(data.slot, p):
        raise BPE("attestation: target epoch != slot epoch")
    if not (data.slot + p.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot <= data.slot + p.SLOTS_PER_EPOCH):
        raise BPE("attestation: inclusion window")
    if data.index >= ctx.get_committee_count_per_slot(data.target.epoch):
        raise BPE("attestation: committee index out of range")
    committee = ctx.get_beacon_committee(data.slot, data.index)
    if len(attestation.aggregation_bits) != len(committee):
        raise BPE("attestation: bits/committee length mismatch")

    inclusion_delay = state.slot - data.slot
    flag_indices = get_attestation_participation_flag_indices(state, data, inclusion_delay, p)

    if not is_valid_indexed_attestation(
        state, get_indexed_attestation(attestation, ctx), ctx, verify_signatures
    ):
        raise BPE("attestation: invalid indexed attestation")

    if data.target.epoch == current_epoch:
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation

    total_active = ctx.total_active_balance
    proposer_reward_numerator = 0
    attesting = ctx.get_attesting_indices(data, attestation.aggregation_bits)
    for index in attesting:
        index = int(index)
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            has_flag = (epoch_participation[index] >> flag_index) & 1
            if flag_index in flag_indices and not has_flag:
                epoch_participation[index] |= 1 << flag_index
                proposer_reward_numerator += _base_reward(state, index, total_active, p) * weight

    proposer_reward = proposer_reward_numerator // (
        WEIGHT_DENOMINATOR * (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) // PROPOSER_WEIGHT
    )
    increase_balance(state, ctx.get_beacon_proposer(state.slot), proposer_reward)


# --- sync aggregate -----------------------------------------------------------


def process_sync_aggregate(state, sync_aggregate, ctx: EpochContext, verify_signatures: bool = True) -> None:
    """Spec process_sync_aggregate: verify previous-slot signature and
    apply participant/proposer rewards."""
    from .block import BlockProcessError as BPE

    p = ctx.p
    committee_pubkeys = [bytes(pk) for pk in state.current_sync_committee.pubkeys]
    bits = list(sync_aggregate.sync_committee_bits)
    participant_pubkeys = [pk for pk, bit in zip(committee_pubkeys, bits) if bit]

    if verify_signatures:
        previous_slot = max(state.slot, 1) - 1
        domain = get_domain(
            state, DOMAIN_SYNC_COMMITTEE, compute_epoch_at_slot(previous_slot, p)
        )
        root = get_block_root_at_slot(state, previous_slot, p)
        signing_root = hashlib.sha256(root + domain).digest()
        if not bls.eth_fast_aggregate_verify(
            participant_pubkeys, signing_root, bytes(sync_aggregate.sync_committee_signature)
        ):
            raise BPE("invalid sync aggregate signature")

    # rewards
    total_active = ctx.total_active_balance
    total_base_rewards = _base_reward_per_increment(total_active, p) * (
        total_active // p.EFFECTIVE_BALANCE_INCREMENT
    )
    max_participant_rewards = (
        total_base_rewards * SYNC_REWARD_WEIGHT // WEIGHT_DENOMINATOR // p.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // p.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT)
    )

    pubkey_to_index = ctx.pubkey_to_index(state)
    proposer_index = ctx.get_beacon_proposer(state.slot)
    for pk, bit in zip(committee_pubkeys, bits):
        vi = pubkey_to_index[pk]
        if bit:
            increase_balance(state, vi, participant_reward)
            increase_balance(state, proposer_index, proposer_reward)
        else:
            decrease_balance(state, vi, participant_reward)


# --- sync committee selection -------------------------------------------------


def get_next_sync_committee(state, p: BeaconPreset):
    """Spec get_next_sync_committee_indices + aggregate (effective-balance
    rejection sampling over the shuffled active set)."""
    from .shuffle import compute_shuffled_index
    from .util import get_active_validator_indices

    t = ssz_types(p)
    epoch = get_current_epoch(state) + 1
    active = get_active_validator_indices(state, epoch)
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE, p)
    indices = []
    i = 0
    n = len(active)
    while len(indices) < p.SYNC_COMMITTEE_SIZE:
        shuffled = compute_shuffled_index(i % n, n, seed, p)
        candidate = int(active[shuffled])
        rand = hashlib.sha256(seed + uint_to_bytes(i // 32)).digest()[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * 255 >= p.MAX_EFFECTIVE_BALANCE * rand:
            indices.append(candidate)
        i += 1
    pubkeys = [bytes(state.validators[i].pubkey) for i in indices]
    committee = t.SyncCommittee.default()
    committee.pubkeys = pubkeys
    committee.aggregate_pubkey = bls.aggregate_pubkeys(pubkeys)
    return committee


# --- epoch processing ---------------------------------------------------------


class AltairEpochStatus:
    """Participation masks from the flag arrays (the altair analogue of
    phase0's pending-attestation scan — already flat arrays, pure numpy)."""

    def __init__(self, state, ctx: EpochContext):
        p = ctx.p
        n = len(state.validators)
        self.ctx = ctx
        prev = np.asarray(state.previous_epoch_participation, dtype=np.int64)
        cur = np.asarray(state.current_epoch_participation, dtype=np.int64)
        act = np.fromiter(
            (v.activation_epoch for v in state.validators), dtype=np.uint64
        ).astype(np.float64)  # FAR_FUTURE_EPOCH overflows int64
        ext = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64).astype(np.float64)
        wde = np.fromiter((v.withdrawable_epoch for v in state.validators), dtype=np.uint64).astype(np.float64)
        self.slashed = np.fromiter((v.slashed for v in state.validators), dtype=bool)
        pe, ce = get_previous_epoch(state), get_current_epoch(state)
        self.active_prev = (act <= pe) & (pe < ext)
        self.active_cur = (act <= ce) & (ce < ext)
        self.withdrawable_epochs = wde
        self.eb = ctx.effective_balances
        unslashed = ~self.slashed

        self.prev_flags = [
            self.active_prev & unslashed & ((prev >> f) & 1 == 1) for f in range(3)
        ]
        self.cur_target = self.active_cur & unslashed & ((cur >> TIMELY_TARGET_FLAG_INDEX) & 1 == 1)
        inc = p.EFFECTIVE_BALANCE_INCREMENT
        self.flag_balances = [max(inc, int(self.eb[m].sum())) for m in self.prev_flags]
        self.cur_target_balance = max(inc, int(self.eb[self.cur_target].sum()))
        self.total_active_balance = ctx.total_active_balance
        self.eligible = self.active_prev | (
            self.slashed & (pe + 1 < self.withdrawable_epochs)
        )


def process_justification_and_finalization_altair(state, status: AltairEpochStatus) -> None:
    from .epoch import process_justification_and_finalization

    # reuse the phase0 checkpoint machinery with altair balances
    class _EP:
        pass

    ep = _EP()
    ep.ctx = status.ctx
    ep.total_active_balance = status.total_active_balance
    ep.prev_target_balance = status.flag_balances[TIMELY_TARGET_FLAG_INDEX]
    ep.cur_target_balance = status.cur_target_balance
    process_justification_and_finalization(state, ep)


def process_inactivity_updates(state, status: AltairEpochStatus, p: BeaconPreset) -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    scores = np.asarray(state.inactivity_scores, dtype=np.int64)
    not_target = status.eligible & ~status.prev_flags[TIMELY_TARGET_FLAG_INDEX]
    target = status.eligible & status.prev_flags[TIMELY_TARGET_FLAG_INDEX]
    scores = np.where(target, np.maximum(0, scores - 1), scores)
    scores = np.where(not_target, scores + INACTIVITY_SCORE_BIAS, scores)
    finality_delay = get_previous_epoch(state) - state.finalized_checkpoint.epoch
    if finality_delay <= p.MIN_EPOCHS_TO_INACTIVITY_PENALTY:
        scores = np.where(
            status.eligible, np.maximum(0, scores - INACTIVITY_SCORE_RECOVERY_RATE), scores
        )
    state.inactivity_scores = scores.tolist()


def process_rewards_and_penalties_altair(state, status: AltairEpochStatus, p: BeaconPreset) -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    n = len(state.validators)
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)
    total = status.total_active_balance
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    brpi = _base_reward_per_increment(total, p)
    base_rewards = status.eb // inc * brpi

    finality_delay = get_previous_epoch(state) - state.finalized_checkpoint.epoch
    is_leak = finality_delay > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    active_increments = total // inc
    for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
        mask = status.prev_flags[flag_index]
        unslashed_participating_increments = status.flag_balances[flag_index] // inc
        hit = status.eligible & mask
        miss = status.eligible & ~mask
        if not is_leak:
            reward_numerator = base_rewards * weight * unslashed_participating_increments
            rewards[hit] += (reward_numerator // (active_increments * WEIGHT_DENOMINATOR))[hit]
        if flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties[miss] += (base_rewards * weight // WEIGHT_DENOMINATOR)[miss]

    # inactivity penalties (quadratic leak via scores); the quotient
    # tightens at bellatrix (reference getRewardsAndPenaltiesAltair uses
    # fork-selected INACTIVITY_PENALTY_QUOTIENT)
    from .block import fork_of

    scores = np.asarray(state.inactivity_scores, dtype=np.int64)
    not_target = status.eligible & ~status.prev_flags[TIMELY_TARGET_FLAG_INDEX]
    quotient = (
        p.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
        if fork_of(state) == "altair"
        else p.INACTIVITY_PENALTY_QUOTIENT_BELLATRIX
    )
    penalty_denominator = INACTIVITY_SCORE_BIAS * quotient
    penalties[not_target] += (status.eb * scores // penalty_denominator)[not_target]

    balances = np.asarray(state.balances, dtype=np.int64)
    state.balances = np.maximum(0, balances + rewards - penalties).tolist()


def process_slashings_altair(state, status: AltairEpochStatus, p: BeaconPreset) -> None:
    from .block import fork_of

    epoch = get_current_epoch(state)
    total = status.total_active_balance
    multiplier = (
        p.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
        if fork_of(state) == "altair"
        else p.PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX
    )
    adjusted = min(int(sum(state.slashings)) * multiplier, total)
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    target_wd = epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2
    mask = status.slashed & (status.withdrawable_epochs == target_wd)
    for i in np.nonzero(mask)[0]:
        penalty = int(status.eb[i]) // inc * adjusted // total * inc
        decrease_balance(state, int(i), penalty)


def process_participation_flag_updates(state) -> None:
    state.previous_epoch_participation = list(state.current_epoch_participation)
    state.current_epoch_participation = [0] * len(state.validators)


def process_sync_committee_updates(state, p: BeaconPreset) -> None:
    next_epoch = get_current_epoch(state) + 1
    if next_epoch % p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state, p)


def process_epoch_altair(state, ctx: EpochContext | None = None, cfg=None) -> None:
    from .epoch import (
        process_effective_balance_updates,
        process_eth1_data_reset,
        process_historical_roots_update,
        process_randao_mixes_reset,
        process_registry_updates,
        process_slashings_reset,
    )

    from .block import fork_of

    ctx = ctx or EpochContext(state)
    p = ctx.p
    fork = fork_of(state)
    status = AltairEpochStatus(state, ctx)
    process_justification_and_finalization_altair(state, status)
    process_inactivity_updates(state, status, p)
    process_rewards_and_penalties_altair(state, status, p)

    # registry/slashings/final updates reuse the phase0 code (same spec
    # logic); the slashing multiplier tightens at bellatrix and capella
    # replaces historical roots with summaries (reference
    # `epoch/index.ts:45-61`)
    class _EP:
        pass

    ep = _EP()
    ep.ctx = ctx
    ep.active_cur = status.active_cur
    process_registry_updates(state, ep, cfg)
    process_slashings_altair(state, status, p)
    process_eth1_data_reset(state, ep)
    process_effective_balance_updates(state, ep)
    process_slashings_reset(state, ep)
    process_randao_mixes_reset(state, ep)
    if fork in ("capella", "deneb"):
        from .capella import process_historical_summaries_update

        process_historical_summaries_update(state, p)
    else:
        process_historical_roots_update(state, ep)
    process_participation_flag_updates(state)
    process_sync_committee_updates(state, p)


# --- fork upgrade -------------------------------------------------------------


def upgrade_to_altair(pre, cfg, p: BeaconPreset):
    """Spec upgrade_to_altair: carry phase0 fields, zero participation,
    compute the first sync committees (reference
    `slot/upgradeStateToAltair.ts`)."""
    t = ssz_types(p)
    post = t.altair.BeaconState.default()
    for fname, _ in t.phase0.BeaconState.fields:
        if fname in ("previous_epoch_attestations", "current_epoch_attestations"):
            continue
        setattr(post, fname, getattr(pre, fname))
    epoch = get_current_epoch(pre)
    fork = t.Fork.default()
    fork.previous_version = bytes(pre.fork.current_version)
    fork.current_version = cfg.ALTAIR_FORK_VERSION if cfg else b"\x01\x00\x00\x00"
    fork.epoch = epoch
    post.fork = fork
    n = len(post.validators)
    post.previous_epoch_participation = [0] * n
    post.current_epoch_participation = [0] * n
    post.inactivity_scores = [0] * n
    committee = get_next_sync_committee(post, p)
    post.current_sync_committee = committee
    post.next_sync_committee = committee.copy()  # identical inputs => identical committee
    return post
