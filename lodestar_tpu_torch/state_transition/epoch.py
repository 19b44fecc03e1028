"""Phase0 epoch processing, numpy-vectorized.

Reference `state-transition/src/epoch/index.ts:9-24` (14 per-step
functions) + `epoch/getAttestationDeltas.ts`. The reference's
`beforeProcessEpoch` precomputes per-validator status flags into typed
arrays; the numpy translation keeps that shape — every per-validator
loop (rewards/penalties, effective-balance hysteresis, slashings) is a
boolean-mask array expression, not an interpreter loop.

Step order (spec process_epoch, phase0):
  justification_and_finalization → rewards_and_penalties →
  registry_updates → slashings → eth1_data_reset →
  effective_balance_updates → slashings_reset → randao_mixes_reset →
  historical_roots_update → participation_record_updates

The port of `lodestar_tpu.state_transition.epoch` (host Python and numpy, as there).
"""

from __future__ import annotations

import numpy as np

from lodestar_tpu_torch.params import (
    BASE_REWARDS_PER_EPOCH,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    BeaconPreset,
)

from .cache import EpochContext
from .util import (
    compute_activation_exit_epoch,
    decrease_balance,
    get_block_root,
    get_block_root_at_slot,
    get_current_epoch,
    get_previous_epoch,
    get_randao_mix,
    increase_balance,
    integer_squareroot,
    is_active_validator,
    is_eligible_for_activation,
    is_eligible_for_activation_queue,
    uint_to_bytes,
)

__all__ = ["EpochProcess", "before_process_epoch", "process_epoch"]


class EpochProcess:
    """Precomputed per-validator attestation-status masks + totals
    (reference `cache/epochProcess.ts` beforeProcessEpoch)."""

    def __init__(self, state, ctx: EpochContext, cfg=None):
        p = ctx.p
        self.ctx = ctx
        self.cfg = cfg
        n = len(state.validators)
        self.n = n
        cur, prev = ctx.current_epoch, ctx.previous_epoch

        eb = ctx.effective_balances
        self.effective_balances = eb
        act = np.fromiter(
            (v.activation_epoch for v in state.validators), dtype=np.uint64
        ).astype(np.float64)  # FAR_FUTURE_EPOCH overflows int64
        # exit/withdrawable epochs hold FAR_FUTURE_EPOCH (2^64-1): keep as
        # float64 for comparisons
        ext = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64).astype(np.float64)
        wde = np.fromiter((v.withdrawable_epoch for v in state.validators), dtype=np.uint64).astype(np.float64)
        self.slashed = np.fromiter((v.slashed for v in state.validators), dtype=bool)
        self.active_prev = (act <= prev) & (prev < ext)
        self.active_cur = (act <= cur) & (cur < ext)
        self.exit_epochs = ext
        self.withdrawable_epochs = wde

        self.total_active_balance = ctx.total_active_balance

        # attestation status masks from PendingAttestations
        self.prev_source = np.zeros(n, dtype=bool)
        self.prev_target = np.zeros(n, dtype=bool)
        self.prev_head = np.zeros(n, dtype=bool)
        self.cur_source = np.zeros(n, dtype=bool)
        self.cur_target = np.zeros(n, dtype=bool)
        # min inclusion delay + proposer for the earliest inclusion
        self.inclusion_delay = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        self.inclusion_proposer = np.full(n, -1, dtype=np.int64)

        for att in state.previous_epoch_attestations:
            data = att.data
            attesting = ctx.get_attesting_indices(data, att.aggregation_bits)
            self.prev_source[attesting] = True
            try:
                is_target = bytes(data.target.root) == get_block_root(state, prev, p)
            except ValueError:
                is_target = False
            if is_target:
                self.prev_target[attesting] = True
                try:
                    if bytes(data.beacon_block_root) == get_block_root_at_slot(state, data.slot, p):
                        self.prev_head[attesting] = True
                except ValueError:
                    pass
            better = att.inclusion_delay < self.inclusion_delay[attesting]
            upd = attesting[better]
            self.inclusion_delay[upd] = att.inclusion_delay
            self.inclusion_proposer[upd] = att.proposer_index

        for att in state.current_epoch_attestations:
            data = att.data
            attesting = ctx.get_attesting_indices(data, att.aggregation_bits)
            self.cur_source[attesting] = True
            try:
                if bytes(data.target.root) == get_block_root(state, cur, p):
                    self.cur_target[attesting] = True
            except ValueError:
                pass

        unslashed = ~self.slashed
        self.unslashed_prev_source = self.prev_source & unslashed
        self.unslashed_prev_target = self.prev_target & unslashed
        self.unslashed_prev_head = self.prev_head & unslashed
        inc = p.EFFECTIVE_BALANCE_INCREMENT

        def bal(mask):
            return max(inc, int(eb[mask].sum()))

        self.prev_source_balance = bal(self.unslashed_prev_source)
        self.prev_target_balance = bal(self.unslashed_prev_target)
        self.prev_head_balance = bal(self.unslashed_prev_head)
        self.cur_target_balance = bal(self.cur_target & unslashed)


def before_process_epoch(state, ctx: EpochContext, cfg=None) -> EpochProcess:
    return EpochProcess(state, ctx, cfg)


# -- steps --------------------------------------------------------------------


def process_justification_and_finalization(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    current_epoch = get_current_epoch(state)
    if current_epoch <= GENESIS_EPOCH + 1:
        return
    previous_epoch = get_previous_epoch(state)

    old_previous_justified = state.previous_justified_checkpoint
    old_current_justified = state.current_justified_checkpoint

    # update justification
    state.previous_justified_checkpoint = state.current_justified_checkpoint
    bits = list(state.justification_bits)
    bits = [False] + bits[: len(bits) - 1]

    total = ep.total_active_balance
    if ep.prev_target_balance * 3 >= total * 2:
        cp = state.current_justified_checkpoint.type.default()
        cp.epoch = previous_epoch
        cp.root = get_block_root(state, previous_epoch, p)
        state.current_justified_checkpoint = cp
        bits[1] = True
    if ep.cur_target_balance * 3 >= total * 2:
        cp = state.current_justified_checkpoint.type.default()
        cp.epoch = current_epoch
        cp.root = get_block_root(state, current_epoch, p)
        state.current_justified_checkpoint = cp
        bits[0] = True
    state.justification_bits = bits

    # finalization
    # 2nd/3rd/4th most recent epochs justified appropriately
    if all(bits[1:4]) and old_previous_justified.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


def get_attestation_deltas(state, ep: EpochProcess) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized phase0 get_attestation_deltas (reference
    `epoch/getAttestationDeltas.ts`). Returns (rewards, penalties)."""
    p = ep.ctx.p
    n = ep.n
    rewards = np.zeros(n, dtype=np.int64)
    penalties = np.zeros(n, dtype=np.int64)

    total = ep.total_active_balance
    sqrt_total = integer_squareroot(total)
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    eb = ep.effective_balances

    # base reward per validator (vectorized)
    base_rewards = eb // inc * inc * p.BASE_REWARD_FACTOR // sqrt_total // BASE_REWARDS_PER_EPOCH

    prev_epoch = get_previous_epoch(state)
    finality_delay = prev_epoch - state.finalized_checkpoint.epoch
    is_inactivity_leak = finality_delay > p.MIN_EPOCHS_TO_INACTIVITY_PENALTY

    # eligible: active in prev epoch OR (slashed and not yet withdrawable)
    eligible = ep.active_prev | (ep.slashed & (prev_epoch + 1 < ep.withdrawable_epochs))

    for attested, attesting_balance in (
        (ep.unslashed_prev_source, ep.prev_source_balance),
        (ep.unslashed_prev_target, ep.prev_target_balance),
        (ep.unslashed_prev_head, ep.prev_head_balance),
    ):
        hit = eligible & attested
        miss = eligible & ~attested
        if is_inactivity_leak:
            # optimal-participation assumption during leaks
            rewards[hit] += base_rewards[hit]
        else:
            rewards[hit] += (
                base_rewards[hit] * (attesting_balance // inc) // (total // inc)
            )
        penalties[miss] += base_rewards[miss]

    # proposer + inclusion-delay micro-rewards (earliest inclusion)
    included = ep.unslashed_prev_source & (ep.inclusion_proposer >= 0)
    idx = np.nonzero(included)[0]
    proposer_rewards = base_rewards[idx] // p.PROPOSER_REWARD_QUOTIENT
    np.add.at(rewards, ep.inclusion_proposer[idx], proposer_rewards)
    max_attester_rewards = base_rewards[idx] - proposer_rewards
    rewards[idx] += max_attester_rewards // ep.inclusion_delay[idx]

    if is_inactivity_leak:
        penalties[eligible] += BASE_REWARDS_PER_EPOCH * base_rewards[eligible]
        not_target = eligible & ~ep.unslashed_prev_target
        penalties[not_target] += (
            eb[not_target] * finality_delay // p.INACTIVITY_PENALTY_QUOTIENT
        )

    return rewards, penalties


def process_rewards_and_penalties(state, ep: EpochProcess) -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(state, ep)
    balances = np.asarray(state.balances, dtype=np.int64)
    balances = np.maximum(0, balances + rewards - penalties)
    state.balances = balances.tolist()


def process_registry_updates(state, ep: EpochProcess, cfg=None) -> None:
    p = ep.ctx.p
    current_epoch = get_current_epoch(state)
    ejection_balance = cfg.EJECTION_BALANCE if cfg is not None else 16_000_000_000
    churn_quotient = cfg.CHURN_LIMIT_QUOTIENT if cfg is not None else 65536
    min_churn = cfg.MIN_PER_EPOCH_CHURN_LIMIT if cfg is not None else 4

    # eligibility + ejections
    for i, v in enumerate(state.validators):
        if is_eligible_for_activation_queue(v, p):
            v.activation_eligibility_epoch = current_epoch + 1
        if is_active_validator(v, current_epoch) and v.effective_balance <= ejection_balance:
            _initiate_validator_exit(state, i, p, churn_quotient, min_churn)

    # activation queue, FIFO by (eligibility epoch, index), bounded by churn
    queue = sorted(
        (
            (v.activation_eligibility_epoch, i)
            for i, v in enumerate(state.validators)
            if is_eligible_for_activation(state, v)
        ),
    )
    n_active = int(ep.active_cur.sum())
    churn = max(min_churn, n_active // churn_quotient)
    for _, i in queue[:churn]:
        state.validators[i].activation_epoch = compute_activation_exit_epoch(current_epoch, p)


def _initiate_validator_exit(state, index: int, p: BeaconPreset, churn_quotient: int, min_churn: int) -> None:
    v = state.validators[index]
    if v.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [w.exit_epoch for w in state.validators if w.exit_epoch != FAR_FUTURE_EPOCH]
    current_epoch = get_current_epoch(state)
    exit_queue_epoch = max(exit_epochs + [compute_activation_exit_epoch(current_epoch, p)])
    exit_queue_churn = sum(1 for e in exit_epochs if e == exit_queue_epoch)
    n_active = len([1 for w in state.validators if is_active_validator(w, current_epoch)])
    churn = max(min_churn, n_active // churn_quotient)
    if exit_queue_churn >= churn:
        exit_queue_epoch += 1
    v.exit_epoch = exit_queue_epoch
    v.withdrawable_epoch = exit_queue_epoch + p.MIN_VALIDATOR_WITHDRAWABILITY_DELAY


def process_slashings(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    epoch = get_current_epoch(state)
    total = ep.total_active_balance
    slashings_sum = int(sum(state.slashings))
    adjusted = min(slashings_sum * p.PROPORTIONAL_SLASHING_MULTIPLIER, total)
    inc = p.EFFECTIVE_BALANCE_INCREMENT

    target_wd = epoch + p.EPOCHS_PER_SLASHINGS_VECTOR // 2
    mask = ep.slashed & (ep.withdrawable_epochs == target_wd)
    idx = np.nonzero(mask)[0]
    eb = ep.effective_balances[idx]
    penalty = eb // inc * adjusted // total * inc
    for i, pen in zip(idx, penalty):
        decrease_balance(state, int(i), int(pen))


def process_eth1_data_reset(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    next_epoch = get_current_epoch(state) + 1
    if next_epoch % p.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    inc = p.EFFECTIVE_BALANCE_INCREMENT
    hysteresis_increment = inc // p.HYSTERESIS_QUOTIENT
    down = hysteresis_increment * p.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = hysteresis_increment * p.HYSTERESIS_UPWARD_MULTIPLIER
    balances = state.balances
    for i, v in enumerate(state.validators):
        balance = balances[i]
        if balance + down < v.effective_balance or v.effective_balance + up < balance:
            v.effective_balance = min(balance - balance % inc, p.MAX_EFFECTIVE_BALANCE)


def process_slashings_reset(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    next_epoch = get_current_epoch(state) + 1
    state.slashings[next_epoch % p.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    current_epoch = get_current_epoch(state)
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % p.EPOCHS_PER_HISTORICAL_VECTOR] = get_randao_mix(
        state, current_epoch, p
    )


def process_historical_roots_update(state, ep: EpochProcess) -> None:
    p = ep.ctx.p
    from lodestar_tpu_torch.types import ssz_types

    next_epoch = get_current_epoch(state) + 1
    if next_epoch % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        t = ssz_types(p)
        batch = t.HistoricalBatch.default()
        batch.block_roots = list(state.block_roots)
        batch.state_roots = list(state.state_roots)
        state.historical_roots.append(t.HistoricalBatch.hash_tree_root(batch))


def process_participation_record_updates(state, ep: EpochProcess) -> None:
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


def process_epoch(state, ctx: EpochContext | None = None, cfg=None) -> EpochProcess:
    """Full phase0 process_epoch; returns the EpochProcess for metrics/
    callers (reference stateTransition.ts:120 flow)."""
    ctx = ctx or EpochContext(state)
    ep = before_process_epoch(state, ctx, cfg)
    process_justification_and_finalization(state, ep)
    process_rewards_and_penalties(state, ep)
    process_registry_updates(state, ep, cfg)
    process_slashings(state, ep)
    process_eth1_data_reset(state, ep)
    process_effective_balance_updates(state, ep)
    process_slashings_reset(state, ep)
    process_randao_mixes_reset(state, ep)
    process_historical_roots_update(state, ep)
    process_participation_record_updates(state, ep)
    return ep
