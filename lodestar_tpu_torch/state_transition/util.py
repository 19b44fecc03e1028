"""Spec helper functions over the typed BeaconState
(reference `state-transition/src/util/`; written from the phase0
consensus spec — epoch math, predicates, balances, seeds, domains).

Array-returning helpers hand back numpy so the epoch-processing layer can
stay vectorized (the numpy translation of the reference's
Uint8Array effective-balance caches, `cache/effectiveBalanceIncrements`).

The port of `lodestar_tpu.state_transition.util` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

import numpy as np

from lodestar_tpu_torch.config import compute_domain as _compute_domain
from lodestar_tpu_torch.config import compute_signing_root  # noqa: F401 (re-export)
from lodestar_tpu_torch.params import (
    BeaconPreset,
    DOMAIN_BEACON_PROPOSER,
    FAR_FUTURE_EPOCH,
    GENESIS_EPOCH,
    active_preset,
)

__all__ = [
    "compute_epoch_at_slot",
    "compute_start_slot_at_epoch",
    "compute_activation_exit_epoch",
    "get_current_epoch",
    "get_previous_epoch",
    "is_active_validator",
    "is_slashable_validator",
    "is_eligible_for_activation_queue",
    "is_eligible_for_activation",
    "get_active_validator_indices",
    "get_validator_churn_limit",
    "get_randao_mix",
    "get_seed",
    "get_block_root",
    "get_block_root_at_slot",
    "get_total_balance",
    "get_total_active_balance",
    "get_domain",
    "compute_signing_root",
    "increase_balance",
    "decrease_balance",
    "integer_squareroot",
    "effective_balances_array",
    "uint_to_bytes",
]


def uint_to_bytes(n: int, length: int = 8) -> bytes:
    return int(n).to_bytes(length, "little")


def integer_squareroot(n: int) -> int:
    return int(np.sqrt(np.float64(n))) if n < 2**52 else _isqrt_big(n)


def _isqrt_big(n: int) -> int:
    x = n
    y = (x + 1) // 2
    while y < x:
        x = y
        y = (x + n // x) // 2
    return x


# -- epoch / slot math --------------------------------------------------------


def compute_epoch_at_slot(slot: int, p: BeaconPreset | None = None) -> int:
    p = p or active_preset()
    return slot // p.SLOTS_PER_EPOCH


def compute_start_slot_at_epoch(epoch: int, p: BeaconPreset | None = None) -> int:
    p = p or active_preset()
    return epoch * p.SLOTS_PER_EPOCH


def compute_activation_exit_epoch(epoch: int, p: BeaconPreset | None = None) -> int:
    p = p or active_preset()
    return epoch + 1 + p.MAX_SEED_LOOKAHEAD


def get_current_epoch(state) -> int:
    return compute_epoch_at_slot(state.slot)


def get_previous_epoch(state) -> int:
    cur = get_current_epoch(state)
    return GENESIS_EPOCH if cur == GENESIS_EPOCH else cur - 1


# -- validator predicates -----------------------------------------------------


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


def is_slashable_validator(v, epoch: int) -> bool:
    return (not v.slashed) and v.activation_epoch <= epoch < v.withdrawable_epoch


def is_eligible_for_activation_queue(v, p: BeaconPreset | None = None) -> bool:
    p = p or active_preset()
    return (
        v.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and v.effective_balance == p.MAX_EFFECTIVE_BALANCE
    )


def is_eligible_for_activation(state, v) -> bool:
    return (
        v.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and v.activation_epoch == FAR_FUTURE_EPOCH
    )


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    act = np.fromiter((v.activation_epoch for v in state.validators), dtype=np.int64)
    ext = np.fromiter((v.exit_epoch for v in state.validators), dtype=np.uint64).astype(
        np.float64
    )  # FAR_FUTURE_EPOCH overflows int64; float64 compares fine
    return np.nonzero((act <= epoch) & (epoch < ext))[0]


def get_validator_churn_limit(state, p: BeaconPreset | None = None, cfg=None) -> int:
    p = p or active_preset()
    quotient = cfg.CHURN_LIMIT_QUOTIENT if cfg is not None else 65536
    min_churn = cfg.MIN_PER_EPOCH_CHURN_LIMIT if cfg is not None else 4
    n_active = len(get_active_validator_indices(state, get_current_epoch(state)))
    return max(min_churn, n_active // quotient)


# -- randomness ---------------------------------------------------------------


def get_randao_mix(state, epoch: int, p: BeaconPreset | None = None) -> bytes:
    p = p or active_preset()
    return state.randao_mixes[epoch % p.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(state, epoch: int, domain_type: bytes, p: BeaconPreset | None = None) -> bytes:
    p = p or active_preset()
    mix = get_randao_mix(state, epoch + p.EPOCHS_PER_HISTORICAL_VECTOR - p.MIN_SEED_LOOKAHEAD - 1, p)
    return hashlib.sha256(domain_type + uint_to_bytes(epoch) + mix).digest()


# -- roots --------------------------------------------------------------------


def get_block_root_at_slot(state, slot: int, p: BeaconPreset | None = None) -> bytes:
    p = p or active_preset()
    if not (slot < state.slot <= slot + p.SLOTS_PER_HISTORICAL_ROOT):
        raise ValueError(f"slot {slot} out of block_roots range at state slot {state.slot}")
    return state.block_roots[slot % p.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(state, epoch: int, p: BeaconPreset | None = None) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch, p), p)


# -- balances -----------------------------------------------------------------


def effective_balances_array(state) -> np.ndarray:
    return np.fromiter((v.effective_balance for v in state.validators), dtype=np.int64)


def get_total_balance(state, indices, p: BeaconPreset | None = None) -> int:
    p = p or active_preset()
    eb = effective_balances_array(state)
    total = int(eb[np.asarray(list(indices), dtype=np.int64)].sum()) if len(indices) else 0
    return max(p.EFFECTIVE_BALANCE_INCREMENT, total)


def get_total_active_balance(state, p: BeaconPreset | None = None) -> int:
    return get_total_balance(state, get_active_validator_indices(state, get_current_epoch(state)), p)


def increase_balance(state, index: int, delta: int) -> None:
    state.balances[index] += delta


def decrease_balance(state, index: int, delta: int) -> None:
    state.balances[index] = max(0, state.balances[index] - delta)


# -- domains ------------------------------------------------------------------


def get_domain(state, domain_type: bytes, epoch: int | None = None) -> bytes:
    """Spec get_domain over the state's own fork (reference computes this
    through BeaconConfig caches; the state-local variant is what the spec
    STF uses)."""
    epoch = get_current_epoch(state) if epoch is None else epoch
    fork = state.fork
    version = fork.previous_version if epoch < fork.epoch else fork.current_version
    return _compute_domain(domain_type, version, state.genesis_validators_root)


# re-export for producers
DOMAIN_PROPOSER = DOMAIN_BEACON_PROPOSER
