"""Capella state transition: withdrawals + BLS-to-execution changes.

Reference: `packages/state-transition/src/block/processWithdrawals.ts`,
`processBlsToExecutionChange.ts`,
`epoch/processHistoricalSummariesUpdate.ts`,
`slot/upgradeStateToCapella.ts`. The withdrawals sweep is vectorized
over the bounded validator window rather than the reference's per-index
loop — same outcome, numpy-first.

The port of `lodestar_tpu.state_transition.capella` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

from lodestar_tpu_torch.config import compute_domain, compute_signing_root
from lodestar_tpu_torch.params import (
    BLS_WITHDRAWAL_PREFIX,
    DOMAIN_BLS_TO_EXECUTION_CHANGE,
    ETH1_ADDRESS_WITHDRAWAL_PREFIX,
    BeaconPreset,
)
from lodestar_tpu_torch.types import ssz_types

from .block import BlockProcessError
from .util import decrease_balance, get_current_epoch

__all__ = [
    "has_eth1_withdrawal_credential",
    "get_expected_withdrawals",
    "process_withdrawals",
    "process_bls_to_execution_change",
    "process_historical_summaries_update",
    "upgrade_to_capella",
]


def has_eth1_withdrawal_credential(withdrawal_credentials: bytes) -> bool:
    return withdrawal_credentials[0] == ETH1_ADDRESS_WITHDRAWAL_PREFIX


def get_expected_withdrawals(state, ctx) -> list:
    """Bounded sweep from next_withdrawal_validator_index: full
    withdrawals for withdrawable validators, partial above
    MAX_EFFECTIVE_BALANCE (reference getExpectedWithdrawals,
    processWithdrawals.ts:69)."""
    p = ctx.p
    t = ssz_types(p)
    epoch = get_current_epoch(state)
    withdrawal_index = int(state.next_withdrawal_index)
    n_vals = len(state.validators)
    bound = min(n_vals, p.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP)
    start = int(state.next_withdrawal_validator_index)

    withdrawals = []
    for n in range(bound):
        vi = (start + n) % n_vals
        v = state.validators[vi]
        creds = bytes(v.withdrawal_credentials)
        if not has_eth1_withdrawal_credential(creds):
            continue
        balance = int(state.balances[vi])
        amount = None
        if balance > 0 and int(v.withdrawable_epoch) <= epoch:
            amount = balance
        elif int(v.effective_balance) == p.MAX_EFFECTIVE_BALANCE and balance > p.MAX_EFFECTIVE_BALANCE:
            amount = balance - p.MAX_EFFECTIVE_BALANCE
        if amount is not None:
            w = t.Withdrawal.default()
            w.index = withdrawal_index
            w.validator_index = vi
            w.address = creds[12:]
            w.amount = amount
            withdrawals.append(w)
            withdrawal_index += 1
        if len(withdrawals) >= p.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
    return withdrawals


def process_withdrawals(state, payload, ctx) -> None:
    """Spec process_withdrawals; accepts a full payload (withdrawal list
    compared elementwise) or a blinded header (withdrawals_root
    compared) — reference processWithdrawals.ts:12-40."""
    from lodestar_tpu_torch import ssz

    p = ctx.p
    t = ssz_types(p)
    expected = get_expected_withdrawals(state, ctx)
    wd_list_type = ssz.List(t.Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)

    if hasattr(payload, "withdrawals_root"):
        expected_root = wd_list_type.hash_tree_root(expected)
        if expected_root != bytes(payload.withdrawals_root):
            raise BlockProcessError("withdrawals_root mismatch in blinded payload header")
    else:
        actual = list(payload.withdrawals)
        if len(expected) != len(actual):
            raise BlockProcessError(
                f"withdrawals length mismatch: expected {len(expected)}, got {len(actual)}"
            )
        for i, (e, a) in enumerate(zip(expected, actual)):
            if t.Withdrawal.serialize(e) != t.Withdrawal.serialize(a):
                raise BlockProcessError(f"withdrawal mismatch at index {i}")

    for w in expected:
        decrease_balance(state, int(w.validator_index), int(w.amount))

    if expected:
        state.next_withdrawal_index = int(expected[-1].index) + 1
    n_vals = len(state.validators)
    if len(expected) == p.MAX_WITHDRAWALS_PER_PAYLOAD:
        state.next_withdrawal_validator_index = (int(expected[-1].validator_index) + 1) % n_vals
    else:
        state.next_withdrawal_validator_index = (
            int(state.next_withdrawal_validator_index) + p.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % n_vals


def process_bls_to_execution_change(
    state, signed_change, ctx, verify_signatures: bool = True, cfg=None
) -> None:
    """Spec process_bls_to_execution_change. The signing domain is pinned
    to the genesis fork version regardless of the state's fork
    (reference blsToExecutionChange.ts:16 `signatureFork = phase0`)."""
    p = ctx.p
    change = signed_change.message
    vi = int(change.validator_index)
    if vi >= len(state.validators):
        raise BlockProcessError("bls change: validator index out of range")
    v = state.validators[vi]
    creds = bytes(v.withdrawal_credentials)
    if creds[0] != BLS_WITHDRAWAL_PREFIX:
        raise BlockProcessError("bls change: credentials are not BLS-prefixed")
    digest = bytearray(hashlib.sha256(bytes(change.from_bls_pubkey)).digest())
    digest[0] = BLS_WITHDRAWAL_PREFIX
    if creds != bytes(digest):
        raise BlockProcessError("bls change: from_bls_pubkey does not match credentials")

    if verify_signatures:
        from lodestar_tpu_torch.crypto.bls import api as bls

        t = ssz_types(p)
        genesis_version = (
            cfg.GENESIS_FORK_VERSION if cfg is not None else b"\x00\x00\x00\x00"
        )
        domain = compute_domain(
            DOMAIN_BLS_TO_EXECUTION_CHANGE,
            genesis_version,
            bytes(state.genesis_validators_root),
        )
        root = compute_signing_root(t.BLSToExecutionChange, change, domain)
        if not bls.verify(bytes(change.from_bls_pubkey), root, bytes(signed_change.signature)):
            raise BlockProcessError("bls change: invalid signature")

    new_creds = bytearray(32)
    new_creds[0] = ETH1_ADDRESS_WITHDRAWAL_PREFIX
    new_creds[12:] = bytes(change.to_execution_address)
    v.withdrawal_credentials = bytes(new_creds)


def process_historical_summaries_update(state, p: BeaconPreset) -> None:
    """Capella replacement for process_historical_roots_update: push
    roots-of-roots instead of a HistoricalBatch root (reference
    epoch/processHistoricalSummariesUpdate.ts:12)."""
    from lodestar_tpu_torch import ssz

    next_epoch = get_current_epoch(state) + 1
    if next_epoch % (p.SLOTS_PER_HISTORICAL_ROOT // p.SLOTS_PER_EPOCH) == 0:
        t = ssz_types(p)
        roots_type = ssz.Vector(ssz.ByteVector(32), p.SLOTS_PER_HISTORICAL_ROOT)
        summary = t.HistoricalSummary.default()
        summary.block_summary_root = roots_type.hash_tree_root(list(state.block_roots))
        summary.state_summary_root = roots_type.hash_tree_root(list(state.state_roots))
        state.historical_summaries.append(summary)


# --- fork upgrade -------------------------------------------------------------


def upgrade_to_capella(pre, cfg, p: BeaconPreset):
    """Spec upgrade_to_capella: bellatrix fields carry over; the payload
    header is extended with a zero withdrawals_root; withdrawal sweep
    counters start at 0 (reference `slot/upgradeStateToCapella.ts`)."""
    from .bellatrix import carry_state_upgrade

    post = carry_state_upgrade(
        pre,
        cfg,
        p,
        src_fork="bellatrix",
        dst_fork="capella",
        fallback_version=b"\x03\x00\x00\x00",
        carry_header=True,  # withdrawals_root stays zero
    )
    post.next_withdrawal_index = 0
    post.next_withdrawal_validator_index = 0
    return post
