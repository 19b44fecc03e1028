"""Epoch caches: shufflings, committees, proposers, balances.

Reference `state-transition/src/cache/epochContext.ts:80` — the per-epoch
precomputation that makes attestation processing O(1) per lookup:
committee slices out of one unshuffled permutation, proposer per slot,
effective balances as a flat array (`effectiveBalanceIncrements`).

The port of `lodestar_tpu.state_transition.cache` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

import numpy as np

from lodestar_tpu_torch.params import (
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    BeaconPreset,
    active_preset,
)

from .shuffle import compute_proposer_index, unshuffle_list
from .util import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    effective_balances_array,
    get_active_validator_indices,
    get_current_epoch,
    get_previous_epoch,
    get_seed,
    uint_to_bytes,
)

__all__ = ["EpochShuffling", "EpochContext"]


class EpochShuffling:
    """Committees for one epoch: the unshuffled active-index permutation
    sliced per (slot, committee index)."""

    def __init__(self, state, epoch: int, p: BeaconPreset):
        self.epoch = epoch
        self.active_indices = get_active_validator_indices(state, epoch)
        seed = get_seed(state, epoch, DOMAIN_BEACON_ATTESTER, p)
        shuffled = unshuffle_list(self.active_indices, seed, p)
        n = len(self.active_indices)
        self.committees_per_slot = max(
            1,
            min(
                p.MAX_COMMITTEES_PER_SLOT,
                n // p.SLOTS_PER_EPOCH // p.TARGET_COMMITTEE_SIZE,
            ),
        )
        count = self.committees_per_slot * p.SLOTS_PER_EPOCH
        # committees[slot_in_epoch][committee_index] -> np array of validator indices
        self.committees: list[list[np.ndarray]] = []
        for slot_i in range(p.SLOTS_PER_EPOCH):
            row = []
            for c in range(self.committees_per_slot):
                i = slot_i * self.committees_per_slot + c
                start = n * i // count
                end = n * (i + 1) // count
                row.append(shuffled[start:end])
            self.committees.append(row)


class EpochContext:
    """Per-state epoch context (subset of reference EpochContext: the
    pieces the STF + gossip validation consume; pubkey caches live with
    the chain layer)."""

    def __init__(self, state, p: BeaconPreset | None = None):
        self.p = p = p or active_preset()
        self.current_epoch = get_current_epoch(state)
        self.previous_epoch = get_previous_epoch(state)
        self.effective_balances = effective_balances_array(state)
        self.current_shuffling = EpochShuffling(state, self.current_epoch, p)
        if self.previous_epoch == self.current_epoch:
            self.previous_shuffling = self.current_shuffling
        else:
            self.previous_shuffling = EpochShuffling(state, self.previous_epoch, p)
        self.total_active_balance = max(
            p.EFFECTIVE_BALANCE_INCREMENT,
            int(self.effective_balances[self.current_shuffling.active_indices].sum())
            if len(self.current_shuffling.active_indices)
            else 0,
        )
        # proposers for every slot of the current epoch
        ep_seed = get_seed(state, self.current_epoch, DOMAIN_BEACON_PROPOSER, p)
        start = compute_start_slot_at_epoch(self.current_epoch, p)
        self.proposers = [
            compute_proposer_index(
                self.effective_balances,
                self.current_shuffling.active_indices,
                hashlib.sha256(ep_seed + uint_to_bytes(slot)).digest(),
                p,
            )
            for slot in range(start, start + p.SLOTS_PER_EPOCH)
        ]

    # -- lookups --------------------------------------------------------------

    def _shuffling_at(self, epoch: int) -> EpochShuffling:
        if epoch == self.current_epoch:
            return self.current_shuffling
        if epoch == self.previous_epoch:
            return self.previous_shuffling
        raise ValueError(f"no shuffling cached for epoch {epoch}")

    def get_committee_count_per_slot(self, epoch: int) -> int:
        return self._shuffling_at(epoch).committees_per_slot

    def get_beacon_committee(self, slot: int, index: int) -> np.ndarray:
        epoch = compute_epoch_at_slot(slot, self.p)
        sh = self._shuffling_at(epoch)
        if index >= sh.committees_per_slot:
            raise ValueError(f"committee index {index} out of range")
        return sh.committees[slot % self.p.SLOTS_PER_EPOCH][index]

    def get_beacon_proposer(self, slot: int) -> int:
        if compute_epoch_at_slot(slot, self.p) != self.current_epoch:
            raise ValueError("proposer cache only covers the current epoch")
        return self.proposers[slot % self.p.SLOTS_PER_EPOCH]

    def pubkey_to_index(self, state) -> dict[bytes, int]:
        """Registry pubkey -> validator index (reference EpochContext
        pubkey2index, `cache/pubkeyCache.ts`). Built once per context and
        extended for registry appends."""
        cached = getattr(self, "_pubkey_to_index", None)
        if cached is None or len(cached) < len(state.validators):
            start = 0 if cached is None else len(cached)
            if cached is None:
                cached = {}
                self._pubkey_to_index = cached
            for i in range(start, len(state.validators)):
                cached[bytes(state.validators[i].pubkey)] = i
        return cached

    def get_attesting_indices(self, att_data, aggregation_bits) -> np.ndarray:
        committee = self.get_beacon_committee(att_data.slot, att_data.index)
        if len(aggregation_bits) != len(committee):
            raise ValueError("aggregation bits length != committee size")
        mask = np.asarray(aggregation_bits, dtype=bool)
        return committee[mask]
