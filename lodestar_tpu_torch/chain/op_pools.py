"""Operation pools + seen caches.

Reference `beacon-node/src/chain/opPools/` + `chain/seenCache/`:

* `AttestationPool` — naive aggregation: single-signature gossip
  attestations OR-merged per AttestationData root
  (`attestationPool.ts:58`), SLOTS_RETAINED window, per-slot cap.
* `AggregatedAttestationPool` — aggregates grouped for block inclusion
  with greedy not-yet-seen scoring (`aggregatedAttestationPool.ts:54,110`).
* `OpPool` — exits / proposer slashings / attester slashings / bls
  changes keyed for dedup + block packing (`opPool.ts`).
* Seen caches — first-seen dedup per epoch: attesters, aggregators
  (`seenCache/seenAttesters.ts`).

The port of `lodestar_tpu.chain.op_pools` (host Python and numpy, as there).
"""

from __future__ import annotations

import enum
from collections import defaultdict

import numpy as np

from lodestar_tpu_torch.crypto.bls.api import aggregate_signatures
from lodestar_tpu_torch.types import ssz_types

__all__ = [
    "InsertOutcome",
    "AttestationPool",
    "AggregatedAttestationPool",
    "OpPool",
    "SeenAttesters",
    "SeenAggregators",
]

SLOTS_RETAINED = 3
MAX_ATTESTATIONS_PER_SLOT = 16_384


class InsertOutcome(enum.Enum):
    NEW_DATA = "NewData"
    AGGREGATED = "Aggregated"
    ALREADY_KNOWN = "AlreadyKnown"
    OLD = "Old"
    REACHED_MAX_PER_SLOT = "ReachedMaxPerSlot"
    NOT_BETTER_THAN = "NotBetterThan"


class OpPoolError(Exception):
    pass


class AttestationPool:
    """Naive aggregation pool for single-signature gossip attestations."""

    def __init__(self) -> None:
        # slot -> data_root -> {bits: list[bool], data, sigs: list[bytes]}
        self._by_slot: dict[int, dict[bytes, dict]] = defaultdict(dict)
        self._lowest_permissible_slot = 0

    def add(self, attestation, att_data_root: bytes) -> InsertOutcome:
        slot = attestation.data.slot
        if slot < self._lowest_permissible_slot:
            return InsertOutcome.OLD
        by_root = self._by_slot[slot]
        if len(by_root) >= MAX_ATTESTATIONS_PER_SLOT:
            raise OpPoolError("reached max attestations per slot")

        bits = list(attestation.aggregation_bits)
        entry = by_root.get(att_data_root)
        if entry is None:
            by_root[att_data_root] = {
                "bits": bits,
                "data": attestation.data,
                "sigs": [bytes(attestation.signature)],
            }
            return InsertOutcome.NEW_DATA
        if len(entry["bits"]) != len(bits):
            raise OpPoolError("aggregation bits length mismatch")
        new_idx = [i for i, b in enumerate(bits) if b]
        if all(entry["bits"][i] for i in new_idx):
            return InsertOutcome.ALREADY_KNOWN
        if any(entry["bits"][i] for i in new_idx):
            # overlapping multi-bit merge unsupported in the naive pool
            # (gossip attestations carry exactly one bit)
            return InsertOutcome.ALREADY_KNOWN
        for i in new_idx:
            entry["bits"][i] = True
        entry["sigs"].append(bytes(attestation.signature))
        return InsertOutcome.AGGREGATED

    def get_aggregate(self, slot: int, att_data_root: bytes):
        entry = self._by_slot.get(slot, {}).get(att_data_root)
        if entry is None:
            return None
        t = ssz_types()
        att = t.Attestation.default()
        att.aggregation_bits = list(entry["bits"])
        att.data = entry["data"]
        att.signature = aggregate_signatures(entry["sigs"])
        return att

    def prune(self, clock_slot: int) -> None:
        self._lowest_permissible_slot = max(0, clock_slot - SLOTS_RETAINED)
        for slot in [s for s in self._by_slot if s < self._lowest_permissible_slot]:
            del self._by_slot[slot]

    def attestation_count(self) -> int:
        return sum(len(m) for m in self._by_slot.values())


class AggregatedAttestationPool:
    """Aggregates ready for block inclusion, greedily packed by
    not-yet-on-chain attester count (reference
    `aggregatedAttestationPool.ts:110` getAttestationsForBlock)."""

    def __init__(self) -> None:
        # slot -> data_root -> list of {bits, attestation}
        self._by_slot: dict[int, dict[bytes, list]] = defaultdict(lambda: defaultdict(list))
        self._lowest_permissible_slot = 0

    def add(self, attestation, att_data_root: bytes) -> InsertOutcome:
        slot = attestation.data.slot
        if slot < self._lowest_permissible_slot:
            return InsertOutcome.OLD
        group = self._by_slot[slot][att_data_root]
        bits = np.asarray(list(attestation.aggregation_bits), dtype=bool)
        for existing in group:
            if existing["bits"].shape == bits.shape and bool(np.all(existing["bits"] >= bits)):
                return InsertOutcome.ALREADY_KNOWN
        group.append({"bits": bits, "attestation": attestation})
        # keep the densest few per data (reference keeps MAX_RETAINED... trims)
        group.sort(key=lambda e: int(e["bits"].sum()), reverse=True)
        del group[4:]
        return InsertOutcome.NEW_DATA

    @staticmethod
    def _on_chain_bits(state) -> dict[bytes, np.ndarray]:
        """Union of aggregation bits already on chain, per AttestationData
        root (from the state's pending attestations — phase0's record of
        included votes)."""
        from lodestar_tpu_torch.types import ssz_types

        t = ssz_types()
        seen: dict[bytes, np.ndarray] = {}
        for pending in list(state.previous_epoch_attestations) + list(
            state.current_epoch_attestations
        ):
            root = t.AttestationData.hash_tree_root(pending.data)
            bits = np.asarray(list(pending.aggregation_bits), dtype=bool)
            prev = seen.get(root)
            seen[root] = bits if prev is None else (prev | bits)
        return seen

    def get_attestations_for_block(
        self, state, p, max_attestations: int | None = None, ctx=None
    ) -> list:
        """Greedy selection of includable aggregates for a block built on
        `state` (already advanced to the block slot), scored by how many
        NEW attesters each contributes over what the state has on chain.
        phase0 reads pending attestations; altair+ reads the TIMELY_TARGET
        participation flags through the committee (reference
        `aggregatedAttestationPool.ts:110` getNotSeenValidatorsFn)."""
        max_attestations = max_attestations or p.MAX_ATTESTATIONS
        is_phase0 = hasattr(state, "previous_epoch_attestations")
        on_chain = self._on_chain_bits(state) if is_phase0 else None
        if not is_phase0 and ctx is None:
            from lodestar_tpu_torch.state_transition import EpochContext

            ctx = EpochContext(state, p)
        state_slot = state.slot
        scored = []
        for slot in sorted(self._by_slot, reverse=True):
            if not (slot + p.MIN_ATTESTATION_INCLUSION_DELAY <= state_slot <= slot + p.SLOTS_PER_EPOCH):
                continue
            for root, group in self._by_slot[slot].items():
                chain_bits = on_chain.get(root) if on_chain is not None else None
                for entry in group:
                    bits = entry["bits"]
                    if is_phase0:
                        fresh = (
                            int(bits.sum())
                            if chain_bits is None or chain_bits.shape != bits.shape
                            else int((bits & ~chain_bits).sum())
                        )
                    else:
                        fresh = self._fresh_count_altair(
                            state, ctx, entry["attestation"], bits, p
                        )
                    if fresh > 0:
                        scored.append((fresh, slot, entry["attestation"]))
        scored.sort(key=lambda x: (x[0], x[1]), reverse=True)
        return [att for _, _, att in scored[:max_attestations]]

    @staticmethod
    def _fresh_count_altair(state, ctx, attestation, bits: np.ndarray, p) -> int:
        """Attesters in `bits` whose TIMELY_TARGET flag is not yet set in
        the state's participation for the attestation's epoch."""
        data = attestation.data
        cur_epoch = state.slot // p.SLOTS_PER_EPOCH
        if data.target.epoch == cur_epoch:
            flags = state.current_epoch_participation
        elif data.target.epoch == cur_epoch - 1:
            flags = state.previous_epoch_participation
        else:
            return 0
        try:
            committee = ctx.get_beacon_committee(data.slot, data.index)
        except ValueError:
            return 0
        if len(committee) != bits.shape[0]:
            return 0
        from lodestar_tpu_torch.params import TIMELY_TARGET_FLAG_INDEX

        timely_target = 1 << TIMELY_TARGET_FLAG_INDEX
        return sum(
            1
            for i, b in enumerate(bits)
            if b and not (int(flags[int(committee[i])]) & timely_target)
        )

    def prune(self, clock_slot: int) -> None:
        self._lowest_permissible_slot = max(0, clock_slot - SLOTS_RETAINED)
        for slot in [s for s in self._by_slot if s < self._lowest_permissible_slot]:
            del self._by_slot[slot]


class OpPool:
    """Exits, slashings, bls-to-execution changes (reference `opPool.ts`)."""

    def __init__(self) -> None:
        self._exits: dict[int, object] = {}  # validator index -> SignedVoluntaryExit
        self._proposer_slashings: dict[int, object] = {}
        self._attester_slashings: dict[bytes, object] = {}  # root -> slashing
        self._bls_changes: dict[int, object] = {}

    def insert_voluntary_exit(self, signed_exit) -> None:
        self._exits.setdefault(signed_exit.message.validator_index, signed_exit)

    def has_exit(self, validator_index: int) -> bool:
        return validator_index in self._exits

    def insert_proposer_slashing(self, slashing) -> None:
        self._proposer_slashings.setdefault(
            slashing.signed_header_1.message.proposer_index, slashing
        )

    def insert_attester_slashing(self, slashing, root: bytes) -> None:
        self._attester_slashings.setdefault(root, slashing)

    def insert_bls_to_execution_change(self, change) -> None:
        self._bls_changes.setdefault(change.message.validator_index, change)

    def get_slashings_and_exits(self, state, p) -> tuple[list, list, list]:
        """(attester_slashings, proposer_slashings, exits) packable into a
        block on `state` — filtered to still-slashable/exitable targets."""
        from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH
        from lodestar_tpu_torch.state_transition.util import get_current_epoch, is_slashable_validator

        epoch = get_current_epoch(state)
        n = len(state.validators)
        att_slashings = []
        for s in self._attester_slashings.values():
            common = set(s.attestation_1.attesting_indices) & set(s.attestation_2.attesting_indices)
            if any(
                i < n and is_slashable_validator(state.validators[i], epoch) for i in common
            ):
                att_slashings.append(s)
                if len(att_slashings) >= p.MAX_ATTESTER_SLASHINGS:
                    break
        prop_slashings = [
            s
            for i, s in self._proposer_slashings.items()
            if i < n and is_slashable_validator(state.validators[i], epoch)
        ][: p.MAX_PROPOSER_SLASHINGS]
        exits = [
            e
            for i, e in self._exits.items()
            if i < n and state.validators[i].exit_epoch == FAR_FUTURE_EPOCH
        ][: p.MAX_VOLUNTARY_EXITS]
        return att_slashings, prop_slashings, exits

    def prune_all(self, state) -> None:
        from lodestar_tpu_torch.params import FAR_FUTURE_EPOCH

        n = len(state.validators)
        for i in [i for i in self._exits if i < n and state.validators[i].exit_epoch != FAR_FUTURE_EPOCH]:
            del self._exits[i]
        for i in [i for i in self._proposer_slashings if i < n and state.validators[i].slashed]:
            del self._proposer_slashings[i]


class _EpochKeyedSet:
    """First-seen dedup keyed by (epoch, index) with pruning below the
    finalized epoch (reference `seenCache/seenAttesters.ts`)."""

    def __init__(self) -> None:
        self._by_epoch: dict[int, set[int]] = defaultdict(set)
        self._lowest_permissible_epoch = 0

    def is_known(self, epoch: int, index: int) -> bool:
        return index in self._by_epoch.get(epoch, ())

    def add(self, epoch: int, index: int) -> None:
        if epoch < self._lowest_permissible_epoch:
            raise ValueError(f"epoch {epoch} below pruned horizon")
        self._by_epoch[epoch].add(index)

    def prune(self, finalized_epoch: int) -> None:
        self._lowest_permissible_epoch = finalized_epoch
        for e in [e for e in self._by_epoch if e < finalized_epoch]:
            del self._by_epoch[e]


class SeenAttesters(_EpochKeyedSet):
    pass


class SeenAggregators(_EpochKeyedSet):
    pass
