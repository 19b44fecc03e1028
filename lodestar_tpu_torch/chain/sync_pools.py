"""Sync-committee message + contribution pools.

Reference `beacon-node/src/chain/opPools/syncCommitteeMessagePool.ts`
(per-(slot, root, subnet) aggregation of gossip messages into
contributions, SLOTS_RETAINED=3) and `syncContributionAndProofPool.ts`
(best contribution per subnet, merged into the block's SyncAggregate,
SLOTS_RETAINED=8, MAX_ITEMS_PER_SLOT=512). Aggregation is plain BLS
signature aggregation through the crypto API; the device batch path
only matters for verification, not aggregation.

The port of `lodestar_tpu.chain.sync_pools` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT, BeaconPreset, active_preset
from lodestar_tpu_torch.types import ssz_types

from .op_pools import InsertOutcome, OpPoolError

__all__ = ["SyncCommitteeMessagePool", "SyncContributionAndProofPool"]

G2_INFINITY = bls.G2_INFINITY

MESSAGE_SLOTS_RETAINED = 3
CONTRIBUTION_SLOTS_RETAINED = 8
MAX_ITEMS_PER_SLOT = 512


class _Aggregate:
    """Mutable (bits, signature, participants) accumulator over one
    subcommittee (reference SyncContributionFast)."""

    __slots__ = ("bits", "signatures", "participants")

    def __init__(self, size: int):
        self.bits = [False] * size
        self.signatures: list[bytes] = []
        self.participants = 0

    def add(self, index_in_subcommittee: int, signature: bytes) -> InsertOutcome:
        if self.bits[index_in_subcommittee]:
            return InsertOutcome.ALREADY_KNOWN
        self.bits[index_in_subcommittee] = True
        self.signatures.append(bytes(signature))
        self.participants += 1
        return InsertOutcome.AGGREGATED

    def signature(self) -> bytes:
        if not self.signatures:
            return G2_INFINITY
        return bls.aggregate_signatures(self.signatures)


class SyncCommitteeMessagePool:
    """Aggregates individual gossip SyncCommitteeMessages into per-subnet
    contributions for the aggregator duty (reference
    syncCommitteeMessagePool.ts)."""

    def __init__(self, p: BeaconPreset | None = None):
        self.p = p or active_preset()
        # (slot, block_root, subnet) -> _Aggregate
        self._by_key: dict[tuple[int, bytes, int], _Aggregate] = {}
        self._count_by_slot: dict[int, int] = {}
        self.lowest_permissible_slot = 0

    @property
    def subcommittee_size(self) -> int:
        return self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT

    def add(self, subnet: int, message, index_in_subcommittee: int) -> InsertOutcome:
        if not (0 <= int(subnet) < SYNC_COMMITTEE_SUBNET_COUNT):
            raise OpPoolError(f"bad subnet {subnet}")
        if not (0 <= int(index_in_subcommittee) < self.subcommittee_size):
            raise OpPoolError(f"bad subcommittee position {index_in_subcommittee}")
        slot = int(message.slot)
        if slot < self.lowest_permissible_slot:
            return InsertOutcome.OLD
        key = (slot, bytes(message.beacon_block_root), int(subnet))
        agg = self._by_key.get(key)
        if agg is None:
            if self._count_by_slot.get(slot, 0) >= MAX_ITEMS_PER_SLOT:
                return InsertOutcome.REACHED_MAX_PER_SLOT
            agg = self._by_key[key] = _Aggregate(self.subcommittee_size)
            self._count_by_slot[slot] = self._count_by_slot.get(slot, 0) + 1
        return agg.add(int(index_in_subcommittee), bytes(message.signature))

    def get_contribution(self, subnet: int, slot: int, block_root: bytes):
        """SyncCommitteeContribution for the aggregator's
        ContributionAndProof, or None."""
        agg = self._by_key.get((int(slot), bytes(block_root), int(subnet)))
        if agg is None:
            return None
        t = ssz_types(self.p)
        c = t.SyncCommitteeContribution.default()
        c.slot = slot
        c.beacon_block_root = bytes(block_root)
        c.subcommittee_index = subnet
        c.aggregation_bits = list(agg.bits)
        c.signature = agg.signature()
        return c

    def prune(self, clock_slot: int) -> None:
        self.lowest_permissible_slot = max(0, clock_slot - MESSAGE_SLOTS_RETAINED)
        for k in [k for k in self._by_key if k[0] < self.lowest_permissible_slot]:
            del self._by_key[k]
        for s in [s for s in self._count_by_slot if s < self.lowest_permissible_slot]:
            del self._count_by_slot[s]


class SyncContributionAndProofPool:
    """Keeps the best (most participants) contribution per (slot, root,
    subnet) and merges them into the block SyncAggregate (reference
    syncContributionAndProofPool.ts getSyncAggregate)."""

    def __init__(self, p: BeaconPreset | None = None):
        self.p = p or active_preset()
        # (slot, block_root) -> {subnet: (participants, bits, signature)}
        self._best: dict[tuple[int, bytes], dict[int, tuple[int, list[bool], bytes]]] = {}
        self._count_by_slot: dict[int, int] = {}
        self.lowest_permissible_slot = 0

    @property
    def subcommittee_size(self) -> int:
        return self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT

    def add(self, contribution_and_proof) -> InsertOutcome:
        contribution = contribution_and_proof.contribution
        subnet = int(contribution.subcommittee_index)
        bits = list(contribution.aggregation_bits)
        # reject malformed input at ingest, not in produce_block
        if not (0 <= subnet < SYNC_COMMITTEE_SUBNET_COUNT):
            raise OpPoolError(f"bad subcommittee index {subnet}")
        if len(bits) != self.subcommittee_size:
            raise OpPoolError(f"bad aggregation bits length {len(bits)}")
        slot = int(contribution.slot)
        if slot < self.lowest_permissible_slot:
            return InsertOutcome.OLD
        key = (slot, bytes(contribution.beacon_block_root))
        if key not in self._best:
            if self._count_by_slot.get(slot, 0) >= MAX_ITEMS_PER_SLOT:
                return InsertOutcome.REACHED_MAX_PER_SLOT
            self._count_by_slot[slot] = self._count_by_slot.get(slot, 0) + 1
        by_subnet = self._best.setdefault(key, {})
        participants = sum(bits)
        cur = by_subnet.get(subnet)
        if cur is not None and cur[0] >= participants:
            return InsertOutcome.NOT_BETTER_THAN
        by_subnet[subnet] = (participants, bits, bytes(contribution.signature))
        return InsertOutcome.NEW_DATA

    def get_sync_aggregate(self, slot: int, block_root: bytes):
        """SyncAggregate over the previous block root for block
        production; empty participation carries the G2 infinity
        signature."""
        t = ssz_types(self.p)
        p = self.p
        agg = t.SyncAggregate.default()
        sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        bits = [False] * p.SYNC_COMMITTEE_SIZE
        sigs: list[bytes] = []
        by_subnet = self._best.get((int(slot), bytes(block_root)), {})
        for subnet, (_n, sub_bits, sig) in by_subnet.items():
            for i, b in enumerate(sub_bits):
                if b:
                    bits[subnet * sub_size + i] = True
            sigs.append(sig)
        agg.sync_committee_bits = bits
        agg.sync_committee_signature = bls.aggregate_signatures(sigs) if sigs else G2_INFINITY
        return agg

    def prune(self, clock_slot: int) -> None:
        self.lowest_permissible_slot = max(0, clock_slot - CONTRIBUTION_SLOTS_RETAINED)
        for k in [k for k in self._best if k[0] < self.lowest_permissible_slot]:
            del self._best[k]
        for s in [s for s in self._count_by_slot if s < self.lowest_permissible_slot]:
            del self._count_by_slot[s]


class SeenSlotKeyed:
    """First-seen dedup keyed by (slot, *ids) — the sync-committee
    equivalents of the attester seen caches (reference
    `seenCache/seenCommittee.ts`, `seenCommitteeContribution.ts`)."""

    def __init__(self):
        self._seen: set[tuple] = set()

    def is_known(self, slot: int, *ids) -> bool:
        return (int(slot), *ids) in self._seen

    def add(self, slot: int, *ids) -> None:
        self._seen.add((int(slot), *ids))

    def prune(self, lowest_permissible_slot: int) -> None:
        self._seen = {k for k in self._seen if k[0] >= lowest_permissible_slot}
