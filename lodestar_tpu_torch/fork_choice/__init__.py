"""LMD-GHOST fork choice (reference `packages/fork-choice/src`).

`ForkChoice` wraps the proto-array with the store state the spec calls
`Store`: justified/finalized checkpoints + balances, per-validator votes,
queued future-slot attestations, equivocations, proposer boost
(reference `forkChoice/forkChoice.ts:67`). Head recomputation =
`compute_deltas` (vectorized) + `apply_score_changes` + `find_head`.

The port of `lodestar_tpu.fork_choice` (host Python and numpy, as there).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lodestar_tpu_torch import tracing

from .proto_array import (  # noqa: F401
    DEFAULT_PRUNE_THRESHOLD,
    ExecutionStatus,
    HEX_ZERO_HASH,
    ProtoArray,
    ProtoArrayError,
    ProtoBlock,
    ProtoNode,
    VoteTracker,
    compute_deltas,
)

__all__ = [
    "Checkpoint",
    "ForkChoice",
    "ForkChoiceError",
    "ProtoArray",
    "ProtoArrayError",
    "ProtoBlock",
    "ProtoNode",
    "ExecutionStatus",
    "VoteTracker",
    "compute_deltas",
    "HEX_ZERO_HASH",
]

# spec constant: proposer boost as % of the committee weight per slot
PROPOSER_SCORE_BOOST = 40


class ForkChoiceError(Exception):
    pass


@dataclass(frozen=True)
class Checkpoint:
    epoch: int
    root: str


@dataclass
class QueuedAttestation:
    slot: int
    attesting_indices: tuple[int, ...]
    block_root: str
    target_epoch: int


class ForkChoice:
    """Reference `ForkChoice` (`forkChoice.ts:67`), reduced to the store +
    vote machinery (the state-transition hooks land with the STF layer)."""

    def __init__(
        self,
        proto_array: ProtoArray,
        *,
        current_slot: int,
        justified_checkpoint: Checkpoint,
        finalized_checkpoint: Checkpoint,
        justified_balances: np.ndarray,
        slots_per_epoch: int,
    ) -> None:
        self.proto_array = proto_array
        self.votes = VoteTracker()
        self.queued_attestations: list[QueuedAttestation] = []
        self.current_slot = current_slot
        self.justified = justified_checkpoint
        self.finalized = finalized_checkpoint
        self.justified_balances = np.asarray(justified_balances, dtype=np.int64)
        self._old_balances = self.justified_balances
        self.slots_per_epoch = slots_per_epoch
        self.proposer_boost_root: str | None = None
        self._head: str | None = None

    @classmethod
    def from_anchor(
        cls,
        anchor: ProtoBlock,
        *,
        current_slot: int,
        justified_balances: np.ndarray,
        slots_per_epoch: int,
    ) -> "ForkChoice":
        arr = ProtoArray.initialize(anchor, current_slot, slots_per_epoch)
        return cls(
            arr,
            current_slot=current_slot,
            justified_checkpoint=Checkpoint(anchor.justified_epoch, anchor.justified_root),
            finalized_checkpoint=Checkpoint(anchor.finalized_epoch, anchor.finalized_root),
            justified_balances=justified_balances,
            slots_per_epoch=slots_per_epoch,
        )

    # -- clock ---------------------------------------------------------------

    def on_tick(self, slot: int) -> None:
        """Advance the store clock; drain queued attestations whose slot is
        now in the past; clear proposer boost at slot boundaries."""
        if slot < self.current_slot:
            raise ForkChoiceError("clock must not go backwards")
        if slot != self.current_slot:
            self.proposer_boost_root = None
        self.current_slot = slot
        ready = [a for a in self.queued_attestations if a.slot < slot]
        self.queued_attestations = [a for a in self.queued_attestations if a.slot >= slot]
        for att in ready:
            for vi in att.attesting_indices:
                self.votes.process_attestation(vi, att.block_root, att.target_epoch)

    # -- inputs ---------------------------------------------------------------

    def on_block(
        self,
        block: ProtoBlock,
        *,
        is_timely: bool = False,
        justified_checkpoint: Checkpoint | None = None,
        finalized_checkpoint: Checkpoint | None = None,
        justified_balances: np.ndarray | None = None,
    ) -> None:
        """Insert a (fully verified) block. Updates store checkpoints if
        the block's state advanced them (the STF supplies them)."""
        if not self.proto_array.has_block(block.parent_root):
            raise ForkChoiceError(f"unknown parent {block.parent_root}")
        self.proto_array.on_block(block, self.current_slot)
        if is_timely and block.slot == self.current_slot:
            self.proposer_boost_root = block.block_root
        if justified_checkpoint and justified_checkpoint.epoch > self.justified.epoch:
            self.justified = justified_checkpoint
            if justified_balances is not None:
                self._old_balances = self.justified_balances
                self.justified_balances = np.asarray(justified_balances, dtype=np.int64)
        if finalized_checkpoint and finalized_checkpoint.epoch > self.finalized.epoch:
            self.finalized = finalized_checkpoint

    def on_attestation(
        self, attesting_indices: list[int], block_root: str, target_epoch: int, slot: int
    ) -> None:
        """LMD vote registration (reference `onAttestation` :483); future-
        slot attestations queue until their slot passes."""
        if block_root == HEX_ZERO_HASH:
            return
        if slot < self.current_slot:
            for vi in attesting_indices:
                if not (vi < len(self.votes.equivocating) and self.votes.equivocating[vi]):
                    self.votes.process_attestation(vi, block_root, target_epoch)
        else:
            self.queued_attestations.append(
                QueuedAttestation(slot, tuple(attesting_indices), block_root, target_epoch)
            )

    def on_attester_slashing(self, attesting_indices_intersection: list[int]) -> None:
        for vi in attesting_indices_intersection:
            self.votes.mark_equivocation(vi)

    # -- head -----------------------------------------------------------------

    def update_head(self) -> str:
        """Recompute and return the canonical head root."""
        with tracing.span("find_head") as sp:
            boost = None
            if self.proposer_boost_root is not None:
                committee_weight = int(self.justified_balances.sum()) // self.slots_per_epoch
                boost = (self.proposer_boost_root, committee_weight * PROPOSER_SCORE_BOOST // 100)
            deltas = compute_deltas(
                self.proto_array.indices, self.votes, self._old_balances, self.justified_balances
            )
            self._old_balances = self.justified_balances
            self.proto_array.apply_score_changes(
                deltas=deltas,
                proposer_boost=boost,
                justified_epoch=self.justified.epoch,
                justified_root=self.justified.root,
                finalized_epoch=self.finalized.epoch,
                finalized_root=self.finalized.root,
                current_slot=self.current_slot,
            )
            self._head = self.proto_array.find_head(self.justified.root, self.current_slot)
            if sp:
                sp.set(nodes=len(self.proto_array.nodes))
            return self._head

    @property
    def head(self) -> str:
        if self._head is None:
            return self.update_head()
        return self._head

    def prune(self) -> list[ProtoNode]:
        return self.proto_array.maybe_prune(self.finalized.root)

    def get_all_ancestor_blocks(self, block_root: str) -> list[ProtoNode]:
        """The canonical chain ending at `block_root` (inclusive),
        ascending by slot — the blocks the archiver migrates to the cold
        db (reference forkChoice.getAllAncestorBlocks)."""
        pa = self.proto_array
        idx = pa.indices.get(block_root)
        out: list[ProtoNode] = []
        while idx is not None:
            node = pa.nodes[idx]
            out.append(node)
            idx = node.parent
        out.reverse()
        return out

    def get_all_non_ancestor_blocks(self, block_root: str) -> list[ProtoNode]:
        """Every known block NOT on the canonical chain to `block_root`
        — dead forks the archiver deletes from the hot db (reference
        forkChoice.getAllNonAncestorBlocks)."""
        canonical = {n.block_root for n in self.get_all_ancestor_blocks(block_root)}
        return [n for n in self.proto_array.nodes if n.block_root not in canonical]
