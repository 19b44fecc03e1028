"""Proto-array LMD-GHOST fork choice.

Counterpart of the reference `fork-choice/src/protoArray/protoArray.ts`
(`applyScoreChanges` :83, `findHead` :447, `nodeIsViableForHead` :725) and
`computeDeltas.ts`. Same flat-array design — children always appear after
parents, so one backwards sweep both applies deltas and back-propagates
them, and a second sweep repairs best-child/best-descendant links.

Deviation from the reference: `compute_deltas` is vectorized. Votes live in numpy
arrays (per-validator interned root ids) and the per-validator loop the
reference runs over ~1M validators becomes two `np.bincount` scatter-adds
— the same O(V) work at C speed, and the natural stepping stone to a
device-resident version if head recomputation ever dominates.

The port of `lodestar_tpu.fork_choice.proto_array` (host Python and numpy, as there).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "ExecutionStatus",
    "ProtoBlock",
    "ProtoNode",
    "ProtoArray",
    "VoteTracker",
    "compute_deltas",
    "HEX_ZERO_HASH",
]

HEX_ZERO_HASH = "0x" + "00" * 32
DEFAULT_PRUNE_THRESHOLD = 0


class ExecutionStatus(enum.Enum):
    PRE_MERGE = "PreMerge"
    SYNCING = "Syncing"
    VALID = "Valid"
    INVALID = "Invalid"


@dataclass
class ProtoBlock:
    """Summary of a block for fork choice (reference `interface.ts` ProtoBlock)."""

    slot: int
    block_root: str
    parent_root: str
    state_root: str
    target_root: str
    justified_epoch: int
    justified_root: str
    finalized_epoch: int
    finalized_root: str
    unrealized_justified_epoch: int = 0
    unrealized_justified_root: str = HEX_ZERO_HASH
    unrealized_finalized_epoch: int = 0
    unrealized_finalized_root: str = HEX_ZERO_HASH
    execution_payload_block_hash: str | None = None
    execution_status: ExecutionStatus = ExecutionStatus.PRE_MERGE


@dataclass
class ProtoNode(ProtoBlock):
    parent: int | None = None
    weight: int = 0
    best_child: int | None = None
    best_descendant: int | None = None


class ProtoArrayError(Exception):
    pass


class ProtoArray:
    def __init__(
        self,
        *,
        justified_epoch: int,
        justified_root: str,
        finalized_epoch: int,
        finalized_root: str,
        slots_per_epoch: int,
        prune_threshold: int = DEFAULT_PRUNE_THRESHOLD,
    ) -> None:
        self.prune_threshold = prune_threshold
        self.justified_epoch = justified_epoch
        self.justified_root = justified_root
        self.finalized_epoch = finalized_epoch
        self.finalized_root = finalized_root
        self.slots_per_epoch = slots_per_epoch
        self.nodes: list[ProtoNode] = []
        self.indices: dict[str, int] = {}
        self._previous_proposer_boost: tuple[str, int] | None = None

    # -- construction ---------------------------------------------------------

    @classmethod
    def initialize(cls, block: ProtoBlock, current_slot: int, slots_per_epoch: int) -> "ProtoArray":
        arr = cls(
            justified_epoch=block.justified_epoch,
            justified_root=block.justified_root,
            finalized_epoch=block.finalized_epoch,
            finalized_root=block.finalized_root,
            slots_per_epoch=slots_per_epoch,
        )
        anchor = ProtoNode(**{**vars(block), "target_root": block.block_root})
        arr.on_block(anchor, current_slot)
        return arr

    def on_block(self, block: ProtoBlock, current_slot: int) -> None:
        """Insert a block (reference `onBlock` :197). Ignores known roots;
        rejects Invalid execution status outright."""
        if block.block_root in self.indices:
            return
        if block.execution_status is ExecutionStatus.INVALID:
            raise ProtoArrayError(f"onBlock with invalid execution status: {block.block_root}")

        node = ProtoNode(**vars(block))
        node.parent = self.indices.get(block.parent_root)
        node.weight = 0
        node.best_child = None
        node.best_descendant = None

        node_index = len(self.nodes)
        self.indices[node.block_root] = node_index
        self.nodes.append(node)

        parent_index = node.parent
        if node.execution_status is ExecutionStatus.VALID and parent_index is not None:
            self._propagate_valid_execution(parent_index)

        idx = node_index
        while parent_index is not None:
            self._maybe_update_best_child_and_descendant(parent_index, idx, current_slot)
            idx = parent_index
            parent_index = self.nodes[idx].parent

    # -- scoring --------------------------------------------------------------

    def apply_score_changes(
        self,
        *,
        deltas: list[int],
        proposer_boost: tuple[str, int] | None,
        justified_epoch: int,
        justified_root: str,
        finalized_epoch: int,
        finalized_root: str,
        current_slot: int,
    ) -> None:
        """Reference `applyScoreChanges` (:83): one backwards sweep applies
        deltas + proposer boost and back-propagates into parent deltas; a
        second sweep repairs best-child/descendant links."""
        if len(deltas) != len(self.indices):
            raise ProtoArrayError(f"invalid delta length {len(deltas)} != {len(self.indices)}")

        self.justified_epoch = justified_epoch
        self.justified_root = justified_root
        self.finalized_epoch = finalized_epoch
        self.finalized_root = finalized_root

        for node_index in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[node_index]
            if node.block_root == HEX_ZERO_HASH:
                continue
            current_boost = (
                proposer_boost[1]
                if proposer_boost is not None and proposer_boost[0] == node.block_root
                else 0
            )
            previous_boost = (
                self._previous_proposer_boost[1]
                if self._previous_proposer_boost is not None
                and self._previous_proposer_boost[0] == node.block_root
                else 0
            )
            if node.execution_status is ExecutionStatus.INVALID:
                node_delta = -node.weight
            else:
                node_delta = deltas[node_index] + current_boost - previous_boost

            node.weight += node_delta
            if node.parent is not None:
                deltas[node.parent] += node_delta

        for node_index in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[node_index]
            if node.parent is not None:
                self._maybe_update_best_child_and_descendant(node.parent, node_index, current_slot)

        self._previous_proposer_boost = proposer_boost

    # -- head -----------------------------------------------------------------

    def find_head(self, justified_root: str, current_slot: int) -> str:
        """Follow best-descendant from the justified node (reference :447)."""
        justified_index = self.indices.get(justified_root)
        if justified_index is None:
            raise ProtoArrayError(f"justified node unknown: {justified_root}")
        justified_node = self.nodes[justified_index]
        if justified_node.execution_status is ExecutionStatus.INVALID:
            raise ProtoArrayError("justified node has invalid execution status")

        best_descendant_index = (
            justified_node.best_descendant
            if justified_node.best_descendant is not None
            else justified_index
        )
        best_node = self.nodes[best_descendant_index]
        if best_descendant_index != justified_index and not self._node_is_viable_for_head(
            best_node, current_slot
        ):
            raise ProtoArrayError(
                f"invalid best node {best_node.block_root} from justified {justified_root}"
            )
        return best_node.block_root

    # -- pruning --------------------------------------------------------------

    def maybe_prune(self, finalized_root: str) -> list[ProtoNode]:
        """Drop all nodes before the finalized one (reference :511)."""
        finalized_index = self.indices.get(finalized_root)
        if finalized_index is None:
            raise ProtoArrayError(f"finalized node unknown: {finalized_root}")
        if finalized_index < self.prune_threshold:
            return []

        for node in self.nodes[:finalized_index]:
            del self.indices[node.block_root]
        removed = self.nodes[:finalized_index]
        self.nodes = self.nodes[finalized_index:]
        for key in self.indices:
            self.indices[key] -= finalized_index
        for node in self.nodes:
            if node.parent is not None:
                node.parent = None if node.parent < finalized_index else node.parent - finalized_index
            if node.best_child is not None:
                node.best_child -= finalized_index
            if node.best_descendant is not None:
                node.best_descendant -= finalized_index
        return removed

    # -- execution status -----------------------------------------------------

    def _propagate_valid_execution(self, start_index: int) -> None:
        idx: int | None = start_index
        while idx is not None:
            node = self.nodes[idx]
            if node.execution_status in (ExecutionStatus.PRE_MERGE, ExecutionStatus.VALID):
                break
            if node.execution_status is ExecutionStatus.INVALID:
                raise ProtoArrayError(
                    f"consensus failure: valid descendant of invalid block {node.block_root}"
                )
            node.execution_status = ExecutionStatus.VALID
            idx = node.parent

    def invalidate(self, block_root: str, current_slot: int) -> None:
        """Mark a node invalid; descendants become invalid via the
        -weight rule on the next apply_score_changes, and best-child links
        are repaired immediately."""
        idx = self.indices.get(block_root)
        if idx is None:
            raise ProtoArrayError(f"unknown block to invalidate: {block_root}")
        node = self.nodes[idx]
        if node.execution_status is ExecutionStatus.PRE_MERGE:
            raise ProtoArrayError("cannot invalidate a pre-merge block")
        node.execution_status = ExecutionStatus.INVALID
        node.best_child = None
        node.best_descendant = None
        # descendants of an invalid payload are invalid too
        for i in range(idx + 1, len(self.nodes)):
            n = self.nodes[i]
            p = n.parent
            if p is not None and self.nodes[p].execution_status is ExecutionStatus.INVALID:
                n.execution_status = ExecutionStatus.INVALID
                n.best_child = None
                n.best_descendant = None
        for i in range(len(self.nodes) - 1, -1, -1):
            n = self.nodes[i]
            if n.parent is not None:
                self._maybe_update_best_child_and_descendant(n.parent, i, current_slot)

    # -- internals ------------------------------------------------------------

    def _maybe_update_best_child_and_descendant(
        self, parent_index: int, child_index: int, current_slot: int
    ) -> None:
        child = self.nodes[child_index]
        parent = self.nodes[parent_index]
        child_viable = self._node_leads_to_viable_head(child, current_slot)

        change_to_child = (
            child_index,
            child.best_descendant if child.best_descendant is not None else child_index,
        )
        no_change = (parent.best_child, parent.best_descendant)

        best_child_index = parent.best_child
        if best_child_index is not None:
            if best_child_index == child_index and not child_viable:
                new = (None, None)
            elif best_child_index == child_index:
                new = change_to_child
            else:
                best_child = self.nodes[best_child_index]
                best_viable = self._node_leads_to_viable_head(best_child, current_slot)
                if child_viable and not best_viable:
                    new = change_to_child
                elif not child_viable and best_viable:
                    new = no_change
                elif child.weight == best_child.weight:
                    # equal-weight tie broken by root ordering (reference :668)
                    new = change_to_child if child.block_root >= best_child.block_root else no_change
                else:
                    new = change_to_child if child.weight >= best_child.weight else no_change
        elif child_viable:
            new = change_to_child
        else:
            new = no_change

        parent.best_child, parent.best_descendant = new

    def _node_leads_to_viable_head(self, node: ProtoNode, current_slot: int) -> bool:
        if node.best_descendant is not None:
            if self._node_is_viable_for_head(self.nodes[node.best_descendant], current_slot):
                return True
        return self._node_is_viable_for_head(node, current_slot)

    def _node_is_viable_for_head(self, node: ProtoNode, current_slot: int) -> bool:
        """`filter_block_tree` equivalent (reference :725): voting-source
        justification check (unrealized for previous-epoch blocks) +
        finalized-ancestor check."""
        if node.execution_status is ExecutionStatus.INVALID:
            return False
        current_epoch = current_slot // self.slots_per_epoch
        previous_epoch = current_epoch - 1
        is_from_prev_epoch = node.slot // self.slots_per_epoch < current_epoch
        voting_source_epoch = (
            node.unrealized_justified_epoch if is_from_prev_epoch else node.justified_epoch
        )
        correct_justified = voting_source_epoch == self.justified_epoch or self.justified_epoch == 0
        if not correct_justified and current_epoch > 0 and self.justified_epoch == previous_epoch:
            correct_justified = (
                node.unrealized_justified_epoch >= previous_epoch
                and voting_source_epoch + 2 >= current_epoch
            )
        finalized_slot = self.finalized_epoch * self.slots_per_epoch
        correct_finalized = (
            self.finalized_epoch == 0
            or self.finalized_root == self._ancestor_or_none(node.block_root, finalized_slot)
        )
        return correct_justified and correct_finalized

    def _ancestor_or_none(self, block_root: str, ancestor_slot: int) -> str | None:
        idx = self.indices.get(block_root)
        if idx is None:
            return None
        node = self.nodes[idx]
        while node.slot > ancestor_slot:
            if node.parent is None:
                return None
            node = self.nodes[node.parent]
        return node.block_root

    def get_ancestor(self, block_root: str, ancestor_slot: int) -> str:
        out = self._ancestor_or_none(block_root, ancestor_slot)
        if out is None:
            raise ProtoArrayError(f"ancestor of {block_root} at slot {ancestor_slot} unknown")
        return out

    def has_block(self, block_root: str) -> bool:
        return block_root in self.indices

    def get_block(self, block_root: str) -> ProtoNode | None:
        idx = self.indices.get(block_root)
        return self.nodes[idx] if idx is not None else None

    def __len__(self) -> int:
        return len(self.nodes)


class VoteTracker:
    """Per-validator LMD votes as numpy arrays of interned root ids.

    The reference keeps `VoteTracker[]` objects (`interface.ts:10-14`);
    here current/next root ids and next-vote epochs are flat int64 arrays
    so `compute_deltas` can scatter-add with bincount instead of looping
    validators in the interpreter.
    """

    def __init__(self) -> None:
        self._root_ids: dict[str, int] = {HEX_ZERO_HASH: 0}
        self._roots: list[str] = [HEX_ZERO_HASH]
        self.current = np.zeros(0, dtype=np.int64)  # root id voted (applied)
        self.next = np.zeros(0, dtype=np.int64)  # root id voted (pending)
        self.next_epoch = np.zeros(0, dtype=np.int64)
        self.equivocating = np.zeros(0, dtype=bool)

    def _intern(self, root: str) -> int:
        rid = self._root_ids.get(root)
        if rid is None:
            rid = len(self._roots)
            self._root_ids[root] = rid
            self._roots.append(root)
        return rid

    def _grow(self, n: int) -> None:
        if n <= len(self.current):
            return
        pad = n - len(self.current)
        self.current = np.concatenate([self.current, np.zeros(pad, dtype=np.int64)])
        self.next = np.concatenate([self.next, np.zeros(pad, dtype=np.int64)])
        self.next_epoch = np.concatenate([self.next_epoch, np.zeros(pad, dtype=np.int64)])
        self.equivocating = np.concatenate([self.equivocating, np.zeros(pad, dtype=bool)])

    def process_attestation(self, validator_index: int, block_root: str, target_epoch: int) -> None:
        """Update the pending vote if newer (reference forkChoice.ts
        onAttestation → votes[i].nextRoot/nextEpoch update)."""
        self._grow(validator_index + 1)
        if self.equivocating[validator_index]:
            return
        if target_epoch > self.next_epoch[validator_index] or self.next[validator_index] == 0:
            self.next[validator_index] = self._intern(block_root)
            self.next_epoch[validator_index] = target_epoch

    def mark_equivocation(self, validator_index: int) -> None:
        self._grow(validator_index + 1)
        self.equivocating[validator_index] = True

    def root_of(self, rid: int) -> str:
        return self._roots[rid]


def compute_deltas(
    indices: dict[str, int],
    votes: VoteTracker,
    old_balances: np.ndarray,
    new_balances: np.ndarray,
) -> list[int]:
    """Vectorized `computeDeltas.ts`: one delta per proto node.

    Two bincount scatter-adds replace the per-validator loop; vote state
    transitions (equivocation zeroing, current←next) are applied with
    boolean masks. Semantics match the reference exactly, including
    processing each equivocating validator only once.
    """
    n_nodes = len(indices)
    n = len(votes.current)
    deltas = np.zeros(n_nodes, dtype=np.int64)
    if n == 0:
        return deltas.tolist()

    # map interned root ids -> node indices (-1 = unknown/pruned)
    id_to_node = np.full(len(votes._roots), -1, dtype=np.int64)
    for root, node_idx in indices.items():
        rid = votes._root_ids.get(root)
        if rid is not None:
            id_to_node[rid] = node_idx

    old_b = np.zeros(n, dtype=np.int64)
    old_b[: min(n, len(old_balances))] = old_balances[: min(n, len(old_balances))]
    new_b = np.zeros(n, dtype=np.int64)
    new_b[: min(n, len(new_balances))] = new_balances[: min(n, len(new_balances))]

    cur, nxt = votes.current, votes.next
    active = ~((cur == 0) & (nxt == 0))

    # rid 0 is the zero-hash alias for genesis: never scored (reference
    # checks `currentRoot !== zeroHash` explicitly)
    id_to_node[0] = -1

    # equivocating validators: remove their current vote once, then zero it
    equiv = votes.equivocating & active
    eq_nodes = id_to_node[cur[equiv]]
    eq_known = eq_nodes >= 0
    np.subtract.at(deltas, eq_nodes[eq_known], old_b[equiv][eq_known])
    cur = cur.copy()
    cur[equiv] = 0

    # regular vote/balance changes
    changed = active & ~equiv & ((cur != nxt) | (old_b != new_b))
    c_nodes = id_to_node[cur[changed]]
    c_known = c_nodes >= 0
    np.subtract.at(deltas, c_nodes[c_known], old_b[changed][c_known])
    n_nodes_idx = id_to_node[nxt[changed]]
    n_known = n_nodes_idx >= 0
    np.add.at(deltas, n_nodes_idx[n_known], new_b[changed][n_known])

    # commit vote state: current <- next for all processed votes
    cur[changed] = nxt[changed]
    votes.current = cur
    return deltas.tolist()
