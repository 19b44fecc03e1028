"""Eth1 data for block production.

Reference `eth1/eth1DepositDataTracker.ts:115` (getEth1DataAndDeposits:
deposit-log ingestion + eth1Data voting) and `eth1/index.ts:108`
(Eth1ForBlockProductionDisabled — the no-op provider dev nodes use).
`Eth1MemoryProvider` implements the voting rule over an in-memory block
feed: follow-distance window, majority vote continuation, deposit-count
monotonicity.

The port of `lodestar_tpu.execution.eth1`, with its imports rewritten.
"""

from __future__ import annotations

from dataclasses import dataclass

from lodestar_tpu_torch.types import ssz_types

__all__ = ["Eth1ForBlockProductionDisabled", "Eth1MemoryProvider", "Eth1Block"]


@dataclass(frozen=True)
class Eth1Block:
    number: int
    timestamp: int
    block_hash: bytes
    deposit_root: bytes
    deposit_count: int


class Eth1ForBlockProductionDisabled:
    """Reuse the state's existing eth1Data (reference `index.ts:108`)."""

    def get_eth1_data_and_deposits(self, state):
        return state.eth1_data, []


class Eth1MemoryProvider:
    """Voting over a fed eth1 chain (the tracker logic minus JSON-RPC).

    Deposit EVENTS must be fed too (`feed_deposit`): the STF requires a
    block to carry min(MAX_DEPOSITS, eth1_data.deposit_count -
    eth1_deposit_index) deposits, so the provider never votes a
    deposit_count beyond what it can actually serve — otherwise block
    production wedges on the deposit-count check
    (`state_transition/block.py` process_operations)."""

    def __init__(self, *, follow_distance_sec: int = 0, cfg=None):
        if cfg is not None:
            follow_distance_sec = cfg.SECONDS_PER_ETH1_BLOCK * cfg.ETH1_FOLLOW_DISTANCE
        self.follow_distance_sec = follow_distance_sec
        self.blocks: list[Eth1Block] = []
        self.deposits: dict[int, object] = {}  # deposit index -> Deposit (with proof)

    def feed_block(self, block: Eth1Block) -> None:
        if self.blocks and block.deposit_count < self.blocks[-1].deposit_count:
            raise ValueError("deposit count must be monotonic")
        self.blocks.append(block)

    def feed_deposit(self, index: int, deposit) -> None:
        self.deposits[index] = deposit

    def _servable_count(self, from_index: int) -> int:
        """Highest deposit_count we can prove contiguously from from_index."""
        count = from_index
        while count in self.deposits:
            count += 1
        return count

    def get_eth1_data_and_deposits(self, state, *, current_time: int | None = None):
        """Spec get_eth1_vote: among candidate blocks inside the follow-
        distance window, vote with the existing majority if any candidate
        matches, else the latest candidate; never decrease deposit_count
        and never exceed the servable deposit horizon."""
        t = ssz_types()
        if not self.blocks:
            return state.eth1_data, []
        now = current_time if current_time is not None else self.blocks[-1].timestamp
        servable = self._servable_count(state.eth1_deposit_index)
        candidates = [
            b
            for b in self.blocks
            if b.timestamp + self.follow_distance_sec <= now
            and state.eth1_data.deposit_count <= b.deposit_count <= servable
        ]
        if not candidates:
            return state.eth1_data, []

        def to_data(b: Eth1Block):
            d = t.Eth1Data.default()
            d.deposit_root = b.deposit_root
            d.deposit_count = b.deposit_count
            d.block_hash = b.block_hash
            return d

        # count existing votes among candidates
        cand_by_hash = {b.block_hash: b for b in candidates}
        tally: dict[bytes, int] = {}
        for vote in state.eth1_data_votes:
            h = bytes(vote.block_hash)
            if h in cand_by_hash:
                tally[h] = tally.get(h, 0) + 1
        if tally:
            best = max(tally.items(), key=lambda kv: (kv[1], cand_by_hash[kv[0]].number))[0]
            chosen = cand_by_hash[best]
        else:
            chosen = candidates[-1]
        deposits = [
            self.deposits[i]
            for i in range(state.eth1_deposit_index, chosen.deposit_count)
        ]
        return to_data(chosen), deposits
