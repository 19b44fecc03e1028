"""Light-client server: produce bootstraps and updates from chain data.

Reference `beacon-node/src/chain/lightClient/index.ts:168` + `proofs.ts`:
on block import the server captures (attested header, sync aggregate,
state proofs) and serves LightClientBootstrap / LightClientUpdate /
FinalityUpdate / OptimisticUpdate. Proof production reuses
`light_client.produce_state_field_branch` over the typed state.

The port of `lodestar_tpu.chain.light_client_server` (host Python, as
there; proofs hash the state's fields on the host).
"""

from __future__ import annotations

from lodestar_tpu_torch.light_client import is_better_update, produce_state_field_branch
from lodestar_tpu_torch.types import ssz_types

__all__ = ["LightClientServer"]


class LightClientServer:
    def __init__(self, chain):
        self.chain = chain
        self.p = chain.p
        self._best_by_period: dict[int, object] = {}
        self._latest_finality_update = None
        self._latest_optimistic_update = None

    # -- production (called from block import) --------------------------------

    def on_imported_block(self, signed_block, post_state) -> None:
        """Build an update whose attested header is the block's PARENT
        (the header the block's sync aggregate signs)."""
        from lodestar_tpu_torch.state_transition.block import fork_of

        if fork_of(post_state) == "phase0":
            return  # no sync committees before altair
        t = ssz_types(self.p)
        block = signed_block.message
        parent_root = bytes(block.parent_root)
        try:
            attested_state = self.chain.get_state_by_block_root(parent_root)
        except Exception:
            return
        parent_node = self.chain.fork_choice.proto_array.get_block("0x" + parent_root.hex())
        if parent_node is None:
            return

        # the attested header must reconstruct EXACTLY (clients verify the
        # sync aggregate against hash_tree_root(attested_header)); without
        # the stored parent block (e.g. the anchor) no valid update exists
        parent_block = self.chain.get_block_by_root(parent_root)
        if parent_block is None:
            return
        if fork_of(attested_state) == "phase0":
            # the first altair block attests a phase0 parent: no sync
            # committee to prove yet
            return

        update = t.LightClientUpdate.default()
        att = t.LightClientHeader.default()
        att.beacon.slot = parent_node.slot
        att.beacon.parent_root = bytes.fromhex(parent_node.parent_root[2:])
        att.beacon.state_root = bytes.fromhex(parent_node.state_root[2:])
        from lodestar_tpu_torch.state_transition.block import block_types_for

        _, body_t = block_types_for(attested_state, self.p)
        att.beacon.body_root = body_t.hash_tree_root(parent_block.message.body)
        att.beacon.proposer_index = parent_block.message.proposer_index
        update.attested_header = att

        # next sync committee proof from the attested state
        update.next_sync_committee = attested_state.next_sync_committee
        update.next_sync_committee_branch = produce_state_field_branch(
            attested_state, "next_sync_committee"
        )

        # finality: prove the attested state's finalized checkpoint
        fin_cp = attested_state.finalized_checkpoint
        fin_block = self.chain.get_block_by_root(bytes(fin_cp.root))
        if fin_block is not None:
            fin_hdr = t.LightClientHeader.default()
            fin_hdr.beacon.slot = fin_block.message.slot
            fin_hdr.beacon.proposer_index = fin_block.message.proposer_index
            fin_hdr.beacon.parent_root = bytes(fin_block.message.parent_root)
            fin_hdr.beacon.state_root = bytes(fin_block.message.state_root)
            from lodestar_tpu_torch.state_transition.block import block_types_for

            _, body_t = block_types_for(attested_state, self.p)
            fin_hdr.beacon.body_root = body_t.hash_tree_root(fin_block.message.body)
            update.finalized_header = fin_hdr
            epoch_root = t.Checkpoint.fields[0][1].hash_tree_root(fin_cp.epoch)
            update.finality_branch = [epoch_root] + produce_state_field_branch(
                attested_state, "finalized_checkpoint"
            )

        update.sync_aggregate = block.body.sync_aggregate
        update.signature_slot = block.slot

        period = parent_node.slot // (
            self.p.SLOTS_PER_EPOCH * self.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )
        best = self._best_by_period.get(period)
        if best is None or is_better_update(update, best):
            self._best_by_period[period] = update
        if update.finalized_header.beacon.slot != 0:
            self._latest_finality_update = update
        self._latest_optimistic_update = update

    # -- serving (the light-client reqresp/REST handlers) ---------------------

    def get_bootstrap(self, block_root: bytes):
        """LightClientBootstrap anchored at `block_root`."""
        t = ssz_types(self.p)
        state = self.chain.get_state_by_block_root(block_root)
        node = self.chain.fork_choice.proto_array.get_block("0x" + block_root.hex())
        if node is None:
            raise KeyError(f"unknown block 0x{block_root.hex()[:16]}")
        # the FULL header: clients verify hash_tree_root(header) against
        # their trusted block root (reference lightclient bootstrap); an
        # unreconstructible header would fail client-side anyway, so a
        # missing block is a clean not-found
        signed = self.chain.get_block_by_root(block_root)
        if signed is None:
            return None
        boot = t.LightClientBootstrap.default()
        boot.header.beacon.slot = node.slot
        boot.header.beacon.state_root = bytes.fromhex(node.state_root[2:])
        msg = signed.message
        boot.header.beacon.proposer_index = int(msg.proposer_index)
        boot.header.beacon.parent_root = bytes(msg.parent_root)
        from lodestar_tpu_torch.state_transition.block import fork_of

        ns = getattr(t, fork_of(msg))
        boot.header.beacon.body_root = ns.BeaconBlockBody.hash_tree_root(msg.body)
        boot.current_sync_committee = state.current_sync_committee
        boot.current_sync_committee_branch = produce_state_field_branch(
            state, "current_sync_committee"
        )
        return boot

    def get_updates(self, start_period: int, count: int) -> list:
        return [
            self._best_by_period[p]
            for p in range(start_period, start_period + count)
            if p in self._best_by_period
        ]

    def get_finality_update(self):
        return self._latest_finality_update

    def get_optimistic_update(self):
        return self._latest_optimistic_update
