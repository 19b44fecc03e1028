"""Backfill sync: verify history backwards from a checkpoint anchor.

Reference `sync/backfill/backfill.ts:105` + `backfill/verify.ts`: after
weak-subjectivity checkpoint sync the node holds no history before the
anchor; backfill downloads blocks BACKWARDS, verifies (a) hash-chain
linkage (block.root == next.parent_root) and (b) proposer signatures as
ONE batched verification per segment (the big-batch consumer of the
device verifier), then persists without re-running the STF.

The port of `lodestar_tpu.sync.backfill` (host Python, as there), with
one departure: each block is typed by its slot's fork
(`chain.block_type_at_slot`) for its root, its signing root and the bytes
persisted, where the JAX package types every block as phase0. For phase0
blocks the two agree byte for byte; for a later fork's block the phase0
type hashes and serializes only the phase0 fields of its body, so the JAX
package reports broken linkage where the port backfills.
"""

from __future__ import annotations

from lodestar_tpu_torch.chain.bls import IBlsVerifier, VerifySignatureOpts
from lodestar_tpu_torch.crypto.bls.api import SignatureSet
from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import DOMAIN_BEACON_PROPOSER, active_preset
from lodestar_tpu_torch.scheduler import PriorityClass

__all__ = ["BackfillSync", "BackfillError"]


class BackfillError(Exception):
    pass


class BackfillSync:
    def __init__(
        self,
        *,
        chain,
        network,
        bls_verifier: IBlsVerifier,
        peers: list[str],
        anchor_state,
        batch_slots: int = 64,
    ) -> None:
        self.chain = chain
        self.network = network
        self.bls = bls_verifier
        self.peers = list(peers)
        self.anchor_state = anchor_state
        self.batch_slots = batch_slots
        self.log = get_logger(name="lodestar.backfill")

    async def backfill(self, anchor_block, until_slot: int = 0, terminal_root: bytes | None = None) -> int:
        """Walk backwards from `anchor_block` persisting verified history.
        Completes when linkage reaches `terminal_root` (e.g. the genesis
        block) or slots are exhausted down to `until_slot`. Returns blocks
        persisted."""
        p = active_preset()
        expected_parent = bytes(anchor_block.message.parent_root)
        persisted = 0
        low = anchor_block.message.slot

        window = self.batch_slots
        while low > until_slot:
            start = max(until_slot, low - window)
            count = low - start
            blocks = None
            for peer in self.peers:
                try:
                    blocks = await self.network.blocks_by_range(peer, start, count)
                    break
                except Exception as e:
                    self.log.warn(f"backfill download failed on {peer}: {e!r}")
            if not blocks:
                # a long run of genuinely empty slots is possible: widen the
                # window downward (linkage still proves completeness); only
                # fail once the whole remaining range came back empty
                if start <= until_slot:
                    raise BackfillError(
                        f"no blocks in remaining range [{until_slot}, {low}) "
                        "and terminal block not reached"
                    )
                window *= 2
                continue
            window = self.batch_slots

            # (a) linkage: walking backwards, every block's root must equal
            # the previously verified block's parent_root (roots cached for
            # the persist pass below)
            types = [self.chain.block_type_at_slot(int(s.message.slot)) for s in blocks]
            roots = [bt.hash_tree_root(s.message) for s, (bt, _) in zip(blocks, types)]
            for signed, root in zip(reversed(blocks), reversed(roots)):
                if root != expected_parent:
                    raise BackfillError(
                        f"chain linkage broken at slot {signed.message.slot}"
                    )
                expected_parent = bytes(signed.message.parent_root)

            # (b) proposer signatures: one batch for the whole segment
            sets = [self._proposer_set(signed, bt, p) for signed, (bt, _) in zip(blocks, types)]
            if sets and not await self.bls.verify_signature_sets(
                sets,
                VerifySignatureOpts(batchable=False, priority=PriorityClass.BACKFILL),
            ):
                raise BackfillError("segment proposer-signature batch invalid")

            for signed, root, (_, st) in zip(blocks, roots, types):
                self.chain.blocks_db.put_binary(root, st.serialize(signed))
                persisted += 1
            if terminal_root is not None and expected_parent == terminal_root:
                break  # linked all the way to the terminal block
            # only the slots actually covered by verified linkage count as
            # done — a peer serving a truncated range must not leave holes
            low = blocks[0].message.slot
        return persisted

    def _proposer_set(self, signed, block_type, p) -> SignatureSet:
        from lodestar_tpu_torch.state_transition.util import get_domain
        from lodestar_tpu_torch.config import compute_signing_root

        proposer = self.anchor_state.validators[signed.message.proposer_index]
        domain = get_domain(
            self.anchor_state,
            DOMAIN_BEACON_PROPOSER,
            signed.message.slot // p.SLOTS_PER_EPOCH,
        )
        return SignatureSet(
            pubkey=bytes(proposer.pubkey),
            message=compute_signing_root(block_type, signed.message, domain),
            signature=bytes(signed.signature),
        )
