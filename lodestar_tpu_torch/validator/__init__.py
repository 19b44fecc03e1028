"""Validator client (reference `packages/validator/src`).

`Validator` runs attestation + block-proposal duties per slot against an
injected beacon API (in-process BeaconChain adapter or a REST client —
the duty flow matches `validator.ts:187` + `services/attestation.ts` /
`services/block.ts`); all signing flows through `ValidatorStore`, which
is gated by the slashing-protection DB.

The port of `lodestar_tpu.validator`, with its imports rewritten.
"""

from __future__ import annotations

from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.state_transition import EpochContext

from .slashing_protection import SlashingError, SlashingProtection  # noqa: F401
from .store import ValidatorStore  # noqa: F401

__all__ = ["Validator", "ValidatorStore", "SlashingProtection", "SlashingError"]


class Validator:
    """Duty loop over an in-process chain (the reference's
    getDevBeaconNode pattern): on each slot — propose if selected, attest
    at the committee assignment."""

    def __init__(
        self,
        *,
        chain,
        store: ValidatorStore,
        p: BeaconPreset | None = None,
        doppelganger=None,
    ):
        self.chain = chain
        self.store = store
        self.p = p or active_preset()
        self.doppelganger = doppelganger

    def _may_sign(self, pubkey: bytes) -> bool:
        """Key is managed AND (when doppelganger protection is on) has
        cleared its detection window (reference validatorStore
        isDoppelgangerSafe gate on every signing path)."""
        if not self.store.has_pubkey(pubkey):
            return False
        return self.doppelganger is None or self.doppelganger.is_safe(pubkey)

    async def run_slot_duties(self, slot: int) -> dict:
        """Propose + attest for `slot`. Returns a summary of what was
        produced (tests + dev runner introspection)."""
        out = {"proposed": None, "attestations": []}
        from lodestar_tpu_torch.chain.produce_block import dial_to_slot

        head_state = self.chain.get_head_state()
        work, ctx = dial_to_slot(head_state, slot, self.p, self.chain.cfg)

        # register managed keys with the validator monitor — iterate the
        # SMALL set (local keys), not the full validator registry
        if self.chain.metrics is not None:
            monitor = self.chain.metrics.validator_monitor
            idx_map = ctx.pubkey_to_index(work)
            for pk in self.store.pubkeys:
                vi = idx_map.get(bytes(pk))
                if vi is not None:
                    monitor.register_local_validator(vi)

        # -- proposal (services/block.ts) --
        proposer_index = ctx.get_beacon_proposer(slot)
        proposer_pk = bytes(work.validators[proposer_index].pubkey)
        if self._may_sign(proposer_pk):
            from lodestar_tpu_torch.chain.produce_block import produce_block

            epoch = slot // self.p.SLOTS_PER_EPOCH
            # only the store.sign_* calls may raise ValueError for
            # concurrent key removal — produce_block stays OUTSIDE the
            # guard so real production bugs surface instead of silently
            # skipping the proposal
            signed = None
            try:
                reveal = self.store.sign_randao(proposer_pk, epoch)
            except ValueError:
                reveal = None  # key removed concurrently by the keymanager
            if reveal is not None:
                block = produce_block(self.chain, slot=slot, randao_reveal=reveal)
                try:
                    signed = self.store.sign_block(proposer_pk, block)
                except ValueError:
                    signed = None  # key removed concurrently
            if signed is not None:
                await self.chain.process_block(signed, is_timely=True)
                out["proposed"] = signed
                # duties for the rest of the slot run on the new head
                work, ctx = dial_to_slot(
                    self.chain.get_head_state(), slot, self.p, self.chain.cfg
                )

        # -- attestations (services/attestation.ts) --
        from lodestar_tpu_torch.chain.produce_block import make_attestation_data
        from lodestar_tpu_torch.types import ssz_types

        t = ssz_types(self.p)
        epoch = slot // self.p.SLOTS_PER_EPOCH
        for committee_index in range(ctx.get_committee_count_per_slot(epoch)):
            committee = ctx.get_beacon_committee(slot, committee_index)
            data = make_attestation_data(self.chain, slot, committee_index)
            data_root = t.AttestationData.hash_tree_root(data)
            for pos, vi in enumerate(committee):
                pk = bytes(work.validators[int(vi)].pubkey)
                if not self._may_sign(pk):
                    continue
                try:
                    sig = self.store.sign_attestation(pk, data)
                except ValueError:
                    continue  # key removed concurrently by the keymanager
                att = t.Attestation.default()
                bits = [False] * len(committee)
                bits[pos] = True
                att.aggregation_bits = bits
                att.data = data
                att.signature = sig
                out["attestations"].append(att)
                self.chain.attestation_pool.add(att, data_root)
                self.chain.fork_choice.on_attestation(
                    [int(vi)], "0x" + bytes(data.beacon_block_root).hex(), epoch, slot
                )

        # -- aggregation round (services/attestation.ts second phase) --
        out["aggregates"] = self._run_aggregation(slot, work, ctx, t)

        # -- sync committee duties (services/syncCommittee.ts) --
        from lodestar_tpu_torch.state_transition.block import fork_of

        if fork_of(work) != "phase0":
            out["sync_messages"], out["sync_contributions"] = self._run_sync_duties(
                slot, work, t, ctx
            )
        return out

    def _run_sync_duties(self, slot: int, work, t, ctx) -> tuple[list, list]:
        """Sign SyncCommitteeMessages for every managed member of the
        current sync committee, then run the contribution-aggregator
        phase over the message pool (reference
        services/syncCommittee.ts + syncCommitteeDuties.ts)."""
        from lodestar_tpu_torch.chain.validation import is_sync_committee_aggregator
        from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT

        p = self.p
        head_root = self.chain.head_root
        sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
        # the aggregate lands in the block at slot+1 and is verified
        # against THAT state's current committee — at the last slot of a
        # period the rotated (next_) committee must sign (the gossip
        # validator's _committee_for_slot handles the same boundary)
        period_len = p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD * p.SLOTS_PER_EPOCH
        committee = (
            work.next_sync_committee
            if (slot + 1) // period_len > int(work.slot) // period_len
            else work.current_sync_committee
        )
        committee_pks = [bytes(pk) for pk in committee.pubkeys]

        messages = []
        vi_by_pk = ctx.pubkey_to_index(work)  # cached on the context
        for pos, pk in enumerate(committee_pks):
            if not self._may_sign(pk):
                continue
            subnet = pos // sub_size
            msg = t.SyncCommitteeMessage.default()
            msg.slot = slot
            msg.beacon_block_root = head_root
            msg.validator_index = vi_by_pk.get(pk, 0)
            try:
                msg.signature = self.store.sign_sync_committee_message(pk, slot, head_root)
            except ValueError:
                continue  # key removed concurrently
            self.chain.sync_committee_message_pool.add(subnet, msg, pos % sub_size)
            messages.append(msg)

        contributions = []
        for subnet in range(SYNC_COMMITTEE_SUBNET_COUNT):
            window = committee_pks[subnet * sub_size : (subnet + 1) * sub_size]
            for pk in window:
                if not self._may_sign(pk):
                    continue
                try:
                    proof = self.store.sign_sync_selection_proof(pk, slot, subnet)
                except ValueError:
                    continue  # key removed concurrently
                if not is_sync_committee_aggregator(proof, p):
                    continue
                contribution = self.chain.sync_committee_message_pool.get_contribution(
                    subnet, slot, head_root
                )
                if contribution is None:
                    continue
                cp = t.ContributionAndProof.default()
                cp.aggregator_index = vi_by_pk.get(pk, 0)
                cp.contribution = contribution
                cp.selection_proof = proof
                signed = self.store.sign_contribution_and_proof(pk, cp)
                self.chain.sync_contribution_pool.add(cp)
                contributions.append(signed)
                break  # one aggregator per subnet suffices locally
        return messages, contributions

    def _run_aggregation(self, slot: int, work, ctx, t) -> list:
        """Selected aggregators publish SignedAggregateAndProof into the
        aggregated pool block production packs from."""
        from lodestar_tpu_torch.chain.validation import is_aggregator

        epoch = slot // self.p.SLOTS_PER_EPOCH
        aggregates = []
        for committee_index in range(ctx.get_committee_count_per_slot(epoch)):
            committee = ctx.get_beacon_committee(slot, committee_index)
            for vi in committee:
                pk = bytes(work.validators[int(vi)].pubkey)
                if not self._may_sign(pk):
                    continue
                try:
                    proof = self.store.sign_selection_proof(pk, slot)
                except ValueError:
                    continue  # key removed concurrently
                if not is_aggregator(len(committee), proof):
                    continue
                # aggregate what the naive pool collected for this data
                data = None
                for root, entry in list(
                    self.chain.attestation_pool._by_slot.get(slot, {}).items()
                ):
                    if entry["data"].index != committee_index:
                        continue
                    agg_att = self.chain.attestation_pool.get_aggregate(slot, root)
                    if agg_att is None:
                        continue
                    aap = t.AggregateAndProof.default()
                    aap.aggregator_index = int(vi)
                    aap.aggregate = agg_att
                    aap.selection_proof = proof
                    signed_agg = self.store.sign_aggregate_and_proof(pk, aap)
                    aggregates.append(signed_agg)
                    self.chain.aggregated_attestation_pool.add(agg_att, root)
                break  # one aggregator per committee suffices locally
        return aggregates
