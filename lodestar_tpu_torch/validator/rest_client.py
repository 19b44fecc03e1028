"""REST-mode validator: duties driven over the Beacon API.

Reference `packages/validator/src/validator.ts` + `services/` — the
production deployment shape: a separate validator process talking to the
beacon node purely through the standard REST endpoints (duties →
produce → sign → publish). The in-process `Validator` (this package's
__init__) is the dev/test shape; this client is the cross-process one.
All signing still flows through ValidatorStore (slashing-protected) and
the optional doppelganger gate.

The port of `lodestar_tpu.validator.rest_client`, with its imports rewritten.
"""

from __future__ import annotations

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.ssz.json import from_json, to_json
from lodestar_tpu_torch.types import ssz_types

from .slashing_protection import SlashingError
from .store import ValidatorStore

__all__ = ["RestValidator"]


class RestValidator:
    """Per-slot duty runner over a BeaconApiClient-compatible client
    (any object with get_proposer_duties / get_attester_duties /
    produce_block_v2 / produce_attestation_data / publish_block /
    submit_pool_attestations)."""

    def __init__(
        self,
        *,
        client,
        store: ValidatorStore,
        p: BeaconPreset | None = None,
        doppelganger=None,
    ):
        self.client = client
        self.store = store
        self.p = p or active_preset()
        self.doppelganger = doppelganger
        self.log = get_logger(name="lodestar.validator.rest")
        # validator index -> pubkey for OUR keys, filled lazily from the API
        self._index_to_pubkey: dict[int, bytes] = {}
        self._indices_epoch = -1

    def _may_sign(self, pubkey: bytes) -> bool:
        if not self.store.has_pubkey(pubkey):
            return False
        return self.doppelganger is None or self.doppelganger.is_safe(pubkey)

    def refresh_indices(self) -> None:
        """Map our pubkeys to validator indices via the state validators
        endpoint (reference indicesService.pollValidatorIndices)."""
        res = self.client.get_state_validators("head")
        ours = set(self.store.pubkeys)
        for entry in res.get("data", []):
            pk = bytes.fromhex(entry["validator"]["pubkey"][2:])
            if pk in ours:
                self._index_to_pubkey[int(entry["index"])] = pk

    def run_slot_duties(self, slot: int) -> dict:
        """Propose (if selected) then attest for `slot`. Synchronous —
        the REST calls are blocking; callers schedule per slot."""
        epoch = slot // self.p.SLOTS_PER_EPOCH
        if epoch != self._indices_epoch:
            # re-poll once per epoch: keymanager imports and fresh
            # activations must start performing duties without a restart
            # (reference indicesService.pollValidatorIndices cadence)
            self.refresh_indices()
            self._indices_epoch = epoch
        out = {"proposed": None, "attestations": []}
        t = ssz_types(self.p)

        # -- proposal (services/block.ts over the API) --
        duties = self.client.get_proposer_duties(epoch).get("data", [])
        my_duty = next(
            (
                d
                for d in duties
                if int(d["slot"]) == slot and int(d["validator_index"]) in self._index_to_pubkey
            ),
            None,
        )
        if my_duty is not None:
            pk = self._index_to_pubkey[int(my_duty["validator_index"])]
            if self._may_sign(pk):
                reveal = self.store.sign_randao(pk, epoch)
                res = self.client.produce_block_v2(slot, reveal)
                fork = res.get("version", "phase0")
                block = from_json(getattr(t, fork).BeaconBlock, res["data"])
                signed = self.store.sign_block(pk, block)
                signed_type = getattr(t, fork).SignedBeaconBlock
                self.client.publish_block(to_json(signed_type, signed))
                out["proposed"] = signed

        # -- attestations (services/attestation.ts over the API) --
        att_duties = self.client.get_attester_duties(
            epoch, sorted(self._index_to_pubkey)
        ).get("data", [])
        to_submit = []
        for duty in att_duties:
            if int(duty["slot"]) != slot:
                continue
            vi = int(duty["validator_index"])
            pk = self._index_to_pubkey.get(vi)
            if pk is None or not self._may_sign(pk):
                continue
            # per-duty isolation: one key's slashing refusal or concurrent
            # keymanager removal must not drop the other keys'
            # already-signed attestations for the slot (mirrors the
            # in-process Validator's per-duty guards). Only the SIGN call
            # is guarded — a malformed beacon response (from_json
            # ValueError) is a real bug and must surface, not be
            # misreported as a skipped duty.
            data_json = self.client.produce_attestation_data(
                slot, int(duty["committee_index"])
            )["data"]
            data = from_json(t.AttestationData, data_json)
            try:
                sig = self.store.sign_attestation(pk, data)
            except (SlashingError, ValueError) as e:
                self.log.warning(
                    "attestation duty skipped validator=%d: %s", vi, e
                )
                continue
            att = t.Attestation.default()
            bits = [False] * int(duty["committee_length"])
            bits[int(duty["validator_committee_index"])] = True
            att.aggregation_bits = bits
            att.data = data
            att.signature = sig
            to_submit.append(att)
        if to_submit:
            self.client.submit_pool_attestations(
                [to_json(t.Attestation, a) for a in to_submit]
            )
        out["attestations"] = to_submit

        # -- sync-committee duties over REST (services/syncCommittee.ts) --
        out["sync_messages"], out["sync_contributions"] = self._run_sync_duties_rest(
            slot, epoch, t
        )
        return out

    def _run_sync_duties_rest(self, slot: int, epoch: int, t) -> tuple[list, list]:
        """Sync-committee message + contribution flow entirely over the
        Beacon API (duties/sync, pool/sync_committees,
        sync_committee_contribution, contribution_and_proofs) — no
        in-process chain access."""
        from lodestar_tpu_torch.chain.validation import is_sync_committee_aggregator
        from lodestar_tpu_torch.params import SYNC_COMMITTEE_SUBNET_COUNT

        p = self.p
        try:
            duties = self.client.get_sync_committee_duties(
                epoch, sorted(self._index_to_pubkey)
            ).get("data", [])
        except Exception as e:
            self.log.warning("sync duties fetch failed: %s", e)
            return [], []
        if not duties:
            return [], []
        head_root = self.client.get_block_root("head")["data"]["root"]
        sub_size = p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT

        messages, contributions = [], []
        msg_jsons = []
        for duty in duties:
            pk = bytes.fromhex(duty["pubkey"][2:])
            if not self._may_sign(pk):
                continue
            msg = t.SyncCommitteeMessage.default()
            msg.slot = slot
            msg.beacon_block_root = bytes.fromhex(head_root[2:])
            msg.validator_index = int(duty["validator_index"])
            try:
                msg.signature = self.store.sign_sync_committee_message(
                    pk, slot, bytes(msg.beacon_block_root)
                )
            except ValueError:
                continue  # key removed concurrently
            msg_jsons.append(to_json(t.SyncCommitteeMessage, msg))
            messages.append(msg)
        if msg_jsons:
            try:
                self.client.submit_pool_sync_committees(msg_jsons)
            except Exception as e:
                self.log.warning("sync message submit failed: %s", e)

        for duty in duties:
            pk = bytes.fromhex(duty["pubkey"][2:])
            if not self._may_sign(pk):
                continue
            for pos_str in duty.get("validator_sync_committee_indices", []):
                subnet = int(pos_str) // sub_size
                try:
                    proof = self.store.sign_sync_selection_proof(pk, slot, subnet)
                except ValueError:
                    continue
                if not is_sync_committee_aggregator(proof, p):
                    continue
                try:
                    res = self.client.produce_sync_committee_contribution(
                        slot, subnet, head_root
                    )
                except Exception:
                    continue  # no contribution available yet
                contribution = from_json(
                    t.SyncCommitteeContribution, res["data"]
                )
                cp = t.ContributionAndProof.default()
                cp.aggregator_index = int(duty["validator_index"])
                cp.contribution = contribution
                cp.selection_proof = proof
                signed = self.store.sign_contribution_and_proof(pk, cp)
                try:
                    self.client.publish_contribution_and_proofs(
                        [to_json(t.SignedContributionAndProof, signed)]
                    )
                    contributions.append(signed)
                except Exception as e:
                    self.log.warning("contribution publish failed: %s", e)
        return messages, contributions
