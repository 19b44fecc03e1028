"""ValidatorStore: keys + all duty signatures, gated by slashing
protection.

Reference `validator/src/services/validatorStore.ts` — signBlock /
signAttestation (both run the slashing-protection check on the SIGNING
ROOT before producing a signature), signRandao, selection proofs,
aggregate-and-proof envelopes, voluntary exits.

The port of `lodestar_tpu.validator.store`, with its imports rewritten.
"""

from __future__ import annotations

from lodestar_tpu_torch import ssz
from lodestar_tpu_torch.config import BeaconConfig
from lodestar_tpu_torch.crypto.bls.api import SecretKey, sign
from lodestar_tpu_torch.params import (
    DOMAIN_AGGREGATE_AND_PROOF,
    DOMAIN_BEACON_ATTESTER,
    DOMAIN_BEACON_PROPOSER,
    DOMAIN_RANDAO,
    DOMAIN_SELECTION_PROOF,
    DOMAIN_VOLUNTARY_EXIT,
    BeaconPreset,
    active_preset,
)
from lodestar_tpu_torch.state_transition.util import compute_epoch_at_slot
from lodestar_tpu_torch.types import ssz_types

from .slashing_protection import SlashingProtection

__all__ = ["ValidatorStore"]


def _signing_root(ssz_type, value, domain: bytes) -> bytes:
    from lodestar_tpu_torch.config import compute_signing_root

    return compute_signing_root(ssz_type, value, domain)


class ValidatorStore:
    def __init__(
        self,
        config: BeaconConfig,
        slashing_protection: SlashingProtection,
        secret_keys: list[SecretKey],
        p: BeaconPreset | None = None,
    ) -> None:
        self.config = config
        self.slashing = slashing_protection
        self.p = p or active_preset()
        self._by_pubkey: dict[bytes, SecretKey] = {sk.to_pubkey(): sk for sk in secret_keys}

    @property
    def pubkeys(self) -> list[bytes]:
        return list(self._by_pubkey)

    def has_pubkey(self, pubkey: bytes) -> bool:
        return pubkey in self._by_pubkey

    def add_secret_key(self, sk: SecretKey) -> None:
        """Runtime key import (keymanager API)."""
        self._by_pubkey[sk.to_pubkey()] = sk

    def remove_pubkey(self, pubkey: bytes) -> bool:
        """Runtime key removal (keymanager API); slashing history stays."""
        return self._by_pubkey.pop(pubkey, None) is not None

    def _sk(self, pubkey: bytes) -> SecretKey:
        sk = self._by_pubkey.get(pubkey)
        if sk is None:
            raise ValueError(f"unknown validator pubkey 0x{pubkey.hex()[:16]}")
        return sk

    # -- duties ---------------------------------------------------------------

    def sign_block(self, pubkey: bytes, block) -> bytes:
        """Signed block — the slashing DB records the signing root BEFORE
        the signature leaves this process. Fork-aware: the block's own
        container type names the fork namespace."""
        from lodestar_tpu_torch.state_transition.block import fork_of

        t = ssz_types(self.p)
        ns = getattr(t, fork_of(block))  # fork_of reads any container's type name
        epoch = compute_epoch_at_slot(block.slot, self.p)
        domain = self.config.get_domain(DOMAIN_BEACON_PROPOSER, epoch)
        root = _signing_root(ns.BeaconBlock, block, domain)
        self.slashing.check_and_insert_block_proposal(pubkey, block.slot, root)
        signed = ns.SignedBeaconBlock.default()
        signed.message = block
        signed.signature = sign(self._sk(pubkey), root)
        return signed

    def sign_attestation(self, pubkey: bytes, att_data) -> bytes:
        t = ssz_types(self.p)
        domain = self.config.get_domain(DOMAIN_BEACON_ATTESTER, att_data.target.epoch)
        root = _signing_root(t.AttestationData, att_data, domain)
        self.slashing.check_and_insert_attestation(
            pubkey, att_data.source.epoch, att_data.target.epoch, root
        )
        return sign(self._sk(pubkey), root)

    def sign_randao(self, pubkey: bytes, epoch: int) -> bytes:
        domain = self.config.get_domain(DOMAIN_RANDAO, epoch)
        return sign(self._sk(pubkey), _signing_root(ssz.uint64, epoch, domain))

    def sign_selection_proof(self, pubkey: bytes, slot: int) -> bytes:
        epoch = compute_epoch_at_slot(slot, self.p)
        domain = self.config.get_domain(DOMAIN_SELECTION_PROOF, epoch)
        return sign(self._sk(pubkey), _signing_root(ssz.uint64, slot, domain))

    def sign_aggregate_and_proof(self, pubkey: bytes, agg_and_proof) -> bytes:
        t = ssz_types(self.p)
        epoch = compute_epoch_at_slot(agg_and_proof.aggregate.data.slot, self.p)
        domain = self.config.get_domain(DOMAIN_AGGREGATE_AND_PROOF, epoch)
        root = _signing_root(t.AggregateAndProof, agg_and_proof, domain)
        signed = t.SignedAggregateAndProof.default()
        signed.message = agg_and_proof
        signed.signature = sign(self._sk(pubkey), root)
        return signed

    def sign_sync_committee_message(self, pubkey: bytes, slot: int, block_root: bytes) -> bytes:
        """SyncCommitteeMessage signature over the head block root
        (reference signSyncCommitteeSignature). SigningData of a raw
        Root is sha256(root || domain)."""
        import hashlib

        from lodestar_tpu_torch.params import DOMAIN_SYNC_COMMITTEE

        epoch = compute_epoch_at_slot(slot, self.p)
        domain = self.config.get_domain(DOMAIN_SYNC_COMMITTEE, epoch)
        return sign(self._sk(pubkey), hashlib.sha256(bytes(block_root) + domain).digest())

    def sign_sync_selection_proof(self, pubkey: bytes, slot: int, subcommittee_index: int) -> bytes:
        """SyncAggregatorSelectionData proof (reference
        signSyncCommitteeSelectionProof)."""
        from lodestar_tpu_torch.params import DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF

        t = ssz_types(self.p)
        data = t.SyncAggregatorSelectionData.default()
        data.slot = slot
        data.subcommittee_index = subcommittee_index
        epoch = compute_epoch_at_slot(slot, self.p)
        domain = self.config.get_domain(DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch)
        return sign(self._sk(pubkey), _signing_root(t.SyncAggregatorSelectionData, data, domain))

    def sign_contribution_and_proof(self, pubkey: bytes, contribution_and_proof):
        """SignedContributionAndProof envelope (reference
        signContributionAndProof)."""
        from lodestar_tpu_torch.params import DOMAIN_CONTRIBUTION_AND_PROOF

        t = ssz_types(self.p)
        epoch = compute_epoch_at_slot(contribution_and_proof.contribution.slot, self.p)
        domain = self.config.get_domain(DOMAIN_CONTRIBUTION_AND_PROOF, epoch)
        root = _signing_root(t.ContributionAndProof, contribution_and_proof, domain)
        signed = t.SignedContributionAndProof.default()
        signed.message = contribution_and_proof
        signed.signature = sign(self._sk(pubkey), root)
        return signed

    def sign_voluntary_exit(self, pubkey: bytes, validator_index: int, epoch: int):
        t = ssz_types(self.p)
        exit_ = t.VoluntaryExit.default()
        exit_.epoch = epoch
        exit_.validator_index = validator_index
        domain = self.config.get_domain(DOMAIN_VOLUNTARY_EXIT, epoch)
        signed = t.SignedVoluntaryExit.default()
        signed.message = exit_
        signed.signature = sign(self._sk(pubkey), _signing_root(t.VoluntaryExit, exit_, domain))
        return signed
