"""Fork-versioned SSZ type schemas (phase0 → deneb).

Counterpart of the reference `packages/types/src/sszTypes.ts` and the
per-fork type dirs (`phase0/ altair/ bellatrix/ capella/ deneb/`). Because
vector lengths depend on the preset, types are built by a cached factory
`ssz_types(preset)` instead of import-frozen module globals.

Field order matters for hash_tree_root — it follows the consensus spec
container definitions exactly.

A copy of `lodestar_tpu.types` over the port's own `ssz` and `params`.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

from lodestar_tpu_torch import ssz
from lodestar_tpu_torch.params import (
    ATTESTATION_SUBNET_COUNT,
    BeaconPreset,
    DEPOSIT_CONTRACT_TREE_DEPTH,
    JUSTIFICATION_BITS_LENGTH,
    SYNC_COMMITTEE_SUBNET_COUNT,
    active_preset,
)

__all__ = ["ssz_types", "Root", "Gwei", "Slot", "Epoch", "ValidatorIndex", "CommitteeIndex"]

# Aliases (readability in downstream signatures)
Root = bytes
Gwei = int
Slot = int
Epoch = int
ValidatorIndex = int
CommitteeIndex = int

_C = ssz.Container
_L = ssz.List
_V = ssz.Vector
u8, u64, u256 = ssz.uint8, ssz.uint64, ssz.uint256
B4, B20, B32, B48, B96 = ssz.Bytes4, ssz.Bytes20, ssz.Bytes32, ssz.Bytes48, ssz.Bytes96


def ssz_types(preset: BeaconPreset | None = None) -> SimpleNamespace:
    """Full fork-versioned type registry for a preset (cached per preset).

    `None` resolves the active preset at call time (so set_active_preset
    takes effect), then caches on the concrete preset value.
    """
    return _build_types(preset or active_preset())


@lru_cache(maxsize=4)
def _build_types(p: BeaconPreset) -> SimpleNamespace:
    t = SimpleNamespace()
    t.preset = p

    # --- primitives shared by all forks (phase0/primitive in reference) ---
    t.Fork = _C("Fork", [("previous_version", B4), ("current_version", B4), ("epoch", u64)])
    t.ForkData = _C("ForkData", [("current_version", B4), ("genesis_validators_root", B32)])
    t.Checkpoint = _C("Checkpoint", [("epoch", u64), ("root", B32)])
    t.Validator = _C(
        "Validator",
        [
            ("pubkey", B48),
            ("withdrawal_credentials", B32),
            ("effective_balance", u64),
            ("slashed", ssz.boolean),
            ("activation_eligibility_epoch", u64),
            ("activation_epoch", u64),
            ("exit_epoch", u64),
            ("withdrawable_epoch", u64),
        ],
    )
    t.AttestationData = _C(
        "AttestationData",
        [
            ("slot", u64),
            ("index", u64),
            ("beacon_block_root", B32),
            ("source", t.Checkpoint),
            ("target", t.Checkpoint),
        ],
    )
    t.IndexedAttestation = _C(
        "IndexedAttestation",
        [
            ("attesting_indices", _L(u64, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("signature", B96),
        ],
    )
    t.PendingAttestation = _C(
        "PendingAttestation",
        [
            ("aggregation_bits", ssz.Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("inclusion_delay", u64),
            ("proposer_index", u64),
        ],
    )
    t.Eth1Data = _C(
        "Eth1Data", [("deposit_root", B32), ("deposit_count", u64), ("block_hash", B32)]
    )
    t.HistoricalBatch = _C(
        "HistoricalBatch",
        [
            ("block_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
        ],
    )
    t.DepositMessage = _C(
        "DepositMessage", [("pubkey", B48), ("withdrawal_credentials", B32), ("amount", u64)]
    )
    t.DepositData = _C(
        "DepositData",
        [("pubkey", B48), ("withdrawal_credentials", B32), ("amount", u64), ("signature", B96)],
    )
    t.BeaconBlockHeader = _C(
        "BeaconBlockHeader",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body_root", B32),
        ],
    )
    t.SignedBeaconBlockHeader = _C(
        "SignedBeaconBlockHeader", [("message", t.BeaconBlockHeader), ("signature", B96)]
    )
    t.SigningData = _C("SigningData", [("object_root", B32), ("domain", B32)])
    t.ProposerSlashing = _C(
        "ProposerSlashing",
        [("signed_header_1", t.SignedBeaconBlockHeader), ("signed_header_2", t.SignedBeaconBlockHeader)],
    )
    t.AttesterSlashing = _C(
        "AttesterSlashing",
        [("attestation_1", t.IndexedAttestation), ("attestation_2", t.IndexedAttestation)],
    )
    t.Attestation = _C(
        "Attestation",
        [
            ("aggregation_bits", ssz.Bitlist(p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("data", t.AttestationData),
            ("signature", B96),
        ],
    )
    t.Deposit = _C(
        "Deposit",
        [("proof", _V(B32, DEPOSIT_CONTRACT_TREE_DEPTH + 1)), ("data", t.DepositData)],
    )
    t.VoluntaryExit = _C("VoluntaryExit", [("epoch", u64), ("validator_index", u64)])
    t.SignedVoluntaryExit = _C(
        "SignedVoluntaryExit", [("message", t.VoluntaryExit), ("signature", B96)]
    )
    t.AggregateAndProof = _C(
        "AggregateAndProof",
        [("aggregator_index", u64), ("aggregate", t.Attestation), ("selection_proof", B96)],
    )
    t.SignedAggregateAndProof = _C(
        "SignedAggregateAndProof", [("message", t.AggregateAndProof), ("signature", B96)]
    )
    # duty/API helper (reference phase0/sszTypes.ts CommitteeAssignment)
    t.CommitteeAssignment = _C(
        "CommitteeAssignment",
        [
            ("validators", _L(u64, p.MAX_VALIDATORS_PER_COMMITTEE)),
            ("committee_index", u64),
            ("slot", u64),
        ],
    )
    # the reference exports the same shape under both names (Validator is
    # its node-struct variant of ValidatorContainer)
    t.ValidatorContainer = t.Validator

    # --- p2p / reqresp containers (reference phase0+altair sszTypes.ts) ---
    t.ENRForkID = _C(
        "ENRForkID",
        [("fork_digest", B4), ("next_fork_version", B4), ("next_fork_epoch", u64)],
    )
    t.Status = _C(
        "Status",
        [
            ("fork_digest", B4),
            ("finalized_root", B32),
            ("finalized_epoch", u64),
            ("head_root", B32),
            ("head_slot", u64),
        ],
    )
    t.BeaconBlocksByRangeRequest = _C(
        "BeaconBlocksByRangeRequest", [("start_slot", u64), ("count", u64), ("step", u64)]
    )
    t.Genesis = _C(
        "Genesis",
        [("genesis_validators_root", B32), ("genesis_time", u64), ("genesis_fork_version", B4)],
    )
    t.Eth1Block = _C(
        "Eth1Block", [("timestamp", u64), ("deposit_root", B32), ("deposit_count", u64)]
    )
    t.Eth1DataOrdered = _C(
        "Eth1DataOrdered",
        [("deposit_root", B32), ("deposit_count", u64), ("block_hash", B32), ("block_number", u64)],
    )
    t.DepositEvent = _C(
        "DepositEvent", [("deposit_data", t.DepositData), ("block_number", u64), ("index", u64)]
    )
    t.HistoricalBatchRoots = _C(
        "HistoricalBatchRoots",
        [
            ("block_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
            ("state_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
        ],
    )

    # --- phase0 block + state ---
    phase0_body_fields = [
        ("randao_reveal", B96),
        ("eth1_data", t.Eth1Data),
        ("graffiti", B32),
        ("proposer_slashings", _L(t.ProposerSlashing, p.MAX_PROPOSER_SLASHINGS)),
        ("attester_slashings", _L(t.AttesterSlashing, p.MAX_ATTESTER_SLASHINGS)),
        ("attestations", _L(t.Attestation, p.MAX_ATTESTATIONS)),
        ("deposits", _L(t.Deposit, p.MAX_DEPOSITS)),
        ("voluntary_exits", _L(t.SignedVoluntaryExit, p.MAX_VOLUNTARY_EXITS)),
    ]
    phase0 = SimpleNamespace()
    phase0.Metadata = _C(
        "MetadataPhase0",
        [("seq_number", u64), ("attnets", ssz.Bitvector(ATTESTATION_SUBNET_COUNT))],
    )
    phase0.BeaconBlockBody = _C("BeaconBlockBodyPhase0", list(phase0_body_fields))
    phase0.BeaconBlock = _C(
        "BeaconBlockPhase0",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body", phase0.BeaconBlockBody),
        ],
    )
    phase0.SignedBeaconBlock = _C(
        "SignedBeaconBlockPhase0", [("message", phase0.BeaconBlock), ("signature", B96)]
    )
    phase0_state_prefix = [
        ("genesis_time", u64),
        ("genesis_validators_root", B32),
        ("slot", u64),
        ("fork", t.Fork),
        ("latest_block_header", t.BeaconBlockHeader),
        ("block_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
        ("state_roots", _V(B32, p.SLOTS_PER_HISTORICAL_ROOT)),
        ("historical_roots", _L(B32, p.HISTORICAL_ROOTS_LIMIT)),
        ("eth1_data", t.Eth1Data),
        ("eth1_data_votes", _L(t.Eth1Data, p.EPOCHS_PER_ETH1_VOTING_PERIOD * p.SLOTS_PER_EPOCH)),
        ("eth1_deposit_index", u64),
        ("validators", _L(t.Validator, p.VALIDATOR_REGISTRY_LIMIT)),
        ("balances", _L(u64, p.VALIDATOR_REGISTRY_LIMIT)),
        ("randao_mixes", _V(B32, p.EPOCHS_PER_HISTORICAL_VECTOR)),
        ("slashings", _V(u64, p.EPOCHS_PER_SLASHINGS_VECTOR)),
    ]
    phase0_state_suffix = [
        ("justification_bits", ssz.Bitvector(JUSTIFICATION_BITS_LENGTH)),
        ("previous_justified_checkpoint", t.Checkpoint),
        ("current_justified_checkpoint", t.Checkpoint),
        ("finalized_checkpoint", t.Checkpoint),
    ]
    phase0.BeaconState = _C(
        "BeaconStatePhase0",
        phase0_state_prefix
        + [
            (
                "previous_epoch_attestations",
                _L(t.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH),
            ),
            (
                "current_epoch_attestations",
                _L(t.PendingAttestation, p.MAX_ATTESTATIONS * p.SLOTS_PER_EPOCH),
            ),
        ]
        + phase0_state_suffix,
    )
    t.phase0 = phase0

    # --- altair ---
    altair = SimpleNamespace()
    t.SyncCommittee = _C(
        "SyncCommittee",
        [("pubkeys", _V(B48, p.SYNC_COMMITTEE_SIZE)), ("aggregate_pubkey", B48)],
    )
    t.SyncAggregate = _C(
        "SyncAggregate",
        [
            ("sync_committee_bits", ssz.Bitvector(p.SYNC_COMMITTEE_SIZE)),
            ("sync_committee_signature", B96),
        ],
    )
    t.SyncCommitteeMessage = _C(
        "SyncCommitteeMessage",
        [("slot", u64), ("beacon_block_root", B32), ("validator_index", u64), ("signature", B96)],
    )
    t.SyncCommitteeContribution = _C(
        "SyncCommitteeContribution",
        [
            ("slot", u64),
            ("beacon_block_root", B32),
            ("subcommittee_index", u64),
            (
                "aggregation_bits",
                ssz.Bitvector(max(p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT, 1)),
            ),
            ("signature", B96),
        ],
    )
    t.ContributionAndProof = _C(
        "ContributionAndProof",
        [
            ("aggregator_index", u64),
            ("contribution", t.SyncCommitteeContribution),
            ("selection_proof", B96),
        ],
    )
    t.SignedContributionAndProof = _C(
        "SignedContributionAndProof", [("message", t.ContributionAndProof), ("signature", B96)]
    )
    t.SyncAggregatorSelectionData = _C(
        "SyncAggregatorSelectionData", [("slot", u64), ("subcommittee_index", u64)]
    )
    altair.Metadata = _C(
        "MetadataAltair",
        [
            ("seq_number", u64),
            ("attnets", ssz.Bitvector(ATTESTATION_SUBNET_COUNT)),
            ("syncnets", ssz.Bitvector(SYNC_COMMITTEE_SUBNET_COUNT)),
        ],
    )

    altair_body_fields = phase0_body_fields + [("sync_aggregate", t.SyncAggregate)]
    altair.BeaconBlockBody = _C("BeaconBlockBodyAltair", list(altair_body_fields))
    altair.BeaconBlock = _C(
        "BeaconBlockAltair",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body", altair.BeaconBlockBody),
        ],
    )
    altair.SignedBeaconBlock = _C(
        "SignedBeaconBlockAltair", [("message", altair.BeaconBlock), ("signature", B96)]
    )
    altair_state_mid = [
        ("previous_epoch_participation", _L(u8, p.VALIDATOR_REGISTRY_LIMIT)),
        ("current_epoch_participation", _L(u8, p.VALIDATOR_REGISTRY_LIMIT)),
    ]
    altair_state_tail = [
        ("inactivity_scores", _L(u64, p.VALIDATOR_REGISTRY_LIMIT)),
        ("current_sync_committee", t.SyncCommittee),
        ("next_sync_committee", t.SyncCommittee),
    ]
    altair.BeaconState = _C(
        "BeaconStateAltair",
        phase0_state_prefix + altair_state_mid + phase0_state_suffix + altair_state_tail,
    )
    t.altair = altair

    # --- light client (altair+) ---
    t.LightClientHeader = _C("LightClientHeader", [("beacon", t.BeaconBlockHeader)])
    t.LightClientBootstrap = _C(
        "LightClientBootstrap",
        [
            ("header", t.LightClientHeader),
            ("current_sync_committee", t.SyncCommittee),
            ("current_sync_committee_branch", _V(B32, 5)),
        ],
    )
    t.LightClientUpdate = _C(
        "LightClientUpdate",
        [
            ("attested_header", t.LightClientHeader),
            ("next_sync_committee", t.SyncCommittee),
            ("next_sync_committee_branch", _V(B32, 5)),
            ("finalized_header", t.LightClientHeader),
            ("finality_branch", _V(B32, 6)),
            ("sync_aggregate", t.SyncAggregate),
            ("signature_slot", u64),
        ],
    )
    t.LightClientFinalityUpdate = _C(
        "LightClientFinalityUpdate",
        [
            ("attested_header", t.LightClientHeader),
            ("finalized_header", t.LightClientHeader),
            ("finality_branch", _V(B32, 6)),
            ("sync_aggregate", t.SyncAggregate),
            ("signature_slot", u64),
        ],
    )
    t.LightClientOptimisticUpdate = _C(
        "LightClientOptimisticUpdate",
        [
            ("attested_header", t.LightClientHeader),
            ("sync_aggregate", t.SyncAggregate),
            ("signature_slot", u64),
        ],
    )
    t.LightClientUpdatesByRange = _C(
        "LightClientUpdatesByRange", [("start_period", u64), ("count", u64)]
    )

    # --- bellatrix ---
    bellatrix = SimpleNamespace()
    payload_prefix = [
        ("parent_hash", B32),
        ("fee_recipient", B20),
        ("state_root", B32),
        ("receipts_root", B32),
        ("logs_bloom", ssz.ByteVector(p.BYTES_PER_LOGS_BLOOM)),
        ("prev_randao", B32),
        ("block_number", u64),
        ("gas_limit", u64),
        ("gas_used", u64),
        ("timestamp", u64),
        ("extra_data", ssz.ByteList(p.MAX_EXTRA_DATA_BYTES)),
        ("base_fee_per_gas", u256),
        ("block_hash", B32),
    ]
    transactions = _L(ssz.ByteList(p.MAX_BYTES_PER_TRANSACTION), p.MAX_TRANSACTIONS_PER_PAYLOAD)
    bellatrix.ExecutionPayload = _C(
        "ExecutionPayloadBellatrix", payload_prefix + [("transactions", transactions)]
    )
    bellatrix.ExecutionPayloadHeader = _C(
        "ExecutionPayloadHeaderBellatrix", payload_prefix + [("transactions_root", B32)]
    )
    bellatrix_body_fields = altair_body_fields + [("execution_payload", bellatrix.ExecutionPayload)]
    bellatrix.BeaconBlockBody = _C("BeaconBlockBodyBellatrix", list(bellatrix_body_fields))
    bellatrix.BeaconBlock = _C(
        "BeaconBlockBellatrix",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body", bellatrix.BeaconBlockBody),
        ],
    )
    bellatrix.SignedBeaconBlock = _C(
        "SignedBeaconBlockBellatrix", [("message", bellatrix.BeaconBlock), ("signature", B96)]
    )
    bellatrix.BeaconState = _C(
        "BeaconStateBellatrix",
        phase0_state_prefix
        + altair_state_mid
        + phase0_state_suffix
        + altair_state_tail
        + [("latest_execution_payload_header", bellatrix.ExecutionPayloadHeader)],
    )

    # engine-api / builder-api containers (reference bellatrix/sszTypes.ts)
    bellatrix.CommonExecutionPayloadType = _C(
        "CommonExecutionPayloadType", payload_prefix[:-1]
    )
    bellatrix.PowBlock = _C(
        "PowBlock", [("block_hash", B32), ("parent_hash", B32), ("total_difficulty", u256)]
    )
    payload_attr_fields = [
        ("timestamp", u64),
        ("prev_randao", B32),
        ("suggested_fee_recipient", B20),
    ]
    bellatrix.PayloadAttributes = _C("PayloadAttributesBellatrix", list(payload_attr_fields))
    sse_payload_attr_common = [
        ("proposer_index", u64),
        ("proposal_slot", u64),
        ("proposal_block_number", u64),
        ("parent_block_root", B32),
        ("parent_block_hash", B32),
    ]
    bellatrix.SSEPayloadAttributesCommon = _C(
        "SSEPayloadAttributesCommon", list(sse_payload_attr_common)
    )
    bellatrix.SSEPayloadAttributes = _C(
        "SSEPayloadAttributesBellatrix",
        sse_payload_attr_common + [("payload_attributes", bellatrix.PayloadAttributes)],
    )
    t.ValidatorRegistrationV1 = _C(
        "ValidatorRegistrationV1",
        [("fee_recipient", B20), ("gas_limit", u64), ("timestamp", u64), ("pubkey", B48)],
    )
    t.SignedValidatorRegistrationV1 = _C(
        "SignedValidatorRegistrationV1",
        [("message", t.ValidatorRegistrationV1), ("signature", B96)],
    )
    bellatrix.ValidatorRegistrationV1 = t.ValidatorRegistrationV1
    bellatrix.SignedValidatorRegistrationV1 = t.SignedValidatorRegistrationV1
    bellatrix.BuilderBid = _C(
        "BuilderBidBellatrix",
        [("header", bellatrix.ExecutionPayloadHeader), ("value", u256), ("pubkey", B48)],
    )
    bellatrix.SignedBuilderBid = _C(
        "SignedBuilderBidBellatrix", [("message", bellatrix.BuilderBid), ("signature", B96)]
    )
    blinded_block_prefix = [
        ("slot", u64),
        ("proposer_index", u64),
        ("parent_root", B32),
        ("state_root", B32),
    ]
    bellatrix.BlindedBeaconBlockBody = _C(
        "BlindedBeaconBlockBodyBellatrix",
        altair_body_fields + [("execution_payload_header", bellatrix.ExecutionPayloadHeader)],
    )
    bellatrix.BlindedBeaconBlock = _C(
        "BlindedBeaconBlockBellatrix",
        blinded_block_prefix + [("body", bellatrix.BlindedBeaconBlockBody)],
    )
    bellatrix.SignedBlindedBeaconBlock = _C(
        "SignedBlindedBeaconBlockBellatrix",
        [("message", bellatrix.BlindedBeaconBlock), ("signature", B96)],
    )
    t.bellatrix = bellatrix

    # --- capella ---
    capella = SimpleNamespace()
    t.Withdrawal = _C(
        "Withdrawal",
        [("index", u64), ("validator_index", u64), ("address", B20), ("amount", u64)],
    )
    t.BLSToExecutionChange = _C(
        "BLSToExecutionChange",
        [("validator_index", u64), ("from_bls_pubkey", B48), ("to_execution_address", B20)],
    )
    t.SignedBLSToExecutionChange = _C(
        "SignedBLSToExecutionChange", [("message", t.BLSToExecutionChange), ("signature", B96)]
    )
    t.HistoricalSummary = _C(
        "HistoricalSummary", [("block_summary_root", B32), ("state_summary_root", B32)]
    )
    withdrawals = _L(t.Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)
    capella.ExecutionPayload = _C(
        "ExecutionPayloadCapella",
        payload_prefix + [("transactions", transactions), ("withdrawals", withdrawals)],
    )
    capella.ExecutionPayloadHeader = _C(
        "ExecutionPayloadHeaderCapella",
        payload_prefix + [("transactions_root", B32), ("withdrawals_root", B32)],
    )
    capella_body_fields = altair_body_fields + [
        ("execution_payload", capella.ExecutionPayload),
        ("bls_to_execution_changes", _L(t.SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)),
    ]
    capella.BeaconBlockBody = _C("BeaconBlockBodyCapella", list(capella_body_fields))
    capella.BeaconBlock = _C(
        "BeaconBlockCapella",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body", capella.BeaconBlockBody),
        ],
    )
    capella.SignedBeaconBlock = _C(
        "SignedBeaconBlockCapella", [("message", capella.BeaconBlock), ("signature", B96)]
    )
    capella.BeaconState = _C(
        "BeaconStateCapella",
        phase0_state_prefix
        + altair_state_mid
        + phase0_state_suffix
        + altair_state_tail
        + [
            ("latest_execution_payload_header", capella.ExecutionPayloadHeader),
            ("next_withdrawal_index", u64),
            ("next_withdrawal_validator_index", u64),
            ("historical_summaries", _L(t.HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)),
        ],
    )

    # engine-api / builder-api containers (reference capella/sszTypes.ts)
    capella.PayloadAttributes = _C(
        "PayloadAttributesCapella", payload_attr_fields + [("withdrawals", withdrawals)]
    )
    capella.SSEPayloadAttributes = _C(
        "SSEPayloadAttributesCapella",
        sse_payload_attr_common + [("payload_attributes", capella.PayloadAttributes)],
    )
    capella.BuilderBid = _C(
        "BuilderBidCapella",
        [("header", capella.ExecutionPayloadHeader), ("value", u256), ("pubkey", B48)],
    )
    capella.SignedBuilderBid = _C(
        "SignedBuilderBidCapella", [("message", capella.BuilderBid), ("signature", B96)]
    )
    capella.BlindedBeaconBlockBody = _C(
        "BlindedBeaconBlockBodyCapella",
        altair_body_fields
        + [
            ("execution_payload_header", capella.ExecutionPayloadHeader),
            ("bls_to_execution_changes", _L(t.SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)),
        ],
    )
    capella.BlindedBeaconBlock = _C(
        "BlindedBeaconBlockCapella",
        blinded_block_prefix + [("body", capella.BlindedBeaconBlockBody)],
    )
    capella.SignedBlindedBeaconBlock = _C(
        "SignedBlindedBeaconBlockCapella",
        [("message", capella.BlindedBeaconBlock), ("signature", B96)],
    )
    capella.LightClientHeader = _C(
        "LightClientHeaderCapella",
        [
            ("beacon", t.BeaconBlockHeader),
            ("execution", capella.ExecutionPayloadHeader),
            ("execution_branch", _V(B32, 4)),
        ],
    )
    t.capella = capella

    # --- deneb ---
    # NOTE: the reference v1.8.0 implements the EARLY EIP-4844 spec — one
    # `excess_data_gas: uint256` field (deneb/sszTypes.ts:120-134), not the
    # final `blob_gas_used`/`excess_blob_gas` pair. Parity follows the
    # reference.
    deneb = SimpleNamespace()
    deneb.ExecutionPayload = _C(
        "ExecutionPayloadDeneb",
        payload_prefix
        + [
            ("transactions", transactions),
            ("withdrawals", withdrawals),
            ("excess_data_gas", u256),
        ],
    )
    deneb.ExecutionPayloadHeader = _C(
        "ExecutionPayloadHeaderDeneb",
        payload_prefix
        + [
            ("transactions_root", B32),
            ("withdrawals_root", B32),
            ("excess_data_gas", u256),
        ],
    )
    deneb_body_fields = altair_body_fields + [
        ("execution_payload", deneb.ExecutionPayload),
        ("bls_to_execution_changes", _L(t.SignedBLSToExecutionChange, p.MAX_BLS_TO_EXECUTION_CHANGES)),
        ("blob_kzg_commitments", _L(B48, p.MAX_BLOBS_PER_BLOCK)),
    ]
    deneb.BeaconBlockBody = _C("BeaconBlockBodyDeneb", list(deneb_body_fields))
    deneb.BeaconBlock = _C(
        "BeaconBlockDeneb",
        [
            ("slot", u64),
            ("proposer_index", u64),
            ("parent_root", B32),
            ("state_root", B32),
            ("body", deneb.BeaconBlockBody),
        ],
    )
    deneb.SignedBeaconBlock = _C(
        "SignedBeaconBlockDeneb", [("message", deneb.BeaconBlock), ("signature", B96)]
    )
    deneb.BeaconState = _C(
        "BeaconStateDeneb",
        phase0_state_prefix
        + altair_state_mid
        + phase0_state_suffix
        + altair_state_tail
        + [
            ("latest_execution_payload_header", deneb.ExecutionPayloadHeader),
            ("next_withdrawal_index", u64),
            ("next_withdrawal_validator_index", u64),
            ("historical_summaries", _L(t.HistoricalSummary, p.HISTORICAL_ROOTS_LIMIT)),
        ],
    )
    t.Blob = ssz.ByteVector(p.FIELD_ELEMENTS_PER_BLOB * 32)
    t.BlobSidecar = _C(
        "BlobSidecar",
        [
            ("block_root", B32),
            ("index", u64),
            ("slot", u64),
            ("block_parent_root", B32),
            ("proposer_index", u64),
            ("blob", t.Blob),
            ("kzg_commitment", B48),
            ("kzg_proof", B48),
        ],
    )
    deneb.BlobSidecar = t.BlobSidecar
    deneb.SignedBlobSidecar = _C(
        "SignedBlobSidecar", [("message", t.BlobSidecar), ("signature", B96)]
    )
    deneb.BlindedBlobSidecar = _C(
        "BlindedBlobSidecar",
        [
            ("block_root", B32),
            ("index", u64),
            ("slot", u64),
            ("block_parent_root", B32),
            ("proposer_index", u64),
            ("blob_root", B32),
            ("kzg_commitment", B48),
            ("kzg_proof", B48),
        ],
    )
    deneb.SignedBlindedBlobSidecar = _C(
        "SignedBlindedBlobSidecar", [("message", deneb.BlindedBlobSidecar), ("signature", B96)]
    )
    blobs = _L(t.Blob, p.MAX_BLOBS_PER_BLOCK)
    deneb.BlobsAndCommitments = _C(
        "BlobsAndCommitments",
        [("blobs", blobs), ("kzg_commitments", _L(B48, p.MAX_BLOBS_PER_BLOCK))],
    )
    deneb.PolynomialAndCommitment = _C(
        "PolynomialAndCommitment",
        [("polynomial", _L(B32, p.FIELD_ELEMENTS_PER_BLOB)), ("kzg_commitment", B48)],
    )
    deneb.BlobIdentifier = _C("BlobIdentifier", [("block_root", B32), ("index", u64)])
    deneb.BlobSidecarsByRangeRequest = _C(
        "BlobSidecarsByRangeRequest", [("start_slot", u64), ("count", u64)]
    )
    deneb.BlobsSidecarsByRangeRequest = _C(
        "BlobsSidecarsByRangeRequest", [("start_slot", u64), ("count", u64)]
    )
    # pre-migration coupled-sidecar containers the reference still carries
    deneb.BlobsSidecar = _C(
        "BlobsSidecar",
        [
            ("beacon_block_root", B32),
            ("beacon_block_slot", u64),
            ("blobs", blobs),
            ("kzg_aggregated_proof", B48),
        ],
    )
    deneb.SignedBeaconBlockAndBlobsSidecar = _C(
        "SignedBeaconBlockAndBlobsSidecar",
        [("beacon_block", deneb.SignedBeaconBlock), ("blobs_sidecar", deneb.BlobsSidecar)],
    )
    deneb.BuilderBid = _C(
        "BuilderBidDeneb",
        [
            ("header", deneb.ExecutionPayloadHeader),
            ("value", u256),
            ("pubkey", B48),
            ("blob_kzg_commitments", _L(B48, p.MAX_BLOBS_PER_BLOCK)),
        ],
    )
    deneb.SignedBuilderBid = _C(
        "SignedBuilderBidDeneb", [("message", deneb.BuilderBid), ("signature", B96)]
    )
    # NOTE: mirrors the reference v1.8.0 declaration (deneb/sszTypes.ts:233),
    # which spreads the FULL BeaconBlockBody (including execution_payload)
    # and appends the header — a quirk of the in-progress deneb code there;
    # parity keeps it byte-identical.
    deneb.BlindedBeaconBlockBody = _C(
        "BlindedBeaconBlockBodyDeneb",
        deneb_body_fields + [("execution_payload_header", deneb.ExecutionPayloadHeader)],
    )
    deneb.BlindedBeaconBlock = _C(
        "BlindedBeaconBlockDeneb",
        blinded_block_prefix + [("body", deneb.BlindedBeaconBlockBody)],
    )
    deneb.SignedBlindedBeaconBlock = _C(
        "SignedBlindedBeaconBlockDeneb",
        [("message", deneb.BlindedBeaconBlock), ("signature", B96)],
    )
    deneb.LightClientHeader = _C(
        "LightClientHeaderDeneb",
        [
            ("beacon", t.BeaconBlockHeader),
            ("execution", deneb.ExecutionPayloadHeader),
            ("execution_branch", _V(B32, 4)),
        ],
    )
    t.deneb = deneb

    t.forks = {
        "phase0": phase0,
        "altair": altair,
        "bellatrix": bellatrix,
        "capella": capella,
        "deneb": deneb,
    }
    return t
