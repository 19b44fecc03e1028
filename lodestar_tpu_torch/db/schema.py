"""Bucket namespaces + key encoding (reference `db/src/schema.ts:5`,
`const.ts` BUCKET_LENGTH=1).

Bucket ids mirror the reference exactly (they are the on-disk format;
matching them keeps an eventual data-dir migration trivial). Keys are
`bucket_byte || id`, with integer ids big-endian 8-byte so lexicographic
key order == numeric order (slot-range iteration relies on this, same as
the reference's `intToBytes(key, 8, "be")`).

The port of `lodestar_tpu.db.schema` (host Python and numpy, as there).
"""

from __future__ import annotations

import enum

__all__ = ["Bucket", "BUCKET_LENGTH", "encode_key", "decode_key_id"]

BUCKET_LENGTH = 1
_UINT_LEN = 8


class Bucket(enum.IntEnum):
    # beacon chain
    allForks_stateArchive = 0  # Slot -> BeaconState (Root->Slot in index_stateArchiveRootIndex)
    allForks_block = 1  # Root -> SignedBeaconBlock
    allForks_blockArchive = 2  # Slot -> SignedBeaconBlock
    index_blockArchiveParentRootIndex = 3  # parent Root -> Slot
    index_blockArchiveRootIndex = 4  # Root -> Slot
    index_mainChain = 6  # Slot -> Root
    index_chainInfo = 7  # Key -> misc
    # eth1
    phase0_eth1Data = 8  # timestamp -> Eth1Data
    index_depositDataRoot = 9  # depositIndex -> Root<DepositData>
    phase0_depositEvent = 19  # depositIndex -> DepositEvent
    phase0_preGenesisState = 30
    phase0_preGenesisStateLastProcessedBlock = 31
    # op pool
    phase0_exit = 13  # ValidatorIndex -> SignedVoluntaryExit
    phase0_proposerSlashing = 14  # ValidatorIndex -> ProposerSlashing
    phase0_attesterSlashing = 15  # Root -> AttesterSlashing
    capella_blsToExecutionChange = 16  # ValidatorIndex -> SignedBLSToExecutionChange
    # validator slashing protection
    phase0_slashingProtectionBlockBySlot = 20
    phase0_slashingProtectionAttestationByTarget = 21
    phase0_slashingProtectionAttestationLowerBound = 22
    index_slashingProtectionMinSpanDistance = 23
    index_slashingProtectionMaxSpanDistance = 24
    index_stateArchiveRootIndex = 26  # State Root -> Slot
    allForks_blobSidecars = 27  # BlockRoot -> BlobSidecars
    allForks_blobSidecarsArchive = 28  # Slot -> BlobSidecars
    # lodestar-specific
    allForks_blobsSidecar = 29  # pre-migration coupled sidecars
    phase0_candidateBlock = 32
    # light client
    lightClient_syncCommitteeWitness = 51
    lightClient_syncCommittee = 52
    lightClient_checkpointHeader = 54
    lightClient_bestLightClientUpdate = 55
    # backfill
    backfilled_ranges = 42


def encode_key(bucket: Bucket, id_: bytes | str | int) -> bytes:
    if isinstance(id_, str):
        body = id_.encode()
    elif isinstance(id_, int):
        body = id_.to_bytes(_UINT_LEN, "big")
    else:
        body = bytes(id_)
    return int(bucket).to_bytes(BUCKET_LENGTH, "little") + body


def decode_key_id(key: bytes) -> bytes:
    """Strip the bucket prefix; caller interprets the id bytes."""
    return key[BUCKET_LENGTH:]
