"""Deneb (EIP-4844, early spec) state transition: blob KZG commitments.

Reference v1.8.0 implements the EARLY 4844 spec (see the deneb note in
`types`): the payload carries one `excess_data_gas` uint256
and blob-carrying transactions are SSZ `SignedBlobTransaction`s whose
versioned hashes sit at a fixed offset (reference
`state-transition/src/util/blobs.ts:20-21`). Parity follows the
reference, not the final mainnet deneb.

The port of `lodestar_tpu.state_transition.deneb` (host Python and numpy, as there).
"""

from __future__ import annotations

import hashlib

from lodestar_tpu_torch.params import BeaconPreset

from .block import BlockProcessError

__all__ = [
    "BLOB_TX_TYPE",
    "VERSIONED_HASH_VERSION_KZG",
    "kzg_commitment_to_versioned_hash",
    "tx_peek_blob_versioned_hashes",
    "verify_kzg_commitments_against_transactions",
    "process_blob_kzg_commitments",
    "upgrade_to_deneb",
]

BLOB_TX_TYPE = 0x03
VERSIONED_HASH_VERSION_KZG = 0x01

# SignedBlobTransaction layout constants (reference blobs.ts:20-21)
OPAQUE_TX_MESSAGE_OFFSET = 70
OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET = OPAQUE_TX_MESSAGE_OFFSET + 188
_BYTES_PER_HASH = 32


def kzg_commitment_to_versioned_hash(commitment: bytes) -> bytes:
    digest = bytearray(hashlib.sha256(bytes(commitment)).digest())
    digest[0] = VERSIONED_HASH_VERSION_KZG
    return bytes(digest)


def tx_peek_blob_versioned_hashes(tx: bytes) -> list[bytes]:
    """Read blob_versioned_hashes out of an opaque SignedBlobTransaction
    without full deserialization (reference txPeekBlobVersionedHashes,
    blobs.ts:59)."""
    tx = bytes(tx)
    if not tx or tx[0] != BLOB_TX_TYPE:
        raise BlockProcessError(f"tx type {tx[0] if tx else None} != BLOB_TX_TYPE")
    if len(tx) < OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET + 4:
        raise BlockProcessError("blob tx too short for versioned-hash offset")
    rel = int.from_bytes(
        tx[OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET : OPAQUE_TX_BLOB_VERSIONED_HASHES_OFFSET + 4],
        "little",
    )
    start = OPAQUE_TX_MESSAGE_OFFSET + rel
    if start > len(tx):
        raise BlockProcessError("blob versioned-hash offset beyond tx end")
    if (len(tx) - start) % _BYTES_PER_HASH != 0:
        raise BlockProcessError("blob versioned-hash region not a multiple of 32")
    return [tx[i : i + _BYTES_PER_HASH] for i in range(start, len(tx), _BYTES_PER_HASH)]


def verify_kzg_commitments_against_transactions(transactions, commitments) -> bool:
    """Cheap consistency check: versioned hashes embedded in blob txs
    must equal hash(commitment) with the KZG version byte (reference
    verifyKzgCommitmentsAgainstTransactions, blobs.ts:29)."""
    all_hashes: list[bytes] = []
    for tx in transactions:
        tx = bytes(tx)
        if tx and tx[0] == BLOB_TX_TYPE:
            all_hashes.extend(tx_peek_blob_versioned_hashes(tx))
    if len(all_hashes) != len(commitments):
        raise BlockProcessError(
            f"versioned hashes ({len(all_hashes)}) != kzg commitments ({len(commitments)})"
        )
    for i, commitment in enumerate(commitments):
        if all_hashes[i] != kzg_commitment_to_versioned_hash(bytes(commitment)):
            raise BlockProcessError(f"wrong versioned hash at index {i}")
    return True


def process_blob_kzg_commitments(body) -> None:
    verify_kzg_commitments_against_transactions(
        list(body.execution_payload.transactions), list(body.blob_kzg_commitments)
    )


# --- fork upgrade -------------------------------------------------------------


def upgrade_to_deneb(pre, cfg, p: BeaconPreset):
    """Spec (early-4844) upgrade_to_deneb: capella fields carry over; the
    payload header gains excess_data_gas=0 (reference
    `slot/upgradeStateToDeneb.ts`)."""
    from .bellatrix import carry_state_upgrade

    return carry_state_upgrade(
        pre,
        cfg,
        p,
        src_fork="capella",
        dst_fork="deneb",
        fallback_version=b"\x04\x00\x00\x00",
        carry_header=True,  # excess_data_gas stays 0
    )
