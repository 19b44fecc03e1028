"""SSZ merkleization: chunking, padded merkle roots, length mix-ins.

Implements the consensus-spec merkleization primitives (`merkleize`,
`mix_in_length`) over the backend-selecting level hasher in
`ssz.hash`. Counterpart of `@chainsafe/persistent-merkle-tree`'s
subtree hashing consumed via `@chainsafe/ssz` (reference
`packages/types/src/sszTypes.ts` → ViewDU hashTreeRoot).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .hash import ZERO_HASHES, hash_nodes


def next_pow_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize(chunks: np.ndarray | bytes, limit: int | None = None) -> bytes:
    """Merkle root of 32-byte chunks padded (virtually) to `limit` leaves.

    chunks: (N, 32) uint8 array or concatenated bytes. limit=None pads to
    next_pow_of_two(N) (the SSZ vector rule); an explicit limit is the SSZ
    list rule. Zero-padding above the real data is folded in via the
    precomputed zero-subtree ladder, so cost scales with N, not limit.
    """
    if isinstance(chunks, (bytes, bytearray)):
        chunks = np.frombuffer(bytes(chunks), dtype=np.uint8).reshape(-1, 32)
    count = chunks.shape[0]
    if limit is None:
        limit = next_pow_of_two(count)
    elif count > limit:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    depth = (next_pow_of_two(limit) - 1).bit_length()
    if count == 0:
        return ZERO_HASHES[depth]
    level = chunks
    for d in range(depth):
        if level.shape[0] == 1:
            # lone node: fold up with zero subtrees for the remaining depth
            node = level[0].tobytes()
            for dd in range(d, depth):
                node = hashlib.sha256(node + ZERO_HASHES[dd]).digest()
            return node
        if level.shape[0] % 2:
            pad = np.frombuffer(ZERO_HASHES[d], dtype=np.uint8).reshape(1, 32)
            level = np.concatenate([level, pad], axis=0)
        level = hash_nodes(level)
    return level[0].tobytes()


def mix_in_length(root: bytes, length: int) -> bytes:
    return hashlib.sha256(root + length.to_bytes(32, "little")).digest()


def pack_bytes(data: bytes) -> np.ndarray:
    """Right-pad bytes to a 32-byte boundary and view as chunks."""
    r = len(data) % 32
    if r:
        data = data + b"\x00" * (32 - r)
    return np.frombuffer(data, dtype=np.uint8).reshape(-1, 32)


def merkle_branch(chunks: np.ndarray | bytes, index: int, limit: int | None = None) -> list[bytes]:
    """Merkle proof (sibling path bottom-up) for chunk `index`.

    Used by the light-client server for state-field proofs (reference
    `packages/beacon-node/src/chain/lightClient/proofs.ts`).
    """
    if isinstance(chunks, (bytes, bytearray)):
        chunks = np.frombuffer(bytes(chunks), dtype=np.uint8).reshape(-1, 32)
    count = chunks.shape[0]
    if limit is None:
        limit = next_pow_of_two(count)
    elif count > limit:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    depth = (next_pow_of_two(limit) - 1).bit_length()
    if not 0 <= index < limit:
        raise IndexError("chunk index out of range")
    # Invariant: `level` holds the real nodes at depth d; every node beyond
    # is a virtual zero subtree whose root is ZERO_HASHES[d].
    proof = []
    level = chunks
    idx = index
    for d in range(depth):
        sib = idx ^ 1
        if sib < level.shape[0]:
            proof.append(level[sib].tobytes())
        else:
            proof.append(ZERO_HASHES[d])
        if level.shape[0] % 2:
            pad = np.frombuffer(ZERO_HASHES[d], dtype=np.uint8).reshape(1, 32)
            level = np.concatenate([level, pad], axis=0)
        level = hash_nodes(level)
        idx >>= 1
    return proof


def verify_merkle_branch(leaf: bytes, proof: list[bytes], index: int, root: bytes) -> bool:
    """Check a bottom-up sibling path (reference `packages/utils/src/verifyMerkleBranch.ts`)."""
    node = leaf
    for d, sib in enumerate(proof):
        if (index >> d) & 1:
            node = hashlib.sha256(sib + node).digest()
        else:
            node = hashlib.sha256(node + sib).digest()
    return node == root
