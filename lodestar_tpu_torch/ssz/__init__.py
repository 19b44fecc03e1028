"""SSZ: serialization, merkleization and type schemas, with large merkle
levels hashed on the device.

The port of `lodestar_tpu.ssz`: schemas and host logic are copies of the
JAX package's pure-Python modules; large merkle levels go to the device
through `ssz.device_htr` and `ops.sha256` (PyTorch).
"""

from .device_htr import HTR_MODES, configure_device_htr, device_htr_active
from .hash import ZERO_HASHES, hash_nodes, sha256_digest
from .merkle import (
    merkle_branch,
    merkleize,
    mix_in_length,
    next_pow_of_two,
    pack_bytes,
    verify_merkle_branch,
)
from .types import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    ByteVector,
    Container,
    ContainerValue,
    List,
    SSZType,
    Uint,
    Vector,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)

__all__ = [
    "HTR_MODES",
    "configure_device_htr",
    "device_htr_active",
    "ZERO_HASHES",
    "hash_nodes",
    "sha256_digest",
    "merkle_branch",
    "merkleize",
    "mix_in_length",
    "next_pow_of_two",
    "pack_bytes",
    "verify_merkle_branch",
    "Bitlist",
    "Bitvector",
    "Boolean",
    "ByteList",
    "Bytes4",
    "Bytes20",
    "Bytes32",
    "Bytes48",
    "Bytes96",
    "ByteVector",
    "Container",
    "ContainerValue",
    "List",
    "SSZType",
    "Uint",
    "Vector",
    "boolean",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "uint128",
    "uint256",
]
