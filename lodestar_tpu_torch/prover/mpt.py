"""Execution-layer proof primitives: keccak-256, RLP, and
Merkle-Patricia-trie proof verification.

The reference prover leans on @ethereumjs/trie + ethereum-cryptography
(`prover/src/utils/validation.ts`: `Trie.verifyProof` against the
execution payload's stateRoot). This is a from-scratch implementation of
the same public algorithms (Keccak-f[1600] per FIPS-202 pre-standard
padding 0x01, RLP per the Ethereum yellow paper appendix B, and the
secure-trie proof walk): no EL dependencies exist in this image.

Host-side by design — proof verification is a few dozen hashes over
~kB inputs; there is nothing for the device here.

The port of `lodestar_tpu.prover.mpt` (host Python, as there).
"""

from __future__ import annotations

__all__ = [
    "keccak256",
    "rlp_encode",
    "rlp_decode",
    "verify_mpt_proof",
    "MptError",
]


# --- keccak-256 ---------------------------------------------------------------

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
        # iota
        state[0] ^= rc


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (the pre-NIST padding Ethereum uses: 0x01, not SHA3's
    0x06)."""
    rate = 136  # bytes, for 256-bit output
    state = [0] * 25
    data = bytes(data)
    # absorb
    padded = bytearray(data)
    pad_len = rate - (len(data) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(state)
    # squeeze (256 bits fits in one rate block)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


# --- RLP ----------------------------------------------------------------------


class MptError(Exception):
    pass


def rlp_encode(item) -> bytes:
    """RLP: item is bytes or a (recursively) nested list of items."""
    if isinstance(item, (bytes, bytearray)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _rlp_len_prefix(len(b), 0x80) + b
    if isinstance(item, list):
        payload = b"".join(rlp_encode(x) for x in item)
        return _rlp_len_prefix(len(payload), 0xC0) + payload
    if isinstance(item, int):  # canonical big-endian, no leading zeros
        if item == 0:
            return b"\x80"
        return rlp_encode(item.to_bytes((item.bit_length() + 7) // 8, "big"))
    raise MptError(f"cannot RLP-encode {type(item)}")


def _rlp_len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    len_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(len_bytes)]) + len_bytes


def rlp_decode(data: bytes):
    """Full decode; raises MptError on trailing bytes or malformed input."""
    item, rest = _rlp_decode_item(bytes(data))
    if rest:
        raise MptError("trailing bytes after RLP item")
    return item


def _rlp_decode_item(data: bytes):
    if not data:
        raise MptError("empty RLP input")
    prefix = data[0]
    if prefix < 0x80:
        return data[:1], data[1:]
    if prefix <= 0xB7:
        length = prefix - 0x80
        if len(data) < 1 + length:
            raise MptError("short RLP string")
        if length == 1 and data[1] < 0x80:
            raise MptError("non-canonical single byte")
        return data[1 : 1 + length], data[1 + length :]
    if prefix <= 0xBF:
        len_len = prefix - 0xB7
        if len(data) < 1 + len_len:
            raise MptError("short RLP length")
        length = int.from_bytes(data[1 : 1 + len_len], "big")
        if length < 56:
            raise MptError("non-canonical long length")
        if len(data) < 1 + len_len + length:
            raise MptError("short RLP string")
        start = 1 + len_len
        return data[start : start + length], data[start + length :]
    # list
    if prefix <= 0xF7:
        length = prefix - 0xC0
        len_len = 0
    else:
        len_len = prefix - 0xF7
        if len(data) < 1 + len_len:
            raise MptError("short RLP list length")
        length = int.from_bytes(data[1 : 1 + len_len], "big")
        if length < 56:
            raise MptError("non-canonical long list length")
    start = 1 + len_len
    if len(data) < start + length:
        raise MptError("short RLP list")
    payload = data[start : start + length]
    items = []
    while payload:
        item, payload = _rlp_decode_item(payload)
        items.append(item)
    return items, data[start + length :]


# --- Merkle-Patricia proof walk ----------------------------------------------


def _nibbles(key: bytes) -> list[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return out


def _decode_hp(path: bytes) -> tuple[list[int], bool]:
    """Hex-prefix decode -> (nibbles, is_leaf)."""
    if not path:
        raise MptError("empty HP path")
    flag = path[0] >> 4
    is_leaf = flag >= 2
    nibs = _nibbles(path)
    # drop the flag nibble, and the padding nibble when even-length
    nibs = nibs[2:] if flag in (0, 2) else nibs[1:]
    return nibs, is_leaf


def verify_mpt_proof(root: bytes, key: bytes, proof: list[bytes]) -> bytes | None:
    """Walk an eth_getProof-style node list from `root` along
    keccak256(key)... no — along `key` itself (callers pass the hashed
    key for secure tries). Returns the value, or None for a proven
    EXCLUSION. Raises MptError when the proof doesn't link to the root.
    """
    nodes_by_hash = {keccak256(n): bytes(n) for n in proof}
    expected = bytes(root)
    path = _nibbles(key)

    while True:
        node_raw = nodes_by_hash.get(expected)
        if node_raw is None:
            raise MptError("proof is missing the node for " + expected.hex())
        node = rlp_decode(node_raw)
        if not isinstance(node, list):
            raise MptError("trie node is not a list")
        if len(node) == 17:  # branch
            if not path:
                value = node[16]
                return bytes(value) if value else None
            child = node[path[0]]
            path = path[1:]
            if child == b"":
                return None  # empty slot: proven exclusion
            if isinstance(child, list):  # embedded (<32B) node
                node_raw = rlp_encode(child)
                nodes_by_hash[keccak256(node_raw)] = node_raw
                expected = keccak256(node_raw)
            else:
                if len(child) != 32:
                    raise MptError("branch child hash length != 32")
                expected = bytes(child)
        elif len(node) == 2:  # extension or leaf
            nibs, is_leaf = _decode_hp(bytes(node[0]))
            if is_leaf:
                return bytes(node[1]) if path == nibs else None
            if path[: len(nibs)] != nibs:
                return None  # path diverges: proven exclusion
            path = path[len(nibs) :]
            nxt = node[1]
            if isinstance(nxt, list):
                node_raw = rlp_encode(nxt)
                nodes_by_hash[keccak256(node_raw)] = node_raw
                expected = keccak256(node_raw)
            else:
                if len(nxt) != 32:
                    raise MptError("extension child hash length != 32")
                expected = bytes(nxt)
        else:
            raise MptError(f"bad trie node arity {len(node)}")
