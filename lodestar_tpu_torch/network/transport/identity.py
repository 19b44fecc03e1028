"""libp2p identity: ed25519 keys and peer ids.

Reference peers are identified by a libp2p PeerId — the multihash of the
protobuf-encoded public key, printed base58btc (js-libp2p
`@libp2p/peer-id`). Ed25519 keys use the identity multihash (the key is
small enough to embed verbatim).

The port of `lodestar_tpu.network.transport.identity` (host Python, as there).
"""

from __future__ import annotations

import hashlib

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

__all__ = ["Identity", "peer_id_from_pubkey", "b58encode", "b58decode"]

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58encode(data: bytes) -> str:
    """base58btc (the PeerId text encoding)."""
    n = int.from_bytes(data, "big")
    out = ""
    while n:
        n, rem = divmod(n, 58)
        out = _ALPHABET[rem] + out
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + out


def b58decode(text: str) -> bytes:
    n = 0
    for ch in text:
        n = n * 58 + _ALPHABET.index(ch)
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for ch in text:
        if ch == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw


def _pubkey_protobuf(raw32: bytes) -> bytes:
    """libp2p PublicKey protobuf: {KeyType Type=1 (Ed25519=1), bytes Data=2}."""
    return b"\x08\x01\x12\x20" + raw32


def peer_id_from_pubkey(raw32: bytes) -> str:
    """Ed25519 peer id: identity multihash (0x00) of the protobuf key,
    base58btc."""
    pb = _pubkey_protobuf(raw32)
    if len(pb) <= 42:
        mh = b"\x00" + bytes([len(pb)]) + pb  # identity multihash
    else:
        mh = b"\x12\x20" + hashlib.sha256(pb).digest()  # sha2-256 multihash
    return b58encode(mh)


class Identity:
    """A node's ed25519 identity keypair + derived peer id."""

    def __init__(self, private_key: Ed25519PrivateKey | None = None):
        self.key = private_key or Ed25519PrivateKey.generate()
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        self.pubkey_raw = self.key.public_key().public_bytes(
            Encoding.Raw, PublicFormat.Raw
        )
        self.peer_id = peer_id_from_pubkey(self.pubkey_raw)

    @classmethod
    def from_seed(cls, seed32: bytes) -> "Identity":
        return cls(Ed25519PrivateKey.from_private_bytes(seed32))

    def sign(self, data: bytes) -> bytes:
        return self.key.sign(data)

    def pubkey_protobuf(self) -> bytes:
        return _pubkey_protobuf(self.pubkey_raw)


def verify_identity_sig(pubkey_pb: bytes, sig: bytes, data: bytes) -> str | None:
    """Verify `sig` over `data` with a protobuf-encoded ed25519 public
    key; returns the peer id on success, None on failure."""
    if len(pubkey_pb) != 36 or not pubkey_pb.startswith(b"\x08\x01\x12\x20"):
        return None
    raw = pubkey_pb[4:]
    try:
        Ed25519PublicKey.from_public_bytes(raw).verify(sig, data)
    except Exception:
        return None
    return peer_id_from_pubkey(raw)
