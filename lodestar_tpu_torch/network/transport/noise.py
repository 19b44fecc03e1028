"""Noise XX secure channel — Noise_XX_25519_ChaChaPoly_SHA256.

The security transport the reference configures in
`network/nodejs/noise.ts` (js-libp2p `@chainsafe/libp2p-noise`), built on
the Noise Protocol Framework spec (rev 34) + the libp2p-noise spec:

* handshake pattern XX (mutual, identity-hiding), DH = X25519,
  cipher = ChaCha20-Poly1305, hash = SHA-256
* wire: every noise message is prefixed with a 2-byte big-endian length
* the handshake payload (messages 2 and 3) carries the libp2p identity
  binding: a protobuf {identity_key, identity_sig} where the signature
  covers b"noise-libp2p-static-key:" + the sender's static x25519 key —
  proving the ephemeral channel belongs to the claimed PeerId
* after the handshake, `NoiseConnection` frames every payload as
  2-byte length + AEAD ciphertext with an 8-byte little-endian counter
  nonce per direction

The port of `lodestar_tpu.network.transport.noise` (host Python, as there).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as hmac_mod

from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

from .identity import Identity, verify_identity_sig

__all__ = ["NoiseConnection", "noise_handshake", "NoiseError"]

PROTOCOL_NAME = b"Noise_XX_25519_ChaChaPoly_SHA256"
SIG_PREFIX = b"noise-libp2p-static-key:"
MAX_NOISE_MSG = 65535


class NoiseError(Exception):
    pass


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _hmac(key: bytes, data: bytes) -> bytes:
    return hmac_mod.new(key, data, hashlib.sha256).digest()


def _hkdf2(ck: bytes, ikm: bytes) -> tuple[bytes, bytes]:
    temp = _hmac(ck, ikm)
    out1 = _hmac(temp, b"\x01")
    out2 = _hmac(temp, out1 + b"\x02")
    return out1, out2


def _nonce(n: int) -> bytes:
    return b"\x00" * 4 + n.to_bytes(8, "little")


class _CipherState:
    def __init__(self, key: bytes | None = None):
        self.key = key
        self.n = 0

    def encrypt(self, ad: bytes, plaintext: bytes) -> bytes:
        if self.key is None:
            return plaintext
        out = ChaCha20Poly1305(self.key).encrypt(_nonce(self.n), plaintext, ad)
        self.n += 1
        return out

    def decrypt(self, ad: bytes, ciphertext: bytes) -> bytes:
        if self.key is None:
            return ciphertext
        try:
            out = ChaCha20Poly1305(self.key).decrypt(_nonce(self.n), ciphertext, ad)
        except Exception as e:
            raise NoiseError(f"AEAD decrypt failed: {e}") from e
        self.n += 1
        return out


class _SymmetricState:
    def __init__(self):
        self.h = PROTOCOL_NAME  # len == 32 already
        self.ck = self.h
        self.cs = _CipherState()

    def mix_hash(self, data: bytes) -> None:
        self.h = _sha256(self.h + data)

    def mix_key(self, ikm: bytes) -> None:
        self.ck, temp_k = _hkdf2(self.ck, ikm)
        self.cs = _CipherState(temp_k)

    def encrypt_and_hash(self, plaintext: bytes) -> bytes:
        out = self.cs.encrypt(self.h, plaintext)
        self.mix_hash(out)
        return out

    def decrypt_and_hash(self, ciphertext: bytes) -> bytes:
        out = self.cs.decrypt(self.h, ciphertext)
        self.mix_hash(ciphertext)
        return out

    def split(self) -> tuple[_CipherState, _CipherState]:
        k1, k2 = _hkdf2(self.ck, b"")
        return _CipherState(k1), _CipherState(k2)


def _dh(priv: X25519PrivateKey, pub_raw: bytes) -> bytes:
    return priv.exchange(X25519PublicKey.from_public_bytes(pub_raw))


def _pub_raw(priv: X25519PrivateKey) -> bytes:
    return priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)


# --- libp2p handshake payload protobuf ---------------------------------------


def _encode_payload(identity: Identity, static_pub: bytes) -> bytes:
    sig = identity.sign(SIG_PREFIX + static_pub)
    key_pb = identity.pubkey_protobuf()
    return (
        b"\x0a" + bytes([len(key_pb)]) + key_pb + b"\x12" + bytes([len(sig)]) + sig
    )


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _decode_payload(data: bytes) -> tuple[bytes, bytes]:
    key = sig = b""
    pos = 0
    try:
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            field, wt = tag >> 3, tag & 7
            if wt != 2:
                raise NoiseError("unexpected wire type in handshake payload")
            ln, pos = _read_varint(data, pos)
            val = data[pos : pos + ln]
            pos += ln
            if field == 1:
                key = val
            elif field == 2:
                sig = val
    except IndexError as e:  # truncated varint/field from a hostile peer
        raise NoiseError("malformed handshake payload") from e
    return key, sig


# --- wire framing -------------------------------------------------------------


async def _read_msg(reader: asyncio.StreamReader) -> bytes:
    ln = int.from_bytes(await reader.readexactly(2), "big")
    return await reader.readexactly(ln)


def _write_msg(writer: asyncio.StreamWriter, data: bytes) -> None:
    if len(data) > MAX_NOISE_MSG:
        raise NoiseError("noise message too large")
    writer.write(len(data).to_bytes(2, "big") + data)


# --- the XX handshake ---------------------------------------------------------


async def noise_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    identity: Identity,
    *,
    initiator: bool,
    expected_peer: str | None = None,
) -> "NoiseConnection":
    """Run XX, verify the identity payload, return the secured connection.

    XX message sequence:  -> e   <- e, ee, s, es   -> s, se
    """
    ss = _SymmetricState()
    ss.mix_hash(b"")  # empty prologue
    e = X25519PrivateKey.generate()
    s = X25519PrivateKey.generate()  # per-connection static key (identity binds it)
    payload = _encode_payload(identity, _pub_raw(s))
    remote_payload = b""

    if initiator:
        # -> e
        ss.mix_hash(_pub_raw(e))
        ss.mix_hash(b"")  # empty payload, no key yet
        _write_msg(writer, _pub_raw(e))
        await writer.drain()
        # <- e, ee, s, es
        msg = await _read_msg(reader)
        if len(msg) < 32 + 48:
            raise NoiseError("short handshake message 2")
        re = msg[:32]
        ss.mix_hash(re)
        ss.mix_key(_dh(e, re))
        enc_rs = msg[32 : 32 + 48]
        rs = ss.decrypt_and_hash(enc_rs)
        ss.mix_key(_dh(e, rs))
        remote_payload = ss.decrypt_and_hash(msg[32 + 48 :])
        # -> s, se
        enc_s = ss.encrypt_and_hash(_pub_raw(s))
        ss.mix_key(_dh(s, re))
        enc_payload = ss.encrypt_and_hash(payload)
        _write_msg(writer, enc_s + enc_payload)
        await writer.drain()
        send_cs, recv_cs = ss.split()
    else:
        # <- e
        msg = await _read_msg(reader)
        if len(msg) < 32:
            raise NoiseError("short handshake message 1")
        re = msg[:32]
        ss.mix_hash(re)
        ss.mix_hash(msg[32:])  # initiator's (empty) cleartext payload
        # -> e, ee, s, es
        ss.mix_hash(_pub_raw(e))
        ss.mix_key(_dh(e, re))
        enc_s = ss.encrypt_and_hash(_pub_raw(s))
        ss.mix_key(_dh(s, re))
        enc_payload = ss.encrypt_and_hash(payload)
        _write_msg(writer, _pub_raw(e) + enc_s + enc_payload)
        await writer.drain()
        # <- s, se
        msg = await _read_msg(reader)
        if len(msg) < 48:
            raise NoiseError("short handshake message 3")
        rs = ss.decrypt_and_hash(msg[:48])
        ss.mix_key(_dh(e, rs))
        remote_payload = ss.decrypt_and_hash(msg[48:])
        recv_cs, send_cs = ss.split()

    key_pb, sig = _decode_payload(remote_payload)
    remote_peer = verify_identity_sig(key_pb, sig, SIG_PREFIX + rs)
    if remote_peer is None:
        raise NoiseError("invalid identity signature in handshake payload")
    if expected_peer is not None and remote_peer != expected_peer:
        raise NoiseError(f"peer id mismatch: got {remote_peer}, want {expected_peer}")
    return NoiseConnection(reader, writer, send_cs, recv_cs, remote_peer)


class NoiseConnection:
    """Post-handshake AEAD channel: read_msg/write_msg move whole noise
    frames (<= 65519 plaintext bytes each; callers chunk above that)."""

    MAX_PLAINTEXT = MAX_NOISE_MSG - 16

    def __init__(self, reader, writer, send_cs, recv_cs, remote_peer: str):
        self._reader = reader
        self._writer = writer
        self._send = send_cs
        self._recv = recv_cs
        self.remote_peer = remote_peer

    async def read_msg(self) -> bytes:
        frame = await _read_msg(self._reader)
        return self._recv.decrypt(b"", frame)

    async def write_msg(self, data: bytes) -> None:
        for i in range(0, max(len(data), 1), self.MAX_PLAINTEXT):
            _write_msg(self._writer, self._send.encrypt(b"", data[i : i + self.MAX_PLAINTEXT]))
        await self._writer.drain()

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass
