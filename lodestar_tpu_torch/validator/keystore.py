"""EIP-2335 BLS keystores (encrypt/decrypt validator signing keys).

Reference `cli/src/cmds/validator/keymanager/` stores keys as EIP-2335
JSON (scrypt or pbkdf2 KDF + AES-128-CTR + sha256 checksum). hashlib
provides both KDFs; AES-128-CTR is implemented here directly over
hashlib-free primitives (pure-Python AES, acceptable for the small
32-byte payloads keystores carry).

The port of `lodestar_tpu.validator.keystore`, with its imports rewritten.
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid

__all__ = ["encrypt_keystore", "decrypt_keystore", "KeystoreError"]


class KeystoreError(Exception):
    pass


# --- minimal AES-128 (encrypt-only; CTR needs just the forward cipher) -------

_SBOX = None


def _build_sbox():
    global _SBOX
    if _SBOX is not None:
        return
    p = q = 1
    sbox = [0] * 256
    while True:
        # multiply p by 3
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        # divide q by 3
        q ^= (q << 1) & 0xFF
        q ^= (q << 2) & 0xFF
        q ^= (q << 4) & 0xFF
        if q & 0x80:
            q ^= 0x09
        x = q ^ ((q << 1) | (q >> 7)) & 0xFF ^ ((q << 2) | (q >> 6)) & 0xFF \
            ^ ((q << 3) | (q >> 5)) & 0xFF ^ ((q << 4) | (q >> 4)) & 0xFF
        sbox[p] = (x ^ 0x63) & 0xFF
        if p == 1:
            break
    sbox[0] = 0x63
    _SBOX = sbox


def _xtime(a: int) -> int:
    return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1


def _expand_key(key: bytes) -> list[list[int]]:
    _build_sbox()
    w = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r : 4 * r + 4], []) for r in range(11)]


def _aes128_block(key_sched, block: bytes) -> bytes:
    # state is flat column-major (AES standard layout)
    state = list(block)

    def add_round_key(st, rk):
        return [a ^ b for a, b in zip(st, rk)]

    def sub_bytes(st):
        return [_SBOX[b] for b in st]

    def shift_rows(st):
        out = list(st)
        for r in range(1, 4):
            row = [st[r + 4 * c] for c in range(4)]
            row = row[r:] + row[:r]
            for c in range(4):
                out[r + 4 * c] = row[c]
        return out

    def mix_columns(st):
        out = [0] * 16
        for c in range(4):
            col = st[4 * c : 4 * c + 4]
            out[4 * c + 0] = _xtime(col[0]) ^ (_xtime(col[1]) ^ col[1]) ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ _xtime(col[1]) ^ (_xtime(col[2]) ^ col[2]) ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ _xtime(col[2]) ^ (_xtime(col[3]) ^ col[3])
            out[4 * c + 3] = (_xtime(col[0]) ^ col[0]) ^ col[1] ^ col[2] ^ _xtime(col[3])
        return out

    state = add_round_key(state, key_sched[0])
    for rnd in range(1, 10):
        state = sub_bytes(state)
        state = shift_rows(state)
        state = mix_columns(state)
        state = add_round_key(state, key_sched[rnd])
    state = sub_bytes(state)
    state = shift_rows(state)
    state = add_round_key(state, key_sched[10])
    return bytes(state)


def _aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    sched = _expand_key(key)
    out = bytearray()
    counter = int.from_bytes(iv, "big")
    for i in range(0, len(data), 16):
        ks = _aes128_block(sched, counter.to_bytes(16, "big"))
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)


# --- EIP-2335 ----------------------------------------------------------------


def _kdf(password: bytes, params: dict, kind: str) -> bytes:
    salt = bytes.fromhex(params["salt"])
    if kind == "scrypt":
        return hashlib.scrypt(
            password, salt=salt, n=params["n"], r=params["r"], p=params["p"],
            dklen=params["dklen"], maxmem=2**31 - 1,
        )
    if kind == "pbkdf2":
        return hashlib.pbkdf2_hmac("sha256", password, salt, params["c"], dklen=params["dklen"])
    raise KeystoreError(f"unsupported kdf {kind}")


def _normalize_password(password: str) -> bytes:
    import unicodedata

    norm = unicodedata.normalize("NFKD", password)
    return "".join(c for c in norm if ord(c) >= 0x20 and ord(c) != 0x7F).encode()


def encrypt_keystore(
    secret: bytes, password: str, pubkey: bytes, *, path: str = "", kdf: str = "pbkdf2"
) -> dict:
    """secret (32-byte BLS sk, big-endian) -> EIP-2335 keystore JSON dict."""
    pw = _normalize_password(password)
    salt = os.urandom(32)
    iv = os.urandom(16)
    if kdf == "scrypt":
        kdf_params = {"dklen": 32, "n": 2**14, "r": 8, "p": 1, "salt": salt.hex()}
    else:
        kdf_params = {"dklen": 32, "c": 2**18, "prf": "hmac-sha256", "salt": salt.hex()}
    dk = _kdf(pw, kdf_params, kdf)
    cipher_text = _aes128_ctr(dk[:16], iv, secret)
    checksum = hashlib.sha256(dk[16:32] + cipher_text).digest()
    return {
        "crypto": {
            "kdf": {"function": kdf, "params": kdf_params, "message": ""},
            "checksum": {"function": "sha256", "params": {}, "message": checksum.hex()},
            "cipher": {
                "function": "aes-128-ctr",
                "params": {"iv": iv.hex()},
                "message": cipher_text.hex(),
            },
        },
        "description": "",
        "pubkey": pubkey.hex(),
        "path": path,
        "uuid": str(uuid.uuid4()),
        "version": 4,
    }


def decrypt_keystore(keystore: dict, password: str) -> bytes:
    if keystore.get("version") != 4:
        raise KeystoreError("only EIP-2335 version 4 supported")
    crypto = keystore["crypto"]
    pw = _normalize_password(password)
    dk = _kdf(pw, crypto["kdf"]["params"], crypto["kdf"]["function"])
    cipher_text = bytes.fromhex(crypto["cipher"]["message"])
    checksum = hashlib.sha256(dk[16:32] + cipher_text).digest()
    if checksum.hex() != crypto["checksum"]["message"]:
        raise KeystoreError("invalid password (checksum mismatch)")
    if crypto["cipher"]["function"] != "aes-128-ctr":
        raise KeystoreError("unsupported cipher")
    iv = bytes.fromhex(crypto["cipher"]["params"]["iv"])
    return _aes128_ctr(dk[:16], iv, cipher_text)
