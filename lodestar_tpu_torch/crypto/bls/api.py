"""The parts of the BLS signature API the port needs (eth2 flavour:
minimal-pubkey-size): secret keys, signing and the signature-set work
item. Pubkeys live in G1 (48B compressed), signatures in G2 (96B
compressed), messages hash to G2.

The batch verifier on the card is ``lodestar_tpu_torch.models.batch_verify``;
`verify_signature_sets` here is the pure-Python oracle of the same check
(the single-thread verifier and the pool's `verify_on_main_thread` road).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import curve as C
from . import fields as F
from .curve import G1_GEN, g1_mul, g1_neg
from .fields import R
from .hash_to_curve import hash_to_g2
from .pairing import final_exponentiation, miller_loop
from .serdes import PointDecodeError, g1_from_bytes, g1_to_bytes, g2_from_bytes, g2_to_bytes

__all__ = ["SecretKey", "SignatureSet", "sk_to_pk", "sign", "verify_signature_sets"]


@dataclass(frozen=True)
class SecretKey:
    scalar: int

    def __post_init__(self):
        # same range contract as from_bytes: sk=0 would sign everything
        # with the infinity signature
        if not 0 < self.scalar < R:
            raise ValueError("secret key out of range (must satisfy 0 < SK < r)")

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        """Strict IETF deserialization: 32 bytes, 0 < SK < r (no reduction)."""
        if len(data) != 32:
            raise ValueError("secret key must be 32 bytes")
        k = int.from_bytes(data, "big")
        if k == 0 or k >= R:
            raise ValueError("secret key out of range (must satisfy 0 < SK < r)")
        return cls(k)

    def to_pubkey_point(self):
        return g1_mul(G1_GEN, self.scalar)

    def to_pubkey(self) -> bytes:
        return g1_to_bytes(self.to_pubkey_point())


def sk_to_pk(sk: SecretKey) -> bytes:
    return sk.to_pubkey()


def sign(sk: SecretKey, message: bytes) -> bytes:
    h = hash_to_g2(message)
    return g2_to_bytes(C.g2_mul(h, sk.scalar))


def _decode_pubkey(pk: bytes):
    """KeyValidate: decompress, reject infinity, subgroup check."""
    pt = g1_from_bytes(pk)
    if pt is None:
        raise PointDecodeError("infinity pubkey rejected (KeyValidate)")
    if not C.g1_in_subgroup(pt):
        raise PointDecodeError("pubkey not in G1 subgroup")
    return pt


def _decode_signature(sig: bytes):
    pt = g2_from_bytes(sig)
    if pt is not None and not C.g2_in_subgroup(pt):
        raise PointDecodeError("signature not in G2 subgroup")
    return pt


@dataclass(frozen=True)
class SignatureSet:
    """One verification work item: (aggregated) pubkey, signing root,
    signature — the wire shape the reference ships to its BLS worker pool
    (`packages/beacon-node/src/chain/bls/multithread/types.ts:8-17`)."""

    pubkey: bytes  # 48B compressed G1
    message: bytes  # 32B signing root
    signature: bytes  # 96B compressed G2


def _random_coeff() -> int:
    """Nonzero 64-bit blinding scalar for batch verification."""
    while True:
        k = int.from_bytes(os.urandom(8), "big")
        if k != 0:
            return k


def verify_signature_sets(sets: list[SignatureSet]) -> bool:
    """Random-linear-combination batch verification (always randomized).

    Checks e(-g1, sum_i r_i S_i) * prod_i e(r_i PK_i, H(m_i)) == 1 with one
    shared final exponentiation — the semantics of blst's
    verifyMultipleSignatures used by the reference worker
    (`packages/beacon-node/src/chain/bls/multithread/worker.ts:52-96`).
    The asymptotic ~2x win over one-by-one verification is the reference's
    own bound (`chain/bls/interface.ts:8`). There is deliberately no
    way to disable the blinding coefficients: an unrandomized batch is
    forgeable (defects in different sets can cancel).
    """
    if not sets:
        return False
    try:
        decoded = [
            (_decode_pubkey(s.pubkey), hash_to_g2(s.message), _decode_signature(s.signature))
            for s in sets
        ]
    except PointDecodeError:
        return False
    if any(sig is None for _, _, sig in decoded):
        return False
    coeffs = [1] + [_random_coeff() for _ in decoded[1:]]
    sig_acc = None
    f = F.FP12_ONE
    for (pk, h, sig), r_i in zip(decoded, coeffs):
        sig_acc = C.g2_add(sig_acc, C.g2_mul(sig, r_i))
        f = F.fp12_mul(f, miller_loop(g1_mul(pk, r_i), h))
    if sig_acc is None:
        return False
    f = F.fp12_mul(f, miller_loop(g1_neg(G1_GEN), sig_acc))
    return F.fp12_eq(final_exponentiation(f), F.FP12_ONE)
