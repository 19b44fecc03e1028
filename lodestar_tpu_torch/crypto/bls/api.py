"""The BLS signature API (eth2 flavour: minimal-pubkey-size): secret keys,
signing, the single-signature checks (verify, the aggregates,
fast-aggregate and aggregate verify) and the signature-set work item.
Pubkeys live in G1 (48B compressed), signatures in G2 (96B compressed),
messages hash to G2.

The batch verifier on the card is ``lodestar_tpu_torch.models.batch_verify``;
`verify_signature_sets` here is the pure-Python oracle of the same check
(the single-thread verifier and the pool's `verify_on_main_thread` road);
the single-signature checks are the oracle the state transition calls
when it verifies inline.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import curve as C
from . import fields as F
from .curve import G1_GEN, g1_add, g1_mul, g1_neg
from .fields import R
from .hash_to_curve import hash_to_g2
from .pairing import final_exponentiation, miller_loop, pairings_are_one
from .serdes import PointDecodeError, g1_from_bytes, g1_to_bytes, g2_from_bytes, g2_to_bytes

__all__ = [
    "SecretKey",
    "sk_to_pk",
    "sign",
    "verify",
    "aggregate_pubkeys",
    "aggregate_signatures",
    "fast_aggregate_verify",
    "eth_fast_aggregate_verify",
    "G2_INFINITY",
    "aggregate_verify",
    "SignatureSet",
    "verify_signature_sets",
    "PointDecodeError",
]


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


def verify(pk: bytes, message: bytes, sig: bytes) -> bool:
    """Core verify: e(pk, H(m)) == e(g1, sig)."""
    try:
        pk_pt = _decode_pubkey(pk)
        sig_pt = _decode_signature(sig)
    except PointDecodeError:
        return False
    if sig_pt is None:
        return False
    h = hash_to_g2(message)
    return pairings_are_one([(g1_neg(G1_GEN), sig_pt), (pk_pt, h)])


def aggregate_pubkeys(pks: list[bytes]) -> bytes:
    if not pks:
        # An empty aggregate would encode the G1 infinity point, an invalid
        # pubkey per KeyValidate: refuse, as aggregate_signatures does.
        raise ValueError("cannot aggregate empty pubkey list")
    pts = [_decode_pubkey(pk) for pk in pks]
    acc = None
    for pt in pts:
        acc = g1_add(acc, pt)
    return g1_to_bytes(acc)


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    if not sigs:
        raise ValueError("cannot aggregate empty signature list")
    acc = None
    for s in sigs:
        acc = C.g2_add(acc, g2_from_bytes(s))
    return g2_to_bytes(acc)


def fast_aggregate_verify(pks: list[bytes], message: bytes, sig: bytes) -> bool:
    """All pks signed the same message (sync-committee / aggregate path)."""
    if not pks:
        return False
    try:
        agg = None
        for pk in pks:
            agg = g1_add(agg, _decode_pubkey(pk))
        sig_pt = _decode_signature(sig)
    except PointDecodeError:
        return False
    if sig_pt is None or agg is None:
        return False
    h = hash_to_g2(message)
    return pairings_are_one([(g1_neg(G1_GEN), sig_pt), (agg, h)])


G2_INFINITY = b"\xc0" + b"\x00" * 95


def eth_fast_aggregate_verify(pks: list[bytes], message: bytes, sig: bytes) -> bool:
    """Altair eth_fast_aggregate_verify: empty participants + infinity sig is
    valid (sync-committee path, reference
    `packages/state-transition/src/signatureSets` sync committee sets).
    """
    if not pks and sig == G2_INFINITY:
        return True
    return fast_aggregate_verify(pks, message, sig)


def aggregate_verify(pks: list[bytes], messages: list[bytes], sig: bytes) -> bool:
    """Distinct messages, one aggregated signature."""
    if not pks or len(pks) != len(messages):
        return False
    try:
        pk_pts = [_decode_pubkey(pk) for pk in pks]
        sig_pt = _decode_signature(sig)
    except PointDecodeError:
        return False
    if sig_pt is None:
        return False
    pairs = [(g1_neg(G1_GEN), sig_pt)]
    pairs += [(pk, hash_to_g2(m)) for pk, m in zip(pk_pts, messages)]
    return pairings_are_one(pairs)


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
