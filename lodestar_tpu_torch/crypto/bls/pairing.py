"""Optimal ate pairing on BLS12-381 (pure-Python reference).

The PyTorch port's copy of ``lodestar_tpu/crypto/bls/pairing.py``: the
oracle behind `api.verify_signature_sets` (the single-thread verifier and
the pool's `verify_on_main_thread` road). Algorithm notes (mirrored 1:1 by
the batched limb code in ``lodestar_tpu_torch/ops/pairing.py``):

* Affine Miller loop over the twist. The G2 point stays in Fp2 twist
  coordinates; the untwist ψ(x,y) = (x·w^-2, y·w^-3) (w^6 = xi) is folded
  into a *sparse* line representation with three Fp2 coefficients in the
  w^0, w^3, w^5 slots. Lines are scaled by xi ∈ Fp2* — a proper-subfield
  factor killed by the final exponentiation. Vertical lines lie entirely in
  Fp6 and are dropped for the same reason.
* Final exponentiation computes f^(3·(p^12-1)/r) — the *cube* of the
  standard ate pairing — using the Hayashida–Hayasaka–Teruya hard-part
  decomposition 3(p^4-p^2+1)/r = (x-1)^2·(x+p)·(x^2+p^2-1) + 3 (identity
  asserted at import). Since gcd(3, r) = 1, cubing is a bijection on GT and
  all pairing-product equality checks are unaffected. This is what makes
  batch verification cheap: one shared final-exp per batch of Miller loops,
  the same trick as `verifyMultipleSignatures` in the reference
  (`packages/beacon-node/src/chain/bls/maybeBatch.ts:18`).

Affine + batch-inversion is the deliberate design point of the batched
versions: all signature sets in a device batch run the Miller loop in lockstep, so the
per-step Fp2 inversions amortize via Montgomery's batch-inversion trick
across the batch dimension.
"""

from __future__ import annotations

from . import fields as F
from .curve import G2_GEN  # noqa: F401  (re-export convenience)
from .fields import BLS_X, BLS_X_ABS, P, R, XI

# Bits of |x| below the most significant one, MSB first.
_X_BITS = [int(b) for b in bin(BLS_X_ABS)[3:]]

# HHT hard-part identity: 3*(p^4-p^2+1)/r == (x-1)^2 (x+p) (x^2+p^2-1) + 3
assert (P**4 - P**2 + 1) % R == 0
assert 3 * ((P**4 - P**2 + 1) // R) == (BLS_X - 1) ** 2 * (BLS_X + P) * (BLS_X**2 + P**2 - 1) + 3


def _sparse_line(c0, c3, c5):
    """Build the Fp12 element c0 + c3*w^3 + c5*w^5 (w^3 = v*w, w^5 = v^2*w)."""
    return ((c0, F.FP2_ZERO, F.FP2_ZERO), (F.FP2_ZERO, c3, c5))


def _line_eval(t, lam, p_g1):
    """Line through twist point t with twist-slope lam, evaluated at P in G1.

    Returns the xi-scaled sparse value: yP*xi - lam*xP*w^5 + (lam*xT - yT)*w^3.
    """
    xt, yt = t
    xp, yp = p_g1
    c0 = F.fp2_mul_scalar(XI, yp)
    c3 = F.fp2_sub(F.fp2_mul(lam, xt), yt)
    c5 = F.fp2_neg(F.fp2_mul_scalar(lam, xp))
    return _sparse_line(c0, c3, c5)


def miller_loop(p_g1, q_g2):
    """Miller loop f_{|x|,Q}(P), conjugated for the negative BLS parameter.

    p_g1: affine (x, y) in G1 over Fp. q_g2: affine (x, y) on the twist over
    Fp2. Neither may be infinity (callers handle identity separately).
    """
    t = q_g2
    f = F.FP12_ONE
    for bit in _X_BITS:
        # doubling step
        xt, yt = t
        lam = F.fp2_mul(
            F.fp2_mul_scalar(F.fp2_sq(xt), 3),
            F.fp2_inv(F.fp2_mul_scalar(yt, 2)),
        )
        f = F.fp12_mul(F.fp12_sq(f), _line_eval(t, lam, p_g1))
        x3 = F.fp2_sub(F.fp2_sq(lam), F.fp2_mul_scalar(xt, 2))
        y3 = F.fp2_sub(F.fp2_mul(lam, F.fp2_sub(xt, x3)), yt)
        t = (x3, y3)
        if bit:
            # addition step (T != +-Q throughout the ate loop: the running
            # multiple k of Q satisfies 1 < k < |x| << r)
            xt, yt = t
            xq, yq = q_g2
            lam = F.fp2_mul(F.fp2_sub(yt, yq), F.fp2_inv(F.fp2_sub(xt, xq)))
            f = F.fp12_mul(f, _line_eval(q_g2, lam, p_g1))
            x3 = F.fp2_sub(F.fp2_sub(F.fp2_sq(lam), xt), xq)
            y3 = F.fp2_sub(F.fp2_mul(lam, F.fp2_sub(xt, x3)), yt)
            t = (x3, y3)
    # x < 0: f_{x,Q} = conj(f_{|x|,Q})
    return F.fp12_conj(f)


def _pow_u(f):
    """f^|x| by square-and-multiply (|x| has Hamming weight 6)."""
    result = f
    for bit in _X_BITS:
        result = F.fp12_sq(result)
        if bit:
            result = F.fp12_mul(result, f)
    return result


def _pow_x(f):
    """f^x for the negative parameter x; valid in the cyclotomic subgroup."""
    return F.fp12_conj(_pow_u(f))


def _pow_xm1(f):
    """f^(x-1) = conj(f^(|x|+1)); cyclotomic subgroup only."""
    return F.fp12_conj(F.fp12_mul(_pow_u(f), f))


def final_exponentiation(f):
    """f^(3*(p^12-1)/r); see module docstring for the cubing caveat."""
    # easy part: f^((p^6-1)(p^2+1))
    f = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    f = F.fp12_mul(F.fp12_frobenius(f, 2), f)
    # hard part (cyclotomic from here; inverse == conjugate)
    y = _pow_xm1(f)  # f^(x-1)
    y = _pow_xm1(y)  # f^((x-1)^2)
    y = F.fp12_mul(_pow_x(y), F.fp12_frobenius(y, 1))  # ^(x+p)
    y = F.fp12_mul(
        F.fp12_mul(_pow_x(_pow_x(y)), F.fp12_frobenius(y, 2)),
        F.fp12_conj(y),
    )  # ^(x^2+p^2-1)
    f3 = F.fp12_mul(F.fp12_mul(f, f), f)
    return F.fp12_mul(y, f3)


def pairing(p_g1, q_g2):
    """Full (cubed) ate pairing e(P, Q)^3. Returns FP12_ONE for infinity inputs."""
    if p_g1 is None or q_g2 is None:
        return F.FP12_ONE
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i)^3 with one shared final exponentiation."""
    f = F.FP12_ONE
    for p_g1, q_g2 in pairs:
        if p_g1 is None or q_g2 is None:
            continue
        f = F.fp12_mul(f, miller_loop(p_g1, q_g2))
    return final_exponentiation(f)


def pairings_are_one(pairs) -> bool:
    """Check prod_i e(P_i, Q_i) == 1 (the batch-verify core predicate)."""
    return F.fp12_eq(multi_pairing(pairs), F.FP12_ONE)
