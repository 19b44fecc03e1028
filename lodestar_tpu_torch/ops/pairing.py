"""Batched optimal ate pairing on BLS12-381 over limb tensors.

PyTorch counterpart of ``lodestar_tpu.ops.pairing``, op for op, so the
limbs match the JAX package:

* **Inversion-free Miller loop.** The running point T stays in Jacobian
  coordinates over Fp2 and every line is scaled by its Fp2 denominator
  (2YZ^3 for doubling, Z*H for addition); the factor lies in a proper
  subfield of Fp12 and is annihilated by the easy part of the final
  exponentiation.
* The loop over the static bits of |x| is a Python loop with a Python
  ``if`` for the (6 of 63) addition steps; the whole batch advances in
  lockstep.
* **Lazy reduction**: the sparse line multiplication runs in the
  accumulator domain; its 14 Fp2 products stay unreduced through the
  Fp6/Fp12 combine and ONE stacked reduction gives the 12 coefficients.
* The final exponentiation mirrors the oracle's cubed-pairing hard part
  op for op, so the outputs are equal Fp12 elements, not merely
  equivalent predicates.

Line representation: c0 + c3*w^3 + c5*w^5 with c_i in Fp2.
"""

from __future__ import annotations

import torch

from ..crypto.bls.fields import BLS_X_ABS
from . import curve as cv
from . import fp
from . import tower as tw

__all__ = [
    "miller_loop",
    "final_exponentiation",
    "pairing",
    "fp12_product_fold",
    "multi_pairing_is_one",
]

# Bits of |x| below the MSB, MSB first (same schedule as the oracle).
_X_BITS = [int(b) for b in bin(BLS_X_ABS)[3:]]


def _mul_by_line(f, c0, c3, c5):
    """f * (c0 + c3 w^3 + c5 w^5), entirely in the accumulator domain.

    With l0 = (c0,0,0) and l1 = (0,c3,c5) in the Fp6[w] halves:
      t0 = a0*l0 (coefficient-wise scale by c0), t1 = a1*l1 (sparse Fp6
      mul), cross = (a0+a1)(l0+l1) (dense Fp6 mul).
    The 8 non-dense Fp2 products ride ONE stacked fp2_mul_acc; `cross`
    rides the stacked fp6_mul_acc; 12 reductions in one launch."""
    a0, a1 = f[..., 0, :, :, :], f[..., 1, :, :, :]
    x0, x1, x2 = a1[..., 0, :, :], a1[..., 1, :, :], a1[..., 2, :, :]
    y0, y1, y2 = a0[..., 0, :, :], a0[..., 1, :, :], a0[..., 2, :, :]
    lhs = torch.stack(
        [y0, y1, y2, x1, x2, tw.fp2_add(x1, x2), tw.fp2_add(x0, x1), tw.fp2_add(x0, x2)],
        dim=-3,
    )
    rhs = torch.stack([c0, c0, c0, c3, c5, tw.fp2_add(c3, c5), c3, c5], dim=-3)
    m = tw.fp2_mul_acc(lhs, rhs)
    t0 = m[..., 0:3, :, :]  # (.., 3, 2, 66) Fp6 accumulator
    p1, p2, m12, m01, m02 = (m[..., 3 + i, :, :] for i in range(5))
    d0 = tw._a2_mul_xi(fp.acc_sub(m12, fp.acc_add(p1, p2)))
    d1 = fp.acc_add(fp.acc_sub(m01, p1), tw._a2_mul_xi(p2))
    d2 = fp.acc_add(fp.acc_sub(m02, p2), p1)
    t1 = torch.stack([d0, d1, d2], dim=-3)

    cross = tw.fp6_mul_acc(tw.fp6_add(a0, a1), torch.stack([c0, c3, c5], dim=-3))
    r0 = fp.acc_add(t0, tw._a6_mul_by_v(t1))
    r1 = fp.acc_sub(cross, fp.acc_add(t0, t1))
    return fp.redc(torch.stack([r0, r1], dim=-4))


def _fp2_triple(a):
    return tw.fp2_add(tw.fp2_add(a, a), a)


def _dbl_line(T, xp, yp):
    X, Y, Z = T
    Z2 = tw.fp2_sq(Z)
    Y2 = tw.fp2_sq(Y)
    X2 = tw.fp2_sq(X)
    YZ3 = tw.fp2_mul(Y, tw.fp2_mul(Z, Z2))
    X3cube = tw.fp2_mul(X, X2)
    # c0 = 2*Y*Z^3 * xi * yP ; c3 = 3X^3 - 2Y^2 ; c5 = -3X^2Z^2 * xP
    c0 = tw.fp2_mul_fp(tw.fp2_mul_xi(tw.fp2_add(YZ3, YZ3)), yp)
    c3 = tw.fp2_sub(_fp2_triple(X3cube), tw.fp2_add(Y2, Y2))
    c5 = tw.fp2_neg(tw.fp2_mul_fp(_fp2_triple(tw.fp2_mul(X2, Z2)), xp))
    return c0, c3, c5


def _add_line(T, xq, yq, xp, yp):
    X, Y, Z = T
    Z2 = tw.fp2_sq(Z)
    Z3 = tw.fp2_mul(Z, Z2)
    theta = tw.fp2_sub(Y, tw.fp2_mul(yq, Z3))  # Y - yQ Z^3
    H = tw.fp2_sub(X, tw.fp2_mul(xq, Z2))  # X - xQ Z^2
    ZH = tw.fp2_mul(Z, H)
    c0 = tw.fp2_mul_fp(tw.fp2_mul_xi(ZH), yp)
    c3 = tw.fp2_sub(tw.fp2_mul(theta, xq), tw.fp2_mul(ZH, yq))
    c5 = tw.fp2_neg(tw.fp2_mul_fp(theta, xp))
    return c0, c3, c5


def miller_loop(p_aff, q_aff):
    """Batched f_{|x|,Q}(P), conjugated for the negative BLS parameter.

    p_aff: (xp, yp) G1 affine, mont-form (.., 33) tensors.
    q_aff: (xq, yq) twist affine over Fp2, (.., 2, 33) tensors.
    Neither input may encode infinity (callers mask separately)."""
    xp, yp = p_aff
    xq, yq = q_aff
    one2 = tw.fp2_one(xq.shape[:-2], xq.device)
    T = (xq, yq, one2)  # T starts at Q (Jacobian, Z = 1)
    f = tw.fp12_one(xp.shape[:-1], xp.device)
    for bit in _X_BITS:
        # doubling step: f <- f^2 * l_{T,T}(P); T <- 2T
        c0, c3, c5 = _dbl_line(T, xp, yp)
        f = _mul_by_line(tw.fp12_sq(f), c0, c3, c5)
        T = cv.jac_double(cv.F2, T)
        if bit:
            c0, c3, c5 = _add_line(T, xq, yq, xp, yp)
            f = _mul_by_line(f, c0, c3, c5)
            T = cv.jac_add_mixed(cv.F2, T, (xq, yq), one2)
    return tw.fp12_conj(f)  # negative parameter: conjugate


# --- final exponentiation ----------------------------------------------------


def _pow_u(f):
    """f^|x|: square, and multiply where the static bit is set."""
    r = f
    for bit in _X_BITS:
        r = tw.fp12_sq(r)
        if bit:
            r = tw.fp12_mul(r, f)
    return r


def _pow_x(f):
    return tw.fp12_conj(_pow_u(f))


def _pow_xm1(f):
    return tw.fp12_conj(tw.fp12_mul(_pow_u(f), f))


def final_exponentiation(f):
    """f^(3*(p^12-1)/r), the op-for-op mirror of the oracle's hard part;
    the cube keeps pairing-product equality unchanged (gcd(3, r) = 1)."""
    # easy part: f^((p^6-1)(p^2+1))
    f = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    f = tw.fp12_mul(tw.fp12_frobenius(f, 2), f)
    # hard part (cyclotomic: inverse == conjugate)
    y = _pow_xm1(f)
    y = _pow_xm1(y)
    y = tw.fp12_mul(_pow_x(y), tw.fp12_frobenius(y, 1))
    y = tw.fp12_mul(tw.fp12_mul(_pow_x(_pow_x(y)), tw.fp12_frobenius(y, 2)), tw.fp12_conj(y))
    f3 = tw.fp12_mul(tw.fp12_mul(f, f), f)  # fp12_mul(f, f) is the square
    return tw.fp12_mul(y, f3)


def pairing(p_aff, q_aff):
    """Full batched (cubed) ate pairing e(P, Q)^3; no infinity inputs. Two
    counted dispatches, as in the JAX package (lazy import: prep imports
    the host oracle modules, which this module does not load at import)."""
    from . import prep

    return prep._dispatch(final_exponentiation, prep._dispatch(miller_loop, p_aff, q_aff))


def fp12_product_fold(f, mask=None):
    """Product of a batch of Fp12 values down axis 0 (tree fold).

    f: (B, ..., 2, 3, 2, 33), any batch dims after B folded apart. mask:
    optional (B, ...) bool; False entries are replaced with one. Returns
    (..., 2, 3, 2, 33)."""
    if mask is not None:
        ones = tw.fp12_one(f.shape[:-4], f.device)
        f = torch.where(mask[..., None, None, None, None], f, ones)
    b = f.shape[0]
    size = 1 if b <= 1 else 1 << (b - 1).bit_length()
    if size != b:
        f = torch.cat([f, tw.fp12_one((size - b, *f.shape[1:-4]), f.device)], dim=0)
    while f.shape[0] > 1:
        half = f.shape[0] // 2
        f = tw.fp12_mul(f[:half], f[half:])
    return f[0]


def multi_pairing_is_one(p_aff, q_aff, mask=None):
    """Batch predicate prod_i e(P_i, Q_i) == 1 with ONE shared final
    exponentiation. p_aff/q_aff: batched affine points (batch axis 0);
    mask: optional (B,) bool, False = skip the pair (treat as infinity).
    Returns a 0-d bool tensor on the inputs' device, with no host sync:
    on the card the KZG checks capture it as one CUDA graph per pow-2
    pair class (``crypto/kzg.py``)."""
    fs = miller_loop(p_aff, q_aff)
    f = fp12_product_fold(fs, mask=mask)
    return tw.fp12_eq_one(final_exponentiation(f))
