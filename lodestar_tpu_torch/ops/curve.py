"""Batched elliptic-curve ops for G1 (over Fp) and the G2 twist (over Fp2).

PyTorch counterpart of ``lodestar_tpu.ops.curve``, in **Jacobian
coordinates** (inversion-free doubling and mixed addition, so the whole
batch advances in lockstep). Points are (X, Y, Z) tuples of mont-form limb
tensors. **Infinity is the exact-zero Z limb pattern**: the relaxed field
core preserves exact zeros through products, so infinity created by
padding or by a zero point propagates for free.

Exceptional cases come in two flavours:

* fast (the blinded hot paths): only exact-zero infinity selects. P == +-Q
  collisions are unreachable there: the running accumulator is k*Q for a
  k that is never +-1 mod ord(Q) (blinding scalars and |x|-prefixes are
  < 2^65 << r, and inputs are subgroup-checked).
* exact (`jac_add`, default, and `scalar_mul_const`): value-level zero
  tests (`is_zero_mod`) drive the P == Q / P == -Q selects, and a
  detected cancellation gives the exact-zero infinity form (aggregate
  folds, subgroup checks, cofactor clearing).
"""

from __future__ import annotations

import torch

from . import fp
from . import tower as tw

__all__ = [
    "F1",
    "F2",
    "jac_double",
    "jac_add_mixed",
    "jac_add",
    "jac_is_inf",
    "jac_is_inf_val",
    "jac_neg",
    "jac_to_affine_batch",
    "scalar_mul_var",
    "scalar_mul_const",
    "affine_to_jac",
    "fold_sum",
]


class _FieldOps:
    """Field-op namespace (one instance per field)."""

    __slots__ = ("mul", "sq", "add", "sub", "neg", "is_zero", "is_zero_mod", "inv")

    def __init__(self, *, mul, sq, add, sub, neg, is_zero, is_zero_mod, inv):
        self.mul = mul
        self.sq = sq
        self.add = add
        self.sub = sub
        self.neg = neg
        self.is_zero = is_zero
        self.is_zero_mod = is_zero_mod
        self.inv = inv


def _fp2_is_zero_mod(a):
    return fp.is_zero_mod(a[..., 0, :]) & fp.is_zero_mod(a[..., 1, :])


F1 = _FieldOps(
    mul=fp.mont_mul,
    sq=fp.mont_sq,
    add=fp.add,
    sub=fp.sub,
    neg=fp.neg,
    is_zero=fp.is_zero,
    is_zero_mod=fp.is_zero_mod,
    inv=fp.inv,
)
F2 = _FieldOps(
    mul=tw.fp2_mul,
    sq=tw.fp2_sq,
    add=tw.fp2_add,
    sub=tw.fp2_sub,
    neg=tw.fp2_neg,
    is_zero=tw.fp2_is_zero,
    is_zero_mod=_fp2_is_zero_mod,
    inv=tw.fp2_inv,
)


def _dbl(F, x):
    return F.add(x, x)


def jac_is_inf(F, pt):
    """Exact-zero infinity test (the maintained encoding)."""
    return F.is_zero(pt[2])


def jac_is_inf_val(F, pt):
    """Value-level infinity test (Z == 0 mod p), for boundary predicates
    where a cancellation may have left a relaxed zero."""
    return F.is_zero_mod(pt[2])


def jac_neg(F, pt):
    return (pt[0], F.neg(pt[1]), pt[2])


def affine_to_jac(F, xy, one):
    """(x, y) affine -> Jacobian with Z = 1 (mont one broadcast to x's shape)."""
    x, y = xy
    return (x, y, one.expand(x.shape))


def jac_double(F, pt):
    """2P for a = 0 curves. Infinity (exact-zero Z) stays exactly infinite
    (Z3 = 2*Y*Z keeps the zero limb pattern through mul/add)."""
    X, Y, Z = pt
    A = F.sq(X)
    B = F.sq(Y)
    C = F.sq(B)
    D = F.sub(F.sub(F.sq(F.add(X, B)), A), C)
    D = _dbl(F, D)
    E = F.add(F.add(A, A), A)
    Fq = F.sq(E)
    X3 = F.sub(Fq, _dbl(F, D))
    eight_c = _dbl(F, _dbl(F, _dbl(F, C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), eight_c)
    Z3 = _dbl(F, F.mul(Y, Z))
    return (X3, Y3, Z3)


def _where_pt(cond, a, b):
    """Select points elementwise on a batch-bool cond."""

    def sel(u, v):
        c = cond
        while c.dim() < u.dim():
            c = c[..., None]
        return torch.where(c, u, v)

    return tuple(sel(u, v) for u, v in zip(a, b))


def _zero_pt_like(x):
    return (torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x))


def jac_add_mixed(F, pt, q_aff, one, exact: bool = False):
    """P (Jacobian) + Q (affine, not infinity). Handles P = inf; with
    exact=True also P = Q (doubling select) and P = -Q (exact-zero
    infinity) via value-level zero tests."""
    X1, Y1, Z1 = pt
    xq, yq = q_aff
    Z1Z1 = F.sq(Z1)
    U2 = F.mul(xq, Z1Z1)
    S2 = F.mul(yq, F.mul(Z1, Z1Z1))
    H = F.sub(U2, X1)
    r = F.sub(S2, Y1)
    H2 = F.sq(H)
    H3 = F.mul(H, H2)
    X1H2 = F.mul(X1, H2)
    X3 = F.sub(F.sub(F.sq(r), H3), _dbl(F, X1H2))
    Y3 = F.sub(F.mul(r, F.sub(X1H2, X3)), F.mul(Y1, H3))
    Z3 = F.mul(Z1, H)
    out = (X3, Y3, Z3)

    q_jac = affine_to_jac(F, q_aff, one)
    if exact:
        finite = ~F.is_zero(Z1)
        h0 = F.is_zero_mod(H)
        r0 = F.is_zero_mod(r)
        out = _where_pt(h0 & r0 & finite, jac_double(F, q_jac), out)
        out = _where_pt(h0 & ~r0 & finite, _zero_pt_like(X3), out)
    out = _where_pt(F.is_zero(Z1), q_jac, out)
    return out


def jac_add(F, p1, p2, exact: bool = True):
    """Full Jacobian + Jacobian addition. exact=True: complete (value-level
    tests drive the P == Q doubling select and canonicalize P == -Q to
    exact-zero infinity). exact=False keeps only the infinity selects."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = F.sq(Z1)
    Z2Z2 = F.sq(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    H2 = F.sq(H)
    H3 = F.mul(H, H2)
    U1H2 = F.mul(U1, H2)
    X3 = F.sub(F.sub(F.sq(r), H3), _dbl(F, U1H2))
    Y3 = F.sub(F.mul(r, F.sub(U1H2, X3)), F.mul(S1, H3))
    Z3 = F.mul(H, F.mul(Z1, Z2))
    out = (X3, Y3, Z3)

    if exact:
        finite = ~F.is_zero(Z1) & ~F.is_zero(Z2)
        h0 = F.is_zero_mod(H)
        r0 = F.is_zero_mod(r)
        out = _where_pt(h0 & r0 & finite, jac_double(F, p1), out)
        out = _where_pt(h0 & ~r0 & finite, _zero_pt_like(X3), out)
    out = _where_pt(F.is_zero(Z1), p2, out)
    out = _where_pt(F.is_zero(Z2), p1, out)
    return out


def scalar_mul_var(F, q_aff, bit_matrix, one, exact: bool = False):
    """Per-element scalar multiples of affine points.

    q_aff: batch of affine points; bit_matrix: (B, nbits) int32 tensor,
    MSB first. Branch-free: every column doubles, computes the add and
    selects it where the bit is set. The fast default addition is sound
    for < 2^64 blinding scalars (module docstring)."""
    acc = _zero_pt_like(q_aff[0])
    for j in range(bit_matrix.shape[-1]):
        acc = jac_double(F, acc)
        added = jac_add_mixed(F, acc, q_aff, one, exact=exact)
        acc = _where_pt(bit_matrix[..., j] != 0, added, acc)
    return acc


def scalar_mul_const(F, q_aff, scalar: int, one):
    """[scalar]Q for one static scalar (subgroup checks): double every
    bit, and add Q with the exact addition where the bit is set (a Python
    `if` on the static bit, the JAX package's `lax.cond`). The exact
    addition is needed: a multiple of the group order walks through
    -Q + Q, and inputs off the subgroup may have small order."""
    acc = _zero_pt_like(q_aff[0])
    if scalar == 0:
        return acc
    for bit in bin(scalar)[2:]:
        acc = jac_double(F, acc)
        if bit == "1":
            acc = jac_add_mixed(F, acc, q_aff, one, exact=True)
    return acc


def fold_sum(F, pts):
    """Sum a batch of Jacobian points down axis 0 (tree fold, padded to a
    power of two with exact-zero infinity). Uses the complete addition:
    cancellations inside an aggregate are legitimate data."""
    X, Y, Z = pts
    b = X.shape[0]
    size = 1 if b <= 1 else 1 << (b - 1).bit_length()
    if size != b:
        X, Y, Z = (torch.cat([a, a.new_zeros((size - b, *a.shape[1:]))]) for a in (X, Y, Z))
    pt = (X, Y, Z)
    while pt[0].shape[0] > 1:
        half = pt[0].shape[0] // 2
        pt = jac_add(F, tuple(c[:half] for c in pt), tuple(c[half:] for c in pt))
    return tuple(c[0] for c in pt)


def jac_to_affine_batch(F, pt):
    """Jacobian -> affine for a batch (one Fermat chain across the whole
    batch). Infinity maps to garbage: callers mask with jac_is_inf."""
    X, Y, Z = pt
    zinv = F.inv(Z)
    zinv2 = F.sq(zinv)
    return (F.mul(X, zinv2), F.mul(Y, F.mul(zinv, zinv2)))
