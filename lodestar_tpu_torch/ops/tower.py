"""Batched Fp2/Fp6/Fp12 tower arithmetic on limb tensors (lazy reduction).

PyTorch counterpart of ``lodestar_tpu.ops.tower``: the same tower
construction and the same Karatsuba shapes and stacking, so the limbs
match the JAX package exactly. Every tower product is computed in the
**accumulator domain**: base-field products stay 66-limb accumulators, the
Karatsuba combine steps are elementwise accumulator ops, and ONE stacked
Montgomery reduction materializes the coefficients (12 reductions per Fp12
multiply, each one kernel launch over all of them).

Layouts (leading batch dims elided):
  Fp2  = (2, 33)       c0 + c1*u         acc: (2, 66)
  Fp6  = (3, 2, 33)    c0 + c1*v + c2*v^2
  Fp12 = (2, 3, 2, 33) c0 + c1*w

All elements are in Montgomery form (R = 2^396), relaxed per ops/fp.py.

The host converters (`fp2_from_ints`, `fp2_to_ints`, `fp12_from_oracle`,
`fp12_to_oracle`) move oracle integers to mont-form limbs and back through
one counted `to_mont` or `from_mont` dispatch, as in the JAX package.

Same-object operands route to the square (`fp2_mul`, `fp6_mul`,
`fp12_mul` test ``a is b``), exactly as in the JAX package: the square
gives other (equally valid) limbs than the general product, and the final
exponentiation calls ``fp12_mul(f, f)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto.bls import fields as F
from . import fp

__all__ = [
    "fp2_from_ints",
    "fp2_to_ints",
    "fp2_zero",
    "fp2_mul_small",
    "fp2_add",
    "fp2_sub",
    "fp2_neg",
    "fp2_conj",
    "fp2_mul",
    "fp2_mul_acc",
    "fp2_sq",
    "fp2_sq_acc",
    "fp2_mul_xi",
    "fp2_inv",
    "fp2_one",
    "fp2_is_zero",
    "fp2_mul_fp",
    "fp6_add",
    "fp6_sub",
    "fp6_neg",
    "fp6_mul",
    "fp6_mul_acc",
    "fp6_sq",
    "fp6_mul_by_v",
    "fp6_inv",
    "fp12_mul",
    "fp12_sq",
    "fp12_conj",
    "fp12_inv",
    "fp12_one",
    "fp12_eq_one",
    "fp12_frobenius",
    "fp12_from_oracle",
    "fp12_to_oracle",
]


# --- host conversions (oracle <-> limbs) -------------------------------------


def fp2_from_ints(vals) -> np.ndarray:
    """[(c0, c1), ...] -> (N, 2, 33) mont-form limbs as numpy, the JAX
    package's limbs: one counted `to_mont` dispatch on the host (the
    plain version)."""
    # lazy import: prep imports this module at its top level
    from . import prep

    out = np.stack(
        [np.stack([fp.limbs_from_int(c0), fp.limbs_from_int(c1)]) for c0, c1 in vals]
    )
    # lint: allow(pow2-dispatch) — host converter for constants and tests, off the serving path; eager PyTorch compiles nothing per shape, so an unpadded batch costs no compile
    return prep._dispatch(fp.to_mont, torch.from_numpy(out)).numpy()


def fp2_to_ints(arr) -> list[tuple[int, int]]:
    """(.., 2, 33) mont-form limbs (numpy, or a tensor on any device) ->
    [(c0, c1), ...] canonical ints: one counted `from_mont` dispatch where
    the limbs lie."""
    from . import prep

    std = prep._dispatch(fp.from_mont, torch.as_tensor(arr)).cpu().numpy()
    flat = std.reshape(-1, 2, fp.LIMBS)
    return [(fp.int_from_limbs(e[0]), fp.int_from_limbs(e[1])) for e in flat]


# --- Fp2 --------------------------------------------------------------------


def fp2_zero(batch_shape=(), device="cpu"):
    return fp.zero((*batch_shape, 2), device)


def fp2_one(batch_shape=(), device="cpu"):
    z = fp.zero((*batch_shape, 2), device)
    z[..., 0, :] = fp.one_mont(batch_shape, device)
    return z


def fp2_add(a, b):
    return fp.add(a, b)


def fp2_sub(a, b):
    return fp.sub(a, b)


def fp2_neg(a):
    return fp.neg(a)


def fp2_conj(a):
    return torch.cat([a[..., 0:1, :], fp.neg(a[..., 1:2, :])], dim=-2)


def fp2_mul_acc(a, b):
    """Karatsuba Fp2 product in the accumulator domain: THREE base products
    ride one stacked mul_acc; no reduction here. Returns (.., 2, 66)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    lhs = torch.stack([a0, a1, fp.add(a0, a1)], dim=-2)
    rhs = torch.stack([b0, b1, fp.add(b0, b1)], dim=-2)
    m = fp.mul_acc(lhs, rhs)
    t0, t1, cross = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c0 = fp.acc_sub(t0, t1)
    c1 = fp.acc_sub(cross, fp.acc_add(t0, t1))
    return torch.stack([c0, c1], dim=-2)


def fp2_mul(a, b):
    if a is b:
        return fp2_sq(a)
    return fp.redc(fp2_mul_acc(a, b))


def fp2_sq_acc(a):
    """(a0+a1)(a0-a1) + 2 a0 a1 u: two base products, no reduction."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    lhs = torch.stack([fp.add(a0, a1), a0], dim=-2)
    rhs = torch.stack([fp.sub(a0, a1), a1], dim=-2)
    m = fp.mul_acc(lhs, rhs)
    c0, c1m = m[..., 0, :], m[..., 1, :]
    return torch.stack([c0, fp.acc_add(c1m, c1m)], dim=-2)


def fp2_sq(a):
    return fp.redc(fp2_sq_acc(a))


def fp2_mul_small(a, k: int):
    """Multiply by a small non-negative integer via repeated addition."""
    if k == 0:
        return fp2_zero(a.shape[:-2], a.device)
    r = a
    for _ in range(k - 1):
        r = fp.add(r, a)
    return r


def fp2_mul_xi(a):
    """Multiply by xi = u + 1: (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fp.sub(a0, a1), fp.add(a0, a1)], dim=-2)


def _a2_mul_xi(t):
    """xi on an Fp2 accumulator pair (.., 2, 66)."""
    t0, t1 = t[..., 0, :], t[..., 1, :]
    return torch.stack([fp.acc_sub(t0, t1), fp.acc_add(t0, t1)], dim=-2)


def fp2_mul_fp(a, s):
    """Multiply an Fp2 element by an Fp scalar (mont form, (.., 33)): one
    broadcast mont_mul over the coefficient axis."""
    return fp.mont_mul(a, s[..., None, :])


def fp2_inv(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    norm = fp.redc(fp.acc_add(fp.sq_acc(a0), fp.sq_acc(a1)))
    ninv = fp.inv(norm)
    scaled = fp.mont_mul(a, ninv[..., None, :])
    return torch.stack([scaled[..., 0, :], fp.neg(scaled[..., 1, :])], dim=-2)


def fp2_is_zero(a):
    """Exact-zero limb test (see fp.is_zero semantics)."""
    return torch.all(torch.all(a == 0, dim=-1), dim=-1)


# --- Fp6 = Fp2[v]/(v^3 - xi) ------------------------------------------------


def fp6_add(a, b):
    return fp.add(a, b)


def fp6_sub(a, b):
    return fp.sub(a, b)


def fp6_neg(a):
    return fp.neg(a)


def _a6_mul_by_v(t):
    """v-shift on an Fp6 accumulator triple (.., 3, 2, 66)."""
    return torch.stack([_a2_mul_xi(t[..., 2, :, :]), t[..., 0, :, :], t[..., 1, :, :]], dim=-3)


def fp6_mul_acc(a, b):
    """Toom/Karatsuba Fp6 product in the accumulator domain: all 6 Fp2
    products (18 base convs) in ONE stacked fp2_mul_acc. Returns
    (.., 3, 2, 66); no reduction."""
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    sa = fp.add(torch.stack([a1, a0, a0], dim=-3), torch.stack([a2, a1, a2], dim=-3))
    sb = fp.add(torch.stack([b1, b0, b0], dim=-3), torch.stack([b2, b1, b2], dim=-3))
    lhs = torch.cat([torch.stack([a0, a1, a2], dim=-3), sa], dim=-3)
    rhs = torch.cat([torch.stack([b0, b1, b2], dim=-3), sb], dim=-3)
    m = fp2_mul_acc(lhs, rhs)  # t0, t1, t2, m12, m01, m02 accs
    t0, t1, t2 = m[..., 0, :, :], m[..., 1, :, :], m[..., 2, :, :]
    m12, m01, m02 = m[..., 3, :, :], m[..., 4, :, :], m[..., 5, :, :]
    u12 = fp.acc_sub(m12, fp.acc_add(t1, t2))
    u01 = fp.acc_sub(m01, fp.acc_add(t0, t1))
    u02 = fp.acc_sub(m02, fp.acc_add(t0, t2))
    c0 = fp.acc_add(t0, _a2_mul_xi(u12))
    c1 = fp.acc_add(u01, _a2_mul_xi(t2))
    c2 = fp.acc_add(u02, t1)
    return torch.stack([c0, c1, c2], dim=-3)


def fp6_mul(a, b):
    if a is b:
        return fp6_sq(a)
    return fp.redc(fp6_mul_acc(a, b))


def _fp6_sq_products(a):
    """The six Fp2 products a0^2, a1a2, a2^2, a0a1, a1^2, a0a2 in one
    stacked fp2_mul_acc (distinct lhs/rhs stacks, as in the JAX package)."""
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    m = fp2_mul_acc(
        torch.stack([a0, a1, a2, a0, a1, a0], dim=-3),
        torch.stack([a0, a2, a2, a1, a1, a2], dim=-3),
    )
    return tuple(m[..., i, :, :] for i in range(6))


def fp6_sq(a):
    # c0 = a0^2 + 2 xi a1 a2; c1 = 2 a0 a1 + xi a2^2; c2 = a1^2 + 2 a0 a2
    sq0, m12, sq2, m01, sq1, m02 = _fp6_sq_products(a)
    c0 = fp.acc_add(sq0, _a2_mul_xi(fp.acc_add(m12, m12)))
    c1 = fp.acc_add(fp.acc_add(m01, m01), _a2_mul_xi(sq2))
    c2 = fp.acc_add(sq1, fp.acc_add(m02, m02))
    return fp.redc(torch.stack([c0, c1, c2], dim=-3))


def fp6_mul_by_v(a):
    return torch.stack([fp2_mul_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], dim=-3)


def fp6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    sq0, m12, sq2, m01, sq1, m02 = _fp6_sq_products(a)
    c0 = fp.redc(fp.acc_sub(sq0, _a2_mul_xi(m12)))
    c1 = fp.redc(fp.acc_sub(_a2_mul_xi(sq2), m01))
    c2 = fp.redc(fp.acc_sub(sq1, m02))
    # t = a0 c0 + xi (a2 c1 + a1 c2): three products, combined in acc
    tm = fp2_mul_acc(torch.stack([a0, a2, a1], dim=-3), torch.stack([c0, c1, c2], dim=-3))
    t = fp.redc(
        fp.acc_add(tm[..., 0, :, :], _a2_mul_xi(fp.acc_add(tm[..., 1, :, :], tm[..., 2, :, :])))
    )
    tinv = fp2_inv(t)
    return fp2_mul(torch.stack([c0, c1, c2], dim=-3), tinv[..., None, :, :])


# --- Fp12 = Fp6[w]/(w^2 - v) ------------------------------------------------


def fp12_one(batch_shape=(), device="cpu"):
    z = fp.zero((*batch_shape, 2, 3, 2), device)
    z[..., 0, 0, 0, :] = fp.one_mont(batch_shape, device)
    return z


def fp12_mul(a, b):
    """Karatsuba Fp12 product: all 54 base-field products ride one
    mul_acc launch (3 stacked fp6_mul_acc -> 18 fp2 -> 54 convs) and ONE
    stacked reduction materializes the 12 coefficients. Same-object
    operands route to the square."""
    if a is b:
        return fp12_sq(a)
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
    lhs = torch.stack([a0, a1, fp6_add(a0, a1)], dim=-4)
    rhs = torch.stack([b0, b1, fp6_add(b0, b1)], dim=-4)
    m = fp6_mul_acc(lhs, rhs)
    t0, t1, cross = m[..., 0, :, :, :], m[..., 1, :, :, :], m[..., 2, :, :, :]
    c0 = fp.acc_add(t0, _a6_mul_by_v(t1))
    c1 = fp.acc_sub(cross, fp.acc_add(t0, t1))
    return fp.redc(torch.stack([c0, c1], dim=-4))


def fp12_sq(a):
    """Karatsuba square: TWO Fp6 products (t = a0*a1 and
    s = (a0+a1)(a0 + v*a1)): c0 = s - t - v*t, c1 = 2t."""
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    lhs = torch.stack([a0, fp6_add(a0, a1)], dim=-4)
    rhs = torch.stack([a1, fp6_add(a0, fp6_mul_by_v(a1))], dim=-4)
    m = fp6_mul_acc(lhs, rhs)
    t, s = m[..., 0, :, :, :], m[..., 1, :, :, :]
    c0 = fp.acc_sub(s, fp.acc_add(t, _a6_mul_by_v(t)))
    c1 = fp.acc_add(t, t)
    return fp.redc(torch.stack([c0, c1], dim=-4))


def fp12_conj(a):
    return torch.stack([a[..., 0, :, :, :], fp6_neg(a[..., 1, :, :, :])], dim=-4)


def fp12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    both = torch.stack([a0, a1], dim=-4)
    s0 = fp6_sq(a0)
    s1 = fp6_sq(a1)
    t = fp6_sub(s0, fp6_mul_by_v(s1))
    tinv = fp6_inv(t)
    scaled = fp6_mul(both, tinv[..., None, :, :, :])
    return torch.stack([scaled[..., 0, :, :, :], fp6_neg(scaled[..., 1, :, :, :])], dim=-4)


def fp12_eq_one(a):
    """Batch predicate a == 1 (mont form). Canonicalizes (boundary op)."""
    one = fp12_one(a.shape[:-4], a.device)
    return torch.all((fp.canon(a) == one).flatten(start_dim=a.dim() - 4), dim=-1)


# Frobenius coefficients g_i(k) = xi^(i*(p^k-1)/6) for powers k = 1..3,
# built on the host from the oracle (numpy only, no device at import).


def _fp2_mont_limbs_host(c0: int, c1: int) -> np.ndarray:
    """(c0, c1) ints -> (2, 33) mont-form limbs, numpy only."""
    return np.stack([fp.mont_limbs_from_int(c0), fp.mont_limbs_from_int(c1)])


_FROB_K = {
    k: np.stack([_fp2_mont_limbs_host(*F.fp2_pow(F.XI, i * (F.P**k - 1) // 6)) for i in range(6)])
    for k in (1, 2, 3)
}


@functools.lru_cache(maxsize=None)
def _frob_on(power: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_FROB_K[power], dtype=torch.int32, device=device)


def _to_w_coeffs(a):
    """((c0,c2,c4),(c1,c3,c5)) -> [c0..c5]."""
    return [
        a[..., 0, 0, :, :],
        a[..., 1, 0, :, :],
        a[..., 0, 1, :, :],
        a[..., 1, 1, :, :],
        a[..., 0, 2, :, :],
        a[..., 1, 2, :, :],
    ]


def _from_w_coeffs(c):
    c0 = torch.stack([c[0], c[2], c[4]], dim=-3)
    c1 = torch.stack([c[1], c[3], c[5]], dim=-3)
    return torch.stack([c0, c1], dim=-4)


def fp12_frobenius(a, power: int = 1):
    """a^(p^power) for power in {1, 2, 3}, coefficient-wise (all six
    coefficient products in one stacked fp2_mul)."""
    if power not in (1, 2, 3):
        raise ValueError("frobenius power must be 1..3")
    stacked = torch.stack(_to_w_coeffs(a), dim=-3)  # (.., 6, 2, 33)
    if power % 2 == 1:
        stacked = fp2_conj(stacked)
    prod = fp2_mul(stacked, _frob_on(power, a.device))
    return _from_w_coeffs([prod[..., i, :, :] for i in range(6)])


# --- oracle bridge ----------------------------------------------------------


def fp12_from_oracle(vals) -> np.ndarray:
    """List of oracle Fp12 tuples -> (N, 2, 3, 2, 33) mont limbs (numpy)."""
    flat = [c for v in vals for half in v for c in half]
    return fp2_from_ints(flat).reshape(len(vals), 2, 3, 2, fp.LIMBS)


def fp12_to_oracle(arr) -> list:
    """(.., 2, 3, 2, 33) mont limbs -> list of oracle Fp12 tuples."""
    shaped = torch.as_tensor(arr).reshape(-1, 2, 3, 2, fp.LIMBS)
    ints = fp2_to_ints(shaped.reshape(-1, 2, fp.LIMBS))
    return [(tuple(ints[6 * i : 6 * i + 3]), tuple(ints[6 * i + 3 : 6 * i + 6]))
            for i in range(shaped.shape[0])]
