"""The port's Jacobian curve ops (`lodestar_tpu_torch.ops.curve`) held
against `lodestar_tpu.ops.curve`, limb for limb, and against the affine
pure-Python oracle on canonical values.

Tolerance: none (exact integer equality). Scalars and points are made
from fixed seeds with numpy; inputs include zero scalars (infinity
results), infinity points (exact-zero Z) and a cancelling pair.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import curve as C
from lodestar_tpu.crypto.bls.curve import G1_GEN, G2_GEN
from lodestar_tpu.ops import curve as jcv
from lodestar_tpu_torch.ops import curve as cv, fp, tower as tw

NBITS = 16


def g1_limbs(pts):
    return (
        np.stack([fp.mont_limbs_from_int(p[0]) for p in pts]),
        np.stack([fp.mont_limbs_from_int(p[1]) for p in pts]),
    )


def g2_limbs(pts):
    return (
        np.stack([tw._fp2_mont_limbs_host(*p[0]) for p in pts]),
        np.stack([tw._fp2_mont_limbs_host(*p[1]) for p in pts]),
    )


def bit_matrix(scalars, nbits=NBITS):
    return np.array([[(s >> (nbits - 1 - j)) & 1 for j in range(nbits)] for s in scalars], np.int32)


def scalars(n, seed):
    r = np.random.default_rng(seed)
    ks = [int(k) for k in r.integers(2, 1 << NBITS, size=n)]
    ks[0] = 0  # infinity result
    ks[1] = 1
    return ks


def same_as_jax(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def g1_affine_values(aff, inf):
    xs = fp.ints_from_limbs(fp.from_mont(aff[0]).numpy())
    ys = fp.ints_from_limbs(fp.from_mont(aff[1]).numpy())
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf.tolist())]


def fp2_values(a):
    flat = fp.ints_from_limbs(fp.from_mont(a.reshape(-1, fp.LIMBS)).numpy())
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


def g2_affine_values(aff, inf):
    xs, ys = fp2_values(aff[0]), fp2_values(aff[1])
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf.tolist())]


class TestScalarMulVar:
    def test_g1(self):
        pts = [C.g1_mul(G1_GEN, k) for k in (3, 5, 7, 11)]
        ks = scalars(4, seed=1)
        q, bits = g1_limbs(pts), bit_matrix(ks)
        one = fp.ONE_MONT_LIMBS
        got = cv.scalar_mul_var(cv.F1, t(*q), torch.from_numpy(bits), torch.from_numpy(one))
        same_as_jax(got, jcv.scalar_mul_var(jcv.F1, q, bits, one))
        assert cv.jac_is_inf(cv.F1, got).tolist() == [True, False, False, False]
        aff = cv.jac_to_affine_batch(cv.F1, got)
        same_as_jax(aff, jcv.jac_to_affine_batch(jcv.F1, tuple(g.numpy() for g in got)))
        want = [C.g1_mul(p, k) if k else None for p, k in zip(pts, ks)]
        assert g1_affine_values(aff, cv.jac_is_inf(cv.F1, got)) == want

    def test_g2(self):
        pts = [C.g2_mul(G2_GEN, k) for k in (13, 29, 31, 37)]
        ks = scalars(4, seed=2)
        q, bits = g2_limbs(pts), bit_matrix(ks)
        one2 = tw.fp2_one()
        got = cv.scalar_mul_var(cv.F2, t(*q), torch.from_numpy(bits), one2)
        same_as_jax(got, jcv.scalar_mul_var(jcv.F2, q, bits, one2.numpy()))
        aff = cv.jac_to_affine_batch(cv.F2, got)
        same_as_jax(aff, jcv.jac_to_affine_batch(jcv.F2, tuple(g.numpy() for g in got)))
        want = [C.g2_mul_raw(p, k) if k else None for p, k in zip(pts, ks)]
        assert g2_affine_values(aff, cv.jac_is_inf(cv.F2, got)) == want


class TestFoldSum:
    def test_g2_with_infinity_and_cancellation(self):
        ks = [3, 7, 11, 13, 17]  # 5 entries: padded to 8 with infinity
        pts = [C.g2_mul(G2_GEN, k) for k in ks]
        pts[2] = C.g2_neg(pts[1])  # P + (-P): a legitimate cancellation
        X, Y = g2_limbs(pts)
        Z = np.broadcast_to(tw.fp2_one().numpy(), X.shape).copy()
        Z[3] = 0  # an infinity entry (exact-zero Z)
        got = cv.fold_sum(cv.F2, t(X, Y, Z))
        same_as_jax(got, jcv.fold_sum(jcv.F2, (X, Y, Z)))
        aff = cv.jac_to_affine_batch(cv.F2, tuple(c[None] for c in got))
        acc = None
        for i, p in enumerate(pts):
            if i != 3:
                acc = C.g2_add(acc, p)
        assert g2_affine_values(aff, cv.jac_is_inf(cv.F2, got)[None]) == [acc]

    def test_all_cancel_gives_exact_infinity(self):
        p = C.g2_mul(G2_GEN, 5)
        X, Y = g2_limbs([p, C.g2_neg(p)])
        Z = np.broadcast_to(tw.fp2_one().numpy(), X.shape).copy()
        got = cv.fold_sum(cv.F2, t(X, Y, Z))
        same_as_jax(got, jcv.fold_sum(jcv.F2, (X, Y, Z)))
        assert bool(cv.jac_is_inf(cv.F2, got))


class TestScalarMulConst:
    """One static scalar for the whole batch (the subgroup checks of input
    prep), with the exact addition at every set bit."""

    def test_g1(self):
        pts = [C.g1_mul(G1_GEN, k) for k in (3, 5, 7, 11)]
        q = g1_limbs(pts)
        one = fp.ONE_MONT_LIMBS
        for k in (0, 1, 45):
            got = cv.scalar_mul_const(cv.F1, t(*q), k, torch.from_numpy(one))
            same_as_jax(got, jcv.scalar_mul_const(jcv.F1, q, k, one))
            aff = cv.jac_to_affine_batch(cv.F1, got)
            want = [C.g1_mul(p, k) if k else None for p in pts]
            assert g1_affine_values(aff, cv.jac_is_inf(cv.F1, got)) == want

    def test_g2_through_a_cancellation(self):
        # [r]Q walks through -Q + Q at its last addition: exact infinity
        pts = [C.g2_mul(G2_GEN, k) for k in (13, 29)]
        q = g2_limbs(pts)
        one2 = tw.fp2_one()
        for k in (45, C.R):
            got = cv.scalar_mul_const(cv.F2, t(*q), k, one2)
            same_as_jax(got, jcv.scalar_mul_const(jcv.F2, q, k, one2.numpy()))
            inf = cv.jac_is_inf(cv.F2, got)
            assert inf.tolist() == [k == C.R] * 2
            assert cv.jac_is_inf_val(cv.F2, got).tolist() == inf.tolist()


def test_jac_neg_and_value_infinity():
    pts = [C.g1_mul(G1_GEN, k) for k in (3, 5)]
    x, y = g1_limbs(pts)
    z = np.stack([fp.ONE_MONT_LIMBS, fp.P_LIMBS])  # p: a relaxed zero, not exact zero
    pt = t(x, y, z)
    neg = cv.jac_neg(cv.F1, pt)
    same_as_jax(neg, jcv.jac_neg(jcv.F1, (x, y, z)))
    assert torch.equal(neg[0], pt[0]) and torch.equal(neg[2], pt[2])
    assert cv.jac_is_inf(cv.F1, pt).tolist() == [False, False]
    assert cv.jac_is_inf_val(cv.F1, pt).tolist() == [False, True]
    assert np.asarray(jcv.jac_is_inf_val(jcv.F1, (x, y, z))).tolist() == [False, True]
