"""The port's Fp2/Fp6/Fp12 tower (`lodestar_tpu_torch.ops.tower`) held
against `lodestar_tpu.ops.tower`, limb for limb, and against the
pure-Python oracle on canonical values; the six host converters (oracle
ints to limbs and back) against the JAX package's.

Tolerance: none (exact integer equality). Inputs are made with numpy from
fixed seeds; the relaxed inputs are outputs of tower arithmetic, so their
limbs are signed and non-canonical as on the main path.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import fields as F
from lodestar_tpu.ops import tower as jtw
from lodestar_tpu_torch.ops import fp, tower as tw

P = F.P


def rand_ints(n, seed):
    r = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        v = int.from_bytes(r.bytes(48), "little")
        if v < P:
            out.append(v)
    return out


def rand_fp12(n, seed):
    """n random Fp12 elements as oracle tuples and as (n, 2, 3, 2, 33)
    mont limbs."""
    xs = rand_ints(12 * n, seed)
    vals, limbs = [], []
    for i in range(n):
        c = xs[12 * i : 12 * i + 12]
        fp2s = [(c[2 * k], c[2 * k + 1]) for k in range(6)]
        vals.append((tuple(fp2s[:3]), tuple(fp2s[3:])))
        limbs.append(np.stack([tw._fp2_mont_limbs_host(*v) for v in fp2s]).reshape(2, 3, 2, fp.LIMBS))
    return vals, np.stack(limbs)


def relaxed_fp12(n, seed):
    """Relaxed Fp12 limbs: a product of two random elements (signed,
    non-canonical limbs), with its oracle value."""
    va, a = rand_fp12(n, seed)
    vb, b = rand_fp12(n, seed + 1)
    out = tw.fp12_mul(torch.from_numpy(a), torch.from_numpy(b))
    return [F.fp12_mul(x, y) for x, y in zip(va, vb)], out


def fp12_to_oracle(t):
    flat = fp.ints_from_limbs(fp.from_mont(t.reshape(-1, fp.LIMBS)).numpy())
    out = []
    for i in range(0, len(flat), 12):
        c = flat[i : i + 12]
        fp2s = [(c[2 * k], c[2 * k + 1]) for k in range(6)]
        out.append((tuple(fp2s[:3]), tuple(fp2s[3:])))
    return out


def same_as_jax(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def elems():
    va, a = relaxed_fp12(3, seed=40)
    vb, b = relaxed_fp12(3, seed=42)
    return va, a, vb, b


class TestFp2Fp6:
    def test_fp2_ops(self, elems):
        _, a, _, b = elems
        x, y = a[:, 0, 0], b[:, 1, 2]  # (3, 2, 33) Fp2 elements
        xn, yn = x.numpy(), y.numpy()
        same_as_jax(tw.fp2_mul(x, y), jtw.fp2_mul(xn, yn))
        same_as_jax(tw.fp2_sq(x), jtw.fp2_sq(xn))
        same_as_jax(tw.fp2_mul(x, x), jtw.fp2_mul(xn, xn))  # same object: the square
        same_as_jax(tw.fp2_mul(x, x), tw.fp2_sq(x))
        same_as_jax(tw.fp2_conj(x), jtw.fp2_conj(xn))
        same_as_jax(tw.fp2_mul_xi(x), jtw.fp2_mul_xi(xn))
        same_as_jax(tw.fp2_mul_fp(x, y[:, 0]), jtw.fp2_mul_fp(xn, yn[:, 0]))
        same_as_jax(tw.fp2_inv(x), jtw.fp2_inv(xn))

    def test_fp6_ops(self, elems):
        _, a, _, b = elems
        x, y = a[:, 1], b[:, 0]  # (3, 3, 2, 33) Fp6 elements
        xn, yn = x.numpy(), y.numpy()
        same_as_jax(tw.fp6_mul(x, y), jtw.fp6_mul(xn, yn))
        same_as_jax(tw.fp6_sq(x), jtw.fp6_sq(xn))
        same_as_jax(tw.fp6_mul(x, x), jtw.fp6_mul(xn, xn))
        same_as_jax(tw.fp6_mul_by_v(x), jtw.fp6_mul_by_v(xn))
        same_as_jax(tw.fp6_inv(x), jtw.fp6_inv(xn))


class TestFp12:
    def test_mul_sq_conj(self, elems):
        va, a, vb, b = elems
        an, bn = a.numpy(), b.numpy()
        got = tw.fp12_mul(a, b)
        same_as_jax(got, jtw.fp12_mul(an, bn))
        assert fp12_to_oracle(got) == [F.fp12_mul(x, y) for x, y in zip(va, vb)]
        same_as_jax(tw.fp12_sq(a), jtw.fp12_sq(an))
        same_as_jax(tw.fp12_conj(a), jtw.fp12_conj(an))

    def test_same_object_routes_to_square(self, elems, monkeypatch):
        va, a, _, _ = elems
        an = a.numpy()
        sq = tw.fp12_mul(a, a)
        same_as_jax(sq, jtw.fp12_mul(an, an))
        same_as_jax(sq, tw.fp12_sq(a))
        # a distinct tensor with the same limbs takes the general product
        general = tw.fp12_mul(a, a.clone())
        same_as_jax(general, jtw.fp12_mul(an, an.copy()))
        assert fp12_to_oracle(general) == fp12_to_oracle(sq) == [F.fp12_mul(x, x) for x in va]
        # the routing itself, at every level of the tower
        for name, x in (("fp2", a[:, 0, 0]), ("fp6", a[:, 0]), ("fp12", a)):
            monkeypatch.setattr(tw, f"{name}_sq", lambda t: "square")
            assert getattr(tw, f"{name}_mul")(x, x) == "square"
            assert isinstance(getattr(tw, f"{name}_mul")(x, x.clone()), torch.Tensor)

    def test_inv(self, elems):
        va, a, _, _ = elems
        got = tw.fp12_inv(a)
        same_as_jax(got, jtw.fp12_inv(a.numpy()))
        assert fp12_to_oracle(got) == [F.fp12_inv(x) for x in va]

    @pytest.mark.parametrize("power", [1, 2, 3])
    def test_frobenius(self, elems, power):
        va, a, _, _ = elems
        got = tw.fp12_frobenius(a, power)
        same_as_jax(got, jtw.fp12_frobenius(a.numpy(), power))
        assert fp12_to_oracle(got) == [F.fp12_frobenius(x, power) for x in va]

    def test_eq_one(self, elems):
        _, a, _, _ = elems
        one = tw.fp12_one((2,))
        batch = torch.cat([one, a[:1], tw.fp12_mul(a[1:2], tw.fp12_inv(a[1:2]))])
        assert tw.fp12_eq_one(batch).tolist() == [True, True, False, True]
        same_as_jax(tw.fp12_eq_one(batch), jtw.fp12_eq_one(batch.numpy()))

    def test_frobenius_constants_match(self):
        for k in (1, 2, 3):
            np.testing.assert_array_equal(tw._FROB_K[k], jtw._FROB_K[k])


class TestConverters:
    def test_fp2_from_ints_and_back(self):
        xs = rand_ints(8, seed=50)
        vals = [(xs[2 * i], xs[2 * i + 1]) for i in range(4)] + [(0, 0), (1, P - 1)]
        got = tw.fp2_from_ints(vals)
        assert isinstance(got, np.ndarray) and got.shape == (6, 2, fp.LIMBS)
        np.testing.assert_array_equal(got, np.asarray(jtw.fp2_from_ints(vals)))
        assert tw.fp2_to_ints(got) == vals
        assert tw.fp2_to_ints(torch.from_numpy(got)) == vals

    def test_fp2_to_ints_on_relaxed_limbs(self, elems):
        _, a, _, _ = elems
        x = a[:, 1, 2]  # (3, 2, 33): signed, non-canonical limbs
        assert tw.fp2_to_ints(x) == jtw.fp2_to_ints(x.numpy())

    def test_fp2_zero_and_mul_small(self, elems):
        _, a, _, _ = elems
        x = a[:, 0, 1]
        assert tw.fp2_zero((3,)).shape == (3, 2, fp.LIMBS) and not tw.fp2_zero((3,)).any()
        same_as_jax(tw.fp2_zero((2, 3)), jtw.fp2_zero((2, 3)))
        for k in (0, 1, 2, 5):
            got = tw.fp2_mul_small(x, k)
            same_as_jax(got, jtw.fp2_mul_small(x.numpy(), k))
            want = [(c0 * k % P, c1 * k % P) for c0, c1 in tw.fp2_to_ints(x)]
            assert tw.fp2_to_ints(got) == want

    def test_fp12_oracle_bridge(self, elems):
        va, a, _, _ = elems
        assert tw.fp12_to_oracle(a) == jtw.fp12_to_oracle(a.numpy()) == va
        assert tw.fp12_to_oracle(a.numpy()) == va
        vals, _ = rand_fp12(2, seed=60)
        got = tw.fp12_from_oracle(vals)
        assert got.shape == (2, 2, 3, 2, fp.LIMBS)
        np.testing.assert_array_equal(got, np.asarray(jtw.fp12_from_oracle(vals)))
        assert tw.fp12_to_oracle(got) == vals
