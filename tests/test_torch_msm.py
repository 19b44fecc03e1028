"""The port's MSM (`lodestar_tpu_torch.ops.msm`) held against
`lodestar_tpu.ops.msm`, limb for limb, and against the pure-Python oracle
on canonical affine values.

Tolerance: none (exact integer equality). The cases of the JAX package's
own MSM tests (`tests/ops/test_msm.py`): (n, width) = (4, 16) and (9, 64),
zero scalars and plain aggregation; then a G2 MSM on 3 points and the
bit matrix. Both sides get the same numpy limbs (the JAX package's
`to_mont` of the oracle points); the port runs on CPU tensors (the
kernels' plain versions).
"""

import random

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import curve as C
from lodestar_tpu.crypto.bls import fields as F
from lodestar_tpu.ops import msm as jmsm
from lodestar_tpu_torch.ops import fp, msm, prep, tower as tw

from .ops.util import g1_to_dev


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread: the tensors are small, and the MSM is thousands
    of small ops a bit, so worker threads only spin against the other
    test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(*arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)


def same_as_jax(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def g1_value(pt):
    """Unbatched Jacobian G1 limbs -> oracle affine point (None = infinity)."""
    X, Y, Z = (fp.int_from_limbs(fp.from_mont(c[None]).numpy()) for c in pt)
    if Z == 0:
        return None
    zi = F.fp_inv(Z)
    return X * zi * zi % F.P, Y * zi * zi * zi % F.P


def g2_value(pt):
    """Unbatched Jacobian G2 limbs -> oracle affine point (None = infinity)."""
    X, Y, Z = (tw.fp2_to_ints(c[None])[0] for c in pt)
    if Z == (0, 0):
        return None
    zi = F.fp2_inv(Z)
    zi2 = F.fp2_mul(zi, zi)
    return F.fp2_mul(X, zi2), F.fp2_mul(Y, F.fp2_mul(zi2, zi))


def oracle_msm(points, scalars, add=C.g1_add, mul=C.g1_mul):
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, mul(pt, s))
    return acc


@pytest.mark.parametrize("n,width", [(4, 16), (9, 64)])
def test_msm_g1_matches_jax_and_oracle(n, width):
    rng = random.Random(42 + n)
    points = [C.g1_mul(C.G1_GEN, rng.randrange(1, C.R)) for _ in range(n)]
    scalars = [rng.randrange(0, 1 << width) for _ in range(n)]
    xs, ys = g1_to_dev(points)
    bits = msm.bits_msb(scalars, width)
    got = msm.msm_g1(t(xs, ys), bits)
    same_as_jax(got, jmsm.msm_g1((xs, ys), bits))
    assert g1_value(got) == oracle_msm(points, scalars)


def test_msm_zero_scalars_and_aggregate():
    rng = random.Random(7)
    points = [C.g1_mul(C.G1_GEN, rng.randrange(1, C.R)) for _ in range(5)]
    scalars = [0, 1, 0, 3, 0]
    xs, ys = g1_to_dev(points)
    bits = msm.bits_msb(scalars, 8)
    got = msm.msm_g1(t(xs, ys), bits)
    same_as_jax(got, jmsm.msm_g1((xs, ys), bits))
    assert g1_value(got) == oracle_msm(points, scalars)

    agg = msm.aggregate_points_g1(t(xs, ys))
    same_as_jax(agg, jmsm.aggregate_points_g1((xs, ys)))
    assert g1_value(agg) == oracle_msm(points, [1] * 5)

    # every scalar zero: the exact-zero infinity, not merely a value zero
    zero = msm.msm_g1(t(xs, ys), msm.bits_msb([0] * 5, 8))
    assert all(int(torch.count_nonzero(c)) == 0 for c in zero)


def test_msm_g2_three_points():
    rng = random.Random(11)
    points = [C.g2_mul(C.G2_GEN, rng.randrange(1, C.R)) for _ in range(3)]
    scalars = [rng.randrange(0, 1 << 8) for _ in range(3)]
    xs = np.stack([tw._fp2_mont_limbs_host(*p[0]) for p in points])
    ys = np.stack([tw._fp2_mont_limbs_host(*p[1]) for p in points])
    bits = msm.bits_msb(scalars, 8)
    got = msm.msm_g2(t(xs, ys), bits)
    same_as_jax(got, jmsm.msm_g2((xs, ys), bits))
    assert g2_value(got) == oracle_msm(points, scalars, C.g2_add, C.g2_mul)


def test_bits_msb_matches_jax():
    rng = random.Random(3)
    for width in (1, 8, 16, 64, 255, 256):
        scalars = [0, 1, (1 << width) - 1, 1 << width, -5]
        scalars += [rng.randrange(0, 1 << (width + 4)) for _ in range(12)]
        got = msm.bits_msb(scalars, width)
        assert got.dtype == np.int32 and got.shape == (len(scalars), width)
        np.testing.assert_array_equal(got, jmsm.bits_msb(scalars, width))


def test_msm_g1_body_is_msm_g1_without_dispatch():
    """The graph body the KZG commitment captures gives msm_g1's limbs, with
    no counted dispatch of its own (the caller counts the one replay)."""
    rng = random.Random(5)
    points = [C.g1_mul(C.G1_GEN, rng.randrange(1, C.R)) for _ in range(4)]
    xs, ys = t(*g1_to_dev(points))
    bits = msm.bits_msb([rng.randrange(0, 1 << 12) for _ in range(4)], 12)
    before = prep.prep_launches_total()
    body = msm.msm_g1_body(xs, ys, torch.from_numpy(bits))
    assert prep.prep_launches_total() == before
    same_as_jax(body, msm.msm_g1((xs, ys), bits))
    assert prep.prep_launches_total() == before + 2
