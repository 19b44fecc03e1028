"""The limb split that an int8 tensor-core Montgomery reduction rests on.

Such a reduction runs its two constant products, t_lo * P' and m * p, as
int8 tensor-core products: every loose limb v is split as v = 128 * hi +
lo with lo in [0, 127], every constant limb the same way, and the four
partial products are recombined in int32 as ((hh * 128 + hl + lh) * 128 +
ll). `redc` was built that way for Hopper (int8 mma.sync) and measured
slower than its CUDA-core version, which ops/csrc/fp_kernels.cu keeps
(PERF.md). These tests check, in numpy and torch on the CPU, that the split
gives the value back on the port's own operands, that each piece fits
int8, and that the recombined products are the exact integers of the plain
version with every partial sum below 2^30.

Tolerance: none (exact integers).
"""

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.ops import fp

INT8 = (-128, 127)
LIMIT = 1 << 30  # the int32 ledger of ops/fp.py


def split(v):
    v = np.asarray(v, dtype=np.int64)
    return v >> 7, v & 127


def relaxed_rows(n, rng):
    a = rng.integers(-66, fp.LIMB_LOOSE + 1, size=(n, fp.LIMBS)).astype(np.int32)
    a[:, -1] = rng.integers(-1, 2, size=n)
    a[0::5] = fp.LIMB_LOOSE
    a[2::5] = -fp.LIMB_LOOSE
    a[3::5] = np.where(np.arange(fp.LIMBS) % 2 == 0, fp.LIMB_LOOSE, -fp.LIMB_LOOSE)
    a[4::9] = 0
    return torch.from_numpy(a)


def carried_three_accumulator_sums(n, seed):
    """`redc`'s operand after its first carry pass: signed sums of three
    accumulators, with exact-zero rows, through the port's `_carry_once`."""
    rng = np.random.default_rng(seed)
    a, b, c = (relaxed_rows(n, rng) for _ in range(3))
    t = fp.plain_mul_acc(a, b) + fp.plain_mul_acc(b, c) - fp.plain_sq_acc(c)
    t[1::7] = 0
    return fp._carry_once(t).numpy()


def toeplitz(c, cols):
    """Row i, column k: c[k - i] where 0 <= k - i < 33, else 0 (32 rows:
    limb 32 stays on the CUDA cores, outside the 16x32 int8 tiles)."""
    m = np.zeros((32, cols), np.int64)
    for i in range(32):
        for k in range(cols):
            if 0 <= k - i < fp.LIMBS:
                m[i, k] = c[k - i]
    return m


def test_split_recombines_worst_case_loose_limbs():
    v = np.arange(-fp.LIMB_LOOSE, fp.LIMB_LOOSE + 1)
    hi, lo = split(v)
    assert np.array_equal(128 * hi + lo, v)
    assert hi.min() == -33 and hi.max() == 32
    assert lo.min() == 0 and lo.max() == 127


@pytest.mark.parametrize("name", ["pprime", "p", "all_limbs"])
def test_split_of_the_constants(name):
    c = {"pprime": fp.PPRIME_LIMBS, "p": fp.P_LIMBS, "all_limbs": np.arange(4096)}[name]
    hi, lo = split(c)
    assert np.array_equal(128 * hi + lo, c)
    assert hi.min() >= 0 and hi.max() <= 31
    assert lo.min() >= 0 and lo.max() <= 127


@pytest.mark.parametrize("seed", [0, 1])
def test_split_of_carried_three_accumulator_sums(seed):
    t = carried_three_accumulator_sums(64, seed)
    assert np.abs(t[:, : fp.LIMBS]).max() <= fp.LIMB_LOOSE  # the tensor-core operand
    hi, lo = split(t)
    assert np.array_equal(128 * hi + lo, t)
    assert INT8[0] <= hi.min() and hi.max() <= INT8[1]
    assert 0 <= lo.min() and lo.max() <= 127


def recombine(x, mat):
    """The split product of (rows, 32) limbs and a (32, cols) constant
    matrix, with its partial sums: (result, max |partial sum|)."""
    xh, xl = split(x)
    mh, ml = split(mat)
    hh = xh @ mh
    mid = hh * 128 + xh @ ml + xl @ mh
    total = mid * 128 + xl @ ml
    partials = [hh, hh * 128, mid, mid * 128, total]
    return total, max(int(np.abs(p).max()) for p in partials)


@pytest.mark.parametrize("product", ["m_step", "m_times_p"])
def test_recombined_products_are_exact_inside_int32(product):
    t = carried_three_accumulator_sums(64, 2)
    if product == "m_step":  # t_lo * P', the low 33 columns
        x = t[:, :32]
        mat = toeplitz(fp.PPRIME_LIMBS, fp.LIMBS)
    else:  # m * p, m the carried m-step of the plain version
        m = fp._carry2(fp._conv_pprime_low(torch.from_numpy(t[:, : fp.LIMBS])), drop_top=True)
        x = m.numpy()[:, :32]
        assert np.abs(x).max() <= fp.LIMB_LOOSE
        mat = toeplitz(fp.P_LIMBS, 2 * fp.LIMBS)
    x = x.astype(np.int64)
    got, largest = recombine(x, mat)
    assert np.array_equal(got, x @ mat)
    assert largest < LIMIT
    # the worst case of the contract: every limb at -LIMB_LOOSE or +LIMB_LOOSE
    for v in (-fp.LIMB_LOOSE, fp.LIMB_LOOSE):
        worst = np.full((1, 32), v, np.int64)
        got, largest = recombine(worst, mat)
        assert np.array_equal(got, worst @ mat)
        assert largest < LIMIT
