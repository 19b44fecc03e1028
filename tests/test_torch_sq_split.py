"""The split of one row over threads in `redc_kernel`, `mont_mul_kernel`,
`mont_sq_kernel` and `sq_acc_kernel` (ops/csrc/fp_kernels.cu), modelled in
numpy on the CPU.

Each row of a tile has W threads (shares), all running the same code on
their own share of each step, chosen by the share's index q: the square
takes the rows i = q, q + W, ... of its triangle (2 * a_i * a_j for j > i,
plus a_i^2), a product and m * p take the operand limbs W' q .. W' q + W'
- 1 (and limb 32 for the last share; W' = 33 // W), the m-step the rows
i = q, q + W, ... of t_lo * P'. The shares' partial sums meet in shared
memory by atomic adds, and each carry pass runs over a window of columns
per share that reads the columns below it. W is 8 (16-row tiles) or 4 (32-row tiles),
read from the source (`shares_for`); 16 (8-row tiles) is checked too.

Checked on worst-case loose limbs (+-LIMB_LOOSE, alternating, in blocks),
random rows and exact-zero rows: the square's rows partition its triangle
(561 products), the summed shares equal `fp._conv_var` column by column,
the windowed carries equal the plain carry passes, the whole model equals
`fp.plain_mont_sq`, `fp.plain_mont_mul`, `fp.plain_redc` and
`fp.plain_sq_acc` limb for limb, and no partial sum reaches 2^30 whatever
order the atomic adds take (the int32 ledger of ops/fp.py), so the kernels'
int32 sums are these integers. `sq_acc`'s one-row path (all 128 threads of
a block on one row, as `mont_row`) is modelled too.

Tolerance: none (exact integers).
"""

import re

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.ops import fp, fp_cuda

L, A = fp.LIMBS, fp.ACC_LIMBS
LIMIT = 1 << 30  # the int32 ledger of ops/fp.py


def source_shares():
    """The shares a row that the entry points choose from (`shares_for`)."""
    with open(fp_cuda.SOURCE) as f:
        src = f.read()
    body = re.search(r"int shares_for\(int64_t n\) \{(.*?)\n\}", src, re.S).group(1)
    return tuple(int(w) for w in re.search(r"\? (\d+) : (\d+);", body).groups())


SHARES = (*source_shares(), 16)  # and 16-share rows (8-row tiles), which the split allows


class Ledger:
    """The largest magnitude any partial sum reached."""

    def __init__(self):
        self.largest = 0

    def see(self, *xs):
        for x in xs:
            self.largest = max(self.largest, int(np.abs(x).max()))


def shares_into(rows, cols, shares, ledger):
    """Atomic adds of each share's partial sums (offset, (n, k) array) into
    zeroed rows: the sum, and the worst any order of the adds can reach."""
    acc = np.zeros((rows, cols), np.int64)
    worst = np.zeros((rows, cols), np.int64)
    for off, p in shares:
        acc[:, off:off + p.shape[1]] += p
        worst[:, off:off + p.shape[1]] += np.abs(p)
    ledger.see(worst)
    return acc


def square_shares(a, w, ledger):
    slots = L // w + 1
    for q in range(w):
        rot = np.zeros((a.shape[0], L), np.int64)  # A[k] = a[q + k]
        rot[:, : L - q] = a[:, q:]
        p = np.zeros((a.shape[0], 2 * L - 1), np.int64)
        for s in range(slots):
            ai = rot[:, w * s]
            p[:, 2 * w * s] += ai * ai
            for k in range(1, L - w * s):
                p[:, 2 * w * s + k] += 2 * ai * rot[:, w * s + k]
                ledger.see(p[:, 2 * w * s + k])
        yield 2 * q, p


def product_shares(a, b, const_limbs, w, ledger):
    """a x b over b's limbs in shares (b may be a constant's limbs)."""
    base, n = L // w, a.shape[0]
    for q in range(w):
        slots = range(base * q, base * q + base + (q == w - 1))
        p = np.zeros((n, base + 1 + const_limbs - 1), np.int64)
        for s, j in enumerate(slots):
            for i in range(const_limbs):
                p[:, s + i] += a[:, i] * b[:, j]
                ledger.see(p[:, s + i])
        yield base * q, p


def m_shares(t_lo, w, ledger):
    pprime = fp.PPRIME_LIMBS.astype(np.int64)
    for q in range(w):
        p = np.zeros((t_lo.shape[0], L), np.int64)
        for i in range(q, L, w):
            s = (i - q) // w
            for k in range(L - w * s):
                p[:, w * s + k] += t_lo[:, i] * pprime[k]
                ledger.see(p[:, w * s + k])
        yield q, p


def windowed_carries(x, passes, width, keep_top, w):
    """Each share's window of `width` columns with `passes` of look-back,
    carried from the top down, as the kernel does; columns past the top
    are zero here (the kernel's are never written)."""
    n, cols = x.shape
    out = np.zeros_like(x)
    for q in range(w):
        c0 = width * q - passes
        idx = np.arange(c0, c0 + width + passes)
        win = np.where((idx >= 0) & (idx < cols), x[:, np.clip(idx, 0, cols - 1)], 0)
        for _ in range(passes):
            for k in range(win.shape[1] - 1, 0, -1):
                top = keep_top and idx[k] == cols - 1
                win[:, k] = (win[:, k] if top else win[:, k] & 4095) + (win[:, k - 1] >> 12)
        for k in range(passes, win.shape[1]):
            if idx[k] < cols:
                out[:, idx[k]] = win[:, k]
    return out


def model_reduce(t_raw, passes, w, ledger):
    """The reduction as the kernel shares it, from the raw accumulator."""
    cw, mw = -(-A // w), -(-L // w)
    u = windowed_carries(t_raw, passes, cw, True, w)
    two_p = fp.TWO_P_LIMBS.astype(np.int64)
    u[:, L:] += two_p
    m = shares_into(u.shape[0], L + w - 1, m_shares(u[:, :L], w, ledger), ledger)[:, :L]
    m2 = windowed_carries(m, 2, mw, False, w)
    p_limbs = np.broadcast_to(fp.P_LIMBS.astype(np.int64), m2.shape)
    mp = shares_into(u.shape[0], A, product_shares(p_limbs, m2, L - 1, w, ledger), ledger)
    u = u + mp
    ledger.see(u)
    x = fp._carry2(torch.from_numpy(u)).numpy()  # redc_out's windows equal full passes
    low_is_r = (x[:, L - 1] >= 2048).astype(np.int64)
    hi = x[:, L:] - two_p
    hi[:, 0] += low_is_r
    return fp._carry_once(torch.from_numpy(hi)).numpy()


def worst_rows(seed=17):
    rng = np.random.default_rng(seed)
    v = fp.LIMB_LOOSE
    alt = np.where(np.arange(L) % 2 == 0, v, -v)
    rows = [np.full(L, v), np.full(L, -v), alt, -alt, np.zeros(L),
            np.where(np.arange(L) < L // 2, v, -v)]
    rand = rng.integers(-66, v + 1, size=(26, L))
    rand[:, -1] = rng.integers(-1, 2, size=26)
    rand[3::5] = 0
    return np.concatenate([np.stack(rows), rand]).astype(np.int64)


def test_source_shares_are_supported():
    assert sorted(source_shares()) == [4, 8]
    assert all(L // w * w + 1 == L for w in SHARES)  # the last share's extra slot is limb 32


@pytest.mark.parametrize("w", SHARES)
def test_square_rows_partition_the_triangle(w):
    rows = sorted(q + w * s for q in range(w) for s in range(L // w + 1) if q + w * s < L)
    assert rows == list(range(L))
    products = sum(L - i for i in rows)
    assert products == 561
    # each thread runs the share of q = 0: every other share is no larger
    shares = [sum(L - i for i in range(q, L, w)) for q in range(w)]
    assert max(shares) == shares[0]


@pytest.mark.parametrize("w", SHARES)
def test_square_shares_sum_to_the_convolution(w):
    a = worst_rows()
    ledger = Ledger()
    got = shares_into(a.shape[0], A + 2 * w, square_shares(a, w, ledger), ledger)
    want = fp._conv_var(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert np.array_equal(got[:, :A], want)
    assert not got[:, A:].any()  # the spare columns above 65 get only zero products
    assert not got[4].any()  # the exact-zero row
    assert ledger.largest < LIMIT


@pytest.mark.parametrize("w", SHARES)
def test_windowed_carries_equal_the_plain_passes(w):
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 29), 1 << 29, size=(16, A))
    got = windowed_carries(x, 3, -(-A // w), True, w)
    want = fp._carry_once(fp._carry2(torch.from_numpy(x))).numpy()
    assert np.array_equal(got, want)
    m = rng.integers(-(1 << 29), 1 << 29, size=(16, L))
    got = windowed_carries(m, 2, -(-L // w), False, w)
    assert np.array_equal(got, fp._carry2(torch.from_numpy(m), drop_top=True).numpy())


@pytest.mark.parametrize("w", SHARES)
@pytest.mark.parametrize("name", ["mont_sq", "mont_mul", "redc"])
def test_shared_model_equals_the_plain_version(name, w):
    a = worst_rows()
    b = np.roll(worst_rows(seed=18), 3, axis=0)
    ledger = Ledger()
    if name == "mont_sq":
        t = shares_into(a.shape[0], A + 2 * w, square_shares(a, w, ledger), ledger)[:, :A]
        got = model_reduce(t, 3, w, ledger)
        want = fp.plain_mont_sq(torch.from_numpy(a.astype(np.int32)))
    elif name == "mont_mul":
        t = shares_into(a.shape[0], A, product_shares(a, b, L, w, ledger), ledger)
        got = model_reduce(t, 3, w, ledger)
        want = fp.plain_mont_mul(torch.from_numpy(a.astype(np.int32)),
                                 torch.from_numpy(b.astype(np.int32)))
    else:  # signed sums of three accumulators, as the verify feeds redc
        ta, tb, tc = (torch.from_numpy(x.astype(np.int32)) for x in (a, b, np.roll(a, 5, 0)))
        t = (fp.plain_mul_acc(ta, tb) + fp.plain_mul_acc(tb, tc) - fp.plain_sq_acc(tc)).numpy()
        t[4] = 0
        got = model_reduce(t.astype(np.int64), 1, w, ledger)
        want = fp.plain_redc(torch.from_numpy(t))
    assert np.array_equal(got, want.numpy())
    assert not got[4].any()  # exact zero stays exact zero
    assert ledger.largest < LIMIT


@pytest.mark.parametrize("w", SHARES)
def test_sq_acc_shares_equal_the_plain_version(w):
    """sq_acc's tile paths: the square's shares, then two windowed carry
    passes keeping the top limb, stored without a reduction."""
    a = worst_rows()
    ledger = Ledger()
    t = shares_into(a.shape[0], A + 2 * w, square_shares(a, w, ledger), ledger)
    assert not t[:, A:].any()  # the spare columns the carry windows read are zero
    got = windowed_carries(t[:, :A], 2, -(-A // w), True, w)
    want = fp.plain_sq_acc(torch.from_numpy(a.astype(np.int32)))
    assert np.array_equal(got, want.numpy())
    assert not got[4].any()  # exact zero stays exact zero
    assert ledger.largest < LIMIT


def one_row_product_shares(a, b, ledger):
    """The one-row split of `mont_row` and `sq_row`, 128 threads on one row:
    thread (warp q, lane l) adds a_l * b_j into column l + j for its slots
    j = 8q + s (s < 8, and s = 8, limb 32, on warp 3), and lane 0 adds
    a_32 * b_j into column 32 + j."""
    for q in range(4):
        slots = [8 * q + s for s in range(9) if s < 8 or q == 3]
        for lane in range(32):
            for j in slots:
                p = a[:, lane] * b[:, j]
                ledger.see(p)
                yield lane + j, p[:, None]
                if lane == 0:
                    yield 32 + j, (a[:, 32] * b[:, j])[:, None]


def test_sq_acc_one_row_split_equals_the_plain_version():
    a = worst_rows()
    ledger = Ledger()
    t = shares_into(a.shape[0], 128, one_row_product_shares(a, a, ledger), ledger)
    assert np.array_equal(t[:, :A], fp._conv_var(torch.from_numpy(a), torch.from_numpy(a)).numpy())
    assert not t[:, A:].any()
    # one column a thread, each reading the two columns below it
    got = windowed_carries(t[:, :A], 2, 1, True, A)
    want = fp.plain_sq_acc(torch.from_numpy(a.astype(np.int32)))
    assert np.array_equal(got, want.numpy())
    assert ledger.largest < LIMIT
