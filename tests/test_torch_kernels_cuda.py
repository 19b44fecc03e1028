"""The five CUDA Fp kernels of the port against their plain PyTorch
versions, on a card.

Tolerance: none (bit-for-bit equality of int32 limbs). Every test here
carries the `cuda` marker and skips where `torch.cuda.is_available()` is
false. The file imports neither JAX nor the JAX package, so it also runs
on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.ops import fp, fp_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Fp kernels build and run only on a GPU")
    return torch.device("cuda")


def relaxed_rows(n, rng, dev):
    a = rng.integers(-66, fp.LIMB_LOOSE + 1, size=(n, fp.LIMBS)).astype(np.int32)
    a[:, -1] = rng.integers(-1, 2, size=n)
    a[0::5] = fp.LIMB_LOOSE
    a[2::5] = -fp.LIMB_LOOSE
    a[4::9] = 0
    return torch.from_numpy(a).to(dev)


def kernel_args(name, n, rng, dev):
    if name == "redc":
        a, b, c = (relaxed_rows(n, rng, dev) for _ in range(3))
        return (fp.plain_mul_acc(a, b) + fp.plain_mul_acc(b, c) - fp.plain_sq_acc(c),)
    if name in ("sq_acc", "mont_sq"):
        return (relaxed_rows(n, rng, dev),)
    return relaxed_rows(n, rng, dev), relaxed_rows(n, rng, dev)


# Edges of the kernels' tiles (16 rows at eight shares a row, 32 rows at
# four and in mul_acc), of the one-row path (n = 1) and the one-tile path
# (n <= 16), of sq_acc's 128-row blocks, of the switch from eight to four
# shares a row (16 rows per SM: 2,112 rows on an H100 SXM) and of redc's
# switch to its column-range body (five 32-row tiles per SM: 21,120 rows);
# the main path's row counts; and counts past one wave of the persistent
# blocks (each block then walks several tiles).
ROW_COUNTS = (1, 2, 12, 15, 16, 17, 31, 32, 33, 36, 63, 64, 65, 127, 128, 129, 2048, 2049,
              2112, 2113, 4096, 4098, 4099, 6147, 21120, 21121, 24588, 73764)


@pytest.mark.cuda
@pytest.mark.parametrize("name", fp_cuda.KERNELS)
def test_kernel_matches_plain_on_card(name, cuda_device):
    rng = np.random.default_rng(5)
    for n in ROW_COUNTS:
        args = kernel_args(name, n, rng, cuda_device)
        if name == "redc":
            args[0][1::13] = 0  # exact-zero accumulators stay exact zero
        before = fp_cuda.LAUNCHES[name]
        before_rows = fp_cuda.ROWS[name].get(n, 0)
        got = getattr(fp_cuda, name)(*args)
        torch.cuda.synchronize()
        assert fp_cuda.LAUNCHES[name] == before + 1
        assert fp_cuda.ROWS[name][n] == before_rows + 1
        want = getattr(fp, f"plain_{name}")(*args)
        assert torch.equal(got, want), f"{name} differs from its plain version at n={n}"
        if name == "redc":
            assert not got[1::13].any()


# The row counts a 2048-set input prep launches the kernels at beyond
# ROW_COUNTS: 4, 6, 10, 15, 40 and 60 rows a set (its Fp2 square-root
# chain runs at 10 and 15).
PREP_ROW_COUNTS = (8192, 12288, 20480, 30720, 81920, 122880)


@pytest.mark.cuda
@pytest.mark.parametrize("name", fp_cuda.KERNELS)
def test_kernel_matches_plain_at_prep_row_counts(name, cuda_device):
    rng = np.random.default_rng(10)
    for n in PREP_ROW_COUNTS:
        args = kernel_args(name, n, rng, cuda_device)
        got = getattr(fp_cuda, name)(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, getattr(fp, f"plain_{name}")(*args)), f"{name} at n={n}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 16, 17, 32, 33, 2048, 2112, 2113, 4096])
def test_sq_acc_paths_at_their_edges(n, cuda_device):
    """sq_acc's one-row path (n = 1), one-tile path (up to 16 rows at eight
    shares a row), tile loop at eight shares (up to 2,112 rows on an H100
    SXM) and at four, with worst-case and exact-zero rows."""
    rng = np.random.default_rng(11)
    a = relaxed_rows(n, rng, cuda_device)
    a[1::4] = 0
    a[3::4] = -fp.LIMB_LOOSE
    got = fp_cuda.sq_acc(a)
    torch.cuda.synchronize()
    assert got.shape == (n, 2 * fp.LIMBS)
    assert torch.equal(got, fp.plain_sq_acc(a))
    assert not got[1::4].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", fp_cuda.KERNELS)
def test_kernel_matches_plain_on_unaligned_rows(name, cuda_device):
    """Rows that do not start on a 16-byte boundary (a view one row into a
    tensor), so no bulk copy can take them."""
    rng = np.random.default_rng(6)
    for n in (17, 4098):
        args = tuple(x_full[1:] for x_full in kernel_args(name, n + 1, rng, cuda_device))
        assert all(x.data_ptr() % 16 for x in args)
        got = getattr(fp_cuda, name)(*args)
        torch.cuda.synchronize()
        want = getattr(fp, f"plain_{name}")(*args)
        assert torch.equal(got, want), f"{name} differs on unaligned rows at n={n}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 12, 16, 17, 2048, 4096])
def test_mont_mul_by_a_broadcast_row(n, cuda_device):
    """One row against many, the way `fp.pow_const` multiplies by one_mont
    (and by its base) at every step of a Fermat chain."""
    rng = np.random.default_rng(8)
    a = relaxed_rows(n, rng, cuda_device)
    for row in (fp.one_mont((1,), cuda_device), relaxed_rows(1, rng, cuda_device)):
        got = fp_cuda.mont_mul(a, row)
        torch.cuda.synchronize()
        assert got.shape == (n, fp.LIMBS)
        assert torch.equal(got, fp.plain_mont_mul(a, row.expand(n, -1)))
        assert torch.equal(fp_cuda.mont_mul(row, a), got)  # the product is symmetric


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mont_mul", "mont_sq"])
def test_exact_zero_rows_stay_exact_zero(name, cuda_device):
    rng = np.random.default_rng(9)
    for n in (1, 2, 16, 17, 2048, 4098):
        args = kernel_args(name, n, rng, cuda_device)
        args[0][1::3] = 0
        got = getattr(fp_cuda, name)(*args)
        torch.cuda.synchronize()
        assert not got[1::3].any(), f"{name}: a zero row is not exact zero at n={n}"
        assert torch.equal(got, getattr(fp, f"plain_{name}")(*args))


@pytest.mark.cuda
def test_wrappers_raise_on_bad_input(cuda_device):
    a = torch.zeros((4, fp.LIMBS), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        fp_cuda.mont_mul(a.long(), a.long())
    with pytest.raises(ValueError):
        fp_cuda.redc(a)  # a redc input has 66 limbs
    assert fp_cuda.mont_sq(a[:0]).shape == (0, fp.LIMBS)  # empty: no launch


@pytest.mark.cuda
def test_batch_verify_on_card(cuda_device):
    import dataclasses

    from lodestar_tpu_torch.models import batch_verify as bv

    sets = bv.make_synthetic_sets(4, seed=3)
    assert bv.verify_signature_sets_device(sets) is True
    bad = list(sets)
    bad[0] = dataclasses.replace(sets[0], signature=sets[1].signature)
    assert bv.verify_signature_sets_device(bad) is False


@pytest.mark.cuda
def test_device_prep_on_card_matches_the_cpu(cuda_device):
    """Input prep of four sets on the card (every product through the
    kernels) gives the limbs of the plain versions on the CPU."""
    from lodestar_tpu_torch.models import batch_verify as bv

    sets = bv.make_synthetic_sets(4, seed=5)
    on_card = bv.prepare_sets_device(sets, device=cuda_device)
    on_cpu = bv.prepare_sets_device(sets, device="cpu")
    for card_pt, cpu_pt in zip(on_card, on_cpu):
        for c_card, c_cpu in zip(card_pt, cpu_pt):
            assert torch.equal(c_card.cpu(), c_cpu)
