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


# Edges of the kernels' 32-row tiles and 128-row blocks (and of 16-row
# tiles), the main path's row counts, and counts past one wave of the
# persistent blocks (each block then walks several tiles).
ROW_COUNTS = (1, 12, 15, 16, 17, 31, 32, 33, 36, 63, 64, 65, 127, 128, 129, 4096, 4098,
              4099, 6147, 24588, 73764)


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
