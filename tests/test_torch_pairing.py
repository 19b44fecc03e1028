"""The port's ate pairing (`lodestar_tpu_torch.ops.pairing`) held against
`lodestar_tpu.ops.pairing` limb for limb (Miller loop, final
exponentiation, masked product fold) and against the pure-Python oracle
`lodestar_tpu.crypto.bls.pairing` on canonical Fp12 values.

Tolerance: none (exact integer equality). Batch 4, the shapes of the JAX
package's own pairing tests, so the JAX side runs programs those tests
already compile; `multi_pairing_is_one` at pair class 2, the size of
every KZG check (one JAX compile), with a mask and a padding row.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import curve as C
from lodestar_tpu.crypto.bls import fields as F
from lodestar_tpu.crypto.bls import pairing as orc
from lodestar_tpu.crypto.bls.curve import G1_GEN, G2_GEN
from lodestar_tpu.ops import pairing as jprg
from lodestar_tpu.ops import tower as jtw
from lodestar_tpu_torch.ops import fp, pairing as prg, tower as tw

PAIRS4 = [
    (G1_GEN, G2_GEN),
    (C.g1_mul(G1_GEN, 5), C.g2_mul(G2_GEN, 7)),
    (C.g1_mul(G1_GEN, 123456789), C.g2_mul(G2_GEN, 987654321)),
    (C.g1_mul(G1_GEN, 31337), C.g2_mul(G2_GEN, 271828)),
]


def limbs(pairs):
    px = np.stack([fp.mont_limbs_from_int(p[0]) for p, _ in pairs])
    py = np.stack([fp.mont_limbs_from_int(p[1]) for p, _ in pairs])
    qx = np.stack([tw._fp2_mont_limbs_host(*q[0]) for _, q in pairs])
    qy = np.stack([tw._fp2_mont_limbs_host(*q[1]) for _, q in pairs])
    return px, py, qx, qy


def fp12_to_oracle(t):
    flat = fp.ints_from_limbs(fp.from_mont(t.reshape(-1, fp.LIMBS)).numpy())
    out = []
    for i in range(0, len(flat), 12):
        c = flat[i : i + 12]
        fp2s = [(c[2 * k], c[2 * k + 1]) for k in range(6)]
        out.append((tuple(fp2s[:3]), tuple(fp2s[3:])))
    return out


@pytest.fixture(scope="module")
def miller4():
    px, py, qx, qy = limbs(PAIRS4)
    got = prg.miller_loop((torch.from_numpy(px), torch.from_numpy(py)),
                          (torch.from_numpy(qx), torch.from_numpy(qy)))
    want = np.asarray(jprg.miller_loop((px, py), (qx, qy)))
    return got, want


def test_miller_loop_matches_jax(miller4):
    got, want = miller4
    assert got.shape == (4, 2, 3, 2, fp.LIMBS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_final_exponentiation_matches_jax_and_oracle(miller4):
    f, f_jax = miller4
    got = prg.final_exponentiation(f)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jprg.final_exponentiation(f_jax)))
    assert fp12_to_oracle(got) == [orc.pairing(p, q) for p, q in PAIRS4]


def test_product_fold_with_mask(miller4):
    f, f_jax = miller4
    mask = np.array([True, False, True, True])
    got = prg.fp12_product_fold(f[:3], mask=torch.from_numpy(mask[:3]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jprg.fp12_product_fold(f_jax[:3], mask=mask[:3]))
    )
    want = F.fp12_mul(*fp12_to_oracle(f[0:3:2]))
    assert fp12_to_oracle(got[None]) == [want]


def test_pairing_matches_jax_and_oracle():
    px, py, qx, qy = limbs(PAIRS4)
    got = prg.pairing((torch.from_numpy(px), torch.from_numpy(py)),
                      (torch.from_numpy(qx), torch.from_numpy(qy)))
    want = jprg.pairing((px, py), (qx, qy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tw.fp12_to_oracle(got) == jtw.fp12_to_oracle(np.asarray(want))
    assert tw.fp12_to_oracle(got) == [orc.pairing(p, q) for p, q in PAIRS4]


@pytest.mark.parametrize("mask", [[True, True], [True, False], [False, False]])
def test_multi_pairing_is_one_with_mask_matches_jax(mask):
    """e(5P, Q) * e(-5P, Q) == 1; with the second pair masked (a padding
    row) it is e(5P, Q) != 1; with both masked the empty product is 1."""
    p = C.g1_mul(G1_GEN, 5)
    px, py, qx, qy = limbs([(p, G2_GEN), (C.g1_neg(p), G2_GEN)])
    m = np.asarray(mask)
    got = prg.multi_pairing_is_one((torch.from_numpy(px), torch.from_numpy(py)),
                                   (torch.from_numpy(qx), torch.from_numpy(qy)),
                                   mask=torch.from_numpy(m))
    assert got.shape == () and got.dtype == torch.bool
    want = bool(jprg.multi_pairing_is_one((px, py), (qx, qy), mask=m))
    assert bool(got) == want == (mask != [True, False])
