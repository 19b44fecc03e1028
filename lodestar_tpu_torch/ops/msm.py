"""Batched multi-scalar multiplication (MSM) on limb tensors.

PyTorch counterpart of ``lodestar_tpu.ops.msm``, with the same schedule
and so the same limbs: a select-based batched double-and-add. All N
points advance through the bit schedule in lockstep
(`curve.scalar_mul_var` with the exact addition, depth = nbits), then one
log2(N) tree fold (`curve.fold_sum`) sums them. No bucket scatter, no
gather: every step is a batch op over all N rows, so on the card every
base-field product of a bit is one kernel launch over all N points.

The KZG blob commitment (``crypto/kzg.py``) is the 4,096-point G1 MSM
over the monomial trusted setup; on the card it replays the body
(`msm_g1_body`) as one CUDA graph per pow-2 point count. Plain (scalar
free) aggregation is just the fold.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve as cv
from . import fp
from . import prep
from . import tower as tw

__all__ = ["bits_msb", "msm_g1", "msm_g1_body", "msm_g2", "aggregate_points_g1"]


def bits_msb(scalars, width: int) -> np.ndarray:
    """(N,) ints -> (N, width) int32 bit matrix, MSB first (bits of each
    scalar mod 2^width)."""
    nbytes = (width + 7) // 8
    mask = (1 << width) - 1
    raw = b"".join((int(s) & mask).to_bytes(nbytes, "big") for s in scalars)
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), nbytes), axis=1)
    return np.ascontiguousarray(bits[:, 8 * nbytes - width:], dtype=np.int32)


def _bits_on(bit_matrix, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(bit_matrix, dtype=torch.int32, device=like.device)


def msm_g1_body(x, y, bit_matrix):
    """sum_i scalar_i * (x_i, y_i) over G1 without a dispatch: the body the
    KZG commitment captures. x, y: (N, 33) mont-form affine coordinates;
    bit_matrix: (N, nbits) int32 MSB first. Returns the Jacobian sum as a
    tuple of three (33,) tensors."""
    acc = cv.scalar_mul_var(cv.F1, (x, y), bit_matrix, fp.one_mont(device=x.device), exact=True)
    return cv.fold_sum(cv.F1, acc)


def msm_g1(points_aff, bit_matrix):
    """sum_i scalar_i * P_i over G1, on the points' device.

    points_aff: (x, y) mont-form (N, 33) tensors; bit_matrix: (N, nbits)
    int32 MSB first (numpy or a tensor). Returns a Jacobian point (no
    batch dim). Scalar 0 rows contribute infinity (their running point
    stays the exact-zero Z). Two counted dispatches, as in the JAX
    package."""
    x, y = points_aff
    bits = _bits_on(bit_matrix, x)
    one = fp.one_mont(device=x.device)
    acc = prep._dispatch(cv.scalar_mul_var, cv.F1, (x, y), bits, one, exact=True)
    return prep._dispatch(cv.fold_sum, cv.F1, acc)


def msm_g2(points_aff, bit_matrix):
    """sum_i scalar_i * Q_i over the G2 twist ((N, 2, 33) coordinates)."""
    x, y = points_aff
    bits = _bits_on(bit_matrix, x)
    one = tw.fp2_one(device=x.device)
    acc = prep._dispatch(cv.scalar_mul_var, cv.F2, (x, y), bits, one, exact=True)
    return prep._dispatch(cv.fold_sum, cv.F2, acc)


def aggregate_points_g1(points_aff):
    """Plain sum of N affine G1 points (pubkey aggregation): one tree
    fold, no scalars."""
    x, y = points_aff
    jac = cv.affine_to_jac(cv.F1, (x, y), fp.one_mont(device=x.device))
    return prep._dispatch(cv.fold_sum, cv.F1, jac)
