"""Batched BLS12-381 base-field arithmetic on limb tensors — relaxed form.

The PyTorch counterpart of ``lodestar_tpu.ops.fp``, in the **same
representation**, so that every op gives the same limbs as the JAX
package on the same input:

* An Fp element is **33** little-endian limbs of 12 bits in int32, shape
  (..., 33). R = 2^396, so R/p ~ 2^14.8 of headroom.
* **Relaxed, signed contract.** Values lie in (-2.1p, 2.2p) (Montgomery
  outputs in (-0.001p, 1.03p)); limbs are SIGNED with |limb| <= ~2^12+70.
  `canon()` restores the canonical form at program boundaries only.
* **Accumulator domain.** A product a*b lives as a 66-limb accumulator
  (`mul_acc`); accumulators add and subtract elementwise, and one
  Montgomery reduction (`redc`) serves a whole signed *sum* of products.
* Montgomery reduction is the separated two-multiplication form
  (m = t_lo * P' mod R; (t + m p)/R). Signed inputs are handled by adding
  2*R*p before the division and subtracting 2p after: value-neutral mod p,
  keeps the quotient positive, and maps exact zero to exact zero. The low
  half s_lo is exactly 0 or R; its limb 32 is <= 1 in the zero case and
  >= 4095 in the R case, so the carry is the test s_lo[32] >= 2048.
* **Exact zero** (all limbs 0) is preserved by mul/redc, which lets
  Jacobian infinity (Z = 0) propagate without canonicalization.
  `is_zero`/`eq` are limb-pattern tests; `is_zero_mod` decides
  value == 0 (mod p) for any relaxed input.

Bounds ledger (int32 safety; all limb bounds are on |limb|):
  limb bound after 2 carry passes   <= 4095 + 66        (LIMB_LOOSE)
  conv coefficient                  <= 33 * 4161^2      < 2^30
  acc sums (k terms)                limbs <= ~2^15, redc pre-carries
  redc input value budget           |t| << p*R ~ 30,000 p^2 (we use < ~10^2 p^2)
  redc output value                 in (-0.001p, |t|/(pR)*p + 1.03p)

Shifts: torch's ``>>`` on int32 is arithmetic (floor division by 2^12,
also for negative limbs) and ``&`` works on the two's-complement pattern,
so ``x & 0xfff == x - (x >> 12) * 4096`` for every int32 x.

The five base-field products (`mul_acc`, `sq_acc`, `redc`, `mont_mul`,
`mont_sq`) run their plain PyTorch version (`plain_*`) on CPU tensors and
the hand-written CUDA kernel of `fp_cuda` on CUDA tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto.bls.fields import P
from . import fp_cuda

__all__ = [
    "LIMBS",
    "LIMB_BITS",
    "LIMB_LOOSE",
    "P",
    "limbs_from_int",
    "int_from_limbs",
    "limbs_from_ints",
    "ints_from_limbs",
    "mont_limbs_from_int",
    "const",
    "zero",
    "one_mont",
    "to_mont",
    "from_mont",
    "add",
    "sub",
    "neg",
    "mont_mul",
    "mont_sq",
    "mul_acc",
    "plain_mul_acc",
    "plain_sq_acc",
    "plain_redc",
    "plain_mont_mul",
    "plain_mont_sq",
    "sq_acc",
    "acc_add",
    "acc_sub",
    "redc",
    "canon",
    "pow_const",
    "inv",
    "is_zero",
    "is_zero_mod",
    "eq",
]

LIMB_BITS = 12
LIMB_MASK = (1 << LIMB_BITS) - 1
LIMBS = 33  # 33 * 12 = 396 bits
ACC_LIMBS = 2 * LIMBS

# --- host-side conversions --------------------------------------------------


def limbs_from_int(x: int) -> np.ndarray:
    """Python int -> (33,) int32 little-endian 12-bit limbs."""
    if not 0 <= x < (1 << (LIMBS * LIMB_BITS)):
        raise ValueError("value out of limb range")
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)], dtype=np.int32)


def int_from_limbs(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.int64).reshape(-1)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))


def limbs_from_ints(xs) -> np.ndarray:
    """List of ints -> (N, 33) int32."""
    return np.stack([limbs_from_int(x) for x in xs])


def mont_limbs_from_int(x: int) -> np.ndarray:
    """Host-side Montgomery-form limbs of x: x * 2^396 mod p. The way to
    build mont-form constants without touching a device."""
    return limbs_from_int(x * (1 << (LIMBS * LIMB_BITS)) % P)


def ints_from_limbs(arr) -> list[int]:
    a = np.asarray(arr)
    return [int_from_limbs(a[i]) for i in range(a.shape[0])]


# --- constants --------------------------------------------------------------

P_LIMBS = limbs_from_int(P)
R_MOD_P = (1 << (LIMBS * LIMB_BITS)) % P  # 2^396 mod p (the Montgomery "1")
R2_MOD_P = pow(1 << (LIMBS * LIMB_BITS), 2, P)
ONE_MONT_LIMBS = limbs_from_int(R_MOD_P)
R2_LIMBS = limbs_from_int(R2_MOD_P)

# Full-width Montgomery factor P' = -P^{-1} mod 2^396.
PPRIME_FULL = (-pow(P, -1, 1 << (LIMBS * LIMB_BITS))) % (1 << (LIMBS * LIMB_BITS))
PPRIME_LIMBS = limbs_from_int(PPRIME_FULL)

# redc positivity offset 2*R*p (low 33 limbs exactly zero) and its
# quotient 2p: redc computes (t + m*p + 2Rp)/R - 2p.
TWO_RP_LIMBS = np.concatenate([np.zeros(LIMBS, dtype=np.int32), limbs_from_int(2 * P)])
TWO_P_LIMBS = limbs_from_int(2 * P)
FOUR_P_LIMBS = limbs_from_int(4 * P)

_CONSTS = {
    "p": P_LIMBS,
    "pprime": PPRIME_LIMBS,
    "one_mont": ONE_MONT_LIMBS,
    "r2": R2_LIMBS,
    "two_rp": TWO_RP_LIMBS,
    "two_p": TWO_P_LIMBS,
    "four_p": FOUR_P_LIMBS,
}


@functools.lru_cache(maxsize=None)
def _const_on(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_CONSTS[name], dtype=torch.int32, device=device)


def const(arr_or_name, device) -> torch.Tensor:
    """A host constant as an int32 tensor on `device`. Named module
    constants are cached per device (one host-to-device copy each);
    numpy arrays are copied on each call."""
    if isinstance(arr_or_name, str):
        return _const_on(arr_or_name, torch.device(device))
    return torch.as_tensor(np.asarray(arr_or_name, dtype=np.int32), device=device)


def zero(batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*batch_shape, LIMBS), dtype=torch.int32, device=device)


def one_mont(batch_shape=(), device="cpu") -> torch.Tensor:
    """Montgomery one, broadcast (a read-only expanded view)."""
    return _const_on("one_mont", torch.device(device)).expand(*batch_shape, LIMBS)


# --- carry handling ---------------------------------------------------------


def _carry_once(x: torch.Tensor, drop_top: bool = False) -> torch.Tensor:
    """One signed carry-propagation pass over the last axis.

    By default the TOP limb keeps its carry (dropping it would shift the
    value by k*2^(12n), which is not 0 mod p). drop_top=True drops it: the
    mod-R truncation of m = t*P' inside `redc` is the one place where that
    is the semantics."""
    c = x >> LIMB_BITS  # arithmetic: floor(x / 4096), negatives included
    if drop_top:
        out = x & LIMB_MASK
    else:
        c[..., -1].zero_()  # the top limb keeps its carry (a fill on the device)
        out = x - (c << LIMB_BITS)
    out[..., 1:] += c[..., :-1]  # c and out are fresh tensors
    return out


def _carry2(x: torch.Tensor, drop_top: bool = False) -> torch.Tensor:
    """Two parallel carry passes: |limbs| < 2^30 in -> limbs in
    [-66, 4095 + 66] (top limb: small, exact), value preserved."""
    return _carry_once(_carry_once(x, drop_top), drop_top)


LIMB_LOOSE = LIMB_MASK + 66  # post-_carry2 |limb| bound


def _carry_seq(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry normalization (boundary use only, `canon`):
    12-bit-clean limbs, top carry dropped."""
    carry = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    out = []
    for i in range(x.shape[-1]):
        t = x[..., i] + carry
        out.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out, dim=-1)


def _cond_sub(x: torch.Tensor, name: str) -> torch.Tensor:
    """x - c if x >= c else x (c a canonical named constant); x must be
    12-bit clean. Boundary use only."""
    d = x - _const_on(name, x.device)
    borrow = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    out = []
    for i in range(x.shape[-1]):
        t = d[..., i] - borrow
        borrow = (t < 0).to(torch.int32)
        out.append(t + (borrow << LIMB_BITS))
    ge = borrow == 0
    return torch.where(ge[..., None], torch.stack(out, dim=-1), x)


# --- element ops (relaxed) --------------------------------------------------


def add(a, b):
    """a + b (mod-p value); relaxed in, relaxed out (one parallel carry)."""
    return _carry_once(a + b)


def sub(a, b):
    """a - b (signed limbs; value in (-2.1p, 2.2p)); one parallel carry."""
    return _carry_once(a - b)


def neg(a):
    """-a (signed). Preserves exact zero."""
    return _carry_once(-a)


# --- the plain convolutions behind the kernels' plain versions ---------------
# The 33-term shifted multiply-accumulate of the Pallas kernel body: row j
# of the (.., 33, 33) product table is one operand times limb j of the
# other, shifted up by j places, and the rows are summed. The shift of
# every row happens at once by the skew trick of `_shifted_row_sum`. Every
# partial sum is an exact int32 inside the ledger, so the order of the
# additions does not matter.

def _shifted_row_sum(rows: torch.Tensor) -> torch.Tensor:
    """(.., 33, 33) rows -> (.., 66): sum over j of rows[j] shifted up by
    j limbs. Each row is padded to 67 entries; read back as rows of 66,
    row j's entry c lands at column j + c."""
    lead = rows.shape[:-2]
    padded = torch.nn.functional.pad(rows, (0, ACC_LIMBS + 1 - LIMBS))
    skewed = padded.reshape(*lead, LIMBS * (ACC_LIMBS + 1))[..., : LIMBS * ACC_LIMBS]
    return skewed.reshape(*lead, LIMBS, ACC_LIMBS).sum(dim=-2, dtype=torch.int32)


def _conv_var(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product (.., 33) x (.., 33) -> (.., 66) coefficients."""
    return _shifted_row_sum(b[..., :, None] * a[..., None, :])


def _conv_const(x: torch.Tensor, name: str) -> torch.Tensor:
    """x * c for a named 33-limb constant c, (.., 33) -> (.., 66)."""
    return _shifted_row_sum(_const_on(name, x.device)[:, None] * x[..., None, :])


def _conv_pprime_low(x: torch.Tensor) -> torch.Tensor:
    """First 33 coefficients of x * P' (the product mod 2^396)."""
    return _conv_const(x, "pprime")[..., :LIMBS]


def _conv_p_full(x: torch.Tensor) -> torch.Tensor:
    """Full product x * p as (.., 66) coefficients."""
    return _conv_const(x, "p")


# --- the plain versions of the five kernels ---------------------------------
# The CPU path and the spec that `fp_cuda`'s kernels are held against.


def plain_mul_acc(a, b):
    """Schoolbook 33x33 convolution, then two signed carry passes keeping
    the top limb: (.., 33) x (.., 33) -> (.., 66)."""
    return _carry2(_conv_var(a, b))


def plain_sq_acc(a):
    return plain_mul_acc(a, a)


def plain_redc(t):
    """(t + m*p + 2Rp)/R - 2p with m = t_lo * P' mod R, for a (.., 66)
    accumulator or signed sum of accumulators."""
    t = _carry_once(t)  # absorb accumulator sums (limbs <= ~2^15 -> loose)
    m = _carry2(_conv_pprime_low(t[..., :LIMBS]), drop_top=True)  # mod R
    s = _carry2(t + _conv_p_full(m) + _const_on("two_rp", t.device))
    carry = (s[..., LIMBS - 1] >= 2048).to(torch.int32)
    hi = s[..., LIMBS:].clone()
    hi[..., 0] += carry
    return _carry_once(hi - _const_on("two_p", t.device))


def plain_mont_mul(a, b):
    return plain_redc(plain_mul_acc(a, b))


def plain_mont_sq(a):
    return plain_redc(plain_mul_acc(a, a))


# --- accumulator domain -----------------------------------------------------
# The five products run the plain version on CPU tensors and the CUDA
# kernel (`fp_cuda`) on any other tensors; nothing else decides.


def mul_acc(a, b):
    """Product accumulator: value(a)*value(b) as 66 loose limbs."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return plain_mul_acc(a, b)
    return fp_cuda.mul_acc(a, b)


def sq_acc(a):
    if a.device.type == "cpu":
        return plain_sq_acc(a)
    return fp_cuda.sq_acc(a)


def acc_add(*ts):
    """Sum accumulators. Ends with one parallel carry pass so the result's
    limbs are loose again (safe as a later acc_sub subtrahend)."""
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return _carry_once(out)


def acc_sub(t, u):
    """t - u (signed limbs). Ends with one carry pass (nestable)."""
    return _carry_once(t - u)


def redc(t):
    """Montgomery reduction of a (.., 66) accumulator (or signed sum of
    accumulators): t * R^{-1} mod p, relaxed in (-0.001p, ~1.03p)."""
    if t.device.type == "cpu":
        return plain_redc(t)
    return fp_cuda.redc(t)


def mont_mul(a, b):
    """Montgomery product abR^{-1} mod p; relaxed in/out, exact-zero
    preserving."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return plain_mont_mul(a, b)
    return fp_cuda.mont_mul(a, b)


def mont_sq(a):
    if a.device.type == "cpu":
        return plain_mont_sq(a)
    return fp_cuda.mont_sq(a)


def to_mont(a):
    """Standard -> Montgomery form (a * R mod p)."""
    return mont_mul(a, _const_on("r2", a.device))


def canon(a):
    """Relaxed signed (|value| < 2.3p) -> canonical (< p, 12-bit clean).
    Boundary op: one sequential carry + three conditional subtracts (the
    input is offset by +4p to clear negativity first)."""
    y = _carry_seq(a + _const_on("four_p", a.device))  # value in (1.7p, 6.3p)
    y = _cond_sub(y, "four_p")
    y = _cond_sub(y, "two_p")
    return _cond_sub(y, "p")


def _widen(a):
    """(.., 33) element -> (.., 66) accumulator of the same value."""
    return torch.cat([a, torch.zeros_like(a)], dim=-1)


def from_mont(a):
    """Montgomery -> standard CANONICAL form (boundary op)."""
    return canon(redc(_widen(a)))


def pow_const(a, e: int):
    """a^e for a static exponent: square-and-always-multiply over the bit
    string (a zero bit multiplies by one, as the JAX package does, which
    keeps the limbs identical). a in Montgomery form, relaxed."""
    one = one_mont(a.shape[:-1], a.device)
    if e == 0:
        return one
    bits = bin(e)[3:]  # the leading 1 is the starting value a
    r = a
    for bit in bits:
        r = mont_sq(r)
        r = mont_mul(r, a if bit == "1" else one)
    return r


def inv(a):
    """a^{-1} via Fermat (a^(p-2)); a in Montgomery form, a != 0."""
    return pow_const(a, P - 2)


def is_zero(a):
    """Exact-zero limb test (infinity flags); NOT a value test. Use
    `is_zero_mod` for value semantics."""
    return torch.all(a == 0, dim=-1)


def is_zero_mod(a):
    """value(a) == 0 (mod p) for any relaxed/wide input (< ~2^19 p).
    One redc + one canon: boundary predicates only."""
    return torch.all(canon(redc(_widen(a))) == 0, dim=-1)


def eq(a, b):
    """Value equality of relaxed elements (canonicalizes both)."""
    return torch.all(canon(a) == canon(b), dim=-1)

