"""Batch-verify input prep on the card: decompression, subgroup checks and
hash-to-G2, compressed bytes in.

PyTorch counterpart of ``lodestar_tpu.ops.prep``, with the same formulas
and the same limbs. The split of labour:

* **Host (numpy and hashlib, bytes only)**: compressed-point flag
  parsing, big-endian bytes to 12-bit limbs, the x < p encoding check and
  ``expand_message_xmd`` (SHA-256). No big-integer arithmetic per set.
* **Device (three counted stages, eager PyTorch)**: every field product
  goes through ``ops/fp.py`` and so, on the card, through the five CUDA
  kernels of ``ops/fp_cuda.py``; on CPU tensors their plain versions run.
  - G1 decompression: the x^3 + 4 square root by the p = 3 mod 4 chain
    a^((p+1)/4), the ZCash sign select, and the subgroup check
    phi(P) == -[x^2]P.
  - G2 decompression: the twist square root in Fp2 by the p^2 = 9 mod 16
    chain a^((p^2+7)/16) times {1, sqrt(-1), sqrt(sqrt(-1)),
    sqrt(-sqrt(-1))}, the Fp2 sign select, and psi(P) == [x]P.
  - `mont_from_wide`: the 512-bit hash_to_field outputs reduced to
    Montgomery form (lo R^2 + hi R^3 through `mont_mul`).
  - `map_to_g2_jac`: simplified SWU on the 3-isogenous curve E' and the
    3-isogeny, straight into Jacobian coordinates.
  - `hash_finish`: the sum of the two mapped points, Budroni-Pintore
    cofactor clearing and the batch affine conversion.

The production schedule (`prepare_arrays_fused`) is three stages: the
field stage (every square-root chain, the G2 root and the four SSWU
candidates sharing one Fp2 chain), the subgroup stage, and the hash
finish. `prepare_arrays_unfused` runs the five legs one by one and is the
fused schedule's differential reference. Every stage call goes through
`_dispatch`, which counts it. The chains are Python loops over static bit
strings: where a static bit is 0 the reference's select keeps the
accumulator, so the port skips the addition and gets the same limbs.

The ok bits stay on the device until the caller reads them once per
batch: nothing here synchronizes with the card. Module constants are
built with numpy from the port's own ``crypto/bls`` oracle copies, and
copied to a device once each, on first use there.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from .. import telemetry
from ..crypto.bls import curve as C
from ..crypto.bls import fields as F
from ..crypto.bls import hash_to_curve as H
from . import curve as cv
from . import fp
from . import tower as tw

__all__ = [
    "pad_pow2",
    "pad_rows",
    "be_bytes_to_limbs",
    "parse_g1_compressed",
    "parse_g2_compressed",
    "hash_to_field_limbs",
    "mont_from_wide",
    "fp2_sqrt_with_flag",
    "g1_decompress_subgroup",
    "g2_decompress_subgroup",
    "map_to_g2_jac",
    "hash_finish",
    "hash_to_g2_device",
    "configure_launch_counter",
    "prep_launches_total",
    "prepare_arrays_fused",
    "prepare_arrays_unfused",
    "FUSED_PREP_LAUNCHES",
    "UNFUSED_PREP_LAUNCHES",
    "SINGLE_LAUNCH_BUDGET",
]

P = F.P
LIMBS = fp.LIMBS
LIMB_BITS = fp.LIMB_BITS

# --- constants (numpy, from the oracle copies) --------------------------------

_P_BE48 = np.frombuffer(P.to_bytes(48, "big"), dtype=np.uint8)
_HALF_P_LIMBS = fp.limbs_from_int((P - 1) // 2)

_B1_MONT = fp.mont_limbs_from_int(F.B_G1)  # G1 b = 4
_B2_MONT = tw._fp2_mont_limbs_host(*C.B_G2)  # twist b' = 4(u + 1)
_BETA_MONT = fp.mont_limbs_from_int(C.BETA_G1)
_PSI_CX_MONT = tw._fp2_mont_limbs_host(*C._PSI_CX)
_PSI_CY_MONT = tw._fp2_mont_limbs_host(*C._PSI_CY)

# SSWU constants on the 3-isogenous curve E' (RFC 9380 section 8.8.2)
_A_MONT = tw._fp2_mont_limbs_host(*H._ISO_A)
_ISO_B_MONT = tw._fp2_mont_limbs_host(*H._ISO_B)
_Z_MONT = tw._fp2_mont_limbs_host(*H._Z)
_NEG_B_OVER_A_MONT = tw._fp2_mont_limbs_host(*H._NEG_B_OVER_A)
_B_OVER_ZA_MONT = tw._fp2_mont_limbs_host(*H._B_OVER_ZA)

# 3-isogeny coefficient stacks (degree ascending, Montgomery form)
_K1_MONT = np.stack([tw._fp2_mont_limbs_host(*c) for c in H._K1])
_K2_MONT = np.stack([tw._fp2_mont_limbs_host(*c) for c in H._K2])
_K3_MONT = np.stack([tw._fp2_mont_limbs_host(*c) for c in H._K3])
_K4_MONT = np.stack([tw._fp2_mont_limbs_host(*c) for c in H._K4])

# Fp2 square-root candidate multipliers for q = p^2 = 9 mod 16 (RFC 9380
# G.1.3): {1, sqrt(-1), sqrt(sqrt(-1)), sqrt(-sqrt(-1))}; sqrt(-1) = u in
# Fp[u]/(u^2 + 1), the two eighth roots from the oracle's square root.
_C2_INT = F.fp2_sqrt((0, 1))
_C3_INT = F.fp2_sqrt((0, P - 1))
assert _C2_INT is not None and _C3_INT is not None
_SQRT_CANDS = np.stack(
    [
        tw._fp2_mont_limbs_host(1, 0),
        tw._fp2_mont_limbs_host(0, 1),
        tw._fp2_mont_limbs_host(*_C2_INT),
        tw._fp2_mont_limbs_host(*_C3_INT),
    ]
)

# R^3 mod p: mont(lo + R hi) = mont_mul(lo, R^2) + mont_mul(hi, R^3)
_R3_LIMBS = fp.limbs_from_int(pow(1 << (LIMBS * LIMB_BITS), 3, P))

# static exponents (MSB first; the leading bit is always 1)
_E_FP_SQRT = (P + 1) // 4
_E_FP2_SQRT_BITS = np.array([int(b) for b in bin((P * P + 7) // 16)[2:]], dtype=np.int32)

# Montgomery-form Fp2 one, for affine_to_jac on G2 points
_ONE2 = np.zeros((2, LIMBS), dtype=np.int32)
_ONE2[0] = fp.ONE_MONT_LIMBS

_DEVICE_CONSTS = {
    "half_p": _HALF_P_LIMBS,
    "b1": _B1_MONT,
    "b2": _B2_MONT,
    "beta": _BETA_MONT,
    "psi_cx": _PSI_CX_MONT,
    "psi_cy": _PSI_CY_MONT,
    "a": _A_MONT,
    "iso_b": _ISO_B_MONT,
    "z": _Z_MONT,
    "neg_b_over_a": _NEG_B_OVER_A_MONT,
    "b_over_za": _B_OVER_ZA_MONT,
    "k1": _K1_MONT,
    "k2": _K2_MONT,
    "k3": _K3_MONT,
    "k4": _K4_MONT,
    "sqrt_cands": _SQRT_CANDS,
    "r2": fp.R2_LIMBS,
    "r3": _R3_LIMBS,
    "one2": _ONE2,
}


@functools.lru_cache(maxsize=None)
def _const_on(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_DEVICE_CONSTS[name], dtype=torch.int32, device=device)


def _c(name: str, like: torch.Tensor) -> torch.Tensor:
    """Module constant `name` on `like`'s device (one copy per device: a
    copy from host memory inside a chain would wait for the stream)."""
    return _const_on(name, like.device)


# --- the counted dispatch seam --------------------------------------------------

_launch_counter = None  # a Counter-like object with .inc(), or None
_launches_total = 0  # process-local monotonic count of stage calls; guarded by: _count_lock
_count_lock = threading.Lock()

#: stage calls of one `prepare_arrays_fused`: the field stage, the
#: subgroup stage and the hash finish, whatever the batch size
FUSED_PREP_LAUNCHES = 3
#: stage calls of one `prepare_arrays_unfused`: one per leg (G1 decompress,
#: G2 decompress, wide reduction, SSWU map, hash finish)
UNFUSED_PREP_LAUNCHES = 5
#: counted dispatches of one single-launch batch
#: (`models/batch_verify.py` `verify_sets_single_launch`): the whole chain,
#: field stage to final exponentiation, compressed bytes in and verdict out,
#: whatever the batch size; on the card one CUDA-graph replay
SINGLE_LAUNCH_BUDGET = 1


def configure_launch_counter(counter) -> None:
    """Install a counter (anything with .inc()) that `_dispatch` ticks
    beside the process-local count; None removes it."""
    global _launch_counter
    _launch_counter = counter


def prep_launches_total() -> int:
    """Stage calls issued by this module in this process."""
    return _launches_total


def _dispatch(program, *args, **kwargs):
    """Call one prep stage: the one place a stage call is counted (and
    timed, when launch telemetry is on)."""
    global _launches_total
    with _count_lock:
        _launches_total += 1
    c = _launch_counter
    if c is not None:
        c.inc()
    t0 = time.perf_counter() if telemetry.launch_telemetry_active() else 0.0
    out = program(*args, **kwargs)
    if t0:
        telemetry.record_launch(
            telemetry.program_name(program),
            telemetry.launch_size_class(args),
            time.perf_counter() - t0,
        )
    return out


def pad_pow2(n: int, floor: int = 8) -> int:
    """Next power of two >= max(floor, n): the size classes shared by the
    prep stages and the verify."""
    return max(floor, 1 << (n - 1).bit_length())


def pad_rows(a: np.ndarray, size: int) -> np.ndarray:
    """Pad the leading axis to `size` by repeating row 0 (every consumer
    masks or slices the padding rows away)."""
    n = a.shape[0]
    if size == n:
        return a
    return np.concatenate([a, np.repeat(a[:1], size - n, axis=0)], axis=0)


# --- host byte stage (numpy) ----------------------------------------------------


def be_bytes_to_limbs(data: np.ndarray, nlimbs: int = LIMBS) -> np.ndarray:
    """(N, nbytes) big-endian uint8 -> (N, nlimbs) int32 12-bit limbs
    (standard form, little-endian limb order); nbytes * 8 <= nlimbs * 12."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n, nbytes = data.shape
    if nbytes * 8 > nlimbs * LIMB_BITS:
        raise ValueError("value wider than limb budget")
    bits = np.unpackbits(data, axis=-1, bitorder="big")[:, ::-1]
    pad = nlimbs * LIMB_BITS - nbytes * 8
    if pad:
        bits = np.concatenate([bits, np.zeros((n, pad), dtype=np.uint8)], axis=-1)
    w = 1 << np.arange(LIMB_BITS, dtype=np.int32)
    return (bits.reshape(n, nlimbs, LIMB_BITS).astype(np.int32) * w).sum(axis=-1, dtype=np.int32)


def _lt_be(a: np.ndarray, b_const: np.ndarray) -> np.ndarray:
    """Lexicographic a < b for (N, nbytes) against (nbytes,)."""
    diff = a != b_const
    idx = diff.argmax(axis=-1)  # the most significant differing byte
    av = np.take_along_axis(a, idx[:, None], axis=-1)[:, 0]
    bv = b_const[idx]
    return np.where(diff.any(axis=-1), av < bv, False)


def parse_g1_compressed(buf: np.ndarray):
    """(N, 48) uint8 compressed G1 -> (x standard limbs, sign_larger, ok).

    ok is the structural check: compressed flag set, infinity flag clear
    (an infinity pubkey or signature rejects its set), x < p. Whether the
    point is on the curve and in the subgroup is decided on the device."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    flags = buf[:, 0]
    xb = buf.copy()
    xb[:, 0] &= 0x1F
    ok = ((flags & 0x80) != 0) & ((flags & 0x40) == 0) & _lt_be(xb, _P_BE48)
    return be_bytes_to_limbs(xb), (flags & 0x20) != 0, ok


def parse_g2_compressed(buf: np.ndarray):
    """(N, 96) uint8 compressed G2 -> (x standard limbs (N, 2, 33),
    sign_larger, ok)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    flags = buf[:, 0]
    x1b = buf[:, :48].copy()
    x1b[:, 0] &= 0x1F
    x0b = buf[:, 48:]
    ok = (
        ((flags & 0x80) != 0)
        & ((flags & 0x40) == 0)
        & _lt_be(x1b, _P_BE48)
        & _lt_be(x0b, _P_BE48)
    )
    x = np.stack([be_bytes_to_limbs(x0b), be_bytes_to_limbs(x1b)], axis=1)
    return x, (flags & 0x20) != 0, ok


_WIDE_LIMBS = 43  # a 512-bit hash_to_field chunk: 43 * 12 = 516 bits


def hash_to_field_limbs(msgs, dst: bytes = H.DST_G2):
    """hash_to_field(msg, count=2) for Fp2, split for the device reduction:
    expand_message_xmd on the host, the mod-p reduction in
    `mont_from_wide`. Returns (lo, hi) int32 arrays of shape (N, 2, 2, 33):
    element axis (u0, u1), then the Fp2 coefficient axis."""
    n = len(msgs)
    buf = np.empty((n, 4, 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        uniform = H.expand_message_xmd(bytes(m), dst, 4 * H._L)
        buf[i] = np.frombuffer(uniform, dtype=np.uint8).reshape(4, 64)
    wide = be_bytes_to_limbs(buf.reshape(n * 4, 64), nlimbs=_WIDE_LIMBS)
    lo = wide[:, :LIMBS]
    hi = np.zeros((n * 4, LIMBS), dtype=np.int32)
    hi[:, : _WIDE_LIMBS - LIMBS] = wide[:, LIMBS:]
    return lo.reshape(n, 2, 2, LIMBS), hi.reshape(n, 2, 2, LIMBS)


# --- device predicates ------------------------------------------------------------


def _limbs_gt(a, b_name: str):
    """Lexicographic a > b for canonical limbs (..., 33) against the named
    constant b (33,)."""
    b = _c(b_name, a)
    neq = a != b
    idx = (LIMBS - 1) - torch.argmax(neq.flip(-1).to(torch.int32), dim=-1)  # first = highest
    av = torch.gather(a, -1, idx[..., None])[..., 0]
    bv = b[idx]
    return neq.any(dim=-1) & (av > bv)


def _fp2_is_larger(y_std):
    """ZCash lexicographic sign of canonical Fp2 limbs: c1 decides, c0
    when c1 == 0."""
    y0, y1 = y_std[..., 0, :], y_std[..., 1, :]
    y1_zero = torch.all(y1 == 0, dim=-1)
    return torch.where(y1_zero, _limbs_gt(y0, "half_p"), _limbs_gt(y1, "half_p"))


def _fp2_eq_val(a, b):
    """Value equality of relaxed Fp2 elements (canonicalizes)."""
    eq = fp.canon(a) == fp.canon(b)
    return torch.all(torch.all(eq, dim=-1), dim=-1)


def _fp2_is_zero_mod(a):
    return fp.is_zero_mod(a[..., 0, :]) & fp.is_zero_mod(a[..., 1, :])


def _sgn0_fp2(a_std):
    """RFC 9380 section 4.1 sgn0 of canonical Fp2 limbs (..., 2, 33)."""
    sign_0 = a_std[..., 0, 0] & 1
    zero_0 = torch.all(a_std[..., 0, :] == 0, dim=-1)
    sign_1 = a_std[..., 1, 0] & 1
    return sign_0 | (zero_0.to(torch.int32) & sign_1)


def _jac_eq_affine(Fo, jac, aff):
    """jac == aff (a finite affine point), cross-multiplied: X == x Z^2,
    Y == y Z^3 mod p, and jac finite."""
    X, Y, Z = jac
    z2 = Fo.sq(Z)
    ex = Fo.is_zero_mod(Fo.sub(Fo.mul(aff[0], z2), X))
    ey = Fo.is_zero_mod(Fo.sub(Fo.mul(aff[1], Fo.mul(Z, z2)), Y))
    return ex & ey & ~Fo.is_zero(Z)


def _sel_pt(cond, a, b):
    """Select Jacobian points on a batch-bool cond (broadcast up)."""

    def sel(u, v):
        c = cond
        while c.dim() < u.dim():
            c = c[..., None]
        return torch.where(c, u, v)

    return tuple(sel(u, v) for u, v in zip(a, b))


# --- Fp2 square root (p^2 = 9 mod 16, candidate form) -----------------------------


def _fp2_pow_bits(a, bits):
    """a^e for a static MSB-first bit array (leading bit 1): square and
    always multiply, by one where the bit is 0 (as `fp.pow_const`)."""
    one = tw.fp2_one(a.shape[:-2], a.device)
    r = a
    for bit in bits[1:]:
        r = tw.fp2_sq(r)
        r = tw.fp2_mul(r, a if bit else one)
    return r


def fp2_sqrt_with_flag(a):
    """Batched Fp2 square root: (root, is_square).

    One a^((p^2+7)/16) chain, then the four candidate multipliers: exactly
    one squares back to a when a is a square (the first in candidate
    order is taken). Exact zero gives (0, True), as the oracle's
    `fp2_sqrt`; a non-residue gives (garbage, False)."""
    tv1 = _fp2_pow_bits(a, _E_FP2_SQRT_BITS)
    cands = tw.fp2_mul(tv1[..., None, :, :], _c("sqrt_cands", a))
    sq = tw.fp2_sq(cands)
    good = _fp2_eq_val(sq, a[..., None, :, :])
    ok = good.any(dim=-1)
    idx = torch.argmax(good.to(torch.int32), dim=-1)  # ties: the first index
    gather = idx[..., None, None, None].expand(*idx.shape, 1, 2, LIMBS)
    root = torch.gather(cands, -3, gather)[..., 0, :, :]
    return root, ok


# --- G1 / G2 decompression and subgroup legs ----------------------------------------


def _g1_subgroup(x, y):
    """phi(P) == -[x^2]P on affine Montgomery coordinates (the oracle's
    `g1_in_subgroup_fast`)."""
    r_ = cv.scalar_mul_const(cv.F1, (x, y), C.BLS_X2, fp.one_mont((), x.device))
    phi = (fp.mont_mul(x, _c("beta", x)), y)
    return _jac_eq_affine(cv.F1, cv.jac_neg(cv.F1, r_), phi)


def _g2_subgroup(x, y):
    """psi(P) == [x]P (x < 0: psi(P) == -[|x|]P) on affine Montgomery
    coordinates."""
    r_ = cv.scalar_mul_const(cv.F2, (x, y), F.BLS_X_ABS, _c("one2", x))
    psi = (
        tw.fp2_mul(tw.fp2_conj(x), _c("psi_cx", x)),
        tw.fp2_mul(tw.fp2_conj(y), _c("psi_cy", y)),
    )
    return _jac_eq_affine(cv.F2, cv.jac_neg(cv.F2, r_), psi)


def _g1_decompress_body(x_std, sign_larger):
    """G1 decompression without the subgroup check: to Montgomery form,
    x^3 + 4, the a^((p+1)/4) square-root chain, the ZCash sign select."""
    x = fp.to_mont(x_std)
    rhs = fp.add(fp.mont_mul(fp.mont_sq(x), x), _c("b1", x))
    y = fp.pow_const(rhs, _E_FP_SQRT)
    on_curve = fp.eq(fp.mont_sq(y), rhs)
    larger = _limbs_gt(fp.from_mont(y), "half_p")
    flip = larger != sign_larger
    y = torch.where(flip[..., None], fp.neg(y), y)
    return x, y, on_curve


def _g2_rhs(x_std):
    """G2 decompression up to the square root's input: to Montgomery form
    and x^3 + 4(u + 1)."""
    x = fp.to_mont(x_std)
    return x, tw.fp2_add(tw.fp2_mul(tw.fp2_sq(x), x), _c("b2", x))


def _g2_select_sign(y, sign_larger):
    """ZCash Fp2 sign select on a candidate root."""
    larger = _fp2_is_larger(fp.from_mont(y))
    flip = larger != sign_larger
    return torch.where(flip[..., None, None], tw.fp2_neg(y), y)


def g1_decompress_subgroup(x_std, sign_larger):
    """(N, 33) standard limbs + sign bits -> (x_mont, y_mont, ok), where ok
    is "on the curve" (x^3 + 4 has a square root) and the subgroup check.
    Invalid rows still carry in-contract relaxed limbs."""
    x, y, on_curve = _g1_decompress_body(x_std, sign_larger)
    return x, y, on_curve & _g1_subgroup(x, y)


def g2_decompress_subgroup(x_std, sign_larger):
    """(N, 2, 33) standard limbs + sign bits -> (x_mont, y_mont, ok) on the
    twist."""
    x, rhs = _g2_rhs(x_std)
    y, on_curve = fp2_sqrt_with_flag(rhs)
    y = _g2_select_sign(y, sign_larger)
    return x, y, on_curve & _g2_subgroup(x, y)


# --- hash-to-G2 legs ----------------------------------------------------------------


def mont_from_wide(lo_std, hi_std):
    """The 512-bit value n = lo + R hi (12-bit-clean halves) -> mont(n mod
    p): mont_mul(lo, R^2) + mont_mul(hi, R^3)."""
    return fp.add(
        fp.mont_mul(lo_std, _c("r2", lo_std)),
        fp.mont_mul(hi_std, _c("r3", hi_std)),
    )


def _horner(name: str, x):
    """sum_i c_i x^i for the named Montgomery coefficient stack."""
    coeffs = _c(name, x)
    acc = coeffs[-1].expand(x.shape)
    for i in range(coeffs.shape[0] - 2, -1, -1):
        acc = tw.fp2_add(tw.fp2_mul(acc, x), coeffs[i])
    return acc


def _gp(x):
    """The right-hand side of E': x^3 + A'x + B'."""
    return tw.fp2_add(
        tw.fp2_add(tw.fp2_mul(tw.fp2_sq(x), x), tw.fp2_mul(_c("a", x), x)),
        _c("iso_b", x),
    )


def _sswu_candidates(u):
    """Simplified SWU on E' up to the two candidate right-hand sides:
    (x1, x2, gx_both), gx_both stacking g(x1) and g(x2) on axis -3 so one
    square-root chain decides both."""
    tv1 = tw.fp2_mul(_c("z", u), tw.fp2_sq(u))
    tv2 = tw.fp2_add(tw.fp2_sq(tv1), tv1)
    tv2_zero = _fp2_is_zero_mod(tv2)
    x1 = tw.fp2_mul(
        _c("neg_b_over_a", u),
        tw.fp2_add(tw.fp2_one(u.shape[:-2], u.device), tw.fp2_inv(tv2)),
    )
    x1 = torch.where(tv2_zero[..., None, None], _c("b_over_za", u), x1)
    x2 = tw.fp2_mul(tv1, x1)
    both = torch.stack([_gp(x1), _gp(x2)], dim=-3)
    return x1, x2, both


def _sswu_finish(u, x1, x2, roots, oks):
    """SSWU candidate select, sign normalization and the 3-isogeny to
    Jacobian coordinates, from the shared chain's (roots, oks)."""
    ok1 = oks[..., 0]
    sel = ok1[..., None, None]
    x = torch.where(sel, x1, x2)
    y = torch.where(sel, roots[..., 0, :, :], roots[..., 1, :, :])
    flip = _sgn0_fp2(fp.from_mont(u)) != _sgn0_fp2(fp.from_mont(y))
    y = torch.where(flip[..., None, None], tw.fp2_neg(y), y)

    # the 3-isogeny E' -> E in Jacobian form: Z = xd yd, X = xn xd yd^2,
    # Y = y yn xd^3 yd^2; a pole makes Z = 0 mod p, set to exact zero below
    xn = _horner("k1", x)
    xd = _horner("k2", x)
    yn = _horner("k3", x)
    yd = _horner("k4", x)
    Z = tw.fp2_mul(xd, yd)
    yd2 = tw.fp2_sq(yd)
    xd3 = tw.fp2_mul(tw.fp2_sq(xd), xd)
    X = tw.fp2_mul(tw.fp2_mul(xn, xd), yd2)
    Y = tw.fp2_mul(tw.fp2_mul(y, yn), tw.fp2_mul(xd3, yd2))
    inf = _fp2_is_zero_mod(Z)[..., None, None]
    zero = torch.zeros_like(Z)
    return (
        torch.where(inf, zero, X),
        torch.where(inf, zero, Y),
        torch.where(inf, zero, Z),
    )


def map_to_g2_jac(u):
    """Simplified SWU on E' and the 3-isogeny, over any leading dims.

    u: (..., 2, 33) Montgomery Fp2 elements. Returns Jacobian (X, Y, Z) on
    the twist; an isogeny pole gives exact-zero infinity. The two
    candidate right-hand sides share one square-root chain; the y sign
    follows sgn0(u), so the result does not depend on which root the
    chain finds."""
    x1, x2, both = _sswu_candidates(u)
    roots, oks = fp2_sqrt_with_flag(both)
    return _sswu_finish(u, x1, x2, roots, oks)


def _psi_jac(pt):
    """psi on Jacobian coordinates: (conj(X) CX, conj(Y) CY, conj(Z));
    exact-zero infinity stays exact zero."""
    X, Y, Z = pt
    return (
        tw.fp2_mul(tw.fp2_conj(X), _c("psi_cx", X)),
        tw.fp2_mul(tw.fp2_conj(Y), _c("psi_cy", Y)),
        tw.fp2_conj(Z),
    )


def _jac_mul_static(pt, scalar: int):
    """[scalar]P for a static positive scalar and a Jacobian base: double
    every bit, and add P with the exact addition where the bit is set."""
    acc = tuple(torch.zeros_like(c) for c in pt)
    for bit in bin(scalar)[2:]:
        acc = cv.jac_double(cv.F2, acc)
        if bit == "1":
            acc = cv.jac_add(cv.F2, acc, pt, exact=True)
    return acc


def _clear_cofactor_jac(q):
    """Budroni-Pintore h_eff clearing, the oracle's schedule
    (`g2_clear_cofactor_fast`): [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P)."""
    c1 = F.BLS_X_ABS
    t1 = cv.jac_neg(cv.F2, _jac_mul_static(q, c1))
    t2 = _psi_jac(q)
    t3 = _psi_jac(_psi_jac(cv.jac_double(cv.F2, q)))
    t3 = cv.jac_add(cv.F2, t3, cv.jac_neg(cv.F2, t2), exact=True)
    t2 = cv.jac_add(cv.F2, t1, t2, exact=True)
    t2 = cv.jac_neg(cv.F2, _jac_mul_static(t2, c1))
    t3 = cv.jac_add(cv.F2, t3, t2, exact=True)
    t3 = cv.jac_add(cv.F2, t3, cv.jac_neg(cv.F2, t1), exact=True)
    return cv.jac_add(cv.F2, t3, cv.jac_neg(cv.F2, q), exact=True)


def hash_finish(q0, q1):
    """Add the two mapped points, clear the cofactor, convert to affine.
    Returns affine (h_x, h_y) Montgomery limbs. A hash landing on infinity
    after clearing is unreachable for SHA-256 outputs, so no infinity mask
    is carried."""
    q = cv.jac_add(cv.F2, q0, q1, exact=True)
    return cv.jac_to_affine_batch(cv.F2, _clear_cofactor_jac(q))


def hash_to_g2_device(msgs, dst: bytes = H.DST_G2, device=None):
    """Hash a batch of messages to G2: SHA-256 expansion on the host, the
    reduction, SSWU, isogeny and cofactor clearing on `device` (CUDA unless
    the caller names another). The batch is padded to a power of two >= 8
    by repeating the first message. Returns affine (h_x, h_y) Montgomery
    limbs of shape (N, 2, 33)."""
    n = len(msgs)
    if n == 0:
        raise ValueError("empty message batch")
    dev = torch.device("cuda" if device is None else device)
    size = pad_pow2(n)
    lo, hi = hash_to_field_limbs(list(msgs) + [msgs[0]] * (size - n), dst)
    u = _dispatch(mont_from_wide, torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev))
    jac = _dispatch(map_to_g2_jac, u)
    h_x, h_y = _dispatch(hash_finish, tuple(c[:, 0] for c in jac), tuple(c[:, 1] for c in jac))
    return h_x[:n], h_y[:n]


# --- the schedules ------------------------------------------------------------------


def _prep_field_stage(pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi):
    """Fused field stage: everything up to the subgroup ladders and the
    cofactor clearing. The G2 root and the four SSWU candidate roots of a
    set share one Fp2 square-root chain (five roots per set stacked on
    the batch axis)."""
    pk_x, pk_y, pk_curve = _g1_decompress_body(pk_x_std, pk_sign)
    sig_x, sig_rhs = _g2_rhs(sig_x_std)
    u = mont_from_wide(lo, hi)  # (N, 2, 2, 33): element, coefficient
    x1, x2, gx_both = _sswu_candidates(u)  # gx_both: (N, 2, 2, 2, 33)
    n = sig_rhs.shape[0]
    stacked = torch.cat([sig_rhs[:, None], gx_both.reshape(n, 4, 2, LIMBS)], dim=1)
    roots, oks = fp2_sqrt_with_flag(stacked)  # (N, 5, 2, 33), (N, 5)
    sig_y = _g2_select_sign(roots[:, 0], sig_sign)
    sig_curve = oks[:, 0]
    sswu_roots = roots[:, 1:].reshape(n, 2, 2, 2, LIMBS)
    sswu_oks = oks[:, 1:].reshape(n, 2, 2)
    jac = _sswu_finish(u, x1, x2, sswu_roots, sswu_oks)
    q0 = tuple(c[:, 0] for c in jac)
    q1 = tuple(c[:, 1] for c in jac)
    return pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve, q0, q1


def _prep_subgroup_stage(pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve):
    """Fused subgroup stage: the phi and psi checks, folded with the
    on-curve flags into the final ok bits (left on the device)."""
    return (
        pk_curve & _g1_subgroup(pk_x, pk_y),
        sig_curve & _g2_subgroup(sig_x, sig_y),
    )


def prepare_arrays_fused(pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi):
    """The production prep schedule, `FUSED_PREP_LAUNCHES` counted stage
    calls for a whole batch. Tensors in, on one device; returns ((pk_x,
    pk_y), pk_ok, (sig_x, sig_y), sig_ok, (h_x, h_y))."""
    pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve, q0, q1 = _dispatch(
        _prep_field_stage, pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi
    )
    pk_ok, sig_ok = _dispatch(_prep_subgroup_stage, pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve)
    h_x, h_y = _dispatch(hash_finish, q0, q1)
    return (pk_x, pk_y), pk_ok, (sig_x, sig_y), sig_ok, (h_x, h_y)


def prepare_arrays_unfused(pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi):
    """One stage call per leg (`UNFUSED_PREP_LAUNCHES`), the fused
    schedule's differential reference. Same contract as
    `prepare_arrays_fused`."""
    pk_x, pk_y, pk_ok = _dispatch(g1_decompress_subgroup, pk_limbs, pk_sign)
    sig_x, sig_y, sig_ok = _dispatch(g2_decompress_subgroup, sig_limbs, sig_sign)
    u = _dispatch(mont_from_wide, lo, hi)
    jac = _dispatch(map_to_g2_jac, u)
    h_x, h_y = _dispatch(hash_finish, tuple(c[:, 0] for c in jac), tuple(c[:, 1] for c in jac))
    return (pk_x, pk_y), pk_ok, (sig_x, sig_y), sig_ok, (h_x, h_y)
