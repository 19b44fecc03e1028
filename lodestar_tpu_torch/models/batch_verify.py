"""BLS batch signature verification (random linear combination) on a GPU.

Checks  e(-g1, sum_i r_i S_i) * prod_i e(r_i PK_i, H(m_i)) == 1  with ONE
shared final exponentiation: the semantics of blst's
`verifyMultipleSignatures` that the reference worker calls
(`packages/beacon-node/src/chain/bls/multithread/worker.ts:52-96`).
PyTorch counterpart of the split schedule of
``lodestar_tpu.models.batch_verify``:

* **Prep** (`build_device_inputs`). With device prep active (the
  default on CUDA, `configure_device_prep`): compressed bytes and
  messages go through the host byte stage of ``ops/prep.py`` (flag
  parsing, limb unpacking, SHA-256 expansion), then its three counted
  device stages (decompression, subgroup checks, hash-to-G2). Otherwise
  (`prep="off"`, and "auto" on the CPU) the pure-Python oracle copies in
  ``crypto/bls`` decode, check and hash on the host. A device-prep error
  propagates: nothing falls back to the oracle.
* **Verify** (`device_batch_verify`): 64-bit blinded scalar
  multiplications in G1 and G2, the G2 fold to the aggregate signature,
  N+1 Miller loops in lockstep, one product fold, one final
  exponentiation, the == 1 predicate, with fresh blinding coefficients
  from the host. Every base-field product, in prep and verify, runs in
  the CUDA kernels of ``ops/fp_cuda.py`` on the card.

The blinding is mandatory: an unrandomized batch is forgeable (defects in
different sets can cancel). Coefficients come from ``os.urandom`` (never
a seeded generator); the first is 1, the rest are nonzero 64-bit.
Functions that consume them also take them explicitly (`coeff_bits`), so
tests can feed two implementations the same bits.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..crypto.bls import curve as C
from ..crypto.bls.api import SecretKey, SignatureSet, sign
from ..crypto.bls.curve import G1_GEN
from ..crypto.bls.hash_to_curve import hash_to_g2
from ..crypto.bls.serdes import PointDecodeError, g1_from_bytes, g2_from_bytes
from ..ops import curve as cv
from ..ops import fp
from ..ops import pairing as prg
from ..ops import prep as dp
from ..ops import tower as tw
from ..ops.prep import pad_pow2, pad_rows

__all__ = [
    "COEFF_BITS",
    "PREP_MODES",
    "resolve_device",
    "configure_device_prep",
    "device_prep_active",
    "prepare_sets",
    "prepare_sets_device",
    "pad_rows",
    "build_device_inputs",
    "inputs_from_numpy",
    "device_batch_verify",
    "make_synthetic_sets",
    "verify_signature_sets_device",
]

COEFF_BITS = 64  # blinding scalar width, matches blst's 64-bit rand coeffs


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and missing:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def _fp_to_mont_host(xs: list[int]) -> np.ndarray:
    return np.stack([fp.mont_limbs_from_int(x) for x in xs])


def _g1_batch_host(pts) -> tuple[np.ndarray, np.ndarray]:
    return (
        _fp_to_mont_host([p[0] for p in pts]),
        _fp_to_mont_host([p[1] for p in pts]),
    )


def _g2_batch_host(pts) -> tuple[np.ndarray, np.ndarray]:
    xs = np.stack([tw._fp2_mont_limbs_host(*p[0]) for p in pts])
    ys = np.stack([tw._fp2_mont_limbs_host(*p[1]) for p in pts])
    return xs, ys


# -g1 generator, mont form (host numpy)
_NEG_G1_X = fp.mont_limbs_from_int(G1_GEN[0])
_NEG_G1_Y = fp.mont_limbs_from_int((-G1_GEN[1]) % C.P)


def _bits_msb(scalars, width: int) -> np.ndarray:
    """(N,) unsigned ints -> (N, width) int32 bit matrix, MSB first."""
    out = np.zeros((len(scalars), width), dtype=np.int32)
    for i, s in enumerate(scalars):
        s = int(s)
        for j in range(width):
            out[i, j] = (s >> (width - 1 - j)) & 1
    return out


def _random_coeffs(n: int) -> np.ndarray:
    """[1, r_1, ..., r_{n-1}] nonzero 64-bit blinding scalars (os.urandom)."""
    out = np.empty(n, dtype=np.uint64)
    if n:
        out[0] = 1
    for i in range(1, n):
        k = 0
        while k == 0:
            k = int.from_bytes(os.urandom(8), "big")
        out[i] = k
    return out


def _blinding_and_mask(n: int, size: int):
    """Fresh blinding bits + padding mask for a size-padded batch: padding
    rows get zero bits and are masked out."""
    bits = np.zeros((size, COEFF_BITS), dtype=np.int32)
    bits[:n] = _bits_msb(_random_coeffs(n), COEFF_BITS)
    mask = np.zeros(size, dtype=bool)
    mask[:n] = True
    return bits, mask


# --- input prep -------------------------------------------------------------------
# "auto" runs device prep on a CUDA device and the oracle on the CPU (where
# the plain versions would make device prep a slower host prep); "on"
# forces device prep, "off" the oracle. Set process-wide by
# `configure_device_prep` or per call by `build_device_inputs(prep=...)`.
PREP_MODES = ("auto", "on", "off")
_prep_mode = "auto"


def configure_device_prep(mode: str | None = None) -> str:
    """Set the process-wide prep mode; returns the previous one."""
    global _prep_mode
    prev = _prep_mode
    if mode is not None:
        if mode not in PREP_MODES:
            raise ValueError(f"device prep mode must be one of {PREP_MODES}, got {mode!r}")
        _prep_mode = mode
    return prev


def device_prep_active(mode: str | None = None, device=None) -> bool:
    """Resolve a prep mode ("auto" follows the device: CUDA -> device prep)."""
    mode = mode or _prep_mode
    if mode not in PREP_MODES:
        raise ValueError(f"device prep mode must be one of {PREP_MODES}, got {mode!r}")
    if mode == "auto":
        return torch.device("cuda" if device is None else device).type == "cuda"
    return mode == "on"


def prepare_sets(sets: list[SignatureSet]):
    """Host precompute with the pure-Python oracle: decode + validate +
    hash. Returns ((pk_x, pk_y), (h_x, h_y), (sig_x, sig_y)) numpy limb
    arrays, or None if any set is structurally invalid (decode failure,
    non-subgroup point, infinity pubkey or signature)."""
    if not sets:
        return None
    pk_pts, h_pts, sig_pts = [], [], []
    try:
        for s in sets:
            pk = g1_from_bytes(s.pubkey)
            if pk is None or not C.g1_in_subgroup(pk):
                return None
            sig = g2_from_bytes(s.signature)
            if sig is None or not C.g2_in_subgroup(sig):
                return None
            pk_pts.append(pk)
            sig_pts.append(sig)
            h_pts.append(hash_to_g2(s.message))
    except PointDecodeError:
        return None
    return (
        _g1_batch_host(pk_pts),
        _g2_batch_host(h_pts),
        _g2_batch_host(sig_pts),
    )


def _parse_host_arrays(sets: list[SignatureSet], size: int):
    """The host byte stage of device prep: the wrong-length check, flag and
    limb parsing of size-padded rows, and expand_message_xmd halves
    (padding rows repeat row 0 and message 0). No device work. Returns
    (pk_limbs, pk_sign, pk_struct, sig_limbs, sig_sign, sig_struct, lo,
    hi) numpy arrays, or None when a set has an encoding of the wrong
    length (a structural reject, never a device error)."""
    n = len(sets)
    if any(len(bytes(s.pubkey)) != 48 or len(bytes(s.signature)) != 96 for s in sets):
        return None
    pk_raw = np.frombuffer(b"".join(bytes(s.pubkey) for s in sets), dtype=np.uint8).reshape(n, 48)
    sig_raw = np.frombuffer(
        b"".join(bytes(s.signature) for s in sets), dtype=np.uint8
    ).reshape(n, 96)
    msgs = [bytes(s.message) for s in sets]
    pk_limbs, pk_sign, pk_struct = dp.parse_g1_compressed(pad_rows(pk_raw, size))
    sig_limbs, sig_sign, sig_struct = dp.parse_g2_compressed(pad_rows(sig_raw, size))
    lo, hi = dp.hash_to_field_limbs(msgs + [msgs[0]] * (size - n))
    return pk_limbs, pk_sign, pk_struct, sig_limbs, sig_sign, sig_struct, lo, hi


def _prepare_sets_device_arrays(sets: list[SignatureSet], size: int, device):
    """Device prep of `sets` on rows padded to `size`: the host byte stage,
    then `prepare_arrays_fused` on `device` (`FUSED_PREP_LAUNCHES` stage
    calls). Returns (pk, h, sig, ok): padded point tensors on the device
    and the host bool "every set is valid", read back in one copy at the
    end."""
    n = len(sets)
    parsed = _parse_host_arrays(sets, size)
    if parsed is None:
        return None, None, None, False
    pk_limbs, pk_sign, pk_struct, sig_limbs, sig_sign, sig_struct, lo, hi = parsed

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    pk, pk_ok, sig, sig_ok, h = dp.prepare_arrays_fused(
        t(pk_limbs), t(pk_sign), t(sig_limbs), t(sig_sign), t(lo), t(hi)
    )
    dev_ok = torch.stack([pk_ok[:n], sig_ok[:n]]).cpu().numpy()  # the one host sync
    valid = pk_struct[:n] & sig_struct[:n] & dev_ok[0] & dev_ok[1]
    return pk, h, sig, bool(valid.all())


def prepare_sets_device(sets: list[SignatureSet], device=None):
    """Device twin of `prepare_sets`: the same contract (point arrays, or
    None when a set is structurally invalid), compressed bytes in, no
    big-integer arithmetic per set on the host. Runs on rows padded to the
    verify's size classes and returns the first len(sets) rows, as tensors
    on `device` (CUDA unless the caller names another)."""
    if not sets:
        return None
    dev = resolve_device(device)
    n = len(sets)
    pk, h, sig, ok = _prepare_sets_device_arrays(sets, pad_pow2(n), dev)
    if not ok:
        return None
    return tuple((c[0][:n], c[1][:n]) for c in (pk, h, sig))


def inputs_from_numpy(pk, h, sig, coeff_bits, mask, device=None):
    """Numpy verify inputs (the layout ``build_device_inputs`` of either
    package returns: pk (x, y) each (N, 33); h/sig (x, y) each
    (N, 2, 33); coeff_bits (N, 64); mask (N,)) -> tensors on `device`."""
    dev = resolve_device(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (
        (t(pk[0]), t(pk[1])),
        (t(h[0]), t(h[1])),
        (t(sig[0]), t(sig[1])),
        t(coeff_bits),
        t(mask, torch.bool),
    )


def build_device_inputs(sets: list[SignatureSet], size: int | None = None, device=None,
                        coeff_bits=None, prep: str | None = None):
    """Prep + padding: decode, check and hash N sets, padded to `size`
    (default: next power of two >= 8). Returns (pk, h, sig, bits, mask)
    tensors on `device` with fresh blinding bits (or the given
    `coeff_bits`, (size, 64) MSB first), or None on invalid input.

    `prep` overrides the process-wide prep mode for this call: device prep
    (`ops/prep.py`) where it resolves active, else the host oracle. An
    error in device prep propagates; it never leads to the oracle."""
    if not sets:
        return None
    dev = resolve_device(device)
    n = len(sets)
    if size is None:
        size = pad_pow2(n)
    if size < n:
        raise ValueError("pad size smaller than batch")
    bits, mask = _blinding_and_mask(n, size)
    if coeff_bits is not None:
        bits = np.asarray(coeff_bits, dtype=np.int32)
        if bits.shape != (size, COEFF_BITS):
            raise ValueError(f"coeff_bits must have shape ({size}, {COEFF_BITS})")
    if device_prep_active(prep, dev):
        pk, h, sig, ok = _prepare_sets_device_arrays(sets, size, dev)
        if not ok:
            return None
        return pk, h, sig, torch.as_tensor(bits, device=dev), torch.as_tensor(mask, device=dev)
    prepared = prepare_sets(sets)
    if prepared is None:
        return None
    (pk_x, pk_y), (h_x, h_y), (sig_x, sig_y) = prepared
    return inputs_from_numpy(
        (pad_rows(pk_x, size), pad_rows(pk_y, size)),
        (pad_rows(h_x, size), pad_rows(h_y, size)),
        (pad_rows(sig_x, size), pad_rows(sig_y, size)),
        bits,
        mask,
        dev,
    )


def _blind_and_aggregate_body(pk_x, pk_y, sig_x, sig_y, coeff_bits, mask):
    """Blinded scalar muls (r_i*PK_i in G1, r_i*S_i in G2), the masked G2
    fold to the aggregate signature, affine conversions."""
    dev = pk_x.device
    one1 = fp.one_mont((), dev)
    one2 = tw.fp2_one((), dev)
    rpk = cv.scalar_mul_var(cv.F1, (pk_x, pk_y), coeff_bits, one1)
    rsig = cv.scalar_mul_var(cv.F2, (sig_x, sig_y), coeff_bits, one2)
    # padded entries must not contribute to the signature aggregate
    rsig = (rsig[0], rsig[1], torch.where(mask[:, None, None], rsig[2], torch.zeros_like(rsig[2])))
    s_agg = cv.fold_sum(cv.F2, rsig)
    rpk_aff = cv.jac_to_affine_batch(cv.F1, rpk)
    s_aff = cv.jac_to_affine_batch(cv.F2, tuple(c[None] for c in s_agg))
    s_inf = cv.jac_is_inf(cv.F2, s_agg)
    return rpk_aff, s_aff, s_inf


def _assemble_pairs(rpk_aff, s_aff, s_inf, h_x, h_y, mask):
    """Miller batch: N blinded-pubkey/message pairs + the (-g1, S_agg)
    pair. Padded or infinite entries get a valid placeholder pair (the
    -g1 generator with message 0's point); the mask drops their value."""
    dev = h_x.device
    neg_g1_x = fp.const(_NEG_G1_X, dev)
    neg_g1_y = fp.const(_NEG_G1_Y, dev)
    p_x = torch.cat([rpk_aff[0], neg_g1_x[None]], dim=0)
    p_y = torch.cat([rpk_aff[1], neg_g1_y[None]], dim=0)
    q_x = torch.cat([h_x, s_aff[0]], dim=0)
    q_y = torch.cat([h_y, s_aff[1]], dim=0)
    pair_mask = torch.cat([mask, ~s_inf[None]], dim=0)
    mm = pair_mask[:, None, None]
    p_x = torch.where(mm[..., 0], p_x, neg_g1_x)
    p_y = torch.where(mm[..., 0], p_y, neg_g1_y)
    q_x = torch.where(mm, q_x, h_x[0])
    q_y = torch.where(mm, q_y, h_y[0])
    return p_x, p_y, q_x, q_y, pair_mask


def _fold_verdict_body(fs, pair_mask):
    f = prg.fp12_product_fold(fs, mask=pair_mask)
    return tw.fp12_eq_one(prg.final_exponentiation(f))


def device_batch_verify(pk, h, sig, coeff_bits, mask) -> torch.Tensor:
    """Verification core on the inputs' device.

    pk: (x, y) each (N, 33); h/sig: (x, y) each (N, 2, 33); coeff_bits:
    (N, 64) int32 MSB first; mask: (N,) bool, False entries are padding.
    Returns a 0-d bool tensor."""
    rpk_aff, s_aff, s_inf = _blind_and_aggregate_body(pk[0], pk[1], sig[0], sig[1], coeff_bits, mask)
    p_x, p_y, q_x, q_y, pair_mask = _assemble_pairs(rpk_aff, s_aff, s_inf, h[0], h[1], mask)
    fs = prg.miller_loop((p_x, p_y), (q_x, q_y))
    return _fold_verdict_body(fs, pair_mask)


def make_synthetic_sets(n: int, seed: int = 1) -> list[SignatureSet]:
    """Deterministic valid signature sets (the same keys and messages as
    the JAX package's fixture of this name)."""
    sets = []
    for i in range(n):
        sk = SecretKey((seed * 1000003 + i + 1) * 0xDEADBEEF + 13)
        msg = bytes([seed & 0xFF, i & 0xFF]) * 16
        sets.append(SignatureSet(pubkey=sk.to_pubkey(), message=msg, signature=sign(sk, msg)))
    return sets


def verify_signature_sets_device(sets: list[SignatureSet], device=None,
                                 prep: str | None = None) -> bool:
    """End-to-end batch verify of N signature sets, compressed bytes in:
    prep (device prep on CUDA by default; see `build_device_inputs`), then
    the verification core on `device` (CUDA unless the caller passes
    another; raises when CUDA is missing)."""
    dev = resolve_device(device)
    inputs = build_device_inputs(sets, device=dev, prep=prep)
    if inputs is None:
        return False
    pk, h, sig, bits, mask = inputs
    return bool(device_batch_verify(pk, h, sig, bits, mask))
