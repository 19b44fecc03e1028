"""BLS batch signature verification (random linear combination) on a GPU.

Checks  e(-g1, sum_i r_i S_i) * prod_i e(r_i PK_i, H(m_i)) == 1  with ONE
shared final exponentiation: the semantics of blst's
`verifyMultipleSignatures` that the reference worker calls
(`packages/beacon-node/src/chain/bls/multithread/worker.ts:52-96`).
PyTorch counterpart of ``lodestar_tpu.models.batch_verify``, its split
schedule and its single-launch path:

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
* **Single launch** (`verify_sets_single_launch`, the default on CUDA,
  `configure_single_launch`): the host byte stage, then the whole chain
  above (the three prep stages, blinding and aggregation, the Miller
  loop, the final exponentiation, the ok bits folded into the verdict on
  the device) as ONE counted dispatch per batch
  (`ops.prep.SINGLE_LAUNCH_BUDGET`). On CUDA that dispatch is one replay
  of a CUDA graph captured once per pow-2 size class (``graphs.py``); on
  the CPU the same body runs eagerly. The split schedule above stays as
  its reference. A capture, replay or body error propagates: nothing
  falls back to the split schedule.

* **Sharded** (`verify_signature_sets_sharded`, `device_batch_verify_sharded`,
  `make_mesh_sharded_fn`): one batch split into equal contiguous row
  slices over several devices, the counterpart of the JAX package's
  `shard_map` over its "data" axis. Each shard does its blinded scalar
  muls, its masked G2 fold, its Miller loops and its Fp12 product
  (`_shard_partials`); the tiny partials move to the home device
  (`devices[0]`), which folds them and runs the (-g1, S_agg) Miller loop
  and the one final exponentiation (`_shard_finish`). The JAX program
  runs that tail on every chip after an `all_gather`; here it runs once,
  with the same verdict. With the single launch active (the default on
  CUDA) each shard is the prep legs plus its partials as one replay of a
  graph per (device, shard class), the shards on different devices
  replayed at once from threads of their own, then the finish is one
  replay on the home device: n_shards + 1 counted dispatches. On the CPU
  the same bodies run eagerly. A shard or finish error propagates.
  `warm_sharded` captures a device list's shard and finish graphs for the
  batch sizes its caller names, before it serves. The JAX package's
  `_warm_sharded_cache_subprocess` works around its persistent compile
  cache and has no counterpart; its
  `make_lane_verify_single_fn` is not ported (one lane callable).
* **Serving** (`make_lane_verify_fn`, `make_lane_verify_prepared_fn`,
  `prepare_inputs_for_lane`, `warm_single_launch`): the entry points the
  verifier pool (``chain/bls/pool.py``) and its lane mesh call, each
  pinned to one device, and the warm-up that captures the size classes
  its caller names (the pool's `POOL_SIZE_CLASSES`) before it serves.
  Every prep leaves a record {layer, sets, start_ns, end_ns, rejected}
  for the calling thread (`consume_prep_info`) and adds to the process
  counters `prep_counts`.
  A set whose fields cannot be read as bytes is a structural reject
  (False, zero dispatches), as a wrong-length encoding is: it is the
  input's fault, not the device's, so it must not charge a lane's
  breaker.

The blinding is mandatory: an unrandomized batch is forgeable (defects in
different sets can cancel). Coefficients come from ``os.urandom`` (never
a seeded generator); the first is 1, the rest are nonzero 64-bit.
Functions that consume them also take them explicitly (`coeff_bits`), so
tests can feed two implementations the same bits.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
import time

import numpy as np
import torch

from ..crypto.bls import curve as C
from ..crypto.bls.api import SecretKey, SignatureSet, sign
from ..crypto.bls.curve import G1_GEN
from ..crypto.bls.hash_to_curve import hash_to_g2
from ..crypto.bls.serdes import PointDecodeError, g1_from_bytes, g2_from_bytes
from ..graphs import GraphCache
from ..ops import curve as cv
from ..ops import fp
from ..ops import pairing as prg
from ..ops import prep as dp
from ..ops import tower as tw
from ..ops.prep import pad_pow2, pad_rows

__all__ = [
    "COEFF_BITS",
    "PREP_MODES",
    "SINGLE_LAUNCH_MODES",
    "resolve_device",
    "configure_device_prep",
    "device_prep_active",
    "configure_single_launch",
    "single_launch_active",
    "prepare_sets",
    "prepare_sets_device",
    "pad_rows",
    "build_device_inputs",
    "inputs_from_numpy",
    "device_batch_verify",
    "device_batch_verify_many",
    "device_batch_verify_sharded",
    "verify_signature_sets_sharded",
    "make_mesh_sharded_fn",
    "warm_sharded",
    "make_synthetic_sets",
    "verify_signature_sets_device",
    "SingleLaunchInputs",
    "prepare_single_launch_inputs",
    "verify_sets_single_launch",
    "verify_prepared",
    "consume_prep_info",
    "prep_counts",
    "reset_prep_counts",
    "mesh_device_count",
    "prepare_inputs_for_lane",
    "make_lane_verify_fn",
    "make_lane_verify_prepared_fn",
    "warm_single_launch",
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


# --- prep records and counters --------------------------------------------------
# The layers a batch's prep ran on: the single-launch path's host byte stage,
# device prep (`ops/prep.py`), or the pure-Python oracle on the host.
PREP_LAYERS = ("single_launch", "device", "host")
_prep_tls = threading.local()  # .info: the calling thread's last prep record
_prep_lock = threading.Lock()
_prep_sets = dict.fromkeys(PREP_LAYERS, 0)  # guarded by: _prep_lock
_prep_seconds = dict.fromkeys(PREP_LAYERS, 0.0)  # guarded by: _prep_lock
_prep_rejected = 0  # batches rejected by prep or by the device's batch_valid; guarded by: _prep_lock


def consume_prep_info():
    """Pop the calling thread's last prep record {layer, sets, start_ns,
    end_ns, rejected}, or None: the pool reads it after a launch for its
    `bls_prep` span."""
    info = getattr(_prep_tls, "info", None)
    _prep_tls.info = None
    return info


def _note_prep(layer: str, n_sets: int, t0_ns: int, rejected: bool = False) -> None:
    end_ns = time.monotonic_ns()
    _prep_tls.info = {"layer": layer, "sets": n_sets, "start_ns": t0_ns, "end_ns": end_ns,
                      "rejected": rejected}
    global _prep_rejected
    with _prep_lock:
        _prep_sets[layer] += n_sets
        _prep_seconds[layer] += (end_ns - t0_ns) / 1e9
        _prep_rejected += bool(rejected)


def _note_rejected() -> None:
    global _prep_rejected
    with _prep_lock:
        _prep_rejected += 1


def prep_counts() -> dict:
    """Sets and seconds of prep by layer, and rejected batches, since the
    last reset (the process counters of this module)."""
    with _prep_lock:
        return {"sets": dict(_prep_sets), "seconds": dict(_prep_seconds),
                "rejected": _prep_rejected}


def reset_prep_counts() -> None:
    global _prep_rejected
    with _prep_lock:
        for layer in PREP_LAYERS:
            _prep_sets[layer] = 0
            _prep_seconds[layer] = 0.0
        _prep_rejected = 0


def _set_bytes(sets: list[SignatureSet]):
    """Each set's (pubkey, message, signature) as bytes, or None when a
    field cannot be read as bytes (not bytes-like, a value out of byte
    range, a failing `__bytes__`): a structural reject of the batch, never
    a device error."""
    try:
        return [(bytes(s.pubkey), bytes(s.message), bytes(s.signature)) for s in sets]
    except Exception:
        return None


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


@functools.lru_cache(maxsize=None)
def _neg_g1_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The -g1 generator's limbs on `device`, copied there once (a copy from
    host memory per batch would wait for the stream, and fail a capture)."""
    return (torch.as_tensor(_NEG_G1_X, device=device), torch.as_tensor(_NEG_G1_Y, device=device))


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


# --- single-launch verification ----------------------------------------------------
# "auto" takes the single-launch path on a CUDA device unless device prep is
# pinned "off" (the single program subsumes the prep stages, so a host-prep
# pin keeps the split schedule), and the split schedule on the CPU, as
# device prep's "auto" does; "on" forces the path, "off" keeps the split
# schedule. Prep "on" does not force single launch.
SINGLE_LAUNCH_MODES = ("auto", "on", "off")
_single_launch_mode = "auto"


def configure_single_launch(mode: str | None = None) -> str:
    """Set the process-wide single-launch mode; returns the previous one."""
    global _single_launch_mode
    prev = _single_launch_mode
    if mode is not None:
        if mode not in SINGLE_LAUNCH_MODES:
            raise ValueError(f"single-launch mode must be one of {SINGLE_LAUNCH_MODES}, got {mode!r}")
        _single_launch_mode = mode
    return prev


def single_launch_active(mode: str | None = None, device=None, prep: str | None = None) -> bool:
    """Resolve a single-launch mode ("auto": CUDA -> single launch, unless
    the prep mode, `prep` or else the process-wide one, is "off")."""
    mode = mode or _single_launch_mode
    if mode not in SINGLE_LAUNCH_MODES:
        raise ValueError(f"single-launch mode must be one of {SINGLE_LAUNCH_MODES}, got {mode!r}")
    prep = prep or _prep_mode
    if prep not in PREP_MODES:
        raise ValueError(f"device prep mode must be one of {PREP_MODES}, got {prep!r}")
    if mode != "auto":
        return mode == "on"
    return prep != "off" and torch.device("cuda" if device is None else device).type == "cuda"


def prepare_sets(sets: list[SignatureSet]):
    """Host precompute with the pure-Python oracle: decode + validate +
    hash. Returns ((pk_x, pk_y), (h_x, h_y), (sig_x, sig_y)) numpy limb
    arrays, or None if any set is structurally invalid (decode failure,
    non-subgroup point, infinity pubkey or signature)."""
    if not sets:
        return None
    raw = _set_bytes(sets)
    if raw is None:
        return None
    pk_pts, h_pts, sig_pts = [], [], []
    try:
        for pk_b, msg, sig_b in raw:
            pk = g1_from_bytes(pk_b)
            if pk is None or not C.g1_in_subgroup(pk):
                return None
            sig = g2_from_bytes(sig_b)
            if sig is None or not C.g2_in_subgroup(sig):
                return None
            pk_pts.append(pk)
            sig_pts.append(sig)
            h_pts.append(hash_to_g2(msg))
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
    hi) numpy arrays, or None when a set has a field that is not bytes or
    an encoding of the wrong length (a structural reject, never a device
    error)."""
    n = len(sets)
    raw = _set_bytes(sets)
    if raw is None or any(len(pk) != 48 or len(sig) != 96 for pk, _, sig in raw):
        return None
    pk_raw = np.frombuffer(b"".join(pk for pk, _, _ in raw), dtype=np.uint8).reshape(n, 48)
    sig_raw = np.frombuffer(b"".join(sig for _, _, sig in raw), dtype=np.uint8).reshape(n, 96)
    msgs = [msg for _, msg, _ in raw]
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
        t0 = time.monotonic_ns()
        pk, h, sig, ok = _prepare_sets_device_arrays(sets, size, dev)
        _note_prep("device", n, t0, rejected=not ok)
        if not ok:
            return None
        return pk, h, sig, torch.as_tensor(bits, device=dev), torch.as_tensor(mask, device=dev)
    t0 = time.monotonic_ns()
    prepared = prepare_sets(sets)
    _note_prep("host", n, t0, rejected=prepared is None)
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
    fold to the aggregate signature, affine conversions. The sets axis is
    the last axis of `mask`; leading axes before it are independent jobs
    (`device_batch_verify_many`), each with its own aggregate."""
    dev = pk_x.device
    one1 = fp.one_mont((), dev)
    one2 = tw.fp2_one((), dev)
    rpk = cv.scalar_mul_var(cv.F1, (pk_x, pk_y), coeff_bits, one1)
    rsig = cv.scalar_mul_var(cv.F2, (sig_x, sig_y), coeff_bits, one2)
    # padded entries must not contribute to the signature aggregate
    rsig = (rsig[0], rsig[1], torch.where(mask[..., None, None], rsig[2], torch.zeros_like(rsig[2])))
    s_agg = cv.fold_sum(cv.F2, tuple(c.movedim(-3, 0) for c in rsig))  # folds the sets axis
    rpk_aff = cv.jac_to_affine_batch(cv.F1, rpk)
    s_aff = cv.jac_to_affine_batch(cv.F2, tuple(c.unsqueeze(-3) for c in s_agg))
    s_inf = cv.jac_is_inf(cv.F2, s_agg)
    return rpk_aff, s_aff, s_inf


def _assemble_pairs(rpk_aff, s_aff, s_inf, h_x, h_y, mask):
    """Miller batch: N blinded-pubkey/message pairs + the (-g1, S_agg)
    pair (per job, on the sets axis). Padded or infinite entries get a
    valid placeholder pair (the -g1 generator with message 0's point); the
    mask drops their value."""
    k = mask.dim() - 1  # the sets axis
    neg_g1_x, neg_g1_y = _neg_g1_on(h_x.device)
    lead = (*mask.shape[:-1], 1)
    p_x = torch.cat([rpk_aff[0], neg_g1_x.expand(*lead, fp.LIMBS)], dim=k)
    p_y = torch.cat([rpk_aff[1], neg_g1_y.expand(*lead, fp.LIMBS)], dim=k)
    q_x = torch.cat([h_x, s_aff[0]], dim=k)
    q_y = torch.cat([h_y, s_aff[1]], dim=k)
    pair_mask = torch.cat([mask, ~s_inf[..., None]], dim=-1)
    mm = pair_mask[..., None, None]
    p_x = torch.where(mm[..., 0], p_x, neg_g1_x)
    p_y = torch.where(mm[..., 0], p_y, neg_g1_y)
    q_x = torch.where(mm, q_x, h_x.narrow(k, 0, 1))
    q_y = torch.where(mm, q_y, h_y.narrow(k, 0, 1))
    return p_x, p_y, q_x, q_y, pair_mask


def _fold_verdict_body(fs, pair_mask):
    """The masked product of each job's Miller values (sets axis = the last
    axis of `pair_mask`), the final exponentiation, the == 1 predicate."""
    k = pair_mask.dim() - 1
    f = prg.fp12_product_fold(fs.movedim(k, 0), mask=pair_mask.movedim(k, 0))
    return tw.fp12_eq_one(prg.final_exponentiation(f))


def _verify_body(pk_x, pk_y, h_x, h_y, sig_x, sig_y, coeff_bits, mask):
    rpk_aff, s_aff, s_inf = _blind_and_aggregate_body(pk_x, pk_y, sig_x, sig_y, coeff_bits, mask)
    p_x, p_y, q_x, q_y, pair_mask = _assemble_pairs(rpk_aff, s_aff, s_inf, h_x, h_y, mask)
    fs = prg.miller_loop((p_x, p_y), (q_x, q_y))
    return _fold_verdict_body(fs, pair_mask)


def device_batch_verify(pk, h, sig, coeff_bits, mask) -> torch.Tensor:
    """Verification core on the inputs' device.

    pk: (x, y) each (N, 33); h/sig: (x, y) each (N, 2, 33); coeff_bits:
    (N, 64) int32 MSB first; mask: (N,) bool, False entries are padding.
    Returns a 0-d bool tensor."""
    if mask.dim() != 1:
        raise ValueError(f"mask must have shape (N,), got {tuple(mask.shape)}")
    return _verify_body(pk[0], pk[1], h[0], h[1], sig[0], sig[1], coeff_bits, mask)


def device_batch_verify_many(pk, h, sig, coeff_bits, mask) -> torch.Tensor:
    """J independent RLC jobs verified in one call: every input has a
    leading job axis J (pk: (J, N, 33) each, h/sig: (J, N, 2, 33) each,
    coeff_bits: (J, N, 64), mask: (J, N)). Each job keeps its own blinding,
    aggregate, fold, final exponentiation and verdict; the scalar muls and
    the Miller loop run on all J*N rows at once, so every kernel launch
    serves all jobs. The counterpart of the JAX package's `jax.vmap` of the
    verify program. Returns (J,) bool verdicts."""
    if mask.dim() != 2:
        raise ValueError(f"mask must have shape (J, N), got {tuple(mask.shape)}")
    return _verify_body(pk[0], pk[1], h[0], h[1], sig[0], sig[1], coeff_bits, mask)


def _single_launch_prep(pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi):
    """The prep legs of the single-launch bodies: the fused prep schedule's
    field stage, subgroup stage and hash finish on the host byte stage's
    arrays. Returns (pk_x, pk_y, pk_ok, sig_x, sig_y, sig_ok, h_x, h_y)."""
    pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve, q0, q1 = dp._prep_field_stage(
        pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi
    )
    pk_ok, sig_ok = dp._prep_subgroup_stage(pk_x, pk_y, pk_curve, sig_x, sig_y, sig_curve)
    h_x, h_y = dp.hash_finish(q0, q1)
    return pk_x, pk_y, pk_ok, sig_x, sig_y, sig_ok, h_x, h_y


def _single_launch_verify(pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi, struct_ok,
                          coeff_bits, mask):
    """The single-launch body: compressed-point limbs and hash-to-field
    halves in (the host byte stage's arrays, rows padded to a size class),
    (verdict, batch_valid) out as two 0-d bool tensors on the device.

    The fused prep schedule's three legs (field stage, subgroup stage, hash
    finish), then the verify core. Rows that fail the host's structural
    checks (`struct_ok`) or prep's on-curve and subgroup checks still carry
    in-contract limbs, so the group ops stay defined on them; `batch_valid`
    (every unmasked row valid) vetoes the verdict on the device, so the
    body makes no host sync and no copy from host memory: on CUDA it is
    captured as one graph per size class. `batch_valid` tells a structural
    reject from a failed pairing check; both are a final False."""
    pk_x, pk_y, pk_ok, sig_x, sig_y, sig_ok, h_x, h_y = _single_launch_prep(
        pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi
    )
    rlc_ok = _verify_body(pk_x, pk_y, h_x, h_y, sig_x, sig_y, coeff_bits, mask)
    batch_valid = torch.all((struct_ok & pk_ok & sig_ok) | ~mask)
    return batch_valid & rlc_ok, batch_valid


#: the single-launch body as one CUDA graph per (device, size class)
_SINGLE_LAUNCH_GRAPHS = GraphCache(_single_launch_verify)


# --- sharded verification over several devices -----------------------------------


def _shard_partials(pk_x, pk_y, h_x, h_y, sig_x, sig_y, coeff_bits, mask):
    """One shard's local half of the sharded verify (the JAX `shard_fn`
    before its `all_gather`): blinded scalar muls, the masked G2 fold of
    the blinded signatures (padded rows are infinity), the Miller loops of
    the blinded pubkeys against the message points (padded rows get the -g1
    generator and the shard's message 0, and the fold drops them), and the
    masked Fp12 product. Returns (f, S_x, S_y, S_z): the shard's Fp12
    product and its Jacobian G2 partial sum."""
    dev = pk_x.device
    one1 = fp.one_mont((), dev)
    one2 = tw.fp2_one((), dev)
    rpk = cv.scalar_mul_var(cv.F1, (pk_x, pk_y), coeff_bits, one1)
    rsig = cv.scalar_mul_var(cv.F2, (sig_x, sig_y), coeff_bits, one2)
    mcol = mask[:, None, None]
    rsig = (rsig[0], rsig[1], torch.where(mcol, rsig[2], torch.zeros_like(rsig[2])))
    local_sig = cv.fold_sum(cv.F2, rsig)
    rpk_aff = cv.jac_to_affine_batch(cv.F1, rpk)
    neg_g1_x, neg_g1_y = _neg_g1_on(dev)
    p_x = torch.where(mask[:, None], rpk_aff[0], neg_g1_x)
    p_y = torch.where(mask[:, None], rpk_aff[1], neg_g1_y)
    q_x = torch.where(mcol, h_x, h_x[0])
    q_y = torch.where(mcol, h_y, h_y[0])
    fs = prg.miller_loop((p_x, p_y), (q_x, q_y))
    local_f = prg.fp12_product_fold(fs, mask=mask)
    return (local_f, *local_sig)


def _shard_finish(all_f, sig_x, sig_y, sig_z, q0_x, q0_y):
    """The sharded verify's tail on the gathered partials (the JAX program
    after its `all_gather`): the product of the n shard products, the fold
    of the n partial G2 sums to S_agg, the (-g1, S_agg) Miller loop on one
    row (when S_agg is infinity the pair is dropped, its placeholder Q
    being message 0 of the first shard, `q0`), one final exponentiation
    and the == 1 predicate. Returns a 0-d bool tensor."""
    dev = all_f.device
    f = prg.fp12_product_fold(all_f)
    s_agg = cv.fold_sum(cv.F2, (sig_x, sig_y, sig_z))
    s_aff = cv.jac_to_affine_batch(cv.F2, tuple(c[None] for c in s_agg))
    s_inf = cv.jac_is_inf(cv.F2, s_agg)
    fin_q_x = torch.where(s_inf, q0_x, s_aff[0][0])
    fin_q_y = torch.where(s_inf, q0_y, s_aff[1][0])
    neg_g1_x, neg_g1_y = _neg_g1_on(dev)
    f_fin = prg.miller_loop((neg_g1_x[None], neg_g1_y[None]), (fin_q_x[None], fin_q_y[None]))
    f_fin = torch.where(s_inf, tw.fp12_one((1,), dev), f_fin)
    f = tw.fp12_mul(f, f_fin[0])
    return tw.fp12_eq_one(prg.final_exponentiation(f))


def _shard_finish_body(all_f, sig_x, sig_y, sig_z, q0_x, q0_y):
    """`_shard_finish` as a graph body: its verdict as a 1-tuple."""
    return (_shard_finish(all_f, sig_x, sig_y, sig_z, q0_x, q0_y),)


def _single_launch_shard(pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi, struct_ok,
                         coeff_bits, mask):
    """One shard of the single-launch sharded verify: the single-launch
    body's prep legs, then `_shard_partials`, with no host sync (on CUDA one
    graph per (device, shard class)). Returns (f, S_x, S_y, S_z, q0_x, q0_y,
    batch_valid): the partials, the shard's message 0 and whether every
    unmasked row of the shard passed prep's checks."""
    pk_x, pk_y, pk_ok, sig_x, sig_y, sig_ok, h_x, h_y = _single_launch_prep(
        pk_x_std, pk_sign, sig_x_std, sig_sign, lo, hi
    )
    partials = _shard_partials(pk_x, pk_y, h_x, h_y, sig_x, sig_y, coeff_bits, mask)
    batch_valid = torch.all((struct_ok & pk_ok & sig_ok) | ~mask)
    return (*partials, h_x[0], h_y[0], batch_valid)


#: one shard of the single-launch sharded verify, one CUDA graph per (device, shard class)
_SHARD_GRAPHS = GraphCache(_single_launch_shard)
#: the sharded verify's finish, one CUDA graph per (device, shard count)
_SHARD_FINISH_GRAPHS = GraphCache(_shard_finish_body)


def _sharded_size(n: int, n_shards: int) -> int:
    """The JAX package's padding rule: the pow-2 size class, at least one
    row a shard, rounded up to a multiple of the shard count."""
    size = max(pad_pow2(n), n_shards)
    if size % n_shards:
        size += n_shards - size % n_shards
    return size


def _shard_slices(size: int, n_shards: int) -> list[slice]:
    """Contiguous equal row slices, one a shard (`P("data")`'s layout)."""
    if size % n_shards:
        raise ValueError(f"{size} rows do not split into {n_shards} equal shards")
    k = size // n_shards
    return [slice(i * k, (i + 1) * k) for i in range(n_shards)]


def _eager_shard_partials(devices, pk, h, sig, coeff_bits, mask) -> list[tuple]:
    """`_shard_partials` of each shard's row slice on its device, eagerly."""
    cols = (pk[0], pk[1], h[0], h[1], sig[0], sig[1], coeff_bits, mask)
    return [_shard_partials(*(c[sl].to(dev) for c in cols))
            for dev, sl in zip(devices, _shard_slices(mask.shape[0], len(devices)))]


def _gather_partials(parts, q0, home) -> tuple:
    """The shards' partials stacked on `home`, with the placeholder `q0`:
    `_shard_finish`'s arguments."""
    stacked = tuple(torch.stack([p[i].to(home) for p in parts]) for i in range(4))
    return (*stacked, q0[0].to(home), q0[1].to(home))


def device_batch_verify_sharded(devices, pk, h, sig, coeff_bits, mask) -> torch.Tensor:
    """Sharded verification core on prepared inputs (the `build_device_inputs`
    layout; N rows a multiple of the device count): contiguous equal row
    slices, one per device of `devices` (the counterpart of the JAX mesh),
    `_shard_partials` on each slice's device, the partials moved to
    `devices[0]` with `.to()`, then `_shard_finish` there. Runs eagerly;
    the reference of the single-launch shard road. Returns a 0-d bool
    tensor on `devices[0]`."""
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("sharded verify needs at least one device")
    if mask.dim() != 1:
        raise ValueError(f"mask must have shape (N,), got {tuple(mask.shape)}")
    parts = _eager_shard_partials(devs, pk, h, sig, coeff_bits, mask)
    return _shard_finish(*_gather_partials(parts, (h[0][0], h[1][0]), devs[0]))


def _shard_launch(dev: torch.device, arrays) -> tuple:
    """ONE counted dispatch of the shard body on `dev`: on CUDA a replay of
    the (device, shard class) graph (captured on its first call), elsewhere
    the body run eagerly."""
    if dev.type == "cuda":
        # a shard class is size / n_shards: a power of two unless the device
        # count is not (three GPUs); the cache keys on the leading dimension,
        # so each class is one capture either way
        return dp._dispatch(_SHARD_GRAPHS, dev, *arrays)
    return dp._dispatch(_single_launch_shard, *(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                                for a in arrays))


def _shard_replays(si: SingleLaunchInputs, devices) -> list[tuple]:
    """Every shard's `_single_launch_shard` outputs (host tensors on CUDA),
    one counted dispatch a shard. When the shards span several CUDA devices
    each is issued from a thread of its own, so they replay at once (the
    host waits for each replay's read, and the graph's class lock keeps two
    shards of one device in turn); an error in any shard propagates once
    all have ended. Shards of one device run in turn on the calling
    thread."""
    arrays = (*si.arrays, si.bits, si.mask)
    jobs = [(dev, tuple(a[sl] for a in arrays))
            for dev, sl in zip(devices, _shard_slices(len(si.mask), len(devices)))]
    if len(set(devices)) > 1 and any(dev.type == "cuda" for dev in devices):
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            futures = [ex.submit(_shard_launch, dev, a) for dev, a in jobs]
        return [f.result() for f in futures]
    return [_shard_launch(dev, a) for dev, a in jobs]


def _finish_launch(parts, home: torch.device) -> torch.Tensor:
    """ONE counted dispatch of the finish on the shards' partials, on `home`:
    a replay of the (device, shard count) finish graph on CUDA, else
    eagerly. Returns the 0-d bool verdict."""
    args = _gather_partials([p[:4] for p in parts], parts[0][4:6], torch.device("cpu"))
    if home.type == "cuda":
        (ok,) = dp._dispatch(_SHARD_FINISH_GRAPHS, home, *(a.numpy() for a in args))
    else:
        (ok,) = dp._dispatch(_shard_finish_body, *(a.to(home) for a in args))
    return ok


def _verify_sharded_prepared(si: SingleLaunchInputs, devices) -> bool:
    """The single-launch shard road on host-staged inputs: n_shards + 1
    counted dispatches (the shards, then the finish on `devices[0]`); the
    verdict is every shard's batch_valid and the finish's. Errors
    propagate (no fallback)."""
    parts = _shard_replays(si, devices)
    verdict = _finish_launch(parts, devices[0])
    for name, t in [("verdict", verdict)] + [("batch_valid", p[6]) for p in parts]:
        _check_bool0d(f"sharded {name}", t)
    valid = all(bool(p[6]) for p in parts)
    if not valid:
        _note_rejected()
    return valid and bool(verdict)


def verify_signature_sets_sharded(sets: list[SignatureSet], devices, coeff_bits=None) -> bool:
    """End-to-end data-parallel batch verify over `devices` (torch devices,
    the counterpart of the JAX mesh; CUDA devices raise without CUDA). The
    batch pads to the JAX package's size: the pow-2 class, at least one row
    a device, a multiple of the device count. Where `single_launch_active`
    resolves true for `devices[0]` (the default on CUDA): the host byte
    stage once, then one shard body a device and the finish
    (`n_shards + 1` counted dispatches). Otherwise `build_device_inputs`
    on `devices[0]`, then `device_batch_verify_sharded`. `coeff_bits`
    ((size, 64), MSB first) replaces the fresh blinding. A wrong-length
    encoding is False with zero dispatches; a shard or finish error
    raises."""
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("sharded verify needs at least one device")
    size = _sharded_size(len(sets), len(devs))
    if single_launch_active(device=devs[0]):
        si = prepare_single_launch_inputs(sets, coeff_bits=coeff_bits, size=size)
        if si is None:
            return False
        return _verify_sharded_prepared(si, devs)
    inputs = build_device_inputs(sets, size=size, device=devs[0], coeff_bits=coeff_bits)
    if inputs is None:
        return False
    return bool(device_batch_verify_sharded(devs, *inputs))


def make_synthetic_sets(n: int, seed: int = 1) -> list[SignatureSet]:
    """Deterministic valid signature sets (the same keys and messages as
    the JAX package's fixture of this name)."""
    sets = []
    for i in range(n):
        sk = SecretKey((seed * 1000003 + i + 1) * 0xDEADBEEF + 13)
        msg = bytes([seed & 0xFF, i & 0xFF]) * 16
        sets.append(SignatureSet(pubkey=sk.to_pubkey(), message=msg, signature=sign(sk, msg)))
    return sets


def _verify_sets_split(sets: list[SignatureSet], device=None, prep: str | None = None) -> bool:
    """The split schedule: prep (`build_device_inputs`: device prep's three
    stage calls, or the oracle), one host read of the ok bits, then the
    verify core. The single-launch path's reference."""
    inputs = build_device_inputs(sets, device=device, prep=prep)
    if inputs is None:
        return False
    pk, h, sig, bits, mask = inputs
    return bool(device_batch_verify(pk, h, sig, bits, mask))


def verify_signature_sets_device(sets: list[SignatureSet], device=None,
                                 prep: str | None = None) -> bool:
    """End-to-end batch verify of N signature sets, compressed bytes in, on
    `device` (CUDA unless the caller passes another; raises when CUDA is
    missing). Where `single_launch_active` resolves true (the default on
    CUDA) one single-launch dispatch; otherwise the split schedule (prep,
    device prep on CUDA by default, see `build_device_inputs`, then the
    verification core)."""
    dev = resolve_device(device)
    if single_launch_active(device=dev, prep=prep):
        return verify_sets_single_launch(sets, device=dev)
    return _verify_sets_split(sets, device=dev, prep=prep)


class SingleLaunchInputs:
    """Host-staged inputs of one single-launch dispatch: the host byte
    stage's arrays (pk limbs, pk sign, sig limbs, sig sign, lo, hi, struct
    ok), fresh blinding bits and the padding mask, all numpy, rows padded
    to the size class; made by byte work only (no device work)."""

    __slots__ = ("arrays", "bits", "mask", "n")

    def __init__(self, arrays, bits, mask, n):
        self.arrays = arrays
        self.bits = bits
        self.mask = mask
        self.n = n


def prepare_single_launch_inputs(sets: list[SignatureSet], coeff_bits=None,
                                 size: int | None = None):
    """The host byte stage of the single-launch path: flag parsing, limb
    unpacking, expand_message_xmd and fresh blinding bits (or the given
    `coeff_bits`, (size, 64) MSB first), with zero dispatches, on rows
    padded to `size` (default: the pow-2 size class). Returns
    SingleLaunchInputs, or None for an empty batch or a set with a field
    that is not bytes or an encoding of the wrong length (a final False,
    never a dispatch)."""
    if not sets:
        return None
    n = len(sets)
    t0 = time.monotonic_ns()
    if size is None:
        size = pad_pow2(n)
    if size < n:
        raise ValueError("pad size smaller than batch")
    parsed = _parse_host_arrays(sets, size)
    if parsed is None:
        _note_prep("single_launch", n, t0, rejected=True)
        return None
    pk_limbs, pk_sign, pk_struct, sig_limbs, sig_sign, sig_struct, lo, hi = parsed
    bits, mask = _blinding_and_mask(n, size)
    if coeff_bits is not None:
        bits = np.asarray(coeff_bits, dtype=np.int32)
        if bits.shape != (size, COEFF_BITS):
            raise ValueError(f"coeff_bits must have shape ({size}, {COEFF_BITS})")
    arrays = (pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi, pk_struct & sig_struct)
    _note_prep("single_launch", n, t0)
    return SingleLaunchInputs(arrays, bits, mask, n)


def _check_bool0d(label: str, t) -> None:
    """A dispatch's output must be a 0-d bool tensor; anything else raises."""
    if not isinstance(t, torch.Tensor) or t.shape != () or t.dtype != torch.bool:
        raise RuntimeError(f"{label} anomaly: "
                           f"{getattr(t, 'shape', None)}/{getattr(t, 'dtype', type(t))}")


def _verify_single_prepared(si: SingleLaunchInputs, device=None) -> bool:
    """ONE counted dispatch of the single-launch body on host-staged inputs:
    on CUDA a replay of the size class's graph (captured on its first
    batch), elsewhere the body run eagerly. Both outputs must be 0-d bool
    tensors; anything else raises. Errors propagate (no fallback). A
    False batch_valid (prep's checks on the device) counts as a rejected
    batch."""
    dev = resolve_device(device)
    args = (*si.arrays, si.bits, si.mask)
    if dev.type == "cuda":
        verdict, batch_valid = dp._dispatch(_SINGLE_LAUNCH_GRAPHS, dev, *args)
    else:
        verdict, batch_valid = dp._dispatch(
            _single_launch_verify, *(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                     for a in args)
        )
    for name, t in (("verdict", verdict), ("batch_valid", batch_valid)):
        _check_bool0d(f"single-launch {name}", t)
    if not bool(batch_valid):
        _note_rejected()
    return bool(verdict)


def verify_sets_single_launch(sets: list[SignatureSet], device=None, coeff_bits=None) -> bool:
    """End-to-end single-launch batch verify: compressed bytes in, ONE
    counted dispatch (`ops.prep.SINGLE_LAUNCH_BUDGET`), verdict out, the
    same verdict as the split schedule on the same sets. A wrong-length
    encoding is a False with zero dispatches."""
    dev = resolve_device(device)
    si = prepare_single_launch_inputs(sets, coeff_bits=coeff_bits)
    if si is None:
        return False
    return _verify_single_prepared(si, device=dev)


def verify_prepared(inputs, device=None) -> bool:
    """Verify a batch staged ahead: either the split schedule's
    `build_device_inputs` tuple (one call of the verify core here, on
    `device` when given, else where the tensors are) or a
    `SingleLaunchInputs` (host bytes only; the one single-launch dispatch
    runs here, on `device`)."""
    if isinstance(inputs, SingleLaunchInputs):
        return _verify_single_prepared(inputs, device=device)
    if device is not None:
        dev = resolve_device(device)
        inputs = tuple(tuple(c.to(dev) for c in x) if isinstance(x, tuple) else x.to(dev)
                       for x in inputs)
    pk, h, sig, bits, mask = inputs
    return bool(device_batch_verify(pk, h, sig, bits, mask))


# --- serving: the entry points of the verifier pool's lanes ------------------------


def mesh_device_count() -> int:
    """CUDA devices visible to this process (0 when enumeration fails): the
    lane count `chain/bls/mesh.build_device_mesh` starts from."""
    try:
        return torch.cuda.device_count()
    except Exception:
        return 0


def _lane_device(index: int | None, device=None) -> torch.device:
    """The device of lane `index`: `device` when the caller names one (tests
    pass "cpu"), else CUDA device `index` (the current one for None)."""
    if device is not None:
        return resolve_device(device)
    return resolve_device("cuda" if index is None else torch.device("cuda", index))


def prepare_inputs_for_lane(sets: list[SignatureSet], lane_index: int | None = None,
                            device=None):
    """The pipelined pool's prep stage: with the single-launch path active,
    the host byte stage only (`prepare_single_launch_inputs`, zero
    dispatches; a structural reject stages None); otherwise
    `build_device_inputs` on the lane's device."""
    dev = _lane_device(lane_index, device)
    if single_launch_active(device=dev):
        return prepare_single_launch_inputs(sets)
    return build_device_inputs(sets, device=dev)


def make_lane_verify_fn(device_index: int, device=None):
    """`verify_signature_sets_device` pinned to one device: a lane's verify
    callable."""
    dev = _lane_device(device_index, device)

    def lane_verify(sets: list[SignatureSet]) -> bool:
        return verify_signature_sets_device(sets, device=dev)

    lane_verify.__name__ = f"lane_verify_dev{device_index}"
    return lane_verify


def make_lane_verify_prepared_fn(device_index: int, device=None):
    """`verify_prepared` pinned to one device: a lane's verify of inputs
    staged by the pipelined pool (either staged shape)."""
    dev = _lane_device(device_index, device)

    def lane_verify_prepared(inputs) -> bool:
        return verify_prepared(inputs, device=dev)

    lane_verify_prepared.__name__ = f"lane_verify_prepared_dev{device_index}"
    return lane_verify_prepared


def make_mesh_sharded_fn(devices=None):
    """The mesh's collective: `sharded_verify(sets, device_indices)` runs
    `verify_signature_sets_sharded` over the lanes named by
    `device_indices`, in sorted (canonical) order, so an occupancy-ordered
    subset gives the same row slice to each lane. Index `i` is
    `devices[i]` when `devices` is given (tests pass "cpu" lanes; two
    lanes may name one GPU), else CUDA device `i`. Raises below two
    devices."""

    def sharded_verify(sets: list[SignatureSet], device_indices) -> bool:
        picked = sorted(device_indices)
        if len(picked) < 2:
            raise ValueError("sharded verify needs at least two devices")
        devs = [torch.device(devices[i]) if devices is not None else torch.device("cuda", i)
                for i in picked]
        return verify_signature_sets_sharded(sets, devs)

    return sharded_verify


@functools.lru_cache(maxsize=1)
def _warm_set() -> tuple[SignatureSet, ...]:
    return tuple(make_synthetic_sets(1, seed=1))


def _warm_inputs(size: int) -> tuple:
    """Single-launch inputs of one size class for a capture (one valid set,
    padded; the graph does not depend on the values)."""
    parsed = _parse_host_arrays(list(_warm_set()), size)
    pk_limbs, pk_sign, pk_struct, sig_limbs, sig_sign, sig_struct, lo, hi = parsed
    bits, mask = _blinding_and_mask(1, size)
    return (pk_limbs, pk_sign, sig_limbs, sig_sign, lo, hi, pk_struct & sig_struct, bits, mask)


def warm_single_launch(classes, device=None) -> dict[int, dict]:
    """Capture the single-launch graph of every class in `classes` (the
    pool's `POOL_SIZE_CLASSES` for a serving process) that has none yet on
    `device` (CUDA unless named), before a server takes
    traffic: CUDA graphs do not outlive the process, so each process pays
    the eager warm-up, capture and instantiation once per class. Returns
    {class: {capture_s, instantiate_s, nodes, pool_bytes, rows}} for the
    classes captured by this call."""
    return _SINGLE_LAUNCH_GRAPHS.warm(resolve_device(device), classes, _warm_inputs)


def warm_sharded(devices, sizes) -> dict[tuple, dict]:
    """Capture the graphs `verify_signature_sets_sharded(sets, devices)`
    replays for a batch of each size in `sizes` (set counts; the JAX
    padding rule gives the shard class), where they are missing: each CUDA
    device's shard graph, then the finish graph on `devices[0]`, so a mesh
    with a collective serves with no capture. Devices that are not CUDA run
    the bodies eagerly and have nothing to capture. Returns
    {("shard" or "finish", device index, class): Graph.info()} for the
    graphs captured by this call."""
    devs = [resolve_device(d) for d in devices]
    if len(devs) < 2:
        raise ValueError("sharded verify needs at least two devices")
    out = {}
    for n in sizes:
        k = _sharded_size(n, len(devs)) // len(devs)
        for dev in dict.fromkeys(d for d in devs if d.type == "cuda"):
            for c, info in _SHARD_GRAPHS.warm(dev, [k], _warm_inputs).items():
                out[("shard", dev.index, c)] = info
        home = devs[0]
        if home.type != "cuda":
            continue

        def finish_inputs(n_shards, k=k):
            # one shard's partials (a replay of the shard graph just
            # warmed), as many times as there are shards
            part = _SHARD_GRAPHS(home, *_warm_inputs(k))
            args = _gather_partials([part[:4]] * n_shards, part[4:6], torch.device("cpu"))
            return tuple(a.numpy() for a in args)

        for c, info in _SHARD_FINISH_GRAPHS.warm(home, [len(devs)], finish_inputs).items():
            out[("finish", home.index, c)] = info
    return out
