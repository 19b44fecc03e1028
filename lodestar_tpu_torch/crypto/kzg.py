"""KZG commitments and proof checks for EIP-4844 blobs, on the card.

PyTorch counterpart of ``lodestar_tpu.crypto.kzg`` (which replaces the
reference's c-kzg binding, `beacon-node/src/util/kzg.ts` and
`chain/validation/blobsSidecar.ts`), with the same wire conventions and
the same answers:

* A commitment is a G1 multi-scalar multiplication over the MONOMIAL
  trusted setup, after an inverse NTT over Fr takes the blob from
  evaluation form to coefficients: 4,096 points for a mainnet blob
  (``ops/msm.py``, the exact double-and-add, then the tree fold).
* A proof check is a product of two pairings == 1
  (``ops/pairing.multi_pairing_is_one``), the pairs masked where a point
  is infinity and padded to a power of two with floor 2.
* The early-4844 coupled ``BlobsSidecar`` of Lodestar v1.8.0: one
  aggregated proof for all of a block's blobs (`compute_aggregate_kzg_proof`,
  `verify_aggregate_kzg_proof`, `validate_blobs_sidecar`), field elements
  little-endian, the 16-byte domain ``FSBLOBVERIFY_V1_``.

``trusted_setup.bin`` beside this file is the public ceremony output in
monomial form (4,096 G1 points [tau^i]G1, then 65 G2 points [tau^i]G2;
header u32be(4096) u32be(96), then compressed points), a byte-equal copy
of the JAX package's.

Roads. Every entry point (`blob_to_kzg_commitment`,
`compute_aggregate_kzg_proof`, `verify_kzg_proof`, `verify_blob_kzg_proof`,
`verify_aggregate_kzg_proof`, `validate_blobs_sidecar`) takes two
keywords:

* ``device`` (default None: CUDA, and a RuntimeError when CUDA is
  missing): the MSM and the pairing check run on that device. On CUDA
  each is one replay of a CUDA graph per pow-2 size class (`_MSM_GRAPHS`:
  the setup's limbs and the bit matrix in, the Jacobian sum out, class
  4,096 for a blob; `_PAIRING_GRAPHS`: the pairs and their mask in, the
  verdict out, class 2 for every KZG check), every base-field product in
  the kernels of ``ops/fp_cuda.py``. ``device="cpu"`` runs the same
  bodies eagerly on CPU tensors, through the kernels' plain versions.
* ``oracle=True``: the host big-integer oracle (``crypto/bls``), no
  tensor at all; the JAX package's ``device=False``.

The setup's Montgomery limbs are computed once per device and stay there
(`_points_on`), so a commitment copies in only its bit matrix. After a
replay the Jacobian sum's infinity test is read on the host; the affine
conversion and the ``from_mont`` of the one result point run eagerly on
the device, as separate counted dispatches.

No fallback: a capture, replay or device error raises out of every entry
point; nothing serves the oracle's verdict in its place. Input faults
keep the JAX package's answers: a malformed or off-subgroup point makes
`verify_kzg_proof` False, `verify_aggregate_kzg_proof` is False on a
`KzgError` or `PointDecodeError`, and `validate_blobs_sidecar` raises
`KzgError`.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..graphs import GraphCache
from ..models.batch_verify import resolve_device
from ..ops import curve as cv
from ..ops import fp
from ..ops import msm
from ..ops import pairing as prg
from ..ops import prep as dp
from ..ops import tower as tw
from .bls import curve as C
from .bls.fields import R
from .bls.pairing import pairings_are_one
from .bls.serdes import PointDecodeError, g1_from_bytes, g1_to_bytes, g2_from_bytes

__all__ = [
    "load_trusted_setup",
    "blob_to_kzg_commitment",
    "verify_kzg_proof",
    "verify_blob_kzg_proof",
    "compute_aggregate_kzg_proof",
    "verify_aggregate_kzg_proof",
    "validate_blobs_sidecar",
    "compute_roots_of_unity",
    "KzgError",
    "FIELD_ELEMENTS_PER_BLOB_MAINNET",
    "G1_INFINITY_BYTES",
]

FIELD_ELEMENTS_PER_BLOB_MAINNET = 4096
SETUP_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trusted_setup.bin")
_GENERATOR = 7  # Fr multiplicative generator (c-kzg GENERATOR)
BYTES_PER_FIELD_ELEMENT = 32
SCALAR_BITS = 255  # Fr scalars, MSB first
# Early-4844 wire convention, pinned by the reference's `c-kzg: ^1.0.9`
# (`packages/beacon-node/package.json:136`): 16-byte domain string,
# field-element bytes LITTLE-endian (the final deneb spec later switched
# to big-endian; v1.8.0's coupled BlobsSidecar flow predates that).
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
KZG_ENDIANNESS = "little"
G1_INFINITY_BYTES = bytes([0xC0]) + bytes(47)


class KzgError(Exception):
    pass


@functools.lru_cache(maxsize=1)
def load_trusted_setup(path: str = SETUP_PATH):
    """-> (g1_monomial: [tau^i]G1 oracle affine points,
    g2_monomial: [tau^i]G2 oracle G2 affine points)."""
    with open(path, "rb") as f:
        data = f.read()
    n_g1 = int.from_bytes(data[0:4], "big")
    if int.from_bytes(data[4:8], "big") != 96:
        raise KzgError("trusted setup header: G2 points must be 96 bytes")
    pos = 8
    g1 = []
    for _ in range(n_g1):
        pt = g1_from_bytes(data[pos : pos + 48])
        if pt is None:
            raise KzgError("invalid G1 point in trusted setup")
        g1.append(pt)
        pos += 48
    g2 = []
    while pos + 96 <= len(data):
        pt = g2_from_bytes(data[pos : pos + 96])
        if pt is None:
            raise KzgError("invalid G2 point in trusted setup")
        g2.append(pt)
        pos += 96
    return g1, g2


# --- field / domain helpers --------------------------------------------------


def _bit_reverse(n: int, order: int) -> int:
    bits = order.bit_length() - 1
    out = 0
    for i in range(bits):
        out = (out << 1) | ((n >> i) & 1)
    return out


@functools.lru_cache(maxsize=4)
def compute_roots_of_unity(order: int, bit_reversed: bool = True) -> tuple[int, ...]:
    """Primitive `order`-th roots of unity in Fr, in the bit-reversed
    permutation c-kzg uses for the Lagrange setup."""
    assert (R - 1) % order == 0
    omega = pow(_GENERATOR, (R - 1) // order, R)
    roots = [1] * order
    for i in range(1, order):
        roots[i] = roots[i - 1] * omega % R
    if bit_reversed:
        roots = [roots[_bit_reverse(i, order)] for i in range(order)]
    return tuple(roots)


def _blob_to_scalars(blob: bytes) -> list[int]:
    if len(blob) % BYTES_PER_FIELD_ELEMENT:
        raise KzgError("blob length not a multiple of 32")
    out = []
    for i in range(0, len(blob), BYTES_PER_FIELD_ELEMENT):
        v = int.from_bytes(blob[i : i + 32], KZG_ENDIANNESS)
        if v >= R:
            raise KzgError("blob element out of field range")
        out.append(v)
    return out


def _inverse_ntt(evals_natural: list[int]) -> list[int]:
    """Inverse radix-2 NTT over Fr: evaluations at the natural-order
    domain -> monomial coefficients."""
    n = len(evals_natural)
    if n & (n - 1):
        raise KzgError("domain size must be a power of two")
    # forward NTT with the inverse root, then scale by n^-1
    w_inv = pow(pow(_GENERATOR, (R - 1) // n, R), R - 2, R)
    out = _ntt(evals_natural, w_inv)
    n_inv = pow(n, R - 2, R)
    return [v * n_inv % R for v in out]


def _ntt(values: list[int], omega: int) -> list[int]:
    """Iterative Cooley-Tukey NTT over Fr (decimation in time)."""
    n = len(values)
    if n == 1:
        return list(values)
    a = [values[_bit_reverse(i, n)] for i in range(n)]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for i in range(start, start + half):
                u, v = a[i], a[i + half] * w % R
                a[i] = (u + v) % R
                a[i + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    return a


def _coefficients(scalars: list[int]) -> list[int]:
    """Evaluation form over the bit-reversed domain -> monomial
    coefficients: undo the bit-reversed storage order, then interpolate."""
    n = len(scalars)
    evals_natural = [0] * n
    for i, v in enumerate(scalars):
        evals_natural[_bit_reverse(i, n)] = v
    return _inverse_ntt(evals_natural)


# --- commitments -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _points_on(points: tuple, device: torch.device, size: int):
    """Montgomery-form affine limbs (x, y), each (size, 33), of oracle G1
    `points` on `device`, rows past len(points) repeating row 0 (their bits
    are zero). The same `to_mont` as the JAX package's on every call, made
    once per device: later commitments copy in only their bit matrix. Never
    evicted: the MSM graph of a class reads these very tensors in place."""
    rows = list(points) + [points[0]] * (size - len(points))
    xs = dp._dispatch(fp.to_mont, torch.as_tensor(fp.limbs_from_ints([p[0] for p in rows]),
                                                  device=device))
    ys = dp._dispatch(fp.to_mont, torch.as_tensor(fp.limbs_from_ints([p[1] for p in rows]),
                                                  device=device))
    return xs, ys


def _pairing_graph_body(px, py, qx, qy, mask):
    """The pairing check graph's body: the padded pairs and their mask in,
    a 1-tuple of the 0-d bool verdict out."""
    return (prg.multi_pairing_is_one((px, py), (qx, qy), mask=mask),)


#: the G1 MSM as one CUDA graph per (device, pow-2 point count): the setup's
#: limbs and the bit matrix in, the Jacobian sum (X, Y, Z), each (33,), out
_MSM_GRAPHS = GraphCache(msm.msm_g1_body)
#: the pairing-product check as one CUDA graph per (device, pow-2 pair count)
_PAIRING_GRAPHS = GraphCache(_pairing_graph_body)


def _commit_msm(g1, scalars, device=None, *, oracle: bool = False) -> bytes:
    """Compressed sum_i scalars[i] * g1[i]: on `device` (see the module
    docstring), or with the host oracle."""
    if oracle:
        acc = None
        for pt, s in zip(g1, scalars):
            if s:
                acc = C.g1_add(acc, C.g1_mul(pt, s))
        return g1_to_bytes(acc)
    dev = resolve_device(device)
    bits = msm.bits_msb(scalars, SCALAR_BITS)
    if dev.type == "cuda":
        size = dp.pad_pow2(len(g1), floor=1)
        index = torch.cuda.current_device() if dev.index is None else dev.index
        xs, ys = _points_on(tuple(g1), torch.device("cuda", index), size)
        bits = np.concatenate([bits, np.zeros((size - len(g1), SCALAR_BITS), np.int32)])
        X, Y, Z = dp._dispatch(_MSM_GRAPHS, dev, xs, ys, bits)
    else:
        xs, ys = _points_on(tuple(g1), dev, len(g1))
        X, Y, Z = msm.msm_g1((xs, ys), bits)
    if not bool(torch.all(Z.cpu() == 0)):  # exact-zero infinity, read on the host
        aff = dp._dispatch(cv.jac_to_affine_batch, cv.F1, tuple(c.to(dev)[None] for c in (X, Y, Z)))
        x, y = (fp.int_from_limbs(dp._dispatch(fp.from_mont, c[0]).cpu().numpy()) for c in aff)
        return g1_to_bytes((x, y))
    return g1_to_bytes(None)


def blob_to_kzg_commitment(blob: bytes, *, device=None, oracle: bool = False) -> bytes:
    """Blob (evaluation form over the bit-reversed domain) -> monomial
    coefficients (inverse NTT on the host) -> MSM over the monomial setup."""
    g1, _ = load_trusted_setup()
    scalars = _blob_to_scalars(blob)
    if len(scalars) != len(g1):
        raise KzgError(f"blob has {len(scalars)} elements, setup {len(g1)}")
    return _commit_msm(g1, _coefficients(scalars), device, oracle=oracle)


# --- verification ------------------------------------------------------------


def _pairs_are_one_device(pairs, dev: torch.device) -> bool:
    """prod e(P_i, Q_i) == 1 through `ops/pairing.multi_pairing_is_one` on
    `dev`: an infinity entry is masked (its pair gives the neutral element,
    as the oracle skips None), and the pairs are padded to a power of two
    with floor 2 by masked rows of valid points, so each pair count uses
    the graph of its class. Errors propagate."""
    mask, px, py, qx, qy = [], [], [], [], []
    for p1, q2 in pairs:
        mask.append(p1 is not None and q2 is not None)
        pp = p1 if p1 is not None else C.G1_GEN
        qq = q2 if q2 is not None else C.G2_GEN
        px.append(fp.mont_limbs_from_int(pp[0]))
        py.append(fp.mont_limbs_from_int(pp[1]))
        qx.append(tw._fp2_mont_limbs_host(*qq[0]))
        qy.append(tw._fp2_mont_limbs_host(*qq[1]))
    size = dp.pad_pow2(len(mask), floor=2)
    mask += [False] * (size - len(mask))  # padding rows: valid points, masked to one
    arrays = [dp.pad_rows(np.stack(a), size) for a in (px, py, qx, qy)] + [np.asarray(mask)]
    if dev.type == "cuda":
        (ok,) = dp._dispatch(_PAIRING_GRAPHS, dev, *arrays)
    else:
        px_t, py_t, qx_t, qy_t, mask_t = (torch.as_tensor(a, device=dev) for a in arrays)
        ok = dp._dispatch(prg.multi_pairing_is_one, (px_t, py_t), (qx_t, qy_t), mask=mask_t)
    return bool(ok)


def _opening_pairs(commitment: bytes, z: int, y: int, proof: bytes):
    """The two pairs of the opening check e(P - [y]G1, -G2) *
    e(proof, [tau]G2 - [z]G2) == 1 as oracle points, or None when a point
    is malformed or outside the G1 subgroup (spec validate_kzg_g1)."""
    _, g2 = load_trusted_setup()
    try:
        c_pt = g1_from_bytes(commitment)
        proof_pt = g1_from_bytes(proof)
    except PointDecodeError:
        return None
    for pt in (c_pt, proof_pt):
        if pt is not None and not C.g1_in_subgroup(pt):
            return None
    # X - [z] in G2: tau_g2 - z*g2_gen
    z_g2 = C.g2_mul(C.G2_GEN, z % R) if z % R else None
    x_minus_z = C.g2_add(g2[1], C.g2_neg(z_g2) if z_g2 else None)
    # P - [y] in G1
    y_g1 = C.g1_mul(C.G1_GEN, y % R) if y % R else None
    p_minus_y = C.g1_add(c_pt, C.g1_neg(y_g1) if y_g1 else None)
    return [(p_minus_y, C.g2_neg(C.G2_GEN)), (proof_pt, x_minus_z)]


def verify_kzg_proof(commitment: bytes, z: int, y: int, proof: bytes, *, device=None,
                     oracle: bool = False) -> bool:
    """The opening check e(P - [y]G1, -G2) * e(proof, [tau]G2 - [z]G2) == 1,
    on `device` (one pairing-check replay at pair class 2 on CUDA) or with
    the oracle. A malformed or out-of-subgroup point is False."""
    dev = None if oracle else resolve_device(device)
    pairs = _opening_pairs(commitment, z, y, proof)
    if pairs is None:
        return False
    if oracle:
        return pairings_are_one(pairs)
    return _pairs_are_one_device(pairs, dev)


def _evaluate_blob_at(blob_scalars: list[int], z: int) -> int:
    """Barycentric evaluation of the (bit-reversed) evaluation-form
    polynomial at z (spec evaluate_polynomial_in_evaluation_form)."""
    n = len(blob_scalars)
    roots = compute_roots_of_unity(n)
    z %= R
    for i, w in enumerate(roots):
        if z == w:
            return blob_scalars[i]
    # p(z) = (z^n - 1)/n * sum_i p_i * w_i / (z - w_i)
    total = 0
    for p_i, w in zip(blob_scalars, roots):
        total = (total + p_i * w % R * pow((z - w) % R, R - 2, R)) % R
    zn = (pow(z, n, R) - 1) % R
    return total * zn % R * pow(n, R - 2, R) % R


def _hash_to_bls_field(data: bytes) -> int:
    """Spec hash_to_bls_field: sha256 reduced to Fr, module endianness."""
    return int.from_bytes(hashlib.sha256(data).digest(), KZG_ENDIANNESS) % R


def _compute_challenge(blob: bytes, commitment: bytes) -> int:
    """Fiat-Shamir challenge of the per-blob proof: domain ||
    uint128(FIELD_ELEMENTS_PER_BLOB) || blob || commitment hashed to a
    field element, in the module's early-4844 endianness."""
    n = len(blob) // BYTES_PER_FIELD_ELEMENT
    data = FIAT_SHAMIR_PROTOCOL_DOMAIN + n.to_bytes(16, KZG_ENDIANNESS) + blob + commitment
    return _hash_to_bls_field(data)


def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes, *, device=None,
                          oracle: bool = False) -> bool:
    """Spec verify_blob_kzg_proof: evaluate at the Fiat-Shamir challenge
    and verify the opening."""
    scalars = _blob_to_scalars(blob)
    z = _compute_challenge(blob, commitment)
    y = _evaluate_blob_at(scalars, z)
    return verify_kzg_proof(commitment, z, y, proof, device=device, oracle=oracle)


# --- early-4844 aggregate proofs (coupled BlobsSidecar) -----------------------
# Lodestar v1.8.0 ships the early EIP-4844 p2p design: one coupled
# `BlobsSidecar` per block carrying ALL blobs + ONE aggregated proof,
# verified by `validate_blobs_sidecar` (c-kzg verifyAggregateKzgProof,
# reference `chain/validation/blobsSidecar.ts:68`). Blobs and commitments
# fold with powers of one Fiat-Shamir scalar, then one opening at a
# second challenge.


def _commit_evals(scalars: list[int], device=None, *, oracle: bool = False) -> bytes:
    """Commit an evaluation-form (bit-reversed domain) polynomial."""
    g1, _ = load_trusted_setup()
    return _commit_msm(g1, _coefficients(scalars), device, oracle=oracle)


def _compute_challenges(blobs: list[bytes], commitments: list[bytes]) -> tuple[int, int]:
    """(folding challenge r, evaluation challenge x) of the aggregate
    proof, as c-kzg 1.0.x `compute_challenges` (eip4844.c):

        transcript = domain(16B) || uint64le(FIELD_ELEMENTS_PER_BLOB)
                   || uint64le(n) || blob bytes || commitment bytes
        hashed    = sha256(transcript)
        r         = hash_to_bls_field(sha256(hashed || 0x00))
        x         = hash_to_bls_field(sha256(hashed || 0x01))

    Both squeeze from ONE transcript over the raw wire bytes; x does not
    depend on the aggregated commitment."""
    width = len(blobs[0]) // BYTES_PER_FIELD_ELEMENT
    h = hashlib.sha256()
    h.update(FIAT_SHAMIR_PROTOCOL_DOMAIN)
    h.update(width.to_bytes(8, KZG_ENDIANNESS))
    h.update(len(blobs).to_bytes(8, KZG_ENDIANNESS))
    for b in blobs:
        h.update(bytes(b))
    for c in commitments:
        h.update(bytes(c))
    hashed = h.digest()
    return _hash_to_bls_field(hashed + b"\x00"), _hash_to_bls_field(hashed + b"\x01")


def _aggregate(blob_scalar_lists: list[list[int]], commitments: list[bytes], r: int):
    """(aggregated eval-form scalars, aggregated commitment point) via
    powers of the folding challenge r (early spec
    compute_aggregated_poly_and_commitment)."""
    powers = [pow(r, i, R) for i in range(len(blob_scalar_lists))]
    agg = [0] * len(blob_scalar_lists[0])
    for coeff, scalars in zip(powers, blob_scalar_lists):
        for i, s in enumerate(scalars):
            agg[i] = (agg[i] + coeff * s) % R
    agg_commitment = None
    for coeff, c in zip(powers, commitments):
        try:
            pt = g1_from_bytes(bytes(c))
        except PointDecodeError as e:
            raise KzgError(f"malformed commitment: {e}") from e
        if pt is not None and not C.g1_in_subgroup(pt):
            raise KzgError("commitment outside the G1 subgroup")
        if pt is not None and coeff:
            agg_commitment = C.g1_add(agg_commitment, C.g1_mul(pt, coeff))
    return agg, agg_commitment


def compute_aggregate_kzg_proof(blobs: list[bytes], *, device=None, oracle: bool = False) -> bytes:
    """One proof for all of a block's blobs (early spec
    compute_aggregate_kzg_proof; c-kzg computeAggregateKzgProof): a
    commitment per blob and one of the quotient, n + 1 MSMs."""
    if not blobs:
        return G1_INFINITY_BYTES
    blob_scalars = [_blob_to_scalars(b) for b in blobs]
    commitments = [blob_to_kzg_commitment(b, device=device, oracle=oracle) for b in blobs]
    r, x = _compute_challenges([bytes(b) for b in blobs], commitments)
    agg, _agg_pt = _aggregate(blob_scalars, commitments, r)
    y = _evaluate_blob_at(agg, x)
    # quotient in evaluation form: q_i = (p_i - y) / (w_i - x)
    roots = compute_roots_of_unity(len(agg))
    q = [(p_i - y) % R * pow((w - x) % R, R - 2, R) % R for p_i, w in zip(agg, roots)]
    return _commit_evals(q, device, oracle=oracle)


def verify_aggregate_kzg_proof(blobs: list[bytes], commitments: list[bytes], proof: bytes, *,
                               device=None, oracle: bool = False) -> bool:
    """Early spec verify_aggregate_kzg_proof (the check inside
    validate_blobs_sidecar). An input fault (`KzgError`, `PointDecodeError`)
    is False; a device fault raises."""
    dev = None if oracle else resolve_device(device)
    if len(blobs) != len(commitments):
        return False
    if not blobs:
        return bytes(proof) == G1_INFINITY_BYTES
    try:
        blob_scalars = [_blob_to_scalars(b) for b in blobs]
        commitment_bytes = [bytes(c) for c in commitments]
        r, x = _compute_challenges([bytes(b) for b in blobs], commitment_bytes)
        agg, agg_pt = _aggregate(blob_scalars, commitment_bytes, r)
        y = _evaluate_blob_at(agg, x)
    except (KzgError, PointDecodeError):
        return False
    return verify_kzg_proof(g1_to_bytes(agg_pt), x, y, bytes(proof), device=dev, oracle=oracle)


def validate_blobs_sidecar(slot: int, beacon_block_root: bytes,
                           expected_kzg_commitments: list[bytes], sidecar, *, device=None,
                           oracle: bool = False) -> None:
    """Spec validate_blobs_sidecar (reference blobsSidecar.ts:73): slot
    and root binding, blob count, aggregate proof. Raises KzgError."""
    if int(sidecar.beacon_block_slot) != int(slot):
        raise KzgError("sidecar slot mismatch")
    if bytes(sidecar.beacon_block_root) != bytes(beacon_block_root):
        raise KzgError("sidecar block root mismatch")
    blobs = [bytes(b) for b in sidecar.blobs]
    if len(blobs) != len(expected_kzg_commitments):
        raise KzgError(f"{len(blobs)} blobs vs {len(expected_kzg_commitments)} commitments")
    if not verify_aggregate_kzg_proof(blobs, [bytes(c) for c in expected_kzg_commitments],
                                      bytes(sidecar.kzg_aggregated_proof), device=device,
                                      oracle=oracle):
        raise KzgError("aggregate KZG proof failed verification")
