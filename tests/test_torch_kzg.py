"""The port's KZG (`lodestar_tpu_torch.crypto.kzg`) held against
`lodestar_tpu.crypto.kzg` and the pure-Python oracle.

Tolerance: none: commitment and proof bytes, field elements and verdicts
are compared for equality. The port runs its device road on CPU tensors
(`device="cpu"`, the kernels' plain versions); the JAX package runs its
device road (`device=True`) on the CPU backend, as its own tests do.

Sizes. The trusted setup, the roots of unity, the inverse NTT, the
challenges and the barycentric evaluation run at the mainnet 4,096 field
elements a blob. An MSM on the CPU road costs ~0.03-3 s a bit on one CPU
core (8 to 4,096 points, 255 bits), so the commitment is held against the
JAX package and the oracle on an 8-point prefix of the setup with full
255-bit scalars, and against the oracle on a 64-point prefix; the full
4,096-point blob commitment on the CPU road (~14 minutes) is `slow`. The
block-level aggregate proof runs on the oracle road with blobs that are
evaluations of degree-3 polynomials: full-size blobs whose coefficient
vectors have 4 nonzero entries, so the oracle's MSM (which skips zero
scalars) takes milliseconds instead of ~35 s a blob.

The device road's departure from the JAX package is tested too: a device
fault raises out of every check, and the oracle never serves in its place.
"""

import random

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import kzg as JK
from lodestar_tpu_torch.crypto import kzg as K
from lodestar_tpu_torch.crypto.bls import curve as C
from lodestar_tpu_torch.crypto.bls import fields as F
from lodestar_tpu_torch.crypto.bls import pairing as orc
from lodestar_tpu_torch.crypto.bls.serdes import g1_to_bytes
from lodestar_tpu_torch.ops import pairing as prg

R = K.R
N = K.FIELD_ELEMENTS_PER_BLOB_MAINNET


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread: the tensors are small and the MSM and the
    pairing are thousands of small ops, so worker threads only spin
    against the other test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    return K.load_trusted_setup()


def blob_of_poly(coeffs):
    """The full-size blob (evaluation form over the bit-reversed domain,
    little-endian) of the polynomial sum_k coeffs[k] x^k."""
    out = bytearray()
    for w in K.compute_roots_of_unity(N):
        v = 0
        for c in reversed(coeffs):
            v = (v * w + c) % R
        out += v.to_bytes(32, K.KZG_ENDIANNESS)
    return bytes(out)


def random_blob(seed):
    r = np.random.default_rng(seed)
    return b"".join((int.from_bytes(r.bytes(32), "little") % R).to_bytes(32, "little")
                    for _ in range(N))


def off_subgroup_g1():
    """A point on the curve y^2 = x^3 + 4 outside the r-subgroup."""
    x = 1
    while True:
        y = F.fp_sqrt((x * x * x + 4) % F.P)
        if y is not None and not C.g1_in_subgroup((x, y)):
            return g1_to_bytes((x, y))
        x += 1


def test_setup_copy_is_byte_equal_and_parses_as_jax(setup):
    with open(K.SETUP_PATH, "rb") as mine, open(JK._SETUP_PATH, "rb") as theirs:
        assert mine.read() == theirs.read()
    g1, g2 = setup
    assert (g1, g2) == JK.load_trusted_setup()
    assert len(g1) == N and len(g2) == 65
    assert g1[0] == C.G1_GEN and g2[0] == C.G2_GEN
    # the ceremony's tau is the same in both groups: e([tau]1, G2) == e(G1, [tau]2)
    assert orc.pairings_are_one([(g1[1], g2[0]), (C.g1_neg(C.G1_GEN), g2[1])])


@pytest.mark.parametrize("n", [8, N])
def test_roots_of_unity_and_inverse_ntt_match_jax(n):
    for bit_reversed in (True, False):
        assert K.compute_roots_of_unity(n, bit_reversed) == JK.compute_roots_of_unity(
            n, bit_reversed)
    natural = K.compute_roots_of_unity(n, bit_reversed=False)
    assert pow(natural[1], n, R) == 1 and pow(natural[1], n // 2, R) != 1
    rng = random.Random(n)
    evals = [rng.randrange(R) for _ in range(n)]
    coeffs = K._inverse_ntt(evals)
    assert coeffs == JK._inverse_ntt(evals)
    assert K._ntt(coeffs, natural[1]) == evals  # the forward NTT evaluates back
    assert [K._bit_reverse(i, n) for i in range(n)] == [JK._bit_reverse(i, n) for i in range(n)]


def test_blob_bytes_and_coefficients():
    blob = blob_of_poly([5, 7, 0, 11])
    assert K._blob_to_scalars(blob) == JK._blob_to_scalars(blob)
    assert K._coefficients(K._blob_to_scalars(blob)) == [5, 7, 0, 11] + [0] * (N - 4)
    with pytest.raises(K.KzgError, match="multiple of 32"):
        K._blob_to_scalars(blob[:-1])
    with pytest.raises(K.KzgError, match="field range"):
        K._blob_to_scalars(R.to_bytes(32, "little"))
    with pytest.raises(K.KzgError, match="elements"):
        K.blob_to_kzg_commitment(blob[: 32 * 8], oracle=True)


def test_commit_msm_prefix_matches_jax_and_oracle(setup):
    """8 setup points, full 255-bit scalars: the port's device road on CPU
    tensors, the JAX package's device road and the oracle give one point."""
    g1, _ = setup
    rng = random.Random(8)
    scalars = [rng.randrange(R) for _ in range(8)]
    scalars[3] = 0  # a zero scalar: an exact-zero infinity row
    got = K._commit_msm(g1[:8], scalars, device="cpu")
    assert got == JK._commit_msm(g1[:8], scalars, True)
    assert got == K._commit_msm(g1[:8], scalars, oracle=True)
    assert K._commit_msm(g1[:8], [0] * 8, device="cpu") == K.G1_INFINITY_BYTES


def test_commit_msm_64_points_against_oracle(setup):
    """The 64-point twin of the slow full-blob test: a constant polynomial
    commits to [c]G1, and random 255-bit scalars to the oracle's point."""
    g1, _ = setup
    c = 0x1234567
    assert (K._commit_msm(g1[:64], [c] + [0] * 63, device="cpu")
            == g1_to_bytes(C.g1_mul(C.G1_GEN, c)))
    rng = random.Random(64)
    scalars = [rng.randrange(R) for _ in range(64)]
    assert (K._commit_msm(g1[:64], scalars, device="cpu")
            == K._commit_msm(g1[:64], scalars, oracle=True))


@pytest.mark.slow
def test_blob_commitment_full_size_on_the_cpu_road(setup):
    """A random mainnet blob (4,096 elements) and a constant one through the
    4,096-point MSM on CPU tensors (~14 minutes each on one core), against
    the oracle's bytes and [c]G1."""
    blob = random_blob(4096)
    assert K.blob_to_kzg_commitment(blob, device="cpu") == K.blob_to_kzg_commitment(
        blob, oracle=True)
    c = 0x1234567
    const = c.to_bytes(32, "little") * N
    assert K.blob_to_kzg_commitment(const, device="cpu") == g1_to_bytes(C.g1_mul(C.G1_GEN, c))


def test_verify_kzg_proof_matches_jax(setup):
    """Through the port's `multi_pairing_is_one` at pair class 2: a linear
    polynomial a + b x commits to [a]G1 + [b][tau]G1 and opens at z to
    a + b z with the proof [b]G1 (its quotient is the constant b)."""
    g1, _ = setup
    a, b, z = 1234, 5678, 99
    commitment = g1_to_bytes(C.g1_add(C.g1_mul(g1[0], a), C.g1_mul(g1[1], b)))
    proof = g1_to_bytes(C.g1_mul(C.G1_GEN, b))
    y = (a + b * z) % R
    for yy, want in ((y, True), (y + 1, False)):
        got = K.verify_kzg_proof(commitment, z, yy, proof, device="cpu")
        assert got == JK.verify_kzg_proof(commitment, z, yy, proof) == want
        assert got == K.verify_kzg_proof(commitment, z, yy, proof, oracle=True)
    # the pairs the device road checks are the oracle's pairs
    pairs = K._opening_pairs(commitment, z, y, proof)
    assert orc.pairings_are_one(pairs)
    # a constant polynomial opens anywhere with the infinity proof
    c = 0x1234567
    const = g1_to_bytes(C.g1_mul(C.G1_GEN, c))
    assert K.verify_kzg_proof(const, z, c, K.G1_INFINITY_BYTES, device="cpu")


def test_verify_kzg_proof_input_faults_are_false(setup):
    """Malformed and off-subgroup points are False without a pairing, as in
    the JAX package."""
    good = g1_to_bytes(C.G1_GEN)
    bad_points = [b"\x00" * 48, b"\xc0" + b"\x01" * 47, off_subgroup_g1()]
    for bad in bad_points:
        for commitment, proof in ((bad, good), (good, bad)):
            assert not K.verify_kzg_proof(commitment, 1, 1, proof, device="cpu")
            assert not JK.verify_kzg_proof(commitment, 1, 1, proof, device=False)


def test_challenges_aggregate_and_evaluation_match_jax():
    blobs = [random_blob(1), random_blob(2)]
    commitments = [g1_to_bytes(C.g1_mul(C.G1_GEN, k)) for k in (3, 5)]
    r, x = K._compute_challenges(blobs, commitments)
    assert (r, x) == JK._compute_challenges(blobs, commitments)
    assert K._compute_challenge(blobs[0], commitments[0]) == JK._compute_challenge(
        blobs[0], commitments[0])
    scalars = [K._blob_to_scalars(b) for b in blobs]
    agg, agg_pt = K._aggregate(scalars, commitments, r)
    assert (agg, agg_pt) == JK._aggregate(scalars, commitments, r)
    assert agg_pt == C.g1_mul(C.G1_GEN, (3 + 5 * r) % R)
    y = K._evaluate_blob_at(agg, x)
    assert y == JK._evaluate_blob_at(agg, x)
    roots = K.compute_roots_of_unity(N)
    assert K._evaluate_blob_at(agg, roots[7]) == agg[7]  # z on the domain
    with pytest.raises(K.KzgError, match="subgroup"):
        K._aggregate(scalars, [commitments[0], off_subgroup_g1()], r)


@pytest.fixture(scope="module")
def block():
    """Two full-size blobs of degree-3 polynomials, their commitments and
    their aggregate proof, on the oracle road of the port and of the JAX
    package (equal bytes)."""
    blobs = [blob_of_poly([3, 1, 4, 1]), blob_of_poly([5, 9, 2, 6])]
    commitments = [K.blob_to_kzg_commitment(b, oracle=True) for b in blobs]
    assert commitments == [JK.blob_to_kzg_commitment(b, device=False) for b in blobs]
    proof = K.compute_aggregate_kzg_proof(blobs, oracle=True)
    assert proof == JK.compute_aggregate_kzg_proof(blobs, device=False)
    return blobs, commitments, proof


class _Sidecar:
    beacon_block_slot = 7
    beacon_block_root = b"\x11" * 32

    def __init__(self, blobs, proof):
        self.blobs = blobs
        self.kzg_aggregated_proof = proof


def test_aggregate_proof_swaps_and_tampering_on_the_oracle_road(block):
    blobs, (c1, c2), proof = block
    (b1, b2) = blobs
    cases = [
        (([b1, b2], [c1, c2], proof), True),
        (([b1, b2], [c2, c1], proof), False),
        (([b2, b1], [c1, c2], proof), False),
        (([b1, b2], [c1, c2], K.G1_INFINITY_BYTES), False),
        (([b1, b2], [c1], proof), False),
        (([b1, b2], [c1, b"\x00" * 48], proof), False),  # malformed commitment
        (([], [], K.G1_INFINITY_BYTES), True),
        (([], [], proof), False),
    ]
    for args, want in cases:
        assert K.verify_aggregate_kzg_proof(*args, oracle=True) == want
        assert JK.verify_aggregate_kzg_proof(*args) == want
    K.validate_blobs_sidecar(7, b"\x11" * 32, [c1, c2], _Sidecar(blobs, proof), oracle=True)
    with pytest.raises(K.KzgError, match="slot"):
        K.validate_blobs_sidecar(8, b"\x11" * 32, [c1, c2], _Sidecar(blobs, proof), oracle=True)
    with pytest.raises(K.KzgError, match="root"):
        K.validate_blobs_sidecar(7, b"\x22" * 32, [c1, c2], _Sidecar(blobs, proof), oracle=True)
    with pytest.raises(K.KzgError, match="commitments"):
        K.validate_blobs_sidecar(7, b"\x11" * 32, [c1], _Sidecar(blobs, proof), oracle=True)
    with pytest.raises(K.KzgError, match="proof"):
        K.validate_blobs_sidecar(7, b"\x11" * 32, [c1, c2],
                                 _Sidecar(blobs, K.G1_INFINITY_BYTES), oracle=True)


def test_aggregate_proof_on_the_device_road(block):
    """The block's check through the port's pairing check on CPU tensors."""
    blobs, commitments, proof = block
    assert K.verify_aggregate_kzg_proof(blobs, commitments, proof, device="cpu")
    assert not K.verify_aggregate_kzg_proof(blobs, commitments[::-1], proof, device="cpu")
    K.validate_blobs_sidecar(7, b"\x11" * 32, commitments, _Sidecar(blobs, proof),
                             device="cpu")


def test_a_device_fault_raises_and_the_oracle_never_serves(block, monkeypatch):
    """The departure from the JAX package: no fallback. A fault inside
    `multi_pairing_is_one` raises out of each check; the oracle's
    `pairings_are_one` is never called; an input fault stays False."""
    blobs, commitments, proof = block
    oracle_calls = []

    def fault(*args, **kwargs):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(prg, "multi_pairing_is_one", fault)
    monkeypatch.setattr(K, "pairings_are_one", lambda pairs: oracle_calls.append(pairs))
    c = 0x1234567
    const = g1_to_bytes(C.g1_mul(C.G1_GEN, c))
    with pytest.raises(RuntimeError, match="injected"):
        K.verify_kzg_proof(const, 99, c, K.G1_INFINITY_BYTES, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        K.verify_aggregate_kzg_proof(blobs, commitments, proof, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        K.validate_blobs_sidecar(7, b"\x11" * 32, commitments, _Sidecar(blobs, proof),
                                 device="cpu")
    assert not K.verify_kzg_proof(b"\x00" * 48, 99, c, K.G1_INFINITY_BYTES, device="cpu")
    assert oracle_calls == []


def test_entry_points_default_to_cuda_and_raise_without_it(block):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    blobs, commitments, proof = block
    calls = [
        lambda: K.blob_to_kzg_commitment(blobs[0]),
        lambda: K.compute_aggregate_kzg_proof(blobs),
        lambda: K.verify_kzg_proof(commitments[0], 1, 1, proof),
        lambda: K.verify_blob_kzg_proof(blobs[0], commitments[0], proof),
        lambda: K.verify_aggregate_kzg_proof(blobs, commitments, proof),
        lambda: K.validate_blobs_sidecar(7, b"\x11" * 32, commitments, _Sidecar(blobs, proof)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_verify_blob_kzg_proof_matches_jax():
    """The per-blob Fiat-Shamir check on the CPU road: a constant blob with
    the infinity proof is True for its commitment and False for another."""
    c = 0x1234567
    blob = c.to_bytes(32, "little") * N
    right = g1_to_bytes(C.g1_mul(C.G1_GEN, c))
    wrong = g1_to_bytes(C.g1_mul(C.G1_GEN, c + 1))
    for commitment, want in ((right, True), (wrong, False)):
        got = K.verify_blob_kzg_proof(blob, commitment, K.G1_INFINITY_BYTES, device="cpu")
        assert got == JK.verify_blob_kzg_proof(blob, commitment, K.G1_INFINITY_BYTES) == want


@pytest.mark.slow
def test_kzg_rows_are_the_graph_bodies_row_counts():
    """`chip_smoke.KZG_ROWS` is the union of the row counts the MSM body at
    class 4,096 and the pairing-check body at class 2 launch the kernels
    at, counted on meta tensors (~75 s here), and phase 3 checks them."""
    import chip_smoke

    rows = chip_smoke.kzg_rows_on_meta()
    seen = {n for graph in rows.values() for by in graph.values() for n in by}
    assert seen == set(chip_smoke.KZG_ROWS)
    assert set(chip_smoke.KZG_ROWS) <= set(chip_smoke.N_KERNEL_CHECK)
    assert rows["msm"]["mont_mul"][N] > 0 and rows["check"]["mul_acc"]
