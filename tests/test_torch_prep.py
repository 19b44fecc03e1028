"""The port's device input prep (`lodestar_tpu_torch.ops.prep`) held against
`lodestar_tpu.ops.prep`, the pure-Python oracle and the RFC 9380 J.10.1 G2
vectors, on the CPU (the plain versions of the kernels).

Tolerance: none. The host byte stage equals the JAX package's numpy
functions exactly; every device leg equals its JAX counterpart limb for
limb on the same inputs (batches of 8, the programs `tests/ops/test_prep.py`
compiles). Inputs are made from fixed numpy seeds: valid points, points on
the curve but off the subgroup, x off the curve, the infinity encoding,
x >= p and a cleared compressed flag. The JAX side of each comparison is
computed once per module in a fixture.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu import telemetry as jtelemetry
from lodestar_tpu.crypto.bls import curve as C
from lodestar_tpu.crypto.bls import fields as F
from lodestar_tpu.crypto.bls import serdes
from lodestar_tpu.crypto.bls.curve import G1_GEN, G2_GEN, g2_rhs
from lodestar_tpu.ops import prep as jprep
from lodestar_tpu_torch import telemetry
from lodestar_tpu_torch.ops import fp, prep
from lodestar_tpu_torch.ops import tower as tw
from tests.crypto.rfc9380_vectors import RFC9380_G2_DST, RFC9380_G2_RO_VECTORS

SIZE = 8


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread for this module: the tensors are small, so its
    worker threads only spin against the other test processes (measured
    on the CPU: the same tests in 53 s instead of 84, at a fifth of the
    CPU time)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rand_fp(r):
    while True:
        v = int.from_bytes(r.bytes(48), "little")
        if v < F.P:
            return v


def g1_cases(seed=21):
    """(N, 48) encodings: four subgroup points, then one on the curve off
    the subgroup, one x off the curve, infinity, x >= p."""
    r = np.random.default_rng(seed)
    pts = [C.g1_mul(G1_GEN, k) for k in (1, 5, 123456789, F.R - 2)]
    bufs = [serdes.g1_to_bytes(p) for p in pts]
    while True:
        x = rand_fp(r)
        y = F.fp_sqrt((x * x * x + 4) % F.P)
        if y is not None and not C.g1_in_subgroup_order_check((x, y)):
            bufs.append(serdes.g1_to_bytes((x, y)))
            break
    while True:
        x = rand_fp(r)
        if F.fp_sqrt((x * x * x + 4) % F.P) is None:
            bad = bytearray(x.to_bytes(48, "big"))
            bad[0] |= 0x80
            bufs.append(bytes(bad))
            break
    bufs.append(serdes.g1_to_bytes(None))
    over = bytearray(F.P.to_bytes(48, "big"))
    over[0] |= 0x80
    bufs.append(bytes(over))
    return np.stack([np.frombuffer(b, np.uint8) for b in bufs]), pts


def g2_cases(seed=22):
    """(N, 96) encodings: three subgroup points, then one on the twist off
    the subgroup, one x off the twist, infinity, x1 >= p, a cleared
    compressed flag."""
    r = np.random.default_rng(seed)
    pts = [C.g2_mul(G2_GEN, k) for k in (1, 7, 987654321)]
    bufs = [serdes.g2_to_bytes(p) for p in pts]
    while True:
        x = (rand_fp(r), rand_fp(r))
        y = F.fp2_sqrt(g2_rhs(x))
        if y is not None and not C.g2_in_subgroup_order_check((x, y)):
            bufs.append(serdes.g2_to_bytes((x, y)))
            break
    while True:
        x = (rand_fp(r), rand_fp(r))
        if F.fp2_sqrt(g2_rhs(x)) is None:
            bad = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
            bad[0] |= 0x80
            bufs.append(bytes(bad))
            break
    bufs.append(serdes.g2_to_bytes(None))
    over = bytearray(F.P.to_bytes(48, "big") + b"\x00" * 48)
    over[0] |= 0x80
    bufs.append(bytes(over))
    raw = bytearray(serdes.g2_to_bytes(pts[0]))
    raw[0] &= 0x7F
    bufs.append(bytes(raw))
    return np.stack([np.frombuffer(b, np.uint8) for b in bufs]), pts


def sqrt_inputs(seed=23):
    """Eight Montgomery Fp2 elements: squares, non-residues, zero, and 4
    (a square of Fp); and whether each is a square."""
    r = np.random.default_rng(seed)
    vals, squares = [], []
    for _ in range(3):
        s = F.fp2_sq((rand_fp(r), rand_fp(r)))
        vals += [s, F.fp2_mul(s, F._FP2_QNR)]
        squares += [True, False]
    vals += [(0, 0), (4, 0)]
    squares += [True, True]
    return np.stack([tw._fp2_mont_limbs_host(*v) for v in vals]), squares


def wide_inputs(seed=29):
    r = np.random.default_rng(seed)
    wides = [int.from_bytes(r.bytes(64), "big") for _ in range(SIZE)]
    b64 = np.stack([np.frombuffer(v.to_bytes(64, "big"), np.uint8) for v in wides])
    wl = prep.be_bytes_to_limbs(b64, nlimbs=43)
    lo = wl[:, : fp.LIMBS]
    hi = np.zeros((SIZE, fp.LIMBS), np.int32)
    hi[:, : 43 - fp.LIMBS] = wl[:, fp.LIMBS :]
    return wides, lo, hi


RFC_MSGS = [v[0] for v in RFC9380_G2_RO_VECTORS]
MSGS = RFC_MSGS + [b"lodestar" * 9, b"\x5a" * 32] + [RFC_MSGS[0]] * (SIZE - len(RFC_MSGS) - 2)


def t(a):
    """numpy -> CPU tensor; integer limbs as int32, the kernels' type (the
    JAX package's host stage gives int64)."""
    a = np.array(a)  # a writable copy (JAX arrays read back read-only)
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.int64 else a)


def same(got, want):
    """Limb-for-limb (and bit-for-bit) equality of a port result with the
    JAX package's, through nested tuples."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    assert np.array_equal(g, w)


def g2_values(a):
    flat = fp.ints_from_limbs(fp.from_mont(a.reshape(-1, fp.LIMBS)).numpy())
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result the tests compare with, computed once."""
    g1_buf, _ = g1_cases()
    g2_buf, _ = g2_cases()
    g1x, g1s, _ = jprep.parse_g1_compressed(g1_buf)
    g2x, g2s, _ = jprep.parse_g2_compressed(g2_buf)
    sq_in, _ = sqrt_inputs()
    _, lo, hi = wide_inputs()
    hlo, hhi = jprep.hash_to_field_limbs(MSGS, RFC9380_G2_DST)
    u = np.asarray(jprep.mont_from_wide(hlo, hhi))
    jac = tuple(np.asarray(c) for c in jprep.map_to_g2_jac(u))
    q0 = tuple(c[:, 0] for c in jac)
    q1 = tuple(c[:, 1] for c in jac)
    args = (g1x, g1s, g2x, g2s, hlo, hhi)
    return {
        "g1": jprep.g1_decompress_subgroup(g1x, g1s),
        "g2": jprep.g2_decompress_subgroup(g2x, g2s),
        "sqrt": jprep.fp2_sqrt_with_flag(sq_in),
        "wide": jprep.mont_from_wide(lo, hi),
        "u": u,
        "jac": jac,
        "q0": q0,
        "q1": q1,
        "finish": jprep.hash_finish(q0, q1),
        "args": args,
        "fused": jprep.prepare_arrays_fused(*args),
    }


class _Counter:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1


@pytest.fixture(scope="module")
def port_schedules(jax_side):
    """One fused and one unfused call of the port on the JAX fixture's
    inputs, with launch telemetry on and a counter installed."""
    args = tuple(t(a) for a in jax_side["args"])
    counter = _Counter()
    prep.configure_launch_counter(counter)
    prev_mode = telemetry._mode
    telemetry._mode = "on"
    try:
        base = prep.prep_launches_total()
        ledger_base = len(telemetry._ledger)
        fused = prep.prepare_arrays_fused(*args)
        fused_launches = prep.prep_launches_total() - base
        fused_ledger = list(telemetry._ledger)[ledger_base:]
        counted = counter.n
        base = prep.prep_launches_total()
        unfused = prep.prepare_arrays_unfused(*args)
        unfused_launches = prep.prep_launches_total() - base
    finally:
        telemetry._mode = prev_mode
        prep.configure_launch_counter(None)
    return {
        "fused": fused,
        "unfused": unfused,
        "fused_launches": fused_launches,
        "unfused_launches": unfused_launches,
        "fused_ledger": fused_ledger,
        "counted": counted,
    }


# --- module constants -------------------------------------------------------------

CONSTANTS = ["_P_BE48", "_HALF_P_LIMBS", "_B1_MONT", "_B2_MONT", "_BETA_MONT", "_PSI_CX_MONT",
             "_PSI_CY_MONT", "_A_MONT", "_ISO_B_MONT", "_Z_MONT", "_NEG_B_OVER_A_MONT",
             "_B_OVER_ZA_MONT", "_K1_MONT", "_K2_MONT", "_K3_MONT", "_K4_MONT", "_SQRT_CANDS",
             "_R3_LIMBS", "_E_FP_SQRT", "_E_FP2_SQRT_BITS", "_ONE2"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_matches_jax(name):
    got, want = getattr(prep, name), getattr(jprep, name)
    if isinstance(want, int):
        assert got == want
    else:
        assert got.shape == want.shape and np.array_equal(got, want)


def test_launch_budgets_match_jax():
    assert prep.FUSED_PREP_LAUNCHES == jprep.FUSED_PREP_LAUNCHES == 3
    assert prep.UNFUSED_PREP_LAUNCHES == jprep.UNFUSED_PREP_LAUNCHES == 5


# --- host byte stage ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 100, 128, 2048, 2049])
def test_pad_pow2_matches_jax(n):
    assert prep.pad_pow2(n) == jprep.pad_pow2(n)
    assert prep.pad_pow2(n, floor=1) == jprep.pad_pow2(n, floor=1)


def test_pad_rows_matches_jax():
    a = np.arange(3 * 5).reshape(3, 5)
    for size in (3, 4, 8):
        assert np.array_equal(prep.pad_rows(a, size), jprep.pad_rows(a, size))


@pytest.mark.parametrize("nbytes,nlimbs", [(48, 33), (64, 43), (1, 1)])
def test_be_bytes_to_limbs_matches_jax(nbytes, nlimbs):
    data = np.random.default_rng(nbytes).integers(0, 256, size=(16, nbytes), dtype=np.uint8)
    got = prep.be_bytes_to_limbs(data, nlimbs)
    assert got.dtype == np.int32
    assert np.array_equal(got, jprep.be_bytes_to_limbs(data, nlimbs))
    with pytest.raises(ValueError):
        prep.be_bytes_to_limbs(np.zeros((1, 50), np.uint8))


def test_lt_be_matches_jax():
    r = np.random.default_rng(3)
    a = r.integers(0, 256, size=(64, 48), dtype=np.uint8)
    a[:8] = prep._P_BE48  # equal
    a[8:16, :40] = prep._P_BE48[:40]  # differ late
    assert np.array_equal(prep._lt_be(a, prep._P_BE48), jprep._lt_be(a, jprep._P_BE48))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_parse_compressed_matches_jax(group):
    buf, _ = g1_cases() if group == "g1" else g2_cases()
    parse = getattr(prep, f"parse_{group}_compressed")
    jparse = getattr(jprep, f"parse_{group}_compressed")
    for g, w in zip(parse(buf), jparse(buf)):
        assert np.array_equal(g, w)
    ok = parse(buf)[2]
    # the structural verdicts: infinity, x >= p and a cleared flag are host rejects
    want = [True] * 6 + [False] * 2 if group == "g1" else [True] * 5 + [False] * 3
    assert list(ok) == want


@pytest.mark.parametrize("dst", ["default", "rfc9380"])
def test_hash_to_field_limbs_matches_jax(dst):
    kw = {} if dst == "default" else {"dst": RFC9380_G2_DST}
    for g, w in zip(prep.hash_to_field_limbs(MSGS, **kw), jprep.hash_to_field_limbs(MSGS, **kw)):
        assert g.dtype == np.int32 and g.shape == (SIZE, 2, 2, fp.LIMBS)
        assert np.array_equal(g, w)


def test_telemetry_helpers_match_jax():
    for n in (0, 1, 5, 8, 9, 2048, 3000):
        assert telemetry.size_class_of(n) == jtelemetry.size_class_of(n)
    args = ((np.zeros((16, 2)), np.zeros((16, 2))), np.zeros(3))
    assert telemetry.launch_size_class(args) == jtelemetry.launch_size_class(args) == 16
    assert telemetry.launch_size_class((1, "x")) == 0
    assert telemetry.program_name(prep.hash_finish) == "hash_finish"
    assert telemetry.program_name(prep.hash_finish) == jtelemetry.program_name(jprep.hash_finish)


# --- device legs against the JAX package ----------------------------------------------


def test_fp2_sqrt_with_flag_matches_jax(jax_side):
    a, squares = sqrt_inputs()
    root, ok = prep.fp2_sqrt_with_flag(t(a))
    same((root, ok), jax_side["sqrt"])
    assert ok.tolist() == squares
    got = g2_values(tw.fp2_sq(root))
    for v, want, is_sq in zip(got, g2_values(t(a)), squares):
        assert (v == want) == is_sq  # a root squares back exactly where one exists


def test_g1_decompress_subgroup_matches_jax(jax_side):
    buf, pts = g1_cases()
    x_std, sign, struct = prep.parse_g1_compressed(buf)
    x, y, ok = prep.g1_decompress_subgroup(t(x_std), t(sign))
    same((x, y, ok), jax_side["g1"])
    assert list(struct & ok.numpy()) == [True] * 4 + [False] * 4
    xs = fp.ints_from_limbs(fp.from_mont(x[:4]).numpy())
    ys = fp.ints_from_limbs(fp.from_mont(y[:4]).numpy())
    assert list(zip(xs, ys)) == pts


def test_g2_decompress_subgroup_matches_jax(jax_side):
    buf, pts = g2_cases()
    x_std, sign, struct = prep.parse_g2_compressed(buf)
    x, y, ok = prep.g2_decompress_subgroup(t(x_std), t(sign))
    same((x, y, ok), jax_side["g2"])
    assert list(struct & ok.numpy()) == [True] * 3 + [False] * 5
    assert list(zip(g2_values(x[:3]), g2_values(y[:3]))) == pts


def test_mont_from_wide_matches_jax(jax_side):
    wides, lo, hi = wide_inputs()
    m = prep.mont_from_wide(t(lo), t(hi))
    same(m, jax_side["wide"])
    assert fp.ints_from_limbs(fp.from_mont(m).numpy()) == [v % F.P for v in wides]


def test_map_to_g2_jac_matches_jax(jax_side):
    same(prep.map_to_g2_jac(t(jax_side["u"])), jax_side["jac"])


def test_hash_finish_matches_jax(jax_side):
    q0 = tuple(t(c) for c in jax_side["q0"])
    q1 = tuple(t(c) for c in jax_side["q1"])
    same(prep.hash_finish(q0, q1), jax_side["finish"])


def test_hash_to_g2_device_gives_the_rfc9380_vectors():
    base = prep.prep_launches_total()
    hx, hy = prep.hash_to_g2_device(RFC_MSGS, RFC9380_G2_DST, device="cpu")
    assert prep.prep_launches_total() - base == 3
    assert hx.shape == (len(RFC_MSGS), 2, fp.LIMBS)
    for (gx, gy), (_msg, px0, px1, py0, py1) in zip(
        zip(g2_values(hx), g2_values(hy)), RFC9380_G2_RO_VECTORS
    ):
        assert ("%096x" % gx[0], "%096x" % gx[1]) == (px0, px1)
        assert ("%096x" % gy[0], "%096x" % gy[1]) == (py0, py1)
    with pytest.raises(ValueError):
        prep.hash_to_g2_device([], device="cpu")


# --- the schedules ------------------------------------------------------------------


def test_fused_schedule_matches_jax(jax_side, port_schedules):
    same(port_schedules["fused"], jax_side["fused"])


def test_fused_equals_unfused_bit_for_bit(port_schedules):
    same(port_schedules["fused"], port_schedules["unfused"])


def test_fused_call_costs_three_launches(port_schedules):
    assert port_schedules["fused_launches"] == prep.FUSED_PREP_LAUNCHES
    assert port_schedules["counted"] == prep.FUSED_PREP_LAUNCHES  # the installed counter
    assert port_schedules["unfused_launches"] == prep.UNFUSED_PREP_LAUNCHES


def test_telemetry_records_each_fused_stage(port_schedules):
    ledger = port_schedules["fused_ledger"]
    assert [e["program"] for e in ledger] == ["_prep_field_stage", "_prep_subgroup_stage",
                                             "hash_finish"]
    assert all(e["size_class"] == SIZE and e["seconds"] > 0 for e in ledger)


def test_rfc9380_vectors_through_the_fused_stage(port_schedules):
    pk_ok, sig_ok = port_schedules["fused"][1], port_schedules["fused"][3]
    assert pk_ok[:6].tolist() == [True] * 4 + [False] * 2
    assert sig_ok[:5].tolist() == [True] * 3 + [False] * 2
    hx, hy = port_schedules["fused"][4]
    for (gx, gy), (_msg, px0, px1, py0, py1) in zip(
        zip(g2_values(hx), g2_values(hy)), RFC9380_G2_RO_VECTORS
    ):
        assert ("%096x" % gx[0], "%096x" % gx[1]) == (px0, px1)
        assert ("%096x" % gy[0], "%096x" % gy[1]) == (py0, py1)


@pytest.mark.parametrize("size", [8, pytest.param(16, marks=pytest.mark.slow)])
def test_launches_per_fused_call_do_not_depend_on_size(size):
    g1 = np.repeat(np.frombuffer(serdes.g1_to_bytes(G1_GEN), np.uint8)[None], size, 0)
    g2 = np.repeat(np.frombuffer(serdes.g2_to_bytes(G2_GEN), np.uint8)[None], size, 0)
    pk, pk_sign, _ = prep.parse_g1_compressed(g1)
    sig, sig_sign, _ = prep.parse_g2_compressed(g2)
    lo, hi = prep.hash_to_field_limbs([bytes([i]) * 32 for i in range(size)])
    base = prep.prep_launches_total()
    out = prep.prepare_arrays_fused(t(pk), t(pk_sign), t(sig), t(sig_sign), t(lo), t(hi))
    assert prep.prep_launches_total() - base == prep.FUSED_PREP_LAUNCHES
    assert out[1].all() and out[3].all()
