"""The port's benchmark (`lodestar_tpu_torch.bench`) held against the repo's
`bench.py` and the JAX package on the CPU.

bench.py's sets and its merge of MERGE_JOBS copies of one job must come
out of the port unchanged: the sets bytes-equal to the JAX fixture's, the
merged arrays limb-equal to what bench.py builds from the JAX package's
`build_device_inputs`, and the verdicts of both packages'
`device_batch_verify` equal with the same blinding bits. Then the port's
line: bench.py's keys and strings, on the split road (the CPU's default)
and the single launch (forced on, its body run eagerly), a False verdict
raising with nothing printed, and `bench_merkle`'s root equal to hashlib's
and to the JAX package's `merkle_root_device`.

Tolerance: none (equal bytes, limbs and verdicts). Sizes: BATCH = 8,
MERGE_JOBS = 2, ITERS = 1 (monkeypatched), one ATen thread.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu.ops import sha256 as jsha
from lodestar_tpu_torch import bench as tb
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import prep as dp
from lodestar_tpu_torch.ssz import device_htr as dh
from lodestar_tpu_torch.ssz.hash import hash_nodes_hashlib

REPO = pathlib.Path(__file__).resolve().parent.parent
KEYS = ["metric", "value", "unit", "vs_baseline"]
CONSTANTS = ("REFERENCE_SIGS_PER_SEC_PER_CORE", "BATCH", "MERGE_JOBS", "ITERS")
UNPATCHED = {n: getattr(tb, n) for n in CONSTANTS}  # read before `small` patches them


def _root_bench():
    """The repo's bench.py, loaded from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """bench.py's workload cut to 2 jobs of 8 sets, one timed launch, on one
    ATen thread; the single-launch mode as the test left it is restored."""
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_mode = bv.configure_single_launch()
    monkeypatch.setattr(tb, "BATCH", 8)
    monkeypatch.setattr(tb, "MERGE_JOBS", 2)
    monkeypatch.setattr(tb, "ITERS", 1)
    yield
    bv.configure_single_launch(prev_mode)
    torch.set_num_threads(prev_threads)


def check_line(line):
    assert list(line) == KEYS
    assert line["metric"] == "bls_batch_verify_sigs_per_sec" and line["unit"] == "sigs/s"
    assert isinstance(line["value"], float) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 2200.0, 2)


def test_constants_are_bench_pys():
    root = _root_bench()
    assert UNPATCHED == {n: getattr(root, n) for n in CONSTANTS}


def test_sets_are_the_jax_fixtures():
    """(a) `_make_sets(8)` is bytes-equal to bench.py's, the JAX package's
    `make_synthetic_sets(8, seed=17)`."""
    want = _root_bench()._make_sets(8)
    assert [(s.pubkey, s.message, s.signature)
            for s in jbv.make_synthetic_sets(8, seed=17)] == [
        (s.pubkey, s.message, s.signature) for s in want]
    got = tb._make_sets(8)
    assert [(s.pubkey, s.message, s.signature) for s in got] == [
        (s.pubkey, s.message, s.signature) for s in want]


def test_split_road_merge_is_bench_pys():
    """(b) On the split road the merged inputs are limb-equal to bench.py's
    (`build_device_inputs` of the JAX package, each array concatenated
    MERGE_JOBS times, an all-True mask), and both packages'
    `device_batch_verify` say True on them with the same bits."""
    assert not bv.single_launch_active(device="cpu")
    staged = tb.merged_inputs("cpu")
    pk, h, sig, mask = staged
    inputs = jbv.build_device_inputs(tb._make_sets(tb.BATCH))
    assert inputs is not None

    def tile1(a):
        return np.concatenate([np.asarray(a)] * tb.MERGE_JOBS, axis=0)

    merged = tb.BATCH * tb.MERGE_JOBS
    want = [(tile1(c[0]), tile1(c[1])) for c in inputs[:3]]
    for got_pair, want_pair in zip((pk, h, sig), want):
        for got, expect in zip(got_pair, want_pair):
            assert got.dtype == torch.int32 and got.shape[0] == merged
            np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(mask.numpy(), np.ones(merged, dtype=bool))

    bits = jbv._bits_msb(jbv._random_coeffs(merged), jbv.COEFF_BITS)
    j_ok = bool(np.asarray(jbv.device_batch_verify(*want, bits, np.ones(merged, dtype=bool))))
    t_ok = bool(bv.device_batch_verify(pk, h, sig, torch.as_tensor(bits), mask))
    assert j_ok is t_ok is True


def test_split_road_line(monkeypatch):
    """(c) `bench_batch_verify(device="cpu")` returns bench.py's keys and
    strings, through the split road (`device_batch_verify`, warm-up + ITERS
    calls)."""
    calls = []
    real = bv.device_batch_verify

    def counted(*args):
        calls.append(args[4].shape[0])
        return real(*args)

    monkeypatch.setattr(bv, "device_batch_verify", counted)
    line = tb.bench_batch_verify(device="cpu")
    check_line(line)
    assert calls == [tb.BATCH * tb.MERGE_JOBS] * (1 + tb.ITERS)


def test_single_launch_road_line():
    """(d) With the single launch forced on, the CPU takes the card's road:
    the merged sets' host byte stage once, then one dispatch of the body a
    launch (here eager), ITERS + 1 of them; the same line."""
    bv.configure_single_launch("on")
    staged = tb.merged_inputs("cpu")
    assert isinstance(staged, bv.SingleLaunchInputs)
    assert staged.n == len(staged.mask) == tb.BATCH * tb.MERGE_JOBS
    base = dp.prep_launches_total()
    line = tb.bench_batch_verify(device="cpu")
    check_line(line)
    assert dp.prep_launches_total() - base == (1 + tb.ITERS) * dp.SINGLE_LAUNCH_BUDGET


def _tampered(change):
    sets = bv.make_synthetic_sets(8, seed=17)
    if change == "signature_byte":
        sig = bytearray(sets[3].signature)
        sig[40] ^= 0x01
        sets[3] = dataclasses.replace(sets[3], signature=bytes(sig))
    else:  # two valid signatures swapped: every point decodes, the verdict is False
        sets[2], sets[5] = (dataclasses.replace(sets[2], signature=sets[5].signature),
                            dataclasses.replace(sets[5], signature=sets[2].signature))
    return sets


@pytest.mark.parametrize("change", ["signature_byte", "swapped_signatures"])
def test_a_bad_job_raises_and_prints_nothing(change, monkeypatch, capsys):
    """(e) A job with a changed signature makes the bench raise (prep's
    reject, or the warm-up's False verdict), and `main` prints no line."""
    monkeypatch.setattr(tb, "_make_sets", lambda n: _tampered(change))
    with pytest.raises(RuntimeError):
        tb.main(device="cpu")
    assert capsys.readouterr().out == ""


def test_a_false_timed_verdict_raises(monkeypatch, capsys):
    """(e) The gate holds after the warm-up too: a timed launch whose
    verdict is False raises, and nothing is printed."""
    real = bv.device_batch_verify
    calls = []

    def false_after_warm_up(*args):
        calls.append(1)
        ok = real(*args)
        return ok if len(calls) == 1 else torch.zeros((), dtype=torch.bool)

    monkeypatch.setattr(bv, "device_batch_verify", false_after_warm_up)
    with pytest.raises(RuntimeError, match="timed"):
        tb.main(device="cpu")
    assert len(calls) == 1 + tb.ITERS and capsys.readouterr().out == ""


@pytest.fixture
def htr_on_the_cpu():
    """The port's HTR device on the CPU, as `tests/test_torch_device_htr.py`
    sets it; the settings are restored after."""
    prev_dev = dh._htr_device
    prev = dh.configure_device_htr(device="cpu")
    yield
    dh.configure_device_htr(mode=prev, device=prev_dev)


def test_bench_merkle_root(htr_on_the_cpu, monkeypatch):
    """(f) `bench_merkle(depth=10, device="cpu")` roots bench.py's words: every
    root equal to hashlib's and to the JAX package's `merkle_root_device`;
    the HTR settings are the caller's again afterwards; bench.py's line
    shape."""
    roots = []
    real = dh.merkle_root

    def recorded(data):
        roots.append(real(data))
        return roots[-1]

    monkeypatch.setattr(dh, "merkle_root", recorded)
    mode = dh.configure_device_htr()
    line = tb.bench_merkle(depth=10, device="cpu")
    assert dh._htr_device == torch.device("cpu") and dh.configure_device_htr() == mode

    n = 1 << 10
    words = np.random.default_rng(0).integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    level = np.frombuffer(words.astype(">u4").tobytes(), dtype=np.uint8).reshape(n, 32)
    while level.shape[0] > 1:
        level = hash_nodes_hashlib(level)
    jax_root = np.asarray(jsha.merkle_root_device(words)).astype(">u4").tobytes()
    assert jax_root == level[0].tobytes()
    assert roots == [jax_root] * (1 + tb.MERKLE_ITERS)
    assert list(line) == KEYS
    assert line["metric"] == "merkle_sha256_pair_hashes_per_sec" and line["unit"] == "hashes/s"
    assert isinstance(line["value"], int) and line["value"] > 0
    assert isinstance(line["vs_baseline"], float)
