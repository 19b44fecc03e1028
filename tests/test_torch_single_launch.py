"""The single-launch verify of the port
(`lodestar_tpu_torch.models.batch_verify`): compressed bytes in, ONE
counted dispatch, (verdict, batch_valid) out, held against the JAX
package's `_single_launch_verify` and against the port's own split
schedule, on the CPU (where the body runs eagerly and the five Fp
products take their plain versions; on the card the same body is one
CUDA-graph replay, tested in `tests/test_torch_single_launch_cuda.py`).

Tolerance: none. Both packages get the same numpy inputs (the port's host
byte stage, explicit blinding bits and mask) and must give the same two
bools; the JAX program runs plain on the CPU (`use_pallas()` is false
there). Four batches of 4 sets padded to one size class of 8: valid, two
swapped signatures, a signature on the twist but off the G2 subgroup, and
a pubkey whose x is off the curve. A body error propagates: the split
schedule is never called.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu_torch.crypto.bls import serdes
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import prep as dp

from tests.ops.test_prep import _g1_noncurve_x, _g2_offsubgroup_point
from tests.ops.util import rng

SIZE = 8  # one size class for every batch here


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    """ATen on one thread for this module (as the prep tests): the tensors
    are small, so its worker threads only spin against other processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    bv.configure_single_launch("auto")
    bv.configure_device_prep("auto")


def _batches():
    sets = bv.make_synthetic_sets(5, seed=3)
    valid = sets[:4]
    swapped = list(valid)
    swapped[0] = dataclasses.replace(valid[0], signature=valid[1].signature)
    swapped[1] = dataclasses.replace(valid[1], signature=valid[0].signature)
    r = rng(41)
    off_subgroup = list(valid)
    off_subgroup[2] = dataclasses.replace(
        valid[2], signature=serdes.g2_to_bytes(_g2_offsubgroup_point(r))
    )
    pk = bytearray(_g1_noncurve_x(r).to_bytes(48, "big"))
    pk[0] |= 0x80
    off_curve = list(valid)
    off_curve[1] = dataclasses.replace(valid[1], pubkey=bytes(pk))
    return {"valid": valid, "swapped": swapped, "off_subgroup": off_subgroup,
            "off_curve": off_curve}


@pytest.fixture(scope="module")
def batches():
    return _batches()


def _bits(seed):
    """Blinding bits for 4 sets padded to 8: 1, then nonzero 64-bit
    scalars from a fixed seed (what `_blinding_and_mask` draws from
    os.urandom)."""
    r = np.random.default_rng(seed)
    bits = np.zeros((SIZE, bv.COEFF_BITS), dtype=np.int32)
    bits[0, -1] = 1
    bits[1:4] = r.integers(0, 2, size=(3, bv.COEFF_BITS), dtype=np.int32)
    bits[1:4, 0] = 1
    return bits


@pytest.fixture(scope="module")
def results(batches):
    """Both packages' `_single_launch_verify` on each batch's numpy inputs
    (the port's host byte stage, fixed bits, mask of the 4 real rows)."""
    out = {}
    mask = np.arange(SIZE) < 4
    for i, (name, sets) in enumerate(batches.items()):
        si = bv.prepare_single_launch_inputs(sets, coeff_bits=_bits(i))
        assert si is not None and si.n == 4
        args = (*si.arrays, si.bits, mask)
        assert np.array_equal(si.mask, mask)
        want = tuple(bool(np.asarray(x)) for x in jbv._single_launch_verify(*args))
        got = bv._single_launch_verify(*(torch.as_tensor(np.ascontiguousarray(a)) for a in args))
        out[name] = {"jax": want, "port": got, "inputs": si}
    return out


@pytest.mark.parametrize("case,want", [
    ("valid", (True, True)),
    ("swapped", (False, True)),
    ("off_subgroup", (False, False)),
    ("off_curve", (False, False)),
])
def test_body_matches_jax(case, want, results):
    got = results[case]["port"]
    for t in got:
        assert isinstance(t, torch.Tensor) and t.shape == () and t.dtype == torch.bool
    assert tuple(bool(t) for t in got) == results[case]["jax"] == want


@pytest.mark.parametrize("case", ["valid", "swapped"])
def test_single_equals_split(case, batches, results):
    """The split schedule through `verify_prepared` on `build_device_inputs`'
    tuple (three prep stage calls), with the same bits, gives the single
    launch's verdict."""
    si = results[case]["inputs"]
    base = dp.prep_launches_total()
    staged = bv.build_device_inputs(batches[case], device="cpu", coeff_bits=si.bits, prep="on")
    assert dp.prep_launches_total() - base == dp.FUSED_PREP_LAUNCHES
    split = bv.verify_prepared(staged)
    assert split is bool(results[case]["port"][0]) is (case == "valid")


def test_verify_prepared_single_launch_is_one_dispatch(results):
    """`verify_prepared` on staged SingleLaunchInputs: one counted dispatch,
    the body's verdict."""
    base = dp.prep_launches_total()
    assert bv.verify_prepared(results["valid"]["inputs"], device="cpu") is True
    assert dp.prep_launches_total() - base == dp.SINGLE_LAUNCH_BUDGET == 1


def test_wrong_length_is_false_with_zero_dispatches(batches):
    bad = list(batches["valid"])
    bad[0] = dataclasses.replace(bad[0], pubkey=bad[0].pubkey[:47])
    base = dp.prep_launches_total()
    assert bv.prepare_single_launch_inputs(bad) is None
    assert bv.verify_sets_single_launch(bad, device="cpu") is False
    bv.configure_single_launch("on")
    assert bv.verify_signature_sets_device(bad, device="cpu") is False
    assert bv.verify_sets_single_launch([], device="cpu") is False
    assert dp.prep_launches_total() == base


def test_stagings_draw_fresh_bits(batches):
    a = bv.prepare_single_launch_inputs(batches["valid"])
    b = bv.prepare_single_launch_inputs(batches["valid"])
    for si in (a, b):
        assert si.bits.shape == (SIZE, bv.COEFF_BITS) and si.bits.dtype == np.int32
        assert list(si.bits[0]) == [0] * (bv.COEFF_BITS - 1) + [1]  # coefficient 0 is 1
        assert si.bits[1:4].any(axis=1).all() and not si.bits[4:].any()  # nonzero; padding 0
        assert list(si.mask) == [True] * 4 + [False] * 4
    assert not np.array_equal(a.bits, b.bits)
    for x, y in zip(a.arrays, b.arrays):  # the byte stage itself is deterministic
        assert np.array_equal(x, y)
    with pytest.raises(ValueError):
        bv.prepare_single_launch_inputs(batches["valid"], coeff_bits=np.zeros((4, 64)))


def test_modes():
    assert bv.SINGLE_LAUNCH_MODES == jbv.SINGLE_LAUNCH_MODES
    assert bv.single_launch_active(device="cpu") is False  # "auto": split on the CPU
    assert bv.single_launch_active(device="cuda") is True  # single launch on the card
    assert bv.single_launch_active("auto", "cuda", prep="off") is False
    assert bv.configure_device_prep("off") == "auto"
    assert bv.single_launch_active(device="cuda") is False  # prep pinned off: split
    assert bv.single_launch_active("on", "cuda") is True  # "on" forces
    bv.configure_device_prep("on")
    assert bv.single_launch_active(device="cuda") is True  # prep "on" does not disable it
    assert bv.single_launch_active(device="cpu") is False  # nor force it
    assert bv.configure_single_launch("on") == "auto"
    assert bv.single_launch_active(device="cpu") is True
    assert bv.configure_single_launch("off") == "on"
    assert bv.single_launch_active(device="cuda") is False
    with pytest.raises(ValueError):
        bv.configure_single_launch("bogus")
    with pytest.raises(ValueError):
        bv.single_launch_active("bogus")
    with pytest.raises(ValueError):
        bv.single_launch_active(device="cuda", prep="bogus")


def test_fault_in_the_body_propagates(batches, monkeypatch):
    """No fallback: an error inside the body reaches the caller, the split
    schedule is never called, and the failed dispatch still counted once."""

    def fault(*a, **k):
        raise RuntimeError("injected single-launch fault")

    def split(*a, **k):
        pytest.fail("the split schedule ran after a single-launch fault")

    monkeypatch.setattr(dp, "_prep_field_stage", fault)
    monkeypatch.setattr(bv, "_verify_sets_split", split)
    monkeypatch.setattr(bv, "device_batch_verify", split)
    monkeypatch.setattr(bv, "build_device_inputs", split)
    bv.configure_single_launch("on")
    base = dp.prep_launches_total()
    with pytest.raises(RuntimeError, match="injected single-launch fault"):
        bv.verify_signature_sets_device(batches["valid"], device="cpu")
    with pytest.raises(RuntimeError, match="injected single-launch fault"):
        bv.verify_sets_single_launch(batches["valid"], device="cpu")
    assert dp.prep_launches_total() - base == 2


def test_output_anomaly_raises(batches, monkeypatch):
    monkeypatch.setattr(bv, "_single_launch_verify",
                        lambda *a: (torch.tensor([True]), torch.tensor(True)))
    with pytest.raises(RuntimeError, match="verdict anomaly"):
        bv.verify_sets_single_launch(batches["valid"], device="cpu")
    monkeypatch.setattr(bv, "_single_launch_verify",
                        lambda *a: (torch.tensor(True), torch.tensor(1)))
    with pytest.raises(RuntimeError, match="batch_valid anomaly"):
        bv.verify_sets_single_launch(batches["valid"], device="cpu")


def test_default_route_on_the_cpu_is_split(batches, monkeypatch):
    """"auto" on the CPU keeps the split schedule; "on" routes to single
    launch (both stubbed here: the routing, not the math)."""
    calls = []
    monkeypatch.setattr(bv, "_verify_sets_split", lambda sets, **k: calls.append("split"))
    monkeypatch.setattr(bv, "verify_sets_single_launch", lambda sets, **k: calls.append("single"))
    bv.verify_signature_sets_device(batches["valid"], device="cpu")
    bv.configure_single_launch("on")
    bv.verify_signature_sets_device(batches["valid"], device="cpu")
    bv.verify_signature_sets_device(batches["valid"], device="cpu", prep="off")  # "on" forces
    bv.configure_single_launch("auto")
    bv.configure_device_prep("on")
    bv.verify_signature_sets_device(batches["valid"], device="cpu")
    assert calls == ["split", "single", "single", "split"]
