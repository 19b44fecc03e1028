"""Device input prep through the port's model layer
(`lodestar_tpu_torch.models.batch_verify`): compressed bytes in, verdict
out, held against `lodestar_tpu.models.batch_verify` and the pure-Python
oracle, on the CPU (device prep forced on with `prep="on"`).

Tolerance: none. The prepped arrays equal the oracle's prep on canonical
values and the JAX package's `prepare_sets_device` limb for limb;
verdicts equal the JAX package's with the same blinding bits. Structural
garbage, wrong-length encodings and the infinity pubkey reject the batch.
A device-prep error propagates: nothing falls back to the oracle. Batches
of 4 sets padded to 8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu_torch.crypto.bls import serdes
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import fp
from lodestar_tpu_torch.ops import prep as dp


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


@pytest.fixture(scope="module")
def sets5():
    return bv.make_synthetic_sets(5, seed=3)


@pytest.fixture(scope="module")
def sets4(sets5):
    return sets5[:4]


@pytest.fixture(autouse=True)
def _restore_prep_mode():
    yield
    bv.configure_device_prep("auto")


@pytest.fixture(scope="module")
def jax_side(sets4, sets5):
    """The JAX package's device prep of the 4 sets, the oracle's prep of
    them (the JAX package's host road), and the JAX verdicts on the valid
    and the tampered batch with fixed blinding bits, computed once."""
    tampered = list(sets4)
    tampered[2] = dataclasses.replace(tampered[2], signature=sets5[4].signature)
    verdicts, oracle = {}, None
    for name, batch in (("valid", sets4), ("tampered", tampered)):
        pk, h, sig, bits, mask = jbv.build_device_inputs(batch, size=8, prep="off")
        verdicts[name] = (
            batch,
            bits,
            bool(np.asarray(jbv.device_batch_verify(pk, h, sig, bits, mask))),
        )
        if oracle is None:  # the oracle's prep of the 4 valid sets (padded to 8)
            oracle = tuple(tuple(np.asarray(c)[:4] for c in pt) for pt in (pk, h, sig))
    prepped = jbv.prepare_sets_device(sets4)
    return {
        "prepped": tuple(tuple(np.asarray(c) for c in pt) for pt in prepped),
        "oracle": oracle,
        "verdicts": verdicts,
    }


def canonical(a):
    return fp.from_mont(torch.as_tensor(np.asarray(a))).numpy()


def test_prepare_sets_device_matches_the_oracle_and_jax(sets4, jax_side):
    got = bv.prepare_sets_device(sets4, device="cpu")
    assert got is not None
    for g_pt, o_pt, j_pt in zip(got, jax_side["oracle"], jax_side["prepped"]):
        for g, o, j in zip(g_pt, o_pt, j_pt):
            assert g.dtype == torch.int32 and g.shape == j.shape
            assert np.array_equal(g.numpy(), j)  # limb for limb with the JAX package
            assert np.array_equal(canonical(g), canonical(o))  # values of the oracle


def test_rejects_structural_garbage(sets4):
    bad = list(sets4)
    bad[1] = dataclasses.replace(bad[1], signature=b"\x00" * 96)
    assert bv.prepare_sets_device(bad, device="cpu") is None


def test_rejects_wrong_length_encoding(sets4):
    bad = list(sets4)
    bad[0] = dataclasses.replace(bad[0], signature=b"\x00" * 95)
    base = dp.prep_launches_total()
    assert bv.prepare_sets_device(bad, device="cpu") is None
    assert bv.build_device_inputs(bad, device="cpu", prep="on") is None
    assert dp.prep_launches_total() == base  # a host reject: no stage ran


def test_rejects_infinity_pubkey(sets4):
    bad = list(sets4)
    bad[0] = dataclasses.replace(bad[0], pubkey=serdes.g1_to_bytes(None))
    assert bv.prepare_sets_device(bad, device="cpu") is None


@pytest.mark.parametrize("case", ["valid", "tampered"])
def test_bytes_in_verdict_out_matches_jax(case, jax_side, monkeypatch):
    """Device prep then the verify core, with the JAX side's blinding bits;
    the oracle's decoders and hash are stubbed to raise, so no set takes
    the host road."""
    batch, bits, want = jax_side["verdicts"][case]

    def boom(*a, **k):
        raise AssertionError("the oracle prep ran on the device-prep path")

    for name in ("hash_to_g2", "g1_from_bytes", "g2_from_bytes", "prepare_sets"):
        monkeypatch.setattr(bv, name, boom)
    base = dp.prep_launches_total()
    inputs = bv.build_device_inputs(batch, device="cpu", coeff_bits=bits, prep="on")
    assert dp.prep_launches_total() - base == dp.FUSED_PREP_LAUNCHES
    np.testing.assert_array_equal(inputs[3].numpy(), bits)
    got = bool(bv.device_batch_verify(*inputs))
    assert got is want is (case == "valid")


def test_device_prep_error_propagates(sets4, monkeypatch):
    """No fallback: a device-prep error reaches the caller and the oracle
    prep is never called."""
    oracle_calls = []

    def fault(*a, **k):
        raise RuntimeError("injected device prep fault")

    monkeypatch.setattr(dp, "_prep_field_stage", fault)
    monkeypatch.setattr(bv, "prepare_sets", lambda sets: oracle_calls.append(sets))
    with pytest.raises(RuntimeError, match="injected device prep fault"):
        bv.build_device_inputs(sets4, device="cpu", prep="on")
    bv.configure_device_prep("on")
    with pytest.raises(RuntimeError, match="injected device prep fault"):
        bv.verify_signature_sets_device(sets4, device="cpu")
    assert oracle_calls == []


def test_prep_modes():
    assert bv.PREP_MODES == jbv.PREP_MODES
    assert bv.device_prep_active("auto", "cuda") is True  # the card's default
    assert bv.device_prep_active("auto", "cpu") is False
    assert bv.device_prep_active("on", "cpu") is True
    assert bv.device_prep_active("off", "cuda") is False
    assert bv.configure_device_prep("off") == "auto"
    assert bv.device_prep_active(device="cuda") is False  # the process-wide mode
    assert bv.configure_device_prep("on") == "off"
    assert bv.device_prep_active(device="cpu") is True
    with pytest.raises(ValueError):
        bv.configure_device_prep("bogus")
    with pytest.raises(ValueError):
        bv.build_device_inputs(bv.make_synthetic_sets(1), device="cpu", prep="bogus")


def test_oracle_prep_stays_behind_prep_off(sets4, monkeypatch):
    """prep="off" takes the oracle road and no prep stage runs."""
    monkeypatch.setattr(dp, "_dispatch", lambda *a, **k: pytest.fail("a prep stage ran"))
    inputs = bv.build_device_inputs(sets4, device="cpu", prep="off")
    want = bv.prepare_sets(sets4)
    for got_pt, want_pt in zip(inputs[:3], want):
        for g, w in zip(got_pt, want_pt):
            np.testing.assert_array_equal(g.numpy()[:4], w)
