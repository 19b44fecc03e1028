"""Serving through the port's own verifier pool on the CPU: the lane entry
points of `lodestar_tpu_torch.models.batch_verify`, the pool and mesh
over a real CPU lane, the prep records, and the faults repaired for
serving from several threads.

Real batches of 4 sets (one size class of 8) run the plain path on one
ATen thread; tolerance: none (equal bools and equal records). Held
against the JAX package: the per-job verdicts of its pool on the same
jobs, and its prep records {layer, sets, rejected} on the same batches
(its host byte stage and its host prep: no JAX compile for those). A set
whose fields cannot be read as bytes is a structural reject in the port
(False, zero dispatches, no breaker failure); the JAX pool rejects such a
job with the parse error instead, and charges its lane's breaker: the
port's verdict is not the JAX pool's there, and both refuse the job.
"""

from __future__ import annotations

import asyncio
import dataclasses
import sys
import threading

import pytest
import torch

import lodestar_tpu.chain.bls as j_bls
import lodestar_tpu.crypto.bls.api as j_api
from lodestar_tpu.models import batch_verify as jbv
from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, VerifySignatureOpts
from lodestar_tpu_torch.chain.bls import mesh as t_mesh
from lodestar_tpu_torch.chain.bls.pool import (
    MAX_PACKAGE_SETS,
    MAX_SIGNATURE_SETS_PER_JOB,
    POOL_SIZE_CLASSES,
)
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.ops import fp_cuda
from lodestar_tpu_torch.ops import prep as dp

from tests.ops.test_prep import _g1_noncurve_x
from tests.ops.util import rng


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    bv.configure_single_launch("auto")
    bv.configure_device_prep("auto")


class _Unreadable:
    def __bytes__(self):
        raise RuntimeError("unreadable field")


def _batches():
    valid = bv.make_synthetic_sets(4, seed=5)
    swapped = list(valid)
    swapped[0] = dataclasses.replace(valid[0], signature=valid[1].signature)
    swapped[1] = dataclasses.replace(valid[1], signature=valid[0].signature)
    pk = bytearray(_g1_noncurve_x(rng(43)).to_bytes(48, "big"))
    pk[0] |= 0x80
    off_curve = list(valid)
    off_curve[1] = dataclasses.replace(valid[1], pubkey=bytes(pk))
    short = list(valid)
    short[3] = dataclasses.replace(valid[3], signature=valid[3].signature[:95])
    return {"valid": valid, "swapped": swapped, "off_curve": off_curve, "short": short}


#: fields that cannot be read as bytes: each makes its batch a structural reject
UNREADABLE = {
    "pubkey_none": {"pubkey": None},
    "signature_str": {"signature": "s" * 96},
    "message_out_of_range": {"message": [256] * 32},
    "pubkey_raises": {"pubkey": _Unreadable()},
}


@pytest.fixture(scope="module")
def batches():
    return _batches()


def _jax_sets(sets):
    return [j_api.SignatureSet(pubkey=s.pubkey, message=s.message, signature=s.signature)
            for s in sets]


# --- the lane entry points ----------------------------------------------------------


@pytest.mark.parametrize("case,want", [("valid", True), ("swapped", False)])
def test_lane_factories_match_the_entry_point(case, want, batches):
    sets = batches[case]
    assert bv.verify_signature_sets_device(sets, device="cpu") is want
    assert bv.make_lane_verify_fn(0, "cpu")(sets) is want
    staged = bv.prepare_inputs_for_lane(sets, 0, device="cpu")  # the split schedule's tuple
    assert bv.make_lane_verify_prepared_fn(0, "cpu")(staged) is want
    # with the single-launch path on, the lane's one callable takes it: the
    # body, run eagerly
    bv.configure_single_launch("on")
    base = dp.prep_launches_total()
    assert bv.make_lane_verify_fn(0, "cpu")(sets) is want
    assert dp.prep_launches_total() - base == dp.SINGLE_LAUNCH_BUDGET


def test_lane_factories_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (bv.make_lane_verify_fn, bv.make_lane_verify_prepared_fn):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bv.warm_single_launch(POOL_SIZE_CLASSES)
    with pytest.raises(ValueError, match="CUDA graphs"):
        bv.warm_single_launch(POOL_SIZE_CLASSES, device="cpu")
    assert bv.mesh_device_count() == 0


def test_pool_size_classes_cover_every_package():
    """Every launch unit a scheduled package can form lands in a warmed
    class: a package drains jobs of at most MAX_SIGNATURE_SETS_PER_JOB sets
    while it holds fewer than MAX_PACKAGE_SETS."""
    reachable = set()
    for last in range(1, MAX_SIGNATURE_SETS_PER_JOB + 1):
        for before in range(0, MAX_PACKAGE_SETS):
            reachable.add(dp.pad_pow2(before + last))
    assert set(POOL_SIZE_CLASSES) == reachable
    assert POOL_SIZE_CLASSES == (8, 16, 32, 64, 128, 256, 512, 1024)


# --- prep records ---------------------------------------------------------------------


def _record():
    info = bv.consume_prep_info()
    return None if info is None else (info["layer"], info["sets"], info["rejected"])


def _jax_record():
    info = jbv.consume_prep_info()
    return None if info is None else (info["layer"], info["sets"], info["rejected"])


@pytest.mark.parametrize("case", ["valid", "swapped", "off_curve", "short"])
def test_prep_records_match_the_jax_package(case, batches):
    sets = batches[case]
    bv.consume_prep_info(), jbv.consume_prep_info()
    before = bv.prep_counts()
    got = [(bv.prepare_single_launch_inputs(sets) is None), _record()]
    want = [(jbv.prepare_single_launch_inputs(_jax_sets(sets)) is None), _jax_record()]
    got += [(bv.build_device_inputs(sets, device="cpu", prep="off") is None), _record()]
    want += [(jbv.build_device_inputs(_jax_sets(sets), prep="off") is None), _jax_record()]
    assert got == want
    after = bv.prep_counts()
    assert after["sets"]["single_launch"] - before["sets"]["single_launch"] == len(sets)
    assert after["sets"]["host"] - before["sets"]["host"] == len(sets)
    rejected = sum(r[2] for r in (got[1], got[3]))
    assert after["rejected"] - before["rejected"] == rejected
    assert bv.consume_prep_info() is None  # popped


def test_batch_valid_false_counts_as_rejected(batches, monkeypatch):
    """The device's batch_valid veto counts as a rejected batch (the
    single-launch dispatch stubbed to give it)."""
    si = bv.prepare_single_launch_inputs(batches["valid"])
    for batch_valid, counted in ((False, 1), (True, 0)):
        monkeypatch.setattr(dp, "_dispatch", lambda *a, bv_=batch_valid: (
            torch.tensor(False), torch.tensor(bv_)))
        before = bv.prep_counts()["rejected"]
        assert bv.verify_prepared(si, device="cpu") is False
        assert bv.prep_counts()["rejected"] - before == counted


# --- host-parse errors: a structural reject, not a lane fault --------------------------


@pytest.mark.parametrize("field", sorted(UNREADABLE))
@pytest.mark.parametrize("single", ["on", "off"])
def test_unreadable_field_is_false_with_no_breaker_failure(field, single, batches):
    bad = list(batches["valid"])
    bad[2] = dataclasses.replace(bad[2], **UNREADABLE[field])
    bv.configure_single_launch(single)
    mesh = t_mesh.build_device_mesh("off", device="cpu")
    lane = mesh.lanes[0]
    base = dp.prep_launches_total()
    bv.consume_prep_info()
    ok, served = t_mesh.mesh_launch(mesh, bad)
    assert ok is False and served is lane
    assert dp.prep_launches_total() == base  # zero dispatches
    assert lane.breaker.state().name == "CLOSED" and lane.breaker._failures == 0
    layer = "single_launch" if single == "on" else "host"
    assert _record() == (layer, 4, True)
    # the JAX package raises on the same batch (its host prep cannot read it)
    with pytest.raises(Exception):
        jbv.prepare_sets(_jax_sets(bad))


def test_unreadable_field_through_the_pool(batches):
    """One valid job and one unreadable job batched together: the port's
    pool gives [True, False] with no lane failure; the JAX pool refuses the
    unreadable job with its parse error (and resolves the valid one True)."""
    good = batches["valid"][:1]
    bad = [dataclasses.replace(batches["valid"][1], pubkey=None)]

    async def go(pool, jobs):
        opts = (VerifySignatureOpts if pool.__module__.startswith("lodestar_tpu_torch")
                else j_bls.VerifySignatureOpts)(batchable=True)
        out = await asyncio.gather(*(pool.verify_signature_sets(s, opts) for s in jobs),
                                   return_exceptions=True)
        await pool.close()
        return out

    port = BlsDeviceVerifierPool(device="cpu")
    got = asyncio.run(go(port, [good, bad]))
    assert got == [True, False]
    assert port.device_breaker._failures == 0
    jax_pool = j_bls.BlsDeviceVerifierPool()
    want = asyncio.run(go(jax_pool, [_jax_sets(good), _jax_sets(bad)]))
    assert want[0] is True and isinstance(want[1], TypeError)


# --- the pool on one real CPU lane against the JAX pool ---------------------------------


def test_pool_on_a_cpu_lane_matches_the_jax_pool(batches):
    """2 batchable jobs of 4 sets, the second with two swapped signatures:
    one merged batch (False), then a retry per job."""
    jobs = [batches["valid"], batches["swapped"]]

    async def go(pool, opts, jobs):
        out = await asyncio.gather(*(pool.verify_signature_sets(s, opts) for s in jobs))
        metrics = dict(pool.metrics)
        await pool.close()
        return list(out), metrics

    port = BlsDeviceVerifierPool(device="cpu")
    assert len(port.mesh) == 1 and port.mesh.lanes[0].device == torch.device("cpu")
    got, got_m = asyncio.run(go(port, VerifySignatureOpts(batchable=True), jobs))
    want, want_m = asyncio.run(go(j_bls.BlsDeviceVerifierPool(),
                                  j_bls.VerifySignatureOpts(batchable=True),
                                  [_jax_sets(s) for s in jobs]))
    assert got == want == [True, False]
    assert got_m == {k: want_m[k] for k in got_m}
    assert got_m["batch_retries"] == 1 and port.mesh.lanes[0].launches == 3


# --- no fallback ----------------------------------------------------------------------


def test_build_device_mesh_never_lands_on_the_oracle(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def blocked(name, *a, **kw):
        if name.endswith("batch_verify") or "models" in name.split("."):
            raise ImportError("no device model")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", blocked)
    with pytest.raises(ImportError):
        t_mesh.build_device_mesh("auto", device="cpu")


def test_a_body_error_raises_through_mesh_launch(batches, monkeypatch):
    """A single-launch body (on the card: capture or replay) error is the
    device's: it raises through `mesh_launch` and charges the lane's
    breaker; it never becomes a verdict."""
    def boom(*args):
        raise RuntimeError("replay failed")

    monkeypatch.setattr(bv, "_single_launch_verify", boom)
    bv.configure_single_launch("on")
    mesh = t_mesh.build_device_mesh("off", device="cpu")
    with pytest.raises(RuntimeError, match="replay failed"):
        t_mesh.mesh_launch(mesh, batches["valid"])
    assert mesh.lanes[0].breaker._failures == 1


# --- counts from several threads --------------------------------------------------------


def test_counts_from_several_threads_are_exact():
    """Stub launches from 8 threads (with a tiny switch interval, so the
    threads interleave inside the bookkeeping): the process-wide Fp counts
    and the prep stage count are the sum of the threads' launches, and
    each thread's tally holds its own launches only."""
    n_threads, per = 8, 400
    tallies = [None] * n_threads
    prev_switch = sys.getswitchinterval()
    fp_cuda.reset_launches()
    base = dp.prep_launches_total()
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        with fp_cuda.tally() as t:
            for j in range(per):
                fp_cuda._count("mont_mul", 8 + i)
                fp_cuda._count("redc", 16)
                dp._dispatch(lambda: None)
        tallies[i] = t

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(prev_switch)
    assert fp_cuda.LAUNCHES["mont_mul"] == fp_cuda.LAUNCHES["redc"] == n_threads * per
    assert fp_cuda.ROWS["mont_mul"] == {8 + i: per for i in range(n_threads)}
    assert fp_cuda.ROWS["redc"] == {16: n_threads * per}
    assert dp.prep_launches_total() - base == n_threads * per
    for i, t in enumerate(tallies):
        assert t["mont_mul"] == {8 + i: per} and t["redc"] == {16: per}
        assert not any(t[k] for k in ("mul_acc", "sq_acc", "mont_sq"))
    fp_cuda.reset_launches()


@pytest.mark.slow
def test_pool_rows_are_the_bodys_row_counts():
    """`chip_smoke.POOL_ROWS` is the union of the row counts the
    single-launch body launches the kernels at over `POOL_SIZE_CLASSES`,
    counted on meta tensors (about a minute per class here)."""
    import chip_smoke

    seen = set()
    for size in POOL_SIZE_CLASSES:
        rows = chip_smoke.rows_on_meta(size)
        assert all(rows[k] for k in fp_cuda.KERNELS)
        seen |= {n for r in rows.values() for n in r}
    assert seen == set(chip_smoke.POOL_ROWS)
    assert set(chip_smoke.POOL_ROWS) <= set(chip_smoke.N_KERNEL_CHECK)
