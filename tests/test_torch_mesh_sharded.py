"""The pool's sharded bulk road (`chain/bls/pool.py` `_pick_placement`,
`_verify_package_sharded`, `_release_unused`; the mesh's `sharded_fn` and
`sharded_breaker`), held against the JAX package's.

Each sharded scenario of `tests/chain/test_mesh_pool.py` runs once through
`lodestar_tpu.chain.bls` over the JAX package's `testing/mesh.FakeLaneRig`
and once through `lodestar_tpu_torch.chain.bls` over the port's copy of it,
with the same jobs: the verdicts, the collective's lane subsets, the
single-lane calls and the counters must be equal, and each run must meet
the original test's assertions. Then one real collective: the port's pool
over two lanes on "cpu" devices with `make_mesh_sharded_fn`, one bulk job of
32 sets through `verify_signature_sets_sharded`. No JAX compile.
"""

from __future__ import annotations

import asyncio
import time
from types import SimpleNamespace

import pytest
import torch

import lodestar_tpu.chain.bls as j_bls
import lodestar_tpu.chain.bls.mesh as j_mesh
import lodestar_tpu.crypto.bls.api as j_api
import lodestar_tpu.scheduler as j_sched
import lodestar_tpu.testing.mesh as j_testing_mesh
import lodestar_tpu_torch.chain.bls as t_bls
import lodestar_tpu_torch.chain.bls.mesh as t_mesh
import lodestar_tpu_torch.crypto.bls.api as t_api
import lodestar_tpu_torch.scheduler as t_sched
import lodestar_tpu_torch.testing.mesh as t_testing_mesh
from lodestar_tpu_torch.models import batch_verify as bv

JAX = SimpleNamespace(name="jax", bls=j_bls, mesh=j_mesh, api=j_api, sched=j_sched,
                      rig=j_testing_mesh.FakeLaneRig)
TORCH = SimpleNamespace(name="torch", bls=t_bls, mesh=t_mesh, api=t_api, sched=t_sched,
                        rig=t_testing_mesh.FakeLaneRig)

COUNTERS = ("jobs_started", "sig_sets_started", "batch_retries", "batch_sigs_success",
            "errors", "sharded_launches", "sharded_fallbacks")


def _run(coro):
    return asyncio.run(coro)


def _sets(P, n: int, tag: int = 0):
    return [
        P.api.SignatureSet(
            pubkey=bytes([1, tag, i % 256]) + bytes(45),
            message=bytes([2, tag, i % 256]) * 8 + bytes(8),
            signature=bytes([3, tag, i % 256]) + bytes(93),
        )
        for i in range(n)
    ]


def _opts(P, name):
    return P.bls.VerifySignatureOpts(priority=getattr(P.sched.PriorityClass, name))


def _counters(pool):
    return {k: pool.metrics[k] for k in COUNTERS}


def s_bulk_shards_across_idle_lanes(P):
    """A big bulk batch goes data-parallel across >=2 idle lanes."""
    rig = P.rig(4)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(_sets(P, 64), _opts(P, "RANGE_SYNC"))
        await pool.close()
        return ok, _counters(pool)

    ok, counters = _run(go())
    assert ok
    assert rig.sharded_calls and len(rig.sharded_calls[0]) >= 2
    assert not rig.calls, "sharded launch should not fall back to single lanes"
    assert [lane.launches for lane in rig.mesh.lanes] == [1, 1, 1, 1]
    return ok, rig.sharded_calls, rig.calls, counters


def s_small_bulk_stays_on_one_lane(P):
    """A bulk batch under 2 * SHARD_MIN_SETS_PER_LANE sets is a plain
    single-lane launch."""
    rig = P.rig(4)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(_sets(P, 8), _opts(P, "BACKFILL"))
        await pool.close()
        return ok, _counters(pool)

    ok, counters = _run(go())
    assert ok and not rig.sharded_calls
    assert len({i for i, _ in rig.calls}) == 1
    return ok, rig.sharded_calls, [n for _, n in rig.calls], counters


def s_sharded_error_degrades(P):
    """A collective failure cannot name the sick lane: the package degrades
    to the single-lane path (verdict unchanged), and SHARD_DISABLE_THRESHOLD
    consecutive failures park the collective while single launches serve.
    The single-lane calls compared are those of the healthy lanes: which
    lane a fallback starts on follows occupancy, and a start on the killed
    lane retries on a sibling."""
    rig = P.rig(4, wedge_threshold=3)
    rig.kill(1)  # poisons any collective that includes lane 1

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        oks = []
        for i in range(4):
            oks.append(await pool.verify_signature_sets(_sets(P, 64, tag=i),
                                                        _opts(P, "RANGE_SYNC")))
        counters = _counters(pool)
        await pool.close()
        return oks, counters

    oks, counters = _run(go())
    assert oks == [True] * 4
    assert counters["sharded_fallbacks"] >= 1
    assert rig.sharded_calls and rig.calls
    assert rig.mesh.sharded_breaker.is_open or len(rig.sharded_calls) < 4
    healthy = sorted(n for i, n in rig.calls if i != 1)
    return (oks, rig.sharded_calls, healthy, rig.mesh.sharded_breaker.is_open,
            counters["sharded_fallbacks"], counters["sharded_launches"],
            counters["jobs_started"], counters["sig_sets_started"])


def s_invalid_sharded_verdict_retries_per_job(P):
    """ok=False from the collective takes the batch-retry road: the package
    re-verifies on one lane, where per-job verdicts are final, and the
    unused lanes go back early with the accounting balanced."""
    rig = P.rig(4)
    record = rig.mesh.sharded_fn

    def lying_collective(sets, device_indices):
        record(sets, device_indices)
        return False

    rig.mesh.sharded_fn = lying_collective

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(_sets(P, 64), _opts(P, "RANGE_SYNC"))
        await pool.close()
        return ok, _counters(pool)

    ok, counters = _run(go())
    assert ok
    assert rig.sharded_calls and rig.calls
    inflight = [lane.inflight for lane in rig.mesh.lanes]
    assert inflight == [0, 0, 0, 0]
    return ok, rig.sharded_calls, [n for _, n in rig.calls], inflight, counters


def s_sharded_subset_is_index_ordered(P):
    """The subset is chosen by occupancy and handed over in index order."""
    rig = P.rig(4)
    pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
    for lane, busy_s in zip(rig.mesh.lanes, (0.04, 0.02, 0.08, 0.0)):
        if busy_s:
            lane.occupancy.begin()
            time.sleep(busy_s)
            lane.occupancy.end()
    package = [SimpleNamespace(sets=_sets(P, 48))]
    mode, lanes = pool._pick_placement(getattr(P.sched.PriorityClass, "RANGE_SYNC"), package,
                                       pool._free_lanes())
    idx = [lane.index for lane in lanes]
    assert mode == "sharded" and idx == sorted(idx) and 2 not in idx
    return mode, idx


def s_pipelined_bulk_shards_with_inline_prep(P):
    """In the pipelined pool a bulk package is not staged: it shards with
    the raw sets, and the prepared seam is never called."""
    rig = P.rig(2, with_prepared=True)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=rig.prep_fn)
        ok = await pool.verify_signature_sets(_sets(P, 64), _opts(P, "RANGE_SYNC"))
        await pool.close()
        return ok, _counters(pool), pool.pipeline_stats()["staged_packages"]

    ok, counters, staged = _run(go())
    assert ok and rig.sharded_calls == [(0, 1)] and not rig.prepared_calls and staged == 0
    return ok, rig.sharded_calls, rig.calls, counters, staged


SCENARIOS = [
    s_bulk_shards_across_idle_lanes,
    s_small_bulk_stays_on_one_lane,
    s_sharded_error_degrades,
    s_invalid_sharded_verdict_retries_per_job,
    s_sharded_subset_is_index_ordered,
    s_pipelined_bulk_shards_with_inline_prep,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_sharded_scenario_matches_the_jax_package(scenario):
    assert scenario(TORCH) == scenario(JAX)


def test_shard_constants_are_the_jax_packages():
    names = ("SHARD_MIN_SETS_PER_LANE", "SHARD_DISABLE_THRESHOLD")
    assert {n: getattr(t_mesh, n) for n in names} == {n: getattr(j_mesh, n) for n in names}


def test_sharded_breaker_gates_the_collective():
    """`sharding_available` needs a collective and a closed sharded breaker,
    which opens after SHARD_DISABLE_THRESHOLD failures, as in the JAX
    package; a mesh without a collective never shards."""
    for P in (TORCH, JAX):
        rig = P.rig(2)
        assert rig.mesh.sharding_available()
        for _ in range(P.mesh.SHARD_DISABLE_THRESHOLD):
            rig.mesh.sharded_breaker.record_failure()
        assert not rig.mesh.sharding_available()
        assert not P.rig(2, with_sharded=False).mesh.sharding_available()
        assert P.mesh.single_lane_mesh(lambda sets: True).sharded_fn is None


def test_build_device_mesh_attaches_no_collective(monkeypatch):
    """Unlike the JAX package's, the port's `build_device_mesh` gives a
    multi-GPU host one lane per GPU and no sharded collective, so the pool
    built on it never shards (a collective is the caller's choice, with its
    graphs warmed by `warm_sharded`)."""
    monkeypatch.setattr(bv, "mesh_device_count", lambda: 2)
    monkeypatch.setattr(t_mesh, "_model_lane",
                        lambda i, device, wedge: t_mesh.MeshLane(i, lambda sets: True,
                                                                 device=torch.device("cpu")))
    for mode in ("auto", "on"):
        mesh = t_mesh.build_device_mesh(mode)
        assert [lane.index for lane in mesh.lanes] == [0, 1]
        assert mesh.sharded_fn is None and not mesh.sharding_available()


@pytest.fixture
def _one_aten_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_real_collective_over_two_cpu_lanes(_one_aten_thread):
    """The port's pool over two lanes on "cpu" devices with the real
    collective (`make_mesh_sharded_fn(devices=["cpu", "cpu"])`): one bulk job
    of 32 real sets shards over both lanes (two shards of 16 and the finish)
    and comes back True, with one sharded launch and no fallback."""
    lanes = [t_mesh.MeshLane(i, bv.make_lane_verify_fn(i, "cpu"), device=torch.device("cpu"))
             for i in range(2)]
    mesh = t_mesh.VerifierMesh(lanes, sharded_fn=bv.make_mesh_sharded_fn(devices=["cpu", "cpu"]))
    sets = bv.make_synthetic_sets(32, seed=5)

    async def go():
        pool = t_bls.BlsDeviceVerifierPool(mesh=mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(sets, _opts(TORCH, "RANGE_SYNC"))
        await pool.close()
        return ok, dict(pool.metrics)

    ok, metrics = _run(go())
    assert ok is True
    assert metrics["sharded_launches"] == 1 and metrics["sharded_fallbacks"] == 0
    assert metrics["batch_retries"] == 0 and [lane.launches for lane in lanes] == [1, 1]
    assert not mesh.sharded_breaker.is_open
