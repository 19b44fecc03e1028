"""The port's verifier pool, lane mesh and their stdlib-only support
modules, held against the JAX package's originals.

Every pool scenario of `tests/chain/test_bls_pool.py`,
`tests/chain/test_mesh_pool.py` (less its cases on the virtual JAX device
mesh, the CPU-oracle drop and the sharded bulk road, which
`tests/test_torch_mesh_sharded.py` holds: its bulk cases here run on a
mesh without a collective) and
`tests/chain/test_pipeline.py` (less the Prometheus gauges and the CLI
wiring the port does not copy) runs once through
`lodestar_tpu.chain.bls` and once through `lodestar_tpu_torch.chain.bls`,
on the same scripted mock backends with the same jobs: the per-job
verdicts, the backend call sizes (in order where one lane serialises
them) and the counters must be equal, and each run must meet the
original test's assertions. Then the copied scheduler, SLO accountant,
tracer and circuit breaker against their originals on the same inputs,
on a fake clock. No device work: nothing here touches JAX's compiler or a
kernel.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from types import SimpleNamespace

import pytest

import lodestar_tpu.chain.bls as j_bls
import lodestar_tpu.chain.bls.mesh as j_mesh
import lodestar_tpu.chain.bls.pool as j_pool
import lodestar_tpu.crypto.bls.api as j_api
import lodestar_tpu.offload.resilience as j_res
import lodestar_tpu.scheduler as j_sched
import lodestar_tpu.slo as j_slo
import lodestar_tpu.tracing as j_tracing
import lodestar_tpu.utils as j_utils
import lodestar_tpu_torch.chain.bls as t_bls
import lodestar_tpu_torch.chain.bls.mesh as t_mesh
import lodestar_tpu_torch.chain.bls.pool as t_pool
import lodestar_tpu_torch.crypto.bls.api as t_api
import lodestar_tpu_torch.offload.resilience as t_res
import lodestar_tpu_torch.scheduler as t_sched
import lodestar_tpu_torch.slo as t_slo
import lodestar_tpu_torch.tracing as t_tracing
import lodestar_tpu_torch.utils as t_utils

JAX = SimpleNamespace(name="jax", bls=j_bls, mesh=j_mesh, pool=j_pool, api=j_api,
                      sched=j_sched)
TORCH = SimpleNamespace(name="torch", bls=t_bls, mesh=t_mesh, pool=t_pool, api=t_api,
                        sched=t_sched)


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


def _bad(P, sets):
    s = sets[0]
    sets[0] = P.api.SignatureSet(pubkey=b"\xbb" + s.pubkey[1:], message=s.message,
                                 signature=s.signature)
    return sets


def _opts(P, **kw):
    return P.bls.VerifySignatureOpts(**kw)


def _prio(P, name):
    return getattr(P.sched.PriorityClass, name)


class Backend:
    """Scripted verify_fn: records call sizes; a set whose pubkey starts
    0xBB is invalid; the `raise_on`-th call raises."""

    def __init__(self, raise_on: int | None = None):
        self.calls: list[int] = []
        self.raise_on = raise_on

    def __call__(self, sets):
        self.calls.append(len(sets))
        if self.raise_on is not None and len(self.calls) == self.raise_on:
            raise RuntimeError("device exploded")
        return not any(s.pubkey[0] == 0xBB for s in sets)


class Rig:
    """N-lane mesh of package `P` over recording fake backends (the JAX
    package's `testing/mesh.FakeLaneRig`, built on either package's
    `MeshLane` / `VerifierMesh`)."""

    def __init__(self, P, n_lanes, *, call_s=0.0, wedge_threshold=2, verdict_fn=None,
                 with_prepared=False):
        self.call_s = call_s
        self.verdict_fn = verdict_fn or (lambda sets: True)
        self._lock = threading.Lock()
        self.calls, self.prepared_calls = [], []
        self.failing: set[int] = set()
        lanes = [
            P.mesh.MeshLane(i, self._lane_fn(i), wedge_threshold=wedge_threshold,
                            verify_prepared_fn=self._prepared_fn(i) if with_prepared else None)
            for i in range(n_lanes)
        ]
        self.mesh = P.mesh.VerifierMesh(lanes)

    @staticmethod
    def prep_fn(sets, lane_hint):
        return ("prepped", list(sets), lane_hint)

    def _lane_fn(self, index):
        def lane_fn(sets):
            if self.call_s:
                time.sleep(self.call_s)
            with self._lock:
                failing = index in self.failing
                self.calls.append((index, len(sets)))
            if failing:
                raise RuntimeError(f"injected device error on dev{index}")
            return self.verdict_fn(sets)

        return lane_fn

    def _prepared_fn(self, index):
        def lane_prepared_fn(inputs):
            tag, sets, _hint = inputs
            assert tag == "prepped"
            if self.call_s:
                time.sleep(self.call_s)
            with self._lock:
                failing = index in self.failing
                self.calls.append((index, len(sets)))
                self.prepared_calls.append((index, len(sets)))
            if failing:
                raise RuntimeError(f"injected device error on dev{index}")
            return self.verdict_fn(sets)

        return lane_prepared_fn

    def kill(self, index):
        with self._lock:
            self.failing.add(index)

    def served_by(self, index):
        with self._lock:
            return sum(1 for i, _ in self.calls if i == index)


def _placed(P, pool, cls, n_sets):
    """Index of the lane `pool` places a package of `n_sets` sets of class
    `cls` on. Both pools' placement also names a mode; the sharded road
    is never taken on a mesh without a collective."""
    free = pool._free_lanes()
    mode, lanes = pool._pick_placement(_prio(P, cls), [SimpleNamespace(sets=_sets(P, n_sets))],
                                       free)
    assert mode == "single" and len(lanes) == 1
    return lanes[0].index


def _busy(lane, seconds):
    lane.occupancy.begin()
    time.sleep(seconds)
    lane.occupancy.end()


# --- scenarios of tests/chain/test_bls_pool.py ------------------------------------
# Each takes a package namespace, asserts what the original test asserts, and
# returns the deterministic facts the two packages must agree on.


def s_chunkify(P):
    f = P.pool.chunkify_maximize_chunk_size
    out = [f([], 128), f(list(range(5)), 2),
           [len(c) for c in f(list(range(300)), P.pool.MAX_SIGNATURE_SETS_PER_JOB)]]
    assert out == [[], [[0, 1], [2, 3], [4]], [100, 100, 100]]
    return out


def s_valid_batchable_together(P):
    async def go():
        be = Backend()
        pool = P.bls.BlsDeviceVerifierPool(be, buffer_wait_ms=5)
        opts = _opts(P, batchable=True)
        r = await asyncio.gather(pool.verify_signature_sets(_sets(P, 3, 1), opts),
                                 pool.verify_signature_sets(_sets(P, 4, 2), opts))
        await pool.close()
        return list(r), be.calls, pool.metrics["batch_sigs_success"]

    out = _run(go())
    assert out == ([True, True], [7], 7)
    return out


def s_invalid_batch_retries(P):
    async def go():
        be = Backend()
        pool = P.bls.BlsDeviceVerifierPool(be, buffer_wait_ms=5)
        opts = _opts(P, batchable=True)
        r = await asyncio.gather(pool.verify_signature_sets(_sets(P, 3, 1), opts),
                                 pool.verify_signature_sets(_bad(P, _sets(P, 2, 2)), opts))
        await pool.close()
        return list(r), be.calls[0], sorted(be.calls[1:]), pool.metrics["batch_retries"]

    out = _run(go())
    assert out == ([True, False], 5, [2, 3], 1)
    return out


def s_buffer_flushes_on_sig_count(P):
    async def go():
        be = Backend()
        pool = P.bls.BlsDeviceVerifierPool(be, buffer_wait_ms=60_000)
        ok = await asyncio.wait_for(
            pool.verify_signature_sets(_sets(P, 33), _opts(P, batchable=True)), 5)
        await pool.close()
        return ok, be.calls

    out = _run(go())
    assert out[0] is True
    return out


def s_large_array_chunks(P):
    async def go():
        be = Backend()
        pool = P.bls.BlsDeviceVerifierPool(be)
        ok = await pool.verify_signature_sets(_sets(P, 300))
        await pool.close()
        return ok, be.calls

    out = _run(go())
    assert out == (True, [100, 100, 100])
    return out


def s_device_error_fails_closed(P):
    async def go():
        pool = P.bls.BlsDeviceVerifierPool(Backend(raise_on=1))
        with pytest.raises(RuntimeError, match="device exploded"):
            await pool.verify_signature_sets(_sets(P, 4))
        await pool.close()
        return pool.metrics["errors"], pool.device_breaker.state().name

    return _run(go())


def s_batchable_error_retries_then_fails_closed(P):
    calls = []

    def always_raise(sets):
        calls.append(len(sets))
        raise RuntimeError("bad transport")

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(always_raise, buffer_wait_ms=5)
        with pytest.raises(RuntimeError):
            await pool.verify_signature_sets(_sets(P, 2), _opts(P, batchable=True))
        await pool.close()
        return pool.metrics["batch_retries"], calls

    out = _run(go())
    assert out[0] == 1
    return out


def s_can_accept_work_bounds_queue(P):
    async def go():
        pool = P.bls.BlsDeviceVerifierPool(lambda sets: True)
        seen = [pool.can_accept_work()]
        pool._outstanding = P.pool.MAX_JOBS_CAN_ACCEPT_WORK
        seen.append(pool.can_accept_work())
        pool._outstanding = 0
        await pool.close()
        seen.append(pool.can_accept_work())
        return seen

    out = _run(go())
    assert out == [True, False, False]
    return out


def s_close_rejects_pending(P):
    async def go():
        pool = P.bls.BlsDeviceVerifierPool(Backend(), buffer_wait_ms=60_000)
        task = asyncio.ensure_future(
            pool.verify_signature_sets(_sets(P, 1), _opts(P, batchable=True)))
        await asyncio.sleep(0.01)
        await pool.close()
        with pytest.raises(asyncio.CancelledError):
            await task
        return "cancelled"

    return _run(go())


def s_single_thread_verifier_and_mock(P):
    async def go():
        sk = P.api.SecretKey(7777)
        msg = b"\x11" * 32
        real = [P.api.SignatureSet(pubkey=sk.to_pubkey(), message=msg,
                                   signature=P.api.sign(sk, msg))]
        st = P.bls.BlsSingleThreadVerifier()
        ok = await st.verify_signature_sets(real)
        mock = P.bls.BlsVerifierMock(False)
        mocked = await mock.verify_signature_sets(real)
        await st.close()
        return ok, mocked, mock.calls, st.can_accept_work()

    out = _run(go())
    assert out == (True, False, [1], False)
    return out


# --- scenarios of tests/chain/test_mesh_pool.py ------------------------------------


def s_single_lane_serialized(P):
    windows = []

    def backend(sets):
        t0 = time.monotonic()
        time.sleep(0.01)
        windows.append((t0, time.monotonic(), sets[0].pubkey[1]))
        return True

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(backend, scheduler_enabled=True)
        assert len(pool.mesh) == 1
        ok = await asyncio.gather(*(
            pool.verify_signature_sets(_sets(P, 1, tag=i),
                                       _opts(P, priority=_prio(P, "BACKFILL")))
            for i in range(4)))
        await pool.close()
        return list(ok)

    ok = _run(go())
    assert ok == [True] * 4 and len(windows) == 4
    for (_, e1, _), (s2, _, _) in zip(windows, windows[1:]):
        assert e1 <= s2 + 1e-4
    return ok, [w[2] for w in windows]


def s_premesh_surface(P):
    pool = P.bls.BlsDeviceVerifierPool(lambda sets: True)
    out = (pool.device_breaker is pool.mesh.lanes[0].breaker, pool.is_down(),
           pool.occupancy.occupancy_permille())
    assert out == (True, False, 0)
    return out


def s_latency_work_spreads(P):
    rig = Rig(P, 4, call_s=0.05)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        jobs = []
        for i in range(4):
            jobs.append(asyncio.ensure_future(pool.verify_signature_sets(
                _sets(P, 1, tag=i), _opts(P, priority=_prio(P, "GOSSIP_ATTESTATION")))))
            await asyncio.sleep(0.01)
        ok = await asyncio.gather(*jobs)
        await pool.close()
        return list(ok)

    ok = _run(go())
    assert ok == [True] * 4
    assert len({i for i, _ in rig.calls}) >= 3, rig.calls
    return ok


def s_pick_placement_least_occupied(P):
    rig = Rig(P, 3)
    pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
    for lane, busy_s in zip(rig.mesh.lanes, (0.2, 0.05, 0.0)):
        if busy_s:
            _busy(lane, busy_s)
    out = _placed(P, pool, "GOSSIP_BLOCK", 1)
    assert out == 2
    return out


def s_bulk_runs_on_one_lane(P):
    """With no collective on the mesh, a bulk batch big enough to shard is
    one launch on one lane."""
    rig = Rig(P, 4)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(_sets(P, 64),
                                              _opts(P, priority=_prio(P, "RANGE_SYNC")))
        await pool.close()
        return ok

    ok = _run(go())
    assert ok and len(rig.calls) == 1
    return ok, [n for _, n in rig.calls]


def s_small_bulk_one_lane(P):
    rig = Rig(P, 4)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(_sets(P, 8),
                                              _opts(P, priority=_prio(P, "BACKFILL")))
        await pool.close()
        return ok

    ok = _run(go())
    assert ok and len({i for i, _ in rig.calls}) == 1
    return ok, [n for _, n in rig.calls]


def s_lane_kill_degrades(P):
    rig = Rig(P, 3, wedge_threshold=2)
    rig.kill(0)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        results = []
        for i in range(50):
            results.append(await pool.verify_signature_sets(
                _sets(P, 1, tag=i), _opts(P, priority=_prio(P, "API"))))
            if rig.mesh.lanes[0].wedged:
                break
        at_wedge = rig.served_by(0)
        for i in range(5):
            results.append(await pool.verify_signature_sets(
                _sets(P, 1, tag=100 + i), _opts(P, priority=_prio(P, "API"))))
        state = (all(results), pool.is_down(), len(pool.mesh.available()),
                 rig.mesh.lanes[0].wedge_trips, rig.served_by(0) == at_wedge)
        await pool.close()
        return state

    out = _run(go())
    assert out == (True, False, 2, 1, True)
    return out


def s_all_lanes_wedged(P):
    rig = Rig(P, 2, wedge_threshold=1)
    rig.kill(0)
    rig.kill(1)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        with pytest.raises(RuntimeError):
            await pool.verify_signature_sets(_sets(P, 1))
        down = pool.is_down()
        await pool.close()
        return down

    assert _run(go()) is True
    return True


def s_bulk_lane_error_degrades(P):
    """A sick lane under bulk traffic: each package it takes errors there
    and is served by a sibling, the verdicts unchanged."""
    rig = Rig(P, 4, wedge_threshold=3)
    rig.kill(0)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        oks = [await pool.verify_signature_sets(_sets(P, 64, tag=i),
                                                _opts(P, priority=_prio(P, "RANGE_SYNC")))
               for i in range(4)]
        stats = dict(pool.metrics)
        await pool.close()
        return oks, stats["errors"]

    oks, errors = _run(go())
    assert oks == [True] * 4 and errors == 0
    assert all(n == 64 for _, n in rig.calls) and rig.served_by(0) < len(rig.calls)
    return oks, errors


def s_invalid_bulk_verdict_retries(P):
    """An invalid bulk batch takes the batch-then-retry road on its lane,
    and every lane's in-flight count returns to 0."""
    rig = Rig(P, 4, verdict_fn=lambda sets: not any(s.pubkey[0] == 0xBB for s in sets))

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        ok = await pool.verify_signature_sets(
            _bad(P, _sets(P, 64)), _opts(P, batchable=True, priority=_prio(P, "RANGE_SYNC")))
        retries = pool.metrics["batch_retries"]
        await pool.close()
        return ok, retries

    ok, retries = _run(go())
    inflight = [lane.inflight for lane in rig.mesh.lanes]
    assert ok is False and inflight == [0, 0, 0, 0]
    return ok, retries, inflight, [n for _, n in rig.calls]


def s_injected_mesh_of_one(P):
    calls_a, calls_b = [], []

    def mk(backend_calls):
        def backend(sets):
            backend_calls.append(tuple(s.pubkey[1] for s in sets))
            return True

        return backend

    async def drive(pool):
        ok = await asyncio.gather(*(
            pool.verify_signature_sets(_sets(P, 2, tag=i), _opts(P, priority=pr))
            for i, pr in enumerate([_prio(P, "BACKFILL"), _prio(P, "GOSSIP_BLOCK"),
                                    _prio(P, "API")])))
        await pool.close()
        return list(ok)

    async def go():
        a = P.bls.BlsDeviceVerifierPool(mk(calls_a), scheduler_enabled=True)
        b = P.bls.BlsDeviceVerifierPool(
            mesh=P.mesh.VerifierMesh(P.mesh.single_lane_mesh(mk(calls_b)).lanes),
            scheduler_enabled=True)
        return await drive(a), await drive(b)

    ra, rb = _run(go())
    assert all(ra) and all(rb) and calls_a == calls_b
    return ra, calls_a


def s_dispatcher_waits_for_healthy_lane(P):
    rig = Rig(P, 2, wedge_threshold=1)
    pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
    lane0, lane1 = rig.mesh.lanes
    lane0.breaker.record_failure()
    lane1.inflight = 1
    seen = [[lane.index for lane in pool._free_lanes()]]
    lane1.inflight = 0
    seen.append([lane.index for lane in pool._free_lanes()])
    lane1.breaker.record_failure()
    seen.append([lane.index for lane in pool._free_lanes()])
    assert seen == [[], [1], [0, 1]]
    return seen


def s_mesh_launch_routes_around_sick_chip(P):
    rig = Rig(P, 2, wedge_threshold=2)
    rig.kill(0)
    wedges = []
    for i in range(6):
        ok, lane = P.mesh.mesh_launch(rig.mesh, _sets(P, 1, tag=i), prefer=rig.mesh.lanes[0],
                                      on_wedge=lambda l: wedges.append(l.index))
        assert ok and lane.index == 1
        if rig.mesh.lanes[0].wedged:
            break
    at_wedge = rig.served_by(0)
    for i in range(4):
        ok, lane = P.mesh.mesh_launch(rig.mesh, _sets(P, 1, tag=50 + i))
        assert ok and lane.index == 1
    assert rig.mesh.lanes[0].wedged and wedges == [0] and rig.served_by(0) == at_wedge
    return wedges, rig.calls


def s_dispatcher_survives_wedge_before_placement(P):
    rig = Rig(P, 2, wedge_threshold=1, call_s=0.05)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
        lane0, lane1 = rig.mesh.lanes
        first = asyncio.ensure_future(pool.verify_signature_sets(
            _sets(P, 1, tag=1), _opts(P, priority=_prio(P, "API"))))
        await asyncio.sleep(0.01)
        idle = lane1 if lane0.inflight else lane0
        idle.breaker.record_failure()
        assert idle.wedged
        second = asyncio.ensure_future(pool.verify_signature_sets(
            _sets(P, 1, tag=2), _opts(P, priority=_prio(P, "API"))))
        ok = await asyncio.gather(first, second)
        await pool.close()
        return list(ok)

    out = _run(go())
    assert out == [True, True]
    return out


def s_bulk_placement_least_occupied(P):
    rig = Rig(P, 4)
    pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True)
    for lane, busy_s in zip(rig.mesh.lanes, (0.04, 0.02, 0.08, 0.0)):
        if busy_s:
            _busy(lane, busy_s)
    out = _placed(P, pool, "RANGE_SYNC", 48)
    assert out == 3
    return out


def s_mesh_launch_reroutes_from_wedged(P):
    rig = Rig(P, 2, wedge_threshold=1)
    rig.kill(0)
    lane0 = rig.mesh.lanes[0]
    lane0.breaker.record_failure()
    before = rig.served_by(0)
    ok, served = P.mesh.mesh_launch(rig.mesh, _sets(P, 1), prefer=lane0)
    assert ok and served.index == 1 and rig.served_by(0) == before
    return ok, served.index


# --- scenarios of tests/chain/test_pipeline.py -------------------------------------


def s_pipelined_vs_unpipelined(P):
    def verdict_fn(sets):
        return all(s.message[1] != 13 for s in sets)

    def replay(pipeline):
        rng = random.Random(42)
        rig = Rig(P, 2, with_prepared=True, verdict_fn=verdict_fn)

        async def go():
            pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                               pipeline=pipeline, prep_fn=Rig.prep_fn)
            jobs = []
            for i in range(24):
                tag = 13 if rng.random() < 0.25 else i % 7
                jobs.append(pool.verify_signature_sets(_sets(P, 2, tag=tag), _opts(
                    P, batchable=rng.random() < 0.5,
                    priority=_prio(P, "GOSSIP_ATTESTATION"))))
            verdicts = await asyncio.gather(*jobs)
            await pool.close()
            return list(verdicts)

        return _run(go())

    off, on = replay("off"), replay("on")
    assert off == on
    return off


def s_prep_overlaps_verify(P):
    rig = Rig(P, 1, call_s=0.08, with_prepared=True)

    def slow_prep(sets, lane_hint):
        time.sleep(0.04)
        return Rig.prep_fn(sets, lane_hint)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=slow_prep)
        jobs = []
        for i in range(4):
            jobs.append(asyncio.ensure_future(pool.verify_signature_sets(
                _sets(P, 1, tag=i), _opts(P, batchable=False))))
            await asyncio.sleep(0.02)
        ok = await asyncio.gather(*jobs)
        stats = pool.pipeline_stats()
        await pool.close()
        return list(ok), stats

    ok, stats = _run(go())
    assert ok == [True] * 4 and stats["pipeline_enabled"] is True
    assert stats["staged_packages"] >= 2 and stats["overlap_ns"] > 0
    assert stats["overlap_occupancy_pct"] > 0.0
    return ok, stats["pipeline_enabled"]


def s_staged_inputs_reach_prepared_seam(P):
    rig = Rig(P, 1, with_prepared=True)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=Rig.prep_fn)
        ok = await pool.verify_signature_sets(_sets(P, 3), _opts(P, batchable=False))
        await pool.close()
        return ok

    ok = _run(go())
    assert ok is True and rig.prepared_calls
    return ok, rig.prepared_calls


def s_prep_error_reprepped_inline(P):
    """A prep-stage error on the second package: that package re-preps
    inline through the lane's plain verify (the staged road for the
    first), and both verdicts stand."""
    rig = Rig(P, 1, with_prepared=True)
    calls = {"n": 0}

    def flaky_prep(sets, lane_hint):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected prep fault")
        return Rig.prep_fn(sets, lane_hint)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=flaky_prep)
        oks = [await pool.verify_signature_sets(_sets(P, 2, tag=i), _opts(P, batchable=False))
               for i in range(2)]
        await pool.close()
        return oks

    oks = _run(go())
    assert oks == [True, True] and rig.prepared_calls == [(0, 2)] and rig.calls == [(0, 2)] * 2
    return oks, rig.calls


def s_close_drains_both_stages(P):
    rig = Rig(P, 1, call_s=0.2, with_prepared=True)

    def slow_prep(sets, lane_hint):
        time.sleep(0.1)
        return Rig.prep_fn(sets, lane_hint)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=slow_prep)
        futures = [asyncio.ensure_future(pool.verify_signature_sets(
            _sets(P, 1, tag=i), _opts(P, batchable=False))) for i in range(6)]
        await asyncio.sleep(0.05)
        await pool.close()
        results = await asyncio.gather(*futures, return_exceptions=True)
        return futures, results

    futures, results = _run(go())
    assert all(f.done() for f in futures)
    assert all(isinstance(r, (bool, asyncio.CancelledError)) for r in results), results
    return "drained"


def s_auto_single_lane_keeps_schedule(P):
    def replay(pipeline):
        rig = Rig(P, 1, call_s=0.01)

        async def go():
            pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                               pipeline=pipeline)
            assert pool.pipeline_stats()["pipeline_enabled"] is False
            for i in range(5):
                assert await pool.verify_signature_sets(_sets(P, 1, tag=i),
                                                        _opts(P, batchable=False))
            stats = pool.pipeline_stats()
            await pool.close()
            return rig.calls, stats

        return _run(go())

    calls_auto, stats_auto = replay("auto")
    calls_off, stats_off = replay("off")
    assert calls_auto == calls_off
    assert stats_auto["staged_packages"] == 0 == stats_off["staged_packages"]
    assert stats_auto["prep_ns"] == 0
    return calls_auto


def s_rejects_unknown_mode(P):
    with pytest.raises(ValueError):
        P.bls.BlsDeviceVerifierPool(lambda sets: True, pipeline="bogus")
    with pytest.raises(ValueError):
        P.bls.BlsDeviceVerifierPool(lambda sets: True, mesh_mode="bogus")
    return P.pool.PIPELINE_MODES, P.mesh.MESH_MODES


def s_staged_inputs_dropped_on_cross_lane_retry(P):
    calls = []

    def l0_prepared(inputs):
        calls.append("l0-prepared")
        raise RuntimeError("poisoned staged inputs")

    def l0_plain(sets):
        calls.append("l0-plain")
        raise RuntimeError("unreachable on this path")

    def l1_prepared(inputs):
        calls.append("l1-prepared")
        return True

    def l1_plain(sets):
        calls.append("l1-plain")
        return True

    lanes = [P.mesh.MeshLane(0, l0_plain, verify_prepared_fn=l0_prepared),
             P.mesh.MeshLane(1, l1_plain, verify_prepared_fn=l1_prepared)]
    ok, served = P.mesh.mesh_launch(P.mesh.VerifierMesh(lanes), _sets(P, 1), prefer=lanes[0],
                                    prepared=P.mesh.PreparedSets(inputs=("staged",)))
    assert ok is True and served is lanes[1] and calls == ["l0-prepared", "l1-plain"]
    return calls


def s_dead_dispatch_stage_restarts(P):
    rig = Rig(P, 1, with_prepared=True)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(mesh=rig.mesh, scheduler_enabled=True,
                                           pipeline="on", prep_fn=Rig.prep_fn)
        assert await pool.verify_signature_sets(_sets(P, 1), _opts(P, batchable=False))
        pool._verify_runner.cancel()
        await asyncio.sleep(0)
        assert pool._verify_runner.done()
        ok = await pool.verify_signature_sets(_sets(P, 1, tag=1), _opts(P, batchable=False))
        await pool.close()
        return ok

    assert _run(go()) is True
    return True


def s_gossip_burst_packages(P):
    """The serve shape of the chip run, on a mock: 512 one-set batchable
    jobs at once at gossip-attestation priority, then 4 jobs of 128 at API
    priority with one invalid, then 16 of 128 at range-sync priority.
    Backend call sizes in order (one lane) and every verdict."""
    async def go():
        be = Backend()
        pool = P.bls.BlsDeviceVerifierPool(be, scheduler_enabled=True)
        gossip = await asyncio.gather(*(pool.verify_signature_sets(
            _sets(P, 1, tag=i % 256), _opts(P, batchable=True,
                                            priority=_prio(P, "GOSSIP_ATTESTATION")))
            for i in range(512)))
        n_gossip = len(be.calls)
        api_jobs = [_sets(P, 128, tag=i) for i in range(4)]
        api_jobs[2] = _bad(P, api_jobs[2])
        api = await asyncio.gather(*(pool.verify_signature_sets(
            s, _opts(P, batchable=True, priority=_prio(P, "API"))) for s in api_jobs))
        n_api = len(be.calls)
        rs = await asyncio.gather(*(pool.verify_signature_sets(
            _sets(P, 128, tag=i), _opts(P, batchable=True, priority=_prio(P, "RANGE_SYNC")))
            for i in range(16)))
        await pool.close()
        return (list(gossip), list(api), list(rs), be.calls[:n_gossip],
                be.calls[n_gossip:n_api], be.calls[n_api:])

    gossip, api, rs, c_gossip, c_api, c_rs = _run(go())
    assert all(gossip) and api == [True, True, False, True] and all(rs)
    assert sum(c_gossip) == 512 and max(c_gossip) <= 16
    assert c_api == [512, 128, 128, 128, 128] and c_rs == [128] * 16
    return gossip, api, rs, c_gossip, c_api, c_rs


SCENARIOS = [
    s_chunkify, s_valid_batchable_together, s_invalid_batch_retries,
    s_buffer_flushes_on_sig_count, s_large_array_chunks, s_device_error_fails_closed,
    s_batchable_error_retries_then_fails_closed, s_can_accept_work_bounds_queue,
    s_close_rejects_pending, s_single_thread_verifier_and_mock,
    s_single_lane_serialized, s_premesh_surface, s_latency_work_spreads,
    s_pick_placement_least_occupied, s_bulk_runs_on_one_lane, s_small_bulk_one_lane,
    s_lane_kill_degrades, s_all_lanes_wedged, s_bulk_lane_error_degrades,
    s_invalid_bulk_verdict_retries, s_injected_mesh_of_one,
    s_dispatcher_waits_for_healthy_lane, s_mesh_launch_routes_around_sick_chip,
    s_dispatcher_survives_wedge_before_placement, s_bulk_placement_least_occupied,
    s_mesh_launch_reroutes_from_wedged,
    s_pipelined_vs_unpipelined, s_prep_overlaps_verify, s_staged_inputs_reach_prepared_seam,
    s_prep_error_reprepped_inline, s_close_drains_both_stages, s_auto_single_lane_keeps_schedule,
    s_rejects_unknown_mode, s_staged_inputs_dropped_on_cross_lane_retry,
    s_dead_dispatch_stage_restarts, s_gossip_burst_packages,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_pool_scenario_matches_the_jax_package(scenario):
    assert scenario(TORCH) == scenario(JAX)


def test_pool_constants_are_the_jax_packages():
    names = ("MAX_SIGNATURE_SETS_PER_JOB", "MAX_BUFFERED_SIGS", "MAX_BUFFER_WAIT_MS",
             "MAX_JOBS_CAN_ACCEPT_WORK", "BATCHABLE_MIN_PER_CHUNK", "MAX_PACKAGE_SETS",
             "DEVICE_WEDGE_THRESHOLD", "PIPELINE_MODES")
    assert {n: getattr(t_pool, n) for n in names} == {n: getattr(j_pool, n) for n in names}
    names = ("LANE_WEDGE_THRESHOLD", "LANE_WEDGE_RESET_S", "LANE_WEDGE_MAX_RESET_S",
             "MESH_MODES")
    assert {n: getattr(t_mesh, n) for n in names} == {n: getattr(j_mesh, n) for n in names}


# --- the copied support modules against their originals, on a fake clock -------------


class FakeClock:
    def __init__(self, t=1_000_000_000):
        self.t = t

    def ns(self):
        return self.t

    def s(self):
        return self.t / 1e9

    def advance_ms(self, ms):
        self.t += int(ms * 1e6)


def _queue_run(sched, fifo, seed):
    clock = FakeClock()
    q = sched.PriorityWorkQueue(fifo=fifo, aging_ms=50.0, time_fn=clock.ns)
    rng = random.Random(seed)
    order = []
    for step in range(400):
        if rng.random() < 0.55:
            cls = rng.choice(list(sched.PriorityClass))
            q.put_nowait(step, cls)
        else:
            got = q.get_nowait(rng.choice([None, None, None, sched.PriorityClass.API]))
            if got is not None:
                order.append((got[0], int(got[1]), got[2]))
        clock.advance_ms(rng.choice([0, 1, 5, 20]))
    order += [(i, int(c), w) for i, c, w in q.drain()]
    return order, q.stats()


@pytest.mark.parametrize("fifo", [False, True])
def test_scheduler_queue_matches_the_jax_package(fifo):
    assert _queue_run(t_sched, fifo, 7) == _queue_run(j_sched, fifo, 7)


def _occupancy_run(sched):
    clock = FakeClock()
    tr = sched.OccupancyTracker(tau_s=1.0, time_fn=clock.ns)
    depth = {"n": 0}
    adm = sched.AdmissionController(tr, depth_fn=lambda: depth["n"], shed_bulk_depth=4,
                                    reject_depth=8)
    out = []
    for step in range(60):
        if step % 3 == 0:
            tr.begin()
        clock.advance_ms(37 * (step % 5 + 1))
        if step % 3 == 1:
            tr.end()
        depth["n"] = step % 10
        out.append((round(tr.occupancy(), 12), tr.occupancy_permille(), int(adm.state()),
                    adm.admits(sched.PriorityClass.BACKFILL)))
    return out, tr.busy_ns_total


def test_occupancy_and_admission_match_the_jax_package():
    assert _occupancy_run(t_sched) == _occupancy_run(j_sched)


def _slo_run(slo, sched):
    clock = FakeClock(t=10_000 * 10**9)
    slo.reset_slo()
    slo.configure_slo(genesis_time=10_000 - 12 * 5, seconds_per_slot=12, time_fn=clock.s,
                      monotonic_ns_fn=clock.ns, slack_floor_ms=50.0)
    rng = random.Random(3)
    for i in range(40):
        cls = list(sched.PriorityClass)[i % 5]
        js = slo.job_begin(cls, slot=None if i % 2 else 5)
        clock.advance_ms(rng.choice([1, 10, 100]))
        slo.job_flushed(js)
        clock.advance_ms(rng.choice([1, 50, 500]))
        slo.job_dequeued(js, waited_ns=rng.randrange(10**6))
        clock.advance_ms(rng.choice([0, 3]))
        slo.job_launch(js)
        clock.advance_ms(rng.choice([100, 900, 5000]))
        slo.job_verdict(js, ok=i % 7 != 0)
    out = slo.wait_budget(), slo.slo_active()
    slo.reset_slo()
    return out


def test_slo_accountant_matches_the_jax_package():
    assert _slo_run(t_slo, t_sched) == _slo_run(j_slo, j_sched)


def _breaker_run(res):
    clock = FakeClock()
    transitions = []
    br = res.CircuitBreaker(failure_threshold=3, reset_timeout_s=1.0, max_reset_timeout_s=4.0,
                            jitter=0.0, clock=clock.s,
                            on_transition=lambda a, b: transitions.append((a.name, b.name)))
    out = []
    script = "fffsfffafaTfaaaTs fffaaaaTf aaaaaaaaTs"
    token = None
    for op in script:
        if op == "f":
            br.record_failure()
        elif op == "s":
            br.record_success(token)
            token = None
        elif op == "a":
            clock.advance_ms(700)
        elif op == "T":
            token = br.try_acquire()
        out.append((br.state().name, br.is_open, round(br.seconds_until_trial(), 9),
                    token is not None))
    return out, transitions


def test_circuit_breaker_matches_the_jax_package():
    assert _breaker_run(t_res) == _breaker_run(j_res)


def test_backoff_delay_matches_the_jax_package():
    for attempt in range(8):
        for jitter in (0.0, 0.3):
            kw = dict(base=0.5, factor=3.0, max_delay=20.0, jitter=jitter, rng=lambda: 0.25)
            assert t_utils.backoff_delay(attempt, **kw) == j_utils.backoff_delay(attempt, **kw)
    with pytest.raises(ValueError):
        t_utils.backoff_delay(-1, base=1.0)


def _tracer_run(tracing):
    tracing.reset()
    tracing.configure(enabled=True, slow_slot_ms=1e9, ring_size=4)
    base = 10**12
    with tracing.root("block_import", slot=9) as root:
        parent = tracing.current()
        assert parent is root
        with tracing.span("stf"):
            pass
        tracing.record(root, "bls_device_launch", base, base + 5_000_000, {"sets": 3})
        sp = tracing.record(root, "bls_buffer_wait", base, base + 9_000_000, {"sets": 1})
        tracing.record(sp, "bls_prep", base, base + 2_000_000, {"layer": "host"})
        tracing.discard()
        tracing.keep()
    trace = tracing.get_tracer().ring[-1]
    spans = sorted((s.name, s.parent_id, s.attrs) for s in trace.spans)
    path = [s.name for s in tracing.critical_path(trace)]
    out = (trace.slot, spans, path, len(tracing.get_tracer().ring), tracing.current())
    with tracing.root("dup", slot=10):
        tracing.discard()
    out += (len(tracing.get_tracer().ring),)
    tracing.reset()
    out += (tracing.current(), bool(tracing.span("off")))
    return out


def test_tracer_matches_the_jax_package():
    assert _tracer_run(t_tracing) == _tracer_run(j_tracing)


def test_trace_region_writes_a_trace_and_never_changes_the_outcome(tmp_path, monkeypatch):
    """`utils.trace_region` (on `torch.profiler`): a Chrome trace per region
    when LODESTAR_TPU_TRACE names a directory; nested regions no-op; a
    profiler that fails to start changes nothing of the region's outcome."""
    import torch

    monkeypatch.setattr(t_utils, "_TRACE_DIR", str(tmp_path))
    with t_utils.trace_region("bls_batch_verify"):
        with t_utils.trace_region("nested"):
            torch.ones(4).sum()
    assert [p.name.split(".")[0] for p in tmp_path.glob("*.json")] == ["bls_batch_verify"]

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with t_utils.trace_region("broken"):
        ran.append(True)
    assert ran == [True]
    with pytest.raises(ValueError, match="the region's own error"):
        with t_utils.trace_region("broken"):
            raise ValueError("the region's own error")
    assert len(list(tmp_path.glob("*.json"))) == 1
    monkeypatch.setattr(t_utils, "_TRACE_DIR", "")
    assert not t_utils.tracing_enabled()
