"""The port's metrics module (`lodestar_tpu_torch/metrics`) and its seams,
held against `lodestar_tpu.metrics` and the JAX package's seams.

* Registry parity: a fresh `create_metrics()` scrape and a fresh
  `create_tenant_metrics()` scrape are text-equal across the packages once
  the `_created` timestamp lines are dropped, so the repo's `dashboards/`
  and `alerts/` read the port unchanged.
* The JAX package's own tests run on the port (`port_copy`):
  `tests/metrics/test_metrics_server.py` and `test_monitoring.py`. Of
  `test_validator_monitor.py`, the family test is written out here for both
  packages and the monitor is driven through its hooks in both; its chain
  test needs `lodestar_tpu.validator`, which is not ported yet.
* Wiring, each across the packages on the same scripted inputs, timings
  excluded (histograms compare by `_count`, and the busy-seconds and
  occupancy gauges are left out): the scheduler queue's families; the pool
  with `sched_metrics=` and `pipeline_metrics=` on a two-lane mesh of
  recording lanes after the same job stream; the SLO accountant's families
  on a fake clock (histograms in full: the slack is deterministic there);
  the tracing bridge; the launch telemetry's sink; the offload client's
  `ResilienceMetrics`; the offload host's tenant families.
* The port alone, where the JAX side would run its compiler: the pool on
  `device="cpu"` serving one real size-8 job with every family attached
  (scheduler, pipeline, prep, launch telemetry, SLO, tracing) agrees with
  the pool's own counts and `prep_counts()`; the HTR device's
  `SszHtrMetrics` agree with `launch_count()`; the offload host's
  `--metrics-port` scrape over HTTP agrees with its tenancy's counts.

Tolerance: none.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import time
import urllib.request

import pytest
import torch

from .test_torch_utils_gaps import port_copy

torch.set_num_threads(1)

port_copy("tests.metrics.test_metrics_server", globals())
port_copy("tests.metrics.test_monitoring", globals())

J, T = "lodestar_tpu", "lodestar_tpu_torch"
ROOTS = (J, T)


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _text(scrape: bytes) -> str:
    return "\n".join(line for line in scrape.decode().splitlines() if "_created" not in line)


def samples(scrape: bytes, prefix: str = "", timings: bool = False) -> dict:
    """{(name, labels): value} of a scrape's samples whose name starts with
    `prefix`; without `timings`, histogram buckets and sums are dropped
    (their `_count` stays)."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(scrape.decode()):
        for s in fam.samples:
            if not s.name.startswith(prefix) or s.name.endswith("_created"):
                continue
            if not timings and fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


# --- registry parity ---------------------------------------------------------------------


def test_create_metrics_scrape_equals_the_jax_packages():
    jm, tm = (_mod(r, "metrics").create_metrics() for r in ROOTS)
    assert _text(tm.scrape()) == _text(jm.scrape())
    assert len(_text(tm.scrape()).splitlines()) > 400


def test_create_tenant_metrics_scrape_equals_the_jax_packages():
    scrapes = []
    for r in ROOTS:
        m = _mod(r, "metrics")
        creator = m.RegistryMetricCreator()
        m.create_tenant_metrics(creator)
        scrapes.append(_text(creator.scrape()))
    assert scrapes[0] == scrapes[1] and "lodestar_offload_tenant_served_sets_total" in scrapes[1]


def test_family_dataclasses_match():
    import dataclasses

    jm, tm = (_mod(r, "metrics") for r in ROOTS)
    for name in jm.__all__:
        j, t = getattr(jm, name), getattr(tm, name)
        if dataclasses.is_dataclass(j):
            assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_expanded_metric_families_scrape():
    """`tests/metrics/test_validator_monitor.py::test_expanded_metric_families_scrape`
    for both packages, with equal samples."""
    outs = []
    for r in ROOTS:
        m = _mod(r, "metrics").create_metrics()
        m.network.peers_by_direction.labels(direction="outbound").set(3)
        m.sync.range_sync_blocks.inc(5)
        m.db.reads.labels(bucket="block").inc()
        m.regen.state_cache_hits.inc()
        m.op_pool.exits.set(2)
        m.api.rest_requests.labels(method="GET", status="200").inc()
        out = m.scrape().decode()
        for name in ("lodestar_peers_by_direction_count", "lodestar_sync_range_blocks_total",
                     "lodestar_db_read_req_total", "lodestar_state_cache_hits_total",
                     "lodestar_op_pool_voluntary_exit_pool_size",
                     "lodestar_api_rest_requests_total",
                     "lodestar_gossip_mesh_peers_by_type_count",
                     "beacon_reqresp_outgoing_requests_total", "beacon_clock_slot"):
            assert name in out, f"missing metric family {name}"
        outs.append(samples(m.scrape(), timings=True))
    assert outs[0] == outs[1]


def test_validator_monitor_hooks_agree():
    outs = []
    for r in ROOTS:
        m = _mod(r, "metrics").create_metrics()
        mon = m.validator_monitor
        for i in (1, 3, 5, 7):
            mon.register_local_validator(i)
        summaries = []
        for epoch in range(3):
            for slot in range(epoch * 8, epoch * 8 + 8):
                mon.on_block_imported(slot, slot % 9)
            mon.on_gossip_attestation(epoch, [1, 3, 4])
            mon.on_attestation_in_block(epoch, [1, 3, 5, 6], 1 + epoch)
            summaries.append(mon.on_epoch(epoch + 1))
        outs.append((mon.count, summaries, samples(m.scrape(), "validator_monitor", True)))
    assert outs[0] == outs[1]
    assert outs[1][0] == 4


# --- seams across the packages --------------------------------------------------------


def test_scheduler_queue_families_agree():
    outs = []
    for r in ROOTS:
        sched = _mod(r, "scheduler")
        m = _mod(r, "metrics").create_metrics()
        q = sched.PriorityWorkQueue(metrics=m.sched, aging_ms=1e9)
        order = []
        for i, cls in enumerate(["GOSSIP_BLOCK", "API", "RANGE_SYNC", "BACKFILL", "API",
                                 "GOSSIP_ATTESTATION", "RANGE_SYNC"]):
            q.put_nowait(i, getattr(sched.PriorityClass, cls))
        while q.depth():
            item = q.get_nowait()
            order.append(item[0] if isinstance(item, tuple) else item)
        outs.append((order, samples(m.scrape(), "lodestar_sched_")))
    assert outs[0] == outs[1]
    assert sum(v for (n, _), v in outs[1][1].items() if n == "lodestar_sched_jobs_dequeued_total") == 7


def _pool_stream(P, m):
    """The scripted job stream of `tests/test_torch_pool.py`'s pipeline
    scenario through package P's pool on a two-lane recording mesh with
    the scheduler and pipeline families of `m` attached."""
    import random

    from .test_torch_pool import Rig, _opts, _prio, _sets

    def verdict_fn(sets):
        return all(s.message[1] != 13 for s in sets)

    rng = random.Random(42)
    rig = Rig(P, 2, with_prepared=True, verdict_fn=verdict_fn)

    async def go():
        pool = P.bls.BlsDeviceVerifierPool(
            mesh=rig.mesh, scheduler_enabled=True, pipeline="on", prep_fn=Rig.prep_fn,
            sched_metrics=m.sched, pipeline_metrics=m.bls_pipeline)
        jobs = []
        for i in range(24):
            tag = 13 if rng.random() < 0.25 else i % 7
            jobs.append(pool.verify_signature_sets(_sets(P, 2, tag=tag), _opts(
                P, batchable=False, priority=_prio(P, "GOSSIP_ATTESTATION"))))
        verdicts = await asyncio.gather(*jobs)
        stats = dict(pool.metrics)
        await pool.close()
        return list(verdicts), stats

    return asyncio.run(go())


def test_pool_with_scheduler_and_pipeline_families_agrees():
    from .test_torch_pool import JAX, TORCH

    outs = []
    for P, r in ((JAX, J), (TORCH, T)):
        m = _mod(r, "metrics").create_metrics()
        verdicts, stats = _pool_stream(P, m)
        s = samples(m.scrape(), "lodestar_sched_")
        s.update({k: v for k, v in samples(m.scrape(), "lodestar_bls_pipeline_").items()
                  if k[0] == "lodestar_bls_pipeline_staged_packages"})
        # occupancy is an EWMA of wall time: its presence is compared, not its value
        s = {k: (None if "occupancy" in k[0] else v) for k, v in s.items()}
        outs.append((verdicts, stats, s))
    assert outs[0] == outs[1]
    verdicts, stats, s = outs[1]
    launches = sum(v for (n, _), v in s.items() if n == "lodestar_sched_lane_launches_total")
    assert launches >= 24 and s[("lodestar_sched_mesh_lanes_available", ())] == 2
    assert s[("lodestar_bls_pipeline_staged_packages", ())] > 0
    dequeued = sum(v for (n, _), v in s.items() if n == "lodestar_sched_jobs_dequeued_total")
    assert dequeued == stats["jobs_started"] == 24


def test_slo_families_agree_on_a_fake_clock():
    outs = []
    for r in ROOTS:
        slo = _mod(r, "slo")
        sched = _mod(r, "scheduler")
        m = _mod(r, "metrics").create_metrics()
        now = [1000.0]
        mono = [10**12]
        slo.configure_slo(genesis_time=1000.0 - 12 * 5, time_fn=lambda: now[0],
                          monotonic_ns_fn=lambda: mono[0], metrics=m.slo, slack_floor_ms=0.0)
        try:
            for i, (cls, ok, dt) in enumerate([("GOSSIP_BLOCK", True, 1.0), ("GOSSIP_BLOCK", True, 5.0),
                                               ("API", False, 2.0), ("RANGE_SYNC", True, 30.0)]):
                js = slo.job_begin(getattr(sched.PriorityClass, cls), slot=5)
                now[0] += dt / 2
                mono[0] += int(dt / 2 * 1e9)
                slo.job_flushed(js)
                slo.job_dequeued(js, 1000)
                slo.job_launch(js)
                now[0] += dt / 2
                mono[0] += int(dt / 2 * 1e9)
                slo.job_verdict(js, ok)
            outs.append(samples(m.scrape(), "lodestar_slo_", timings=True))
        finally:
            slo.reset_slo()
    assert outs[0] == outs[1]
    assert outs[1][("lodestar_slo_deadline_miss_total", (("class", "gossip_block"),))] == 1


def test_tracing_bridge_agrees():
    outs = []
    for r in ROOTS:
        tracing = _mod(r, "tracing")
        m = _mod(r, "metrics").create_metrics()
        tracing.reset()
        try:
            tracing.configure(enabled=True, slow_slot_ms=1e9, metrics=m.trace)
            for slot in range(3):
                with tracing.root("block_import", slot=slot):
                    with tracing.span("bls_verify"):
                        pass
                    with tracing.span("state_transition"):
                        pass
            with tracing.root("range_sync", slot=9, bulk=True):
                with tracing.span("bls_verify"):
                    pass
            tracing.configure(slow_slot_ms=0.0)
            with tracing.root("block_import", slot=4):
                time.sleep(0.001)
            dump = tracing.get_tracer().last_slow_dump
            outs.append((samples(m.scrape(), "lodestar_trace_"), dump["slot"], dump["spans"]))
        finally:
            tracing.reset()
    assert outs[0] == outs[1]
    s = outs[1][0]
    assert s[("lodestar_trace_completed_total", ())] == 5
    assert s[("lodestar_trace_slow_slot_total", ())] == 1
    assert s[("lodestar_trace_block_pipeline_seconds_count", ())] == 4


def test_launch_telemetry_sink_agrees():
    outs = []
    for r in ROOTS:
        tel = _mod(r, "telemetry")
        m = _mod(r, "metrics").create_metrics()
        tel.reset_launch_telemetry()
        try:
            tel.configure_launch_telemetry(mode="auto", metrics=m.device_launch)
            for program, size, secs in [("merkle_level", 4096, 0.01), ("merkle_level", 4096, 0.002),
                                        ("bls_lane_verify", 128, 0.6), ("_prep_field_stage", 256, 0.1),
                                        ("bls_lane_verify", 128, 0.7)]:
                tel.record_launch(program, size, secs, lane="cuda:0")
            outs.append((samples(m.scrape(), "lodestar_device_", timings=True), tel.launch_totals()))
        finally:
            tel.reset_launch_telemetry()
    assert outs[0] == outs[1]
    assert outs[1][0][("lodestar_device_launch_seconds_count",
                       (("program", "bls_lane_verify"), ("size_class", "128")))] == 2


def test_offload_client_resilience_families_agree():
    from .test_torch_offload_client import GOSSIP_BLOCK, JAX, PORT, Rig, _rule

    outs = []
    for P, r in ((JAX, J), (PORT, T)):
        m = _mod(r, "metrics").create_metrics()
        rig = Rig(P, P, rules=[_rule(P, "ERROR_FRAME", targets={"A"}, methods={"verify"})],
                  connect=False, metrics=False)
        rig.metrics = m.resilience
        rig.connect(breaker_threshold=2, probe_interval_s=3600.0)
        try:
            rig.wait_probed()
            out = [rig.verify(rig.sets(), GOSSIP_BLOCK) for _ in range(4)]
            outs.append((out, samples(m.scrape(), "lodestar_resilience_")))
        finally:
            rig.close()
    assert outs[0] == outs[1]
    out, s = outs[1]
    assert out == [True] * 4
    assert s[("lodestar_resilience_breaker_state", (("endpoint", "A"),))] == 2
    assert sum(v for (n, _), v in s.items() if n == "lodestar_resilience_hedge_win_total") == 2


def _tenant_frames(P, off):
    """Frames for tenants a and b: 3 one-set frames of a, 2 two-set frames
    of b, one empty-trailer legacy frame."""
    from .test_torch_offload_client import dummy_sets

    out = []
    for i in range(3):
        out.append(("a", off.encode_sets(dummy_sets(P, 1, tag=i), tenant="a", priority=2)))
    for i in range(2):
        out.append(("b", off.encode_sets(dummy_sets(P, 2, tag=10 + i), tenant="b", priority=3)))
    out.append(("default", off.encode_sets(dummy_sets(P, 1, tag=20))))
    return out


def test_offload_host_tenant_families_agree():
    from .test_torch_offload_client import JAX, PORT

    outs = []
    for P, r in ((JAX, J), (PORT, T)):
        mm = _mod(r, "metrics")
        srv = _mod(r, "offload.server")
        off = _mod(r, "offload")
        creator = mm.RegistryMetricCreator()
        tm = mm.create_tenant_metrics(creator)
        server = srv.BlsOffloadServer(lambda sets: True, tenant_weights={"a": 1, "b": 3},
                                      tenant_metrics=tm)
        try:
            stub = srv.LocalStub(server._verify)
            verdicts = [off.decode_verdict(stub(frame), request=frame) for _, frame in
                        _tenant_frames(P, off)]
        finally:
            server.stop()
        outs.append((verdicts, samples(creator.scrape(), "lodestar_offload_tenant_")))
    assert outs[0] == outs[1]
    s = outs[1][1]
    assert s[("lodestar_offload_tenant_served_sets_total", (("tenant", "a"),))] == 3
    assert s[("lodestar_offload_tenant_served_sets_total", (("tenant", "b"),))] == 4


# --- the port alone ------------------------------------------------------------------


def test_offload_host_metrics_port_scrape_agrees_with_tenancy():
    """`build_server(["--metrics-port", ...])` on the CPU oracle: the scrape
    over HTTP holds the tenant families, equal to the tenancy's counts."""
    import socket

    from lodestar_tpu_torch import offload as off
    from lodestar_tpu_torch.offload import server as srv

    from .test_torch_offload_client import PORT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = srv.build_server(["--bls-mesh", "off", "--metrics-port", str(port),
                               "--tenant-weight", "a=1", "--tenant-weight", "b=3"])
    try:
        assert server.metrics_server is not None and server.metrics_server.port == port
        stub = srv.LocalStub(server._verify)
        frames = _tenant_frames(PORT, off)
        verdicts = [off.decode_verdict(stub(frame), request=frame) for _, frame in frames]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read()
    finally:
        server.stop()
        server.metrics_server.stop()
    assert all(v is False for v in verdicts)  # dummy sets fail the oracle
    s = samples(body, "lodestar_offload_tenant_")
    sets_by_tenant = {}
    for tenant, frame in frames:
        sets_by_tenant[tenant] = sets_by_tenant.get(tenant, 0) + int.from_bytes(frame[:4], "little")
    for tenant, n in sets_by_tenant.items():
        assert s[("lodestar_offload_tenant_served_sets_total", (("tenant", tenant),))] == n
        assert server.tenancy.served[tenant] == sum(1 for t, _ in frames if t == tenant)
    assert s[("lodestar_offload_tenant_quota_weight", (("tenant", "b"),))] == 3
    assert not server.tenancy.shed
    assert srv.build_server(["--bls-mesh", "off"]).metrics_server is None


def test_pool_on_cpu_with_every_family_attached():
    """One real size-8 job through `BlsDeviceVerifierPool(device="cpu")`
    with the scheduler, pipeline, prep, launch-telemetry, SLO and tracing
    families attached: the scrape agrees with the pool's counts and
    `prep_counts()`; the fallback counters stay at zero."""
    from lodestar_tpu_torch import slo, telemetry, tracing
    from lodestar_tpu_torch.chain.bls import BlsDeviceVerifierPool, VerifySignatureOpts
    from lodestar_tpu_torch.metrics import create_metrics
    from lodestar_tpu_torch.models import batch_verify as bv
    from lodestar_tpu_torch.scheduler import PriorityClass

    m = create_metrics()
    sets = bv.make_synthetic_sets(8, seed=21)
    prev_mode = bv.configure_device_prep(metrics=m.bls_prep)
    telemetry.reset_launch_telemetry()
    telemetry.configure_launch_telemetry(metrics=m.device_launch)
    slo.configure_slo(genesis_time=time.time() - 12 * 3, metrics=m.slo)
    tracing.reset()
    tracing.configure(enabled=True, slow_slot_ms=1e9, metrics=m.trace)
    bv.reset_prep_counts()
    try:
        async def go():
            pool = BlsDeviceVerifierPool(device="cpu", sched_metrics=m.sched,
                                         pipeline_metrics=m.bls_pipeline)
            with tracing.root("block_import", slot=3):
                ok = await pool.verify_signature_sets(
                    sets, VerifySignatureOpts(batchable=False, priority=PriorityClass.API, slot=3))
            stats = dict(pool.metrics)
            await pool.close()
            return ok, stats

        ok, stats = asyncio.run(go())
        counts = bv.prep_counts()
        s = samples(m.scrape())
    finally:
        bv.configure_device_prep(mode=prev_mode)
        bv._prep_metrics = None
        bv.dp.configure_launch_counter(None)
        telemetry.reset_launch_telemetry()
        slo.reset_slo()
        tracing.reset()
    assert ok is True and stats["jobs_started"] == 1 and stats["sig_sets_started"] == 8

    def total(name):
        return sum(v for (n, _), v in s.items() if n == name)

    assert total("lodestar_sched_jobs_dequeued_total") == stats["jobs_started"]
    assert total("lodestar_sched_lane_launches_total") == 1
    assert s[("lodestar_bls_prep_sets_total", (("layer", "host"),))] == counts["sets"]["host"] == 8
    assert total("lodestar_bls_prep_seconds_count") == 1
    assert total("lodestar_bls_prep_rejected_total") == counts["rejected"] == 0
    assert total("lodestar_bls_prep_fallbacks_total") == 0
    assert total("lodestar_bls_prep_single_launch_fallbacks_total") == 0
    assert s[("lodestar_slo_sli_total", (("class", "api"),))] == 1
    assert total("lodestar_trace_completed_total") == 1
    assert total("lodestar_trace_span_duration_seconds_count") >= 2
    lane = [v for (n, labels), v in s.items() if n == "lodestar_device_launch_seconds_count"]
    assert sum(lane) == 1
    assert total("lodestar_device_compile_misses_total") == 1


def test_htr_device_metrics_agree_with_the_launch_count():
    import numpy as np

    from lodestar_tpu_torch.metrics import create_metrics
    from lodestar_tpu_torch.ssz import device_htr as dh

    m = create_metrics()
    prev_min = dh.DEVICE_MIN_FLUSH_PAIRS
    prev = dh.configure_device_htr(mode="on", device="cpu", metrics=m.ssz_htr)
    before = dh.launch_count()
    try:
        chunks = np.random.default_rng(5).integers(0, 256, size=(64, 32), dtype=np.uint8)
        root = dh.merkle_root(chunks)
        launched = dh.launch_count() - before
    finally:
        dh.configure_device_htr(mode=prev, device="cuda")
        dh._htr_metrics = None
        dh.DEVICE_MIN_FLUSH_PAIRS = prev_min
    from lodestar_tpu_torch.ssz.hash import hash_nodes_hashlib

    level = chunks
    while level.shape[0] > 1:
        level = hash_nodes_hashlib(level)
    assert bytes(root) == level[0].tobytes()
    s = samples(m.scrape(), "lodestar_ssz_htr_")
    assert launched >= 1 and s[("lodestar_ssz_htr_launches_total", ())] == launched
    assert not [v for (n, _), v in s.items() if n == "lodestar_ssz_htr_fallback_total" and v]


def test_metrics_server_serves_a_tenant_creator():
    """The offload host hands `MetricsServer` its tenant creator, not a
    `BeaconMetrics`: anything with `scrape()` is served."""
    from lodestar_tpu_torch import metrics as tm

    creator = tm.RegistryMetricCreator()
    fam = tm.create_tenant_metrics(creator)
    fam.served_sets.labels("x").inc(4)
    server = tm.MetricsServer(creator, port=0)
    server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            body = r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        server.stop()
    assert samples(body)[("lodestar_offload_tenant_served_sets_total", (("tenant", "x"),))] == 4
