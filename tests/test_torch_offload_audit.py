"""The port's auditor, fault harness, clock and breaker against the JAX
package's, on the CPU.

* `AuditSampler`, `TrustScore`, `detection_horizon`: the same seed and
  verdict stream give the same picks, the same trust series and the same
  horizon in both packages.
* The quarantine file: a file either package writes loads in the other;
  a damaged file is loud and kept aside in both; `remaining_cooloff`
  agrees.
* `OffloadAuditor` through each package's client, in-process: a
  `LIE_VERDICT` helper is caught within `detection_horizon` samples,
  quarantined (probe-immune, persisted, forensics dumped) and routed
  around, at the same sample in both packages; the port's CPU oracle
  catches a lie about a real tampered set; `cross_helper_reference`
  arbitrates a lying reference; the duty-cycle budget and both queue caps
  shed without blocking the caller; False verdicts are always audited.
* `FaultInjector`: rule windows, the same seed and call sequence give the
  same decisions and `schedule()`, `from_trace` replays a schedule exactly,
  corruption / flip / lie bytes are equal, partitions, the backend seam,
  and the chaos invariant (no injected fault turns an invalid set True).
* `SimClock`, and the breaker's quarantine and probe release, run on a
  `SimClock` against the JAX breaker on the JAX package's clock.

Tolerance: none (equal picks, bytes, schedules, states and counts).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time

import pytest

import lodestar_tpu.chain.bls as j_bls
import lodestar_tpu.testing.clock as j_clock
import lodestar_tpu_torch.chain.bls as t_bls
import lodestar_tpu_torch.testing as t_testing
import lodestar_tpu_torch.testing.clock as t_clock

from .test_torch_offload_client import (
    GOSSIP_ATT,
    GOSSIP_BLOCK,
    JAX,
    PACKAGES,
    PORT,
    Metrics,
    Rig,
    _rule,
    _wait,
    dummy_sets,
)

RATE = 0.5  # audit rate of the invariant scenarios: horizon ceil(ln .01 / ln .5) = 7


def _stub_reference(verdict=False):
    return lambda sets, exclude_target: (verdict, None)


def _frame(P, n=1):
    return P.off.encode_sets(dummy_sets(P, n))


# -- sampler, trust, horizon -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1234, 2**63 + 5])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.3, 1.0])
def test_sampler_picks_agree(seed, rate):
    picks = {}
    for P in (JAX, PORT):
        s = P.audit.AuditSampler(rate, seed=seed)
        assert s.seed == seed
        picks[P.name] = [s.sample(P.PC(i % 5)) for i in range(300)]
        picks[P.name + "_rates"] = {int(c): s.rate_for(c) for c in P.PC}
    assert picks["port"] == picks["jax"]
    assert picks["port_rates"] == picks["jax_rates"]


def test_sampler_class_weights_and_unseeded_default():
    assert {int(k): v for k, v in PORT.audit.AUDIT_CLASS_WEIGHTS.items()} == \
        {int(k): v for k, v in JAX.audit.AUDIT_CLASS_WEIGHTS.items()}
    for name in ("DEFAULT_AUDIT_RATE", "DEFAULT_AUDIT_BUDGET", "DEFAULT_AUDIT_QUEUE_MAX",
                 "DEFAULT_AUDIT_QUEUE_MAX_BYTES", "TRUST_ROUTE_THRESHOLD", "_QUARANTINE_FILE"):
        assert getattr(PORT.audit, name) == getattr(JAX.audit, name), name
    # unseeded: an unpredictable seed, kept for replay
    a, b = PORT.audit.AuditSampler(), PORT.audit.AuditSampler()
    assert a.seed != b.seed
    replay = PORT.audit.AuditSampler(seed=a.seed)
    assert [a.sample(PORT.PC(0)) for _ in range(50)] == \
        [replay.sample(PORT.PC(0)) for _ in range(50)]


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.05, 0.25, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("p", [0.01, 0.001])
def test_detection_horizon_agrees(rate, p):
    assert PORT.audit.detection_horizon(rate, p) == JAX.audit.detection_horizon(rate, p)
    assert PORT.audit.detection_horizon(0.5) == 7 and PORT.audit.detection_horizon(0.05) == 90


@pytest.mark.parametrize("alpha", [0.25, 0.1])
def test_trust_score_series_agrees(alpha):
    pattern = [False, True, True, True, False, False] + [True] * 20
    series = {}
    for P in (JAX, PORT):
        t = P.audit.TrustScore(alpha=alpha)
        series[P.name] = [t.record(x) for x in pattern] + [t.agrees, t.disagrees]
    assert series["port"] == series["jax"]


# -- the quarantine file ------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_quarantine_file_crosses_packages(tmp_path, writer, reader):
    W, R = PACKAGES[writer], PACKAGES[reader]
    aud = W.audit.OffloadAuditor(sampler=W.audit.AuditSampler(1.0, seed=0),
                                 dump_dir=str(tmp_path), start=False)
    aud._persist_quarantine("10.0.0.1:50051", "deadbeef")
    aud._persist_quarantine("liar:9000", "cafe")
    aud.close()
    entries = R.audit.load_quarantine_file(str(tmp_path))
    assert set(entries) == {"10.0.0.1:50051", "liar:9000"}
    assert entries["liar:9000"]["request_digest"] == "cafe"
    R.audit.clear_quarantine_file(str(tmp_path), "liar:9000")
    assert set(W.audit.load_quarantine_file(str(tmp_path))) == {"10.0.0.1:50051"}
    raud = R.audit.OffloadAuditor(sampler=R.audit.AuditSampler(1.0, seed=0),
                                  dump_dir=str(tmp_path), start=False)
    assert set(raud.load_quarantined()) == {"10.0.0.1:50051"}
    raud.clear_quarantine("10.0.0.1:50051")
    assert W.audit.load_quarantine_file(str(tmp_path)) == {}
    raud.close()
    assert PORT.audit.load_quarantine_file(None) == {} == JAX.audit.load_quarantine_file(None)


@pytest.mark.parametrize("content", ["[]\n", "{ not json", '"x"', ""])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_damaged_quarantine_file_is_loud_and_kept(tmp_path, caplog, pkg, content):
    P = PACKAGES[pkg]
    (tmp_path / "quarantine.json").write_text(content)
    with caplog.at_level(logging.ERROR, logger="lodestar.offload.audit"):
        assert P.audit.load_quarantine_file(str(tmp_path)) == {}
    assert any("quarantine file unreadable" in r.message for r in caplog.records)
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                 dump_dir=str(tmp_path), start=False)
    aud._persist_quarantine("liar:9000", "deadbeef")
    aud.close()
    # the new record is written; the damaged original is moved aside, intact
    assert "liar:9000" in P.audit.load_quarantine_file(str(tmp_path))
    saved = [p for p in os.listdir(tmp_path) if p.startswith("quarantine.json.damaged-")]
    assert len(saved) == 1 and (tmp_path / saved[0]).read_text() == content


def test_remaining_cooloff_agrees():
    now = 1_000_000.0
    for entry in ({"at": now - 600}, {"at": now - 2000}, {}, {"at": now + 5}):
        for cool in (900.0, None, 0.5):
            assert PORT.audit.remaining_cooloff(entry, cool, now) == \
                JAX.audit.remaining_cooloff(entry, cool, now)
    assert PORT.audit.remaining_cooloff({"at": now - 600}, 900.0, now) == pytest.approx(300.0)
    assert PORT.audit.remaining_cooloff({"at": now - 2000}, 900.0, now) == 0.001


# -- the auditor ----------------------------------------------------------------------------


def test_auditor_picks_and_counts_agree():
    out = {}
    for P in (JAX, PORT):
        aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.5, seed=99),
                                     reference=_stub_reference(False))
        frame = _frame(P)
        picks = [aud.observe("ep", frame, 1, i % 3 == 0, P.PC(i % 5)) for i in range(64)]
        assert aud.drain()
        aud.close()
        out[P.name] = (picks, aud.sampled, aud.audited, aud.dropped,
                       aud.trust_value("ep"), len(aud.byzantine_events))
    assert out["port"] == out["jax"]
    picks, sampled, audited, dropped, _, _ = out["port"]
    assert sampled == audited == sum(picks) and dropped == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_false_verdicts_always_audited(pkg):
    P = PACKAGES[pkg]
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.0, seed=0),
                                 reference=_stub_reference(True))
    frame = _frame(P)
    assert not aud.observe("ep", frame, 1, True, P.PC.GOSSIP_BLOCK)
    assert aud.observe("ep", frame, 1, False, P.PC.BACKFILL)
    assert aud.drain()
    aud.close()
    assert aud.audited == 1 and len(aud.byzantine_events) == 1
    assert aud.byzantine_events[0]["claimed_verdict"] is False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_auditor_respects_cpu_budget(pkg):
    P = PACKAGES[pkg]
    work_s, budget, n = 0.01, 0.2, 10

    def burning_reference(sets, exclude_target):
        t0 = time.thread_time()
        while time.thread_time() - t0 < work_s:
            pass
        return False, None

    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                 reference=burning_reference, budget=budget, queue_max=64)
    frame = _frame(P)
    t0 = time.monotonic()
    for _ in range(n):
        assert aud.observe("ep", frame, 1, True, P.PC.GOSSIP_BLOCK)
    assert aud.drain(timeout_s=15.0)
    elapsed = time.monotonic() - t0
    aud.close()
    assert aud.audited == n
    assert elapsed >= (n - 1) * work_s / budget * 0.6, elapsed


@pytest.mark.parametrize("cap", ["records", "bytes"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_auditor_queue_caps_shed_without_blocking(pkg, cap):
    P = PACKAGES[pkg]
    gate = threading.Event()

    def blocked_reference(sets, exclude_target):
        gate.wait(timeout=10.0)
        return False, None

    frame = _frame(P, 4)
    kw = {"queue_max": 2} if cap == "records" else {"queue_max": 64,
                                                     "queue_max_bytes": 2 * len(frame)}
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                 reference=blocked_reference, **kw)
    t0 = time.monotonic()
    accepted = [aud.observe("ep", frame, 4, True, P.PC.GOSSIP_BLOCK) for _ in range(8)]
    assert time.monotonic() - t0 < 1.0  # never waited on the wedged worker
    assert accepted.count(False) >= 5 and aud.dropped >= 5
    assert aud._queue_bytes <= 2 * len(frame) or cap == "records"
    gate.set()
    assert aud.drain()
    aud.close()
    assert aud._queue_bytes == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_observe_never_blocks_the_verify(pkg):
    P = PACKAGES[pkg]

    def slow_reference(sets, exclude_target):
        time.sleep(0.3)
        return False, None

    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                 reference=slow_reference)
    r = Rig(P, P, ["A"], backend=lambda sets: False, auditor=aud)
    try:
        r.wait_probed()
        t0 = time.monotonic()
        assert r.verify(r.sets(), GOSSIP_BLOCK) is False
        assert time.monotonic() - t0 < 0.25
        assert aud.drain(timeout_s=5.0) and aud.audited == 1
        assert aud.audit_thread_names == {"offload-audit"}
    finally:
        r.close()


# -- the acceptance invariant: a lying helper -----------------------------------------------


def _lying_helper_run(P, S, dump_dir):
    """LIE_VERDICT on A (listed first, so ties route to it), the sets invalid
    (backend False, stub oracle False): every lie is True. Returns what is
    observed up to detection, after it, and after the operator lift."""
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(RATE, seed=0),
                                 reference=_stub_reference(False), dump_dir=dump_dir,
                                 quarantine_cooloff_s=None)
    r = Rig(P, S, backend=lambda sets: False, auditor=aud, probe_interval_s=0.05,
            rules=[_rule(P, "LIE_VERDICT", targets={"A"}, methods={"verify"})])
    horizon = P.audit.detection_horizon(RATE)
    try:
        r.wait_probed()
        verdicts, caught_at = [], None
        for i in range(horizon):
            verdicts.append(r.verify(r.sets(tag=i), GOSSIP_BLOCK))
            assert aud.drain()
            if r.client.endpoint_states()[0]["quarantined"]:
                caught_at = i + 1
                break
        assert caught_at is not None and caught_at <= horizon
        assert verdicts == [True] * caught_at  # the lie worked until detection
        st = {s["target"]: s for s in r.states()}
        assert st["A"]["quarantined"] and st["A"]["breaker"] == "open" and st["A"]["trust"] < 1
        dumps = [f for f in os.listdir(dump_dir) if f.startswith("byzantine_")]
        assert len(dumps) == 1
        dump = json.load(open(os.path.join(dump_dir, dumps[0])))
        assert (dump["claimed_verdict"], dump["recheck_verdict"], dump["endpoint"],
                dump["class"]) == (True, False, "A", "gossip_block")
        assert "A" in aud.load_quarantined()
        # probes keep answering for A (transport healthy), yet it stays out
        probes = r.inj.calls_to("A", "status")
        _wait(lambda: r.inj.calls_to("A", "status") >= probes + 2, what="two more probes")
        assert r.client.endpoint_states()[0]["quarantined"]
        after = r.verify(r.sets(tag=99), GOSSIP_BLOCK)
        assert after is False and r.rec.verifies()[-1][0] == "B"
        assert r.client.unquarantine_endpoint("A")
        assert "A" not in aud.load_quarantined()
        assert not r.client.endpoint_states()[0]["quarantined"]
        return {"verdicts": verdicts, "caught_at": caught_at, "after": after,
                "frames": r.rec.verifies(), "states": r.states(),
                "dump": {k: dump[k] for k in ("request_digest", "claimed_verdict",
                                              "recheck_verdict", "recheck_source",
                                              "arbiter_verdict", "class", "n_sets",
                                              "signature_sets", "sampled_index",
                                              "trust_score")}}
    finally:
        r.close()


@pytest.mark.parametrize("servers", ["jax", "port"])
def test_lying_helper_caught_quarantined_and_routed_around(tmp_path, servers):
    S = PACKAGES[servers]
    ref = _lying_helper_run(JAX, S, str(tmp_path / "jax"))
    got = _lying_helper_run(PORT, S, str(tmp_path / "port"))
    assert got == ref


@pytest.fixture(scope="module")
def tampered_set():
    from lodestar_tpu_torch.models import batch_verify as bv

    sets = bv.make_synthetic_sets(2, seed=9)
    return sets[0].pubkey, sets[0].message, sets[1].signature


def test_cpu_oracle_catches_a_lie_about_a_real_set(tmp_path, tampered_set):
    """The default reference, the port's own oracle, re-verifies a real
    tampered set the liar called True; then a valid set is served through
    the degradation chain by the honest sibling."""
    from lodestar_tpu_torch.models import batch_verify as bv

    out = {}
    for P, bls in ((JAX, j_bls), (PORT, t_bls)):
        aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                     dump_dir=str(tmp_path / P.name))
        r = Rig(P, P, backend=P.api.verify_signature_sets, auditor=aud,
                rules=[_rule(P, "LIE_VERDICT", targets={"A"}, methods={"verify"})])
        deg = bls.DegradingBlsVerifier([("offload", r.client),
                                        ("cpu", bls.BlsSingleThreadVerifier())])
        try:
            r.wait_probed()
            bad = [P.api.SignatureSet(*tampered_set)]
            lied = asyncio.run(deg.verify_signature_sets(bad, r.opts(GOSSIP_ATT)))
            assert aud.drain(timeout_s=30.0)
            assert lied is True and len(aud.byzantine_events) == 1
            assert r.client.endpoint_states()[0]["quarantined"]
            good = [P.api.SignatureSet(s.pubkey, s.message, s.signature)
                    for s in bv.make_synthetic_sets(1, seed=9)]
            valid = asyncio.run(deg.verify_signature_sets(good, r.opts(GOSSIP_ATT)))
            assert valid is True and deg.last_layer == "offload"
            assert r.rec.verifies()[-1][0] == "B"
            out[P.name] = (lied, valid, aud.byzantine_events[0]["recheck_source"],
                           r.rec.verifies())
        finally:
            asyncio.run(deg.close())
            for s in r.servers.values():
                s.stop()
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cross_helper_reference_arbitrates_a_lying_reference(pkg):
    P = PACKAGES[pkg]
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                 arbiter=lambda sets: False)
    r = Rig(P, P, connect=False)
    r.servers["B"] = P.srv.BlsOffloadServer(lambda sets: True)  # lies: True for garbage
    r.servers["A"] = P.srv.BlsOffloadServer(lambda sets: False)  # honest here
    r.connect(probe_interval_s=3600.0, auditor=aud)
    aud.set_reference(P.audit.cross_helper_reference(r.client))
    try:
        r.wait_probed()
        assert aud.observe("A", _frame(P), 1, False, P.PC.GOSSIP_BLOCK)
        assert aud.drain()
        assert [e["endpoint"] for e in aud.byzantine_events] == ["B"]
        assert aud.trust_value("B") < 1.0 and aud.trust_value("A") == 1.0
        st = {s["target"]: s for s in r.states()}
        assert st["B"]["quarantined"] and not st["A"]["quarantined"]
        assert r.rec.verifies()[0][0] == "B"  # the audit RPC went to the sibling
    finally:
        r.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_persisted_quarantine_reapplied_and_lifted(tmp_path, pkg):
    P = PACKAGES[pkg]
    seed_aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(1.0, seed=0),
                                      dump_dir=str(tmp_path), start=False)
    seed_aud._persist_quarantine("A", "deadbeef")
    seed_aud.close()
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.1, seed=0),
                                 dump_dir=str(tmp_path))
    r = Rig(P, P, ["A"], backend=lambda sets: False, auditor=aud)
    try:
        for target in aud.load_quarantined():
            r.client.quarantine_endpoint(target, reason="persisted_byzantine")
        assert r.client.endpoint_states()[0]["quarantined"] and r.client.is_down()
        r.client.unquarantine_endpoint("A")
        assert not r.client.endpoint_states()[0]["quarantined"]
        assert aud.load_quarantined() == {}
    finally:
        r.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_quarantine_gauge_and_file_converge_after_cooloff(tmp_path, pkg):
    P = PACKAGES[pkg]
    metrics = Metrics()
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.0, seed=0),
                                 reference=_stub_reference(False), metrics=metrics,
                                 dump_dir=str(tmp_path))
    aud._persist_quarantine("A", "deadbeef")
    r = Rig(P, P, ["A"], backend=lambda sets: False, auditor=aud, probe_interval_s=0.1)
    try:
        r.client.quarantine_endpoint("A", cooloff_s=0.2, reason="test")
        assert metrics.quarantined.labels("A").value == 1
        assert "A" in aud.load_quarantined()
        _wait(lambda: not r.client.endpoint_states()[0]["quarantined"],
              what="the 0.2 s cool-off elapsing")
        assert r.verify(r.sets(), GOSSIP_BLOCK) is False  # the half-open trial
        _wait(lambda: metrics.quarantined.labels("A").value == 0
              and "A" not in aud.load_quarantined(), timeout_s=5.0,
              what="the gauge and the file converging")
        assert r.client.endpoint_states()[0]["breaker"] == "closed"
    finally:
        r.close()


# -- the fault injector ---------------------------------------------------------------------


def _both(fn):
    return {P.name: fn(P) for P in (JAX, PORT)}


def test_rule_windows_agree():
    def windows(P):
        r = _rule(P, "UNAVAILABLE", first_call=2, last_call=3, targets={"a"},
                  methods={"verify"})
        return [r.matches(t, m, i) for t in "ab" for m in ("verify", "status")
                for i in range(6)]

    got = _both(windows)
    assert got["port"] == got["jax"]
    assert {k.value for k in PORT.faults.FaultKind} == {k.value for k in JAX.faults.FaultKind}


PROB_RULES = (
    ("UNAVAILABLE", {"probability": 0.3, "methods": {"verify"}}),
    ("LATENCY", {"probability": 0.5, "delay_s": 0.25, "targets": {"b"}}),
    ("DEADLINE", {"first_call": 4, "last_call": 9, "probability": 0.5}),
    ("ERROR_FRAME", {"first_call": 20}),
)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_seed_same_schedule_and_replay(seed):
    calls = [(t, m) for i in range(40) for t, m in (("a", "verify"), ("b", "verify"),
                                                     ("b", "status"))]

    def run(P):
        inj = P.faults.FaultInjector([_rule(P, k, **dict(kw)) for k, kw in PROB_RULES],
                                     seed=seed)
        decisions = [inj._next_fault(t, m) for t, m in calls[:60]]
        inj.partition("a")
        decisions += [inj._next_fault(t, m) for t, m in calls[60:80]]
        inj.heal("*")
        decisions += [inj._next_fault(t, m) for t, m in calls[80:]]
        trace = json.loads(json.dumps(inj.export_trace()))
        replay = P.faults.FaultInjector.from_trace(trace)
        replayed = [replay._next_fault(t, m)[0] for t, m in calls]
        return ([(k and k.value, idx) for k, _r, idx in decisions], inj.schedule(), trace,
                [k and k.value for k in replayed], replay.schedule(),
                {k.value: v for k, v in inj.injected.items()})

    got = _both(run)
    assert got["port"] == got["jax"]
    decisions, schedule, trace, replayed, replay_schedule, _ = got["port"]
    # the replay fires the recorded schedule exactly (the partition included,
    # pinned as its edge's calls), with no probabilistic draw
    assert replay_schedule == schedule and trace["seed"] == seed
    assert replayed == [k for k, _ in decisions]


@pytest.mark.parametrize("seed", [1, 7, 99])
def test_corruption_flip_and_lie_bytes_agree(seed):
    def run(P):
        req = _frame(P, 2)
        out = []
        for data in (P.off.encode_verdict(False, request=req), P.off.encode_verdict(True),
                     P.off.encode_verdict(None, error="boom"), b"\x01"):
            inj = P.faults.FaultInjector(seed=seed)
            out.append([inj._corrupt(data) for _ in range(4)])
            out.append(P.faults._flip_verdict_byte(data))
            out.append(P.faults._lie_verdict(data, req))
        lied = P.faults._lie_verdict(P.off.encode_verdict(False, request=req), req)
        assert P.off.decode_verdict(lied, request=req, require_digest=True) is True
        return out

    got = _both(run)
    assert got["port"] == got["jax"]


def test_partition_heal_and_backend_seam():
    def run(P):
        inj = P.faults.FaultInjector([_rule(P, "ERROR_FRAME", methods={"backend"},
                                            first_call=0, last_call=0)])
        seen = [inj._next_fault("a", "verify")[0]]
        inj.partition("a")
        seen += [inj._next_fault("a", "verify")[0], inj._next_fault("b", "verify")[0]]
        inj.partition("*")
        seen.append(inj._next_fault("b", "verify")[0])
        inj.heal("*")
        seen.append(inj._next_fault("a", "verify")[0])
        backend = inj.wrap_backend(lambda sets: True)
        with pytest.raises(RuntimeError, match="injected backend fault"):
            backend([])
        seen.append(backend([]))
        bad = P.faults.FaultInjector([_rule(P, "FLIP_VERDICT", methods={"backend"})])
        with pytest.raises(ValueError, match="transport fault"):
            bad.wrap_backend(lambda sets: True)
        return [k.value if hasattr(k, "value") else k for k in seen], inj.calls_to("a")

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [None, "partition", None, "partition", None, True]


def test_latency_rides_the_sim_clock():
    def run(P):
        clock = (t_clock if P is PORT else j_clock).SimClock()
        inj = P.faults.FaultInjector(
            [_rule(P, "LATENCY", delay_s=0.3, first_call=0, last_call=0),
             _rule(P, "LATENCY", delay_s=5.0, first_call=1, last_call=1),
             _rule(P, "DEADLINE", delay_s=0.7, first_call=2, last_call=2)],
            sleep_fn=clock.sleep)
        class Plain:
            def __call__(self, req, timeout=None):
                return b"\x01"

            def with_call(self, req, timeout=None):
                return b"\x01", "call"

        stub = inj.wrap_transport("a", "verify", Plain())
        out = [stub(b"x", timeout=1.0)]
        for _ in range(2):
            try:
                stub(b"x", timeout=1.0)
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, str(e.code()), e.details()))
        out.append(stub.with_call(b"x", timeout=1.0))
        return out, clock.monotonic()

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1] == pytest.approx(0.3 + 1.0 + 0.7)


@pytest.mark.parametrize("servers", ["jax", "port"])
def test_chaos_invariant_no_fault_yields_true_for_invalid_sets(servers):
    """No injected fault class turns an invalid set True: every outcome is
    False or an error, and every class fired."""
    windows = [("LATENCY", {"delay_s": 0.02}), ("DEADLINE", {}), ("UNAVAILABLE", {}),
               ("RESET", {}), ("ERROR_FRAME", {}), ("CORRUPT_VERDICT", {}),
               ("FLIP_VERDICT", {})]

    def run(P):
        rules = [_rule(P, k, first_call=2 * i, last_call=2 * i + 1, methods={"verify"}, **kw)
                 for i, (k, kw) in enumerate(windows)]
        r = Rig(P, PACKAGES[servers], ["A"], backend=lambda sets: False, rules=rules,
                seed=1234, timeout_s=1.0, breaker_threshold=100)
        try:
            r.wait_probed()
            outcomes = [r.outcome(r.sets(2)) for _ in range(18)]
            assert all(o is False or isinstance(o, tuple) for o in outcomes)
            for k, _ in windows:
                assert r.inj.injected[getattr(P.faults.FaultKind, k)] >= 1, k
            return outcomes
        finally:
            r.close()

    got = _both(run)
    assert got["port"] == got["jax"]
    assert False in got["port"] and any(isinstance(o, tuple) for o in got["port"])


# -- SimClock and the breaker on it ---------------------------------------------------------


def test_sim_clock_agrees():
    def run(mod):
        c = mod.SimClock(start=5.0)
        out = [c.time(), c.monotonic(), c.monotonic_ns()]
        out += [c.advance(1.25), c.advance(-3.0), c.advance_to(2.0), c.advance_to(10.5)]
        c.sleep(0.5)
        out += [c.time(), c.monotonic_ns(), repr(c)]
        return out

    assert run(t_clock) == run(j_clock)
    assert t_testing.SimClock is t_clock.SimClock
    assert sorted(t_testing.__all__) == ["FaultInjector", "FaultKind", "FaultRule", "SimClock"]


def _breaker_script(P, clock_mod):
    clock = clock_mod.SimClock(start=100.0)
    transitions = []
    b = P.res.CircuitBreaker(failure_threshold=3, reset_timeout_s=2.0, max_reset_timeout_s=8.0,
                             jitter=0.0, clock=clock.monotonic,
                             on_transition=lambda o, n: transitions.append((o.label, n.label)))
    log = []

    def snap(tag):
        log.append((tag, b.state().label, b.is_open, b.is_quarantined,
                    round(b.seconds_until_trial(), 9)))

    # quarantine survives probe release and stale successes until the cool-off
    b.quarantine(30.0)
    snap("quarantined")
    b.note_probe_success()
    log.append(("acquire_while_quarantined", b.try_acquire()))
    b.record_success(1)
    snap("stale_success")
    clock.advance(31.0)
    snap("cooloff_elapsed")
    tok = b.try_acquire()
    log.append(("trial", tok))
    b.record_success(tok)
    snap("trial_passed")
    # failures open; a probe success releases the open-wait early
    for _ in range(3):
        b.record_failure()
    snap("opened")
    log.append(("acquire_while_open", b.try_acquire()))
    b.note_probe_success()
    tok = b.try_acquire()
    log.append(("released_trial", tok))
    b.record_failure(tok)
    snap("trial_failed")
    clock.advance(4.0)
    snap("second_window")
    # indefinite quarantine: only unquarantine lifts it, into a trial
    b.quarantine(None)
    clock.advance(1e9)
    snap("indefinite")
    b.note_probe_success()
    log.append(("acquire_indefinite", b.try_acquire()))
    b.unquarantine()
    snap("lifted")
    tok = b.try_acquire()
    log.append(("lift_trial", tok))
    b.record_failure(tok)
    snap("lift_trial_failed")
    b.unquarantine()  # not quarantined: a no-op
    snap("noop_lift")
    # a plain failure era replaces a quarantine
    b.quarantine(50.0)
    clock.advance(60.0)
    b.record_failure()
    snap("failure_after_cooloff")
    return log, transitions


def test_breaker_quarantine_and_probe_release_agree():
    got, ref = _breaker_script(PORT, t_clock), _breaker_script(JAX, j_clock)
    assert got == ref
    log = dict((entry[0], entry[1:]) for entry in got[0])
    assert log["quarantined"] == ("open", True, True, 30.0)
    assert log["acquire_while_quarantined"] == (None,)
    assert log["trial_passed"][0] == "closed"
    assert log["released_trial"][0] is not None
    assert log["lifted"] == ("open", False, False, 0.0)


def test_pool_lanes_keep_the_tokenless_path():
    """The lanes gate on `is_open` alone and record tokenless outcomes: the
    window rule is unchanged by the quarantine state added for the client."""

    def run(P, clock_mod):
        clock = clock_mod.SimClock(start=0.0)
        b = P.res.CircuitBreaker(failure_threshold=2, reset_timeout_s=1.0, jitter=0.0,
                                 clock=clock.monotonic)
        out = []
        for step in ("f", "f", "s", "+2", "f", "+1", "s", "f", "f", "+10", "f"):
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            else:
                clock.advance(float(step))
            out.append((b.state().label, b.is_open, b.is_quarantined))
        return out

    assert run(PORT, t_clock) == run(JAX, j_clock)
