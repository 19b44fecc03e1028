"""The port's offload client against the JAX package's, on the CPU.

Every scenario runs once with each package's client (`BlsOffloadClient`,
its `FaultInjector`, breaker, auditor) against servers of one package
(parametrised: the JAX package's and the port's `BlsOffloadServer`),
in-process through that client package's `local_transports`, and the two
runs must observe the same thing: the request frames each endpoint was
sent (bytes-equal, tenant trailer included), the verdicts or errors, the
endpoint each call went to, the hedge / hedge-win / failover / shed
counts and the breaker states. The scenarios are those of
`tests/offload/test_offload.py`, `test_resilience.py`, `test_hedge.py`,
the routing half of `test_mesh_status.py` and `test_probe_reconnect.py`;
each also asserts what its JAX test asserts.

Waits poll a condition against a deadline; no fixed sleep is shorter than
the schedule it waits out (the JAX `test_no_reconnect_while_verifications_
outstanding` sleeps 0.6 s for a second probe due 0.5 s after the first plus
a dial, a race this file does not copy).

Beyond the scenarios: the port's client against the JAX server over a real
gRPC socket on 127.0.0.1, remote spans grafted through the port's client,
and, in a subprocess where grpc cannot be imported, the port's client
serving a verdict in-process while a dialed target raises the ImportError.

Tolerance: none (equal bytes, equal verdicts, equal counts). Backends are
`lambda sets: <verdict>` on wire-shaped sets, or a package's CPU oracle on
at most three real sets (the port's `make_synthetic_sets`).
"""

from __future__ import annotations

import asyncio
import pathlib
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

import lodestar_tpu.chain.bls.interface as j_iface
import lodestar_tpu.crypto.bls.api as j_api
import lodestar_tpu.offload as j_off
import lodestar_tpu.offload.audit as j_audit
import lodestar_tpu.offload.client as j_client
import lodestar_tpu.offload.resilience as j_res
import lodestar_tpu.offload.server as j_srv
import lodestar_tpu.scheduler as j_sched
import lodestar_tpu.testing.faults as j_faults
import lodestar_tpu.tracing as j_tr
import lodestar_tpu_torch.chain.bls.interface as t_iface
import lodestar_tpu_torch.crypto.bls.api as t_api
import lodestar_tpu_torch.offload as t_off
import lodestar_tpu_torch.offload.audit as t_audit
import lodestar_tpu_torch.offload.client as t_client
import lodestar_tpu_torch.offload.resilience as t_res
import lodestar_tpu_torch.offload.server as t_srv
import lodestar_tpu_torch.scheduler as t_sched
import lodestar_tpu_torch.testing.faults as t_faults
import lodestar_tpu_torch.tracing as t_tr

REPO = pathlib.Path(__file__).resolve().parent.parent

JAX = SimpleNamespace(name="jax", client=j_client, srv=j_srv, off=j_off, faults=j_faults,
                      res=j_res, audit=j_audit, api=j_api, Opts=j_iface.VerifySignatureOpts,
                      PC=j_sched.PriorityClass, tr=j_tr)
PORT = SimpleNamespace(name="port", client=t_client, srv=t_srv, off=t_off, faults=t_faults,
                       res=t_res, audit=t_audit, api=t_api, Opts=t_iface.VerifySignatureOpts,
                       PC=t_sched.PriorityClass, tr=t_tr)
PACKAGES = {"jax": JAX, "port": PORT}

GOSSIP_BLOCK, GOSSIP_ATT, API, RANGE_SYNC, BACKFILL = 0, 1, 2, 3, 4


def _wait(pred, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} never held within {timeout_s} s")
        time.sleep(0.005)


# -- shared harness -------------------------------------------------------------------


class _Cell:
    def __init__(self):
        self.value = 0.0

    def inc(self, v=1):
        self.value += v

    def set(self, v):
        self.value = v


class _Family:
    def __init__(self):
        self.cells = {}

    def labels(self, *key):
        return self.cells.setdefault(tuple(str(k) for k in key), _Cell())

    def inc(self, v=1):  # an unlabelled family (the auditor's cpu_seconds)
        self.labels().inc(v)

    def set(self, v):  # an unlabelled gauge (the auditor's queue_depth)
        self.labels().set(v)

    def total(self):
        return sum(c.value for c in self.cells.values())


class Metrics:
    """Autovivifying duck-typed resilience metrics, the same object shape for
    both clients."""

    def __init__(self):
        object.__setattr__(self, "_families", {})

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._families.setdefault(name, _Family())

    def total(self, name):
        f = self._families.get(name)
        return f.total() if f is not None else 0.0

    def snapshot(self):
        return {n: {"|".join(k): c.value for k, c in sorted(f.cells.items())}
                for n, f in sorted(self._families.items())}


class Recorder:
    """Outermost transport wrapper: logs every stub call the client makes
    (target, method, request bytes) in front of the fault injector and the
    in-process dispatch."""

    def __init__(self, inj=None):
        self.inj = inj
        self.calls = []
        self._lock = threading.Lock()

    def wrap(self, target, method, fn):
        inner = self.inj.wrap_transport(target, method, fn) if self.inj is not None else fn
        rec = self

        class _Rec:
            def __call__(self, request, timeout=None, metadata=None):
                rec._log(target, method, request)
                return inner(request, timeout=timeout, metadata=metadata)

            def with_call(self, request, timeout=None, metadata=None):
                rec._log(target, method, request)
                return inner.with_call(request, timeout=timeout, metadata=metadata)

        return _Rec()

    def _log(self, target, method, request):
        with self._lock:
            self.calls.append((target, method, bytes(request)))

    def verifies(self):
        with self._lock:
            return [(t, r) for t, m, r in self.calls if m == "verify"]


def dummy_sets(P, n=1, tag=0):
    """Wire-shaped sets of package P (not real signatures)."""
    return [P.api.SignatureSet(pubkey=bytes([1, tag, i % 256]) + bytes(45),
                               message=bytes([2, tag, i % 256]) * 8 + bytes(8),
                               signature=bytes([3, tag, i % 256]) + bytes(93))
            for i in range(n)]


class Rig:
    """One client package against in-process servers of one server package."""

    def __init__(self, P, S, targets=("A", "B"), *, backend=lambda sets: True, rules=(),
                 seed=0, server_kw=None, connect=True, metrics=True, **client_kw):
        self.P, self.S = P, S
        self.targets = list(targets)
        self.servers = {t: S.srv.BlsOffloadServer(backend, **(server_kw or {}))
                        for t in self.targets}
        self.inj = P.faults.FaultInjector(list(rules), seed=seed)
        self.rec = Recorder(self.inj)
        self.metrics = Metrics() if metrics else None
        client_kw.setdefault("probe_interval_s", 3600.0)
        self.client = None
        if connect:
            self.connect(**client_kw)

    def connect(self, servers=None, **client_kw):
        wrapper = self.P.srv.local_transports(self.servers if servers is None else servers,
                                              wrap=self.rec.wrap)
        self.client = self.P.client.BlsOffloadClient(
            self.targets if len(self.targets) > 1 else self.targets[0],
            transport_wrapper=wrapper, metrics=self.metrics, **client_kw)
        return self.client

    def wait_probed(self):
        _wait(lambda: all(s["extended"] for s in self.client.endpoint_states()),
              what="the startup probe")

    def sets(self, n=1, tag=0):
        return dummy_sets(self.P, n, tag)

    def opts(self, priority):
        return self.P.Opts(priority=int(priority))

    def verify(self, sets, priority=None):
        opts = None if priority is None else self.opts(priority)
        return asyncio.run(self.client.verify_signature_sets(sets, opts))

    def outcome(self, sets, priority=None):
        try:
            return self.verify(sets, priority)
        except Exception as e:  # noqa: BLE001 — the error's kind is the observation
            return _error(e)

    def states(self):
        keep = ("target", "healthy", "breaker", "quarantined", "trust", "admission",
                "capacity", "chips_wedged", "tenant_capable", "outstanding")
        return [{k: s[k] for k in keep} for s in self.client.endpoint_states()]

    def counts(self):
        m = self.metrics
        return {n: m.total(n) for n in ("routed", "hedges", "hedge_wins", "failovers", "shed")}

    def close(self):
        if self.client is not None:
            asyncio.run(self.client.close())
        for s in self.servers.values():
            s.stop()


def _error(e):
    """An exception as an observation both packages can produce equally."""
    kind = type(e).__name__
    if kind in ("OffloadShed", "OffloadError"):
        return (kind, str(e))
    return (kind,)


def _ep(client, target):
    return next(ep for ep in client._endpoints if ep.target == target)


def _set_ep(client, target, **fields):
    with client._lock:
        for k, v in fields.items():
            setattr(_ep(client, target), k, v)


def _rule(P, kind, **kw):
    for key in ("targets", "methods"):
        if key in kw:
            kw[key] = frozenset(kw[key])
    return P.faults.FaultRule(getattr(P.faults.FaultKind, kind), **kw)


# -- scenarios: each returns what both packages must observe equally --------------


def sc_roundtrip_and_tenant_trailer(P, S, real):
    """test_offload: real sets through the oracle, True then False, with the
    tenant trailer once the server advertised it (frames carry it)."""
    r = Rig(P, S, ["A"], backend=S.api.verify_signature_sets, tenant="node-a")
    try:
        r.wait_probed()
        sets = [P.api.SignatureSet(s.pubkey, s.message, s.signature) for s in real[:2]]
        swapped = [P.api.SignatureSet(sets[0].pubkey, sets[0].message, sets[1].signature),
                   P.api.SignatureSet(sets[1].pubkey, sets[1].message, sets[0].signature)]
        out = [r.verify(sets, GOSSIP_ATT), r.verify(swapped)]
        assert out == [True, False]
        assert r.client.can_accept_work() and not r.client.is_down()
        assert r.servers["A"].tenancy.served == {"node-a": 2}
        frames = r.rec.verifies()
        assert frames[0][1] == P.off.encode_sets(sets, tenant="node-a", priority=GOSSIP_ATT)
        assert frames[1][1] == P.off.encode_sets(swapped, tenant="node-a", priority=API)
        return {"out": out, "frames": frames, "states": r.states()}
    finally:
        r.close()


def sc_legacy_frame_before_capability(P, S, real):
    """No probe has landed yet (it is faulted): the tenant trailer is not
    sent, so the server sees the bit-exact legacy frame."""
    r = Rig(P, S, ["A"], tenant="node-a",
            rules=[_rule(P, "UNAVAILABLE", methods={"status"})])
    try:
        _wait(lambda: r.inj.calls_to("A", "status") >= 1, what="the startup probe")
        out = r.verify(r.sets(2))
        assert out is True
        assert r.rec.verifies()[0][1] == P.off.encode_sets(r.sets(2))
        assert r.servers["A"].tenancy.served == {"default": 1}
        return {"out": out, "frames": r.rec.verifies()}
    finally:
        r.close()


def sc_server_error_fails_closed(P, S, real):
    """test_offload: a backend that raises answers error frames; the client
    raises OffloadError, never a verdict; a server refusing work makes the
    client refuse too."""

    def exploding(sets):
        raise RuntimeError("device on fire")

    r = Rig(P, S, ["A"], backend=exploding, server_kw={"can_accept_work": lambda: False})
    try:
        r.wait_probed()
        with pytest.raises(P.off.OffloadError, match="device on fire"):
            r.verify(r.sets(1))
        assert not r.client.can_accept_work()  # the server's admission says no
        return {"states": r.states(), "frames": r.rec.verifies()}
    finally:
        r.close()


def sc_breaker_open_endpoint_skipped(P, S, real):
    """test_resilience: gray failure (error frames, transport fine) on A,
    threshold 2: A dialed twice, then skipped without dialing; every call
    hedges to B and is True."""
    r = Rig(P, S, rules=[_rule(P, "ERROR_FRAME", targets={"A"}, methods={"verify"})],
            breaker_threshold=2)
    try:
        r.wait_probed()
        out = [r.verify(r.sets(), GOSSIP_BLOCK) for _ in range(4)]
        assert out == [True] * 4
        assert r.inj.calls_to("A", "verify") == 2
        st = {s["target"]: s for s in r.states()}
        assert st["A"]["breaker"] == "open" and st["A"]["healthy"]
        assert st["B"]["breaker"] == "closed"
        c = r.counts()
        assert c["failovers"] == 2 and c["hedges"] == 2 and c["hedge_wins"] == 2
        assert r.metrics.breaker_state.labels("A").value == 2
        return {"out": out, "frames": r.rec.verifies(), "states": r.states(), "counts": c,
                "metrics": r.metrics.snapshot()}
    finally:
        r.close()


def sc_all_breakers_open_fail_fast(P, S, real):
    """test_resilience: every call UNAVAILABLE, threshold 1: two failing
    calls open both breakers; the third raises without dialing."""
    r = Rig(P, S, rules=[_rule(P, "UNAVAILABLE")], breaker_threshold=1, breaker_reset_s=60.0)
    try:
        _wait(lambda: r.inj.calls_to("B", "status") >= 1, what="the startup probes")
        first = [r.outcome(r.sets(), GOSSIP_BLOCK) for _ in range(2)]
        assert all(o[0] == "OffloadError" for o in first)
        assert all(s["breaker"] == "open" for s in r.states())
        dialed = len(r.rec.verifies())
        t0 = time.monotonic()
        third = r.outcome(r.sets(), GOSSIP_BLOCK)
        assert third[0] == "OffloadError" and "breakers open" in third[1]
        assert time.monotonic() - t0 < 0.5 and len(r.rec.verifies()) == dialed
        assert not r.client.can_accept_work() and r.client.is_down()
        return {"out": first + [third], "frames": r.rec.verifies(), "states": r.states()}
    finally:
        r.close()


def sc_latency_past_class_deadline_hedges(P, S, real):
    """test_resilience: A blows the 0.3 s gossip-block budget (the injector
    raises DEADLINE_EXCEEDED at the attempt's 0.15 s share); the hedge to B
    answers inside it."""
    r = Rig(P, S, rules=[_rule(P, "LATENCY", delay_s=5.0, targets={"A"}, methods={"verify"})],
            class_deadlines={P.PC.GOSSIP_BLOCK: 0.3})
    try:
        r.wait_probed()
        t0 = time.monotonic()
        out = r.verify(r.sets(), GOSSIP_BLOCK)
        assert out is True and time.monotonic() - t0 < 2.0
        assert r.inj.calls_to("B", "verify") == 1
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts()}
    finally:
        r.close()


def sc_bulk_class_does_not_hedge(P, S, real):
    r = Rig(P, S, rules=[_rule(P, "UNAVAILABLE", targets={"A"}, methods={"verify"})])
    try:
        r.wait_probed()
        out = r.outcome(r.sets(), BACKFILL)
        assert out == ("OffloadError", "offload transport: StatusCode.UNAVAILABLE")
        assert r.inj.calls_to("B", "verify") == 0
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts()}
    finally:
        r.close()


def sc_recovered_endpoint_readopted(P, S, real):
    """test_resilience: A fails twice (error frames) and opens; after its
    0.05 s reset delay a first-attempt gossip call is spent as its half-open
    trial, which re-closes it while B stays closed."""
    r = Rig(P, S, rules=[_rule(P, "ERROR_FRAME", targets={"A"}, methods={"verify"},
                               first_call=0, last_call=1)],
            breaker_threshold=2, breaker_reset_s=0.05)
    try:
        r.wait_probed()
        out = [r.verify(r.sets(), GOSSIP_BLOCK) for _ in range(2)]
        mid = r.states()
        assert {s["target"]: s["breaker"] for s in mid}["A"] == "open"
        time.sleep(0.1)  # the reset delay (0.05 s, jitter 10%) elapses
        out.append(r.verify(r.sets(), GOSSIP_BLOCK))
        assert out == [True] * 3
        assert {s["target"]: s["breaker"] for s in r.states()}["A"] == "closed"
        assert r.inj.calls_to("A", "verify") == 3
        return {"out": out, "mid": mid, "states": r.states(), "frames": r.rec.verifies()}
    finally:
        r.close()


def sc_half_open_trial_recloses(P, S, real):
    r = Rig(P, S, ["A"], rules=[_rule(P, "UNAVAILABLE", methods={"verify"},
                                      first_call=0, last_call=1)],
            breaker_threshold=2, breaker_reset_s=0.05)
    try:
        r.wait_probed()
        first = [r.outcome(r.sets()) for _ in range(2)]
        assert all(o[0] == "OffloadError" for o in first)
        assert r.states()[0]["breaker"] == "open"
        time.sleep(0.1)  # the reset delay elapses; the fault window is over
        last = r.verify(r.sets())
        assert last is True and r.states()[0]["breaker"] == "closed"
        return {"out": first + [last], "states": r.states()}
    finally:
        r.close()


def sc_shed_fails_over_without_charging(P, S, real):
    """A tenant quota shed on A: the job fails over to B (any class), the
    shed is counted and A's breaker records success, not failure."""
    r = Rig(P, S, tenant="t")
    try:
        r.wait_probed()
        a = S.srv.BlsOffloadServer(lambda sets: True, tenant_shed_depth=0,
                                   tenant_reject_depth=0)
        r.servers["A"].stop()
        r.servers["A"] = a
        asyncio.run(r.client.close())
        r.connect(probe_interval_s=3600.0, tenant="t")
        r.wait_probed()
        out = r.verify(r.sets(), BACKFILL)
        assert out is True
        assert r.counts()["shed"] == 1 and r.counts()["failovers"] == 0
        assert a.tenancy.shed == {"t": 1} and r.servers["B"].tenancy.served == {"t": 1}
        assert all(s["breaker"] == "closed" for s in r.states())
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts(),
                "states": r.states()}
    finally:
        r.close()


# test_hedge: the concurrent hedge (`hedge_delay_ms`)


def sc_hedge_fires_past_delay_and_wins(P, S, real):
    r = Rig(P, S, rules=[_rule(P, "LATENCY", delay_s=0.4, targets={"A"}, methods={"verify"})],
            hedge_delay_ms=40.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), GOSSIP_BLOCK)
        assert out is True
        c = r.counts()
        assert (c["hedges"], c["hedge_wins"], c["failovers"]) == (1, 1, 0)
        assert r.inj.calls_to("A", "verify") == 1 and r.inj.calls_to("B", "verify") == 1
        _wait(lambda: r.client._outstanding == 0, what="the loser settling")
        return {"out": out, "frames": sorted(r.rec.verifies()), "counts": c}
    finally:
        r.close()


def sc_no_hedge_when_primary_fast(P, S, real):
    r = Rig(P, S, hedge_delay_ms=200.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = [r.verify(r.sets(2), GOSSIP_BLOCK) for _ in range(3)]
        assert out == [True] * 3 and r.counts()["hedges"] == 0
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts()}
    finally:
        r.close()


def sc_loser_discarded_counters_settle(P, S, real):
    r = Rig(P, S, rules=[_rule(P, "LATENCY", delay_s=0.3, targets={"A"}, methods={"verify"})],
            hedge_delay_ms=40.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), GOSSIP_BLOCK)
        assert out is True
        _wait(lambda: r.client._outstanding == 0, what="the loser settling")
        assert all(ep.outstanding == 0 for ep in r.client._endpoints)
        assert r.counts()["hedges"] == 1
        return {"out": out, "counts": r.counts(), "states": r.states()}
    finally:
        r.close()


def sc_primary_error_is_failover_not_hedge(P, S, real):
    r = Rig(P, S, rules=[_rule(P, "UNAVAILABLE", first_call=0, last_call=0, targets={"A"},
                               methods={"verify"})],
            hedge_delay_ms=40.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), GOSSIP_BLOCK)
        c = r.counts()
        assert out is True and (c["failovers"], c["hedges"], c["hedge_wins"]) == (1, 0, 0)
        return {"out": out, "frames": r.rec.verifies(), "counts": c, "states": r.states()}
    finally:
        r.close()


def sc_bulk_class_never_hedges(P, S, real):
    r = Rig(P, S, rules=[_rule(P, "LATENCY", delay_s=0.2, targets={"A"}, methods={"verify"})],
            hedge_delay_ms=40.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), RANGE_SYNC)
        assert out is True and r.counts()["hedges"] == 0
        assert r.inj.calls_to("B", "verify") == 0
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts()}
    finally:
        r.close()


def sc_single_endpoint_cannot_hedge(P, S, real):
    r = Rig(P, S, ["A"], hedge_delay_ms=40.0, timeout_s=5.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), GOSSIP_BLOCK)
        assert out is True and r.counts()["hedges"] == 0
        return {"out": out, "counts": r.counts()}
    finally:
        r.close()


def sc_sequential_path_without_delay(P, S, real):
    """hedge_delay_ms=None: the first attempt's share of a 1 s budget runs
    out on A (the injector raises DEADLINE_EXCEEDED at 0.5 s), then B."""
    r = Rig(P, S, rules=[_rule(P, "LATENCY", delay_s=6.0, targets={"A"}, methods={"verify"})],
            timeout_s=1.0)
    try:
        r.wait_probed()
        out = r.verify(r.sets(2), GOSSIP_BLOCK)
        assert out is True and r.inj.calls_to("B", "verify") == 1
        assert r.counts()["failovers"] == 1
        return {"out": out, "frames": r.rec.verifies(), "counts": r.counts()}
    finally:
        r.close()


def sc_negative_hedge_delay_rejected(P, S, real):
    r = Rig(P, S, connect=False)
    try:
        with pytest.raises(ValueError, match="hedge_delay_ms"):
            r.connect(hedge_delay_ms=-1.0, probe_interval_s=3600.0)
        return {"raised": True}
    finally:
        r.close()


# test_mesh_status: the routing half


def sc_mixed_version_routing(P, S, real):
    r = Rig(P, S)
    try:
        r.wait_probed()
        _set_ep(r.client, "A", occupancy_permille=300, capacity=8)
        _set_ep(r.client, "B", occupancy_permille=200, capacity=1)
        out = [r.verify(r.sets(2, tag=i), GOSSIP_ATT) for i in range(3)]
        assert r.inj.calls_to("B", "verify") == 3  # least occupied wins
        _set_ep(r.client, "A", occupancy_permille=100)
        out += [r.verify(r.sets(2, tag=i), GOSSIP_ATT) for i in range(2)]
        assert r.inj.calls_to("A", "verify") == 2
        return {"out": out, "frames": r.rec.verifies()}
    finally:
        r.close()


def sc_quarantined_chip_drops_capacity(P, S, real):
    chips = [[(100, False), (150, False)]]
    r = Rig(P, S, ["A"], server_kw={"chip_status_fn": lambda: chips[0]})
    try:
        r.wait_probed()
        ep = r.client._endpoints[0]
        assert r.client._probe_one(ep)
        first = r.client.endpoint_states()[0]
        assert first["capacity"] == 2 and first["chips_wedged"] == 0
        chips[0] = [(100, False), (1000, True)]
        assert r.client._probe_one(ep)
        second = r.client.endpoint_states()[0]
        assert second["capacity"] == 1 and second["chips_wedged"] == 1
        assert second["occupancy_permille"] == 100
        return {"first": first, "second": second}
    finally:
        r.close()


def sc_load_shifts_with_contradictions(P, S, real):
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.0, seed=0), start=False)
    r = Rig(P, S, auditor=aud)
    try:
        r.wait_probed()
        _set_ep(r.client, "A", occupancy_permille=100, capacity=1)
        _set_ep(r.client, "B", occupancy_permille=1000, capacity=1)
        ts = aud.trust_for("A")
        served_a = []
        for i in range(4):
            assert r.verify(r.sets(2, tag=i), GOSSIP_ATT)
            served_a.append(r.inj.calls_to("A", "verify"))
            ts.record(False)
        assert served_a[0] == 1 and served_a[1] == 2
        assert r.verify(r.sets(2, tag=99), GOSSIP_ATT)
        assert r.inj.calls_to("B", "verify") >= 1 and r.inj.calls_to("A", "verify") <= 3
        return {"served_a": served_a, "frames": r.rec.verifies(), "states": r.states()}
    finally:
        r.close()
        aud.close()


def sc_low_trust_endpoint_demoted(P, S, real):
    """test_audit: A's trust below the route threshold: every call goes to B,
    and A is demoted, not quarantined."""
    aud = P.audit.OffloadAuditor(sampler=P.audit.AuditSampler(0.0, seed=0), start=False)
    r = Rig(P, S, backend=lambda sets: False, auditor=aud)
    try:
        r.wait_probed()
        for _ in range(4):
            aud.trust_for("A").record(False)
        out = [r.verify(r.sets(), GOSSIP_BLOCK) for _ in range(3)]
        assert out == [False] * 3
        assert r.inj.calls_to("B", "verify") == 3 and r.inj.calls_to("A", "verify") == 0
        st = {s["target"]: s for s in r.states()}
        assert st["A"]["trust"] < 0.5 and not st["A"]["quarantined"]
        return {"out": out, "states": r.states()}
    finally:
        r.close()
        aud.close()


# test_probe_reconnect (in-process: the dead endpoint's Status is UNAVAILABLE)


class _SpyReconnects:
    """Logs each `_reconnect` of the package's client class (patched on the
    class, as the JAX tests do, so the probe thread sees it from its first
    probe)."""

    def __init__(self, P):
        self.cls = P.client.BlsOffloadClient
        self.log = []

    def __enter__(self):
        orig = self._orig = self.cls._reconnect
        log = self.log

        def spy(client, ep):
            log.append((ep.target, time.monotonic()))
            orig(client, ep)

        self.cls._reconnect = spy
        return self.log

    def __exit__(self, *exc):
        self.cls._reconnect = self._orig


def sc_reconnect_backoff_paces_redials(P, S, real):
    r = Rig(P, S, ["A"], rules=[_rule(P, "UNAVAILABLE", methods={"status"})], connect=False)
    try:
        with _SpyReconnects(P) as log:
            client = r.connect(probe_interval_s=0.05)
            _wait(lambda: _ep(client, "A").consecutive_failures >= 3, timeout_s=10.0,
                  what="three failed probes")
            ep = _ep(client, "A")
            assert not ep.healthy
            gaps = [b - a for (_, a), (_, b) in zip(log, log[1:])]
            # the backoff (0.5, 1.0, ...) paces redials: a 0.05 s interval
            # would have redialed every probe
            assert 2 <= len(log) <= 4 and gaps[0] >= 0.4
            if len(gaps) >= 2:
                assert gaps[1] > gaps[0]
            asyncio.run(client.close())
            r.client = None
        return {"redials_at_3": min(len(log), 3), "healthy": ep.healthy}
    finally:
        r.close()


def sc_no_reconnect_while_outstanding(P, S, real):
    r = Rig(P, S, ["A"], rules=[_rule(P, "UNAVAILABLE", methods={"status"})], connect=False)
    try:
        with _SpyReconnects(P) as log:
            # an RPC in flight before the first probe: hold the lock over
            # construction's first probe so it sees outstanding == 1
            client = r.connect(probe_interval_s=0.05)
            with client._lock:
                _ep(client, "A").outstanding = 1
            # the startup probe may have run before the line above: only
            # failures counted after it matter here
            start = len(log)
            base = _ep(client, "A").consecutive_failures
            # the next probes are due on the backoff (0.5 s, then 1.0 s)
            _wait(lambda: _ep(client, "A").consecutive_failures >= base + 2, timeout_s=10.0,
                  what="two more failed probes")
            assert len(log) == start  # probing went on, no teardown under in-flight work
            with client._lock:
                _ep(client, "A").outstanding = 0
            _wait(lambda: len(log) > start, timeout_s=10.0,
                  what="a redial once the work drained")
            asyncio.run(client.close())
            r.client = None
        return {"redialed": True}
    finally:
        r.close()


def sc_close_wakes_probe(P, S, real):
    r = Rig(P, S, ["A"], probe_interval_s=30.0)
    try:
        r.wait_probed()  # the first probe is done; the thread sleeps ~30 s
        assert r.client._probe_thread.is_alive()
        t0 = time.monotonic()
        asyncio.run(r.client.close())
        assert time.monotonic() - t0 < 5.0
        assert not r.client._probe_thread.is_alive()
        r.client = None
        return {"joined": True}
    finally:
        r.close()


def sc_health_recovers_after_fault_window(P, S, real):
    r = Rig(P, S, ["A"], rules=[_rule(P, "UNAVAILABLE", methods={"status"}, first_call=0,
                                      last_call=1)],
            probe_interval_s=0.05)
    try:
        _wait(lambda: r.inj.calls_to("A", "status") >= 1, what="the first probe")
        _wait(lambda: not _ep(r.client, "A").healthy or r.inj.calls_to("A", "status") > 2,
              what="the fault window observed")
        # `healthy` is set inside the probe and `consecutive_failures` reset
        # after it returns, so the three facts are read together in one
        # predicate: asserting the counter after `healthy` alone could land
        # between the two writes
        _wait(lambda: (_ep(r.client, "A").healthy and r.inj.calls_to("A", "status") >= 3
                       and _ep(r.client, "A").consecutive_failures == 0
                       and r.client.can_accept_work()),
              timeout_s=10.0, what="recovery")
        return {"status_faults": r.inj.injected[P.faults.FaultKind.UNAVAILABLE]}
    finally:
        r.close()


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@pytest.fixture(scope="module")
def real_sets():
    from lodestar_tpu_torch.models import batch_verify as bv

    return bv.make_synthetic_sets(3, seed=9)


@pytest.mark.parametrize("servers", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_client_scenario_agrees(case, servers, real_sets):
    S = PACKAGES[servers]
    ref = SCENARIOS[case](JAX, S, real_sets)
    got = SCENARIOS[case](PORT, S, real_sets)
    assert got == ref


# -- pure routing functions ---------------------------------------------------------------


def test_occupancy_key_and_trust_penalty_agree():
    assert t_client.TRUST_PENALTY_SPAN == j_client.TRUST_PENALTY_SPAN == 2000
    for occ in (None, 0, 100, 300, 1000):
        for out, cap in ((0, 1), (2, 1), (8, 8), (3, 0)):
            ep = SimpleNamespace(occupancy_permille=occ, outstanding=out, capacity=cap)
            for trust in (1.0, 0.9, 0.5, 0.0, -1.0, 2.0):
                assert t_client._occupancy_key(ep, trust) == j_client._occupancy_key(ep, trust)
    mesh = SimpleNamespace(occupancy_permille=300, outstanding=8, capacity=8)
    single = SimpleNamespace(occupancy_permille=300, outstanding=2, capacity=1)
    assert t_client._occupancy_key(mesh) < t_client._occupancy_key(single)


def test_client_constants_agree():
    for name in ("DEFAULT_TIMEOUT_S", "MAX_OUTSTANDING_JOBS", "HEALTH_PROBE_INTERVAL_S",
                 "RECONNECT_BACKOFF_S", "_UNKNOWN_OCCUPANCY"):
        assert getattr(t_client, name) == getattr(j_client, name), name
    assert t_res.DEFAULT_QUARANTINE_COOLOFF_S == j_res.DEFAULT_QUARANTINE_COOLOFF_S
    assert t_res.DEFAULT_HEDGE_DELAY_MS == j_res.DEFAULT_HEDGE_DELAY_MS
    assert {int(k): v for k, v in t_res.CLASS_DEADLINE_S.items()} == \
        {int(k): v for k, v in j_res.CLASS_DEADLINE_S.items()}
    assert {int(c) for c in t_res.HEDGE_CLASSES} == {int(c) for c in j_res.HEDGE_CLASSES}
    for p in range(5):
        for cap in (None, 1.0, 30.0):
            assert t_res.deadline_for(t_sched.PriorityClass(p), cap=cap) == \
                j_res.deadline_for(j_sched.PriorityClass(p), cap=cap)
    custom = {t_sched.PriorityClass.GOSSIP_BLOCK: 0.3}
    assert t_res.deadline_for(t_sched.PriorityClass.GOSSIP_BLOCK, deadlines=custom) == 0.3
    assert t_res.deadline_for(t_sched.PriorityClass.BACKFILL, deadlines=custom) == 10.0


# -- the transport error types -------------------------------------------------------------


def test_transport_errors_read_like_grpc():
    import grpc

    e = t_off.TransportError(t_off.StatusCode.UNAVAILABLE, "gone")
    assert str(e.code()) == str(grpc.StatusCode.UNAVAILABLE) == "StatusCode.UNAVAILABLE"
    assert e.details() == "gone"
    assert {c.name for c in t_off.StatusCode} == {c.name for c in grpc.StatusCode}
    assert t_off.transport_errors() == (t_off.TransportError, grpc.RpcError)
    injected = t_faults.InjectedRpcError(t_off.StatusCode.DEADLINE_EXCEEDED, "late")
    reference = j_faults.InjectedRpcError(grpc.StatusCode.DEADLINE_EXCEEDED, "late")
    assert str(injected) == str(reference)
    assert isinstance(injected, t_off.TransportError)


# -- tracing: the server's spans grafted under the client's RPC span -------------------------


@pytest.mark.parametrize("servers", ["jax", "port"])
def test_remote_spans_grafted_through_the_client(servers):
    names = {}
    for P in (JAX, PORT):
        r = Rig(P, PACKAGES[servers], ["A"])
        P.tr.reset()
        P.tr.configure(enabled=True, slow_slot_ms=60_000.0)
        try:
            r.wait_probed()

            async def go():
                with P.tr.root("block_import", slot=3) as root:
                    v = await r.client.verify_signature_sets(r.sets(2), r.opts(GOSSIP_BLOCK))
                return v, root

            v, root = asyncio.run(go())
            spans = root.trace.spans
            rpc = [s for s in spans if s.name == "offload_rpc"]
            assert v is True and len(rpc) == 1
            assert rpc[0].attrs["target"] == "A" and rpc[0].attrs["sets"] == 2
            kids = sorted(s.name for s in spans if s.parent_id == rpc[0].span_id)
            assert all(s.attrs.get("remote") for s in spans if s.parent_id == rpc[0].span_id)
            names[P.name] = (kids, rpc[0].attrs["class"], round(rpc[0].attrs["deadline_s"], 1))
        finally:
            P.tr.reset()
            r.close()
    assert names["port"] == names["jax"] == (["offload_decode", "offload_device_verify"],
                                             "gossip_block", 2.0)


# -- over a real gRPC socket: the port's client against the JAX server ---------------------


def test_port_client_against_the_jax_server_over_grpc(real_sets):
    server = j_srv.BlsOffloadServer(j_api.verify_signature_sets, port=0)
    server.start()
    target = f"127.0.0.1:{server.port}"
    metrics = Metrics()
    client = t_client.BlsOffloadClient(target, probe_interval_s=0.05, tenant="node-a",
                                       metrics=metrics)
    try:
        _wait(lambda: client.endpoint_states()[0]["tenant_capable"], what="a probe over grpc")
        opts = t_iface.VerifySignatureOpts(priority=GOSSIP_ATT)
        swapped = [t_api.SignatureSet(real_sets[0].pubkey, real_sets[0].message,
                                      real_sets[1].signature),
                   t_api.SignatureSet(real_sets[1].pubkey, real_sets[1].message,
                                      real_sets[0].signature)]

        async def go():
            return (await client.verify_signature_sets(real_sets[:2], opts),
                    await client.verify_signature_sets(swapped, opts))

        assert asyncio.run(go()) == (True, False)
        assert server.tenancy.served == {"node-a": 2}
        st = client.endpoint_states()[0]
        assert st["breaker"] == "closed" and st["healthy"] and st["tenant_capable"]
        assert metrics.total("routed") == 2
    finally:
        asyncio.run(client.close())
        server.stop()
    # the server gone: the next call fails closed on grpc's own error type
    dead = t_client.BlsOffloadClient(target, timeout_s=1.0, probe_interval_s=3600.0)
    try:
        with pytest.raises(t_off.OffloadError, match="offload transport: StatusCode"):
            asyncio.run(dead.verify_signature_sets(real_sets[:1]))
        _wait(lambda: not dead.can_accept_work(), what="the dead endpoint marked down")
    finally:
        asyncio.run(dead.close())


# -- without grpc: in-process verdicts, and a dialed target raises the ImportError -----------

_NO_GRPC = r"""
import asyncio, sys
sys.modules["grpc"] = None
sys.modules["jax"] = None
sys.modules["lodestar_tpu"] = None
from lodestar_tpu_torch.crypto.bls.api import SignatureSet
from lodestar_tpu_torch.offload import server as srv
from lodestar_tpu_torch.offload.client import BlsOffloadClient
from lodestar_tpu_torch.testing import FaultInjector, FaultKind, FaultRule
sets = [SignatureSet(bytes([1]) * 48, bytes(32), bytes(96))]
inj = FaultInjector([FaultRule(FaultKind.UNAVAILABLE, first_call=0, last_call=0,
                               targets=frozenset({"a"}), methods=frozenset({"verify"}))])
wrapper = srv.local_transports({"a": srv.BlsOffloadServer(lambda s: False),
                                "b": srv.BlsOffloadServer(lambda s: True)},
                               wrap=inj.wrap_transport)
client = BlsOffloadClient(["a", "b"], probe_interval_s=3600.0, transport_wrapper=wrapper)


def outcome():
    try:
        return asyncio.run(client.verify_signature_sets(sets))
    except Exception as e:
        return type(e).__name__


print("verdicts", outcome(), outcome())
asyncio.run(client.close())
dialed = BlsOffloadClient("127.0.0.1:1", probe_interval_s=3600.0)
try:
    asyncio.run(dialed.verify_signature_sets(sets))
except ImportError as e:
    print("dialed target raised ImportError")
print("probe thread alive", dialed._probe_thread.is_alive(),
      "healthy", dialed.endpoint_states()[0]["healthy"])
asyncio.run(dialed.close())
assert sys.modules["grpc"] is None
"""


def test_client_serves_in_process_without_grpc():
    proc = subprocess.run([sys.executable, "-c", _NO_GRPC], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the first call fails on a (injected UNAVAILABLE; the API class has
    # one attempt): a transport error, never a verdict; a is then
    # unhealthy and the second call is served by b
    lines = proc.stdout.splitlines()
    assert "verdicts OffloadError True" in lines
    assert "dialed target raised ImportError" in lines
    assert "probe thread alive True healthy False" in lines
