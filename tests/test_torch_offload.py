"""The port's offload host against the JAX package's, on the CPU.

* The wire format (`lodestar_tpu_torch.offload`): every frame of both
  packages on the same inputs is bytes-equal (sets frames with and
  without the tenant trailer, status frames with and without the mesh
  trailer, verdicts, sheds, digests), and both decoders give the same
  answer, or raise the same error, on the same bytes, malformed ones
  included.
* `TenantScheduler` against the JAX one on the same arrivals: the same
  grant order, served and shed counts, admission grades and metric calls
  (the scenarios of `tests/offload/test_tenancy.py`).
* `DegradingBlsVerifier` against the JAX one on the mock-layer scenarios
  of `tests/offload/test_degradation.py`.
* Remote trace spans: the port's recorder payload grafted by the JAX
  `graft_remote_spans`, and the other way round.
* `BlsOffloadServer` against the JAX server, each on its own CPU oracle,
  through `LocalStub`: the same request frames give bytes-equal verdict,
  error, shed and status frames. One size-8 frame through a CPU mesh lane
  (`build_device_mesh("off", device="cpu")` with `mesh_launch`), and an
  injected lane fault that reaches the wire as the error frame and charges
  the lane's breaker.
* The departures: the server module imports and serves in-process without
  grpc, where `start()` raises ImportError; `build_server` with
  `--bls-mesh auto`/`on` raises without CUDA, `off` serves the oracle, and
  `--metrics-port` is not a flag.
* Over a real gRPC socket: the JAX package's `BlsOffloadClient` against
  the port's started server (valid True, tampered False, tenant trailer
  accounting, a quota shed arriving as `OffloadShed` with the endpoint's
  breaker closed, and the server's spans grafted under the client's RPC
  span).

Tolerance: none (equal bytes, equal orders, equal verdicts). Real signature
sets are the port's `make_synthetic_sets` (the JAX fixture's keys); the
oracles verify one or two of them (~0.2 s each).
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

import lodestar_tpu.chain.bls as j_bls
import lodestar_tpu.offload as j_off
import lodestar_tpu.offload.server as j_srv
import lodestar_tpu.offload.tenancy as j_ten
import lodestar_tpu.tracing as j_tr
from lodestar_tpu.crypto.bls import api as j_api
import lodestar_tpu_torch.chain.bls as t_bls
import lodestar_tpu_torch.offload as t_off
import lodestar_tpu_torch.offload.server as t_srv
import lodestar_tpu_torch.offload.tenancy as t_ten
import lodestar_tpu_torch.tracing as t_tr
from lodestar_tpu_torch.chain.bls import mesh as t_mesh
from lodestar_tpu_torch.crypto.bls import api as t_api
from lodestar_tpu_torch.models import batch_verify as bv
from lodestar_tpu_torch.scheduler import AdmissionState

REPO = pathlib.Path(__file__).resolve().parent.parent

API, GOSSIP_BLOCK, GOSSIP_ATT, RANGE_SYNC, BACKFILL = 2, 0, 1, 3, 4


@pytest.fixture(scope="module", autouse=True)
def _one_aten_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def real_sets():
    return bv.make_synthetic_sets(8, seed=9)


def _dummy(n, tag=0):
    return [
        t_api.SignatureSet(
            pubkey=bytes([1, tag, i % 256]) + bytes(45),
            message=bytes([2, tag, i % 256]) * 8 + bytes(8),
            signature=bytes([3, tag, i % 256]) + bytes(93),
        )
        for i in range(n)
    ]


def _swapped(sets):
    out = list(sets)
    out[0] = t_api.SignatureSet(sets[0].pubkey, sets[0].message, sets[1].signature)
    out[1] = t_api.SignatureSet(sets[1].pubkey, sets[1].message, sets[0].signature)
    return out


# -- the wire format: encoders --------------------------------------------------

_FRAME = bytes(range(256)) * 3  # a request for the digests

ENCODE_CASES = {
    "sets_empty": lambda o: o.encode_sets([]),
    "sets_1": lambda o: o.encode_sets(_dummy(1)),
    "sets_3": lambda o: o.encode_sets(_dummy(3, tag=7)),
    **{
        f"sets_3_tenant_class{p}": (lambda p: lambda o: o.encode_sets(
            _dummy(3), tenant="node-a", priority=p))(p)
        for p in range(5)
    },
    "sets_1_tenant_default_class": lambda o: o.encode_sets(_dummy(1), tenant="ténant-β"),
    "sets_2_tenant_255_bytes": lambda o: o.encode_sets(_dummy(2), tenant="x" * 255, priority=4),
    "tenant_trailer": lambda o: o.encode_tenant_trailer("node-b", RANGE_SYNC),
    "validate_tenant": lambda o: o.validate_tenant("node-c"),
    "status_v1": lambda o: o.encode_status(occupancy_permille=734, queue_depth=17, admission=1),
    "status_reject": lambda o: o.encode_status(occupancy_permille=990, queue_depth=999,
                                               admission=2),
    "status_clamped": lambda o: o.encode_status(occupancy_permille=5000, queue_depth=2**40,
                                                admission=0),
    "status_chips": lambda o: o.encode_status(
        occupancy_permille=12, queue_depth=3, admission=0,
        chips=[(10, False), (1200, True), (-5, False)], tenant_capable=True),
    "status_tenant_capable_only": lambda o: o.encode_status(
        occupancy_permille=1, queue_depth=0, admission=0, tenant_capable=True),
    "status_empty_chip_table": lambda o: o.encode_status(
        occupancy_permille=1, queue_depth=0, admission=1, chips=[]),
    "status_300_chips": lambda o: o.encode_status(
        occupancy_permille=500, queue_depth=1, admission=0,
        chips=[(i, i % 7 == 0) for i in range(300)]),
    "verdict_legacy_true": lambda o: o.encode_verdict(True),
    "verdict_legacy_false": lambda o: o.encode_verdict(False),
    "verdict_digest_true": lambda o: o.encode_verdict(True, request=_FRAME),
    "verdict_digest_false": lambda o: o.encode_verdict(False, request=_FRAME),
    "verdict_error": lambda o: o.encode_verdict(None, error="boom"),
    "verdict_error_unicode": lambda o: o.encode_verdict(True, error="état → ✗"),
    "shed_bare": lambda o: o.encode_shed(1, "tenant quota"),
    "shed_bound": lambda o: o.encode_shed(2, "quota (reject)", request=_FRAME),
    "shed_long_reason": lambda o: o.encode_shed(0, "r" * 300, request=_FRAME),
    "shed_no_reason": lambda o: o.encode_shed(2),
    "verdict_digest_0": lambda o: o.verdict_digest(_FRAME, 0),
    "verdict_digest_1": lambda o: o.verdict_digest(b"", 1),
    "shed_digest_2": lambda o: o.shed_digest(_FRAME, 2),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_frames_are_bytes_equal(case):
    port, ref = ENCODE_CASES[case](t_off), ENCODE_CASES[case](j_off)
    assert isinstance(port, bytes) and port == ref


@pytest.mark.parametrize("bad", [
    lambda o: o.encode_sets(_dummy(1), tenant=""),
    lambda o: o.encode_sets(_dummy(1), tenant="x" * 256),
    lambda o: o.encode_sets([t_api.SignatureSet(bytes(47), bytes(32), bytes(96))]),
    lambda o: o.validate_tenant(""),
])
def test_bad_inputs_raise_in_both(bad):
    with pytest.raises(t_off.OffloadError):
        bad(t_off)
    with pytest.raises(j_off.OffloadError):
        bad(j_off)


def test_constants_are_equal():
    for name in ("SET_BYTES", "STATUS_FRAME_BYTES", "VERDICT_FRAME_BYTES", "DEFAULT_TENANT",
                 "STATUS_MAGIC", "STATUS_MESH_MAGIC", "SETS_TRAILER_MAGIC", "VERDICT_MAGIC",
                 "MAX_TENANT_BYTES", "VERDICT_DIGEST_BYTES", "CHIP_FLAG_WEDGED",
                 "STATUS_FLAG_TENANT_CAPABLE"):
        assert getattr(t_off, name) == getattr(j_off, name), name
    assert sorted(t_off.__all__) == sorted(j_off.__all__)


# -- the wire format: decoders --------------------------------------------------


def _outcome(fn, *args, **kw):
    """A decoder's answer in package-free terms: values as plain data,
    enums as ints, or the error's class name and text."""
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        state = getattr(e, "state", None)
        return ("raise", type(e).__name__, str(e), None if state is None else int(state))
    return ("ok", _plain(out))


def _plain(v):
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if hasattr(v, "__dataclass_fields__"):
        d = {k: _plain(getattr(v, k)) for k in v.__dataclass_fields__}
        if hasattr(v, "capacity"):
            d["capacity"] = v.capacity
        return (type(v).__name__, tuple(sorted(d.items())))
    if hasattr(v, "value") and hasattr(v, "name"):  # an IntEnum
        return int(v)
    return v


_LEGACY = j_off.encode_sets(_dummy(2))
_STAMPED = j_off.encode_sets(_dummy(2), tenant="node-a", priority=RANGE_SYNC)

SETS_FRAMES = {
    "legacy": _LEGACY,
    "stamped": _STAMPED,
    "empty": j_off.encode_sets([]),
    "empty_stamped": j_off.encode_sets([], tenant="t", priority=0),
    "short": b"\x01\x00",
    "truncated": _LEGACY[:-1],
    "count_lies": b"\xff\xff\xff\xff" + bytes(10),
    "trailer_truncated": _STAMPED[:-1],
    "trailer_bad_priority": _LEGACY + b"\xc3\x01\x63\x01\x00t",
    "trailer_wrong_version": _LEGACY + b"\xc3\x02\x02\x01\x00t",
    "trailer_zero_length": _LEGACY + b"\xc3\x01\x02\x00\x00",
    "trailer_not_utf8": _LEGACY + b"\xc3\x01\x02\x02\x00\xff\xfe",
    "trailer_extra_byte": _STAMPED + b"\x00",
    "garbage": _LEGACY + b"garbage",
}


@pytest.mark.parametrize("case", sorted(SETS_FRAMES))
def test_decode_sets_agrees(case):
    frame = SETS_FRAMES[case]

    def decode(o):
        sets, trailer = o.decode_sets_ex(frame)
        return [(bytes(s.pubkey), bytes(s.message), bytes(s.signature)) for s in sets], trailer

    assert _outcome(decode, t_off) == _outcome(decode, j_off)
    assert _outcome(t_off.decode_sets, frame)[0] == _outcome(j_off.decode_sets, frame)[0]


STATUS_FRAMES = {
    "legacy_1": b"\x01",
    "legacy_0": b"\x00",
    "empty": b"",
    "v1": j_off.encode_status(occupancy_permille=734, queue_depth=17, admission=1),
    "v1_reject": j_off.encode_status(occupancy_permille=990, queue_depth=9, admission=2),
    "mesh": j_off.encode_status(occupancy_permille=12, queue_depth=3, admission=0,
                                chips=[(10, False), (900, True)], tenant_capable=True),
    "mesh_future_version": j_off.encode_status(occupancy_permille=1, queue_depth=0,
                                               admission=0)[:10] + b"\xc4\x02\x01\x00",
    "mesh_bad_length": j_off.encode_status(occupancy_permille=1, queue_depth=0, admission=0,
                                           chips=[(1, False)])[:-1],
    "unknown_admission": b"\x01\xa5\x01\x09" + bytes(6),
    "future_version": b"\x01\xa5\x02\x00" + bytes(6),
}


@pytest.mark.parametrize("case", sorted(STATUS_FRAMES))
def test_decode_status_agrees(case):
    frame = STATUS_FRAMES[case]
    assert _outcome(t_off.decode_status, frame) == _outcome(j_off.decode_status, frame)


_REQ = _LEGACY
VERDICT_FRAMES = {
    "legacy_true": b"\x01",
    "legacy_false": b"\x00",
    "digest_true": j_off.encode_verdict(True, request=_REQ),
    "digest_false": j_off.encode_verdict(False, request=_REQ),
    "digest_other_request": j_off.encode_verdict(True, request=_STAMPED),
    "flipped": b"\x01" + j_off.encode_verdict(False, request=_REQ)[1:],
    "error": j_off.encode_verdict(None, error="boom"),
    "error_empty": b"\x02",
    "shed_bound": j_off.encode_shed(1, "quota", request=_REQ),
    "shed_bare": j_off.encode_shed(2, "quota"),
    "shed_other_request": j_off.encode_shed(2, "quota", request=_STAMPED),
    "shed_unknown_state": bytes([3, 9, 0]),
    "shed_malformed": b"\x03\x00",
    "empty": b"",
    "lead_byte_7": b"\x07",
    "trailing_garbage": j_off.encode_verdict(True, request=_REQ) + b"\x00",
    "wrong_magic": b"\x01\xb8\x01" + bytes(8),
}


@pytest.mark.parametrize("case", sorted(VERDICT_FRAMES))
@pytest.mark.parametrize("mode", ["unbound", "bound", "require_digest"])
def test_decode_verdict_agrees(case, mode):
    frame = VERDICT_FRAMES[case]
    kw = {} if mode == "unbound" else {"request": _REQ}
    if mode == "require_digest":
        kw["require_digest"] = True
    assert _outcome(t_off.decode_verdict, frame, **kw) == _outcome(j_off.decode_verdict,
                                                                   frame, **kw)


def test_shed_decodes_as_offload_shed_with_its_state():
    frame = t_off.encode_shed(1, "tenant quota", request=_REQ)
    with pytest.raises(t_off.OffloadShed) as ei:
        t_off.decode_verdict(frame, request=_REQ)
    assert ei.value.state is AdmissionState.SHED_BULK
    assert isinstance(ei.value, t_off.OffloadError)


# -- TenantScheduler -------------------------------------------------------------


class _Metric:
    """A labelled metric stub that logs every call, shared shape for both
    packages' duck-typed `metrics`."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def labels(self, *key):
        log, name = self.log, self.name

        class _Child:
            def set(self, v):
                log.append((name, key, "set", v))

            def inc(self, v=1):
                log.append((name, key, "inc", v))

            def dec(self, v=1):
                log.append((name, key, "dec", v))

            def observe(self, v):
                log.append((name, key, "observe", type(v).__name__))

        return _Child()


class _TenantMetrics:
    def __init__(self):
        self.log = []
        for name in ("quota_weight", "shed", "inflight", "served_sets", "slack"):
            setattr(self, name, _Metric(self.log, name))


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("condition never held")
        time.sleep(0.002)


def _grant_order(ten, arrivals, *, weights=None, **kw):
    """Hold the one slot, queue `arrivals` [(tenant, class, tag)] one at a
    time (each in the queue before the next arrives), release, and return
    the order of grants, the served and shed counts and the metric calls."""
    metrics = _TenantMetrics()
    sched = ten.TenantScheduler(slots=1, weights=weights, metrics=metrics, **kw)
    assert sched.acquire("hold", API)
    order, threads = [], []

    def worker(tenant, priority, tag):
        if sched.acquire(tenant, priority, timeout_s=10.0):
            order.append(tag)
            sched.release(tenant)

    for tenant, priority, tag in arrivals:
        n = len(sched._waiters)
        t = threading.Thread(target=worker, args=(tenant, priority, tag))
        t.start()
        threads.append(t)
        _wait(lambda: len(sched._waiters) == n + 1)
    sched.release("hold")
    for t in threads:
        t.join(timeout=20)
    sched.close()
    return order, dict(sched.served), dict(sched.shed), metrics.log


GRANT_SCENARIOS = {
    # a deep backlog of one tenant, then another tenant's gossip: served next
    "greedy_backlog_then_gossip": (
        {"a": 1, "b": 1},
        [("a", BACKFILL, f"a{i}") for i in range(5)] + [("b", GOSSIP_BLOCK, "b0")],
    ),
    # within a tenant, priority beats FIFO
    "within_tenant_priority": ({}, [("a", BACKFILL, "bulk"), ("a", GOSSIP_BLOCK, "gossip")]),
    # 3:1 weights under a queued backlog of both
    "weights_3_to_1": (
        {"heavy": 3, "light": 1},
        [(t, API, f"{t}{i}") for i in range(12) for t in ("heavy", "light")],
    ),
    # three tenants, default weight for the unlisted one, mixed classes
    "three_tenants_mixed": (
        {"a": 2, "b": 1},
        [("abc"[i % 3], (i * 7) % 5, f"{'abc'[i % 3]}{i}") for i in range(18)],
    ),
}


@pytest.mark.parametrize("case", sorted(GRANT_SCENARIOS))
def test_tenant_grants_agree(case):
    weights, arrivals = GRANT_SCENARIOS[case]
    port = _grant_order(t_ten, arrivals, weights=weights)
    ref = _grant_order(j_ten, arrivals, weights=weights)
    assert port == ref
    order = port[0]
    assert len(order) == len(arrivals)
    if case == "greedy_backlog_then_gossip":
        assert order[0] == "b0"
    if case == "within_tenant_priority":
        assert order == ["gossip", "bulk"]
    if case == "weights_3_to_1":
        first = order[:16]
        assert sum(tag.startswith("heavy") for tag in first) == 12, first


def _admission_and_sheds(ten):
    metrics = _TenantMetrics()
    sched = ten.TenantScheduler(slots=1, shed_depth=2, reject_depth=4, metrics=metrics)
    seen = []

    def grades():
        seen.append(tuple(
            (t, int(sched.admission_for(t)),
             tuple(sched.admits(t, p) for p in range(5))) for t in ("a", "b")))

    assert sched.acquire("a", API)
    grades()
    waiters, results = [], []
    for _ in range(3):
        n = len(sched._waiters)
        t = threading.Thread(
            target=lambda: results.append(sched.acquire("a", BACKFILL, timeout_s=10.0)))
        t.start()
        waiters.append(t)
        _wait(lambda: len(sched._waiters) == n + 1)
        grades()
    # a slot wait that times out is a shed the caller counts
    assert not sched.acquire("b", GOSSIP_BLOCK, timeout_s=0.01)
    sched.count_shed("b", GOSSIP_BLOCK, "slot_timeout")
    sched.count_shed("a", BACKFILL, "quota")
    depth = (sched.depth(), sched.depth("a"), sched.depth("b"))
    sched.close()  # parked waiters shed at once
    for t in waiters:
        t.join(timeout=10)
    grades()
    sched.release("a")
    closed = sched.acquire("a", API, timeout_s=1.0)  # a closed scheduler sheds at once
    return (seen, depth, dict(sched.served), dict(sched.shed), closed, results,
            sched.tenants_seen(), metrics.log)


def test_tenant_admission_and_sheds_agree():
    port = _admission_and_sheds(t_ten)
    ref = _admission_and_sheds(j_ten)
    assert port == ref
    seen, depth, served, shed, closed, results = port[:6]
    # depth 2-3 >= shed_depth: bulk sheds for a, gossip and API still admitted
    assert seen[1][0][1] == seen[2][0][1] == 1
    assert seen[2][0][2] == (True, True, True, False, False)
    assert seen[3][0][1] == 2 and not any(seen[3][0][2])  # depth 4: everything sheds
    assert seen[0][1][2] == (True,) * 5  # the idle sibling tenant is unaffected
    assert seen[4][0][1] == 0  # the waiters left: a's depth is its running job
    assert depth == (4, 4, 0) and served == {"a": 1} and shed == {"a": 1, "b": 1}
    assert closed is False and results == [False] * 3


def test_tenant_weights_and_defaults_agree():
    for specs in (["a=3", "b=1"], [], ["x=10"]):
        assert t_ten.parse_tenant_weights(specs) == j_ten.parse_tenant_weights(specs)
    for bad in ("a", "a=", "a=0", "a=-1", "=3"):
        with pytest.raises(ValueError):
            t_ten.parse_tenant_weights([bad])
    for name in ("DEFAULT_TENANT_WEIGHT", "DEFAULT_TENANT_SHED_DEPTH",
                 "DEFAULT_TENANT_REJECT_DEPTH", "DEFAULT_ACQUIRE_TIMEOUT_S", "_STRIDE_SCALE"):
        assert getattr(t_ten, name) == getattr(j_ten, name)


def test_tenant_served_shares_track_weights():
    """The saturation test's observable on a queued backlog: the served
    shares of 3:1 weights, equal in both packages."""
    arrivals = [(t, API, t) for _ in range(30) for t in ("heavy", "light")]
    shares = []
    for ten in (t_ten, j_ten):
        order = _grant_order(ten, arrivals, weights={"heavy": 3, "light": 1})[0][:40]
        shares.append(order.count("heavy") / len(order))
    assert shares[0] == shares[1] and abs(shares[0] - 0.75) <= 0.10


# -- DegradingBlsVerifier ---------------------------------------------------------


class _Erroring:
    def __init__(self, accepting=True):
        self.accepting = accepting
        self.calls = 0

    async def verify_signature_sets(self, sets, opts=None):
        self.calls += 1
        raise RuntimeError("layer down")

    def is_down(self):
        return not self.accepting

    def can_accept_work(self):
        return self.accepting

    async def close(self):
        return None


class _SaturatedButAlive:
    async def verify_signature_sets(self, sets, opts=None):
        raise AssertionError("a saturated layer is not called here")

    def is_down(self):
        return False

    def can_accept_work(self):
        return False

    async def close(self):
        return None


class _Gauge:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


class _ResilienceMetrics:
    def __init__(self):
        self.log = []
        self.fallback_active = _Gauge()
        self.fallback_verifications = _Metric(self.log, "fallback_verifications")
        self.fallback_skipped = _Metric(self.log, "fallback_skipped")


def _deg_error_then_false_is_final(b, sets):
    err, strict, lenient = _Erroring(), b.BlsVerifierMock(False), b.BlsVerifierMock(True)
    deg = b.DegradingBlsVerifier([("a", err), ("b", strict), ("c", lenient)])
    v = asyncio.run(deg.verify_signature_sets(_dummy(1)))
    return v, deg.last_layer, err.calls, strict.calls, lenient.calls


def _deg_down_layer_skipped(b, sets):
    err, ok, m = _Erroring(accepting=False), b.BlsVerifierMock(True), _ResilienceMetrics()
    deg = b.DegradingBlsVerifier([("a", err), ("b", ok)], metrics=m)
    v = asyncio.run(deg.verify_signature_sets(_dummy(1)))
    return v, err.calls, deg.last_layer, m.log, m.fallback_active.value


def _deg_all_layers_err(b, sets):
    a, c = _Erroring(), _Erroring()
    deg = b.DegradingBlsVerifier([("a", a), ("b", c)])
    try:
        asyncio.run(deg.verify_signature_sets(_dummy(1)))
        out = "no raise"
    except RuntimeError as e:
        out = str(e)
    return out, a.calls, c.calls, deg.in_outage()


def _deg_nothing_accepts(b, sets):
    deg = b.DegradingBlsVerifier([("a", _Erroring(accepting=False))])
    try:
        asyncio.run(deg.verify_signature_sets(_dummy(1)))
        return "no raise"
    except RuntimeError as e:
        return str(e), deg.in_outage(), deg.can_accept_work()


def _deg_can_accept_work(b, sets):
    d1 = b.DegradingBlsVerifier([("a", _Erroring(accepting=False)), ("b", b.BlsVerifierMock())])
    d2 = b.DegradingBlsVerifier([("a", _Erroring(accepting=False))])
    d3 = b.DegradingBlsVerifier([("offload", _SaturatedButAlive()),
                                 ("cpu", b.BlsSingleThreadVerifier())])
    return d1.can_accept_work(), d2.can_accept_work(), d3.can_accept_work()


def _deg_layer_without_is_down(b, sets):
    busy = b.BlsVerifierMock(verdict=True)
    busy.can_accept_work = lambda: False
    deg = b.DegradingBlsVerifier([("a", busy), ("b", b.BlsVerifierMock())])
    return asyncio.run(deg.verify_signature_sets(_dummy(1))), deg.last_layer


def _deg_reverifies(b, sets):
    m = _ResilienceMetrics()
    deg = b.DegradingBlsVerifier([("offload", _Erroring()), ("cpu", b.BlsSingleThreadVerifier())],
                                 metrics=m)

    async def go():
        good = await deg.verify_signature_sets(sets[:2])
        layer = deg.serving_layer()
        bad = await deg.verify_signature_sets(_swapped(sets[:2]))
        return good, layer, bad, deg.serving_layer(), deg.last_layer

    return asyncio.run(go()), m.log, m.fallback_active.value


def _deg_empty_layers(b, sets):
    try:
        b.DegradingBlsVerifier([])
    except ValueError as e:
        return str(e)
    return "no raise"


def _deg_concurrent_serving_layer(b, sets):
    class Selective:
        async def verify_signature_sets(self, sets_, opts=None):
            if bytes(sets_[0].message)[0] == 0xAA:
                raise RuntimeError("primary refuses the tagged set")
            await asyncio.sleep(0.01)
            return True

        def can_accept_work(self):
            return True

        async def close(self):
            return None

    class SlowCpu:
        async def verify_signature_sets(self, sets_, opts=None):
            await asyncio.sleep(0.1)
            return False

        def can_accept_work(self):
            return True

        async def close(self):
            return None

    deg = b.DegradingBlsVerifier([("offload", Selective()), ("cpu", SlowCpu())])

    def tagged(x):
        return [t_api.SignatureSet(bytes(48), bytes([x]) * 32, bytes(96))]

    async def task(x):
        v = await deg.verify_signature_sets(tagged(x))
        return v, deg.serving_layer()

    async def go():
        return await asyncio.gather(task(0xAA), task(0x01)), deg.last_layer

    return asyncio.run(go())


def _deg_fallback_span(b, tr):
    tr.reset()
    tr.configure(enabled=True, slow_slot_ms=60_000.0)
    try:
        deg = b.DegradingBlsVerifier([("a", _Erroring()), ("b", b.BlsVerifierMock(True))])
        with tr.root("block_import", slot=3) as root:
            asyncio.run(deg.verify_signature_sets(_dummy(1)))
        return sorted((s.name, tuple(sorted((s.attrs or {}).items())))
                      for s in root.trace.spans if s is not root)
    finally:
        tr.reset()


DEGRADE_SCENARIOS = {
    "error_degrades_false_is_final": (_deg_error_then_false_is_final, (False, "b", 1, [1], [])),
    "down_layer_skipped": (_deg_down_layer_skipped, None),
    "all_layers_err": (_deg_all_layers_err, ("layer down", 1, 1, True)),
    "nothing_accepts": (_deg_nothing_accepts,
                        ("no bls verifier layer accepts work", True, False)),
    "can_accept_work": (_deg_can_accept_work, (True, False, False)),
    "layer_without_is_down": (_deg_layer_without_is_down, (True, "a")),
    "reverifies": (_deg_reverifies, None),
    "empty_layers": (_deg_empty_layers, "at least one verifier layer required"),
    "concurrent_serving_layer": (_deg_concurrent_serving_layer,
                                 ([(False, "cpu"), (True, "offload")], "cpu")),
}


@pytest.mark.parametrize("case", sorted(DEGRADE_SCENARIOS))
def test_degrading_verifier_agrees(case, real_sets):
    fn, want = DEGRADE_SCENARIOS[case]
    port, ref = fn(t_bls, real_sets), fn(j_bls, real_sets)
    assert port == ref
    if want is not None:
        assert port == want
    if case == "down_layer_skipped":
        assert port == (True, 0, "b", [("fallback_skipped", ("a",), "inc", 1),
                                       ("fallback_verifications", ("b",), "inc", 1)], 1)
    if case == "reverifies":
        (good, layer, bad, layer2, last), log, active = port
        assert (good, layer, bad, layer2, last) == (True, "cpu", False, "cpu", "cpu")
        assert log == [("fallback_verifications", ("cpu",), "inc", 1)] * 2 and active == 1


def test_degrading_verifier_traces_each_downgrade():
    port = _deg_fallback_span(t_bls, t_tr)
    ref = _deg_fallback_span(j_bls, j_tr)
    assert port == ref == [("bls_fallback", (("after_error", "layer down"), ("layer", "b")))]


def test_degrading_verifier_is_exported():
    assert t_bls.DegradingBlsVerifier.__module__ == "lodestar_tpu_torch.chain.bls.fallback"
    assert issubclass(t_bls.DegradingBlsVerifier, t_bls.IBlsVerifier)


# -- remote trace spans ----------------------------------------------------------


def _record_remote(tr):
    rec = tr.remote_recorder("00000001:4:7")
    with rec.span("offload_decode"):
        time.sleep(0.001)
    with rec.span("offload_device_verify", sets=3, tenant="a") as sp:
        sp.set(lane="dev0")
    with pytest.raises(RuntimeError):
        with rec.span("failing"):
            raise RuntimeError("fault")
    return rec


def _graft(tr, payload):
    tr.reset()
    tr.configure(enabled=True, slow_slot_ms=60_000.0)
    try:
        with tr.root("block_import", slot=7) as root:
            t0 = time.monotonic_ns()
            sp = tr.record(root, "offload_rpc", t0, t0 + 50_000_000, {"sets": 3})
            n = tr.graft_remote_spans(sp, payload, t0)
        kids = [s for s in root.trace.spans if s.parent_id == sp.span_id]
        return n, [(s.name, s.start_ns - t0, s.end_ns - s.start_ns, s.attrs) for s in kids]
    finally:
        tr.reset()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_remote_spans_graft_across_packages(direction):
    src, dst = (t_tr, j_tr) if direction == "port_to_jax" else (j_tr, t_tr)
    payload = _record_remote(src).serialize()
    n, kids = _graft(dst, payload)
    n_same, kids_same = _graft(src, payload)
    assert n == n_same == 3 and kids == kids_same
    names = [k[0] for k in kids]
    assert names == ["offload_decode", "offload_device_verify", "failing"]
    assert all(k[3]["remote"] is True for k in kids)
    assert kids[1][3] == {"sets": 3, "tenant": "a", "lane": "dev0", "remote": True}
    assert kids[2][3]["error"] == "RuntimeError: fault"
    assert kids[0][2] >= 1_000_000  # the decode span's own duration, in ns


def test_remote_payload_and_headers_match():
    recs = []
    for tr in (t_tr, j_tr):
        rec = tr.RemoteSpanRecorder()
        rec.origin_ns = 1_000
        rec._add("offload_decode", 1_500, 4_000, {})
        rec._add("offload_device_verify", 4_000, 90_000, {"sets": 2, "tenant": "t"})
        recs.append(rec.serialize())
    assert recs[0] == recs[1]
    assert t_tr.TRACE_CONTEXT_KEY == j_tr.TRACE_CONTEXT_KEY
    assert t_tr.TRACE_SPANS_KEY == j_tr.TRACE_SPANS_KEY
    for hdr in ("abc:3:12", "abc:3:", "bad", "a:b:c", None, "x:1:2:3"):
        assert t_tr.parse_context_header(hdr) == j_tr.parse_context_header(hdr)
        assert (type(t_tr.remote_recorder(hdr)).__name__
                == type(j_tr.remote_recorder(hdr)).__name__)
    assert t_tr.remote_recorder(None).serialize() is None
    assert t_tr.graft_remote_spans(None, recs[0], 0) == 0
    assert t_tr.graft_remote_spans(t_tr.NOOP_SPAN, recs[0], 0) == 0
    # the port's header is read by the JAX parser
    t_tr.reset()
    t_tr.configure(enabled=True)
    try:
        assert t_tr.context_header() is None  # no active span
        with t_tr.root("block_import", slot=5) as root:
            hdr = t_tr.context_header()
        assert j_tr.parse_context_header(hdr) == (root.trace.trace_id, root.span_id, 5)
    finally:
        t_tr.reset()
    assert t_tr.context_header() is None  # tracing off


# -- the server against the JAX server, in-process ---------------------------------


class _Ctx:
    """The shape of a servicer context both servers read."""

    def __init__(self, tr=None, hdr=None, remaining=None):
        self.md = () if hdr is None else ((tr.TRACE_CONTEXT_KEY, hdr),)
        self.remaining = remaining
        self.trailers = None

    def invocation_metadata(self):
        return self.md

    def time_remaining(self):
        return self.remaining

    def set_trailing_metadata(self, md):
        self.trailers = md


def _server_pair(**kw):
    port = t_srv.BlsOffloadServer(t_api.verify_signature_sets, **kw)
    ref = j_srv.BlsOffloadServer(j_api.verify_signature_sets, **kw)
    return port, ref


def test_server_replies_are_bytes_equal(real_sets):
    port, ref = _server_pair(tenant_slots=1)
    try:
        assert port._status(b"", None) == ref._status(b"", None)  # idle: equal frames
        frames = {
            "valid_legacy": t_off.encode_sets(real_sets[:2]),
            "valid_stamped": t_off.encode_sets(real_sets[:1], tenant="node-a", priority=GOSSIP_ATT),
            "tampered": t_off.encode_sets(_swapped(real_sets[:2]), tenant="node-b"),
            "zero_sets": t_off.encode_sets([]),
            "length_mismatch": t_off.encode_sets(real_sets[:2])[:-1],
            "unknown_class": t_off.encode_sets(real_sets[:1]) + b"\xc3\x01\x63\x01\x00a",
            "short": b"\x00",
        }
        want = {"valid_legacy": True, "valid_stamped": True, "tampered": False,
                "zero_sets": False}
        for name, frame in frames.items():
            a = t_srv.LocalStub(port._verify)(frame)
            b = t_srv.LocalStub(ref._verify)(frame)
            assert a == b, name
            if name in want:
                assert t_off.decode_verdict(a, request=frame) is want[name]
            else:
                assert a[0] == 2, name  # the error frame
        assert port.tenancy.served == ref.tenancy.served == {"default": 2, "node-a": 1,
                                                             "node-b": 1}
        assert port._depth() == ref._depth() == 0
    finally:
        port.stop()
        ref.stop()


def test_server_shed_frames_are_bytes_equal(real_sets):
    port, ref = _server_pair(tenant_shed_depth=0, tenant_reject_depth=0)
    try:
        for priority in (GOSSIP_BLOCK, BACKFILL):
            frame = t_off.encode_sets(real_sets[:1], tenant="t", priority=priority)
            a, b = port._verify(frame, _Ctx()), ref._verify(frame, _Ctx())
            assert a == b and a[0] == 3
            with pytest.raises(t_off.OffloadShed):
                t_off.decode_verdict(a, request=frame)
        # a legacy frame accounts to the default tenant and sheds the same way
        frame = t_off.encode_sets(real_sets[:1])
        assert port._verify(frame, _Ctx()) == ref._verify(frame, _Ctx())
        assert port.tenancy.shed == ref.tenancy.shed == {"t": 2, "default": 1}
    finally:
        port.stop()
        ref.stop()


def test_server_slot_wait_shed_inside_the_deadline():
    """A request parked behind a held slot sheds at its deadline less the
    margin, in both servers, with the same frame."""
    outs = []
    for srv_mod in (t_srv, j_srv):
        hold = threading.Event()

        def backend(sets, hold=hold):
            hold.wait(10.0)
            return True

        server = srv_mod.BlsOffloadServer(backend, tenant_slots=1, slot_wait_margin_s=0.1)
        try:
            first = t_off.encode_sets(_dummy(1, tag=1), tenant="t")
            occupier = threading.Thread(target=server._verify, args=(first, _Ctx()))
            occupier.start()
            _wait(lambda: server.tenancy.depth("t") == 1)
            frame = t_off.encode_sets(_dummy(1, tag=2), tenant="t", priority=GOSSIP_ATT)
            t0 = time.monotonic()
            reply = server._verify(frame, _Ctx(remaining=0.3))
            waited = time.monotonic() - t0
            hold.set()
            occupier.join(timeout=10)
            assert 0.15 <= waited < 1.0
            outs.append((reply, dict(server.tenancy.shed)))
        finally:
            hold.set()
            server.stop()
    assert outs[0] == outs[1] and outs[0][0][0] == 3 and outs[0][1] == {"t": 1}


def test_server_trailing_spans_agree(real_sets):
    port, ref = _server_pair()
    spans = []
    try:
        for server, tr in ((port, t_tr), (ref, j_tr)):
            names = []
            for frame in (t_off.encode_sets(real_sets[:1], tenant="a"),  # served
                          b"\x05\x00\x00\x00"):  # an error frame ships its spans too
                ctx = _Ctx(tr, "0000002a:1:9")
                server._verify(frame, ctx)
                key, payload = ctx.trailers[0]
                assert key == tr.TRACE_SPANS_KEY
                items = json.loads(payload)
                names.append([(i["name"], sorted(i["attrs"])) for i in items])
            ctx = _Ctx(tr)  # no header: no trailing metadata
            server._verify(t_off.encode_sets(_dummy(1)), ctx)
            assert ctx.trailers is None
            spans.append(names)
    finally:
        port.stop()
        ref.stop()
    assert spans[0] == spans[1] == [
        [("offload_decode", []), ("offload_device_verify", ["sets", "tenant"])],
        [("offload_decode", ["error"])],
    ]


def test_server_metrics_and_deadline_model(real_sets):
    from lodestar_tpu_torch.slo import SlotDeadlineModel

    logs = []
    for srv_mod in (t_srv, j_srv):
        m = _TenantMetrics()
        dm = SlotDeadlineModel(genesis_time=0, seconds_per_slot=12, time_fn=lambda: 1_000.0)
        server = srv_mod.BlsOffloadServer(lambda sets: True, tenant_metrics=m,
                                          tenant_weights={"a": 2}, deadline_model=dm)
        try:
            server._verify(t_off.encode_sets(_dummy(3), tenant="a", priority=GOSSIP_BLOCK),
                           _Ctx())
        finally:
            server.stop()
        logs.append(m.log)
    assert logs[0] == logs[1]
    assert ("served_sets", ("a",), "inc", 3) in logs[0]
    assert ("slack", ("a", "gossip_block"), "observe", "float") in logs[0]


def test_local_transports_dispatch_in_process(real_sets):
    server = t_srv.BlsOffloadServer(t_api.verify_signature_sets)
    seen = []

    def wrap(target, method, fn):
        seen.append((target, method))
        return fn

    try:
        wrapper = t_srv.local_transports({"h": server}, wrap=wrap)
        verify, status = wrapper("h", "verify", None), wrapper("h", "status", None)
        dialed = object()
        assert wrapper("elsewhere", "verify", dialed) is dialed
        frame = t_off.encode_sets(real_sets[:1])
        reply, call = verify.with_call(frame, timeout=5.0,
                                       metadata=((t_tr.TRACE_CONTEXT_KEY, "1:1:"),))
        assert t_off.decode_verdict(reply, request=frame) is True
        assert call.trailing_metadata()[0][0] == t_tr.TRACE_SPANS_KEY
        st = t_off.decode_status(status(b""))
        assert st.tenant_capable and st.capacity == 1 and st.can_accept
        assert seen == [("h", "verify"), ("h", "status"), ("elsewhere", "verify")]
        assert t_srv.SERVICE_NAME == j_srv.SERVICE_NAME
        assert (t_srv.VERIFY_METHOD, t_srv.STATUS_METHOD) == (j_srv.VERIFY_METHOD,
                                                              j_srv.STATUS_METHOD)
        ctx = t_srv._LocalContext(timeout_s=2.0, clock=lambda: 10.0)
        assert ctx.time_remaining() == 2.0 and t_srv._LocalContext().time_remaining() is None
    finally:
        server.stop()


@pytest.mark.parametrize("chips", [[], [(100, False)], [(200, False), (900, True)],
                                   [(0, True)], [(400, False), (801, False)]])
def test_fleet_occupancy_agrees(chips):
    assert t_srv.fleet_occupancy_permille(chips) == j_srv.fleet_occupancy_permille(chips)


# -- a CPU mesh lane behind the server ----------------------------------------------


@pytest.fixture(scope="module")
def cpu_mesh():
    return t_mesh.build_device_mesh("off", device="cpu")


def test_size8_frame_through_a_cpu_mesh_lane(real_sets, cpu_mesh):
    """One frame of 8 sets through the lane's device model (the plain path
    on the CPU), as `build_server` wires the mesh: True, one launch, the
    breaker clean, the chip table in the Status frame."""
    mesh = cpu_mesh
    lane = mesh.lanes[0]

    def backend(sets, _mesh=mesh):
        ok, _lane = t_mesh.mesh_launch(_mesh, sets)
        return ok

    server = t_srv.BlsOffloadServer(backend, chip_status_fn=mesh.chip_table)
    try:
        launches = lane.launches
        frame = t_off.encode_sets(real_sets[:8], tenant="a", priority=API)
        reply = t_srv.LocalStub(server._verify)(frame)
        assert reply == j_off.encode_verdict(True, request=frame)
        assert lane.launches == launches + 1
        assert lane.breaker.state().name == "CLOSED" and lane.breaker._failures == 0
        st = t_off.decode_status(server._status(b"", None))
        assert len(st.chips) == 1 and not st.chips[0].wedged and st.tenant_capable
    finally:
        server.stop()


def test_lane_fault_reaches_the_wire_and_charges_the_breaker(cpu_mesh):
    """A device fault in the backend is the error frame on the wire (the
    JAX server's fail-closed reply, not a fallback) and one failure on the
    lane's breaker, charged by `mesh_launch`."""
    mesh = t_mesh.VerifierMesh([t_mesh.MeshLane(0, cpu_mesh.lanes[0].verify_fn)])
    lane = mesh.lanes[0]

    def fault(sets):
        raise RuntimeError("device fault")

    lane.verify_fn = fault

    def backend(sets, _mesh=mesh):
        return t_mesh.mesh_launch(_mesh, sets)[0]

    server = t_srv.BlsOffloadServer(backend, chip_status_fn=mesh.chip_table)
    try:
        frame = t_off.encode_sets(_dummy(1))
        reply = t_srv.LocalStub(server._verify)(frame)
        assert reply == j_off.encode_verdict(None, error="RuntimeError: device fault")
        with pytest.raises(t_off.OffloadError, match="device fault"):
            t_off.decode_verdict(reply, request=frame)
        assert lane.breaker._failures == 1 and lane.launches == 1
    finally:
        server.stop()


# -- the departures ------------------------------------------------------------------

_NO_GRPC = r"""
import sys
sys.modules["grpc"] = None  # `import grpc` now raises ImportError
sys.modules["jax"] = None
sys.modules["lodestar_tpu"] = None
from lodestar_tpu_torch.offload import server as s, encode_sets, decode_verdict
from lodestar_tpu_torch.crypto.bls.api import SignatureSet
srv = s.BlsOffloadServer(lambda sets: len(sets) == 1)
frame = encode_sets([SignatureSet(bytes(48), bytes(32), bytes(96))], tenant="a")
assert decode_verdict(s.LocalStub(srv._verify)(frame), request=frame) is True
try:
    srv.start()
except ImportError:
    print("start raised ImportError")
assert "torch" not in sys.modules, "the server module loaded torch"
"""


def test_server_imports_and_serves_without_grpc():
    proc = subprocess.run([sys.executable, "-c", _NO_GRPC], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "start raised ImportError" in proc.stdout


@pytest.fixture
def _restore_single_launch():
    prev = bv.configure_single_launch()
    yield
    bv.configure_single_launch(prev)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_build_server_device_mesh_raises_without_cuda(mode, _restore_single_launch):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_srv.build_server(["--bls-mesh", mode, "--bls-single-launch", "on"])
    assert bv.configure_single_launch() == "on"  # the flag was pinned first


def test_build_server_off_serves_the_oracle(real_sets, _restore_single_launch):
    server = t_srv.build_server([
        "--bls-mesh", "off", "--port", "0", "--workers", "3", "--tenant-slots", "1",
        "--tenant-weight", "a=1", "--tenant-weight", "b=3", "--tenant-shed-depth", "5",
        "--genesis-time", "0", "--seconds-per-slot", "6"])
    try:
        assert server.mesh is None and server.backend is t_api.verify_signature_sets
        assert server._server is None and server.port == 0  # built, not started
        assert server.tenancy._weights == {"a": 1, "b": 3} and server.tenancy._slots == 1
        assert server.tenancy.shed_depth == 5
        assert server._deadline_model.seconds_per_slot == 6
        for sets, want in ((real_sets[:1], True), (_swapped(real_sets[:2]), False)):
            frame = t_off.encode_sets(sets, tenant="b")
            assert t_off.decode_verdict(t_srv.LocalStub(server._verify)(frame),
                                        request=frame) is want
        assert server.tenancy.served == {"b": 2}
    finally:
        server.stop()


def test_build_server_has_no_metrics_port_flag(capsys):
    with pytest.raises(SystemExit):
        t_srv.build_server(["--bls-mesh", "off", "--metrics-port", "9100"])
    assert "--metrics-port" in capsys.readouterr().err


# -- over a real gRPC socket: the JAX client against the port's server ----------------


def _wait_capable(client):
    _wait(lambda: all(s["tenant_capable"] for s in client.endpoint_states()))


def test_jax_client_against_the_port_server_over_grpc(real_sets):
    from lodestar_tpu.chain.bls.interface import VerifySignatureOpts
    from lodestar_tpu.offload.client import BlsOffloadClient

    server = t_srv.BlsOffloadServer(t_api.verify_signature_sets)
    server.start()
    assert server.port > 0
    client = BlsOffloadClient(f"127.0.0.1:{server.port}", probe_interval_s=0.05,
                              tenant="node-a")
    j_tr.reset()
    j_tr.configure(enabled=True, slow_slot_ms=60_000.0)
    try:
        _wait_capable(client)
        opts = VerifySignatureOpts(priority=GOSSIP_ATT)

        async def go():
            with j_tr.root("block_import", slot=4) as root:
                good = await client.verify_signature_sets(real_sets[:2], opts)
                bad = await client.verify_signature_sets(_swapped(real_sets[:2]), opts)
            return good, bad, root

        good, bad, root = asyncio.run(go())
        assert (good, bad) == (True, False)
        assert server.tenancy.served == {"node-a": 2}  # the tenant trailer was accounted
        spans = root.trace.spans
        rpcs = [s for s in spans if s.name == "offload_rpc"]
        assert len(rpcs) == 2
        for rpc in rpcs:
            kids = sorted(s.name for s in spans if s.parent_id == rpc.span_id)
            assert kids == ["offload_decode", "offload_device_verify"]
            assert all(s.attrs["remote"] is True for s in spans if s.parent_id == rpc.span_id)
        st = client.endpoint_states()[0]
        assert st["breaker"] == "closed" and st["healthy"] and st["capacity"] == 1
    finally:
        j_tr.reset()
        asyncio.run(client.close())
        server.stop()


def test_jax_client_gets_a_quota_shed_from_the_port_server(real_sets):
    from lodestar_tpu.chain.bls.interface import VerifySignatureOpts
    from lodestar_tpu.offload.client import BlsOffloadClient

    calls = []
    server = t_srv.BlsOffloadServer(lambda sets: calls.append(len(sets)) or True,
                                    tenant_shed_depth=0, tenant_reject_depth=0)
    server.start()
    client = BlsOffloadClient(f"127.0.0.1:{server.port}", probe_interval_s=0.05, tenant="t")
    try:
        _wait_capable(client)

        async def go():
            with pytest.raises(j_off.OffloadShed) as ei:
                await client.verify_signature_sets(
                    real_sets[:1], VerifySignatureOpts(priority=BACKFILL))
            return ei.value

        shed = asyncio.run(go())
        assert int(shed.state) == 2 and "tenant quota" in str(shed)
        assert calls == [] and server.tenancy.shed == {"t": 1}
        st = client.endpoint_states()[0]
        assert st["breaker"] == "closed" and st["healthy"]  # alive and refusing: not sick
    finally:
        asyncio.run(client.close())
        server.stop()
