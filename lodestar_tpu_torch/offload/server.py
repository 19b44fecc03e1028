"""Offload service host: the process that owns the accelerator fleet.

The PyTorch port's copy of ``lodestar_tpu/offload/server.py``. It exposes
the verify backend over gRPC generic handlers (opaque-bytes methods — no
proto codegen needed in this environment):

  /lodestar.BlsOffload/VerifySignatureSets   sets frame -> verdict frame
  /lodestar.BlsOffload/Status                b"" -> occupancy status frame

Status grades the old binary can-accept byte into an occupancy frame
(EWMA busy-ns/wall-ns around device launches, in-flight depth, and an
ACCEPT/SHED_BULK/REJECT admission state) so a multi-endpoint client can
prefer the least-occupied host and keep bulk work off a shedding one.
Byte 0 keeps the legacy meaning — old clients read it unchanged. A
mesh-backed host appends the per-chip table (occupancy + wedged flag
per lane) so client routing sees FLEET headroom: a wedged/quarantined
chip drops out of the advertised capacity within one probe interval.

Multi-tenant front-end (`offload/tenancy.py`): verify frames may carry
a tenant trailer (identity + launch class). Per-tenant admission quotas
layer on the graded admission — a tenant over its depth quota gets the
shed frame instead of service — and admitted work is granted backend
slots in stride-fair cross-tenant order, so one greedy beacon node
cannot starve the rest. Legacy clients (no trailer) account to the
`default` tenant and parse every reply they always did.

Run standalone next to the GPUs (`python -m lodestar_tpu_torch.offload.server
--port 50051`), with beacon nodes connecting via the JAX package's
`BlsOffloadClient` over the network (SURVEY §2d). Each frame is one
`mesh_launch` on the port's device mesh: on CUDA one replay of the
single-launch graph of the frame's pow-2 size class.

Departures from the JAX package's server:

(a) `grpc` is imported only where a socket is bound: `start()` builds
    the gRPC server and binds the port, so `port` is known after
    `start()`. Importing this module, the constructor and the in-process
    seam (`LocalStub`, `local_transports`) work on a machine without
    `grpc`; `start()` there raises the ImportError — nothing falls back
    to another wire.
(b) `main()` is `build_server(argv)` plus the signal loop: `build_server`
    parses the flags and returns the server it builds, unstarted, with
    its mesh (`server.mesh`, None on the oracle backend).
(c) `--bls-mesh auto` and `on` serve the CUDA mesh
    (`chain/bls/mesh.build_device_mesh`), also on one GPU, after pinning
    the single-launch mode from `--bls-single-launch` and capturing every
    size class the pool launches (`POOL_SIZE_CLASSES`, 8-1,024) on each
    lane; without CUDA they raise. `--bls-mesh off` is the explicit ask
    for the CPU oracle (`crypto.bls.api.verify_signature_sets`). The JAX
    server's oracle backend on a single-device `auto` and its swallowed
    ImportError of the model are not copied: both hide the device.
(d) `--metrics-port` is not ported (it needs `prometheus_client`); the
    constructor keeps its duck-typed `tenant_metrics=` argument.
"""

from __future__ import annotations

import threading
import time

from .. import tracing
from ..logger import get_logger
from ..scheduler import (
    AdmissionController,
    AdmissionState,
    OccupancyTracker,
    PriorityClass,
)

from . import (
    DEFAULT_TENANT,
    decode_sets_ex,
    encode_shed,
    encode_status,
    encode_verdict,
)
from .tenancy import TenantScheduler

__all__ = [
    "BlsOffloadServer",
    "SERVICE_NAME",
    "VERIFY_METHOD",
    "STATUS_METHOD",
    "LocalStub",
    "local_transports",
    "build_server",
    "main",
]

SERVICE_NAME = "lodestar.BlsOffload"
VERIFY_METHOD = f"/{SERVICE_NAME}/VerifySignatureSets"
STATUS_METHOD = f"/{SERVICE_NAME}/Status"


def _identity(b: bytes) -> bytes:
    return b


# -- in-process transport seam --------------------------------------------------
#
# A fleet harness runs N clients against M servers IN ONE PROCESS, and a
# host without grpc can still drive its server: these
# shims dispatch a client's stub calls straight into the server's
# handlers — the exact `_verify`/`_status` code paths the wire exercises
# (tenancy, admission, trailing-metadata trace spans, digest-checked
# verdicts), minus the socket. They plug into `BlsOffloadClient`'s
# `transport_wrapper` hook, the same seam the fault injector uses, so a
# `FaultInjector` chains IN FRONT of the local dispatch and every edge
# still sees its faults.


class _LocalContext:
    """Duck-typed grpc.ServicerContext for in-process dispatch: carries
    invocation metadata in, a deadline for `time_remaining()`, and the
    trailing metadata the handler sets back out."""

    def __init__(self, metadata=None, timeout_s: float | None = None, clock=None):
        self._metadata = tuple(metadata or ())
        self._clock = clock if clock is not None else time.monotonic
        self._deadline = self._clock() + timeout_s if timeout_s is not None else None
        self.trailing = ()

    def invocation_metadata(self):
        return self._metadata

    def time_remaining(self):
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - self._clock())

    def set_trailing_metadata(self, md) -> None:
        self.trailing = tuple(md or ())


class _LocalCall:
    """grpc.Call twin for `.with_call`: hands back the trailing metadata
    the handler set on its context."""

    def __init__(self, ctx: _LocalContext):
        self._ctx = ctx

    def trailing_metadata(self):
        return self._ctx.trailing


class LocalStub:
    """In-process unary-unary callable: the shapes the client uses
    (`__call__` and `.with_call`) dispatched straight into a server
    handler on the calling thread."""

    def __init__(self, handler, clock=None):
        self._handler = handler
        self._clock = clock

    def __call__(self, request: bytes, timeout=None, metadata=None) -> bytes:
        resp, _call = self.with_call(request, timeout=timeout, metadata=metadata)
        return resp

    def with_call(self, request: bytes, timeout=None, metadata=None):
        ctx = _LocalContext(metadata, timeout, self._clock)
        return self._handler(request, ctx), _LocalCall(ctx)


def local_transports(servers: dict, *, wrap=None, clock=None):
    """Build a `BlsOffloadClient(transport_wrapper=...)` that serves
    `servers[target]` in-process instead of dialing. `wrap(target,
    method, fn)` — e.g. `FaultInjector.wrap_transport` — chains a fault
    seam in front of the local dispatch; unknown targets keep the dialed
    stub (mixed local/remote deployments still work). `clock` feeds the
    local contexts' `time_remaining()` (a `SimClock.monotonic` under the
    fleet harness)."""

    def wrapper(target: str, method: str, fn):
        server = servers.get(target)
        if server is not None:
            fn = LocalStub(
                server._verify if method == "verify" else server._status, clock=clock
            )
        return fn if wrap is None else wrap(target, method, fn)

    return wrapper


class _Replied(Exception):
    """Internal _verify control flow: the reply (`out`) is already
    built — skip the verify leg but still run the finally + trailing-
    metadata blocks every reply path shares."""


def fleet_occupancy_permille(chips) -> int:
    """THE fleet-occupancy aggregate: mean over healthy (non-wedged)
    chips, 1000 (pinned) when none is healthy. Shared by the Status
    frame and the admission grader so the two can never diverge."""
    healthy = [int(occ) for occ, wedged in chips if not wedged]
    if not healthy:
        return 1000
    return max(0, min(1000, int(round(sum(healthy) / len(healthy)))))


class _FleetOccupancyView:
    """Admission-grading occupancy for a mesh-backed host: mean busy
    fraction over HEALTHY chips (matching the Status frame's fleet
    field). The server-level tracker measures "any RPC in flight",
    which saturates toward 1.0 under modest multi-chip load and would
    advertise REJECT while chips idle. Falls back to the server-level
    tracker if the chip table errors."""

    def __init__(self, chip_status_fn, fallback: OccupancyTracker) -> None:
        self._fn = chip_status_fn
        self._fallback = fallback

    def occupancy(self) -> float:
        try:
            return fleet_occupancy_permille(self._fn()) / 1000.0
        except Exception:
            return self._fallback.occupancy()


class BlsOffloadServer:
    """gRPC host around a verify backend.

    backend(sets) -> bool may be sync or return an awaitable-free bool;
    can_accept_work() -> bool stays the hard veto (mirrors the pool's
    MAX_JOBS semantics when the backend is a BlsDeviceVerifierPool);
    on top of it the server tracks per-launch occupancy and grades
    admission — injectable `admission` (anything with .state()) lets
    tests and smarter hosts replace the policy.

    `tenancy` (a TenantScheduler, or None to build a default one from
    the tenant_* kwargs) owns per-tenant quotas + stride-fair service.
    `chip_status_fn` () -> [(occupancy_permille, wedged)] feeds the
    Status frame's mesh trailer; default: one pseudo-chip from the
    server-level tracker (single-die hosts advertise exactly what they
    are). Hosts serving a `BlsDeviceVerifierPool` pass the pool mesh's
    `chip_table`."""

    def __init__(
        self,
        backend,
        *,
        can_accept_work=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_workers: int = 4,
        occupancy_tracker: OccupancyTracker | None = None,
        admission=None,
        shed_bulk_at: float = 0.75,
        reject_at: float = 0.95,
        tenancy: TenantScheduler | None = None,
        tenant_weights: dict[str, int] | None = None,
        tenant_default_weight: int | None = None,
        tenant_slots: int | None = None,
        tenant_shed_depth: int | None = None,
        tenant_reject_depth: int | None = None,
        tenant_metrics=None,
        chip_status_fn=None,
        slot_wait_margin_s: float = 0.5,
        deadline_model=None,
    ) -> None:
        self.backend = backend
        self._can_accept_work = can_accept_work or (lambda: True)
        self.occupancy = occupancy_tracker or OccupancyTracker()
        self._pending = 0  # guarded by: _pending_lock
        self._pending_lock = threading.Lock()
        self.admission = admission or AdmissionController(
            # a mesh-backed host grades FLEET occupancy, not the
            # single overlapped RPC tracker
            _FleetOccupancyView(chip_status_fn, self.occupancy)
            if chip_status_fn is not None
            else self.occupancy,
            shed_bulk_at=shed_bulk_at,
            reject_at=reject_at,
            depth_fn=self._depth,
            # _pending counts RPCs already ON the gRPC worker threads —
            # the executor queues the rest invisibly, so it never exceeds
            # max_workers. All-workers-busy is therefore the depth signal
            # for SHED_BULK; deeper backlog surfaces as occupancy, which
            # alone drives REJECT (depth-based REJECT is unreachable)
            shed_bulk_depth=max(1, max_workers),
            reject_depth=1 << 30,
            can_accept=self._can_accept_work,
        )
        tenancy_kwargs = {
            # service slots default to the worker count: the scheduler
            # then never blocks beyond what gRPC already bounds, so a
            # single-tenant deployment behaves exactly like the
            # pre-tenancy server
            "slots": max_workers if tenant_slots is None else tenant_slots,
            "weights": tenant_weights,
            "metrics": tenant_metrics,
        }
        if tenant_default_weight is not None:
            tenancy_kwargs["default_weight"] = tenant_default_weight
        if tenant_shed_depth is not None:
            tenancy_kwargs["shed_depth"] = tenant_shed_depth
        if tenant_reject_depth is not None:
            tenancy_kwargs["reject_depth"] = tenant_reject_depth
        self.tenancy = tenancy or TenantScheduler(**tenancy_kwargs)
        self._tenant_metrics = tenant_metrics
        # slot-deadline model (the port's slo.SlotDeadlineModel, or
        # None when the host wasn't launched with --genesis-time): lets
        # a multi-tenant host observe per-tenant remaining deadline
        # slack at verdict time — "which tenant are we serving too late"
        self._deadline_model = deadline_model
        self._chip_status_fn = chip_status_fn
        # reply-wire + expected-backend-launch reserve subtracted from
        # the caller's RPC deadline when waiting for a service slot
        self.slot_wait_margin_s = slot_wait_margin_s
        self.log = get_logger(name="lodestar.offload")
        # the gRPC server is built and bound in start(): the in-process
        # seam (LocalStub) needs no grpc, and a machine without it can
        # still serve frames in-process
        self._max_workers = max_workers
        self._server = None
        self.host = host
        self.port = port
        self.mesh = None  # the served VerifierMesh, set by build_server

    def _depth(self) -> int:
        """In-flight RPC count for admission/status — locked, so the
        grader never folds a torn read into its thresholds."""
        with self._pending_lock:
            return self._pending

    def _chip_table(self) -> list[tuple[int, bool]]:
        """Per-chip (occupancy_permille, wedged) for the Status mesh
        trailer; errors degrade to the single-die view rather than
        failing the probe."""
        if self._chip_status_fn is not None:
            try:
                return [(int(occ), bool(w)) for occ, w in self._chip_status_fn()]
            except Exception:
                pass
        return [(self.occupancy.occupancy_permille(), False)]

    # -- handlers --------------------------------------------------------------

    def _verify(self, request: bytes, context) -> bytes:
        # caller-propagated trace context: when present, record the
        # server-side decode/verify spans and ship them back in trailing
        # metadata so the client grafts them under its RPC span
        hdr = None
        try:
            for k, v in context.invocation_metadata() or ():
                if k == tracing.TRACE_CONTEXT_KEY:
                    hdr = v
        except Exception:
            hdr = None
        rec = tracing.remote_recorder(hdr)
        with self._pending_lock:
            self._pending += 1
        tenant = DEFAULT_TENANT
        granted = False
        try:
            with rec.span("offload_decode"):
                sets, trailer = decode_sets_ex(request)
            priority = PriorityClass.API
            if trailer is not None:
                tenant = trailer.tenant
                priority = trailer.priority
            # per-tenant quota grading, then the stride-fair slot wait —
            # both sheds answer with the shed frame (alive, refusing),
            # never an error frame (sick)
            if not self.tenancy.admits(tenant, priority):
                state = self.tenancy.admission_for(tenant)
                self.tenancy.count_shed(tenant, priority, "quota")
                self.log.info(
                    "offload admission shed",
                    {"tenant": tenant, "class": priority.label, "state": state.label},
                )
                # NOT an early return: shed replies fall through to the
                # trailing-metadata block too — a shed storm is exactly
                # when the operator needs the server-side trace legs
                out = encode_shed(
                    state, f"tenant quota ({state.label})", request=request
                )
                raise _Replied()
            # the slot wait must resolve INSIDE the caller's RPC
            # deadline: a shed frame the client never receives becomes
            # DEADLINE_EXCEEDED on its side — a transport failure that
            # charges the endpoint's breaker as sick, exactly what the
            # shed frame exists to prevent. The margin must also cover
            # the BACKEND launch after a grant — a grant at deadline
            # minus epsilon converts the shed into the same
            # DEADLINE_EXCEEDED mid-verify. slot_wait_margin_s should
            # therefore sit above the host's typical launch time; no
            # deadline metadata = scheduler cap.
            slot_wait = None
            try:
                remaining = context.time_remaining()
                if remaining is not None:
                    slot_wait = max(0.0, remaining - self.slot_wait_margin_s)
            except Exception:
                pass
            if not self.tenancy.acquire(tenant, priority, timeout_s=slot_wait):
                self.tenancy.count_shed(tenant, priority, "slot_timeout")
                out = encode_shed(
                    AdmissionState.REJECT,
                    "service slot wait timed out",
                    request=request,
                )
                raise _Replied()
            granted = True
            # tenant identity rides the server-side span home: a Chrome
            # trace of a multi-tenant slot names who each verify served
            with rec.span("offload_device_verify", sets=len(sets), tenant=tenant):
                with self.occupancy.launch():
                    ok = bool(self.backend(sets))
            m = self._tenant_metrics
            if m is not None:
                m.served_sets.labels(tenant).inc(len(sets))
                dm = self._deadline_model
                if dm is not None:
                    try:
                        # anchored at the wall-clock slot: the wire
                        # trailer carries tenant+class, not the subject
                        # slot, so the host measures "slack left in the
                        # slot being served right now" — negative means
                        # this tenant's verdicts are landing past the
                        # class cutoff
                        m.slack.labels(tenant, priority.label).observe(
                            dm.slack_s(priority)
                        )
                    except Exception:
                        pass  # slack observation must never fail a verdict
            # digest-checked verdict: binds this reply to this request
            # frame so corruption/splicing fails closed at the client
            out = encode_verdict(ok, request=request)
        except _Replied:
            pass  # `out` already holds the shed frame
        except Exception as e:  # error frame, not a transport abort
            self.log.warn("verify job failed", {"error": str(e), "tenant": tenant})
            out = encode_verdict(None, error=f"{type(e).__name__}: {e}")
        finally:
            if granted:
                self.tenancy.release(tenant)
            with self._pending_lock:
                self._pending -= 1
        payload = rec.serialize()
        if payload:
            try:
                context.set_trailing_metadata(((tracing.TRACE_SPANS_KEY, payload),))
            except Exception:
                pass  # a metadata-less transport must not fail the verdict
        return out

    def _status(self, request: bytes, context) -> bytes:
        chips = self._chip_table()
        # fleet occupancy (healthy-chip mean, same helper the admission
        # grader uses): legacy v1-prefix readers also rank this host by
        # its headroom, not one die
        return encode_status(
            occupancy_permille=fleet_occupancy_permille(chips),
            queue_depth=self._depth(),
            admission=self.admission.state(),
            chips=chips,
            tenant_capable=True,
        )

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        """Build the gRPC server, bind `host:port` (0 picks a free port,
        read back into `port`) and start serving. Raises ImportError
        where grpc is missing."""
        import grpc
        from concurrent import futures

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=self._max_workers))
        handlers = {
            "VerifySignatureSets": grpc.unary_unary_rpc_method_handler(
                self._verify, request_deserializer=_identity, response_serializer=_identity
            ),
            "Status": grpc.unary_unary_rpc_method_handler(
                self._status, request_deserializer=_identity, response_serializer=_identity
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        self.port = server.add_insecure_port(f"{self.host}:{self.port}")
        server.start()
        self._server = server
        self.log.info("offload service up", {"port": self.port})

    def stop(self, grace: float = 0.5) -> None:
        self.tenancy.close()
        if self._server is not None:
            self._server.stop(grace)


def build_server(argv=None) -> BlsOffloadServer:
    """The standalone host's construction, without starting it: parse the
    flags (`argv`, default sys.argv[1:]) and build the server around the
    port's own verifier. `--bls-mesh auto`/`on` serve the CUDA mesh (one
    lane per GPU, one on a single GPU) through `mesh_launch`, after the
    single-launch mode is pinned from `--bls-single-launch` and every size
    class the pool launches is captured on each lane (`POOL_SIZE_CLASSES`,
    8-1,024), so serving captures no graph for a frame of at most 1,024
    sets; they raise where CUDA is missing. `--bls-mesh off` serves the
    CPU oracle. The mesh is `server.mesh` (None on the oracle)."""
    import argparse
    import json

    from .tenancy import (
        DEFAULT_TENANT_REJECT_DEPTH,
        DEFAULT_TENANT_SHED_DEPTH,
        parse_tenant_weights,
    )

    ap = argparse.ArgumentParser(prog="python -m lodestar_tpu_torch.offload.server")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument(
        "--bls-mesh", choices=["auto", "on", "off"], default="auto",
        help="serve the CUDA device mesh: one launch lane per GPU (auto and "
        "on; raises without CUDA); off = CPU oracle backend",
    )
    ap.add_argument(
        # literal copy of models.batch_verify.SINGLE_LAUNCH_MODES
        # (re-validated by configure_single_launch below)
        "--bls-single-launch", choices=["auto", "on", "off"], default="auto",
        help="verify each served batch as ONE CUDA-graph replay: auto = on "
        "CUDA, on = always, off = pin the split prep-then-verify schedule",
    )
    ap.add_argument(
        "--tenant-weight", action="append", default=[], metavar="NAME=WEIGHT",
        help="stride-fair service share for a tenant (repeatable); unlisted "
        "tenants get --tenant-default-weight",
    )
    ap.add_argument("--tenant-default-weight", type=int, default=1)
    ap.add_argument(
        "--tenant-slots", type=int, default=None,
        help="concurrent backend service slots the stride scheduler grants "
        "(default: --workers, which never queues — set BELOW --workers to "
        "make cross-tenant fairness and quota sheds actually arbitrate; "
        "e.g. the chip count of the served mesh)",
    )
    ap.add_argument(
        "--tenant-shed-depth", type=int, default=DEFAULT_TENANT_SHED_DEPTH,
        help="per-tenant pending+running depth at which bulk classes shed",
    )
    ap.add_argument(
        "--tenant-reject-depth", type=int, default=DEFAULT_TENANT_REJECT_DEPTH,
        help="per-tenant pending+running depth at which everything sheds",
    )
    ap.add_argument(
        "--genesis-time", type=int, default=None,
        help="chain genesis timestamp (unix seconds): enables the per-tenant "
        "slot-deadline slack observation at verdict time (tenant_metrics)",
    )
    ap.add_argument(
        "--seconds-per-slot", type=int, default=12,
        help="slot length for the deadline model (with --genesis-time)",
    )
    args = ap.parse_args(argv)

    mesh = None
    chip_status_fn = None
    if args.bls_mesh == "off":
        from ..crypto.bls.api import verify_signature_sets as backend
    else:
        # serve the mesh synchronously: mesh_launch keeps the per-chip
        # wedge accounting + cross-lane error retry (a sick chip trips
        # ITS breaker, drops out of the advertised chip table, and
        # self-offers after the reset delay); the server's slot
        # scheduler bounds concurrency per tenant above it
        from ..chain.bls.mesh import build_device_mesh, mesh_launch
        from ..chain.bls.pool import POOL_SIZE_CLASSES
        from ..models import batch_verify as bv

        bv.configure_single_launch(mode=args.bls_single_launch)
        mesh = build_device_mesh(args.bls_mesh)
        for lane in mesh.lanes:
            if bv.single_launch_active(device=lane.device):
                bv.warm_single_launch(POOL_SIZE_CLASSES, device=lane.device)
        chip_status_fn = mesh.chip_table

        def backend(sets, _mesh=mesh):
            ok, _lane = mesh_launch(_mesh, sets)
            return ok

    deadline_model = None
    if args.genesis_time is not None:
        from ..slo import SlotDeadlineModel

        deadline_model = SlotDeadlineModel(
            genesis_time=args.genesis_time,
            seconds_per_slot=args.seconds_per_slot,
        )

    weights = parse_tenant_weights(args.tenant_weight)
    server = BlsOffloadServer(
        backend,
        port=args.port,
        max_workers=args.workers,
        tenant_weights=weights,
        tenant_default_weight=args.tenant_default_weight,
        # default: workers (never queues — single-tenant hosts behave
        # exactly like the pre-tenancy server); fairness enforcement
        # needs slots < concurrent demand, e.g. the mesh's chip count
        tenant_slots=args.workers if args.tenant_slots is None else args.tenant_slots,
        tenant_shed_depth=args.tenant_shed_depth,
        tenant_reject_depth=args.tenant_reject_depth,
        chip_status_fn=chip_status_fn,
        deadline_model=deadline_model,
    )
    server.mesh = mesh
    # surface the effective tenancy config once, for operators' logs
    server.log.info(
        "offload tenancy",
        {"weights": json.dumps(weights), "default_weight": args.tenant_default_weight},
    )
    return server


def main(argv=None) -> int:
    """Standalone entry: build the host (`build_server`), serve until
    SIGTERM or SIGINT, then stop."""
    import signal

    server = build_server(argv)
    server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
