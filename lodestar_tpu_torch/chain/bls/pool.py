"""Device BLS verifier pool: buffering, chunking, retry, fail-closed.

The PyTorch port's copy of ``lodestar_tpu/chain/bls/pool.py``, with the
same constants, pipeline modes, scheduler and admission controller; its
default lanes run the port's device model (``models/batch_verify.py``) on
CUDA, or on the device the caller names (`device=`). Its Prometheus
wiring (scheduler and pipeline gauges) is not copied.

Asyncio re-design of `BlsMultiThreadWorkerPool`
(reference `beacon-node/src/chain/bls/multithread/index.ts:103`) with the
N-worker thread pool replaced by one device pipeline:

* **Buffering** (`index.ts:277-291`): batchable jobs accumulate up to
  MAX_BUFFER_WAIT_MS (100 ms) or MAX_BUFFERED_SIGS (32), then flush as one
  batch — gossip bursts amortize into single device launches.
* **Chunking** (`index.ts:34-39`): big arrays (sync submits ~8k sets) are
  split ≤ MAX_SIGNATURE_SETS_PER_JOB (128) per job; jobs queue
  independently so a long sync batch never head-of-line-blocks gossip.
* **Batch-then-retry** (`worker.ts:52-96`): batchable chunks ≥
  BATCHABLE_MIN_PER_CHUNK are RLC-batch-verified; an invalid batch is
  re-verified per-job so one bad signature can't poison its neighbors.
  `batch_retries` / `batch_sigs_success` counters keep the reference's
  metric semantics.
* **Fail-closed** (`index.ts:386-393` analogue): any backend error rejects
  the job with the error — it never resolves True. Callers treat rejection
  as invalid-block/peer-downscore, exactly like the reference.
* **Mesh lanes** (`chain/bls/mesh.py`): the pool serves a `VerifierMesh`
  of per-device launch lanes. One dispatcher waits for a free lane,
  dequeues through the shared priority queue, and places the package:
  latency-class work goes to the least-occupied free chip; on a mesh
  with a collective (the mesh's `sharded_fn`,
  `verify_signature_sets_sharded`; `build_device_mesh` attaches none),
  bulk range-sync/backfill batches big enough to amortize the extra
  launches go data-parallel across the idle chips.
  With a single visible device the mesh is one lane and the launch
  schedule is bit-identical to the pre-mesh pool (regression-tested).
* **Wedge detection** (`offload/resilience.CircuitBreaker`): each lane
  carries its OWN wedge breaker — consecutive launch errors on a chip
  open it, the dispatcher stops placing work there, and in-flight work
  retries on a sibling lane, so one sick device degrades the pool to an
  (N-1)-chip mesh. Only when EVERY lane is wedged does the pool report
  is_down() and the degradation chain routes around it; after the reset
  delay a wedged lane self-offers again.
* **Admission** (`index.ts:143-149`): can_accept_work() false once
  MAX_JOBS_CAN_ACCEPT_WORK (512) jobs are outstanding — backpressure
  signal for the gossip processor.
* **Scheduling** (`lodestar_tpu/scheduler`): launches dequeue through a
  priority-class queue (gossip block > gossip attestation > API >
  range sync > backfill; stride-weighted-fair + starvation aging)
  instead of FIFO, so a slot-deadline block never queues behind a
  backfill batch. Bulk-class jobs run one per package — the bound on
  how long they can head-of-line-block an arriving urgent job. Device
  launches feed per-lane EWMA occupancy trackers whose mesh aggregate
  backs a graded ACCEPT/SHED_BULK/REJECT admission view. `scheduler_enabled=False` restores arrival
  order (the control arm for the saturation tests).

The verify backend is injected as a callable (default: the device model
`models.batch_verify.verify_signature_sets_device`, pinned to the pool's
device, with its staged road), which keeps the seam
mockable and lets tests drive the retry paths deterministically; passing
an explicit callable pins the pool to a single lane (a mock cannot be
enumerated per device). Tests inject multi-lane topologies via `mesh=`.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time
from typing import Awaitable, Callable, Sequence

from ... import slo, tracing
from ...crypto.bls.api import SignatureSet
from ...logger import get_logger
from ...ops.prep import pad_pow2
from ...scheduler import (
    BULK_CLASSES,
    AdmissionController,
    PriorityClass,
    PriorityWorkQueue,
)

from .interface import IBlsVerifier, VerifySignatureOpts
from .mesh import (
    LANE_WEDGE_THRESHOLD,
    MESH_MODES,
    SHARD_MIN_SETS_PER_LANE,
    MeshLane,
    PreparedSets,
    VerifierMesh,
    build_device_mesh,
    single_lane_mesh,
)

__all__ = [
    "BlsDeviceVerifierPool",
    "chunkify_maximize_chunk_size",
    "MAX_SIGNATURE_SETS_PER_JOB",
    "MAX_BUFFERED_SIGS",
    "MAX_BUFFER_WAIT_MS",
    "MAX_JOBS_CAN_ACCEPT_WORK",
    "BATCHABLE_MIN_PER_CHUNK",
    "MAX_PACKAGE_SETS",
    "POOL_SIZE_CLASSES",
    "PIPELINE_MODES",
]

#: prep→verify pipeline modes: "auto" double-buffers
#: only when the mesh has a sibling lane to stage prep on (a 1-lane /
#: no-mesh pool keeps the exact pre-pipeline launch schedule), "on"
#: forces the overlap even on one chip (prep of batch k+1 interleaves
#: with the verify of batch k on the same die — the host byte work and
#: the prep launches slot into the verify program's gaps), "off" keeps
#: prep inline with the launch. With the single-launch path active the
#: staged prep is host byte-parse only (the whole device chain is batch
#: k's one graph replay), so the overlap is host parse of k+1 vs the
#: replay of k.
PIPELINE_MODES = ("auto", "on", "off")

# tuning constants — same values/rationale as the reference (index.ts:30-62)
MAX_SIGNATURE_SETS_PER_JOB = 128
MAX_BUFFERED_SIGS = 32
MAX_BUFFER_WAIT_MS = 100
MAX_JOBS_CAN_ACCEPT_WORK = 512
BATCHABLE_MIN_PER_CHUNK = 16  # worker.ts:11-17
# consecutive backend errors before ONE LANE reports itself wedged —
# the pre-mesh pool-wide threshold carried over per chip. THE value
# lives in mesh.py (LANE_WEDGE_THRESHOLD, shared with the standalone
# offload host); this alias keeps the pre-mesh export name
DEVICE_WEDGE_THRESHOLD = LANE_WEDGE_THRESHOLD
# sets per launch package under the scheduler: a queued attestation
# flood must not coalesce into one giant package that head-of-line
# blocks an arriving gossip block for its whole duration
MAX_PACKAGE_SETS = 4 * MAX_SIGNATURE_SETS_PER_JOB


def _pool_size_classes() -> tuple[int, ...]:
    """Every pow-2 size class (floor 8) a package can launch: a package
    drains jobs while it holds fewer than MAX_PACKAGE_SETS sets, so its
    last job (at most MAX_SIGNATURE_SETS_PER_JOB sets) can take it to one
    set short of their sum, and a launch unit is at most one package."""
    top = pad_pow2(MAX_PACKAGE_SETS + MAX_SIGNATURE_SETS_PER_JOB - 1)
    return tuple(1 << k for k in range(pad_pow2(1).bit_length() - 1, top.bit_length()))


#: the size classes a serving process captures before it takes traffic
#: (models `warm_single_launch`): 8 through 1024
POOL_SIZE_CLASSES = _pool_size_classes()


def chunkify_maximize_chunk_size(arr: Sequence, max_len: int) -> list[list]:
    """Split into the fewest chunks of size ≤ max_len, sizes as equal as
    possible (reference `multithread/utils.ts` chunkifyMaximizeChunkSize)."""
    if not arr:
        return []
    n_chunks = (len(arr) + max_len - 1) // max_len
    base = len(arr) // n_chunks
    extra = len(arr) % n_chunks
    out, pos = [], 0
    for i in range(n_chunks):
        size = base + (1 if i < extra else 0)
        out.append(list(arr[pos : pos + size]))
        pos += size
    return out


class _Job:
    __slots__ = ("sets", "batchable", "priority", "future", "added_ns", "trace_parent", "slo")

    def __init__(
        self,
        sets: list[SignatureSet],
        batchable: bool,
        priority: PriorityClass = PriorityClass.API,
        slot: int | None = None,
    ):
        self.sets = sets
        self.batchable = batchable
        self.priority = priority
        self.future: asyncio.Future[bool] = asyncio.get_event_loop().create_future()
        # the submitting task's span (None when tracing is off): the
        # executor thread parents its buffer-wait/device-launch spans on
        # it explicitly, since run_in_executor drops contextvars. The
        # clock read rides the same gate — untraced jobs pay nothing
        self.trace_parent = tracing.current()
        self.added_ns = time.monotonic_ns() if self.trace_parent is not None else 0
        # slot-deadline slack ledger (None when the SLO layer is off —
        # the unconfigured path pays one None check per lifecycle edge)
        self.slo = slo.job_begin(priority, slot)


class _OverlapTracker:
    """Wall-clock pipeline accounting: how much of the verify stages'
    busy time had a prep stage in flight — the number behind the
    `prep_verify_overlap_occupancy_pct` bench line (and the tier-1
    overlap test). Count-based interval algebra: every begin/end of
    either stage advances the three accumulators by the elapsed window,
    attributed to whichever stages were active during it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._prep_n = 0  # guarded by: _lock
        self._verify_n = 0  # guarded by: _lock
        self._last_ns = 0  # guarded by: _lock
        self._prep_ns = 0  # guarded by: _lock
        self._verify_ns = 0  # guarded by: _lock
        self._overlap_ns = 0  # guarded by: _lock

    def _transition(self, dprep: int, dverify: int) -> None:
        with self._lock:
            now = time.monotonic_ns()
            if self._last_ns:
                dt = now - self._last_ns
                if self._prep_n:
                    self._prep_ns += dt
                if self._verify_n:
                    self._verify_ns += dt
                if self._prep_n and self._verify_n:
                    self._overlap_ns += dt
            self._last_ns = now
            self._prep_n += dprep
            self._verify_n += dverify

    @contextlib.contextmanager
    def prep(self):
        self._transition(1, 0)
        try:
            yield
        finally:
            self._transition(-1, 0)

    @contextlib.contextmanager
    def verify(self):
        self._transition(0, 1)
        try:
            yield
        finally:
            self._transition(0, -1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "prep_ns": self._prep_ns,
                "verify_ns": self._verify_ns,
                "overlap_ns": self._overlap_ns,
            }


class _PrepUnit:
    """One staged launch unit: the jobs it covers, their flattened sets,
    and the prep outcome (PreparedSets: inputs / reject / error)."""

    __slots__ = ("jobs", "sets", "prepared")

    def __init__(self, jobs: list[_Job], sets: list, prepared: PreparedSets):
        self.jobs = jobs
        self.sets = sets
        self.prepared = prepared


class _PreppedPackage:
    """Staged launch units for one package (the package itself and its
    class ride the _Staged entry — this is just the prep output)."""

    __slots__ = ("chunks", "singles")

    def __init__(self, chunks, singles):
        self.chunks = chunks  # batchable RLC chunks, prep staged
        self.singles = singles  # non-batchable jobs, prep staged


class _Staged:
    """Staging-queue entry: the dequeued package plus the (possibly
    still-running) prep future; `prep` is None for bulk packages, which
    prep inline as they do in the reference pool."""

    __slots__ = ("package", "cls", "prep")

    def __init__(self, package, cls, prep):
        self.package = package
        self.cls = cls
        self.prep = prep


class BlsDeviceVerifierPool(IBlsVerifier):
    def __init__(
        self,
        verify_fn: Callable[[list[SignatureSet]], bool] | None = None,
        *,
        buffer_wait_ms: float = MAX_BUFFER_WAIT_MS,
        max_buffered_sigs: int = MAX_BUFFERED_SIGS,
        scheduler_enabled: bool = True,
        aging_ms: float | None = None,
        mesh: VerifierMesh | None = None,
        mesh_mode: str | None = None,
        pipeline: str = "auto",
        prep_fn: Callable | None = None,
        device=None,
    ) -> None:
        explicit_fn = verify_fn is not None
        self._device = device  # the default lanes' device (None: CUDA)
        self._buffer_wait_ms = buffer_wait_ms
        self._max_buffered_sigs = max_buffered_sigs
        self._log = get_logger(name="lodestar.bls-pool")

        # mesh construction: an injected mesh wins (tests/topologies);
        # a mesh_mode builds from the device enumeration unless the
        # caller pinned an explicit verify_fn (a mock can't be
        # enumerated per device); an explicit verify_fn gets the
        # single-lane shape around it (a mock only speaks sets, so its
        # lane leaves the staged seam unset and
        # mesh_launch re-preps inline through it); the default is one
        # lane over the device model on `device`
        if mesh is not None:
            self.mesh = mesh
        elif mesh_mode is not None and mesh_mode not in MESH_MODES:
            raise ValueError(f"bls_mesh must be one of {MESH_MODES}, got {mesh_mode!r}")
        elif explicit_fn:
            self.mesh = single_lane_mesh(verify_fn, wedge_threshold=DEVICE_WEDGE_THRESHOLD)
        else:
            self.mesh = build_device_mesh(
                mesh_mode if mesh_mode is not None else "off",
                wedge_threshold=DEVICE_WEDGE_THRESHOLD,
                device=device,
            )

        # prep→verify double buffering: stage prep of package k+1 while
        # the lanes verify package k. "auto" engages only with a sibling
        # lane to stage on — the 1-lane default keeps the pre-pipeline
        # launch schedule exactly (regression-tested). Staging also
        # requires lanes that can CONSUME staged inputs (or an injected
        # prep_fn): a mesh of plain verify callables would pay real prep
        # for inputs nobody uses — and a prep-stage structural reject
        # would overrule a backend that never saw the sets
        if pipeline not in PIPELINE_MODES:
            raise ValueError(
                f"bls_pipeline must be one of {PIPELINE_MODES}, got {pipeline!r}"
            )
        self.pipeline_mode = pipeline
        stageable = prep_fn is not None or all(
            lane.verify_prepared_fn is not None for lane in self.mesh.lanes
        )
        if pipeline == "on" and not stageable:
            self._log.warn(
                "bls pipeline forced on but no lane can verify staged inputs; "
                "running unpipelined"
            )
        self._pipeline_enabled = stageable and (
            pipeline == "on" or (pipeline == "auto" and len(self.mesh) > 1)
        )
        self._prep_fn = prep_fn if prep_fn is not None else self._default_prep_fn
        self._staged_q: asyncio.Queue | None = None  # guarded by: event-loop (built by _ensure_runner)
        self._stage_slot: asyncio.Semaphore | None = None  # guarded by: event-loop (built by _ensure_runner)
        self._verify_runner: asyncio.Task | None = None  # guarded by: event-loop (single-threaded)
        self._overlap = _OverlapTracker()
        self._staged_packages = 0  # guarded by: advisory-only (monotonic count, prep threads under the GIL)

        self.scheduler_enabled = scheduler_enabled
        queue_kwargs = {"fifo": not scheduler_enabled}
        if aging_ms is not None:
            queue_kwargs["aging_ms"] = aging_ms
        self._jobs: PriorityWorkQueue = PriorityWorkQueue(**queue_kwargs)
        # the mesh IS the occupancy view: mean busy fraction over
        # available lanes (one lane -> exactly the pre-mesh tracker)
        self.occupancy = self.mesh
        self.admission = AdmissionController(
            self.mesh,
            depth_fn=lambda: self._outstanding,
            shed_bulk_depth=MAX_JOBS_CAN_ACCEPT_WORK // 2,
            reject_depth=MAX_JOBS_CAN_ACCEPT_WORK,
            can_accept=lambda: not self._closed,
        )
        self._outstanding = 0  # guarded by: event-loop (writers; depth_fn readers tolerate a stale int)
        self._buffered: list[_Job] = []  # guarded by: event-loop (single-threaded)
        self._buffered_sigs = 0  # guarded by: event-loop (single-threaded)
        self._buffer_timer: asyncio.TimerHandle | None = None  # guarded by: event-loop (single-threaded)
        self._closed = False  # guarded by: event-loop (one-way flag; executor readers see it at worst one package late)
        self._runner: asyncio.Task | None = None  # guarded by: event-loop (single-threaded)
        self._launch_tasks: set[asyncio.Task] = set()  # guarded by: event-loop (single-threaded)
        self._lane_free = asyncio.Event()  # guarded by: event-loop (single-threaded)
        self._lane_free.set()

        # metric counters (reference blsThreadPool.* taxonomy)
        self.metrics = {  # guarded by: advisory-only (incremented from executor threads under the GIL; scrapers read stale-by-one)
            "jobs_started": 0,
            "sig_sets_started": 0,
            "batch_retries": 0,
            "batch_sigs_success": 0,
            "errors": 0,
            "sharded_launches": 0,
            "sharded_fallbacks": 0,
        }

    @property
    def device_breaker(self):
        """Back-compat alias: the first lane's wedge breaker (THE wedge
        breaker on a single-lane pool)."""
        return self.mesh.lanes[0].breaker

    # -- IBlsVerifier ---------------------------------------------------------

    def is_down(self) -> bool:
        """Every lane wedged (breaker open) or closed — the degradation
        chain routes around the pool; mere queue saturation is NOT down
        (that's backpressure, handled by can_accept_work). One wedged
        chip out of N is NOT down: the mesh serves on the rest."""
        return self._closed or not self.mesh.available()

    def can_accept_work(self) -> bool:
        return not self.is_down() and self._outstanding < MAX_JOBS_CAN_ACCEPT_WORK

    async def verify_signature_sets(
        self, sets: list[SignatureSet], opts: VerifySignatureOpts | None = None
    ) -> bool:
        if self._closed:
            raise RuntimeError("verifier pool is closed")
        if not sets:
            raise ValueError("empty signature-set array")
        opts = opts or VerifySignatureOpts()

        if opts.verify_on_main_thread:
            # inline path for cheap time-critical single sets (the
            # caller's explicit choice: the pure-Python oracle)
            from ...crypto.bls.api import verify_signature_sets

            return verify_signature_sets(sets)

        priority = (
            PriorityClass(opts.priority) if opts.priority is not None else PriorityClass.API
        )
        self._ensure_runner()
        jobs = [
            self._enqueue(_Job(chunk, opts.batchable, priority, opts.slot))
            for chunk in chunkify_maximize_chunk_size(sets, MAX_SIGNATURE_SETS_PER_JOB)
        ]
        results = await asyncio.gather(*(j.future for j in jobs))
        return all(results)

    async def close(self) -> None:
        self._closed = True
        if self._buffer_timer is not None:
            self._buffer_timer.cancel()
        err = asyncio.CancelledError("bls pool closed")
        for job in self._buffered:
            if not job.future.done():
                job.future.set_exception(err)
        self._buffered.clear()
        for job, _cls, _waited in self._jobs.drain():
            if not job.future.done():
                job.future.set_exception(err)
        self._lane_free.set()  # unblock a dispatcher parked on a busy mesh
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except asyncio.CancelledError:
                pass
            self._runner = None
        if self._verify_runner is not None:
            self._verify_runner.cancel()
            try:
                await self._verify_runner
            except asyncio.CancelledError:
                pass
            self._verify_runner = None
        # drain the staging queue: a package parked between the prep and
        # verify stages has no other owner left to fail its futures (and
        # its still-running prep future nobody left to await — consume
        # the eventual outcome so a late prep error isn't logged as an
        # unretrieved exception at shutdown)
        if self._staged_q is not None:
            while True:
                try:
                    staged = self._staged_q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if staged.prep is not None:
                    staged.prep.add_done_callback(
                        lambda f: f.cancelled() or f.exception()
                    )
                for job in staged.package:
                    if not job.future.done():
                        job.future.set_exception(err)
        # in-flight launches: cancel the awaiting tasks (the executor
        # threads run to completion and resolve futures thread-safe,
        # exactly like the pre-mesh abandoned run_in_executor)
        for t in list(self._launch_tasks):
            t.cancel()
        if self._launch_tasks:
            await asyncio.gather(*self._launch_tasks, return_exceptions=True)
        self._launch_tasks.clear()

    # -- queueing -------------------------------------------------------------

    def _ensure_runner(self) -> None:
        loop = asyncio.get_event_loop()
        if self._pipeline_enabled:
            # BOTH stage tasks self-heal independently: a dead dispatch
            # stage with a live staging stage would otherwise fill the
            # 1-deep queue and hang every later verify with no restart
            if self._staged_q is None:
                # depth 1 IS the double buffer: one package staged
                # (prep in flight) beyond whatever is launching
                self._staged_q = asyncio.Queue(maxsize=1)
                self._stage_slot = asyncio.Semaphore(1)
            if self._runner is None or self._runner.done():
                self._runner = loop.create_task(self._stage_jobs())
            if self._verify_runner is None or self._verify_runner.done():
                self._verify_runner = loop.create_task(self._dispatch_staged())
        elif self._runner is None or self._runner.done():
            self._runner = loop.create_task(self._run_jobs())

    def _enqueue(self, job: _Job) -> _Job:
        self._outstanding += 1
        job.future.add_done_callback(lambda f, j=job: self._on_job_done(j, f))
        if job.batchable:
            self._buffered.append(job)
            self._buffered_sigs += len(job.sets)
            if self._buffered_sigs > self._max_buffered_sigs:
                self._flush_buffer()
            elif self._buffer_timer is None:
                loop = asyncio.get_event_loop()
                self._buffer_timer = loop.call_later(
                    self._buffer_wait_ms / 1000.0, self._flush_buffer
                )
        else:
            self._jobs.put_nowait(job, job.priority)
        return job

    def _dec_outstanding(self) -> None:
        self._outstanding -= 1

    def _on_job_done(self, job: _Job, f: "asyncio.Future[bool]") -> None:
        """The job future resolves exactly once — however many batch
        retries the verdict took — so this callback is the one place a
        per-job SLO verdict can't double-count. Cancellation (shutdown)
        is not a deadline miss and records nothing."""
        self._dec_outstanding()
        if job.slo is not None and not f.cancelled():
            ok = f.exception() is None and f.result() is True
            slo.job_verdict(job.slo, ok)

    def _flush_buffer(self) -> None:
        if self._buffer_timer is not None:
            self._buffer_timer.cancel()
            self._buffer_timer = None
        jobs, self._buffered = self._buffered, []
        self._buffered_sigs = 0
        for job in jobs:
            slo.job_flushed(job.slo)
            self._jobs.put_nowait(job, job.priority)

    # -- execution ------------------------------------------------------------

    def _record_sched_dequeue(self, job: _Job, cls: PriorityClass, waited_ns: int) -> None:
        """`sched_queue_wait` span per traced job: enqueue -> dequeue —
        the number the saturation acceptance test bounds."""
        slo.job_dequeued(job.slo, waited_ns)
        if job.trace_parent is not None:
            end_ns = time.monotonic_ns()
            tracing.record(
                job.trace_parent,
                "sched_queue_wait",
                end_ns - waited_ns,
                end_ns,
                {"class": cls.label, "sets": len(job.sets)},
            )

    # -- lane placement --------------------------------------------------------

    def _free_lanes(self) -> list[MeshLane]:
        """Lanes eligible for a new package. While ANY healthy lane
        exists, only healthy free lanes count — a busy-but-healthy mesh
        makes the dispatcher WAIT rather than dispatch onto an idle
        wedged chip (which would feed a launch storm into the hung
        device the breaker just isolated). Only when every lane is
        wedged does the dispatcher place work on a sick chip: it fails
        fast, tripping futures with the error — the pre-mesh
        wedged-pool behavior, and how a wedged breaker earns its
        half-open retrial."""
        avail = self.mesh.available()
        if avail:
            return [lane for lane in avail if lane.inflight == 0]
        return [lane for lane in self.mesh.lanes if lane.inflight == 0]

    async def _wait_free_lane(self) -> None:
        """Park the dispatcher until some lane can take a package. The
        wait happens BEFORE the dequeue, so jobs stay in the priority
        queue (and keep reordering under arriving urgent work) until
        the mesh actually has capacity — with one lane this is exactly
        the pre-mesh serialized schedule."""
        while not self._free_lanes():
            self._lane_free.clear()
            await self._lane_free.wait()

    def _pick_placement(
        self, cls: PriorityClass, package: list[_Job], free: list[MeshLane]
    ) -> tuple[str, list[MeshLane]]:
        """("sharded", lanes) for a bulk package big enough to amortize
        the shard launches over >=2 idle healthy lanes; otherwise
        ("single", [least-occupied free lane]). `free` is non-empty by
        contract (the dispatcher re-waits when a lane wedges out from
        under it). Sharded lane sets are occupancy-CHOSEN but
        index-ORDERED: the shard graphs key on (device, class), so a
        canonical ordering gives one row slice per lane whatever the
        occupancy order."""
        if (
            self.scheduler_enabled
            and cls in BULK_CLASSES
            and self.mesh.sharding_available()
        ):
            healthy_free = [lane for lane in free if not lane.wedged]
            n_sets = sum(len(j.sets) for j in package)
            want = n_sets // SHARD_MIN_SETS_PER_LANE
            if len(healthy_free) >= 2 and want >= 2:
                chosen = sorted(healthy_free, key=lambda l: l.occupancy.occupancy())
                picked = chosen[: min(len(chosen), want)]
                return "sharded", sorted(picked, key=lambda l: l.index)
        lane = min(free, key=lambda l: (l.wedged, l.occupancy.occupancy()))
        return "single", [lane]

    async def _next_package(self) -> tuple[list[_Job], PriorityClass]:
        """Dequeue one job and drain immediately-available work into the
        package: same class only under the scheduler, capped at
        MAX_PACKAGE_SETS (and bulk runs ONE job per package) — both
        bound how long an arriving gossip block can wait behind the
        in-flight launch; everything available in FIFO mode (the
        pre-scheduler arm)."""
        job, cls, waited_ns = await self._jobs.get()
        self._record_sched_dequeue(job, cls, waited_ns)
        package = [job]
        if not (self.scheduler_enabled and cls in BULK_CLASSES):
            drain_cls = cls if self.scheduler_enabled else None
            package_sets = len(job.sets)
            while not self.scheduler_enabled or package_sets < MAX_PACKAGE_SETS:
                nxt = self._jobs.get_nowait(drain_cls)
                if nxt is None:
                    break
                self._record_sched_dequeue(*nxt)
                package.append(nxt[0])
                package_sets += len(nxt[0].sets)
        return package, cls

    async def _place_and_launch(self, package, cls, prepped=None) -> None:
        """Shared dispatch tail: the in-hand wait-for-capacity /
        placement / launch-task sequence, with the in-hand cancellation
        contract — from here to create_task, any await must fail the
        package's futures on cancellation (close() only drains the
        queue, it cannot see this package)."""
        try:
            while True:
                free = self._free_lanes()
                if free:
                    break
                # a free lane wedged between the capacity check and
                # placement (a cross-lane retry on an executor
                # thread can trip any breaker): healthy lanes exist
                # but are busy — their in-flight completions set
                # _lane_free, so this wait always terminates
                self._lane_free.clear()
                await self._lane_free.wait()
                if self._closed:
                    raise asyncio.CancelledError("bls pool closed")
            mode, lanes = self._pick_placement(cls, package, free)
        except asyncio.CancelledError:
            err = asyncio.CancelledError("bls pool closed")
            for j in package:
                if not j.future.done():
                    j.future.set_exception(err)
            raise
        for lane in lanes:
            lane.inflight += 1
        task = asyncio.get_event_loop().create_task(
            self._launch(package, mode, lanes, prepped=prepped)
        )
        self._launch_tasks.add(task)
        task.add_done_callback(self._launch_tasks.discard)

    async def _run_jobs(self) -> None:
        while not self._closed:
            await self._wait_free_lane()
            if self._closed:
                return
            package, cls = await self._next_package()
            await self._place_and_launch(package, cls)

    # -- prep→verify pipeline (dispatcher split into two stages) ---------------

    async def _stage_jobs(self) -> None:
        """Pipeline stage 1: reserve the staging slot, dequeue, submit
        prep to an executor thread, hand the package to the verify
        dispatcher through the 1-deep staging queue. The slot is
        acquired BEFORE the dequeue, so package k+2 is not even taken
        out of the priority queue until the dispatcher consumed k+1 —
        the lookahead beyond the in-flight launches is exactly one
        package, the same bound the pre-pipeline dispatcher's in-hand
        package had."""
        loop = asyncio.get_event_loop()
        while not self._closed:
            await self._stage_slot.acquire()
            if self._closed:
                self._stage_slot.release()
                return
            try:
                package, cls = await self._next_package()
            except BaseException:
                # nothing dequeued: release the slot so a restarted
                # stage loop (the self-heal contract) isn't deadlocked
                # on a permit this dead task took to its grave
                self._stage_slot.release()
                raise
            try:
                if self.scheduler_enabled and cls in BULK_CLASSES:
                    # bulk may shard across lanes; the collective launch
                    # preps inline exactly like the unpipelined pool
                    prep = None
                else:
                    prep = loop.run_in_executor(
                        None, self._prep_package, package
                    )
                # the slot reservation guarantees room: never blocks
                self._staged_q.put_nowait(_Staged(package, cls, prep))
            except BaseException as e:
                # ANY failure here (cancellation, an executor refusing
                # work at shutdown, ...) must fail the in-hand package's
                # futures — no one else can see it — and return the
                # staging permit before the task dies
                self._stage_slot.release()
                err = (
                    asyncio.CancelledError("bls pool closed")
                    if isinstance(e, asyncio.CancelledError)
                    else e
                )
                for j in package:
                    if not j.future.done():
                        j.future.set_exception(err)
                raise

    async def _dispatch_staged(self) -> None:
        """Pipeline stage 2: wait for lane capacity, take the staged
        package (releasing the staging slot), await its prep, place and
        launch. Placement policy, verdict semantics, and the
        fail-closed chain are the unpipelined dispatcher's — only the
        prep wall time moved off the critical path."""
        while not self._closed:
            await self._wait_free_lane()
            if self._closed:
                return
            staged = await self._staged_q.get()
            self._stage_slot.release()
            try:
                prepped = await staged.prep if staged.prep is not None else None
            except asyncio.CancelledError:
                err = asyncio.CancelledError("bls pool closed")
                for j in staged.package:
                    if not j.future.done():
                        j.future.set_exception(err)
                raise
            except Exception as e:  # prep infrastructure failure: fail closed
                for j in staged.package:
                    if not j.future.done():
                        j.future.set_exception(e)
                continue
            await self._place_and_launch(staged.package, staged.cls, prepped=prepped)

    def _default_prep_fn(self, sets: list[SignatureSet], lane_hint: int | None):
        from ...models.batch_verify import prepare_inputs_for_lane

        return prepare_inputs_for_lane(sets, lane_hint, device=self._device)

    def _prep_lane_hint(self) -> int | None:
        """A free sibling lane to stage prep on (mesh with >1 chip);
        None interleaves prep on whatever chip is current. Advisory
        read of dispatcher-owned state from the prep thread: a stale
        pick costs placement quality, never correctness."""
        if len(self.mesh.lanes) < 2:
            return None
        free = [l for l in self.mesh.available() if l.inflight == 0]
        if not free:
            return None
        return min(free, key=lambda l: l.occupancy.occupancy()).index

    def _prep_unit(self, jobs: list[_Job], sets: list) -> _PrepUnit:
        """Stage prep for one launch unit (prep executor thread). Errors
        are CAPTURED, not raised: the launch re-preps through the plain
        verify path so a prep fault takes the exact pre-pipeline
        degradation road (device→host inside build_device_inputs;
        anything worse raises at launch time and fails closed)."""
        from ...models.batch_verify import consume_prep_info

        t0_ns = time.monotonic_ns()
        inputs = None
        error: Exception | None = None
        with self._overlap.prep():
            try:
                inputs = self._prep_fn(sets, self._prep_lane_hint())
            except Exception as e:
                error = e
        info = consume_prep_info()
        if info is not None and info["end_ns"] < t0_ns:
            info = None  # stale record from an earlier launch on this thread
        return _PrepUnit(jobs, sets, PreparedSets(inputs, error, info))

    def _prep_package(self, package: list[_Job]) -> _PreppedPackage:
        """Prep every launch unit the verify stage will dispatch: the
        RLC chunks of the batchable jobs plus each non-batchable job —
        the same unit boundaries `_verify_package` launches, so the
        launch schedule is unchanged."""
        self._staged_packages += 1
        batchable = [j for j in package if j.batchable]
        individual = [j for j in package if not j.batchable]
        chunks = [
            self._prep_unit(chunk, [s for j in chunk for s in j.sets])
            for chunk in chunkify_maximize_chunk_size(batchable, BATCHABLE_MIN_PER_CHUNK)
        ]
        singles = [self._prep_unit([j], j.sets) for j in individual]
        return _PreppedPackage(chunks, singles)

    def pipeline_stats(self) -> dict:
        """Pipeline wall-clock accounting: prep/verify busy time, their
        overlap, the overlap share of verify time, and the staged
        package count (0 = pipeline never engaged). The device path per
        batch is either the split schedule (3-launch fused prep + the
        RLC verify dispatch) or, with the single-launch path active, ONE
        graph replay — in which case the prep accumulator measures
        the staged host byte-parse and the verify accumulator the
        single launch."""
        s = self._overlap.snapshot()
        v = s["verify_ns"]
        s["overlap_occupancy_pct"] = (100.0 * s["overlap_ns"] / v) if v else 0.0
        s["staged_packages"] = self._staged_packages
        s["pipeline_enabled"] = self._pipeline_enabled
        return s

    def _with_verify_window(self, fn, *args) -> None:
        """Executor-thread entry: every verify path runs inside the
        overlap tracker's verify window (the denominator of the
        pipeline's overlap-occupancy number)."""
        with self._overlap.verify():
            fn(*args)

    def _release_lanes_early(self, to_release: list[MeshLane], held: list[MeshLane]) -> None:
        """Loop-side early release: the sharded fallback returns unused
        lanes to the dispatcher before its (possibly long) single-lane
        retry finishes. `held` is the launch's live accounting — the
        finally below decrements exactly what is still held."""
        for lane in to_release:
            if lane in held:
                held.remove(lane)
                lane.inflight -= 1
        self._lane_free.set()

    async def _launch(
        self,
        package: list[_Job],
        mode: str,
        lanes: list[MeshLane],
        prepped: _PreppedPackage | None = None,
    ) -> None:
        held = list(lanes)  # guarded by: event-loop (early releases and the finally both run on the loop)
        try:
            if mode == "sharded":
                await asyncio.get_event_loop().run_in_executor(
                    None, self._with_verify_window,
                    self._verify_package_sharded, package, lanes, held,
                )
            else:
                await asyncio.get_event_loop().run_in_executor(
                    None, self._with_verify_window,
                    self._verify_package, package, lanes[0], prepped,
                )
        except asyncio.CancelledError:
            # close() cancels launch tasks; if the executor work item
            # had not STARTED yet it never runs and nobody else will
            # resolve these futures — fail them closed (done futures,
            # resolved by an already-running executor thread, no-op)
            err = asyncio.CancelledError("bls pool closed")
            for j in package:
                if not j.future.done():
                    j.future.set_exception(err)
            raise
        except Exception as e:  # fail closed: reject, never resolve True
            self.metrics["errors"] += len(package)
            self._log.error(f"bls verify package failed: {e!r}")
            for j in package:
                if not j.future.done():
                    j.future.set_exception(e)
        finally:
            for lane in held:
                lane.inflight -= 1
            # clear so a LATE _release_lanes_early (scheduled by an
            # executor thread that outlives a cancelled launch task)
            # finds nothing left to double-decrement
            held.clear()
            self._lane_free.set()

    # -- device launches (executor threads) ------------------------------------

    def _on_lane_wedge(self, lane: MeshLane) -> None:
        """closed->open transition on one chip's wedge breaker."""
        self._log.warn(
            "device lane wedged, degrading to remaining chips",
            {"device": lane.label, "lanes_left": len(self.mesh.available())},
        )

    def _launch_sets(
        self,
        lane: MeshLane,
        sets: list[SignatureSet],
        prepared: PreparedSets | None = None,
    ):
        """One verify launch, preferring `lane` (mesh_launch: breaker
        accounting + cross-lane error retry — a sick chip degrades its
        work onto the rest of the mesh with the verdict unchanged;
        raises only when every candidate lane errored, which with one
        lane is exactly the pre-mesh fail-closed behavior). `prepared`
        carries staged pipeline inputs (see mesh_launch). Returns
        (ok, lane_that_served)."""
        from .mesh import mesh_launch

        return mesh_launch(
            self.mesh,
            sets,
            prefer=lane,
            prepared=prepared,
            on_wedge=self._on_lane_wedge,
        )

    def _verify_package(
        self,
        package: list[_Job],
        lane: MeshLane,
        prepped: _PreppedPackage | None = None,
        counted: bool = False,
    ) -> None:
        """Runs in a thread executor (device dispatch releases the GIL).

        `prepped` carries the pipeline's staged launch units — the SAME
        unit boundaries as the inline path, so the launch schedule is
        identical; only where prep ran differs. The batch-then-retry
        road always re-preps INLINE (fresh blinding, fresh prep — one
        bad signature can't poison its neighbors, and a stale staged
        prep can't poison the retry)."""
        if not counted:
            self.metrics["jobs_started"] += len(package)
            self.metrics["sig_sets_started"] += sum(len(j.sets) for j in package)
            # SLO launch stamp once per job: the sharded fallback road
            # (counted=True) already stamped at its collective launch
            for j in package:
                slo.job_launch(j.slo)

        # tracing work (incl. the clock reads) only when some job in the
        # package was submitted under an active trace — the disabled path
        # pays the flag checks hidden in trace_parent alone
        traced = any(j.trace_parent is not None for j in package)
        if traced:
            # buffer-wait spans: from job submission to the launch this
            # thread is about to perform (buffering + queue time)
            launch_ns = time.monotonic_ns()
            for j in package:
                if j.trace_parent is not None:
                    tracing.record(
                        j.trace_parent, "bls_buffer_wait", j.added_ns, launch_ns,
                        {"sets": len(j.sets)},
                    )

        batchable = [j for j in package if j.batchable]
        individual = [j for j in package if not j.batchable]
        if prepped is None:
            chunk_units = [
                (chunk, [s for j in chunk for s in j.sets], None)
                for chunk in chunkify_maximize_chunk_size(
                    batchable, BATCHABLE_MIN_PER_CHUNK
                )
            ]
            single_units = [([j], j.sets, None) for j in individual]
        else:
            chunk_units = [(u.jobs, u.sets, u.prepared) for u in prepped.chunks]
            single_units = [(u.jobs, u.sets, u.prepared) for u in prepped.singles]

        # RLC-batch the batchable jobs in ≥16-set chunks; invalid batch →
        # retry each job individually (worker.ts:52-96)
        from ...utils import trace_region

        retries: list[_Job] = []
        for jobs, all_sets, staged in chunk_units:
            t0 = time.monotonic_ns() if traced else 0
            try:
                with trace_region("bls_batch_verify"):
                    ok, served = self._launch_sets(lane, all_sets, prepared=staged)
            except Exception:
                self.metrics["batch_retries"] += 1
                if traced:
                    self._trace_unit_prep(jobs, staged, t0)
                    self._trace_launch(
                        jobs, t0, len(all_sets), "batch_error", lane.label,
                        lane=str(lane.index),
                    )
                retries.extend(jobs)
                continue
            if traced:
                self._trace_unit_prep(jobs, staged, t0)
                self._trace_launch(
                    jobs, t0, len(all_sets), "batch", served.label,
                    lane=str(served.index),
                )
            if ok:
                self.metrics["batch_sigs_success"] += len(all_sets)
                for j in jobs:
                    self._resolve(j, True)
            else:
                self.metrics["batch_retries"] += 1
                retries.extend(jobs)

        for jobs, sets_, staged in single_units + [([j], j.sets, None) for j in retries]:
            j = jobs[0]
            t0 = time.monotonic_ns() if traced else 0
            try:
                ok, served = self._launch_sets(lane, sets_, prepared=staged)
                if traced:
                    self._trace_unit_prep([j], staged, t0)
                    self._trace_launch(
                        [j], t0, len(sets_), "single", served.label,
                        lane=str(served.index),
                    )
                self._resolve(j, ok)
            except Exception as e:
                if traced:
                    self._trace_unit_prep([j], staged, t0)
                    self._trace_launch(
                        [j], t0, len(sets_), "single_error", lane.label,
                        lane=str(lane.index),
                    )
                if not j.future.done():
                    j.future.get_loop().call_soon_threadsafe(self._reject, j, e)

    def _verify_package_sharded(
        self, package: list[_Job], lanes: list[MeshLane], held: list[MeshLane] | None = None
    ) -> None:
        """One data-parallel launch over idle lanes (executor thread).
        A collective ERROR cannot name the sick device, so it feeds the
        mesh's sharded breaker (parking the collective path) and the
        package degrades to the attributable single-lane path; an
        invalid VERDICT takes the same retry road the RLC batch does —
        re-verified per job so one bad signature can't poison its
        package (and so a lying collective can't be weaker than the
        single-device policy)."""
        self.metrics["jobs_started"] += len(package)
        self.metrics["sig_sets_started"] += sum(len(j.sets) for j in package)
        for j in package:
            slo.job_launch(j.slo)
        all_sets = [s for j in package for s in j.sets]
        traced = any(j.trace_parent is not None for j in package)
        if traced:
            launch_ns = time.monotonic_ns()
            for j in package:
                if j.trace_parent is not None:
                    tracing.record(
                        j.trace_parent, "bls_buffer_wait", j.added_ns, launch_ns,
                        {"sets": len(j.sets)},
                    )
        t0 = time.monotonic_ns() if traced else 0
        try:
            with contextlib.ExitStack() as stack:
                for lane in lanes:
                    stack.enter_context(lane.occupancy.launch())
                ok = bool(
                    self.mesh.sharded_fn(all_sets, [lane.index for lane in lanes])
                )
            self.mesh.sharded_breaker.record_success()
            self.metrics["sharded_launches"] += 1
            for lane in lanes:
                lane.launches += 1
        except Exception:
            self.mesh.sharded_breaker.record_failure()
            self.metrics["sharded_fallbacks"] += 1
            self.metrics["batch_retries"] += 1
            if traced:
                self._trace_launch(
                    package, t0, len(all_sets), "sharded_error",
                    ",".join(lane.label for lane in lanes),
                    lane=",".join(str(lane.index) for lane in lanes),
                )
            fallback = min(lanes, key=lambda l: l.occupancy.occupancy())
            self._release_unused(lanes, fallback, held, package)
            self._verify_package(package, fallback, counted=True)
            return
        if traced:
            self._trace_launch(
                package, t0, len(all_sets), "sharded",
                ",".join(lane.label for lane in lanes),
                lane=",".join(str(lane.index) for lane in lanes),
            )
        if ok:
            self.metrics["batch_sigs_success"] += len(all_sets)
            for j in package:
                self._resolve(j, True)
        else:
            self.metrics["batch_retries"] += 1
            fallback = min(lanes, key=lambda l: l.occupancy.occupancy())
            self._release_unused(lanes, fallback, held, package)
            self._verify_package(package, fallback, counted=True)

    def _release_unused(
        self,
        lanes: list[MeshLane],
        fallback: MeshLane,
        held: "list[MeshLane] | None",
        package: list[_Job],
    ) -> None:
        """Executor-side entry to the loop-side early release: the
        sharded fallback keeps ONE lane for its (possibly long)
        single-lane retry — the other lanes go back to the dispatcher
        now instead of idling behind this package's finally."""
        if held is None:
            return
        unused = [lane for lane in lanes if lane is not fallback]
        if unused:
            package[0].future.get_loop().call_soon_threadsafe(
                self._release_lanes_early, unused, held
            )

    def _trace_unit_prep(self, jobs: list[_Job], staged, t0: int) -> None:
        """`bls_prep` span for one launch unit: from the thread-local
        record for inline prep, or from the record the prep STAGE
        carried across threads on its PreparedSets."""
        if staged is None:
            self._trace_prep(jobs, t0)
        else:
            self._trace_prep_info(jobs, staged.info)

    @staticmethod
    def _trace_prep_info(jobs: list[_Job], info) -> None:
        """`bls_prep` span from a record the prep STAGE carried across
        threads (the pipelined twin of `_trace_prep`, which reads the
        launch thread's TLS): staged prep ran on the prep executor, so
        the record rides the _PrepUnit instead."""
        if info is None:
            return
        attrs = {"layer": info["layer"], "sets": info["sets"], "staged": True}
        if info["rejected"]:
            attrs["rejected"] = True
        for j in jobs:
            if j.trace_parent is not None:
                tracing.record(
                    j.trace_parent, "bls_prep", info["start_ns"], info["end_ns"], attrs
                )

    @staticmethod
    def _trace_prep(jobs: list[_Job], launch_start_ns: int) -> None:
        """`bls_prep` span per traced job: input preparation inside the
        launch this thread just performed, with the serving layer
        (device on-chip pipeline vs host native/python) stamped as an
        attribute — mirroring how `verifier_layer` attributes the verify.
        The model layer leaves the timing in a thread-local (it runs on
        this executor thread, below any tracer context); consuming it
        here keeps untraced launches free of tracer work. Records that
        predate this launch are discarded: untraced launches (and mock
        backends layered over earlier real ones) leave stale info on the
        executor thread, and attributing an old prep's timestamps to this
        trace would corrupt its span window."""
        from ...models.batch_verify import consume_prep_info

        info = consume_prep_info()
        if info is None or info["end_ns"] < launch_start_ns:
            return
        attrs = {"layer": info["layer"], "sets": info["sets"]}
        if info["rejected"]:
            attrs["rejected"] = True
        for j in jobs:
            if j.trace_parent is not None:
                tracing.record(
                    j.trace_parent, "bls_prep", info["start_ns"], info["end_ns"], attrs
                )

    @staticmethod
    def _trace_launch(
        jobs: list[_Job],
        start_ns: int,
        n_sets: int,
        mode: str,
        device: str = "dev0",
        lane: str | None = None,
    ) -> None:
        """Per-traced-job device-launch span; a batch covering jobs from
        several traces lands one identically-timed span in each. A
        batchable job verified in the single pass got there because its
        batch failed — that's the reference's batch-then-retry path, so
        it's labeled bls_batch_retry to keep the decomposition visible.
        The serving lane rides along as the `device` attribute (plus the
        `lane` index when known), and is ALSO stamped onto the job's
        trace parent — for chain imports that is the `bls_verify` span,
        so a Chrome-trace export of a mesh slot names its chips at the
        top level (a job served across several launches keeps the last
        serving lane, the one that produced its verdict)."""
        end_ns = time.monotonic_ns()
        attrs = {"sets": n_sets, "mode": mode, "device": device}
        if lane is not None:
            attrs["lane"] = lane
        for j in jobs:
            if j.trace_parent is not None:
                retried = j.batchable and mode.startswith("single")
                tracing.record(
                    j.trace_parent,
                    "bls_batch_retry" if retried else "bls_device_launch",
                    start_ns,
                    end_ns,
                    attrs,
                )
                j.trace_parent.set(device=device, **({"lane": lane} if lane is not None else {}))

    def _resolve(self, job: _Job, result: bool) -> None:
        if not job.future.done():
            job.future.get_loop().call_soon_threadsafe(self._set_result, job, result)

    @staticmethod
    def _set_result(job: _Job, result: bool) -> None:
        if not job.future.done():
            job.future.set_result(result)

    @staticmethod
    def _reject(job: _Job, err: Exception) -> None:
        if not job.future.done():
            job.future.set_exception(err)
