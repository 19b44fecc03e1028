"""Verifier mesh: per-device launch lanes behind one verifier pool.

The PyTorch port's copy of ``lodestar_tpu/chain/bls/mesh.py``:

* `MeshLane` — one device: its own verify callables, its own EWMA
  `OccupancyTracker`, and its own wedge `CircuitBreaker`, so a sick
  device (a hung runtime, an OOM loop) degrades the pool to an (N-1)-device
  mesh instead of tripping the whole pool.
* `VerifierMesh` — the lane set plus an optional data-parallel sharded
  verify callable (`sharded_fn`: a bulk range-sync/backfill batch runs
  as one verify split over several idle lanes, each shard on its lane's
  device, see ``models/batch_verify.verify_signature_sets_sharded``),
  gated by a breaker of its own. It also answers the fleet-level
  questions: aggregate occupancy over *available* lanes and the per-lane
  table (a wedged lane drops out of the advertised capacity).
* `mesh_launch` — one verify launch with per-lane breaker accounting and
  cross-lane error retry.
* `build_device_mesh` — production construction from
  ``models/batch_verify.py``'s device enumeration: "auto" (and "on") means
  CUDA with more than one device, one lane per GPU; one visible GPU is the
  single-lane shape. Unlike the JAX package's, it attaches no sharded
  collective (see its docstring). There is no fallback: the lanes run the
  port's device model, and an import or enumeration problem raises instead
  of landing on the pure-Python oracle.

Placement policy lives in the pool (`chain/bls/pool.py`): latency-class
work dequeues to the least-occupied free lane; on a mesh with a
collective, bulk work shards across idle lanes when at least two are
free and the batch is large enough to amortize the extra launches.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

from ... import telemetry
from ...offload.resilience import CircuitBreaker
from ...scheduler import OccupancyTracker

__all__ = [
    "MeshLane",
    "VerifierMesh",
    "PreparedSets",
    "build_device_mesh",
    "single_lane_mesh",
    "mesh_launch",
    "MESH_MODES",
    "LANE_WEDGE_THRESHOLD",
    "SHARD_MIN_SETS_PER_LANE",
    "SHARD_DISABLE_THRESHOLD",
]

#: pool-facing mesh modes
MESH_MODES = ("auto", "on", "off")

# consecutive launch errors before ONE lane reports itself wedged —
# same rationale as the pre-mesh pool-wide DEVICE_WEDGE_THRESHOLD:
# high enough that one bad batch + its retries can't trip it, low
# enough to stop a launch storm against a hung device
LANE_WEDGE_THRESHOLD = 8
LANE_WEDGE_RESET_S = 5.0
LANE_WEDGE_MAX_RESET_S = 60.0

#: a bulk batch shards over at most len(sets)//this lanes — a 32-set
#: batch across 8 devices would pay 8 shard launches and a finish to save
#: one small launch (the JAX package's value, tuned on a TPU, where a
#: shard's time scales with its rows; not measured on several GPUs)
SHARD_MIN_SETS_PER_LANE = 16

#: consecutive sharded-launch errors before the mesh stops trying the
#: collective (single-lane launches attribute errors to the exact sick
#: device; the sharded launch cannot, so it gets its own gate)
SHARD_DISABLE_THRESHOLD = 3


class PreparedSets:
    """Staged prep output for one launch unit (the pipelined pool's
    hand-off between its prep and verify stages).

    `inputs` is the `build_device_inputs` tuple, or None when prep
    REJECTED the batch (a structural verdict — final, never re-prepped).
    `error` carries a prep-stage exception; a launch seeing one re-preps
    through the lane's plain `verify_fn`, which re-raises through the
    exact pre-pipeline fail-closed path."""

    __slots__ = ("inputs", "error", "info")

    def __init__(self, inputs=None, error: Exception | None = None, info=None):
        self.inputs = inputs
        self.error = error
        self.info = info  # prep span record carried across threads


class MeshLane:
    """One device lane: verify callable + occupancy + wedge breaker.

    `inflight` is dispatcher state (how many packages the pool has in
    flight on this lane) and is only touched on the event loop; the
    occupancy tracker and breaker are thread-safe because the launches
    themselves run on executor threads. `verify_prepared_fn` (optional)
    verifies a `PreparedSets.inputs` staged by the pipelined pool's
    prep stage (either staged shape — see models verify_prepared);
    lanes without one always re-prep inline."""

    def __init__(
        self,
        index: int,
        verify_fn: Callable,
        *,
        label: str | None = None,
        wedge_threshold: int = LANE_WEDGE_THRESHOLD,
        wedge_reset_s: float = LANE_WEDGE_RESET_S,
        verify_prepared_fn: Callable | None = None,
        device=None,
    ) -> None:
        self.index = index
        self.device = device  # the lane's torch device (None: a mock lane)
        self.label = label if label is not None else f"dev{index}"
        self.verify_fn = verify_fn
        self.verify_prepared_fn = verify_prepared_fn
        self.occupancy = OccupancyTracker()
        self.breaker = CircuitBreaker(
            failure_threshold=wedge_threshold,
            reset_timeout_s=wedge_reset_s,
            max_reset_timeout_s=LANE_WEDGE_MAX_RESET_S,
        )
        self.inflight = 0  # guarded by: event-loop (dispatcher-owned)
        self.wedge_trips = 0  # guarded by: advisory-only (monotonic trip count, read by tests/metrics)
        self.launches = 0  # guarded by: advisory-only (monotonic launch count)

    @property
    def wedged(self) -> bool:
        return self.breaker.is_open

    def state(self) -> dict:
        return {
            "device": self.label,
            "occupancy_permille": self.occupancy.occupancy_permille(),
            "wedged": self.wedged,
            "inflight": self.inflight,
            "wedge_trips": self.wedge_trips,
            "launches": self.launches,
        }


class VerifierMesh:
    """Lane set + optional sharded collective. Duck-types the occupancy
    interface `AdmissionController` expects (`occupancy()`), reporting
    the MEAN busy fraction over available lanes — the admission
    thresholds (0.75 / 0.95) grade fleet headroom, not "any chip busy".
    With one lane this is exactly that lane's tracker value, so the
    pre-mesh admission behavior is unchanged."""

    def __init__(self, lanes: Sequence[MeshLane], *, sharded_fn: Callable | None = None):
        if not lanes:
            raise ValueError("a verifier mesh needs at least one lane")
        self.lanes = list(lanes)
        #: sharded_fn(sets, device_indices) -> bool over >=2 lanes
        self.sharded_fn = sharded_fn
        # gates the collective only: a sharded error cannot name the sick
        # device, so it must not wedge per-lane breakers — instead repeated
        # collective failures park the sharded path while single-lane
        # launches keep attributing errors per device
        self.sharded_breaker = CircuitBreaker(
            failure_threshold=SHARD_DISABLE_THRESHOLD,
            reset_timeout_s=LANE_WEDGE_RESET_S,
            max_reset_timeout_s=LANE_WEDGE_MAX_RESET_S,
        )

    def __len__(self) -> int:
        return len(self.lanes)

    def available(self) -> list[MeshLane]:
        """Lanes whose wedge breaker admits work (the (N-1) degradation
        set). May be empty — the pool then fails fast like the pre-mesh
        wedged-device path."""
        return [lane for lane in self.lanes if not lane.wedged]

    def sharding_available(self) -> bool:
        return self.sharded_fn is not None and not self.sharded_breaker.is_open

    def occupancy(self) -> float:
        lanes = self.available() or self.lanes
        return sum(lane.occupancy.occupancy() for lane in lanes) / len(lanes)

    def occupancy_permille(self) -> int:
        return max(0, min(1000, int(round(self.occupancy() * 1000.0))))

    def chip_table(self) -> list[tuple[int, bool]]:
        """(occupancy_permille, wedged) per chip — the Status frame's
        mesh trailer. A wedged chip stays listed (so operators see it)
        but flagged, and clients drop it from advertised capacity."""
        return [
            (lane.occupancy.occupancy_permille(), lane.wedged) for lane in self.lanes
        ]

    def lane_states(self) -> list[dict]:
        return [lane.state() for lane in self.lanes]


def mesh_launch(
    mesh: VerifierMesh,
    sets,
    *,
    prefer: MeshLane | None = None,
    on_launch: Callable | None = None,
    on_wedge: Callable | None = None,
    prepared: "PreparedSets | None" = None,
) -> tuple[bool, MeshLane]:
    """One verify launch with per-lane wedge accounting and cross-lane
    error retry — the single-launch core shared by the pool's executor
    path and the standalone offload host's backend.

    Starts on `prefer` (default: the least-occupied available lane;
    every lane when all are wedged, failing fast through the sick chip
    so its breaker earns the half-open retrial). A backend ERROR
    records the failing lane's breaker — firing `on_wedge(lane)` on the
    closed→open transition — and retries on each remaining available
    sibling, least-occupied first; the verdict is unchanged and the
    call raises only when every candidate errored. `on_launch(lane)`
    fires per attempt (metrics). Returns (ok, lane_that_served).

    `prepared` (pipelined pool) short-circuits the prep half: a staged
    structural REJECT is the final verdict (ok=False, no re-prep); clean
    staged inputs go through the lane's `verify_prepared_fn`; a staged
    prep ERROR — or a lane without a prepared callable — re-preps
    through the plain `verify_fn`, so the fail-closed degradation chain
    is byte-for-byte the pre-pipeline one."""
    if prefer is None or (prefer.wedged and mesh.available()):
        # no preference, or the preferred lane wedged since dispatch
        # (mid-package: chunk N trips the breaker, chunk N+1 must not
        # keep feeding the hung device): start on a healthy lane
        lanes = mesh.available() or mesh.lanes
        prefer = min(lanes, key=lambda l: l.occupancy.occupancy())
    tried: list[MeshLane] = []
    current = prefer
    while True:
        tried.append(current)
        try:
            # launch telemetry at the lane seam: wall time of the whole
            # verify launch this lane serves (staged-inputs verify, or
            # the full re-prep + verify chain), labeled with the lane so
            # a mesh slot's launches name their devices. Size class is
            # the pow-2 bucket of the set count — the graph cache's own
            # bucketing.
            t0 = time.perf_counter() if telemetry.launch_telemetry_active() else 0.0
            dispatched = True
            with current.occupancy.launch():
                use_staged = prepared is not None and prepared.error is None
                if use_staged and prepared.inputs is None:
                    ok = False  # prep rejected the batch: verdict final
                    dispatched = False  # no backend call — not a launch
                elif use_staged and current.verify_prepared_fn is not None:
                    ok = bool(current.verify_prepared_fn(prepared.inputs))
                else:
                    ok = bool(current.verify_fn(sets))
            if t0 and dispatched:
                telemetry.record_launch(
                    "bls_lane_verify",
                    telemetry.size_class_of(len(sets)),
                    time.perf_counter() - t0,
                    lane=current.label,
                )
        except Exception:
            # an error on a staged-inputs attempt may be input-bound
            # (arrays committed to the sick die, a malformed staging) —
            # sibling retries re-prep inline so the cross-lane recovery
            # is exactly the pre-pipeline one, not N copies of the same
            # poisoned inputs wedging every healthy breaker
            prepared = None
            was_open = current.breaker.is_open
            current.breaker.record_failure()
            if not was_open and current.breaker.is_open:
                current.wedge_trips += 1
                if on_wedge is not None:
                    on_wedge(current)
            current.launches += 1
            if on_launch is not None:
                on_launch(current)
            candidates = [l for l in mesh.available() if l not in tried]
            if not candidates:
                raise
            current = min(candidates, key=lambda l: l.occupancy.occupancy())
            continue
        current.breaker.record_success()
        current.launches += 1
        if on_launch is not None:
            on_launch(current)
        return ok, current


def single_lane_mesh(
    verify_fn: Callable,
    *,
    wedge_threshold: int = LANE_WEDGE_THRESHOLD,
    verify_prepared_fn: Callable | None = None,
    device=None,
) -> VerifierMesh:
    """The pre-mesh shape: one lane, no sharded collective."""
    return VerifierMesh(
        [
            MeshLane(
                0,
                verify_fn,
                wedge_threshold=wedge_threshold,
                verify_prepared_fn=verify_prepared_fn,
                device=device,
            )
        ]
    )


def _model_lane(index: int, device, wedge_threshold: int) -> MeshLane:
    """Lane `index` over the port's device model, pinned to `device` (CUDA
    device `index` when None); raises when that device is unusable."""
    from ...models import batch_verify as bv

    dev = bv._lane_device(index, device)
    return MeshLane(
        index,
        bv.make_lane_verify_fn(index, dev),
        wedge_threshold=wedge_threshold,
        verify_prepared_fn=bv.make_lane_verify_prepared_fn(index, dev),
        device=dev,
    )


def build_device_mesh(
    mode: str = "auto",
    *,
    wedge_threshold: int = LANE_WEDGE_THRESHOLD,
    device=None,
) -> VerifierMesh:
    """Production mesh from the models layer's device enumeration.

    mode "off", a named `device` (tests pass "cpu"), or a single visible
    CUDA device yields the single-lane shape: one lane over the device
    model pinned to `device` (CUDA device 0 when None). Modes "auto" and
    "on" give one lane per CUDA device when more than one is visible.
    Nothing here falls back: a device model that fails to import, or CUDA
    missing for a CUDA lane, raises.

    No mesh built here has a sharded collective, where the JAX package's
    multi-device mesh does. On an NVIDIA H100 a shard's graph replay costs
    nearly what a whole batch's does (a replay is bound by its ~0.4 M node
    launches, not by its rows), so a bulk job sharded over two GPUs saves
    little latency and holds two lanes instead of one; the break-even has
    not been measured on several GPUs, and its shard graphs would be
    captured while serving. A caller who wants the sharded road builds
    `VerifierMesh(lanes, sharded_fn=make_mesh_sharded_fn())` and captures
    its graphs first with `models.batch_verify.warm_sharded`."""
    if mode not in MESH_MODES:
        raise ValueError(f"bls_mesh must be one of {MESH_MODES}, got {mode!r}")
    if mode == "off" or device is not None:
        return VerifierMesh([_model_lane(0, device, wedge_threshold)])
    from ...models.batch_verify import mesh_device_count

    n = mesh_device_count()
    if n <= 1:
        return VerifierMesh([_model_lane(0, None, wedge_threshold)])
    return VerifierMesh([_model_lane(i, None, wedge_threshold) for i in range(n)])
