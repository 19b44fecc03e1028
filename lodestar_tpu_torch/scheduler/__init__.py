"""Device work scheduler: priority-aware launch queue + occupancy + admission.

The PyTorch port's copy of ``lodestar_tpu/scheduler`` (stdlib only),
with the same classes, weights and thresholds.

The accelerator is one shared pipeline fed by workloads with wildly
different deadlines: a gossip block must verify inside its slot, a
range-sync backfill batch merely needs to finish eventually. A FIFO
launch queue lets the second starve the first (head-of-line blocking the
committee-consensus measurements in PAPERS.md call the dominant tail
term once verification is outsourced). This package is the seam every
device launch routes through:

* `PriorityClass` — the five launch classes, most- to least-urgent:
  gossip block > gossip attestation/aggregate > API > range sync >
  backfill. Call sites tag work via `VerifySignatureOpts.priority`.
* `PriorityWorkQueue` — weighted-fair dequeue (stride scheduling: each
  class holds a virtual "pass" advancing by 1/weight per served job, the
  smallest pass wins) so bulk classes keep a trickle of service under
  gossip pressure, plus starvation aging: any head-of-line job older
  than `aging_ms` is served outright. `fifo=True` degrades to the old
  arrival-order queue (the control arm for the saturation tests).
* `OccupancyTracker` — EWMA busy-ns per wall-ns around device launches;
  the ROADMAP's "can this host absorb another beacon node" number.
* `AdmissionController` — grades the binary can-accept gate into
  ACCEPT / SHED_BULK / REJECT from occupancy + queue depth, the frame
  `BlsOffloadServer.Status` ships to clients for load-aware routing.

Dependency-free by design: `chain/bls`, `offload` and the call sites all
import from here, never the reverse.
"""

from .core import (  # noqa: F401
    BULK_CLASSES,
    DEFAULT_AGING_MS,
    DEFAULT_WEIGHTS,
    PriorityClass,
    PriorityWorkQueue,
)
from .occupancy import (  # noqa: F401
    AdmissionController,
    AdmissionState,
    OccupancyTracker,
)

__all__ = [
    "PriorityClass",
    "PriorityWorkQueue",
    "BULK_CLASSES",
    "DEFAULT_WEIGHTS",
    "DEFAULT_AGING_MS",
    "OccupancyTracker",
    "AdmissionController",
    "AdmissionState",
]
