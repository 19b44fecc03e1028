"""Deterministic test harnesses for the port's failure paths.

The PyTorch port's copy of ``lodestar_tpu/testing/__init__.py``, with the
same exports. `faults` is the fault-injection seam a chaos run drives
through the offload client/server and the verify backend — seeded,
scheduled fault delivery so every run is reproducible from its seed.
`clock` is the virtual-time seam (`SimClock`). `mesh` holds
`FakeLaneRig`, the recording lane mesh of the pool's multi-lane tests
(imported from ``testing.mesh``, as in the JAX package). `fleet` is the
seeded multi-node chaos harness built on `clock` and `faults`: N in-process
beacon verification stacks against M offload hosts and a replayable verdict
ledger. It pulls the whole offload stack, so it is imported from
``testing.fleet``, as in the JAX package.
"""

from .clock import SimClock  # noqa: F401
from .faults import FaultInjector, FaultKind, FaultRule  # noqa: F401

__all__ = ["FaultInjector", "FaultKind", "FaultRule", "SimClock"]
