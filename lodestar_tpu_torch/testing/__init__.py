"""Deterministic test harnesses for the port's failure paths.

The PyTorch port's copy of ``lodestar_tpu/testing/__init__.py``, with the
same exports. `faults` is the fault-injection seam a chaos run drives
through the offload client/server and the verify backend — seeded,
scheduled fault delivery so every run is reproducible from its seed.
`clock` is the virtual-time seam (`SimClock`). `mesh` holds
`FakeLaneRig`, the recording lane mesh of the pool's multi-lane tests
(imported from ``testing.mesh``, as in the JAX package). The JAX
package's `fleet` harness is not ported.
"""

from .clock import SimClock  # noqa: F401
from .faults import FaultInjector, FaultKind, FaultRule  # noqa: F401

__all__ = ["FaultInjector", "FaultKind", "FaultRule", "SimClock"]
