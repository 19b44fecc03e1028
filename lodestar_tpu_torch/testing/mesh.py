"""Mesh fixtures: drive the multi-device serving path on the CPU.

The PyTorch port's copy of ``lodestar_tpu/testing/mesh.py``'s
`FakeLaneRig`. The production mesh backs onto real GPUs; the CPU tests
run without one. The JAX package closes that gap twice: an XLA flag that
makes the CPU backend expose N virtual devices (its `mesh_env`,
`virtual_device_count`, `require_virtual_devices`), and fake lane
backends. The flag has no counterpart here: PyTorch's "cpu" device is a
device like any other, so the port's multi-device tests put each lane,
and each shard of the real sharded verify, on ``"cpu"``
(``models/batch_verify.make_mesh_sharded_fn(devices=["cpu", "cpu"])``).

**Fake lane backends** — per-device-lane and sharded-bulk INVARIANTS
(who served what, how errors degrade) do not need real pairings.
`FakeLaneRig` builds an N-lane `VerifierMesh` over recording fake
backends with injectable per-lane latency and errors, and a recording
collective that notes which lane subset each sharded launch used.
"""

from __future__ import annotations

import threading
import time

from ..chain.bls.mesh import MeshLane, VerifierMesh

__all__ = ["FakeLaneRig"]


class FakeLaneRig:
    """N-lane mesh over recording fake backends.

    Each lane's verify_fn sleeps `call_s`, records (device_index, tag)
    per call, and raises while its index is in `failing` — the seam for
    lane-kill tests. The collective `sharded_fn` (unless `with_sharded`
    is False) records the device subset per launch and delegates the
    verdict to `verdict_fn` (default: all sets valid).
    `calls`/`sharded_calls` are appended under a lock so executor threads
    can't tear them."""

    def __init__(
        self,
        n_lanes: int,
        *,
        call_s: float = 0.0,
        wedge_threshold: int = 2,
        verdict_fn=None,
        with_sharded: bool = True,
        with_prepared: bool = False,
    ) -> None:
        self.call_s = call_s
        self.verdict_fn = verdict_fn or (lambda sets: True)
        self._record_lock = threading.Lock()
        self.calls: list[tuple[int, int]] = []  # guarded by: _record_lock
        self.prepared_calls: list[tuple[int, int]] = []  # guarded by: _record_lock
        self.sharded_calls: list[tuple[int, ...]] = []  # guarded by: _record_lock
        self.failing: set[int] = set()  # guarded by: _record_lock — lanes currently erroring
        lanes = [
            MeshLane(
                i,
                self._make_lane_fn(i),
                wedge_threshold=wedge_threshold,
                verify_prepared_fn=(
                    self._make_prepared_fn(i) if with_prepared else None
                ),
            )
            for i in range(n_lanes)
        ]
        self.mesh = VerifierMesh(
            lanes, sharded_fn=self._sharded if with_sharded else None
        )

    @staticmethod
    def prep_fn(sets, lane_hint):
        """Pool `prep_fn` seam twin: wraps the sets as staged 'inputs'
        so the prepared lane callables can delegate to `verdict_fn` —
        the pipeline invariants don't need real limb arrays."""
        return ("prepped", list(sets), lane_hint)

    def _make_lane_fn(self, index: int):
        def lane_fn(sets):
            if self.call_s:
                time.sleep(self.call_s)
            with self._record_lock:
                failing = index in self.failing
                self.calls.append((index, len(sets)))
            if failing:
                raise RuntimeError(f"injected device error on dev{index}")
            return self.verdict_fn(sets)

        return lane_fn

    def _make_prepared_fn(self, index: int):
        def lane_prepared_fn(inputs):
            tag, sets, _hint = inputs
            assert tag == "prepped"
            if self.call_s:
                time.sleep(self.call_s)
            with self._record_lock:
                failing = index in self.failing
                self.calls.append((index, len(sets)))
                self.prepared_calls.append((index, len(sets)))
            if failing:
                raise RuntimeError(f"injected device error on dev{index}")
            return self.verdict_fn(sets)

        return lane_prepared_fn

    def _sharded(self, sets, device_indices):
        if self.call_s:
            time.sleep(self.call_s)
        with self._record_lock:
            failing = bool(set(device_indices) & self.failing)
            self.sharded_calls.append(tuple(device_indices))
        if failing:
            raise RuntimeError(f"injected device error in collective {device_indices}")
        return self.verdict_fn(sets)

    def kill(self, index: int) -> None:
        with self._record_lock:
            self.failing.add(index)

    def heal(self, index: int) -> None:
        with self._record_lock:
            self.failing.discard(index)

    def served_by(self, index: int) -> int:
        with self._record_lock:
            return sum(1 for i, _ in self.calls if i == index)
