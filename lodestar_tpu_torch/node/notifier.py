"""Node status notifier + process-fault policy (reference
`node/notifier.ts:29` runNodeNotifier and `chain/chain.ts:151`
processShutdownCallback).

`StatusNotifier` logs one human status line per slot (head vs clock,
sync distance, peers, finalized epoch) and warns on low peer count.
`ProcessFaultPolicy` is the abort seam: subsystems report fatal errors
(`on_fatal`), which invoke the node's shutdown callback exactly once —
the reference wires the same callback into the chain so corrupted state
triggers a clean process exit instead of limping on.

The port of `lodestar_tpu.node.notifier`, with its imports rewritten.
"""

from __future__ import annotations

import time

from lodestar_tpu_torch.logger import get_logger

__all__ = ["StatusNotifier", "ProcessFaultPolicy"]

LOW_PEER_COUNT = 3


class ProcessFaultPolicy:
    """Fatal-error funnel: first `on_fatal` fires the shutdown callback
    (reference ProcessShutdownCallback), later ones only log."""

    def __init__(self, shutdown_callback=None):
        self._shutdown = shutdown_callback
        self.fired = False
        self.reason: str | None = None
        self.log = get_logger(name="lodestar.fault")

    def on_fatal(self, subsystem: str, err: BaseException | str) -> None:
        msg = f"fatal error in {subsystem}: {err}"
        if self.fired:
            self.log.error(f"{msg} (shutdown already requested: {self.reason})")
            return
        self.fired = True
        self.reason = msg
        self.log.error(f"{msg} — requesting process shutdown")
        if self._shutdown is not None:
            try:
                self._shutdown(msg)
            except Exception as e:  # the callback must never mask the fault
                self.log.error(f"shutdown callback failed: {e!r}")


class StatusNotifier:
    """Per-slot status line, driven by the node clock."""

    def __init__(self, chain, *, network=None, time_fn=time.monotonic):
        self.chain = chain
        self.network = network
        self._time = time_fn
        self.metrics = getattr(chain, "metrics", None)
        self._last_head_slot = 0
        self._last_t = time_fn()
        self.log = get_logger(name="lodestar.notifier")

    def on_slot(self, clock_slot: int) -> str:
        fc = self.chain.fork_choice
        head = fc.proto_array.get_block(fc.head)
        head_slot = head.slot if head else 0
        skipped = max(0, clock_slot - head_slot)
        peers = len(self.network.host.peers()) if self.network is not None else 0

        now = self._time()
        dt = max(now - self._last_t, 1e-9)
        speed = (head_slot - self._last_head_slot) / dt
        self._last_head_slot, self._last_t = head_slot, now

        if skipped <= 3:
            state = "synced"
        else:
            state = f"syncing ({speed:.2f} slots/s, -{skipped} behind)"
        line = (
            f"{state} - slot: {clock_slot}"
            + (f" (head -{skipped})" if skipped else "")
            + f" - head: {head_slot} {head.block_root[:12] if head else '-'}"
            + f" - finalized: {fc.finalized.epoch}"
            + f" - peers: {peers}"
        )
        self.log.info(line)
        m = self.metrics
        if m is not None:
            m.sync_detail.head_distance.set(skipped)
            m.sync_detail.status.set(2 if skipped <= 3 else (1 if speed > 0 else 0))
            m.peer.peer_count.set(peers)
            if self.network is not None:
                gs = getattr(self.network, "gossip", None)
                if gs is not None:
                    m.gossip_detail.mcache_size.set(
                        sum(len(w) for w in gs.mcache)
                    )
                    for topic, mesh in gs.mesh.items():
                        scores = [gs._score(pid) for pid in mesh] or [0.0]
                        m.gossip_detail.peer_score_by_topic.labels(
                            topic=topic.split("/")[-2] if topic.count("/") >= 3 else topic
                        ).set(sum(scores) / len(scores))
                d5 = getattr(self.network, "discv5", None)
                if d5 is not None:
                    m.peer.discv5_sessions.set(len(getattr(d5, "sessions", {})))
        if self.network is not None and peers < LOW_PEER_COUNT:
            self.log.warn(f"low peer count: {peers}")
        return line
