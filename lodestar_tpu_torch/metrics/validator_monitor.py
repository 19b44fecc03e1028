"""Per-validator performance monitor (reference
`metrics/validatorMonitor.ts`): track registered local validators'
block proposals and attestation life-cycle (seen on gossip, included in
blocks, inclusion distance), and summarize per epoch.

Wire-in points (the same seams the reference hooks):
* `register_local_validator(index)` — from the validator/keymanager
* `on_block_imported(slot, proposer_index)` — chain import
* `on_attestation_in_block(epoch, indices, inclusion_distance)` — STF
  block-ops processing
* `on_gossip_attestation(epoch, indices)` — gossip validation accept
* `on_epoch(epoch)` — clock epoch boundary: flush the previous epoch's
  summaries into the prometheus series

The port of `lodestar_tpu.metrics.validator_monitor`, with its imports rewritten.
"""

from __future__ import annotations

from collections import defaultdict

__all__ = ["ValidatorMonitor"]


class ValidatorMonitor:
    def __init__(self, creator):
        self._validators: set[int] = set()
        self._first_observed_epoch: int | None = None
        # epoch -> index -> status
        self._gossip_seen: dict[int, set[int]] = defaultdict(set)
        self._included: dict[int, set[int]] = defaultdict(set)
        self._distances: dict[int, dict[int, int]] = defaultdict(dict)
        self._blocks: dict[int, int] = defaultdict(int)  # index -> proposals

        self.validators_total = creator.gauge(
            "validator_monitor_validators_total", "Registered local validators"
        )
        self.prev_epoch_attestations = creator.counter(
            "validator_monitor_prev_epoch_attestations_total",
            "Local validators attesting in the previous epoch",
        )
        self.prev_epoch_attestation_misses = creator.counter(
            "validator_monitor_prev_epoch_attestations_missed_total",
            "Local validators that missed the previous epoch",
        )
        self.prev_epoch_inclusion_distance = creator.histogram(
            "validator_monitor_prev_epoch_attestation_inclusion_distance",
            "Inclusion distance of local attestations",
            (1, 2, 3, 4, 8, 16, 32),
        )
        self.blocks_total = creator.counter(
            "validator_monitor_beacon_block_total", "Blocks proposed by local validators"
        )
        self.gossip_attestations = creator.counter(
            "validator_monitor_unaggregated_attestation_total",
            "Local attestations seen on gossip",
        )

    # -- registration ----------------------------------------------------------

    def register_local_validator(self, index: int) -> None:
        self._validators.add(int(index))
        self.validators_total.set(len(self._validators))

    @property
    def count(self) -> int:
        return len(self._validators)

    # -- observation hooks -----------------------------------------------------

    def on_block_imported(self, slot: int, proposer_index: int) -> None:
        if int(proposer_index) in self._validators:
            self._blocks[int(proposer_index)] += 1
            self.blocks_total.inc()

    def on_gossip_attestation(self, epoch: int, indices) -> None:
        if self._first_observed_epoch is None:
            self._first_observed_epoch = int(epoch)
        for i in indices:
            if int(i) in self._validators:
                self._gossip_seen[int(epoch)].add(int(i))
                self.gossip_attestations.inc()

    def on_attestation_in_block(self, epoch: int, indices, inclusion_distance: int) -> None:
        if self._first_observed_epoch is None:
            self._first_observed_epoch = int(epoch)
        dist = max(1, int(inclusion_distance))
        for i in indices:
            i = int(i)
            if i in self._validators:
                self._included[int(epoch)].add(i)
                prev = self._distances[int(epoch)].get(i)
                if prev is None or dist < prev:
                    self._distances[int(epoch)][i] = dist

    # -- epoch summary ---------------------------------------------------------

    def on_epoch(self, epoch: int) -> dict:
        """Flush epoch-2 (attestations for epoch e land up to e+1) and
        prune. Returns the summary dict for logging."""
        target = int(epoch) - 2
        if target < 0 or not self._validators:
            return {}
        included = self._included.pop(target, set())
        self._gossip_seen.pop(target, None)
        distances = self._distances.pop(target, {})
        # prune anything older than the flush target too (historical
        # range-sync epochs and clock jumps would otherwise accumulate
        # per-epoch sets for the process lifetime)
        for store in (self._included, self._gossip_seen, self._distances):
            for old in [e for e in store if e < target]:
                del store[old]
        # epochs before monitoring began have no observations by
        # construction: judging them would report a spurious 100% miss on
        # every restart
        if self._first_observed_epoch is None or target < self._first_observed_epoch:
            return {}
        hit = len(included & self._validators)
        miss = len(self._validators) - hit
        self.prev_epoch_attestations.inc(hit)
        self.prev_epoch_attestation_misses.inc(miss)
        for d in distances.values():
            self.prev_epoch_inclusion_distance.observe(d)
        return {
            "epoch": target,
            "attested": hit,
            "missed": miss,
            "avg_inclusion_distance": (
                sum(distances.values()) / len(distances) if distances else 0.0
            ),
        }
