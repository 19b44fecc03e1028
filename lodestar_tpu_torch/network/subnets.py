"""Subnet services: attnets rotation, syncnets, and node metadata.

Reference `beacon-node/src/network/subnets/attnetsService.ts:47`
(committee/short-lived + random/long-lived attestation subnets,
LAST_SEEN_VALIDATOR_TIMEOUT=150 slots, random subscriptions renewed
every randBetween(256, 512) epochs), `syncnetsService.ts` (sync
committee subnets held to the period end), and `metadata.ts`
(MetadataController: seq_number bumped on every attnets/syncnets
change — peers poll it via the reqresp metadata protocol).

The gossip side is a `subscriber` with subscribe(subnet)/
unsubscribe(subnet); the node runtime binds it to topic subscriptions.

The port of `lodestar_tpu.network.subnets` (host Python, as there).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from lodestar_tpu_torch.params import (
    ATTESTATION_SUBNET_COUNT,
    SYNC_COMMITTEE_SUBNET_COUNT,
    BeaconPreset,
    active_preset,
)

__all__ = [
    "CommitteeSubscription",
    "AttnetsService",
    "SyncnetsService",
    "MetadataController",
    "RANDOM_SUBNETS_PER_VALIDATOR",
    "EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION",
]

RANDOM_SUBNETS_PER_VALIDATOR = 1
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION = 256
LAST_SEEN_VALIDATOR_TIMEOUT_SLOTS = 150


@dataclass
class CommitteeSubscription:
    """One validator duty subscription (reference
    CommitteeSubscription in subnets/interface.ts)."""

    validator_index: int
    subnet: int
    slot: int
    is_aggregator: bool


class _SubnetMap:
    """subnet -> expiry slot (last slot the subscription is wanted)."""

    def __init__(self):
        self._expiry: dict[int, int] = {}

    def request(self, subnet: int, to_slot: int) -> None:
        self._expiry[subnet] = max(self._expiry.get(subnet, -1), int(to_slot))

    def active(self, slot: int) -> list[int]:
        return sorted(s for s, exp in self._expiry.items() if exp >= slot)

    def prune(self, slot: int) -> list[int]:
        """Drop expired entries; returns the subnets that expired."""
        gone = [s for s, exp in self._expiry.items() if exp < slot]
        for s in gone:
            del self._expiry[s]
        return gone

    def has(self, subnet: int, slot: int) -> bool:
        return self._expiry.get(subnet, -1) >= slot


def _reconcile_subscriptions(want: set, subscribed: set, subscriber) -> set:
    """Diff the wanted subnet set against the currently-subscribed one,
    issuing subscribe/unsubscribe calls; returns the new subscribed set
    (shared by attnets and syncnets)."""
    for subnet in sorted(want - subscribed):
        if subscriber is not None:
            subscriber.subscribe(subnet)
    for subnet in sorted(subscribed - want):
        if subscriber is not None:
            subscriber.unsubscribe(subnet)
    return want


class MetadataController:
    """The node's gossip metadata record (reference
    network/metadata.ts): seq_number increments whenever the advertised
    attnets/syncnets change, so peers refresh via the metadata
    protocol."""

    def __init__(self):
        self.seq_number = 0
        self.attnets = [False] * ATTESTATION_SUBNET_COUNT
        self.syncnets = [False] * SYNC_COMMITTEE_SUBNET_COUNT

    def update_attnets(self, subnets: list[int]) -> None:
        new = [i in set(subnets) for i in range(ATTESTATION_SUBNET_COUNT)]
        if new != self.attnets:
            self.attnets = new
            self.seq_number += 1

    def update_syncnets(self, subnets: list[int]) -> None:
        new = [i in set(subnets) for i in range(SYNC_COMMITTEE_SUBNET_COUNT)]
        if new != self.syncnets:
            self.syncnets = new
            self.seq_number += 1


class AttnetsService:
    """Short-lived committee subnets for duties + long-lived random
    subnets per known validator (reference attnetsService.ts:47)."""

    def __init__(
        self,
        *,
        subscriber=None,
        metadata: MetadataController | None = None,
        p: BeaconPreset | None = None,
        rand_fn=random.randint,
        shuffle_fn=random.shuffle,
    ) -> None:
        self.p = p or active_preset()
        self.subscriber = subscriber
        self.metadata = metadata or MetadataController()
        self.rand_fn = rand_fn
        self.shuffle_fn = shuffle_fn
        self.committee_subnets = _SubnetMap()  # peers wanted (PeerManager reads)
        self.subscribed_committee = _SubnetMap()  # gossip-subscribed (aggregators)
        # validator_index -> last seen slot
        self._known_validators: dict[int, int] = {}
        # subnet -> expiry slot for the long-lived random subscriptions
        self.random_subnets = _SubnetMap()
        self._gossip_subscribed: set[int] = set()
        self._current_slot = 0

    # -- duties ---------------------------------------------------------------

    def add_committee_subscriptions(self, subscriptions: list[CommitteeSubscription]) -> None:
        for sub in subscriptions:
            # +1 slot so aggregation at the duty slot still sees messages
            self.committee_subnets.request(sub.subnet, sub.slot + 1)
            if sub.is_aggregator:
                self.subscribed_committee.request(sub.subnet, sub.slot + 1)
            self._note_validator(sub.validator_index)
        self._reconcile()

    def _note_validator(self, validator_index: int) -> None:
        first_seen = validator_index not in self._known_validators
        self._known_validators[validator_index] = self._current_slot
        if first_seen:
            self._add_random_subnets()

    def _add_random_subnets(self) -> None:
        """Top the long-lived random subscriptions up to
        known_validators * RANDOM_SUBNETS_PER_VALIDATOR (capped at the
        subnet count)."""
        spe = self.p.SLOTS_PER_EPOCH
        active = set(self.random_subnets.active(self._current_slot))
        want = min(
            len(self._known_validators) * RANDOM_SUBNETS_PER_VALIDATOR,
            ATTESTATION_SUBNET_COUNT,
        )
        candidates = [s for s in range(ATTESTATION_SUBNET_COUNT) if s not in active]
        self.shuffle_fn(candidates)
        for subnet in candidates[: max(0, want - len(active))]:
            duration_epochs = self.rand_fn(
                EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION, 2 * EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION
            )
            self.random_subnets.request(subnet, self._current_slot + duration_epochs * spe)

    # -- clock ----------------------------------------------------------------

    def on_slot(self, slot: int) -> None:
        self._current_slot = int(slot)
        self.committee_subnets.prune(slot)
        self.subscribed_committee.prune(slot)
        expired_random = self.random_subnets.prune(slot)
        # forget validators not seen for the timeout; their random
        # subnets lapse at their own expiries
        floor = slot - LAST_SEEN_VALIDATOR_TIMEOUT_SLOTS
        for vi in [vi for vi, seen in self._known_validators.items() if seen < floor]:
            del self._known_validators[vi]
        if expired_random and self._known_validators:
            self._add_random_subnets()
        self._reconcile()

    # -- queries ---------------------------------------------------------------

    def should_process(self, subnet: int, slot: int) -> bool:
        """Aggregator duty check for incoming gossip (reference
        shouldProcess)."""
        return self.subscribed_committee.has(subnet, slot)

    def active_subnets(self, slot: int | None = None) -> list[int]:
        slot = self._current_slot if slot is None else slot
        return sorted(
            set(self.subscribed_committee.active(slot)) | set(self.random_subnets.active(slot))
        )

    def _reconcile(self) -> None:
        self._gossip_subscribed = _reconcile_subscriptions(
            set(self.active_subnets()), self._gossip_subscribed, self.subscriber
        )
        # only long-lived subnets are advertised in the ENR/metadata
        # (reference updateMetadata uses random subnets)
        self.metadata.update_attnets(self.random_subnets.active(self._current_slot))


class SyncnetsService:
    """Sync-committee subnets, held to the end of the subscription
    period (reference syncnetsService.ts)."""

    def __init__(
        self,
        *,
        subscriber=None,
        metadata: MetadataController | None = None,
        p: BeaconPreset | None = None,
    ) -> None:
        self.p = p or active_preset()
        self.subscriber = subscriber
        self.metadata = metadata or MetadataController()
        self.subnets = _SubnetMap()
        self._gossip_subscribed: set[int] = set()
        self._current_slot = 0

    def add_sync_committee_subscriptions(self, subscriptions: list[CommitteeSubscription]) -> None:
        for sub in subscriptions:
            self.subnets.request(sub.subnet, sub.slot)
        self._reconcile()

    def on_slot(self, slot: int) -> None:
        self._current_slot = int(slot)
        self.subnets.prune(slot)
        self._reconcile()

    def active_subnets(self, slot: int | None = None) -> list[int]:
        return self.subnets.active(self._current_slot if slot is None else slot)

    def _reconcile(self) -> None:
        want = set(self.subnets.active(self._current_slot))
        self._gossip_subscribed = _reconcile_subscriptions(
            want, self._gossip_subscribed, self.subscriber
        )
        self.metadata.update_syncnets(sorted(want))
