"""Light client: update verification, selection, store processing +
server-side proof production.

Reference `packages/light-client/src` (`Lightclient` `index.ts:99`,
`spec/processLightClientUpdate.ts`, `isBetterUpdate` in `spec/utils.ts`)
and the node-side proof producer (`chain/lightClient/proofs.ts`).

The altair light-client sync protocol, written from the spec:
* validate: sync-aggregate participation >= MIN_SYNC_COMMITTEE_PARTICIPANTS,
  finality branch proves finalized_header under attested.state_root,
  next-sync-committee branch proves under attested.state_root, and the
  sync committee's aggregate BLS signature covers the attested header's
  signing root for DOMAIN_SYNC_COMMITTEE.
* is_better_update: supermajority > finality > participation > age.
* LightClientStore: apply updates, advance finalized/optimistic headers
  across sync-committee periods.

The port of `lodestar_tpu.light_client` (host Python, as there). The
sync aggregate is checked through the host oracle's
`crypto.bls.api.fast_aggregate_verify`, as there: no device path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from lodestar_tpu_torch.config import compute_signing_root
from lodestar_tpu_torch.crypto.bls import api as bls
from lodestar_tpu_torch.params import DOMAIN_SYNC_COMMITTEE, BeaconPreset, active_preset
from lodestar_tpu_torch.ssz.merkle import merkle_branch, verify_merkle_branch
from lodestar_tpu_torch.types import ssz_types

__all__ = [
    "FINALIZED_ROOT_DEPTH",
    "NEXT_SYNC_COMMITTEE_DEPTH",
    "LightClientStore",
    "LightClientError",
    "validate_light_client_update",
    "is_better_update",
    "produce_state_field_branch",
    "sync_committee_period",
]

# spec generalized indices: FINALIZED_ROOT_INDEX=105 (depth 6, leaf 41),
# NEXT_SYNC_COMMITTEE_INDEX=55 (depth 5, leaf 23)
FINALIZED_ROOT_DEPTH = 6
FINALIZED_ROOT_LEAF = 41
NEXT_SYNC_COMMITTEE_DEPTH = 5
NEXT_SYNC_COMMITTEE_LEAF = 23


class LightClientError(Exception):
    pass


def sync_committee_period(epoch: int, p: BeaconPreset | None = None) -> int:
    p = p or active_preset()
    return epoch // p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD


def produce_state_field_branch(state, field_name: str) -> list[bytes]:
    """Server side (reference `chain/lightClient/proofs.ts`): sibling path
    proving `field_name`'s root under the state root."""
    ctype = state.type
    roots = b"".join(ft.hash_tree_root(getattr(state, fn)) for fn, ft in ctype.fields)
    index = ctype.field_index(field_name)
    return merkle_branch(roots, index)


def _participation(update) -> int:
    return sum(1 for b in update.sync_aggregate.sync_committee_bits if b)


def validate_light_client_update(
    store: "LightClientStore",
    update,
    genesis_validators_root: bytes,
    fork_version: bytes,
    p: BeaconPreset | None = None,
) -> None:
    """Spec validate_light_client_update (raises on invalid)."""
    p = p or active_preset()
    t = ssz_types(p)

    if _participation(update) < p.MIN_SYNC_COMMITTEE_PARTICIPANTS:
        raise LightClientError("insufficient sync committee participation")

    attested = update.attested_header
    att_epoch = attested.beacon.slot // p.SLOTS_PER_EPOCH

    # finality proof (if the update carries a finalized header)
    fin = update.finalized_header
    if any(bytes(fin.beacon.body_root) != b"\x00" * 32 for _ in [0]) or fin.beacon.slot != 0:
        fin_root = t.BeaconBlockHeader.hash_tree_root(fin.beacon)
        if not verify_merkle_branch(
            fin_root,
            [bytes(b) for b in update.finality_branch],
            FINALIZED_ROOT_LEAF,
            bytes(attested.beacon.state_root),
        ):
            raise LightClientError("invalid finality branch")

    # next sync committee proof (if present)
    nsc = update.next_sync_committee
    if bytes(nsc.aggregate_pubkey) != b"\x00" * 48:
        nsc_root = t.SyncCommittee.hash_tree_root(nsc)
        if not verify_merkle_branch(
            nsc_root,
            [bytes(b) for b in update.next_sync_committee_branch],
            NEXT_SYNC_COMMITTEE_LEAF,
            bytes(attested.beacon.state_root),
        ):
            raise LightClientError("invalid next-sync-committee branch")

    # committee selection by the signature slot's period (spec
    # validate_light_client_update): same period as the store -> current,
    # next period -> next (must be known)
    store_period = sync_committee_period(
        store.finalized_header.beacon.slot // p.SLOTS_PER_EPOCH, p
    )
    sig_period = sync_committee_period(
        max(0, update.signature_slot - 1) // p.SLOTS_PER_EPOCH, p
    )
    if sig_period == store_period:
        committee = store.current_sync_committee
    elif sig_period == store_period + 1 and store.next_sync_committee is not None:
        committee = store.next_sync_committee
    else:
        raise LightClientError(
            f"signature period {sig_period} not covered (store period {store_period})"
        )
    bits = list(update.sync_aggregate.sync_committee_bits)
    pubkeys = [bytes(pk) for pk, bit in zip(committee.pubkeys, bits) if bit]
    from lodestar_tpu_torch.config import compute_domain

    domain = compute_domain(DOMAIN_SYNC_COMMITTEE, fork_version, genesis_validators_root)
    signing_root = compute_signing_root(t.BeaconBlockHeader, attested.beacon, domain)
    if not bls.fast_aggregate_verify(
        pubkeys, signing_root, bytes(update.sync_aggregate.sync_committee_signature)
    ):
        raise LightClientError("invalid sync aggregate signature")


def is_better_update(new, old) -> bool:
    """Spec isBetterUpdate (reference `spec/utils.ts`)."""
    max_bits = len(list(new.sync_aggregate.sync_committee_bits))
    new_part = _participation(new)
    old_part = _participation(old)
    new_super = new_part * 3 >= max_bits * 2
    old_super = old_part * 3 >= max_bits * 2
    if new_super != old_super:
        return new_super
    new_finality = new.finalized_header.beacon.slot != 0
    old_finality = old.finalized_header.beacon.slot != 0
    if new_finality != old_finality:
        return new_finality
    if new_part != old_part:
        return new_part > old_part
    return new.attested_header.beacon.slot < old.attested_header.beacon.slot


@dataclass
class LightClientStore:
    """Reference `Lightclient` state: finalized + optimistic headers,
    current/next sync committees, best pending update."""

    finalized_header: object
    current_sync_committee: object
    next_sync_committee: object | None = None
    optimistic_header: object | None = None
    best_valid_update: object | None = None
    p: BeaconPreset = field(default_factory=active_preset)

    def process_update(
        self, update, genesis_validators_root: bytes, fork_version: bytes
    ) -> None:
        """Spec process_light_client_update: validate, track best, apply
        on finality / supermajority."""
        validate_light_client_update(
            self, update, genesis_validators_root, fork_version, self.p
        )
        if self.best_valid_update is None or is_better_update(update, self.best_valid_update):
            self.best_valid_update = update

        att = update.attested_header
        if (
            self.optimistic_header is None
            or att.beacon.slot > self.optimistic_header.beacon.slot
        ):
            self.optimistic_header = att

        max_bits = len(list(update.sync_aggregate.sync_committee_bits))
        has_finality = update.finalized_header.beacon.slot != 0
        supermajority = _participation(update) * 3 >= max_bits * 2
        if has_finality and supermajority:
            fin = update.finalized_header
            if fin.beacon.slot > self.finalized_header.beacon.slot:
                prev_period = sync_committee_period(
                    self.finalized_header.beacon.slot // self.p.SLOTS_PER_EPOCH, self.p
                )
                new_period = sync_committee_period(
                    fin.beacon.slot // self.p.SLOTS_PER_EPOCH, self.p
                )
                if new_period > prev_period and self.next_sync_committee is not None:
                    self.current_sync_committee = self.next_sync_committee
                    self.next_sync_committee = None
                self.finalized_header = fin
            if bytes(update.next_sync_committee.aggregate_pubkey) != b"\x00" * 48:
                self.next_sync_committee = update.next_sync_committee
            self.best_valid_update = None

    def force_update(self, current_slot: int) -> bool:
        """Spec process_light_client_store_force_update: past
        UPDATE_TIMEOUT (one sync-committee period) without finality
        evidence, adopt the best valid update's attested header as
        finalized so the store can keep moving."""
        upd = self.best_valid_update
        if upd is None:
            return False
        timeout = self.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD * self.p.SLOTS_PER_EPOCH
        if int(current_slot) <= int(self.finalized_header.beacon.slot) + timeout:
            return False
        progressed = False
        # adopting the update's next committee is progress on its own: it
        # unlocks validating the NEXT period's updates even when the
        # attested header itself is older than our finalized header
        if (
            self.next_sync_committee is None
            and bytes(upd.next_sync_committee.aggregate_pubkey) != b"\x00" * 48
        ):
            self.next_sync_committee = upd.next_sync_committee
            progressed = True
        att = upd.attested_header
        if int(att.beacon.slot) > int(self.finalized_header.beacon.slot):
            prev_period = sync_committee_period(
                int(self.finalized_header.beacon.slot) // self.p.SLOTS_PER_EPOCH, self.p
            )
            new_period = sync_committee_period(
                int(att.beacon.slot) // self.p.SLOTS_PER_EPOCH, self.p
            )
            if new_period > prev_period:
                if self.next_sync_committee is None:
                    return progressed  # cannot cross a period blind
                self.current_sync_committee = self.next_sync_committee
                # adopt the update's own next committee across the
                # rotation (spec apply_light_client_update) so the walk
                # continues period by period without re-stalling
                if bytes(upd.next_sync_committee.aggregate_pubkey) != b"\x00" * 48:
                    self.next_sync_committee = upd.next_sync_committee
                else:
                    self.next_sync_committee = None
            self.finalized_header = att
            if self.optimistic_header is None or int(att.beacon.slot) > int(
                self.optimistic_header.beacon.slot
            ):
                self.optimistic_header = att
            progressed = True
        self.best_valid_update = None
        return progressed
