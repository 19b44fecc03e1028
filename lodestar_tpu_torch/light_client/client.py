"""The driving light client (reference `light-client/src/index.ts:99`
`Lightclient` + `transport/rest.ts`): bootstrap from a trusted block
root, follow sync-committee updates period by period, track
finality/optimistic updates, and emit head events.

Transport: any object with the four REST-shaped methods (the repo's
`BeaconApiClient` provides them over HTTP; tests may inject an
in-process adapter over a LightClientServer):

    get_lc_bootstrap(block_root_hex) -> {"data": bootstrap_json}
    get_lc_updates(start_period, count) -> {"data": [{"data": update_json}]}
    get_lc_finality_update() -> {"version", "data"} (404 -> None)
    get_lc_optimistic_update() -> likewise

The port of `lodestar_tpu.light_client.client` (host Python, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.types import ssz_types

from . import LightClientError, LightClientStore, sync_committee_period

__all__ = ["Lightclient", "RunStatusCode"]


class RunStatusCode:
    UNINITIALIZED = "uninitialized"
    SYNCING = "syncing"
    STARTED = "started"
    STOPPED = "stopped"


# current_sync_committee leaf index in the altair BeaconState field
# layer: field 22 of 25 fields padded to 32 leaves (spec
# CURRENT_SYNC_COMMITTEE_INDEX = gindex 54 = 32 + 22).
CURRENT_SYNC_COMMITTEE_LEAF = 22


class Lightclient:
    def __init__(
        self,
        *,
        transport,
        genesis_validators_root: bytes,
        fork_version: bytes,
        p: BeaconPreset | None = None,
    ):
        self.transport = transport
        self.gvr = bytes(genesis_validators_root)
        self.fork_version = bytes(fork_version)
        self.p = p or active_preset()
        self.store: LightClientStore | None = None
        self.status = RunStatusCode.UNINITIALIZED
        self.head_listeners: list = []  # fn(header)
        self.log = get_logger(name="lodestar.light-client")

    # -- bootstrap -------------------------------------------------------------

    def bootstrap(self, trusted_block_root: bytes) -> None:
        """Fetch + verify the bootstrap: the header must match the
        trusted root and the committee branch must prove into its state
        root (spec initialize_light_client_store)."""
        t = ssz_types(self.p)
        from lodestar_tpu_torch.ssz.json import from_json

        res = self.transport.get_lc_bootstrap("0x" + bytes(trusted_block_root).hex())
        bootstrap = from_json(t.LightClientBootstrap, res["data"])
        header_root = t.BeaconBlockHeader.hash_tree_root(bootstrap.header.beacon)
        if header_root != bytes(trusted_block_root):
            raise LightClientError("bootstrap header does not match trusted root")
        from lodestar_tpu_torch.ssz.merkle import verify_merkle_branch

        committee_root = t.SyncCommittee.hash_tree_root(bootstrap.current_sync_committee)
        if not verify_merkle_branch(
            committee_root,
            [bytes(b) for b in bootstrap.current_sync_committee_branch],
            CURRENT_SYNC_COMMITTEE_LEAF,
            bytes(bootstrap.header.beacon.state_root),
        ):
            raise LightClientError("bootstrap sync-committee branch invalid")
        self.store = LightClientStore(
            finalized_header=bootstrap.header,
            current_sync_committee=bootstrap.current_sync_committee,
            optimistic_header=bootstrap.header,
            p=self.p,
        )
        self.status = RunStatusCode.SYNCING
        self.log.info(
            f"light client bootstrapped at slot {int(bootstrap.header.beacon.slot)}"
        )

    # -- sync ------------------------------------------------------------------

    def _current_period(self) -> int:
        assert self.store is not None
        epoch = int(self.store.finalized_header.beacon.slot) // self.p.SLOTS_PER_EPOCH
        return sync_committee_period(epoch, self.p)

    def sync_to_head(
        self,
        target_period: int | None = None,
        *,
        current_slot: int | None = None,
        max_periods: int = 128,
    ) -> int:
        """Pull committee updates period by period until caught up.
        `current_slot` (the wall clock, when the caller has one) feeds
        the force-update timeout; otherwise the freshest update's
        signature slot stands in. Returns the number of updates applied."""
        if self.store is None:
            raise LightClientError("bootstrap first")
        t = ssz_types(self.p)
        from lodestar_tpu_torch.ssz.json import from_json

        applied = 0
        # a period CURSOR independent of the finalized header: without
        # finality evidence the store's finalized period lags, and
        # re-fetching it would loop on the same (spec-preferred, oldest)
        # best update forever — the reference walks periods forward the
        # same way (one update per period)
        period = self._current_period()
        for _ in range(max_periods):
            if target_period is not None and period >= target_period:
                break
            res = self.transport.get_lc_updates(period, 1)
            updates = res.get("data", [])
            if not updates:
                break
            update = from_json(t.LightClientUpdate, updates[0]["data"])
            before = int(self.store.finalized_header.beacon.slot)
            try:
                self.store.process_update(update, self.gvr, self.fork_version)
                applied += 1
            except LightClientError as e:
                self.log.warn(f"update for period {period} rejected: {e}")
                break
            if int(self.store.finalized_header.beacon.slot) > before:
                self._emit_head()
            else:
                # no finality evidence: past UPDATE_TIMEOUT the spec's
                # force-update adopts the best attested header/committee
                clock = max(int(update.signature_slot), int(current_slot or 0))
                if self.store.force_update(clock):
                    self._emit_head()
            period += 1
        self.status = RunStatusCode.STARTED
        return applied

    def poll_head(self) -> None:
        """One head-follow tick: apply the latest finality + optimistic
        updates if present (the reference's event-driven path, polled)."""
        if self.store is None:
            raise LightClientError("bootstrap first")
        t = ssz_types(self.p)
        from lodestar_tpu_torch.ssz.json import from_json

        for getter, type_name in (
            (self.transport.get_lc_finality_update, "LightClientFinalityUpdate"),
            (self.transport.get_lc_optimistic_update, "LightClientOptimisticUpdate"),
        ):
            try:
                res = getter()
            except Exception:
                continue  # 404: nothing yet
            update = from_json(getattr(t, type_name), res["data"])
            # both shapes validate through the full-update path with the
            # absent fields zeroed (validate_light_client_update treats
            # zero next_sync_committee / finality branch as not-present)
            try:
                self.store.process_update(
                    self._as_full_update(update, t), self.gvr, self.fork_version
                )
                self._emit_head()
            except LightClientError:
                pass

    def _as_full_update(self, update, t):
        full = t.LightClientUpdate.default()
        full.attested_header = update.attested_header
        full.sync_aggregate = update.sync_aggregate
        full.signature_slot = update.signature_slot
        if hasattr(update, "finalized_header"):
            full.finalized_header = update.finalized_header
            full.finality_branch = update.finality_branch
        return full

    # -- events ----------------------------------------------------------------

    def on_head(self, fn) -> None:
        self.head_listeners.append(fn)

    def _emit_head(self) -> None:
        header = self.store.optimistic_header
        for fn in self.head_listeners:
            try:
                fn(header)
            except Exception:
                pass

    @property
    def head_slot(self) -> int:
        if self.store is None or self.store.optimistic_header is None:
            return 0
        return int(self.store.optimistic_header.beacon.slot)

    @property
    def finalized_slot(self) -> int:
        if self.store is None:
            return 0
        return int(self.store.finalized_header.beacon.slot)
