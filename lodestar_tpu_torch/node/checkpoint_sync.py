"""Checkpoint sync: initialize a beacon node from a trusted provider's
finalized state instead of replaying from genesis.

Reference `cli/src/cmds/beacon/initBeaconState.ts`
(fetchWeakSubjectivityState: download the finalized state from a
trusted beacon API, verify it is within the weak-subjectivity horizon,
anchor the node on it) — the "wss sync" leg of SURVEY §5
checkpoint/resume.

The port of `lodestar_tpu.node.checkpoint_sync`, with its imports rewritten.
"""

from __future__ import annotations

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.ssz.json import from_json
from lodestar_tpu_torch.types import ssz_types

__all__ = ["fetch_checkpoint_state", "CheckpointSyncError"]

# ~54 hours of mainnet epochs; the reference computes the period from
# validator counts (mainnet lands around 256-665 epochs) — a fixed
# conservative value keeps the check dependency-free here
DEFAULT_WSS_EPOCHS = 512


class CheckpointSyncError(Exception):
    pass


def fetch_checkpoint_state(
    client,
    *,
    state_id: str = "finalized",
    p: BeaconPreset | None = None,
    current_slot: int | None = None,
    wss_epochs: int = DEFAULT_WSS_EPOCHS,
    allow_stale: bool = False,
):
    """Download + decode the anchor state from a trusted beacon API.

    `client` is any object with `get_debug_state_v2(state_id) -> dict`
    (the BeaconApiClient, or an in-process impl for tests). The state is
    decoded with its own fork's container and gated by the
    weak-subjectivity horizon. The gate is opt-OUT: callers must supply
    `current_slot` (or explicitly pass allow_stale=True) — silently
    skipping the wss check is exactly the long-range-attack door this
    module exists to close."""
    p = p or active_preset()
    log = get_logger(name="lodestar.checkpoint_sync")
    if current_slot is None and not allow_stale:
        raise CheckpointSyncError(
            "current_slot is required for the weak-subjectivity check "
            "(pass allow_stale=True to explicitly skip it)"
        )
    res = client.get_debug_state_v2(state_id)
    if not isinstance(res, dict) or "data" not in res:
        raise CheckpointSyncError(f"malformed state response: {type(res)}")
    fork = res.get("version", "phase0")
    t = ssz_types(p)
    ns = getattr(t, fork, None)
    if ns is None:
        raise CheckpointSyncError(f"unknown fork version {fork!r}")
    try:
        state = from_json(ns.BeaconState, res["data"])
    except (KeyError, ValueError, TypeError) as e:
        raise CheckpointSyncError(f"cannot decode {fork} state: {e}") from e

    if current_slot is not None:
        age_epochs = (int(current_slot) - int(state.slot)) // p.SLOTS_PER_EPOCH
        if age_epochs > wss_epochs:
            raise CheckpointSyncError(
                f"checkpoint state is {age_epochs} epochs old — beyond the "
                f"weak-subjectivity horizon ({wss_epochs}); refusing to anchor"
            )
        if int(state.slot) > int(current_slot):
            raise CheckpointSyncError("checkpoint state is from the future")

    log.info(
        "checkpoint state fetched",
        {"fork": fork, "slot": int(state.slot), "validators": len(state.validators)},
    )
    return state


def load_anchor_state_from_db(db, p: BeaconPreset | None = None, cfg=None):
    """Restart-from-db: the newest archived finalized state in the data
    directory, fork-decoded, or None for a fresh datadir (reference
    `initBeaconState.ts` db branch — mechanism (3) of SURVEY §5
    checkpoint/resume; the archiver wrote these at finalization)."""
    from lodestar_tpu_torch.db import Bucket, Repository
    from lodestar_tpu_torch.ssz import uint64

    p = p or active_preset()
    repo = Repository(db, Bucket.allForks_stateArchive, uint64)  # keys only
    keys = repo.keys()
    if not keys:
        return None
    slot = int.from_bytes(keys[-1], "big")
    raw = repo.get_binary(slot)
    if raw is None:
        return None
    from lodestar_tpu_torch.chain.archiver import decode_archived_state

    t = ssz_types(p)
    state, fork = decode_archived_state(db, t, raw, slot, cfg=cfg, p=p)
    if state is None:
        raise CheckpointSyncError(f"archived state at slot {slot} matches no known fork")
    get_logger(name="lodestar.checkpoint_sync").info(
        "resuming from archived state", {"slot": slot, "fork": fork}
    )
    return state
