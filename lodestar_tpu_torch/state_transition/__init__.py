"""Consensus state transition (reference `packages/state-transition/src`).

`state_transition(state, signed_block)` = process_slots to the block's
slot (epoch processing at boundaries) + process_block + state-root check
— the reference's flow at `stateTransition.ts:42,120`. States are typed
SSZ ContainerValues; per-validator hot loops run vectorized in numpy
(see `epoch.py`); the per-slot state root is `htr.state_hash_tree_root`,
whose large merkle levels are CUDA-graph replays on the card when the HTR
mode selects the device (`ssz.device_htr`).

The port of `lodestar_tpu.state_transition`. A device error in the state
root raises: the JAX package's degrade to the value path is not ported.
"""

from __future__ import annotations

from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.types import ssz_types

from .block import (  # noqa: F401
    BlockProcessError,
    get_indexed_attestation,
    is_valid_indexed_attestation,
    process_attestation,
    process_attester_slashing,
    process_block,
    process_block_header,
    process_deposit,
    process_eth1_data,
    process_operations,
    process_proposer_slashing,
    process_randao,
    process_voluntary_exit,
    slash_validator,
)
from .cache import EpochContext, EpochShuffling  # noqa: F401
from .htr import StateRootTracker, drop_tracker, state_hash_tree_root  # noqa: F401
from .epoch import (  # noqa: F401
    EpochProcess,
    before_process_epoch,
    get_attestation_deltas,
    process_epoch,
)
from .shuffle import compute_proposer_index, compute_shuffled_index, unshuffle_list  # noqa: F401
from .util import (  # noqa: F401
    compute_epoch_at_slot,
    compute_signing_root,
    compute_start_slot_at_epoch,
    get_current_epoch,
    get_domain,
    get_previous_epoch,
    get_total_active_balance,
)

__all__ = [
    "state_transition",
    "state_hash_tree_root",
    "drop_tracker",
    "StateRootTracker",
    "process_slots",
    "process_slot",
    "process_block",
    "process_epoch",
    "EpochContext",
    "EpochProcess",
    "BlockProcessError",
    "StateTransitionError",
]


class StateTransitionError(Exception):
    pass


def _state_type(state, p: BeaconPreset):
    # the registry's container name encodes the fork (BeaconStatePhase0...)
    return state.type


def process_slot(state, p: BeaconPreset | None = None) -> None:
    """Spec process_slot: cache state root, backfill latest header state
    root, cache block root."""
    p = p or active_preset()
    t = ssz_types(p)
    # per-slot state root: the dirty-subtree collector when the HTR mode
    # selects the device (one graph replay per large tree level), else the
    # value path; a device error raises (htr.py)
    prev_state_root = state_hash_tree_root(state)
    state.state_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_state_root
    if bytes(state.latest_block_header.state_root) == b"\x00" * 32:
        state.latest_block_header.state_root = prev_state_root
    prev_block_root = t.BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % p.SLOTS_PER_HISTORICAL_ROOT] = prev_block_root


def process_slots(state, slot: int, p: BeaconPreset | None = None, cfg=None):
    """Advance state to `slot`: epoch processing at boundaries (fork-
    dispatched per the state's container fork) and scheduled fork
    upgrades at their activation epochs. Upgrades swap the container
    in place, so every existing reference to `state` observes the new
    fork. Returns the EpochContext for the final slot's epoch."""
    from .block import fork_of

    p = p or active_preset()
    if slot <= state.slot:
        raise StateTransitionError(f"cannot advance to past slot {slot} <= {state.slot}")
    while state.slot < slot:
        process_slot(state, p)
        if (state.slot + 1) % p.SLOTS_PER_EPOCH == 0:
            with tracing.span("epoch_transition") as sp:
                if sp:
                    sp.set(epoch=int(state.slot) // p.SLOTS_PER_EPOCH + 1)
                if fork_of(state) == "phase0":
                    process_epoch(state, EpochContext(state, p), cfg)
                else:
                    from .altair import process_epoch_altair

                    process_epoch_altair(state, EpochContext(state, p), cfg)
        state.slot += 1
        # scheduled upgrades at the first slot of each activation epoch
        if cfg is not None and state.slot % p.SLOTS_PER_EPOCH == 0:
            _maybe_upgrade_fork(state, cfg, p)
    return EpochContext(state, p)


# (prior_fork, activation-epoch config key, upgrade fn import) in order
_UPGRADE_SCHEDULE = (
    ("phase0", "ALTAIR_FORK_EPOCH", "altair", "upgrade_to_altair"),
    ("altair", "BELLATRIX_FORK_EPOCH", "bellatrix", "upgrade_to_bellatrix"),
    ("bellatrix", "CAPELLA_FORK_EPOCH", "capella", "upgrade_to_capella"),
    ("capella", "DENEB_FORK_EPOCH", "deneb", "upgrade_to_deneb"),
)


def _maybe_upgrade_fork(state, cfg, p: BeaconPreset) -> None:
    """Run the scheduled fork upgrade if the state just crossed an
    activation epoch. Upgrades swap the container contents in place so
    every existing reference to `state` observes the new fork (reference
    `stateTransition.ts processSlotsWithTransientCache`)."""
    import importlib

    from .block import fork_of

    epoch = state.slot // p.SLOTS_PER_EPOCH
    for prior, key, module, fn_name in _UPGRADE_SCHEDULE:
        if fork_of(state) == prior and getattr(cfg, key, 2**64 - 1) == epoch:
            mod = importlib.import_module(f".{module}", __package__)
            upgraded = getattr(mod, fn_name)(state, cfg, p)
            state.__dict__.clear()
            object.__setattr__(state, "_type", upgraded.type)
            for name in upgraded.type._field_names:
                setattr(state, name, getattr(upgraded, name))


def state_transition(
    state,
    signed_block,
    p: BeaconPreset | None = None,
    cfg=None,
    *,
    verify_state_root: bool = True,
    verify_proposer_signature: bool = True,
    verify_signatures: bool = True,
):
    """Full STF: returns the post-state (input state is copied first —
    callers keep the pre-state, reference stateTransition.ts:59 clone).
    """
    p = p or active_preset()
    block = signed_block.message
    post = state.copy()
    ctx = process_slots(post, block.slot, p, cfg)

    if verify_proposer_signature:
        from lodestar_tpu_torch.crypto.bls import api as bls
        from lodestar_tpu_torch.params import DOMAIN_BEACON_PROPOSER

        from .block import block_types_for

        proposer = post.validators[block.proposer_index]
        domain = get_domain(post, DOMAIN_BEACON_PROPOSER)
        block_type, _ = block_types_for(post, p)
        root = compute_signing_root(block_type, block, domain)
        if not bls.verify(bytes(proposer.pubkey), root, bytes(signed_block.signature)):
            raise StateTransitionError("invalid block proposer signature")

    process_block(post, block, ctx, verify_signatures, cfg)

    if verify_state_root:
        got = state_hash_tree_root(post)
        if got != bytes(block.state_root):
            raise StateTransitionError(
                f"state root mismatch: block {bytes(block.state_root).hex()[:16]} != computed {got.hex()[:16]}"
            )
    return post
