"""Bellatrix (merge) state transition: execution payloads.

Reference: `packages/state-transition/src/block/processExecutionPayload.ts`,
`src/util/execution.ts`, `src/slot/upgradeStateToBellatrix.ts`. The
payload itself is opaque to the consensus layer — validity is delegated
to the execution engine (`externalData.executionPayloadStatus` in the
reference); here the caller passes `payload_status` ("valid" unless an
engine said otherwise) so the STF stays synchronous.

The port of `lodestar_tpu.state_transition.bellatrix` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.params import BeaconPreset
from lodestar_tpu_torch.types import ssz_types

from .block import BlockProcessError, fork_of
from .util import get_current_epoch, get_randao_mix

__all__ = [
    "is_merge_transition_complete",
    "is_merge_transition_block",
    "is_execution_enabled",
    "compute_timestamp_at_slot",
    "execution_payload_to_header",
    "process_execution_payload",
    "upgrade_to_bellatrix",
]

_EXEC_FORKS = ("bellatrix", "capella", "deneb")


def _header_type(state, p: BeaconPreset):
    return getattr(ssz_types(p), fork_of(state)).ExecutionPayloadHeader


def _payload_type(state, p: BeaconPreset):
    return getattr(ssz_types(p), fork_of(state)).ExecutionPayload


_DEFAULT_ROOT_CACHE: dict[int, bytes] = {}


def _default_root(ssz_type) -> bytes:
    """Root of a type's default value — a per-type constant, cached
    because the merge checks run several times per block."""
    key = id(ssz_type)
    root = _DEFAULT_ROOT_CACHE.get(key)
    if root is None:
        root = _DEFAULT_ROOT_CACHE[key] = ssz_type.hash_tree_root(ssz_type.default())
    return root


def is_merge_transition_complete(state, p: BeaconPreset) -> bool:
    """latest_execution_payload_header != default (spec; reference
    `util/execution.ts isMergeTransitionComplete`)."""
    ht = _header_type(state, p)
    return ht.hash_tree_root(state.latest_execution_payload_header) != _default_root(ht)


def _payload_is_default(payload, payload_type) -> bool:
    return payload_type.hash_tree_root(payload) == _default_root(payload_type)


def is_merge_transition_block(state, body, p: BeaconPreset) -> bool:
    if is_merge_transition_complete(state, p):
        return False
    if hasattr(body, "execution_payload_header"):  # blinded body
        ht = _header_type(state, p)
        return not _payload_is_default(body.execution_payload_header, ht)
    pt = _payload_type(state, p)
    return not _payload_is_default(body.execution_payload, pt)


def is_execution_enabled(state, body, p: BeaconPreset) -> bool:
    if fork_of(state) not in _EXEC_FORKS:
        return False
    return is_merge_transition_block(state, body, p) or is_merge_transition_complete(state, p)


def compute_timestamp_at_slot(state, slot: int, cfg=None) -> int:
    seconds = getattr(cfg, "SECONDS_PER_SLOT", 12) if cfg is not None else 12
    return int(state.genesis_time) + slot * seconds


def execution_payload_to_header(payload, fork: str, p: BeaconPreset):
    """Full payload -> header: transactions/withdrawals become roots
    (reference `executionPayloadToPayloadHeader`, processExecutionPayload.ts:74)."""
    from lodestar_tpu_torch import ssz

    t = ssz_types(p)
    ns = getattr(t, fork)
    header = ns.ExecutionPayloadHeader.default()
    for fname, _ in ns.ExecutionPayloadHeader.fields:
        if fname == "transactions_root":
            tx_list = ssz.List(
                ssz.ByteList(p.MAX_BYTES_PER_TRANSACTION), p.MAX_TRANSACTIONS_PER_PAYLOAD
            )
            header.transactions_root = tx_list.hash_tree_root(list(payload.transactions))
        elif fname == "withdrawals_root":
            wd_list = ssz.List(t.Withdrawal, p.MAX_WITHDRAWALS_PER_PAYLOAD)
            header.withdrawals_root = wd_list.hash_tree_root(list(payload.withdrawals))
        else:
            setattr(header, fname, getattr(payload, fname))
    return header


def process_execution_payload(
    state, payload, ctx, cfg=None, payload_status: str = "valid"
) -> None:
    """Spec process_execution_payload. `payload` may be a full payload or
    a header (blinded block); detection follows the reference's
    isCapellaPayloadHeader shape check (`transactions_root` attr)."""
    p = ctx.p
    blinded = hasattr(payload, "transactions_root")

    if is_merge_transition_complete(state, p):
        if bytes(payload.parent_hash) != bytes(state.latest_execution_payload_header.block_hash):
            raise BlockProcessError(
                "execution payload parent_hash does not match latest block_hash"
            )

    expected_random = get_randao_mix(state, get_current_epoch(state), p)
    if bytes(payload.prev_randao) != expected_random:
        raise BlockProcessError("execution payload prev_randao mismatch")

    if int(payload.timestamp) != compute_timestamp_at_slot(state, int(state.slot), cfg):
        raise BlockProcessError("execution payload timestamp mismatch")

    if not blinded:
        if payload_status == "pre_merge":
            raise BlockProcessError("execution payload status pre_merge")
        if payload_status == "invalid":
            raise BlockProcessError("invalid execution payload")

    fork = fork_of(state)
    header = payload if blinded else execution_payload_to_header(payload, fork, p)
    state.latest_execution_payload_header = header


# --- fork upgrade -------------------------------------------------------------


def carry_state_upgrade(
    pre,
    cfg,
    p: BeaconPreset,
    *,
    src_fork: str,
    dst_fork: str,
    fallback_version: bytes,
    skip: tuple[str, ...] = (),
    carry_header: bool = False,
):
    """Shared spec-upgrade shape: copy the source fork's state fields,
    rotate Fork versions, and (optionally) re-type the execution payload
    header field-by-field, leaving new header fields at default. Each
    per-fork upgrade_to_* wraps this (reference `slot/upgradeStateTo*.ts`
    all follow this same carry-over pattern)."""
    t = ssz_types(p)
    post = getattr(t, dst_fork).BeaconState.default()
    all_skip = set(skip) | ({"latest_execution_payload_header"} if carry_header else set())
    for fname, _ in getattr(t, src_fork).BeaconState.fields:
        if fname in all_skip:
            continue
        setattr(post, fname, getattr(pre, fname))
    fork = t.Fork.default()
    fork.previous_version = bytes(pre.fork.current_version)
    fork.current_version = (
        getattr(cfg, f"{dst_fork.upper()}_FORK_VERSION") if cfg else fallback_version
    )
    fork.epoch = get_current_epoch(pre)
    post.fork = fork
    if carry_header:
        header = getattr(t, dst_fork).ExecutionPayloadHeader.default()
        for fname, _ in getattr(t, src_fork).ExecutionPayloadHeader.fields:
            setattr(header, fname, getattr(pre.latest_execution_payload_header, fname))
        post.latest_execution_payload_header = header
    return post


def upgrade_to_bellatrix(pre, cfg, p: BeaconPreset):
    """Spec upgrade_to_bellatrix: altair fields carry over; the execution
    header starts at its default (reference
    `slot/upgradeStateToBellatrix.ts`)."""
    t = ssz_types(p)
    post = carry_state_upgrade(
        pre, cfg, p, src_fork="altair", dst_fork="bellatrix", fallback_version=b"\x02\x00\x00\x00"
    )
    post.latest_execution_payload_header = t.bellatrix.ExecutionPayloadHeader.default()
    return post
