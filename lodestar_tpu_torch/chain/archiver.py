"""Archiver: migrate finalized data hot -> cold on finalization.

Reference `beacon-node/src/chain/archiver/index.ts:40` (Archiver),
`archiveBlocks.ts` (canonical blocks hot->blockArchive keyed by slot +
root/parent-root indexes; non-canonical hot blocks deleted) and
`archiveStates.ts` (StatesArchiver.maybeArchiveState — persist one
finalized state per `archive_state_epoch_frequency` window, prune
intermediate stored states within the window).

The port of `lodestar_tpu.chain.archiver` (host Python and numpy, as there).
"""

from __future__ import annotations

from lodestar_tpu_torch.db import Bucket, DbController, Repository, encode_key
from lodestar_tpu_torch.logger import get_logger

__all__ = ["Archiver", "StatesArchiver"]

# reference cli default `chain.archiveStateEpochFrequency` (1024 epochs)
DEFAULT_ARCHIVE_STATE_EPOCH_FREQUENCY = 1024
# spec MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS: sidecars older than this
# are prunable (reference archiveBlocks.ts blob expiry)
MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS = 4096


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:])


def decode_archived_state(db: DbController, types, raw: bytes, slot: int, *, cfg=None, p=None):
    """Decode a slot-keyed archived state: the archiver's recorded fork
    name is authoritative, then the state's own fork version bytes
    (every BeaconState starts genesis_time u64 | gvr 32 | slot 8 |
    fork{prev4 current4 ...}), then the config schedule. Shared by the
    in-process cold reads and the restart-from-db loader so the record
    format lives in ONE place."""
    candidates: list[str] = []
    recorded = db.get(encode_key(Bucket.index_chainInfo, f"state_fork_{slot:020d}"))
    if recorded:
        candidates.append(recorded.decode())
    current_version = bytes(raw[52:56]) if len(raw) >= 56 else b""
    if cfg is not None:
        from lodestar_tpu_torch.config import FORK_ORDER, fork_name_at_epoch

        for name in reversed(FORK_ORDER):
            if cfg.fork_version(name) == current_version:
                candidates.append(name)
                break
        if p is not None:
            candidates.append(fork_name_at_epoch(cfg, slot // p.SLOTS_PER_EPOCH))
    elif current_version and current_version[0] < 5:
        from lodestar_tpu_torch.config import FORK_ORDER

        candidates.append(FORK_ORDER[current_version[0]])
    # blind probe last (capella/deneb share a layout — only reached when
    # nothing above matched)
    candidates += ["deneb", "capella", "bellatrix", "altair", "phase0"]
    for name in dict.fromkeys(candidates):
        ns = getattr(types, name, None)
        if ns is None:
            continue
        try:
            return ns.BeaconState.deserialize(raw), name
        except (ValueError, KeyError):
            continue
    return None, None


class StatesArchiver:
    """Persist finalized states on the epoch-frequency cadence
    (reference archiveStates.ts:27)."""

    def __init__(
        self,
        chain,
        db: DbController,
        frequency: int = DEFAULT_ARCHIVE_STATE_EPOCH_FREQUENCY,
    ) -> None:
        self.chain = chain
        self.db = db
        self.frequency = frequency
        self._last_stored_epoch = -1

    def maybe_archive_state(self, finalized_cp) -> None:
        """Archive the finalized state if we crossed a frequency window
        (or every finalization when frequency == 0, useful in tests)."""
        epoch = int(finalized_cp.epoch)
        if self.frequency > 0:
            last_window = self._last_stored_epoch // self.frequency
            if self._last_stored_epoch >= 0 and epoch // self.frequency <= last_window:
                return
        self.archive_state(finalized_cp)

    def archive_state(self, finalized_cp) -> None:
        root = bytes(finalized_cp.root)
        state = self.chain.state_cache.get(root)
        if state is None:
            return
        from lodestar_tpu_torch.state_transition.block import fork_of

        slot = int(state.slot)
        # serialize with the state's own (fork-versioned) type, not the
        # repository's anchor type; record the fork name so restart can
        # decode WITHOUT guessing from the config (a state's actual fork
        # can lag the schedule, e.g. genesis-epoch activations)
        self.chain.states_db.put_binary(slot, state.type.serialize(state))
        self.db.put(
            encode_key(Bucket.index_chainInfo, f"state_fork_{slot:020d}"),
            fork_of(state).encode(),
        )
        state_root = state.type.hash_tree_root(state)
        self.db.put(
            encode_key(Bucket.index_stateArchiveRootIndex, state_root),
            slot.to_bytes(8, "big"),
        )
        self._last_stored_epoch = int(finalized_cp.epoch)


class Archiver:
    """Subscribes to the chain's finalization and moves finalized data
    to the archive buckets (reference archiver/index.ts:40)."""

    def __init__(
        self,
        chain,
        db: DbController,
        archive_state_epoch_frequency: int = DEFAULT_ARCHIVE_STATE_EPOCH_FREQUENCY,
    ) -> None:
        self.chain = chain
        self.db = db
        self.log = get_logger(name="lodestar.archiver")
        self.states_archiver = StatesArchiver(chain, db, archive_state_epoch_frequency)
        t = chain.types
        self.block_archive = Repository(db, Bucket.allForks_blockArchive, t.phase0.SignedBeaconBlock)

    def on_finalized(self, finalized_cp) -> None:
        """archiveBlocks + maybeArchiveState + cache pruning. Runs
        BEFORE fork-choice prune so the dead-fork nodes are still
        enumerable (the reference keeps them until archiving completes,
        archiver/index.ts processFinalizedCheckpoint)."""
        self.archive_blocks(finalized_cp)
        self.states_archiver.maybe_archive_state(finalized_cp)

    def archive_blocks(self, finalized_cp) -> None:
        chain = self.chain
        root_hex = _hex(bytes(finalized_cp.root))
        canonical = chain.fork_choice.get_all_ancestor_blocks(root_hex)
        non_canonical = chain.fork_choice.get_all_non_ancestor_blocks(root_hex)
        finalized_slot = int(finalized_cp.epoch) * chain.p.SLOTS_PER_EPOCH

        # hot -> cold: cold key is the slot; root + parent-root indexes
        # let by-root lookups fall through to the archive
        migrated = 0
        for node in canonical:
            block_root = _unhex(node.block_root)
            raw = chain.blocks_db.get_binary(block_root)
            if raw is None:
                continue
            self.block_archive.put_binary(node.slot, raw)
            self.db.put(
                encode_key(Bucket.index_blockArchiveRootIndex, block_root),
                int(node.slot).to_bytes(8, "big"),
            )
            self.db.put(
                encode_key(Bucket.index_blockArchiveParentRootIndex, _unhex(node.parent_root)),
                int(node.slot).to_bytes(8, "big"),
            )
            chain.blocks_db.delete(block_root)
            migrated += 1

        # dead forks at or below the finalized slot leave the hot db,
        # their sidecars with them
        dropped = 0
        for node in non_canonical:
            if node.slot <= finalized_slot:
                chain.blocks_db.delete(_unhex(node.block_root))
                chain.blobs_db.delete(_unhex(node.block_root))
                dropped += 1

        # blob retention window (spec MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS)
        floor_slot = (
            int(finalized_cp.epoch) - MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS
        ) * chain.p.SLOTS_PER_EPOCH
        if floor_slot > 0:
            for key, sidecar in list(chain.blobs_db.entries()):
                if int(sidecar.beacon_block_slot) < floor_slot:
                    chain.blobs_db.delete(bytes(key))

        if migrated or dropped:
            self.log.debug(
                "archived blocks",
                {"migrated": migrated, "dropped": dropped, "epoch": finalized_cp.epoch},
            )

    # -- cold lookups ----------------------------------------------------------

    def get_archived_state_by_slot(self, slot: int):
        """Deserialize a slot-keyed archived state with its
        fork-versioned type (the repository's pinned type is only the
        anchor fork)."""
        raw = self.chain.states_db.get_binary(int(slot))
        if raw is None:
            return None
        return self._decode_state(int(slot), raw)

    def get_archived_state_by_root(self, state_root: bytes):
        raw = self.db.get(encode_key(Bucket.index_stateArchiveRootIndex, bytes(state_root)))
        if raw is None:
            return None
        return self.get_archived_state_by_slot(int.from_bytes(raw, "big"))

    def get_archived_state_at_or_before(self, slot: int):
        """Newest archived state with state.slot <= slot (checkpoint-sync
        style lookup, reference stateArchive.lastValue semantics)."""
        keys = self.chain.states_db.keys(lt=int(slot) + 1)
        if not keys:
            return None
        found_slot = int.from_bytes(keys[-1], "big")
        raw = self.chain.states_db.get_binary(found_slot)
        return None if raw is None else self._decode_state(found_slot, raw)

    def _decode_state(self, slot: int, raw: bytes):
        chain = self.chain
        state, _fork = decode_archived_state(
            self.db, chain.types, raw, slot, cfg=chain.cfg, p=chain.p
        )
        return state

    def get_archived_block_by_slot(self, slot: int):
        raw = self.block_archive.get_binary(int(slot))
        if raw is None:
            return None
        chain = self.chain
        _, signed_type = chain.block_type_at_slot(int(slot))
        return signed_type.deserialize(raw)

    def get_archived_block_by_root(self, block_root: bytes):
        raw = self.db.get(encode_key(Bucket.index_blockArchiveRootIndex, bytes(block_root)))
        if raw is None:
            return None
        return self.get_archived_block_by_slot(int.from_bytes(raw, "big"))
