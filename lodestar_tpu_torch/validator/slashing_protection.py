"""Slashing protection DB: double votes, surround votes (min-max spans),
double proposals, lower bounds, EIP-3076 interchange.

Reference `validator/src/slashingProtection/`:
* attestation checks (`attestation/index.ts:39`): source<=target, double
  vote by target epoch, lower-bound gates, then min-max surround
  (`minMaxSurround/minMaxSurround.ts`, protolambda's scheme: minSpan[e] =
  min(target - e) over atts with source > e; maxSpan[e] = max(target - e)
  over atts with source < e < target; a new (s, t) is surrounding iff
  minSpan[s] < t - s, surrounded iff maxSpan[s] > t - s).
* block checks (`block/index.ts:24`): double proposal by slot + lower
  bound.
* interchange (EIP-3076 v5 complete format, `interchange/`).

Storage is the repo db layer using the reference's bucket ids (20-24).

The port of `lodestar_tpu.validator.slashing_protection`, with its imports rewritten.
"""

from __future__ import annotations

import json

from lodestar_tpu_torch.db import Bucket, DbController, FilterOptions, encode_key

__all__ = [
    "SlashingProtection",
    "SlashingError",
    "SlashingErrorCode",
    "MAX_EPOCH_LOOKBACK",
]

MAX_EPOCH_LOOKBACK = 4096  # minMaxSurround.ts DEFAULT_MAX_EPOCH_LOOKBACK


class SlashingErrorCode:
    SOURCE_EXCEEDS_TARGET = "SOURCE_EXCEEDS_TARGET"
    DOUBLE_VOTE = "DOUBLE_VOTE"
    SURROUNDING_VOTE = "SURROUNDING_VOTE"
    SURROUNDED_VOTE = "SURROUNDED_VOTE"
    DOUBLE_BLOCK_PROPOSAL = "DOUBLE_BLOCK_PROPOSAL"
    BELOW_LOWER_BOUND = "BELOW_LOWER_BOUND"


class SlashingError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code


def _u64(v: int) -> bytes:
    return int(v).to_bytes(8, "big")


class _PerPubkeyMap:
    """bucket[pubkey || key_u64] -> json payload."""

    def __init__(self, db: DbController, bucket: Bucket):
        self.db = db
        self.bucket = bucket

    def get(self, pubkey: bytes, key: int):
        raw = self.db.get(encode_key(self.bucket, pubkey + _u64(key)))
        return None if raw is None else json.loads(raw)

    def put(self, pubkey: bytes, key: int, value) -> None:
        self.db.put(encode_key(self.bucket, pubkey + _u64(key)), json.dumps(value).encode())

    def put_batch(self, pubkey: bytes, items: list[tuple[int, object]]) -> None:
        self.db.batch_put(
            [
                (encode_key(self.bucket, pubkey + _u64(k)), json.dumps(v).encode())
                for k, v in items
            ]
        )

    def entries(self, pubkey: bytes):
        lo = encode_key(self.bucket, pubkey)
        hi = encode_key(self.bucket, pubkey + b"\xff" * 9)
        for k, v in self.db.entries_stream(FilterOptions(gte=lo, lt=hi)):
            yield int.from_bytes(k[-8:], "big"), json.loads(v)


class SlashingProtection:
    def __init__(self, db: DbController, *, max_epoch_lookback: int = MAX_EPOCH_LOOKBACK):
        self._att_by_target = _PerPubkeyMap(db, Bucket.phase0_slashingProtectionAttestationByTarget)
        self._lower_bound = _PerPubkeyMap(db, Bucket.phase0_slashingProtectionAttestationLowerBound)
        self._min_span = _PerPubkeyMap(db, Bucket.index_slashingProtectionMinSpanDistance)
        self._max_span = _PerPubkeyMap(db, Bucket.index_slashingProtectionMaxSpanDistance)
        self._block_by_slot = _PerPubkeyMap(db, Bucket.phase0_slashingProtectionBlockBySlot)
        self.max_epoch_lookback = max_epoch_lookback

    # -- attestations ---------------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        if source_epoch > target_epoch:
            raise SlashingError(SlashingErrorCode.SOURCE_EXCEEDS_TARGET)

        # double vote: same target epoch, different signing root
        existing = self._att_by_target.get(pubkey, target_epoch)
        if existing is not None:
            if bytes.fromhex(existing["signing_root"]) == signing_root and signing_root != b"\x00" * 32:
                return  # SAME_DATA: already recorded
            raise SlashingError(
                SlashingErrorCode.DOUBLE_VOTE, f"target epoch {target_epoch} already attested"
            )

        # interchange lower bound
        lb = self._lower_bound.get(pubkey, 0)
        if lb is not None:
            if source_epoch < lb.get("min_source", 0):
                raise SlashingError(SlashingErrorCode.BELOW_LOWER_BOUND, "source below lower bound")
            if target_epoch <= lb.get("min_target", -1):
                raise SlashingError(SlashingErrorCode.BELOW_LOWER_BOUND, "target below lower bound")

        # min-max surround
        self._assert_not_surrounding(pubkey, source_epoch, target_epoch)
        self._assert_not_surrounded(pubkey, source_epoch, target_epoch)

        # insert: spans then the by-target record
        self._update_min_span(pubkey, source_epoch, target_epoch)
        self._update_max_span(pubkey, source_epoch, target_epoch)
        self._att_by_target.put(
            pubkey,
            target_epoch,
            {"source_epoch": source_epoch, "signing_root": signing_root.hex()},
        )

    def _assert_not_surrounding(self, pubkey: bytes, source: int, target: int) -> None:
        """New att surrounds an existing one: minSpan[source] < target - source."""
        entry = self._min_span.get(pubkey, source)
        distance = target - source
        if entry is not None and 0 < entry < distance:
            raise SlashingError(
                SlashingErrorCode.SURROUNDING_VOTE,
                f"would surround attestation with target {source + entry}",
            )

    def _assert_not_surrounded(self, pubkey: bytes, source: int, target: int) -> None:
        """New att is surrounded: maxSpan[source] > target - source."""
        entry = self._max_span.get(pubkey, source)
        distance = target - source
        if entry is not None and entry > distance:
            raise SlashingError(
                SlashingErrorCode.SURROUNDED_VOTE,
                f"surrounded by attestation with target {source + entry}",
            )

    def _update_min_span(self, pubkey: bytes, source: int, target: int) -> None:
        until = max(0, source - 1 - self.max_epoch_lookback)
        values = []
        for epoch in range(source - 1, until - 1, -1):
            cur = self._min_span.get(pubkey, epoch)
            distance = target - epoch
            if cur is None or distance < cur:
                values.append((epoch, distance))
            else:
                break
        self._min_span.put_batch(pubkey, values)

    def _update_max_span(self, pubkey: bytes, source: int, target: int) -> None:
        values = []
        for epoch in range(source + 1, target):
            cur = self._max_span.get(pubkey, epoch)
            distance = target - epoch
            if cur is None or distance > cur:
                values.append((epoch, distance))
            else:
                break
        self._max_span.put_batch(pubkey, values)

    # -- blocks ---------------------------------------------------------------

    def check_and_insert_block_proposal(self, pubkey: bytes, slot: int, signing_root: bytes) -> None:
        existing = self._block_by_slot.get(pubkey, slot)
        if existing is not None:
            if bytes.fromhex(existing["signing_root"]) == signing_root and signing_root != b"\x00" * 32:
                return
            raise SlashingError(
                SlashingErrorCode.DOUBLE_BLOCK_PROPOSAL, f"slot {slot} already proposed"
            )
        lb = self._lower_bound.get(pubkey, 0)
        if lb is not None and slot <= lb.get("min_block_slot", -1):
            raise SlashingError(SlashingErrorCode.BELOW_LOWER_BOUND, "slot below lower bound")
        self._block_by_slot.put(pubkey, slot, {"signing_root": signing_root.hex()})

    # -- interchange (EIP-3076) ----------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes, pubkeys: list[bytes]) -> dict:
        data = []
        for pk in pubkeys:
            atts = [
                {
                    "source_epoch": str(v["source_epoch"]),
                    "target_epoch": str(t),
                    "signing_root": "0x" + v["signing_root"],
                }
                for t, v in self._att_by_target.entries(pk)
            ]
            blocks = [
                {"slot": str(s), "signing_root": "0x" + v["signing_root"]}
                for s, v in self._block_by_slot.entries(pk)
            ]
            data.append({"pubkey": "0x" + pk.hex(), "signed_blocks": blocks, "signed_attestations": atts})
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, interchange: dict, genesis_validators_root: bytes) -> None:
        meta = interchange["metadata"]
        if bytes.fromhex(meta["genesis_validators_root"][2:]) != genesis_validators_root:
            raise ValueError("interchange genesis_validators_root mismatch")
        if meta["interchange_format_version"] != "5":
            raise ValueError("unsupported interchange version")
        for entry in interchange["data"]:
            pk = bytes.fromhex(entry["pubkey"][2:])
            max_target = -1
            max_source = 0
            max_slot = -1
            for att in entry.get("signed_attestations", []):
                s, t = int(att["source_epoch"]), int(att["target_epoch"])
                root = bytes.fromhex(att.get("signing_root", "0x" + "00" * 32)[2:])
                try:
                    self.check_and_insert_attestation(pk, s, t, root)
                except SlashingError:
                    pass  # keep the safest record; duplicates are fine
                max_target = max(max_target, t)
                max_source = max(max_source, s)
            for blk in entry.get("signed_blocks", []):
                slot = int(blk["slot"])
                root = bytes.fromhex(blk.get("signing_root", "0x" + "00" * 32)[2:])
                try:
                    self.check_and_insert_block_proposal(pk, slot, root)
                except SlashingError:
                    pass
                max_slot = max(max_slot, slot)
            # raise lower bounds so anything at or below imported history
            # is refused even if individual records were skipped
            lb = self._lower_bound.get(pk, 0) or {}
            self._lower_bound.put(
                pk,
                0,
                {
                    "min_source": max(lb.get("min_source", 0), max_source),
                    "min_target": max(lb.get("min_target", -1), max_target),
                    "min_block_slot": max(lb.get("min_block_slot", -1), max_slot),
                },
            )
