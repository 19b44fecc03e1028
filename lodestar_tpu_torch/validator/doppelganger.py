"""Doppelganger protection: refuse to sign until freshly-added keys
have observed quiet epochs on the network.

Reference `validator/src/services/doppelgangerService.ts`: each
registered pubkey must watch DEFAULT_REMAINING_DETECTION_EPOCHS (2)
full epochs of liveness data; ANY observed activity for its validator
index means another instance is running the same key — signing is
blocked permanently (the reference shuts the process down). Liveness
comes from the beacon API's POST /eth/v1/validator/liveness/{epoch}.

The port of `lodestar_tpu.validator.doppelganger`, with its imports rewritten.
"""

from __future__ import annotations

import enum

from lodestar_tpu_torch.logger import get_logger

__all__ = ["DoppelgangerService", "DoppelgangerStatus", "DoppelgangerDetected"]

DEFAULT_REMAINING_DETECTION_EPOCHS = 2


class DoppelgangerStatus(enum.Enum):
    VERIFIED_SAFE = "VerifiedSafe"
    UNVERIFIED = "Unverified"
    UNKNOWN = "Unknown"
    DETECTED = "Detected"


class DoppelgangerDetected(Exception):
    pass


class DoppelgangerService:
    def __init__(self, detection_epochs: int = DEFAULT_REMAINING_DETECTION_EPOCHS):
        self.detection_epochs = detection_epochs
        self.log = get_logger(name="lodestar.doppelganger")
        # pubkey -> remaining epochs to observe (0 = verified safe, -1 = detected)
        self._remaining: dict[bytes, int] = {}
        self._registered_epoch: dict[bytes, int] = {}
        self._last_processed: dict[bytes, int] = {}

    def register_validator(self, pubkey: bytes, current_epoch: int) -> None:
        pubkey = bytes(pubkey)
        if pubkey in self._remaining:
            return
        # genesis-epoch registrations skip detection (reference: nothing
        # could have signed before the chain started)
        remaining = 0 if current_epoch == 0 else self.detection_epochs
        self._remaining[pubkey] = remaining
        self._registered_epoch[pubkey] = current_epoch

    def status(self, pubkey: bytes) -> DoppelgangerStatus:
        remaining = self._remaining.get(bytes(pubkey))
        if remaining is None:
            return DoppelgangerStatus.UNKNOWN
        if remaining < 0:
            return DoppelgangerStatus.DETECTED
        if remaining == 0:
            return DoppelgangerStatus.VERIFIED_SAFE
        return DoppelgangerStatus.UNVERIFIED

    def is_safe(self, pubkey: bytes) -> bool:
        """Unknown (never registered) keys are treated as safe — the
        service only gates keys explicitly enrolled for detection
        (reference getStatus default)."""
        return self.status(pubkey) in (
            DoppelgangerStatus.VERIFIED_SAFE,
            DoppelgangerStatus.UNKNOWN,
        )

    @property
    def detected(self) -> list[bytes]:
        return [pk for pk, r in self._remaining.items() if r < 0]

    def on_epoch_liveness(
        self, epoch: int, liveness_by_pubkey: dict[bytes, bool]
    ) -> list[bytes]:
        """Process one epoch of liveness data for the watched keys.
        Returns newly-detected pubkeys (and marks them blocked). A key
        only burns down its counter for epochs AFTER its registration
        (its own pre-registration activity is not a doppelganger)."""
        newly_detected = []
        for pubkey, live in liveness_by_pubkey.items():
            pubkey = bytes(pubkey)
            remaining = self._remaining.get(pubkey)
            if remaining is None or remaining <= 0:
                continue
            if epoch <= self._registered_epoch[pubkey]:
                continue
            if epoch <= self._last_processed.get(pubkey, -1):
                continue  # an epoch counts once; retries must not burn the window
            self._last_processed[pubkey] = epoch
            if live:
                self._remaining[pubkey] = -1
                newly_detected.append(pubkey)
                self.log.error(
                    "DOPPELGANGER DETECTED — blocking key",
                    {"pubkey": "0x" + pubkey.hex()[:16], "epoch": epoch},
                )
            else:
                self._remaining[pubkey] = remaining - 1
                if self._remaining[pubkey] == 0:
                    self.log.info(
                        "doppelganger detection complete, key is safe",
                        {"pubkey": "0x" + pubkey.hex()[:16]},
                    )
        return newly_detected
