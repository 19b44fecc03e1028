"""MEV-boost builder API client (blinded block flow).

Reference `beacon-node/src/execution/builder/http.ts:30`
(ExecutionBuilderHttp): registerValidator / getHeader /
submitBlindedBlock over the builder REST API, with the spec'd
circuit-breaker — the builder is disabled when more than
`allowed_faults` of the last `fault_inspection_window` slots missed
blocks, re-enabled once the window clears.

Transport is a pluggable callable `transport(method, path, json_body)
-> dict` so tests (and the zero-egress environment) inject fakes; a
urllib transport is provided for real deployments.

The port of `lodestar_tpu.execution.builder`, with its imports rewritten.
"""

from __future__ import annotations

import json as _json
import random
from typing import Callable

from lodestar_tpu_torch.logger import get_logger
from lodestar_tpu_torch.params import BeaconPreset, active_preset
from lodestar_tpu_torch.ssz.json import from_json, to_json
from lodestar_tpu_torch.types import ssz_types

__all__ = ["ExecutionBuilderHttp", "BuilderError", "http_transport"]


class BuilderError(Exception):
    pass


def http_transport(base_url: str, timeout: float = 12.0) -> Callable:
    """urllib JSON transport (reference getClient baseUrl binding)."""
    import urllib.request

    def transport(method: str, path: str, body=None):
        req = urllib.request.Request(
            base_url.rstrip("/") + path,
            method=method,
            data=None if body is None else _json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
            data = resp.read()
            return _json.loads(data) if data else None

    return transport


class ExecutionBuilderHttp:
    """Builder circuit-breaker state machine + the three endpoints
    (reference http.ts: updateStatus/checkStatus/registerValidator/
    getHeader/submitBlindedBlock)."""

    def __init__(
        self,
        transport: Callable,
        p: BeaconPreset | None = None,
        cfg=None,
        *,
        fault_inspection_window: int | None = None,
        allowed_faults: int | None = None,
        rand_fn=random.randint,
    ) -> None:
        self.transport = transport
        self.p = p or active_preset()
        self.cfg = cfg
        self.log = get_logger(name="lodestar.builder")
        self.status = False  # enabled only via update_status (reference :74)
        spe = self.p.SLOTS_PER_EPOCH
        # randomized per boot within the spec'd ranges (reference :55-70)
        window = fault_inspection_window
        if window is None:
            window = spe + rand_fn(0, spe)
        self.fault_inspection_window = max(window, spe)
        cap = self.fault_inspection_window // 2
        self.allowed_faults = min(allowed_faults if allowed_faults is not None else cap, cap)
        self._faults: list[int] = []  # slots with missed builder blocks

    # -- circuit breaker -------------------------------------------------------

    def update_status(self, should_enable: bool) -> None:
        self.status = should_enable

    def check_status(self) -> None:
        """Probe /eth/v1/builder/status; a failure disables the builder
        until the next explicit update_status(True)."""
        try:
            self.transport("GET", "/eth/v1/builder/status")
        except Exception as e:
            if self.status:
                self.log.warn("builder status check failed, disabling", {"error": str(e)})
            self.status = False

    def register_fault(self, slot: int) -> None:
        """A slot whose builder block was missed/failed."""
        self._faults.append(int(slot))
        self._gc_faults(int(slot))

    def _gc_faults(self, current_slot: int) -> None:
        floor = current_slot - self.fault_inspection_window
        self._faults = [s for s in self._faults if s > floor]

    def is_circuit_broken(self, current_slot: int) -> bool:
        self._gc_faults(int(current_slot))
        return len(self._faults) > self.allowed_faults

    # -- endpoints -------------------------------------------------------------

    def register_validator(self, signed_registrations: list) -> None:
        t = ssz_types(self.p)
        body = [
            to_json(t.SignedValidatorRegistrationV1, r) for r in signed_registrations
        ]
        self.transport("POST", "/eth/v1/builder/validators", body)

    def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes, fork: str = "capella"):
        """SignedBuilderBid for (slot, parent, proposer) or None when the
        builder has no bid (204)."""
        path = (
            f"/eth/v1/builder/header/{int(slot)}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}"
        )
        res = self.transport("GET", path)
        if res is None:
            return None
        if "data" not in res:
            raise BuilderError(f"builder header response missing data: {res!r}")
        t = ssz_types(self.p)
        bid_type = getattr(t, fork).SignedBuilderBid
        return from_json(bid_type, res["data"])

    def submit_blinded_block(self, signed_blinded_block, fork: str = "capella"):
        """SignedBlindedBeaconBlock -> the unblinded ExecutionPayload
        (reference submitBlindedBlock)."""
        t = ssz_types(self.p)
        blinded_type = getattr(t, fork).SignedBlindedBeaconBlock
        res = self.transport(
            "POST", "/eth/v1/builder/blinded_blocks", to_json(blinded_type, signed_blinded_block)
        )
        if res is None or "data" not in res:
            raise BuilderError("builder returned no payload for blinded block")
        payload_type = getattr(t, fork).ExecutionPayload
        payload = from_json(payload_type, res["data"])
        # the unblinded payload MUST match the header the proposer signed
        header = signed_blinded_block.message.body.execution_payload_header
        if bytes(payload.block_hash) != bytes(header.block_hash):
            raise BuilderError("unblinded payload block_hash != signed header block_hash")
        return payload
