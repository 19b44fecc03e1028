"""Engine API seam: HTTP client + in-memory mock EL.

Reference `execution/engine/http.ts:83` (engine_newPayloadV1/
forkchoiceUpdatedV1/getPayloadV1 over JSON-RPC with JWT) and `mock.ts`
(the in-memory EL used by the `dev` command and sim tests).

The port of `lodestar_tpu.execution.engine`, with its imports rewritten.
"""

from __future__ import annotations

import base64
import enum
import hashlib
import hmac
import json
import os
import time
import urllib.request
from dataclasses import dataclass, field

__all__ = [
    "ExecutePayloadStatus",
    "PayloadAttributes",
    "IExecutionEngine",
    "ExecutionEngineMock",
    "ExecutionEngineHttp",
]


class ExecutePayloadStatus(enum.Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"
    INVALID_BLOCK_HASH = "INVALID_BLOCK_HASH"
    ELERROR = "ELERROR"
    UNAVAILABLE = "UNAVAILABLE"


@dataclass
class PayloadAttributes:
    timestamp: int
    prev_randao: bytes
    suggested_fee_recipient: bytes


class IExecutionEngine:
    async def notify_new_payload(self, payload) -> tuple[ExecutePayloadStatus, bytes | None]:
        """-> (status, latest_valid_hash)."""
        raise NotImplementedError

    async def notify_forkchoice_update(
        self, head_block_hash: bytes, safe_block_hash: bytes, finalized_block_hash: bytes,
        payload_attributes: PayloadAttributes | None = None,
    ) -> str | None:
        """-> payload_id when attributes were supplied."""
        raise NotImplementedError

    async def get_payload(self, payload_id: str):
        raise NotImplementedError


@dataclass
class _MockBlock:
    block_hash: bytes
    parent_hash: bytes
    block_number: int
    timestamp: int
    prev_randao: bytes


class ExecutionEngineMock(IExecutionEngine):
    """In-memory EL: tracks a hash-linked payload chain, builds payloads
    on request (reference `mock.ts`); scriptable validity for fault
    injection (the invalid-payload test path)."""

    def __init__(self, genesis_block_hash: bytes = b"\x00" * 32):
        self.head_hash = genesis_block_hash
        self.blocks: dict[bytes, _MockBlock] = {
            genesis_block_hash: _MockBlock(genesis_block_hash, b"\x00" * 32, 0, 0, b"\x00" * 32)
        }
        self.invalid_hashes: set[bytes] = set()  # scripted INVALID responses
        self._payloads: dict[str, _MockBlock] = {}
        self._payload_seq = 0

    async def notify_new_payload(self, payload):
        block_hash = bytes(payload.block_hash)
        parent_hash = bytes(payload.parent_hash)
        if block_hash in self.invalid_hashes:
            parent = self.blocks.get(parent_hash)
            lvh = parent.block_hash if parent else None
            return ExecutePayloadStatus.INVALID, lvh
        if parent_hash not in self.blocks:
            return ExecutePayloadStatus.SYNCING, None
        self.blocks[block_hash] = _MockBlock(
            block_hash, parent_hash, payload.block_number, payload.timestamp,
            bytes(payload.prev_randao),
        )
        return ExecutePayloadStatus.VALID, block_hash

    async def notify_forkchoice_update(
        self, head_block_hash, safe_block_hash, finalized_block_hash, payload_attributes=None
    ):
        if bytes(head_block_hash) not in self.blocks:
            return None
        self.head_hash = bytes(head_block_hash)
        if payload_attributes is None:
            return None
        self._payload_seq += 1
        pid = f"0x{self._payload_seq:016x}"
        parent = self.blocks[self.head_hash]
        body = parent.block_hash + payload_attributes.prev_randao + payload_attributes.timestamp.to_bytes(8, "little")
        self._payloads[pid] = _MockBlock(
            hashlib.sha256(body).digest(),
            parent.block_hash,
            parent.block_number + 1,
            payload_attributes.timestamp,
            payload_attributes.prev_randao,
        )
        return pid

    async def get_payload(self, payload_id: str):
        blk = self._payloads.get(payload_id)
        if blk is None:
            raise ValueError(f"unknown payload id {payload_id}")
        return blk


class ExecutionEngineHttp(IExecutionEngine):
    """Engine API over JSON-RPC with JWT bearer auth (http.ts:83).
    Offline-testable: the transport is one overridable `_post` method."""

    def __init__(self, url: str, jwt_secret: bytes, timeout_sec: float = 5.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout_sec
        self._id = 0

    # -- jwt ------------------------------------------------------------------

    def _jwt_token(self) -> str:
        header = base64.urlsafe_b64encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode()).rstrip(b"=")
        claims = base64.urlsafe_b64encode(json.dumps({"iat": int(time.time())}).encode()).rstrip(b"=")
        signing_input = header + b"." + claims
        sig = hmac.new(self.jwt_secret, signing_input, hashlib.sha256).digest()
        return (signing_input + b"." + base64.urlsafe_b64encode(sig).rstrip(b"=")).decode()

    def _post(self, body: dict) -> dict:
        req = urllib.request.Request(
            self.url,
            data=json.dumps(body).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self._jwt_token()}",
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _rpc_sync(self, method: str, params: list) -> dict:
        self._id += 1
        out = self._post({"jsonrpc": "2.0", "id": self._id, "method": method, "params": params})
        if "error" in out:
            raise RuntimeError(f"{method}: {out['error']}")
        return out["result"]

    async def _rpc(self, method: str, params: list) -> dict:
        """Blocking urllib transport stays off the event loop — a slow EL
        must only stall the awaiting caller, not the whole node."""
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self._rpc_sync, method, params
        )

    # -- engine api -----------------------------------------------------------

    async def notify_new_payload(self, payload):
        from lodestar_tpu_torch.ssz.json import to_json
        from lodestar_tpu_torch.types import ssz_types

        t = ssz_types()
        result = await self._rpc("engine_newPayloadV1", [to_json(t.bellatrix.ExecutionPayload, payload)])
        status = ExecutePayloadStatus(result["status"])
        lvh = result.get("latestValidHash")
        return status, bytes.fromhex(lvh[2:]) if lvh else None

    async def notify_forkchoice_update(
        self, head_block_hash, safe_block_hash, finalized_block_hash, payload_attributes=None
    ):
        state = {
            "headBlockHash": "0x" + bytes(head_block_hash).hex(),
            "safeBlockHash": "0x" + bytes(safe_block_hash).hex(),
            "finalizedBlockHash": "0x" + bytes(finalized_block_hash).hex(),
        }
        attrs = None
        if payload_attributes is not None:
            attrs = {
                "timestamp": hex(payload_attributes.timestamp),
                "prevRandao": "0x" + payload_attributes.prev_randao.hex(),
                "suggestedFeeRecipient": "0x" + payload_attributes.suggested_fee_recipient.hex(),
            }
        result = await self._rpc("engine_forkchoiceUpdatedV1", [state, attrs])
        return (result.get("payloadId")) if result else None

    async def get_payload(self, payload_id: str):
        return await self._rpc("engine_getPayloadV1", [payload_id])
