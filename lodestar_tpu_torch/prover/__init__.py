"""Prover: a verified web3 provider over light-client-tracked payloads.

Reference `packages/prover/src` (`web3_provider.ts:32`
createVerifiedExecutionProvider, `proof_provider/payload_store.ts`,
`verified_requests/*`, `utils/validation.ts`): untrusted EL JSON-RPC
responses are verified against execution payloads whose roots the light
client proved — account/storage reads through Merkle-Patricia proofs
(eth_getProof) against the payload's stateRoot, code through its
codeHash, blocks field-by-field against the payload itself.

Decoupling: the consensus side pushes payloads via
`ProofProvider.on_payload(payload, finalized=...)` (the reference wires
this to Lightclient events); the execution side is any
`handler(method, params) -> result` callable. eth_call/eth_estimateGas
need a local EVM (the reference embeds @ethereumjs/vm) — out of scope
here; those return an explicit unverifiable error rather than silently
passing through.

The port of `lodestar_tpu.prover` (host Python, as there), on the port's
copy of `mpt` (keccak-256, RLP and Merkle-Patricia proof verification),
which discv5 also uses for ENRs.
"""

from __future__ import annotations

from typing import Callable

from lodestar_tpu_torch.logger import get_logger

from .mpt import MptError, keccak256, rlp_encode, verify_mpt_proof

__all__ = [
    "PayloadStore",
    "ProofProvider",
    "VerifiedExecutionProvider",
    "VerificationError",
    "verify_account_proof",
    "verify_storage_proof",
    "verify_code",
    "verify_block_response",
]

MAX_PAYLOAD_HISTORY = 32

# keccak256(b"") and keccak256(rlp(b"")) — empty account sentinels
EMPTY_CODE_HASH = bytes.fromhex("c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
EMPTY_TRIE_ROOT = bytes.fromhex("56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")


class VerificationError(Exception):
    pass


def _hx(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _unhex(s: str | bytes) -> bytes:
    if isinstance(s, bytes):
        return s
    s = s[2:] if s.startswith("0x") else s
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def _to_int(v) -> int:
    if isinstance(v, int):
        return v
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    raise VerificationError(f"cannot interpret {v!r} as an integer")


def _int_be(v) -> bytes:
    """Quantity -> minimal big-endian bytes (RLP canonical form)."""
    n = _to_int(v)
    return b"" if n == 0 else n.to_bytes((n.bit_length() + 7) // 8, "big")


# --- payload store ------------------------------------------------------------


class PayloadStore:
    """Execution payloads keyed by EL block hash, with a finalized
    block-number index (reference payload_store.ts). Only payloads the
    caller verified (light-client-proven) may be stored."""

    def __init__(self, max_history: int = MAX_PAYLOAD_HISTORY):
        self.max_history = max_history
        self._payloads: dict[bytes, object] = {}  # el block hash -> payload
        self._finalized_by_number: dict[int, bytes] = {}
        self._latest_hash: bytes | None = None

    @property
    def latest(self):
        return self._payloads.get(self._latest_hash) if self._latest_hash else None

    @property
    def finalized(self):
        if not self._finalized_by_number:
            return None
        return self._payloads.get(self._finalized_by_number[max(self._finalized_by_number)])

    def set(self, payload, finalized: bool) -> None:
        block_hash = bytes(payload.block_hash)
        self._payloads[block_hash] = payload
        cur = self.latest
        if cur is None or int(cur.block_number) < int(payload.block_number):
            self._latest_hash = block_hash
        if finalized:
            self._finalized_by_number[int(payload.block_number)] = block_hash
        self._prune()

    def get(self, block_id):
        """By EL block hash (bytes / 0x-hex), block number, or the tags
        latest/finalized. Numeric lookups resolve through the finalized
        index or the canonical parent-hash chain from `latest` — never
        by scanning the payload map, which may still hold reorged-out
        payloads at the same height."""
        if block_id in (None, "latest", "pending"):
            return self.latest
        if block_id in ("finalized", "safe"):
            return self.finalized
        if block_id == "earliest":
            return None  # genesis is outside the tracked history
        if isinstance(block_id, bytes):
            return self._payloads.get(block_id)
        if isinstance(block_id, str) and block_id.startswith("0x") and len(block_id) == 66:
            return self._payloads.get(_unhex(block_id))
        try:
            number = _to_int(block_id)
        except (VerificationError, ValueError):
            return None
        by_num = self._finalized_by_number.get(number)
        if by_num is not None:
            return self._payloads.get(by_num)
        payload = self.latest
        while payload is not None and int(payload.block_number) > number:
            payload = self._payloads.get(bytes(payload.parent_hash))
        if payload is not None and int(payload.block_number) == number:
            return payload
        return None

    def _prune(self) -> None:
        if len(self._finalized_by_number) > self.max_history:
            keep = sorted(self._finalized_by_number)[-self.max_history :]
            dropped = [n for n in self._finalized_by_number if n not in set(keep)]
            for n in dropped:
                self._payloads.pop(self._finalized_by_number.pop(n), None)
        # unfinalized payloads are bounded too: anything older than the
        # latest head by max_history and not in the finalized index goes
        latest = self.latest
        if latest is None:
            return
        floor = int(latest.block_number) - self.max_history
        finalized_hashes = set(self._finalized_by_number.values())
        for h in [
            h
            for h, pl in self._payloads.items()
            if int(pl.block_number) < floor and h not in finalized_hashes
        ]:
            del self._payloads[h]


class ProofProvider:
    """The consensus-side anchor: holds light-client-proven payloads and
    answers get_execution_payload for the verified request handlers
    (reference proof_provider.ts)."""

    def __init__(self):
        self.store = PayloadStore()
        self.log = get_logger(name="lodestar.prover")

    def on_payload(self, payload, finalized: bool = False) -> None:
        self.store.set(payload, finalized)

    def get_execution_payload(self, block_id="latest"):
        payload = self.store.get(block_id)
        if payload is None:
            raise VerificationError(f"no verified payload for block {block_id!r}")
        return payload


# --- proof checks -------------------------------------------------------------


def verify_account_proof(state_root: bytes, address: bytes | str, proof: dict) -> bool:
    """eth_getProof account verification (reference isValidAccount,
    validation.ts:25): walk accountProof from the payload stateRoot at
    keccak256(address); the proven RLP must equal the claimed account
    tuple, or be a proven exclusion matching the empty account."""
    address = _unhex(address)
    key = keccak256(address)
    try:
        proven = verify_mpt_proof(
            bytes(state_root), key, [_unhex(n) for n in proof["accountProof"]]
        )
    except (MptError, KeyError):
        return False
    claimed = rlp_encode(
        [
            _int_be(proof.get("nonce", 0)),
            _int_be(proof.get("balance", 0)),
            _unhex(proof.get("storageHash", _hx(EMPTY_TRIE_ROOT))),
            _unhex(proof.get("codeHash", _hx(EMPTY_CODE_HASH))),
        ]
    )
    if proven is None:
        empty = rlp_encode([b"", b"", EMPTY_TRIE_ROOT, EMPTY_CODE_HASH])
        return claimed == empty
    return proven == claimed


def verify_storage_proof(storage_hash: bytes, storage_key: bytes | str, entry: dict) -> bool:
    """One eth_getProof storageProof entry against the account's
    storageHash (reference isValidStorageKeys)."""
    key = keccak256(_unhex(storage_key).rjust(32, b"\x00"))
    try:
        proven = verify_mpt_proof(bytes(storage_hash), key, [_unhex(n) for n in entry["proof"]])
    except (MptError, KeyError):
        return False
    claimed = _to_int(entry.get("value", 0))
    if proven is None:
        return claimed == 0
    from .mpt import rlp_decode

    return int.from_bytes(rlp_decode(proven), "big") == claimed


def verify_code(code_hash: bytes | str, code: bytes | str) -> bool:
    """eth_getCode response against the proven account codeHash
    (reference isValidCodeHash)."""
    return keccak256(_unhex(code)) == _unhex(code_hash)


def verify_block_response(payload, block: dict) -> bool:
    """eth_getBlockBy{Hash,Number} response against the light-client-
    proven payload: every payload-covered field must match, and the
    response's transaction hashes must equal keccak256 of the payload's
    raw transactions (reference isValidBlock)."""
    # the response dict is attacker-controlled: ANY malformation (missing
    # keys, bad hex, wrong types) is a verification failure, not a crash
    try:
        checks = [
            _unhex(block["hash"]) == bytes(payload.block_hash),
            _unhex(block["parentHash"]) == bytes(payload.parent_hash),
            _unhex(block["stateRoot"]) == bytes(payload.state_root),
            _unhex(block["receiptsRoot"]) == bytes(payload.receipts_root),
            _unhex(block["miner"]) == bytes(payload.fee_recipient),
            _unhex(block["mixHash"]) == bytes(payload.prev_randao),
            _unhex(block["logsBloom"]) == bytes(payload.logs_bloom),
            _to_int(block["number"]) == int(payload.block_number),
            _to_int(block["gasLimit"]) == int(payload.gas_limit),
            _to_int(block["gasUsed"]) == int(payload.gas_used),
            _to_int(block["timestamp"]) == int(payload.timestamp),
            _unhex(block.get("extraData", "0x")) == bytes(payload.extra_data),
            _to_int(block.get("baseFeePerGas", 0)) == int(payload.base_fee_per_gas),
        ]
        if not all(checks):
            return False
        txs = block.get("transactions", [])
        raw_txs = list(payload.transactions)
        if len(txs) != len(raw_txs):
            return False
        for tx, raw in zip(txs, raw_txs):
            tx_hash = tx if isinstance(tx, str) else tx.get("hash")
            if _unhex(tx_hash) != keccak256(bytes(raw)):
                return False
        # capella+: the withdrawals list is consensus data — every field
        # must match the proven payload
        if hasattr(payload, "withdrawals"):
            wds = block.get("withdrawals", [])
            raw_wds = list(payload.withdrawals)
            if len(wds) != len(raw_wds):
                return False
            for wd, pw in zip(wds, raw_wds):
                if (
                    _to_int(wd["index"]) != int(pw.index)
                    or _to_int(wd["validatorIndex"]) != int(pw.validator_index)
                    or _unhex(wd["address"]) != bytes(pw.address)
                    or _to_int(wd["amount"]) != int(pw.amount)
                ):
                    return False
        # early-4844 deneb: one excess_data_gas quantity
        if hasattr(payload, "excess_data_gas"):
            if _to_int(block.get("excessDataGas", 0)) != int(payload.excess_data_gas):
                return False
    except (KeyError, VerificationError, ValueError, TypeError, AttributeError):
        return False
    return True


# --- verified provider --------------------------------------------------------


class VerifiedExecutionProvider:
    """Wraps an EL JSON-RPC handler with verification (reference
    processAndVerifyRequest, utils/process.ts). `handler(method, params)`
    returns the JSON result field."""

    def __init__(self, handler: Callable, proof_provider: ProofProvider):
        self.handler = handler
        self.proofs = proof_provider
        self.log = get_logger(name="lodestar.prover.provider")
        self._verified = {
            "eth_getBalance": self._get_account_field("balance"),
            "eth_getTransactionCount": self._get_account_field("nonce"),
            "eth_getCode": self._eth_get_code,
            "eth_getStorageAt": self._eth_get_storage_at,
            "eth_getBlockByHash": self._eth_get_block,
            "eth_getBlockByNumber": self._eth_get_block,
        }
        self._unverifiable = {"eth_call", "eth_estimateGas"}

    def request(self, method: str, params: list):
        fn = self._verified.get(method)
        if fn is not None:
            return fn(method, params)
        if method in self._unverifiable:
            raise VerificationError(
                f"{method} requires local EVM execution to verify; not supported"
            )
        self.log.debug("passing through unverified method", {"method": method})
        return self.handler(method, params)

    # -- handlers --------------------------------------------------------------

    def _account_proof(self, address, block_id):
        payload = self.proofs.get_execution_payload(
            "latest" if block_id is None else block_id
        )
        proof = self.handler("eth_getProof", [address, [], _hx(payload.block_hash)])
        if not verify_account_proof(bytes(payload.state_root), address, proof):
            raise VerificationError(f"account proof for {address} failed verification")
        return payload, proof

    def _get_account_field(self, field: str):
        def fn(method: str, params: list):
            address = params[0]
            block_id = params[1] if len(params) > 1 else None
            _, proof = self._account_proof(address, block_id)
            return proof[field]

        return fn

    def _eth_get_code(self, method: str, params: list):
        address = params[0]
        block_id = params[1] if len(params) > 1 else None
        payload, proof = self._account_proof(address, block_id)
        code = self.handler("eth_getCode", [address, _hx(payload.block_hash)])
        if not verify_code(proof["codeHash"], code):
            raise VerificationError(f"code for {address} does not match proven codeHash")
        return code

    def _eth_get_storage_at(self, method: str, params: list):
        address, slot = params[0], params[1]
        block_id = params[2] if len(params) > 2 else None
        payload = self.proofs.get_execution_payload(
            "latest" if block_id is None else block_id
        )
        proof = self.handler("eth_getProof", [address, [slot], _hx(payload.block_hash)])
        if not verify_account_proof(bytes(payload.state_root), address, proof):
            raise VerificationError(f"account proof for {address} failed verification")
        entries = proof.get("storageProof", [])
        if not entries or not verify_storage_proof(
            _unhex(proof["storageHash"]), slot, entries[0]
        ):
            raise VerificationError(f"storage proof for {address}[{slot}] failed")
        value = _to_int(entries[0].get("value", 0))
        return "0x" + value.to_bytes(32, "big").hex()

    def _eth_get_block(self, method: str, params: list):
        block_id = params[0]
        payload = self.proofs.get_execution_payload(block_id)
        # pin the EL query to the VERIFIED payload: a tag like "latest"
        # resolves to the light-client head, which lags the EL's own
        # head — forwarding the tag would make honest ELs fail to verify
        rest = list(params[1:])
        if method == "eth_getBlockByHash":
            el_params = [_hx(payload.block_hash), *rest]
        else:
            el_params = [hex(int(payload.block_number)), *rest]
        block = self.handler(method, el_params)
        if block is None:
            return None
        if not verify_block_response(payload, block):
            raise VerificationError(f"block response for {block_id!r} failed verification")
        return block
