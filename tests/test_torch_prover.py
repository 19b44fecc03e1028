"""The port's prover (`lodestar_tpu_torch.prover`: `PayloadStore`,
`ProofProvider`, `VerifiedExecutionProvider` and the account, storage,
code and block checks) against the JAX package's.

Tolerance: none. The eight cases of the JAX package's
`tests/prover/test_prover.py` run on the port (`port_copy`: the JAX test
module with its imports rewritten to the port, its assertions unchanged,
collected here as `test_port_*`; its independent trie construction then
runs on the port's `mpt`). Across the packages: on tries that the JAX test's own
trie construction builds, each package's account, storage and code verdicts on valid and
tampered proofs are equal; a block response is checked against the same
payload (carried into the port as SSZ bytes) with equal verdicts field by
field; and the verified provider over a scripted EL gives equal answers and
equal `VerificationError`s in both.
"""

from __future__ import annotations

import importlib
import random

import pytest

from .test_torch_utils_gaps import port_copy

_port = port_copy("tests.prover.test_prover", globals())
_jax = importlib.import_module("tests.prover.test_prover")

ROOTS = ("lodestar_tpu", "lodestar_tpu_torch")


def pkgs():
    return [importlib.import_module(f"{r}.prover") for r in ROOTS]


def _accounts(rng, n):
    return {rng.randbytes(20): [rng.randbytes(rng.randrange(1, 3)), rng.randbytes(4),
                                rng.randbytes(32), rng.randbytes(32)] for _ in range(n)}


def test_account_storage_and_code_verdicts_agree():
    rng = random.Random(1559)
    accounts = _accounts(rng, 24)
    trie = _jax._account_trie(accounts)
    cases = []
    for addr, (nonce, balance, storage, code) in list(accounts.items())[:8]:
        n, b = int.from_bytes(nonce, "big"), int.from_bytes(balance, "big")
        good = _jax._proof_dict(trie, addr, n, b, storage, code)
        cases += [(addr, good), (addr, dict(good, nonce=hex(n + 1))),
                  (addr, dict(good, accountProof=good["accountProof"][:1])),
                  (addr, dict(good, codeHash="0x" + bytes(32).hex()))]
    missing = rng.randbytes(20)
    cases.append((missing, _jax._proof_dict(trie, missing, 0, 0, _jax.EMPTY_TRIE_ROOT,
                                            _jax.EMPTY_CODE_HASH)))
    cases.append((missing, _jax._proof_dict(trie, missing, 1, 0, _jax.EMPTY_TRIE_ROOT,
                                            _jax.EMPTY_CODE_HASH)))
    slots = {rng.randbytes(32): rng.randrange(1, 2**64) for _ in range(12)}
    strie = _jax._TrieBuilder({_jax.keccak256(k): _jax.rlp_encode(v) for k, v in slots.items()})
    entries = []
    for k, v in slots.items():
        proof = ["0x" + x.hex() for x in strie.prove(_jax.keccak256(k))]
        entries += [("0x" + k.hex(), {"value": hex(v), "proof": proof}),
                    ("0x" + k.hex(), {"value": hex(v + 1), "proof": proof}),
                    ("0x" + k.hex(), {"value": hex(v), "proof": []})]
    entries.append(("0x07", {"value": "0x0", "proof": entries[0][1]["proof"]}))
    codes = [(_jax.keccak256(c), c) for c in (b"", b"\x60\x00", rng.randbytes(300))]
    verdicts = []
    for prover in pkgs():
        verdicts.append((
            [prover.verify_account_proof(trie.root, a, p) for a, p in cases],
            [prover.verify_storage_proof(strie.root, k, e) for k, e in entries],
            [prover.verify_code("0x" + h.hex(), "0x" + c.hex()) for h, c in codes]
            + [prover.verify_code(codes[1][0], b"\x60\x01")],
        ))
    assert verdicts[1] == verdicts[0]
    assert verdicts[0][0].count(True) == 9 and verdicts[0][1].count(True) == 13


def _payloads(p):
    """The JAX test's payload and the same payload in the port (SSZ bytes)."""
    from lodestar_tpu_torch.types import ssz_types

    txs = [b"\x02rawtx1", b"\x02rawtx2", b"\x01" * 70]
    payload = _jax._payload_with(p, b"\x11" * 32, 7, txs)
    payload.gas_limit, payload.gas_used, payload.timestamp = 30_000_000, 21_000, 1_700_000_000
    payload.extra_data = b"lodestar"
    payload.base_fee_per_gas = 7
    typ = ssz_types(p).deneb.ExecutionPayload
    return payload, typ.deserialize(payload.type.serialize(payload)), txs


def test_block_response_verdicts_agree():
    from lodestar_tpu import params

    jpayload, tpayload, txs = _payloads(params.MINIMAL)
    keccak = _jax.keccak256
    block = {
        "hash": "0x" + bytes(jpayload.block_hash).hex(),
        "parentHash": "0x" + bytes(jpayload.parent_hash).hex(),
        "stateRoot": "0x" + bytes(jpayload.state_root).hex(),
        "receiptsRoot": "0x" + bytes(jpayload.receipts_root).hex(),
        "miner": "0x" + bytes(jpayload.fee_recipient).hex(),
        "mixHash": "0x" + bytes(jpayload.prev_randao).hex(),
        "logsBloom": "0x" + bytes(jpayload.logs_bloom).hex(),
        "number": hex(7), "gasLimit": hex(30_000_000), "gasUsed": hex(21_000),
        "timestamp": hex(1_700_000_000), "extraData": "0x" + b"lodestar".hex(),
        "baseFeePerGas": "0x7", "transactions": ["0x" + keccak(tx).hex() for tx in txs],
        "withdrawals": [], "excessDataGas": "0x0",
    }
    variants = [block] + [dict(block, **{k: v}) for k, v in (
        ("number", "0x8"), ("gasUsed", "0x0"), ("extraData", "0x"), ("baseFeePerGas", "0x8"),
        ("miner", "0x" + "01" * 20), ("transactions", block["transactions"][:2]),
        ("transactions", list(reversed(block["transactions"]))), ("hash", "zz"),
        ("withdrawals", [{"index": "0x0", "validatorIndex": "0x0", "address": "0x",
                          "amount": "0x0"}]))]
    variants.append({k: v for k, v in block.items() if k != "stateRoot"})
    got = [[prover.verify_block_response(payload, b) for b in variants]
           for prover, payload in zip(pkgs(), (jpayload, tpayload))]
    assert got[1] == got[0] and got[0][0] and not any(got[0][1:])


def test_verified_provider_answers_agree():
    """The JAX test's provider scenario, scripted EL and lying EL, through
    both packages: equal answers and equal errors (class and message)."""
    from lodestar_tpu import params

    addr = "0x" + "ab" * 20
    code = b"\x60\x02\x60\x03"
    acct = [b"\x09", b"\x01\x00", _jax.EMPTY_TRIE_ROOT, _jax.keccak256(code)]
    trie = _jax._account_trie({bytes.fromhex(addr[2:]): acct})
    jpayload, tpayload, _ = _payloads(params.MINIMAL)
    jpayload.state_root = trie.root
    from lodestar_tpu_torch.types import ssz_types

    tpayload = ssz_types(params.MINIMAL).deneb.ExecutionPayload.deserialize(
        jpayload.type.serialize(jpayload))

    def handler(balance):
        def fn(method, params_):
            if method == "eth_getProof":
                return _jax._proof_dict(trie, bytes.fromhex(addr[2:]), 9, balance,
                                        _jax.EMPTY_TRIE_ROOT, _jax.keccak256(code))
            if method == "eth_getCode":
                return "0x" + code.hex()
            return {"method": method, "params": params_}
        return fn

    requests = [("eth_getBalance", [addr, "latest"]), ("eth_getTransactionCount", [addr]),
                ("eth_getCode", [addr, "finalized"]), ("eth_call", [{"to": addr}, "latest"]),
                ("eth_chainId", []), ("eth_getBalance", [addr, "0x8"]),
                ("eth_getBalance", [addr, 7])]
    seen = []
    for prover, payload in zip(pkgs(), (jpayload, tpayload)):
        proofs = prover.ProofProvider()
        proofs.on_payload(payload, finalized=True)
        out = []
        for balance in (256, 255):
            vp = prover.VerifiedExecutionProvider(handler(balance), proofs)
            for method, params_ in requests:
                try:
                    out.append(vp.request(method, params_))
                except prover.VerificationError as e:
                    out.append(("VerificationError", str(e)))
        seen.append(out)
    assert seen[1] == seen[0]
    assert seen[0][0] == hex(256) and seen[0][7][0] == "VerificationError"


@pytest.mark.parametrize("max_history", [1, 2, 4])
def test_payload_store_agrees(max_history):
    """The same pushes (finalized and not, a reorged-out payload at an equal
    height) into both packages' `PayloadStore`: equal lookups by tag, number
    and hash after every push."""
    from lodestar_tpu import params
    from lodestar_tpu_torch.types import ssz_types

    rng = random.Random(max_history)
    jp = [_jax._payload_with(params.MINIMAL, rng.randbytes(32), n, []) for n in range(1, 9)]
    fork = _jax._payload_with(params.MINIMAL, b"\x05" * 32, 5, [])
    fork.block_hash = b"\xfe" * 32
    jp.insert(5, fork)
    typ = ssz_types(params.MINIMAL).deneb.ExecutionPayload
    tp = [typ.deserialize(x.type.serialize(x)) for x in jp]
    seen = []
    for prover, payloads in zip(pkgs(), (jp, tp)):
        store = prover.PayloadStore(max_history=max_history)
        out = []
        for i, pl in enumerate(payloads):
            store.set(pl, finalized=i % 3 == 0)
            for key in ("latest", "finalized", "safe", "earliest", None, 1, 3, 5, "0x5", 8,
                        "0x" + "fe" * 32, b"\xfe" * 32, "junk"):
                got = store.get(key)
                out.append(None if got is None else bytes(got.block_hash))
        seen.append(out)
    assert seen[1] == seen[0]
