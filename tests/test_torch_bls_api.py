"""The port's single-signature BLS API (`lodestar_tpu_torch.crypto.bls.api`:
`verify`, `aggregate_pubkeys`, `aggregate_signatures`,
`fast_aggregate_verify`, `eth_fast_aggregate_verify`, `aggregate_verify`,
`G2_INFINITY`) against the JAX package's `lodestar_tpu.crypto.bls.api`.

Tolerance: none. Each call gives the same outcome in both packages: equal
bytes or verdicts, or the same exception class. Inputs are the committed
vectors under `tests/spec/vectors/tests/general/phase0/bls` (the table
`tests/spec/test_bls_vectors.py` runs) and keys and messages made from a
numpy seed: valid and tampered checks, empty lists, the infinity points
and bytes that do not decode. Also: a committee's aggregate signature made
as one signature by the sum of its secret keys mod r (how the on-card
block phase of `chip_smoke.py` signs its attestations) is byte-equal to
`aggregate_signatures` of the members' own signatures.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from lodestar_tpu.crypto.bls import api as japi
from lodestar_tpu.spec_test import iterate_spec_tests as j_iterate
from lodestar_tpu_torch.crypto import bls as port_bls
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.crypto.bls.fields import R

VECTORS = os.path.join(os.path.dirname(__file__), "spec", "vectors", "tests")
NEW = ("verify", "aggregate_pubkeys", "aggregate_signatures", "fast_aggregate_verify",
       "eth_fast_aggregate_verify", "aggregate_verify")


def _b(hexstr: str) -> bytes:
    return bytes.fromhex(hexstr[2:] if hexstr.startswith("0x") else hexstr)


def outcome(mod, name, *args):
    """("ok", value) or ("raises", exception class name) of mod.name(*args)."""
    try:
        return "ok", getattr(mod, name)(*args)
    except Exception as e:  # noqa: BLE001 - the class is the observation
        return "raises", type(e).__name__


def both(name, *args):
    """The port's outcome, after checking that it equals the JAX package's."""
    got, want = outcome(api, name, *args), outcome(japi, name, *args)
    assert got == want, f"{name}: port {got} != jax {want}"
    return got


def test_exports():
    assert set(NEW) | {"G2_INFINITY"} <= set(api.__all__)
    assert set(NEW) | {"G2_INFINITY"} <= set(port_bls.__all__)
    assert api.G2_INFINITY == japi.G2_INFINITY == b"\xc0" + bytes(95)


# --- the committed vectors ----------------------------------------------------

_HANDLER_ARGS = {
    "verify": lambda i: (_b(i["pubkey"]), _b(i["message"]), _b(i["signature"])),
    "aggregate": lambda i: ([_b(s) for s in i],),
    "fast_aggregate_verify": lambda i: ([_b(p) for p in i["pubkeys"]], _b(i["message"]),
                                        _b(i["signature"])),
    "eth_fast_aggregate_verify": lambda i: ([_b(p) for p in i["pubkeys"]], _b(i["message"]),
                                            _b(i["signature"])),
    "aggregate_verify": lambda i: ([_b(p) for p in i["pubkeys"]],
                                   [_b(m) for m in i["messages"]], _b(i["signature"])),
}
_FN = {"aggregate": "aggregate_signatures"}
_CASES = [c for c in j_iterate(VECTORS) if c.runner == "bls" and c.handler in _HANDLER_ARGS]


@pytest.mark.parametrize("case", _CASES, ids=[c.test_id for c in _CASES])
def test_vector_case(case):
    data = case.load("data")
    name = _FN.get(case.handler, case.handler)
    kind, value = both(name, *_HANDLER_ARGS[case.handler](data["input"]))
    if data["output"] is None:
        assert kind == "raises"
    elif isinstance(data["output"], bool):
        assert (kind, value) == ("ok", data["output"])
    else:
        assert (kind, value) == ("ok", _b(data["output"]))


def test_every_new_function_has_a_vector():
    handlers = {_FN.get(c.handler, c.handler) for c in _CASES}
    assert handlers == set(NEW) - {"aggregate_pubkeys"}
    assert len(_CASES) == 21  # the 28 cases less sign (4) and batch_verify (3)


# --- seeded keys --------------------------------------------------------------


@pytest.fixture(scope="module")
def keyed():
    rng = np.random.default_rng(12)
    scalars = [int.from_bytes(rng.bytes(32), "big") % R or 1 for _ in range(4)]
    sks = [api.SecretKey(k) for k in scalars]
    pks = [sk.to_pubkey() for sk in sks]
    assert pks == [japi.SecretKey(k).to_pubkey() for k in scalars]
    msgs = [rng.bytes(32) for _ in range(4)]
    sigs = [api.sign(sk, m) for sk, m in zip(sks, msgs)]
    same = [api.sign(sk, msgs[0]) for sk in sks]
    assert sigs == [japi.sign(japi.SecretKey(k), m) for k, m in zip(scalars, msgs)]
    return {"scalars": scalars, "pks": pks, "msgs": msgs, "sigs": sigs, "same": same}


def test_verify_seeded(keyed):
    pks, msgs, sigs = keyed["pks"], keyed["msgs"], keyed["sigs"]
    assert both("verify", pks[0], msgs[0], sigs[0]) == ("ok", True)
    assert both("verify", pks[1], msgs[0], sigs[0]) == ("ok", False)
    assert both("verify", pks[0], msgs[1], sigs[0]) == ("ok", False)
    assert both("verify", pks[0], msgs[0], api.G2_INFINITY) == ("ok", False)


@pytest.mark.parametrize("pk,sig", [
    (b"\xc0" + bytes(47), None),  # the G1 infinity pubkey (KeyValidate rejects it)
    (b"\xff" * 48, None),  # no point
    (b"\x01" * 47, None),  # one byte short
    (None, b"\xff" * 96),  # no G2 point
    (None, b"\x01" * 95),
], ids=["infinity_pk", "garbage_pk", "short_pk", "garbage_sig", "short_sig"])
def test_verify_undecodable(keyed, pk, sig):
    pk = keyed["pks"][0] if pk is None else pk
    sig = keyed["sigs"][0] if sig is None else sig
    assert both("verify", pk, keyed["msgs"][0], sig) == ("ok", False)


def test_aggregates_seeded(keyed):
    pks, sigs = keyed["pks"], keyed["sigs"]
    kind, agg_pk = both("aggregate_pubkeys", pks)
    assert kind == "ok" and len(agg_pk) == 48
    kind, agg_sig = both("aggregate_signatures", sigs)
    assert kind == "ok" and len(agg_sig) == 96
    assert both("aggregate_pubkeys", pks[:1]) == ("ok", pks[0])
    assert both("aggregate_pubkeys", []) == ("raises", "ValueError")
    assert both("aggregate_signatures", []) == ("raises", "ValueError")
    assert both("aggregate_pubkeys", [pks[0], b"\xff" * 48])[0] == "raises"
    assert both("aggregate_signatures", [sigs[0], b"\xff" * 96])[0] == "raises"
    # the infinity signature is the identity of the sum
    assert both("aggregate_signatures", [sigs[0], api.G2_INFINITY]) == ("ok", sigs[0])


def test_fast_aggregate_verify_seeded(keyed):
    pks, msgs, same = keyed["pks"], keyed["msgs"], keyed["same"]
    agg = api.aggregate_signatures(same)
    assert both("fast_aggregate_verify", pks, msgs[0], agg) == ("ok", True)
    assert both("fast_aggregate_verify", pks[:3], msgs[0], agg) == ("ok", False)
    assert both("fast_aggregate_verify", pks, msgs[1], agg) == ("ok", False)
    assert both("fast_aggregate_verify", [], msgs[0], api.G2_INFINITY) == ("ok", False)
    assert both("fast_aggregate_verify", pks, msgs[0], b"\x01" * 96) == ("ok", False)
    assert both("fast_aggregate_verify", [b"\xc0" + bytes(47)], msgs[0], agg) == ("ok", False)


def test_eth_fast_aggregate_verify_seeded(keyed):
    pks, msgs, same = keyed["pks"], keyed["msgs"], keyed["same"]
    agg = api.aggregate_signatures(same)
    assert both("eth_fast_aggregate_verify", [], msgs[0], api.G2_INFINITY) == ("ok", True)
    assert both("eth_fast_aggregate_verify", [], msgs[0], agg) == ("ok", False)
    assert both("eth_fast_aggregate_verify", pks, msgs[0], agg) == ("ok", True)
    assert both("eth_fast_aggregate_verify", pks, msgs[0], api.G2_INFINITY) == ("ok", False)


def test_aggregate_verify_seeded(keyed):
    pks, msgs, sigs = keyed["pks"], keyed["msgs"], keyed["sigs"]
    agg = api.aggregate_signatures(sigs)
    assert both("aggregate_verify", pks, msgs, agg) == ("ok", True)
    assert both("aggregate_verify", pks, msgs[::-1], agg) == ("ok", False)
    assert both("aggregate_verify", pks[:3], msgs, agg) == ("ok", False)  # lengths differ
    assert both("aggregate_verify", [], [], api.G2_INFINITY) == ("ok", False)
    assert both("aggregate_verify", pks, msgs, api.G2_INFINITY) == ("ok", False)
    assert both("aggregate_verify", [b"\xff" * 48] + pks[1:], msgs, agg) == ("ok", False)


def test_summed_key_signature_is_the_aggregate(keyed):
    """sign(sum of the keys mod r, m) == aggregate_signatures([sign(k_i, m)])."""
    scalars, msg = keyed["scalars"], keyed["msgs"][0]
    summed = api.SecretKey(sum(scalars) % R)
    assert api.sign(summed, msg) == api.aggregate_signatures(keyed["same"])
    assert api.sign(summed, msg) == japi.aggregate_signatures(
        [japi.sign(japi.SecretKey(k), msg) for k in scalars])
    assert api.verify(api.aggregate_pubkeys(keyed["pks"]), msg, api.sign(summed, msg))
