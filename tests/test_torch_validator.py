"""The port's validator client (`lodestar_tpu_torch.validator`: the
in-process `Validator`, `ValidatorStore`, `SlashingProtection`, the EIP-2335
keystore, doppelganger protection and the keymanager API) against the JAX
package's, minimal preset.

Tolerance: none. The JAX package's `tests/validator/test_{keystore,
slashing_protection,doppelganger,keymanager,validator}.py` run on the port
(`port_copy`: the module's source with `lodestar_tpu` rewritten to
`lodestar_tpu_torch`, its assertions unchanged, its tests adopted as
`test_port_*`); its duty-loop tests (`test_rest_validator.py`,
`test_sync_duties.py` and the chain test of
`tests/metrics/test_validator_monitor.py`) run in
`tests/test_torch_validator_duties.py`. Beside them, both packages on the
same inputs:

* a keystore encrypted under a fixed salt, IV and uuid (both KDFs) is the
  same JSON in both, and each package decrypts the other's;
* the same attestations and proposals through both packages' slashing
  protection give the same verdicts and error codes and a byte-equal
  EIP-3076 interchange, and each package imports the other's;
* both packages' keymanager servers answer the same requests with the same
  status codes and JSON, and refuse a missing or wrong bearer token alike;
* the same registrations and liveness epochs give both packages'
  doppelganger services the same status sequences and detections.

`RestValidator` is held against the JAX package's in
`tests/test_torch_rest_validator.py`.
"""

from __future__ import annotations

import importlib
import json
import urllib.error
import urllib.request

import pytest

from .test_torch_chain import minimal_cpu  # noqa: F401 - the minimal preset in both packages
from .test_torch_utils_gaps import port_copy

for _mod in ("test_keystore", "test_slashing_protection", "test_doppelganger",
             "test_keymanager", "test_validator"):
    port_copy(f"tests.validator.{_mod}", globals())

J, T = "lodestar_tpu", "lodestar_tpu_torch"
SECRET = bytes.fromhex("000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")
PUB = b"\x12" * 48


def both(name):
    return [importlib.import_module(f"{root}.{name}") for root in (J, T)]


@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_keystore_json_is_equal_and_decrypts_across_the_packages(kdf, monkeypatch):
    import os
    import uuid

    stores = []
    for ks_mod in both("validator.keystore"):
        fixed = [bytes(range(32)), bytes(range(100, 116))]  # salt, then IV
        monkeypatch.setattr(os, "urandom", lambda n, fixed=fixed: fixed.pop(0)[:n])
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0x1234))
        stores.append(ks_mod.encrypt_keystore(SECRET, "pa\x07ss wörd", PUB, kdf=kdf,
                                              path="m/12381/3600/0/0/0"))
    assert json.dumps(stores[1]) == json.dumps(stores[0])
    jmod, tmod = both("validator.keystore")
    assert tmod.decrypt_keystore(stores[0], "pass wörd") == SECRET
    assert jmod.decrypt_keystore(stores[1], "pass wörd") == SECRET
    for mod in (jmod, tmod):
        with pytest.raises(mod.KeystoreError, match="checksum"):
            mod.decrypt_keystore(stores[0], "wrong")


def _protection_run(root):
    sp_mod = importlib.import_module(f"{root}.validator.slashing_protection")
    db = importlib.import_module(f"{root}.db")
    sp = sp_mod.SlashingProtection(db.MemoryDbController())
    pk, pk2, gvr = b"\xaa" * 48, b"\xbb" * 48, b"\x33" * 32
    seen = []
    steps = [("att", pk, 1, 2, 1), ("att", pk, 1, 2, 1), ("att", pk, 1, 2, 9),
             ("att", pk, 3, 4, 2), ("att", pk, 2, 5, 3), ("att", pk, 6, 9, 4),
             ("att", pk, 7, 8, 5), ("att", pk, 5, 4, 6), ("att", pk2, 1, 2, 1),
             ("block", pk, 10, 1), ("block", pk, 10, 1), ("block", pk, 10, 3),
             ("block", pk, 11, 2), ("block", pk2, 40, 7)]
    for step in steps:
        try:
            if step[0] == "att":
                sp.check_and_insert_attestation(step[1], step[2], step[3], bytes([step[4]]) * 32)
            else:
                sp.check_and_insert_block_proposal(step[1], step[2], bytes([step[3]]) * 32)
            seen.append("ok")
        except sp_mod.SlashingError as e:
            seen.append((e.code, str(e)))
    exported = json.dumps(sp.export_interchange(gvr, [pk, pk2]))
    return sp_mod, seen, exported, list(sp._att_by_target.db.entries_stream())


def test_slashing_protection_verdicts_and_interchange_are_equal():
    (jmod, jseen, jexp, jdb), (tmod, tseen, texp, tdb) = _protection_run(J), _protection_run(T)
    assert tseen == jseen
    assert "ok" in tseen and any(isinstance(s, tuple) for s in tseen)
    assert texp == jexp
    assert tdb == jdb
    gvr = b"\x33" * 32
    for mod, other in ((jmod, texp), (tmod, jexp)):
        db = importlib.import_module(f"{mod.__name__.split('.')[0]}.db")
        sp = mod.SlashingProtection(db.MemoryDbController())
        sp.import_interchange(json.loads(other), gvr)
        with pytest.raises(mod.SlashingError):
            sp.check_and_insert_attestation(b"\xaa" * 48, 0, 3, b"\x09" * 32)
        assert json.dumps(sp.export_interchange(gvr, [b"\xaa" * 48, b"\xbb" * 48])) == jexp


def _keymanager_run(root, new_ks):
    """The same requests against `root`'s keymanager server: (status, JSON)
    each, with the server's own token where one is sent; `new_ks` is the
    keystore of a third key to import."""
    config = importlib.import_module(f"{root}.config")
    db = importlib.import_module(f"{root}.db")
    gen = importlib.import_module(f"{root}.state_transition.genesis")
    validator = importlib.import_module(f"{root}.validator")
    km_mod = importlib.import_module(f"{root}.validator.keymanager")
    params = importlib.import_module(f"{root}.params")
    sks = gen.interop_secret_keys(3)
    store = validator.ValidatorStore(
        config.create_beacon_config(config.minimal_chain_config(), b"\x00" * 32),
        validator.SlashingProtection(db.MemoryDbController()), sks[:2], params.MINIMAL)
    store.slashing.check_and_insert_block_proposal(sks[0].to_pubkey(), 5, b"\x05" * 32)
    server = km_mod.create_keymanager_server(km_mod.KeymanagerApi(store), port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    pk0, pk1 = "0x" + sks[0].to_pubkey().hex(), "0x" + sks[1].to_pubkey().hex()
    requests = [
        ("GET", "/eth/v1/keystores", None, None),
        ("GET", "/eth/v1/keystores", None, "Bearer wrong"),
        ("GET", "/eth/v1/keystores", None, "token"),
        ("POST", "/eth/v1/keystores", {"keystores": [json.dumps(new_ks), "{}"],
                                       "passwords": ["pw", "x"]}, "token"),
        ("POST", "/eth/v1/keystores", {"keystores": [json.dumps(new_ks)], "passwords": []},
         "token"),
        ("GET", "/eth/v1/keystores", None, "token"),
        ("DELETE", "/eth/v1/keystores", {"pubkeys": [pk0, "0x" + "ee" * 48, "0x12"]}, "token"),
        ("POST", "/eth/v1/remotekeys", {"remote_keys": [{"pubkey": "0x" + "ab" * 48,
                                                         "url": "https://signer"}, {}]}, "token"),
        ("GET", "/eth/v1/remotekeys", None, "token"),
        ("DELETE", "/eth/v1/remotekeys", {"pubkeys": ["0x" + "ab" * 48, "0x" + "cd" * 48]},
         "token"),
        ("POST", f"/eth/v1/validator/{pk1}/feerecipient", {"ethaddress": "0x" + "CC" * 20},
         "token"),
        ("GET", f"/eth/v1/validator/{pk1}/feerecipient", None, "token"),
        ("POST", f"/eth/v1/validator/{pk1}/feerecipient", {"ethaddress": "nonsense"}, "token"),
        ("DELETE", f"/eth/v1/validator/{pk1}/feerecipient", None, "token"),
        ("POST", f"/eth/v1/validator/{pk1}/gas_limit", {"gas_limit": "12345"}, "token"),
        ("GET", f"/eth/v1/validator/{pk1}/gas_limit", None, "token"),
        ("POST", f"/eth/v1/validator/{pk1}/gas_limit", {"gas_limit": -5}, "token"),
        ("DELETE", f"/eth/v1/validator/{pk1}/gas_limit", None, "wrong"),
        ("GET", "/eth/v1/nonsense", None, "token"),
    ]
    out = []
    try:
        for method, path, body, auth in requests:
            headers = {}
            if auth == "token":
                headers["Authorization"] = f"Bearer {server.auth_token}"
            elif auth is not None:
                headers["Authorization"] = auth
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
            try:
                with urllib.request.urlopen(req) as r:
                    raw = r.read()
                    out.append((r.status, json.loads(raw) if raw else None))
            except urllib.error.HTTPError as e:
                raw = e.read()
                out.append((e.code, json.loads(raw) if raw else None))
    finally:
        server.stop()
    return out, sorted(store.pubkeys)


KEYSTORE = json.dumps({
    "crypto": {
        "kdf": {"function": "pbkdf2",
                "params": {"dklen": 32, "c": 2, "prf": "hmac-sha256", "salt": "00" * 32},
                "message": ""},
        "checksum": {"function": "sha256", "params": {}, "message": ""},
        "cipher": {"function": "aes-128-ctr", "params": {"iv": "11" * 16}, "message": ""},
    },
    "description": "", "pubkey": "", "path": "", "uuid": "", "version": 4})


def _third_key_keystore():
    """KEYSTORE completed for interop key 2 under password "pw" by the JAX
    package's cipher and checksum (c=2 keeps the KDF cheap)."""
    import hashlib

    from lodestar_tpu.state_transition.genesis import interop_secret_keys
    from lodestar_tpu.validator import keystore as ks

    sk = interop_secret_keys(3)[2]
    out = json.loads(KEYSTORE)
    params = out["crypto"]["kdf"]["params"]
    dk = ks._kdf(ks._normalize_password("pw"), params, "pbkdf2")
    cipher = ks._aes128_ctr(dk[:16], bytes.fromhex("11" * 16), sk.scalar.to_bytes(32, "big"))
    out["crypto"]["cipher"]["message"] = cipher.hex()
    out["crypto"]["checksum"]["message"] = hashlib.sha256(dk[16:32] + cipher).hexdigest()
    out["pubkey"] = sk.to_pubkey().hex()
    return out


def test_keymanager_answers_and_refusals_are_equal():
    new_ks = _third_key_keystore()
    jax_out, port_out = _keymanager_run(J, new_ks), _keymanager_run(T, new_ks)
    assert port_out == jax_out
    statuses = [s for s, _ in port_out[0]]
    assert statuses[:3] == [401, 401, 200] and {202, 204, 400, 404} <= set(statuses)
    assert [s["status"] for s in port_out[0][3][1]["data"]] == ["imported", "error"]


def test_doppelganger_status_sequences_are_equal():
    pks = [bytes([i]) * 48 for i in range(1, 6)]
    script = [("register", 0, 0), ("register", 1, 3), ("register", 2, 3), ("register", 3, 5),
              ("live", 3, {0: False, 1: False, 2: True}), ("live", 4, {1: False, 2: False, 3: True}),
              ("live", 4, {1: True}), ("live", 5, {1: False, 3: False}),
              ("register", 1, 9), ("live", 6, {1: True, 3: False}), ("live", 7, {3: False}),
              ("live", 8, {3: False, 4: True})]
    runs = []
    for dg in both("validator.doppelganger"):
        svc = dg.DoppelgangerService(detection_epochs=2)
        seen = []
        for kind, a, b in script:
            if kind == "register":
                svc.register_validator(pks[a], current_epoch=b)
            else:
                seen.append([pks.index(pk) for pk in svc.on_epoch_liveness(
                    a, {pks[i]: live for i, live in b.items()})])
            seen.append([(svc.status(pk).value, svc.is_safe(pk)) for pk in pks])
        seen.append([pks.index(pk) for pk in svc.detected])
        runs.append(seen)
    assert runs[1] == runs[0]
