"""Keymanager API: runtime keystore management for the validator client.

Reference `packages/api/src/keymanager/routes.ts` (the standard
keymanager endpoints: /eth/v1/keystores GET/POST/DELETE, /remotekeys,
per-pubkey feerecipient + gas_limit) and the CLI-side impl
`cli/src/cmds/validator/keymanager/impl.ts`. Deleting keys exports the
EIP-3076 slashing-protection interchange for the deleted pubkeys — the
data a migrating validator must carry.

The port of `lodestar_tpu.validator.keymanager`, with its imports rewritten.
"""

from __future__ import annotations

import json

from lodestar_tpu_torch.crypto.bls.api import SecretKey
from lodestar_tpu_torch.logger import get_logger

from .keystore import KeystoreError, decrypt_keystore
from .store import ValidatorStore

__all__ = ["KeymanagerApi"]

DEFAULT_GAS_LIMIT = 30_000_000


class KeymanagerApi:
    def __init__(
        self,
        store: ValidatorStore,
        *,
        genesis_validators_root: bytes = b"\x00" * 32,
        default_fee_recipient: str = "0x" + "00" * 20,
    ) -> None:
        self.store = store
        self.gvr = bytes(genesis_validators_root)
        self.log = get_logger(name="lodestar.keymanager")
        self.default_fee_recipient = default_fee_recipient
        self._fee_recipients: dict[bytes, str] = {}
        self._gas_limits: dict[bytes, int] = {}
        self._remote_keys: dict[bytes, str] = {}  # pubkey -> signer url

    # -- local keystores (/eth/v1/keystores) -----------------------------------

    def list_keys(self) -> list[dict]:
        return [
            {
                "validating_pubkey": "0x" + pk.hex(),
                "derivation_path": "",
                "readonly": False,
            }
            for pk in self.store.pubkeys
        ]

    def import_keystores(
        self, keystores: list[str | dict], passwords: list[str], slashing_protection: str | None = None
    ) -> list[dict]:
        """Per-keystore status: imported | duplicate | error (reference
        importKeystores). The optional EIP-3076 interchange is imported
        FIRST so the new keys are protected before they can sign."""
        if slashing_protection:
            interchange = (
                json.loads(slashing_protection)
                if isinstance(slashing_protection, str)
                else slashing_protection
            )
            self.store.slashing.import_interchange(interchange, self.gvr)
        statuses = []
        for i, ks in enumerate(keystores):
            if i >= len(passwords):
                # statuses must stay index-aligned with the request
                statuses.append({"status": "error", "message": "missing password"})
                continue
            password = passwords[i]
            try:
                ks_dict = json.loads(ks) if isinstance(ks, str) else ks
                secret = decrypt_keystore(ks_dict, password)
                sk = SecretKey.from_bytes(secret)
                pk = sk.to_pubkey()
                if self.store.has_pubkey(pk):
                    statuses.append({"status": "duplicate", "message": ""})
                    continue
                self.store.add_secret_key(sk)
                statuses.append({"status": "imported", "message": ""})
            except (KeystoreError, ValueError, KeyError, json.JSONDecodeError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return statuses

    def delete_keys(self, pubkeys_hex: list[str]) -> dict:
        """Per-pubkey status + the interchange export for the deleted
        keys (reference deleteKeys: slashing data travels with the
        keys)."""
        statuses = []
        deleted: list[bytes] = []
        for pk_hex in pubkeys_hex:
            try:
                pk = self._pk(pk_hex)
            except ValueError as e:
                statuses.append({"status": "error", "message": str(e)})
                continue
            if self.store.has_pubkey(pk):
                self.store.remove_pubkey(pk)
                deleted.append(pk)
                statuses.append({"status": "deleted", "message": ""})
            else:
                statuses.append({"status": "not_found", "message": ""})
        interchange = self.store.slashing.export_interchange(self.gvr, deleted)
        return {"statuses": statuses, "slashing_protection": json.dumps(interchange)}

    # -- remote keys (/eth/v1/remotekeys) --------------------------------------

    def list_remote_keys(self) -> list[dict]:
        return [
            {"pubkey": "0x" + pk.hex(), "url": url, "readonly": False}
            for pk, url in self._remote_keys.items()
        ]

    def import_remote_keys(self, remote_keys: list[dict]) -> list[dict]:
        statuses = []
        for entry in remote_keys:
            try:
                pk = self._pk(entry["pubkey"])
                if pk in self._remote_keys or self.store.has_pubkey(pk):
                    statuses.append({"status": "duplicate", "message": ""})
                    continue
                self._remote_keys[pk] = entry.get("url", "")
                statuses.append({"status": "imported", "message": ""})
            except (KeyError, ValueError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return statuses

    def delete_remote_keys(self, pubkeys_hex: list[str]) -> list[dict]:
        statuses = []
        for pk_hex in pubkeys_hex:
            try:
                pk = self._pk(pk_hex)
            except ValueError as e:
                statuses.append({"status": "error", "message": str(e)})
                continue
            if self._remote_keys.pop(pk, None) is not None:
                statuses.append({"status": "deleted", "message": ""})
            else:
                statuses.append({"status": "not_found", "message": ""})
        return statuses

    # -- per-validator proposer config ----------------------------------------

    def _pk(self, pubkey_hex: str) -> bytes:
        pk = bytes.fromhex(pubkey_hex[2:] if pubkey_hex.startswith("0x") else pubkey_hex)
        if len(pk) != 48:
            raise ValueError(f"pubkey must be 48 bytes, got {len(pk)}")
        return pk

    def get_fee_recipient(self, pubkey_hex: str) -> dict:
        pk = self._pk(pubkey_hex)
        return {
            "pubkey": "0x" + pk.hex(),
            "ethaddress": self._fee_recipients.get(pk, self.default_fee_recipient),
        }

    def set_fee_recipient(self, pubkey_hex: str, ethaddress: str) -> None:
        addr = ethaddress.lower()
        if not (addr.startswith("0x") and len(addr) == 42):
            raise ValueError(f"bad fee recipient address {ethaddress!r}")
        self._fee_recipients[self._pk(pubkey_hex)] = addr

    def delete_fee_recipient(self, pubkey_hex: str) -> None:
        self._fee_recipients.pop(self._pk(pubkey_hex), None)

    def get_gas_limit(self, pubkey_hex: str) -> dict:
        pk = self._pk(pubkey_hex)
        return {
            "pubkey": "0x" + pk.hex(),
            "gas_limit": str(self._gas_limits.get(pk, DEFAULT_GAS_LIMIT)),
        }

    def set_gas_limit(self, pubkey_hex: str, gas_limit: int) -> None:
        if int(gas_limit) <= 0:
            raise ValueError("gas limit must be positive")
        self._gas_limits[self._pk(pubkey_hex)] = int(gas_limit)

    def delete_gas_limit(self, pubkey_hex: str) -> None:
        self._gas_limits.pop(self._pk(pubkey_hex), None)


# --- REST surface (reference api/src/keymanager/routes.ts) --------------------

KEYMANAGER_ROUTES = [
    ("GET", r"/eth/v1/keystores", "r_list_keys"),
    ("POST", r"/eth/v1/keystores", "r_import_keystores"),
    ("DELETE", r"/eth/v1/keystores", "r_delete_keys"),
    ("GET", r"/eth/v1/remotekeys", "r_list_remote"),
    ("POST", r"/eth/v1/remotekeys", "r_import_remote"),
    ("DELETE", r"/eth/v1/remotekeys", "r_delete_remote"),
    ("GET", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/feerecipient", "r_get_fee"),
    ("POST", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/feerecipient", "r_set_fee"),
    ("DELETE", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/feerecipient", "r_del_fee"),
    ("GET", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/gas_limit", "r_get_gas"),
    ("POST", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/gas_limit", "r_set_gas"),
    ("DELETE", r"/eth/v1/validator/(?P<pubkey>0x[0-9a-fA-F]+)/gas_limit", "r_del_gas"),
]


class KeymanagerRouter:
    """Route table -> KeymanagerApi calls, same dispatch contract as the
    beacon API router so RestServer hosts either."""

    def __init__(self, km: KeymanagerApi):
        import re

        self.km = km
        self.table = [
            (method, re.compile("^" + pattern + "$"), getattr(self, handler))
            for method, pattern, handler in KEYMANAGER_ROUTES
        ]

    def dispatch(self, method: str, path: str, query: dict, body):
        from lodestar_tpu_torch.api.impl import ApiError

        for m, rx, fn in self.table:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                try:
                    return fn(query=query, body=body, **match.groupdict())
                except (ValueError, KeyError, AttributeError, TypeError) as e:
                    raise ApiError(400, f"bad request: {e}") from e
        raise ApiError(404, f"route not found: {method} {path}")

    def r_list_keys(self, **kw):
        return {"data": self.km.list_keys()}

    def r_import_keystores(self, body, **kw):
        body = body if isinstance(body, dict) else {}
        return {
            "data": self.km.import_keystores(
                body.get("keystores", []),
                body.get("passwords", []),
                body.get("slashing_protection"),
            )
        }

    def r_delete_keys(self, body, **kw):
        body = body if isinstance(body, dict) else {}
        out = self.km.delete_keys(body.get("pubkeys", []))
        return {"data": out["statuses"], "slashing_protection": out["slashing_protection"]}

    def r_list_remote(self, **kw):
        return {"data": self.km.list_remote_keys()}

    def r_import_remote(self, body, **kw):
        body = body if isinstance(body, dict) else {}
        return {"data": self.km.import_remote_keys(body.get("remote_keys", []))}

    def r_delete_remote(self, body, **kw):
        body = body if isinstance(body, dict) else {}
        return {"data": self.km.delete_remote_keys(body.get("pubkeys", []))}

    def r_get_fee(self, pubkey, **kw):
        return {"data": self.km.get_fee_recipient(pubkey)}

    def r_set_fee(self, pubkey, body, **kw):
        self.km.set_fee_recipient(pubkey, body["ethaddress"])
        return 202

    def r_del_fee(self, pubkey, **kw):
        self.km.delete_fee_recipient(pubkey)
        return 204

    def r_get_gas(self, pubkey, **kw):
        return {"data": self.km.get_gas_limit(pubkey)}

    def r_set_gas(self, pubkey, body, **kw):
        self.km.set_gas_limit(pubkey, int(body["gas_limit"]))
        return 202

    def r_del_gas(self, pubkey, **kw):
        self.km.delete_gas_limit(pubkey)
        return 204


def create_keymanager_server(
    km: KeymanagerApi,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    token_dir: str | None = None,
):
    """RestServer hosting the keymanager routes (reference runs this on
    the validator process, `keymanager/server/index.ts`).

    A bearer token is generated on startup and REQUIRED on every route
    (`Authorization: Bearer ...`) — key import/delete, interchange export
    and fee-recipient redirection must not be reachable by any co-resident
    process that can open the port. The token is exposed as
    `server.auth_token` and, when `token_dir` is given, written to
    `api-token.txt` in the standard format.
    """
    import secrets

    from lodestar_tpu_torch.api.server import RestServer

    token = "api-token-0x" + secrets.token_hex(32)
    if token_dir is not None:
        import os

        os.makedirs(token_dir, exist_ok=True)
        path = os.path.join(token_dir, "api-token.txt")
        with open(path, "w") as f:
            f.write(token + "\n")
        try:
            os.chmod(path, 0o600)
        except OSError:
            pass
    return RestServer(KeymanagerRouter(km), host=host, port=port, auth_token=token)
