"""Typed REST client over the same routes (reference
`api/src/beacon/client/` getClient — the validator process talks to the
node exclusively through this).

The port of `lodestar_tpu.api.client`, with its imports rewritten.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

__all__ = ["BeaconApiClient", "ApiClientError"]


class ApiClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class BeaconApiClient:
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _req(self, method: str, path: str, query: dict | None = None, body=None):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req) as r:
                raw = r.read()
                return json.loads(raw) if raw else {}
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("message", "")
            except Exception:
                msg = ""
            raise ApiClientError(e.code, msg) from e

    # beacon
    def get_genesis(self):
        return self._req("GET", "/eth/v1/beacon/genesis")

    def get_block_header(self, block_id: str):
        return self._req("GET", f"/eth/v1/beacon/headers/{block_id}")

    def get_block_v2(self, block_id: str):
        return self._req("GET", f"/eth/v2/beacon/blocks/{block_id}")

    def publish_block(self, signed_block_json: dict):
        return self._req("POST", "/eth/v1/beacon/blocks", body=signed_block_json)

    def get_state_finality_checkpoints(self, state_id: str):
        return self._req("GET", f"/eth/v1/beacon/states/{state_id}/finality_checkpoints")

    def get_state_fork(self, state_id: str):
        return self._req("GET", f"/eth/v1/beacon/states/{state_id}/fork")

    def get_state_validators(self, state_id: str):
        return self._req("GET", f"/eth/v1/beacon/states/{state_id}/validators")

    def submit_pool_proposer_slashing(self, slashing_json: dict):
        return self._req("POST", "/eth/v1/beacon/pool/proposer_slashings", body=slashing_json)

    def submit_pool_attester_slashing(self, slashing_json: dict):
        return self._req("POST", "/eth/v1/beacon/pool/attester_slashings", body=slashing_json)

    def submit_pool_attestations(self, attestations_json: list):
        return self._req("POST", "/eth/v1/beacon/pool/attestations", body=attestations_json)

    # validator
    def get_proposer_duties(self, epoch: int):
        return self._req("GET", f"/eth/v1/validator/duties/proposer/{epoch}")

    def get_attester_duties(self, epoch: int, indices: list[int]):
        return self._req(
            "POST", f"/eth/v1/validator/duties/attester/{epoch}", body=[str(i) for i in indices]
        )

    def produce_block_v2(self, slot: int, randao_reveal: bytes, graffiti: str = ""):
        return self._req(
            "GET",
            f"/eth/v2/validator/blocks/{slot}",
            query={"randao_reveal": "0x" + randao_reveal.hex(), "graffiti": graffiti},
        )

    def produce_attestation_data(self, slot: int, committee_index: int):
        return self._req(
            "GET",
            "/eth/v1/validator/attestation_data",
            query={"slot": slot, "committee_index": committee_index},
        )

    # node
    # sync-committee validator flows
    def get_sync_committee_duties(self, epoch: int, indices: list[int]):
        return self._req(
            "POST", f"/eth/v1/validator/duties/sync/{epoch}", body=[int(i) for i in indices]
        )

    def submit_pool_sync_committees(self, messages_json: list):
        return self._req("POST", "/eth/v1/beacon/pool/sync_committees", body=messages_json)

    def produce_sync_committee_contribution(
        self, slot: int, subcommittee_index: int, beacon_block_root: str
    ):
        return self._req(
            "GET",
            "/eth/v1/validator/sync_committee_contribution",
            {
                "slot": str(slot),
                "subcommittee_index": str(subcommittee_index),
                "beacon_block_root": beacon_block_root,
            },
        )

    def publish_contribution_and_proofs(self, signed_json: list):
        return self._req(
            "POST", "/eth/v1/validator/contribution_and_proofs", body=signed_json
        )

    def get_block_root(self, block_id: str):
        return self._req("GET", f"/eth/v1/beacon/blocks/{block_id}/root")

    # light-client namespace
    def get_lc_bootstrap(self, block_root_hex: str):
        return self._req(
            "GET", f"/eth/v1/beacon/light_client/bootstrap/{block_root_hex}"
        )

    def get_lc_updates(self, start_period: int, count: int):
        return self._req(
            "GET",
            "/eth/v1/beacon/light_client/updates",
            {"start_period": str(start_period), "count": str(count)},
        )

    def get_lc_finality_update(self):
        return self._req("GET", "/eth/v1/beacon/light_client/finality_update")

    def get_lc_optimistic_update(self):
        return self._req("GET", "/eth/v1/beacon/light_client/optimistic_update")

    def get_health(self) -> int:
        try:
            self._req("GET", "/eth/v1/node/health")
            return 200
        except ApiClientError as e:
            return e.status

    def get_version(self):
        return self._req("GET", "/eth/v1/node/version")

    def get_syncing_status(self):
        return self._req("GET", "/eth/v1/node/syncing")

    # debug / config
    def get_debug_state_v2(self, state_id: str):
        return self._req("GET", f"/eth/v2/debug/beacon/states/{state_id}")

    def get_spec(self):
        return self._req("GET", "/eth/v1/config/spec")
