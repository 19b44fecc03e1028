"""REST server: Eth Beacon API routes over the impl.

Reference `beacon-node/src/api/rest/base.ts:39` (fastify) — here a
threaded stdlib HTTP server with a declarative route table, the same
path shapes (`/eth/v1/...`, `/eth/v2/...`) so standard beacon clients
interoperate.

The port of `lodestar_tpu.api.server`, with its imports rewritten.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Callable

from .impl import ApiError, BeaconApiImpl, EventStream

__all__ = ["BeaconRestApiServer", "ROUTES"]

# (method, path regex with named groups, handler name, kind)
ROUTES: list[tuple[str, str, str]] = [
    ("GET", r"/eth/v1/beacon/genesis", "r_genesis"),
    ("GET", r"/eth/v1/beacon/headers", "r_block_headers"),
    ("GET", r"/eth/v1/beacon/headers/(?P<block_id>[^/]+)", "r_block_header"),
    ("GET", r"/eth/v2/beacon/blocks/(?P<block_id>[^/]+)", "r_block_v2"),
    ("GET", r"/eth/v1/beacon/blocks/(?P<block_id>[^/]+)/root", "r_block_root"),
    ("GET", r"/eth/v1/beacon/blocks/(?P<block_id>[^/]+)/attestations", "r_block_attestations"),
    ("POST", r"/eth/v1/beacon/blocks", "r_publish_block"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/finality_checkpoints", "r_finality"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/fork", "r_fork"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/root", "r_state_root"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/committees", "r_committees"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/sync_committees", "r_sync_committees"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/validators", "r_validators"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/validators/(?P<validator_id>[^/]+)", "r_state_validator"),
    ("GET", r"/eth/v1/beacon/states/(?P<state_id>[^/]+)/validator_balances", "r_validator_balances"),
    ("GET", r"/eth/v1/beacon/pool/attestations", "r_get_pool_attestations"),
    ("POST", r"/eth/v1/beacon/pool/attestations", "r_pool_attestations"),
    ("GET", r"/eth/v1/beacon/pool/attester_slashings", "r_get_pool_attester_slashings"),
    ("POST", r"/eth/v1/beacon/pool/attester_slashings", "r_post_pool_attester_slashing"),
    ("GET", r"/eth/v1/beacon/pool/proposer_slashings", "r_get_pool_proposer_slashings"),
    ("POST", r"/eth/v1/beacon/pool/proposer_slashings", "r_post_pool_proposer_slashing"),
    ("GET", r"/eth/v1/beacon/pool/voluntary_exits", "r_get_pool_voluntary_exits"),
    ("POST", r"/eth/v1/beacon/pool/voluntary_exits", "r_post_pool_voluntary_exit"),
    ("GET", r"/eth/v1/beacon/pool/bls_to_execution_changes", "r_get_pool_bls_changes"),
    ("POST", r"/eth/v1/beacon/pool/bls_to_execution_changes", "r_post_pool_bls_change"),
    ("POST", r"/eth/v1/beacon/pool/sync_committees", "r_post_pool_sync_committees"),
    ("GET", r"/eth/v1/beacon/light_client/bootstrap/(?P<block_root>0x[0-9a-fA-F]+)", "r_lc_bootstrap"),
    ("GET", r"/eth/v1/beacon/light_client/updates", "r_lc_updates"),
    ("GET", r"/eth/v1/beacon/light_client/optimistic_update", "r_lc_optimistic"),
    ("GET", r"/eth/v1/beacon/light_client/finality_update", "r_lc_finality"),
    ("GET", r"/eth/v0/beacon/proof/state/(?P<state_id>[^/]+)", "r_state_proof"),
    ("GET", r"/eth/v1/validator/duties/proposer/(?P<epoch>\d+)", "r_proposer_duties"),
    ("POST", r"/eth/v1/validator/duties/attester/(?P<epoch>\d+)", "r_attester_duties"),
    ("POST", r"/eth/v1/validator/duties/sync/(?P<epoch>\d+)", "r_sync_duties"),
    ("GET", r"/eth/v2/validator/blocks/(?P<slot>\d+)", "r_produce_block"),
    ("GET", r"/eth/v1/validator/attestation_data", "r_attestation_data"),
    ("GET", r"/eth/v1/validator/aggregate_attestation", "r_aggregate_attestation"),
    ("POST", r"/eth/v1/validator/aggregate_and_proofs", "r_aggregate_and_proofs"),
    ("GET", r"/eth/v1/validator/sync_committee_contribution", "r_sync_contribution"),
    ("POST", r"/eth/v1/validator/contribution_and_proofs", "r_contribution_and_proofs"),
    ("POST", r"/eth/v1/validator/beacon_committee_subscriptions", "r_committee_subscriptions"),
    ("POST", r"/eth/v1/validator/sync_committee_subscriptions", "r_sync_subscriptions"),
    ("POST", r"/eth/v1/validator/prepare_beacon_proposer", "r_prepare_proposer"),
    ("POST", r"/eth/v1/validator/register_validator", "r_register_validator"),
    ("POST", r"/eth/v1/validator/liveness/(?P<epoch>\d+)", "r_liveness"),
    ("GET", r"/eth/v1/events", "r_events"),
    ("GET", r"/eth/v1/node/health", "r_health"),
    ("GET", r"/eth/v1/node/version", "r_version"),
    ("GET", r"/eth/v1/node/syncing", "r_syncing"),
    ("GET", r"/eth/v1/node/identity", "r_node_identity"),
    ("GET", r"/eth/v1/node/peers", "r_node_peers"),
    ("GET", r"/eth/v1/node/peers/(?P<peer_id>[^/]+)", "r_node_peer"),
    ("GET", r"/eth/v1/node/peer_count", "r_node_peer_count"),
    ("GET", r"/eth/v2/debug/beacon/states/(?P<state_id>[^/]+)", "r_debug_state"),
    ("GET", r"/eth/v1/debug/beacon/heads", "r_debug_heads"),
    ("GET", r"/eth/v2/debug/beacon/heads", "r_debug_heads"),
    ("GET", r"/eth/v0/debug/forkchoice", "r_debug_forkchoice"),
    ("GET", r"/eth/v0/debug/traces", "r_debug_traces_recent"),
    ("GET", r"/eth/v0/debug/traces/(?P<slot>\d+)", "r_debug_traces"),
    ("GET", r"/eth/v0/debug/launches", "r_debug_launches"),
    ("GET", r"/eth/v0/debug/slo", "r_debug_slo"),
    ("GET", r"/eth/v1/config/spec", "r_spec"),
    ("GET", r"/eth/v1/config/fork_schedule", "r_fork_schedule"),
    ("GET", r"/eth/v1/config/deposit_contract", "r_deposit_contract"),
]


class _Router:
    def __init__(self, api: BeaconApiImpl):
        self.api = api
        self.table = [
            (method, re.compile("^" + pattern + "$"), getattr(self, handler))
            for method, pattern, handler in ROUTES
        ]

    def dispatch(self, method: str, path: str, query: dict, body):
        for m, rx, fn in self.table:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                return fn(query=query, body=body, **match.groupdict())
        raise ApiError(404, f"route not found: {method} {path}")

    # handlers — translate path/query/body into impl calls
    def r_genesis(self, **kw):
        return self.api.get_genesis()

    def r_block_header(self, block_id, **kw):
        return self.api.get_block_header(block_id)

    def r_block_v2(self, block_id, **kw):
        return self.api.get_block_v2(block_id)

    def r_publish_block(self, body, **kw):
        return self.api.publish_block(body)

    def r_finality(self, state_id, **kw):
        return self.api.get_state_finality_checkpoints(state_id)

    def r_fork(self, state_id, **kw):
        return self.api.get_state_fork(state_id)

    def r_validators(self, state_id, **kw):
        return self.api.get_state_validators(state_id)

    def r_pool_attestations(self, body, **kw):
        return self.api.submit_pool_attestations(body)

    def r_proposer_duties(self, epoch, **kw):
        return self.api.get_proposer_duties(int(epoch))

    def r_attester_duties(self, epoch, body, **kw):
        return self.api.get_attester_duties(int(epoch), [int(i) for i in body])

    def r_produce_block(self, slot, query, **kw):
        reveal = query.get("randao_reveal")
        if not reveal:
            raise ApiError(400, "missing required parameter: randao_reveal")
        return self.api.produce_block_v2(int(slot), reveal, query.get("graffiti", ""))

    def r_attestation_data(self, query, **kw):
        return self.api.produce_attestation_data(
            int(query["slot"]), int(query["committee_index"])
        )

    def r_liveness(self, epoch, body, **kw):
        return self.api.get_validator_liveness(int(epoch), [int(i) for i in (body or [])])

    def r_events(self, query, **kw):
        topics = [t for t in (query.get("topics") or "").split(",") if t]
        return self.api.stream_events(topics)

    def r_health(self, **kw):
        return self.api.get_health()

    def r_version(self, **kw):
        return self.api.get_version()

    def r_syncing(self, **kw):
        return self.api.get_syncing_status()

    def r_debug_state(self, state_id, **kw):
        return self.api.get_debug_state_v2(state_id)

    def r_spec(self, **kw):
        return self.api.get_spec()

    # -- expanded surface (beacon/state, pools, node, lightclient, proof,
    # sync-committee validator flows, debug, config) --------------------------

    def r_block_headers(self, query, **kw):
        return self.api.get_block_headers(query)

    def r_block_root(self, block_id, **kw):
        return self.api.get_block_root(block_id)

    def r_block_attestations(self, block_id, **kw):
        return self.api.get_block_attestations(block_id)

    def r_state_root(self, state_id, **kw):
        return self.api.get_state_root(state_id)

    def r_committees(self, state_id, query, **kw):
        return self.api.get_epoch_committees(state_id, query)

    def r_sync_committees(self, state_id, query, **kw):
        return self.api.get_epoch_sync_committees(state_id, query)

    def r_state_validator(self, state_id, validator_id, **kw):
        return self.api.get_state_validator(state_id, validator_id)

    def r_validator_balances(self, state_id, query, **kw):
        return self.api.get_state_validator_balances(state_id, query)

    def r_get_pool_attestations(self, **kw):
        return self.api.get_pool_attestations()

    def r_get_pool_attester_slashings(self, **kw):
        return self.api.get_pool_attester_slashings()

    def r_post_pool_attester_slashing(self, body, **kw):
        return self.api.submit_pool_attester_slashing(body)

    def r_get_pool_proposer_slashings(self, **kw):
        return self.api.get_pool_proposer_slashings()

    def r_post_pool_proposer_slashing(self, body, **kw):
        return self.api.submit_pool_proposer_slashing(body)

    def r_get_pool_voluntary_exits(self, **kw):
        return self.api.get_pool_voluntary_exits()

    def r_post_pool_voluntary_exit(self, body, **kw):
        return self.api.submit_pool_voluntary_exit(body)

    def r_get_pool_bls_changes(self, **kw):
        return self.api.get_pool_bls_changes()

    def r_post_pool_bls_change(self, body, **kw):
        return self.api.submit_pool_bls_change(body)

    def r_post_pool_sync_committees(self, body, **kw):
        return self.api.submit_pool_sync_committees(body or [])

    def r_lc_bootstrap(self, block_root, **kw):
        return self.api.get_lc_bootstrap(block_root)

    def r_lc_updates(self, query, **kw):
        return self.api.get_lc_updates(query)

    def r_lc_optimistic(self, **kw):
        return self.api.get_lc_optimistic_update()

    def r_lc_finality(self, **kw):
        return self.api.get_lc_finality_update()

    def r_state_proof(self, state_id, query, **kw):
        return self.api.get_state_proof(state_id, query)

    def r_sync_duties(self, epoch, body, **kw):
        return self.api.get_sync_committee_duties(int(epoch), [int(i) for i in (body or [])])

    def r_aggregate_attestation(self, query, **kw):
        return self.api.get_aggregated_attestation(query)

    def r_aggregate_and_proofs(self, body, **kw):
        return self.api.publish_aggregate_and_proofs(body or [])

    def r_sync_contribution(self, query, **kw):
        return self.api.produce_sync_committee_contribution(query)

    def r_contribution_and_proofs(self, body, **kw):
        return self.api.publish_contribution_and_proofs(body or [])

    def r_committee_subscriptions(self, body, **kw):
        return self.api.prepare_beacon_committee_subnet(body or [])

    def r_sync_subscriptions(self, body, **kw):
        return self.api.prepare_sync_committee_subnets(body or [])

    def r_prepare_proposer(self, body, **kw):
        return self.api.prepare_beacon_proposer(body or [])

    def r_register_validator(self, body, **kw):
        return self.api.register_validator(body or [])

    def r_node_identity(self, **kw):
        return self.api.get_node_identity()

    def r_node_peers(self, query, **kw):
        return self.api.get_node_peers(query)

    def r_node_peer(self, peer_id, **kw):
        return self.api.get_node_peer(peer_id)

    def r_node_peer_count(self, **kw):
        return self.api.get_node_peer_count()

    def r_debug_heads(self, **kw):
        return self.api.get_debug_chain_heads()

    def r_debug_forkchoice(self, **kw):
        return self.api.get_fork_choice_nodes()

    def r_debug_traces(self, slot, query=None, **kw):
        return self.api.get_slot_traces(slot, fmt=(query or {}).get("format", "json"))

    def r_debug_traces_recent(self, query=None, **kw):
        raw = (query or {}).get("count", "16")
        try:
            count = int(raw)
        except ValueError:
            raise ApiError(400, f"count must be an integer, got {raw!r}") from None
        return self.api.get_recent_traces(count)

    def r_debug_launches(self, query=None, **kw):
        raw = (query or {}).get("count", "64")
        try:
            count = int(raw)
        except ValueError:
            raise ApiError(400, f"count must be an integer, got {raw!r}") from None
        return self.api.get_debug_launches(count, program=(query or {}).get("program"))

    def r_debug_slo(self, **kw):
        return self.api.get_debug_slo()

    def r_fork_schedule(self, **kw):
        return self.api.get_fork_schedule()

    def r_deposit_contract(self, **kw):
        return self.api.get_deposit_contract()


class RestServer:
    """Threaded stdlib HTTP server over any router exposing
    `dispatch(method, path, query, body)` (the Beacon API and the
    validator keymanager API share this host)."""

    def __init__(
        self,
        router,
        *,
        host: str = "127.0.0.1",
        port: int = 9596,
        auth_token: str | None = None,
    ):
        self.router = router
        self.host = host
        self.port = port
        # When set, every request must carry `Authorization: Bearer <token>`
        # (the keymanager API's api-token.txt scheme, reference
        # `keymanager/server/index.ts` bearer auth).
        self.auth_token = auth_token
        self._httpd = None
        self._thread: threading.Thread | None = None
        self._sse_streams: set = set()  # live EventStreams, closed on stop()
        self._closing = False

    def start(self) -> None:
        import http.server
        from urllib.parse import parse_qsl, urlsplit

        router = self.router
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _run(self, method):
                parts = urlsplit(self.path)
                query = dict(parse_qsl(parts.query))
                if outer.auth_token is not None:
                    import hmac

                    # compare as bytes: compare_digest raises TypeError on
                    # non-ASCII str (headers arrive latin-1 decoded)
                    presented = (self.headers.get("Authorization") or "").encode(
                        "utf-8", "surrogateescape"
                    )
                    expected = f"Bearer {outer.auth_token}".encode()
                    if not hmac.compare_digest(presented, expected):
                        payload = json.dumps(
                            {"code": 401, "message": "missing or invalid bearer token"}
                        ).encode()
                        self._reply(401, payload)
                        return
                try:
                    body = None
                    if method in ("POST", "DELETE"):
                        length = int(self.headers.get("Content-Length") or 0)
                        raw = self.rfile.read(length) if length else b""
                        try:
                            body = json.loads(raw) if raw else None
                        except json.JSONDecodeError as e:
                            raise ApiError(400, f"malformed JSON body: {e}") from e
                    out = router.dispatch(method, parts.path, query, body)
                except ApiError as e:
                    payload = json.dumps({"code": e.status, "message": e.message}).encode()
                    self._reply(e.status, payload)
                    return
                except Exception as e:  # internal error fail-safe
                    payload = json.dumps({"code": 500, "message": repr(e)}).encode()
                    self._reply(500, payload)
                    return
                if isinstance(out, int):  # health-style status-only
                    self.send_response(out)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if isinstance(out, EventStream):
                    self._stream_sse(out)
                    return
                self._reply(200, json.dumps(out).encode())

            def _stream_sse(self, stream):
                """Server-Sent Events: drain the stream's queue until the
                client disconnects or the server shuts down (None
                sentinel); periodic keepalive comments."""
                import queue as _queue

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                outer._sse_streams.add(stream)
                try:
                    while not outer._closing:
                        try:
                            item = stream.queue.get(timeout=10.0)
                        except _queue.Empty:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        if item is None:  # shutdown sentinel from stop()
                            break
                        event_type, payload = item
                        frame = (
                            f"event: {event_type}\ndata: {json.dumps(payload)}\n\n".encode()
                        )
                        self.wfile.write(frame)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away
                finally:
                    outer._sse_streams.discard(stream)
                    stream.close()

            def _reply(self, status, payload: bytes):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):  # noqa: N802
                self._run("GET")

            def do_POST(self):  # noqa: N802
                self._run("POST")

            def do_DELETE(self):  # noqa: N802
                self._run("DELETE")

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # unblock live SSE handlers: the closing flag covers handlers the
        # sentinel can't reach (race before _sse_streams.add, full queue)
        # within one keepalive interval; the sentinel covers the rest now
        self._closing = True
        for stream in list(self._sse_streams):
            stream.close()
            try:
                stream.queue.put_nowait(None)
            except Exception:
                pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class BeaconRestApiServer(RestServer):
    def __init__(self, api: BeaconApiImpl, *, host: str = "127.0.0.1", port: int = 9596):
        super().__init__(_Router(api), host=host, port=port)
