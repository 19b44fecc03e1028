"""ReqResp engine: typed request/response over negotiated streams.

Reference `reqresp/src/ReqResp.ts:47`: the server side registers handlers
per protocol id and enforces rate limits; the client side opens a stream
(via an injected dial function), writes one request, and collects typed
response chunks. Stream negotiation here is a single length-prefixed
protocol-id line — the multistream-select stand-in for the asyncio
transport (the framing above it is byte-identical eth2 ssz_snappy).

The port of `lodestar_tpu.reqresp.reqresp` (host Python, as there).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Awaitable, Callable

from .encoding import read_request, read_response_chunks, write_request, write_response_chunk
from .protocols import CONTEXT_FORK_DIGEST, Protocol, protocol_by_id
from .rate_limiter import RateLimiter, RateLimiterQuota

__all__ = ["ReqResp", "RespStatus", "ReqRespError", "ResponseError"]


class RespStatus:
    SUCCESS = 0
    INVALID_REQUEST = 1
    SERVER_ERROR = 2
    RESOURCE_UNAVAILABLE = 3
    RATE_LIMITED = 139  # lodestar-specific code used for downscoring


class ReqRespError(Exception):
    pass


class ResponseError(ReqRespError):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"response status {status}: {message}")
        self.status = status


Handler = Callable[[object, str], AsyncIterator[object]]


class ReqResp:
    """Both halves of the protocol engine; transport injected."""

    def __init__(
        self,
        *,
        default_quota: RateLimiterQuota = RateLimiterQuota(50, 10.0),
        request_timeout_sec: float = 10.0,
    ) -> None:
        self._handlers: dict[str, Handler] = {}
        self._limiters: dict[str, RateLimiter] = {}
        self._default_quota = default_quota
        self._timeout = request_timeout_sec
        self._streams_served = 0
        # optional ReqRespMetrics (set by the node wiring); None = no-op
        self.metrics = None
        # fork-context resolvers (set_fork_context) for ForkDigest protocols
        self._fork_to_digest: Callable[[str], bytes] | None = None
        self._digest_to_fork: Callable[[bytes], str | None] | None = None

    def set_fork_context(
        self,
        fork_to_digest: Callable[[str], bytes],
        digest_to_fork: Callable[[bytes], str | None],
    ) -> None:
        """Install the fork digest mappings that ForkDigest-context
        protocols (blocks V2, blobs, light-client) resolve chunk types
        with (reference `ContextBytesType.ForkDigest`,
        `beacon-node/src/network/reqresp/protocols.ts:41`)."""
        self._fork_to_digest = fork_to_digest
        self._digest_to_fork = digest_to_fork

    # -- server side ----------------------------------------------------------

    def register_handler(
        self, protocol_id: str, handler: Handler, quota: RateLimiterQuota | None = None
    ) -> None:
        protocol_by_id(protocol_id)  # unknown protocol = programming error
        self._handlers[protocol_id] = handler
        self._limiters[protocol_id] = RateLimiter(quota or self._default_quota)

    async def handle_stream(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, peer_id: str = "?"
    ) -> None:
        """Serve one negotiated stream: read protocol id line, then the
        request, stream back chunks."""
        try:
            pid_len = int.from_bytes(await reader.readexactly(2), "big")
            protocol_id = (await reader.readexactly(pid_len)).decode()
            handler = self._handlers.get(protocol_id)
            if handler is None:
                await write_response_chunk(writer, RespStatus.INVALID_REQUEST, b"")
                return
            if self.metrics is not None:
                self.metrics.requests_received.labels(protocol=protocol_id).inc()
            limiter = self._limiters[protocol_id]
            if not limiter.allows(peer_id):
                if self.metrics is not None:
                    self.metrics.rate_limited.labels(protocol=protocol_id).inc()
                await write_response_chunk(writer, RespStatus.RATE_LIMITED, b"")
                return
            # bound per-peer bucket growth from untrusted peer-id churn
            self._streams_served += 1
            if self._streams_served % 1024 == 0:
                for lim in self._limiters.values():
                    lim.prune()
            proto = protocol_by_id(protocol_id)
            request = None
            if proto.request_type is not None:
                try:
                    raw = await asyncio.wait_for(read_request(reader), self._timeout)
                    request = proto.request_type().deserialize(raw)
                except Exception as e:  # malformed/slow request: tell the peer
                    await write_response_chunk(
                        writer, RespStatus.INVALID_REQUEST, repr(e).encode()[:256]
                    )
                    return
            count = 0
            fork_ctx = proto.context == CONTEXT_FORK_DIGEST
            try:
                async for item in handler(request, peer_id):
                    if count >= proto.max_response_chunks:
                        break
                    if fork_ctx:
                        # ForkDigest protocols: handlers yield (fork, item)
                        fork, item = item
                        if self._fork_to_digest is None:
                            raise ReqRespError("fork context not configured")
                        context = self._fork_to_digest(fork)
                        payload = proto.resolve_response_type(fork).serialize(item)
                    else:
                        context = b""
                        payload = proto.response_type().serialize(item)
                    await write_response_chunk(
                        writer, RespStatus.SUCCESS, payload, context=context
                    )
                    count += 1
            except ReqRespError as e:
                if self.metrics is not None:
                    self.metrics.request_errors.labels(protocol=protocol_id).inc()
                await write_response_chunk(writer, RespStatus.INVALID_REQUEST, str(e).encode()[:256])
            except Exception:
                if self.metrics is not None:
                    self.metrics.request_errors.labels(protocol=protocol_id).inc()
                await write_response_chunk(writer, RespStatus.SERVER_ERROR, b"")
            else:
                if self.metrics is not None:
                    self.metrics.response_chunks_sent.labels(protocol=protocol_id).inc(count)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass  # peer hung up mid-negotiation; nothing to answer
        finally:
            try:
                writer.write_eof()
                await writer.drain()
            except (ConnectionResetError, OSError):
                pass

    # -- client side ----------------------------------------------------------

    async def send_request(
        self,
        dial: Callable[[], Awaitable[tuple[asyncio.StreamReader, asyncio.StreamWriter]]],
        protocol_id: str,
        request,
        max_chunks: int | None = None,
    ) -> list:
        """Open a stream via `dial`, send `request`, return decoded chunks.
        Dial and the full response are bounded by request_timeout_sec each
        (TTFB/RESP timeouts in the reference) so a dead peer can never
        hang the caller."""
        proto = protocol_by_id(protocol_id)
        if self.metrics is not None:
            self.metrics.requests_sent.labels(protocol=protocol_id).inc()
        try:
            reader, writer = await asyncio.wait_for(dial(), self._timeout)
        except asyncio.TimeoutError:
            if self.metrics is not None:
                self.metrics.dial_timeouts.inc()
            raise
        try:
            pid = protocol_id.encode()
            writer.write(len(pid).to_bytes(2, "big") + pid)
            if proto.request_type is not None:
                await write_request(writer, proto.request_type().serialize(request))
            try:
                writer.write_eof()
            except (AttributeError, OSError):
                pass

            fork_ctx = proto.context == CONTEXT_FORK_DIGEST
            ctx_len = 4 if fork_ctx else 0

            async def collect() -> list:
                out = []
                limit = max_chunks if max_chunks is not None else proto.max_response_chunks
                async for status, context, payload in read_response_chunks(
                    reader, context_len=ctx_len
                ):
                    if status != RespStatus.SUCCESS:
                        raise ResponseError(status, payload.decode(errors="replace"))
                    if fork_ctx and self._digest_to_fork is not None:
                        fork = self._digest_to_fork(context)
                        if fork is None:
                            raise ReqRespError(
                                f"unknown fork digest {context.hex()}"
                            )
                        typ = proto.resolve_response_type(fork)
                    elif fork_ctx and not proto.fork_invariant:
                        # decoding a fork-variant chunk without a digest
                        # mapping would silently mis-deserialize: fail loud
                        raise ReqRespError(
                            "fork context not configured for "
                            f"{protocol_id}"
                        )
                    else:
                        typ = proto.response_type()
                    out.append(typ.deserialize(payload))
                    if len(out) >= limit:
                        break
                return out

            return await asyncio.wait_for(collect(), self._timeout)
        finally:
            writer.close()
    # one request per stream, as the spec demands
