"""Libp2pHost: the composed swarm (reference `network/nodejs/bundle.ts`
createNodeJsLibp2p — TCP transport + noise security + mplex muxing +
multistream-select, with per-protocol stream handlers).

Upgrade pipeline for every connection, both directions:

    TCP  --multistream-->  /noise  --XX handshake-->
    secured channel  --multistream-->  /mplex/6.7.0  -->  muxed streams

Each muxed stream then negotiates its application protocol
(/eth2/beacon_chain/req/..., /meshsub/1.1.0) with multistream-select and
is handed to the registered handler. `new_stream(peer, proto)` is the
dial surface the ReqResp engine and gossipsub ride.

The port of `lodestar_tpu.network.transport.host` (host Python, as there).
"""

from __future__ import annotations

import asyncio

from lodestar_tpu_torch.logger import get_logger

from .identity import Identity
from .mplex import Mplex, MplexStream
from .multistream import negotiate_in, negotiate_out
from .noise import NoiseError, noise_handshake

__all__ = ["Libp2pHost", "Stream", "PeerConnection"]

NOISE_PROTO = "/noise"
MPLEX_PROTO = "/mplex/6.7.0"

Stream = MplexStream


class _PushbackReader:
    """StreamReader facade serving pushed-back bytes first (pipelined
    data that arrived interleaved with a multistream negotiation)."""

    def __init__(self, reader, pending: bytes):
        self._reader = reader
        self._pending = bytearray(pending)

    async def readexactly(self, n: int) -> bytes:
        if self._pending:
            take = bytes(self._pending[:n])
            del self._pending[:n]
            if len(take) == n:
                return take
            return take + await self._reader.readexactly(n - len(take))
        return await self._reader.readexactly(n)

    async def read(self, n: int = -1) -> bytes:
        if self._pending:
            if n < 0 or n >= len(self._pending):
                out = bytes(self._pending)
                self._pending.clear()
            else:
                out = bytes(self._pending[:n])
                del self._pending[:n]
            return out
        return await self._reader.read(n)


class PeerConnection:
    """One upgraded connection to a peer (noise channel + mplex mux)."""

    def __init__(self, host: "Libp2pHost", peer_id: str, mux: Mplex, addr):
        self.host = host
        self.peer_id = peer_id
        self.mux = mux
        self.addr = addr  # (ip, port) we can redial

    def close(self) -> None:
        self.mux.close()


class Libp2pHost:
    def __init__(self, identity: Identity | None = None, *, listen_port: int = 0):
        self.identity = identity or Identity()
        self.peer_id = self.identity.peer_id
        self.listen_port = listen_port
        self.handlers: dict[str, object] = {}  # proto id -> async fn(stream, peer_id)
        self.connections: dict[str, PeerConnection] = {}
        self.on_peer_connect = None  # async fn(peer_id)
        self.on_peer_disconnect = None  # async fn(peer_id)
        self._server: asyncio.AbstractServer | None = None
        self.log = get_logger(name="lodestar.network.host")

    # -- lifecycle -------------------------------------------------------------

    async def listen(self, host: str = "127.0.0.1", port: int | None = None) -> int:
        self._server = await asyncio.start_server(
            self._on_inbound, host, self.listen_port if port is None else port
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        return self.listen_port

    async def close(self) -> None:
        # connections first: on Python 3.12+ Server.wait_closed blocks
        # until every accepted transport is gone
        for conn in list(self.connections.values()):
            conn.close()
        self.connections.clear()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5.0)
            except (Exception, asyncio.TimeoutError):
                pass

    def set_handler(self, protocol_id: str, handler) -> None:
        """handler: async (stream, peer_id) -> None."""
        self.handlers[protocol_id] = handler

    # -- upgrade pipeline ------------------------------------------------------

    @staticmethod
    def _raw_channel(reader, writer):
        async def send(data: bytes) -> None:
            writer.write(data)
            await writer.drain()

        async def recv() -> bytes:
            data = await reader.read(4096)
            if not data:
                raise ConnectionResetError("connection closed during negotiation")
            return data

        return send, recv

    async def _upgrade(
        self, reader, writer, *, initiator: bool, expected_peer: str | None, addr
    ) -> PeerConnection:
        send, recv = self._raw_channel(reader, writer)
        if initiator:
            leftover = await negotiate_out(send, recv, NOISE_PROTO)
        else:
            _, leftover = await negotiate_in(send, recv, {NOISE_PROTO})
        if leftover:
            # a pipelining peer's first noise bytes arrived with the
            # negotiation lines — push them back in front of the reader
            reader = _PushbackReader(reader, leftover)
        conn = await noise_handshake(
            reader, writer, self.identity, initiator=initiator, expected_peer=expected_peer
        )

        async def sec_send(data: bytes) -> None:
            await conn.write_msg(data)

        async def sec_recv() -> bytes:
            return await conn.read_msg()

        if initiator:
            leftover = await negotiate_out(sec_send, sec_recv, MPLEX_PROTO)
        else:
            _, leftover = await negotiate_in(sec_send, sec_recv, {MPLEX_PROTO})

        mux = Mplex(
            conn,
            is_initiator=initiator,
            on_stream=self._on_remote_stream,
            initial_buf=leftover,
        )
        pc = PeerConnection(self, conn.remote_peer, mux, addr)
        old = self.connections.get(conn.remote_peer)
        if old is not None:
            old.close()
        self.connections[conn.remote_peer] = pc
        mux.start()
        # tear-down notification when the pump dies
        asyncio.ensure_future(self._watch(pc))
        if self.on_peer_connect is not None:
            asyncio.ensure_future(self.on_peer_connect(conn.remote_peer))
        return pc

    async def _watch(self, pc: PeerConnection) -> None:
        task = pc.mux._pump_task
        if task is not None:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        if self.connections.get(pc.peer_id) is pc:
            del self.connections[pc.peer_id]
            if self.on_peer_disconnect is not None:
                try:
                    await self.on_peer_disconnect(pc.peer_id)
                except Exception:
                    pass

    async def _on_inbound(self, reader, writer) -> None:
        try:
            peername = writer.get_extra_info("peername")
            await asyncio.wait_for(
                self._upgrade(
                    reader, writer, initiator=False, expected_peer=None, addr=peername
                ),
                timeout=10.0,
            )
        except (NoiseError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            self.log.debug(f"inbound upgrade failed: {e}")
            try:
                writer.close()
            except Exception:
                pass

    async def _on_remote_stream(self, stream: MplexStream) -> None:
        """Negotiate the app protocol on a remotely-opened stream, then
        hand it to the registered handler."""

        async def send(data: bytes) -> None:
            stream.write(data)
            await stream.drain()

        async def recv() -> bytes:
            data = await stream.read()
            if not data:
                raise ConnectionResetError("stream closed during negotiation")
            return data

        try:
            proto, leftover = await asyncio.wait_for(
                negotiate_in(send, recv, set(self.handlers)), timeout=10.0
            )
        except (ConnectionError, OSError, asyncio.TimeoutError):
            stream.reset()
            return
        if leftover:  # pipelined app bytes: put them back at the front
            stream._buf[0:0] = leftover
        stream.protocol = proto
        peer_id = self._peer_of(stream)
        handler = self.handlers[proto]
        try:
            await handler(stream, peer_id)
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            stream.reset()
        except Exception as e:
            self.log.warn(f"handler error on {proto}: {e!r}")
            stream.reset()

    def _peer_of(self, stream: MplexStream) -> str:
        for pid, pc in self.connections.items():
            if pc.mux is stream._mux:
                return pid
        return "?"

    # -- dial surface ----------------------------------------------------------

    async def connect(
        self, host: str, port: int, expected_peer: str | None = None
    ) -> PeerConnection:
        """Dial, upgrade, register. Reuses a live connection to the same
        peer when one exists."""
        if expected_peer is not None and expected_peer in self.connections:
            return self.connections[expected_peer]
        reader, writer = await asyncio.open_connection(host, port)
        return await asyncio.wait_for(
            self._upgrade(
                reader, writer, initiator=True, expected_peer=expected_peer,
                addr=(host, port),
            ),
            timeout=10.0,
        )

    async def new_stream(self, peer_id: str, protocol_id: str) -> MplexStream:
        """Open a muxed stream to a connected peer and negotiate the
        protocol."""
        pc = self.connections.get(peer_id)
        if pc is None:
            raise ConnectionError(f"not connected to {peer_id}")
        stream = pc.mux.open_stream()

        async def send(data: bytes) -> None:
            stream.write(data)
            await stream.drain()

        async def recv() -> bytes:
            data = await stream.read()
            if not data:
                raise ConnectionResetError("stream closed during negotiation")
            return data

        try:
            leftover = await asyncio.wait_for(
                negotiate_out(send, recv, protocol_id), timeout=10.0
            )
        except BaseException:
            # a refused/failed negotiation must not leak the substream —
            # V2-first dialing makes 'na' an expected per-request event
            stream.reset()
            raise
        if leftover:  # pipelined response bytes: back to the front
            stream._buf[0:0] = leftover
        stream.protocol = protocol_id
        return stream

    def peers(self) -> list[str]:
        return list(self.connections)
