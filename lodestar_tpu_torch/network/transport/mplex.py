"""/mplex/6.7.0 stream multiplexer over the noise channel.

Many logical streams (reqresp requests, the gossipsub channel) share one
secured TCP connection. Frame format (libp2p mplex spec):

    <header varint> <length varint> <data>
    header = (stream_id << 3) | flag

Flags: NewStream=0, MessageReceiver=1, MessageInitiator=2,
CloseReceiver=3, CloseInitiator=4, ResetReceiver=5, ResetInitiator=6.
"Initiator" flags are sent by the side that opened the stream.

Streams expose an asyncio Stream-like (read/readexactly/write/drain/
close/write_eof) surface so the existing ReqResp engine runs over them
unchanged.

The port of `lodestar_tpu.network.transport.mplex` (host Python, as there).
"""

from __future__ import annotations

import asyncio

__all__ = ["Mplex", "MplexStream", "MplexError"]

NEW_STREAM = 0
MSG_RECEIVER = 1
MSG_INITIATOR = 2
CLOSE_RECEIVER = 3
CLOSE_INITIATOR = 4
RESET_RECEIVER = 5
RESET_INITIATOR = 6

_MAX_BUFFERED = 8 * 1024 * 1024  # per-stream inbound cap (reset on abuse)
_MAX_FRAME = 1 * 1024 * 1024  # max declared frame length (protocol violation above)


class MplexError(Exception):
    pass


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


class MplexStream:
    """One logical stream; duck-types the asyncio Stream pair."""

    def __init__(self, mux: "Mplex", sid: int, initiator: bool):
        self._mux = mux
        self.sid = sid
        self.initiator = initiator
        self._buf = bytearray()
        self._eof = False
        self._reset = False
        self._wclosed = False
        self._wakeup = asyncio.Event()
        self.protocol: str | None = None

    # -- reader surface --------------------------------------------------------

    async def read(self, n: int = -1) -> bytes:
        while not self._buf and not self._eof and not self._reset:
            self._wakeup.clear()
            await self._wakeup.wait()
        if self._reset:
            raise ConnectionResetError("mplex stream reset")
        if n < 0 or n >= len(self._buf):
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            if self._reset:
                raise ConnectionResetError("mplex stream reset")
            if self._eof:
                raise asyncio.IncompleteReadError(bytes(self._buf), n)
            self._wakeup.clear()
            await self._wakeup.wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def at_eof(self) -> bool:
        return self._eof and not self._buf

    # -- writer surface --------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self._wclosed or self._reset:
            raise ConnectionResetError("mplex stream closed for writing")
        flag = MSG_INITIATOR if self.initiator else MSG_RECEIVER
        self._mux._send_frame(self.sid, flag, bytes(data))

    async def drain(self) -> None:
        await self._mux._drain()

    def write_eof(self) -> None:
        if self._wclosed:
            return
        self._wclosed = True
        flag = CLOSE_INITIATOR if self.initiator else CLOSE_RECEIVER
        self._mux._send_frame(self.sid, flag, b"")

    def close(self) -> None:
        """Half-close our side; the stream dies fully when both close."""
        try:
            self.write_eof()
        except ConnectionResetError:
            pass

    def reset(self) -> None:
        if not self._reset:
            self._reset = True
            flag = RESET_INITIATOR if self.initiator else RESET_RECEIVER
            try:
                self._mux._send_frame(self.sid, flag, b"")
            except Exception:
                pass
            self._wakeup.set()

    # -- mux-side delivery -----------------------------------------------------

    def _on_data(self, data: bytes) -> None:
        if len(self._buf) + len(data) > _MAX_BUFFERED:
            self.reset()
            return
        self._buf.extend(data)
        self._wakeup.set()

    def _on_close(self) -> None:
        self._eof = True
        self._wakeup.set()

    def _on_reset(self) -> None:
        self._reset = True
        self._eof = True
        self._wakeup.set()


class Mplex:
    """Frame pump over a NoiseConnection; dispatches to streams.

    `on_stream(stream)` fires for every remotely-opened stream (the host
    runs protocol negotiation on it).
    """

    def __init__(self, conn, *, is_initiator: bool, on_stream=None, initial_buf: bytes = b""):
        self._conn = conn
        self._initiator = is_initiator
        self._on_stream = on_stream
        # odd/even id split avoids collisions without coordination
        self._next_id = 1 if is_initiator else 2
        self._streams: dict[tuple[int, bool], MplexStream] = {}
        self._outbox: list[bytes] = []
        self._closed = False
        self._pump_task: asyncio.Task | None = None
        self._flush_lock = asyncio.Lock()
        # frames that arrived pipelined with the muxer negotiation
        self._initial_buf = initial_buf

    def start(self) -> None:
        self._pump_task = asyncio.ensure_future(self._pump())

    def open_stream(self) -> MplexStream:
        sid = self._next_id
        self._next_id += 2
        st = MplexStream(self, sid, initiator=True)
        self._streams[(sid, True)] = st
        self._send_frame(sid, NEW_STREAM, str(sid).encode())
        return st

    # -- frame IO --------------------------------------------------------------

    def _send_frame(self, sid: int, flag: int, data: bytes) -> None:
        if self._closed:
            raise ConnectionResetError("mplex connection closed")
        self._outbox.append(_varint(sid << 3 | flag) + _varint(len(data)) + data)
        # sync writers (write/write_eof/reset) never await: schedule a
        # flush so frames can't sit queued while the pump blocks on read
        try:
            asyncio.get_running_loop()
            asyncio.ensure_future(self._flush_soon())
        except RuntimeError:
            pass

    async def _flush_soon(self) -> None:
        try:
            await self._drain()
        except Exception:
            pass

    async def _drain(self) -> None:
        async with self._flush_lock:
            batch, self._outbox = self._outbox, []
            if batch:
                await self._conn.write_msg(b"".join(batch))

    async def _pump(self) -> None:
        buf = self._initial_buf
        self._initial_buf = b""
        try:
            if buf:
                buf = self._dispatch(buf)
            while True:
                # flush anything queued synchronously before blocking
                await self._drain()
                chunk = await self._conn.read_msg()
                buf += chunk
                buf = self._dispatch(buf)
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            ConnectionError,
            OSError,
        ):
            pass
        except Exception:
            pass
        finally:
            self._closed = True
            # close the underlying socket so the peer (and, on Python
            # 3.12+, Server.wait_closed) observes the teardown
            self._conn.close()
            for st in list(self._streams.values()):
                st._on_reset()

    def _dispatch(self, buf: bytes) -> bytes:
        pos = 0
        n = len(buf)
        while True:
            start = pos
            try:
                header, pos = self._rv(buf, pos, n)
                ln, pos = self._rv(buf, pos, n)
                if ln > _MAX_FRAME:
                    # a declared length beyond the cap would make this
                    # reassembly buffer grow without bound — protocol
                    # violation, kill the connection
                    raise MplexError(f"oversized mplex frame: {ln}")
                if pos + ln > n:
                    raise IndexError
                data = buf[pos : pos + ln]
                pos += ln
            except IndexError:
                return buf[start:]
            sid, flag = header >> 3, header & 7
            self._on_frame(sid, flag, data)

    @staticmethod
    def _rv(buf: bytes, pos: int, n: int) -> tuple[int, int]:
        out = shift = 0
        while True:
            if pos >= n:
                raise IndexError
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, pos
            shift += 7

    def _on_frame(self, sid: int, flag: int, data: bytes) -> None:
        if flag == NEW_STREAM:
            old = self._streams.get((sid, False))
            if old is not None:
                old._on_reset()  # sid reuse: wake/kill the orphaned stream
            st = MplexStream(self, sid, initiator=False)
            self._streams[(sid, False)] = st
            if self._on_stream is not None:
                asyncio.ensure_future(self._on_stream(st))
            return
        # frames from the remote INITIATOR target our receiver-side entry
        # (initiator=False locally) and vice versa
        from_initiator = flag in (MSG_INITIATOR, CLOSE_INITIATOR, RESET_INITIATOR)
        st = self._streams.get((sid, not from_initiator))
        if st is None:
            return
        if flag in (MSG_INITIATOR, MSG_RECEIVER):
            st._on_data(data)
        elif flag in (CLOSE_INITIATOR, CLOSE_RECEIVER):
            st._on_close()
        elif flag in (RESET_INITIATOR, RESET_RECEIVER):
            st._on_reset()

    def close(self) -> None:
        self._closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
        self._conn.close()
        for st in list(self._streams.values()):
            st._on_reset()
