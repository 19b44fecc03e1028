"""multistream-select/1.0.0 — protocol negotiation over a message channel.

Every libp2p layer boundary (raw TCP -> security, security -> muxer,
muxed stream -> application protocol) negotiates with multistream-select:
varint-length-prefixed lines ending in '\\n'; the dialer proposes, the
listener echoes to accept or answers "na".

The port of `lodestar_tpu.network.transport.multistream` (host Python, as there).
"""

from __future__ import annotations

__all__ = ["encode_ms", "decode_ms", "MS_PROTO", "NA"]

MS_PROTO = "/multistream/1.0.0"
NA = "na"


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def encode_ms(line: str) -> bytes:
    data = line.encode() + b"\n"
    return _varint(len(data)) + data


def decode_ms(buf: bytes, pos: int = 0) -> tuple[str, int]:
    """-> (line, new_pos). Raises IndexError on truncation."""
    ln = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        ln |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    line = buf[pos : pos + ln]
    if len(line) != ln:
        raise IndexError("truncated multistream line")
    return line.rstrip(b"\n").decode(), pos + ln


class NegotiationError(ConnectionError):
    """The remote refused the proposed protocol (multistream 'na')."""


async def negotiate_out(send, recv, protocol: str) -> bytes:
    """Dialer side over a frame channel: propose `protocol`, expect echo.

    Returns any bytes received past the negotiation lines (a pipelining
    peer's next-layer data) so the caller can feed them to that layer
    instead of losing them."""
    await send(encode_ms(MS_PROTO) + encode_ms(protocol))
    buf = b""
    seen = []
    while len(seen) < 2:
        buf += await recv()
        try:
            while len(seen) < 2:
                line, pos = decode_ms(buf)
                buf = buf[pos:]
                seen.append(line)
        except IndexError:
            continue
    if seen[0] != MS_PROTO or seen[1] != protocol:
        raise NegotiationError(f"multistream negotiation failed: {seen}")
    return buf


async def negotiate_in(send, recv, supported) -> tuple[str, bytes]:
    """Listener side: accept the first supported proposal, 'na' others.
    Returns (protocol, leftover-bytes) — see negotiate_out."""
    await send(encode_ms(MS_PROTO))
    buf = b""
    while True:
        buf += await recv()
        try:
            while True:
                line, pos = decode_ms(buf)
                buf = buf[pos:]
                if line == MS_PROTO:
                    continue
                if line in supported:
                    await send(encode_ms(line))
                    return line, buf
                await send(encode_ms(NA))
        except IndexError:
            continue
