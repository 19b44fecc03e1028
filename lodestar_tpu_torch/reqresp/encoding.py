"""ssz_snappy stream framing (reference
`reqresp/src/encodingStrategies/sszSnappy/`).

request  := varint(uncompressed ssz length) || snappy-frames(ssz)
resp-chunk := result_byte || varint(length) || snappy-frames(ssz)

The port of `lodestar_tpu.reqresp.encoding` (host Python, as there).
"""

from __future__ import annotations

import asyncio

from lodestar_tpu_torch.utils.snappy import decompress as _snappy_block_decompress
from lodestar_tpu_torch.utils.snappy import frame_compress
from lodestar_tpu_torch.utils.snappy import _masked_crc  # shared CRC32C masking
from lodestar_tpu_torch.utils.snappy import SnappyError

__all__ = [
    "write_request",
    "read_request",
    "write_response_chunk",
    "read_response_chunks",
    "EncodingError",
]

MAX_VARINT_BYTES = 10


class EncodingError(Exception):
    pass


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


async def _read_varint(reader: asyncio.StreamReader) -> int:
    out = 0
    for shift in range(0, 7 * MAX_VARINT_BYTES, 7):
        b = await reader.readexactly(1)
        out |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return out
    raise EncodingError("varint too long")


async def _read_snappy_frames(reader: asyncio.StreamReader, uncompressed_len: int) -> bytes:
    """Read snappy frame chunks until `uncompressed_len` bytes decoded.

    Incremental: each frame chunk decodes independently (O(n) total, not
    O(chunks^2)), and exact chunk counts are consumed so back-to-back
    response chunks on one stream never desync. Zero-length payloads
    still carry their stream id + one empty data chunk (what
    frame_compress emits), so they are consumed exactly too.
    """
    stream_id = await reader.readexactly(10)
    if not stream_id.startswith(b"\xff\x06\x00\x00sNaPpY"):
        raise EncodingError("missing snappy stream identifier")
    out = bytearray()
    need_data_chunk = True  # even a 0-length payload carries one chunk
    while len(out) < uncompressed_len or need_data_chunk:
        hdr = await reader.readexactly(4)
        ctype = hdr[0]
        length = int.from_bytes(hdr[1:4], "little")
        body = await reader.readexactly(length)
        if ctype in (0x00, 0x01):
            crc = int.from_bytes(body[:4], "little")
            chunk = _snappy_block_decompress(body[4:]) if ctype == 0x00 else body[4:]
            if _masked_crc(chunk) != crc:
                raise EncodingError("bad snappy chunk checksum")
            out += chunk
            need_data_chunk = False
        elif ctype == 0xFF or 0x80 <= ctype <= 0xFD:
            continue  # repeated stream id / skippable padding
        else:
            raise EncodingError(f"unskippable chunk type {ctype:#x}")
    if len(out) != uncompressed_len:
        raise EncodingError(f"length mismatch {len(out)} != {uncompressed_len}")
    return bytes(out)


async def write_request(writer: asyncio.StreamWriter, ssz_bytes: bytes) -> None:
    writer.write(_encode_varint(len(ssz_bytes)) + frame_compress(ssz_bytes))
    await writer.drain()


async def read_request(reader: asyncio.StreamReader, max_len: int = 2**22) -> bytes:
    n = await _read_varint(reader)
    if n > max_len:
        raise EncodingError(f"request too large: {n}")
    return await _read_snappy_frames(reader, n)


async def write_response_chunk(
    writer: asyncio.StreamWriter, status: int, ssz_bytes: bytes,
    context: bytes = b"",
) -> None:
    """One response chunk. `context` (e.g. a 4-byte fork digest) rides
    between the result byte and the length varint on SUCCESS chunks —
    reference encodingStrategies ContextBytes placement."""
    head = bytes([status]) + (context if status == 0 else b"")
    writer.write(head + _encode_varint(len(ssz_bytes)) + frame_compress(ssz_bytes))
    await writer.drain()


async def read_response_chunks(
    reader: asyncio.StreamReader, max_len: int = 2**22, context_len: int = 0
):
    """Async iterator of (status, context, payload) until EOF.
    `context_len` bytes are read after SUCCESS result bytes only
    (error chunks carry a bare message)."""
    while True:
        try:
            status_b = await reader.readexactly(1)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return
        context = b""
        if status_b[0] == 0 and context_len:
            context = await reader.readexactly(context_len)
        n = await _read_varint(reader)
        if n > max_len:
            raise EncodingError(f"response chunk too large: {n}")
        payload = await _read_snappy_frames(reader, n)
        yield status_b[0], context, payload
