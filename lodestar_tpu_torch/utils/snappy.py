"""Snappy block + frame codecs, pure Python.

The reference's wire stack compresses every gossip message and reqresp
chunk with snappy (`snappyjs` / `@chainsafe/snappy-stream`;
`reqresp/encodingStrategies/sszSnappy/`). The image has no snappy
binding, so this implements the format from Google's public spec:

* block format (decompress: full tag set incl. 1/2/4-byte copies;
  compress: greedy hash-table matcher, same structure as the C++
  reference's fast path)
* framing format (stream identifier, compressed/uncompressed chunks,
  masked CRC32C) used by reqresp streams.

Wire-compatible with real snappy in both directions.

The port of `lodestar_tpu.utils.snappy` (host Python, as there).
"""

from __future__ import annotations

import struct

__all__ = [
    "compress",
    "decompress",
    "frame_compress",
    "frame_decompress",
    "crc32c",
    "SnappyError",
]


class SnappyError(Exception):
    pass


# --- varint -------------------------------------------------------------------


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# --- block format -------------------------------------------------------------


def decompress(data: bytes) -> bytes:
    expected_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n:
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0b111) + 4
            if pos >= n:
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("invalid copy offset")
        # overlapping copies are byte-by-byte semantics
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected_len:
        raise SnappyError(f"length mismatch: {len(out)} != {expected_len}")
    return bytes(out)


def _emit_literal(out: bytearray, lit: bytes) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out.append(n)
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += lit


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # prefer 2-byte-offset copies (lengths 1..64); 1-byte form for small
    while length > 0:
        this_len = min(64, length)
        if this_len < 4:
            # copy-2 supports lengths 1..64 so always usable
            pass
        if 4 <= this_len <= 11 and offset < 2048:
            out.append(0b01 | ((this_len - 4) << 2) | ((offset >> 8) << 5))
            out.append(offset & 0xFF)
        elif offset < (1 << 16):
            out.append(0b10 | ((this_len - 1) << 2))
            out += offset.to_bytes(2, "little")
        else:
            out.append(0b11 | ((this_len - 1) << 2))
            out += offset.to_bytes(4, "little")
        length -= this_len


def compress(data: bytes) -> bytes:
    out = bytearray(_write_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    if n < 16:
        _emit_literal(out, data)
        return bytes(out)

    table: dict[bytes, int] = {}
    pos = 0
    lit_start = 0
    while pos + 4 <= n:
        key = data[pos : pos + 4]
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand < (1 << 16):
            # extend the match
            length = 4
            while pos + length < n and data[cand + length] == data[pos + length] and length < 64:
                length += 1
            if lit_start < pos:
                _emit_literal(out, data[lit_start:pos])
            _emit_copy(out, pos - cand, length)
            pos += length
            lit_start = pos
        else:
            pos += 1
    if lit_start < n:
        _emit_literal(out, data[lit_start:])
    return bytes(out)


# --- CRC32C (Castagnoli) ------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) & 0xFFFFFFFF


# --- framing format -----------------------------------------------------------

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MAX_UNCOMPRESSED_CHUNK = 65536


def frame_compress(data: bytes) -> bytes:
    out = bytearray(_STREAM_ID)
    offsets = range(0, len(data), _MAX_UNCOMPRESSED_CHUNK) if data else [0]
    for i in offsets:
        chunk = data[i : i + _MAX_UNCOMPRESSED_CHUNK]
        crc = _masked_crc(chunk)
        comp = compress(chunk)
        if len(comp) < len(chunk):
            body = struct.pack("<I", crc) + comp
            out += b"\x00" + len(body).to_bytes(3, "little") + body
        else:
            body = struct.pack("<I", crc) + chunk
            out += b"\x01" + len(body).to_bytes(3, "little") + body
    return bytes(out)


def frame_decompress(data: bytes) -> bytes:
    pos = 0
    out = bytearray()
    if not data.startswith(_STREAM_ID):
        raise SnappyError("missing stream identifier")
    pos = len(_STREAM_ID)
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise SnappyError("truncated chunk header")
        ctype = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + length > n:
            raise SnappyError("truncated chunk body")
        body = data[pos : pos + length]
        pos += length
        if ctype == 0x00:  # compressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = decompress(body[4:])
            if _masked_crc(chunk) != crc:
                raise SnappyError("bad chunk checksum")
            out += chunk
        elif ctype == 0x01:  # uncompressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = body[4:]
            if _masked_crc(chunk) != crc:
                raise SnappyError("bad chunk checksum")
            out += chunk
        elif ctype == 0xFF:  # repeated stream id
            continue
        elif 0x80 <= ctype <= 0xFD:  # skippable padding
            continue
        else:
            raise SnappyError(f"unskippable unknown chunk type {ctype:#x}")
    return bytes(out)
