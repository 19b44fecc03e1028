"""KV controllers (reference `db/src/controller/level.ts` seam).

The reference binds LevelDB (C++) behind a narrow Db interface: get/put/
delete/batch/iterate-with-filters. Two implementations here:

* `MemoryDbController` — sorted in-memory store (tests, ephemeral nodes).
* `FileDbController` — persistent append-only WAL + in-memory index with
  startup replay and size-triggered compaction. Single-writer, crash-safe
  (partial tail records are discarded on replay): the durability model a
  beacon node needs without dragging in an external database. The
  interface stays narrow so a C++ LSM (or RocksDB binding) can slot in
  behind the same controller seam later, exactly as leveldown does in the
  reference.

Range iteration contract (`FilterOptions`): gte/gt/lte/lt bounds over raw
keys, lexicographic order (int ids are big-endian so numeric order
matches), reverse + limit.

The port of `lodestar_tpu.db.controller` (host Python and numpy, as there).
"""

from __future__ import annotations

import bisect
import os
import struct
from dataclasses import dataclass
from typing import Iterator

__all__ = ["FilterOptions", "DbController", "MemoryDbController", "FileDbController"]


@dataclass
class FilterOptions:
    gte: bytes | None = None
    gt: bytes | None = None
    lte: bytes | None = None
    lt: bytes | None = None
    reverse: bool = False
    limit: int | None = None


class DbController:
    """Narrow KV interface (reference `controller/interface.ts` Db)."""

    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def batch_put(self, items: list[tuple[bytes, bytes]]) -> None:
        for k, v in items:
            self.put(k, v)

    def batch_delete(self, keys: list[bytes]) -> None:
        for k in keys:
            self.delete(k)

    def keys_stream(self, opts: FilterOptions | None = None) -> Iterator[bytes]:
        raise NotImplementedError

    def entries_stream(self, opts: FilterOptions | None = None) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        return None


class MemoryDbController(DbController):
    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._keys: list[bytes] = []  # sorted

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            bisect.insort(self._keys, key)
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        if key in self._data:
            del self._data[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def _range(self, opts: FilterOptions | None) -> Iterator[bytes]:
        opts = opts or FilterOptions()
        lo = 0
        hi = len(self._keys)
        if opts.gte is not None:
            lo = bisect.bisect_left(self._keys, opts.gte)
        if opts.gt is not None:
            lo = max(lo, bisect.bisect_right(self._keys, opts.gt))
        if opts.lte is not None:
            hi = bisect.bisect_right(self._keys, opts.lte)
        if opts.lt is not None:
            hi = min(hi, bisect.bisect_left(self._keys, opts.lt))
        sel = self._keys[lo:hi]
        if opts.reverse:
            sel = sel[::-1]
        if opts.limit is not None:
            sel = sel[: opts.limit]
        return iter(sel)

    def keys_stream(self, opts: FilterOptions | None = None) -> Iterator[bytes]:
        return self._range(opts)

    def entries_stream(self, opts: FilterOptions | None = None) -> Iterator[tuple[bytes, bytes]]:
        for k in self._range(opts):
            yield k, self._data[k]


# WAL record: u8 op (0=put 1=del), u32 keylen, u32 vallen, key, value
_HDR = struct.Struct("<BII")


class FileDbController(MemoryDbController):
    """Memory index + append-only WAL. Replays (discarding any torn tail
    record) on open; compacts to a fresh log when garbage exceeds half the
    file past `compact_bytes`."""

    def __init__(self, path: str, *, compact_bytes: int = 64 * 1024 * 1024) -> None:
        super().__init__()
        self._path = path
        self._compact_bytes = compact_bytes
        self._garbage = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        with open(self._path, "rb") as f:
            data = f.read()
        pos, n = 0, len(data)
        valid_end = 0
        while pos + _HDR.size <= n:
            op, klen, vlen = _HDR.unpack_from(data, pos)
            rec_end = pos + _HDR.size + klen + vlen
            if op > 1 or rec_end > n:
                break  # torn/corrupt tail: stop at the last whole record
            key = data[pos + _HDR.size : pos + _HDR.size + klen]
            if op == 0:
                super().put(key, data[pos + _HDR.size + klen : rec_end])
            else:
                super().delete(key)
            pos = valid_end = rec_end
        if valid_end != n:
            with open(self._path, "r+b") as f:
                f.truncate(valid_end)

    def _append(self, op: int, key: bytes, value: bytes = b"") -> None:
        self._f.write(_HDR.pack(op, len(key), len(value)) + key + value)
        self._f.flush()

    def put(self, key: bytes, value: bytes) -> None:
        old = self.get(key)
        if old is not None:
            self._garbage += _HDR.size + len(key) + len(old)
        super().put(key, value)
        self._append(0, key, value)
        self._maybe_compact()

    def delete(self, key: bytes) -> None:
        old = self.get(key)
        if old is None:
            return
        self._garbage += 2 * (_HDR.size + len(key)) + len(old)
        super().delete(key)
        self._append(1, key)
        self._maybe_compact()

    def batch_put(self, items: list[tuple[bytes, bytes]]) -> None:
        chunks = []
        for k, v in items:
            old = self.get(k)
            if old is not None:
                self._garbage += _HDR.size + len(k) + len(old)
            MemoryDbController.put(self, k, v)
            chunks.append(_HDR.pack(0, len(k), len(v)) + k + v)
        self._f.write(b"".join(chunks))
        self._f.flush()
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        size = self._f.tell()
        if size < self._compact_bytes or self._garbage * 2 < size:
            return
        tmp = self._path + ".compact"
        with open(tmp, "wb") as f:
            for k in list(self._keys):
                v = self._data[k]
                f.write(_HDR.pack(0, len(k), len(v)) + k + v)
        self._f.close()
        os.replace(tmp, self._path)
        self._f = open(self._path, "ab")
        self._garbage = 0

    def close(self) -> None:
        self._f.close()
