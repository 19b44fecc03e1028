"""Typed Repository over bucket-prefixed KV (reference
`db/src/abstractRepository.ts:19`): SSZ (de)serialization at the edges,
id = hash_tree_root by default, batch ops, range iteration by id.

The port of `lodestar_tpu.db.repository` (host Python and numpy, as there).
"""

from __future__ import annotations

from typing import Generic, Iterator, TypeVar

from lodestar_tpu_torch import ssz

from .controller import DbController, FilterOptions
from .schema import BUCKET_LENGTH, Bucket, encode_key

__all__ = ["Repository"]

T = TypeVar("T")
Id = bytes | str | int


class Repository(Generic[T]):
    def __init__(self, db: DbController, bucket: Bucket, type_: ssz.SSZType) -> None:
        self.db = db
        self.bucket = bucket
        self.type = type_
        self._min_key = encode_key(bucket, b"")
        self._max_key = int(bucket + 1).to_bytes(BUCKET_LENGTH, "little")

    # -- codecs ---------------------------------------------------------------

    def encode_value(self, value: T) -> bytes:
        return self.type.serialize(value)

    def decode_value(self, data: bytes) -> T:
        return self.type.deserialize(data)

    def encode_key(self, id_: Id) -> bytes:
        return encode_key(self.bucket, id_)

    def get_id(self, value: T) -> bytes:
        """Default id = hash_tree_root (override for slot-indexed repos)."""
        return self.type.hash_tree_root(value)

    # -- single ops -----------------------------------------------------------

    def get(self, id_: Id) -> T | None:
        data = self.db.get(self.encode_key(id_))
        return None if data is None else self.decode_value(data)

    def get_binary(self, id_: Id) -> bytes | None:
        return self.db.get(self.encode_key(id_))

    def has(self, id_: Id) -> bool:
        return self.db.get(self.encode_key(id_)) is not None

    def put(self, id_: Id, value: T) -> None:
        self.db.put(self.encode_key(id_), self.encode_value(value))

    def put_binary(self, id_: Id, data: bytes) -> None:
        self.db.put(self.encode_key(id_), data)

    def delete(self, id_: Id) -> None:
        self.db.delete(self.encode_key(id_))

    def add(self, value: T) -> None:
        self.put(self.get_id(value), value)

    def remove(self, value: T) -> None:
        self.delete(self.get_id(value))

    # -- batch ops ------------------------------------------------------------

    def batch_put(self, items: list[tuple[Id, T]]) -> None:
        self.db.batch_put(
            [(self.encode_key(k), self.encode_value(v)) for k, v in items]
        )

    def batch_delete(self, ids: list[Id]) -> None:
        self.db.batch_delete([self.encode_key(i) for i in ids])

    def batch_add(self, values: list[T]) -> None:
        self.batch_put([(self.get_id(v), v) for v in values])

    # -- iteration ------------------------------------------------------------

    def _bucket_opts(
        self,
        gte: Id | None = None,
        lt: Id | None = None,
        reverse: bool = False,
        limit: int | None = None,
    ) -> FilterOptions:
        return FilterOptions(
            gte=self.encode_key(gte) if gte is not None else self._min_key,
            lt=self.encode_key(lt) if lt is not None else self._max_key,
            reverse=reverse,
            limit=limit,
        )

    def keys(self, **kw) -> list[bytes]:
        return [k[BUCKET_LENGTH:] for k in self.db.keys_stream(self._bucket_opts(**kw))]

    def values(self, **kw) -> list[T]:
        return [self.decode_value(v) for _, v in self.db.entries_stream(self._bucket_opts(**kw))]

    def entries(self, **kw) -> Iterator[tuple[bytes, T]]:
        for k, v in self.db.entries_stream(self._bucket_opts(**kw)):
            yield k[BUCKET_LENGTH:], self.decode_value(v)

    def first_value(self) -> T | None:
        for _, v in self.db.entries_stream(self._bucket_opts(limit=1)):
            return self.decode_value(v)
        return None

    def last_value(self) -> T | None:
        for _, v in self.db.entries_stream(self._bucket_opts(reverse=True, limit=1)):
            return self.decode_value(v)
        return None
