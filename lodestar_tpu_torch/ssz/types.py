"""SSZ type system: serialization, deserialization, hash_tree_root.

Replacement for `@chainsafe/ssz` (reference
`packages/types/src/sszTypes.ts` and the ssz package it binds): declarative
type objects with `serialize` / `deserialize` / `hash_tree_root` /
`default()`. Values are plain Python (ints, bytes, lists, Container
instances) — tree-backed incremental views are a separate optimization
layered on top (ssz.tree), matching how the reference splits ssz (schemas)
from persistent-merkle-tree (incremental hashing).

Merkleization follows the consensus-specs SSZ spec exactly:
pack → merkleize(limit) → mix_in_length for lists/bitlists.
"""

from __future__ import annotations

import io
from typing import Any, Sequence

import numpy as np

from .merkle import merkleize, mix_in_length, pack_bytes

OFFSET_SIZE = 4
_BYTES_PER_CHUNK = 32


class SSZType:
    """Base interface for all SSZ type descriptors."""

    def is_fixed_size(self) -> bool:
        raise NotImplementedError

    def fixed_size(self) -> int:
        """Serialized byte length for fixed-size types."""
        raise NotImplementedError

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError

    # equality of type descriptors (useful in tests/config caching)
    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items(), key=lambda kv: kv[0]))))


class Uint(SSZType):
    def __init__(self, byte_len: int):
        if byte_len not in (1, 2, 4, 8, 16, 32):
            raise ValueError("invalid uint size")
        self.byte_len = byte_len

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.byte_len

    def serialize(self, value: int) -> bytes:
        return int(value).to_bytes(self.byte_len, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.byte_len:
            raise ValueError(f"uint{self.byte_len * 8}: expected {self.byte_len} bytes, got {len(data)}")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value: int) -> bytes:
        return self.serialize(value).ljust(_BYTES_PER_CHUNK, b"\x00")

    def default(self) -> int:
        return 0


class Boolean(SSZType):
    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return 1

    def serialize(self, value: bool) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x01":
            return True
        if data == b"\x00":
            return False
        raise ValueError("invalid boolean encoding")

    def hash_tree_root(self, value: bool) -> bytes:
        return self.serialize(value).ljust(_BYTES_PER_CHUNK, b"\x00")

    def default(self) -> bool:
        return False


uint8 = Uint(1)
uint16 = Uint(2)
uint32 = Uint(4)
uint64 = Uint(8)
uint128 = Uint(16)
uint256 = Uint(32)
boolean = Boolean()


class ByteVector(SSZType):
    """Fixed-length opaque bytes (Bytes4/20/32/48/96 in the spec)."""

    def __init__(self, length: int):
        self.length = length

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return self.length

    def serialize(self, value: bytes) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)} bytes")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return self.serialize(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length


class ByteList(SSZType):
    """Variable-length opaque bytes with a max length (e.g. graffiti-free data)."""

    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: bytes) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: got {len(value)} bytes")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        if len(data) > self.limit:
            raise ValueError(f"ByteList[{self.limit}]: got {len(data)} bytes")
        return bytes(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        limit_chunks = (self.limit + _BYTES_PER_CHUNK - 1) // _BYTES_PER_CHUNK
        root = merkleize(pack_bytes(bytes(value)), limit=max(limit_chunks, 1))
        return mix_in_length(root, len(value))

    def default(self) -> bytes:
        return b""


Bytes4 = ByteVector(4)
Bytes20 = ByteVector(20)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


def _is_basic(t: SSZType) -> bool:
    return isinstance(t, (Uint, Boolean))


class Vector(SSZType):
    def __init__(self, elem: SSZType, length: int):
        if length <= 0:
            raise ValueError("vector length must be positive")
        self.elem = elem
        self.length = length

    def is_fixed_size(self) -> bool:
        return self.elem.is_fixed_size()

    def fixed_size(self) -> int:
        return self.elem.fixed_size() * self.length

    def serialize(self, value: Sequence) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Vector[{self.length}]: got {len(value)} elements")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        return _deserialize_homogeneous(self.elem, data, exact_count=self.length)

    def hash_tree_root(self, value: Sequence) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Vector[{self.length}]: got {len(value)} elements")
        if _is_basic(self.elem):
            return merkleize(pack_bytes(b"".join(self.elem.serialize(v) for v in value)))
        roots = b"".join(self.elem.hash_tree_root(v) for v in value)
        return merkleize(roots)

    def default(self):
        return [self.elem.default() for _ in range(self.length)]


class List(SSZType):
    def __init__(self, elem: SSZType, limit: int):
        self.elem = elem
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: Sequence) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"List[{self.limit}]: got {len(value)} elements")
        return _serialize_homogeneous(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_homogeneous(self.elem, data, exact_count=None)
        if len(out) > self.limit:
            raise ValueError(f"List[{self.limit}]: got {len(out)} elements")
        return out

    def hash_tree_root(self, value: Sequence) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"List[{self.limit}]: got {len(value)} elements")
        if _is_basic(self.elem):
            from .batch import pack_basic_chunks  # local import avoids cycle

            elem_size = self.elem.fixed_size()
            limit_chunks = (self.limit * elem_size + _BYTES_PER_CHUNK - 1) // _BYTES_PER_CHUNK
            root = merkleize(pack_basic_chunks(self.elem, value), limit=max(limit_chunks, 1))
        else:
            roots = None
            if isinstance(self.elem, Container) and len(value) >= 64:
                # vectorized batch rooter (device-batched hash levels) for
                # big homogeneous lists — the validators hot path
                from .batch import batch_container_roots

                roots_arr = batch_container_roots(self.elem, value)
                if roots_arr is not None:
                    roots = roots_arr.tobytes()
            if roots is None:
                roots = b"".join(self.elem.hash_tree_root(v) for v in value)
            root = merkleize(roots, limit=max(self.limit, 1))
        return mix_in_length(root, len(value))

    def default(self):
        return []


class Bitvector(SSZType):
    def __init__(self, length: int):
        if length <= 0:
            raise ValueError("bitvector length must be positive")
        self.length = length

    def is_fixed_size(self) -> bool:
        return True

    def fixed_size(self) -> int:
        return (self.length + 7) // 8

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"Bitvector[{self.length}]: got {len(value)} bits")
        return _bits_to_bytes(value)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size():
            raise ValueError("bitvector byte length mismatch")
        all_bits = _bytes_to_bits(data, len(data) * 8)
        if any(all_bits[self.length :]):
            raise ValueError("bitvector has set padding bits")
        return all_bits[: self.length]

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        return merkleize(pack_bytes(self.serialize(value)))

    def default(self):
        return [False] * self.length


class Bitlist(SSZType):
    def __init__(self, limit: int):
        self.limit = limit

    def is_fixed_size(self) -> bool:
        return False

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: got {len(value)} bits")
        # delimiter bit marks the length
        bits = list(value) + [True]
        return _bits_to_bytes(bits)

    def deserialize(self, data: bytes):
        if not data:
            raise ValueError("bitlist cannot be empty (needs delimiter)")
        if data[-1] == 0:
            raise ValueError("bitlist missing delimiter bit")
        all_bits = _bytes_to_bits(data, len(data) * 8)
        # find the delimiter: highest set bit
        last = max(i for i, b in enumerate(all_bits) if b)
        bits = all_bits[:last]
        if len(bits) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: got {len(bits)} bits")
        return bits

    def hash_tree_root(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError(f"Bitlist[{self.limit}]: got {len(value)} bits")
        limit_chunks = ((self.limit + 7) // 8 + _BYTES_PER_CHUNK - 1) // _BYTES_PER_CHUNK
        root = merkleize(pack_bytes(_bits_to_bytes(value)), limit=max(limit_chunks, 1))
        return mix_in_length(root, len(value))

    def default(self):
        return []


class Container(SSZType):
    """Declarative container type; values are `ContainerValue` instances."""

    def __init__(self, name: str, fields: Sequence[tuple[str, SSZType]]):
        if not fields:
            raise ValueError("container must have at least one field")
        self.name = name
        self.fields = tuple(fields)
        self._field_names = tuple(n for n, _ in fields)

    def is_fixed_size(self) -> bool:
        return all(t.is_fixed_size() for _, t in self.fields)

    def fixed_size(self) -> int:
        return sum(t.fixed_size() for _, t in self.fields)

    def serialize(self, value) -> bytes:
        fixed_parts: list[bytes | None] = []
        variable_parts: list[bytes] = []
        for fname, ftype in self.fields:
            v = getattr(value, fname)
            if ftype.is_fixed_size():
                fixed_parts.append(ftype.serialize(v))
            else:
                fixed_parts.append(None)
                variable_parts.append(ftype.serialize(v))
        fixed_len = sum(len(p) if p is not None else OFFSET_SIZE for p in fixed_parts)
        out = io.BytesIO()
        offset = fixed_len
        vi = 0
        for p in fixed_parts:
            if p is not None:
                out.write(p)
            else:
                out.write(offset.to_bytes(OFFSET_SIZE, "little"))
                offset += len(variable_parts[vi])
                vi += 1
        for p in variable_parts:
            out.write(p)
        return out.getvalue()

    def deserialize(self, data: bytes):
        values: dict[str, Any] = {}
        # first pass: fixed fields + offsets
        pos = 0
        offsets: list[tuple[str, SSZType, int]] = []
        for fname, ftype in self.fields:
            if ftype.is_fixed_size():
                size = ftype.fixed_size()
                values[fname] = ftype.deserialize(data[pos : pos + size])
                pos += size
            else:
                off = int.from_bytes(data[pos : pos + OFFSET_SIZE], "little")
                offsets.append((fname, ftype, off))
                pos += OFFSET_SIZE
        if offsets and offsets[0][2] != pos:
            raise ValueError("first offset does not match fixed-part size")
        for i, (fname, ftype, off) in enumerate(offsets):
            end = offsets[i + 1][2] if i + 1 < len(offsets) else len(data)
            if end < off:
                raise ValueError("offsets out of order")
            values[fname] = ftype.deserialize(data[off:end])
        if not offsets and pos != len(data):
            raise ValueError("trailing bytes after fixed-size container")
        return ContainerValue(self, **values)

    def hash_tree_root(self, value) -> bytes:
        roots = b"".join(ftype.hash_tree_root(getattr(value, fname)) for fname, ftype in self.fields)
        return merkleize(roots)

    def default(self):
        return ContainerValue(self, **{n: t.default() for n, t in self.fields})

    def field_index(self, fname: str) -> int:
        return self._field_names.index(fname)

    def __repr__(self):
        return f"Container({self.name})"


class ContainerValue:
    """A concrete container instance: attribute access, equality, repr."""

    __slots__ = ("_type", "__dict__")

    def __init__(self, ctype: Container, **kwargs):
        object.__setattr__(self, "_type", ctype)
        missing = set(ctype._field_names) - set(kwargs)
        extra = set(kwargs) - set(ctype._field_names)
        if missing or extra:
            raise ValueError(f"{ctype.name}: missing={sorted(missing)} extra={sorted(extra)}")
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def type(self) -> Container:
        return self._type

    def copy(self) -> "ContainerValue":
        """Recursive copy: nested containers and lists are copied all the
        way down, so mutating a copy can never alias the original (the
        state-transition clones pre-states before applying blocks —
        reference ssz ViewDU .clone() semantics)."""

        def cp(v):
            if isinstance(v, ContainerValue):
                return v.copy()
            if isinstance(v, list):
                return [cp(x) for x in v]
            return v

        return ContainerValue(
            self._type, **{n: cp(getattr(self, n)) for n in self._type._field_names}
        )

    def __eq__(self, other):
        return (
            isinstance(other, ContainerValue)
            and self._type is other._type
            and all(getattr(self, n) == getattr(other, n) for n in self._type._field_names)
        )

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._type._field_names[:4])
        more = "..." if len(self._type.fields) > 4 else ""
        return f"{self._type.name}({inner}{more})"


# --- helpers ----------------------------------------------------------------


def _serialize_homogeneous(elem: SSZType, value: Sequence) -> bytes:
    if elem.is_fixed_size():
        return b"".join(elem.serialize(v) for v in value)
    parts = [elem.serialize(v) for v in value]
    offset = OFFSET_SIZE * len(parts)
    out = io.BytesIO()
    for p in parts:
        out.write(offset.to_bytes(OFFSET_SIZE, "little"))
        offset += len(p)
    for p in parts:
        out.write(p)
    return out.getvalue()


def _deserialize_homogeneous(elem: SSZType, data: bytes, exact_count: int | None):
    if elem.is_fixed_size():
        size = elem.fixed_size()
        if len(data) % size:
            raise ValueError("byte length not a multiple of element size")
        count = len(data) // size
        if exact_count is not None and count != exact_count:
            raise ValueError(f"expected {exact_count} elements, got {count}")
        return [elem.deserialize(data[i * size : (i + 1) * size]) for i in range(count)]
    if not data:
        if exact_count not in (None, 0):
            raise ValueError(f"expected {exact_count} elements, got 0")
        return []
    first_off = int.from_bytes(data[:OFFSET_SIZE], "little")
    # bounds before use: first_off drives the allocation count, so an
    # attacker-controlled value must not exceed the actual payload, be
    # misaligned, or be zero (zero would make non-empty data decode as [],
    # breaking encoding injectivity)
    if first_off % OFFSET_SIZE or first_off == 0 or first_off > len(data):
        raise ValueError("invalid first offset")
    count = first_off // OFFSET_SIZE
    if exact_count is not None and count != exact_count:
        raise ValueError(f"expected {exact_count} elements, got {count}")
    offs = [int.from_bytes(data[i * OFFSET_SIZE : (i + 1) * OFFSET_SIZE], "little") for i in range(count)]
    offs.append(len(data))
    out = []
    for i in range(count):
        if offs[i + 1] < offs[i] or offs[i + 1] > len(data):
            raise ValueError("offsets out of order")
        out.append(elem.deserialize(data[offs[i] : offs[i + 1]]))
    return out


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    if not bits:
        return b""
    arr = np.zeros(((len(bits) + 7) // 8) * 8, dtype=np.uint8)
    arr[: len(bits)] = [1 if b else 0 for b in bits]
    return np.packbits(arr, bitorder="little").tobytes()


def _bytes_to_bits(data: bytes, count: int) -> list[bool]:
    arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
    return [bool(b) for b in arr[:count]]
