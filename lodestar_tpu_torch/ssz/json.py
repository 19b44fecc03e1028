"""Eth2-flavoured JSON codecs for SSZ values.

The Beacon API wire format (reference types use `jsonCase: "eth2"` in
every ContainerType): snake_case field names, uints as decimal STRINGS,
byte vectors/lists as 0x-hex, bitfields as the 0x-hex of their SSZ
serialization. Generic over the same type objects the rest of the stack
uses, so every container in `lodestar_tpu_torch.types` is API-serializable for
free.

The port of `lodestar_tpu.ssz.json` (host Python, as there).
"""

from __future__ import annotations

from . import types as T

__all__ = ["to_json", "from_json"]


def to_json(typ, value):
    if isinstance(typ, T.Uint):
        return str(int(value))
    if isinstance(typ, T.Boolean):
        return bool(value)
    if isinstance(typ, (T.ByteVector, T.ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(typ, (T.Bitvector, T.Bitlist)):
        return "0x" + typ.serialize(value).hex()
    if isinstance(typ, (T.Vector, T.List)):
        return [to_json(typ.elem, v) for v in value]
    if isinstance(typ, T.Container):
        return {fname: to_json(ftype, getattr(value, fname)) for fname, ftype in typ.fields}
    raise TypeError(f"to_json: unsupported type {typ!r}")


def from_json(typ, data):
    if isinstance(typ, T.Uint):
        return int(data)
    if isinstance(typ, T.Boolean):
        if isinstance(data, str):
            return data == "true"
        return bool(data)
    if isinstance(typ, (T.ByteVector, T.ByteList)):
        return bytes.fromhex(data[2:] if data.startswith("0x") else data)
    if isinstance(typ, (T.Bitvector, T.Bitlist)):
        raw = bytes.fromhex(data[2:] if data.startswith("0x") else data)
        return typ.deserialize(raw)
    if isinstance(typ, (T.Vector, T.List)):
        return [from_json(typ.elem, v) for v in data]
    if isinstance(typ, T.Container):
        return T.ContainerValue(
            typ, **{fname: from_json(ftype, data[fname]) for fname, ftype in typ.fields}
        )
    raise TypeError(f"from_json: unsupported type {typ!r}")
