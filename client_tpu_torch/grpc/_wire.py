"""Schema-driven protobuf wire-format codec (proto3 semantics).

The GRPC protocol surface is implemented without generated stubs: messages
are plain Python dicts encoded/decoded against declarative field specs
(see ``_messages.py``). This keeps the framework free of a protoc build
step, makes the raw-tensor path (``raw_input_contents``) a zero-copy chunk
append, and sidesteps the protobuf-python object graph entirely.

Wire format notes (developers.google.com/protocol-buffers/docs/encoding):
- tag = (field_number << 3) | wire_type; wire types: 0 varint, 1 fixed64,
  2 length-delimited, 5 fixed32.
- proto3 scalars at their default value are not emitted.
- repeated numeric fields are packed (wire type 2) on encode; both packed
  and unpacked forms are accepted on decode.
- map<K,V> fields are repeated messages with key=1, value=2.
- int32/int64 negatives are 10-byte two's-complement varints.
- Unknown fields are skipped on decode (forward compatibility).

An own copy of ``client_tpu.grpc._wire``: the same bytes for the same dicts.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# varint primitives
# ---------------------------------------------------------------------------


def encode_varint(value: int, out: List[bytes]) -> None:
    if value < 0:
        value += 1 << 64
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(bytes((byte | 0x80,)))
        else:
            out.append(bytes((byte,)))
            return


def decode_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


# ---------------------------------------------------------------------------
# field specs
# ---------------------------------------------------------------------------

_VARINT_KINDS = frozenset(("int32", "int64", "uint32", "uint64", "bool", "enum"))
_WIRE_OF_KIND = {
    "double": 1,
    "float": 5,
    "string": 2,
    "bytes": 2,
    "message": 2,
}


class Field:
    __slots__ = ("name", "num", "kind", "repeated", "msg", "map_kv", "oneof")

    def __init__(
        self,
        name: str,
        num: int,
        kind: str,
        repeated: bool = False,
        msg: Optional["MessageSpec"] = None,
        map_kv: Optional[Tuple["Field", "Field"]] = None,
        oneof: Optional[str] = None,
    ):
        self.name = name
        self.num = num
        self.kind = kind  # scalar kind | 'message' | 'map'
        self.repeated = repeated
        self.msg = msg
        self.map_kv = map_kv
        self.oneof = oneof


class MessageSpec:
    """An ordered collection of Fields; encode/decode plain dicts against it."""

    def __init__(self, name: str, fields: Optional[List[Field]] = None):
        self.name = name
        self.fields: List[Field] = []
        self.by_num: Dict[int, Field] = {}
        self.by_name: Dict[str, Field] = {}
        for f in fields or []:
            self.add(f)

    def add(self, field: Field) -> "MessageSpec":
        self.fields.append(field)
        self.by_num[field.num] = field
        self.by_name[field.name] = field
        return self


# convenience constructors used by _messages.py
def scalar(name: str, num: int, kind: str, repeated: bool = False, oneof: str = None) -> Field:
    return Field(name, num, kind, repeated=repeated, oneof=oneof)


def message(name: str, num: int, spec: MessageSpec, repeated: bool = False, oneof: str = None) -> Field:
    return Field(name, num, "message", repeated=repeated, msg=spec, oneof=oneof)


def map_field(name: str, num: int, key_kind: str, value: Union[str, MessageSpec]) -> Field:
    if isinstance(value, MessageSpec):
        vfield = Field("value", 2, "message", msg=value)
    else:
        vfield = Field("value", 2, value)
    return Field(name, num, "map", map_kv=(Field("key", 1, key_kind), vfield))


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _encode_tag(num: int, wire_type: int, out: List[bytes]) -> None:
    encode_varint((num << 3) | wire_type, out)


def _encode_scalar(f: Field, value: Any, out: List[bytes]) -> None:
    kind = f.kind
    if kind in _VARINT_KINDS:
        _encode_tag(f.num, 0, out)
        encode_varint(int(value), out)
    elif kind == "double":
        _encode_tag(f.num, 1, out)
        out.append(struct.pack("<d", value))
    elif kind == "float":
        _encode_tag(f.num, 5, out)
        out.append(struct.pack("<f", value))
    elif kind == "string":
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        _encode_tag(f.num, 2, out)
        encode_varint(len(raw), out)
        out.append(raw)
    elif kind == "bytes":
        raw = value if isinstance(value, (bytes, memoryview, bytearray)) else bytes(value)
        _encode_tag(f.num, 2, out)
        encode_varint(len(raw), out)
        out.append(bytes(raw) if not isinstance(raw, bytes) else raw)
    else:
        raise ValueError(f"cannot encode scalar kind {kind}")


def _encode_packed(f: Field, values, out: List[bytes]) -> None:
    inner: List[bytes] = []
    for v in values:
        if f.kind in _VARINT_KINDS:
            encode_varint(int(v), inner)
        elif f.kind == "double":
            inner.append(struct.pack("<d", v))
        elif f.kind == "float":
            inner.append(struct.pack("<f", v))
        else:
            raise ValueError(f"kind {f.kind} is not packable")
    payload = b"".join(inner)
    _encode_tag(f.num, 2, out)
    encode_varint(len(payload), out)
    out.append(payload)


def encode_message(spec: MessageSpec, value: Dict[str, Any]) -> bytes:
    """Encode dict ``value`` against ``spec``; returns the serialized bytes."""
    out: List[bytes] = []
    for f in spec.fields:
        v = value.get(f.name)
        if v is None:
            continue
        if f.kind == "map":
            kf, vf = f.map_kv
            for mk, mv in v.items():
                entry: List[bytes] = []
                _encode_map_entry(kf, vf, mk, mv, entry)
                payload = b"".join(entry)
                _encode_tag(f.num, 2, out)
                encode_varint(len(payload), out)
                out.append(payload)
        elif f.kind == "message":
            items = v if f.repeated else [v]
            for item in items:
                payload = encode_message(f.msg, item)
                _encode_tag(f.num, 2, out)
                encode_varint(len(payload), out)
                out.append(payload)
        elif f.repeated:
            if not len(v):
                continue
            if f.kind in _VARINT_KINDS or f.kind in ("float", "double"):
                _encode_packed(f, v, out)
            else:
                for item in v:
                    _encode_scalar(f, item, out)
        else:
            # proto3: skip default values — except oneof members, which have
            # explicit presence and must serialize even at their default
            if f.oneof is None:
                if f.kind in _VARINT_KINDS and int(v) == 0:
                    continue
                if f.kind in ("float", "double") and float(v) == 0.0:
                    continue
                if f.kind in ("string", "bytes") and len(v) == 0:
                    continue
            _encode_scalar(f, v, out)
    return b"".join(out)


def _encode_map_entry(kf: Field, vf: Field, mk, mv, entry: List[bytes]) -> None:
    if isinstance(mk, str):
        if mk != "":
            _encode_scalar(kf, mk, entry)
    elif int(mk) != 0:
        _encode_scalar(kf, mk, entry)
    if vf.kind == "message":
        payload = encode_message(vf.msg, mv)
        _encode_tag(vf.num, 2, entry)
        encode_varint(len(payload), entry)
        entry.append(payload)
    else:
        if isinstance(mv, str):
            if mv != "":
                _encode_scalar(vf, mv, entry)
        elif isinstance(mv, (bytes, bytearray)):
            if len(mv):
                _encode_scalar(vf, mv, entry)
        elif isinstance(mv, float):
            if mv != 0.0:
                _encode_scalar(vf, mv, entry)
        elif int(mv) != 0:
            _encode_scalar(vf, mv, entry)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _skip_field(buf, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = decode_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        length, pos = decode_varint(buf, pos)
        pos += length
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        raise ValueError("truncated message")
    return pos


def _decode_scalar(f: Field, buf, pos: int, wire_type: int) -> Tuple[Any, int]:
    kind = f.kind
    if wire_type == 0:
        raw, pos = decode_varint(buf, pos)
        if kind in ("int32", "int64"):
            return _signed(raw), pos
        if kind == "bool":
            return bool(raw), pos
        return raw, pos
    if wire_type == 1:
        if pos + 8 > len(buf):
            raise ValueError("truncated fixed64 field")
        val = struct.unpack_from("<d", buf, pos)[0]
        return val, pos + 8
    if wire_type == 5:
        if pos + 4 > len(buf):
            raise ValueError("truncated fixed32 field")
        val = struct.unpack_from("<f", buf, pos)[0]
        return val, pos + 4
    if wire_type == 2:
        length, pos = decode_varint(buf, pos)
        if pos + length > len(buf):
            raise ValueError("truncated length-delimited field")
        raw = bytes(buf[pos : pos + length])
        pos += length
        if kind == "string":
            return raw.decode("utf-8"), pos
        return raw, pos
    raise ValueError(f"unsupported wire type {wire_type} for {kind}")


def decode_message(spec: MessageSpec, buf) -> Dict[str, Any]:
    """Decode ``buf`` into a plain dict according to ``spec``.

    Repeated fields decode to lists, maps to dicts, sub-messages to dicts.
    Absent proto3 scalars keep their implicit defaults *out* of the dict.
    """
    if isinstance(buf, (bytes, bytearray)):
        buf = memoryview(buf)
    result: Dict[str, Any] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = decode_varint(buf, pos)
        num, wire_type = tag >> 3, tag & 0x7
        f = spec.by_num.get(num)
        if f is None:
            pos = _skip_field(buf, pos, wire_type)
            continue
        if f.kind == "map":
            length, pos = decode_varint(buf, pos)
            if pos + length > n:
                raise ValueError("truncated map entry")
            entry = buf[pos : pos + length]
            pos += length
            k, v = _decode_map_entry(f, entry)
            result.setdefault(f.name, {})[k] = v
        elif f.kind == "message":
            length, pos = decode_varint(buf, pos)
            if pos + length > n:
                raise ValueError("truncated sub-message")
            sub = decode_message(f.msg, buf[pos : pos + length])
            pos += length
            if f.repeated:
                result.setdefault(f.name, []).append(sub)
            else:
                result[f.name] = sub
        elif f.repeated:
            if wire_type == 2 and f.kind in _VARINT_KINDS | {"float", "double"}:
                # packed
                length, pos = decode_varint(buf, pos)
                end = pos + length
                if end > n:
                    raise ValueError("truncated packed field")
                vals = result.setdefault(f.name, [])
                while pos < end:
                    if f.kind == "double":
                        if pos + 8 > end:
                            raise ValueError("truncated packed field")
                        vals.append(struct.unpack_from("<d", buf, pos)[0])
                        pos += 8
                    elif f.kind == "float":
                        if pos + 4 > end:
                            raise ValueError("truncated packed field")
                        vals.append(struct.unpack_from("<f", buf, pos)[0])
                        pos += 4
                    else:
                        raw, pos = decode_varint(buf, pos)
                        if f.kind in ("int32", "int64"):
                            raw = _signed(raw)
                        elif f.kind == "bool":
                            raw = bool(raw)
                        vals.append(raw)
            else:
                val, pos = _decode_scalar(f, buf, pos, wire_type)
                result.setdefault(f.name, []).append(val)
        else:
            val, pos = _decode_scalar(f, buf, pos, wire_type)
            result[f.name] = val
    return result


def _decode_map_entry(f: Field, entry) -> Tuple[Any, Any]:
    kf, vf = f.map_kv
    key: Any = "" if kf.kind == "string" else 0
    value: Any = None
    pos = 0
    n = len(entry)
    while pos < n:
        tag, pos = decode_varint(entry, pos)
        num, wire_type = tag >> 3, tag & 0x7
        if num == 1:
            key, pos = _decode_scalar(kf, entry, pos, wire_type)
        elif num == 2:
            if vf.kind == "message":
                length, pos = decode_varint(entry, pos)
                if pos + length > n:
                    raise ValueError("truncated map value")
                value = decode_message(vf.msg, entry[pos : pos + length])
                pos += length
            else:
                value, pos = _decode_scalar(vf, entry, pos, wire_type)
        else:
            pos = _skip_field(entry, pos, wire_type)
    if value is None:
        if vf.kind == "message":
            value = {}
        elif vf.kind == "string":
            value = ""
        elif vf.kind == "bytes":
            value = b""
        elif vf.kind in ("float", "double"):
            value = 0.0
        elif vf.kind == "bool":
            value = False
        else:
            value = 0
    return key, value
