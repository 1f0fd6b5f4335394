"""Minimal ONNX protobuf wire codec (decode + encode), zero dependencies
(the port's own copy of singa_tpu/sonnx/proto.py, unchanged below this
docstring).

The reference SINGA's `sonnx` leans on the `onnx` package for ModelProto
parsing; this codec covers exactly the ONNX message subset the importer
and exporter need, in pure Python. The protobuf wire format is a stream
of (field_number << 3 | wire_type) keys with varint / 64-bit /
length-delimited / 32-bit payloads; the schemas below mirror
onnx/onnx.proto's field numbers.

Messages decode to `PB` namespace objects (attribute access, repeated
fields are lists). `decode_model(buf)` / `encode_model(pb)` are the public
entry points. The same `PB` tree encodes to the same bytes here as in
the reference.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "PB",
    "decode_model",
    "encode_model",
    "decode",
    "encode",
    "TensorDataType",
    "AttrType",
]


class TensorDataType:
    """onnx.TensorProto.DataType enum values."""

    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13
    BFLOAT16 = 16


class AttrType:
    """onnx.AttributeProto.AttributeType enum values."""

    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10


# ---------------------------------------------------------------------------
# schemas: {field_number: (name, kind, repeated)}
# kind: "int" | "float" | "double" | "bytes" | "string" | "msg:<Name>"
# ---------------------------------------------------------------------------

SCHEMAS: Dict[str, Dict[int, Tuple[str, str, bool]]] = {
    "ModelProto": {
        1: ("ir_version", "int", False),
        2: ("producer_name", "string", False),
        3: ("producer_version", "string", False),
        4: ("domain", "string", False),
        5: ("model_version", "int", False),
        6: ("doc_string", "string", False),
        7: ("graph", "msg:GraphProto", False),
        8: ("opset_import", "msg:OperatorSetIdProto", True),
    },
    "OperatorSetIdProto": {
        1: ("domain", "string", False),
        2: ("version", "int", False),
    },
    "GraphProto": {
        1: ("node", "msg:NodeProto", True),
        2: ("name", "string", False),
        5: ("initializer", "msg:TensorProto", True),
        10: ("doc_string", "string", False),
        11: ("input", "msg:ValueInfoProto", True),
        12: ("output", "msg:ValueInfoProto", True),
        13: ("value_info", "msg:ValueInfoProto", True),
    },
    "NodeProto": {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", "msg:AttributeProto", True),
        6: ("doc_string", "string", False),
        7: ("domain", "string", False),
    },
    "AttributeProto": {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int", False),
        4: ("s", "bytes", False),
        5: ("t", "msg:TensorProto", False),
        6: ("g", "msg:GraphProto", False),
        7: ("floats", "float", True),
        8: ("ints", "int", True),
        9: ("strings", "bytes", True),
        10: ("tensors", "msg:TensorProto", True),
        11: ("graphs", "msg:GraphProto", True),
        20: ("type", "int", False),
    },
    "TensorProto": {
        1: ("dims", "int", True),
        2: ("data_type", "int", False),
        4: ("float_data", "float", True),
        5: ("int32_data", "int", True),
        6: ("string_data", "bytes", True),
        7: ("int64_data", "int", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        10: ("double_data", "double", True),
        11: ("uint64_data", "int", True),
    },
    "ValueInfoProto": {
        1: ("name", "string", False),
        2: ("type", "msg:TypeProto", False),
        3: ("doc_string", "string", False),
    },
    "TypeProto": {
        1: ("tensor_type", "msg:TypeProtoTensor", False),
    },
    "TypeProtoTensor": {
        1: ("elem_type", "int", False),
        2: ("shape", "msg:TensorShapeProto", False),
    },
    "TensorShapeProto": {
        1: ("dim", "msg:TensorShapeDim", True),
    },
    "TensorShapeDim": {
        1: ("dim_value", "int", False),
        2: ("dim_param", "string", False),
    },
}

_SCALAR_DEFAULT = {"int": 0, "float": 0.0, "double": 0.0,
                   "bytes": b"", "string": ""}


class PB:
    """Decoded protobuf message: attribute access with schema defaults."""

    def __init__(self, schema: str, **kw: Any):
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_d", {})
        for k, v in kw.items():
            setattr(self, k, v)

    def __getattr__(self, name: str):
        d = object.__getattribute__(self, "_d")
        if name in d:
            return d[name]
        schema = object.__getattribute__(self, "_schema")
        for fname, kind, repeated in SCHEMAS[schema].values():
            if fname == name:
                if repeated:
                    d[name] = []
                    return d[name]
                if kind.startswith("msg:"):
                    return None
                return _SCALAR_DEFAULT[kind]
        raise AttributeError(f"{schema}.{name}")

    def __setattr__(self, name: str, value: Any):
        object.__getattribute__(self, "_d")[name] = value

    def HasField(self, name: str) -> bool:
        return name in object.__getattribute__(self, "_d")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        d = object.__getattribute__(self, "_d")
        return f"PB<{self._schema}>({', '.join(d)})"


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def decode(buf: bytes, schema: str) -> PB:
    fields = SCHEMAS[schema]
    msg = PB(schema)
    d = object.__getattribute__(msg, "_d")
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field_no, wire = key >> 3, key & 7
        spec = fields.get(field_no)
        # read payload
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            payload: Any = val
        elif wire == 1:
            payload = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            payload = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            payload = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if spec is None:
            continue  # unknown field: skip
        name, kind, repeated = spec

        def _scalar(payload: Any, kind: str, wire: int) -> Any:
            if kind == "int":
                return _to_signed64(payload)
            if kind == "float":
                return struct.unpack("<f", payload)[0]
            if kind == "double":
                return struct.unpack("<d", payload)[0]
            if kind == "string":
                return payload.decode("utf-8", errors="replace")
            if kind == "bytes":
                return bytes(payload)
            raise ValueError(kind)

        if kind.startswith("msg:"):
            value = decode(payload, kind[4:])
            if repeated:
                d.setdefault(name, []).append(value)
            else:
                d[name] = value
        elif repeated and wire == 2 and kind in ("int", "float", "double"):
            # packed repeated scalars
            vals = []
            p = 0
            if kind == "int":
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    vals.append(_to_signed64(v))
            elif kind == "float":
                vals = list(struct.unpack(f"<{len(payload) // 4}f", payload))
            else:
                vals = list(struct.unpack(f"<{len(payload) // 8}d", payload))
            d.setdefault(name, []).extend(vals)
        else:
            value = _scalar(payload, kind, wire)
            if repeated:
                d.setdefault(name, []).append(value)
            else:
                d[name] = value
    return msg


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # negative int64 -> 10-byte two's-complement varint
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _key(out: bytearray, field_no: int, wire: int) -> None:
    _write_varint(out, (field_no << 3) | wire)


def encode(msg: PB, schema: Optional[str] = None) -> bytes:
    schema = schema or object.__getattribute__(msg, "_schema")
    fields = SCHEMAS[schema]
    d = object.__getattribute__(msg, "_d")
    out = bytearray()
    for field_no, (name, kind, repeated) in sorted(fields.items()):
        if name not in d:
            continue
        value = d[name]
        values = value if repeated else [value]
        if repeated and kind in ("int", "float", "double") and values:
            # packed encoding for repeated scalars
            payload = bytearray()
            for v in values:
                if kind == "int":
                    _write_varint(payload, int(v))
                elif kind == "float":
                    payload += struct.pack("<f", float(v))
                else:
                    payload += struct.pack("<d", float(v))
            _key(out, field_no, 2)
            _write_varint(out, len(payload))
            out += payload
            continue
        for v in values:
            if kind.startswith("msg:"):
                sub = encode(v, kind[4:])
                _key(out, field_no, 2)
                _write_varint(out, len(sub))
                out += sub
            elif kind == "int":
                _key(out, field_no, 0)
                _write_varint(out, int(v))
            elif kind == "float":
                _key(out, field_no, 5)
                out += struct.pack("<f", float(v))
            elif kind == "double":
                _key(out, field_no, 1)
                out += struct.pack("<d", float(v))
            elif kind == "string":
                b = v.encode("utf-8")
                _key(out, field_no, 2)
                _write_varint(out, len(b))
                out += b
            elif kind == "bytes":
                _key(out, field_no, 2)
                _write_varint(out, len(v))
                out += v
            else:  # pragma: no cover
                raise ValueError(kind)
    return bytes(out)


def decode_model(buf: bytes) -> PB:
    return decode(buf, "ModelProto")


def encode_model(model: PB) -> bytes:
    return encode(model, "ModelProto")
