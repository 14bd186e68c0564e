"""Self-contained ONNX protobuf codec (no ``onnx`` package needed).

The port's own copy of ``joshupscale_tpu/export/onnx_minimal.py`` (the
JAX package cannot be imported without jax).  The reference's exit door
into the TensorRT toolchain is an ONNX file (reference
scripts/training/train_local.py:184-209 exports via tf2onnx, then the
onnx/ surgery pipeline consumes it); this module hand-encodes/decodes
the subset of the ONNX protobuf schema the exporter needs --
ModelProto / GraphProto / NodeProto / TensorProto / AttributeProto /
ValueInfoProto -- with the protobuf wire format directly (varint +
length-delimited fields).  Field numbers follow the public onnx.proto
schema.  The same wire primitives encode the TFRecord Examples of
``data/tfrecord.py``.

Numpy only.  Encoded files parse with the real ``onnx`` package (same
wire format); decoding accepts files produced by ``onnx``/tf2onnx
(packed or unpacked repeated scalars, raw_data or typed data arrays).
``make_model``'s producer name is the reference exporter's, so a file
written here is byte for byte the JAX package's for the same graph.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64 = 1, 2, 3, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, BFLOAT16 = 8, 9, 10, 11, 16

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------
# Wire-format primitives


def _varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s) -> bytes:
    if isinstance(s, str):
        s = s.encode()
    return _len_field(field, s)


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_message(buf: bytes) -> Dict[int, List[Any]]:
    """Generic protobuf parse: field number -> list of raw values
    (int for varint/fixed, bytes for length-delimited)."""
    fields: Dict[int, List[Any]] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _ints_from(vals: List[Any]) -> List[int]:
    """Repeated int64 field: accepts unpacked varints and packed blobs."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(_signed64(v))
        else:
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(_signed64(x))
    return out


# ---------------------------------------------------------------------
# Encoders


def make_tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto with raw_data (little-endian)."""
    array = np.ascontiguousarray(array)
    out = bytearray()
    for d in array.shape:
        out += _int_field(1, int(d))  # dims
    out += _int_field(2, NP_TO_ONNX[array.dtype])  # data_type
    out += _str_field(8, name)
    out += _len_field(9, array.astype(array.dtype.newbyteorder("<"))
                      .tobytes())  # raw_data
    return bytes(out)


def _attr(name: str, value) -> bytes:
    out = bytearray(_str_field(1, name))
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _int_field(20, ATTR_FLOAT)
    elif isinstance(value, bool) or isinstance(value, int):
        out += _int_field(3, int(value))
        out += _int_field(20, ATTR_INT)
    elif isinstance(value, (str, bytes)):
        out += _str_field(4, value)
        out += _int_field(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, make_tensor(name + "_value", value))
        out += _int_field(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _tag(7, 5) + struct.pack("<f", v)
            out += _int_field(20, ATTR_FLOATS)
        elif all(isinstance(v, int) for v in value):
            for v in value:
                out += _int_field(8, int(v))
            out += _int_field(20, ATTR_INTS)
        else:
            for v in value:
                out += _str_field(9, v)
            out += _int_field(20, ATTR_STRINGS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return bytes(out)


def make_node(op_type: str, inputs: Sequence[str],
              outputs: Sequence[str], name: str = "",
              **attrs) -> bytes:
    out = bytearray()
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for k, v in attrs.items():
        out += _len_field(5, _attr(k, v))
    return bytes(out)


def make_value_info(name: str, elem_type: int,
                    shape: Sequence[Optional[int]]) -> bytes:
    dims = bytearray()
    for d in shape:
        if d is None:
            dim = _str_field(2, "N")
        else:
            dim = _int_field(1, int(d))
        dims += _len_field(1, dim)
    tensor_type = (_int_field(1, elem_type)
                   + _len_field(2, bytes(dims)))
    type_proto = _len_field(1, tensor_type)
    return (_str_field(1, name) + _len_field(2, type_proto))


def make_graph(name: str, nodes: Sequence[bytes],
               inputs: Sequence[bytes], outputs: Sequence[bytes],
               initializers: Sequence[bytes]) -> bytes:
    out = bytearray()
    for n in nodes:
        out += _len_field(1, n)
    out += _str_field(2, name)
    for init in initializers:
        out += _len_field(5, init)
    for i in inputs:
        out += _len_field(11, i)
    for o in outputs:
        out += _len_field(12, o)
    return bytes(out)


def make_model(graph: bytes, opset: int = 16,
               producer: str = "joshupscale_tpu",
               ir_version: int = 8) -> bytes:
    opset_id = _str_field(1, "") + _int_field(2, opset)
    return (_int_field(1, ir_version)
            + _str_field(2, producer)
            + _len_field(7, graph)
            + _len_field(8, opset_id))


# ---------------------------------------------------------------------
# Decoders (structured views over parse_message)


def _first_str(fields, num, default=""):
    vals = fields.get(num)
    return vals[0].decode() if vals else default


def tensor_to_array(buf: bytes) -> Tuple[str, np.ndarray]:
    f = parse_message(buf)
    dims = _ints_from(f.get(1, []))
    dtype_code = f.get(2, [FLOAT])[0]
    np_dtype = ONNX_TO_NP[dtype_code]
    name = _first_str(f, 8)
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0], dtype=np_dtype.newbyteorder("<"))
    elif 4 in f and dtype_code == FLOAT:  # float_data (packed or not)
        raw = b"".join(v if isinstance(v, bytes)
                       else struct.pack("<f", v) for v in f[4])
        arr = np.frombuffer(raw, dtype="<f4")
    elif 7 in f and dtype_code == INT64:  # int64_data
        arr = np.asarray(_ints_from(f[7]), dtype=np.int64)
    else:
        raise ValueError(f"tensor {name}: no supported data field")
    return name, arr.astype(np_dtype).reshape(dims)


def decode_node(buf: bytes) -> Dict[str, Any]:
    f = parse_message(buf)
    attrs = {}
    for a in f.get(5, []):
        af = parse_message(a)
        aname = _first_str(af, 1)
        atype = af.get(20, [0])[0]
        if atype == ATTR_INT or (3 in af and atype == 0):
            attrs[aname] = _signed64(af[3][0])
        elif atype == ATTR_FLOAT:
            attrs[aname] = struct.unpack("<f", af[2][0])[0]
        elif atype == ATTR_STRING:
            attrs[aname] = af[4][0].decode()
        elif atype == ATTR_INTS:
            attrs[aname] = _ints_from(af.get(8, []))
        elif atype == ATTR_TENSOR:
            attrs[aname] = tensor_to_array(af[5][0])[1]
    return {
        "op_type": _first_str(f, 4),
        "name": _first_str(f, 3),
        "inputs": [v.decode() for v in f.get(1, [])],
        "outputs": [v.decode() for v in f.get(2, [])],
        "attrs": attrs,
    }


def decode_value_info(buf: bytes) -> Dict[str, Any]:
    f = parse_message(buf)
    name = _first_str(f, 1)
    elem_type = None
    shape: List[Optional[int]] = []
    if 2 in f:
        tp = parse_message(f[2][0])
        if 1 in tp:  # tensor_type
            tt = parse_message(tp[1][0])
            elem_type = tt.get(1, [None])[0]
            if 2 in tt:
                sh = parse_message(tt[2][0])
                for d in sh.get(1, []):
                    df = parse_message(d)
                    if 1 in df:
                        shape.append(_signed64(df[1][0]))
                    else:
                        shape.append(None)
    return {"name": name, "elem_type": elem_type, "shape": shape}


def decode_model(buf: bytes) -> Dict[str, Any]:
    """Parse a serialized ModelProto into nodes / initializers / I/O."""
    model = parse_message(buf)
    if 7 not in model:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    graph = parse_message(model[7][0])
    inits = {}
    for t in graph.get(5, []):
        name, arr = tensor_to_array(t)
        inits[name] = arr
    opset = 0
    for op in model.get(8, []):
        of = parse_message(op)
        if _first_str(of, 1) == "":
            opset = of.get(2, [0])[0]
    return {
        "ir_version": model.get(1, [0])[0],
        "producer": _first_str(model, 2),
        "opset": opset,
        "graph_name": _first_str(graph, 2),
        "nodes": [decode_node(n) for n in graph.get(1, [])],
        "initializers": inits,
        "inputs": [decode_value_info(v) for v in graph.get(11, [])],
        "outputs": [decode_value_info(v) for v in graph.get(12, [])],
    }


def _fields(buf: bytes):
    """Each top-level field of a message in order: ``(field, wire, raw,
    value)``, ``raw`` its bytes as they stand (tag included), ``value``
    the payload of a length-delimited field (else None)."""
    pos = 0
    while pos < len(buf):
        start = pos
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        value = None
        if wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            value = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, buf[start:pos], value


def rewrite_initializers(buf: bytes, fn) -> bytes:
    """A serialized ModelProto with each graph initializer replaced by
    the TensorProto of ``fn(name, array)`` (None keeps the initializer);
    every other byte stays as it was."""

    def graph(g: bytes) -> bytes:
        out = bytearray()
        for field, wire, raw, value in _fields(g):
            if field == 5 and wire == 2:
                name, arr = tensor_to_array(value)
                new = fn(name, arr)
                if new is not None:
                    out += _len_field(5, make_tensor(name, new))
                    continue
            out += raw
        return bytes(out)

    out = bytearray()
    for field, wire, raw, value in _fields(buf):
        out += (_len_field(7, graph(value)) if field == 7 and wire == 2
                else raw)
    return bytes(out)
