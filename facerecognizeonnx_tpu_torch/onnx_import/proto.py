"""Minimal protobuf wire-format reader for the ONNX schema subset.

The port's own copy of `facerecognizeonnx_tpu/onnx_import/proto.py`
(numpy only; the same dataclasses, `DTYPE_MAP` and parse results).
Neither `onnx` nor `onnxruntime` is needed: the .onnx container (a
protobuf ModelProto) is decoded directly at the wire level. Only the
fields the face models need are mapped; unknown fields are skipped per
protobuf rules, so files with extra metadata still parse.

Field numbers follow onnx.proto3 (stable since ONNX IR v3):
  ModelProto:     graph=7, ir_version=1, opset_import=8
  GraphProto:     node=1, name=2, initializer=5, input=11, output=12
  NodeProto:      input=1, output=2, name=3, op_type=4, attribute=5
  TensorProto:    dims=1, data_type=2, float_data=4, int32_data=5,
                  string_data=6, int64_data=7, name=8, raw_data=9,
                  double_data=10, uint64_data=11
  AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
                  strings=9, type=20
  ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1;
  TensorTypeProto: elem_type=1, shape=2; TensorShapeProto.dim=1;
  Dimension:      dim_value=1, dim_param=2
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


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
        if shift > 70:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == _WIRE_I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _zigzag_passthrough(v: int) -> int:
    # ONNX int64 fields use plain (non-zigzag) varints; negative values
    # arrive as 10-byte two's-complement varints.
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(val: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(_zigzag_passthrough(v))
    return out


# ONNX TensorProto.DataType → numpy
DTYPE_MAP = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


@dataclasses.dataclass
class Tensor:
    name: str
    dims: Tuple[int, ...]
    data_type: int
    array: np.ndarray


@dataclasses.dataclass
class Attribute:
    name: str
    value: Any


@dataclasses.dataclass
class Node:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[List[Optional[int]]]]]
    outputs: List[str]


def parse_tensor(buf: bytes) -> Tensor:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == _WIRE_VARINT:
                dims.append(_zigzag_passthrough(val))
            else:
                dims.extend(_packed_varints(val))
        elif field == 2 and wire == _WIRE_VARINT:
            data_type = val
        elif field == 4:
            if wire == _WIRE_I32:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(np.frombuffer(val, "<f4").tolist())
        elif field == 5:
            if wire == _WIRE_VARINT:
                int32_data.append(_zigzag_passthrough(val))
            else:
                int32_data.extend(_packed_varints(val))
        elif field == 7:
            if wire == _WIRE_VARINT:
                int64_data.append(_zigzag_passthrough(val))
            else:
                int64_data.extend(_packed_varints(val))
        elif field == 8 and wire == _WIRE_LEN:
            name = val.decode("utf-8", "replace")
        elif field == 9 and wire == _WIRE_LEN:
            raw = val
        elif field == 10:
            if wire == _WIRE_I64:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(np.frombuffer(val, "<f8").tolist())

    np_dtype = DTYPE_MAP.get(data_type)
    if np_dtype is None:
        raise ValueError(f"unsupported tensor data_type {data_type} ({name})")
    shape = tuple(dims)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype).reshape(shape).copy()
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(shape)
    elif double_data:
        arr = np.asarray(double_data, np.float64).reshape(shape)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(shape)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype).reshape(shape)
    else:
        arr = np.zeros(shape, np_dtype)
    return Tensor(name=name, dims=shape, data_type=data_type, array=arr)


def parse_attribute(buf: bytes) -> Attribute:
    name = ""
    value: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            name = val.decode()
        elif field == 2 and wire == _WIRE_I32:
            value = struct.unpack("<f", val)[0]
        elif field == 3 and wire == _WIRE_VARINT:
            value = _zigzag_passthrough(val)
        elif field == 4 and wire == _WIRE_LEN:
            value = val  # bytes attr (e.g. mode strings)
        elif field == 5 and wire == _WIRE_LEN:
            value = parse_tensor(val).array
        elif field == 7:
            if wire == _WIRE_I32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(np.frombuffer(val, "<f4").tolist())
        elif field == 8:
            if wire == _WIRE_VARINT:
                ints.append(_zigzag_passthrough(val))
            else:
                ints.extend(_packed_varints(val))
        elif field == 9 and wire == _WIRE_LEN:
            strings.append(val)
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = strings
    return Attribute(name=name, value=value)


def parse_node(buf: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            inputs.append(val.decode())
        elif field == 2 and wire == _WIRE_LEN:
            outputs.append(val.decode())
        elif field == 3 and wire == _WIRE_LEN:
            name = val.decode()
        elif field == 4 and wire == _WIRE_LEN:
            op_type = val.decode()
        elif field == 5 and wire == _WIRE_LEN:
            attr = parse_attribute(val)
            attrs[attr.name] = attr.value
    return Node(op_type=op_type, name=name, inputs=inputs, outputs=outputs, attrs=attrs)


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[List[Optional[int]]]]:
    name = ""
    shape: Optional[List[Optional[int]]] = None
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            name = val.decode()
        elif field == 2 and wire == _WIRE_LEN:  # TypeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == _WIRE_LEN:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 2 and w3 == _WIRE_LEN:  # shape
                            dims: List[Optional[int]] = []
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1 and w4 == _WIRE_LEN:  # dim
                                    dim_val: Optional[int] = None
                                    for f5, w5, v5 in _iter_fields(v4):
                                        if f5 == 1 and w5 == _WIRE_VARINT:
                                            dim_val = _zigzag_passthrough(v5)
                                    dims.append(dim_val)
                            shape = dims
    return name, shape


def parse_graph(buf: bytes) -> Graph:
    nodes: List[Node] = []
    initializers: Dict[str, np.ndarray] = {}
    inputs: List[Tuple[str, Optional[List[Optional[int]]]]] = []
    outputs: List[str] = []
    name = ""
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            nodes.append(parse_node(val))
        elif field == 2 and wire == _WIRE_LEN:
            name = val.decode()
        elif field == 5 and wire == _WIRE_LEN:
            t = parse_tensor(val)
            initializers[t.name] = t.array
        elif field == 11 and wire == _WIRE_LEN:
            inputs.append(_parse_value_info(val))
        elif field == 12 and wire == _WIRE_LEN:
            out_name, _ = _parse_value_info(val)
            outputs.append(out_name)
    return Graph(
        name=name, nodes=nodes, initializers=initializers,
        inputs=inputs, outputs=outputs,
    )


def parse_model(data: bytes) -> Graph:
    """ModelProto bytes → Graph (field 7)."""
    graph: Optional[Graph] = None
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == _WIRE_LEN:
            graph = parse_graph(val)
    if graph is None:
        raise ValueError("no GraphProto found — not an ONNX ModelProto?")
    return graph


def load_model(path: str) -> Graph:
    with open(path, "rb") as f:
        return parse_model(f.read())
