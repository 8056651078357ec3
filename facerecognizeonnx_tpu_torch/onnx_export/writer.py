"""Dependency-free ONNX protobuf writer (wire-format encoder).

The port's own copy of `facerecognizeonnx_tpu/onnx_export/writer.py`:
the same functions, giving the same bytes. The encoding counterpart of
the decoder in `onnx_import/proto.py` (field numbers per onnx.proto3).

Messages are built as lists of parts joined once, so writing a file is
linear in its size: growing one bytes object per initializer copies
everything before it again, which for a full-width IResNet-50 (174.5 MB)
is most of the export's time.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

NP_TO_ONNX_DTYPE = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
}


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_parts(field: int, payload: bytes) -> List[bytes]:
    """A length-delimited field as parts, the payload not copied."""
    return [_tag(field, 2), _varint(len(payload)), payload]


def _len_field(field: int, payload: bytes) -> bytes:
    return b"".join(_len_parts(field, payload))


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def tensor(name: str, arr: np.ndarray, use_raw: bool = True) -> bytes:
    arr = np.ascontiguousarray(arr)
    parts = [_varint_field(1, d) for d in arr.shape]
    parts.append(_varint_field(2, NP_TO_ONNX_DTYPE[arr.dtype]))
    parts.append(_len_field(8, name.encode()))
    if use_raw:
        parts += _len_parts(9, arr.tobytes())
    elif arr.dtype == np.float32:
        parts += _len_parts(4, arr.tobytes())  # packed float_data
    elif arr.dtype == np.int64:
        parts += _len_parts(7, b"".join(_varint(int(v)) for v in arr.ravel()))
    else:
        raise ValueError(f"non-raw serialization unsupported for {arr.dtype}")
    return b"".join(parts)


def _attribute(name: str, value) -> bytes:
    parts = [_len_field(1, name.encode())]
    if isinstance(value, bool):
        parts.append(_varint_field(3, int(value)))
    elif isinstance(value, int):
        parts.append(_varint_field(3, value))
    elif isinstance(value, float):
        parts.append(_float_field(2, value))
    elif isinstance(value, bytes):
        parts.append(_len_field(4, value))
    elif isinstance(value, str):
        parts.append(_len_field(4, value.encode()))
    elif isinstance(value, np.ndarray):
        parts.append(_len_field(5, tensor("", value)))
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            parts += [_varint_field(8, v) for v in value]  # repeated, not packed
        elif all(isinstance(v, float) for v in value):
            parts += [_tag(7, 5) + struct.pack("<f", v) for v in value]
        else:
            raise ValueError(f"unsupported attr list {value!r}")
    else:
        raise ValueError(f"unsupported attr {value!r}")
    return b"".join(parts)


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    parts = [_len_field(1, i.encode()) for i in inputs]
    parts += [_len_field(2, o.encode()) for o in outputs]
    # empty node names are spec-legal and exempt from the graph-level
    # uniqueness rule (the ONNX checker rejects duplicate names)
    if name:
        parts.append(_len_field(3, name.encode()))
    parts.append(_len_field(4, op_type.encode()))
    parts += [_len_field(5, _attribute(k, v)) for k, v in attrs.items()]
    return b"".join(parts)


def _value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b"".join(
        _len_field(1, _varint_field(1, d) if d is not None and d >= 0 else b"")
        for d in shape
    )
    tensor_type = _varint_field(1, elem_type) + _len_field(2, dims)
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode()) + _len_field(2, type_proto)


def graph(nodes, initializers, inputs, outputs, name="testgraph") -> bytes:
    parts: List[bytes] = []
    for n in nodes:
        parts += _len_parts(1, n)
    parts += _len_parts(2, name.encode())
    for init in initializers:
        parts += _len_parts(5, init)
    for in_name, in_shape in inputs:
        parts += _len_parts(11, _value_info(in_name, in_shape))
    for out_name, out_shape in outputs:
        parts += _len_parts(12, _value_info(out_name, out_shape))
    return b"".join(parts)


def model(graph_bytes: bytes, opset_version: int = 8) -> bytes:
    """ModelProto: ir_version + opset_import + graph.

    ONNX requires at least one opset_import for ir_version >= 4 (stock
    ONNX Runtime rejects a model without one). Opset 8 by default: the
    exported detector uses the attribute-form Upsample (its scales moved
    to an input in opset 9; the op is deprecated from 10)."""
    opset = _len_field(1, b"") + _varint_field(2, opset_version)  # domain "", version
    return b"".join(
        [_varint_field(1, 8)] + _len_parts(8, opset) + _len_parts(7, graph_bytes)
    )
