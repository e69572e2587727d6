"""The ONNX protobuf wire writer (counterpart of the JAX package's
`export/onnx_proto.py`, byte for byte): neither `onnx` nor a protobuf
runtime is needed. Field numbers follow onnx.proto3 (IR version 8); the
subset covers what the pose and localizer graphs need: nodes with
attributes, tensors as raw_data, value infos with symbolic batch dimensions
and the opset import. `decode_raw` is a generic wire-format reader.
"""

import struct
from typing import Any, List, Sequence, Tuple, Union

import numpy as np

# --- protobuf wire-format primitives ----------------------------------------


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement for negative int64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def field_string(field: int, value: str) -> bytes:
    return field_bytes(field, value.encode("utf-8"))


def field_message(field: int, value: bytes) -> bytes:
    return field_bytes(field, value)


def field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def field_packed_int64(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return field_bytes(field, payload)


def field_packed_float(field: int, values: Sequence[float]) -> bytes:
    payload = b"".join(struct.pack("<f", float(v)) for v in values)
    return field_bytes(field, payload)


# --- ONNX data types ----------------------------------------------------------

FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
}

# AttributeProto.AttributeType
_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_TENSOR = 4
_ATTR_FLOATS = 6
_ATTR_INTS = 7
_ATTR_STRINGS = 8


def tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.ascontiguousarray(array)
    onnx_type = _NP_TO_ONNX[array.dtype]
    msg = b""
    msg += field_packed_int64(1, array.shape)  # dims
    msg += field_varint(2, onnx_type)  # data_type
    msg += field_string(8, name)  # name
    msg += field_bytes(9, array.tobytes())  # raw_data
    return msg


def attribute_proto(name: str, value) -> bytes:
    msg = field_string(1, name)
    if isinstance(value, float):
        msg += field_float(2, value) + field_varint(20, _ATTR_FLOAT)
    elif isinstance(value, bool):
        msg += field_varint(3, int(value)) + field_varint(20, _ATTR_INT)
    elif isinstance(value, int):
        msg += field_varint(3, value) + field_varint(20, _ATTR_INT)
    elif isinstance(value, str):
        msg += field_bytes(4, value.encode()) + field_varint(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        msg += field_message(5, tensor_proto(name + "_value", value))
        msg += field_varint(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            msg += field_float(7, v)
        msg += field_varint(20, _ATTR_FLOATS)
    elif isinstance(value, (list, tuple)) and (not value or isinstance(value[0], int)):
        for v in value:
            msg += field_varint(8, int(v))
        msg += field_varint(20, _ATTR_INTS)
    elif isinstance(value, (list, tuple)) and isinstance(value[0], str):
        for v in value:
            msg += field_bytes(9, v.encode())
        msg += field_varint(20, _ATTR_STRINGS)
    else:
        raise TypeError(f"Unsupported attribute {name}={value!r}")
    return msg


def node_proto(op_type: str, inputs, outputs, name="", **attributes) -> bytes:
    msg = b""
    for i in inputs:
        msg += field_string(1, i)
    for o in outputs:
        msg += field_string(2, o)
    if name:
        msg += field_string(3, name)
    msg += field_string(4, op_type)
    for k, v in attributes.items():
        msg += field_message(5, attribute_proto(k, v))
    return msg


def value_info_proto(name: str, elem_type: int, shape: Sequence[Union[int, str, None]]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, int):
            dims += field_message(1, field_varint(1, d))  # dim_value
        elif d is None:
            dims += field_message(1, b"")
        else:
            dims += field_message(1, field_string(2, d))  # dim_param
    shape_msg = dims
    tensor_type = field_varint(1, elem_type) + field_message(2, shape_msg)
    type_msg = field_message(1, tensor_type)
    return field_string(1, name) + field_message(2, type_msg)


def graph_proto(
    name: str,
    nodes: Sequence[bytes],
    inputs: Sequence[bytes],
    outputs: Sequence[bytes],
    initializers: Sequence[bytes],
    doc_string: str = "",
) -> bytes:
    parts = [field_message(1, n) for n in nodes]  # joined once: a graph's initializers run to tens of MB
    parts.append(field_string(2, name))
    parts += [field_message(5, init) for init in initializers]
    if doc_string:
        parts.append(field_string(10, doc_string))
    parts += [field_message(11, i) for i in inputs]
    parts += [field_message(12, o) for o in outputs]
    return b"".join(parts)


def model_proto(
    graph: bytes,
    opset_version: int = 13,
    producer_name: str = "neuralnet_tracker_traincode_tpu",  # the JAX package's: the same weights give the same file
    model_version: int = 4,
    ir_version: int = 8,
    doc_string: str = "",
) -> bytes:
    opset = field_string(1, "") + field_varint(2, opset_version)
    msg = field_varint(1, ir_version)
    msg += field_string(2, producer_name)
    msg += field_varint(5, model_version)
    if doc_string:
        msg += field_string(6, doc_string)
    msg += field_message(7, graph)
    msg += field_message(8, opset)
    return msg


# --- generic wire-format decoder (for verification/tests) --------------------


def decode_raw(data: bytes) -> List[Tuple[int, int, Any]]:
    """Decode protobuf wire format generically: [(field, wire_type, value)]."""
    out = []
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(data, i)
        elif wt == 2:
            ln, i = _read_varint(data, i)
            v = data[i : i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack("<I", data[i : i + 4])[0]
            i += 4
        elif wt == 1:
            v = struct.unpack("<Q", data[i : i + 8])[0]
            i += 8
        else:
            raise ValueError(f"Unsupported wire type {wt}")
        out.append((field, wt, v))
    return out


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    value = 0
    while True:
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, i
        shift += 7
