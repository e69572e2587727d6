"""Typed ONNX conformance check (counterpart of the JAX package's
`export/onnx_conformance.py`): neither `onnx` nor `onnxruntime` is needed.

The executor (`onnx_run.py`) shares its reading of the file with the
writer, so a schema fault (a wrong attribute name or type, an opset
mismatch) could pass it and still be refused by onnxruntime, which the
opentrack plugin loads the files with. This module decodes the bytes on
its own:

 1. `decode_model` reads them strictly by the onnx.proto3 field numbers
    (ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
    ValueInfoProto): unknown fields and wrong wire types are errors.
 2. `validate_model` checks every node against the opset-13 operator table
    (`OPSET13`, from the public operator spec): the allowed attributes and
    their types, the required ones, the input and output arities; and the
    graph: topological order (every input is a graph input, an initializer
    or an earlier node's output), unique value names, declared inputs and
    outputs, the default-domain opset import, and each initializer's size
    against its dims and type.
"""

import struct
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from neuralnet_tracker_traincode_torch.export.onnx_proto import decode_raw

# AttributeProto.AttributeType values (onnx.proto3)
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_GRAPH = 1, 2, 3, 4, 5
A_FLOATS, A_INTS, A_STRINGS, A_TENSORS, A_GRAPHS = 6, 7, 8, 9, 10
ATTR_TYPE_NAMES = {
    A_FLOAT: "FLOAT", A_INT: "INT", A_STRING: "STRING", A_TENSOR: "TENSOR",
    A_GRAPH: "GRAPH", A_FLOATS: "FLOATS", A_INTS: "INTS", A_STRINGS: "STRINGS",
}

# TensorProto.DataType values used by the exporter
T_FLOAT, T_UINT8, T_INT8, T_INT32, T_INT64, T_BOOL, T_FLOAT16 = 1, 2, 3, 6, 7, 9, 10
VALID_ELEM_TYPES = {T_FLOAT, T_UINT8, T_INT8, T_INT32, T_INT64, T_BOOL, T_FLOAT16}

_DTYPE_SIZES = {T_FLOAT: 4, T_UINT8: 1, T_INT8: 1, T_INT32: 4, T_INT64: 8,
                T_BOOL: 1, T_FLOAT16: 2}


class Attr(NamedTuple):
    name: str
    type: int
    value: Any


class Node(NamedTuple):
    op_type: str
    name: str
    domain: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Attr]


class TensorInfo(NamedTuple):
    name: str
    data_type: int
    dims: Tuple[int, ...]
    raw_len: Optional[int]


class ValueInfo(NamedTuple):
    name: str
    elem_type: int
    shape: Tuple[Any, ...]  # ints and/or symbolic strings


class Graph(NamedTuple):
    name: str
    nodes: List[Node]
    initializers: List[TensorInfo]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]


class Model(NamedTuple):
    ir_version: int
    producer_name: str
    model_version: int
    opset_imports: Dict[str, int]  # domain -> version
    graph: Graph


class ConformanceError(ValueError):
    pass


def _expect(cond: bool, msg: str):
    if not cond:
        raise ConformanceError(msg)


def _utf8(v: Any, ctx: str) -> str:
    _expect(isinstance(v, (bytes, bytearray)), f"{ctx}: expected length-delimited string")
    return bytes(v).decode("utf-8")


def _decode_attribute(data: bytes) -> Attr:
    name = ""
    atype = None
    single: Dict[int, Any] = {}
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt, v in decode_raw(data):
        if field == 1:
            name = _utf8(v, "AttributeProto.name")
        elif field == 20:
            _expect(wt == 0, "AttributeProto.type: wrong wire type")
            atype = int(v)
        elif field == 2:  # f (float, fixed32)
            _expect(wt == 5, "AttributeProto.f: wrong wire type")
            single[A_FLOAT] = struct.unpack("<f", struct.pack("<I", v))[0]
        elif field == 3:  # i (int64 varint)
            _expect(wt == 0, "AttributeProto.i: wrong wire type")
            single[A_INT] = _signed64(v)
        elif field == 4:  # s
            single[A_STRING] = bytes(v)
        elif field == 5:  # t (TensorProto)
            single[A_TENSOR] = _decode_tensor(v)
        elif field == 7:  # floats: packed or repeated fixed32
            if wt == 5:
                floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
            else:
                b = bytes(v)
                _expect(len(b) % 4 == 0, "AttributeProto.floats: bad packed length")
                floats.extend(struct.unpack(f"<{len(b)//4}f", b))
        elif field == 8:  # ints: packed varints or repeated
            if wt == 0:
                ints.append(_signed64(v))
            else:
                ints.extend(_signed64(x) for x in _unpack_varints(bytes(v)))
        elif field == 9:
            strings.append(bytes(v))
        elif field == 6:
            raise ConformanceError("AttributeProto.g (GRAPH) not expected in these models")
        else:
            raise ConformanceError(f"AttributeProto: unknown field {field}")
    _expect(name != "", "AttributeProto: missing name")
    _expect(atype is not None, f"AttributeProto {name!r}: missing type (field 20)")
    if atype in single:
        value = single[atype]
    elif atype == A_FLOATS:
        value = floats
    elif atype == A_INTS:
        value = ints
    elif atype == A_STRINGS:
        value = strings
    else:
        raise ConformanceError(
            f"AttributeProto {name!r}: declared type {atype} but no matching payload"
        )
    # cross-typed payloads (e.g. declared INT but carries floats) are emission bugs
    stray = [k for k in single if k != atype] + (
        [A_FLOATS] if floats and atype != A_FLOATS else []
    ) + ([A_INTS] if ints and atype != A_INTS else []) + (
        [A_STRINGS] if strings and atype != A_STRINGS else []
    )
    _expect(not stray, f"AttributeProto {name!r}: payload fields {stray} conflict with type {atype}")
    return Attr(name, atype, value)


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _unpack_varints(data: bytes) -> List[int]:
    out = []
    i, value, shift = 0, 0, 0
    while i < len(data):
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            out.append(value)
            value, shift = 0, 0
    _expect(shift == 0, "packed varints: truncated")
    return out


def _decode_tensor(data: bytes) -> TensorInfo:
    dims: List[int] = []
    data_type = None
    name = ""
    raw_len = None
    n_typed_values = 0
    for field, wt, v in decode_raw(data):
        if field == 1:
            if wt == 0:
                dims.append(int(v))
            else:
                dims.extend(int(x) for x in _unpack_varints(bytes(v)))
        elif field == 2:
            data_type = int(v)
        elif field == 8:
            name = _utf8(v, "TensorProto.name")
        elif field == 9:
            raw_len = len(v)
        elif field in (4, 5, 6, 7, 10, 11):  # typed data fields
            n_typed_values += 1
        elif field == 13:  # external data
            raise ConformanceError("TensorProto: external data not allowed")
        else:
            raise ConformanceError(f"TensorProto: unknown field {field}")
    _expect(data_type is not None, f"TensorProto {name!r}: missing data_type")
    return TensorInfo(name, data_type, tuple(dims), raw_len)


def _decode_value_info(data: bytes) -> ValueInfo:
    name = ""
    elem_type = None
    shape: List[Any] = []
    for field, wt, v in decode_raw(data):
        if field == 1:
            name = _utf8(v, "ValueInfoProto.name")
        elif field == 2:  # TypeProto
            for f2, wt2, v2 in decode_raw(bytes(v)):
                _expect(f2 == 1, f"TypeProto: only tensor_type supported, got field {f2}")
                for f3, wt3, v3 in decode_raw(bytes(v2)):
                    if f3 == 1:
                        elem_type = int(v3)
                    elif f3 == 2:  # TensorShapeProto
                        for f4, wt4, v4 in decode_raw(bytes(v3)):
                            _expect(f4 == 1, "TensorShapeProto: unknown field")
                            dim_val: Any = None
                            for f5, wt5, v5 in decode_raw(bytes(v4)):
                                if f5 == 1:
                                    dim_val = int(v5)
                                elif f5 == 3:
                                    dim_val = _utf8(v5, "dim_param")
                            shape.append(dim_val)
                    else:
                        raise ConformanceError(f"TypeProto.Tensor: unknown field {f3}")
        elif field == 3:
            pass  # doc_string
        else:
            raise ConformanceError(f"ValueInfoProto: unknown field {field}")
    _expect(name != "", "ValueInfoProto: missing name")
    _expect(elem_type is not None, f"ValueInfoProto {name!r}: missing elem_type")
    return ValueInfo(name, elem_type, tuple(shape))


def _decode_node(data: bytes) -> Node:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    domain = ""
    attrs: Dict[str, Attr] = {}
    for field, wt, v in decode_raw(data):
        if field == 1:
            inputs.append(_utf8(v, "NodeProto.input"))
        elif field == 2:
            outputs.append(_utf8(v, "NodeProto.output"))
        elif field == 3:
            name = _utf8(v, "NodeProto.name")
        elif field == 4:
            op_type = _utf8(v, "NodeProto.op_type")
        elif field == 5:
            a = _decode_attribute(bytes(v))
            _expect(a.name not in attrs, f"node {name!r}: duplicate attribute {a.name!r}")
            attrs[a.name] = a
        elif field == 7:
            domain = _utf8(v, "NodeProto.domain")
        elif field == 6:
            pass  # doc_string
        else:
            raise ConformanceError(f"NodeProto: unknown field {field}")
    _expect(op_type != "", f"NodeProto {name!r}: missing op_type")
    return Node(op_type, name, domain, inputs, outputs, attrs)


def _decode_graph(data: bytes) -> Graph:
    nodes: List[Node] = []
    initializers: List[TensorInfo] = []
    inputs: List[ValueInfo] = []
    outputs: List[ValueInfo] = []
    name = ""
    for field, wt, v in decode_raw(data):
        if field == 1:
            nodes.append(_decode_node(bytes(v)))
        elif field == 2:
            name = _utf8(v, "GraphProto.name")
        elif field == 5:
            initializers.append(_decode_tensor(bytes(v)))
        elif field == 11:
            inputs.append(_decode_value_info(bytes(v)))
        elif field == 12:
            outputs.append(_decode_value_info(bytes(v)))
        elif field == 13:
            _decode_value_info(bytes(v))  # value_info entries: decode-checked only
        elif field == 10:
            pass  # doc_string
        else:
            raise ConformanceError(f"GraphProto: unknown field {field}")
    return Graph(name, nodes, initializers, inputs, outputs)


def decode_model(data: bytes) -> Model:
    ir_version = None
    producer_name = ""
    model_version = 0
    opsets: Dict[str, int] = {}
    graph: Optional[Graph] = None
    for field, wt, v in decode_raw(data):
        if field == 1:
            ir_version = int(v)
        elif field == 2:
            producer_name = _utf8(v, "ModelProto.producer_name")
        elif field == 3:
            pass  # producer_version
        elif field == 5:
            model_version = int(v)
        elif field == 6:
            pass  # doc_string
        elif field == 7:
            graph = _decode_graph(bytes(v))
        elif field == 8:
            domain, version = "", None
            for f2, wt2, v2 in decode_raw(bytes(v)):
                if f2 == 1:
                    domain = _utf8(v2, "OperatorSetIdProto.domain")
                elif f2 == 2:
                    version = int(v2)
                else:
                    raise ConformanceError(f"OperatorSetIdProto: unknown field {f2}")
            _expect(version is not None, "OperatorSetIdProto: missing version")
            opsets[domain] = version
        else:
            raise ConformanceError(f"ModelProto: unknown field {field}")
    _expect(ir_version is not None, "ModelProto: missing ir_version")
    _expect(graph is not None, "ModelProto: missing graph")
    return Model(ir_version, producer_name, model_version, opsets, graph)


# --- opset-13 operator table --------------------------------------------------
# Transcribed from the public ONNX operator spec at opset 13 (Operators.md).
# Format: op -> (min_in, max_in, min_out, max_out,
#                {attr: (type, required)}).


class OpSpec(NamedTuple):
    min_in: int
    max_in: int
    min_out: int
    max_out: int
    attrs: Dict[str, Tuple[int, bool]]


OPSET13: Dict[str, OpSpec] = {
    "Abs": OpSpec(1, 1, 1, 1, {}),
    "Add": OpSpec(2, 2, 1, 1, {}),
    "ArgMax": OpSpec(1, 1, 1, 1, {
        "axis": (A_INT, False), "keepdims": (A_INT, False),
        "select_last_index": (A_INT, False)}),
    "Cast": OpSpec(1, 1, 1, 1, {"to": (A_INT, True)}),
    # opset 13: min/max are INPUTS (attributes were pre-11)
    "Clip": OpSpec(1, 3, 1, 1, {}),
    "Concat": OpSpec(1, 2**31, 1, 1, {"axis": (A_INT, True)}),
    "Conv": OpSpec(2, 3, 1, 1, {
        "auto_pad": (A_STRING, False), "dilations": (A_INTS, False),
        "group": (A_INT, False), "kernel_shape": (A_INTS, False),
        "pads": (A_INTS, False), "strides": (A_INTS, False)}),
    "DequantizeLinear": OpSpec(2, 3, 1, 1, {"axis": (A_INT, False)}),
    "Div": OpSpec(2, 2, 1, 1, {}),
    "Elu": OpSpec(1, 1, 1, 1, {"alpha": (A_FLOAT, False)}),
    "Equal": OpSpec(2, 2, 1, 1, {}),
    "Exp": OpSpec(1, 1, 1, 1, {}),
    "Flatten": OpSpec(1, 1, 1, 1, {"axis": (A_INT, False)}),
    "Gather": OpSpec(2, 2, 1, 1, {"axis": (A_INT, False)}),
    "Gemm": OpSpec(2, 3, 1, 1, {
        "alpha": (A_FLOAT, False), "beta": (A_FLOAT, False),
        "transA": (A_INT, False), "transB": (A_INT, False)}),
    "GlobalAveragePool": OpSpec(1, 1, 1, 1, {}),
    "Greater": OpSpec(2, 2, 1, 1, {}),
    "Identity": OpSpec(1, 1, 1, 1, {}),
    "MatMul": OpSpec(2, 2, 1, 1, {}),
    "MaxPool": OpSpec(1, 1, 1, 2, {
        "auto_pad": (A_STRING, False), "ceil_mode": (A_INT, False),
        "dilations": (A_INTS, False), "kernel_shape": (A_INTS, True),
        "pads": (A_INTS, False), "storage_order": (A_INT, False),
        "strides": (A_INTS, False)}),
    "Mul": OpSpec(2, 2, 1, 1, {}),
    "Neg": OpSpec(1, 1, 1, 1, {}),
    "Pad": OpSpec(2, 3, 1, 1, {"mode": (A_STRING, False)}),
    "Pow": OpSpec(2, 2, 1, 1, {}),
    "QuantizeLinear": OpSpec(2, 3, 1, 1, {"axis": (A_INT, False)}),
    # opset 13: axes is an ATTRIBUTE for Reduce* (input-form arrived at 18)
    "ReduceL2": OpSpec(1, 1, 1, 1, {"axes": (A_INTS, False), "keepdims": (A_INT, False)}),
    "ReduceMax": OpSpec(1, 1, 1, 1, {"axes": (A_INTS, False), "keepdims": (A_INT, False)}),
    "ReduceMean": OpSpec(1, 1, 1, 1, {"axes": (A_INTS, False), "keepdims": (A_INT, False)}),
    "ReduceSum": OpSpec(1, 2, 1, 1, {
        "keepdims": (A_INT, False), "noop_with_empty_axes": (A_INT, False)}),
    "Relu": OpSpec(1, 1, 1, 1, {}),
    # opset 13: NO attributes (allowzero arrived at 14 — emitting it under a
    # 13 import is exactly the class of bug this checker exists to catch)
    "Reshape": OpSpec(2, 2, 1, 1, {}),
    "Sigmoid": OpSpec(1, 1, 1, 1, {}),
    "Sign": OpSpec(1, 1, 1, 1, {}),
    "Slice": OpSpec(3, 5, 1, 1, {}),
    "Softmax": OpSpec(1, 1, 1, 1, {"axis": (A_INT, False)}),
    "Sqrt": OpSpec(1, 1, 1, 1, {}),
    "Sub": OpSpec(2, 2, 1, 1, {}),
    "Tanh": OpSpec(1, 1, 1, 1, {}),
    "Transpose": OpSpec(1, 1, 1, 1, {"perm": (A_INTS, False)}),
    # opset 13: axes is an INPUT (attribute form is pre-13)
    "Unsqueeze": OpSpec(2, 2, 1, 1, {}),
    "Squeeze": OpSpec(1, 2, 1, 1, {}),
    "Where": OpSpec(3, 3, 1, 1, {}),
}

SUPPORTED_OPSET = 13


def validate_model(data: bytes) -> Model:
    """Decode + validate; raises ConformanceError on any violation."""
    model = decode_model(data)
    _expect(model.ir_version >= 4,
            f"ir_version {model.ir_version} predates initializer-as-constant semantics")
    _expect("" in model.opset_imports, "missing default-domain opset import")
    opset = model.opset_imports[""]
    _expect(opset == SUPPORTED_OPSET,
            f"default opset {opset} != validated opset {SUPPORTED_OPSET}")
    for dom in model.opset_imports:
        _expect(dom in ("", "ai.onnx"), f"unexpected operator domain {dom!r}")

    g = model.graph
    available = set()
    for vi in g.inputs:
        _expect(vi.elem_type in VALID_ELEM_TYPES,
                f"graph input {vi.name!r}: bad elem_type {vi.elem_type}")
        available.add(vi.name)
    init_names = set()
    for t in g.initializers:
        _expect(t.name != "", "initializer with empty name")
        _expect(t.name not in init_names, f"duplicate initializer {t.name!r}")
        init_names.add(t.name)
        _expect(t.data_type in VALID_ELEM_TYPES,
                f"initializer {t.name!r}: bad data_type {t.data_type}")
        if t.raw_len is not None:
            n = int(np.prod(t.dims)) if t.dims else 1
            _expect(t.raw_len == n * _DTYPE_SIZES[t.data_type],
                    f"initializer {t.name!r}: raw_data length {t.raw_len} != "
                    f"{n} x {_DTYPE_SIZES[t.data_type]} for dims {t.dims}")
        available.add(t.name)

    for node in g.nodes:
        ctx = f"node {node.name or node.outputs}: {node.op_type}"
        _expect(node.domain in ("", "ai.onnx"), f"{ctx}: bad domain {node.domain!r}")
        spec = OPSET13.get(node.op_type)
        _expect(spec is not None, f"{ctx}: op not in the opset-13 table")
        n_in = len(node.inputs)
        n_out = len(node.outputs)
        _expect(spec.min_in <= n_in <= spec.max_in,
                f"{ctx}: {n_in} inputs, expected [{spec.min_in}, {spec.max_in}]")
        _expect(spec.min_out <= n_out <= spec.max_out,
                f"{ctx}: {n_out} outputs, expected [{spec.min_out}, {spec.max_out}]")
        for aname, attr in node.attrs.items():
            _expect(aname in spec.attrs,
                    f"{ctx}: attribute {aname!r} not allowed at opset 13")
            want_type = spec.attrs[aname][0]
            _expect(attr.type == want_type,
                    f"{ctx}: attribute {aname!r} type {ATTR_TYPE_NAMES.get(attr.type)} "
                    f"!= {ATTR_TYPE_NAMES.get(want_type)}")
        for aname, (want_type, required) in spec.attrs.items():
            if required:
                _expect(aname in node.attrs, f"{ctx}: missing required attribute {aname!r}")
        for inp in node.inputs:
            if inp == "":
                continue  # optional input slot
            _expect(inp in available,
                    f"{ctx}: input {inp!r} not produced before use (topological order)")
        for out in node.outputs:
            _expect(out != "", f"{ctx}: empty output name")
            _expect(out not in available, f"{ctx}: output {out!r} redefined (SSA violation)")
            available.add(out)

    _expect(len(g.outputs) > 0, "graph has no outputs")
    for vo in g.outputs:
        _expect(vo.name in available, f"graph output {vo.name!r} is never produced")
        _expect(vo.elem_type in VALID_ELEM_TYPES,
                f"graph output {vo.name!r}: bad elem_type {vo.elem_type}")
    return model
