"""Decode and execute the ONNX files that `onnx_export.py` writes, in torch
(counterpart of the JAX package's `export/onnx_run.py`).

`load_model` decodes a file into nodes, numpy initializers and the graph's
inputs and outputs. `run` executes the decoded graph node by node with torch
ops on a device; `TorchOnnxSession` is the onnxruntime-like facade the eval
path and the export CLI use (CUDA unless the caller asks for the CPU).

The ops are exactly those of the JAX package's numpy executor, with its
semantics: convolutions compute in f32 (also in fp16 graphs); binary ops
promote their operands by dtype alone, as numpy 2 does; `QuantizeLinear`
rounds half to even and saturates to its zero point's range;
`DequantizeLinear` takes a per-channel scale on `axis`; `MaxPool` pads with
-inf; `Reshape` reads 0 as "keep this dimension"; f64 results are stored as
f32. The int64 operands of `Slice`, `Reshape` and `Unsqueeze` stay numpy on
the host, so no node reads a value back from the device.
"""

import struct
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.export import onnx_proto as P

_ONNX_TO_NP = {
    P.FLOAT: np.float32,
    P.UINT8: np.uint8,
    P.INT8: np.int8,
    P.INT32: np.int32,
    P.INT64: np.int64,
    P.BOOL: np.bool_,
    P.FLOAT16: np.float16,
}
_ONNX_TO_TORCH = {
    P.FLOAT: torch.float32,
    P.UINT8: torch.uint8,
    P.INT8: torch.int8,
    P.INT32: torch.int32,
    P.INT64: torch.int64,
    P.BOOL: torch.bool,
    P.FLOAT16: torch.float16,
}


class Node(NamedTuple):
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


class OnnxModel(NamedTuple):
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    input_names: List[str]
    output_names: List[str]
    model_version: int
    input_dims: Dict[str, List[Optional[int]]]  # symbolic dims -> None


def _parse_tensor(data: bytes):
    dims, dtype, name, raw = [], P.FLOAT, "", b""
    for field, wt, v in P.decode_raw(data):
        if field == 1:
            if wt == 0:
                dims.append(v)
            else:  # packed
                i = 0
                while i < len(v):
                    val, i = P._read_varint(v, i)
                    dims.append(val)
        elif field == 2:
            dtype = v
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
    arr = np.frombuffer(raw, dtype=_ONNX_TO_NP[dtype]).reshape(dims)
    return name, arr


def _signed64(v: int) -> int:
    return v if v < (1 << 63) else v - (1 << 64)


def _parse_attr(data: bytes):
    name, value = "", None
    ints, floats = [], []
    for field, wt, v in P.decode_raw(data):
        if field == 1:
            name = v.decode()
        elif field == 2:
            value = struct.unpack("<f", struct.pack("<I", v))[0]
        elif field == 3:
            value = _signed64(v)
        elif field == 4:
            value = v.decode()
        elif field == 5:
            value = _parse_tensor(v)[1]
        elif field == 7:
            floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif field == 8:
            ints.append(_signed64(v))
    if ints:
        value = ints
    elif floats:
        value = floats
    return name, value


def _parse_node(data: bytes) -> Node:
    inputs, outputs, op_type, attrs = [], [], "", {}
    for field, wt, v in P.decode_raw(data):
        if field == 1:
            inputs.append(v.decode())
        elif field == 2:
            outputs.append(v.decode())
        elif field == 4:
            op_type = v.decode()
        elif field == 5:
            k, val = _parse_attr(v)
            attrs[k] = val
    return Node(op_type, inputs, outputs, attrs)


def _parse_value_info(data: bytes):
    """ValueInfoProto -> (name, dims); symbolic or absent dims parse as None."""
    name, dims = "", []
    for field, wt, v in P.decode_raw(data):
        if field == 1:
            name = v.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in P.decode_raw(v):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in P.decode_raw(v2):
                    if f3 != 2:  # shape
                        continue
                    for f4, _, v4 in P.decode_raw(v3):
                        if f4 != 1:  # dim
                            continue
                        dim = None
                        for f5, _, v5 in P.decode_raw(v4):
                            if f5 == 1:  # dim_value
                                dim = int(v5)
                        dims.append(dim)
    return name, dims


def load_model(model_bytes: bytes) -> OnnxModel:
    graph = None
    model_version = 0
    for field, wt, v in P.decode_raw(model_bytes):
        if field == 7:
            graph = v
        elif field == 5:
            model_version = v
    assert graph is not None, "no graph in model"
    nodes, initializers, inputs, outputs, input_dims = [], {}, [], [], {}
    for field, wt, v in P.decode_raw(graph):
        if field == 1:
            nodes.append(_parse_node(v))
        elif field == 5:
            name, arr = _parse_tensor(v)
            initializers[name] = arr
        elif field == 11:
            name, dims = _parse_value_info(v)
            inputs.append(name)
            input_dims[name] = dims
        elif field == 12:
            outputs.append(_parse_value_info(v)[0])
    return OnnxModel(nodes, initializers, inputs, outputs, model_version, input_dims)


def device_initializers(model: OnnxModel, device: torch.device) -> Dict[str, Any]:
    """The initializers as the executor holds them: int64 arrays (index
    operands) stay numpy on the host, the others are tensors on `device`."""
    return {k: v if v.dtype == np.int64 else torch.from_numpy(v.copy()).to(device)
            for k, v in model.initializers.items()}


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """Both operands in the dtype numpy 2 gives them (by dtype alone)."""
    if a.dtype == b.dtype:
        return a, b
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def _axes(a, key="axes"):
    return tuple(int(d) for d in a[key])


def _conv(x, w, b, strides, pads, group):
    ph0, pw0, ph1, pw1 = pads
    x, w = x.float(), w.float()
    if (ph0, pw0) == (ph1, pw1):
        y = F.conv2d(x, w, None, tuple(strides), (ph0, pw0), 1, group)
    else:
        y = F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, None, tuple(strides), 0, 1, group)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return y


def _unsqueeze(x, axes):
    rank = x.dim() + len(axes)
    for ax in sorted(int(a) % rank for a in axes):
        x = x.unsqueeze(ax)
    return x


def _node(op: str, i: List[Any], a: Dict[str, Any]):
    """One node's output (the first) from its inputs `i` and attributes `a`."""
    if op == "Conv":
        return _conv(i[0], i[1], i[2] if len(i) > 2 else None, a.get("strides", [1, 1]),
                     a.get("pads", [0, 0, 0, 0]), a.get("group", 1))
    if op == "Relu":
        return torch.clamp_min(i[0], 0)
    if op == "Elu":
        x = i[0]
        return torch.where(x > 0, x, a.get("alpha", 1.0) * (torch.exp(torch.clamp_max(x, 0.0)) - 1))
    if op in ("Add", "Sub", "Mul", "Div", "MatMul", "Greater", "Equal"):
        x, y = _promoted(i[0], i[1])
        if op == "Add":
            return x + y
        if op == "Sub":
            return x - y
        if op == "Mul":
            return x * y
        if op == "Div":
            return x / y
        if op == "MatMul":
            return torch.matmul(x, y)
        return x > y if op == "Greater" else x == y
    if op == "Sqrt":
        return torch.sqrt(i[0])
    if op == "Sigmoid":
        return 1.0 / (1.0 + torch.exp(-i[0]))
    if op == "Abs":
        return torch.abs(i[0])
    if op == "Sign":
        return torch.sign(i[0])
    if op == "Where":
        x, y = _promoted(i[1], i[2])
        return torch.where(i[0], x, y)
    if op == "ReduceMax":
        return torch.amax(i[0], dim=_axes(a), keepdim=bool(a.get("keepdims", 1)))
    if op == "ArgMax":
        return torch.argmax(i[0], dim=a.get("axis", 0), keepdim=bool(a.get("keepdims", 1)))
    if op == "Gemm":
        x, w = _promoted(i[0], i[1].T if a.get("transB", 0) else i[1])
        y = torch.matmul(x, w)
        if len(i) > 2:
            y, c = _promoted(y, i[2])
            y = y + c
        return y
    if op == "Concat":
        dtype = i[0].dtype
        for t in i[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        return torch.cat([t.to(dtype) for t in i], dim=a["axis"])
    if op == "Slice":
        sl = [slice(None)] * i[0].dim()
        for s_, e_, ax in zip(i[1], i[2], i[3]):
            sl[int(ax)] = slice(int(s_), int(e_))
        return i[0][tuple(sl)]
    if op == "Reshape":
        shape = [i[0].shape[k] if int(d) == 0 else int(d) for k, d in enumerate(i[1])]
        return i[0].reshape(shape)
    if op == "Unsqueeze":
        return _unsqueeze(i[0], i[1])
    if op == "Flatten":
        return i[0].reshape(i[0].shape[0], -1)
    if op == "GlobalAveragePool":
        return i[0].mean(dim=(2, 3), keepdim=True)
    if op == "ReduceMean":
        return i[0].mean(dim=_axes(a), keepdim=bool(a.get("keepdims", 1)))
    if op == "ReduceL2":
        return torch.sqrt(torch.square(i[0]).sum(dim=_axes(a), keepdim=bool(a.get("keepdims", 1))))
    if op == "Clip":
        y = i[0]
        if len(i) > 1 and i[1] is not None:
            y, lo = _promoted(y, i[1])
            y = torch.maximum(y, lo)
        if len(i) > 2 and i[2] is not None:
            y, hi = _promoted(y, i[2])
            y = torch.minimum(y, hi)
        return y
    if op == "Softmax":
        ax = a.get("axis", -1)
        e = torch.exp(i[0] - torch.amax(i[0], dim=ax, keepdim=True))
        return e / e.sum(dim=ax, keepdim=True)
    if op == "Identity":
        return i[0]
    if op == "Transpose":
        return i[0].permute(*a["perm"])
    if op == "Cast":
        return i[0].to(_ONNX_TO_TORCH[a["to"]])
    if op == "QuantizeLinear":
        x, scale, zp = i
        info = torch.iinfo(zp.dtype)
        q = torch.round(x / scale) + zp.to(torch.promote_types(x.dtype, scale.dtype))  # half to even, as np.rint
        return torch.clamp(q, info.min, info.max).to(zp.dtype)
    if op == "DequantizeLinear":
        q, scale, zp = i
        if scale.dim() == 1 and scale.numel() > 1:  # per-channel
            shape = [1] * q.dim()
            shape[a.get("axis", 1)] = scale.numel()
            scale, zp = scale.reshape(shape), zp.reshape(shape)
        return (q.float() - zp.float()) * scale
    if op == "MaxPool":
        kh, kw = a["kernel_shape"]
        pt, pl, pb, pr = a.get("pads", [0, 0, 0, 0])
        x = F.pad(i[0], (pl, pr, pt, pb), value=-float("inf"))
        return F.max_pool2d(x, (kh, kw), tuple(a.get("strides", [1, 1])))
    raise NotImplementedError(f"op {op}")


def run(
    model: OnnxModel,
    feeds: Dict[str, Any],
    collect: Optional[List[str]] = None,
    device: DeviceLike = None,
    initializers: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Execute the graph on `device` (CUDA unless the caller asks for the
    CPU); the outputs are tensors there. With `collect`, also return those
    intermediate tensors (the calibration of int8 exports reads the Conv
    inputs). `initializers`: those of `device_initializers`, to reuse."""
    device = resolve_device(device)
    env: Dict[str, Any] = dict(initializers if initializers is not None else device_initializers(model, device))
    for k, v in feeds.items():
        v = torch.as_tensor(v).to(device)
        env[k] = v.float() if v.dtype == torch.float64 else v
    for node in model.nodes:
        y = _node(node.op_type, [env[n] if n else None for n in node.inputs], node.attrs)
        env[node.outputs[0]] = y.float() if y.dtype == torch.float64 else y
    out = {name: env[name] for name in model.output_names}
    if collect is not None:
        out.update({name: env[name] for name in collect})
    return out


class TorchOnnxSession:
    """onnxruntime-like facade over `run` on one device (the counterpart of
    the JAX package's `JaxOnnxSession`): the float and 8-bit initializers
    go to the device once, here; `run` executes under `f32_eval` (no TF32,
    no autocast: rounded contractions trip the 6D head's orthonormality
    fallback) and `torch.inference_mode()`, and returns tensors on the
    device."""

    def __init__(self, path_or_bytes, device: DeviceLike = None):
        if isinstance(path_or_bytes, str):
            with open(path_or_bytes, "rb") as f:
                path_or_bytes = f.read()
        self.device = resolve_device(device)
        self.model = load_model(path_or_bytes)
        self._inits = device_initializers(self.model, self.device)

    @property
    def output_names(self) -> List[str]:
        return self.model.output_names

    @property
    def model_version(self) -> int:
        return self.model.model_version

    @property
    def input_dims(self) -> Dict[str, List[Optional[int]]]:
        return self.model.input_dims

    def run(self, output_names, feeds, collect: Optional[List[str]] = None) -> List[torch.Tensor]:
        """The outputs `output_names` (all when None), then those of `collect`."""
        from neuralnet_tracker_traincode_torch.eval.predictor import f32_eval

        with f32_eval(self.device), torch.inference_mode():
            out = run(self.model, feeds, collect, self.device, self._inits)
        names = list(output_names or self.model.output_names) + list(collect or [])
        return [out[n] for n in names]
