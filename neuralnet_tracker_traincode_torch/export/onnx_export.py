"""Export trained networks to ONNX for the opentrack plugin (counterpart of
the JAX package's `export/onnx_export.py`, byte for byte).

Contract: the reference's `scripts/export_model.py`: opentrack output names
(coord -> pos_size, pose -> quat, roi -> box, *_scales), opset 13,
model_version 4, denormal scrubbing, BatchNorm folded into the convolutions.
The graph is written with `onnx_proto.py` (no `onnx` package); with BN
folded it is already "simplified" (the reference runs onnxsim for this).

The builders take the port's modules and read their weights through the
port's bridge (`models/weights.py:posenet_variables_to_jax`,
`localizer_variables_to_jax`): numpy arrays in the JAX layout. So the
folding and every constant are the same numpy f32 arithmetic as the JAX
exporter's, in the same order, and the nodes are emitted in the same order
(a counter names every tensor): the same weights give the same bytes.

Pose network configurations: mobilenetv1 and resnet18 (each with and
without BlurPool), efficientnet_b0 to b4, and hybrid_vit (attention
decomposed to MatMul/Softmax, LayerNorm to opset-13 primitives); the
quaternion and 6D rotation heads; with and without uncertainty. Outputs:
 - outputs='opentrack' (default): pos_size, quat, box (+ *_scales), the
   subset the opentrack plugin reads (reference `ModelForOpenTrack`);
 - outputs='full': every eval-forward output under its own name (coord,
   pose, roi, unnormalized_quat or unnormalized_6drepr, pt3d_68,
   shapeparam, hasface, + scales), for landmark evaluation and
   pseudo-labelling from the file (reference `ExportModel`).

Inputs are NCHW float32 like the reference's exports.
"""

import math
from typing import List, Optional, Sequence

import numpy as np

from neuralnet_tracker_traincode_torch.device import DeviceLike
from neuralnet_tracker_traincode_torch.export import onnx_proto as P

BN_EPS = 1e-5


def clear_denormals(tree, threshold=1e-20):
    """Zero out tiny weights (reference `export_model.py:36-50`) in a nested
    dict (or list) of arrays; every leaf comes back as a numpy array."""
    if isinstance(tree, dict):
        return {k: clear_denormals(v, threshold) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clear_denormals(v, threshold) for v in tree)
    x = np.asarray(tree)
    if x.dtype in (np.float32, np.float64):
        x = np.where(np.abs(x) < threshold, 0.0, x)
    return x


def _np_smoothclip0(x):
    return np.where(x > 0, x + 1.0, np.exp(x))


class GraphBuilder:
    def __init__(self, fp16: bool = False):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._counter = 0
        # fp16 graphs store every float initializer as FLOAT16; callers cast
        # the graph input to fp16 and the outputs back to fp32 (same boundary
        # contract as the reference's onnxconverter fp16 pass,
        # reference export_model.py's --posehalf path).
        self.fp16 = fp16
        # Static PTQ (QDQ form): per-conv-index activation (min, max) ranges.
        # Mirrors the reference's backbone-only FX PTQ (quint8 per-tensor
        # activations, qint8 per-channel-symmetric weights, avgpool/heads
        # fp32; reference export_model.py:53-113) — the convs are exactly
        # the backbone here (heads are Gemm).
        self.quant_ranges: Optional[Sequence] = None
        self._conv_quant_idx = 0

    @property
    def float_ty(self):
        return P.FLOAT16 if self.fp16 else P.FLOAT

    def fresh(self, hint="t"):
        self._counter += 1
        return f"{hint}_{self._counter}"

    def init_tensor(self, array, hint="const"):
        array = np.ascontiguousarray(array)
        if self.fp16 and array.dtype == np.float32:
            array = array.astype(np.float16)
        name = self.fresh(hint)
        self.initializers.append(P.tensor_proto(name, array))
        return name

    def node(self, op, inputs, n_out=1, hint=None, **attrs):
        outs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(P.node_proto(op, inputs, outs, name=self.fresh(op), **attrs))
        return outs[0] if n_out == 1 else outs

    def rename_output(self, src: str, dst: str):
        self.nodes.append(P.node_proto("Identity", [src], [dst], name=self.fresh("Identity")))
        return dst

    # --- quantization helpers ------------------------------------------------
    def _qdq_activation(self, x, lo, hi):
        scale = max((float(hi) - float(lo)) / 255.0, 1e-8)
        zp = int(np.clip(round(-float(lo) / scale), 0, 255))
        s = self.init_tensor(np.asarray(scale, np.float32), "qs")
        z = self.init_tensor(np.asarray(zp, np.uint8), "qz")
        q = self.node("QuantizeLinear", [x, s, z])
        return self.node("DequantizeLinear", [q, s, z])

    def _qdq_weight(self, w_oihw):
        absmax = np.abs(w_oihw).reshape(w_oihw.shape[0], -1).max(axis=1)
        scale = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
        wq = np.clip(
            np.rint(w_oihw / scale[:, None, None, None]), -127, 127
        ).astype(np.int8)
        s = self.init_tensor(scale, "wqs")
        z = self.init_tensor(np.zeros(w_oihw.shape[0], np.int8), "wqz")
        q = self.init_tensor(wq, "Wq")
        return self.node("DequantizeLinear", [q, s, z], axis=0)

    # --- common op helpers ---------------------------------------------------
    def conv(self, x, weight_oihw, bias, stride=1, group=1, pads=None):
        w_arr = weight_oihw.astype(np.float32)
        if self.quant_ranges is not None:
            lo, hi = self.quant_ranges[self._conv_quant_idx]
            self._conv_quant_idx += 1
            x = self._qdq_activation(x, lo, hi)
            w = self._qdq_weight(w_arr)
        else:
            w = self.init_tensor(w_arr, "W")
        inputs = [x, w]
        if bias is not None:
            inputs.append(self.init_tensor(bias.astype(np.float32), "B"))
        kh, kw = weight_oihw.shape[2], weight_oihw.shape[3]
        if pads is None:
            pads = [kh // 2, kw // 2, kh // 2, kw // 2]
        return self.node(
            "Conv", inputs, strides=[stride, stride], group=group, pads=pads,
            kernel_shape=[kh, kw],
        )

    def gemm(self, x, weight_in_out, bias):
        w = self.init_tensor(weight_in_out.T.astype(np.float32), "Wfc")  # (out, in)
        b = self.init_tensor(bias.astype(np.float32), "Bfc")
        return self.node("Gemm", [x, w, b], transB=1)

    def relu(self, x):
        return self.node("Relu", [x])

    def sigmoid(self, x):
        return self.node("Sigmoid", [x])

    def silu(self, x):
        return self.mul(x, self.sigmoid(x))

    def smoothclip0(self, x):
        e = self.node("Elu", [x], alpha=1.0)
        one = self.init_tensor(np.asarray([1.0], np.float32), "one")
        return self.node("Add", [e, one])

    def add(self, a, b):
        return self.node("Add", [a, b])

    def mul(self, a, b):
        return self.node("Mul", [a, b])

    def sub(self, a, b):
        return self.node("Sub", [a, b])

    def concat(self, xs, axis=1):
        return self.node("Concat", xs, axis=axis)

    def slice_(self, x, starts, ends, axes):
        s = self.init_tensor(np.asarray(starts, np.int64), "starts")
        e = self.init_tensor(np.asarray(ends, np.int64), "ends")
        a = self.init_tensor(np.asarray(axes, np.int64), "axes")
        return self.node("Slice", [x, s, e, a])

    def reshape(self, x, shape):
        return self.node(
            "Reshape", [x, self.init_tensor(np.asarray(shape, np.int64), "shape")]
        )

    def unsqueeze(self, x, axes):
        return self.node(
            "Unsqueeze", [x, self.init_tensor(np.asarray(axes, np.int64), "uax")]
        )

    def transpose(self, x, perm):
        return self.node("Transpose", [x], perm=list(perm))

    def matmul(self, a, b):
        return self.node("MatMul", [a, b])

    def expand_batch(self, const_1x, ref):
        """Broadcast a (1, ...)-shaped constant across `ref`'s dynamic batch:
        ReduceMean(ref*0) + const. Arithmetic broadcasting keeps the graph
        free of Shape/Expand (same trick as const_like_rowvec). `ref` must
        have the same rank as the constant."""
        zero = self.init_tensor(np.asarray([0.0], np.float32), "zero")
        z = self.mul(ref, zero)
        z = self.node("ReduceMean", [z], axes=list(range(1, const_1x.ndim)), keepdims=1)
        return self.add(z, self.init_tensor(const_1x, "bconst"))

    def const_like_rowvec(self, ref2d, values):
        """Broadcast a constant (C,) row vector to ref2d's batch: ref*0 + const.

        ReduceMean keeps its axes ATTRIBUTE in opset 13 (ReduceSum does not).
        """
        zero = self.init_tensor(np.asarray([0.0], np.float32), "zero")
        z = self.mul(ref2d, zero)
        c = self.init_tensor(np.asarray(values, np.float32)[None, :], "rowconst")
        z1 = self.node("ReduceMean", [z], axes=[1], keepdims=1)
        return self.add(z1, c)


def _fold_bn(kernel_hwio, bn_scale, bn_bias, bn_mean, bn_var, eps=BN_EPS):
    """Fold BatchNorm into the preceding conv. Returns (OIHW weight, bias)."""
    std = np.sqrt(bn_var + eps)
    factor = bn_scale / std  # (Cout,)
    w = np.transpose(kernel_hwio, (3, 2, 0, 1))  # HWIO -> OIHW
    w = w * factor[:, None, None, None]
    b = bn_bias - bn_mean * factor
    return w.astype(np.float32), b.astype(np.float32)


def _fold_scope(params, stats, conv_name, bn_name, eps=BN_EPS):
    return _fold_bn(
        np.asarray(params[conv_name]["kernel"]),
        np.asarray(params[bn_name]["scale"]), np.asarray(params[bn_name]["bias"]),
        np.asarray(stats[bn_name]["mean"]), np.asarray(stats[bn_name]["var"]),
        eps=eps,
    )


def _emit_blurpool(g: GraphBuilder, x, channels: int, kernel_size: int = 3, stride: int = 2):
    """Anti-aliased downsample: depthwise conv with the fixed Pascal kernel.

    Matches `models/backbones/common.py:BlurPool2D` (zero padding (k-1)//2,
    kornia `_blur_pool_by_kernel2d` semantics).
    """
    from neuralnet_tracker_traincode_torch.models.components import pascal_kernel_2d

    k = pascal_kernel_2d(kernel_size)  # (k, k), normalized
    w = np.broadcast_to(
        k[None, None, :, :], (channels, 1, kernel_size, kernel_size)
    ).astype(np.float32)
    pad = (kernel_size - 1) // 2
    return g.conv(x, w, None, stride=stride, group=channels, pads=[pad] * 4)


def _emit_mobilenet(g: GraphBuilder, x, params, stats, use_blurpool=False):
    """MobileNetV1 backbone -> pooled feature vector node name."""

    w, b = _fold_scope(params, stats, "conv1", "bn1")
    x = g.conv(x, w, b, stride=2)
    x = g.relu(x)

    block_strides = [
        ("dw2_1", 1), ("dw2_2", 2), ("dw3_1", 1), ("dw3_2", 2),
        ("dw4_1", 1), ("dw4_2", 2), ("dw5_1", 1), ("dw5_2", 1),
        ("dw5_3", 1), ("dw5_4", 1), ("dw5_5", 1), ("dw5_6", 2),
        ("dw6", 1),
    ]
    channels = w.shape[0]
    for name, stride in block_strides:
        bp = params[name]
        bs = stats[name]
        wd, bd = _fold_scope(bp, bs, "conv_dw", "bn_dw")
        residual = x
        if stride == 2 and use_blurpool:
            # DepthWiseBlock: blurpool then a stride-1 depthwise conv
            # (`mobilenet_v1.py:30-34`).
            x = _emit_blurpool(g, x, channels=channels)
            conv_stride = 1
        else:
            conv_stride = stride
        h = g.conv(x, wd, bd, stride=conv_stride, group=channels)
        h = g.relu(h)
        ws, bs_ = _fold_scope(bp, bs, "conv_sep", "bn_sep")
        planes = ws.shape[0]
        h = g.conv(h, ws, bs_, stride=1, group=1, pads=[0, 0, 0, 0])
        if stride == 1 and channels == planes:
            h = g.add(h, residual)
        x = g.relu(h)
        channels = planes

    pooled = g.node("GlobalAveragePool", [x])
    return g.node("Flatten", [pooled], axis=1)


def _emit_resnet18(g: GraphBuilder, x, params, stats, use_blurpool=False):
    """ResNet-18 backbone -> pooled 512-d feature node name.

    Mirrors `models/backbones/resnet.py` (torchvision resnet18 topology,
    1-channel 7x7 stem); BN folded into the convs. With blurpool, EVERY block
    blurs before conv1 (stride-1 blocks get a pure blur) and the stem maxpool
    becomes a blurpool — reference CustomBlock semantics.
    """

    w, b = _fold_scope(params, stats, "conv1", "bn1")
    x = g.conv(x, w, b, stride=2, pads=[3, 3, 3, 3])
    x = g.relu(x)
    if use_blurpool:
        x = _emit_blurpool(g, x, channels=w.shape[0])
    else:
        x = g.node("MaxPool", [x], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])

    for stage, num_blocks in enumerate([2, 2, 2, 2]):
        for blk in range(num_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            bp = params[f"layer{stage + 1}_{blk}"]
            bs = stats[f"layer{stage + 1}_{blk}"]
            identity = x
            w1, b1 = _fold_scope(bp, bs, "conv1", "bn1")
            y = x
            if use_blurpool:
                y = _emit_blurpool(g, y, channels=w1.shape[1], stride=stride)
                first_stride = 1
            else:
                first_stride = stride
            h = g.relu(g.conv(y, w1, b1, stride=first_stride))
            w2, b2 = _fold_scope(bp, bs, "conv2", "bn2")
            h = g.conv(h, w2, b2, stride=1)
            if "downsample_conv" in bp:
                wd, bd = _fold_scope(bp, bs, "downsample_conv", "downsample_bn")
                identity = g.conv(x, wd, bd, stride=stride, pads=[0, 0, 0, 0])
            x = g.relu(g.add(h, identity))

    pooled = g.node("GlobalAveragePool", [x])
    return g.node("Flatten", [pooled], axis=1)


def _emit_efficientnet(g: GraphBuilder, x, params, stats, kind: str):
    """EfficientNet b0..b4 backbone -> pooled feature vector node name.

    Mirrors `models/backbones/efficientnet.py` (BN eps 1e-5 as in torchvision
    V1, SiLU, SE blocks, 1->3 channel input adapter; stochastic depth is
    identity at eval).
    """
    from neuralnet_tracker_traincode_torch.models.backbones.efficientnet import scaled_settings

    EPS = 1e-5
    # 1x1 input adapter (has a bias, no BN).
    w = np.transpose(np.asarray(params["to_3chn_input"]["kernel"]), (3, 2, 0, 1))
    x = g.conv(x, w, np.asarray(params["to_3chn_input"]["bias"]), pads=[0, 0, 0, 0])

    w, b = _fold_scope(params, stats, "stem_conv", "stem_bn", eps=EPS)
    x = g.silu(g.conv(x, w, b, stride=2, pads=[1, 1, 1, 1]))

    settings, _ = scaled_settings(kind)
    for stage_idx, cfg in enumerate(settings):
        for layer_idx in range(cfg.num_layers):
            stride = cfg.stride if layer_idx == 0 else 1
            bp = params[f"stage{stage_idx + 1}_{layer_idx}"]
            bs = stats[f"stage{stage_idx + 1}_{layer_idx}"]
            h = x
            if cfg.expand_ratio != 1:
                we, be = _fold_scope(bp, bs, "expand_conv", "expand_bn", eps=EPS)
                h = g.silu(g.conv(h, we, be, pads=[0, 0, 0, 0]))
            wd, bd = _fold_scope(bp, bs, "dw_conv", "dw_bn", eps=EPS)
            expanded = wd.shape[0]
            pad = cfg.kernel // 2
            h = g.silu(g.conv(h, wd, bd, stride=stride, group=expanded, pads=[pad] * 4))
            # Squeeze-excitation: pooled -> fc1 -> silu -> fc2 -> sigmoid -> scale.
            se = bp["se"]
            s = g.node("GlobalAveragePool", [h])
            w1 = np.transpose(np.asarray(se["fc1"]["kernel"]), (3, 2, 0, 1))
            s = g.silu(g.conv(s, w1, np.asarray(se["fc1"]["bias"]), pads=[0, 0, 0, 0]))
            w2 = np.transpose(np.asarray(se["fc2"]["kernel"]), (3, 2, 0, 1))
            s = g.sigmoid(g.conv(s, w2, np.asarray(se["fc2"]["bias"]), pads=[0, 0, 0, 0]))
            h = g.mul(h, s)
            wp, bpj = _fold_scope(bp, bs, "project_conv", "project_bn", eps=EPS)
            h = g.conv(h, wp, bpj, pads=[0, 0, 0, 0])
            # Residual when shapes match: repeated layers in a stage always do
            # (their input is already out_ch); a stage's first layer only if
            # stride 1 and in_ch == out_ch.
            if stride == 1 and (layer_idx > 0 or cfg.in_ch == cfg.out_ch):
                h = g.add(h, x)
            x = h

    w, b = _fold_scope(params, stats, "head_conv", "head_bn", eps=EPS)
    x = g.silu(g.conv(x, w, b, pads=[0, 0, 0, 0]))
    pooled = g.node("GlobalAveragePool", [x])
    return g.node("Flatten", [pooled], axis=1)


def _emit_layernorm(g: GraphBuilder, x, ln_params, eps=1e-5):
    """LayerNorm over the last axis, decomposed for opset 13 (the dedicated
    LayerNormalization op only exists from opset 17)."""
    scale = np.asarray(ln_params["scale"], np.float32)
    bias = np.asarray(ln_params["bias"], np.float32)
    mean = g.node("ReduceMean", [x], axes=[-1], keepdims=1)
    d = g.sub(x, mean)
    var = g.node("ReduceMean", [g.mul(d, d)], axes=[-1], keepdims=1)
    std = g.node("Sqrt", [g.add(var, g.init_tensor(np.asarray(eps, np.float32), "lneps"))])
    y = g.node("Div", [d, std])
    y = g.mul(y, g.init_tensor(scale[None, None, :], "lnw"))
    return g.add(y, g.init_tensor(bias[None, None, :], "lnb"))


def _emit_mha(g: GraphBuilder, q_in, kv_in, p, d_model=256, nhead=8):
    """Multi-head attention decomposed to MatMul/Softmax (flax
    MultiHeadDotProductAttention semantics: logits scaled by 1/sqrt(hd))."""
    hd = d_model // nhead

    def proj(x, pr):
        k = np.asarray(pr["kernel"], np.float32).reshape(d_model, d_model)  # (in, h*hd)
        b = np.asarray(pr["bias"], np.float32).reshape(d_model)
        y = g.add(g.matmul(x, g.init_tensor(k, "Wqkv")), g.init_tensor(b[None, None, :], "bqkv"))
        y = g.reshape(y, [0, -1, nhead, hd])
        return g.transpose(y, (0, 2, 1, 3))  # (B, h, L, hd)

    qh = proj(q_in, p["query"])
    kh = proj(kv_in, p["key"])
    vh = proj(kv_in, p["value"])
    scale = g.init_tensor(np.asarray(1.0 / math.sqrt(hd), np.float32), "attnscale")
    logits = g.mul(g.matmul(qh, g.transpose(kh, (0, 1, 3, 2))), scale)
    w = g.node("Softmax", [logits], axis=-1)
    o = g.transpose(g.matmul(w, vh), (0, 2, 1, 3))  # (B, L, h, hd)
    o = g.reshape(o, [0, -1, d_model])
    ok = np.asarray(p["out"]["kernel"], np.float32).reshape(d_model, d_model)  # (h*hd, d)
    ob = np.asarray(p["out"]["bias"], np.float32)
    return g.add(g.matmul(o, g.init_tensor(ok, "Wo")), g.init_tensor(ob[None, None, :], "bo"))


def _emit_transformer_ffn(g: GraphBuilder, x, p):
    def dense(h, pr):
        k = np.asarray(pr["kernel"], np.float32)
        b = np.asarray(pr["bias"], np.float32)
        return g.add(g.matmul(h, g.init_tensor(k, "Wff")), g.init_tensor(b[None, None, :], "bff"))

    return dense(g.relu(dense(x, p["linear1"])), p["linear2"])


def _emit_hybrid_vit(g: GraphBuilder, x, params, stats, num_heads: int):
    """Hybrid CNN/Transformer backbone -> list of per-query feature nodes.

    Mirrors `models/backbones/hybrid_vit.py` (reference
    `trackertraincode/backbones/hybrid_vit.py:8-96`): bare 7x7 stride-2 stem
    conv (no BN — reference quirk), resnet18 stages, 1x1 proj + BN, learned
    position channels, cls token, post-LN 1+1 layer transformer with learned
    queries. Attention decomposes to MatMul/Softmax; LayerNorm to
    ReduceMean/Sqrt (opset-13 safe). The reference exports this via
    torch.onnx (`scripts/export_model.py:201-279`)."""
    w_stem = np.transpose(np.asarray(params["stem"]["kernel"]), (3, 2, 0, 1))
    x = g.conv(x, w_stem.astype(np.float32), None, stride=2, pads=[3, 3, 3, 3])

    for stage in range(4):
        for blk in range(2):
            stride = 2 if (stage > 0 and blk == 0) else 1
            bp = params[f"layer{stage + 1}_{blk}"]
            bs = stats[f"layer{stage + 1}_{blk}"]
            identity = x
            w1, b1 = _fold_scope(bp, bs, "conv1", "bn1")
            h = g.relu(g.conv(x, w1, b1, stride=stride))
            w2, b2 = _fold_scope(bp, bs, "conv2", "bn2")
            h = g.conv(h, w2, b2, stride=1)
            if "downsample_conv" in bp:
                wd, bd = _fold_scope(bp, bs, "downsample_conv", "downsample_bn")
                identity = g.conv(x, wd, bd, stride=stride, pads=[0, 0, 0, 0])
            x = g.relu(g.add(h, identity))

    wp, bpj = _fold_scope(params, stats, "proj_conv", "proj_bn")
    z = g.conv(x, wp, bpj, pads=[0, 0, 0, 0])  # (B, 248, H, W)

    pos = np.asarray(params["position"], np.float32)  # (1, H, W, 8)
    _, H, W, penc = pos.shape
    d_model = wp.shape[0] + penc
    pos_nchw = np.transpose(pos, (0, 3, 1, 2)).copy()
    z = g.concat([z, g.expand_batch(pos_nchw, z)], axis=1)  # (B, 256, H, W)
    z = g.reshape(z, [0, d_model, H * W])
    z = g.transpose(z, (0, 2, 1))  # (B, HW, 256)
    cls = np.asarray(params["cls_token"], np.float32)  # (1, 1, 256)
    z = g.concat([g.expand_batch(cls, z), z], axis=1)  # (B, HW+1, 256)

    # Encoder layer (post-LN) + final encoder norm.
    enc = params["transformer_encoder"]
    att = _emit_mha(g, z, z, enc["self_attn"], d_model)
    z = _emit_layernorm(g, g.add(z, att), enc["norm1"])
    z = _emit_layernorm(g, g.add(z, _emit_transformer_ffn(g, z, enc)), enc["norm2"])
    memory = _emit_layernorm(g, z, params["transformer_encoder_norm"])

    # Decoder layer over the learned queries + final decoder norm.
    queries = np.asarray(params["queries"], np.float32)[:, :num_heads, :]
    tgt = g.expand_batch(queries.copy(), memory)
    dec = params["transformer_decoder"]
    att = _emit_mha(g, tgt, tgt, dec["self_attn"], d_model)
    tgt = _emit_layernorm(g, g.add(tgt, att), dec["norm1"])
    cross = _emit_mha(g, tgt, memory, dec["cross_attn"], d_model)
    tgt = _emit_layernorm(g, g.add(tgt, cross), dec["norm2"])
    tgt = _emit_layernorm(g, g.add(tgt, _emit_transformer_ffn(g, tgt, dec)), dec["norm3"])
    out = _emit_layernorm(g, tgt, params["transformer_decoder_norm"])  # (B, nq, 256)

    return [
        g.reshape(g.slice_(out, [i], [i + 1], [1]), [-1, d_model])
        for i in range(num_heads)
    ]


def _emit_backbone(g: GraphBuilder, x, model, params, stats):
    bargs = dict(model.backbone_args or {})
    use_blurpool = bool(bargs.get("use_blurpool"))
    if model.config == "mobilenetv1":
        return _emit_mobilenet(g, x, params["convnet"], stats["convnet"], use_blurpool)
    if model.config == "resnet18":
        return _emit_resnet18(g, x, params["convnet"], stats["convnet"], use_blurpool)
    if model.config.startswith("efficientnet_"):
        kind = model.config[len("efficientnet_"):]
        return _emit_efficientnet(g, x, params["convnet"], stats["convnet"], kind)
    if model.config == "hybrid_vit":
        return _emit_hybrid_vit(
            g, x, params["convnet"], stats["convnet"], model.num_heads
        )
    raise ValueError(f"ONNX export does not support backbone {model.config!r}")


def _np_quat_mult(u, v):
    """Hamilton product (i, j, k, w) in numpy f32, term for term the JAX
    package's `ops/quaternion.py:mult`."""
    ux, uy, uz, uw = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    vx, vy, vz, vw = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return np.stack(
        [
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
            uw * vw - ux * vx - uy * vy - uz * vz,
        ],
        axis=-1,
    )


def _np_quat_rotate(q, p):
    """q * (p, 0) * conj(q), the JAX package's `ops/quaternion.py:rotate`."""
    pq = np.concatenate([p, np.zeros_like(p[..., :1])], axis=-1)
    conj = q * np.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)
    return _np_quat_mult(_np_quat_mult(q, pq), conj)[..., :3]


def _quat_mult_const_right(g: GraphBuilder, q, v_const):
    """Emit q' = mult(q, v_const): linear in q => single MatMul."""
    M = np.stack(
        [_np_quat_mult(e, np.asarray(v_const, np.float32)) for e in np.eye(4, dtype=np.float32)],
        axis=0,
    )  # row i = mult(e_i, v) => q' = q @ M
    m = g.init_tensor(M.astype(np.float32), "quat_offset_M")
    return g.node("MatMul", [q, m])


def _rotate_const_vector(g: GraphBuilder, q, t_const):
    """Emit rotate(q, t_const) (quadratic in q) via outer-product + Gemm."""

    def rot(qv):
        return _np_quat_rotate(np.asarray(qv, np.float32), np.asarray(t_const, np.float32))

    eye = np.eye(4, dtype=np.float32)
    C = np.zeros((16, 3), np.float32)
    for j in range(4):
        rj = rot(eye[j])
        C[j * 4 + j] = rj
        for k in range(j + 1, 4):
            cross = 0.5 * (rot(eye[j] + eye[k]) - rot(eye[j]) - rot(eye[k]))
            C[j * 4 + k] += cross
            C[k * 4 + j] += cross
    q_col = g.unsqueeze(q, [2])
    q_row = g.unsqueeze(q, [1])
    outer = g.mul(q_col, q_row)  # (N, 4, 4)
    flat = g.reshape(outer, [-1, 16])
    c = g.init_tensor(C, "rot_quadratic_C")
    return g.node("MatMul", [flat, c])  # (N, 3)


def _emit_quat_tomatrix(g: GraphBuilder, q):
    """Normalized quaternion (N, 4) -> rotation matrix (N, 3, 3), row-major.

    Mirrors `ops/quaternion.py:tomatrix`.
    """
    qi = g.slice_(q, [0], [1], [1])
    qj = g.slice_(q, [1], [2], [1])
    qk = g.slice_(q, [2], [3], [1])
    qw = g.slice_(q, [3], [4], [1])
    one = g.init_tensor(np.asarray([1.0], np.float32), "one")
    two = g.init_tensor(np.asarray([2.0], np.float32), "two")

    def d2(a, b):  # 2*a*b
        return g.mul(two, g.mul(a, b))

    m00 = g.sub(one, d2(qj, qj))
    m00 = g.sub(m00, d2(qk, qk))
    m11 = g.sub(one, d2(qi, qi))
    m11 = g.sub(m11, d2(qk, qk))
    m22 = g.sub(one, d2(qi, qi))
    m22 = g.sub(m22, d2(qj, qj))
    m01 = g.sub(d2(qi, qj), d2(qk, qw))
    m10 = g.add(d2(qi, qj), d2(qk, qw))
    m02 = g.add(d2(qi, qk), d2(qj, qw))
    m20 = g.sub(d2(qi, qk), d2(qj, qw))
    m12 = g.sub(d2(qj, qk), d2(qi, qw))
    m21 = g.add(d2(qj, qk), d2(qi, qw))
    flat = g.concat([m00, m01, m02, m10, m11, m12, m20, m21, m22], axis=1)  # (N, 9)
    return g.reshape(flat, [-1, 3, 3])


def _emit_from_matrix(g: GraphBuilder, m):
    """Rotation matrix (N, 3, 3) -> quaternion (N, 4), positive real part.

    Mirrors `ops/quaternion.py:from_matrix` (best-conditioned-of-4 candidates
    picked by argmax over the sqrt arguments), in standard opset-13 ops.
    """
    f = g.reshape(m, [-1, 9])  # row-major: m[i, j] = column 3*i + j
    e = {(i, j): g.slice_(f, [3 * i + j], [3 * i + j + 1], [1]) for i in range(3) for j in range(3)}
    one = g.init_tensor(np.asarray([1.0], np.float32), "one")
    quart = g.init_tensor(np.asarray([0.25], np.float32), "quart")
    half = g.init_tensor(np.asarray([0.5], np.float32), "half")

    m00, m11, m22 = e[(0, 0)], e[(1, 1)], e[(2, 2)]
    sq_k = g.add(g.sub(g.sub(e[(2, 2)], m00), m11), one)    # -m00 - m11 + m22 + 1
    sq_j = g.add(g.sub(g.sub(m11, m00), m22), one)          # -m00 + m11 - m22 + 1
    sq_i = g.add(g.sub(g.sub(m00, m11), m22), one)          # +m00 - m11 - m22 + 1
    sq_w = g.add(g.add(g.add(m00, m11), m22), one)          # +m00 + m11 + m22 + 1
    sqrt_args = g.concat([sq_k, sq_j, sq_i, sq_w], axis=1)  # (N, 4)
    sqrt_args = g.node(
        "Clip", [sqrt_args, g.init_tensor(np.asarray(1e-6, np.float32), "minclip"), ""]
    )
    roots = g.mul(half, g.node("Sqrt", [sqrt_args]))  # 0.5 sqrt: [qk|k, qj|j, qi|i, qw|w]
    qk_k = g.slice_(roots, [0], [1], [1])
    qj_j = g.slice_(roots, [1], [2], [1])
    qi_i = g.slice_(roots, [2], [3], [1])
    qw_w = g.slice_(roots, [3], [4], [1])

    def od(a, b, sign, denom):  # 0.25 (a + sign b) / denom
        s = g.add(a, b) if sign > 0 else g.sub(a, b)
        return g.node("Div", [g.mul(quart, s), denom])

    qw_k = od(e[(1, 0)], e[(0, 1)], -1, qk_k)
    qi_k = od(e[(2, 0)], e[(0, 2)], +1, qk_k)
    qj_k = od(e[(1, 2)], e[(2, 1)], +1, qk_k)
    qw_j = od(e[(0, 2)], e[(2, 0)], -1, qj_j)
    qi_j = od(e[(1, 0)], e[(0, 1)], +1, qj_j)
    qk_j = od(e[(1, 2)], e[(2, 1)], +1, qj_j)
    qw_i = od(e[(2, 1)], e[(1, 2)], -1, qi_i)
    qj_i = od(e[(1, 0)], e[(0, 1)], +1, qi_i)
    qk_i = od(e[(0, 2)], e[(2, 0)], +1, qi_i)
    qi_w = od(e[(2, 1)], e[(1, 2)], -1, qw_w)
    qj_w = od(e[(0, 2)], e[(2, 0)], -1, qw_w)
    qk_w = od(e[(1, 0)], e[(0, 1)], -1, qw_w)

    cands = [
        g.concat([qi_k, qj_k, qk_k, qw_k], axis=1),
        g.concat([qi_j, qj_j, qk_j, qw_j], axis=1),
        g.concat([qi_i, qj_i, qk_i, qw_i], axis=1),
        g.concat([qi_w, qj_w, qk_w, qw_w], axis=1),
    ]
    cands3 = g.concat([g.unsqueeze(c, [1]) for c in cands], axis=1)  # (N, 4, 4)

    pick = g.node("ArgMax", [sqrt_args], axis=1, keepdims=1)  # (N, 1) int64
    pickf = g.node("Cast", [pick], to=g.float_ty)
    iota = g.init_tensor(np.arange(4, dtype=np.float32)[None, :], "iota4")
    onehot = g.node("Cast", [g.node("Equal", [pickf, iota])], to=g.float_ty)  # (N, 4)
    quat = g.reshape(g.matmul(g.unsqueeze(onehot, [1]), cands3), [-1, 4])
    # positivereal: q * sign(q_w)
    sign = g.node("Sign", [g.slice_(quat, [3], [4], [1])])
    return g.mul(quat, sign)


def _emit_6d_tomatrix(g: GraphBuilder, z6):
    """6D rotation features (N, 6) -> (N, 3, 3), `ops/rot6d.py:tomatrix`:
    cross products, row normalization (eps 1e-6), identity fallback when
    far from orthonormal (inf-norm of M M^T - I > 1e-3)."""

    def cross(a, b):  # (N, 3) x (N, 3)
        a0, a1, a2 = (g.slice_(a, [i], [i + 1], [1]) for i in range(3))
        b0, b1, b2 = (g.slice_(b, [i], [i + 1], [1]) for i in range(3))
        return g.concat(
            [
                g.sub(g.mul(a1, b2), g.mul(a2, b1)),
                g.sub(g.mul(a2, b0), g.mul(a0, b2)),
                g.sub(g.mul(a0, b1), g.mul(a1, b0)),
            ],
            axis=1,
        )

    x = g.slice_(z6, [0], [3], [1])
    y = g.slice_(z6, [3], [6], [1])
    zv = cross(x, y)
    yv = cross(zv, x)
    eps = g.init_tensor(np.asarray(1e-6, np.float32), "eps6d")

    def normalize(v):
        n = g.node("ReduceL2", [v], axes=[1], keepdims=1)
        n = g.node("Clip", [n, eps, ""])
        return g.node("Div", [v, n])

    rows = [g.unsqueeze(normalize(v), [1]) for v in (x, yv, zv)]
    m = g.concat(rows, axis=1)  # (N, 3, 3)

    eye = g.init_tensor(np.eye(3, dtype=np.float32)[None], "eye33")
    mmt = g.matmul(m, g.transpose(m, [0, 2, 1]))
    diff = g.node("Abs", [g.sub(mmt, eye)])
    badness = g.node("ReduceMax", [diff], axes=[1, 2], keepdims=1)  # (N, 1, 1)
    thresh = g.init_tensor(np.asarray(1e-3, np.float32), "badthresh")
    cond = g.node("Greater", [badness, thresh])
    return g.node("Where", [cond, eye, m])


def _emit_triangular_scale(g: GraphBuilder, features, neck_params):
    """FeaturesAsTriangularScale(3) -> (N, 3, 3) lower-triangular output."""
    k = np.asarray(neck_params["lin"]["kernel"])
    b = np.asarray(neck_params["lin"]["bias"])
    z = g.gemm(features, k, b)  # (N, 7): [multiplier_raw, 6 values]
    mult = g.smoothclip0(g.slice_(z, [0], [1], [1]))
    diag = g.smoothclip0(g.slice_(z, [1], [4], [1]))
    off = g.slice_(z, [4], [7], [1])
    vals = g.concat([diag, off], axis=1)  # (N, 6)
    vals = g.mul(vals, mult)
    min_diag = g.init_tensor(
        np.asarray([[1e-6, 1e-6, 1e-6, 0.0, 0.0, 0.0]], np.float32), "min_diag"
    )
    vals = g.add(vals, min_diag)
    z0 = g.slice_(vals, [0], [1], [1])
    z1 = g.slice_(vals, [1], [2], [1])
    z2 = g.slice_(vals, [2], [3], [1])
    z3 = g.slice_(vals, [3], [4], [1])
    z4 = g.slice_(vals, [4], [5], [1])
    z5 = g.slice_(vals, [5], [6], [1])
    zero = g.mul(z0, g.init_tensor(np.asarray([0.0], np.float32), "zero"))
    flat = g.concat([z0, zero, zero, z3, z1, zero, z4, z5, z2], axis=1)  # (N, 9)
    return g.reshape(flat, [-1, 3, 3])


def _np_diag_scale_param(params_scope) -> np.ndarray:
    """DiagonalScaleParameter as a constant: clip(h0) * clip(h1:) + 1e-6."""
    hidden = np.asarray(params_scope["hidden_scale"])
    return (_np_smoothclip0(hidden[:1]) * _np_smoothclip0(hidden[1:]) + 1e-6).astype(np.float32)


def _offset_constants(params, scope_name):
    """LocalToGlobalCoordinateOffset constants for convention slot 0.

    The exported graph has no `coord_convention_id` input — like the
    reference's deploy path it bakes in slot 0 (the reference exports the
    model called without set_id, which selects p[0:1];
    `modelcomponents.py:155-158`)."""
    p = np.asarray(params[scope_name]["p"])[0]
    angle = float(p[1])
    offset_quat = np.asarray(
        [math.sin(0.5 * angle), 0.0, 0.0, math.cos(0.5 * angle)], np.float32
    )
    offset_transl = np.asarray([0.0, p[1], p[2]], np.float32)
    offset_scale = float(_np_smoothclip0(np.asarray(p[3])))
    rot_x = np.asarray(
        [
            [1.0, 0.0, 0.0],
            [0.0, math.cos(angle), -math.sin(angle)],
            [0.0, math.sin(angle), math.cos(angle)],
        ],
        np.float32,
    )
    return offset_quat, offset_transl, offset_scale, rot_x


def _apply_offset_quat(g, quat, xy, size, oq, ot, osc):
    """Quaternion-repr LocalToGlobalCoordinateOffset; returns (quat', screen, scale)."""
    pred_quat = _quat_mult_const_right(g, quat, oq)
    scale = g.mul(size, g.init_tensor(np.asarray([osc], np.float32), "oscale"))
    rotated = _rotate_const_vector(g, quat, ot)  # (N, 3)
    pos_corr = g.mul(g.slice_(rotated, [0], [2], [1]), scale)
    screen = g.add(pos_corr, xy)
    return pred_quat, screen, scale


def _apply_offset_mat(g, m, xy, size, ot, osc, rot_x):
    """Matrix-repr LocalToGlobalCoordinateOffset; returns (m', screen, scale)."""
    pred_m = g.matmul(m, g.init_tensor(rot_x[None], "offset_rot_x"))
    scale = g.mul(size, g.init_tensor(np.asarray([osc], np.float32), "oscale"))
    rotated = g.reshape(
        g.matmul(m, g.init_tensor(ot.reshape(3, 1)[None], "offset_t")), [-1, 3]
    )
    pos_corr = g.mul(g.slice_(rotated, [0], [2], [1]), scale)
    screen = g.add(pos_corr, xy)
    return pred_m, screen, scale


def _emit_landmarks(g: GraphBuilder, features, R, screen, scale, lm_params):
    """Landmarks3dOutput: shapenet -> BFM blend -> rigid 2.5D transform.

    R: (N, 3, 3) rotation node; screen: (N, 2); scale: (N, 1).
    Returns (pt3d_68 (N, 68, 3), shapeparam (N, 50)).
    """
    from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel

    head = BFMModel(40, 10)
    shapeparam = g.gemm(
        features, np.asarray(lm_params["shapenet"]["kernel"]),
        np.asarray(lm_params["shapenet"]["bias"]),
    )  # (N, 50)
    W = np.asarray(head.scaled_bases).reshape(head.num_eigvecs, -1)  # (50, 204)
    mean = np.asarray(head.keypts).reshape(1, -1)  # (1, 204)
    pts = g.add(g.matmul(shapeparam, g.init_tensor(W, "bfm_eigvecs")),
                g.init_tensor(mean, "bfm_mean"))
    pts = g.reshape(pts, [-1, 68, 3])
    # rotate_points: p' = p @ R^T; then scale all axes, translate xy only.
    rot = g.matmul(pts, g.transpose(R, [0, 2, 1]))
    tmp = g.mul(rot, g.unsqueeze(scale, [2]))  # (N, 68, 3) * (N, 1, 1)
    xy = g.add(g.slice_(tmp, [0], [2], [2]), g.unsqueeze(screen, [1]))
    z = g.slice_(tmp, [2], [3], [2])
    pt3d = g.concat([xy, z], axis=2)
    return pt3d, shapeparam


def build_posenet_onnx(
    model, outputs: str = "opentrack", fp16: bool = False,
    quant_ranges: Optional[Sequence] = None,
) -> bytes:
    """Build the ONNX ModelProto bytes for the port's `NetworkWithPointHead`.

    outputs='opentrack': pos_size, quat, box (+ *_scales with uncertainty).
    outputs='full': all eval-forward outputs under their raw names (see module
    docstring) — feeds ONNX-based landmark eval and pseudo-labeling.
    fp16=True stores all weights as FLOAT16 and runs the graph in half
    precision between boundary casts (fp32 input/outputs).
    quant_ranges: per-conv-index activation (min, max) from
    `calibrate_conv_ranges` -> QDQ int8 backbone (heads stay fp32).
    """
    assert outputs in ("opentrack", "full"), outputs
    assert not (fp16 and quant_ranges is not None), "pick one of fp16/quantize"
    from neuralnet_tracker_traincode_torch.models.weights import posenet_variables_to_jax

    variables = posenet_variables_to_jax(model.state_dict(), model.get_config())
    params = variables["params"]
    stats = variables["batch_stats"]
    res = model.input_resolution

    g = GraphBuilder(fp16=fp16)
    g.quant_ranges = quant_ranges
    # The graph is NCHW like the reference's exports; the HWIO kernels of the
    # JAX layout are transposed to OIHW here, so no runtime transposes appear.
    x = "x"
    if fp16:
        x = g.node("Cast", [x], to=P.FLOAT16)
    features = _emit_backbone(g, x, model, params, stats)

    # Per-head features: the transformer neck yields one query output per
    # head (consumed in the same pop order as the flax/torch forward,
    # `models.py:340-376`); CNN necks share one pooled vector.
    if isinstance(features, list):
        zs = list(features)
    else:
        zs = [features] * model.num_heads
    f_box, f_pos, f_quat = zs.pop(), zs.pop(), zs.pop()
    f_lmk = zs.pop() if model.enable_point_head else None
    f_face = zs.pop() if model.enable_face_detector else None

    # Heads.
    box_z = g.gemm(
        f_box, np.asarray(params["boxnet"]["linear"]["kernel"]),
        np.asarray(params["boxnet"]["linear"]["bias"]),
    )
    box_center = g.slice_(box_z, [0], [2], [1])
    box_size = g.smoothclip0(g.slice_(box_z, [2], [4], [1]))
    box = g.concat([g.sub(box_center, box_size), g.add(box_center, box_size)], axis=1)

    xy = g.gemm(
        f_pos, np.asarray(params["posnet"]["linear_xy"]["kernel"]),
        np.asarray(params["posnet"]["linear_xy"]["bias"]),
    )
    size = g.smoothclip0(
        g.gemm(
            f_pos, np.asarray(params["posnet"]["linear_size"]["kernel"]),
            np.asarray(params["posnet"]["linear_size"]["bias"]),
        )
    )

    # Rotation head: hidden (pre-offset) representation.
    quat_z = g.gemm(
        f_quat, np.asarray(params["quatnet"]["linear"]["kernel"]),
        np.asarray(params["quatnet"]["linear"]["bias"]),
    )
    if model.enable_6drot:
        unnorm_name, unnorm_node, unnorm_dims = "unnormalized_6drepr", quat_z, 6
        hidden_mat = _emit_6d_tomatrix(g, quat_z)
        hidden_quat = None
    else:
        quat_ijk = g.slice_(quat_z, [0], [3], [1])
        quat_w = g.smoothclip0(g.slice_(quat_z, [3], [4], [1]))
        unnorm = g.concat([quat_ijk, quat_w], axis=1)
        norm = g.node("ReduceL2", [unnorm], axes=[1], keepdims=1)
        norm = g.node(
            "Clip",
            [norm, g.init_tensor(np.asarray(1e-6, np.float32), "minclip"), ""],
        )
        hidden_quat = g.node("Div", [unnorm, norm])
        hidden_mat = None
        unnorm_name, unnorm_node, unnorm_dims = "unnormalized_quat", unnorm, 4

    # Local->global pose offsets (convention slot 0 baked in; see
    # _offset_constants). The main offset feeds pose/coord; the _kpts variant
    # feeds the landmark head from the SAME hidden rotation (`models.py:352-366`).
    emit_landmarks = model.enable_point_head and outputs == "full"
    if model.use_local_pose_offset:
        oq, ot, osc, rot_x = _offset_constants(params, "local_pose_offset")
        if model.enable_6drot:
            global_mat, screen, scale = _apply_offset_mat(g, hidden_mat, xy, size, ot, osc, rot_x)
            pose = _emit_from_matrix(g, global_mat)
        else:
            pose, screen, scale = _apply_offset_quat(g, hidden_quat, xy, size, oq, ot, osc)
        coord = g.concat([screen, scale], axis=1)
        if emit_landmarks:
            oqk, otk, osck, rot_xk = _offset_constants(params, "local_pose_offset_kpts")
            if model.enable_6drot:
                mat_k, screen_k, scale_k = _apply_offset_mat(
                    g, hidden_mat, xy, size, otk, osck, rot_xk
                )
            else:
                quat_k, screen_k, scale_k = _apply_offset_quat(
                    g, hidden_quat, xy, size, oqk, otk, osck
                )
                mat_k = _emit_quat_tomatrix(g, quat_k)
    else:
        if model.enable_6drot:
            pose = _emit_from_matrix(g, hidden_mat)
        else:
            pose = hidden_quat
        coord = g.concat([xy, size], axis=1)
        if emit_landmarks:
            mat_k = hidden_mat if model.enable_6drot else _emit_quat_tomatrix(g, hidden_quat)
            screen_k, scale_k = xy, size

    if emit_landmarks:
        pt3d_68, shapeparam = _emit_landmarks(
            g, f_lmk, mat_k, screen_k, scale_k, params["landmarks"]
        )

    if outputs == "opentrack":
        output_infos = [
            ("pos_size", coord, 3),
            ("quat", pose, 4),
            ("box", box, 4),
        ]
    else:
        output_infos = [
            ("coord", coord, 3),
            ("pose", pose, 4),
            ("roi", box, 4),
            (unnorm_name, unnorm_node, unnorm_dims),
        ]
        if emit_landmarks:
            output_infos += [
                ("pt3d_68", pt3d_68, (68, 3)),
                ("shapeparam", shapeparam, 50),
            ]
        if model.enable_face_detector:
            logits2d = g.gemm(
                f_face, np.asarray(params["face_detector"]["kernel"]),
                np.asarray(params["face_detector"]["bias"]),
            )
            logits = g.reshape(logits2d, [-1])
            output_infos += [
                ("hasface_logits", logits, None),
                ("hasface", g.sigmoid(logits), None),
            ]

    if model.enable_uncertainty:
        coord_scales = _emit_triangular_scale(
            g, f_pos, params["posnet"]["uncertainty_scales"]["neck"]
        )
        pose_scales = _emit_triangular_scale(
            g, f_quat, params["quatnet"]["uncertainty_net"]["neck"]
        )
        roi_scales_const = _np_diag_scale_param(params["boxnet"]["uncertainty_scales"])
        roi_scales = g.const_like_rowvec(box, roi_scales_const)
        if outputs == "opentrack":
            output_infos += [
                ("pos_size_scales", coord_scales, (3, 3)),
                ("rotaxis_scales_tril", pose_scales, (3, 3)),
                ("box_scales", roi_scales, 4),
            ]
        else:
            output_infos += [
                ("coord_scales", coord_scales, (3, 3)),
                ("pose_scales_tril", pose_scales, (3, 3)),
                ("roi_scales", roi_scales, 4),
            ]
            if emit_landmarks:
                # Constant diagonal scales broadcast to the prediction shapes.
                pt_scales = _np_diag_scale_param(params["landmarks"]["uncertainty_points"])
                sp_scales = _np_diag_scale_param(params["landmarks"]["uncertainty_shape"])
                pt_rows = g.const_like_rowvec(shapeparam, np.repeat(pt_scales, 3))  # (N, 204)
                output_infos += [
                    ("pt3d_68_scales", g.reshape(pt_rows, [-1, 68, 3]), (68, 3)),
                    ("shapeparam_scales", g.const_like_rowvec(shapeparam, sp_scales), 50),
                ]

    out_protos = []
    for name, src, dims in output_infos:
        if fp16:
            src = g.node("Cast", [src], to=P.FLOAT)
        g.rename_output(src, name)
        if dims is None:
            shape = ["batch"]
        else:
            shape = ["batch"] + (list(dims) if isinstance(dims, tuple) else [dims])
        out_protos.append(P.value_info_proto(name, P.FLOAT, shape))

    input_proto = P.value_info_proto("x", P.FLOAT, ["batch", 1, res, res])
    graph = P.graph_proto(
        "posenet", g.nodes, [input_proto], out_protos, g.initializers,
        doc_string="NetworkWithPointHead (TPU traincode export)",  # the JAX exporter's, for equal bytes
    )
    return P.model_proto(graph, opset_version=13, model_version=4)


def build_localizer_onnx(model) -> bytes:
    """The port's LocalizerNet -> ONNX: outputs logit_box (N, 5) = [logit, x0, y0, x1, y1]."""
    from neuralnet_tracker_traincode_torch.models.weights import localizer_variables_to_jax

    variables = localizer_variables_to_jax(model.state_dict())
    params = variables["params"]
    stats = variables["batch_stats"]
    g = GraphBuilder()
    H, W = model.input_resolution
    x = "x"
    ps_p, ps_s = params["initial_bn"], stats["initial_bn"]
    w, b = _fold_bn(
        np.asarray(params["initial_conv"]["kernel"]),
        np.asarray(ps_p["scale"]), np.asarray(ps_p["bias"]),
        np.asarray(ps_s["mean"]), np.asarray(ps_s["var"]),
    )
    h = g.relu(g.conv(x, w, b, stride=2))
    ps_p, ps_s = params["dsconv_bn1"], stats["dsconv_bn1"]
    w, b = _fold_bn(
        np.asarray(params["dsconv_dw"]["kernel"]),
        np.asarray(ps_p["scale"]), np.asarray(ps_p["bias"]),
        np.asarray(ps_s["mean"]), np.asarray(ps_s["var"]),
    )
    h = g.relu(g.conv(h, w, b, stride=1, group=8))
    ps_p, ps_s = params["dsconv_bn2"], stats["dsconv_bn2"]
    w, b = _fold_bn(
        np.asarray(params["dsconv_pw"]["kernel"]),
        np.asarray(ps_p["scale"]), np.asarray(ps_p["bias"]),
        np.asarray(ps_s["mean"]), np.asarray(ps_s["var"]),
    )
    h = g.conv(h, w, b, stride=1, pads=[0, 0, 0, 0])

    ir_cfg = [
        (12, 3, 2, 2), (12, 3, 1, 2), (20, 3, 2, 4), (20, 3, 1, 4), (20, 3, 1, 4),
        (32, 5, 2, 2), (32, 5, 1, 2), (32, 3, 1, 2), (32, 3, 1, 2),
        (56, 3, 2, 2), (56, 3, 1, 2), (56, 3, 1, 2),
    ]
    in_ch = 8
    for i, (out_ch, ksz, stride, expf) in enumerate(ir_cfg):
        bp, bs = params[f"ir{i}"], stats[f"ir{i}"]
        mid = in_ch * expf
        w, b = _fold_bn(
            np.asarray(bp["expand"]["kernel"]), np.asarray(bp["bn1"]["scale"]),
            np.asarray(bp["bn1"]["bias"]), np.asarray(bs["bn1"]["mean"]), np.asarray(bs["bn1"]["var"]),
        )
        t = g.relu(g.conv(h, w, b, pads=[0, 0, 0, 0]))
        w, b = _fold_bn(
            np.asarray(bp["depthwise"]["kernel"]), np.asarray(bp["bn2"]["scale"]),
            np.asarray(bp["bn2"]["bias"]), np.asarray(bs["bn2"]["mean"]), np.asarray(bs["bn2"]["var"]),
        )
        t = g.relu(g.conv(t, w, b, stride=stride, group=mid))
        w, b = _fold_bn(
            np.asarray(bp["project"]["kernel"]), np.asarray(bp["bn3"]["scale"]),
            np.asarray(bp["bn3"]["bias"]), np.asarray(bs["bn3"]["mean"]), np.asarray(bs["bn3"]["var"]),
        )
        t = g.conv(t, w, b, pads=[0, 0, 0, 0])
        if stride == 1 and in_ch == out_ch:
            t = g.add(t, h)
        h = t
        in_ch = out_ch

    w = np.transpose(np.asarray(params["final_conv"]["kernel"]), (3, 2, 0, 1))
    h = g.conv(h, w, np.asarray(params["final_conv"]["bias"]), pads=[0, 0, 0, 0])

    logit = g.node("ReduceMean", [g.slice_(h, [0], [1], [1])], axes=[1, 2, 3], keepdims=0)
    logit = g.unsqueeze(logit, [1])
    attn = g.slice_(h, [1], [2], [1])  # (N, 1, h, w)
    fh, fw = H // 32, W // 32  # initial s2 conv + four stride-2 IR stages
    flat = g.reshape(attn, [-1, fh * fw])
    sm = g.node("Softmax", [flat], axis=1)
    px = np.linspace(-1, 1, fw, dtype=np.float32)
    py = np.linspace(-1, 1, fh, dtype=np.float32)
    pos = np.stack(
        [np.broadcast_to(px[None, :], (fh, fw)), np.broadcast_to(py[:, None], (fh, fw))]
    ).reshape(2, -1)  # (2, hw)
    half_size = float(np.asarray(params["boxstddev_half_size"]))
    mean = g.node("MatMul", [sm, g.init_tensor((half_size * pos.T).astype(np.float32), "poscode")])
    # Reference CenterOfMassAndStd subtracts the half_size-SCALED mean from the
    # UNSCALED position code (`modelcomponents.py:128-133`):
    # var = sum attn p^2 - (2/hs) mean^2 + mean^2.
    sq = g.node("MatMul", [sm, g.init_tensor((pos.T**2).astype(np.float32), "possq")])
    msq = g.mul(mean, mean)
    var = g.add(sq, g.mul(msq, g.init_tensor(
        np.asarray([1.0 - 2.0 / half_size], np.float32), "mixcoef")))
    eps = g.init_tensor(np.asarray([1e-4], np.float32), "eps")
    std = g.node("Sqrt", [g.add(var, eps)])
    pred = g.concat([logit, g.sub(mean, std), g.add(mean, std)], axis=1)
    g.rename_output(pred, "logit_box")

    input_proto = P.value_info_proto("x", P.FLOAT, ["batch", 1, H, W])
    out_proto = P.value_info_proto("logit_box", P.FLOAT, ["batch", 5])
    graph = P.graph_proto("localizer", g.nodes, [input_proto], [out_proto], g.initializers)
    return P.model_proto(graph, opset_version=13, model_version=4)


def calibrate_conv_ranges(model_bytes: bytes, batches_nchw, device: DeviceLike = None) -> List:
    """(min, max) of every Conv input over the calibration batches.

    Runs the f32 graph in `onnx_run.TorchOnnxSession` on `device` (CUDA
    unless the caller asks for the CPU); the Conv order is that of a later
    `build_posenet_onnx(..., quant_ranges=...)` by construction (the
    reference attaches torch observers instead and runs 20 training
    batches, export_model.py:108-110).
    """
    import torch

    from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession

    sess = TorchOnnxSession(model_bytes, device)
    names = [n.inputs[0] for n in sess.model.nodes if n.op_type == "Conv"]
    lo, hi = {}, {}
    for x in batches_nchw:
        got = sess.run(None, {"x": torch.as_tensor(x, dtype=torch.float32)}, collect=names)[-len(names):]
        for n, t in zip(names, got):
            lo[n] = torch.minimum(lo[n], t.amin()) if n in lo else t.amin()
            hi[n] = torch.maximum(hi[n], t.amax()) if n in hi else t.amax()
    ranges = torch.stack([torch.stack([lo[n], hi[n]]) for n in names]).float().cpu().tolist()
    return [(a, b) for a, b in ranges]
