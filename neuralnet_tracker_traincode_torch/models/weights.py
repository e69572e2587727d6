"""Weight bridge between the JAX package's flax variables and the port's state dict.

`posenet_state_dict_from_jax` takes `{"params", "batch_stats"}` as nested
dicts of numpy arrays (what `jax.tree_util.tree_map(np.asarray, variables)`
gives) and returns the `state_dict` of `models.posenet.NetworkWithPointHead`;
`posenet_variables_to_jax` is its inverse. `localizer_state_dict_from_jax`
and `localizer_variables_to_jax` do the same for `models.localizer.LocalizerNet`.
Each pair reads one table (`_posenet_layout`, `_localizer_layout`), the
port's own copy of the reference-format export (pure transposes), for every
backbone (mobilenetv1, resnet18 with and without BlurPool, efficientnet_b0
to b4, hybrid_vit) and head (the quaternion and the 6D rotation alike are
`quatnet.linear`; the face detector):

 - Conv kernel HWIO -> OIHW; depthwise (k, k, 1, C) -> (C, 1, k, k)
 - Dense kernel (in, out) -> Linear weight (out, in)
 - BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*;
   LayerNorm scale/bias -> weight/bias
 - flax attention q/k/v (d, heads, d_head) -> the packed `in_proj_weight`
   (3d, d) and `in_proj_bias`, out (heads, d_head, d) -> `out_proj`
 - hybrid_vit's positional channels NHWC -> NCHW
 - NLL necks `uncertainty_*/neck/lin` -> `*.scales.neck.lin` /
   `quatnet.uncertainty_net.neck.lin`; a `FeaturesAsDiagonalScale` on its
   own (`diagonal_scale_state_dict_from_jax`) `<path>/neck/lin` -> `neck.lin`.

The buffers with no flax counterpart (`_constant_buffers`: the NLL necks'
`min_diag`, the BFM keypoint tables from the port's own npz copy, the
BlurPool kernels, `num_batches_tracked`) are made going in and dropped going
back.
"""

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
from neuralnet_tracker_traincode_torch.models.components import pascal_kernel_2d

_STRIDE2 = ("dw2_2", "dw3_2", "dw4_2", "dw5_6")
_BLOCKS = "dw2_1 dw2_2 dw3_1 dw3_2 dw4_1 dw4_2 dw5_1 dw5_2 dw5_3 dw5_4 dw5_5 dw5_6 dw6".split()
_MHA_HEADS = 8  # hybrid_vit's attention heads

# how a value maps from flax to the state dict; the inverse transposes go back
_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0), "same": None, "nhwc": (0, 3, 1, 2)}  # conv: HWIO -> OIHW
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0), "same": None, "nhwc": (0, 2, 3, 1)}
_QKV = ("query", "key", "value")

Row = Tuple[str, str, str, str]  # (state-dict key, flax collection, flax path, kind)


def _conv(key, path):
    return [(key, "params", path + "/kernel", "conv")]


def _dense(key, path):
    return [(key + ".weight", "params", path + "/kernel", "dense"), (key + ".bias", "params", path + "/bias", "same")]


def _bn(key, path):
    return [
        (key + ".weight", "params", path + "/scale", "same"),
        (key + ".bias", "params", path + "/bias", "same"),
        (key + ".running_mean", "batch_stats", path + "/mean", "same"),
        (key + ".running_var", "batch_stats", path + "/var", "same"),
    ]


def _ln(key, path):
    return [(key + ".weight", "params", path + "/scale", "same"), (key + ".bias", "params", path + "/bias", "same")]


def _same(key, path):
    return [(key, "params", path, "same")]


def _mha(key, path):
    """The packed input projection is made of three flax leaves: its path
    is the attention module's."""
    return [
        (key + ".in_proj_weight", "params", path, "qkv_weight"),
        (key + ".in_proj_bias", "params", path, "qkv_bias"),
        (key + ".out_proj.weight", "params", path + "/out/kernel", "out_weight"),
        (key + ".out_proj.bias", "params", path + "/out/bias", "same"),
    ]


def _mobilenet_rows(backbone_args) -> List[Row]:
    blurpool = bool(backbone_args.get("use_blurpool"))
    rows = _conv("convnet.conv1.weight", "convnet/conv1") + _bn("convnet.bn1", "convnet/bn1")
    for name in _BLOCKS:
        dw = "conv_dw.1" if blurpool and name in _STRIDE2 else "conv_dw"
        rows += _conv(f"convnet.{name}.{dw}.weight", f"convnet/{name}/conv_dw")
        rows += _bn(f"convnet.{name}.bn_dw", f"convnet/{name}/bn_dw")
        rows += _conv(f"convnet.{name}.conv_sep.weight", f"convnet/{name}/conv_sep")
        rows += _bn(f"convnet.{name}.bn_sep", f"convnet/{name}/bn_sep")
    return rows


def _basic_block_rows(key, path, blurpool: bool, downsample: bool) -> List[Row]:
    rows = _conv(key + (".conv1.1.weight" if blurpool else ".conv1.weight"), path + "/conv1")
    rows += _bn(key + ".bn1", path + "/bn1") + _conv(key + ".conv2.weight", path + "/conv2") + _bn(key + ".bn2", path + "/bn2")
    if downsample:
        rows += _conv(key + ".downsample.0.weight", path + "/downsample_conv")
        rows += _bn(key + ".downsample.1", path + "/downsample_bn")
    return rows


def _resnet_stage_rows(prefix: str, first_stage: int, blurpool: bool) -> List[Row]:
    """The four stages of two basic blocks; stage s is `{prefix}.{first_stage + s}`."""
    rows = []
    for stage in range(4):
        for b in range(2):
            rows += _basic_block_rows(f"{prefix}.{first_stage + stage}.{b}", f"convnet/layer{stage + 1}_{b}",
                                      blurpool, stage > 0 and b == 0)
    return rows


def _resnet18_rows(backbone_args) -> List[Row]:
    rows = _conv("convnet.layers.0.weight", "convnet/conv1") + _bn("convnet.layers.1", "convnet/bn1")
    return rows + _resnet_stage_rows("convnet.layers", 4, bool(backbone_args.get("use_blurpool")))


def _efficientnet_rows(kind: str) -> Callable[[Dict[str, Any]], List[Row]]:
    def rows_of(backbone_args) -> List[Row]:
        from neuralnet_tracker_traincode_torch.models.backbones.efficientnet import scaled_settings

        settings, _ = scaled_settings(kind)
        rows = _conv("convnet.to_3chn_input.weight", "convnet/to_3chn_input")
        rows += _same("convnet.to_3chn_input.bias", "convnet/to_3chn_input/bias")
        rows += _conv("convnet.layers.0.0.weight", "convnet/stem_conv") + _bn("convnet.layers.0.1", "convnet/stem_bn")
        for stage_idx, cfg in enumerate(settings):
            for j in range(cfg.num_layers):
                t, f = f"convnet.layers.{stage_idx + 1}.{j}.block", f"convnet/stage{stage_idx + 1}_{j}"
                k = 0
                if cfg.expand_ratio != 1:
                    rows += _conv(f"{t}.0.0.weight", f + "/expand_conv") + _bn(f"{t}.0.1", f + "/expand_bn")
                    k = 1
                rows += _conv(f"{t}.{k}.0.weight", f + "/dw_conv") + _bn(f"{t}.{k}.1", f + "/dw_bn")
                for fc in ("fc1", "fc2"):
                    rows += _conv(f"{t}.{k + 1}.{fc}.weight", f"{f}/se/{fc}")
                    rows += _same(f"{t}.{k + 1}.{fc}.bias", f"{f}/se/{fc}/bias")
                rows += _conv(f"{t}.{k + 2}.0.weight", f + "/project_conv") + _bn(f"{t}.{k + 2}.1", f + "/project_bn")
        return rows + _conv("convnet.layers.8.0.weight", "convnet/head_conv") + _bn("convnet.layers.8.1", "convnet/head_bn")

    return rows_of


def _hybrid_vit_rows(backbone_args) -> List[Row]:
    rows = _conv("convnet.convnet.0.weight", "convnet/stem") + _resnet_stage_rows("convnet.convnet", 1, False)
    rows += _conv("convnet.proj.0.weight", "convnet/proj_conv") + _bn("convnet.proj.1", "convnet/proj_bn")
    rows += [("convnet.position", "params", "convnet/position", "nhwc")]
    rows += _same("convnet.queries", "convnet/queries") + _same("convnet.cls_token", "convnet/cls_token")
    enc, e = "convnet.transformer.encoder.layers.0", "convnet/transformer_encoder"
    rows += _mha(enc + ".self_attn", e + "/self_attn")
    rows += _dense(enc + ".linear1", e + "/linear1") + _dense(enc + ".linear2", e + "/linear2")
    rows += _ln(enc + ".norm1", e + "/norm1") + _ln(enc + ".norm2", e + "/norm2")
    rows += _ln("convnet.transformer.encoder.norm", "convnet/transformer_encoder_norm")
    dec, d = "convnet.transformer.decoder.layers.0", "convnet/transformer_decoder"
    rows += _mha(dec + ".self_attn", d + "/self_attn") + _mha(dec + ".multihead_attn", d + "/cross_attn")
    rows += _dense(dec + ".linear1", d + "/linear1") + _dense(dec + ".linear2", d + "/linear2")
    rows += _ln(dec + ".norm1", d + "/norm1") + _ln(dec + ".norm2", d + "/norm2") + _ln(dec + ".norm3", d + "/norm3")
    return rows + _ln("convnet.transformer.decoder.norm", "convnet/transformer_decoder_norm")


_BACKBONE_ROWS = {"mobilenetv1": _mobilenet_rows, "resnet18": _resnet18_rows, "hybrid_vit": _hybrid_vit_rows}
for _kind in ("b0", "b1", "b2", "b3", "b4"):
    _BACKBONE_ROWS["efficientnet_" + _kind] = _efficientnet_rows(_kind)


def _posenet_layout(config: Dict[str, Any]) -> List[Row]:
    """Every state-dict key of `NetworkWithPointHead(**config)` that has a
    flax variable, with that variable's place and the transform between them."""
    backbone = config.get("config", "mobilenetv1")
    if backbone not in _BACKBONE_ROWS:
        raise ValueError(f"Unsupported backbone {backbone}")
    rows = _BACKBONE_ROWS[backbone](config.get("backbone_args") or {})

    uncertainty = bool(config.get("enable_uncertainty", False))
    rows += _dense("boxnet.linear", "boxnet/linear")
    if uncertainty:
        rows += _same("boxnet.scales.hidden_scale", "boxnet/uncertainty_scales/hidden_scale")
    rows += _dense("posnet.linear_xy", "posnet/linear_xy") + _dense("posnet.linear_size", "posnet/linear_size")
    if uncertainty:
        rows += _dense("posnet.scales.neck.lin", "posnet/uncertainty_scales/neck/lin")
    rows += _dense("quatnet.linear", "quatnet/linear")
    if uncertainty:
        rows += _dense("quatnet.uncertainty_net.neck.lin", "quatnet/uncertainty_net/neck/lin")
    point_head = config.get("enable_point_head", True)
    if config.get("use_local_pose_offset", True):
        rows += _same("local_pose_offset.p", "local_pose_offset/p")
        if point_head:
            rows += _same("local_pose_offset_kpts.p", "local_pose_offset_kpts/p")
    if point_head:
        rows += _dense("landmarks.shapenet", "landmarks/shapenet")
        if uncertainty:
            rows += _same("landmarks.point_distrib_scales.hidden_scale", "landmarks/uncertainty_points/hidden_scale")
            rows += _same("landmarks.shape_distrib_scales.hidden_scale", "landmarks/uncertainty_shape/hidden_scale")
    if config.get("enable_face_detector", False):
        rows += _dense("face_detector", "face_detector")
    return rows


def _num_batches_tracked(rows: List[Row]) -> Dict[str, np.ndarray]:
    return {k[: -len("running_mean")] + "num_batches_tracked": np.asarray(0, np.int64)
            for k, *_ in rows if k.endswith(".running_mean")}


def _constant_buffers(config: Dict[str, Any], rows: List[Row]) -> Dict[str, np.ndarray]:
    """The state dict's buffers that no flax variable holds."""
    sd = _num_batches_tracked(rows)
    backbone = config.get("config", "mobilenetv1")
    if (config.get("backbone_args") or {}).get("use_blurpool"):
        if backbone == "mobilenetv1":
            for name in _STRIDE2:
                sd[f"convnet.{name}.conv_dw.0.kernel"] = pascal_kernel_2d(3)
        elif backbone == "resnet18":
            sd["convnet.layers.3.kernel"] = pascal_kernel_2d(3)
            for stage in range(4):
                for b in range(2):
                    sd[f"convnet.layers.{4 + stage}.{b}.conv1.0.kernel"] = pascal_kernel_2d(3)
    if config.get("enable_uncertainty", False):
        min_diag = np.zeros((6,), np.float32)
        min_diag[:3] = 1e-6
        sd["posnet.scales.min_diag"] = min_diag
        sd["quatnet.uncertainty_net.min_diag"] = min_diag.copy()
    if config.get("enable_point_head", True):
        bfm = BFMModel()
        sd["landmarks.deformablekeypoints.keypts"] = np.asarray(bfm.keypts, np.float32)
        sd["landmarks.deformablekeypoints.keyeigvecs"] = np.asarray(bfm.scaled_bases[:50], np.float32)
    return sd


def _leaf(variables: Dict[str, Any], collection: str, path: str):
    v = variables[collection]
    for k in path.split("/"):
        v = v[k]
    return np.asarray(v)


def _to_torch(variables: Dict[str, Any], collection: str, path: str, kind: str) -> np.ndarray:
    if kind == "qkv_weight":  # (d, h, hd) each -> (3d, d)
        ws = [_leaf(variables, collection, f"{path}/{n}/kernel") for n in _QKV]
        return np.concatenate([w.reshape(w.shape[0], -1).T for w in ws], axis=0)
    if kind == "qkv_bias":
        return np.concatenate([_leaf(variables, collection, f"{path}/{n}/bias").reshape(-1) for n in _QKV])
    v = _leaf(variables, collection, path)
    if kind == "out_weight":  # (h, hd, d) -> (d, h * hd)
        return v.reshape(-1, v.shape[-1]).T
    return v if _TO_TORCH[kind] is None else np.transpose(v, _TO_TORCH[kind])


def _to_flax(path: str, kind: str, v: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """(flax path, value) of each flax leaf a state-dict value makes."""
    if kind == "qkv_weight":
        d = v.shape[1]
        return [(f"{path}/{n}/kernel", w.T.reshape(d, _MHA_HEADS, -1)) for n, w in zip(_QKV, np.split(v, 3))]
    if kind == "qkv_bias":
        return [(f"{path}/{n}/bias", b.reshape(_MHA_HEADS, -1)) for n, b in zip(_QKV, np.split(v, 3))]
    if kind == "out_weight":
        return [(path, v.T.reshape(_MHA_HEADS, -1, v.shape[0]))]
    return [(path, v if _TO_FLAX[kind] is None else np.transpose(v, _TO_FLAX[kind]))]


def _state_dict_from_jax(variables: Dict[str, Any], rows: List[Row], constants: Dict[str, np.ndarray]):
    sd = {key: _to_torch(variables, collection, path, kind) for key, collection, path, kind in rows}
    sd.update(constants)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _variables_to_jax(state_dict: Dict[str, torch.Tensor], rows: List[Row]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, collection, path, kind in rows:
        for leaf_path, v in _to_flax(path, kind, state_dict[key].detach().cpu().numpy()):
            *parents, leaf = leaf_path.split("/")
            tree = out[collection]
            for k in parents:
                tree = tree.setdefault(k, {})
            tree[leaf] = np.array(v, order="C")  # not ascontiguousarray: it makes 0-d arrays 1-d
    return out


def posenet_state_dict_from_jax(variables: Dict[str, Any], config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `NetworkWithPointHead` variables -> the port's state dict (CPU tensors)."""
    rows = _posenet_layout(config)
    return _state_dict_from_jax(variables, rows, _constant_buffers(config, rows))


def posenet_variables_to_jax(state_dict: Dict[str, torch.Tensor], config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's state dict -> the JAX `NetworkWithPointHead` variables
    `{"params", "batch_stats"}` as nested dicts of f32 numpy arrays."""
    return _variables_to_jax(state_dict, _posenet_layout(config))


def _localizer_layout() -> List[Row]:
    """Every state-dict key of `LocalizerNet` with its flax variable: the
    reference's `convnet` Sequential (initial stage, ds-sep conv, 12
    inverted residuals with `layers.{0,1,3,4,6,7}`, final conv) and
    `boxstddev.half_size`."""
    rows = _conv("convnet.0.0.weight", "initial_conv") + _bn("convnet.0.1", "initial_bn")
    rows += _conv("convnet.1.0.weight", "dsconv_dw") + _bn("convnet.1.1", "dsconv_bn1")
    rows += _conv("convnet.1.3.weight", "dsconv_pw") + _bn("convnet.1.4", "dsconv_bn2")
    for i in range(12):
        t, f = f"convnet.{i + 2}.layers", f"ir{i}"
        rows += _conv(t + ".0.weight", f + "/expand") + _bn(t + ".1", f + "/bn1")
        rows += _conv(t + ".3.weight", f + "/depthwise") + _bn(t + ".4", f + "/bn2")
        rows += _conv(t + ".6.weight", f + "/project") + _bn(t + ".7", f + "/bn3")
    rows += _conv("convnet.14.weight", "final_conv") + _same("convnet.14.bias", "final_conv/bias")
    return rows + _same("boxstddev.half_size", "boxstddev_half_size")


def localizer_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `LocalizerNet` variables -> the port's state dict (CPU tensors)."""
    rows = _localizer_layout()
    return _state_dict_from_jax(variables, rows, _num_batches_tracked(rows))


def localizer_variables_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's `LocalizerNet` state dict -> the JAX variables."""
    return _variables_to_jax(state_dict, _localizer_layout())


def _diagonal_scale_layout(path: str) -> List[Row]:
    return _dense("neck.lin", path + "/neck/lin")


def diagonal_scale_state_dict_from_jax(params: Dict[str, Any], path: str = "uncertainty_scales"
                                       ) -> Dict[str, torch.Tensor]:
    """The flax params of a JAX `FeaturesAsDiagonalScale` held at `path`
    (slash-separated, e.g. "uncertainty_scales") -> the state dict of the
    port's `models/nll.py:FeaturesAsDiagonalScale` (CPU tensors)."""
    return _state_dict_from_jax({"params": params}, _diagonal_scale_layout(path), {})


def diagonal_scale_params_to_jax(state_dict: Dict[str, torch.Tensor], path: str = "uncertainty_scales"
                                 ) -> Dict[str, Any]:
    """The port's `FeaturesAsDiagonalScale` state dict -> the flax params,
    the module at `path`."""
    return _variables_to_jax(state_dict, _diagonal_scale_layout(path))["params"]
