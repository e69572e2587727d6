"""Weight bridge between the JAX package's flax variables and the port's state dict.

`posenet_state_dict_from_jax` takes `{"params", "batch_stats"}` as nested
dicts of numpy arrays (what `jax.tree_util.tree_map(np.asarray, variables)`
gives) and returns the `state_dict` of `models.posenet.NetworkWithPointHead`;
`posenet_variables_to_jax` is its inverse. Both directions read one table,
`_posenet_layout`, the port's own copy of the reference-format export (pure
transposes), for the quaternion and the 6D rotation heads alike (both are
`quatnet.linear`):

 - Conv kernel HWIO -> OIHW; depthwise (k, k, 1, C) -> (C, 1, k, k)
 - Dense kernel (in, out) -> Linear weight (out, in)
 - BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
 - NLL necks `uncertainty_*/neck/lin` -> `*.scales.neck.lin` /
   `quatnet.uncertainty_net.neck.lin`.

The buffers with no flax counterpart (`_constant_buffers`: the NLL necks'
`min_diag`, the BFM keypoint tables from the port's own npz copy, the
BlurPool kernels, `num_batches_tracked`) are made going in and dropped going
back.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import not_ported
from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
from neuralnet_tracker_traincode_torch.models.components import pascal_kernel_2d

_STRIDE2 = ("dw2_2", "dw3_2", "dw4_2", "dw5_6")
_BLOCKS = "dw2_1 dw2_2 dw3_1 dw3_2 dw4_1 dw4_2 dw5_1 dw5_2 dw5_3 dw5_4 dw5_5 dw5_6 dw6".split()

# how a value maps from flax to the state dict; the inverse transposes go back
_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0), "same": None}  # conv: HWIO -> OIHW
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0), "same": None}

Row = Tuple[str, str, str, str]  # (state-dict key, flax collection, flax path, kind)


def _check_supported(config: Dict[str, Any]):
    if config.get("config", "mobilenetv1") != "mobilenetv1":
        raise not_ported(f"the weight bridge for backbone {config.get('config')!r}")
    if config.get("enable_face_detector"):
        raise not_ported("the weight bridge for the face detector head")


def _posenet_layout(config: Dict[str, Any]) -> List[Row]:
    """Every state-dict key of `NetworkWithPointHead(**config)` that has a
    flax variable, with that variable's place and the transpose between them."""
    _check_supported(config)

    def conv(key, path):
        return [(key, "params", path + "/kernel", "conv")]

    def dense(key, path):
        return [(key + ".weight", "params", path + "/kernel", "dense"), (key + ".bias", "params", path + "/bias", "same")]

    def bn(key, path):
        return [
            (key + ".weight", "params", path + "/scale", "same"),
            (key + ".bias", "params", path + "/bias", "same"),
            (key + ".running_mean", "batch_stats", path + "/mean", "same"),
            (key + ".running_var", "batch_stats", path + "/var", "same"),
        ]

    def same(key, path):
        return [(key, "params", path, "same")]

    blurpool = bool((config.get("backbone_args") or {}).get("use_blurpool"))
    rows = conv("convnet.conv1.weight", "convnet/conv1") + bn("convnet.bn1", "convnet/bn1")
    for name in _BLOCKS:
        dw = "conv_dw.1" if blurpool and name in _STRIDE2 else "conv_dw"
        rows += conv(f"convnet.{name}.{dw}.weight", f"convnet/{name}/conv_dw")
        rows += bn(f"convnet.{name}.bn_dw", f"convnet/{name}/bn_dw")
        rows += conv(f"convnet.{name}.conv_sep.weight", f"convnet/{name}/conv_sep")
        rows += bn(f"convnet.{name}.bn_sep", f"convnet/{name}/bn_sep")

    uncertainty = bool(config.get("enable_uncertainty", False))
    rows += dense("boxnet.linear", "boxnet/linear")
    if uncertainty:
        rows += same("boxnet.scales.hidden_scale", "boxnet/uncertainty_scales/hidden_scale")
    rows += dense("posnet.linear_xy", "posnet/linear_xy") + dense("posnet.linear_size", "posnet/linear_size")
    if uncertainty:
        rows += dense("posnet.scales.neck.lin", "posnet/uncertainty_scales/neck/lin")
    rows += dense("quatnet.linear", "quatnet/linear")
    if uncertainty:
        rows += dense("quatnet.uncertainty_net.neck.lin", "quatnet/uncertainty_net/neck/lin")
    point_head = config.get("enable_point_head", True)
    if config.get("use_local_pose_offset", True):
        rows += same("local_pose_offset.p", "local_pose_offset/p")
        if point_head:
            rows += same("local_pose_offset_kpts.p", "local_pose_offset_kpts/p")
    if point_head:
        rows += dense("landmarks.shapenet", "landmarks/shapenet")
        if uncertainty:
            rows += same("landmarks.point_distrib_scales.hidden_scale", "landmarks/uncertainty_points/hidden_scale")
            rows += same("landmarks.shape_distrib_scales.hidden_scale", "landmarks/uncertainty_shape/hidden_scale")
    return rows


def _constant_buffers(config: Dict[str, Any], rows: List[Row]) -> Dict[str, np.ndarray]:
    """The state dict's buffers that no flax variable holds."""
    sd = {k[: -len("running_mean")] + "num_batches_tracked": np.asarray(0, np.int64)
          for k, *_ in rows if k.endswith(".running_mean")}
    if (config.get("backbone_args") or {}).get("use_blurpool"):
        for name in _STRIDE2:
            sd[f"convnet.{name}.conv_dw.0.kernel"] = pascal_kernel_2d(3)
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


def posenet_state_dict_from_jax(variables: Dict[str, Any], config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `NetworkWithPointHead` variables -> the port's state dict (CPU tensors)."""
    rows = _posenet_layout(config)
    sd: Dict[str, np.ndarray] = {}
    for key, collection, path, kind in rows:
        v = variables[collection]
        for k in path.split("/"):
            v = v[k]
        v = np.asarray(v)
        sd[key] = v if _TO_TORCH[kind] is None else np.transpose(v, _TO_TORCH[kind])
    sd.update(_constant_buffers(config, rows))
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def posenet_variables_to_jax(state_dict: Dict[str, torch.Tensor], config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's state dict -> the JAX `NetworkWithPointHead` variables
    `{"params", "batch_stats"}` as nested dicts of f32 numpy arrays."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, collection, path, kind in _posenet_layout(config):
        v = state_dict[key].detach().cpu().numpy()
        if _TO_FLAX[kind] is not None:
            v = np.transpose(v, _TO_FLAX[kind])
        *parents, leaf = path.split("/")
        tree = out[collection]
        for k in parents:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.ascontiguousarray(v)
    return out
