"""Weight bridge: the JAX package's flax variables -> the port's state dict.

Takes `{"params", "batch_stats"}` as nested dicts of numpy arrays (what
`jax.tree_util.tree_map(np.asarray, variables)` gives) and returns the
`state_dict` of `models.posenet.NetworkWithPointHead`. The mapping is the
port's own copy of the reference-format export (pure transposes):

 - Conv kernel HWIO -> OIHW; depthwise (k, k, 1, C) -> (C, 1, k, k)
 - Dense kernel (in, out) -> Linear weight (out, in)
 - BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
 - NLL necks `uncertainty_*/neck/lin` -> `*.scales.neck.lin` /
   `quatnet.uncertainty_net.neck.lin`, plus the constant `min_diag` buffers
 - the BFM keypoint buffers from the port's own npz copy.
"""

from typing import Any, Dict

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import not_ported
from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
from neuralnet_tracker_traincode_torch.models.components import pascal_kernel_2d

_STRIDE2 = ("dw2_2", "dw3_2", "dw4_2", "dw5_6")
_BLOCKS = "dw2_1 dw2_2 dw3_1 dw3_2 dw4_1 dw4_2 dw5_1 dw5_2 dw5_3 dw5_4 dw5_5 dw5_6 dw6".split()


def _conv(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))  # HWIO -> OIHW; (k,k,1,C) -> (C,1,k,k)


def _dense(sd, prefix: str, p: Dict[str, Any]):
    sd[prefix + ".weight"] = np.transpose(np.asarray(p["kernel"]), (1, 0))
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _bn(sd, prefix: str, p: Dict[str, Any], s: Dict[str, Any]):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])
    sd[prefix + ".running_mean"] = np.asarray(s["mean"])
    sd[prefix + ".running_var"] = np.asarray(s["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _min_diag3() -> np.ndarray:
    v = np.zeros((6,), np.float32)
    v[:3] = 1e-6
    return v


def _mobilenet(sd, p, s, backbone_args):
    use_blurpool = bool((backbone_args or {}).get("use_blurpool"))
    sd["convnet.conv1.weight"] = _conv(p["conv1"]["kernel"])
    _bn(sd, "convnet.bn1", p["bn1"], s["bn1"])
    for name in _BLOCKS:
        bp, bs = p[name], s[name]
        if use_blurpool and name in _STRIDE2:
            sd[f"convnet.{name}.conv_dw.0.kernel"] = pascal_kernel_2d(3)
            dw_key = f"convnet.{name}.conv_dw.1.weight"
        else:
            dw_key = f"convnet.{name}.conv_dw.weight"
        sd[dw_key] = _conv(bp["conv_dw"]["kernel"])
        _bn(sd, f"convnet.{name}.bn_dw", bp["bn_dw"], bs["bn_dw"])
        sd[f"convnet.{name}.conv_sep.weight"] = _conv(bp["conv_sep"]["kernel"])
        _bn(sd, f"convnet.{name}.bn_sep", bp["bn_sep"], bs["bn_sep"])


def posenet_state_dict_from_jax(variables: Dict[str, Any], config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `NetworkWithPointHead` variables -> the port's state dict (CPU tensors)."""
    if config.get("config", "mobilenetv1") != "mobilenetv1":
        raise not_ported(f"the weight bridge for backbone {config.get('config')!r}")
    if config.get("enable_6drot") or config.get("enable_face_detector"):
        raise not_ported("the weight bridge for 6D rotation / face detector heads")
    p = variables["params"]
    s = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    _mobilenet(sd, p["convnet"], s.get("convnet", {}), config.get("backbone_args"))

    uncertainty = bool(config.get("enable_uncertainty", False))
    _dense(sd, "boxnet.linear", p["boxnet"]["linear"])
    if uncertainty:
        sd["boxnet.scales.hidden_scale"] = np.asarray(p["boxnet"]["uncertainty_scales"]["hidden_scale"])
    _dense(sd, "posnet.linear_xy", p["posnet"]["linear_xy"])
    _dense(sd, "posnet.linear_size", p["posnet"]["linear_size"])
    if uncertainty:
        _dense(sd, "posnet.scales.neck.lin", p["posnet"]["uncertainty_scales"]["neck"]["lin"])
        sd["posnet.scales.min_diag"] = _min_diag3()
    _dense(sd, "quatnet.linear", p["quatnet"]["linear"])
    if uncertainty:
        _dense(sd, "quatnet.uncertainty_net.neck.lin", p["quatnet"]["uncertainty_net"]["neck"]["lin"])
        sd["quatnet.uncertainty_net.min_diag"] = _min_diag3()
    point_head = config.get("enable_point_head", True)
    if config.get("use_local_pose_offset", True):
        sd["local_pose_offset.p"] = np.asarray(p["local_pose_offset"]["p"])
        if point_head:
            sd["local_pose_offset_kpts.p"] = np.asarray(p["local_pose_offset_kpts"]["p"])
    if point_head:
        _dense(sd, "landmarks.shapenet", p["landmarks"]["shapenet"])
        bfm = BFMModel()
        sd["landmarks.deformablekeypoints.keypts"] = np.asarray(bfm.keypts, np.float32)
        sd["landmarks.deformablekeypoints.keyeigvecs"] = np.asarray(bfm.scaled_bases[:50], np.float32)
        if uncertainty:
            sd["landmarks.point_distrib_scales.hidden_scale"] = np.asarray(
                p["landmarks"]["uncertainty_points"]["hidden_scale"]
            )
            sd["landmarks.shape_distrib_scales.hidden_scale"] = np.asarray(
                p["landmarks"]["uncertainty_shape"]["hidden_scale"]
            )
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
