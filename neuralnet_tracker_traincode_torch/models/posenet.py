"""The pose estimator network and its output heads.

Counterpart of the JAX package's `models/posenet.py`. Input is (B, H, W, C)
like the JAX package; the model permutes to NCHW inside. Module names give
the reference state-dict keys (`convnet.dw2_1.conv_dw.weight`,
`quatnet.uncertainty_net.neck.lin.weight`, ...), so `models/weights.py` maps
the JAX package's variables onto it one to one.

`dtype=torch.bfloat16` runs backbone and head linears under autocast, as the
JAX model's `dtype=jnp.bfloat16` does; heads cast their outputs to f32 and
the geometry stays f32.

Backbones (`create_pose_estimator_backbone`): mobilenetv1, resnet18,
efficientnet_b0 to b4 and hybrid_vit, whose output has one feature vector
per head; the others share their pooled features among the heads. Heads: the
box, position and size, the quaternion or the 6D rotation, the landmarks
and the face detector. Dropout (hybrid_vit) and stochastic depth
(efficientnet) draw their masks from the generator `forward` is given.
"""

import contextlib
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from neuralnet_tracker_traincode_torch.kernels.heads import pose_heads
from neuralnet_tracker_traincode_torch.models import nll as NLL
from neuralnet_tracker_traincode_torch.models.backbones.common import device_generator, lecun_normal_
from neuralnet_tracker_traincode_torch.models.backbones.efficientnet import EfficientNetBackbone
from neuralnet_tracker_traincode_torch.models.backbones.hybrid_vit import HybridVitBackbone
from neuralnet_tracker_traincode_torch.models.backbones.mobilenet_v1 import MobileNet
from neuralnet_tracker_traincode_torch.models.backbones.resnet import resnet18
from neuralnet_tracker_traincode_torch.models.components import (
    DeformableHeadKeypoints,
    box_from_features,
    offset_pose,
    rigid_transformation_25d,
)
from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops.mathfn import smoothclip0
from neuralnet_tracker_traincode_torch.ops.rotrepr import Mat33Repr, QuatRepr, RotationRepr


class DirectQuaternionWithNormalization(nn.Module):
    def __init__(self, num_features: int, enable_uncertainty: bool = False):
        super().__init__()
        self.linear = nn.Linear(num_features, 4)
        if enable_uncertainty:
            self.uncertainty_net = NLL.FeaturesAsTriangularScale(num_features, 3)
        self.enable_uncertainty = enable_uncertainty

    def init_bias(self):
        # inv_smoothclip0(0.1) = log(0.1): initial rotation near identity
        self.linear.bias.zero_()
        self.linear.bias[Q.iw] = math.log(0.1)

    def forward(self, x) -> Dict[str, Any]:
        quats, quats_unnormalized = QuatRepr.from_features(self.linear(x).float())
        out = {"unnormalized_quat": quats_unnormalized, "rot": quats}
        if self.enable_uncertainty:
            out["pose_scales_tril"] = self.uncertainty_net(x)
        return out


class RotRepr6dWithNormalization(nn.Module):
    def __init__(self, num_features: int, enable_uncertainty: bool = False):
        super().__init__()
        self.linear = nn.Linear(num_features, 6)
        if enable_uncertainty:
            self.uncertainty_net = NLL.FeaturesAsTriangularScale(num_features, 3)
        self.enable_uncertainty = enable_uncertainty

    def init_bias(self):
        self.linear.bias.copy_(0.001 * torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))

    def forward(self, x) -> Dict[str, Any]:
        z = self.linear(x).float()  # Gram-Schmidt and its orthonormality test in f32
        out = {"unnormalized_6drepr": z, "rot": Mat33Repr.from_6drepr_features(z)}
        if self.enable_uncertainty:
            out["pose_scales_tril"] = self.uncertainty_net(x)
        return out


class BoundingBox(nn.Module):
    def __init__(self, num_features: int, enable_uncertainty: bool = False):
        super().__init__()
        self.linear = nn.Linear(num_features, 4)
        if enable_uncertainty:
            self.scales = NLL.DiagonalScaleParameter(4)
        self.enable_uncertainty = enable_uncertainty

    def init_bias(self):
        self.linear.bias.copy_(torch.tensor([0.0, 0.0, 0.5, 0.5]))

    def forward(self, x) -> Dict[str, Any]:
        z = self.linear(x).float()
        out = {"roi": box_from_features(z)}
        if self.enable_uncertainty:
            out["roi_scales"] = self.scales()[None, :].expand(z.shape)
        return out


class PositionSizeOutput(nn.Module):
    def __init__(self, num_features: int, enable_uncertainty: bool = False):
        super().__init__()
        self.linear_xy = nn.Linear(num_features, 2)
        self.linear_size = nn.Linear(num_features, 1)
        if enable_uncertainty:
            self.scales = NLL.FeaturesAsTriangularScale(num_features, 3)
        self.enable_uncertainty = enable_uncertainty

    def init_bias(self):
        self.linear_xy.bias.zero_()
        self.linear_size.bias.fill_(0.5)

    def forward(self, x) -> Dict[str, Any]:
        xy = self.linear_xy(x).float()
        size = self.linear_size(x).float()
        out = {"coord": torch.cat([xy, smoothclip0(size)], dim=-1)}
        if self.enable_uncertainty:
            out["coord_scales"] = self.scales(x)
        return out


class Landmarks3dOutput(nn.Module):
    def __init__(self, num_features: int, enable_uncertainty: bool = False):
        super().__init__()
        self.deformablekeypoints = DeformableHeadKeypoints(40, 10)
        self.shapenet = nn.Linear(num_features, self.deformablekeypoints.num_eigvecs)
        if enable_uncertainty:
            self.point_distrib_scales = NLL.DiagonalScaleParameter(68)
            self.shape_distrib_scales = NLL.DiagonalScaleParameter(50)
        self.enable_uncertainty = enable_uncertainty

    def init_bias(self):
        self.shapenet.bias.zero_()

    def forward(self, z, quats: RotationRepr, coords) -> Dict[str, Any]:
        shapeparam = self.shapenet(z).float()
        pt3d_68 = rigid_transformation_25d(
            quats, coords[..., :2], coords[..., 2:], self.deformablekeypoints(shapeparam)
        )
        out = {"pt3d_68": pt3d_68, "shapeparam": shapeparam}
        if self.enable_uncertainty:
            out["pt3d_68_scales"] = self.point_distrib_scales()[None, :, None].expand(pt3d_68.shape)
            out["shapeparam_scales"] = self.shape_distrib_scales()[None, :].expand(shapeparam.shape)
        return out


class LocalToGlobalCoordinateOffset(nn.Module):
    """Learned per-dataset local->global pose offset (8 convention slots):
    row `set_id` of p (row 0 without ids) through `components.offset_pose`."""

    def __init__(self, num_parameter_sets: int = 1):
        super().__init__()
        self.p = nn.Parameter(torch.zeros(num_parameter_sets, 4))

    def forward(self, quats: RotationRepr, coords, set_id):
        return offset_pose(quats, coords, self.p[0:1] if set_id is None else self.p[set_id.long()])


def create_pose_estimator_backbone(num_heads: int, config: str, args: Optional[Dict[str, Any]],
                                   input_resolution: int = 129) -> nn.Module:
    args = dict(args or {})
    if config == "mobilenetv1":
        return MobileNet(**args)
    if config == "resnet18":
        return resnet18(**args)
    if config == "hybrid_vit":
        if args:
            print(f"WARNING: backbone arguments to {config} ignored: {args}")
        return HybridVitBackbone(num_heads_out=num_heads, input_resolution=input_resolution)
    if config.startswith("efficientnet_"):
        kind = config[len("efficientnet_"):]
        assert kind in ("b0", "b1", "b2", "b3", "b4")
        args.pop("use_blurpool", None)
        return EfficientNetBackbone(kind=kind, stochastic_depth_prob=0.1, **args)
    raise ValueError(f"Unsupported backbone {config}")


class NetworkWithPointHead(nn.Module):
    """Pose network: grayscale crop -> backbone -> features (shared, or one
    per head for hybrid_vit) -> heads."""

    NUM_DATASET_CONSTANTS = 8
    # the heads' outputs in the order `_heads_per_op` gives them
    HEAD_OUTPUTS = ("roi", "roi_scales", "coord", "coord_scales", "unnormalized_quat", "rot", "pose_scales_tril",
                    "pt3d_68", "shapeparam", "pt3d_68_scales", "shapeparam_scales")

    def __init__(
        self,
        enable_point_head: bool = True,
        enable_face_detector: bool = False,
        config: str = "mobilenetv1",
        enable_uncertainty: bool = False,
        dropout_prob: Optional[float] = None,  # accepted for config compat; unused
        use_local_pose_offset: bool = True,
        backbone_args: Optional[Dict[str, Any]] = None,
        enable_6drot: bool = False,
        dtype: torch.dtype = torch.float32,
        input_resolution: int = 129,
    ):
        super().__init__()
        self.enable_point_head = enable_point_head
        self.enable_face_detector = enable_face_detector
        self.enable_uncertainty = enable_uncertainty
        self.use_local_pose_offset = use_local_pose_offset
        self.backbone_args = dict(backbone_args or {})
        self.config = config
        self.enable_6drot = enable_6drot
        self.dtype = dtype
        self.input_resolution = input_resolution

        self.convnet = create_pose_estimator_backbone(self.num_heads, config, self.backbone_args, input_resolution)
        n = self.convnet.num_features
        self.boxnet = BoundingBox(n, enable_uncertainty)
        self.posnet = PositionSizeOutput(n, enable_uncertainty)
        rot_head = RotRepr6dWithNormalization if enable_6drot else DirectQuaternionWithNormalization
        self.quatnet = rot_head(n, enable_uncertainty)
        if use_local_pose_offset:
            self.local_pose_offset = LocalToGlobalCoordinateOffset(self.NUM_DATASET_CONSTANTS)
            if enable_point_head:
                self.local_pose_offset_kpts = LocalToGlobalCoordinateOffset(self.NUM_DATASET_CONSTANTS)
        if enable_point_head:
            self.landmarks = Landmarks3dOutput(n, enable_uncertainty)
        if enable_face_detector:
            self.face_detector = nn.Linear(n, 1)

    @property
    def num_heads(self) -> int:
        return 3 + int(self.enable_point_head) + int(self.enable_face_detector)

    @property
    def name_tag(self) -> str:
        """The name of the training CLI's output directory for this network."""
        return type(self).__name__ + "_" + self.config

    def get_config(self) -> Dict[str, Any]:
        """The constructor arguments a checkpoint records (the JAX package's
        `get_config`, key for key)."""
        return {
            "enable_point_head": self.enable_point_head,
            "enable_face_detector": self.enable_face_detector,
            "config": self.config,
            "enable_uncertainty": self.enable_uncertainty,
            "use_local_pose_offset": self.use_local_pose_offset,
            "backbone_args": dict(self.backbone_args),
            "enable_6drot": self.enable_6drot,
        }

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's default init: lecun-normal kernels, zero biases, then each
        backbone module's own init (`init_extra`) and each head's bias init.
        Scale parameters, offsets and BN stay as built."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        for mod in self.modules():
            if hasattr(mod, "init_extra"):
                mod.init_extra(generator)
        for head in (self.boxnet, self.posnet, self.quatnet, getattr(self, "landmarks", None)):
            if head is not None:
                head.init_bias()

    def _precision(self, device_type: str):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        # no cast cache in training: a CUDA graph capture of the step refuses it; the values are the same
        return torch.autocast(device_type, dtype=self.dtype, cache_enabled=not self.training)

    @property
    def fused_heads(self) -> bool:
        """Whether the heads after their linear layers run as one
        `kernels.heads.pose_heads` call (one kernel forward, one backward on
        the card): with the quaternion head, the point head and the local pose
        offsets. The 6D head and the head sets without points or offsets go
        op by op (`_heads_per_op`)."""
        return not self.enable_6drot and self.enable_point_head and self.use_local_pose_offset

    def _heads_per_op(self, zs, set_id) -> Dict[str, Any]:
        """The heads module by module on the features `zs` (popped box, position, rotation, points)."""
        out: Dict[str, Any] = self.boxnet(zs.pop())
        out.update(self.posnet(zs.pop()))
        out.update(self.quatnet(zs.pop()))
        rots, coords = out["rot"], out["coord"]
        if self.use_local_pose_offset:
            out["rot"], out["coord"] = self.local_pose_offset(rots, coords, set_id)
            if self.enable_point_head:
                rots_k, coords_k = self.local_pose_offset_kpts(rots, coords, set_id)
                out.update(self.landmarks(zs.pop(), rots_k, coords_k))
        elif self.enable_point_head:
            out.update(self.landmarks(zs.pop(), rots, coords))
        return out

    def _heads_fused(self, zs, set_id) -> Dict[str, Any]:
        """What `_heads_per_op` gives, the same dict in the same order, from
        the head linears and one `pose_heads` call."""
        zb, zp, zq, zl = zs.pop(), zs.pop(), zs.pop(), zs.pop()
        inputs = dict(
            box=self.boxnet.linear(zb).float(), xy=self.posnet.linear_xy(zp).float(),
            size=self.posnet.linear_size(zp).float(), quat=self.quatnet.linear(zq).float(),
            shape=self.landmarks.shapenet(zl).float(), offset=self.local_pose_offset.p,
            offset_kpts=self.local_pose_offset_kpts.p, set_id=set_id,
            keypts=self.landmarks.deformablekeypoints.keypts,
            keyeigvecs=self.landmarks.deformablekeypoints.keyeigvecs,
        )
        if self.enable_uncertainty:
            inputs.update(
                neck_rot=self.quatnet.uncertainty_net.neck.linear(zq), min_diag_rot=self.quatnet.uncertainty_net.min_diag,
                neck_coord=self.posnet.scales.neck.linear(zp), min_diag_coord=self.posnet.scales.min_diag,
                hidden_roi=self.boxnet.scales.hidden_scale,
                hidden_pt3d=self.landmarks.point_distrib_scales.hidden_scale,
                hidden_shape=self.landmarks.shape_distrib_scales.hidden_scale,
            )
        h = pose_heads(**inputs)
        h.update(rot=QuatRepr(h["rot"]), shapeparam=inputs["shape"])
        if self.enable_uncertainty:  # the diagonal scales over the batch, as the modules give them
            h["roi_scales"] = h["roi_scales"][None, :].expand(h["roi"].shape)
            h["pt3d_68_scales"] = h["pt3d_68_scales"][None, :, None].expand(h["pt3d_68"].shape)
            h["shapeparam_scales"] = h["shapeparam_scales"][None, :].expand(inputs["shape"].shape)
        return {k: h[k] for k in self.HEAD_OUTPUTS if h.get(k) is not None}

    def forward(self, x: torch.Tensor, coord_convention_id=None, generator: Optional[torch.Generator] = None,
                mask_generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """x: (B, H, W, C) whitened crops. Train/eval follows `self.training`;
        eval mode adds 'pose' (the quaternion). In training, the backbone's
        dropout and stochastic-depth masks come from `mask_generator` (a
        generator on x's device, seeded by the caller), else from one on x's
        device seeded by one draw from `generator`, else from torch's global
        one."""
        assert x.shape[1] == x.shape[2] == self.input_resolution, f"Bad input shape {x.shape}"
        gen = None
        if self.training and self.convnet.draws_masks:
            gen = mask_generator if mask_generator is not None else device_generator(generator, x.device)
        with self._precision(x.device.type):
            features, _ = self.convnet(x.permute(0, 3, 1, 2), generator=gen)
            if self.config == "hybrid_vit":  # one query output per head, taken from the last
                zs = [features[:, i, :] for i in range(self.num_heads)]
            else:
                zs = [features] * self.num_heads
            if self.fused_heads:
                out = self._heads_fused(zs, coord_convention_id)
            else:
                out = self._heads_per_op(zs, coord_convention_id)
            if self.enable_face_detector:
                logits = self.face_detector(zs.pop()).float()[..., 0]
                out["hasface_logits"] = logits
                out["hasface"] = torch.sigmoid(logits)
        if not self.training:
            out["pose"] = out["rot"].as_quat()
        return out
