"""The pose network in plain PyTorch: a backbone from `backbones/<name>.py`
(found by the configuration's `backbone`), then the box, position and size,
quaternion and landmark heads with their NLL scale heads, and the learned
per-dataset pose offsets. Parameter and buffer names are the configuration's
published layout, so one state dict serves every implementation.

`precision` rounds the operands of every convolution and linear layer
outside the scale necks (which run in float32 in the configuration): None
keeps float32; a dtype (torch.bfloat16, torch.float8_e4m3fn) rounds each
operand to it and back, so the products see that precision's inputs."""

import importlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import geometry as G

KEYPOINTS_NPZ = __file__.rsplit("/", 1)[0] + "/bfm_keypoints_subset.npz"


class Precision:
    """Where the convolutions and linears of the network round their operands."""

    dtype: Optional[torch.dtype] = None

    @classmethod
    def round(cls, x):
        if cls.dtype is None:
            return x
        if cls.dtype.is_floating_point and cls.dtype.itemsize == 1:  # fp8: scale into range first
            amax = x.detach().abs().amax().clamp(min=1e-12)
            scale = torch.finfo(cls.dtype).max / amax / 2.0
            q = (x.detach() * scale).to(cls.dtype).float() / scale
        else:
            q = x.detach().to(cls.dtype).float()
        return x + (q - x.detach())  # the rounding in the forward pass, the identity in the backward


class Flops:
    """While `counts` is a dict, each convolution and linear layer adds its
    forward FLOPs for one image (2 a multiply-add) under its module."""

    counts: Optional[Dict[nn.Module, float]] = None

    @classmethod
    def add(cls, module: nn.Module, out, fan_in: int):
        if cls.counts is not None:
            cls.counts[module] = cls.counts.get(module, 0.0) + 2.0 * fan_in * out[0].numel()


def conv(x, conv_module: nn.Conv2d):
    m = conv_module
    out = F.conv2d(Precision.round(x), Precision.round(m.weight), None if m.bias is None else m.bias, m.stride,
                   m.padding, m.dilation, m.groups)
    Flops.add(m, out, m.weight[0].numel())
    return out


def linear(x, lin: nn.Linear):
    out = F.linear(Precision.round(x), Precision.round(lin.weight), lin.bias)
    Flops.add(lin, out, lin.in_features)
    return out


class BatchNorm(nn.BatchNorm2d):
    """Training BatchNorm: the batch's biased variance normalises and feeds
    the running variance (momentum 0.1)."""

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean[None, :, None, None]) * (inv * self.weight)[None, :, None, None] + self.bias[None, :, None, None]


class Neck(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.lin = nn.Linear(n_in, n_out + 1)

    def forward(self, x):
        y = F.linear(x.float(), self.lin.weight, self.lin.bias)
        Flops.add(self.lin, y, self.lin.in_features)
        return y[..., 1:], G.smoothclip0(y[..., :1])


class DiagonalScaleParameter(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.hidden_scale = nn.Parameter(torch.zeros(n + 1))

    def forward(self):
        h = self.hidden_scale
        return G.smoothclip0(h[:1]) * G.smoothclip0(h[1:]) + 1.0e-6


class TriangularScale(nn.Module):
    """Features -> lower-triangular 3 x 3 scale: diagonal first (positive), then row by row."""

    def __init__(self, n_in: int):
        super().__init__()
        self.neck = Neck(n_in, 6)
        min_diag = torch.zeros(6)
        min_diag[:3] = 1.0e-6
        self.register_buffer("min_diag", min_diag)

    def forward(self, x):
        z, mult = self.neck(x)
        z = mult * torch.cat([G.smoothclip0(z[..., :3]), z[..., 3:]], dim=-1) + self.min_diag
        zero = torch.zeros_like(z[..., 0])
        return torch.stack([torch.stack([z[..., 0], zero, zero], -1), torch.stack([z[..., 3], z[..., 1], zero], -1),
                            torch.stack([z[..., 4], z[..., 5], z[..., 2]], -1)], dim=-2)


class QuatHead(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.linear = nn.Linear(n, 4)
        self.uncertainty_net = TriangularScale(n)

    def forward(self, x):
        z = linear(x, self.linear).float()
        unnormalized = torch.cat([z[..., :3], G.smoothclip0(z[..., 3:])], dim=-1)
        return {"unnormalized_quat": unnormalized, "rot": G.qnormalized(unnormalized),
                "pose_scales_tril": self.uncertainty_net(x)}


class BoxHead(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.linear = nn.Linear(n, 4)
        self.scales = DiagonalScaleParameter(4)

    def forward(self, x):
        z = linear(x, self.linear).float()
        size = G.smoothclip0(z[..., 2:])
        return {"roi": torch.cat([z[..., :2] - size, z[..., :2] + size], dim=-1),
                "roi_scales": self.scales()[None, :].expand(z.shape)}


class PositionHead(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.linear_xy = nn.Linear(n, 2)
        self.linear_size = nn.Linear(n, 1)
        self.scales = TriangularScale(n)

    def forward(self, x):
        xy = linear(x, self.linear_xy).float()
        size = linear(x, self.linear_size).float()
        return {"coord": torch.cat([xy, G.smoothclip0(size)], dim=-1), "coord_scales": self.scales(x)}


class Keypoints(nn.Module):
    """The 68 BFM keypoints deformed by 40 shape and 10 expression parameters."""

    def __init__(self):
        super().__init__()
        with np.load(KEYPOINTS_NPZ) as f:
            keypts = f["keypts"].astype(np.float32)
            bases = np.concatenate([f["w_shp"][:40], f["w_exp"][:10]], axis=0).astype(np.float32)
        self.register_buffer("keypts", torch.from_numpy(keypts))
        self.register_buffer("keyeigvecs", torch.from_numpy(bases))

    def forward(self, params):
        K = self.keyeigvecs.shape[0]
        return (params.float() @ self.keyeigvecs.reshape(K, -1)).reshape(params.shape[:-1] + (68, 3)) + self.keypts


def posed(q, coord, local):
    """Rotate, scale all axes, move in xy only."""
    p = G.qrotate(q[..., None, :], local) * coord[..., None, 2:]
    return torch.cat([p[..., :2] + coord[..., None, :2], p[..., 2:]], dim=-1)


class LandmarkHead(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.deformablekeypoints = Keypoints()
        self.shapenet = nn.Linear(n, 50)
        self.point_distrib_scales = DiagonalScaleParameter(68)
        self.shape_distrib_scales = DiagonalScaleParameter(50)

    def forward(self, z, q, coord):
        shapeparam = linear(z, self.shapenet).float()
        pt3d = posed(q, coord, self.deformablekeypoints(shapeparam))
        return {"pt3d_68": pt3d, "shapeparam": shapeparam,
                "pt3d_68_scales": self.point_distrib_scales()[None, :, None].expand(pt3d.shape),
                "shapeparam_scales": self.shape_distrib_scales()[None, :].expand(shapeparam.shape)}


class PoseOffset(nn.Module):
    """Per-dataset offset: p[1] an x rotation and, with p[2], a shift; p[3] a scale."""

    def __init__(self, n_sets: int = 8):
        super().__init__()
        self.p = nn.Parameter(torch.zeros(n_sets, 4))

    def forward(self, q, coord, set_id):
        p = self.p[set_id.long()]
        scale = coord[..., 2:] * G.smoothclip0(p[..., 3])[..., None]
        shift = torch.cat([torch.zeros_like(p[..., :1]), p[..., 1:3]], dim=-1)
        pos = G.qrotate(q, shift)
        return G.qmult(q, G.qrotate_x(p[..., 1])), torch.cat([pos[..., :2] * scale + coord[..., :2], scale], dim=-1)


def load_backbone(name: str):
    return importlib.import_module(f"portbench.reference.backbones.{name}")


class PoseNetwork(nn.Module):
    """Backbone -> pooled features -> heads; input (B, S, S, 1) whitened crops."""

    def __init__(self, config: Dict):
        super().__init__()
        self.convnet = load_backbone(config["backbone"]).Backbone(**config.get("backbone_args", {}))
        n = self.convnet.num_features
        self.boxnet = BoxHead(n)
        self.posnet = PositionHead(n)
        self.quatnet = QuatHead(n)
        self.local_pose_offset = PoseOffset()
        self.local_pose_offset_kpts = PoseOffset()
        self.landmarks = LandmarkHead(n)

    def forward(self, x, set_id):
        f = self.convnet(x.permute(0, 3, 1, 2))
        out = self.boxnet(f)
        out.update(self.posnet(f))
        out.update(self.quatnet(f))
        q, coord = out["rot"], out["coord"]
        out["rot"], out["coord"] = self.local_pose_offset(q, coord, set_id)
        qk, ck = self.local_pose_offset_kpts(q, coord, set_id)
        out.update(self.landmarks(f, qk, ck))
        return out


def initial_values(net: nn.Module, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The configuration's initial state dict, from `gen` in one draw: every
    convolution and linear weight truncated normal (+-2 sd) with variance
    1 / fan-in, biases zero, the heads' bias priors, and each backbone's own
    rule (`init_extra`); the rest as the modules are built. The unit normals
    are drawn on `device` in one call, in the state dict's order."""
    sd = {k: v.detach().to(device).clone() for k, v in net.state_dict().items()}
    kernels = [n[:-len(".weight")] for n, m in net.named_modules() if isinstance(m, (nn.Conv2d, nn.Linear))
               for n in [n + ".weight"]]
    total = sum(sd[k + ".weight"].numel() for k in kernels)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    o = 0
    for k in kernels:
        w = sd[k + ".weight"]
        fan_in = w[0].numel()
        w.copy_(flat[o:o + w.numel()].view(w.shape) * (math.sqrt(1.0 / fan_in) / 0.87962566103423978))
        o += w.numel()
        if k + ".bias" in sd:
            sd[k + ".bias"].zero_()
    sd["quatnet.linear.bias"][G.IW] = math.log(0.1)
    sd["boxnet.linear.bias"].copy_(torch.tensor([0.0, 0.0, 0.5, 0.5]))
    sd["posnet.linear_size.bias"].fill_(0.5)
    for name in getattr(net.convnet, "zero_init", lambda: [])():
        sd["convnet." + name].zero_()
    return sd
