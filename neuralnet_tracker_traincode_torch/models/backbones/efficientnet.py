"""EfficientNet-V1 backbone, b0 to b4 (counterpart of the JAX package's
`models/backbones/efficientnet.py`): a 1x1 1->3 channel adapter initialised
to broadcast the grayscale channel, the torchvision stage layout, squeeze and
excite, stochastic depth 0.1 x block_id / total on the residual blocks,
mean-pooled output. NCHW inside; BatchNorm momentum flax 0.99 == torch 0.01.

Module names give the reference (torchvision) state-dict keys:
`convnet.to_3chn_input`, `convnet.layers.0` (stem conv, BatchNorm),
`convnet.layers.1`-`.7` the stages of `MBConv`s, whose `block` holds the
expansion (when the ratio is not 1), the depthwise conv, `SqueezeExcite`
(`fc1`, `fc2`) and the projection; `convnet.layers.8` the head conv and
BatchNorm. The stochastic-depth masks are drawn from the generator the
forward is given.
"""

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d, global_avg_pool


class MBConvConfig(NamedTuple):
    expand_ratio: int
    kernel: int
    stride: int
    in_ch: int
    out_ch: int
    num_layers: int


_BASE_SETTINGS = [
    MBConvConfig(1, 3, 1, 32, 16, 1),
    MBConvConfig(6, 3, 2, 16, 24, 2),
    MBConvConfig(6, 5, 2, 24, 40, 2),
    MBConvConfig(6, 3, 2, 40, 80, 3),
    MBConvConfig(6, 5, 1, 80, 112, 3),
    MBConvConfig(6, 5, 2, 112, 192, 4),
    MBConvConfig(6, 3, 1, 192, 320, 1),
]

_SCALING = {  # (width_mult, depth_mult, head_features)
    "b0": (1.0, 1.0, 1280),
    "b1": (1.0, 1.1, 1280),
    "b2": (1.1, 1.2, 1408),
    "b3": (1.2, 1.4, 1536),
    "b4": (1.4, 1.8, 1792),
}

_MOMENTUM = 0.01  # flax 0.99


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def scaled_settings(kind: str) -> Tuple[List[MBConvConfig], int]:
    width_mult, depth_mult, head = _SCALING[kind]
    out = []
    for cfg in _BASE_SETTINGS:
        out.append(
            MBConvConfig(
                cfg.expand_ratio,
                cfg.kernel,
                cfg.stride,
                _make_divisible(cfg.in_ch * width_mult),
                _make_divisible(cfg.out_ch * width_mult),
                int(math.ceil(cfg.num_layers * depth_mult)),
            )
        )
    return out, head


def _conv_bn(in_ch: int, out_ch: int, k: int = 1, stride: int = 1, groups: int = 1, act: bool = True):
    layers = [nn.Conv2d(in_ch, out_ch, k, stride, k // 2, groups=groups, bias=False), BatchNorm2d(out_ch, _MOMENTUM)]
    return nn.Sequential(*layers, nn.SiLU()) if act else nn.Sequential(*layers)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze_ch: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_ch, 1)
        self.fc2 = nn.Conv2d(squeeze_ch, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        s = self.fc2(nn.functional.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, expand_ratio: int, kernel: int, stride: int, out_ch: int, sd_prob: float = 0.0):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        self.sd_prob = sd_prob
        expanded = in_ch * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(in_ch, expanded))
        layers.append(_conv_bn(expanded, expanded, kernel, stride, groups=expanded))
        layers.append(SqueezeExcite(expanded, max(1, in_ch // 4)))
        layers.append(_conv_bn(expanded, out_ch, act=False))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.block(x)
        if not self.use_res:
            return h
        if self.training and self.sd_prob > 0.0:
            keep = 1.0 - self.sd_prob
            mask = torch.rand((h.shape[0], 1, 1, 1), generator=generator, device=h.device) < keep
            h = h * mask / keep
        return h + x


class EfficientNetBackbone(nn.Module):
    """Returns (mean-pooled features, the stage outputs at /2 /4 /8 /16 /32)."""
    draws_masks = True  # whether training draws dropout or stochastic-depth masks

    def __init__(self, kind: str = "b0", stochastic_depth_prob: float = 0.1):
        super().__init__()
        self.kind = kind
        settings, head_features = scaled_settings(kind)
        self.num_features = head_features
        self.to_3chn_input = nn.Conv2d(1, 3, 1)
        stages = [_conv_bn(3, settings[0].in_ch, 3, 2)]
        total_blocks = sum(c.num_layers for c in settings)
        block_id = 0
        for cfg in settings:
            blocks = []
            for layer_idx in range(cfg.num_layers):
                stride = cfg.stride if layer_idx == 0 else 1
                in_ch = cfg.in_ch if layer_idx == 0 else cfg.out_ch
                sd_prob = stochastic_depth_prob * block_id / total_blocks
                blocks.append(MBConv(in_ch, cfg.expand_ratio, cfg.kernel, stride, cfg.out_ch, sd_prob))
                block_id += 1
            stages.append(nn.Sequential(*blocks))
        stages.append(_conv_bn(settings[-1].out_ch, head_features))
        self.layers = nn.Sequential(*stages)

    @torch.no_grad()
    def init_extra(self, generator: Optional[torch.Generator] = None):
        """The adapter broadcasts the grayscale channel: ones, zero bias."""
        self.to_3chn_input.weight.fill_(1.0)
        self.to_3chn_input.bias.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = self.layers[0](self.to_3chn_input(x))
        taps = []
        for stage in self.layers[1:-1]:
            for block in stage:
                x = block(x, generator)
            taps.append(x)
        x = self.layers[-1](x)
        return global_avg_pool(x), [taps[i] for i in (0, 1, 2, 4, 6)]
