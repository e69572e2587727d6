"""MobileNet v1 backbone (counterpart of the JAX package's
`models/backbones/mobilenet_v1.py`): 5x5 stride-2 stem, 13 depthwise-separable
blocks, optional BlurPool striding, width multiplier. NCHW inside; returns
(pooled features (B, 1024*w), the 5 intermediate maps)."""

import torch
import torch.nn.functional as F
from torch import nn

from neuralnet_tracker_traincode_torch.models.backbones.common import (
    BatchNorm2d,
    BlurPool2D,
    global_avg_pool,
)


class DepthWiseBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_blurpool: bool = True):
        super().__init__()
        self.residual = stride == 1 and inplanes == planes
        if stride == 2 and use_blurpool:
            # state-dict keys conv_dw.0.kernel / conv_dw.1.weight, as the reference
            self.conv_dw = nn.Sequential(
                BlurPool2D(3, 2),
                nn.Conv2d(inplanes, inplanes, 3, 1, 1, groups=inplanes, bias=False),
            )
        else:
            self.conv_dw = nn.Conv2d(inplanes, inplanes, 3, stride, 1, groups=inplanes, bias=False)
        self.bn_dw = BatchNorm2d(inplanes)
        self.conv_sep = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn_sep = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_dw(self.conv_dw(x)))
        y = self.bn_sep(self.conv_sep(y))
        if self.residual:
            y = y + x
        return F.relu(y)


_BLOCKS = [
    ("dw2_1", 64, 1), ("dw2_2", 128, 2), ("dw3_1", 128, 1), ("dw3_2", 256, 2),
    ("dw4_1", 256, 1), ("dw4_2", 512, 2), ("dw5_1", 512, 1), ("dw5_2", 512, 1),
    ("dw5_3", 512, 1), ("dw5_4", 512, 1), ("dw5_5", 512, 1), ("dw5_6", 1024, 2),
    ("dw6", 1024, 1),
]
_OUTPUTS = ("dw2_1", "dw3_1", "dw4_1", "dw5_5", "dw6")


class MobileNet(nn.Module):
    draws_masks = False  # whether training draws dropout or stochastic-depth masks

    def __init__(self, widen_factor: float = 1.0, use_blurpool: bool = False, in_channels: int = 1):
        super().__init__()
        w = widen_factor
        self.num_features = int(1024 * w)
        self.conv1 = nn.Conv2d(in_channels, int(32 * w), 5, 2, 2, bias=False)
        self.bn1 = BatchNorm2d(int(32 * w))
        inplanes = int(32 * w)
        for name, planes, stride in _BLOCKS:
            setattr(self, name, DepthWiseBlock(inplanes, int(planes * w), stride, use_blurpool))
            inplanes = int(planes * w)

    def forward(self, x: torch.Tensor, generator=None):
        x = F.relu(self.bn1(self.conv1(x)))
        outs = []
        for name, _, _ in _BLOCKS:
            x = getattr(self, name)(x)
            if name in _OUTPUTS:
                outs.append(x)
        return global_avg_pool(x), outs
