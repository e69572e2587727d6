"""ResNet-18 backbone (counterpart of the JAX package's
`models/backbones/resnet.py`): 1-channel 7x7 stride-2 stem, max pool (or
BlurPool), four stages of two basic blocks, zero-initialised last BatchNorm
of each block, 512-d pooled output. NCHW inside.

Module names give the reference state-dict keys: `convnet.layers.0` the stem
conv, `.1` its BatchNorm, `.3` the pool (a BlurPool's `kernel` buffer),
`.4`-`.7` the stages; with BlurPool every block's `conv1` is (BlurPool at the
block's stride, 3x3 conv at stride 1), stride-1 blocks included.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d, BlurPool2D, global_avg_pool


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_blurpool: bool = False,
                 momentum: float = 0.1):
        super().__init__()
        if use_blurpool:
            self.conv1 = nn.Sequential(BlurPool2D(3, stride), nn.Conv2d(inplanes, planes, 3, 1, 1, bias=False))
        else:
            self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, momentum)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, momentum)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes, momentum))

    @torch.no_grad()
    def init_extra(self, generator: Optional[torch.Generator] = None):
        """Zero-init residual: the last BatchNorm's scale starts at 0."""
        self.bn2.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def make_stages(layers: Sequence[int], use_blurpool: bool, momentum: float):
    """The four stages of basic blocks (64, 128, 256, 512 planes), stride 2
    at the first block of every stage after the first."""
    stages, inplanes, planes = [], 64, 64
    for stage, num_blocks in enumerate(layers):
        blocks = []
        for b in range(num_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            blocks.append(BasicBlock(inplanes, planes, stride, use_blurpool, momentum))
            inplanes = planes
        stages.append(nn.Sequential(*blocks))
        planes *= 2
    return stages


class ResNetBackbone(nn.Module):
    draws_masks = False  # whether training draws dropout or stochastic-depth masks
    num_features = 512

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), use_blurpool: bool = False, momentum: float = 0.1):
        super().__init__()
        pool = BlurPool2D(3, 2) if use_blurpool else nn.MaxPool2d(3, 2, 1)
        self.layers = nn.Sequential(
            nn.Conv2d(1, 64, 7, 2, 3, bias=False), BatchNorm2d(64, momentum), nn.ReLU(), pool,
            *make_stages(layers, use_blurpool, momentum),
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return global_avg_pool(self.layers(x)), None


def resnet18(use_blurpool: bool = False) -> ResNetBackbone:
    return ResNetBackbone((2, 2, 2, 2), use_blurpool)
