"""MobileNet v1 (Howard et al. 2017, arXiv:1704.04861) as the pose network
uses it: a 1-channel 5 x 5 stride-2 stem and 13 depthwise-separable blocks
(3 x 3 depthwise, BatchNorm, ReLU, 1 x 1 pointwise, BatchNorm, a residual
where stride 1 keeps the width, ReLU), width multiplier, global average
pool. Plain PyTorch, float32."""

import torch.nn.functional as F
from torch import nn

from portbench.reference.model import BatchNorm, conv

BLOCKS = [
    ("dw2_1", 64, 1), ("dw2_2", 128, 2), ("dw3_1", 128, 1), ("dw3_2", 256, 2),
    ("dw4_1", 256, 1), ("dw4_2", 512, 2), ("dw5_1", 512, 1), ("dw5_2", 512, 1),
    ("dw5_3", 512, 1), ("dw5_4", 512, 1), ("dw5_5", 512, 1), ("dw5_6", 1024, 2),
    ("dw6", 1024, 1),
]


class Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.residual = stride == 1 and c_in == c_out
        self.conv_dw = nn.Conv2d(c_in, c_in, 3, stride, 1, groups=c_in, bias=False)
        self.bn_dw = BatchNorm(c_in)
        self.conv_sep = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.bn_sep = BatchNorm(c_out)

    def forward(self, x):
        y = F.relu(self.bn_dw(conv(x, self.conv_dw)))
        y = self.bn_sep(conv(y, self.conv_sep))
        return F.relu(y + x if self.residual else y)


class Backbone(nn.Module):
    def __init__(self, widen_factor: float = 1.0, use_blurpool: bool = False):
        super().__init__()
        if use_blurpool:
            raise ValueError("this reference has no BlurPool")
        w = widen_factor
        self.num_features = int(1024 * w)
        self.conv1 = nn.Conv2d(1, int(32 * w), 5, 2, 2, bias=False)
        self.bn1 = BatchNorm(int(32 * w))
        c = int(32 * w)
        for name, planes, stride in BLOCKS:
            setattr(self, name, Block(c, int(planes * w), stride))
            c = int(planes * w)

    def stem(self):
        return self.conv1

    def forward(self, x):
        x = F.relu(self.bn1(conv(x, self.conv1)))
        for name, _, _ in BLOCKS:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))
