"""ResNet-18 (He et al. 2016, arXiv:1512.03385) as the pose network uses
it: a 1-channel 7 x 7 stride-2 stem, BatchNorm, ReLU, 3 x 3 stride-2 max
pool, four stages of two basic blocks (64, 128, 256, 512 planes; stride 2
and a 1 x 1 projection at the first block of stages 2-4), the last
BatchNorm of each block starting at scale 0, global average pool. Plain
PyTorch, float32."""

import torch.nn.functional as F
from torch import nn

from portbench.reference.model import BatchNorm, conv


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(c_out)
        self.downsample = None
        if stride != 1 or c_in != c_out:
            self.downsample = nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride, bias=False), BatchNorm(c_out))

    def forward(self, x):
        y = F.relu(self.bn1(conv(x, self.conv1)))
        y = self.bn2(conv(y, self.conv2))
        identity = x if self.downsample is None else self.downsample[1](conv(x, self.downsample[0]))
        return F.relu(y + identity)


class Backbone(nn.Module):
    num_features = 512

    def __init__(self, use_blurpool: bool = False):
        super().__init__()
        if use_blurpool:
            raise ValueError("this reference has no BlurPool")
        stages, c = [], 64
        for i in range(4):
            planes = 64 * 2**i
            stages.append(nn.Sequential(BasicBlock(c, planes, 1 if i == 0 else 2), BasicBlock(planes, planes, 1)))
            c = planes
        self.layers = nn.Sequential(nn.Conv2d(1, 64, 7, 2, 3, bias=False), BatchNorm(64), nn.ReLU(),
                                    nn.MaxPool2d(3, 2, 1), *stages)

    def stem(self):
        return self.layers[0]

    def zero_init(self):
        return [f"layers.{4 + s}.{b}.bn2.weight" for s in range(4) for b in range(2)]

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.layers[1](conv(x, self.layers[0]))), 3, 2, 1)
        for stage in self.layers[4:]:
            for block in stage:
                x = block(x)
        return x.mean(dim=(2, 3))
