"""Shared backbone building blocks (counterpart of the JAX package's
`models/backbones/common.py`): BatchNorm with the JAX package's statistics,
BlurPool2D, global average pooling, the default weight init, and dropout
with its masks drawn from an explicit generator."""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralnet_tracker_traincode_torch.models.components import pascal_kernel_2d


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose running statistics follow flax, not torch.

    `torch.nn.BatchNorm2d` updates `running_var` with the UNBIASED batch
    variance; flax (the JAX reference) uses the biased one, which differs by
    n/(n-1) (18/17 for B=2 on a 3x3 map). Normalisation in training uses the
    biased variance in both. Momentum: flax 0.9 == torch 0.1; eps 1e-5.

    In training the running statistics come from the batch statistics that
    the normalisation computes anyway (mean and 1/sqrt(var + eps)), so the
    batch is reduced once.
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2) - self.eps  # the biased batch variance
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class BlurPool2D(nn.Module):
    """Blur (anti-alias) then downsample; fixed Pascal kernel buffer `kernel`,
    depthwise, zero padding (k-1)//2."""

    def __init__(self, kernel_size: int = 3, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.pad = (kernel_size - 1) // 2
        self.register_buffer("kernel", torch.from_numpy(pascal_kernel_2d(kernel_size)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        k = self.kernel.to(x.dtype)[None, None].expand(C, 1, -1, -1)
        return F.conv2d(x, k, stride=self.stride, padding=self.pad, groups=C)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C)"""
    return torch.mean(x, dim=(2, 3))


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
    """flax's default kernel init: truncated normal with variance 1/fan_in.

    fan_in of a torch weight is the product of all dims but the first
    (conv (O, I/g, k, k), linear (out, in)). 0.8796... is the std of a unit
    normal truncated at +-2, which flax divides out.
    """
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def draw_mask_seed(generator: torch.Generator) -> int:
    """The one draw from `generator` (the trainer's host generator) that
    seeds a forward's dropout and stochastic-depth masks."""
    return int(torch.randint(0, 2**62, (), generator=generator, dtype=torch.int64))


def device_generator(generator: Optional[torch.Generator], device: torch.device) -> Optional[torch.Generator]:
    """A generator on `device` seeded by `draw_mask_seed(generator)`, for a
    forward's dropout and stochastic-depth masks; None (torch's global
    generator) without one. The masks then follow the trainer's generator,
    whose state the resume file keeps."""
    if generator is None:
        return None
    return torch.Generator(device=device).manual_seed(draw_mask_seed(generator))


def dropout(x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `nn.Dropout`: keep each element with probability 1 - rate,
    scaled by 1 / (1 - rate); the mask is drawn from `generator`."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
