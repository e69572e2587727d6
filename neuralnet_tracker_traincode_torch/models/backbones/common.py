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

    With `sync` set (a `parallel.distributed.DataParallel` with a process
    group; `PoseTrainer` sets it where there are several ranks) training
    normalises by the statistics of the batch of all ranks, as flax does on
    a mesh's global array (`_SyncBatchNorm`). `torch.nn.SyncBatchNorm` would not do: it
    raises on CPU tensors and keeps the unbiased running variance.
    """

    sync = None

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        if self.sync is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, self.sync)
        else:
            y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = invstd.detach().pow(-2) - self.eps  # the biased batch variance
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def _channel_sums(*tensors: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) tensors -> one (k * C,) f64 vector of their per-channel sums."""
    return torch.cat([t.sum((0, 2, 3), dtype=torch.float64) for t in tensors])


class _SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the rows of all ranks. Returns (y, mean,
    biased variance); the last two feed the running statistics.

    Forward: each rank's count and per-channel sums of x and x^2 are summed
    over the ranks (one all-reduce of a (2C + 1,) f64 vector), and the mean
    and variance follow in f64. Backward: sum(dy) and sum(dy * (x - mean))
    are summed over the ranks for the input gradient; the weight and bias
    gradients stay this rank's, since the trainer sums the gradients over
    the ranks. On the card the rank's own reductions and the elementwise
    passes are PyTorch's fused BatchNorm kernels (`batch_norm_stats`, its
    f32 Welford statistics, `batch_norm_elemt`, `batch_norm_backward_reduce`,
    `batch_norm_backward_elemt`, as `torch.nn.SyncBatchNorm` uses them); on
    the CPU, where those do not exist, the sums accumulate in f64, as
    `torch.batch_norm` does there: the gradient of a conv that feeds
    BatchNorm is a small residue of them, which f32 sums move by up to 10% at
    full width. The output and the input gradient are in the input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, sync):
        C = x.shape[1]
        count = torch.full((1,), float(x.numel() // C), dtype=torch.float64, device=x.device)
        if x.is_cuda:
            mean, invstd = torch.batch_norm_stats(x, eps)
            mean = mean.double()
            sums = torch.cat([count * mean, count * (invstd.double().pow(-2) - eps + mean * mean), count])
        else:
            xf = x.float()
            sums = torch.cat([_channel_sums(xf, xf * xf), count])
        sums = sync.all_reduce_(sums)
        n = sums[2 * C]
        mean = sums[:C] / n
        var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
        mean, var = mean.float(), var.float()
        invstd = torch.rsqrt(var + eps)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        else:
            y = ((xf - mean[:, None, None]) * (invstd * weight.float())[:, None, None]
                 + bias.float()[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.sync = sync
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        if x.is_cuda:
            channels_last = x.is_contiguous(memory_format=torch.channels_last)
            dy = dy.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
            sum_dy, sum_dy_xmu, dweight, dbias = torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                                                 True, True, True)
            total = ctx.sync.all_reduce_(torch.cat([sum_dy, sum_dy_xmu]))
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, total[:C], total[C:],
                                                 n.to(torch.int32).reshape(1))
            return dx, dweight, dbias, None, None
        dyf = dy.float()
        x_hat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        local = _channel_sums(dyf, dyf * x_hat)  # this rank's bias and weight gradients
        total = (ctx.sync.all_reduce_(local.clone()) / n).float()
        dx = (weight.float() * invstd)[:, None, None] * (
            dyf - total[:C, None, None] - x_hat * total[C:, None, None])
        return dx.to(x.dtype), local[C:].to(weight.dtype), local[:C].to(weight.dtype), None, None


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
