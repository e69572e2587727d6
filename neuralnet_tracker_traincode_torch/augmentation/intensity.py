"""Intensity (photometric) augmentations (counterpart of the JAX package's
`augmentation/intensity.py`).

  stage 1 (random_apply=4 of 6): equalize p=.2, posterize(4-6) p=.01,
           gamma(.5-2) p=.2, contrast(.7-1.5) p=.2, brightness(.7-1.5) p=.2,
           gaussian blur 5x5 sigma 1.5 p=.1
  stage 2: stacked gaussian noise sigma in {4,16,32,64}/255 at p=.25^k, one
           draw at the combined sigma, clip.

A random 4-subset of the 6 ops, in random order, is drawn per BATCH; each
selected op then gates per sample with its own probability. Sampling
(`sample_stage1_parameters`, `sample_noise_parameters`, from a
`torch.Generator`) is separate from applying. Equalize runs through K2
(`kernels/equalize.py`) and the noise through K3 (`kernels/noise.py`).
Images are floats in [0, 1], shape (B, H, W, C).

Stage 1 is branch-free: the drawn order stays on the device, and each of the
4 slots applies all 6 ops, op o gated per sample by (perm[slot] == o) and
its own mask. An op whose gate is off returns its input unchanged (`where`,
and K2 passes a gated-off image through), so this equals applying the 4
drawn ops in the drawn order, bit for bit, with no value read back: the
same kernels run for every draw, as a CUDA graph of the step needs.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neuralnet_tracker_traincode_torch.device import device_constant
from neuralnet_tracker_traincode_torch.kernels import equalize as K2
from neuralnet_tracker_traincode_torch.kernels import noise as K3

OP_NAMES = ("equalize", "posterize", "gamma", "contrast", "brightness", "blur")
OP_PROBS = (0.2, 0.01, 0.2, 0.2, 0.2, 0.1)
NOISE_SIGMAS = np.asarray([4.0, 16.0, 32.0, 64.0], np.float32) / 255.0
NOISE_PROBS = np.asarray([0.25, 0.25**2, 0.25**3, 0.25**4], np.float32)


class Stage1Parameters(NamedTuple):
    perm: torch.Tensor  # (6,) op order; the first `random_apply` run
    masks: torch.Tensor  # (6, B) bool per-sample gate of each op
    values: torch.Tensor  # (6, B) f32 per-sample value of each op (unused for equalize / blur)

    def to(self, device) -> "Stage1Parameters":
        return Stage1Parameters(*(t.to(device) for t in self))

    def rows(self, rows: slice) -> "Stage1Parameters":
        """The draws of batch rows `rows`: the batch is axis 1 of `masks` and
        `values`; `perm` is the whole batch's."""
        return Stage1Parameters(self.perm, self.masks[:, rows], self.values[:, rows])


class NoiseParameters(NamedTuple):
    sigma: torch.Tensor  # (B,) combined sigma, 0 = pass-through
    seeds: torch.Tensor  # (B,) int32 per-sample Philox keys

    def to(self, device) -> "NoiseParameters":
        return NoiseParameters(self.sigma.to(device), self.seeds.to(device))

    def rows(self, rows: slice) -> "NoiseParameters":
        """The draws of batch rows `rows`: rows r.b to (r + 1).b of a batch
        drawn whole keep the keys base + r.b + arange(b)."""
        return NoiseParameters(self.sigma[rows], self.seeds[rows])


def sample_stage1_parameters(generator: Optional[torch.Generator], B: int) -> Stage1Parameters:
    g = dict(generator=generator)
    perm = torch.randperm(6, **g)
    masks = torch.rand((6, B), **g) < torch.tensor(OP_PROBS)[:, None]
    u = torch.rand((6, B), **g)
    lo = torch.tensor([0.0, 4.0, 0.5, 0.7, 0.7, 0.0])[:, None]
    hi = torch.tensor([0.0, 6.0, 2.0, 1.5, 1.5, 0.0])[:, None]
    values = lo + (hi - lo) * u
    # posterize truncates a continuous uniform(4, 6) to bits in {4, 5}
    values[1] = torch.floor(values[1])
    return Stage1Parameters(perm, masks, values)


def combine_noise_sigma(applied: torch.Tensor) -> torch.Tensor:
    """(B, 4) bool layers applied -> (B,) sigma of their sum."""
    sig2 = device_constant(NOISE_SIGMAS, applied.device) ** 2
    return torch.sqrt(torch.sum(sig2[None, :] * applied, dim=-1))


def sample_noise_parameters(generator: Optional[torch.Generator], B: int) -> NoiseParameters:
    applied = torch.rand((B, 4), generator=generator) < torch.as_tensor(NOISE_PROBS)[None, :]
    # base + arange: collision-free per-sample keys within the batch
    base = int(torch.randint(0, 2**32, (), generator=generator, dtype=torch.int64))
    seeds = (base + torch.arange(B, dtype=torch.int64)) % 2**32
    seeds = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(torch.int32)  # same bits as uint32
    return NoiseParameters(combine_noise_sigma(applied), seeds)


def _per_sample_where(mask, a, b):
    return torch.where(mask[:, None, None, None], a, b)


def equalize(images: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel histogram equalization through K2, gated per sample."""
    B, H, W, C = images.shape
    flat = images.permute(0, 3, 1, 2).reshape(B * C, H * W).contiguous()
    out = K2.equalize(flat, gate[:, None].expand(B, C).reshape(B * C))
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)


def posterize(images: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep the top `bits` bits of each 8-bit pixel; bits shape (B,)."""
    x = torch.clamp(images * 255.0, 0.0, 255.0).to(torch.int32)
    shift = (8 - bits).to(torch.int32)[:, None, None, None]
    x = (x >> shift) << shift
    return x.float() / 255.0


def adjust_gamma(images: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.clamp(images, min=0.0), gamma[:, None, None, None])


def adjust_contrast(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(images * factor[:, None, None, None], 0.0, 1.0)


def adjust_brightness(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return torch.clamp(images + (factor - 1.0)[:, None, None, None], 0.0, 1.0)


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(images: torch.Tensor, ksize: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Separable depthwise gaussian blur with reflect padding (kornia default)."""
    C = images.shape[-1]
    k = device_constant(_gaussian_kernel1d(ksize, sigma), images.device)
    pad = ksize // 2
    x = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    x = F.conv2d(x, k[None, None, :, None].expand(C, 1, ksize, 1), groups=C)
    x = F.conv2d(x, k[None, None, None, :].expand(C, 1, 1, ksize), groups=C)
    return x.permute(0, 2, 3, 1)


def _stage1_op(op: int, x: torch.Tensor, mask: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    if op == 0:
        return equalize(x, mask)
    if op == 1:
        fn = posterize(x, value)
    elif op == 2:
        fn = adjust_gamma(x, value)
    elif op == 3:
        fn = adjust_contrast(x, value)
    elif op == 4:
        fn = adjust_brightness(x, value)
    else:
        fn = gaussian_blur(x, 5, 1.5)
    return _per_sample_where(mask, fn, x)


def intensity_augmentation_stage1(images: torch.Tensor, params: Stage1Parameters, random_apply: int = 4):
    """The ops perm[:random_apply] in that order, each gated per sample by
    its mask, as `random_apply` slots of all 6 ops (module docstring)."""
    x = images
    for slot in range(random_apply):
        chosen = params.perm[slot]
        for op in range(len(OP_NAMES)):
            x = _stage1_op(op, x, (chosen == op) & params.masks[op], params.values[op])
    return x


def intensity_augmentation_noise(images: torch.Tensor, params: NoiseParameters, offset: float) -> torch.Tensor:
    """Gaussian noise at the combined per-sample sigma through K3, then clip,
    then add `offset` (the caller's whitening, in the same pass)."""
    return K3.add_gaussian_noise(images.contiguous(), params.seeds, params.sigma, offset)


def intensity_augmentation(
    images: torch.Tensor, stage1: Stage1Parameters, noise: NoiseParameters, offset: float
) -> torch.Tensor:
    return intensity_augmentation_noise(intensity_augmentation_stage1(images, stage1), noise, offset)
