"""Batched affine image warping by gathers with bilinear filtering
(counterpart of the JAX package's `augmentation/warp.py`), the eval crop.

The transform `tr` maps SOURCE pixel coordinates to OUTPUT pixel
coordinates, so sampling uses tr^-1. Out-of-bounds reads are zero (cv2
BORDER_CONSTANT 0). Anti-aliasing: each output pixel is the mean of an
`oversample` x `oversample` subpixel grid.

Plain tensor code, in the JAX package's arithmetic order: per output
subpixel the source coordinate `m00*gx + m01*gy + m02 - 0.5` elementwise in
f32 (no matrix product over the grid, which would round differently), four
clipped gathers masked to zero outside the image, the bilinear blend, then
the mean. `grid_sample` is not used: its normalised coordinates round
differently. No Pallas kernel computes this in the JAX package.
"""

from typing import Tuple, Union

import torch

from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d


def _bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) images at float array coordinates `x`, `y` (B, N):
    (B, N, C) f32, zero outside the image."""
    B, H, W, C = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(B, H * W, C)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)).float()
        return torch.where(inb[..., None], vals, 0.0)

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def warp_affine(
    images: torch.Tensor, tr: Affine2d, out_size: Union[int, Tuple[int, int]], oversample: int = 2
) -> torch.Tensor:
    """Warp (B, H, W, C) images with per-sample source->output transforms.

    Returns (B, out_h, out_w, C) f32 on the images' device. Output pixel j
    is sampled at continuous coordinate j + 0.5 (subpixel-jittered when
    oversampling); the inverse transform gives the source's continuous
    coordinate, and -0.5 turns it into an array index: the convention of the
    label transforms (after the half-pixel offset)."""
    B = images.shape[0]
    assert tuple(tr.m.shape[:-2]) == (B,), f"Need one transform per image, got {tuple(tr.m.shape[:-2])}"
    dev = images.device
    m = tr.inv().tensor().to(dev)
    s = oversample
    out_h, out_w = (out_size, out_size) if isinstance(out_size, int) else out_size
    nh, nw = out_h * s, out_w * s
    gx = ((torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) / s)[None, None, :]
    gy = ((torch.arange(nh, dtype=torch.float32, device=dev) + 0.5) / s)[None, :, None]
    c = lambda i, j: m[:, i, j, None, None]  # noqa: E731
    sx = c(0, 0) * gx + c(0, 1) * gy + c(0, 2) - 0.5
    sy = c(1, 0) * gx + c(1, 1) * gy + c(1, 2) - 0.5
    out = _bilinear_gather(images, sx.reshape(B, -1), sy.reshape(B, -1))
    C = out.shape[-1]
    out = out.reshape(B, nh, nw, C)
    if s > 1:
        out = out.reshape(B, out_h, s, out_w, s, C).mean(dim=(2, 4))
    return out


def croprescale(images: torch.Tensor, roi: torch.Tensor, out_size: int, oversample: int = 2) -> torch.Tensor:
    """Axis-aligned crop + rescale: roi (B, 4) in source pixels -> out_size^2."""
    B = images.shape[0]
    roi = torch.as_tensor(roi, dtype=torch.float32)
    tr = Affine2d.range_remap_2d(
        roi[..., :2],
        roi[..., 2:],
        torch.zeros((B, 2), device=roi.device),
        torch.full((B, 2), float(out_size), device=roi.device),
    )
    return warp_affine(images, tr, out_size, oversample)
