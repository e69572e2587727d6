"""K1: the training crop warp (counterpart of the JAX package's
`augmentation/warp_pallas.py:warp_roi_rotate_pallas`).

Per sample: a separable triangle-filter resample of the view ROI onto a
CS x CS canvas (antialiased when minifying), three Paeth shears that rotate
it about its centre (skipped with `skip_rotation`), and the centre S x S crop.
Flip and rot90 arrive folded into the ROI and angle (`augmentation/warp_fast.py`).

`warp_roi_rotate` launches the CUDA kernel (`csrc/warp.cu`) for a CUDA tensor
and takes `warp_roi_rotate_plain` for a CPU tensor; both take the same
per-sample parameter rows from `warp_params`.
"""

import math

import torch

from neuralnet_tracker_traincode_torch.kernels import ext


def canvas_size(out_size: int, theta_max_deg: float) -> int:
    """Canvas big enough that the final out_size^2 crop only ever pulls
    in-canvas content through the three shear passes."""
    a = abs(math.tan(math.radians(theta_max_deg) / 2.0))
    b = abs(math.sin(math.radians(theta_max_deg)))
    hx = hy = out_size / 2.0
    hx = hx + a * hy  # innermost x-shear
    hy = hy + b * hx  # y-shear
    hx = hx + a * hy  # outermost x-shear
    c = 2 * (int(math.ceil(max(hx, hy))) + 1)
    if (c - out_size) % 2:  # keep the crop centred on whole pixels
        c += 1
    return c


def warp_params(view_roi: torch.Tensor, angles: torch.Tensor, out_size: int, cs: int) -> torch.Tensor:
    """(B, 6) f32 rows [y0', sy, x0', sx, a, b]: canvas start and scale per
    axis, and the Paeth shear coefficients a = -tan(phi/2), b = sin(phi) of
    the pull rotation phi = -angle."""
    S = float(out_size)
    x0, y0 = view_roi[:, 0], view_roi[:, 1]
    sx = (view_roi[:, 2] - x0) / S
    sy = (view_roi[:, 3] - y0) / S
    m = (cs - out_size) / 2.0
    phi = -angles
    return torch.stack(
        [y0 - sy * m, sy, x0 - sx * m, sx, -torch.tan(phi / 2.0), torch.sin(phi)], dim=-1
    ).float().contiguous()


def _tri_weights(start, scale, n_out: int, n_src: int) -> torch.Tensor:
    """(B, n_out, n_src) triangle-filter weights, each row divided by its sum + 1e-8."""
    c = torch.arange(n_out, dtype=torch.float32, device=start.device)
    h = torch.arange(n_src, dtype=torch.float32, device=start.device)
    p = start[:, None] + scale[:, None] * (c[None, :] + 0.5)
    supp = torch.clamp(torch.abs(scale), min=1.0)[:, None, None]
    t = (h[None, None, :] + 0.5 - p[:, :, None]) / supp
    w = torch.clamp(1.0 - torch.abs(t), min=0.0)
    return w / (torch.sum(w, dim=-1, keepdim=True) + 1e-8)


def _shear_rows(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """out[b, y, j] = x(b, y, j + coef_b * (y + 0.5 - c0)), 2-tap lerp, zero fill."""
    B, R, C = x.shape
    c0 = C / 2.0
    s = coef[:, None] * ((torch.arange(R, dtype=torch.float32, device=x.device) + 0.5) - c0)
    i0 = torch.floor(s)
    f = (s - i0)[:, :, None]
    idx = torch.arange(C, device=x.device)[None, None, :] + i0.long()[:, :, None]

    def tap(k):
        valid = (k >= 0) & (k < C)
        return torch.gather(x, 2, k.clamp(0, C - 1)) * valid

    return (1.0 - f) * tap(idx) + f * tap(idx + 1)


def warp_roi_rotate_plain(images: torch.Tensor, params: torch.Tensor, out_size: int, cs: int, rotate: bool):
    """Plain PyTorch K1: dense weight matrices, two batched matmuls, shears by gather."""
    B, H, W = images.shape
    wy = _tri_weights(params[:, 0], params[:, 1], cs, H)
    wx = _tri_weights(params[:, 2], params[:, 3], cs, W)
    canvas = torch.bmm(torch.bmm(wy, images.float()), wx.transpose(1, 2))
    if not rotate:
        return canvas
    canvas = _shear_rows(canvas, params[:, 4])
    canvas = _shear_rows(canvas.transpose(1, 2), params[:, 5]).transpose(1, 2)
    canvas = _shear_rows(canvas, params[:, 4])
    lo = (cs - out_size) // 2
    return canvas[:, lo : lo + out_size, lo : lo + out_size].contiguous()


def warp_roi_rotate(
    images: torch.Tensor,  # (B, H, W) uint8, single channel
    view_roi: torch.Tensor,  # (B, 4) x0 y0 x1 y1, possibly reversed (folded flips)
    angles: torch.Tensor,  # (B,) radians
    out_size: int,
    theta_max_deg: float,
    skip_rotation: bool = False,
) -> torch.Tensor:
    """(B, S, S) f32 crops in 0..255: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    S = int(out_size)
    cs = S if skip_rotation else canvas_size(S, theta_max_deg)
    params = warp_params(view_roi.to(images.device), angles.to(images.device), S, cs)
    if images.device.type == "cpu":
        return warp_roi_rotate_plain(images, params, S, cs, not skip_rotation)
    ext.require_cuda_tensor(images, "images", torch.uint8, 3)
    B = images.shape[0]
    out = torch.empty((B, S, S), dtype=torch.float32, device=images.device)
    canvas = (
        out if skip_rotation else torch.empty((B, cs, cs), dtype=torch.float32, device=images.device)
    )
    ext.extension().warp_roi_rotate(images, params, canvas, out, S, cs, not skip_rotation)
    ext.LAUNCHES["warp_roi_rotate"] += 1
    return out
