"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel's work can take on it (its roofline bound), and the model FLOPs a
trained image costs.

Bounds count what the inputs of a launch need: each input byte read once,
each output byte written once, and the operations the algorithm must do,
at the H100 SXM data sheet's rates. The forms of K1-K3's follow the
kernels' own arithmetic (the triangle-filter taps, the shears, the
histogram, Philox and Box-Muller)."""

import math
from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
I32_OPS_PER_S = 33.5e12  # 32-bit integer: half the float32 lanes per SM
BF16_DENSE_FLOPS = 989e12  # bf16 tensor cores, dense


def bound_s(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0) -> float:
    """The larger of the bytes' time and the operations' time, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S + i32_ops / I32_OPS_PER_S)


def canvas_size(out_size: int, theta_max_deg: float) -> int:
    a = abs(math.tan(math.radians(theta_max_deg) / 2.0))
    b = abs(math.sin(math.radians(theta_max_deg)))
    hx = hy = out_size / 2.0
    hx = hx + a * hy
    hy = hy + b * hx
    hx = hx + a * hy
    c = 2 * (int(math.ceil(max(hx, hy))) + 1)
    return c + 1 if (c - out_size) % 2 else c


def k1_bound(scales_y: torch.Tensor, scales_x: torch.Tensor, src: int, S: int, theta_max_deg: float) -> float:
    """K1 (crop warp) over a batch whose per-sample |source pixels per crop
    pixel| are `scales_y`, `scales_x`: the source rows and columns the canvas
    footprint covers (each byte once), 6 parameters a sample, the S^2 f32
    crop written; 2 operations a tap of the separable triangle filter over
    the canvas, 3 shears of 3 operations a canvas pixel."""
    cs = canvas_size(S, theta_max_deg)
    sy, sx = scales_y.abs().clamp(min=1.0), scales_x.abs().clamp(min=1.0)
    rows = torch.clamp(cs * scales_y.abs() + 2 * torch.ceil(sy) + 1, max=src)
    cols = torch.clamp(cs * scales_x.abs() + 2 * torch.ceil(sx) + 1, max=src)
    B = scales_y.numel()
    nbytes = float((rows * cols).sum()) + B * 6 * 4 + B * S * S * 4
    taps_y, taps_x = 2 * torch.ceil(sy) + 1, 2 * torch.ceil(sx) + 1
    ops = float((cs * rows * taps_y * 2 + cs * cs * taps_x * 2).sum()) + B * 3 * cs * cs * 3
    return bound_s(nbytes, f32_ops=ops)


def k2_bound(B: int, P: int) -> float:
    """K2 (equalize) over B images of P f32 pixels: read and written once, the gate; 4 operations a pixel."""
    return bound_s(2 * B * P * 4 + B * 4, f32_ops=4 * B * P)


def k3_bound(n_on: int, B: int, P: int) -> float:
    """K3 (gaussian noise, whitening fused) over B images of P pixels, n_on of
    them with sigma > 0: read and written once, seeds and sigma; half a
    Philox call (~50 integer operations) and 13 f32 operations a pixel of a
    sample with sigma > 0, clip and offset (3) otherwise."""
    return bound_s(2 * B * P * 4 + 8 * B, f32_ops=(13 * n_on + 3 * (B - n_on)) * P, i32_ops=50 * n_on * P)


def model_flops_per_image(config: Dict) -> float:
    """Training FLOPs one image costs the configuration's network at its
    input size, from the reference model's layer shapes: every convolution
    and linear layer's multiply-adds at 2 FLOPs each, forward once and
    backward twice (input and weight gradients), except the stem's input
    gradient, which no step computes. Elementwise work is not counted, so
    the count is the same whatever implements the layers."""
    from portbench.reference import model as M

    net = M.PoseNetwork(config)
    S = config["inputsize"]
    M.Flops.counts = {}
    try:
        with torch.no_grad():
            net(torch.zeros((2, S, S, 1)), torch.zeros((2,), dtype=torch.int32))
        fwd = dict(M.Flops.counts)
    finally:
        M.Flops.counts = None
    return 3.0 * sum(fwd.values()) - fwd.get(net.convnet.stem(), 0.0)
