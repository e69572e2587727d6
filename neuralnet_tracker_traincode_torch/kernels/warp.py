"""K1: the training crop warp (counterpart of the JAX package's
`augmentation/warp_pallas.py:warp_roi_rotate_pallas`).

Per sample: a separable triangle-filter resample of the view ROI onto a
CS x CS canvas (antialiased when minifying), three Paeth shears that rotate
it about its centre (skipped with `skip_rotation`), and the centre S x S crop.
Flip and rot90 arrive folded into the ROI and angle (`augmentation/warp_fast.py`).

`warp_roi_rotate` launches the CUDA kernel (`csrc/warp.cu`) for a CUDA tensor
and takes `warp_roi_rotate_plain` for a CPU tensor; both take the same
per-sample parameter rows from `warp_params`. The kernel keeps the canvas in
the shared memory of a 2-CTA cluster; `launch_plan` sizes that memory from
the batch's largest |scale|. The wrapper reads that scale back from the card
unless the caller hands it a plan: the training step plans on the host
(`rounded_plan`, from the host copies of its ROIs and draws), so that its
device part waits for nothing and can be captured in a CUDA graph.
`compose_shears_pull` is the kernel's index logic (the three shears and the
crop as one 8-tap pull) in PyTorch, for the CPU tests.
"""

import math
from typing import NamedTuple, Optional

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


SHARED_BYTES_PER_BLOCK = 232448  # the H100's 227 KB of opt-in shared memory
_TAP_GROUP = 8  # csrc/warp.cu: kTapGroup


class LaunchPlan(NamedTuple):
    taps_x: int  # filter taps per canvas column, for the batch's largest |sx|
    taps_y: int  # filter taps per canvas row, for the batch's largest |sy|
    chunk: int  # canvas rows filtered per step
    band_rows: int  # source rows a chunk of canvas rows may tap
    shared_bytes: int  # dynamic shared memory per CTA


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def shared_bytes(W: int, cs: int, rotate: bool, taps_x: int, taps_y: int, chunk: int, band_rows: int) -> int:
    """Shared memory of one CTA: `make_layout` of `csrc/warp.cu`, region by region."""
    rows, tpad, pitch = (cs + 1) // 2, _round_up(taps_x + 1, _TAP_GROUP), _round_up(W, 16)
    regions = [
        rows * cs * 4 if rotate else 0,  # canvas half
        tpad * cs * 4,  # horizontal weights
        cs * 4,  # horizontal window starts
        rows * taps_y * 4,  # vertical weights
        rows * 4,  # vertical first rows
        chunk * (pitch + tpad) * 4,  # vertically filtered rows
        2 * band_rows * pitch,  # two bands of source rows
    ]
    return sum(_round_up(r, 16) for r in regions)


def launch_plan(W: int, cs: int, rotate: bool, max_sy: float, max_sx: float) -> LaunchPlan:
    """The kernel's tap counts, chunk and band for a batch whose largest
    |sy|, |sx| are given; raises ValueError when no chunk fits in 227 KB."""

    def taps(s):  # the open support (p - supp, p + supp) holds at most ceil(2 supp) indices
        return int(math.ceil(2.0 * max(s, 1.0))) + 1

    tx, ty = taps(max_sx), taps(max_sy)
    for chunk in (16, 8, 4):
        # first taps of a chunk's rows span at most ceil((chunk - 1) |sy|) + 1 rows
        band_rows = int(math.ceil((chunk - 1) * max_sy)) + ty + 2
        nbytes = shared_bytes(W, cs, rotate, tx, ty, chunk, band_rows)
        if nbytes <= SHARED_BYTES_PER_BLOCK:
            return LaunchPlan(tx, ty, chunk, band_rows, nbytes)
    raise ValueError(
        f"K1 cannot hold a {cs}^2 canvas half and the taps of |scale| up to {max(max_sy, max_sx):.3g} "
        f"(source width {W}) in {SHARED_BYTES_PER_BLOCK} bytes of shared memory per block"
    )


PLAN_STEP = 0.5  # rounded_plan's grid of |scale|


def rounded_plan(W: int, cs: int, rotate: bool, max_sy: float, max_sx: float) -> LaunchPlan:
    """`launch_plan` for |scale| bounds known on the host, each rounded up to
    the next multiple of `PLAN_STEP` (after a relative margin of 2^-20), so
    that the plan is never smaller than the batch needs and batches of
    similar ROIs share one plan, and so one captured graph. A larger plan
    only adds taps of weight zero. Where the rounded bounds do not fit in
    shared memory, the plan is the bounds' own (with the margin)."""
    margin = 1.0 + 2.0**-20

    def up(s: float) -> float:
        return math.ceil(s * margin / PLAN_STEP) * PLAN_STEP

    try:
        return launch_plan(W, cs, rotate, up(max_sy), up(max_sx))
    except ValueError:
        return launch_plan(W, cs, rotate, max_sy * margin, max_sx * margin)


def compose_shears_pull(canvas: torch.Tensor, params: torch.Tensor, out_size: int) -> torch.Tensor:
    """The three shears and the centre crop of `warp_roi_rotate_plain` as one
    pull per output pixel, indexed as `csrc/warp.cu` does: output (r, q)
    lerps 2 values of stage 2 (zero fill on the column), each lerps 2 of
    stage 1 (zero fill on the row), each lerps 2 canvas values (zero fill on
    the canvas column), in the plain version's order of operations. (The
    kernel computes each stage-2 value once and hands it to the neighbouring
    output by a warp shuffle; the values are the same.) For the tests: it
    keeps the kernel's index logic checkable without a card."""
    B, cs, _ = canvas.shape
    S = int(out_size)
    lo = (cs - S) // 2
    dev = canvas.device
    line = (torch.arange(cs, dtype=torch.float32, device=dev) + 0.5) - cs / 2.0

    def shifts(coef):
        s = coef[:, None] * line[None, :]
        fl = torch.floor(s)
        return fl.long(), s - fl

    k_row, f_row = shifts(params[:, 4])  # stages 1 and 3: row y shifted by a
    k_col, f_col = shifts(params[:, 5])  # stage 2: column x shifted by b
    bi = torch.arange(B, device=dev)[:, None, None]
    y = (lo + torch.arange(S, device=dev))[None, :, None].expand(B, S, S)
    j = (lo + torch.arange(S, device=dev))[None, None, :].expand(B, S, S)

    def inside(i):
        return (i >= 0) & (i < cs)

    def stage1(yy, x):
        yc = yy.clamp(0, cs - 1)
        xx = x + k_row[bi, yc]
        f = f_row[bi, yc]
        v0 = canvas[bi, yc, xx.clamp(0, cs - 1)] * inside(xx)
        v1 = canvas[bi, yc, (xx + 1).clamp(0, cs - 1)] * inside(xx + 1)
        return ((1.0 - f) * v0 + f * v1) * inside(yy)

    def stage2(x):
        xc = x.clamp(0, cs - 1)
        ya = y + k_col[bi, xc]
        f = f_col[bi, xc]
        return ((1.0 - f) * stage1(ya, xc) + f * stage1(ya + 1, xc)) * inside(x)

    xa = j + k_row[bi, y]
    f = f_row[bi, y]
    return (1.0 - f) * stage2(xa) + f * stage2(xa + 1)


def warp_roi_rotate(
    images: torch.Tensor,  # (B, H, W) uint8, single channel
    view_roi: torch.Tensor,  # (B, 4) x0 y0 x1 y1, possibly reversed (folded flips)
    angles: torch.Tensor,  # (B,) radians
    out_size: int,
    theta_max_deg: float,
    skip_rotation: bool = False,
    plan: Optional[LaunchPlan] = None,
) -> torch.Tensor:
    """(B, S, S) f32 crops in 0..255: the kernel for a CUDA tensor, the plain
    version for a CPU tensor. On the card the kernel's shared memory follows
    `plan`, which must be at least the batch's own (`rounded_plan` of bounds
    on its |scale|); without one the wrapper reads the batch's largest
    |scale| back to the host."""
    S = int(out_size)
    cs = S if skip_rotation else canvas_size(S, theta_max_deg)
    params = warp_params(view_roi.to(images.device), angles.to(images.device), S, cs)
    if images.device.type == "cpu":
        return warp_roi_rotate_plain(images, params, S, cs, not skip_rotation)
    ext.require_cuda_tensor(images, "images", torch.uint8, 3)
    B, _, W = images.shape
    out = torch.empty((B, S, S), dtype=torch.float32, device=images.device)
    if plan is None:
        max_sy, max_sx = params[:, [1, 3]].abs().amax(0).tolist()
        plan = launch_plan(W, cs, not skip_rotation, max_sy, max_sx)
    ext.extension().warp_roi_rotate(images, params, out, S, cs, not skip_rotation, *plan[:4])
    ext.LAUNCHES["warp_roi_rotate"] += 1
    return out
