"""Gather-free crop warp of the training augmentation (counterpart of the JAX
package's `augmentation/warp_fast.py`).

`warp_roi_rotate` realises `fliprot @ center_rot(angle) @ range_remap(view_roi
-> [0, S]^2)` on the image: the flip and the flip halves of the +-90 degree
rotations fold into reversed ROI ranges and negated angles, so one pass of
K1 (`kernels/warp.py`) does the crop, and only a per-sample transpose
remains. The label path composes the same map as an `Affine2d`
(`augmentation/pipeline.py`); both halves must change together.
"""

from typing import Optional

import torch

from neuralnet_tracker_traincode_torch.kernels import warp as K1
from neuralnet_tracker_traincode_torch.kernels.warp import canvas_size  # noqa: F401  (re-export)


def apply_fliprot(
    crop: torch.Tensor,  # (B, S, S, C)
    do_flip: Optional[torch.Tensor],  # (B,) bool
    rot_dir: Optional[torch.Tensor],  # (B,) in {-1, 0, +1}
) -> torch.Tensor:
    """Square-canvas horizontal flip, then +-90 degree rotation, per sample:
    exact pixel permutations (plain gathers) matching the Affine2d that
    `geometric.py:flip_rot90_transform` builds (the flip is x -> S - x,
    rot_dir +1 rotates by +90 degrees). The training step folds the flip
    into K1 instead (`fold_fliprot`)."""
    x = crop
    if do_flip is not None:
        x = torch.where(do_flip[:, None, None, None], x.flip(2), x)
    if rot_dir is not None:
        d = x.transpose(1, 2)
        rd = rot_dir[:, None, None, None]
        x = torch.where(rd > 0, d.flip(2), torch.where(rd < 0, d.flip(1), x))
    return x


def _masked_transpose(crop: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample transpose of the square (B, S, S, C) crop where mask holds:
    the residue of the folded +-90 degree rotations."""
    if mask is None:
        return crop
    return torch.where(mask[:, None, None, None], crop.transpose(1, 2), crop)


def fold_fliprot(view_roi, angles, do_flip=None, rot_dir=None):
    """Fold flip / rot90 choices into (view_roi, angles, transpose_mask).

    A horizontal flip equals sampling x along the REVERSED roi range with the
    rotation negated (F R(phi) = R(-phi) F). rot+90 = T flip_y and
    rot-90 = T flip_x, so their flip halves fold the same way (composed with
    do_flip) and a per-sample transpose is left.
    """
    if do_flip is None and rot_dir is None:
        return view_roi, angles, None
    B = view_roi.shape[0]
    flip = do_flip if do_flip is not None else torch.zeros((B,), dtype=torch.bool, device=view_roi.device)
    rd = rot_dir if rot_dir is not None else torch.zeros((B,), device=view_roi.device)
    swap_x = torch.logical_xor(flip, rd < 0)
    swap_y = rd > 0
    negate = torch.logical_xor(flip, rd != 0)
    x0, y0, x1, y1 = view_roi.unbind(-1)
    view_roi = torch.stack(
        [
            torch.where(swap_x, x1, x0),
            torch.where(swap_y, y1, y0),
            torch.where(swap_x, x0, x1),
            torch.where(swap_y, y0, y1),
        ],
        dim=-1,
    )
    angles = torch.where(negate, -angles, angles)
    return view_roi, angles, (rd != 0) if rot_dir is not None else None


def warp_roi_rotate(
    images: torch.Tensor,  # (B, H, W, C) uint8
    view_roi: torch.Tensor,  # (B, 4) x0 y0 x1 y1 source pixels (square)
    angles: torch.Tensor,  # (B,) radians, |angle| <= theta_max
    out_size: int,
    theta_max_deg: float,
    do_flip: Optional[torch.Tensor] = None,
    rot_dir: Optional[torch.Tensor] = None,
    skip_rotation: bool = False,
    plan: Optional[K1.LaunchPlan] = None,
) -> torch.Tensor:
    """Crop `view_roi` -> out_size^2 with in-plane rotation about the crop
    centre. Returns (B, S, S, C) float32 in 0..255. Channels go through K1
    as separate samples; `plan` is K1's launch plan (`kernels/warp.py`)."""
    B, H, W, C = images.shape
    S = int(out_size)
    view_roi, angles, transpose_mask = fold_fliprot(view_roi, angles, do_flip, rot_dir)
    if C == 1:
        planes = images.reshape(B, H, W)
    else:
        planes = images.permute(0, 3, 1, 2).reshape(B * C, H, W)
        view_roi = view_roi[:, None].expand(B, C, 4).reshape(B * C, 4)
        angles = angles[:, None].expand(B, C).reshape(B * C)
    crop = K1.warp_roi_rotate(planes.contiguous(), view_roi, angles, S, theta_max_deg, skip_rotation, plan=plan)
    crop = crop.reshape(B, C, S, S).permute(0, 2, 3, 1)
    return _masked_transpose(crop, transpose_mask)
