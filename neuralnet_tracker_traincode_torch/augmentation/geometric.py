"""ROI-focus crop augmentation (counterpart of the JAX package's
`augmentation/geometric.py`).

Sampling is separate from applying: `make_roi_randomization_parameters` and
`sample_flip_rot90` draw from an explicit `torch.Generator` (on the host),
and the functions that apply take the drawn values. Video sequences share
their first frame's draws through `share_params_within_sequences`.
"""

import functools
import math
from typing import NamedTuple, Optional

import torch

from neuralnet_tracker_traincode_torch.augmentation.affine import apply_affine2d
from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
from neuralnet_tracker_traincode_torch.data.batch import Batch
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d

MAX_BEYOND_BORDER_SHIFT = 0.3


class RoiFocusRandomizationParameters(NamedTuple):
    scales: torch.Tensor  # (B,)
    angles: torch.Tensor  # (B,)
    translations: torch.Tensor  # (B, 2)

    def to(self, device) -> "RoiFocusRandomizationParameters":
        return RoiFocusRandomizationParameters(*(t.to(device) for t in self))


def make_roi_randomization_parameters(
    generator: Optional[torch.Generator],
    batchshape,
    rotation_aug_angle: float = 30.0,
    extension_factor: float = 1.1,
) -> RoiFocusRandomizationParameters:
    """Gaussian scale and translation jitter; +-angle rotation with p=1/3."""
    batchshape = tuple(batchshape)
    g = dict(generator=generator)
    scales = torch.clamp(torch.randn(batchshape, **g) * 0.1, -0.5, 0.5) + extension_factor
    translations = torch.clamp(torch.randn(batchshape + (2,), **g) * 0.5, -1.0, 1.0)
    if rotation_aug_angle:
        sign = torch.where(torch.rand(batchshape, **g) < 0.5, 1.0, -1.0)
        onoff = (torch.rand(batchshape, **g) < 1.0 / 3.0).float()
        angles = math.pi * rotation_aug_angle / 180.0 * sign * onoff
    else:
        angles = torch.zeros(batchshape)
    return RoiFocusRandomizationParameters(scales, angles, translations)


def no_roi_randomization(batchshape, extent_factor: float, device=None) -> RoiFocusRandomizationParameters:
    batchshape = tuple(batchshape)
    return RoiFocusRandomizationParameters(
        scales=torch.full(batchshape, extent_factor, device=device),
        angles=torch.zeros(batchshape, device=device),
        translations=torch.zeros(batchshape + (2,), device=device),
    )


def share_params_within_sequences(
    params: RoiFocusRandomizationParameters, param_index: torch.Tensor
) -> RoiFocusRandomizationParameters:
    """Every frame uses the params of the batch row `param_index` points at."""
    idx = param_index.long()
    return RoiFocusRandomizationParameters(*(t[idx] for t in params))


def compute_view_roi(face_bbox, enlargement_factor, translation_factor, beyond_border_shift: float):
    """Expanded and shifted square ROI around the face bbox."""
    x0, y0, x1, y1 = face_bbox.unbind(-1)
    rx, ry = translation_factor.unbind(-1)
    bbox_w = x1 - x0
    bbox_h = y1 - y0
    cx = 0.5 * (x1 + x0)
    cy = 0.5 * (y1 + y0)
    size = torch.maximum(bbox_w, bbox_h) * enlargement_factor
    wiggle_room_x = 0.5 * torch.abs(size - bbox_w) + beyond_border_shift * torch.minimum(size, bbox_w)
    wiggle_room_y = 0.5 * torch.abs(size - bbox_h) + beyond_border_shift * torch.minimum(size, bbox_h)
    tx = wiggle_room_x * rx
    ty = wiggle_room_y * ry
    return torch.stack(
        [cx - size * 0.5 + tx, cy - size * 0.5 + ty, cx + size * 0.5 + tx, cy + size * 0.5 + ty], dim=-1
    )


def _point_transform_from_roi(view_roi: torch.Tensor, new_size: int) -> Affine2d:
    B = tuple(view_roi.shape[:-1])
    return Affine2d.range_remap_2d(
        inmin=view_roi[..., :2],
        inmax=view_roi[..., 2:],
        outmin=torch.zeros(B + (2,), device=view_roi.device),
        outmax=torch.full(B + (2,), float(new_size), device=view_roi.device),
    )


@functools.lru_cache(maxsize=None)
def constant_remap(inmin, inmax, outmin, outmax, device: torch.device) -> Affine2d:
    """A constant `Affine2d.range_remap_2d` (corners as tuples), computed on
    the host and copied to `device` once: the step copies no constant from
    the host."""
    return Affine2d(Affine2d.range_remap_2d(inmin, inmax, outmin, outmax).tensor().to(device))


def _center_rotation_tr(angles: torch.Tensor, new_size: int) -> Affine2d:
    dev, n = angles.device, float(new_size)
    tr_norm = constant_remap((0.0, 0.0), (n, n), (-1.0, -1.0), (1.0, 1.0), dev)
    tr_rot = Affine2d.trs(angles=angles)
    tr_denorm = constant_remap((-1.0, -1.0), (1.0, 1.0), (0.0, 0.0), (n, n), dev)
    return tr_denorm @ tr_rot @ tr_norm


def focus_roi_components(roi, params: RoiFocusRandomizationParameters, new_size: int, round_roi: bool = True):
    """(view_roi, transform): the expanded, rounded square view ROI and the
    full source->crop Affine2d (centre rotation @ axis-aligned remap)."""
    view_roi = compute_view_roi(roi, params.scales, params.translations, MAX_BEYOND_BORDER_SHIFT)
    if round_roi:
        view_roi = torch.round(view_roi)
    tr = _point_transform_from_roi(view_roi, new_size)
    return view_roi, _center_rotation_tr(params.angles, new_size) @ tr


def focus_roi_transform(roi, params: RoiFocusRandomizationParameters, new_size: int, round_roi: bool = True) -> Affine2d:
    """Per-sample source->crop transform (ROI expansion + in-plane rotation)."""
    return focus_roi_components(roi, params, new_size, round_roi)[1]


def focus_roi_batch(batch: Batch, tr: Affine2d, new_size: int, oversample: int = 2,
                    insert_backtransform: bool = False) -> Batch:
    """The crop transform applied to the image and every label of a Batch
    of tensors: the image warped (`warp_affine`), the labels moved by
    `apply_affine2d`; with `insert_backtransform` also the inverse
    transform and the source's (W, H), for backtransforming predictions."""
    W, H = batch.meta.image_wh
    out = batch.copy()
    for k, v in batch.items():
        c = batch.get_category(k)
        if c == FieldCategory.image:
            out[k] = warp_affine(torch.as_tensor(v), tr, new_size, oversample)
        else:
            out[k] = apply_affine2d(tr, k, torch.as_tensor(v), c)
    if insert_backtransform:
        out["image_backtransform"] = tr.inv().tensor()
        out["image_original_size"] = torch.tensor((W, H), dtype=torch.int32)
    out.meta._imagesize = new_size
    return out


def sample_flip_rot90(generator: Optional[torch.Generator], batchshape, p_rot: float = 0.01):
    """(do_flip bool, rot_dir in {-1, 0, +1} float): flip with p=0.5, +-90 deg
    with p=p_rot/2 each."""
    batchshape = tuple(batchshape)
    do_flip = torch.rand(batchshape, generator=generator) < 0.5
    u = torch.rand(batchshape, generator=generator)
    rot_dir = torch.where(u < p_rot / 2.0, -1.0, torch.where(u < 1.0 - p_rot / 2.0, 0.0, 1.0))
    return do_flip, rot_dir


def flip_rot90_transform(do_flip: torch.Tensor, rot_dir: torch.Tensor, new_size: int) -> Affine2d:
    """Affine2d of the `sample_flip_rot90` choices (flip applied first)."""
    batchshape = tuple(do_flip.shape)
    dev = do_flip.device
    w = h = float(new_size)
    tr_rot = (
        constant_remap((-1.0, -1.0), (1.0, 1.0), (0.0, 0.0), (w, h), dev).broadcast_to(batchshape)
        @ Affine2d.trs(angles=rot_dir * (math.pi * 0.5))
        @ constant_remap((0.0, 0.0), (w, h), (-1.0, -1.0), (1.0, 1.0), dev).broadcast_to(batchshape)
    )
    identity = Affine2d.identity(dev).broadcast_to(batchshape)
    tr = Affine2d(torch.where((rot_dir != 0.0)[..., None, None], tr_rot.tensor(), identity.tensor()))
    tr_flip = constant_remap((0.0, 0.0), (w, h), (w, 0.0), (0.0, h), dev).broadcast_to(batchshape)
    flip_or_id = Affine2d(torch.where(do_flip[..., None, None], tr_flip.tensor(), identity.tensor()))
    return tr @ flip_or_id


def random_flip_rot90_transform(generator: Optional[torch.Generator], batchshape, new_size: int,
                                p_rot: float = 0.01) -> Affine2d:
    """Batched horizontal flip (p=0.5) and +-90 degree rotation (p=p_rot):
    `flip_rot90_transform` of the `sample_flip_rot90` draws, an Affine2d to
    compose with the crop transform."""
    return flip_rot90_transform(*sample_flip_rot90(generator, batchshape, p_rot), new_size)
