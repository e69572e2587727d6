"""The training augmentation pipeline (counterpart of the JAX package's
`augmentation/pipeline.py`):

    half-pixel label offset -> ROI focus crop with folded flip/rot90 (K1) ->
    matched label affines -> normalize -> intensity stage 1 (K2 for
    equalize) -> gaussian noise (K3) -> whiten (fused into K3 when the
    image augmentation runs)

`sample_augmentation_parameters` draws every random value from a
`torch.Generator`; `augment_batch_for_training` applies explicit draws, so a
test can hand both packages the same ones. `crop_scale_bounds` repeats the
crop's ROI arithmetic on the host, for K1's launch plan. `crop_for_eval` is
the deterministic eval crop (the gather warp of `warp.py`, 2x oversampled).
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from neuralnet_tracker_traincode_torch.augmentation.affine import apply_affine2d
from neuralnet_tracker_traincode_torch.augmentation.geometric import (
    RoiFocusRandomizationParameters,
    constant_remap,
    flip_rot90_transform,
    focus_roi_components,
    focus_roi_transform,
    make_roi_randomization_parameters,
    no_roi_randomization,
    sample_flip_rot90,
    share_params_within_sequences,
)
from neuralnet_tracker_traincode_torch.augmentation.intensity import (
    NoiseParameters,
    Stage1Parameters,
    intensity_augmentation,
    sample_noise_parameters,
    sample_stage1_parameters,
)
from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
from neuralnet_tracker_traincode_torch.augmentation.warp_fast import warp_roi_rotate
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
from neuralnet_tracker_traincode_torch.device import DeviceLike, device_constant, resolve_device
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d


class TrainAugmentationConfig(NamedTuple):
    inputsize: int = 129
    rotation_aug_angle: float = 30.0
    extension_factor: float = 1.1
    enable_image_aug: bool = True
    p_flip_rot90: float = 0.01
    enable_flip: bool = True
    roi_key: str = "roi"
    deterministic: bool = False  # validation: fixed crop, no flip/intensity


class AugmentationParameters(NamedTuple):
    """Every random draw of one batch's augmentation; None where `cfg` turns
    the stage off."""

    roi: Optional[RoiFocusRandomizationParameters]
    do_flip: Optional[torch.Tensor]  # (B,) bool
    rot_dir: Optional[torch.Tensor]  # (B,) in {-1, 0, +1}
    stage1: Optional[Stage1Parameters]
    noise: Optional[NoiseParameters]


def sample_augmentation_parameters(
    generator: Optional[torch.Generator], B: int, cfg: TrainAugmentationConfig
) -> AugmentationParameters:
    """Draw one batch's augmentation on the host from `generator`."""
    roi = do_flip = rot_dir = stage1 = noise = None
    if not cfg.deterministic:
        roi = make_roi_randomization_parameters(generator, (B,), cfg.rotation_aug_angle, cfg.extension_factor)
        if cfg.enable_flip:
            do_flip, rot_dir = sample_flip_rot90(generator, (B,), cfg.p_flip_rot90)
        if cfg.enable_image_aug:
            stage1 = sample_stage1_parameters(generator, B)
            noise = sample_noise_parameters(generator, B)
    return AugmentationParameters(roi, do_flip, rot_dir, stage1, noise)


def draws_for_rows(
    params: AugmentationParameters, rows: slice, param_index: Optional[torch.Tensor] = None
) -> AugmentationParameters:
    """The draws of rows `rows` of a batch whose draws `params` were made
    whole (a data-parallel rank's share). The leaves do not share one batch
    axis: the ROI, flip and rot90 draws are (B, ...), stage 1's masks and
    values (6, B) with a shared `perm`, the noise (B,). `param_index` (the
    rows' own, in the whole batch's row numbers) resolves the sequences as
    `augment_batch_for_training` does, so that the rows' draws are applied
    without it: a sequence may begin in another rank's rows."""

    def take(t):
        return None if t is None else (t[rows] if param_index is None else t[param_index.long()])

    return AugmentationParameters(
        roi=None if params.roi is None else RoiFocusRandomizationParameters(*map(take, params.roi)),
        do_flip=take(params.do_flip),
        rot_dir=take(params.rot_dir),
        stage1=None if params.stage1 is None else params.stage1.rows(rows),
        noise=None if params.noise is None else params.noise.rows(rows),
    )


_POINTISH = (FieldCategory.points, FieldCategory.xys)


def _offset_half_pixel(labels, categories, device):
    tr = Affine2d.trs(translations=device_constant([0.5, 0.5], device))
    out = dict(labels)
    for k, v in labels.items():
        if categories.get(k) in _POINTISH:
            out[k] = apply_affine2d(tr, k, v, categories[k])
    return out


def _transform_labels(labels, categories, tr: Affine2d):
    out = dict(labels)
    for k, v in labels.items():
        c = categories.get(k, FieldCategory.general)
        if c not in (FieldCategory.image, FieldCategory.semseg):
            out[k] = apply_affine2d(tr, k, v, c)
    return out


def _normalize_labels(labels, categories, size: int, device):
    # affine.py:position_normalization(size, size), kept on the device
    tr = constant_remap((0.0, 0.0), (float(size), float(size)), (-1.0, -1.0), (1.0, 1.0), device)
    out = dict(labels)
    for k, v in labels.items():
        c = categories.get(k, FieldCategory.general)
        if c in (FieldCategory.image, FieldCategory.semseg):
            continue
        if v.dtype == torch.bool:
            out[k] = torch.where(v, 0.9, 0.1).float()  # label smoothing
        else:
            out[k] = apply_affine2d(tr, k, v, c)
    return out


def crop_scale_bounds(
    roi: torch.Tensor,
    params: AugmentationParameters,
    categories: Dict[str, FieldCategory],
    cfg: TrainAugmentationConfig,
    param_index: Optional[torch.Tensor] = None,
) -> Tuple[float, float]:
    """(largest |sy|, largest |sx|) of K1's source pixels per crop pixel for
    a batch, from the host copies of its ROI labels (B, 4) and of its draws:
    `augment_batch_for_training`'s view ROI arithmetic, on the CPU. A fold
    of flip or rot90 only reorders a view ROI's corners, so it is left out."""
    cpu = torch.device("cpu")
    roi = _offset_half_pixel({cfg.roi_key: roi.to(cpu)}, categories, cpu)[cfg.roi_key]
    if cfg.deterministic:
        roi_params = no_roi_randomization((roi.shape[0],), cfg.extension_factor, cpu)
    else:
        roi_params = params.roi.to(cpu)
        if param_index is not None:
            roi_params = share_params_within_sequences(roi_params, param_index.to(cpu))
    view_roi, _ = focus_roi_components(roi, roi_params, cfg.inputsize)
    size = (view_roi[:, 2:] - view_roi[:, :2]).abs().amax(0) / float(cfg.inputsize)
    return float(size[1]), float(size[0])


def augment_batch_for_training(
    images,  # (B, H, W, C) uint8, zero-padded to a fixed size
    labels: Dict[str, Any],
    categories: Dict[str, FieldCategory],
    cfg: TrainAugmentationConfig,
    params: Optional[AugmentationParameters] = None,
    generator: Optional[torch.Generator] = None,
    param_index=None,
    device: DeviceLike = None,
    k1_plan=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Crop-warp + flip/rot90 + intensity + normalize + whiten on `device`.

    Returns (whitened f32 images (B, S, S, C), normalized labels).
    `labels[cfg.roi_key]` holds the face bbox in source pixels. `params`
    holds the draws; without it they are drawn from `generator`. `k1_plan`
    is K1's launch plan (`kernels/warp.py:rounded_plan` of
    `crop_scale_bounds`); without it K1 reads its scales back.
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images).to(dev)
    labels = {k: torch.as_tensor(v).to(dev) for k, v in labels.items()}
    B = images.shape[0]
    S = cfg.inputsize
    if params is None:
        params = sample_augmentation_parameters(generator, B, cfg)
    if param_index is not None:
        param_index = torch.as_tensor(param_index).to(dev)

    labels = _offset_half_pixel(labels, categories, dev)
    if cfg.deterministic:
        roi_params = no_roi_randomization((B,), cfg.extension_factor, dev)
    else:
        roi_params = params.roi.to(dev)
        if param_index is not None:
            roi_params = share_params_within_sequences(roi_params, param_index)
    view_roi, tr = focus_roi_components(labels[cfg.roi_key], roi_params, S)

    do_flip = rot_dir = None
    if cfg.enable_flip and not cfg.deterministic:
        do_flip, rot_dir = params.do_flip.to(dev), params.rot_dir.to(dev)
        if param_index is not None:
            do_flip, rot_dir = do_flip[param_index.long()], rot_dir[param_index.long()]
        tr = flip_rot90_transform(do_flip, rot_dir, S) @ tr

    warped = warp_roi_rotate(
        images,
        view_roi,
        roi_params.angles,
        S,
        cfg.rotation_aug_angle,
        do_flip=do_flip,
        rot_dir=rot_dir,
        skip_rotation=cfg.deterministic or not cfg.rotation_aug_angle,
        plan=k1_plan,
    )
    labels = _transform_labels(labels, categories, tr)
    labels = _normalize_labels(labels, categories, S, dev)

    x = warped * (1.0 / 256.0)
    if cfg.enable_image_aug and not cfg.deterministic:
        # K3 adds the whitening's -0.5 after its clip: x + (-0.5) == x - 0.5 in f32
        return intensity_augmentation(x, params.stage1.to(dev), params.noise.to(dev), offset=-0.5), labels
    return x - 0.5, labels


def crop_for_eval(
    images: torch.Tensor, roi: torch.Tensor, inputsize: int, expansion_factor: float = 1.2, oversample: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic eval crop on the images' device: (whitened f32 images
    (B, S, S, C), backtransform (B, 2, 3) from crop to source pixels). No ROI
    randomization, the expansion factor only."""
    B = images.shape[0]
    roi = torch.as_tensor(roi, dtype=torch.float32).to(images.device)
    tr = focus_roi_transform(roi, no_roi_randomization((B,), expansion_factor, images.device), inputsize)
    x = warp_affine(images, tr, inputsize, oversample) * (1.0 / 256.0) - 0.5
    return x, tr.inv().tensor()
