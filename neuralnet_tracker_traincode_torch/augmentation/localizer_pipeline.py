"""The localizer's training augmentation (counterpart of the JAX package's
`augmentation/localizer_pipeline.py`): randomized context crops around the
face ROI (wider than the pose crops), aspect-corrected to the 224x288 input,
horizontal flips, the intensity stages, and ROI labels in [-1, 1].

    view ROI (compute_view_roi, extension 2.2 +- jitter, translation) ->
    aspect correction -> ROI-to-crop affine (with the flip folded in) ->
    warp_affine (plain gathers) -> labels through the same affine, then to
    [-1, 1] -> / 256 -> intensity stage 1 (K2 for equalize) and noise (K3,
    with the whitening's -0.5 fused) when image augmentation is on, else -0.5

Every random value is drawn from a `torch.Generator` by
`sample_localizer_parameters`, or injected, so that a test can give both
packages the same draws. The JAX package splits its key into scale,
translation, flip and intensity parts; the port's draws are independent of
those streams.
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from neuralnet_tracker_traincode_torch.augmentation.affine import transform_roi
from neuralnet_tracker_traincode_torch.augmentation.geometric import compute_view_roi
from neuralnet_tracker_traincode_torch.augmentation.intensity import (
    NoiseParameters,
    Stage1Parameters,
    intensity_augmentation,
    sample_noise_parameters,
    sample_stage1_parameters,
)
from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d


class LocalizerAugConfig(NamedTuple):
    out_h: int = 224
    out_w: int = 288
    extension_factor: float = 2.2  # wide context around the face
    scale_jitter: float = 0.4
    enable_image_aug: bool = True
    deterministic: bool = False
    oversample: int = 1


class LocalizerAugParameters(NamedTuple):
    """Every random draw of one batch; None where `cfg` turns it off."""

    scales: Optional[torch.Tensor]  # (B,) view ROI enlargement
    translations: Optional[torch.Tensor]  # (B, 2) in [-1, 1]
    do_flip: Optional[torch.Tensor]  # (B,) bool
    stage1: Optional[Stage1Parameters]
    noise: Optional[NoiseParameters]


def sample_localizer_parameters(
    generator: Optional[torch.Generator], B: int, cfg: LocalizerAugConfig
) -> LocalizerAugParameters:
    """Draw one batch's augmentation on the host from `generator`, with the
    JAX package's distributions."""
    if cfg.deterministic:
        return LocalizerAugParameters(None, None, None, None, None)
    g = dict(generator=generator)
    scales = torch.clamp(torch.randn(B, **g) * cfg.scale_jitter, -1.0, 2.0) + cfg.extension_factor
    translations = torch.clamp(torch.randn((B, 2), **g) * 0.5, -1.0, 1.0)
    do_flip = torch.rand(B, **g) < 0.5
    stage1 = noise = None
    if cfg.enable_image_aug:
        stage1 = sample_stage1_parameters(generator, B)
        noise = sample_noise_parameters(generator, B)
    return LocalizerAugParameters(scales, translations, do_flip, stage1, noise)


def _aspect_corrected_roi(view_roi: torch.Tensor, aspect: float) -> torch.Tensor:
    """Expand the square view ROI to the target aspect (w/h), centred."""
    x0, y0, x1, y1 = view_roi.unbind(-1)
    w = x1 - x0
    h = y1 - y0
    target_w = torch.maximum(w, h * aspect)
    target_h = target_w / aspect
    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    return torch.stack(
        [cx - 0.5 * target_w, cy - 0.5 * target_h, cx + 0.5 * target_w, cy + 0.5 * target_h], dim=-1
    )


def augment_batch_for_localizer(
    images,  # (B, H, W, C) uint8, zero-padded
    labels: Dict[str, Any],  # roi (B, 4), hasface (B,) float
    cfg: LocalizerAugConfig,
    params: Optional[LocalizerAugParameters] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Crop, flip and intensity-augment on `device`: (whitened f32 crops
    (B, out_h, out_w, C), labels with `roi` in [-1, 1] crop units). `params`
    holds the draws; without it they are drawn from `generator`."""
    dev = resolve_device(device)
    images = torch.as_tensor(images).to(dev)
    labels = {k: torch.as_tensor(v).to(dev) for k, v in labels.items()}
    B = images.shape[0]
    W, H = float(cfg.out_w), float(cfg.out_h)
    if params is None:
        params = sample_localizer_parameters(generator, B, cfg)
    roi = labels["roi"].float()
    if cfg.deterministic:
        scales = torch.full((B,), cfg.extension_factor, device=dev)
        translations = torch.zeros((B, 2), device=dev)
        do_flip = torch.zeros((B,), dtype=torch.bool, device=dev)
    else:
        scales, translations, do_flip = (params.scales.to(dev), params.translations.to(dev), params.do_flip.to(dev))

    view_roi = compute_view_roi(roi, scales, translations, beyond_border_shift=0.3)
    view_roi = _aspect_corrected_roi(view_roi, cfg.out_w / cfg.out_h)
    tr = Affine2d.range_remap_2d(
        view_roi[..., :2], view_roi[..., 2:], torch.zeros((B, 2), device=dev),
        torch.tensor([W, H], device=dev).expand(B, 2),
    )
    flip = Affine2d.range_remap_2d(
        torch.tensor([0.0, 0.0], device=dev), [W, H], [W, 0.0], [0.0, H]
    ).broadcast_to((B,))
    identity = Affine2d.identity(dev).broadcast_to((B,))
    tr = Affine2d(torch.where(do_flip[:, None, None], flip.tensor(), identity.tensor())) @ tr

    warped = warp_affine(images, tr, (cfg.out_h, cfg.out_w), cfg.oversample)

    norm = Affine2d.range_remap_2d(torch.tensor([0.0, 0.0], device=dev), [W, H], [-1.0, -1.0], [1.0, 1.0])
    out_labels = dict(labels)
    out_labels["roi"] = transform_roi(norm.broadcast_to((B,)), transform_roi(tr, roi))

    x = warped * (1.0 / 256.0)
    if cfg.enable_image_aug and not cfg.deterministic:
        # K3 adds the whitening's -0.5 after its clip: x + (-0.5) == x - 0.5 in f32
        return intensity_augmentation(x, params.stage1.to(dev), params.noise.to(dev), offset=-0.5), out_labels
    return x - 0.5, out_labels
