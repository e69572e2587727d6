"""Batch normalization transforms (counterpart of the JAX package's
`augmentation/normalization.py`): coordinates to [-1, 1], images to [0, 1],
whitening (subtract 0.5). Pixel-centre convention: point-like labels are
offset by +0.5 px before normalization. Values are tensors (numpy arrays
are taken as tensors on the CPU)."""

import torch

from neuralnet_tracker_traincode_torch.augmentation.affine import (
    apply_affine2d,
    position_normalization,
    position_unnormalization,
)
from neuralnet_tracker_traincode_torch.data.batch import Batch
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory, imagelike_categories
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d


def whiten_image(image):
    return image - 0.5


def unwhiten_image(image):
    return image + 0.5


def _on(tr: Affine2d, v: torch.Tensor) -> Affine2d:
    return Affine2d(tr.tensor().to(v.device))


def normalize_batch(sample: Batch) -> Batch:
    """Coordinates -> [-1, 1]; image colour -> [0, 1]; bools -> smoothed labels."""
    W, H = sample.meta.image_wh
    tr = position_normalization(W, H)
    sample = sample.copy()
    for k, v in sample.items():
        v = torch.as_tensor(v)
        category = sample.get_category(k)
        if category == FieldCategory.image:
            sample[k] = v.float() * (1.0 / 256)
        elif category == FieldCategory.semseg:
            sample[k] = v.to(torch.int32)
        elif v.dtype == torch.bool:
            sample[k] = torch.where(v, 0.9, 0.1).float()  # label smoothing
        else:
            sample[k] = apply_affine2d(_on(tr, v), k, v, category)
    return sample


def unnormalize_batch(sample: Batch) -> Batch:
    W, H = sample.meta.image_wh
    tr = position_unnormalization(W, H)
    sample = sample.copy()
    for k, v in sample.items():
        v = torch.as_tensor(v)
        category = sample.get_category(k)
        if category == FieldCategory.image:
            sample[k] = torch.clamp(v * 256.0, 0.0, 255.0).to(torch.uint8)
        else:
            sample[k] = apply_affine2d(_on(tr, v), k, v, category)
    return sample


def offset_points_by_half_pixel(sample: Batch) -> Batch:
    """Pixel-centre convention: shift point-like labels by +(0.5, 0.5)."""
    sample = sample.copy()
    for k, v in sample.items():
        c = sample.get_category(k)
        if c in (FieldCategory.points, FieldCategory.xys):
            v = torch.as_tensor(v)
            tr = Affine2d.trs(translations=torch.tensor([0.5, 0.5], device=v.device))
            sample[k] = apply_affine2d(tr, k, v, c)
    return sample


def whiten_batch(batch: Batch) -> Batch:
    batch = batch.copy()
    for k, v in batch.items():
        if batch.get_category(k) in imagelike_categories:
            batch[k] = whiten_image(v)
    return batch
