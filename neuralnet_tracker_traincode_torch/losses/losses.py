"""Per-sample loss terms for pose estimation.

Counterpart of the JAX package's `losses/losses.py`. Every loss is a callable
(pred_dict, sample_dict) -> per-sample loss of shape (B,); the localizer's
take its (B, 5) output in place of the dict.
"""

import math
from typing import Literal

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import device_constant
from neuralnet_tracker_traincode_torch.facemodel import keypoints68 as kpts68
from neuralnet_tracker_traincode_torch.models.components import SHAPEPARAMS_GMM_NPZ, GaussianMixture
from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops import rot6d

SimpleLossSwitch = Literal["l2", "l1", "smooth_l1"]


def _smooth_l1(pred, target, beta: float):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def elementwise_loss(kind: SimpleLossSwitch, pred, target):
    if kind == "l2":
        return torch.square(pred - target)
    if kind == "l1":
        return torch.abs(pred - target)
    if kind == "smooth_l1":
        return _smooth_l1(pred, target, beta=0.01)
    raise ValueError(kind)


def smooth_geodesic_distance(pred_quat, target_quat):
    smooth_zone = 1.0 * math.pi / 180.0  # one degree
    normed_delta = Q.geodesicdistance(pred_quat, target_quat)
    return _smooth_l1(normed_delta, torch.zeros_like(normed_delta), beta=smooth_zone) / math.pi


class QuatPoseLoss:
    def __init__(self, loss: Literal["approx_distance", "smooth_geodesic"] = "approx_distance", prefix=""):
        self._prefix = prefix
        self._fn = {"approx_distance": Q.distance, "smooth_geodesic": smooth_geodesic_distance}[loss]

    def __call__(self, pred, sample):
        return self._fn(pred[self._prefix + "rot"].value, sample["pose"])


class Rot6dReprLoss:
    def __call__(self, pred, sample):
        return rot6d.rotation_distance_loss(pred["rot"].value, Q.tomatrix(sample["pose"]))


class Rot6dNormalizationSoftConstraint:
    def __call__(self, pred, sample):
        return rot6d.orthonormality_loss(pred["unnormalized_6drepr"])


class PoseSizeLoss:
    def __init__(self, loss: SimpleLossSwitch, prefix=""):
        self._prefix = prefix
        self._kind = loss

    def __call__(self, pred, sample):
        return elementwise_loss(self._kind, pred[self._prefix + "coord"][..., 2], sample["coord"][..., 2])


class PoseXYLoss:
    def __init__(self, loss: SimpleLossSwitch, prefix=""):
        self._prefix = prefix
        self._kind = loss

    def __call__(self, pred, sample):
        return torch.mean(
            elementwise_loss(self._kind, pred[self._prefix + "coord"][..., :2], sample["coord"][..., :2]),
            dim=-1,
        )


class QuaternionNormalizationSoftConstraint:
    def __init__(self, prefix=""):
        self._prefix = prefix

    def __call__(self, pred, sample):
        norm = torch.linalg.norm(pred[self._prefix + "unnormalized_quat"], dim=-1)
        return torch.square(1.0 - norm)


def _point_weights(chin_weight, eye_weights) -> np.ndarray:
    pointweights = np.ones((68,), dtype=np.float32)
    pointweights[kpts68.chin_left[:-1]] = chin_weight
    pointweights[kpts68.chin_right[1:]] = chin_weight
    pointweights[kpts68.eye_not_corners] = eye_weights
    return pointweights


class Points3dLoss:
    def __init__(self, loss: SimpleLossSwitch, pointdimension: int = 3, chin_weight=1.0, eye_weights=0.0, prefix=""):
        assert pointdimension in (2, 3)
        self._prefix = prefix
        self._kind = loss
        self.pointdimension = pointdimension
        self.pointweights = _point_weights(chin_weight, eye_weights)

    def __call__(self, pred, sample):
        p = pred[self._prefix + "pt3d_68"][..., : self.pointdimension]
        t = sample["pt3d_68"][..., : self.pointdimension]
        pointwise = torch.sum(elementwise_loss(self._kind, p, t), dim=-1)
        return torch.mean(pointwise * device_constant(self.pointweights, p.device, p.dtype)[None, :], dim=-1)


class BoxLoss:
    def __init__(self, loss: SimpleLossSwitch, dataname="roi"):
        self.dataname = dataname
        self._kind = loss

    def __call__(self, pred, sample):
        return torch.mean(elementwise_loss(self._kind, pred[self.dataname], sample[self.dataname]), dim=-1)


class ShapeParameterLoss:
    def __call__(self, pred, sample):
        return torch.mean(torch.square(pred["shapeparam"] - sample["shapeparam"]), dim=-1)


class ShapePlausibilityLoss:
    """-log p(shape) under a diagonal GMM prior, fudged by 0.001 / K."""

    def __init__(self, gmm: GaussianMixture):
        self.gmm = gmm
        self.fudge_factor = 0.001 / gmm.n_components

    @staticmethod
    def from_npz(path: str = SHAPEPARAMS_GMM_NPZ) -> "ShapePlausibilityLoss":
        return ShapePlausibilityLoss(GaussianMixture.from_npz(path))

    @staticmethod
    def from_hdf5(path: str) -> "ShapePlausibilityLoss":
        return ShapePlausibilityLoss(GaussianMixture.from_hdf5(path))

    def __call__(self, pred, sample):
        return -self.gmm(pred["shapeparam"]) * self.fudge_factor


def _bce_with_logits(logits, target):
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


class HasFaceLoss:
    """The face detector head's binary cross-entropy on its logits."""

    def __call__(self, pred, sample):
        return _bce_with_logits(pred["hasface_logits"], sample["hasface"])


class LocalizerProbLoss:
    """Binary cross-entropy of the localizer's face logit (pred[:, 0])."""

    def __call__(self, pred, sample):
        return _bce_with_logits(pred[:, 0], sample["hasface"])


class LocalizerBoxLoss:
    """Smooth-L1 (beta 0.1) of the localizer's box, weighted by `hasface`."""

    def __call__(self, pred, sample):
        err = _smooth_l1(pred[:, 1:], sample["roi"], beta=0.1)
        return torch.mean(sample["hasface"][:, None] * err, dim=-1)
