"""Per-sample loss terms for pose estimation.

Counterpart of the JAX package's `losses/losses.py`. Every loss is a callable
(pred_dict, sample_dict) -> per-sample loss of shape (B,). The shape losses
(`ShapeParameterLoss`, `ShapePlausibilityLoss`), `QuatPoseLoss("smooth_geodesic")`,
the 6D rotation losses and the face-detector loss wait (ROADMAP.md).
"""

from typing import Literal

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import not_ported
from neuralnet_tracker_traincode_torch.facemodel import keypoints68 as kpts68
from neuralnet_tracker_traincode_torch.ops import quaternion as Q

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


class QuatPoseLoss:
    def __init__(self, loss: Literal["approx_distance"] = "approx_distance", prefix=""):
        if loss != "approx_distance":
            raise not_ported(f"QuatPoseLoss({loss!r})")
        self._prefix = prefix

    def __call__(self, pred, sample):
        return Q.distance(pred[self._prefix + "rot"].value, sample["pose"])


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
        return torch.mean(pointwise * p.new_tensor(self.pointweights)[None, :], dim=-1)


class BoxLoss:
    def __init__(self, loss: SimpleLossSwitch, dataname="roi"):
        self.dataname = dataname
        self._kind = loss

    def __call__(self, pred, sample):
        return torch.mean(elementwise_loss(self._kind, pred[self.dataname], sample[self.dataname]), dim=-1)


class ShapeParameterLoss:
    def __init__(self, *args, **kwargs):
        raise not_ported("ShapeParameterLoss")


class ShapePlausibilityLoss:
    def __init__(self, *args, **kwargs):
        raise not_ported("ShapePlausibilityLoss")
