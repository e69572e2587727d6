"""Negative log-likelihood losses with predicted uncertainty.

Counterpart of the JAX package's `losses/nll.py`: gaussian and laplace
diagonal NLLs, the full-MVN coordinate NLL with a Cholesky scale mixed with a
0.1% uniform density, and the tangent-space rotation distribution (which
takes a quaternion or a 3x3 matrix rotation through `as_quat`).
"""

import math
from typing import Literal

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import device_constant
from neuralnet_tracker_traincode_torch.facemodel import keypoints68 as kpts68
from neuralnet_tracker_traincode_torch.ops import quaternion as Q

SimpleDistributionSwitch = Literal["gaussian", "laplace"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_log_prob(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI


def laplace_log_prob(x, loc, scale):
    return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)


_LOG_PROB = {"gaussian": gaussian_log_prob, "laplace": laplace_log_prob}


def mvn_log_prob_scale_tril(x, loc, scale_tril):
    """Multivariate normal log density with Cholesky factor scale_tril.

    x, loc: (..., D); scale_tril: (..., D, D) lower triangular. The solve is a
    written-out forward substitution (D is 3 here).
    """
    d = x - loc
    D = x.shape[-1]
    z = []
    for i in range(D):
        acc = d[..., i]
        for j in range(i):
            acc = acc - scale_tril[..., i, j] * z[j]
        z.append(acc / scale_tril[..., i, i])
    z = torch.stack(z, dim=-1)
    log_det = torch.sum(torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(z * z, dim=-1) - log_det - D * _LOG_SQRT_2PI


class MixWithUniformProbability:
    """log( 0.999 p + 0.001 / V ) - robustifies NLLs against outliers."""

    def __init__(self, state_space_volume: float):
        self.log_uniform_prob = -math.log(state_space_volume)
        self.log_weights = np.log(np.asarray([0.999, 0.001], np.float32))

    def __call__(self, log_prob):
        log_uniform = torch.full_like(log_prob, self.log_uniform_prob)
        stacked = torch.stack([log_prob, log_uniform], dim=-1) + device_constant(self.log_weights, log_prob.device, log_prob.dtype)
        return torch.logsumexp(stacked, dim=-1)


class CorrelatedCoordPoseNLLLoss:
    def __init__(self):
        # State space volume = [-1,1] x [-1,1] x [0,1]
        self.uniform_mixing = MixWithUniformProbability(4.0)

    def __call__(self, preds, sample):
        log_prob = mvn_log_prob_scale_tril(sample["coord"], preds["coord"], preds["coord_scales"])
        return -self.uniform_mixing(log_prob)


class TangentSpaceRotationDistribution:
    """Zero-mean MVN over the tangent space at the predicted rotation
    (not normalised over SO(3))."""

    def __init__(self, quat, scale_tril):
        self.quat = quat
        self.scale_tril = scale_tril

    def log_prob(self, otherquat):
        rotvec = Q.rotation_delta(self.quat, otherquat)
        return mvn_log_prob_scale_tril(rotvec, torch.zeros_like(rotvec), self.scale_tril)


class QuatPoseNLLLoss:
    def __init__(self):
        r = math.pi
        v = r * r * r * math.pi * 4.0 / 3.0  # volume of the rotation-vector ball
        self.uniform_mixing = MixWithUniformProbability(v)

    def __call__(self, preds, sample):
        log_prob = TangentSpaceRotationDistribution(
            preds["rot"].as_quat(), preds["pose_scales_tril"]
        ).log_prob(sample["pose"])
        return -self.uniform_mixing(log_prob)


class CoordPoseNLLLoss:
    def __init__(self, xy_weight: float, head_size_weight: float, distribution: SimpleDistributionSwitch = "gaussian"):
        self.weights = np.asarray([xy_weight / 2.0, xy_weight / 2.0, head_size_weight], np.float32)
        self._log_prob = _LOG_PROB[distribution]

    def __call__(self, preds, sample):
        lp = self._log_prob(sample["coord"], preds["coord"], preds["coord_scales"])
        return torch.mean(-lp * device_constant(self.weights, lp.device, lp.dtype)[None, :], dim=-1)


class BoxNLLLoss:
    def __init__(self, dataname="roi", distribution: SimpleDistributionSwitch = "gaussian"):
        self.dataname = dataname
        self._log_prob = _LOG_PROB[distribution]

    def __call__(self, pred, sample):
        lp = self._log_prob(sample[self.dataname], pred[self.dataname], pred[self.dataname + "_scales"])
        return torch.mean(-lp, dim=-1)


class Points3dNLLLoss:
    def __init__(self, chin_weight, eye_weight, pointdimension: int = 3,
                 distribution: SimpleDistributionSwitch = "gaussian"):
        self._log_prob = _LOG_PROB[distribution]
        pointweights = np.ones((68,), dtype=np.float32)
        pointweights[kpts68.chin_left[:-1]] = chin_weight
        pointweights[kpts68.chin_right[1:]] = chin_weight
        pointweights[kpts68.eye_not_corners] = eye_weight
        self.pointweights = pointweights
        self.pointdimension = pointdimension

    def __call__(self, preds, sample):
        d = self.pointdimension  # the scales are sliced with the points
        lp = self._log_prob(sample["pt3d_68"][:, :, :d], preds["pt3d_68"][:, :, :d], preds["pt3d_68_scales"][:, :, :d])
        loss = -device_constant(self.pointweights, lp.device, lp.dtype)[None, :, None] * lp
        return torch.mean(loss, dim=(-2, -1))


class ShapeParamsNLLLoss:
    def __init__(self, distribution: SimpleDistributionSwitch = "gaussian"):
        self._log_prob = _LOG_PROB[distribution]

    def __call__(self, preds, sample):
        lp = self._log_prob(sample["shapeparam"], preds["shapeparam"], preds["shapeparam_scales"])
        return torch.mean(-lp, dim=-1)
