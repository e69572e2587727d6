"""Negative log-likelihood losses with predicted uncertainty.

Counterpart of the JAX package's `losses/nll.py`: the full-MVN coordinate NLL
with a Cholesky scale mixed with a 0.1% uniform density, and the
tangent-space rotation distribution. `BoxNLLLoss`, `Points3dNLLLoss`,
`ShapeParamsNLLLoss` and `CoordPoseNLLLoss` wait (ROADMAP.md).
"""

import math

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import not_ported
from neuralnet_tracker_traincode_torch.ops import quaternion as Q

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


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
        stacked = torch.stack([log_prob, log_uniform], dim=-1) + log_prob.new_tensor(self.log_weights)
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


class _NotPorted:
    def __init__(self, *args, **kwargs):
        raise not_ported(type(self).__name__)


class CoordPoseNLLLoss(_NotPorted):
    pass


class BoxNLLLoss(_NotPorted):
    pass


class Points3dNLLLoss(_NotPorted):
    pass


class ShapeParamsNLLLoss(_NotPorted):
    pass
