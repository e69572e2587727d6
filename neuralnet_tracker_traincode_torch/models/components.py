"""Model components: 2.5D rigid transform, deformable keypoints, Pascal kernel.

Counterpart of the JAX package's `models/components.py`. `GaussianMixture`
(the shape prior of `ShapePlausibilityLoss`) waits (ROADMAP.md).
"""

import numpy as np
import torch
from torch import nn

from neuralnet_tracker_traincode_torch.device import not_ported
from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel
from neuralnet_tracker_traincode_torch.ops.mathfn import matmul_hp
from neuralnet_tracker_traincode_torch.ops.rotrepr import RotationRepr


def rigid_transformation_25d(r: RotationRepr, t: torch.Tensor, s: torch.Tensor, points: torch.Tensor):
    """2.5D rigid transform: rotate, scale (all axes), translate in xy only.

    r: rotation, batch shape (...,); t: (..., 2); s: (..., 1); points (..., N, 3).
    """
    tmp = r.rotate_points(points)
    tmp = tmp * s[..., None, :]
    xy = tmp[..., :2] + t[..., None, :]
    return torch.cat([xy, tmp[..., 2:]], dim=-1)


class DeformableHeadKeypoints(nn.Module):
    """Linear blend-shape keypoint model over the BFM 68-keypoint subset.

    Buffers `keypts` (68, 3) and `keyeigvecs` (50, 68, 3), as the reference
    state dict names them.
    """

    def __init__(self, num_shape=40, num_expr=10):
        super().__init__()
        self.num_eigvecs = num_shape + num_expr
        full = BFMModel(num_shape, num_expr)
        self.register_buffer("keypts", torch.from_numpy(full.keypts.copy()))
        self.register_buffer("keyeigvecs", torch.from_numpy(full.scaled_bases.copy()))

    def forward(self, shapeparams: torch.Tensor) -> torch.Tensor:
        """(..., 50) -> (..., 68, 3), in f32 whatever the autocast policy."""
        K = self.keyeigvecs.shape[0]
        local = matmul_hp(shapeparams, self.keyeigvecs.reshape(K, -1))
        return local.reshape(shapeparams.shape[:-1] + (68, 3)) + self.keypts


def pascal_kernel_2d(kernel_size: int) -> np.ndarray:
    """Normalized 2D binomial (Pascal) kernel for anti-aliased downsampling."""
    row = np.asarray([1.0])
    for _ in range(kernel_size - 1):
        row = np.convolve(row, [1.0, 1.0])
    k = np.outer(row, row)
    return (k / k.sum()).astype(np.float32)


class GaussianMixture:
    def __init__(self, *args, **kwargs):
        raise not_ported("GaussianMixture")
