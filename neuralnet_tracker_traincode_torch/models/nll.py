"""Scale (uncertainty) parameterisations for the NLL losses.

Counterpart of the JAX package's `models/nll.py`: Neck, the diagonal scale
head and parameter and the lower-triangular scale head, positivity through
smoothclip0 (+1e-6). A network holds them under names that start with
`uncertainty` or `scales` (`models/weights.py` maps them to flax's paths);
the optimizer finds them by type (`SCALE_MODULES`).

The necks are f32 linears even when the model runs under bf16 autocast: the
JAX package leaves their Dense at the promoted f32 dtype.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuralnet_tracker_traincode_torch.ops.mathfn import inv_smoothclip0, smoothclip0

make_positive = smoothclip0
inv_make_positive = inv_smoothclip0


class Neck(nn.Module):
    """Linear producing per-feature values plus one global positive multiplier."""

    def __init__(self, in_features: int, num_out_features: int):
        super().__init__()
        self.lin = nn.Linear(in_features, num_out_features + 1)

    def linear(self, x: torch.Tensor) -> torch.Tensor:
        """The linear's f32 output: the multiplier's value first, then the rest."""
        with torch.autocast(x.device.type, enabled=False):
            return F.linear(x.float(), self.lin.weight, self.lin.bias)

    def forward(self, x: torch.Tensor):
        y = self.linear(x)
        return y[..., 1:], make_positive(y[..., :1])


class FeaturesAsDiagonalScale(nn.Module):
    """Features -> positive per-feature scales: smoothclip0 of the neck's
    values times its global multiplier, + eps."""

    def __init__(self, in_features: int, num_out_features: int, eps: float = 1.0e-6):
        super().__init__()
        self.neck = Neck(in_features, num_out_features)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, multiplier = self.neck(x)
        return make_positive(x) * multiplier + self.eps


class DiagonalScaleParameter(nn.Module):
    """Trainable input-independent positive scale, starting at 1."""

    def __init__(self, num_out_features: int, eps: float = 1.0e-6):
        super().__init__()
        self.hidden_scale = nn.Parameter(torch.zeros(num_out_features + 1))
        self.eps = eps

    def forward(self):
        return diagonal_scale(self.hidden_scale, self.eps)


def diagonal_scale(h: torch.Tensor, eps: float) -> torch.Tensor:
    """`DiagonalScaleParameter`'s scales from its hidden values (n + 1,):
    the first one's positive multiplier times each other's, + eps."""
    return make_positive(h[:1]) * make_positive(h[1:]) + eps


def fill_triangular_matrix(dim: int, z: torch.Tensor) -> torch.Tensor:
    """Lower-triangular matrix: first `dim` values on the diagonal, then the
    off-diagonals row by row. Stack-based for dim 3 (the pose and coordinate
    scales), by index assignment otherwise."""
    if dim == 3:
        zero = torch.zeros_like(z[..., 0])
        row0 = torch.stack([z[..., 0], zero, zero], dim=-1)
        row1 = torch.stack([z[..., 3], z[..., 1], zero], dim=-1)
        row2 = torch.stack([z[..., 4], z[..., 5], z[..., 2]], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)
    irow, icol = (torch.from_numpy(a) for a in np.tril_indices(dim, -1))
    m = z.new_zeros(z.shape[:-1] + (dim, dim))
    m[..., irow, icol] = z[..., dim:]
    i = torch.arange(dim)
    m[..., i, i] = z[..., :dim]
    return m


class FeaturesAsTriangularScale(nn.Module):
    """Features -> lower-triangular scale (Cholesky factor) with positive diagonal."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.dim = dim
        n = (dim * (dim + 1)) // 2
        self.neck = Neck(in_features, n)
        min_diag = torch.zeros(n)
        min_diag[:dim] = 1.0e-6
        self.register_buffer("min_diag", min_diag)

    def forward(self, x):
        return triangular_scale(self.dim, self.neck.linear(x), self.min_diag)


def triangular_scale(dim: int, y: torch.Tensor, min_diag: torch.Tensor) -> torch.Tensor:
    """`FeaturesAsTriangularScale` from its neck's linear output y (..., 1 + n):
    the diagonal made positive, all times the positive multiplier, + min_diag."""
    x, multiplier = y[..., 1:], make_positive(y[..., :1])
    z = torch.cat([make_positive(x[..., :dim]), x[..., dim:]], dim=-1)
    z = multiplier * z + min_diag
    return fill_triangular_matrix(dim, z)


SCALE_MODULES = (Neck, DiagonalScaleParameter, FeaturesAsTriangularScale)  # FeaturesAsDiagonalScale: its Neck
