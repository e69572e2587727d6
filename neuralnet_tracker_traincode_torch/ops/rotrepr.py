"""Rotation representation of the quaternion heads.

Counterpart of the JAX package's `ops/rotrepr.py`. Only `QuatRepr` is ported;
`Mat33Repr` and the 6D rotation heads wait (ROADMAP.md).
"""

import dataclasses
from typing import Tuple

import torch

from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops.mathfn import smoothclip0


@dataclasses.dataclass(frozen=True)
class QuatRepr:
    value: torch.Tensor  # (..., 4) real-last

    def rotate_points(self, pts: torch.Tensor) -> torch.Tensor:
        return Q.rotate(self.value[..., None, :], pts)

    def mult(self, other: "QuatRepr") -> "QuatRepr":
        return QuatRepr(Q.mult(self.value, other.value))

    @classmethod
    def make_rotate_x(cls, angle: torch.Tensor) -> "QuatRepr":
        half = 0.5 * angle
        zeros = torch.zeros(half.shape + (2,), dtype=half.dtype, device=half.device)
        return QuatRepr(torch.cat([torch.sin(half)[..., None], zeros, torch.cos(half)[..., None]], dim=-1))

    @classmethod
    def from_features(cls, z: torch.Tensor) -> Tuple["QuatRepr", torch.Tensor]:
        """Features -> (normalized quats, unnormalized quats); the real part is
        forced positive through smoothclip0 because -q is the same rotation."""
        unnormalized = torch.cat([z[..., Q.iijk], smoothclip0(z[..., Q.iw :])], dim=-1)
        return QuatRepr(Q.normalized(unnormalized)), unnormalized

    def as_quat(self) -> torch.Tensor:
        return self.value


RotationRepr = QuatRepr
