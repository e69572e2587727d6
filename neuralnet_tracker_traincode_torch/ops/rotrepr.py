"""Rotation representations of the pose heads: quaternion and 3x3 matrix.

Counterpart of the JAX package's `ops/rotrepr.py`. `QuatRepr` carries the
quaternion heads, `Mat33Repr` the 6D rotation head; both offer the same
methods, so the heads and the landmark transform take either.
"""

import dataclasses
from typing import Tuple, Union

import torch

from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops import rot6d
from neuralnet_tracker_traincode_torch.ops.mathfn import matmul_hp, smoothclip0


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


@dataclasses.dataclass(frozen=True)
class Mat33Repr:
    value: torch.Tensor  # (..., 3, 3)

    def rotate_points(self, pts: torch.Tensor) -> torch.Tensor:
        return matmul_hp(self.value, pts.transpose(-2, -1)).transpose(-2, -1)

    def mult(self, other: "Mat33Repr") -> "Mat33Repr":
        return Mat33Repr(matmul_hp(self.value, other.value))

    @classmethod
    def make_rotate_x(cls, angle: torch.Tensor) -> "Mat33Repr":
        sn, cs = torch.sin(angle), torch.cos(angle)
        zeros, ones = torch.zeros_like(angle), torch.ones_like(angle)
        m = torch.stack([ones, zeros, zeros, zeros, cs, -sn, zeros, sn, cs], dim=-1)
        return Mat33Repr(m.reshape(angle.shape + (3, 3)))

    @classmethod
    def from_6drepr_features(cls, z: torch.Tensor) -> "Mat33Repr":
        return Mat33Repr(rot6d.tomatrix(z))

    def as_quat(self) -> torch.Tensor:
        return Q.from_matrix(self.value)


RotationRepr = Union[QuatRepr, Mat33Repr]
