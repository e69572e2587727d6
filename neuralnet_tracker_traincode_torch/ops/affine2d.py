"""Batched 2D affine transforms stored as (..., 2, 3) tensors.

Counterpart of the JAX package's `ops/affine2d.py`. Constructors take tensors
or python numbers; `device` defaults to the device of the first tensor
argument, else the CPU.
"""

import math
from typing import Optional

import torch

from neuralnet_tracker_traincode_torch.ops.mathfn import matmul_hp, matvecmul

SQRT2 = math.sqrt(2.0)

MaybeTensor = Optional[torch.Tensor]


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Affine2d:
    def __init__(self, m: torch.Tensor):
        assert m.shape[-2:] == (2, 3), f"Bad affine shape {m.shape}"
        self.m = m

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def identity(device=None) -> "Affine2d":
        return Affine2d(torch.eye(2, 3, dtype=torch.float32, device=device))

    @staticmethod
    def trs(
        translations: MaybeTensor = None,
        angles: MaybeTensor = None,
        scales: MaybeTensor = None,
    ) -> "Affine2d":
        """Translation-rotation-scale transform (scale and rotation applied first)."""
        dev = _device_of(translations, angles, scales)
        shape = Affine2d._batch_shape(translations, angles, scales)
        if angles is None:
            rot = torch.eye(2, dtype=torch.float32, device=dev).expand(shape + (2, 2))
            if scales is not None:
                rot = rot * _f32(scales, dev)[..., None, None]
        else:
            angles = _f32(angles, dev)
            cs, sn = torch.cos(angles), torch.sin(angles)
            if scales is not None:
                scales = _f32(scales, dev)
                cs, sn = cs * scales, sn * scales
            rot = torch.stack(
                [torch.stack([cs, -sn], dim=-1), torch.stack([sn, cs], dim=-1)], dim=-2
            ).expand(shape + (2, 2))
        if translations is not None:
            t = _f32(translations, dev).expand(shape + (2,))
        else:
            t = torch.zeros(shape + (2,), dtype=torch.float32, device=dev)
        return Affine2d(torch.cat([rot, t[..., None]], dim=-1))

    @staticmethod
    def range_remap_2d(inmin, inmax, outmin, outmax) -> "Affine2d":
        """Per-axis remap; args have a trailing 2-dim (x, y)."""
        dev = _device_of(inmin, inmax, outmin, outmax)
        inmin, inmax, outmin, outmax = (_f32(x, dev) for x in (inmin, inmax, outmin, outmax))
        s = (outmax - outmin) / (inmax - inmin)
        t = outmin - inmin * s
        s, t = torch.broadcast_tensors(s, t)
        zeros = torch.zeros(s.shape[:-1], dtype=torch.float32, device=dev)
        row0 = torch.stack([s[..., 0], zeros, t[..., 0]], dim=-1)
        row1 = torch.stack([zeros, s[..., 1], t[..., 1]], dim=-1)
        return Affine2d(torch.stack([row0, row1], dim=-2))

    @staticmethod
    def _batch_shape(translations, angles, scales):
        if translations is not None:
            return tuple(torch.as_tensor(translations).shape[:-1])
        if angles is not None:
            return tuple(torch.as_tensor(angles).shape)
        if scales is not None:
            return tuple(torch.as_tensor(scales).shape)
        raise ValueError("Need at least one argument")

    # ---- accessors ---------------------------------------------------------
    def tensor(self) -> torch.Tensor:
        return self.m

    @property
    def R(self) -> torch.Tensor:
        return self.m[..., :2, :2]

    @property
    def T(self) -> torch.Tensor:
        return self.m[..., :2, 2]

    # ---- algebra -----------------------------------------------------------
    def __matmul__(self, other: "Affine2d") -> "Affine2d":
        rot = matmul_hp(self.R, other.R)
        t = matvecmul(self.R, other.T) + self.T
        t = t.expand(rot.shape[:-2] + (2,))
        return Affine2d(torch.cat([rot, t[..., None]], dim=-1))

    def inv(self) -> "Affine2d":
        a, b = self.m[..., 0, 0], self.m[..., 0, 1]
        c, d = self.m[..., 1, 0], self.m[..., 1, 1]
        det = a * d - b * c
        inv_r = (
            torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
            / det[..., None, None]
        )
        t = -matvecmul(inv_r, self.T)
        return Affine2d(torch.cat([inv_r, t[..., None]], dim=-1))

    @property
    def scales(self) -> torch.Tensor:
        """Recover the isotropic scaling factor: |R|_F / sqrt(2)."""
        return torch.linalg.norm(self.m[..., :, :2], dim=(-2, -1)) / SQRT2

    @property
    def det(self) -> torch.Tensor:
        a, b = self.m[..., 0, 0], self.m[..., 0, 1]
        c, d = self.m[..., 1, 0], self.m[..., 1, 1]
        return a * d - b * c

    # ---- reshaping ----------------------------------------------------------
    def broadcast_to(self, shape) -> "Affine2d":
        return Affine2d(self.m.expand(tuple(shape) + (2, 3)))


def roi_normalizing_transform(roi: torch.Tensor) -> Affine2d:
    """Transform mapping an (x0, y0, x1, y1) roi onto [-1, 1]^2."""
    roi = torch.as_tensor(roi)
    assert roi.shape[-1] == 4
    out_min = torch.full(roi.shape[:-1] + (2,), -1.0, dtype=torch.float32, device=roi.device)
    return Affine2d.range_remap_2d(roi[..., :2], roi[..., 2:], out_min, torch.ones_like(out_min))
