"""Quaternion ops, scipy convention (real component LAST: x, y, z, w).

Counterpart of the JAX package's `ops/quaternion.py`: Hamilton products,
vector rotation, quat<->matrix conversions (best-conditioned-of-four
candidate selection in `from_matrix`), the rotation vector between two
rotations and back (`to_rotvec`, `from_rotvec`), spherical interpolation
(`slerp`) and the distances the losses use. Plain functions on tensors,
elementwise f32; `quat_average` (the pseudo-labels' ensemble mean) is host
numpy.
"""

from typing import Union

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import device_constant

# Component indices (scipy convention, real last).
iw = 3
ii = 0
ij = 1
ik = 2
iijk = slice(0, 3)


def mult(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two quaternion arrays, components in last dim (i,j,k,w)."""
    ux, uy, uz, uw = u.unbind(-1)
    vx, vy, vz, vw = v.unbind(-1)
    return torch.stack(
        [
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
            uw * vw - ux * vx - uy * vy - uz * vz,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * device_constant([-1.0, -1.0, -1.0, 1.0], q.device, q.dtype)


def rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors `p` by quaternions `q` (broadcasting over leading dims).

    q * (p, 0) * conj(q); for unnormalized q the result carries |q|^2.
    """
    pq = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    q, pq = torch.broadcast_tensors(q, pq)
    return mult(mult(q, pq), conjugate(q))[..., :3]


def tomatrix(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion -> rotation matrix (..., 3, 3)."""
    qi, qj, qk, qw = q[..., ii], q[..., ij], q[..., ik], q[..., iw]
    m00 = 1.0 - 2.0 * (qj * qj + qk * qk)
    m10 = 2.0 * (qi * qj + qk * qw)
    m20 = 2.0 * (qi * qk - qj * qw)
    m01 = 2.0 * (qi * qj - qk * qw)
    m11 = 1.0 - 2.0 * (qi * qi + qk * qk)
    m21 = 2.0 * (qj * qk + qi * qw)
    m02 = 2.0 * (qi * qk + qj * qw)
    m12 = 2.0 * (qj * qk - qi * qw)
    m22 = 1.0 - 2.0 * (qi * qi + qj * qj)
    return torch.stack(
        [
            torch.stack([m00, m01, m02], dim=-1),
            torch.stack([m10, m11, m12], dim=-1),
            torch.stack([m20, m21, m22], dim=-1),
        ],
        dim=-2,
    )


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion, picking the best conditioned of 4 solutions."""
    assert m.shape[-2:] == (3, 3)
    shape = m.shape[:-2]
    m = m.reshape((-1, 3, 3))
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]

    sqrt_args = torch.stack(
        [
            -m00 - m11 + m22 + 1.0,  # 4 qk^2
            -m00 + m11 - m22 + 1.0,  # 4 qj^2
            m00 - m11 - m22 + 1.0,  # 4 qi^2
            m00 + m11 + m22 + 1.0,  # 4 qw^2
        ],
        dim=-1,
    )
    sqrt_args = torch.clamp(sqrt_args, min=1.0e-6)
    qk_from_k, qj_from_j, qi_from_i, qw_from_w = (0.5 * torch.sqrt(sqrt_args)).unbind(-1)

    def od(a, b, sign, denom):
        return 0.25 * (a + sign * b) / denom

    candidates = torch.stack(
        [
            torch.stack(
                [od(m20, m02, 1.0, qk_from_k), od(m12, m21, 1.0, qk_from_k), qk_from_k,
                 od(m10, m01, -1.0, qk_from_k)], dim=-1),
            torch.stack(
                [od(m10, m01, 1.0, qj_from_j), qj_from_j, od(m12, m21, 1.0, qj_from_j),
                 od(m02, m20, -1.0, qj_from_j)], dim=-1),
            torch.stack(
                [qi_from_i, od(m10, m01, 1.0, qi_from_i), od(m02, m20, 1.0, qi_from_i),
                 od(m21, m12, -1.0, qi_from_i)], dim=-1),
            torch.stack(
                [od(m21, m12, -1.0, qw_from_w), od(m02, m20, -1.0, qw_from_w),
                 od(m10, m01, -1.0, qw_from_w), qw_from_w], dim=-1),
        ],
        dim=1,
    )  # (N, 4, 4)
    pick = torch.argmax(sqrt_args, dim=-1)
    quat = candidates[torch.arange(m.shape[0], device=m.device), pick]
    return positivereal(quat).reshape(shape + (4,))


def from_rotvec(r: torch.Tensor, eps: float = 1.0e-12) -> torch.Tensor:
    """Rotation vector (..., 3) -> unit quaternion (..., 4); `eps` keeps the
    axis finite at a zero angle."""
    angle = torch.linalg.norm(r, dim=-1, keepdim=True)
    axis = r / (angle + eps)
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def to_rotvec(q: torch.Tensor, eps: float = 1.0e-12) -> torch.Tensor:
    # Positive real part constrains angles to [0, pi].
    q = positivereal(q)
    w = q[..., iw]
    axis = q[..., iijk]
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    return axis * angle[..., None] / (norm + eps)


def rotation_delta(from_: torch.Tensor, to_: torch.Tensor) -> torch.Tensor:
    """Rotation vector taking `from_` to `to_` (tangent-space difference)."""
    return to_rotvec(mult(conjugate(from_), to_))


def slerp(p: torch.Tensor, q: torch.Tensor, t: Union[float, torch.Tensor], eps: float = 1.0e-12) -> torch.Tensor:
    """Spherical interpolation from `p` (t = 0) to `q` (t = 1) along the
    shorter arc; `t` a float or a tensor that broadcasts against (..., 1)."""
    return mult(p, from_rotvec(rotation_delta(p, q) * t, eps))


def positivereal(q: torch.Tensor) -> torch.Tensor:
    return q * torch.sign(q[..., iw])[..., None]


def normalized(q: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - <a,b>^2, a cheap rotation distance."""
    return 1.0 - torch.square(torch.sum(a * b, dim=-1))


def geodesicdistance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(rotation_delta(a, b), dim=-1)


def quat_average(quats) -> np.ndarray:
    """Ensemble mean of quaternions (E, N, 4) -> (N, 4), host numpy: each
    sample's quaternions are sign-aligned on their pivot axis (the largest
    summed magnitude), averaged and normalized (the reference's
    `torchquaternion.py:239-256`)."""
    quats = np.array(quats, copy=True)
    E, N, D = quats.shape
    assert D == 4
    pivot_axes = np.argmax(np.sum(np.abs(quats), axis=0), axis=-1)
    mask = np.take_along_axis(quats, pivot_axes[None, :, None], axis=-1)[..., 0] < 0.0
    quats[mask, :] *= -1
    quats = np.average(quats, axis=0)
    norms = np.linalg.norm(quats, axis=-1, keepdims=True)
    if not np.all(norms > 0.5):
        print("quat_average: rotation predictions differ wildly (or there is a bug)")
    quats /= norms
    return quats
