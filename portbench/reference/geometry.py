"""Quaternions (real part last: x, y, z, w) and 2D affine maps stored as
(..., 2, 3) tensors, in plain float32 PyTorch. Frozen copies of the
arithmetic the pose pipeline uses; every product is an explicit f32 matmul
with TF32 off (the reference sets the flags)."""

import math

import torch
import torch.nn.functional as F

IW = 3


def smoothclip0(x):
    """elu(x) + 1: a smooth ramp onto positive values."""
    return F.elu(x) + 1.0


def qmult(u, v):
    ux, uy, uz, uw = u.unbind(-1)
    vx, vy, vz, vw = v.unbind(-1)
    return torch.stack([
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw,
        uw * vw - ux * vx - uy * vy - uz * vz,
    ], dim=-1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def qrotate(q, p):
    """Rotate 3-vectors p by quaternions q: q (p, 0) conj(q)."""
    pq = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    q, pq = torch.broadcast_tensors(q, pq)
    return qmult(qmult(q, pq), qconj(q))[..., :3]


def qnormalized(q, eps: float = 1.0e-6):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def qpositivereal(q):
    return q * torch.sign(q[..., IW])[..., None]


def qto_rotvec(q, eps: float = 1.0e-12):
    q = qpositivereal(q)
    norm = torch.linalg.norm(q[..., :3], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], q[..., IW])
    return q[..., :3] * angle[..., None] / (norm + eps)


def qrotation_delta(a, b):
    return qto_rotvec(qmult(qconj(a), b))


def qdistance(a, b):
    """1 - <a, b>^2."""
    return 1.0 - torch.square(torch.sum(a * b, dim=-1))


def qrotate_x(angle):
    half = 0.5 * angle
    zeros = torch.zeros(half.shape + (2,), dtype=half.dtype, device=half.device)
    return torch.cat([torch.sin(half)[..., None], zeros, torch.cos(half)[..., None]], dim=-1)


# ---- affine maps (..., 2, 3) --------------------------------------------------


def affine(rot, t):
    return torch.cat([rot, t[..., None]], dim=-1)


def amul(a, b):
    """a @ b: apply b first."""
    rot = a[..., :2, :2] @ b[..., :2, :2]
    t = (a[..., :2, :2] @ b[..., :2, 2:])[..., 0] + a[..., :2, 2]
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    return torch.cat([rot.expand(batch + (2, 2)), t.expand(batch + (2,))[..., None]], dim=-1)


def remap(inmin, inmax, outmin, outmax):
    """Per-axis range remap; arguments (..., 2) tensors (x, y)."""
    s = (outmax - outmin) / (inmax - inmin)
    t = outmin - inmin * s
    s, t = torch.broadcast_tensors(s, t)
    zeros = torch.zeros_like(s[..., 0])
    return torch.stack([torch.stack([s[..., 0], zeros, t[..., 0]], -1),
                        torch.stack([zeros, s[..., 1], t[..., 1]], -1)], dim=-2)


def const_remap(inmin, inmax, outmin, outmax, device):
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return remap(f(inmin), f(inmax), f(outmin), f(outmax))


def rotation(angles):
    cs, sn = torch.cos(angles), torch.sin(angles)
    rot = torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], dim=-2)
    return affine(rot, torch.zeros(angles.shape + (2,), dtype=torch.float32, device=angles.device))


def adet(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def ascales(m):
    return torch.linalg.norm(m[..., :, :2], dim=(-2, -1)) / math.sqrt(2.0)


def apply_points(m, pts):
    """Affine (..., 2, 3) on points (..., n, 2|3): xy moved, z scaled by sqrt|det|."""
    extra = pts.dim() - m.dim() + 1
    mm = m.reshape(m.shape[:-2] + (1,) * extra + (2, 3))
    xy = (mm[..., :2, :2] @ pts[..., :2, None])[..., 0] + mm[..., :2, 2]
    if pts.shape[-1] == 2:
        return xy
    detscale = torch.sqrt(torch.abs(adet(m))).reshape(m.shape[:-2] + (1,) * extra + (1,))
    return torch.cat([xy, (detscale * pts[..., 2:]).expand(xy.shape[:-1] + (1,))], dim=-1)
