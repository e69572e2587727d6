"""6D rotation representation (counterpart of the JAX package's `ops/rot6d.py`).

6 features -> two 3-vectors -> an orthonormal frame by cross products, rows
normalised with eps 1e-6, and identity where the result is far from
orthonormal (inf-norm of M M^T - I above 1e-3).

Every product here is written out elementwise in f32, so neither bf16
autocast nor TF32 can round M M^T: a rounded test would trip the 1e-3
threshold and replace good rotations with the identity.
"""

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _gram(m: torch.Tensor) -> torch.Tensor:
    """m m^T over the last two dims, (..., R, C) -> (..., R, R), elementwise f32."""
    return torch.sum(m[..., :, None, :] * m[..., None, :, :], dim=-1)


def _normalize_rows(m: torch.Tensor, eps: float = 1.0e-6) -> torch.Tensor:
    norm = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    return m / torch.clamp(norm, min=eps)


def tomatrix(sixdrot: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) rotation matrix with rows [x, y, z]."""
    assert sixdrot.shape[-1] == 6
    v = sixdrot.float().reshape(sixdrot.shape[:-1] + (2, 3))
    x, y = v[..., 0, :], v[..., 1, :]
    z = _cross(x, y)
    y = _cross(z, x)
    out = _normalize_rows(torch.stack([x, y, z], dim=-2))
    eye = torch.eye(3, dtype=out.dtype, device=out.device)
    badness = torch.amax(torch.abs(_gram(out) - eye).flatten(-2), dim=-1)
    return torch.where(badness[..., None, None] > 1.0e-3, eye, out)


def frommatrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows, flattened."""
    assert m.shape[-2:] == (3, 3)
    return m[..., :-1, :].reshape(m.shape[:-2] + (6,))


def orthonormality_loss(m: torch.Tensor) -> torch.Tensor:
    assert m.shape[-1] == 6
    v = m.float().reshape(m.shape[:-1] + (2, 3))
    eye = torch.eye(2, dtype=v.dtype, device=v.device)
    return torch.mean(torch.square(_gram(v) - eye).flatten(-2), dim=-1)


def rotation_distance_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shifted and scaled cosine of the geodesic distance: 0.75 - 0.25 tr(A B^T)."""
    assert a.shape[-2:] == (3, 3) and b.shape[-2:] == (3, 3)
    trace = torch.sum(a.float() * b.float(), dim=(-2, -1))  # tr(A B^T) = sum_ij A_ij B_ij
    return 0.75 - 0.25 * trace
