"""Small math helpers (counterpart of the JAX package's `ops/mathfn.py`).

smoothclip0 = elu + 1, sqrclip0 (a relu smoothed by a parabola) and their
inverses, and the matrix products the geometry code uses.
"""

import contextlib
import functools

import torch
import torch.nn.functional as F


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 matmul for small geometry matrices, immune to autocast.

    The model runs under bf16 autocast; the affine/quaternion geometry must
    stay f32 whatever the surrounding precision policy (the JAX package pins
    `Precision.HIGHEST` for the same reason). Full f32 also needs
    `torch.backends.cuda.matmul.allow_tf32` False, which is PyTorch's default.
    """
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.float(), b.float())


@contextlib.contextmanager
def full_f32_matmul():
    """Within the block cuBLAS computes f32 matmuls in full f32 (no TF32),
    whatever `torch.backends.cuda.matmul.allow_tf32` says; the flag is
    restored on exit."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def matvecmul(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """matmul where v has no trailing column dimension."""
    return matmul_hp(m, v[..., None])[..., 0]


def affinevecmul(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply an affine (..., D, D+1) matrix to (..., D) vectors."""
    return matvecmul(m[..., :, :-1], v) + m[..., :, -1]


def smoothclip0(x: torch.Tensor) -> torch.Tensor:
    """Smooth ramp onto positive values: elu(x) + 1."""
    return F.elu(x) + 1.0


def inv_smoothclip0(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    safe_log = torch.log(torch.where(x > 1.0, torch.ones_like(x), x))
    return torch.where(x > 1.0, x - 1.0, safe_log)


def sqrclip0(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Smoothed relu: quadratic in [-beta/2, beta/2], linear above."""
    z = F.relu(x + beta * 0.5)
    return torch.where(z < beta, (0.5 / beta) * torch.square(z), z - 0.5 * beta)


def inv_sqrclip0(y, beta: float) -> torch.Tensor:
    y = torch.as_tensor(y)
    safe_sqrt = torch.sqrt(torch.clamp(beta * 2.0 * y, min=0.0))
    return torch.where(y > 0.5 * beta, y + 0.5 * beta, safe_sqrt) - beta * 0.5


def chain_gmm(*matrices: torch.Tensor) -> torch.Tensor:
    """The product of the matrices, left to right, in f32 (`matmul_hp`)."""
    return functools.reduce(matmul_hp, matrices)
