"""Small math helpers (counterpart of the JAX package's `ops/mathfn.py`).

smoothclip0 = elu + 1 and its inverse, and the matrix-vector products the
geometry code uses.
"""

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
