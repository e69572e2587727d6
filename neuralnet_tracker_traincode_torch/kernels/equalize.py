"""K2: per-image histogram equalization (counterpart of the JAX package's
`augmentation/equalize_pallas.py:equalize_pallas`).

kornia/torchvision semantics: histogram bin floor(x*256), step = (total -
count of the last nonzero bin) // 255, LUT (cum + step//2) // max(step, 1)
shifted by one and clipped to 0..255, lookup at floor(x*255), pass-through
where step == 0 or the per-sample gate is off. Bit-equal across the plain
version, the CUDA kernel (`csrc/equalize.cu`) and the JAX package.

The kernel runs one cluster of `CLUSTER` CTAs per image; each CTA stages a
slice of the image in shared memory. `slice_edges` and `slice_capacity` are
the kernel's choice of slices and the room it stages them in, for the CPU
tests; the launcher itself checks that the slice fits in shared memory.
"""

import torch

from neuralnet_tracker_traincode_torch.kernels import ext

CLUSTER = 8  # CTAs per image: csrc/equalize.cu, kCluster


def slice_edges(B: int, P: int) -> torch.Tensor:
    """(B, CLUSTER + 1) int64 edges of each image's slices, as indices into
    the whole (B, P) array: the image's ends, and between them edge c at
    b*P + c*P // CLUSTER rounded up to a multiple of 4 (16 bytes) and cut to
    the image, as `csrc/equalize.cu:slice_edge` computes them."""
    base = torch.arange(B, dtype=torch.int64)[:, None] * P
    c = torch.arange(CLUSTER + 1, dtype=torch.int64)[None, :]
    inner = torch.minimum((base + c * P // CLUSTER + 3) // 4 * 4, base + P)
    return torch.where(c == 0, base, torch.where(c == CLUSTER, base + P, inner))


def slice_capacity(P: int) -> int:
    """f32 values a CTA stages for images of P pixels: its slice and the up
    to 3 pixels before it that share its first 16 bytes (`csrc/equalize.cu`,
    `cap`)."""
    return ((P + CLUSTER - 1) // CLUSTER + 6 + 3) // 4 * 4


def equalize_plain(images_flat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2 on (B, P) f32 images in [0, 1] and a (B,) gate."""
    x = images_flat
    B, P = x.shape
    bins = torch.clamp(torch.floor(x * 256.0), 0.0, 255.0).long()
    hist = torch.zeros((B, 256), dtype=torch.long, device=x.device).scatter_add_(1, bins, torch.ones_like(bins))
    idx = torch.arange(256, device=x.device)
    last_nz = torch.where(hist > 0, idx, -1).amax(dim=-1)
    last_count = torch.where(last_nz >= 0, hist.gather(1, last_nz.clamp(min=0)[:, None])[:, 0], 0)
    step = (hist.sum(dim=-1) - last_count) // 255
    cum = torch.cumsum(hist, dim=-1)
    lut = (cum + (step // 2)[:, None]) // torch.clamp(step, min=1)[:, None]
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=-1).clamp(0, 255)
    # divide by a tensor, not a python scalar: PyTorch's CUDA division by a
    # CPU scalar multiplies by the reciprocal, which is not IEEE division
    lut = lut.float() / torch.full_like(lut, 255, dtype=torch.float32)
    look = torch.floor(x * 255.0).long()
    valid = (look >= 0) & (look < 256)
    eq = torch.where(valid, lut.gather(1, look.clamp(0, 255)), torch.zeros_like(x))
    apply = (gate.reshape(B) != 0) & (step != 0)
    return torch.where(apply[:, None], eq, x)


def equalize(images_flat: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(B, P) f32 -> (B, P) f32: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if images_flat.device.type == "cpu":
        return equalize_plain(images_flat, gate)
    ext.require_cuda_tensor(images_flat, "images_flat", torch.float32, 2)
    gate = gate.to(device=images_flat.device, dtype=torch.int32).contiguous()
    if gate.shape != (images_flat.shape[0],):
        raise ValueError(f"gate must have shape ({images_flat.shape[0]},), got {tuple(gate.shape)}")
    out = torch.empty_like(images_flat)
    ext.extension().equalize(images_flat, gate, out)
    ext.LAUNCHES["equalize"] += 1
    return out
