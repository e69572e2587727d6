"""K3: the gaussian-noise augmentation (counterpart of the JAX package's
`augmentation/noise_pallas.py`: `add_gaussian_noise_pallas`, and
`add_gaussian_noise_from_bits` for the injected-bits entry).

Per pixel: two 24-bit words b1, b2 -> u1 = (b1+1)/2^24, u2 = b2/2^24 ->
z = sqrt(-2 ln u1) cos(2 pi u2) -> clip(x + sigma_b z, 0, 1) + offset. The
words come from Philox-4x32-10, or are injected: pixel pair q = p >> 1 of
sample b takes key (seeds[b], 0) and counter (q, 0, 0, 0), the even pixel
words 0 and 1, the odd pixel words 2 and 3 (`philox_bits`). The TPU's
hardware bits cannot be reproduced; the seeded path is held against the JAX
package by moments. `offset` (0 for the TPU kernel's function) lets the
training pipeline fold its whitening (-0.5) into the same pass; the
injected-bits entry has none.
"""

import math

import torch

from neuralnet_tracker_traincode_torch.kernels import ext

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a in [0, 2^32), split
    into 16-bit halves so no intermediate leaves the int64 range."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key):
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words: counter (c0, c1, c2, c3), key (k0, k1) -> the 4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, _M0)
        hi1, lo1 = _mulhilo32(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seeds: torch.Tensor, num: int):
    """(bits1, bits2), each (B, num) int32 in [0, 2^24): pixel p takes
    Philox-4x32-10 with key (seeds[b], 0) and counter (p >> 1, 0, 0, 0),
    words 0 and 1 for an even p, words 2 and 3 for an odd p."""
    B = seeds.shape[0]
    pairs = (num + 1) // 2
    k0 = (seeds.to(torch.int64) & _MASK32)[:, None].expand(B, pairs)
    zero = torch.zeros_like(k0)
    c0 = torch.arange(pairs, dtype=torch.int64, device=seeds.device)[None, :].expand(B, pairs)
    w0, w1, w2, w3 = philox4x32_10((c0, zero, zero, zero), (k0, zero))

    def interleave(even, odd):
        return (torch.stack([even, odd], dim=-1).reshape(B, 2 * pairs)[:, :num] & 0xFFFFFF).to(torch.int32)

    return interleave(w0, w2), interleave(w1, w3)


def apply_noise_from_bits_plain(x, bits1, bits2, sigma):
    """Plain PyTorch Box-Muller + add + clip on (B, P) tensors (low 24 bits used)."""
    u1 = ((bits1 & 0xFFFFFF) + 1).float() * (1.0 / (1 << 24))
    u2 = (bits2 & 0xFFFFFF).float() * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = r * torch.cos((2.0 * math.pi) * u2)
    return torch.clamp(x + sigma[:, None] * z, 0.0, 1.0)


def add_gaussian_noise_plain(
    images: torch.Tensor, seeds: torch.Tensor, sigma: torch.Tensor, offset: float = 0.0
) -> torch.Tensor:
    B = images.shape[0]
    x = images.reshape(B, -1)
    bits1, bits2 = philox_bits(seeds, x.shape[1])
    return (apply_noise_from_bits_plain(x, bits1, bits2, sigma) + offset).reshape(images.shape)


def add_gaussian_noise_from_bits_plain(images, bits1, bits2, sigma) -> torch.Tensor:
    B = images.shape[0]
    return apply_noise_from_bits_plain(
        images.reshape(B, -1), bits1.reshape(B, -1), bits2.reshape(B, -1), sigma
    ).reshape(images.shape)


def _check(images, sigma):
    ext.require_cuda_tensor(images, "images", torch.float32, images.dim())
    B = images.shape[0]
    sigma = sigma.to(device=images.device, dtype=torch.float32).contiguous()
    if sigma.shape != (B,):
        raise ValueError(f"sigma must have shape ({B},), got {tuple(sigma.shape)}")
    return images.reshape(B, -1), sigma


def add_gaussian_noise(
    images: torch.Tensor, seeds: torch.Tensor, sigma: torch.Tensor, offset: float = 0.0
) -> torch.Tensor:
    """(B, ...) f32 images in [0, 1], (B,) int32 seeds, (B,) f32 sigma, a
    scalar `offset` added after the clip: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if images.device.type == "cpu":
        return add_gaussian_noise_plain(images, seeds, sigma, offset)
    x, sigma = _check(images, sigma)
    seeds = seeds.to(device=images.device, dtype=torch.int32).contiguous()
    if seeds.shape != sigma.shape:
        raise ValueError(f"seeds must have shape {tuple(sigma.shape)}, got {tuple(seeds.shape)}")
    out = torch.empty_like(x)
    ext.extension().gaussian_noise(x, seeds, sigma, out, float(offset))
    ext.LAUNCHES["gaussian_noise"] += 1
    return out.reshape(images.shape)


def add_gaussian_noise_from_bits(images, bits1, bits2, sigma) -> torch.Tensor:
    """K3 with injected int32 bits, B * P elements each (low 24 bits used);
    on the card a sample whose sigma is 0 reads none of its bits."""
    if images.device.type == "cpu":
        return add_gaussian_noise_from_bits_plain(images, bits1, bits2, sigma)
    x, sigma = _check(images, sigma)
    for name, b in (("bits1", bits1), ("bits2", bits2)):
        if b.numel() != x.numel():
            raise ValueError(f"{name} must have B * P = {x.shape[0]} * {x.shape[1]} elements, got shape "
                             f"{tuple(b.shape)}")
    b1, b2 = (b.reshape(x.shape) for b in (bits1, bits2))
    for name, b in (("bits1", b1), ("bits2", b2)):
        ext.require_cuda_tensor(b, name, torch.int32, 2)
    out = torch.empty_like(x)
    ext.extension().gaussian_noise_from_bits(x, b1, b2, sigma, out)
    ext.LAUNCHES["gaussian_noise_from_bits"] += 1
    return out.reshape(images.shape)
