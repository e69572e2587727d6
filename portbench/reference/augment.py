"""The training augmentation in plain float32 PyTorch: the draws from a
generator, the ROI-focus crop with its flip and rot90 (a triangle-filter
resample onto a canvas, three shears, the centre crop), the labels moved
with it, the four intensity slots (equalize, posterize, gamma, contrast,
brightness, blur) and the gaussian noise from Philox-4x32-10 bits, whitened.

The draws consume the generator in the order of the configuration's
pipeline: per step the ROI jitter, flip and rot90, the intensity slots, the
noise. The same seed gives the same draws as the pipeline under test."""

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import geometry as G

OP_PROBS = (0.2, 0.01, 0.2, 0.2, 0.2, 0.1)
NOISE_SIGMAS = np.asarray([4.0, 16.0, 32.0, 64.0], np.float32) / 255.0
NOISE_PROBS = np.asarray([0.25, 0.25**2, 0.25**3, 0.25**4], np.float32)
BEYOND_BORDER_SHIFT = 0.3
FLIP_MAP = [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
            27, 28, 29, 30, 35, 34, 33, 32, 31, 45, 44, 43, 42, 47, 46, 39, 38, 37, 36, 41, 40, 54, 53, 52, 51,
            50, 49, 48, 59, 58, 57, 56, 55, 64, 63, 62, 61, 60, 67, 66, 65]


class Draws(NamedTuple):
    scales: torch.Tensor  # (B,)
    angles: torch.Tensor  # (B,)
    translations: torch.Tensor  # (B, 2)
    do_flip: torch.Tensor  # (B,) bool
    rot_dir: torch.Tensor  # (B,) in {-1, 0, 1}
    perm: torch.Tensor  # (6,)
    masks: torch.Tensor  # (6, B) bool
    values: torch.Tensor  # (6, B)
    sigma: torch.Tensor  # (B,)
    seeds: torch.Tensor  # (B,) int32 Philox keys

    def to(self, device) -> "Draws":
        return Draws(*(t.to(device) for t in self))


def draw(gen: torch.Generator, B: int, aug: Dict) -> Draws:
    """One step's draws, on the host, from `gen`."""
    g = dict(generator=gen)
    scales = torch.clamp(torch.randn((B,), **g) * 0.1, -0.5, 0.5) + aug["extension_factor"]
    translations = torch.clamp(torch.randn((B, 2), **g) * 0.5, -1.0, 1.0)
    sign = torch.where(torch.rand((B,), **g) < 0.5, 1.0, -1.0)
    onoff = (torch.rand((B,), **g) < 1.0 / 3.0).float()
    angles = math.pi * aug["rotation_aug_angle"] / 180.0 * sign * onoff
    do_flip = torch.rand((B,), **g) < 0.5
    u = torch.rand((B,), **g)
    p = aug["p_flip_rot90"]
    rot_dir = torch.where(u < p / 2.0, -1.0, torch.where(u < 1.0 - p / 2.0, 0.0, 1.0))
    perm = torch.randperm(6, **g)
    masks = torch.rand((6, B), **g) < torch.tensor(OP_PROBS)[:, None]
    u = torch.rand((6, B), **g)
    lo = torch.tensor([0.0, 4.0, 0.5, 0.7, 0.7, 0.0])[:, None]
    hi = torch.tensor([0.0, 6.0, 2.0, 1.5, 1.5, 0.0])[:, None]
    values = lo + (hi - lo) * u
    values[1] = torch.floor(values[1])
    applied = torch.rand((B, 4), **g) < torch.as_tensor(NOISE_PROBS)[None, :]
    base = int(torch.randint(0, 2**32, (), dtype=torch.int64, **g))
    seeds = (base + torch.arange(B, dtype=torch.int64)) % 2**32
    seeds = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(torch.int32)
    sigma = torch.sqrt(torch.sum(torch.from_numpy(NOISE_SIGMAS)[None, :] ** 2 * applied, dim=-1))
    return Draws(scales, angles, translations, do_flip, rot_dir, perm, masks, values, sigma, seeds)


# ---- the crop ---------------------------------------------------------------


def canvas_size(out_size: int, theta_max_deg: float) -> int:
    a = abs(math.tan(math.radians(theta_max_deg) / 2.0))
    b = abs(math.sin(math.radians(theta_max_deg)))
    hx = hy = out_size / 2.0
    hx = hx + a * hy
    hy = hy + b * hx
    hx = hx + a * hy
    c = 2 * (int(math.ceil(max(hx, hy))) + 1)
    return c + 1 if (c - out_size) % 2 else c


def view_roi(roi, d: Draws, S: int):
    """(rounded square view ROI (B, 4), source -> crop affine) before flip and rot90."""
    x0, y0, x1, y1 = roi.unbind(-1)
    rx, ry = d.translations.unbind(-1)
    w, h = x1 - x0, y1 - y0
    cx, cy = 0.5 * (x1 + x0), 0.5 * (y1 + y0)
    size = torch.maximum(w, h) * d.scales
    tx = (0.5 * torch.abs(size - w) + BEYOND_BORDER_SHIFT * torch.minimum(size, w)) * rx
    ty = (0.5 * torch.abs(size - h) + BEYOND_BORDER_SHIFT * torch.minimum(size, h)) * ry
    vr = torch.round(torch.stack([cx - size * 0.5 + tx, cy - size * 0.5 + ty,
                                  cx + size * 0.5 + tx, cy + size * 0.5 + ty], dim=-1))
    dev, n = roi.device, float(S)
    tr = G.remap(vr[:, :2], vr[:, 2:], torch.zeros_like(vr[:, :2]), torch.full_like(vr[:, :2], n))
    centre = G.amul(G.amul(G.const_remap((-1.0, -1.0), (1.0, 1.0), (0.0, 0.0), (n, n), dev), G.rotation(d.angles)),
                    G.const_remap((0.0, 0.0), (n, n), (-1.0, -1.0), (1.0, 1.0), dev))
    return vr, G.amul(centre, tr)


def fliprot_affine(do_flip, rot_dir, S: int):
    dev, n = do_flip.device, float(S)
    rot = G.amul(G.amul(G.const_remap((-1.0, -1.0), (1.0, 1.0), (0.0, 0.0), (n, n), dev),
                        G.rotation(rot_dir * (math.pi * 0.5))),
                 G.const_remap((0.0, 0.0), (n, n), (-1.0, -1.0), (1.0, 1.0), dev))
    eye = torch.eye(2, 3, device=dev).expand(rot.shape)
    rot = torch.where((rot_dir != 0.0)[:, None, None], rot, eye)
    flip = G.const_remap((0.0, 0.0), (n, n), (n, 0.0), (0.0, n), dev).expand(rot.shape)
    return G.amul(rot, torch.where(do_flip[:, None, None], flip, eye))


def _tri_weights(start, scale, n_out: int, n_src: int):
    c = torch.arange(n_out, dtype=torch.float32, device=start.device)
    h = torch.arange(n_src, dtype=torch.float32, device=start.device)
    p = start[:, None] + scale[:, None] * (c[None, :] + 0.5)
    supp = torch.clamp(torch.abs(scale), min=1.0)[:, None, None]
    w = torch.clamp(1.0 - torch.abs((h[None, None, :] + 0.5 - p[:, :, None]) / supp), min=0.0)
    return w / (torch.sum(w, dim=-1, keepdim=True) + 1e-8)


def _shear_rows(x, coef):
    B, R, C = x.shape
    s = coef[:, None] * ((torch.arange(R, dtype=torch.float32, device=x.device) + 0.5) - C / 2.0)
    i0 = torch.floor(s)
    f = (s - i0)[:, :, None]
    idx = torch.arange(C, device=x.device)[None, None, :] + i0.long()[:, :, None]

    def tap(k):
        return torch.gather(x, 2, k.clamp(0, C - 1)) * ((k >= 0) & (k < C))

    return (1.0 - f) * tap(idx) + f * tap(idx + 1)


def crop(images, vr, angles, do_flip, rot_dir, S: int, theta_max_deg: float):
    """(B, H, W, 1) uint8 -> (B, S, S, 1) f32 in 0..255: the view ROI resampled
    onto a canvas, rotated by three shears, centre-cropped; the flip and the
    flip halves of rot90 as a reversed ROI range and a negated angle, then a
    transpose where rot90 is drawn."""
    B, H, W, _ = images.shape
    swap_x = torch.logical_xor(do_flip, rot_dir < 0)
    swap_y = rot_dir > 0
    negate = torch.logical_xor(do_flip, rot_dir != 0)
    x0, y0, x1, y1 = vr.unbind(-1)
    x0, x1 = torch.where(swap_x, x1, x0), torch.where(swap_x, x0, x1)
    y0, y1 = torch.where(swap_y, y1, y0), torch.where(swap_y, y0, y1)
    angles = torch.where(negate, -angles, angles)
    cs = canvas_size(S, theta_max_deg)
    m = (cs - S) / 2.0
    sx, sy = (x1 - x0) / S, (y1 - y0) / S
    phi = -angles
    a, b = -torch.tan(phi / 2.0), torch.sin(phi)
    wy = _tri_weights(y0 - sy * m, sy, cs, H)
    wx = _tri_weights(x0 - sx * m, sx, cs, W)
    canvas = torch.bmm(torch.bmm(wy, images[..., 0].float()), wx.transpose(1, 2))
    canvas = _shear_rows(canvas, a)
    canvas = _shear_rows(canvas.transpose(1, 2), b).transpose(1, 2)
    canvas = _shear_rows(canvas, a)
    lo = (cs - S) // 2
    out = canvas[:, lo:lo + S, lo:lo + S]
    out = torch.where((rot_dir != 0)[:, None, None], out.transpose(1, 2), out)
    return out[..., None]


# ---- the labels ---------------------------------------------------------------


def move_labels(labels: Dict[str, torch.Tensor], m) -> Dict[str, torch.Tensor]:
    """The labels under the affine m (..., 2, 3): points (68 landmarks
    reindexed under a reflection), the box (its corners' bounds), position
    and size, the quaternion (its in-plane part from m's y column); the rest
    as they are."""
    out = dict(labels)
    det = G.adet(m)
    pts = G.apply_points(m, labels["pt3d_68"])
    flipped = pts[:, torch.tensor(FLIP_MAP, device=pts.device)]
    out["pt3d_68"] = torch.where((det < 0.0)[:, None, None], flipped, pts)
    x0, y0, x1, y1 = labels["roi"].unbind(-1)
    corners = torch.stack([torch.stack([x0, y0], -1), torch.stack([x0, y1], -1),
                           torch.stack([x1, y0], -1), torch.stack([x1, y1], -1)], dim=-2)
    c = G.apply_points(m, corners)
    out["roi"] = torch.cat([c.amin(dim=-2), c.amax(dim=-2)], dim=-1)
    coord = labels["coord"]
    xy = (m[:, :2, :2] @ coord[:, :2, None])[..., 0] + m[:, :2, 2]
    out["coord"] = torch.cat([xy, (G.ascales(m) * coord[:, 2])[:, None]], dim=-1)
    sn, cs = -m[..., 0, 1], m[..., 1, 1]
    sign = torch.sign(det)
    alpha = torch.atan2(sn, cs)
    zeros = torch.zeros_like(alpha)
    zrot = torch.stack([zeros, zeros, torch.sin(alpha * 0.5) * sign, torch.cos(alpha * 0.5)], dim=-1)
    q = G.qmult(zrot, labels["pose"])
    out["pose"] = torch.cat([q[:, :1], sign[:, None] * q[:, 1:3], q[:, 3:]], dim=-1)
    return out


# ---- intensity ------------------------------------------------------------------


def equalize(x, gate):
    """Histogram equalization of (B, P) images in [0, 1] where the gate is on."""
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
    lut = lut.float() / torch.full_like(lut, 255, dtype=torch.float32)
    look = torch.floor(x * 255.0).long()
    eq = torch.where((look >= 0) & (look < 256), lut.gather(1, look.clamp(0, 255)), torch.zeros_like(x))
    return torch.where(((gate != 0) & (step != 0))[:, None], eq, x)


def _blur(x):
    k = np.exp(-0.5 * ((np.arange(5, dtype=np.float64) - 2.0) / 1.5) ** 2)
    k = torch.from_numpy((k / k.sum()).astype(np.float32)).to(x.device)
    y = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect")
    y = F.conv2d(y, k[None, None, :, None])
    y = F.conv2d(y, k[None, None, None, :])
    return y.permute(0, 2, 3, 1)


def _op(op: int, x, gate, value):
    B = x.shape[0]
    if op == 0:
        return equalize(x.reshape(B, -1), gate).reshape(x.shape)
    v = value[:, None, None, None]
    if op == 1:
        q = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.int32)
        shift = (8 - value).to(torch.int32)[:, None, None, None]
        y = ((q >> shift) << shift).float() / 255.0
    elif op == 2:
        y = torch.pow(torch.clamp(x, min=0.0), v)
    elif op == 3:
        y = torch.clamp(x * v, 0.0, 1.0)
    elif op == 4:
        y = torch.clamp(x + (v - 1.0), 0.0, 1.0)
    else:
        y = _blur(x)
    return torch.where(gate[:, None, None, None], y, x)


_M0, _M1, _W0, _W1, _MASK = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF


def _mulhilo(a, m: int):
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox_bits(seeds, num: int):
    """Pixel p of sample b: Philox-4x32-10 with key (seeds[b], 0), counter
    (p >> 1, 0, 0, 0); words 0, 1 for an even p, 2, 3 for an odd one; low 24 bits."""
    B, pairs = seeds.shape[0], (num + 1) // 2
    k0 = (seeds.to(torch.int64) & _MASK)[:, None].expand(B, pairs)
    k1 = torch.zeros_like(k0)
    c0 = torch.arange(pairs, dtype=torch.int64, device=seeds.device)[None, :].expand(B, pairs)
    c1 = c2 = c3 = torch.zeros_like(k0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK

    def interleave(even, odd):
        return (torch.stack([even, odd], -1).reshape(B, 2 * pairs)[:, :num] & 0xFFFFFF).to(torch.int32)

    return interleave(c0, c2), interleave(c1, c3)


def noise(x, seeds, sigma, offset: float):
    B = x.shape[0]
    flat = x.reshape(B, -1)
    b1, b2 = philox_bits(seeds, flat.shape[1])
    u1 = (b1 + 1).float() * (1.0 / (1 << 24))
    u2 = b2.float() * (1.0 / (1 << 24))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return (torch.clamp(flat + sigma[:, None] * z, 0.0, 1.0) + offset).reshape(x.shape)


def augment(images, labels: Dict[str, torch.Tensor], d: Draws, S: int, aug: Dict):
    """(whitened crops (B, S, S, 1), labels in crop coordinates normalised to [-1, 1])."""
    dev = images.device
    labels = dict(labels)
    half = torch.tensor([0.5, 0.5], device=dev)
    labels["coord"] = torch.cat([labels["coord"][:, :2] + half, labels["coord"][:, 2:]], dim=-1)
    p = labels["pt3d_68"]
    labels["pt3d_68"] = torch.cat([p[..., :2] + half, p[..., 2:]], dim=-1)
    vr, m = view_roi(labels["roi"], d, S)
    m = G.amul(fliprot_affine(d.do_flip, d.rot_dir, S), m)
    x = crop(images, vr, d.angles, d.do_flip, d.rot_dir, S, aug["rotation_aug_angle"])
    n = float(S)
    norm = G.const_remap((0.0, 0.0), (n, n), (-1.0, -1.0), (1.0, 1.0), dev).expand(m.shape)
    labels = move_labels(move_labels(labels, m), norm)
    x = x * (1.0 / 256.0)
    for slot in range(4):
        for op in range(6):
            x = _op(op, x, (d.perm[slot] == op) & d.masks[op], d.values[op])
    return noise(x.contiguous(), d.seeds, d.sigma, -0.5), labels
