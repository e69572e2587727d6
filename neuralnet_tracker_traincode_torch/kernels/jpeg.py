"""K4: the JPEG decode's device half (counterpart of the JAX package's
`data/native_loader.py` / `native/nntc_loader.cpp`, where libjpeg decodes
on the host; no Pallas kernel).

From the quantized DCT coefficients that the host's entropy decoder writes
(`data/native_loader.py:entropy_decode`), per 8x8 block: dequantize, run
libjpeg's integer inverse DCT (`JDCT_ISLOW`), add 128 and limit to [0, 255];
then write each image's pixels inside its (h, w) into its slot of the
zero-padded (N, pad, pad, 1) uint8 batch, and zeros everywhere else.

The arithmetic is libjpeg-turbo's ISLOW as its x86 SIMD code (SSE2, AVX2)
computes it, which is what cv2 and the JAX package's libjpeg run on x86-64:
jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2), the same products and
DESCALE roundings (by 11 after the column pass, by 18 after the row pass),
on 16-bit lanes. It equals jidctint.c's 64-bit arithmetic wherever no
intermediate leaves 16 bits, which holds for the files encoders write; where
one does (a file whose quantization tables were raised after encoding), the
lanes decide, and so does this code:
  - the dequantized coefficient keeps its low 16 bits;
  - the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 keep their low
    16 bits;
  - the column pass's outputs saturate to 16 bits, except in a block whose
    rows 1-7 are all zero, where each column is its dequantized DC times 4,
    low 16 bits kept (the SIMD code's shortcut);
  - the row pass's outputs saturate to [-128, 127] before the + 128.
So the range limit is a clamp: jidctint.c's table with its 10-bit wrap
(`& RANGE_MASK`) is not what these decoders run, and gives other pixels on
such files.

`idct_pack` launches the kernel (`kernels/csrc/jpeg_idct.cu`) on a CUDA
tensor and raises on anything else but a CPU tensor, for which it runs
`idct_pack_plain`, the same function in plain PyTorch integer ops.

Its input is K5's output (`kernels/jpeg_huffman.py`): `slots` (NB, 64)
int16, each Y block's coefficients in zigzag order up to its last nonzero
one (what lies past `lens[b]` is not read and may be anything); `lens`
(NB,) uint8, each block's count, 1 to 64; `qtables` (N, 64) int32, each
image's table in natural order; `meta` (N, M) int32, M >= 4, whose first
four columns are each image's height, width, block-grid width ceil(w / 8)
and first block (its ceil(w/8) x ceil(h/8) blocks follow in raster order).
`runs_to_slots` lays the host entropy decoder's runs
(`data/native_loader.py:JpegCoefficients`) out so.
"""

from typing import Optional, Tuple

import torch

from neuralnet_tracker_traincode_torch.kernels import ext

CONST_BITS, PASS1_BITS = 13, 2
# jidctint.c's FIX_* constants, FIX(x) = round(x * 2^13)
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172
# the natural (row-major) position of each zigzag index
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
          60, 61, 54, 47, 55, 62, 63)


def _low16(x: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int64 `x`, as a signed value."""
    return ((x + 32768) & 0xFFFF) - 32768


def _islow_pass(v: torch.Tensor, shift: int) -> torch.Tensor:
    """One 1D pass of the ISLOW IDCT along the last axis of int64 `v` (values
    in the 16-bit range), DESCALEd by `shift`; the products as the SIMD code
    groups them (each the C code's sum, distributed)."""
    i0, i1, i2, i3, i4, i5, i6, i7 = v.unbind(-1)
    # even part
    tmp3 = i2 * (FIX_0_541196100 + FIX_0_765366865) + i6 * FIX_0_541196100
    tmp2 = i2 * FIX_0_541196100 + i6 * (FIX_0_541196100 - FIX_1_847759065)
    tmp0 = _low16(i0 + i4) * (1 << CONST_BITS)
    tmp1 = _low16(i0 - i4) * (1 << CONST_BITS)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    # odd part
    z3, z4 = _low16(i7 + i3), _low16(i5 + i1)
    z3p = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602
    z4p = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644)
    t0 = i7 * (FIX_0_298631336 - FIX_0_899976223) - i1 * FIX_0_899976223 + z3p
    t1 = i5 * (FIX_2_053119869 - FIX_2_562915447) - i3 * FIX_2_562915447 + z4p
    t2 = -i5 * FIX_2_562915447 + i3 * (FIX_3_072711026 - FIX_2_562915447) + z3p
    t3 = -i7 * FIX_0_899976223 + i1 * (FIX_1_501321110 - FIX_0_899976223) + z4p
    out = torch.stack([t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3], -1)
    return (out + (1 << (shift - 1))) >> shift


def dense_blocks(coeffs: torch.Tensor, block_start: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Blocks `first` .. `first + count` of a payload as (count, 64) int64
    coefficients in natural order."""
    starts = block_start[first:first + count + 1].to(torch.int64)
    lens = starts[1:] - starts[:-1]
    if count and bool((lens < 1).any() | (lens > 64).any()):
        raise ValueError("a block of the payload holds no coefficient or more than 64")
    blocks = torch.arange(count, device=coeffs.device).repeat_interleave(lens)
    zigzag = torch.arange(int(starts[-1] - starts[0]), device=coeffs.device) \
        - (starts[:-1] - starts[0]).repeat_interleave(lens)
    dense = torch.zeros((count, 64), dtype=torch.int64, device=coeffs.device)
    natural = torch.as_tensor(ZIGZAG, device=coeffs.device)[zigzag]
    dense[blocks, natural] = coeffs[int(starts[0]):int(starts[-1])].to(torch.int64)
    return dense


def idct_blocks_plain(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """(nb, 64) coefficient blocks in natural order and their (nb or 1, 64)
    table -> (nb, 8, 8) uint8 pixels: dequantize, ISLOW IDCT, + 128, range
    limit."""
    raw = coeffs.to(torch.int64).reshape(-1, 8, 8)
    dq = _low16(raw * qtable.to(torch.int64).reshape(-1, 8, 8))
    ws = _islow_pass(dq.transpose(1, 2), CONST_BITS - PASS1_BITS).transpose(1, 2).clamp(-32768, 32767)
    dc_only = (raw[:, 1:, :] == 0).all(2).all(1)
    ws = torch.where(dc_only[:, None, None], _low16(dq[:, :1, :] * (1 << PASS1_BITS)).expand_as(dq), ws)
    out = _islow_pass(ws, CONST_BITS + PASS1_BITS + 3)
    return (out.clamp(-128, 127) + 128).to(torch.uint8)


def runs_to_slots(coeffs: torch.Tensor, block_start: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host entropy decoder's runs (block b is coeffs[block_start[b] ..
    block_start[b + 1]), zigzag order) as (slots (NB, 64) int16, lens (NB,)
    uint8), the entries past each run zero; on the runs' device, without a
    read-back."""
    starts = block_start.to(torch.int64)
    lens = starts[1:] - starts[:-1]
    nb = lens.shape[0]
    total = coeffs.shape[0]
    block = torch.repeat_interleave(torch.arange(nb, device=coeffs.device), lens, output_size=total)
    z = torch.arange(total, device=coeffs.device) - torch.repeat_interleave(starts[:-1] - starts[0], lens,
                                                                             output_size=total)
    slots = torch.zeros((nb, 64), dtype=torch.int16, device=coeffs.device)
    slots.view(-1)[block * 64 + z] = coeffs[:total]
    return slots, lens.to(torch.uint8)


def slot_blocks(slots: torch.Tensor, lens: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Blocks `first` .. `first + count` of K5's slots as (count, 64) int64
    coefficients in natural order (each past its length zero)."""
    z = slots[first:first + count].to(torch.int64)
    z = torch.where(torch.arange(64, device=slots.device) < lens[first:first + count, None].to(torch.int64), z, 0)
    dense = torch.zeros_like(z)
    dense[:, torch.as_tensor(ZIGZAG, device=slots.device)] = z
    return dense


def _output(meta: torch.Tensor, pad: int, out: Optional[torch.Tensor], device) -> torch.Tensor:
    shape = (meta.shape[0], pad, pad, 1)
    if out is None:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    if tuple(out.shape) != shape or out.dtype != torch.uint8 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 tensor of shape {shape}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    return out


def _check_shapes(slots, lens, qtables, meta):
    if slots.dim() != 2 or slots.shape[1] != 64 or tuple(lens.shape) != (slots.shape[0],) or meta.dim() != 2 \
            or meta.shape[1] < 4 or tuple(qtables.shape) != (meta.shape[0], 64):
        raise ValueError(f"bad payload shapes: slots {tuple(slots.shape)}, lens {tuple(lens.shape)}, qtables "
                         f"{tuple(qtables.shape)}, meta {tuple(meta.shape)}")


def _check_payload(slots: torch.Tensor, lens: torch.Tensor, qtables: torch.Tensor, meta: torch.Tensor, pad: int):
    """Raise unless the payload's dims fit `pad`, its block grids lie in
    `slots` and its lengths are 1 to 64 (read on the host)."""
    _check_shapes(slots, lens, qtables, meta)
    m = meta.detach().cpu().to(torch.int64)
    if m.shape[0] == 0:
        return
    h, w, gw, first = m[:, :4].unbind(1)
    if bool((h < 1).any() | (w < 1).any() | (h > pad).any() | (w > pad).any()):
        raise ValueError(f"an image of the payload is empty or exceeds the padding {pad}")
    if bool((gw != (w + 7) // 8).any() | (first < 0).any() | (first + gw * ((h + 7) // 8) > slots.shape[0]).any()):
        raise ValueError("the payload's block grids do not lie in its slots")
    ln = lens.detach().cpu()
    if ln.numel() and bool((ln < 1).any() | (ln > 64).any()):
        raise ValueError("a block of the payload holds no coefficient or more than 64")


def idct_pack_plain(slots: torch.Tensor, lens: torch.Tensor, qtables: torch.Tensor, meta: torch.Tensor,
                    pad: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 in plain PyTorch: the (N, pad, pad, 1) uint8 batch, each image top
    left in its zero-padded slot."""
    _check_payload(slots, lens, qtables, meta, pad)
    out = _output(meta, pad, out, slots.device)
    out.zero_()
    for n, (h, w, gw, first) in enumerate(meta[:, :4].detach().cpu().tolist()):
        gh = (h + 7) // 8
        px = idct_blocks_plain(slot_blocks(slots, lens, first, gw * gh), qtables[n:n + 1])
        px = px.reshape(gh, gw, 8, 8).permute(0, 2, 1, 3).reshape(gh * 8, gw * 8)
        out[n, :h, :w, 0] = px[:h, :w]
    return out


def idct_pack(slots: torch.Tensor, lens: torch.Tensor, qtables: torch.Tensor, meta: torch.Tensor, pad: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4 for CUDA tensors (into `out` where given, e.g. row k of a stacked
    (K, B, pad, pad, 1) batch), the plain version for CPU tensors. On the
    card the kernel reads no slot outside `slots` (lengths are clamped to
    1-64 there)."""
    if slots.device.type == "cpu":
        return idct_pack_plain(slots, lens, qtables, meta, pad, out)
    ext.require_cuda_tensor(slots, "slots", torch.int16, 2)
    ext.require_cuda_tensor(lens, "lens", torch.uint8, 1)
    ext.require_cuda_tensor(qtables, "qtables", torch.int32, 2)
    ext.require_cuda_tensor(meta, "meta", torch.int32, 2)
    _check_shapes(slots, lens, qtables, meta)
    out = _output(meta, pad, out, slots.device)
    ext.require_cuda_tensor(out, "out", torch.uint8, 4)
    if meta.shape[0]:
        ext.extension().jpeg_idct_pack(slots, lens, qtables, meta, out, int(pad))
        ext.LAUNCHES["jpeg_idct"] += 1
    return out
