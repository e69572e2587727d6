"""JPEG decoding for the training loader (counterpart of the JAX package's
`data/native_loader.py`, which decodes with libjpeg on the host through
`native/nntc_loader.cpp`).

The decode is split where the card can take it. The host's part is the
entropy (Huffman) decode, serial within a scan: `data/csrc/jpeg_entropy.cpp`,
standalone C++ with no libjpeg, built by `g++ -O3 -shared -fPIC` at first use
into `.cache/torch_host/` and loaded through ctypes; it decodes a batch on a
thread pool into a `JpegCoefficients` payload (each image's quantized Y
coefficients, each block's up to its last nonzero one in zigzag order, its
quantization table, its dims). The card's part is K4
(`kernels/jpeg.py:idct_pack`): dequantization, libjpeg's integer IDCT, the
range limit and the zero-padded (N, pad, pad, 1) uint8 batch, bit-equal to
libjpeg's grayscale decode as cv2 and the JAX package run it. On the CPU the
same payload goes through K4's plain version.

What the entropy decoder refuses raises a ValueError naming the image and
the marker: progressive, lossless and arithmetic-coded files, other than
8-bit samples, 4 components, a subsampled Y, a 3-component file that libjpeg
reads as RGB, and truncated or corrupt scan data (where libjpeg warns and
fills with zeros). A build failure raises too: nothing gives way to cv2
silently. `$NNTC_NO_NATIVE=1`, as in the JAX module, is the one switch: then
`get_lib()` gives None, the functions here give None, and the loader decodes
with cv2 on the host (`decode_mode`).
"""

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "jpeg_entropy.cpp")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, ".cache", "torch_host")
_SO = os.path.join(BUILD_DIR, "libnntc_jpeg_entropy.so")
BUILD_COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", "{out}", "-lpthread"]
_ERRLEN = 512

_lib = None
_lib_lock = threading.Lock()
_scratch = threading.local()  # each thread's room for a batch's coefficients, reused from batch to batch


def native_disabled() -> bool:
    """`$NNTC_NO_NATIVE` is set: decode with cv2 on the host."""
    return bool(os.environ.get("NNTC_NO_NATIVE"))


def decode_mode(requested: str) -> str:
    """The loader's JPEG decode: "device" (host entropy decode, K4) or "host"
    (cv2); `$NNTC_NO_NATIVE` turns "device" into "host"."""
    if requested not in ("device", "host"):
        raise ValueError(f"jpeg_decode must be 'device' or 'host', got {requested!r}")
    return "host" if native_disabled() else requested


def _build():
    """Compile the library into BUILD_DIR (under a file lock, so that spawned
    workers starting together build it once); raise on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "jpeg_entropy.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [a.format(out=tmp) for a in BUILD_COMMAND]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building the JPEG entropy decoder failed ({' '.join(cmd)}): {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"building the JPEG entropy decoder failed ({' '.join(cmd)}):\n{res.stderr[-4000:]}")
        os.replace(tmp, _SO)


def get_lib() -> Optional[ctypes.CDLL]:
    """The entropy decoder, built on first use; None under `$NNTC_NO_NATIVE`."""
    global _lib
    if native_disabled():
        return None
    with _lib_lock:
        if _lib is None:
            if not os.path.isfile(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_SO)
            p = ctypes.c_void_p
            lib.nntc_jpeg_probe_batch.restype = ctypes.c_int
            lib.nntc_jpeg_probe_batch.argtypes = [p, p, p, ctypes.c_int, p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.nntc_jpeg_entropy_batch.restype = ctypes.c_int
            lib.nntc_jpeg_entropy_batch.argtypes = [p, p, p, ctypes.c_int, p, ctypes.c_int64, p, p, p, p,
                                                    ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


class JpegCoefficients:
    """A batch of entropy-decoded grayscale JPEGs, the input of K4:
    `coeffs` (NC,) int16, the Y blocks one after another, each as its
    coefficients in zigzag order up to its last nonzero one (at least the
    DC); `block_start` (NB + 1,) int32, where each block's run starts (block
    b is `coeffs[block_start[b]:block_start[b + 1]]`); `qtables` (N, 64)
    int32, natural order; `meta` (N, 4) int32: height, width, block-grid
    width ceil(w/8) and first block of each image (its ceil(w/8) x
    ceil(h/8) blocks follow in raster order); `pad`, the side of the
    zero-padded slot each image is decoded into. The arrays are numpy arrays
    on the host or tensors (pinned, or on a device).

    Indexing selects images (rows of the batch it decodes to); the selected
    images share the coefficients. `shape` is that of the decoded batch,
    (N, pad, pad, 1)."""

    __slots__ = ("coeffs", "block_start", "qtables", "meta", "pad")

    def __init__(self, coeffs, block_start, qtables, meta, pad: int):
        self.coeffs, self.block_start, self.qtables, self.meta = coeffs, block_start, qtables, meta
        self.pad = int(pad)

    def __len__(self) -> int:
        return int(self.meta.shape[0])

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self), self.pad, self.pad, 1)

    @property
    def heights(self):
        return self.meta[:, 0]

    @property
    def widths(self):
        return self.meta[:, 1]

    @property
    def arrays(self):
        return self.coeffs, self.block_start, self.qtables, self.meta

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) if hasattr(a, "nbytes") else a.numel() * a.element_size() for a in self.arrays)

    def __getitem__(self, index) -> "JpegCoefficients":
        if isinstance(index, (int, np.integer)):
            index = [int(index)]
        return JpegCoefficients(self.coeffs, self.block_start, self.qtables[index], self.meta[index], self.pad)

    def with_pad(self, pad: int) -> "JpegCoefficients":
        """The same images decoded into larger slots."""
        if pad < self.pad:
            raise ValueError(f"cannot shrink the padding from {self.pad} to {pad}")
        return JpegCoefficients(*self.arrays, pad)

    def pinned(self) -> "JpegCoefficients":
        """Pinned host tensors of the arrays (for an asynchronous upload);
        an array in pinned memory already is not copied."""

        def pin(a):
            a = torch.as_tensor(a)
            if a.is_pinned():
                return a
            out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            out.copy_(a)
            return out

        return JpegCoefficients(*(pin(a) for a in self.arrays), self.pad)

    def to(self, device, non_blocking: bool = False) -> "JpegCoefficients":
        return JpegCoefficients(*(torch.as_tensor(a).to(device, non_blocking=non_blocking) for a in self.arrays),
                                self.pad)

    def decode(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (N, pad, pad, 1) uint8 batch, on the arrays' device: K4 on a
        card, its plain version on the CPU (`out`: where to write it)."""
        from neuralnet_tracker_traincode_torch.kernels.jpeg import idct_pack

        return idct_pack(*(torch.as_tensor(a) for a in self.arrays), self.pad, out=out)


def _blob(buffers: Sequence[np.ndarray]):
    arrays = [np.ascontiguousarray(np.frombuffer(b, np.uint8) if isinstance(b, (bytes, bytearray)) else b,
                                   np.uint8).ravel() for b in buffers]
    lengths = np.asarray([a.size for a in arrays], np.uintp)
    offsets = np.zeros(len(arrays), np.uintp)
    np.cumsum(lengths[:-1], out=offsets[1:])
    return np.concatenate(arrays) if arrays else np.zeros(0, np.uint8), offsets, lengths


def entropy_decode(buffers: Sequence[np.ndarray], pad_size: int, nthreads: Optional[int] = None,
                   names: Optional[Sequence[str]] = None) -> Optional[JpegCoefficients]:
    """Entropy-decode JPEG buffers on `nthreads` threads (default: the host's
    cores) into a payload for slots of `pad_size`; None under
    `$NNTC_NO_NATIVE`. Raises ValueError naming the image (`names[i]`, else
    its index) for what it does not decode and for an image larger than the
    slot."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(buffers)
    if n == 0:
        raise ValueError("no JPEG buffers to decode")
    threads = int(nthreads or os.cpu_count() or 1)
    blob, offsets, lengths = _blob(buffers)
    err = ctypes.create_string_buffer(_ERRLEN)

    def name(i):
        return names[i] if names is not None else f"image {i} of {n}"

    dims = np.zeros((n, 4), np.int32)
    bad = lib.nntc_jpeg_probe_batch(blob.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, dims.ctypes.data,
                                    threads, err, _ERRLEN)
    if bad >= 0:
        raise ValueError(f"JPEG decode: {name(bad)}: {err.value.decode(errors='replace')}")
    large = np.flatnonzero(dims[:, :2].max(1) > pad_size)
    if large.size:
        i = int(large[0])
        raise ValueError(f"JPEG decode: {name(i)} is {dims[i, 0]}x{dims[i, 1]}, larger than the padding {pad_size}")
    blocks = dims[:, 2].astype(np.int64) * dims[:, 3]
    first = np.zeros(n, np.int64)
    np.cumsum(blocks[:-1], out=first[1:])
    nb = int(blocks.sum())
    if nb * 64 >= 2**31:
        raise ValueError(f"JPEG decode: {nb} blocks in one batch exceed the payload's 32-bit offsets")
    # room for every coefficient; what a batch fills is copied out, and the room kept for the thread's next batch
    room = getattr(_scratch, "room", None)
    if room is None or room.size < nb * 64:
        room = _scratch.room = np.empty(nb * 64, np.int16)
    block_start = np.empty(nb + 1, np.int32)
    total = ctypes.c_int64()
    qtables = np.zeros((n, 64), np.int32)
    bad = lib.nntc_jpeg_entropy_batch(blob.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n,
                                      first.ctypes.data, nb, room.ctypes.data, block_start.ctypes.data,
                                      ctypes.byref(total), qtables.ctypes.data, threads, err, _ERRLEN)
    if bad >= 0:
        raise ValueError(f"JPEG decode: {name(bad)}: {err.value.decode(errors='replace')}")
    coeffs = room[:total.value].copy()
    meta = np.stack([dims[:, 0], dims[:, 1], dims[:, 2], first.astype(np.int32)], 1).astype(np.int32)
    return JpegCoefficients(coeffs, block_start, qtables, meta, pad_size)


def decode_jpeg_gray(buffer: np.ndarray, device: DeviceLike = None) -> Optional[torch.Tensor]:
    """One JPEG buffer -> (H, W) uint8 grayscale on `device` (default: the
    card); None under `$NNTC_NO_NATIVE`."""
    dev = resolve_device(device)
    payload = entropy_decode([buffer], 1 << 16, nthreads=1)
    if payload is None:
        return None
    h, w = (int(v) for v in payload.meta[0, :2])
    return JpegCoefficients(*payload.arrays, max(h, w)).to(dev).decode()[0, :h, :w, 0]


def pack_jpeg_batch_gray(buffers: Sequence[np.ndarray], pad_size: int, nthreads: Optional[int] = None,
                         device: DeviceLike = None) -> Optional[Tuple[torch.Tensor, np.ndarray, np.ndarray]]:
    """JPEG buffers decoded straight into a zero-padded (N, pad, pad, 1)
    uint8 batch on `device` (default: the card): (batch, heights, widths),
    heights and widths int32 on the host; None under `$NNTC_NO_NATIVE`."""
    dev = resolve_device(device)
    payload = entropy_decode(buffers, pad_size, nthreads)
    if payload is None:
        return None
    return payload.to(dev).decode(), payload.heights.copy(), payload.widths.copy()


def payload_bytes_bound(images: int, pad: int) -> int:
    """The most bytes a payload of `images` images in slots of `pad` holds:
    every coefficient of the 8-aligned slot (2 bytes a pixel), each block's
    start (4 bytes), the tables and the dims."""
    blocks = ((pad + 7) // 8) ** 2
    return images * (blocks * (64 * 2 + 4) + 64 * 4 + 4 * 4) + 4
