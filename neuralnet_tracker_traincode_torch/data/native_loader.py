"""JPEG decoding for the training loader (counterpart of the JAX package's
`data/native_loader.py`, which decodes with libjpeg on the host through
`native/nntc_loader.cpp`).

The decode runs on the card; the host only parses. `data/csrc/
jpeg_entropy.cpp` (standalone C++ with no libjpeg, built by `g++ -O3
-shared -fPIC` at first use into `.cache/torch_host/` and loaded through
ctypes) reads each file's markers, builds the Huffman decode tables (shared
across the batch where files share them) and unstuffs the scan that holds
Y, cut at its restart markers: `scan_batch` gives a `JpegScans` payload,
on a thread pool. On the card K5 (`kernels/jpeg_huffman.py`) decodes the
scans into each Y block's quantized coefficients and K4 (`kernels/jpeg.py`)
dequantizes them, runs libjpeg's integer IDCT and writes the range-limited
pixels into the zero-padded (N, pad, pad, 1) uint8 batch, bit-equal to
libjpeg's grayscale decode as cv2 and the JAX package run it. On the CPU the
same payload goes through their plain versions.

`entropy_decode` is the whole Huffman decode on the host (the split before
K5, `JpegCoefficients`): K5's oracle in the tests and on the card.

What the parse refuses raises a ValueError naming the image and the
marker: progressive, lossless and arithmetic-coded files, other than 8-bit
samples, 4 components, a subsampled Y and a 3-component file that libjpeg
reads as RGB. What only a decode finds in the scan (a code that matches
nothing, a run past the block, data that ends early, a restart marker out
of sequence; libjpeg warns and fills with zeros) K5 writes to a status word
an image, and `decode` raises it with the host decoder's message, naming
the image. A build failure raises too: nothing gives way to cv2 silently.
`$NNTC_NO_NATIVE=1`, as in the JAX module, is the one switch: then
`get_lib()` gives None, the functions here give None, and the loader
decodes with cv2 on the host (`decode_mode`).
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
from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as KH
from neuralnet_tracker_traincode_torch.kernels.jpeg import idct_pack, runs_to_slots
from neuralnet_tracker_traincode_torch.kernels.jpeg_huffman import huffman_decode, raise_for_status

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
    """The loader's JPEG decode: "device" (the host parses, K5 and K4 decode)
    or "host" (cv2); `$NNTC_NO_NATIVE` turns "device" into "host"."""
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
    """The host library (the parse and the entropy decoder), built on first
    use; None under `$NNTC_NO_NATIVE`."""
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
            lib.nntc_jpeg_scan_batch.restype = ctypes.c_int
            lib.nntc_jpeg_scan_batch.argtypes = [p, p, p, ctypes.c_int, p, p, p, p, ctypes.c_int, ctypes.c_char_p,
                                                 ctypes.c_int, p, ctypes.POINTER(ctypes.c_void_p)]
            lib.nntc_jpeg_scan_collect.restype = None
            lib.nntc_jpeg_scan_collect.argtypes = [p, p, p, p]
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

        return JpegCoefficients(*(_pin(a) for a in self.arrays), self.pad)

    def to(self, device, non_blocking: bool = False) -> "JpegCoefficients":
        return JpegCoefficients(*(torch.as_tensor(a).to(device, non_blocking=non_blocking) for a in self.arrays),
                                self.pad)

    def decode(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (N, pad, pad, 1) uint8 batch, on the arrays' device: the runs
        laid out as K5 lays its slots (`kernels/jpeg.py:runs_to_slots`), then
        K4 on a card, its plain version on the CPU (`out`: where to write
        it)."""
        coeffs, block_start, qtables, meta = (torch.as_tensor(a) for a in self.arrays)
        slots, lens = runs_to_slots(coeffs, block_start)
        return idct_pack(slots, lens, qtables, meta, self.pad, out=out)


def _bases(meta):
    """`meta` (numpy or a tensor) with each image's first block and first DC
    difference (M_FIRST_BLOCK, M_DC_BASE) set for its place in the batch,
    and the batch's counts: blocks, Y blocks in the scans, the scans' bits and
    their restart intervals."""
    host = torch.as_tensor(meta).detach().cpu().to(torch.int64)
    blocks = host[:, KH.M_GW] * host[:, KH.M_GH]
    ys = host[:, KH.M_MCUS_X] * host[:, KH.M_MCUS_Y] * host[:, KH.M_YH] * host[:, KH.M_YV]
    cols = torch.zeros((host.shape[0], 2), dtype=torch.int64)
    cols[:, 0] = torch.cumsum(blocks, 0) - blocks
    cols[:, 1] = torch.cumsum(ys, 0) - ys
    counts = (int(blocks.sum()), int(ys.sum()), int(host[:, KH.M_BITS].sum()), int(host[:, KH.M_INTERVALS].sum()))
    if isinstance(meta, np.ndarray):
        meta = meta.copy()
        meta[:, [KH.M_FIRST_BLOCK, KH.M_DC_BASE]] = cols.numpy()
    else:
        meta = meta.clone()
        meta[:, [KH.M_FIRST_BLOCK, KH.M_DC_BASE]] = cols.to(meta.device, meta.dtype)
    return meta, counts


class JpegScans:
    """A batch of parsed JPEGs, the input of K5 then K4 (the loader's JPEG
    payload): `scan` uint8, the unstuffed scans that hold Y, back to back on
    4-byte boundaries; `intervals` (NI, 4) int32, each restart interval's
    first and end bit in `scan`, the marker that ends its data and its image;
    `tables` (T, TABLE_WORDS) int32, the batch's distinct Huffman decode
    tables; `meta` (N, META_COLS) int32, each image's dims, MCU layout and
    tables (`kernels/jpeg_huffman.py`: M_*); `qtables` (N, 64) int32, Y's
    quantization tables in natural order; `pad`, the side of the zero-padded
    slot each image is decoded into; `names`, how an error names each image.
    The arrays are numpy arrays on the host or tensors (pinned, or on a
    device); `counts` (blocks, Y blocks, bits, intervals) sizes K5's output
    and scratch without a read-back.

    Indexing selects images (rows of the batch it decodes to); the selected
    images share the scans. `shape` is that of the decoded batch,
    (N, pad, pad, 1)."""

    __slots__ = ("scan", "intervals", "tables", "meta", "qtables", "pad", "names", "counts")

    def __init__(self, scan, intervals, tables, meta, qtables, pad: int, names: Optional[Sequence[str]] = None,
                 counts: Optional[Tuple[int, int, int, int]] = None):
        if counts is None:
            meta, counts = _bases(meta)
        self.scan, self.intervals, self.tables, self.meta, self.qtables = scan, intervals, tables, meta, qtables
        self.pad, self.counts = int(pad), tuple(counts)
        self.names = None if names is None else tuple(names)

    def __len__(self) -> int:
        return int(self.meta.shape[0])

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self), self.pad, self.pad, 1)

    @property
    def heights(self):
        return self.meta[:, KH.M_H]

    @property
    def widths(self):
        return self.meta[:, KH.M_W]

    @property
    def arrays(self):
        return self.scan, self.intervals, self.tables, self.meta, self.qtables

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) if hasattr(a, "nbytes") else a.numel() * a.element_size() for a in self.arrays)

    def _like(self, arrays, pad=None, names=None, counts=None):
        return JpegScans(*arrays, self.pad if pad is None else pad, self.names if names is None else names,
                         self.counts if counts is None else counts)

    def __getitem__(self, index) -> "JpegScans":
        if isinstance(index, (int, np.integer)):
            index = [int(index)]
        meta, counts = _bases(self.meta[index])
        names = None if self.names is None else list(np.asarray(self.names, dtype=object)[index])
        return JpegScans(self.scan, self.intervals, self.tables, meta, self.qtables[index], self.pad, names, counts)

    def with_pad(self, pad: int) -> "JpegScans":
        """The same images decoded into larger slots."""
        if pad < self.pad:
            raise ValueError(f"cannot shrink the padding from {self.pad} to {pad}")
        return self._like(self.arrays, pad=pad)

    def pinned(self) -> "JpegScans":
        """Pinned host tensors of the arrays (for an asynchronous upload);
        an array in pinned memory already is not copied."""
        return self._like([_pin(a) for a in self.arrays])

    def to(self, device, non_blocking: bool = False) -> "JpegScans":
        return self._like([torch.as_tensor(a).to(device, non_blocking=non_blocking) for a in self.arrays])

    def decode_async(self, out: Optional[torch.Tensor] = None,
                     subsequence_bits: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the (N, pad, pad, 1) uint8 batch, K5's status (N, 4) int32), on
        the arrays' device: K5 then K4 on a card, their plain versions on the
        CPU (K5's subsequences of `subsequence_bits`, by default each
        image's own: `image_layout`). On a card nothing is read
        back: a fault in a scan shows only in the status (`raise_for_status`),
        and the images are then not to be used; on the CPU the status is
        raised on at once."""
        scan, intervals, tables, meta, qtables = (torch.as_tensor(a) for a in self.arrays)
        blocks, ys, bits, nint = self.counts
        slots, lens, status, _ = huffman_decode(scan, intervals, tables, meta, blocks, ys, nint, bits,
                                                subsequence_bits)
        if not status.is_cuda:  # the plain versions: read at once, before K4's plain version checks the slots
            raise_for_status(status, self.names)
        return idct_pack(slots, lens, qtables, meta, self.pad, out=out), status

    def decode(self, out: Optional[torch.Tensor] = None, subsequence_bits: Optional[int] = None) -> torch.Tensor:
        """`decode_async`, then the status read and raised on (a ValueError
        naming the image, the host decoder's message)."""
        images, status = self.decode_async(out, subsequence_bits)
        raise_for_status(status, self.names)
        return images


def _pin(a):
    a = torch.as_tensor(a)
    if a.is_pinned():
        return a
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    out.copy_(a)
    return out


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


def scan_batch(buffers: Sequence[np.ndarray], pad_size: int, nthreads: Optional[int] = None,
               names: Optional[Sequence[str]] = None) -> Optional[JpegScans]:
    """Parse JPEG buffers on `nthreads` threads (default: the host's cores)
    into a `JpegScans` payload for slots of `pad_size`: the markers, the
    tables, the Y scan unstuffed and cut at its restart markers (no bit-level
    work); None under `$NNTC_NO_NATIVE`. Raises ValueError naming the image
    (`names[i]`, else its index) for what the decoder refuses and for an
    image larger than the slot; the faults in a scan (codes, runs, data that
    ends early, restart markers out of sequence) are the decode's to raise
    (`JpegScans.decode`), as a sequential decode meets them."""
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

    # each image's unstuffed scan is at most its file's length; room on 4-byte boundaries, 8 zero bytes after
    room = (lengths.astype(np.int64) + 3) // 4 * 4
    scan_offsets = np.zeros(n + 1, np.uintp)
    np.cumsum(room, out=scan_offsets[1:])
    total = int(scan_offsets[-1])
    if total * 8 >= 2**31:
        raise ValueError(f"JPEG decode: {total} bytes of scans in one batch exceed the payload's 32-bit bit offsets")
    scan = np.empty(total + 8, np.uint8)
    scan[total:] = 0
    meta = np.zeros((n, KH.META_COLS), np.int32)
    qtables = np.zeros((n, 64), np.int32)
    totals = np.zeros(2, np.int64)
    handle = ctypes.c_void_p()
    bad = lib.nntc_jpeg_scan_batch(blob.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, scan.ctypes.data,
                                   scan_offsets.ctypes.data, meta.ctypes.data, qtables.ctypes.data, threads, err,
                                   _ERRLEN, totals.ctypes.data, ctypes.byref(handle))
    if bad >= 0:
        raise ValueError(f"JPEG decode: {name(bad)}: {err.value.decode(errors='replace')}")
    intervals = np.empty((int(totals[0]), 4), np.int32)
    tables = np.empty((int(totals[1]), KH.TABLE_WORDS), np.int32)
    lib.nntc_jpeg_scan_collect(handle, scan_offsets.ctypes.data, intervals.ctypes.data, tables.ctypes.data)
    large = np.flatnonzero(meta[:, :2].max(1) > pad_size)
    if large.size:
        i = int(large[0])
        raise ValueError(f"JPEG decode: {name(i)} is {meta[i, 0]}x{meta[i, 1]}, larger than the padding {pad_size}")
    return JpegScans(scan, intervals, tables, meta, qtables, pad_size, names)


def decode_jpeg_gray(buffer: np.ndarray, device: DeviceLike = None) -> Optional[torch.Tensor]:
    """One JPEG buffer -> (H, W) uint8 grayscale on `device` (default: the
    card): parsed on the host, K5 and K4 on the card (their plain versions
    on the CPU); None under `$NNTC_NO_NATIVE`."""
    dev = resolve_device(device)
    payload = scan_batch([buffer], 1 << 16, nthreads=1)
    if payload is None:
        return None
    h, w = (int(v) for v in payload.meta[0, :2])
    return payload._like(payload.arrays, pad=max(h, w)).to(dev).decode()[0, :h, :w, 0]


def pack_jpeg_batch_gray(buffers: Sequence[np.ndarray], pad_size: int, nthreads: Optional[int] = None,
                         device: DeviceLike = None) -> Optional[Tuple[torch.Tensor, np.ndarray, np.ndarray]]:
    """JPEG buffers decoded straight into a zero-padded (N, pad, pad, 1)
    uint8 batch on `device` (default: the card): parsed on the host, K5 and
    K4 on the card (their plain versions on the CPU). Returns (batch,
    heights, widths), heights and widths int32 on the host; None under
    `$NNTC_NO_NATIVE`."""
    dev = resolve_device(device)
    payload = scan_batch(buffers, pad_size, nthreads)
    if payload is None:
        return None
    return payload.to(dev).decode(), payload.heights.copy(), payload.widths.copy()


# the ring slot's room for a batch's scans: bytes a pixel of its slots (the Y scan of a 448^2 grey q95 noise frame
# takes about 1.0, a colour 4:2:0 q95 photo well under that)
SCAN_BYTES_PER_PIXEL = 2


def payload_bytes_bound(images: int, pad: int) -> int:
    """The room a ring slot keeps for a `JpegScans` payload of `images`
    images in slots of `pad`: SCAN_BYTES_PER_PIXEL bytes of scan a pixel
    (with each file's 4-byte rounding and the 8 bytes after), and the
    intervals, tables, dims and quantization tables of files without
    restart markers. A batch past it is not cut: it goes through the
    worker's queue whole."""
    return (images * (SCAN_BYTES_PER_PIXEL * pad * pad + 4 + 16 + 4 * (KH.META_COLS + 64))
            + 8 * KH.TABLE_WORDS * 4 + 8)
