"""K4 (`kernels/csrc/jpeg_idct.cu`) and K5 (`kernels/csrc/jpeg_huffman.cu`)
against their plain PyTorch versions and against cv2, on the card.

Marked `cuda`: it needs an NVIDIA GPU and `nvcc` (the kernels build at first
use) and skips without a card. On the machine with the card:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_jpeg_cuda.py`.
Tolerance: bit-equal. The payloads: noise at quality 1, 50 and 100, sizes
1 x 1 to 448 x 448, a 4:2:0 source with restart markers, colour 4:2:0,
4:2:2 and 4:4:0 sources and a file whose quantization tables were raised
after encoding, decoded into slots of 448 (a multiple of 8) and 453 (not),
into a fresh tensor and into row k of a stacked (K, B, pad, pad, 1) one,
and on flat blocks (slots of their DC alone) beside blocks with terms; K5
at three subsequence sizes and on the loader's marker, colour 4:2:0 and
noise frames at 448^2 (slots compared up to each block's length, with the
lengths, the status and the stats), and on scans that the host decoder
finds corrupt (the first fault in scan order across K5's sequences: the
host decoder's message, K5's status equal to its plain version's), also as
the loader's upload decodes them; the extension refuses CPU tensors.
"""

import struct

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch.data import native_loader as NL
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as K5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 and K5 are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _buffers():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)

    def enc(img, *p):
        return cv2.imencode(".jpg", img, list(p))[1].tobytes()

    out = [enc(rng.integers(0, 256, (123, 301), dtype=np.uint8), cv2.IMWRITE_JPEG_QUALITY, q) for q in (1, 50, 100)]
    out += [enc(rng.integers(0, 256, s, dtype=np.uint8)) for s in ((1, 1), (7, 9), (448, 448))]
    out.append(enc(rng.integers(0, 256, (97, 131, 3), dtype=np.uint8), cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    for sf in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440):
        out.append(enc(rng.integers(0, 256, (123, 301, 3), dtype=np.uint8), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf))
    raised = bytearray(enc(rng.integers(0, 256, (64, 80), dtype=np.uint8), cv2.IMWRITE_JPEG_QUALITY, 95))
    i = 2
    while raised[i + 1] != 0xDA:  # every 8-bit table entry of every DQT set to 255
        n = struct.unpack(">H", raised[i + 2:i + 4])[0]
        if raised[i + 1] == 0xDB:
            for t in range(n // 65):
                raised[i + 5 + 65 * t:i + 69 + 65 * t] = b"\xff" * 64
        i += 2 + n
    out.append(bytes(raised))
    return out, [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE) for b in out]


def _slots(payload):
    """The host entropy decoder's coefficients as K5's slots and lengths."""
    return K4.runs_to_slots(torch.as_tensor(payload.coeffs), torch.as_tensor(payload.block_start))


@pytest.mark.parametrize("pad", [448, 453])
def test_k4_is_bit_equal_to_its_plain_version_and_to_cv2(dev, pad):
    buffers, images = _buffers()
    payload = NL.entropy_decode(buffers, pad)
    slots, lens = (t.to(dev) for t in _slots(payload))
    qtables, meta = (torch.as_tensor(a).to(dev) for a in (payload.qtables, payload.meta))
    before = ext.LAUNCHES["jpeg_idct"]
    got = K4.idct_pack(slots, lens, qtables, meta, pad)
    assert ext.LAUNCHES["jpeg_idct"] == before + 1
    plain = K4.idct_pack_plain(slots, lens, qtables, meta, pad)
    torch.cuda.synchronize()
    assert got.shape == (len(buffers), pad, pad, 1) and torch.equal(got, plain)
    want = np.zeros((len(buffers), pad, pad, 1), np.uint8)
    for i, im in enumerate(images):
        want[i, :im.shape[0], :im.shape[1], 0] = im
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("pad", [448, 453])
def test_k4_takes_blocks_of_their_dc_alone_as_the_plain_version_does(dev, pad):
    """Flat 8 x 8 blocks (slots of length 1, K4's one-value path) beside
    blocks with terms, at sizes that cut the last blocks."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    bands = np.repeat(np.repeat(rng.integers(0, 256, (56, 56), dtype=np.uint8), 8, 0), 8, 1)
    mixed = bands.copy()
    mixed[::3, ::5] = rng.integers(0, 256, mixed[::3, ::5].shape, dtype=np.uint8)
    images = [bands, bands[:443, :437], mixed[:300, :201], np.full((9, 17), 200, np.uint8)]
    buffers = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
               for im, q in zip(images, (95, 75, 95, 50))]
    payload = NL.scan_batch(buffers, pad).to(dev)
    scan, intervals, tables, meta, qtables = payload.arrays
    blocks, ys, bits, nint = payload.counts
    slots, lens, status, _ = K5.huffman_decode(scan, intervals, tables, meta, blocks, ys, nint, bits)
    assert int((lens == 1).sum()) > blocks // 2 and int((lens > 1).sum()) > 0
    got = K4.idct_pack(slots, lens, qtables, meta, pad)
    plain = K4.idct_pack_plain(slots, lens, qtables, meta, pad)
    torch.cuda.synchronize()
    assert not bool(status.any()) and torch.equal(got, plain)
    for i, b in enumerate(buffers):
        im = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(got[i, :im.shape[0], :im.shape[1], 0].cpu().numpy(), im)
        assert not bool(got[i, im.shape[0]:].any()) and not bool(got[i, :, im.shape[1]:].any())


def test_k4_writes_row_k_of_a_stacked_batch(dev):
    buffers, _ = _buffers()
    payload = NL.scan_batch(buffers, 448).to(dev)
    stacked = torch.full((3, len(buffers), 448, 448, 1), 9, dtype=torch.uint8, device=dev)
    payload.decode(out=stacked[1])
    torch.cuda.synchronize()
    assert torch.equal(stacked[1], payload.decode()) and bool((stacked[0] == 9).all()) and bool((stacked[2] == 9).all())


@pytest.mark.parametrize("bits", [64, 1024, 1 << 30])
def test_k5_is_bit_equal_to_its_plain_version_and_to_the_host_decoder(dev, bits):
    buffers, images = _buffers()
    host = NL.scan_batch(buffers, 448)
    payload = host[np.asarray(list(range(len(buffers))) + [2, 0])]  # repeated images share the scans
    blocks, ys, nbits, nint = payload.counts
    args = [torch.as_tensor(a) for a in payload.arrays[:4]]
    before = ext.LAUNCHES["jpeg_huffman"]
    slots, lens, status, stats = K5.huffman_decode(*(a.to(dev) for a in args), blocks, ys, nint, nbits, bits)
    assert ext.LAUNCHES["jpeg_huffman"] == before + 1
    ps, pl, pst, pstats = K5.huffman_decode_plain(*args, blocks, ys, bits)
    torch.cuda.synchronize()
    within = torch.arange(64) < pl[:, None].long()
    assert torch.equal(lens.cpu(), pl) and torch.equal(torch.where(within, slots.cpu(), 0), ps)
    assert torch.equal(status.cpu(), pst) and not bool(pst.any()) and torch.equal(stats.cpu(), pstats)
    want, want_lens = _slots(NL.entropy_decode([buffers[i] for i in list(range(len(buffers))) + [2, 0]], 448))
    assert torch.equal(pl, want_lens) and torch.equal(ps, want)
    got = payload.to(dev).decode(subsequence_bits=bits).cpu().numpy()
    for i, im in enumerate(images + [images[2], images[0]]):
        np.testing.assert_array_equal(got[i, :im.shape[0], :im.shape[1], 0], im)


def _sos_end(b):
    i = b.index(b"\xff\xda")
    return i + 2 + ((b[i + 2] << 8) | b[i + 3])


@pytest.mark.parametrize("content", ["markers", "colour", "noise", "mixed"])
def test_k5_is_bit_equal_to_its_plain_version_on_the_loaders_frames(dev, content):
    """Phase 18's three kinds of frame at 448^2 (8 of each), and 7 marker
    frames with a noise frame, at the images' own layouts: K5 bit-equal to
    its plain version (slots up to each length, lengths, status, stats), to
    the host decoder and, with K4, to cv2."""
    cv2 = pytest.importorskip("cv2")
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames

    if content == "mixed":
        frames = jpeg_frames(7, 448, 5, dev), jpeg_frames(1, 448, 5, dev, "noise")
        buffers = [f.buffer(i) for f in frames for i in range(len(f))]
    else:
        frames = jpeg_frames(8, 448, 5, dev, content)
        buffers = [frames.buffer(i) for i in range(len(frames))]
    payload = NL.scan_batch(buffers, 448)
    blocks, ys, nbits, nint = payload.counts
    args = [torch.as_tensor(a) for a in payload.arrays[:4]]
    slots, lens, status, stats = K5.huffman_decode(*(a.to(dev) for a in args), blocks, ys, nint, nbits)
    ps, pl, pst, pstats = K5.huffman_decode_plain(*(a.to(dev) for a in args), blocks, ys)
    torch.cuda.synchronize()
    within = torch.arange(64, device=dev) < pl[:, None].long()
    assert torch.equal(lens, pl) and torch.equal(torch.where(within, slots, 0), ps)
    assert torch.equal(status, pst) and not bool(pst.any()) and torch.equal(stats, pstats)
    want, want_lens = _slots(NL.entropy_decode(buffers, 448))
    assert torch.equal(pl.cpu(), want_lens) and torch.equal(ps.cpu(), want)
    got = payload.to(dev).decode().cpu().numpy()
    for i, b in enumerate(buffers):
        im = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(got[i, :im.shape[0], :im.shape[1], 0], im)


def _corrupt(buffers):
    """Files the host decoder finds corrupt, each spanning many of K5's
    sequences: (name, bytes)."""
    out = []
    for i in (1, 6, 7):  # noise q50; a 4:2:0 source with restart markers; colour 4:2:0
        b = buffers[i]
        s = _sos_end(b)
        out.append((f"{i}: ends early", b[: s + (len(b) - s) // 2] + b"\xff\xd9"))
        out.append((f"{i}: ones", b[: s + 300] + b"\xff\x00" * 6 + b[s + 312:]))
    b = buffers[6]
    j = b.index(b"\xff\xd1")
    out.append(("6: an interval short of data", b[: j - 20] + b[j:]))
    out.append(("6: RST5 where RST1 is due", b.replace(b"\xff\xd1", b"\xff\xd5", 1)))
    s, far = _sos_end(b), len(b) * 3 // 4  # ones in two intervals far apart: faults in several of K5's CTAs
    out.append(("6: ones twice", b[: s + 300] + b"\xff\x00" * 6 + b[s + 312: far] + b"\xff\x00" * 6 + b[far + 12:]))
    return out


def test_k5_raises_the_host_decoders_faults_naming_the_image(dev):
    """The first fault in scan order, found across K5's sequences: the
    host decoder's message naming the frame, and K5's status (the fault's
    kind, symbol or marker and block) and stats equal to its plain
    version's."""
    buffers, _ = _buffers()
    good = buffers[0]
    for name, b in _corrupt(buffers):
        with pytest.raises(ValueError) as host:
            NL.entropy_decode([good, b, good], 320)
        payload = NL.scan_batch([good, b, good], 320, names=["frame 0", "frame 1 (index 9)", "frame 2"])
        with pytest.raises(ValueError) as card:
            payload.to(dev).decode()
        assert str(card.value) == str(host.value).replace("image 1 of 3", "frame 1 (index 9)"), name
        blocks, ys, nbits, nint = payload.counts
        args = [torch.as_tensor(a) for a in payload.arrays[:4]]
        _, _, status, stats = K5.huffman_decode(*(a.to(dev) for a in args), blocks, ys, nint, nbits, 64)
        _, _, pst, pstats = K5.huffman_decode_plain(*args, blocks, ys, 64)
        assert torch.equal(status.cpu(), pst) and torch.equal(stats.cpu(), pstats) and pst[1, 0] > 0, name
        _, T = K5.image_layout(args[3], nbits, 64)
        assert int(stats[1, 1]) > int(T[1]), name  # the image spans several sequences


def test_the_upload_raises_a_corrupt_scan_naming_its_frame(dev):
    """`device_prefetch` and `device_prefetch_stacked` read K5's status once
    the upload's event has completed and raise before handing the batch on."""
    from neuralnet_tracker_traincode_torch.data import loader as TL

    buffers, _ = _buffers()
    good = buffers[1]
    s = _sos_end(good)
    bad = good[: s + (len(good) - s) // 2] + b"\xff\xd9"
    payload = NL.scan_batch([good, bad], 320, names=["frame 0", "frame 1 (index 5)"])
    batch = {"image": payload, "pose": np.zeros((2, 4), np.float32)}
    with pytest.raises(ValueError, match=r"frame 1 \(index 5\): truncated or corrupt scan data: it runs into "
                                         r"marker 0xD9"):
        next(TL.device_prefetch(iter([batch]), device=dev))
    with pytest.raises(ValueError, match=r"frame 1 \(index 5\)"):
        next(TL.device_prefetch_stacked(iter([batch, batch]), device=dev, steps_per_dispatch=2))
    good_batch = {"image": NL.scan_batch([good, good], 320), "pose": np.zeros((2, 4), np.float32)}
    got = next(TL.device_prefetch(iter([good_batch]), device=dev))
    assert got["image"].shape == (2, 320, 320, 1)


def test_the_extension_refuses_cpu_tensors(dev):
    buffers, _ = _buffers()
    payload = NL.entropy_decode(buffers[:2], 320)
    slots, lens = _slots(payload)
    args = [slots, lens, torch.as_tensor(payload.qtables), torch.as_tensor(payload.meta)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ext.extension().jpeg_idct_pack(*args, torch.empty((2, 320, 320, 1), dtype=torch.uint8), 320)
    with pytest.raises(ValueError, match="CUDA"):
        K4.idct_pack(*(a.to(dev) for a in args[:3]), args[3], 320)
    scans = NL.scan_batch(buffers[:2], 320)
    with pytest.raises(ValueError, match="CUDA"):
        K5.huffman_decode(*(torch.as_tensor(a).to(dev) for a in scans.arrays[:3]), torch.as_tensor(scans.meta),
                          *scans.counts[:2], scans.counts[3], scans.counts[2])
