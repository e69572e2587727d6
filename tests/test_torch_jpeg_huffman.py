"""K5's plain version (`kernels/jpeg_huffman.py:huffman_decode_plain`: the
subsequence synchronization, block counting, decode and DC scan of
`kernels/csrc/jpeg_huffman.cu`, in lockstep PyTorch ops) and the host's
parse that feeds it (`data/native_loader.py:scan_batch`,
`data/csrc/jpeg_entropy.cpp:nntc_jpeg_scan_batch`), on the seeded set of
`tests/test_torch_jpeg.py` (`CASES`: grey, 4:4:4, 4:2:0, 4:2:2, 4:4:0,
restart intervals 1, 7 and 3 (4:2:0), optimized Huffman tables, 1 x 1 to
448 x 448).

Tolerance: exact. K5 against the host entropy decoder (`entropy_decode`,
libjpeg's order of operations): each kept Y block's coefficients up to its
length and the lengths, at subsequences of 64 bits (the larger scans span
many of the kernel's sequences; thousands of head re-decodes on the noise
cases), 256, 2,048 and, on the small cases, the whole scan (the sequential
decode), and at sequences shortened to 1, 3 and 16 subsequences; K5 then
K4 against the JAX package's libjpeg pack, bit for bit; what the host
decoder refuses raises the same message at the parse, and what it finds
corrupt (codes, runs, truncations, restart markers) the same message at the
decode, naming the image.
"""

import os

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.data import native_loader as JN
from neuralnet_tracker_traincode_torch.data import native_loader as NL
from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as K5
from test_torch_jpeg import CASES, _encode, _marker_frames

cv2 = pytest.importorskip("cv2")

NAMES = sorted(CASES)


@pytest.fixture(scope="module")
def one_thread():
    """The plain version's steps are many small ops: one intra-op thread
    runs them fastest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decode(payload, bits):
    return K5.huffman_decode_plain(*(torch.as_tensor(a) for a in payload.arrays[:4]), *payload.counts[:2], bits)


def _host_slots(buffers, pad):
    ref = NL.entropy_decode(buffers, pad)
    return K4.runs_to_slots(torch.as_tensor(ref.coeffs), torch.as_tensor(ref.block_start))


def _within(slots, lens):
    return torch.where(torch.arange(64) < lens[:, None].long(), slots, 0)


# the cases whose decode at 64-bit subsequences or at one subsequence an interval is short: small scans, or short
# restart intervals
SMALL = [n for n in NAMES if len(CASES[n]) < 10000 or "rst" in n]


@pytest.mark.parametrize("bits", [64, 256, 2048, 1 << 30])
def test_plain_k5_gives_the_host_decoders_coefficients_on_every_case(one_thread, bits):
    """Every case at 256 and 2,048 bits; the small cases at 64 bits (the
    larger of them span several of the kernel's sequences) and at one
    subsequence an interval (the sequential decode)."""
    names = SMALL if bits in (64, 1 << 30) else NAMES
    buffers = [CASES[n] for n in names]
    payload = NL.scan_batch(buffers, 448)
    slots, lens, status, stats = _decode(payload, bits)
    want, want_lens = _host_slots(buffers, 448)
    assert not bool(status.any())
    assert torch.equal(lens, want_lens)
    assert torch.equal(_within(slots, lens), want)
    passes, subs, codewords = stats.long().unbind(1)
    assert bool((passes >= 2).all())
    assert bool((codewords >= 2 * torch.as_tensor(payload.meta[:, K5.M_GW] * payload.meta[:, K5.M_GH])).all())
    if bits >= 1 << 30:  # one subsequence an interval: nothing to synchronize
        assert bool((passes == 2).all())
        assert torch.equal(subs, torch.as_tensor(payload.meta[:, K5.M_INTERVALS]).long())
    else:
        noise = names.index("noise_q95" if "noise_q95" in names else "noise_q10")
        assert int(passes[noise]) > 2
        if bits == 64:  # a scan that spans several sequences
            _, threads = K5.image_layout(torch.as_tensor(payload.meta), None, bits)
            noise = names.index("noise_q10")
            assert int(subs[noise]) > 4 * int(threads[noise])


@pytest.mark.parametrize("seq,bits", [(1, 256), (3, 128), (16, 64)])
def test_plain_k5_holds_across_short_sequences(one_thread, monkeypatch, seq, bits):
    """Sequences of 1, 3 and 16 subsequences (the kernel's are 32 or 128:
    `image_layout`) put sequence boundaries inside the marker frames' and
    the noise's long unsynchronized runs: the chain's head re-decodes, from a
    predecessor's tentative exit and again from its final one, still give
    the host decoder's coefficients. With one subsequence a sequence, a
    sequence's passes are 2, so the passes past 2 are the head re-decodes:
    more than one a chained sequence means some boundary fell inside a run
    that had not synchronized within its predecessor."""
    layout = K5.image_layout

    def short(meta, bits_total=None, subsequence_bits=None):
        S, _ = layout(meta, bits_total, subsequence_bits)
        return S, torch.full_like(S, seq)

    monkeypatch.setattr(K5, "image_layout", short)
    buffers = _marker_frames(2) + [CASES["noise_q10"]]
    payload = NL.scan_batch(buffers, 448)
    slots, lens, status, stats = _decode(payload, bits)
    want, want_lens = _host_slots(buffers, 448)
    assert not bool(status.any()) and torch.equal(lens, want_lens) and torch.equal(_within(slots, lens), want)
    passes, subs, _ = stats.long().unbind(1)
    assert bool((subs > 4 * seq).all())  # several sequences an image
    if seq == 1:
        heads = passes - 2
        assert bool((heads > subs - 1).any())


def test_plain_k5_then_plain_k4_equal_the_jax_native_pack(one_thread):
    """A batch of every case and the marker frames (pad 448), some images
    selected twice (they share the scans), through `JpegScans.decode` at
    256-bit subsequences: images, heights and widths equal the JAX
    package's threaded libjpeg pack."""
    buffers = [np.frombuffer(b, np.uint8) for b in [CASES[n] for n in NAMES] + _marker_frames()]
    order = list(range(len(buffers))) + [3, 0]
    payload = NL.scan_batch(buffers, 448, nthreads=3)[np.asarray(order)]
    got = payload.decode(subsequence_bits=256)
    want, wh, ww = JN.pack_jpeg_batch_gray([buffers[i] for i in order], 448, 3)
    assert got.shape == (len(order), 448, 448, 1) and got.dtype == torch.uint8
    np.testing.assert_array_equal(payload.heights, wh)
    np.testing.assert_array_equal(payload.widths, ww)
    np.testing.assert_array_equal(got.numpy(), want)


def _scan_start(buf):
    sos = buf.index(b"\xff\xda")
    return sos + 2 + ((buf[sos + 2] << 8) | buf[sos + 3])


def _corrupt():
    """Files whose scan data the host decoder finds corrupt: (name, bytes)."""
    out = []
    for case in ("noise_q50", "color_420", "gray_rst1", "optimized_huffman"):
        b = CASES[case]
        s = _scan_start(b)
        out.append((f"{case}: ends early (EOI)", b[: s + (len(b) - s) // 2] + b"\xff\xd9"))
        out.append((f"{case}: ones", b[: s + 200] + b"\xff\x00" * 8 + b[s + 216:]))
    b = bytearray(CASES["color_420_rst3"])
    i = b.index(b"\xff\xd2")
    out.append(("color_420_rst3: an interval short of data", bytes(b[: i - 20]) + bytes(b[i:])))
    out.append(("noise_q50: no EOI", CASES["noise_q50"][:-2]))
    b = CASES["gray_rst1"]
    out.append(("gray_rst1: ends before RST3", b[: b.index(b"\xff\xd3")]))
    out.append(("gray_rst1: RST5 where RST3 is due", b.replace(b"\xff\xd3", b"\xff\xd5", 1)))
    return out


@pytest.mark.parametrize("name,buf", _corrupt(), ids=[n for n, _ in _corrupt()])
@pytest.mark.parametrize("bits", [64, 256, 1024])
def test_a_corrupt_scan_raises_the_host_decoders_message_naming_the_image(one_thread, name, buf, bits):
    """Between two sound noise scans. The larger corrupt scans span tens of
    the kernel's sequences at 64 and 256 bits; the first fault in scan order
    is the host decoder's. At 64 and 1,024 bits through `JpegScans.decode`;
    at 256 from the status (`raise_for_status`, as `JpegScans.decode` raises
    it), the sound images' status clean."""
    good = CASES["noise_q10"]
    with pytest.raises(ValueError) as host:
        NL.entropy_decode([good, buf, good], 320)
    payload = NL.scan_batch([good, buf, good], 320, names=["frame 0", "frame 1 (index 41)", "frame 2"])
    if bits == 256:
        _, _, status, _ = _decode(payload, bits)
        assert status[1, 0] > 0 and not bool(status[[0, 2]].any())
        with pytest.raises(ValueError) as card:
            K5.raise_for_status(status, payload.names)
    else:
        with pytest.raises(ValueError) as card:
            payload.decode(subsequence_bits=bits)
    assert str(card.value) == str(host.value).replace("image 1 of 3", "frame 1 (index 41)")


def test_an_image_far_larger_than_the_batchs_mean_takes_its_own_layout(one_thread):
    """A dense scan among flat frames (noise at q95 beside marker frames):
    each takes the layout it takes in a batch of its own kind (`image_layout`:
    the flat frames 32 subsequences of 64 bits, the dense one 128 of 256),
    not the mixed batch's mean's, so that the dense scan's sequences stay
    longer than its synchronization distance; the decode equals the host
    decoder's and each image's subsequences follow its own S."""
    flat, dense = _marker_frames(4), CASES["noise_q95"]
    alone = [K5.image_layout(torch.as_tensor(NL.scan_batch(b, 448).meta)) for b in (flat, [dense])]
    buffers = flat + [dense]
    payload = NL.scan_batch(buffers, 448)
    S, T = K5.image_layout(torch.as_tensor(payload.meta))
    assert S.tolist() == alone[0][0].tolist() + alone[1][0].tolist() == [64] * 4 + [256]
    assert T.tolist() == alone[0][1].tolist() + alone[1][1].tolist() == [32] * 4 + [128]
    blocks, ys, bits, nint = payload.counts
    mean = K5.auto_subsequence_bits(bits, len(buffers)), K5.sequence_threads(bits, len(buffers))
    assert mean == (256, 32)  # the batch's mean scan's layout, which neither kind takes
    slots, lens, status, stats = _decode(payload, None)
    want, want_lens = _host_slots(buffers, 448)
    assert not bool(status.any()) and torch.equal(lens, want_lens) and torch.equal(_within(slots, lens), want)
    m = torch.as_tensor(payload.meta).long()
    assert bool((stats[:, 1].long() >= m[:, K5.M_BITS] // S).all())
    assert bool((stats[:, 1].long() <= m[:, K5.M_BITS] // S + m[:, K5.M_INTERVALS]).all())


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_a_truncated_file_raises_the_host_decoders_message(cut):
    """The file ends inside its scan: the parse takes what there is and the
    decode raises what the host decoder raises (libjpeg would fill the rest
    with zeros)."""
    buf = CASES["noise_q95"][: int(len(CASES["noise_q95"]) * cut)]
    with pytest.raises(ValueError, match="truncated") as host:
        NL.entropy_decode([buf], 320, names=["frame 7 (index 12)"])
    payload = NL.scan_batch([buf], 320, names=["frame 7 (index 12)"])
    with pytest.raises(ValueError, match="truncated") as card:
        payload.decode()
    assert str(card.value) == str(host.value)


@pytest.mark.parametrize("make,match", [
    (lambda c: _encode(c, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
    (lambda c: _encode(c)[:2] + b"\xff\xc9" + _encode(c)[4:], "arithmetic"),
    (lambda c: b"\x00" + _encode(c), "SOI"),
])
def test_refused_files_raise_the_same_message_at_the_parse(make, match):
    color = np.random.default_rng(1).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    bad = make(color)
    with pytest.raises(ValueError, match=match) as host:
        NL.entropy_decode([CASES["noise_q50"], bad], 64)
    with pytest.raises(ValueError, match=match) as parse:
        NL.scan_batch([CASES["noise_q50"], bad], 64)
    assert str(parse.value) == str(host.value) and "image 1 of 2" in str(parse.value)


def test_the_parse_unstuffs_the_scan_and_cuts_it_at_its_restart_markers():
    buf = CASES["gray_rst7"]
    payload = NL.scan_batch([buf], 320)
    start = _scan_start(buf)
    body = buf[start:buf.rindex(b"\xff\xd9")]
    intervals = payload.intervals
    assert len(intervals) == int(payload.meta[0, K5.M_INTERVALS]) > 1
    # the intervals' bytes back to back: the data without its restart markers, 0xFF00 read as 0xFF
    data, i = bytearray(), 0
    while i < len(body):
        if body[i] == 0xFF:
            if body[i + 1] == 0:
                data.append(0xFF)
            i += 2
            continue
        data.append(body[i])
        i += 1
    scan = bytes(payload.scan)
    got = b"".join(scan[a // 8:e // 8] for a, e, _, _ in intervals.tolist())
    assert got == bytes(data)
    assert [m for _, _, m, _ in intervals.tolist()] == [0xD0 + i % 8 for i in range(len(intervals) - 1)] + [0xD9]


def test_the_batch_shares_its_decode_tables():
    """cv2 writes Annex K's tables into every file: a batch of its colour
    files carries 4 decode tables, and optimized tables add their own."""
    colour = [CASES[n] for n in ("color_420", "color_444", "color_422", "color_440", "color_420_rst3")]
    assert NL.scan_batch(colour, 320).tables.shape == (4, K5.TABLE_WORDS)
    assert NL.scan_batch(colour + [CASES["optimized_huffman"]], 320).tables.shape[0] == 6


def test_the_payload_selects_repads_pins_and_moves():
    payload = NL.scan_batch([CASES["size_7x9"], CASES["noise_q50"], CASES["color_420"]], 320,
                            names=["a", "b", "c"])
    full = payload.decode()
    picked = payload[np.asarray([2, 0, 0])]
    assert len(picked) == 3 and picked.scan is payload.scan and picked.names == ("c", "a", "a")
    assert picked.counts[0] == 2 * int(payload.meta[0, K5.M_GW] * payload.meta[0, K5.M_GH]) + int(
        payload.meta[2, K5.M_GW] * payload.meta[2, K5.M_GH])
    np.testing.assert_array_equal(picked.decode().numpy(), full.numpy()[[2, 0, 0]])
    grown = payload[1:].with_pad(384).decode()
    assert grown.shape == (2, 384, 384, 1)
    np.testing.assert_array_equal(grown[:, :320, :320].numpy(), full[1:].numpy())
    assert not grown[:, 320:].any() and not grown[:, :, 320:].any()
    with pytest.raises(ValueError, match="shrink"):
        payload.with_pad(128)
    moved = payload.to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in moved.arrays) and moved.counts == payload.counts
    assert torch.equal(moved.decode(), full)
    assert payload.nbytes == sum(a.nbytes for a in payload.arrays)


def test_huffman_decode_runs_the_plain_version_on_the_cpu_and_raises_elsewhere():
    payload = NL.scan_batch([CASES["noise_q10"], CASES["color_420"]], 320)
    args = [torch.as_tensor(a) for a in payload.arrays[:4]]
    blocks, ys, bits, nint = payload.counts
    got = K5.huffman_decode(*args, blocks, ys, nint, bits, 512)
    want = K5.huffman_decode_plain(*args, blocks, ys, 512)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        K5.huffman_decode(*(a.to("meta") for a in args), blocks, ys, nint, bits)
    with pytest.raises(ValueError, match="shapes"):
        K5.huffman_decode(args[0], args[1][:, :3], *args[2:], blocks, ys, nint, bits)


def test_the_thread_pool_gives_the_serial_parse():
    buffers = [CASES[n] for n in NAMES if n != "size_448x448"] * 3
    want = NL.scan_batch(buffers, 320, nthreads=1)
    for _ in range(3):
        got = NL.scan_batch(buffers, 320, nthreads=4 * (os.cpu_count() or 1))
        for a, b in zip(got.arrays, want.arrays):
            np.testing.assert_array_equal(a, b)


def test_the_subsequence_size_follows_the_batchs_mean_scan():
    """Sequences of about an eighth of the mean image's scan, 128
    subsequences where that leaves 256 bits or more a subsequence, else 32:
    64 flat frames at 448^2 (~5 KB a scan), colour 4:2:0 photos (~64 KB),
    noise (~200 KB) take 32 x 128, 128 x 512 and 128 x 2,048 bits; the
    decode's result does not depend on it (the tests above run several
    sizes). Each image of a batch of like images takes this layout
    (`image_layout`). The kernel's scratch follows from the same counts,
    with no read-back."""
    n = 64
    for kb, threads, bits in ((1, 32, 64), (5, 32, 128), (64, 128, 512), (200, 128, 2048), (2000, 128, 8192)):
        assert (K5.sequence_threads(n * kb * 8192, n), K5.auto_subsequence_bits(n * kb * 8192, n)) == (threads, bits)
    assert (K5.sequence_threads(0, 0), K5.auto_subsequence_bits(0, 0)) == (32, 64)
    payload = NL.scan_batch([CASES["noise_q10"], CASES["size_1x1"]], 320)
    blocks, ys, bits, nint = payload.counts
    args = [torch.as_tensor(a) for a in payload.arrays[:4]]
    want = K5.huffman_decode_plain(*args, blocks, ys)
    for a, b in zip(K5.huffman_decode(*args, blocks, ys, nint, bits), want):
        assert torch.equal(a, b)
    _, T = K5.image_layout(args[3], bits)
    subs = K5.subsequences_bound(2, nint, bits)
    assert int(want[3][:, 1].sum()) <= subs
    assert K5.sequences_bound(2, subs) >= int(((want[3][:, 1].long() + T - 1) // T).sum())


def test_the_build_log_gives_k5s_ptxas_lines(tmp_path, monkeypatch):
    """`ext.ptxas_summary` reads each named kernel's registers, stack and
    spills and shared memory from the extension's build log (nvcc's
    `-Xptxas=-v` lines as ninja prints them), and nothing from a log of a
    build that compiled nothing."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    log = tmp_path / "build.log"
    log.write_text(
        "[3/7] /usr/local/cuda/bin/nvcc ... -c jpeg_huffman.cu -o jpeg_huffman.cuda.o\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126jpeg_huffman_decode_kernelEPKj' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_126jpeg_huffman_decode_kernelEPKj\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers, 31744 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117jpeg_huffman_prepEPKi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117jpeg_huffman_prepEPKi\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 1040 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z10warp_rotatePKh' for 'sm_90a'\n"
        "ptxas info    : Used 90 registers, used 1 barriers, 400 bytes cmem[0]\n")
    monkeypatch.setattr(ext, "BUILD_LOG", str(log))
    got = ext.ptxas_summary(("jpeg_huffman_prep", "jpeg_huffman_decode_kernel", "jpeg_huffman_finish"))
    assert got == [
        "jpeg_huffman_prep: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 40 registers, used 1 "
        "barriers, 1040 bytes smem, 400 bytes cmem[0]",
        "jpeg_huffman_decode_kernel: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 64 "
        "registers, used 1 barriers, 31744 bytes smem, 400 bytes cmem[0]"]
    log.write_text("ninja: no work to do.\n")
    assert ext.ptxas_summary(("jpeg_huffman_prep",)) == []
