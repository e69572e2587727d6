"""The port's JPEG decode (`data/native_loader.py`: the host entropy decoder
`data/csrc/jpeg_entropy.cpp`, then K4's plain version `kernels/jpeg.py:
idct_pack_plain`) against libjpeg twice: `cv2.imdecode(..., 0)` and the JAX
package's `native_loader.decode_jpeg_gray` / `pack_jpeg_batch_gray`, on the
same buffers.

Tolerance: bit-equal (images, heights, widths). The set, made with numpy
from fixed seeds and encoded by cv2: noise at quality 1 to 100, sizes 1 x 1
to 448 x 448, grayscale, 4:4:4, 4:2:0, 4:2:2 and 4:4:0 sources, restart
intervals, optimized Huffman tables, 16-bit quantization tables, files whose
tables were raised after encoding (their intermediates leave 16 bits, where
libjpeg-turbo's SIMD arithmetic, which cv2 and the JAX package's libjpeg run
on x86-64, departs from jidctint.c's C: `kernels/jpeg.py`), and the marker frames
of `data/synthetic.py` at quality 95. What the decoder refuses raises a
ValueError naming the image; a truncated scan raises where libjpeg fills
zeros (the one deliberate difference).
"""

import os
import struct
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.data import native_loader as JN
from neuralnet_tracker_traincode_torch.data import native_loader as NL
from neuralnet_tracker_traincode_torch.kernels import jpeg as K4

cv2 = pytest.importorskip("cv2")


def _encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _segments(buf):
    """(marker, start, end) of each marker segment up to and including SOS."""
    out, i = [], 2
    while i < len(buf):
        assert buf[i] == 0xFF
        m = buf[i + 1]
        n = (buf[i + 2] << 8) | buf[i + 3]
        out.append((m, i, i + 2 + n))
        if m == 0xDA:
            break
        i += 2 + n
    return out


def raise_dqt(buf, value=255):
    """Every quantization table entry set to `value` after encoding."""
    b = bytearray(buf)
    for m, start, end in _segments(buf):
        j = start + 4
        while m == 0xDB and j < end:
            pq = b[j] >> 4
            for k in range(64):
                if pq:
                    b[j + 1 + 2 * k: j + 3 + 2 * k] = struct.pack(">H", value)
                else:
                    b[j + 1 + k] = value
            j += 1 + 64 * (pq + 1)
    return bytes(b)


def dqt16(buf, scale):
    """The quantization tables rewritten with 16-bit entries, each times `scale`."""
    out = bytearray(buf[:2])
    segs = _segments(buf)
    for m, start, end in segs:
        if m != 0xDB:
            out += buf[start:end]
            continue
        body, j = b"", start + 4
        while j < end:
            pq, tq = buf[j] >> 4, buf[j] & 15
            vals = [struct.unpack(">H", buf[j + 1 + 2 * k: j + 3 + 2 * k])[0] if pq else buf[j + 1 + k]
                    for k in range(64)]
            body += bytes([0x10 | tq]) + b"".join(struct.pack(">H", min(65535, v * scale)) for v in vals)
            j += 1 + 64 * (pq + 1)
        out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
    return bytes(out) + buf[segs[-1][2]:]


def without_app0(buf):
    segs = _segments(buf)
    return buf[:2] + b"".join(buf[s:e] for m, s, e in segs if m != 0xE0) + buf[segs[-1][2]:]


def with_sof(buf, marker=None, precision=None, ids=None, sampling=None):
    """The SOF0 segment changed: its marker, sample precision, component ids
    (the scan's selectors with them) or sampling bytes."""
    b = bytearray(buf)
    (start,) = [s for m, s, e in _segments(buf) if m == 0xC0]
    if marker is not None:
        b[start + 1] = marker
    if precision is not None:
        b[start + 4] = precision
    for i, v in enumerate(ids or ()):  # in the frame header and in each scan header
        old = b[start + 10 + 3 * i]
        b[start + 10 + 3 * i] = v
        for m, sos, _ in _segments(buf):
            for j in range(buf[sos + 4] if m == 0xDA else 0):
                if buf[sos + 5 + 2 * j] == old:
                    b[sos + 5 + 2 * j] = v
    for i, v in enumerate(sampling or ()):
        b[start + 11 + 3 * i] = v
    return bytes(b)


def adobe_transform_0(buf):
    """No JFIF APP0, an Adobe APP14 with transform 0: libjpeg reads RGB."""
    app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    b = without_app0(buf)
    return b[:2] + app14 + b[2:]


def _cases():
    rng = np.random.default_rng(20261017)
    noise = rng.integers(0, 256, (123, 301), dtype=np.uint8)
    color = rng.integers(0, 256, (123, 301, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:96, :128]
    smooth = np.clip(128 + 70 * np.sin(xx / 9.0) * np.cos(yy / 13.0), 0, 255).astype(np.uint8)
    # flat 8 x 8 blocks: the SIMD code's DC-only shortcut, with 16-bit overflow once the tables are raised
    bands = np.repeat(np.repeat(np.arange(96, 176, dtype=np.uint8).reshape(8, 10), 8, 0), 8, 1)
    c = {f"noise_q{q}": _encode(noise, cv2.IMWRITE_JPEG_QUALITY, q) for q in (1, 10, 50, 95, 99, 100)}
    for h, w in ((1, 1), (7, 9), (123, 301), (448, 448)):
        c[f"size_{h}x{w}"] = _encode(rng.integers(0, 256, (h, w), dtype=np.uint8), cv2.IMWRITE_JPEG_QUALITY, 90)
    for name, sf in (("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                     ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422), ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)):
        c[f"color_{name}"] = _encode(color, cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf)
    c["gray_rst1"] = _encode(noise, cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    c["gray_rst7"] = _encode(smooth, cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 7)
    c["color_420_rst3"] = _encode(color, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    c["optimized_huffman"] = _encode(noise, cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    c["dqt_raised_noise"] = raise_dqt(_encode(noise[:96, :128], cv2.IMWRITE_JPEG_QUALITY, 95))
    c["dqt_raised_smooth"] = raise_dqt(_encode(smooth, cv2.IMWRITE_JPEG_QUALITY, 50))
    c["dqt_raised_flat_blocks"] = raise_dqt(_encode(bands, cv2.IMWRITE_JPEG_QUALITY, 95))
    c["dqt16_x3"] = dqt16(_encode(smooth, cv2.IMWRITE_JPEG_QUALITY, 95), 3)
    c["dqt16_x300"] = dqt16(_encode(noise, cv2.IMWRITE_JPEG_QUALITY, 95), 300)
    c["jfif_with_rgb_ids"] = with_sof(_encode(color, cv2.IMWRITE_JPEG_QUALITY, 75), ids=b"RGB")  # JFIF: YCbCr
    return c


CASES = _cases()


def _marker_frames(n=4, size=160):
    from neuralnet_tracker_traincode_torch.data.synthetic import make_labels, render_marker_images

    _, coords, pt3d, _, _ = make_labels(n, size, seed=3, device="cpu")
    return [_encode(im, cv2.IMWRITE_JPEG_QUALITY, 95) for im in render_marker_images(pt3d, coords, size).numpy()]


def _cv2_gray(buf):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_is_bit_equal_to_libjpeg(name):
    buf = CASES[name]
    got = NL.decode_jpeg_gray(np.frombuffer(buf, np.uint8), device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    want = _cv2_gray(buf)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), JN.decode_jpeg_gray(np.frombuffer(buf, np.uint8)))


def test_batch_is_bit_equal_to_the_jax_native_pack():
    """One batch of every case and the marker frames at q95 (pad 448): images,
    heights and widths equal to the JAX package's threaded libjpeg pack."""
    buffers = [np.frombuffer(b, np.uint8) for b in list(CASES.values()) + _marker_frames()]
    got, h, w = NL.pack_jpeg_batch_gray(buffers, 448, nthreads=3, device="cpu")
    want, wh, ww = JN.pack_jpeg_batch_gray(buffers, 448, 3)
    assert got.shape == (len(buffers), 448, 448, 1) and got.dtype == torch.uint8
    np.testing.assert_array_equal(h, wh)
    np.testing.assert_array_equal(w, ww)
    np.testing.assert_array_equal(got.numpy(), want)


def test_marker_frames_equal_cv2():
    frames = _marker_frames(n=8)
    payload = NL.entropy_decode(frames, 192)
    assert payload.shape == (8, 192, 192, 1)
    got = payload.decode().numpy()
    for i, b in enumerate(frames):
        im = _cv2_gray(b)
        np.testing.assert_array_equal(got[i, :160, :160, 0], im)
        assert not got[i, 160:].any() and not got[i, :, 160:].any()


def _variant_pixels(payload, dequant16=True, sums16=True, saturate=True, wrap=False):
    """The plain decode with one of the SIMD lanes' 16-bit steps widened, or
    jidctint.c's range limit (the row pass's value read as a signed 10-bit
    number, `& RANGE_MASK`) in place of the saturation."""
    out = []
    for n, (h, w, gw, first) in enumerate(payload.meta.tolist()):
        gh = (h + 7) // 8
        raw = K4.dense_blocks(torch.as_tensor(payload.coeffs), torch.as_tensor(payload.block_start), first,
                              gw * gh).reshape(-1, 8, 8)
        dq = raw * torch.as_tensor(payload.qtables[n]).to(torch.int64).reshape(1, 8, 8)
        if dequant16:
            dq = K4._low16(dq)
        with mock.patch.object(K4, "_low16", K4._low16 if sums16 else (lambda x: x)):
            ws = K4._islow_pass(dq.transpose(1, 2), 11).transpose(1, 2)
            if saturate:
                ws = ws.clamp(-32768, 32767)
            dc_only = (raw[:, 1:, :] == 0).all(2).all(1)
            ws = torch.where(dc_only[:, None, None], K4._low16(dq[:, :1, :] * 4).expand_as(dq), ws)
            px = K4._islow_pass(ws, 18)
        if wrap:
            px = ((px & 1023) ^ 512) - 512
        px = (px.clamp(-128, 127) + 128).to(torch.uint8)
        out.append(px.reshape(gh, gw, 8, 8).permute(0, 2, 1, 3).reshape(gh * 8, gw * 8)[:h, :w].numpy())
    return out


def test_the_raised_tables_drive_every_16_bit_step():
    """The raised-table files reach every place where libjpeg-turbo's SIMD
    lanes, which cv2 runs, depart from jidctint.c's 64-bit C: widening any
    16-bit step, or jidctint.c's 10-bit range-limit wrap in place of the
    saturation, changes pixels that cv2 gives."""
    names = ("dqt_raised_noise", "dqt_raised_smooth", "dqt_raised_flat_blocks", "dqt16_x300")
    payload = NL.entropy_decode([CASES[n] for n in names], 320)
    want = [_cv2_gray(CASES[n]) for n in names]
    for got, w in zip(_variant_pixels(payload), want):
        np.testing.assert_array_equal(got, w)
    for change in ({"dequant16": False}, {"sums16": False}, {"saturate": False}, {"wrap": True}):
        differ = sum(int((g != w).sum()) for g, w in zip(_variant_pixels(payload, **change), want))
        assert differ > 100, (change, differ)


@pytest.mark.parametrize("name,buf,match", [
    ("progressive", lambda c: _encode(c, cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
    ("rgb_ids", lambda c: with_sof(without_app0(_encode(c)), ids=b"RGB"), "RGB"),
    ("adobe_transform_0", lambda c: adobe_transform_0(_encode(c)), "RGB"),
    ("twelve_bit", lambda c: with_sof(_encode(c), precision=12), "12-bit"),
    ("arithmetic", lambda c: with_sof(_encode(c), marker=0xC9), "arithmetic"),
    ("lossless", lambda c: with_sof(_encode(c), marker=0xC3), "lossless"),
    ("y_subsampled", lambda c: with_sof(_encode(c, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), sampling=(0x11, 0x22, 0x11)),
     "Y component"),
])
def test_unsupported_files_raise_naming_the_image(name, buf, match):
    color = np.random.default_rng(1).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    bad = buf(color)
    good = CASES["noise_q50"]
    with pytest.raises(ValueError, match=match) as e:
        NL.entropy_decode([good, good, bad], 64)
    assert "image 2 of 3" in str(e.value)


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_truncated_scans_raise_where_libjpeg_fills_zeros(cut):
    buf = CASES["noise_q95"]
    short = buf[: int(len(buf) * cut)]
    # libjpeg warns and decodes the rest as zero coefficients (flat gray); cv2 refuses the image
    filled = JN.decode_jpeg_gray(np.frombuffer(short, np.uint8))
    assert filled.shape == (123, 301) and (filled[-1] == 128).all()
    with pytest.raises(ValueError, match="truncated") as e:
        NL.entropy_decode([short], 320, names=["frame 7 (index 12)"])
    assert "frame 7 (index 12)" in str(e.value)


def test_corrupt_restart_markers_raise():
    buf = bytearray(CASES["gray_rst1"])
    i = buf.index(b"\xff\xd3")
    buf[i + 1] = 0xD5  # RST5 where RST3 is due
    with pytest.raises(ValueError, match="RST3"):
        NL.entropy_decode([bytes(buf)], 320)


def test_an_image_larger_than_the_slot_raises():
    with pytest.raises(ValueError, match="larger than the padding 64"):
        NL.entropy_decode([CASES["size_448x448"]], 64)


def test_the_host_library_names_no_libjpeg():
    includes = [line for line in open(NL._SRC).read().splitlines() if line.startswith("#include")]
    assert includes and not any("jpeg" in line for line in includes)
    assert not any("jpeg" in a for a in NL.BUILD_COMMAND if a.startswith("-l"))
    lib = NL.get_lib()
    assert lib is not None and os.path.isfile(NL._SO)
    ldd = subprocess.run(["ldd", NL._SO], capture_output=True, text=True)
    if ldd.returncode == 0:
        assert "libjpeg" not in ldd.stdout


def test_the_payload_selects_and_repads_images():
    payload = NL.entropy_decode([CASES["size_7x9"], CASES["noise_q50"], CASES["color_420"]], 320)
    full = payload.decode()
    picked = payload[np.asarray([2, 0, 0])]
    assert len(picked) == 3 and picked.coeffs is payload.coeffs
    np.testing.assert_array_equal(picked.decode().numpy(), full.numpy()[[2, 0, 0]])
    grown = payload[1:].with_pad(384).decode()
    assert grown.shape == (2, 384, 384, 1)
    np.testing.assert_array_equal(grown[:, :320, :320].numpy(), full[1:].numpy())
    assert not grown[:, 320:].any() and not grown[:, :, 320:].any()
    with pytest.raises(ValueError, match="shrink"):
        payload.with_pad(128)


def test_idct_pack_runs_the_plain_version_on_the_cpu_and_raises_elsewhere():
    payload = NL.entropy_decode([CASES["noise_q10"], CASES["size_1x1"]], 304)
    args = [torch.as_tensor(a) for a in payload.arrays]
    out = torch.full((2, 304, 304, 1), 7, dtype=torch.uint8)
    assert K4.idct_pack(*args, 304, out=out) is out
    assert torch.equal(out, K4.idct_pack_plain(*args, 304))
    assert not out[1, 1:].any() and not out[1, :, 1:].any()
    with pytest.raises(ValueError, match="CUDA"):
        K4.idct_pack(*(a.to("meta") for a in args), 304)
    with pytest.raises(ValueError, match="exceeds the padding"):
        K4.idct_pack_plain(*args, 128)


def test_nntc_no_native_selects_cv2(monkeypatch):
    monkeypatch.setenv("NNTC_NO_NATIVE", "1")
    assert NL.get_lib() is None and NL.entropy_decode([CASES["noise_q50"]], 320) is None
    assert NL.decode_mode("device") == "host" and NL.decode_mode("host") == "host"
    assert NL.decode_jpeg_gray(np.frombuffer(CASES["noise_q50"], np.uint8), device="cpu") is None
    monkeypatch.delenv("NNTC_NO_NATIVE")
    assert NL.decode_mode("device") == "device"
    with pytest.raises(ValueError):
        NL.decode_mode("gpu")


def test_the_thread_pool_gives_the_serial_decode():
    """More threads than cores and than images: the same payload as one
    thread, every time."""
    buffers = [CASES[n] for n in sorted(CASES) if n != "size_448x448"] * 3
    want = NL.entropy_decode(buffers, 320, nthreads=1)
    for _ in range(3):
        got = NL.entropy_decode(buffers, 320, nthreads=4 * (os.cpu_count() or 1))
        for a, b in zip(got.arrays, want.arrays):
            np.testing.assert_array_equal(a, b)
