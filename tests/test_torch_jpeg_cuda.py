"""K4 (`kernels/csrc/jpeg_idct.cu`) against its plain PyTorch version and
against cv2, on the card.

Marked `cuda`: it needs an NVIDIA GPU and `nvcc` (the kernels build at first
use) and skips without a card. On the machine with the card:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_jpeg_cuda.py`.
Tolerance: bit-equal. The payloads: noise at quality 1, 50 and 100, sizes
1 x 1 to 448 x 448, a 4:2:0 source with restart markers and a file whose
quantization tables were raised after encoding, decoded into slots of 448
(a multiple of 8) and 453 (not), into a fresh tensor and into row k of a
stacked (K, B, pad, pad, 1) one; the extension refuses CPU tensors.
"""

import struct

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch.data import native_loader as NL
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import jpeg as K4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 is CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _buffers():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)

    def enc(img, *p):
        return cv2.imencode(".jpg", img, list(p))[1].tobytes()

    out = [enc(rng.integers(0, 256, (123, 301), dtype=np.uint8), cv2.IMWRITE_JPEG_QUALITY, q) for q in (1, 50, 100)]
    out += [enc(rng.integers(0, 256, s, dtype=np.uint8)) for s in ((1, 1), (7, 9), (448, 448))]
    out.append(enc(rng.integers(0, 256, (97, 131, 3), dtype=np.uint8), cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
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


@pytest.mark.parametrize("pad", [448, 453])
def test_k4_is_bit_equal_to_its_plain_version_and_to_cv2(dev, pad):
    buffers, images = _buffers()
    payload = NL.entropy_decode(buffers, pad).to(dev)
    before = ext.LAUNCHES["jpeg_idct"]
    got = payload.decode()
    assert ext.LAUNCHES["jpeg_idct"] == before + 1
    plain = K4.idct_pack_plain(*payload.arrays, pad)
    torch.cuda.synchronize()
    assert got.shape == (len(buffers), pad, pad, 1) and torch.equal(got, plain)
    want = np.zeros((len(buffers), pad, pad, 1), np.uint8)
    for i, im in enumerate(images):
        want[i, :im.shape[0], :im.shape[1], 0] = im
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_k4_writes_row_k_of_a_stacked_batch(dev):
    buffers, _ = _buffers()
    payload = NL.entropy_decode(buffers, 448).to(dev)
    stacked = torch.full((3, len(buffers), 448, 448, 1), 9, dtype=torch.uint8, device=dev)
    payload.decode(out=stacked[1])
    torch.cuda.synchronize()
    assert torch.equal(stacked[1], payload.decode()) and bool((stacked[0] == 9).all()) and bool((stacked[2] == 9).all())


def test_the_extension_refuses_cpu_tensors(dev):
    buffers, _ = _buffers()
    payload = NL.entropy_decode(buffers[:2], 320)
    args = [torch.as_tensor(a) for a in payload.arrays]
    with pytest.raises(RuntimeError, match="CUDA"):
        ext.extension().jpeg_idct_pack(*args, torch.empty((2, 320, 320, 1), dtype=torch.uint8), 320)
    with pytest.raises(ValueError, match="CUDA"):
        K4.idct_pack(*(a.to(dev) for a in args[:3]), args[3], 320)
