"""The yardstick's arithmetic against shapes worked out by hand: the
roofline bounds of K1-K3 and the model FLOPs of both configurations."""

import json
import os

import pytest

from portbench.harness import bounds

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_canvas_and_k1_bound_at_scale_two():
    import torch

    assert bounds.canvas_size(129, 30.0) == 225
    # one sample at |scale| 2: 448 rows and columns of the source (the footprint
    # 2 * 225 + 5 clipped to the frame), 6 parameters, a 129^2 f32 crop
    nbytes = 448 * 448 + 24 + 129 * 129 * 4
    ops = 225 * 448 * 5 * 2 + 225 * 225 * 5 * 2 + 9 * 225 * 225
    assert ops / bounds.F32_OPS_PER_S < nbytes / bounds.HBM_BYTES_PER_S
    got = bounds.k1_bound(torch.tensor([2.0]), torch.tensor([2.0]), 448, 129, 30.0)
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_k2_and_k3_bounds_at_the_step():
    assert bounds.k2_bound(64, 16641) == pytest.approx((2 * 64 * 16641 * 4 + 64 * 4) / 3.35e12, rel=1e-12)
    # 19 of 64 samples noised: bytes 2 x 64 x 16641 x 4 + 512 against 13 x 19 + 3 x 45 f32 and 50 x 19 integer
    # operations a pixel
    nbytes = 2 * 64 * 16641 * 4 + 512
    ops = (13 * 19 + 3 * 45) * 16641 / 67e12 + 50 * 19 * 16641 / 33.5e12
    assert bounds.k3_bound(19, 64, 16641) == pytest.approx(max(nbytes / 3.35e12, ops), rel=1e-12)


def _conv(c_in, c_out, k, stride, pad, h, groups=1):
    out = (h + 2 * pad - k) // stride + 1
    return 2 * (c_in // groups) * k * k * c_out * out * out, out


HEADS = 4 + 2 + 1 + 7 + 4 + 7 + 50  # box, xy, size, position neck, quaternion, its neck, shape parameters


def test_mobilenetv1_flops_by_hand():
    stem, h = _conv(1, 32, 5, 2, 2, 129)
    total, c = stem, 32
    for planes, stride in [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1), (512, 1),
                           (512, 1), (512, 1), (1024, 2), (1024, 1)]:
        dw, h = _conv(c, c, 3, stride, 1, h, groups=c)
        pw, _ = _conv(c, planes, 1, 1, 0, h)
        total, c = total + dw + pw, planes
    total += 2 * 1024 * HEADS
    config = json.load(open(os.path.join(ROOT, "portbench", "configs", "posenet-mobilenetv1.json")))
    assert bounds.model_flops_per_image(config) == pytest.approx(3 * total - stem, rel=1e-12)


def test_resnet18_flops_by_hand():
    stem, h = _conv(1, 64, 7, 2, 3, 129)
    h = (h + 2 - 3) // 2 + 1  # the max pool
    total, c = stem, 64
    for stage in range(4):
        planes = 64 * 2**stage
        for block in range(2):
            stride = 2 if stage > 0 and block == 0 else 1
            a, h2 = _conv(c, planes, 3, stride, 1, h)
            b, _ = _conv(planes, planes, 3, 1, 1, h2)
            total += a + b
            if stride != 1 or c != planes:
                total += _conv(c, planes, 1, stride, 0, h)[0]
            c, h = planes, h2
    total += 2 * 512 * HEADS
    config = json.load(open(os.path.join(ROOT, "portbench", "configs", "posenet-resnet18.json")))
    assert bounds.model_flops_per_image(config) == pytest.approx(3 * total - stem, rel=1e-12)
