"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and `nvcc` (the kernels build at first
use) and skip without a card. On the machine with the card:
`python -m pytest -m cuda tests/test_torch_kernels_cuda.py`.
Tolerances as in `chip_smoke.py`: K1 max 0.02 / mean 0.002 gray, K2
bit-equal, K3 bits bit-equal and output 1e-6.
"""

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch.kernels import equalize as K2
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import noise as K3
from neuralnet_tracker_traincode_torch.kernels import warp as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (8, 448, 448), generator=g, dtype=torch.uint8)
    lo = 60 + 40 * torch.rand(8, 2, generator=g)
    roi = torch.cat([lo, lo + 280], -1)
    roi[1] = roi[1][[2, 1, 0, 3]]  # a folded flip
    ang = (torch.rand(8, generator=g) - 0.5)
    for skip in (False, True):
        ref = K1.warp_roi_rotate(img, roi, ang, 129, 30.0, skip)
        out = K1.warp_roi_rotate(img.to(dev), roi.to(dev), ang.to(dev), 129, 30.0, skip).cpu()
        d = (out - ref).abs()
        assert d.max() < 0.02 and d.mean() < 0.002, (d.max(), d.mean())


def test_k2_kernel_is_bit_equal_to_plain(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(16, 129 * 129, generator=g) ** (0.3 + 2 * torch.rand(16, 1, generator=g))
    x[0] = 0.3
    gate = torch.rand(16, generator=g) < 0.7
    assert torch.equal(K2.equalize(x.to(dev), gate.to(dev)).cpu(), K2.equalize(x, gate))


def test_k3_kernels_match_plain(dev):
    g = torch.Generator().manual_seed(2)
    x = torch.rand(8, 129, 129, generator=g)
    seeds = torch.arange(8, dtype=torch.int32) + 77
    sigma = torch.rand(8, generator=g) * 0.3
    out = K3.add_gaussian_noise(x.to(dev), seeds.to(dev), sigma.to(dev)).cpu()
    assert (out - K3.add_gaussian_noise(x, seeds, sigma)).abs().max() <= 1e-6
    b1, b2 = K3.philox_bits(seeds, 129 * 129)
    b1, b2 = b1.reshape(x.shape), b2.reshape(x.shape)
    out = K3.add_gaussian_noise_from_bits(x.to(dev), b1.to(dev), b2.to(dev), sigma.to(dev)).cpu()
    assert (out - K3.add_gaussian_noise_from_bits(x, b1, b2, sigma)).abs().max() <= 1e-6


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(dev):
    ext.reset_launch_counts()
    x = torch.rand(2, 64, device=dev)
    K2.equalize(x, torch.ones(2, dtype=torch.bool, device=dev))
    assert ext.LAUNCHES["equalize"] == 1
    with pytest.raises(TypeError):
        K2.equalize(x.double(), torch.ones(2, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        K2.equalize(x.t(), torch.ones(64, dtype=torch.bool, device=dev))
    assert ext.LAUNCHES["equalize"] == 1
    np.testing.assert_array_equal(sorted(ext.LAUNCHES), sorted(["warp_roi_rotate", "equalize", "gaussian_noise",
                                                               "gaussian_noise_from_bits"]))
