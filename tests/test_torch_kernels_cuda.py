"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA GPU and `nvcc` (the kernels build at first
use) and skip without a card. On the machine with the card:
`python -m pytest -m cuda tests/test_torch_kernels_cuda.py`.
Tolerances as in `chip_smoke.py`: K1 max 0.02 / mean 0.002 gray, K2
bit-equal, K3 bits bit-equal and output 1e-6. K1 runs at the main path's
shapes (B = 64, 448^2 -> 129^2) with every fold, +-30 degrees, a minifying,
a magnifying and a partly outside ROI, and with `skip_rotation`. K2 runs
at B = 64, 129^2 and at odd P, with one-bin
and two-bin images, gates mixed, all off and all on, and from an input 4
bytes off 16-byte alignment. K3 runs with sigma 0 and > 0 mixed, at
offsets 0 and -0.5. Both run at the localizer's shape too, (64, 224 x 288),
with the gates and sigmas drawn as its augmentation draws them and all on.
K3b (injected bits) at B in {1, 7, 64} and P from 1 to 224 x 288, sigma
mixed with zeros, the bits' high 8 bits set, from misaligned inputs; its
sigma 0 samples bit-equal to clip(x) whatever their bits.
The training step's CUDA graph (`PoseTrainer.train_step_multi`) at a small
width: its replays bit-equal to the eager steps, and to the replays of the
graph captured with the tracer's stamps (`train/tracing.py`), whose ring
holds each block's stamps in order; the pose heads' kernels launched once
a step each. The stamp kernel fills and wraps its ring.
The pose heads' kernels (`kernels/heads.py`) against the plain Function on
the card at B in {1, 7, 64, 512}, forward and every gradient, with and
without the scales and with gradients left out: each output within 1e-5 of
its largest value, each gradient within 5e-5. Not bit-equal, because the
kernels contract products and sums into FMAs, sum the blend's 50 products in
another order than cuBLAS, and sum the keypoints' shares over 68 points and
the rows' over up to 512 samples in a tree where the plain version sums
elementwise kernels in sample order. Two runs bit-equal; a CUDA graph of
forward and backward bit-equal to eager; one launch each a call.
"""

import math

import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_torch.augmentation.warp_fast import fold_fliprot
from neuralnet_tracker_traincode_torch.kernels import equalize as K2
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import heads as H
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


def _main_path_batch(case, B=64, src=448, S=129):
    """B sources of src^2 and view ROIs of the main path's geometry: all four
    flip/rot90 folds, a quarter of the angles at exactly +-30 degrees, and
    ROIs sized for the case (|scale| ~2.2, ~3.5 or < 1), some partly outside."""
    g = torch.Generator().manual_seed(11)
    img = torch.randint(0, 256, (B, src, src), generator=g, dtype=torch.uint8)
    size = {"main": 2.2 * S, "minify": 3.5 * S, "magnify": 0.7 * S, "outside": 2.2 * S}[case]
    centre = src / 2 + (torch.rand(B, 2, generator=g) - 0.5) * 120
    if case == "outside":
        centre = centre + torch.tensor([[src / 2, -src / 2]]) * torch.sign(torch.randn(B, 2, generator=g))
    roi = torch.cat([centre - size / 2, centre + size / 2], -1)
    ang = (torch.rand(B, generator=g) - 0.5) * 2 * math.radians(30.0)
    ang[: B // 4] = torch.tensor([1.0, -1.0]).repeat(B // 8) * math.radians(30.0)
    do_flip = (torch.arange(B) % 2) == 1
    rot_dir = ((torch.arange(B) // 2) % 3 - 1).float()
    view_roi, ang, _ = fold_fliprot(roi, ang, do_flip, rot_dir)
    return img, view_roi, ang


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("case", ["main", "minify", "magnify", "outside"])
def test_k1_kernel_matches_plain_at_main_path_shapes(dev, case, skip):
    """B = 64, 448^2 -> 129^2 through the wrapper the step calls, against the
    plain version on the card (TF32 off): max 0.02, mean 0.002 gray."""
    torch.backends.cuda.matmul.allow_tf32 = False
    img, view_roi, ang = (x.to(dev) for x in _main_path_batch(case))
    S = 129
    cs = S if skip else K1.canvas_size(S, 30.0)
    params = K1.warp_params(view_roi, ang, S, cs)
    ext.reset_launch_counts()
    out = K1.warp_roi_rotate(img, view_roi, ang, S, 30.0, skip)
    assert ext.LAUNCHES["warp_roi_rotate"] == 1
    ref = K1.warp_roi_rotate_plain(img, params, S, cs, not skip)
    torch.cuda.synchronize()
    d = (out - ref).abs()
    assert torch.isfinite(out).all() and d.max() < 0.02 and d.mean() < 0.002, (case, d.max(), d.mean())


def test_k1_kernel_fill_of_every_shear_stage(dev):
    """A canvas only 8 pixels wider than the crop: at +-30 degrees the pull
    reaches the zero fill of every stage; the kernel against the plain
    version's three shears and against the composed pull."""
    torch.backends.cuda.matmul.allow_tf32 = False
    img, view_roi, ang = (x.to(dev) for x in _main_path_batch("main"))
    S = 129
    cs = S + 8
    params = K1.warp_params(view_roi, ang, S, cs)
    max_sy, max_sx = params[:, [1, 3]].abs().amax(0).tolist()
    plan = K1.launch_plan(img.shape[2], cs, True, max_sy, max_sx)
    out = torch.empty((img.shape[0], S, S), device=dev)
    ext.extension().warp_roi_rotate(img, params, out, S, cs, True, *plan[:4])
    ref = K1.warp_roi_rotate_plain(img, params, S, cs, True)
    pull = K1.compose_shears_pull(K1.warp_roi_rotate_plain(img, params, cs, cs, False), params, S)
    torch.cuda.synchronize()
    assert (pull - ref).abs().max() <= 1e-4
    d = (out - ref).abs()
    assert d.max() < 0.02 and d.mean() < 0.002, (d.max(), d.mean())


def test_k1_wrapper_raises_when_the_taps_do_not_fit(dev):
    img = torch.zeros((2, 448, 448), dtype=torch.uint8, device=dev)
    roi = torch.tensor([[-4000.0, -4000.0, 4000.0, 4000.0]] * 2, device=dev)  # |scale| = 62
    ext.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        K1.warp_roi_rotate(img, roi, torch.zeros(2, device=dev), 129, 30.0)
    with pytest.raises(TypeError):
        K1.warp_roi_rotate(img.float(), roi, torch.zeros(2, device=dev), 129, 30.0)
    assert ext.LAUNCHES["warp_roi_rotate"] == 0


def test_k2_kernel_is_bit_equal_to_plain(dev):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(16, 129 * 129, generator=g) ** (0.3 + 2 * torch.rand(16, 1, generator=g))
    x[0] = 0.3
    gate = torch.rand(16, generator=g) < 0.7
    assert torch.equal(K2.equalize(x.to(dev), gate.to(dev)).cpu(), K2.equalize(x, gate))


def _eq_batch(B, P, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, P, generator=g) ** (0.3 + 2 * torch.rand(B, 1, generator=g))
    x[0] = 0.3  # one bin: step 0
    x[1] = torch.where(torch.rand(P, generator=g) < 0.5, 0.2, 0.9)  # two bins
    x[2, :4] = torch.tensor([0.0, 1.0, 255.0 / 256.0, 254.5 / 255.0])
    return x


@pytest.mark.parametrize("gates", ["mixed", "off", "on"])
@pytest.mark.parametrize("B,P", [(64, 129 * 129), (7, 999), (5, 63), (3, 5)])
def test_k2_cluster_kernel_is_bit_equal_to_plain(dev, B, P, gates):
    x = _eq_batch(B, P, P)
    gate = {"mixed": torch.arange(B) % 3 != 1, "off": torch.zeros(B, dtype=torch.bool),
            "on": torch.ones(B, dtype=torch.bool)}[gates]
    ext.reset_launch_counts()
    out = K2.equalize(x.to(dev), gate.to(dev)).cpu()
    assert ext.LAUNCHES["equalize"] == 1
    assert torch.equal(out.view(torch.int32), K2.equalize_plain(x, gate).view(torch.int32))


def test_k2_cluster_kernel_from_an_unaligned_input(dev):
    """An input 4 bytes off 16-byte alignment takes the kernel's scalar path."""
    B, P = 9, 129 * 129
    x = _eq_batch(B, P, 3)
    buf = torch.empty(B * P + 1, device=dev)
    xs = buf[1:].view(B, P)
    xs.copy_(x.to(dev))
    assert xs.data_ptr() % 16 != 0
    gate = torch.arange(B) % 2 == 0
    out = K2.equalize(xs, gate.to(dev)).cpu()
    assert torch.equal(out.view(torch.int32), K2.equalize_plain(x, gate).view(torch.int32))


@pytest.mark.parametrize("offset", [0.0, -0.5])
@pytest.mark.parametrize("B,P", [(64, 129 * 129), (7, 999)])
def test_k3_kernel_with_mixed_sigma_and_offsets_matches_plain(dev, B, P, offset):
    g = torch.Generator().manual_seed(P)
    x = torch.rand(B, P, generator=g)
    seeds = torch.arange(B, dtype=torch.int32) * 7919 - 2**30
    sigma = torch.where(torch.arange(B) % 3 == 0, torch.rand(B, generator=g) * 0.3 + 0.01, torch.zeros(B))
    ext.reset_launch_counts()
    out = K3.add_gaussian_noise(x.to(dev), seeds.to(dev), sigma.to(dev), offset).cpu()
    assert ext.LAUNCHES["gaussian_noise"] == 1
    ref = K3.add_gaussian_noise_plain(x, seeds, sigma, offset)
    assert (out - ref).abs().max() <= 1e-6
    quiet = sigma == 0
    assert torch.equal(out[quiet], x[quiet].clamp(0, 1) + offset)
    b1, b2 = K3.philox_bits(seeds, P)
    bits = K3.add_gaussian_noise_from_bits(x.to(dev), b1.to(dev), b2.to(dev), sigma.to(dev)).cpu()
    assert ext.LAUNCHES["gaussian_noise_from_bits"] == 1
    if offset == 0.0:
        assert torch.equal(bits, out)


P_LOCALIZER = 224 * 288  # the localizer's crops


@pytest.mark.parametrize("gates", ["drawn", "on"])
def test_k2_at_the_localizer_shape(dev, gates):
    from neuralnet_tracker_traincode_torch.augmentation.intensity import sample_stage1_parameters

    x = _eq_batch(64, P_LOCALIZER, 11)
    gate = sample_stage1_parameters(torch.Generator().manual_seed(4), 64).masks[0]
    if gates == "on":
        gate = torch.ones_like(gate)
    assert gate.any()
    ext.reset_launch_counts()
    out = K2.equalize(x.to(dev), gate.to(dev)).cpu()
    assert ext.LAUNCHES["equalize"] == 1
    assert torch.equal(out.view(torch.int32), K2.equalize_plain(x, gate).view(torch.int32))


@pytest.mark.parametrize("offset", [0.0, -0.5])
@pytest.mark.parametrize("sigmas", ["drawn", "on"])
def test_k3_at_the_localizer_shape(dev, sigmas, offset):
    from neuralnet_tracker_traincode_torch.augmentation.intensity import sample_noise_parameters

    g = torch.Generator().manual_seed(5)
    x = torch.rand(64, P_LOCALIZER, generator=g)
    noise = sample_noise_parameters(g, 64)
    sigma = noise.sigma if sigmas == "drawn" else torch.full((64,), 16.0 / 255.0)
    ext.reset_launch_counts()
    out = K3.add_gaussian_noise(x.to(dev), noise.seeds.to(dev), sigma.to(dev), offset).cpu()
    assert ext.LAUNCHES["gaussian_noise"] == 1
    assert (out - K3.add_gaussian_noise_plain(x, noise.seeds, sigma, offset)).abs().max() <= 1e-6


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


@pytest.mark.parametrize("P", [1, 3, 5, 999, 129 * 129, P_LOCALIZER])
@pytest.mark.parametrize("B", [1, 7, 64])
def test_k3b_kernel_matches_plain_and_skips_the_bits_of_quiet_samples(dev, B, P):
    """K3b with sigma mixed with zeros and bits with their high 8 bits set:
    within 1e-6 of its plain version; a sigma 0 sample is clip(x, 0, 1) bit
    for bit and stays so when its bits are overwritten (it reads none)."""
    rng = np.random.RandomState(B * 7 + P)
    x = torch.from_numpy(rng.rand(B, P).astype(np.float32) * 1.2 - 0.1)
    b1, b2 = (torch.from_numpy(rng.randint(-(2**31), 2**31 - 1, size=(B, P)).astype(np.int32)) | -0x1000000
              for _ in range(2))
    sigma = torch.where(torch.arange(B) % 3 == 1, 0.0, torch.from_numpy(rng.rand(B).astype(np.float32)) * 0.3 + 0.01)
    ext.reset_launch_counts()
    out = K3.add_gaussian_noise_from_bits(x.to(dev), b1.to(dev), b2.to(dev), sigma.to(dev)).cpu()
    assert ext.LAUNCHES["gaussian_noise_from_bits"] == 1
    assert (out - K3.add_gaussian_noise_from_bits_plain(x, b1, b2, sigma)).abs().max() <= 1e-6
    quiet = sigma == 0
    assert torch.equal(out[quiet], x[quiet].clamp(0, 1))
    b1[quiet], b2[quiet] = ~b1[quiet], b2[quiet] ^ 0x5A5A5A
    again = K3.add_gaussian_noise_from_bits(x.to(dev), b1.to(dev), b2.to(dev), sigma.to(dev)).cpu()
    assert torch.equal(again, out)


def _off_by_a_word(t):
    """A copy of `t` on the card whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device="cuda")
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("which", ["x", "all"])
def test_k3b_kernel_from_a_misaligned_input(dev, which):
    """x alone 4 bytes off 16-byte alignment, and x and both bit arrays off
    alike, at an odd P: the scalar path (the output the wrapper allocates
    is aligned), with its sigma 0 samples still reading no bits."""
    B, P = 9, 129 * 129
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(B, P).astype(np.float32))
    b1, b2 = (torch.from_numpy(rng.randint(-(2**31), 2**31 - 1, size=(B, P)).astype(np.int32)) for _ in range(2))
    sigma = torch.where(torch.arange(B) % 2 == 0, 0.05, 0.0)
    xs = _off_by_a_word(x)
    c1, c2 = (_off_by_a_word(b) if which == "all" else b.to(dev) for b in (b1, b2))
    out = K3.add_gaussian_noise_from_bits(xs, c1, c2, sigma.to(dev)).cpu()
    assert (out - K3.add_gaussian_noise_from_bits_plain(x, b1, b2, sigma)).abs().max() <= 1e-6
    assert torch.equal(out[sigma == 0], x[sigma == 0].clamp(0, 1))


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
    xs, sigma = torch.rand(2, 64, device=dev), torch.ones(2, device=dev)
    bits = torch.zeros(2, 64, dtype=torch.int32, device=dev)
    for name, b1, b2 in (("bits1", bits[:, :63], bits), ("bits2", bits, bits.reshape(-1)[:127])):
        with pytest.raises(ValueError, match=name):
            K3.add_gaussian_noise_from_bits(xs, b1, b2, sigma)
    with pytest.raises(TypeError):
        K3.add_gaussian_noise_from_bits(xs, bits.float(), bits, sigma)
    K3.add_gaussian_noise_from_bits(xs, bits.reshape(2, 8, 8), bits, sigma)  # any shape of B * P elements
    assert ext.LAUNCHES["gaussian_noise_from_bits"] == 1
    np.testing.assert_array_equal(sorted(ext.LAUNCHES), sorted(["warp_roi_rotate", "equalize", "gaussian_noise",
                                                               "gaussian_noise_from_bits", "jpeg_idct",
                                                               "jpeg_huffman", "stamp", "pose_heads_forward",
                                                               "pose_heads_backward"]))


def _graph_test_batch(rng, B=8, src=96):
    lo = src * 0.2 + rng.rand(B, 2) * src * 0.1
    size = src * (0.35 + rng.rand(B, 1) * 0.2)
    roi = np.concatenate([lo, lo + size], axis=-1).astype(np.float32)
    q = rng.randn(B, 4).astype(np.float32)
    return {
        "image": rng.randint(0, 256, size=(B, src, src, 1), dtype=np.uint8),
        "pose": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "coord": np.concatenate([roi[:, :2] + size * 0.5, size * 0.5], -1).astype(np.float32),
        "roi": roi,
        "pt3d_68": np.concatenate([roi[:, None, :2] + rng.rand(B, 68, 2) * size[:, None], rng.rand(B, 68, 1) * 20],
                                  -1).astype(np.float32),
        "shapeparam": rng.randn(B, 50).astype(np.float32),
        "hasface": np.full((B,), 0.9, np.float32),
        "coord_convention_id": np.zeros((B,), np.int32),
        "tag_id": np.zeros((B,), np.int32),
        "dataset_weight": np.ones((B,), np.float32),
        "param_index": np.arange(B, dtype=np.int32),
    }


def _graph_test_trainer(dev):
    """MobileNetV1 at width 0.25, point and NLL heads, the 8-term criterion,
    f32, batch 8, image augmentation on; its state from seed 0."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.losses import losses as L
    from neuralnet_tracker_traincode_torch.losses import nll as NLL
    from neuralnet_tracker_traincode_torch.losses.criterion import Criterion, CriterionGroup, MaskedMultiTaskCriterion
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig

    terms = [Criterion("nllrot", NLL.QuatPoseNLLLoss(), 0.005), Criterion("rot", L.QuatPoseLoss("approx_distance"), 1.0),
             Criterion("xy", L.PoseXYLoss("l2"), 0.25), Criterion("points3d", L.Points3dLoss("l2", chin_weight=0.8), 0.5),
             Criterion("box", L.BoxLoss("l2"), 0.01), Criterion("nllcoord", NLL.CorrelatedCoordPoseNLLLoss(), 0.005),
             Criterion("sz", L.PoseSizeLoss("l2"), 0.25),
             Criterion("quatreg", L.QuaternionNormalizationSoftConstraint(), 1e-6)]
    crit = MaskedMultiTaskCriterion({Tag.POSE_WITH_LANDMARKS: CriterionGroup(terms)}, [Tag.POSE_WITH_LANDMARKS])
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                 backbone_args={"widen_factor": 0.25})
    cfg = TrainerConfig(batchsize=8, epochs=4, samples_per_epoch=32,
                        aug=TrainAugmentationConfig(inputsize=129, enable_image_aug=True, p_flip_rot90=0.5))
    tr = PoseTrainer(model, crit, cfg, LABEL_CATEGORIES, device=dev)
    return tr, tr.init_state(torch.Generator().manual_seed(0))


def _graph_test_blocks(dev):
    """4 single batches of 96^2 sources on the card, and the same as 2 blocks of K = 2."""
    rng = np.random.RandomState(0)
    singles = [{k: torch.from_numpy(v).to(dev) for k, v in _graph_test_batch(rng).items()} for _ in range(4)]
    return singles, [{k: torch.stack([b[k] for b in singles[i:i + 2]]) for k in singles[0]} for i in (0, 2)]


def test_graph_replays_equal_eager_steps(dev):
    """`train_step_multi` (2 replays of a CUDA graph of K=2 steps) against 4
    `train_step` calls from the same weights and generator: MobileNetV1 at
    width 0.25, point and NLL heads, the 8-term criterion, f32, batch 8,
    96^2 sources, image augmentation on. Every metric, parameter, buffer,
    Adam moment and the count bit-equal; K1, K2 and K3 counted once a
    replayed step."""
    singles, groups = _graph_test_blocks(dev)
    runs = []
    for multi in (False, True):
        tr, state = _graph_test_trainer(dev)
        W, gen = tr.weight_matrix(0), torch.Generator().manual_seed(3)
        ext.reset_launch_counts()
        rows = []
        if multi:
            for g in groups:
                state, m = tr.train_step_multi(state, g, W, generator=gen)
                rows.append(torch.stack([m[n] for n in m], -1))
            warm = tr.graph_stats["warmup_steps"]
            assert tr.graph_stats["captures"] == 1 and warm == 3
            for name in ("warp_roi_rotate", "gaussian_noise", "pose_heads_forward", "pose_heads_backward"):
                assert ext.LAUNCHES[name] == 4 + warm
            assert ext.LAUNCHES["equalize"] == 4 * (4 + warm)
        else:
            for b in singles:
                state, m = tr.train_step(state, b, W, generator=gen)
                rows.append(torch.stack([m[n] for n in m])[None])
            assert ext.LAUNCHES["pose_heads_forward"] == ext.LAUNCHES["pose_heads_backward"] == 4
        torch.cuda.synchronize()
        runs.append([torch.cat(rows)] + [t.detach().clone() for t in tr._state_tensors(state)])
    assert int(runs[1][-1]) == 4
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_stamp_kernel_fills_and_wraps_its_ring(dev):
    from neuralnet_tracker_traincode_torch.kernels import stamp as KS

    ext.reset_launch_counts()
    ring, cursor = KS.new_ring(3, dev)
    for kind in (0, 5, 15, 2, 7):
        KS.stamp(ring, cursor, kind, kind * 1000)
    stamps, lost = KS.unroll(ring, cursor)
    assert lost == 2 and ext.LAUNCHES["stamp"] == 5
    np.testing.assert_array_equal(stamps[:, :2], [[15, 15000], [2, 2000], [7, 7000]])
    assert (np.diff(stamps[:, 2]) >= 0).all() and stamps[0, 2] > 0
    with pytest.raises(ValueError):
        KS.stamp(ring, cursor, KS.KINDS, 0)  # past the kernels' kinds
    assert ext.LAUNCHES["stamp"] == 5 and int(cursor[0]) == 5


def test_stamps_leave_the_blocks_bit_equal_and_fill_the_ring(dev):
    """2 blocks of K = 2 through the graph with the tracer on and 2 with it
    off, from the same weights and draws: every metric, parameter, buffer,
    Adam moment and the count bit-equal; the graph with stamps launches the
    same kernels and 13 stamps more a replay; the ring holds each block's
    load, 2 x (5 sections, step_end) and block_end in order, inside the
    anchors' brackets, and the sections sum to the block."""
    from neuralnet_tracker_traincode_torch.train import tracing as T

    _, groups = _graph_test_blocks(dev)
    runs = []
    for on in (True, False):
        tr, state = _graph_test_trainer(dev)
        W, gen = tr.weight_matrix(0), torch.Generator().manual_seed(3)
        if on:
            tr.tracer.enable()
        rows = []
        for g in groups:
            state, m = tr.train_step_multi(state, g, W, generator=gen)
            rows.append(torch.stack([m[n] for n in m], -1))
        torch.cuda.synchronize()
        (graph,) = tr._graphs.values()
        runs.append(([torch.cat(rows)] + [t.detach().clone() for t in tr._state_tensors(state)], graph.launches,
                     tr.tracer.records()))
    (on, launches_on, rec), (off, launches_off, rec_off) = runs
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert launches_off["stamp"] == 0 and launches_on == dict(launches_off, stamp=13)
    assert len(rec_off.stamps) == 0 and len(rec_off.spans) == 0
    blocks = T.split_blocks(rec.stamps)
    assert [b.number for b in blocks] == [1, 2] and len(rec.stamps) == 28 and rec.stamps_lost == 0
    want = ["load"] + ["augment", "forward", "loss", "backward", "optimizer", "step_end"] * 2 + ["block_end"]
    for b in blocks:
        assert [T.KINDS[k] for k in b.marks[:, 0]] == want
        assert list(b.marks[1:, 1]) == [0] * 6 + [1] * 6 + [2] and (np.diff(b.marks[:, 2]) >= 0).all()
        assert sum(T.section_ns(b).values()) == b.end - b.start
    first, last = rec.anchors
    slack = first.half_ns + last.half_ns
    assert first.host_ns - slack <= T.to_host_ns(blocks[0].start, rec.anchors)
    assert T.to_host_ns(blocks[-1].end, rec.anchors) <= last.host_ns + slack
    s = T.summarize(rec)
    assert s["blocks"] == 2 and s["clock"]["uncertainty_us"] < 50 and s["host_part_ms"] > 0


def _heads_inputs(dev, B, ids, scales=True, seed=0):
    """The pose heads' inputs on `dev`, f32, from a seed; every row's id
    ("all8"), three rows' ("repeated") or none."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(dev)

    x = dict(quat=r(B, 4), xy=r(B, 2), size=r(B, 1), box=r(B, 4), shape=r(B, 50), offset=r(8, 4, s=0.3),
             offset_kpts=r(8, 4, s=0.3), keypts=r(68, 3, s=50.0), keyeigvecs=r(50, 68, 3, s=2.0), set_id=None)
    if ids != "none":
        id_ = torch.arange(B) % 8 if ids == "all8" else torch.randint(0, 3, (B,), generator=g)
        x["set_id"] = id_.to(torch.int32).to(dev)
    if scales:
        md = torch.tensor([1e-6] * 3 + [0.0] * 3, device=dev)
        x.update(neck_rot=r(B, 7), neck_coord=r(B, 7), min_diag_rot=md, min_diag_coord=md.clone(),
                 hidden_roi=r(5), hidden_pt3d=r(69), hidden_shape=r(51))
    return x


def _heads_through_the_function(x, g):
    """(outputs, gradients of the differentiable inputs) through `pose_heads` and autograd."""
    names = [k for k in H.REACHES if x.get(k) is not None]
    leaves = {k: x[k].clone().requires_grad_() for k in names}
    out = H.pose_heads(**dict(x, **leaves))
    used = [k for k in g if g[k] is not None]
    grads = torch.autograd.grad([out[k] for k in used], [leaves[k] for k in names], [g[k] for k in used],
                                allow_unused=True)
    return {k: v.detach() for k, v in out.items() if v is not None}, dict(zip(names, grads))


@pytest.mark.parametrize("B,ids,scales,dropped", [
    (1, "none", True, ()), (7, "repeated", True, ()), (64, "all8", True, ()), (512, "all8", True, ()),
    (512, "repeated", True, ()), (64, "repeated", False, ()),
    (64, "all8", True, ("rot", "roi", "pose_scales_tril", "roi_scales")), (64, "none", True, ("pt3d_68",)),
])
def test_pose_heads_kernels_match_plain(dev, B, ids, scales, dropped):
    x = _heads_inputs(dev, B, ids, scales, seed=B)
    want = H.heads_plain(x)
    gen = torch.Generator().manual_seed(1)
    g = {k: None if k in dropped else torch.randn(v.shape, generator=gen).to(dev) for k, v in want.items()
         if v is not None}
    ext.reset_launch_counts()
    out, d = _heads_through_the_function(x, g)
    assert ext.LAUNCHES["pose_heads_forward"] == ext.LAUNCHES["pose_heads_backward"] == 1
    assert set(out) == {k for k, v in want.items() if v is not None}
    for k, v in out.items():
        err = float((v - want[k]).abs().max())
        assert torch.isfinite(v).all() and err <= 1e-5 * float(want[k].abs().max()), (k, err)
    d_want = H.heads_backward_plain(x, g)
    for k, v in d.items():
        if not any(g.get(o) is not None for o in H.REACHES[k]):
            assert v is None, k
            continue
        err = float((v - d_want[k]).abs().max())
        assert torch.isfinite(v).all() and err <= 5e-5 * float(d_want[k].abs().max()), (k, err)


def test_pose_heads_kernels_are_deterministic_and_capture_in_a_graph(dev):
    x = _heads_inputs(dev, 64, "repeated")
    gen = torch.Generator().manual_seed(2)
    g = {k: torch.randn(v.shape, generator=gen).to(dev) for k, v in H.heads_plain(x).items()}
    first, second = _heads_through_the_function(x, g), _heads_through_the_function(x, g)
    for a, b in zip(first, second):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as the trainer's capture does
        _heads_through_the_function(x, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    ext.reset_launch_counts()
    with torch.cuda.graph(graph):
        captured = _heads_through_the_function(x, g)
    assert ext.LAUNCHES["pose_heads_forward"] == ext.LAUNCHES["pose_heads_backward"] == 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(first, captured):
            for k in a:
                assert torch.equal(a[k], b[k]), k
