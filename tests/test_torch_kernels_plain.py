"""The plain PyTorch versions of the port's three kernels against the JAX
package's Pallas kernels (interpret mode) and XLA formulations, on the CPU.

On the card each CUDA kernel is held against these plain versions
(`chip_smoke.py`, `tests/test_torch_kernels_cuda.py`). Tolerances:
 - K1 crop warp: max 0.02 and mean 0.002 gray levels, the CPU bound of
   `tests/test_warp_pallas.py` (a banded or dense resample sums in another
   order than the Pallas dots);
 - K2 equalize: bit-equal to `intensity.equalize` (integer histogram and
   LUT, one IEEE division); the same LUT level as the Pallas kernel, whose
   jitted lut / 255 is one ulp off on some levels (see the test). The
   kernel's slices (`slice_edges`) and its per-slice algorithm, written out
   in numpy, are bit-equal to the plain version;
 - K3 noise from injected bits: 1e-6 (log/cos of two libraries), sigma = 0
   bit-equal; the seeded K3 by moments and seed independence, as
   `tests/test_noise_pallas.py` holds the TPU kernel; its Philox words
   against Random123's vectors, pixel pair by pixel pair; its offset
   bit-equal to a subtraction after it.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import intensity as JI
from neuralnet_tracker_traincode_tpu.augmentation import warp_fast as JW
from neuralnet_tracker_traincode_tpu.augmentation.equalize_pallas import equalize_pallas
from neuralnet_tracker_traincode_tpu.augmentation.noise_pallas import add_gaussian_noise_from_bits
from neuralnet_tracker_traincode_tpu.augmentation.warp_pallas import warp_roi_rotate_pallas
from neuralnet_tracker_traincode_torch.augmentation import warp_fast as TW
from neuralnet_tracker_traincode_torch.kernels import equalize as K2
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as K5
from neuralnet_tracker_traincode_torch.kernels import noise as K3
from neuralnet_tracker_traincode_torch.kernels import warp as K1
from tests.torch_port_helpers import t

# ---------------------------------------------------------------- K1 ---


def _warp_data(B=4, H=112, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, size=(B, H, H)).astype(np.uint8)
    roi = np.asarray(
        [[10.0, 5.0, 90.0, 85.0], [-20.0, -10.0, H + 15.0, H + 25.0], [20.0, 20.0, 70.0, 70.0],
         [100.5, 8.25, 5.5, 103.25]],  # beyond the border; a reversed x range (a folded flip)
        np.float32,
    )[:B]
    ang = np.asarray([0.2, -0.4, 0.0, 0.45], np.float32)[:B]
    return img, roi, ang


def _gray_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.max(), d.mean()


@pytest.mark.parametrize("skip_rotation", [False, True])
@pytest.mark.parametrize("S", [49, 129])
def test_k1_plain_matches_pallas_kernel(skip_rotation, S):
    img, roi, ang = _warp_data()
    ref = warp_roi_rotate_pallas(jnp.asarray(img), jnp.asarray(roi), jnp.asarray(ang), S, 30.0,
                                 skip_rotation=skip_rotation, interpret=True)
    out = K1.warp_roi_rotate(t(img), t(roi), t(ang), S, 30.0, skip_rotation=skip_rotation)
    assert out.dtype == torch.float32 and out.shape == (4, S, S)
    dmax, dmean = _gray_diff(out.numpy(), ref)
    assert dmax < 0.02 and dmean < 0.002, (dmax, dmean)


@pytest.mark.parametrize("skip_rotation", [False, True])
def test_k1_with_flip_and_rot90_matches_xla_warp(skip_rotation):
    """The folded flip/rot90 (reversed ROI ranges, negated angles, per-sample
    transpose) through the port's `warp_fast` against the JAX XLA warp."""
    img, roi, ang = _warp_data(seed=1)
    roi[3] = [5.5, 8.25, 100.5, 103.25]
    do_flip = np.asarray([True, False, True, False])
    rot_dir = np.asarray([1.0, -1.0, -1.0, 0.0], np.float32)
    os.environ["NNTC_WARP_IMPL"] = "xla"
    try:
        ref = JW.warp_roi_rotate(jnp.asarray(img[..., None]), jnp.asarray(roi), jnp.asarray(ang), 49, 30.0,
                                 do_flip=jnp.asarray(do_flip), rot_dir=jnp.asarray(rot_dir),
                                 skip_rotation=skip_rotation)
    finally:
        os.environ.pop("NNTC_WARP_IMPL", None)
    out = TW.warp_roi_rotate(t(img[..., None]), t(roi), t(ang), 49, 30.0, do_flip=t(do_flip), rot_dir=t(rot_dir),
                             skip_rotation=skip_rotation)
    dmax, dmean = _gray_diff(out.numpy(), ref)
    assert dmax < 0.02 and dmean < 0.002, (dmax, dmean)


_FOLDS = {  # (do_flip, rot_dir): the folded flip reverses x, rot+90 reverses y, rot-90 and a flip neither
    "none": (False, 0.0), "flip_x": (True, 0.0), "flip_y": (False, 1.0), "flip_xy": (True, 1.0),
}


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("fold", sorted(_FOLDS))
@pytest.mark.parametrize("S", [49, 129])
def test_k1_composed_shear_pull_matches_three_shears(S, fold, tight):
    """`compose_shears_pull` (the CUDA kernel's 8-tap pull with each stage's
    zero fill) against the plain version's three `_shear_rows` and crop, at
    exactly +-30 degrees, 0 and +-0.45 rad, with the flips folded into the ROI
    and the angle. `canvas_size` leaves a margin that the pull never reaches;
    a tight canvas (S + 8) makes the crop's corners pull from the zero fill
    of every stage."""
    rng = np.random.RandomState(S)
    H = 2 * S
    ang = np.asarray([math.radians(30.0), -math.radians(30.0), 0.0, 0.45, -0.45], np.float32)
    B = ang.shape[0]
    img = rng.randint(0, 256, size=(B, H, H)).astype(np.uint8)
    roi = np.tile(np.asarray([[0.2 * H, 0.15 * H, 0.85 * H, 0.8 * H]], np.float32), (B, 1))
    roi[-1] = [-0.1 * H, -0.2 * H, 0.7 * H, 0.6 * H]  # partly outside the source
    do_flip, rot_dir = _FOLDS[fold]
    view_roi, angles, _ = TW.fold_fliprot(t(roi), t(ang), torch.full((B,), do_flip), torch.full((B,), rot_dir))
    assert (view_roi[:, 2] < view_roi[:, 0]).all() == fold.endswith(("x", "xy"))
    cs = S + 8 if tight else K1.canvas_size(S, 30.0)
    params = K1.warp_params(view_roi, angles, S, cs)
    canvas = K1.warp_roi_rotate_plain(t(img), params, cs, cs, False)
    ref = K1.warp_roi_rotate_plain(t(img), params, S, cs, True)
    out = K1.compose_shears_pull(canvas, params, S)
    assert out.shape == (B, S, S) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize(
    "max_s, chunk",
    [(2.17, 16), (3.5, 16), (0.6, 16), (6.0, 8), (30.0, None)],  # main path, minify, magnify, far, too far
)
def test_k1_launch_plan_sizes_shared_memory_or_raises(max_s, chunk):
    """The plan holds every tap of a chunk's rows within its band, and the
    canvas half plus tables within 227 KB, or it raises: no fallback."""
    if chunk is None:
        with pytest.raises(ValueError, match="shared memory"):
            K1.launch_plan(448, 225, True, max_s, max_s)
        return
    plan = K1.launch_plan(448, 225, True, max_s, max_s)
    assert plan.chunk == chunk and plan.shared_bytes <= K1.SHARED_BYTES_PER_BLOCK
    assert plan.taps_x == plan.taps_y == math.ceil(2 * max(max_s, 1.0)) + 1
    # every source row a chunk's taps reach, at any start, fits the band
    for y0 in np.linspace(-40.0, 30.0, 7):
        p = np.float32(y0) + np.float32(max_s) * (np.arange(225, dtype=np.float32) + np.float32(0.5))
        first = np.floor(p - np.float32(0.5) - np.float32(max(max_s, 1.0))).astype(np.int64) + 1
        for cb in range(0, 225, plan.chunk):
            rows = first[cb : cb + plan.chunk]
            assert rows.max() - rows.min() + plan.taps_y <= plan.band_rows
    assert K1.launch_plan(448, 129, False, max_s, max_s).shared_bytes < plan.shared_bytes


def test_k1_canvas_size_and_params_match_jax():
    from neuralnet_tracker_traincode_tpu.augmentation.warp_fast import canvas_size as jax_canvas_size

    for S, theta in [(129, 30.0), (49, 30.0), (129, 0.0), (64, 45.0)]:
        assert K1.canvas_size(S, theta) == jax_canvas_size(S, theta)
    assert K1.canvas_size(129, 30.0) == 225


# ---------------------------------------------------------------- K2 ---


def _eq_images(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(10, 33 * 33).astype(np.float32) ** (0.3 + 2 * rng.rand(10, 1)).astype(np.float32)
    x[0] = 0.3  # one bin: step == 0, passes through
    x[1] = np.where(rng.rand(33 * 33) < 0.5, 0.2, 0.9)  # two bins: the last one is dropped from the step
    x[2, :5] = [0.0, 1.0, 255.0 / 256.0, 1.0 / 256.0, 254.5 / 255.0]  # the edges of both index scales
    gate = np.ones(10, bool)
    gate[3] = False
    return x, gate


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_plain_matches_pallas_kernel(seed):
    """Same LUT level for every pixel; the last step differs by design of
    XLA, not of the kernel: a jitted program rewrites lut / 255 into
    lut * (1 / 255), one ulp off IEEE division on a third of the levels,
    and the interpreted Pallas kernel is such a program (so is a jitted
    `intensity.equalize`). The port divides, as kornia and the eager
    `intensity.equalize` do (bit-equal below)."""
    x, gate = _eq_images(seed)
    ref = np.asarray(equalize_pallas(jnp.asarray(x), jnp.asarray(gate), interpret=True))
    out = K2.equalize(t(x), t(gate)).numpy()
    np.testing.assert_array_equal(np.rint(out * 255.0), np.rint(ref * 255.0))
    np.testing.assert_array_equal(out[[0, 3]], x[[0, 3]])
    np.testing.assert_array_equal(ref[[0, 3]], x[[0, 3]])
    eq = np.ones(10, bool)
    eq[[0, 3]] = False
    levels = np.rint(out[eq] * 255.0).astype(np.float32)
    np.testing.assert_array_equal(out[eq], levels / np.float32(255.0))
    np.testing.assert_array_equal(ref[eq], levels * np.float32(1.0 / 255.0))
    jitted = np.asarray(jax.jit(JI.equalize)(jnp.asarray(x.reshape(10, 33, 33, 1))))[..., 0].reshape(10, -1)
    np.testing.assert_array_equal(jitted[eq], ref[eq])


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_plain_is_bit_equal_to_xla_equalize(seed):
    x, gate = _eq_images(seed)
    ref = np.asarray(JI.equalize(jnp.asarray(x.reshape(10, 33, 33, 1))))[..., 0].reshape(10, -1)
    ref = np.where(gate[:, None], ref, x)
    np.testing.assert_array_equal(K2.equalize(t(x), t(gate)).numpy(), ref)


@pytest.mark.parametrize("P", [129 * 129, 129 * 129 + 1, 4096, 999, 257, 255, 64, 9, 8, 7, 5, 1])
def test_k2_slices_cover_each_image_once_on_aligned_edges(P):
    """Odd P (so b*P is odd for odd b), P below one CTA's 256 threads and
    below the cluster size: the slices of image b tile [b*P, (b+1)*P) in
    order, each inner edge lies on 16 bytes of the (B, P) array, and each
    slice with the up to 3 pixels before it fits the staged capacity."""
    B = 7
    edges = K2.slice_edges(B, P)
    assert edges.shape == (B, K2.CLUSTER + 1)
    assert torch.equal(edges[:, 0], torch.arange(B) * P) and torch.equal(edges[:, -1], torch.arange(1, B + 1) * P)
    assert (edges[:, 1:] >= edges[:, :-1]).all()
    covered = torch.cat([torch.arange(int(a), int(b)) for a, b in zip(edges[:, :-1].flatten(), edges[:, 1:].flatten())])
    assert torch.equal(covered, torch.arange(B * P))
    inner = edges[:, 1:-1]
    assert ((inner % 4 == 0) | (inner == edges[:, -1:])).all()
    cap = K2.slice_capacity(P)
    assert int((edges[:, 1:] - edges[:, :-1] // 4 * 4).max()) <= cap and cap % 4 == 0


def test_k2_slice_capacity_at_the_main_path():
    """P = 129^2 over 8 CTAs: 2081 pixels a slice and 3 before it, rounded
    to 16 bytes; far below the 48 KB a launch gets without opting in."""
    assert K2.CLUSTER == 8
    assert K2.slice_capacity(129 * 129) == 2088 and 4 * 2088 < 48 * 1024
    assert K2.slice_capacity(1) == 8


def _equalize_as_the_kernel_does(x: np.ndarray, gate: np.ndarray, vec: bool = True) -> np.ndarray:
    """`csrc/equalize.cu` written out in numpy, CTA by CTA: each CTA stages
    its slice (scalar ends, float4 middle) at staged[g - lo], the CTAs' bins
    are summed, step comes from the exclusive count at the last nonzero bin,
    the LUT from exclusive counts, the lookup from the staged slice."""
    B, P = x.shape
    flat, out = x.reshape(-1), np.empty(B * P, np.float32)
    edges = K2.slice_edges(B, P).numpy()
    cap = K2.slice_capacity(P)
    for b in range(B):
        parts, staged = [], []
        for r in range(K2.CLUSTER):
            g0, g1 = int(edges[b, r]), int(edges[b, r + 1])
            a0, a1 = (min(-(-g0 // 4) * 4, g1), max(g1 // 4 * 4, min(-(-g0 // 4) * 4, g1))) if vec else (g1, g1)
            lo = g0 // 4 * 4
            s = np.full(cap, np.nan, np.float32)
            for g in list(range(g0, a0)) + list(range(a1, g1)):
                s[g - lo] = flat[g]
            for k in range(a0 // 4, a1 // 4):
                s[4 * k - lo : 4 * k - lo + 4] = flat[4 * k : 4 * k + 4]
            v = s[g0 - lo : g1 - lo]
            assert not np.isnan(v).any()
            bins = np.clip(np.floor(v * np.float32(256.0)), 0, 255).astype(np.int64)
            parts.append(np.bincount(bins, minlength=256))
            staged.append((g0, g1, v))
        hist = np.sum(parts, axis=0)
        excl = np.cumsum(hist) - hist
        last = int(np.nonzero(hist)[0].max())
        step = int(excl[last]) // 255
        lut = (np.clip((excl + step // 2) // max(step, 1), 0, 255).astype(np.float32) / np.float32(255.0))
        for g0, g1, v in staged:
            li = np.floor(v * np.float32(255.0)).astype(np.int64)
            eq = np.where((li >= 0) & (li < 256), lut[np.clip(li, 0, 255)], np.float32(0.0))
            out[g0:g1] = eq if (gate[b] and step) else v
    return out.reshape(B, P)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("seed", [2, 3])
def test_k2_kernel_algorithm_is_bit_equal_to_plain(seed, vec):
    """The kernel's slicing, staging and integer LUT algebra at an odd P
    (33^2: every odd image starts off 16 bytes), with one-bin, two-bin and
    gated-off images."""
    x, gate = _eq_images(seed)
    out = _equalize_as_the_kernel_does(x, gate, vec)
    np.testing.assert_array_equal(out, K2.equalize_plain(t(x), t(gate)).numpy())


# ---------------------------------------------------------------- K3 ---


def _bits(rng, shape):
    return rng.randint(-(2**31), 2**31 - 1, size=shape).astype(np.int32)


@pytest.mark.parametrize("shape,sigma", [
    ((3, 40, 129), [0.1, 0.02, 0.5]),
    ((4, 40, 129), [0.1, 0.0, 0.5, 0.0]),  # sigma with zeros among non-zeros
    ((1, 40, 129), [0.3]),  # B = 1
    ((3, 7, 143), [0.0, 0.2, 0.05]),  # an odd P, 1,001
], ids=["sigma_on", "sigma_with_zeros", "one_sample", "odd_P"])
def test_k3_from_bits_plain_matches_pallas_kernel(shape, sigma):
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    if shape != (3, 40, 129):  # beyond [0, 1] too, where the clip of a quiet sample acts
        x = x * np.float32(1.2) - np.float32(0.1)
    b1, b2 = _bits(rng, x.shape), _bits(rng, x.shape)
    b1[0, 0, :3] = [0, -1, 0xFFFFFF]  # u1 at its ends, high bits masked off
    sigma = np.asarray(sigma, np.float32)
    ref = np.asarray(add_gaussian_noise_from_bits(jnp.asarray(x), jnp.asarray(b1), jnp.asarray(b2),
                                                  jnp.asarray(sigma), interpret=True))
    out = K3.add_gaussian_noise_from_bits(t(x), t(b1), t(b2), t(sigma)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    quiet = sigma == 0
    np.testing.assert_array_equal(out[quiet], np.clip(x[quiet], 0, 1))
    np.testing.assert_array_equal(ref[quiet], np.clip(x[quiet], 0, 1))
    z = K3.add_gaussian_noise_from_bits(t(x), t(b1), t(b2), torch.zeros(shape[0])).numpy()
    np.testing.assert_array_equal(z, np.clip(x, 0, 1))


def test_philox_matches_published_test_vectors():
    """Philox-4x32-10 known-answer vectors of the Random123 distribution."""
    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    as_t = lambda words: [torch.tensor([w], dtype=torch.int64) for w in words]  # noqa: E731
    for ctr, key, expect in vectors:
        assert [int(w) for w in K3.philox4x32_10(as_t(ctr), as_t(key))] == list(expect)
    b1, b2 = K3.philox_bits(torch.tensor([0, -1], dtype=torch.int32), 2)
    assert b1[0, 0] == 0x6627E8D5 & 0xFFFFFF and b2[0, 0] == 0xE169C58D & 0xFFFFFF


def test_philox_bits_take_all_four_words_of_a_pixel_pair():
    """Pixel 2q takes words 0 and 1 of counter (q, 0, 0, 0), pixel 2q + 1
    words 2 and 3: pixel 1 of key (0, 0) is Random123's words 2 and 3."""
    b1, b2 = K3.philox_bits(torch.tensor([0], dtype=torch.int32), 2)
    assert b1.tolist() == [[0x6627E8D5 & 0xFFFFFF, 0xBC57AC4C & 0xFFFFFF]]
    assert b2.tolist() == [[0xE169C58D & 0xFFFFFF, 0x9B00DBD8 & 0xFFFFFF]]


@pytest.mark.parametrize("num", [1, 2, 7, 129 * 129])
def test_philox_bits_at_odd_and_even_sizes(num):
    """At odd num the last pair has one pixel; every pixel's words equal a
    direct Philox call on its pair's counter."""
    seeds = torch.tensor([0, -1, 123456789], dtype=torch.int32)
    b1, b2 = K3.philox_bits(seeds, num)
    assert b1.shape == b2.shape == (3, num) and b1.dtype == torch.int32
    assert int(b1.min()) >= 0 and int(b1.max()) < 2**24 and int(b2.min()) >= 0 and int(b2.max()) < 2**24
    p = torch.tensor(sorted(i for i in {0, 1, num // 2, num - 2, num - 1} if 0 <= i < num))
    q = (p // 2).to(torch.int64)
    for i, seed in enumerate(seeds.tolist()):
        zero = torch.zeros_like(q)
        words = K3.philox4x32_10((q, zero, zero, zero), (torch.full_like(q, seed & 0xFFFFFFFF), zero))
        odd = (p % 2).bool()
        expect1 = torch.where(odd, words[2], words[0]) & 0xFFFFFF
        expect2 = torch.where(odd, words[3], words[1]) & 0xFFFFFF
        assert torch.equal(b1[i, p].to(torch.int64), expect1) and torch.equal(b2[i, p].to(torch.int64), expect2)


def test_k3_offset_is_a_subtraction_after_the_clip():
    """The pipeline's whitening folded into K3: offset -0.5 is bit-equal to
    K3 at offset 0 followed by - 0.5, with noisy and sigma-0 samples."""
    rng = np.random.RandomState(3)
    x = t(rng.rand(4, 33, 33).astype(np.float32))
    seeds = torch.arange(4, dtype=torch.int32) + 9
    sigma = torch.tensor([0.0, 0.1, 0.0, 0.3])
    out = K3.add_gaussian_noise(x, seeds, sigma, offset=-0.5)
    assert torch.equal(out, K3.add_gaussian_noise(x, seeds, sigma) - 0.5)
    assert torch.equal(out[[0, 2]], x[[0, 2]] - 0.5)
    assert torch.equal(K3.add_gaussian_noise_plain(x, seeds, sigma, -0.5), out)


def test_k3_seeded_plain_moments_determinism_and_seed_independence():
    B, S = 48, 64
    x = torch.full((B, S, S), 0.5)
    sigma = torch.full((B,), 0.1)
    sigma[B // 2 :] = 0.05
    seeds = (torch.arange(B, dtype=torch.int32) + 123456)
    out = K3.add_gaussian_noise(x, seeds, sigma)
    assert torch.equal(out, K3.add_gaussian_noise(x, seeds, sigma))
    z = ((out - 0.5) / sigma[:, None, None]).numpy()
    assert abs(z.mean()) < 6e-3 and abs(z.std() - 1.0) < 2e-2, (z.mean(), z.std())
    assert abs(z[: B // 2].std() - z[B // 2 :].std()) < 2e-2
    # neighbouring seeds (base + arange) give uncorrelated fields: the
    # correlation of two independent fields of 4096 pixels has std 1/64
    c = np.corrcoef(z.reshape(B, -1))[np.triu_indices(B, 1)]
    assert np.abs(c).max() < 5.0 / 64 and np.abs(c).mean() < 1.0 / 64, (np.abs(c).max(), np.abs(c).mean())
    other = K3.add_gaussian_noise(x, seeds + 1000, sigma)
    assert not torch.equal(out, other)
    assert torch.equal(K3.add_gaussian_noise(x, seeds, torch.zeros(B)), x)


def test_k3_clips_to_unit_range():
    x = torch.tensor([[0.0, 1.0, 0.5, 0.99]]).repeat(4, 64)
    out = K3.add_gaussian_noise(x, torch.arange(4, dtype=torch.int32), torch.full((4,), 0.5))
    assert out.min() >= 0.0 and out.max() <= 1.0 and (out == 0.0).any() and (out == 1.0).any()


# ----------------------------------------------------------- wrappers ---


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ext.reset_launch_counts()
    img, roi, ang = _warp_data()
    K1.warp_roi_rotate(t(img), t(roi), t(ang), 49, 30.0)
    x, gate = _eq_images(0)
    K2.equalize(t(x), t(gate))
    K3.add_gaussian_noise(t(x), torch.arange(10, dtype=torch.int32), torch.full((10,), 0.1))
    # K4 on one flat 8 x 8 block: its DC alone
    K4.idct_pack(torch.tensor([[5] + [0] * 63], dtype=torch.int16), torch.tensor([1], dtype=torch.uint8),
                 torch.ones((1, 64), dtype=torch.int32), torch.tensor([[8, 8, 1, 0]], dtype=torch.int32), 8)
    # K5 on one small JPEG's scan
    from neuralnet_tracker_traincode_torch.data.native_loader import scan_batch
    from neuralnet_tracker_traincode_torch.data.preprocessing import imencode

    payload = scan_batch([imencode(np.random.default_rng(0).integers(0, 256, (16, 24), dtype=np.uint8))], 24)
    K5.huffman_decode(*(torch.as_tensor(a) for a in payload.arrays[:4]), *payload.counts[:2], payload.counts[3],
                      payload.counts[2])
    # the tracer's stamp on a CPU ring: the host's clock
    from neuralnet_tracker_traincode_torch.kernels import stamp as KS

    ring, cursor = KS.new_ring(2, "cpu")
    KS.stamp(ring, cursor, 3, 7)
    assert int(cursor[0]) == 1 and int(ring[0, 0]) == 3 | 7 << 8 and int(ring[0, 1]) > 0
    # the pose heads' Function, forward and backward
    from neuralnet_tracker_traincode_torch.kernels import heads as H

    g = torch.Generator().manual_seed(0)
    inputs = {k: torch.randn(s, generator=g) for k, s in H.input_shapes(2, 8).items() if k != "set_id"}
    inputs["quat"].requires_grad_()
    sum(v.sum() for v in H.pose_heads(**inputs).values()).backward()
    assert inputs["quat"].grad.shape == (2, 4)
    assert set(ext.LAUNCHES) == {"warp_roi_rotate", "equalize", "gaussian_noise", "gaussian_noise_from_bits",
                                 "jpeg_idct", "jpeg_huffman", "stamp", "pose_heads_forward", "pose_heads_backward"}
    assert all(v == 0 for v in ext.LAUNCHES.values())
