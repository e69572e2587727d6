"""Parity of the port's training augmentation with the JAX package's.

Draws come from a JAX key with the splits of `pipeline.py` (ROI, flip/rot90,
intensity) and `intensity.py` (stage-1 permutation, per-op masks and values,
noise gates) and are injected into the port. Tolerances:
 - crop images: max 0.02 and mean 0.002 gray levels, the CPU bound of the
   JAX package's own warp-kernel test (f32 reassociation between a dense
   and a banded resample);
 - labels: 1e-4 absolute (f32 affine compositions in another order);
 - stage-1 ops on one input: 2e-6 (pow/conv rounding; equalize is exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import intensity as JI
from neuralnet_tracker_traincode_tpu.augmentation.noise_pallas import add_gaussian_noise_from_bits
from neuralnet_tracker_traincode_tpu.augmentation.pipeline import (
    TrainAugmentationConfig as JCfg,
    augment_batch_for_training as jax_augment,
)
from neuralnet_tracker_traincode_tpu.data.loader import LABEL_CATEGORIES as JCATS
from neuralnet_tracker_traincode_torch.augmentation import intensity as TI
from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
    TrainAugmentationConfig as TCfg,
    augment_batch_for_training as torch_augment,
)
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES as TCATS
from neuralnet_tracker_traincode_torch.kernels.noise import philox_bits
from tests.torch_port_helpers import LABEL_KEYS, jax_augmentation_draws, jax_op_draws, make_batch, t

B, SRC, S = 8, 96, 49


def _run_both(seed, image_aug, param_index=None):
    rng = np.random.RandomState(seed)
    batch = make_batch(rng, B, SRC)
    labels = {k: batch[k] for k in LABEL_KEYS}
    kw = dict(inputsize=S, enable_image_aug=image_aug, p_flip_rot90=0.5)
    key = jax.random.PRNGKey(seed)
    ref_x, ref_labels = jax_augment(
        key, jnp.asarray(batch["image"]), {k: jnp.asarray(v) for k, v in labels.items()}, JCATS, JCfg(**kw),
        param_index=None if param_index is None else jnp.asarray(param_index),
    )
    draws = jax_augmentation_draws(key, B, JCfg(**kw))
    x, out_labels = torch_augment(
        batch["image"], labels, TCATS, TCfg(**kw), params=draws, param_index=param_index, device="cpu"
    )
    return batch, key, draws, (np.asarray(ref_x), ref_labels), (x.numpy(), out_labels)


def _check_labels(ref_labels, out_labels):
    for k in LABEL_KEYS:
        np.testing.assert_allclose(out_labels[k].numpy(), np.asarray(ref_labels[k]), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("seed,shared", [(0, False), (1, True), (2, False)])
def test_geometry_only_matches_jax(seed, shared):
    """Crop warp with folded flip/rot90 (p_flip_rot90=0.5 so both fold) and labels."""
    param_index = np.asarray([0, 0, 2, 3, 3, 5, 6, 6], np.int32) if shared else None
    batch, key, draws, (ref_x, ref_labels), (x, out_labels) = _run_both(seed, False, param_index)
    assert (draws.rot_dir != 0).any() and draws.do_flip.any()
    d = np.abs(ref_x - x) * 256.0  # whitened = gray / 256 - 0.5
    assert d.max() < 0.02 and d.mean() < 0.002, (d.max(), d.mean())
    _check_labels(ref_labels, out_labels)


def _op_input(op):
    rng = np.random.RandomState(op)
    return (rng.rand(B, 33, 33, 1) ** (0.3 + rng.rand())).astype(np.float32)


@pytest.mark.parametrize("op", range(6))
def test_stage1_op_matches_jax(op):
    """Each of equalize/posterize/gamma/contrast/brightness/blur with the
    per-sample gate and value that the JAX op draws from the same key."""
    x = _op_input(op)
    key = jax.random.fold_in(jax.random.PRNGKey(7), op)
    ref = np.asarray(JI._stage1_op(jnp.asarray(op), key, jnp.asarray(x)))
    mask, value = jax_op_draws(key, op, B)
    out = TI._stage1_op(op, t(x), t(mask), t(value)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


_JAX_OPS = [
    lambda x, v: JI.equalize(x),
    lambda x, v: JI.posterize(x, v.astype(jnp.int32)),
    JI.adjust_gamma,
    JI.adjust_contrast,
    JI.adjust_brightness,
    lambda x, v: JI.gaussian_blur(x, 5, 1.5),
]


@pytest.mark.parametrize("op", range(6))
def test_stage1_op_math_matches_jax(op):
    """The same ops with every gate on (posterize's p=0.01 gate is rarely
    on in a draw). Equalize is bit-equal."""
    x = _op_input(op)
    _, value = jax_op_draws(jax.random.PRNGKey(op), op, B)
    ref = np.asarray(_JAX_OPS[op](jnp.asarray(x), jnp.asarray(value)))
    out = TI._stage1_op(op, t(x), torch.ones(B, dtype=torch.bool), t(value)).numpy()
    if op == 0:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_stage1_sequence_matches_jax(seed):
    """The random 4-of-6 subset in random order, on one input."""
    from tests.torch_port_helpers import jax_stage1_draws

    rng = np.random.RandomState(seed)
    x = rng.rand(B, 33, 33, 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JI.intensity_augmentation_stage1(key, jnp.asarray(x)))
    out = TI.intensity_augmentation_stage1(t(x), jax_stage1_draws(key, B)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("seed", [5, 8])
def test_full_pipeline_with_image_aug_matches_jax(seed):
    """Image augmentation on: the JAX reference is the JAX package's own
    pieces (geometry-only pipeline, stage 1 from the same key, the noise
    kernel body on the port's Philox bits). Stage 1 runs on crops that differ
    by float noise, so an equalize histogram bin may flip: tolerance is one
    gray level (1/255) at most and 1e-4 on the mean. Labels are unaffected.
    Seed 8 draws equalize first, seed 5 does not draw it."""
    batch, key, draws, _, (x, out_labels) = _run_both(seed, True)
    labels = {k: jnp.asarray(batch[k]) for k in LABEL_KEYS}
    geo_x, ref_labels = jax_augment(
        key, jnp.asarray(batch["image"]), labels, JCATS, JCfg(inputsize=S, enable_image_aug=False, p_flip_rot90=0.5)
    )
    k1, _ = jax.random.split(jax.random.split(key, 3)[2])
    y = JI.intensity_augmentation_stage1(k1, geo_x + 0.5)[..., 0]
    bits1, bits2 = philox_bits(draws.noise.seeds, S * S)
    y = add_gaussian_noise_from_bits(
        y, jnp.asarray(bits1.numpy().reshape(B, S, S)), jnp.asarray(bits2.numpy().reshape(B, S, S)),
        jnp.asarray(draws.noise.sigma.numpy()), interpret=True,
    )
    ref = np.asarray(y)[..., None] - 0.5
    d = np.abs(ref - x)
    assert d.max() <= 1.0 / 255.0 + 1e-5 and d.mean() < 1e-4, (d.max(), d.mean())
    _check_labels(ref_labels, out_labels)
    # samples with no noise and no stage-1 change also match the plain JAX pipeline
    ref_full = np.asarray(
        jax_augment(key, jnp.asarray(batch["image"]), labels, JCATS, JCfg(inputsize=S, p_flip_rot90=0.5))[0]
    )
    quiet = draws.noise.sigma.numpy() == 0
    assert quiet.any()
    assert np.abs(ref_full[quiet] - x[quiet]).max() <= 1.0 / 255.0 + 1e-5


@pytest.mark.parametrize("seed", [5, 8])
def test_pipeline_whitening_folded_into_k3_is_bit_equal(seed, monkeypatch):
    """With image augmentation K3 adds the whitening's -0.5 after its clip:
    the pipeline's output is bit-equal to the old formula, stage 1 and K3 at
    offset 0 followed by - 0.5, on the same crop and draws."""
    from neuralnet_tracker_traincode_torch.augmentation import pipeline as TP

    seen = []

    def spy(x, stage1, noise, offset):
        seen.append((x.clone(), stage1, noise, offset))
        return TI.intensity_augmentation(x, stage1, noise, offset)

    monkeypatch.setattr(TP, "intensity_augmentation", spy)
    _, _, draws, _, (x, _) = _run_both(seed, True)
    (crop, stage1, noise, offset), = seen
    assert offset == -0.5 and (noise.sigma == 0).any() and (noise.sigma > 0).any()
    old = TI.intensity_augmentation(crop, stage1, noise, 0.0) - 0.5
    assert torch.equal(t(x).view(torch.int32), old.view(torch.int32))


def test_sampled_parameters_drive_the_pipeline():
    """Without injected draws, the port samples from the generator: same seed,
    same output; the entry point defaults to CUDA and raises without it."""
    rng = np.random.RandomState(0)
    batch = make_batch(rng, B, SRC)
    labels = {k: batch[k] for k in LABEL_KEYS}
    cfg = TCfg(inputsize=S)
    outs = [
        torch_augment(batch["image"], labels, TCATS, cfg, generator=torch.Generator().manual_seed(3), device="cpu")[0]
        for _ in range(2)
    ]
    assert torch.equal(outs[0], outs[1]) and outs[0].shape == (B, S, S, 1)
    assert torch.isfinite(outs[0]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_augment(batch["image"], labels, TCATS, cfg, generator=torch.Generator())
