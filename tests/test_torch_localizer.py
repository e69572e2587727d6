"""The port's face localizer against the JAX package's: the network, its
weight bridge and model file, the augmentation, the three new losses, one
training step of `scripts/train_localizer.py` and the two protocols of
`scripts/evaluate_localizer.py`. B = 2 (the eval: 6 frames), LocalizerNet at
its fixed 224x288, inputs from seeded numpy. Tolerances:

 - forward (eval and train mode): <= 1e-4 absolute on the logit and the box
   (measured 1.2e-7 / 5.3e-6); new BatchNorm statistics <= 1e-4 per leaf.
 - the weight bridge both ways and the model file: exact, byte for byte.
 - `augment_batch_for_localizer` with the same draws: crops <= 1e-3 gray
   (smooth sources, see `test_torch_eval_crop.py`; measured 3e-5), ROI
   labels <= 1e-5 (measured 0). With image augmentation the reference is
   the JAX package's own pieces, as in `test_torch_augmentation.py`.
 - the losses: <= 1e-6 relative.
 - the training step. Ten BatchNorm biases (the ds-sep conv's last and
   the last of inverted residuals 0-8) reach a BatchNorm in train mode only
   through a 1x1 conv, so their gradient is zero: in float64 it is 1e-16 to
   1e-19 of the whole, in f32 each package's first moment there is rounding
   noise of <= 3e-10 of the whole (limit 1e-8), which Adam scales to full
   steps of either sign. On the JAX crop, against the float64 gradient of
   that crop, the port's f32 clipped gradient is off by up to 8.3e-2 on a
   leaf and the JAX one by 5.1e-2 (the first layers: sums over
   B x 112 x 144 positions), and the loss by 8e-5 and 6e-5 relative. The
   port's first moment agrees with the JAX one to 7.5e-2 on the worst other
   leaf (nu 0.16) and 5.5e-2 over them all, in both step tests; a step with
   the face labels swapped reads 1.06 over them all, on a crop 1 gray
   brighter 0.51, on half the batch 1.34. The clipped gradient is dominated
   by the face logit, so box faults show in the loss instead: 0.8301 (port)
   against 0.8300 (JAX), 0.8848 with the boxes flipped left to right and
   0.8296 with the boxes 5% larger. Limits: 0.2 per leaf (0.4 for nu), 0.1
   over all leaves, the loss to 3e-4 relative.
 - the evaluation: accuracy and corner RMSE within 1e-3 of a JAX run that
   copies the script's `eval_full` and `eval_crop`.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import intensity as JI
from neuralnet_tracker_traincode_tpu.augmentation.affine import transform_roi as jax_transform_roi
from neuralnet_tracker_traincode_tpu.augmentation.localizer_pipeline import (
    LocalizerAugConfig as JCfg,
    augment_batch_for_localizer as jax_augment,
)
from neuralnet_tracker_traincode_tpu.augmentation.noise_pallas import add_gaussian_noise_from_bits
from neuralnet_tracker_traincode_tpu.augmentation.warp import warp_affine as jax_warp_affine
from neuralnet_tracker_traincode_tpu.eval import metrics as JM
from neuralnet_tracker_traincode_tpu.losses import losses as JL
from neuralnet_tracker_traincode_tpu.models import io as jio
from neuralnet_tracker_traincode_tpu.models.localizer import LocalizerNet as JLoc
from neuralnet_tracker_traincode_tpu.models.torch_interop import convert_localizer_state_dict
from neuralnet_tracker_traincode_tpu.ops.affine2d import Affine2d as JAffine2d
from neuralnet_tracker_traincode_tpu.train.schedules import exponential_up_then_steps as jax_schedule
from neuralnet_tracker_traincode_torch.augmentation import intensity as TI
from neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline import (
    LocalizerAugConfig as TCfg,
    LocalizerAugParameters,
    augment_batch_for_localizer,
    sample_localizer_parameters,
)
from neuralnet_tracker_traincode_torch.eval.localizer import LocalizerEvaluator, aspect_corrected_full_roi, result_lines
from neuralnet_tracker_traincode_torch.kernels.noise import philox_bits
from neuralnet_tracker_traincode_torch.losses import losses as TL
from neuralnet_tracker_traincode_torch.models import io as tio
from neuralnet_tracker_traincode_torch.models import localizer as port_localizer
from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet
from neuralnet_tracker_traincode_torch.models.weights import localizer_state_dict_from_jax, localizer_variables_to_jax
from neuralnet_tracker_traincode_torch.train import localizer as port_trainer
from neuralnet_tracker_traincode_torch.train.localizer import (
    LocalizerTrainer,
    LocalizerTrainerConfig,
    run_localizer_training,
)
from tests.torch_port_helpers import jax_noise_sigma, jax_stage1_draws, leaf_rel_err, t

B, SRC = 2, 160
ROI = np.float32([[40, 50, 110, 120], [30, 20, 100, 95]])
HASFACE = np.float32([0.9, 0.1])


def _smooth(rng, n, h, w=None):
    """Smooth uint8 sources (two plane waves of up to 0.1 rad/px), (n, h, w, 1)."""
    w = h if w is None else w
    y, x = np.mgrid[:h, :w]
    out = np.zeros((n, h, w, 1), np.uint8)
    for i in range(n):
        k = rng.uniform(-0.1, 0.1, (2, 2))
        ph = rng.uniform(0, 2 * np.pi, 2)
        out[i, ..., 0] = np.round(127.5 + 63.5 * (np.sin(k[0, 0] * x + k[0, 1] * y + ph[0])
                                                  + np.sin(k[1, 0] * x + k[1, 1] * y + ph[1])))
    return out


@functools.cache
def jax_localizer(seed: int = 0):
    """The JAX `LocalizerNet` and its variables as numpy trees, every
    parameter with 0.05 N(0, 1) added and the BatchNorm statistics
    randomised, so that unit scales and identity statistics hide no mapping
    fault."""
    model = JLoc()
    init = jax.jit(lambda key: model.init({"params": key}, jnp.zeros((2, 224, 288, 1)), train=True))
    variables = init(jax.random.PRNGKey(seed))  # jitted: the eager init takes three times as long
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a))).astype(np.float32), variables["params"])

    def stat(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    return model, {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def port_localizer_of(variables) -> LocalizerNet:
    net = LocalizerNet()
    net.load_state_dict(localizer_state_dict_from_jax(variables))
    return net


def _trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.asarray(x).shape == np.asarray(y).shape and np.array_equal(x, y), p


# ---- the network ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_localizer_forward_matches_jax(train):
    model, variables = jax_localizer()
    x = (np.random.RandomState(1).rand(2, 224, 288, 1) - 0.5).astype(np.float32)
    net = port_localizer_of(variables).train(train)
    if train:
        ref, mut = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = net(t(x))
    assert out.dtype == torch.float32 and out.shape == (2, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    if train:  # the running statistics, the ds-sep conv's at momentum 0.999 (flax) = 0.001 (torch)
        want = localizer_state_dict_from_jax({"params": variables["params"], "batch_stats": mut["batch_stats"]})
        got = net.state_dict()
        moved = 0
        for k, v in got.items():
            if k.endswith(("running_mean", "running_var")):
                assert leaf_rel_err(v.numpy(), want[k].numpy()) <= 1e-4, k
                moved += not torch.equal(v, localizer_state_dict_from_jax(variables)[k])
        assert moved == 2 * 39
        assert net.convnet[1][1].momentum == 0.001 and net.convnet[0][1].momentum == 0.1


def test_localizer_weights_bridge_is_the_reference_layout():
    """Both directions exact; the port's state dict is the reference layout
    that the JAX package's converter reads: converted by it, it gives back
    the JAX variables."""
    _, variables = jax_localizer()
    sd = localizer_state_dict_from_jax(variables)
    _trees_equal(localizer_variables_to_jax(sd), variables)
    _trees_equal(convert_localizer_state_dict({k: v.numpy() for k, v in sd.items()}), variables)
    net = LocalizerNet()
    assert set(net.state_dict()) == set(sd)
    net.load_state_dict(sd)
    assert net.boxstddev.half_size.shape == () and LocalizerNet().boxstddev.half_size.item() == 1.5
    assert LocalizerNet().get_config() == JLoc().get_config() == {}


def test_localizer_tail_runs_in_f32_under_bf16(monkeypatch):
    """dtype=bfloat16 runs the convolutions under autocast; the final conv's
    output is cast to f32 and the logit, softmax and soft-argmax stay f32."""
    _, variables = jax_localizer()
    x = t((np.random.RandomState(2).rand(2, 224, 288, 1) - 0.5).astype(np.float32))
    seen = []
    center = port_localizer.center_of_mass_and_std

    def spy(attn, half_size):
        seen.append((attn.dtype, torch.is_autocast_enabled("cpu")))
        return center(attn, half_size)

    monkeypatch.setattr(port_localizer, "center_of_mass_and_std", spy)
    net = port_localizer_of(variables).eval()
    net.dtype = torch.bfloat16
    with torch.no_grad():
        out = net(x)
        net.dtype = torch.float32
        ref = net(x)
    assert seen[0] == (torch.float32, False) and out.dtype == torch.float32
    assert not torch.equal(out, ref) and float((out - ref).abs().max()) < 0.1
    assert torch.allclose(LocalizerNet.inference_outputs(out)["hasface"], torch.sigmoid(out[:, 0]))


def test_center_of_mass_matches_jax():
    from neuralnet_tracker_traincode_tpu.models.components import center_of_mass_and_std as jcms
    from neuralnet_tracker_traincode_torch.models.components import center_of_mass_and_std

    rng = np.random.RandomState(3)
    p = rng.rand(3, 14, 18).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    ref = jcms(jnp.asarray(p), 1.5)
    out = center_of_mass_and_std(t(p), torch.tensor(1.5))
    for a, b in zip(out, ref):  # f32 sums of 252 products in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


# ---- losses ------------------------------------------------------------------


def test_localizer_losses_match_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(6, 5).astype(np.float32) * 2
    sample = {"hasface": np.float32([0.9, 0.1, 0.9, 0.1, 0.9, 0.9]),
              "roi": rng.uniform(-1, 1, (6, 4)).astype(np.float32)}
    sample["roi"][0] = pred[0, 1:] + 0.01  # inside smooth-L1's quadratic zone
    face = {"hasface_logits": pred[:, 0]}
    for jloss, tloss, p in ((JL.LocalizerProbLoss(), TL.LocalizerProbLoss(), pred),
                            (JL.LocalizerBoxLoss(), TL.LocalizerBoxLoss(), pred),
                            (JL.HasFaceLoss(), TL.HasFaceLoss(), face)):
        ref = np.asarray(jloss(jax.tree_util.tree_map(jnp.asarray, p), {k: jnp.asarray(v) for k, v in sample.items()}))
        out = tloss({k: t(v) for k, v in p.items()} if isinstance(p, dict) else t(p), {k: t(v) for k, v in sample.items()})
        assert out.shape == (6,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


# ---- augmentation ------------------------------------------------------------


def jax_localizer_draws(key, B_: int, cfg) -> LocalizerAugParameters:
    """Every draw of the JAX `augment_batch_for_localizer(key, ...)`, as the
    port's parameters; noise seeds are free."""
    k_scale, k_transl, k_flip, k_intensity = jax.random.split(key, 4)
    scales = np.clip(np.asarray(jax.random.normal(k_scale, (B_,))) * cfg.scale_jitter, -1.0, 2.0) + cfg.extension_factor
    transl = np.clip(np.asarray(jax.random.normal(k_transl, (B_, 2))) * 0.5, -1.0, 1.0)
    do_flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (B_,)))
    stage1 = noise = None
    if cfg.enable_image_aug:
        k1, k2 = jax.random.split(k_intensity)
        stage1 = jax_stage1_draws(k1, B_)
        noise = TI.NoiseParameters(t(jax_noise_sigma(k2, B_)), torch.arange(777, 777 + B_, dtype=torch.int32))
    return LocalizerAugParameters(t(scales.astype(np.float32)), t(transl.astype(np.float32)), t(do_flip), stage1, noise)


def _aug_batch(seed, n=B):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(20, 60, (n, 2))
    roi = np.concatenate([lo, lo + rng.uniform(40, 80, (n, 2))], -1).astype(np.float32)
    return _smooth(rng, n, SRC), roi, np.where(np.arange(n) % 2 == 0, 0.9, 0.1).astype(np.float32)


@pytest.mark.parametrize("seed,deterministic", [(0, False), (1, False), (2, True)])
def test_augment_for_localizer_matches_jax(seed, deterministic):
    images, roi, hasface = _aug_batch(seed, 4)
    key = jax.random.PRNGKey(seed)
    kw = dict(enable_image_aug=False, deterministic=deterministic)
    ref_x, ref_l = jax_augment(key, jnp.asarray(images), {"roi": jnp.asarray(roi), "hasface": jnp.asarray(hasface)},
                               JCfg(**kw))
    draws = jax_localizer_draws(key, 4, JCfg(**kw))
    x, labels = augment_batch_for_localizer(images, {"roi": roi, "hasface": hasface}, TCfg(**kw),
                                            params=None if deterministic else draws, device="cpu")
    assert x.shape == (4, 224, 288, 1)
    assert np.abs(x.numpy() - np.asarray(ref_x)).max() * 256 <= 1e-3
    np.testing.assert_allclose(labels["roi"].numpy(), np.asarray(ref_l["roi"]), atol=1e-5, rtol=0)
    assert torch.equal(labels["hasface"], t(hasface))


@pytest.mark.parametrize("seed", [3, 6])
def test_augment_for_localizer_with_image_aug_matches_jax_pieces(seed):
    """Image augmentation on: the reference is the JAX package's geometry-only
    crop, its stage 1 from the same key and its noise kernel body on the
    port's Philox bits. An equalize bin may flip on crops that differ by float
    noise: one gray level (1/255) at most, 1e-4 on the mean. The whitening's
    -0.5 is K3's offset."""
    images, roi, hasface = _aug_batch(seed, 4)
    key = jax.random.PRNGKey(seed)
    labels = {"roi": jnp.asarray(roi), "hasface": jnp.asarray(hasface)}
    geo_x, ref_l = jax_augment(key, jnp.asarray(images), labels, JCfg(enable_image_aug=False))
    draws = jax_localizer_draws(key, 4, JCfg())
    k1, _ = jax.random.split(jax.random.split(key, 4)[3])
    y = JI.intensity_augmentation_stage1(k1, geo_x + 0.5)[..., 0]
    P = 224 * 288
    bits1, bits2 = (b.numpy().reshape(4, 224, 288) for b in philox_bits(draws.noise.seeds, P))
    y = add_gaussian_noise_from_bits(y, jnp.asarray(bits1), jnp.asarray(bits2),
                                     jnp.asarray(draws.noise.sigma.numpy()), interpret=True)
    ref = np.asarray(y)[..., None] - 0.5
    seen = []

    def spy(x, stage1, noise, offset):
        seen.append(offset)
        return TI.intensity_augmentation(x, stage1, noise, offset)

    import neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline as LP

    orig, LP.intensity_augmentation = LP.intensity_augmentation, spy
    try:
        x, out_l = augment_batch_for_localizer(images, {"roi": roi, "hasface": hasface}, TCfg(), params=draws,
                                               device="cpu")
    finally:
        LP.intensity_augmentation = orig
    assert seen == [-0.5]
    d = np.abs(ref - x.numpy())
    assert d.max() <= 1.0 / 255.0 + 1e-5 and d.mean() < 1e-4, (d.max(), d.mean())
    np.testing.assert_allclose(out_l["roi"].numpy(), np.asarray(ref_l["roi"]), atol=1e-5, rtol=0)


def test_sampled_localizer_parameters():
    cfg = TCfg()
    a = sample_localizer_parameters(torch.Generator().manual_seed(0), 512, cfg)
    b = sample_localizer_parameters(torch.Generator().manual_seed(0), 512, cfg)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    assert float(a.scales.min()) >= 2.2 - 1.0 and float(a.scales.max()) <= 2.2 + 2.0
    assert abs(float(a.scales.std()) - 0.4) < 0.05 and float(a.translations.abs().max()) <= 1.0
    assert 0.4 < float(a.do_flip.float().mean()) < 0.6
    assert a.stage1.masks.shape == (6, 512) and a.noise.sigma.shape == (512,)
    off = sample_localizer_parameters(None, 4, TCfg(enable_image_aug=False))
    assert off.stage1 is None and off.noise is None
    assert sample_localizer_parameters(None, 4, TCfg(deterministic=True)) == (None,) * 5


# ---- the training step ---------------------------------------------------------

E, SPE, LR = 4, 2, 1e-3


def _jax_tx():
    """The CLI's optimizer: clip 1.0 and Adam on the per-epoch table."""
    sched = jax_schedule(max(1, E // 10), 0.1, [E // 2])
    table = np.asarray([sched(e) for e in range(E)], np.float32)
    epoch_ids = np.arange(E)

    def lr_fn(step):
        epoch = jnp.clip(step // SPE, 0, E - 1)
        return LR * jnp.sum(jnp.where(epoch_ids == epoch, table, 0.0))

    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr_fn)), lr_fn


@functools.cache
def jax_step(image_aug: bool):
    """One step of `train_localizer`'s `train_step` (f32), with its inputs,
    crop and labels."""
    model, variables = jax_localizer()
    cfg = JCfg(enable_image_aug=image_aug)
    tx, _ = _jax_tx()
    prob_loss, box_loss = JL.LocalizerProbLoss(), JL.LocalizerBoxLoss()

    @jax.jit
    def train_step(params, batch_stats, opt_state, batch, key, step):
        key = jax.random.fold_in(key, step)
        x, labels = jax_augment(key, batch["image"], {"roi": batch["roi"], "hasface": batch["hasface"]}, cfg)

        def loss_fn(p):
            pred, mut = model.apply({"params": p, "batch_stats": batch_stats}, x, train=True, mutable=["batch_stats"])
            return jnp.mean(prob_loss(pred, labels)) + jnp.mean(box_loss(pred, labels)), mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, loss, x, labels

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    images = _smooth(np.random.RandomState(5), B, SRC)
    batch = {"image": jnp.asarray(images), "roi": jnp.asarray(ROI), "hasface": jnp.asarray(HASFACE)}
    key = jax.random.PRNGKey(3)
    new_p, new_s, new_opt, loss, x, labels = train_step(params, variables["batch_stats"], tx.init(params), batch, key, 0)
    adam = new_opt[1][0]
    sd = lambda p, s=variables["batch_stats"]: localizer_state_dict_from_jax(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, p), "batch_stats": jax.tree_util.tree_map(np.asarray, s)})
    return dict(
        variables=variables, images=images, loss=float(loss), new=sd(new_p, new_s), mu=sd(adam.mu), nu=sd(adam.nu),
        draws=jax_localizer_draws(jax.random.fold_in(key, 0), B, cfg), cfg=cfg,
        crop=(t(np.asarray(x)), {k: t(np.asarray(v)) for k, v in labels.items()}),
    )


def _port_step(ref, image_aug):
    net = port_localizer_of(ref["variables"])
    cfg = LocalizerTrainerConfig(batchsize=B, lr=LR, epochs=E, samples_per_epoch=SPE * B, aug=TCfg(enable_image_aug=image_aug))
    trainer = LocalizerTrainer(net, cfg, device="cpu")
    state = trainer.init_state(state_dict=localizer_state_dict_from_jax(ref["variables"]))
    state, loss = trainer.train_step(state, {"image": ref["images"], "roi": ROI, "hasface": HASFACE},
                                     aug_params=ref["draws"])
    return trainer, state, loss


# The BatchNorm biases whose gradient is zero: the ds-sep conv's last and the
# last of inverted residuals 0-8, which reach a BatchNorm in train mode only
# through a 1x1 conv (residuals 9-11 reach the final conv through the skip
# connections). In float64 their gradient is 1e-16 to 1e-19 of the whole.
_NULL = ("convnet.1.4.bias",) + tuple(f"convnet.{i}.layers.7.bias" for i in range(2, 11))


def _check_step(ref, trainer, state, loss, leaf_limit, all_limit):
    assert state.step == 1 and state.opt_state.count == 1
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=3e-4)
    got = trainer.model.state_dict()
    for k, v in got.items():
        if k.endswith(("running_mean", "running_var")):
            assert leaf_rel_err(v.numpy(), ref["new"][k].numpy()) <= 1e-4, k
    mu, nu = state.opt_state.mu, state.opt_state.nu
    whole = np.linalg.norm(np.concatenate([v.numpy().ravel() for v in ref["mu"].values()]))
    for k in trainer.params():
        if k in _NULL:
            assert max(np.linalg.norm(mu[k].numpy()), np.linalg.norm(ref["mu"][k].numpy())) <= 1e-8 * whole, k
            continue
        assert leaf_rel_err(mu[k].numpy(), ref["mu"][k].numpy()) <= leaf_limit, k
        assert leaf_rel_err(nu[k].numpy(), ref["nu"][k].numpy()) <= 2 * leaf_limit, k
    keys = [k for k in trainer.params() if k not in _NULL]
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in keys])  # noqa: E731
    assert leaf_rel_err(flat(mu), flat(ref["mu"])) <= all_limit


def test_localizer_train_step_matches_jax():
    """Geometry-only augmentation, each package cropping with the same draws."""
    _check_step(jax_step(False), *_port_step(jax_step(False), False), leaf_limit=0.2, all_limit=0.1)


def test_localizer_train_step_on_the_jax_crop_matches_jax(monkeypatch):
    """Image augmentation on (the CLI's default): the port's step on the JAX
    package's crop and labels of that step."""
    ref = jax_step(True)
    x, labels = ref["crop"]
    monkeypatch.setattr(port_trainer, "augment_batch_for_localizer", lambda *a, **k: (x, dict(labels)))
    _check_step(ref, *_port_step(ref, True), leaf_limit=0.2, all_limit=0.1)


def test_localizer_learning_rate_follows_the_cli_table():
    _, lr_fn = _jax_tx()
    trainer = LocalizerTrainer(LocalizerNet(), LocalizerTrainerConfig(batchsize=B, lr=LR, epochs=E,
                                                                      samples_per_epoch=SPE * B), device="cpu")
    assert set(trainer.tx.groups.values()) == {"main"}
    for step in range(SPE * E + 3):
        np.testing.assert_allclose(trainer.tx.learning_rate(step, "main"), float(lr_fn(step)), rtol=1e-6)


def test_localizer_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert LocalizerTrainer(LocalizerNet(), LocalizerTrainerConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalizerTrainer(LocalizerNet(), LocalizerTrainerConfig())


def test_run_localizer_training_writes_last_ckpt(tmp_path):
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.batch import frame
    from neuralnet_tracker_traincode_torch.data.loader import iterate_fused_batches, pack_fused_batch
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler

    images, roi, hasface = _aug_batch(7, 4)
    frames = [frame(Tag.FACE_DETECTION, dict(image=images[i], roi=roi[i], hasface=np.asarray(hasface[i] > 0.5)))
              for i in range(4)]
    packed = pack_fused_batch(frames, [0] * 4, SRC)
    sampler = make_concat_dataset_item_sampler(ConcatDataset([frames]), [1.0], seed=1)
    net = LocalizerNet()
    trainer = LocalizerTrainer(net, LocalizerTrainerConfig(batchsize=2, epochs=2, samples_per_epoch=4), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    lines = []
    state, records = run_localizer_training(trainer, state, iterate_fused_batches(packed, 2, sampler, device="cpu"),
                                            str(tmp_path), torch.Generator().manual_seed(2), log=lines.append)
    assert state.step == 4 and len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    assert lines[0].startswith("epoch 1/2: loss ") and lines[-1].startswith("Saved localizer")
    loaded = tio.load_model(str(tmp_path / "last.ckpt"), [LocalizerNet])
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[k], v), k


# ---- the model file --------------------------------------------------------------


def test_localizer_file_is_the_jax_file(tmp_path):
    """Same weights, same bytes; each package loads the other's file."""
    model, variables = jax_localizer()
    net = port_localizer_of(variables)
    tio.save_model(net, None, str(tmp_path / "port.ckpt"))
    jio.save_model(model, variables, str(tmp_path / "jax.ckpt"))
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    jm, jvars = jio.load_posenet(str(tmp_path / "port.ckpt"))
    assert isinstance(jm, JLoc)
    _trees_equal(jvars, variables)
    loaded = tio.load_posenet(str(tmp_path / "jax.ckpt"))
    assert isinstance(loaded, LocalizerNet) and not loaded.training
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ---- the evaluation ----------------------------------------------------------------

SIZES = [(120, 150), (160, 100), (90, 90), (140, 140), (100, 170), (130, 110)]
CHUNK = 4


def _eval_samples():
    """Ragged smooth frames, every third without a face (hasface 0, a random box)."""
    rng = np.random.RandomState(8)
    samples = []
    for i, (h, w) in enumerate(SIZES):
        img = _smooth(rng, 1, h, w)[0]
        lo = rng.uniform(0.1, 0.4, 2) * np.float32([w, h])
        size = rng.uniform(0.3, 0.5) * min(h, w)
        samples.append(dict(image=img, roi=np.concatenate([lo, lo + size]).astype(np.float32),
                            hasface=np.float32(0.0 if i % 3 == 2 else 1.0)))
    return samples


@functools.cache
def _eval_script():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("evaluate_localizer", os.path.join(root, "scripts", "evaluate_localizer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_eval(model, variables, samples, protocol):
    """The script's loop, `eval_full` and `eval_crop` copied; returns the
    results per threshold and the face scores."""
    OUT_H, OUT_W = 224, 288
    px = np.asarray([OUT_W, OUT_H, OUT_W, OUT_H], np.float32) * 0.5
    cfg = JCfg(deterministic=True, enable_image_aug=False)

    @jax.jit
    def eval_full(images, view_roi, roi_gt):
        B_ = images.shape[0]
        tr = JAffine2d.range_remap_2d(
            view_roi[..., :2], view_roi[..., 2:], jnp.zeros((B_, 2), jnp.float32),
            jnp.broadcast_to(jnp.asarray([float(OUT_W), float(OUT_H)], jnp.float32), (B_, 2)))
        x = jax_warp_affine(images, tr, (OUT_H, OUT_W), 1) * (1.0 / 256.0) - 0.5
        pred = JLoc.inference_outputs(model.apply(variables, x, train=False))
        return x, pred["hasface"], (pred["roi"] + 1.0) * px, jax_transform_roi(tr, roi_gt)

    @jax.jit
    def eval_crop(key, images, roi_gt, hasface):
        x, labels = jax_augment(key, images, {"roi": roi_gt, "hasface": hasface}, cfg)
        pred = JLoc.inference_outputs(model.apply(variables, x, train=False))
        return x, pred["hasface"], (pred["roi"] + 1.0) * px, (labels["roi"] + 1.0) * px

    pad = max(max(s["image"].shape[:2]) for s in samples)
    metrics = {th: (JM.LocalizerIsFaceMatches(th), JM.LocalizerBoxMeanSquareErrors(th)) for th in (0.25, 0.5, 0.75)}
    scores = []
    for start in range(0, len(samples), CHUNK):
        chunk = samples[start:start + CHUNK]
        n = len(chunk)
        images = np.zeros((CHUNK, pad, pad, 1), np.uint8)
        sizes = np.zeros((CHUNK, 2), np.int32)
        roi = np.zeros((CHUNK, 4), np.float32)
        hasface = np.zeros((CHUNK,), np.float32)
        for j, s in enumerate(chunk):
            h, w = s["image"].shape[:2]
            images[j, :h, :w] = s["image"]
            sizes[j] = (w, h)
            roi[j] = s["roi"]
            hasface[j] = s["hasface"]
        if protocol == "full":
            _, score, pred_roi, gt_roi = eval_full(images, _eval_script()._aspect_corrected_full_roi(sizes), roi)
        else:
            _, score, pred_roi, gt_roi = eval_crop(jax.random.PRNGKey(0), images, roi, hasface)
        preds = {"hasface": np.asarray(score)[:n], "roi": np.asarray(pred_roi)[:n]}
        targets = {"hasface": hasface[:n], "roi": np.asarray(gt_roi)[:n]}
        scores.append(preds["hasface"])
        for acc, mse in metrics.values():
            acc.update(preds, targets)
            mse.update(preds, targets)
    out = {}
    for th, (acc_m, mse_m) in metrics.items():
        err = np.asarray(mse_m.compute())
        err = err[np.isfinite(err)]
        out[th] = (float(np.average(np.asarray(acc_m.compute(), np.float64))),
                   float(np.sqrt(np.average(err.ravel()))) if err.size else float("nan"))
    return out, np.concatenate(scores)


@pytest.mark.parametrize("protocol", ["full", "crop"])
def test_localizer_eval_matches_jax_script(protocol):
    model, variables = jax_localizer(1)
    samples = _eval_samples()
    ref, scores = _jax_eval(model, variables, samples, protocol)
    # no face score within 1e-3 of a threshold, where float noise could flip a match
    assert min(abs(s - th) for s in scores for th in (0.25, 0.5, 0.75)) > 1e-3
    out = LocalizerEvaluator(port_localizer_of(variables), device="cpu").evaluate(samples, protocol, batchsize=CHUNK)
    assert list(out) == [0.25, 0.5, 0.75]
    for th in out:
        np.testing.assert_allclose(out[th], ref[th], atol=1e-3, rtol=0, err_msg=str(th))
    assert any(np.isfinite(rmse) for _, rmse in out.values())
    lines = result_lines(out).splitlines()
    assert len(lines) == 3 and lines[1].startswith("Threshold 0.5 => Acc ") and lines[1].endswith(" px")


def test_aspect_corrected_full_roi_matches_the_script():
    sizes = np.asarray([[150, 120], [100, 160], [288, 224]], np.int32)
    np.testing.assert_array_equal(aspect_corrected_full_roi(sizes), _eval_script()._aspect_corrected_full_roi(sizes))
