"""The pose network's other backbones in the port against the JAX package:
resnet18 (with and without BlurPool), efficientnet_b0 (the CPU's stand-in for
b0-b4, which differ only in widths and depths) and hybrid_vit, each inside
`NetworkWithPointHead` with the point head and the NLL heads; the face
detector head on one of them. B = 2, inputs from seeded numpy. Tolerances:

 - the eval forward: <= 1e-4 absolute on every output;
 - the weight bridge: the port's state dict of the JAX variables is, key for
   key and bit for bit, the JAX package's `export_posenet_state_dict`, it is
   the port module's own key set, and the way back gives the variables;
 - one training step with dropout and stochastic depth off in both packages
   (the port's step on a crop given to both, the flagship 8-term criterion,
   the JAX loss and update copied from its `PoseTrainer._step_fn`, Adam with
   its groups: hybrid_vit's transformer at 0.01x with weight decay). The
   metrics to 1e-4 relative (1e-3 for quatreg), the BatchNorm statistics to
   1e-4 per leaf. The first moment: against the float64 gradient on that
   crop, the f32 clipped gradients of both packages are off by up to 3e-3
   (resnet18: 2.9e-3 on `layers.4.1.bn1.bias` in each), 6e-5 (efficientnet)
   and 3.7e-3 (hybrid_vit, JAX; the port 6.8e-4). The port's first moment
   agrees with the JAX one to 1.2e-5 / 8.3e-5 / 3.7e-3 on the worst leaf and
   1.5e-6 / 1.2e-5 / 1.5e-4 over all leaves. Limits (resnet18, efficientnet,
   hybrid_vit): 1e-3 / 1e-3 / 1e-2 per leaf (twice that for nu) and
   1e-4 / 1e-4 / 1e-3 over all leaves. efficientnet's 16 projection
   BatchNorm biases have no gradient (float64: zero): both packages' first
   moments there are below 3e-11 of the whole (limit 1e-8);
 - dropout and stochastic depth, on: every mask at its rate (means over
   many draws), drawn from the generator the forward is given.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralnet_tracker_traincode_tpu.models import posenet as JP
from neuralnet_tracker_traincode_tpu.models.backbones.efficientnet import EfficientNetBackbone as JEff
from neuralnet_tracker_traincode_tpu.models.backbones.hybrid_vit import HybridVitBackbone as JVit
from neuralnet_tracker_traincode_tpu.models.torch_export import export_posenet_state_dict
from neuralnet_tracker_traincode_tpu.train.loop import make_optimizer as jax_make_optimizer
from neuralnet_tracker_traincode_torch.models.backbones import common as C
from neuralnet_tracker_traincode_torch.models.backbones import hybrid_vit as TV
from neuralnet_tracker_traincode_torch.models.backbones.efficientnet import MBConv, EfficientNetBackbone
from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead as TNet
from neuralnet_tracker_traincode_torch.models.posenet import create_pose_estimator_backbone
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax, posenet_variables_to_jax
from neuralnet_tracker_traincode_torch.train import loop as port_loop
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
from tests.torch_port_helpers import flagship_criteria, leaf_rel_err, normalized_labels, t

HEADS = dict(enable_point_head=True, enable_uncertainty=True)
NETS = {
    "resnet18": dict(HEADS, config="resnet18"),
    "resnet18_blurpool": dict(HEADS, config="resnet18", backbone_args={"use_blurpool": True},
                              enable_face_detector=True),
    "efficientnet_b0": dict(HEADS, config="efficientnet_b0"),
    "hybrid_vit": dict(HEADS, config="hybrid_vit"),
}
OUTPUTS = ("coord", "roi", "pose", "pt3d_68", "shapeparam", "pose_scales_tril", "coord_scales")


@functools.cache
def jax_net(name: str, seed: int = 0):
    """The JAX network and variables of the tree that its `init` makes (its
    structure and shapes checked against `jax.eval_shape` of that init, which
    compiles nothing), made by the port's init through the bridge, every
    parameter with 0.05 N(0, 1) added and the BatchNorm statistics
    randomised, so that zero biases, unit scales and identity statistics
    hide no mapping fault."""
    net = NETS[name]
    model = JP.NetworkWithPointHead(**net)
    shapes = jax.eval_shape(lambda key: model.init(key, jnp.zeros((2, 129, 129, 1)), train=False,
                                                   coord_convention_id=jnp.zeros((2,), jnp.int32)), jax.random.PRNGKey(0))
    port = TNet(**net)
    port.init_weights(torch.Generator().manual_seed(seed))
    variables = posenet_variables_to_jax(port.state_dict(), net)
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(shapes)
    for (path, a), (_, b) in zip(*(jax.tree_util.tree_leaves_with_path(v) for v in (variables, shapes))):
        assert np.shape(a) == b.shape, path
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a))).astype(np.float32), variables["params"])

    def stat(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    return model, {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def port_net(name: str, variables) -> TNet:
    model = TNet(**NETS[name])
    model.load_state_dict(posenet_state_dict_from_jax(variables, NETS[name]))
    return model


def _x(seed, n=2):
    return (np.random.RandomState(seed).rand(n, 129, 129, 1) - 0.5).astype(np.float32)


@pytest.mark.parametrize("name", list(NETS))
def test_backbone_forward_matches_jax(name):
    model, variables = jax_net(name)
    x, conv = _x(1), np.asarray([0, 3], np.int32)
    ref = jax.jit(functools.partial(model.apply, train=False))(variables, jnp.asarray(x), coord_convention_id=jnp.asarray(conv))
    net = port_net(name, variables).eval()
    with torch.no_grad():
        out = net(t(x), coord_convention_id=t(conv))
    keys = OUTPUTS + (("hasface", "hasface_logits") if NETS[name].get("enable_face_detector") else ())
    assert set(keys) <= set(out)
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=0, err_msg=k)
    assert net.get_config() == model.get_config()


@pytest.mark.parametrize("name", list(NETS))
def test_backbone_bridge_is_the_jax_exporter(name):
    _, variables = jax_net(name)
    sd = posenet_state_dict_from_jax(variables, NETS[name])
    ref = export_posenet_state_dict(variables, NETS[name])
    assert set(sd) == set(ref) == set(TNet(**NETS[name]).state_dict())
    for k, v in ref.items():
        assert sd[k].shape == np.shape(v) and np.array_equal(sd[k].numpy(), v), k
    back = posenet_variables_to_jax(sd, NETS[name])
    la, lb = (jax.tree_util.tree_leaves_with_path(v) for v in (back, variables))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, a), (_, b) in zip(la, lb):
        assert np.shape(a) == np.shape(b) and np.array_equal(a, b), p


def test_unknown_backbones_are_refused():
    with pytest.raises(ValueError, match="Unsupported backbone"):
        create_pose_estimator_backbone(4, "vgg", {})
    with pytest.raises(AssertionError):
        create_pose_estimator_backbone(4, "efficientnet_b7", {})
    vit = create_pose_estimator_backbone(5, "hybrid_vit", {"use_blurpool": True})
    assert vit.queries.shape == (1, 5, 256) and vit.position.shape == (1, 8, 9, 9)


# ---- one training step, dropout and stochastic depth off ----------------------

_AUG = dict(inputsize=129, enable_image_aug=False)


def _rates_off_jax(monkeypatch):
    """The JAX backbones built with dropout and stochastic depth 0."""
    build = JP.create_pose_estimator_backbone

    def without_randomness(num_heads, config, args, dtype, name="convnet"):
        if config == "hybrid_vit":
            return JVit(num_heads_out=num_heads, dropout=0.0, dtype=dtype, name=name)
        if config.startswith("efficientnet_"):
            return JEff(kind=config[len("efficientnet_"):], stochastic_depth_prob=0.0, dtype=dtype, name=name)
        return build(num_heads, config, args, dtype, name)

    monkeypatch.setattr(JP, "create_pose_estimator_backbone", without_randomness)


def _rates_off_port(model):
    for mod in model.modules():
        if isinstance(mod, MBConv):
            mod.sd_prob = 0.0
        for attr in ("rate", "dropout_rate"):
            if hasattr(mod, attr):
                setattr(mod, attr, 0.0)
    return model


def _jax_step(name, x, labels, monkeypatch):
    """Loss, metrics, new statistics and Adam moments of one step of the JAX
    `PoseTrainer._step_fn` on the crop `x` (its augmentation left out)."""
    _rates_off_jax(monkeypatch)
    _, variables = jax_net(name)
    model = JP.NetworkWithPointHead(**NETS[name])
    jcrit, _ = flagship_criteria()
    W = jnp.asarray(jcrit.weight_matrix(0))
    tx = jax_make_optimizer(1e-3, lambda e: 1.0, 4, 4, 1.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jl = {k: jnp.asarray(v) for k, v in labels.items()}
    tag = jnp.zeros((x.shape[0],), jnp.int32)

    def loss_fn(p):
        out, mutated = model.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                                   coord_convention_id=jl["coord_convention_id"], train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        loss, byname = jcrit(out, jl, tag, W, dataset_weight=jnp.ones((x.shape[0],)))
        return loss, (mutated["batch_stats"], byname)

    (loss, (stats, byname)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _, opt = jax.jit(tx.update)(grads, jax.jit(tx.init)(params), params)
    inner = opt[1].inner_states
    masked = lambda *ls: next(np.asarray(v) for v in ls if not isinstance(v, optax.MaskedNode))  # noqa: E731
    merge = lambda trees: jax.tree_util.tree_map(  # noqa: E731
        masked, *trees, is_leaf=lambda v: isinstance(v, optax.MaskedNode))
    adam = [inner[g].inner_state[0] for g in ("main", "variance", "transformer")]
    to_sd = lambda p, s=variables["batch_stats"]: posenet_state_dict_from_jax(  # noqa: E731
        {"params": p, "batch_stats": jax.tree_util.tree_map(np.asarray, s)}, NETS[name])
    metrics = {"loss": float(loss)}
    metrics.update({k: float(jnp.sum(v) / jnp.maximum(jnp.sum(w != 0), 1)) for k, (v, w) in byname.items()})
    return dict(metrics=metrics, stats=to_sd(variables["params"], stats),
                mu=to_sd(merge([a.mu for a in adam])), nu=to_sd(merge([a.nu for a in adam])))


def _port_step(name, x, labels, monkeypatch):
    _, variables = jax_net(name)
    _, tcrit = flagship_criteria()
    trainer = PoseTrainer(_rates_off_port(port_net(name, variables)), tcrit,
                          TrainerConfig(batchsize=2, lr=1e-3, epochs=4, samples_per_epoch=8,
                                        aug=TrainAugmentationConfig(**_AUG)),
                          LABEL_CATEGORIES, lambda e: 1.0, device="cpu")
    state = trainer.init_state(state_dict=posenet_state_dict_from_jax(variables, NETS[name]))
    monkeypatch.setattr(port_loop, "augment_batch_for_training",
                        lambda *a, **k: (t(x), {k: t(v) for k, v in labels.items()}))
    batch = {"image": np.zeros((2, 8, 8, 1), np.uint8), "tag_id": np.zeros((2,), np.int32),
             "dataset_weight": np.ones((2,), np.float32), "param_index": np.arange(2, dtype=np.int32)}
    state, metrics = trainer.train_step(state, batch, trainer.weight_matrix(0), generator=torch.Generator())
    return trainer, state, metrics


def _labels(seed):
    labels = normalized_labels(np.random.RandomState(seed), 2)
    labels["coord_convention_id"] = np.zeros((2,), np.int32)
    return labels


def _null_leaves(model) -> set:
    """The leaves whose gradient is zero: efficientnet's projection BatchNorm
    biases, which reach a BatchNorm in train mode only through a 1x1 conv
    (the next block's expansion, or the head) and the skip connections."""
    return {f"{name}.block.{len(mod.block) - 1}.1.bias" for name, mod in model.named_modules() if isinstance(mod, MBConv)}


# per backbone: (worst leaf of the first moment, all leaves); see the module doc
STEP_LIMITS = {"resnet18": (1e-3, 1e-4), "efficientnet_b0": (1e-3, 1e-4), "hybrid_vit": (1e-2, 1e-3)}


@pytest.mark.parametrize("name", list(STEP_LIMITS))
def test_backbone_train_step_matches_jax(name, monkeypatch):
    x, labels = _x(4), _labels(4)
    ref = _jax_step(name, x, labels, monkeypatch)
    trainer, state, metrics = _port_step(name, x, labels, monkeypatch)
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-3 if k == "quatreg" else 1e-4, err_msg=k)
    for k, v in trainer.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert leaf_rel_err(v.numpy(), ref["stats"][k].numpy()) <= 1e-4, k
    leaf_limit, all_limit = STEP_LIMITS[name]
    mu, nu = state.opt_state.mu, state.opt_state.nu
    whole = np.linalg.norm(np.concatenate([v.numpy().ravel() for v in ref["mu"].values()]))
    null = _null_leaves(trainer.model)
    errs = {}
    for k in trainer.params():
        if k in null:
            assert max(np.linalg.norm(mu[k].numpy()), np.linalg.norm(ref["mu"][k].numpy())) <= 1e-8 * whole, k
            continue
        errs[k] = leaf_rel_err(mu[k].numpy(), ref["mu"][k].numpy())
        assert errs[k] <= leaf_limit, (k, errs[k])
        assert leaf_rel_err(nu[k].numpy(), ref["nu"][k].numpy()) <= 2 * leaf_limit, k
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in errs])  # noqa: E731
    assert leaf_rel_err(flat(mu), flat(ref["mu"])) <= all_limit


# ---- dropout and stochastic depth ---------------------------------------------------


def test_dropout_keeps_at_its_rate_and_scales():
    x = torch.ones(200_000)
    out = C.dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 3e-3
    assert torch.allclose(out[kept], torch.tensor(1 / 0.9)) and torch.equal(C.dropout(x, 0.1, False, None), x)


def test_hybrid_vit_dropout_masks_at_rate_from_the_generator(monkeypatch):
    """Ten dropouts in a train-mode forward (the encoder's attention weights,
    its two residual branches and its feed-forward hidden layer; the
    decoder's two attention weights, three branches and hidden layer), each
    at 0.1; the masks follow the generator and leave torch's global one alone."""
    calls = []

    def spy(x, rate, training, generator):
        out = C.dropout(x, rate, training, generator)
        calls.append((rate, training, float((out[x != 0] != 0).float().mean()), x.numel()))
        return out

    monkeypatch.setattr(TV, "dropout", spy)
    net = TNet(**NETS["hybrid_vit"])
    net.init_weights(torch.Generator().manual_seed(0))
    x = t(_x(5, 16))
    net.train()
    state = torch.get_rng_state()
    a = net(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), state)
    assert len(calls) == 10 and all(r == 0.1 and tr for r, tr, *_ in calls)
    big = [kept for *_, kept, n in calls if n >= 16 * 82 * 256]
    assert len(big) == 4 and all(abs(k - 0.9) < 5e-3 for k in big)
    b = net(x, generator=torch.Generator().manual_seed(1))
    c = net(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a["coord"], b["coord"]) and not torch.equal(a["coord"], c["coord"])
    net.eval()
    calls.clear()
    with torch.no_grad():
        e1 = net(x, generator=torch.Generator().manual_seed(1))["coord"]
        e2 = net(x, generator=torch.Generator().manual_seed(2))["coord"]
    assert torch.equal(e1, e2) and all(not tr for _, tr, *_ in calls)


def test_efficientnet_stochastic_depth_at_rate_from_the_generator():
    """0.1 x block_id / 16 on the residual blocks of b0; one block at 0.3:
    the fraction of samples whose residual branch is dropped, and the kept
    ones scaled by 1 / 0.7."""
    eff = EfficientNetBackbone("b0")
    blocks = [b for stage in eff.layers[1:-1] for b in stage]
    assert len(blocks) == 16
    assert [b.sd_prob for b in blocks] == [0.1 * i / 16 for i in range(16)]
    block = MBConv(16, 6, 3, 1, 16, sd_prob=0.3).train()
    x = torch.randn((4000, 16, 2, 2), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h = block.block(x)
        out = block(x, torch.Generator().manual_seed(3))
        again = block(x, torch.Generator().manual_seed(3))
    dropped = (out == x).flatten(1).all(1)
    assert abs(float(dropped.float().mean()) - 0.3) < 0.03 and torch.equal(out, again)
    assert torch.allclose(out[~dropped], x[~dropped] + h[~dropped] / 0.7, atol=1e-6)
    with torch.no_grad():
        block.eval()
        assert torch.equal(block(x, None), x + block.block(x))


def test_pose_trainer_passes_its_generator_to_the_network(monkeypatch):
    """The trainer's step draws the masks from its augmentation generator:
    equal seeds give equal steps, torch's global generator is not used."""
    monkeypatch.setattr(port_loop, "augment_batch_for_training",
                        lambda *a, **k: (t(_x(6)), {k: t(v) for k, v in _labels(6).items()}))
    _, tcrit = flagship_criteria()
    runs = []
    for seed in (1, 1, 2):
        net = TNet(**NETS["hybrid_vit"])
        trainer = PoseTrainer(net, tcrit, TrainerConfig(batchsize=2, aug=TrainAugmentationConfig(**_AUG)),
                              LABEL_CATEGORIES, device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        batch = {"image": np.zeros((2, 8, 8, 1), np.uint8), "tag_id": np.zeros((2,), np.int32)}
        global_state = torch.get_rng_state()
        _, metrics = trainer.train_step(state, batch, trainer.weight_matrix(0), generator=torch.Generator().manual_seed(seed))
        assert torch.equal(torch.get_rng_state(), global_state)
        runs.append(float(metrics["loss"]))
    assert runs[0] == runs[1] != runs[2]


def test_transformer_group_is_adamw_as_in_optax():
    """hybrid_vit's transformer parameters: optax.adamw at 0.01x the learning
    rate with weight decay 0.01, over four steps above and below the clip norm."""
    from neuralnet_tracker_traincode_torch.train.loop import ClippedGroupAdam, label_parameters

    rng = np.random.RandomState(0)
    shapes = {"w": (3, 4), "transformer_encoder": {"lin": (5, 2)}, "uncertainty_s": (2,)}
    init = {"w": rng.randn(3, 4), "transformer_encoder": {"lin": rng.randn(5, 2)}, "uncertainty_s": rng.randn(2)}
    init = jax.tree_util.tree_map(lambda a: a.astype(np.float32), init)
    table = [1.0, 0.5, 0.25, 2.0]
    tx = jax_make_optimizer(1e-1, lambda e: table[e], 1, 4, 1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    js = tx.init(jp)
    names = {"w": "w", "t": ("transformer_encoder", "lin"), "u": "uncertainty_s"}
    get = lambda tree, k: tree[k[0]][k[1]] if isinstance(k, tuple) else tree[k]  # noqa: E731
    opt = ClippedGroupAdam(1e-1, lambda e: table[e], 1, 4, {"w": "main", "t": "transformer", "u": "variance"}, 1.0)
    tp = {n: t(get(init, k)) for n, k in names.items()}
    ts = opt.init(tp)
    for gscale in (0.05, 3.0, 0.2, 10.0):
        g = jax.tree_util.tree_map(lambda a: (gscale * rng.randn(*a.shape)).astype(np.float32), init)
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.step(tp, {n: t(get(g, k)) for n, k in names.items()}, ts)
        for n, k in names.items():
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(get(jp, k)), rtol=1e-6, atol=1e-7, err_msg=n)
    groups = label_parameters(TNet(**NETS["hybrid_vit"]))
    assert {g for n, g in groups.items() if ".transformer." in n} == {"transformer"}
    assert groups["convnet.queries"] == groups["convnet.proj.0.weight"] == "main"


def test_resume_with_dropout_continues_bit_for_bit(tmp_path, monkeypatch):
    """hybrid_vit with its dropout on: one step, the resume file, one step in
    a fresh trainer gives every tensor of two straight steps; the masks
    follow the generator the file restores (another seed gives other
    weights)."""
    from neuralnet_tracker_traincode_torch.train.checkpointing import load_train_state, save_train_state

    monkeypatch.setattr(port_loop, "augment_batch_for_training",
                        lambda *a, **k: (t(_x(7)), {k: t(v) for k, v in _labels(7).items()}))
    _, tcrit = flagship_criteria()
    batch = {"image": np.zeros((2, 8, 8, 1), np.uint8), "tag_id": np.zeros((2,), np.int32)}

    def trainer(seed=0):
        tr = PoseTrainer(TNet(**NETS["hybrid_vit"]), tcrit, TrainerConfig(batchsize=2, aug=TrainAugmentationConfig(**_AUG)),
                         LABEL_CATEGORIES, device="cpu")
        return tr, tr.init_state(torch.Generator().manual_seed(seed))

    def step(tr, state, gen):
        return tr.train_step(state, batch, tr.weight_matrix(0), generator=gen)[0]

    def tensors(tr, state):
        return {**tr.model.state_dict(), **{f"mu.{k}": v for k, v in state.opt_state.mu.items()},
                **{f"nu.{k}": v for k, v in state.opt_state.nu.items()}}

    tr, state = trainer()
    g = torch.Generator().manual_seed(3)
    want = tensors(tr, step(tr, step(tr, state, g), g))
    tr1, state1 = trainer()
    g1 = torch.Generator().manual_seed(3)
    save_train_state(tr1, step(tr1, state1, g1), str(tmp_path / "resume.pt"), generator=g1)
    tr2, _ = trainer(seed=5)
    g2 = torch.Generator().manual_seed(99)
    state2, _ = load_train_state(tr2, str(tmp_path / "resume.pt"), g2)
    got = tensors(tr2, step(tr2, state2, g2))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    tr3, state3 = trainer()
    other = tensors(tr3, step(tr3, step(tr3, state3, torch.Generator().manual_seed(4)), torch.Generator().manual_seed(4)))
    assert not torch.equal(other["convnet.queries"], want["convnet.queries"])
