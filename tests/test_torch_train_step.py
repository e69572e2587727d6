"""Parity of the port's training step with the JAX package's.

 - The optimizer alone: the port's clip + grouped Adam against the JAX
   package's optax chain over four steps, on gradients above and below the
   clip norm and a schedule that changes every step (so the learning rate of
   the pre-increment count is checked). f32 on both sides: 1e-6 relative.
 - One full `train_step` of both packages (widen 0.25, B=8, geometry-only
   augmentation with the same injected draws, one-device JAX mesh) from the
   same weights. Loss and metrics: 1e-4 relative (quatreg = (1 - |q|)^2
   magnifies the relative error of |q| by 2|q| / |1 - |q||, so 1e-3).
   BatchNorm running statistics: 1e-4 per leaf.

The gradients of the first layers (conv1, bn1, dw2_1) are the small residue
of sums over B x 65 x 65 positions, and every ReLU mask that flips moves it:
in float64, a random input change of 1e-8 / 1e-7 / 1e-5 of the crop's norm
moves the gradient by 2e-7 / 1e-4 / 3e-2 (relative), while the heads' move
linearly. The two packages' crops differ by up to 0.007 gray here (K1's plain
version against the XLA warp, held to 0.02 in `test_torch_kernels_plain.py`),
so the Adam moments are compared twice, each against limits set between the
sound runs and deliberately wrong steps (first moment mu = 0.1 x the clipped
gradient, nu = 1e-3 x its square):

 - each package on its own crop: mu agrees to 3.6e-2 on the worst leaf and
   2.4e-2 over all leaves (up to 0.12 and 4.3e-2 at other seeds), nu to
   6.1e-2 on the worst leaf; a step on half the batch, with unflipped
   labels, with the rotation's sign flipped or with one ROI moved by 2 px
   reads >= 0.46 over all leaves and >= 1.4 on the worst. Limits: 0.1 per
   leaf (0.2 for nu) and 0.1 over all leaves.
 - the port's step on the JAX package's crop and labels: mu agrees to
   1.1e-2 on the worst leaf (<= 1.4e-2 at other seeds) and nu to 9.6e-3.
   That is the f32 floor here: against a float64 gradient on that crop, the
   port's f32 one is off by 1.1e-2 and the JAX one by 3.4e-3. A 5% scale
   error in the coord labels reads 6.0e-2 on its worst leaf. Limits: 3e-2
   per leaf (6e-2 for nu) and 1e-2 over all leaves.

Adam's first update has size lr for every element whose gradient is not ~0,
so per leaf the mean |update| agrees to 5e-3 (it pins learning rate, group
and schedule) and the signs agree on 90% of the elements (elements whose
gradient is below the f32 noise take either sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation.pipeline import TrainAugmentationConfig as JCfg
from neuralnet_tracker_traincode_tpu.augmentation.pipeline import augment_batch_for_training as jax_augment
from neuralnet_tracker_traincode_tpu.data.loader import LABEL_CATEGORIES as JCATS
from neuralnet_tracker_traincode_tpu.parallel.mesh import make_mesh, shard_batch
from neuralnet_tracker_traincode_tpu.train.loop import (
    PoseTrainer as JTrainer,
    TrainerConfig as JTrainerConfig,
    make_optimizer as jax_make_optimizer,
)
from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig as TCfg
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES as TCATS
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax
from neuralnet_tracker_traincode_torch.train import loop as port_loop
from neuralnet_tracker_traincode_torch.train.loop import (
    ClippedGroupAdam,
    PoseTrainer as TTrainer,
    TrainerConfig as TTrainerConfig,
    label_parameters,
)
from tests.torch_port_helpers import (
    LABEL_KEYS,
    SMALL_NET,
    flagship_criteria,
    jax_augmentation_draws,
    jax_posenet_variables,
    leaf_rel_err,
    make_batch,
    t,
    torch_posenet,
)

B, SRC = 8, 160
_TABLE = [1.0, 0.5, 0.25, 2.0]


def test_clipped_group_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"w": (3, 4), "b": (4,), "uncertainty_s": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_make_optimizer(1e-2, lambda e: _TABLE[e], 1, len(_TABLE), 1.0)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    groups = {"w": "main", "b": "main", "uncertainty_s": "variance"}
    opt = ClippedGroupAdam(1e-2, lambda e: _TABLE[e], 1, len(_TABLE), groups, 1.0)
    tparams = {k: t(v) for k, v in init.items()}
    tstate = opt.init(tparams)
    for step, gscale in enumerate([0.05, 3.0, 0.2, 10.0]):  # global norm below and above 1
        grads = {k: (gscale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = opt.step(tparams, {k: t(v) for k, v in grads.items()}, tstate)
        assert tstate.count == step + 1
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    inner = jstate[1].inner_states
    for k, group in groups.items():
        adam = inner[group].inner_state[0]
        np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-12)


def test_variance_group_is_the_nll_scale_parameters():
    groups = label_parameters(torch_posenet(jax_posenet_variables(0, **SMALL_NET)[1], **SMALL_NET))
    variance = sorted(n for n, g in groups.items() if g == "variance")
    assert variance == sorted(
        [
            "boxnet.scales.hidden_scale",
            "posnet.scales.neck.lin.weight", "posnet.scales.neck.lin.bias",
            "quatnet.uncertainty_net.neck.lin.weight", "quatnet.uncertainty_net.neck.lin.bias",
            "landmarks.point_distrib_scales.hidden_scale", "landmarks.shape_distrib_scales.hidden_scale",
        ]
    )


def _merge_masked(trees):
    """One tree from optax's per-group masked trees."""
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    return jax.tree_util.tree_map(
        lambda *leaves: next(np.asarray(x) for x in leaves if not is_masked(x)), *trees, is_leaf=is_masked
    )


_AUG = dict(inputsize=129, enable_image_aug=False, p_flip_rot90=0.5)
_COMMON = dict(batchsize=B, lr=1e-3, epochs=4, samples_per_epoch=4 * B)


def _schedule(e):
    return _TABLE[e]


@pytest.fixture(scope="module")
def jax_step():
    """One JAX `train_step`, its inputs, and the JAX crop of that step."""
    jcrit, _ = flagship_criteria()
    jmodel, variables = jax_posenet_variables(4, **SMALL_NET)
    mesh = make_mesh(jax.devices()[:1])
    jtr = JTrainer(jmodel, jcrit, JTrainerConfig(aug=JCfg(**_AUG), **_COMMON), JCATS, _schedule, mesh=mesh)
    jstate = jtr.init_state(jax.random.PRNGKey(0), (129, 129, 1))
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
    )
    batch = make_batch(np.random.RandomState(4), B, SRC)
    rng = jax.random.PRNGKey(11)
    jnew, jmetrics = jtr.train_step(jstate, shard_batch(batch, mesh), jtr.weight_matrix(0), rng)

    # the key `train_step` hands its augmentation at step 0
    k_aug, _ = jax.random.split(jax.random.fold_in(rng, 0))
    labels = {k: jnp.asarray(batch[k]) for k in LABEL_KEYS}
    jx, jl = jax.jit(lambda k, im, lab, pi: jax_augment(k, im, lab, JCATS, JCfg(**_AUG), param_index=pi))(
        k_aug, jnp.asarray(batch["image"]), labels, jnp.asarray(batch["param_index"])
    )

    to_sd = lambda params, stats: posenet_state_dict_from_jax(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, params), "batch_stats": jax.tree_util.tree_map(np.asarray, stats)},
        SMALL_NET,
    )
    inner = jnew.opt_state[1].inner_states
    adam = [inner[g].inner_state[0] for g in ("main", "variance")]
    return dict(
        variables=variables, batch=batch, metrics=jmetrics,
        draws=jax_augmentation_draws(k_aug, B, JCfg(**_AUG)),
        crop=(t(np.asarray(jx)), {k: t(np.asarray(v)) for k, v in jl.items()}),
        new=to_sd(jnew.params, jnew.batch_stats),
        mu=to_sd(_merge_masked([a.mu for a in adam]), jnew.batch_stats),
        nu=to_sd(_merge_masked([a.nu for a in adam]), jnew.batch_stats),
        old=to_sd(variables["params"], variables["batch_stats"]),
    )


def _check_step(ref, ttr, tstate, tmetrics, old, mu_leaf, nu_leaf):
    assert tstate.step == 1 and tstate.opt_state.count == 1
    assert set(tmetrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(tmetrics[k].item(), float(v), rtol=1e-3 if k == "quatreg" else 1e-4, err_msg=k)
    got = ttr.model.state_dict()
    for k in got:
        if k.endswith(("running_mean", "running_var")):
            assert leaf_rel_err(got[k].numpy(), ref["new"][k].numpy()) <= 1e-4, k
    params = ttr.params()
    mu, nu = tstate.opt_state.mu, tstate.opt_state.nu
    for k, p in params.items():
        assert leaf_rel_err(mu[k].numpy(), ref["mu"][k].numpy()) <= mu_leaf, k
        assert leaf_rel_err(nu[k].numpy(), ref["nu"][k].numpy()) <= nu_leaf, k
        d_t, d_j = (p.detach() - old[k]).numpy(), ref["new"][k].numpy() - ref["old"][k].numpy()
        if not d_j.any():  # the scales that feed no flagship term
            assert not d_t.any(), k
            continue
        assert abs(np.abs(d_t).mean() / np.abs(d_j).mean() - 1.0) <= 5e-3, k
        assert np.mean(np.sign(d_t) == np.sign(d_j)) >= 0.9, k
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in params])  # noqa: E731
    return leaf_rel_err(flat(mu), flat(ref["mu"]))


def _port_step(ref):
    _, tcrit = flagship_criteria()
    ttr = TTrainer(torch_posenet(ref["variables"], **SMALL_NET), tcrit, TTrainerConfig(aug=TCfg(**_AUG), **_COMMON),
                   TCATS, _schedule, device="cpu")
    tstate = ttr.init_state(state_dict=posenet_state_dict_from_jax(ref["variables"], SMALL_NET))
    old = {k: v.detach().clone() for k, v in ttr.params().items()}
    tstate, tmetrics = ttr.train_step(tstate, ref["batch"], ttr.weight_matrix(0), aug_params=ref["draws"])
    return ttr, tstate, tmetrics, old


def test_one_train_step_matches_jax(jax_step):
    """Each package augments the batch itself."""
    assert _check_step(jax_step, *_port_step(jax_step), mu_leaf=0.1, nu_leaf=0.2) <= 0.1


def test_one_train_step_on_the_jax_crop_matches_jax(jax_step, monkeypatch):
    """The port's step on the JAX package's crop and labels of that step."""
    x, labels = jax_step["crop"]
    monkeypatch.setattr(port_loop, "augment_batch_for_training", lambda *a, **k: (x, dict(labels)))
    assert _check_step(jax_step, *_port_step(jax_step), mu_leaf=3e-2, nu_leaf=6e-2) <= 1e-2


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    _, tcrit = flagship_criteria()
    model = torch_posenet(jax_posenet_variables(0, **SMALL_NET)[1], **SMALL_NET)
    cfg = TTrainerConfig(batchsize=B, aug=TCfg(inputsize=129))
    if torch.cuda.is_available():
        assert TTrainer(model, tcrit, cfg, TCATS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TTrainer(model, tcrit, cfg, TCATS)
    assert TTrainer(model, tcrit, cfg, TCATS, device="cpu").device.type == "cpu"
