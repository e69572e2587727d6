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

import dataclasses

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
from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_torch.augmentation.pipeline import sample_augmentation_parameters
from neuralnet_tracker_traincode_torch.data.fields import Tag as TTag
from neuralnet_tracker_traincode_torch.train.run import LossOptions, setup_losses
from tests.torch_port_helpers import (
    cli_setup_losses,
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


def _jax_step(jcrit, net, swa_steps: int = 0):
    """One JAX `train_step`, its inputs, and the JAX crop of that step; then
    `swa_steps` more steps, each followed by `update_swa`."""
    jmodel, variables = jax_posenet_variables(4, **net)
    mesh = make_mesh(jax.devices()[:1])
    jtr = JTrainer(jmodel, jcrit, JTrainerConfig(aug=JCfg(**_AUG), **_COMMON), JCATS, _schedule, mesh=mesh)
    jstate = jtr.init_state(jax.random.PRNGKey(0), (129, 129, 1))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    jstate = jstate.replace(params=params, batch_stats=stats, swa_params=copy(params), swa_batch_stats=copy(stats))
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
        net,
    )
    inner = jnew.opt_state[1].inner_states
    adam = [inner[g].inner_state[0] for g in ("main", "variance")]
    out = dict(
        net=net, variables=variables, batch=batch, metrics=jmetrics,
        draws=jax_augmentation_draws(k_aug, B, JCfg(**_AUG)),
        crop=(t(np.asarray(jx)), {k: t(np.asarray(v)) for k, v in jl.items()}),
        new=to_sd(jnew.params, jnew.batch_stats),
        mu=to_sd(_merge_masked([a.mu for a in adam]), jnew.batch_stats),
        nu=to_sd(_merge_masked([a.nu for a in adam]), jnew.batch_stats),
        old=to_sd(variables["params"], variables["batch_stats"]),
    )
    out["trajectory"] = trajectory = []  # (variables after the step, SWA variables after the update)
    st = jnew  # read above: the steps donate their state
    for _ in range(swa_steps):
        st = jtr.update_swa(jtr.train_step(st, shard_batch(batch, mesh), jtr.weight_matrix(0), rng)[0])
        host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        trajectory.append(({"params": host(st.params), "batch_stats": host(st.batch_stats)},
                           {"params": host(st.swa_params), "batch_stats": host(st.swa_batch_stats)}))
    return out


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step(flagship_criteria()[0], SMALL_NET, swa_steps=3)


def _check_step(ref, ttr, tstate, tmetrics, old, mu_leaf, nu_leaf, loose=("quatreg",), sign_floor=False,
                size_floor=False):
    """`sign_floor`: compare the update's signs only where the JAX first
    moment exceeds mu_leaf x its leaf's RMS (the f32 noise of that leaf);
    for a leaf of 8 elements one element below the noise is 1/8.
    `size_floor`: the update's mean size too (an element whose gradient is
    noise may move by less than lr: Adam divides by |g| + 1e-8)."""
    assert tstate.step == 1 and tstate.opt_state.count == 1
    assert set(tmetrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(tmetrics[k].item(), float(v), rtol=1e-3 if k in loose else 1e-4, err_msg=k)
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
        m_j = ref["mu"][k].numpy()
        signal = np.abs(m_j) > mu_leaf * np.sqrt(np.mean(np.square(m_j)))
        sized = signal if size_floor else slice(None)
        assert abs(np.abs(d_t[sized]).mean() / np.abs(d_j[sized]).mean() - 1.0) <= 5e-3, k
        above = signal if sign_floor else slice(None)
        assert np.mean(np.sign(d_t[above]) == np.sign(d_j[above])) >= 0.9, k
    flat = lambda tree: np.concatenate([tree[k].numpy().ravel() for k in params])  # noqa: E731
    return leaf_rel_err(flat(mu), flat(ref["mu"]))


def _port_step(ref, tcrit=None):
    tcrit = flagship_criteria()[1] if tcrit is None else tcrit
    net = ref["net"]
    ttr = TTrainer(torch_posenet(ref["variables"], **net), tcrit, TTrainerConfig(aug=TCfg(**_AUG), **_COMMON),
                   TCATS, _schedule, device="cpu")
    tstate = ttr.init_state(state_dict=posenet_state_dict_from_jax(ref["variables"], net))
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


def test_update_swa_matches_jax(jax_step):
    """Three steps, each followed by `update_swa`: the port averages the JAX
    package's own parameters and BatchNorm statistics of each step (loaded
    into its model), so both average the same sequence; f32 arithmetic in
    the same order, so equal to the bit."""
    net = jax_step["net"]
    ttr, tstate, _, _ = _port_step(jax_step)
    initial = posenet_state_dict_from_jax(jax_step["variables"], net)
    tstate = dataclasses.replace(
        tstate,
        swa_params={k: initial[k].clone() for k in tstate.swa_params},
        swa_buffers={k: initial[k].clone() for k in tstate.swa_buffers},
    )
    assert len(tstate.swa_buffers) == 2 * 27 and not any(k.endswith("num_batches_tracked") for k in tstate.swa_buffers)
    for i, (variables, swa) in enumerate(jax_step["trajectory"]):
        ttr.model.load_state_dict(posenet_state_dict_from_jax(variables, net))
        tstate = ttr.update_swa(tstate)
        assert tstate.swa_count == i + 1
        want = posenet_state_dict_from_jax(swa, net)
        for k, v in {**tstate.swa_params, **tstate.swa_buffers}.items():
            assert torch.equal(v, want[k]), (i, k)
    # the slots are copies, and variables_of(swa=True) puts them in the model's place
    sd = ttr.variables_of(tstate, swa=True)
    p = next(iter(tstate.swa_params))
    assert sd[p] is tstate.swa_params[p] and tstate.swa_params[p].data_ptr() != ttr.params()[p].data_ptr()
    assert torch.equal(ttr.variables_of(tstate)[p], ttr.params()[p].detach())


def test_swa_slots_start_as_copies_not_aliases():
    _, tcrit = flagship_criteria()
    model = torch_posenet(jax_posenet_variables(0, **SMALL_NET)[1], **SMALL_NET)
    ttr = TTrainer(model, tcrit, TTrainerConfig(aug=TCfg(**_AUG), **_COMMON), TCATS, _schedule, device="cpu")
    state = ttr.init_state(state_dict=model.state_dict())
    buffers = dict(model.named_buffers())
    for k, p in ttr.params().items():
        assert torch.equal(state.swa_params[k], p) and state.swa_params[k].data_ptr() != p.data_ptr(), k
    for k, v in state.swa_buffers.items():
        assert torch.equal(v, buffers[k]) and v.data_ptr() != buffers[k].data_ptr(), k
    assert state.swa_count == 0


def test_train_step_multi_equals_single_steps():
    """K=3 steps in one call against three `train_step` calls from the same
    weights and draws: the same parameters, statistics, moments and
    metrics, bit for bit; metrics stacked on a leading (K,) axis."""
    _, tcrit = flagship_criteria()
    _, variables = jax_posenet_variables(3, **SMALL_NET)
    rng = np.random.RandomState(9)
    batches = [make_batch(rng, B, 96) for _ in range(3)]
    cfg = TCfg(inputsize=129, enable_image_aug=True, p_flip_rot90=0.5)
    draws = [sample_augmentation_parameters(torch.Generator().manual_seed(i), B, cfg) for i in range(3)]
    runs = []
    for multi in (False, True):
        ttr = TTrainer(torch_posenet(variables, **SMALL_NET), tcrit, TTrainerConfig(aug=cfg, **_COMMON), TCATS,
                       _schedule, device="cpu")
        state = ttr.init_state(state_dict=posenet_state_dict_from_jax(variables, SMALL_NET))
        W = ttr.weight_matrix(0)
        if multi:
            stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            state, metrics = ttr.train_step_multi(state, stacked, W, aug_params=draws)
        else:
            history = []
            for b, d in zip(batches, draws):
                state, m = ttr.train_step(state, b, W, aug_params=d)
                history.append(m)
            metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
        runs.append((ttr.model.state_dict(), state, metrics))
    (sd1, s1, m1), (sd2, s2, m2) = runs
    assert s2.step == 3 and s2.opt_state.count == 3
    assert all(v.shape == (3,) for v in m2.values()) and set(m1) == set(m2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    for k in s1.opt_state.mu:
        assert torch.equal(s1.opt_state.mu[k], s2.opt_state.mu[k]) and torch.equal(s1.opt_state.nu[k], s2.opt_state.nu[k])


@pytest.fixture(scope="module")
def jax_full_step():
    """One JAX step of the 6D model with the training CLI's full loss setup:
    NLL heads, point head, ROI training, 6D rotation (12 terms)."""
    opts = LossOptions(epochs=4, with_nll_loss=True, with_pointhead=True, with_roi_train=True, enable_6drot=True)
    return _jax_step(cli_setup_losses()(opts, [JTag.POSE_WITH_LANDMARKS]), dict(SMALL_NET, enable_6drot=True)), opts


def test_full_loss_setup_train_step_on_the_jax_crop_matches_jax(jax_full_step, monkeypatch):
    """The port's step with `setup_losses` on the JAX package's crop and
    labels of that step, against the JAX step. Limits as in
    `test_one_train_step_on_the_jax_crop_matches_jax`: 1e-4 per metric (1e-3
    for the orthonormality regulariser, a small difference of two squares),
    3e-2 / 6e-2 per leaf of mu / nu and 1e-2 over all leaves of mu (measured:
    2.0e-2 on the worst leaf, 5.0e-3 over all), and the update's sign on 90%
    of the elements above each leaf's noise (one of the 8 elements of
    `dw2_1.bn_dw.weight` has a first moment of 1e-3 of the leaf's largest)."""
    ref, opts = jax_full_step
    x, labels = ref["crop"]
    monkeypatch.setattr(port_loop, "augment_batch_for_training", lambda *a, **k: (x, dict(labels)))
    tcrit = setup_losses(opts, [TTag.POSE_WITH_LANDMARKS])
    assert len(tcrit.terms) == 12
    err = _check_step(ref, *_port_step(ref, tcrit), mu_leaf=3e-2, nu_leaf=6e-2, loose=("quatregularization1",),
                      sign_floor=True)
    assert err <= 1e-2
