"""Several optimizer steps in one call (`PoseTrainer.train_step_multi`,
`device_prefetch_stacked`, `run_training(steps_per_dispatch=K)`, the
training CLI's `--steps-per-dispatch`), on the CPU.

On the card K steps are one replay of a CUDA graph of the step's device part;
that needs a device part that reads nothing back and branches on no value,
and a host part that draws exactly what K eager steps draw. These tests pin
both halves without a card (the graph itself is held against the eager
steps by `tests/test_torch_kernels_cuda.py` and `chip_smoke.py` phase 14):

 - branch-free stage 1 (4 slots x 6 gated ops) is bit-equal to the ops in
   the drawn order, over all 360 ordered 4-subsets of the 6 ops; and equal
   to the JAX package's ops in that order on the same injected draws, within
   2e-6 (the per-op tolerance of `tests/test_torch_augmentation.py`);
 - the device-count Adam against optax over 2 epochs of a schedule that
   steps at the epoch boundary (1e-6 relative), and against the host-scalar
   Adam of the previous formulation: moments bit-equal, parameters within
   1 ulp (p - lr * u against PyTorch's fused p + (-lr) * u);
 - K1's host plan is never smaller than the one the wrapper reads back;
 - a block's host draws equal K eager steps' draws, and leave the generator
   in the same state; their one upload's layout gives every draw back;
 - `device_prefetch_stacked` against the JAX package's on the JAX test's
   batches (`tests/test_train_loop.py:test_device_prefetch_stacked_shapes`);
 - `run_training(steps_per_dispatch=4)` bit-equal to K=1, resume included;
 - the device part calls no op that reads a value back or has a
   data-dependent shape;
 - the CLI's auto rule.
"""

import dataclasses
import itertools
import math
import os
import traceback

import jax
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from neuralnet_tracker_traincode_tpu.augmentation import intensity as JI
from neuralnet_tracker_traincode_tpu.data.loader import device_prefetch_stacked as jax_prefetch_stacked
from neuralnet_tracker_traincode_tpu.parallel.mesh import make_mesh
from neuralnet_tracker_traincode_tpu.train.loop import make_optimizer as jax_make_optimizer
from neuralnet_tracker_traincode_torch.augmentation import intensity as TI
from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
    TrainAugmentationConfig as TCfg,
    augment_batch_for_training,
    crop_scale_bounds,
    sample_augmentation_parameters,
)
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES as TCATS
from neuralnet_tracker_traincode_torch.data.loader import device_prefetch_stacked, stack_batches
from neuralnet_tracker_traincode_torch.kernels import warp as K1
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax
from neuralnet_tracker_traincode_torch.scripts.train_poseestimator import steps_per_dispatch
from neuralnet_tracker_traincode_torch.train.loop import ClippedGroupAdam
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer as TTrainer
from neuralnet_tracker_traincode_torch.train.loop import TrainerConfig as TTrainerConfig
from neuralnet_tracker_traincode_torch.train.loop import _draw_leaves, _draws_from_leaves, _Packing
from neuralnet_tracker_traincode_torch.train.run import run_training
from neuralnet_tracker_traincode_torch.train.validation import FusedValidation as TValidation
from tests.test_torch_train_run import SIXD_NET, _all_tensors, _port_trainer, _train_batches
from tests.torch_port_helpers import (
    SMALL_NET,
    flagship_criteria,
    jax_posenet_variables,
    make_batch,
    t,
    torch_posenet,
    two_intra_op_threads,  # noqa: F401  (autouse)
)

B = 4


def _stage1_case(rng, perm, size=12):
    x = (rng.rand(B, size, size, 1) ** (0.3 + rng.rand())).astype(np.float32)
    masks = rng.rand(6, B) < 0.6
    values = np.stack([
        np.zeros(B), np.floor(rng.uniform(4, 6, B)), rng.uniform(0.5, 2.0, B), rng.uniform(0.7, 1.5, B),
        rng.uniform(0.7, 1.5, B), np.zeros(B),
    ]).astype(np.float32)
    params = TI.Stage1Parameters(torch.as_tensor(perm, dtype=torch.int64), t(masks), t(values))
    return x, params


@pytest.mark.parametrize("first", range(6))
def test_branch_free_stage1_equals_the_drawn_order(first):
    """Every ordered 4-subset of the 6 ops that starts with `first` (60 each,
    360 in all): the 4 slots of 6 gated ops against the 4 drawn ops applied
    in order (the previous formulation), bit for bit."""
    rng = np.random.RandomState(first)
    orders = [p for p in itertools.permutations(range(6), 4) if p[0] == first]
    assert len(orders) == 60
    for order in orders:
        perm = list(order) + [o for o in range(6) if o not in order]
        x, params = _stage1_case(rng, perm)
        want = t(x)
        for op in order:
            want = TI._stage1_op(op, want, params.masks[op], params.values[op])
        got = TI.intensity_augmentation_stage1(t(x), params)
        assert torch.equal(got, want), order


_JAX_OPS = [
    lambda x, v: JI.equalize(x),
    lambda x, v: JI.posterize(x, v.astype(np.int32)),
    JI.adjust_gamma,
    JI.adjust_contrast,
    JI.adjust_brightness,
    lambda x, v: JI.gaussian_blur(x, 5, 1.5),
]


@pytest.mark.parametrize("seed", range(4))
def test_branch_free_stage1_equals_the_jax_ops_in_the_drawn_order(seed):
    """The JAX package's six ops, each gated per sample by the injected mask
    (`_per_sample_where`), applied in the injected order, against the port's
    branch-free stage 1 on the same draws."""
    rng = np.random.RandomState(10 + seed)
    for _ in range(6):
        perm = rng.permutation(6)
        x, params = _stage1_case(rng, perm, size=33)
        ref = jax.numpy.asarray(x)
        for op in perm[:4]:
            ref = JI._per_sample_where(np.asarray(params.masks[op]), _JAX_OPS[op](ref, params.values[op].numpy()), ref)
        out = TI.intensity_augmentation_stage1(t(x), params).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-6, err_msg=str(perm[:4]))


_TABLE = [1.0, 0.5, 0.25, 2.0]


def _adam_inputs(steps):
    rng = np.random.RandomState(0)
    shapes = {"w": (3, 4), "b": (4,), "uncertainty_s": (5,), "transformer.k": (2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (g * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
             for g in itertools.islice(itertools.cycle([0.05, 3.0, 0.2, 10.0, 0.7]), steps)]
    groups = {"w": "main", "b": "main", "uncertainty_s": "variance", "transformer.k": "transformer"}
    return init, grads, groups


def test_device_count_adam_matches_optax_across_an_epoch_boundary():
    """3 steps an epoch for 2 epochs whose learning rates differ (1.0 then
    0.5 of the base): the count is a device int32 advanced in place, and the
    learning rate of the count before the increment is the step's."""
    init, grads, groups = _adam_inputs(6)
    init.pop("transformer.k"), groups.pop("transformer.k")
    tx = jax_make_optimizer(1e-2, lambda e: _TABLE[e], 3, 2, 1.0)
    jparams = {k: jax.numpy.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    opt = ClippedGroupAdam(1e-2, lambda e: _TABLE[e], 3, 2, groups, 1.0)
    tparams = {k: t(v) for k, v in init.items()}
    tstate = opt.init(tparams)
    assert tstate.count.dtype == torch.int32 and tstate.count.dim() == 0
    count = tstate.count
    for step, g in enumerate(grads):
        upd, jstate = tx.update({k: jax.numpy.asarray(g[k]) for k in init}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        assert opt.step(tparams, {k: t(v) for k, v in g.items() if k in init}, tstate) is tstate
        assert tstate.count is count and int(count) == step + 1
        for k in init:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def _host_scalar_adam(opt, params, grads, mu, nu, count):
    """The previous formulation: host-float bias corrections and learning
    rate, `_foreach_add_(..., alpha=-lr)`."""
    names = list(params)
    g = [grads[n] for n in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    scale = torch.where(norm < opt.grad_clip_norm, torch.ones_like(norm), opt.grad_clip_norm / norm)
    g = torch._foreach_mul(g, scale)
    m, v = [mu[n] for n in names], [nu[n] for n in names]
    torch._foreach_mul_(m, opt.b1)
    torch._foreach_add_(m, g, alpha=1.0 - opt.b1)
    torch._foreach_mul_(v, opt.b2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - opt.b2)
    bc1 = float(np.float32(1.0) - np.float32(opt.b1) ** np.float32(count + 1))
    bc2 = float(np.float32(1.0) - np.float32(opt.b2) ** np.float32(count + 1))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    for i, n in enumerate(names):
        group = opt.groups[n]
        if group == "transformer":
            upd[i].add_(params[n], alpha=0.01)
        params[n].add_(upd[i], alpha=-opt.learning_rate(count, group))


def test_device_count_adam_keeps_the_previous_values():
    """Every group, 10 steps over 4 epochs: moments bit-equal to the
    host-scalar formulation's, parameters within 1 ulp."""
    init, grads, groups = _adam_inputs(10)
    opt = ClippedGroupAdam(1e-2, lambda e: _TABLE[e], 3, 4, groups, 1.0)
    new = {k: t(v) for k, v in init.items()}
    old = {k: t(v) for k, v in init.items()}
    state = opt.init(new)
    mu = {k: torch.zeros_like(v) for k, v in old.items()}
    nu = {k: torch.zeros_like(v) for k, v in old.items()}
    for step, g in enumerate(grads):
        opt.step(new, {k: t(v) for k, v in g.items()}, state)
        _host_scalar_adam(opt, old, {k: t(v) for k, v in g.items()}, mu, nu, step)
        for k in init:
            assert torch.equal(state.mu[k], mu[k]) and torch.equal(state.nu[k], nu[k]), (step, k)
            np.testing.assert_array_max_ulp(new[k].numpy(), old[k].numpy(), maxulp=1)


def _readback_plan(monkeypatch, batch, params, cfg):
    """The plan the K1 wrapper derives on the card from the batch's own
    warp parameters (the largest |scale| of the crops it is handed)."""
    seen = []
    launch = K1.warp_roi_rotate

    def spy(images, view_roi, angles, out_size, theta_max_deg, skip_rotation=False, plan=None):
        cs = out_size if skip_rotation else K1.canvas_size(out_size, theta_max_deg)
        p = K1.warp_params(view_roi, angles, out_size, cs)
        max_sy, max_sx = p[:, [1, 3]].abs().amax(0).tolist()
        seen.append((max_sy, max_sx, K1.launch_plan(images.shape[2], cs, not skip_rotation, max_sy, max_sx)))
        return launch(images, view_roi, angles, out_size, theta_max_deg, skip_rotation)

    monkeypatch.setattr(K1, "warp_roi_rotate", spy)
    labels = {k: t(v) for k, v in batch.items() if k not in ("image", "param_index", "tag_id", "dataset_weight")}
    augment_batch_for_training(t(batch["image"]), labels, TCATS, cfg, params=params,
                               param_index=t(batch["param_index"]), device="cpu")
    monkeypatch.setattr(K1, "warp_roi_rotate", launch)
    (got,) = seen
    return got


@pytest.mark.parametrize("seed", range(6))
def test_host_k1_plan_is_never_smaller_than_the_readback(seed, monkeypatch):
    """Random batches (sources 96^2 to 448^2, ROIs of 20-55% of the source,
    flips and rot90 at p 0.5, sequences sharing draws): the host bounds are
    the read-back ones, and the rounded plan covers them."""
    rng = np.random.RandomState(seed)
    cfg = TCfg(inputsize=129, enable_image_aug=False, p_flip_rot90=0.5)
    for src in (96, 160, 448):
        batch = make_batch(rng, 8, src)
        batch["param_index"] = np.asarray([0, 0, 2, 2, 2, 5, 6, 6], np.int32)
        params = sample_augmentation_parameters(torch.Generator().manual_seed(seed * 7 + src), 8, cfg)
        max_sy, max_sx, exact = _readback_plan(monkeypatch, batch, params, cfg)
        sy, sx = crop_scale_bounds(t(batch["roi"]), params, TCATS, cfg, t(batch["param_index"]))
        assert (sy, sx) == (max_sy, max_sx)
        cs = K1.canvas_size(129, cfg.rotation_aug_angle)
        plan = K1.rounded_plan(src, cs, True, sy, sx)
        assert plan.taps_x >= exact.taps_x and plan.taps_y >= exact.taps_y, (plan, exact)
        # the band a chunk of the plan needs at the batch's own scale
        assert plan.band_rows >= int(math.ceil((plan.chunk - 1) * max_sy)) + exact.taps_y + 2, (plan, exact)


def test_host_k1_plan_falls_back_to_the_bounds_where_rounding_does_not_fit():
    """1024-wide sources: |scale| 7.1 fits in K1's shared memory, 7.5 (its
    rounding) does not; the plan is then the bounds' own."""
    cs = K1.canvas_size(129, 30.0)
    with pytest.raises(ValueError):
        K1.launch_plan(1024, cs, True, 7.5, 7.5)
    assert K1.rounded_plan(1024, cs, True, 7.1, 7.1) == K1.launch_plan(1024, cs, True, 7.1 * (1 + 2**-20),
                                                                        7.1 * (1 + 2**-20))
    assert K1.rounded_plan(1024, cs, True, 2.2, 2.2) == K1.launch_plan(1024, cs, True, 2.5, 2.5)


def _mask_drawing_trainer():
    """A flagship trainer whose network draws masks, as efficientnet's and
    hybrid_vit's do (the host part asks `convnet.draws_masks`)."""
    _, tcrit = flagship_criteria()
    model = torch_posenet(jax_posenet_variables(0, **SMALL_NET)[1], **SMALL_NET)
    model.convnet.draws_masks = True
    cfg = TTrainerConfig(batchsize=B, aug=TCfg(inputsize=129, enable_image_aug=True, p_flip_rot90=0.5))
    return TTrainer(model, tcrit, cfg, TCATS, device="cpu")


def test_a_blocks_draws_are_k_eager_steps_draws():
    tr = _mask_drawing_trainer()
    rng = np.random.RandomState(3)
    batches = [make_batch(rng, B, 96) for _ in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    g_eager, g_block = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    eager = []
    for b in batches:
        inputs = tr.prepare_step(b, generator=g_eager)
        eager.append((inputs.aug, inputs.mask_generator.initial_seed()))
    drawn, plan = tr.prepare_block(stacked, generator=g_block)
    assert plan is None and len(drawn) == 3  # the CPU plans nothing
    assert torch.equal(g_eager.get_state(), g_block.get_state())
    for (want_aug, want_seed), (aug, seed) in zip(eager, drawn):
        want, got = _draw_leaves(want_aug), _draw_leaves(aug)
        assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
        assert seed == want_seed


def test_the_draws_pack_into_one_buffer_and_back():
    """The layout of the one upload of a block's draws (`_Packing`, on a
    host buffer here): every leaf of every step comes back bit for bit, at
    a 16-byte offset, whatever its dtype (bool, int32, int64, f32)."""
    cfg = TCfg(inputsize=129, enable_image_aug=True, p_flip_rot90=0.5)
    draws = [sample_augmentation_parameters(torch.Generator().manual_seed(i), 5, cfg) for i in range(3)]
    leaves = [_draw_leaves(d) for d in draws]
    assert {t.dtype for t in leaves[0].values()} == {torch.bool, torch.int32, torch.int64, torch.float32}
    packing = _Packing({n: ((3,) + tuple(t.shape), t.dtype) for n, t in leaves[0].items()})
    buf = torch.zeros(packing.nbytes, dtype=torch.uint8)
    views = packing.views(buf)
    for n, v in views.items():
        assert v.data_ptr() % 16 == buf.data_ptr() % 16
        for k in range(3):
            v[k].copy_(leaves[k][n])
    for k in range(3):
        back = _draw_leaves(_draws_from_leaves(draws[0], {n: v[k] for n, v in views.items()}))
        assert all(torch.equal(back[n], leaves[k][n]) for n in back)


def _jax_test_batches():
    from tests.test_train_loop import make_synthetic_batch

    return [make_synthetic_batch(np.random.RandomState(i), B=8) for i in range(5)]


def test_device_prefetch_stacked_matches_jax():
    batches = _jax_test_batches()
    out = list(device_prefetch_stacked(iter(batches), "cpu", steps_per_dispatch=2))
    ref = list(jax_prefetch_stacked(iter(batches), make_mesh(jax.devices()[:1]), steps_per_dispatch=2))
    assert len(out) == len(ref) == 2  # trailing odd batch dropped
    assert out[0]["image"].shape == (2, 8, 64, 64, 1)
    np.testing.assert_array_equal(out[1]["coord"][0].numpy(), batches[2]["coord"])
    for a, b in zip(out, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
    stacked = list(stack_batches(({k: t(v) for k, v in b.items()} for b in batches), 2))
    assert len(stacked) == 2 and all(torch.equal(stacked[i][k], out[i][k]) for i in range(2) for k in out[i])


def _trainer(variables, epochs, steps=4):
    """`tests/test_torch_train_run.py:_port_trainer` with `steps` steps an epoch."""
    tr, _ = _port_trainer(variables, epochs=epochs, swa_start=0)
    cfg = dataclasses.replace(tr.config, samples_per_epoch=steps * tr.config.batchsize)
    tr = TTrainer(torch_posenet(variables, **SIXD_NET), tr.criterion, cfg, TCATS, device="cpu")
    return tr, tr.init_state(state_dict=posenet_state_dict_from_jax(variables, SIXD_NET))


def test_run_training_in_blocks_of_four_is_bit_equal_to_single_steps(tmp_path):
    """Two epochs of 4 steps, SWA after epoch 0: K=4 (one call an epoch)
    against K=1, every tensor and every epoch's metrics bit-equal; then K=4
    for one epoch and a resumed second one, equal too."""
    _, variables = jax_posenet_variables(11, **SIXD_NET)
    frames, batches = _train_batches(6)

    def run(K, outdir, epochs=2, resume=None, tr_state=None):
        tr, state = tr_state or _trainer(variables, epochs)
        blocks = batches if K == 1 else (lambda step: stack_batches(batches(step), K))
        state, records = run_training(tr, state, blocks, TValidation(tr, frames[:6], batchsize=4),
                                      str(tmp_path / outdir), torch.Generator().manual_seed(1), resume=resume,
                                      steps_per_dispatch=K)
        return tr, state, records

    tr1, s1, r1 = run(1, "k1")
    tr4, s4, r4 = run(4, "k4")
    assert [r["steps"] for r in r4] == [4, 4] and s4.step == 8 and int(s4.opt_state.count) == 8
    want, got = _all_tensors(tr1, s1), _all_tensors(tr4, s4)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    for a, b in zip(r1, r4):
        assert a["train_metrics"] == b["train_metrics"] and a["val_loss"] == b["val_loss"]
    with open(tmp_path / "k1" / "last.ckpt", "rb") as f1, open(tmp_path / "k4" / "last.ckpt", "rb") as f4:
        assert f1.read() == f4.read()

    run(4, "cut", epochs=1)
    tr_c = _trainer(jax_posenet_variables(12, **SIXD_NET)[1], 2)
    tr_c, s_c, r_c = run(4, "cut", resume=str(tmp_path / "cut" / "resume.pt"), tr_state=tr_c)
    assert [r["epoch"] for r in r_c] == [1]
    got = _all_tensors(tr_c, s_c)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_run_training_rounds_an_epoch_down_to_whole_dispatches(tmp_path, capsys):
    _, variables = jax_posenet_variables(11, **SIXD_NET)
    frames, batches = _train_batches(6)
    tr, state = _trainer(variables, 1, steps=3)
    state, records = run_training(tr, state, lambda step: stack_batches(batches(step), 2),
                                  TValidation(tr, frames[:4], batchsize=4), str(tmp_path), steps_per_dispatch=2)
    assert records[0]["steps"] == 2 and state.step == 2
    assert "note: 3 steps/epoch rounded down to 2 (multiple of --steps-per-dispatch 2)" in capsys.readouterr().out
    with pytest.raises(ValueError):
        run_training(tr, state, batches, None, str(tmp_path), steps_per_dispatch=4)


class _ReadBacks(TorchDispatchMode):
    """Records the ops that read a value back to the host or whose output
    shape depends on values: each is a device sync on the card."""

    FORBIDDEN = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2", "repeat_interleave",
                 "lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        # `record_function` makes a host tensor of its own, which is no copy to the device
        if name in self.FORBIDDEN and not any(f.filename.endswith(os.path.join("autograd", "profiler.py"))
                                              for f in traceback.extract_stack()):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("image_aug", [False, True])
def test_the_device_part_reads_nothing_back(image_aug):
    """One device part (augmentation with every stage, forward, loss with
    NLL, backward, clip, Adam) after a first step has built its constants:
    no op that the card would have to answer to the host."""
    _, tcrit = flagship_criteria()
    _, variables = jax_posenet_variables(3, **SMALL_NET)
    cfg = TCfg(inputsize=129, enable_image_aug=image_aug, p_flip_rot90=0.5)
    tr = TTrainer(torch_posenet(variables, **SMALL_NET), tcrit, TTrainerConfig(batchsize=B, aug=cfg), TCATS,
                  device="cpu")
    state = tr.init_state(state_dict=posenet_state_dict_from_jax(variables, SMALL_NET))
    W, gen = tr.weight_matrix(0), torch.Generator().manual_seed(2)
    batch = make_batch(np.random.RandomState(1), B, 96)
    state, _ = tr.train_step(state, batch, W, generator=gen)
    inputs = tr.prepare_step(batch, generator=gen)
    with _ReadBacks() as mode:
        names, values = tr.device_step(state, inputs, W)
    assert mode.seen == [] and values.shape == (len(names),)


@pytest.mark.parametrize("requested,batch,steps,device,want", [
    (0, 64, 160, "cpu", 1), (0, 8, 2, "cpu", 1), (0, 64, 160, "cuda", 8), (0, 128, 80, "cuda", 8),
    (0, 64, 12, "cuda", 4), (0, 64, 6, "cuda", 2), (0, 64, 7, "cuda", 1), (0, 256, 40, "cuda", 1),
    (3, 64, 160, "cuda", 3), (1, 64, 160, "cuda", 1), (4, 8, 2, "cpu", 4),
])
def test_cli_steps_per_dispatch_follows_the_jax_rule(requested, batch, steps, device, want):
    """`scripts/train_poseestimator.py:284-297` of the JAX package: an
    explicit K as given; else 1 on the CPU, and on an accelerator at batch
    <= 128 the largest of 8, 4, 2 dividing the epoch's steps."""
    assert steps_per_dispatch(requested, batch, steps, device) == want
