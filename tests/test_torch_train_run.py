"""The training run around the step, on the CPU: packing, validation,
synthetic data, the NaN watchdog, resume and the epoch loop.

Tolerances:
 - `pack_fused_batch`: equal to the JAX package's, array for array.
 - `FusedValidation`: the loss and each term within 1e-5 relative of the JAX
   package's on the same samples, weights and tag order (measured: 7.7e-7 on
   the worst term; the two deterministic crops are K1's plain version and the
   XLA warp).
 - `make_labels`: 1e-5 relative (the same numpy draws; the keypoint model in
   f32 on both sides); `render_marker_images`: within 1 gray level (a float
   rounding before the cast to uint8 may move a pixel by one level).
 - Resume: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation.pipeline import TrainAugmentationConfig as JCfg
from neuralnet_tracker_traincode_tpu.data import synthetic as JS
from neuralnet_tracker_traincode_tpu.data.batch import Batch, Metadata
from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_tpu.data.loader import LABEL_CATEGORIES as JCATS
from neuralnet_tracker_traincode_tpu.data.loader import pack_fused_batch as jax_pack
from neuralnet_tracker_traincode_tpu.parallel.mesh import make_mesh
from neuralnet_tracker_traincode_tpu.train.loop import PoseTrainer as JTrainer, TrainerConfig as JTrainerConfig
from neuralnet_tracker_traincode_tpu.train.validation import FusedValidation as JValidation
from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig as TCfg
from neuralnet_tracker_traincode_torch.data import synthetic as TS
from neuralnet_tracker_traincode_torch.data.fields import Tag as TTag
from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES as TCATS
from neuralnet_tracker_traincode_torch.data.batch import frame
from neuralnet_tracker_traincode_torch.data.loader import iterate_fused_batches, pack_fused_batch
from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
from neuralnet_tracker_traincode_torch.models.io import load_posenet
from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax
from neuralnet_tracker_traincode_torch.train.checkpointing import load_train_state, save_train_state
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer as TTrainer, TrainerConfig as TTrainerConfig
from neuralnet_tracker_traincode_torch.train.loop import check_not_nan
from neuralnet_tracker_traincode_torch.train.plotting import ConsoleTrainOutput
from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
from neuralnet_tracker_traincode_torch.train.validation import FusedValidation as TValidation
from tests.torch_port_helpers import SMALL_NET, cli_setup_losses, jax_posenet_variables, t, torch_posenet

SIXD_NET = dict(SMALL_NET, enable_6drot=True)
OPTS = LossOptions(epochs=4, with_nll_loss=True, enable_6drot=True)
TAGS = ("ONLY_POSE", "POSE_WITH_LANDMARKS")


def _jax_frames(n, size, seed):
    """Synthetic marker frames as the JAX package's single-frame `Batch`es,
    every third one `ONLY_POSE` without landmarks."""
    quats, coords, pt3d, shapeparams, rois = JS.make_labels(n, size, seed)
    images = JS.render_marker_images(pt3d, coords, size, chunk=16)
    frames = []
    for i in range(n):
        tag = JTag.ONLY_POSE if i % 3 == 0 else JTag.POSE_WITH_LANDMARKS
        fields = dict(image=images[i, :, :, None], pose=quats[i], coord=coords[i], roi=rois[i])
        if tag == JTag.POSE_WITH_LANDMARKS:
            fields.update(pt3d_68=pt3d[i], shapeparam=shapeparams[i])
        frames.append(Batch(Metadata((size, size), 0, tag=tag), **fields))
    return frames


def _port_frames(jframes):
    return [frame(getattr(TTag, f.meta.tag.name), {k: v for k, v in f.items()}) for f in jframes]


def test_pack_fused_batch_matches_jax():
    jframes = _jax_frames(5, 90, seed=1)
    weights = [1.0, 0.5, 2.0, 1.0, 0.25]
    ref = jax_pack(jframes, [0, 1, 1, 0, 1], 128, weights)
    out = pack_fused_batch(_port_frames(jframes), [0, 1, 1, 0, 1], 128, weights)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert out["image"].shape == (5, 128, 128, 1)
    np.testing.assert_array_equal(out["hasface"], 0.0)  # no frame has it: zero, masked by the weights
    grown = pack_fused_batch(_port_frames(jframes), [0] * 5, 64)  # an image above pad_size grows the padding
    assert grown["image"].shape[1:3] == (128, 128)


def test_pack_fused_batch_smooths_hasface_and_refuses_what_waits():
    f = frame(TTag.POSE_WITH_LANDMARKS, dict(image=np.zeros((4, 4, 1), np.uint8), hasface=np.asarray(True)))
    g = frame(TTag.POSE_WITH_LANDMARKS, dict(image=np.zeros((4, 4, 1), np.uint8), hasface=np.asarray(0.0)))
    np.testing.assert_array_equal(pack_fused_batch([f, g], [0, 0], 8)["hasface"], np.float32([0.9, 0.1]))
    with pytest.raises(TypeError, match="bytes"):  # an encoded image is a `RawJpegBuffer`, not bytes
        pack_fused_batch([frame(TTag.ONLY_POSE, dict(image=b"\xff\xd8"))], [0], 8)
    # a sequence of two frames beside a single frame: its frames share param_index 0, as the JAX package packs it
    rng = np.random.RandomState(0)
    fields = dict(image=rng.randint(0, 255, (2, 4, 4, 1)).astype(np.uint8), pose=rng.rand(2, 4).astype(np.float32))
    seq = Batch(Metadata((4, 4), 0, tag=JTag.ONLY_POSE, seq=[0, 2]), **fields)
    port_seq = frame(TTag.ONLY_POSE, fields)
    port_seq.meta.seq = [0, 2]
    ref = jax_pack([seq, g], [1, 0], 8, [0.5, 1.0])
    out = pack_fused_batch([port_seq, g], [1, 0], 8, [0.5, 1.0])
    assert out["param_index"].tolist() == [0, 0, 2] and out["tag_id"].tolist() == [1, 1, 0]
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)


def _sampler(frames, seed):
    """The training CLI's sampler over one set of frames."""
    return make_concat_dataset_item_sampler(ConcatDataset([frames]), [1.0], seed=seed)


def test_iterate_fused_batches_covers_each_pass_once():
    frames = _port_frames(_jax_frames(6, 40, seed=2))
    packed = pack_fused_batch(frames, [0] * 6, 64)
    packed["coord_convention_id"] = np.arange(6, dtype=np.int32)
    it = iterate_fused_batches(packed, 2, _sampler(frames, 0), device="cpu")
    seen = [next(it) for _ in range(3)]
    assert sorted(torch.cat([b["coord_convention_id"] for b in seen]).tolist()) == list(range(6))
    assert all(b["image"].shape == (2, 64, 64, 1) and b["param_index"].tolist() == [0, 1] for b in seen)


@pytest.mark.parametrize("start", [0, 2, 3, 7])
def test_iterate_fused_batches_starts_where_a_fresh_iterator_would_be(start):
    """A resumed run's iterator: `start` batches into a stream of passes of
    7 frames (batches cross the passes), the batches an iterator of an equal
    sampler gives after `start` batches."""
    frames = _port_frames(_jax_frames(7, 40, seed=2))
    packed = pack_fused_batch(frames, [0] * 7, 64)
    packed["coord_convention_id"] = np.arange(7, dtype=np.int32)
    straight = iterate_fused_batches(packed, 2, _sampler(frames, 4), device="cpu")
    want = [next(straight)["coord_convention_id"] for _ in range(start + 4)][start:]
    resumed = iterate_fused_batches(packed, 2, _sampler(frames, 4), device="cpu", start=start)
    for w in want:
        assert torch.equal(next(resumed)["coord_convention_id"], w)
    with pytest.raises(ValueError, match="no batch"):
        next(iterate_fused_batches(packed, 8, _sampler(frames, 4), device="cpu"))


def test_synthetic_labels_and_images_match_jax():
    ref = JS.make_labels(24, 80, seed=5)
    out = TS.make_labels(24, 80, seed=5, device="cpu")
    for r, o in zip(ref, out):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-4)
    img_ref = JS.render_marker_images(ref[2], ref[1], 80, chunk=16)
    img = TS.render_marker_images(t(ref[2]), t(ref[1]), 80, chunk=10)
    assert img.dtype == torch.uint8 and tuple(img.shape) == img_ref.shape
    diff = np.abs(img.numpy().astype(np.int32) - img_ref.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff) < 1e-3 and img_ref.max() > 150


def _port_trainer(variables, epochs=4, swa_start=None, batchsize=4, image_aug=True):
    cfg = TTrainerConfig(batchsize=batchsize, lr=1e-3, epochs=epochs, samples_per_epoch=2 * batchsize,
                         swa_start_epoch=swa_start, aug=TCfg(inputsize=129, enable_image_aug=image_aug))
    tr = TTrainer(torch_posenet(variables, **SIXD_NET), setup_losses(OPTS, [getattr(TTag, n) for n in TAGS]), cfg,
                  TCATS, device="cpu")
    return tr, tr.init_state(state_dict=posenet_state_dict_from_jax(variables, SIXD_NET))


def test_fused_validation_matches_jax():
    """11 frames of two tags, 100^2 (padded to 128), batches of 4: the last
    batch is filled with a repeat of its first frame at weight 0."""
    jmodel, variables = jax_posenet_variables(8, **SIXD_NET)
    jframes = _jax_frames(11, 100, seed=3)
    jcrit = cli_setup_losses()(OPTS, [getattr(JTag, n) for n in TAGS])
    jtr = JTrainer(jmodel, jcrit, JTrainerConfig(batchsize=4, epochs=4, aug=JCfg()), JCATS,
                   mesh=make_mesh(jax.devices()[:1]))
    jstate = jtr.init_state(jax.random.PRNGKey(0), (129, 129, 1)).replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
    )
    jrec, trec = ConsoleTrainOutput(), ConsoleTrainOutput()
    ref = JValidation(jtr, jframes, [getattr(JTag, n) for n in TAGS], batchsize=4).run(jstate, 2, jrec)

    tr, _ = _port_trainer(variables)
    val = TValidation(tr, _port_frames(jframes), batchsize=4)
    assert len(val._batches) == 3 and val._batches[0]["image"].shape == (4, 128, 128, 1)
    np.testing.assert_array_equal(val._batches[2]["dataset_weight"].numpy(), [1, 1, 1, 0])
    out = val.run(2, trec)
    assert isinstance(out, float)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert set(trec.histories) == set(jrec.histories)
    for k, h in jrec.histories.items():
        np.testing.assert_allclose(float(trec.histories[k].test[-1][1]), float(h.test[-1][1]), rtol=1e-5, err_msg=k)
    assert not tr.model.training


def test_check_not_nan_raises_and_dumps(tmp_path):
    params = {"w": torch.ones(3)}
    batch = {"image": torch.zeros(2, 4, 4, 1, dtype=torch.uint8)}
    check_not_nan({"loss": torch.tensor([0.5, 1.0])}, params, batch, str(tmp_path / "dump.pt"))
    assert not (tmp_path / "dump.pt").exists()
    with pytest.raises(FloatingPointError, match="Non-finite loss"):
        check_not_nan({"loss": torch.tensor([0.5, float("nan")]), "xy": torch.tensor(1.0)}, params, batch,
                      str(tmp_path / "dump.pt"))
    dump = torch.load(str(tmp_path / "dump.pt"), weights_only=True)
    assert set(dump) == {"metrics", "batch", "params"}
    assert torch.isnan(dump["metrics"]["loss"][1]) and torch.equal(dump["params"]["w"], params["w"])
    assert torch.equal(dump["batch"]["image"], batch["image"])


def _train_batches(seed, batchsize=4):
    frames = _port_frames(_jax_frames(12, 96, seed=seed))
    tags = {TTag.ONLY_POSE: 0, TTag.POSE_WITH_LANDMARKS: 1}
    packed = pack_fused_batch(frames, [tags[f.meta.tag] for f in frames], 96)

    def batches(start):
        return iterate_fused_batches(packed, batchsize, _sampler(frames, seed), device="cpu", start=start)

    return frames, batches


def _all_tensors(trainer, state):
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"mu.{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.opt_state.nu.items()})
    out.update({f"swa.{k}": v for k, v in {**state.swa_params, **state.swa_buffers}.items()})
    return out


def test_resume_continues_bit_for_bit(tmp_path):
    """2 steps + SWA update, save, load into a fresh trainer, 2 more steps +
    SWA update: every tensor equal to 4 straight steps'."""
    _, variables = jax_posenet_variables(9, **SIXD_NET)
    it = _train_batches(4)[1](0)
    batches = [next(it) for _ in range(4)]

    def steps(tr, state, bs, gen):
        W = tr.weight_matrix(0)
        for b in bs:
            state, _ = tr.train_step(state, b, W, generator=gen)
        return tr.update_swa(state)

    tr, state = _port_trainer(variables)
    straight = steps(tr, steps(tr, state, batches[:2], g := torch.Generator().manual_seed(3)), batches[2:], g)
    want = _all_tensors(tr, straight)

    tr1, state1 = _port_trainer(variables)
    g1 = torch.Generator().manual_seed(3)
    state1 = steps(tr1, state1, batches[:2], g1)
    save_train_state(tr1, state1, str(tmp_path / "resume.pt"), extra={"epoch": 0}, generator=g1)
    assert not (tmp_path / "resume.pt.tmp").exists()
    _, variables_other = jax_posenet_variables(10, **SIXD_NET)
    tr2, _ = _port_trainer(variables_other)
    g2 = torch.Generator().manual_seed(99)
    state2, extra = load_train_state(tr2, str(tmp_path / "resume.pt"), g2)
    assert extra == {"epoch": 0} and (state2.step, state2.opt_state.count, state2.swa_count) == (2, 2, 1)
    state2 = steps(tr2, state2, batches[2:], g2)
    got = _all_tensors(tr2, state2)
    assert set(got) == set(want) and (state2.step, state2.swa_count) == (straight.step, straight.swa_count) == (4, 2)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_run_training_writes_its_files_and_resumes(tmp_path):
    """Two epochs with SWA after epoch 0 write last, best, swa and resume;
    `swa.ckpt` holds the SWA variables; one epoch and a resumed second epoch,
    its batches from a fresh iterator, end where the two straight epochs end."""
    _, variables = jax_posenet_variables(11, **SIXD_NET)
    frames, batches = _train_batches(6)

    tr, state = _port_trainer(variables, epochs=2, swa_start=0)
    val = TValidation(tr, frames[:6], batchsize=4)
    state, records = run_training(tr, state, batches, val, str(tmp_path / "a"), torch.Generator().manual_seed(1))
    assert sorted(os.listdir(tmp_path / "a")) == ["best.ckpt", "last.ckpt", "resume.pt", "swa.ckpt"]
    assert [r["epoch"] for r in records] == [0, 1] and all(r["steps"] == 2 for r in records)
    assert all(np.isfinite(r["val_loss"]) and r["images_per_s"] > 0 for r in records)
    assert records[1]["sustained_images_per_s"] > 0
    assert set(records[0]["train_metrics"]) == {"loss"} | {t.name for t in tr.criterion.terms}
    assert state.step == 4 and state.swa_count == 1
    swa = load_posenet(str(tmp_path / "a" / "swa.ckpt"))
    want = tr.variables_of(state, swa=True)
    for k, v in swa.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    last = load_posenet(str(tmp_path / "a" / "last.ckpt")).state_dict()
    assert torch.equal(last["quatnet.linear.weight"], tr.model.quatnet.linear.weight.detach())

    # the same two epochs, cut after the first and resumed from its state file
    tr_b, state_b = _port_trainer(variables, epochs=1, swa_start=0)
    run_training(tr_b, state_b, _train_batches(6)[1], TValidation(tr_b, frames[:6], batchsize=4), str(tmp_path / "b"),
                 torch.Generator().manual_seed(1))
    tr_c, state_c = _port_trainer(jax_posenet_variables(12, **SIXD_NET)[1], epochs=2, swa_start=0)
    state_c, records_c = run_training(
        tr_c, state_c, _train_batches(6)[1], TValidation(tr_c, frames[:6], batchsize=4), str(tmp_path / "b"),
        torch.Generator(), resume=str(tmp_path / "b" / "resume.pt"))
    assert [r["epoch"] for r in records_c] == [1]
    assert os.path.exists(tmp_path / "b" / "swa.ckpt")
    got, want = _all_tensors(tr_c, state_c), _all_tensors(tr, state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_equal(records_c[0]["val_loss"], records[1]["val_loss"])


def test_run_training_stops_on_a_nonfinite_loss(tmp_path):
    _, variables = jax_posenet_variables(11, **SIXD_NET)
    frames, batches = _train_batches(6)
    tr, state = _port_trainer(variables, epochs=1)
    with torch.no_grad():
        tr.model.posnet.linear_xy.bias.fill_(float("nan"))
    val = TValidation(tr, frames[:4], batchsize=4)
    with pytest.raises(FloatingPointError):
        run_training(tr, state, batches, val, str(tmp_path), torch.Generator().manual_seed(1))
    assert sorted(os.listdir(tmp_path)) == ["notgood.pt"]


def test_validation_tag_outside_the_training_mixture():
    """Training on one tag (300W-LP's) and validating on another (aflw2k's):
    `setup_losses(..., validation_tags=...)` gives the validation tag its
    own row after the training tags, where the JAX package's validation
    raises a KeyError; without it the port says what to do."""
    _, variables = jax_posenet_variables(13, **SIXD_NET)
    jframes = _jax_frames(6, 96, seed=7)
    for f in jframes:
        f.meta.tag = JTag.POSE_WITH_LANDMARKS
    train_frames = _port_frames(jframes)
    for f in train_frames:
        f.meta.tag = TTag.POSE_WITH_LANDMARKS_3D_AND_2D
    cfg = TTrainerConfig(batchsize=4, epochs=1, samples_per_epoch=4, aug=TCfg(inputsize=129))
    train_tags = [TTag.POSE_WITH_LANDMARKS_3D_AND_2D]
    crit = setup_losses(OPTS, train_tags, validation_tags=[TTag.POSE_WITH_LANDMARKS, TTag.POSE_WITH_LANDMARKS_3D_AND_2D])
    assert crit.tags == [TTag.POSE_WITH_LANDMARKS_3D_AND_2D, TTag.POSE_WITH_LANDMARKS]
    tr = TTrainer(torch_posenet(variables, **SIXD_NET), crit, cfg, TCATS, device="cpu")
    state = tr.init_state(state_dict=posenet_state_dict_from_jax(variables, SIXD_NET))
    packed = pack_fused_batch(train_frames[:4], [0] * 4, 96)
    state, metrics = tr.train_step(state, packed, tr.weight_matrix(0), generator=torch.Generator().manual_seed(0))
    val_frames = _port_frames(jframes)
    val = TValidation(tr, val_frames, batchsize=4)
    assert val._batches[0]["tag_id"].tolist() == [1, 1, 1, 1]
    assert np.isfinite(val.run(0)) and np.isfinite(metrics["loss"].item())

    lone = TTrainer(torch_posenet(variables, **SIXD_NET), setup_losses(OPTS, train_tags), cfg, TCATS, device="cpu")
    with pytest.raises(ValueError, match="validation_tags"):
        TValidation(lone, val_frames, batchsize=4)
    jlone = JTrainer(jax_posenet_variables(13, **SIXD_NET)[0], cli_setup_losses()(OPTS, [JTag.POSE_WITH_LANDMARKS_3D_AND_2D]),
                     JTrainerConfig(batchsize=4, aug=JCfg()), JCATS, mesh=make_mesh(jax.devices()[:1]))
    with pytest.raises(KeyError):
        JValidation(jlone, jframes, [JTag.POSE_WITH_LANDMARKS_3D_AND_2D], batchsize=4)
