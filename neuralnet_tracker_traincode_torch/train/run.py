"""The training run around the step: the loss setup and the epoch loop of
the JAX package's `scripts/train_poseestimator.py`, as a library.

`setup_losses` builds the per-tag criterion for every combination of the
CLI's loss options; `run_training` runs epochs over the fused-batch dicts
(`data/loader.py:pack_fused_batch`) of an iterator that the caller makes
for the run's first step, so that a resumed run takes the batches it would
have taken without the stop, one step a call or, with `steps_per_dispatch`
K, K steps a call of `PoseTrainer.train_step_multi` (on the card one CUDA
graph replay) over stacked batches: per epoch the
criterion's weights, the steps with their metrics kept on the device (one
transfer when the epoch ends: a host-bound step must not wait for the device
every step), the NaN watchdog, validation, the SWA update, `last.ckpt`, the
resume file and `best.ckpt`; `swa.ckpt` at the end. The training CLI
(`scripts/train_poseestimator.py`) drives it over the HDF5 datasets of
`$DATADIR`, the batches from `FusedBatchLoader` through `device_prefetch`.
In a data-parallel run (the trainer's `parallel`) every rank runs the loop
on its rows; rank 0 alone validates (every rank takes its loss, so the
best-epoch decision is the same everywhere), prints and writes the files,
and the other ranks wait until they are written.
"""

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.losses import losses, nll as NLL
from neuralnet_tracker_traincode_torch.losses.criterion import Criterion as C
from neuralnet_tracker_traincode_torch.losses.criterion import CriterionGroup, MaskedMultiTaskCriterion
from neuralnet_tracker_traincode_torch.train.checkpointing import load_train_state, save_train_state
from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainState, check_not_nan
from neuralnet_tracker_traincode_torch.train.plotting import ConsoleTrainOutput
from neuralnet_tracker_traincode_torch.train.profiling import ThroughputMeter
from neuralnet_tracker_traincode_torch.train.tracing import format_summary, summarize


@dataclasses.dataclass
class LossOptions:
    """The loss options of the training CLI, with its defaults; any object
    with these attributes (an argparse namespace) will do."""

    epochs: int = 200
    with_nll_loss: bool = False
    rampup_nll_losses: bool = False
    with_roi_train: bool = True
    with_pointhead: bool = True
    enable_6drot: bool = False


def setup_losses(args, tag_order: Sequence[Tag], validation_tags: Sequence[Tag] = ()) -> MaskedMultiTaskCriterion:
    """Per-tag criterion groups (`scripts/train_poseestimator.py:setup_losses`)
    for the tags of `tag_order` (their order gives the tag ids of the training
    batches), followed by the tags of `validation_tags` that training lacks:
    validation keys its frames by the criterion's tags, so a validation set
    whose tag is not in the training mixture (aflw2k beside 300W-LP) gets
    its own row of weights rather than failing (the JAX package's
    `train/validation.py:33` raises a KeyError there)."""
    tag_order = list(tag_order) + [t for t in validation_tags if t not in tag_order]
    if args.enable_6drot:
        rot_loss = losses.Rot6dReprLoss()
        rot_constraint = losses.Rot6dNormalizationSoftConstraint()
    else:
        rot_loss = losses.QuatPoseLoss("approx_distance")
        rot_constraint = losses.QuaternionNormalizationSoftConstraint()

    cregularize = [C("quatregularization1", rot_constraint, 1.0e-6)]
    poselosses, roilosses, pointlosses, pointlosses25d, shapeparamloss = [], [], [], [], []

    if args.with_nll_loss:

        def ramped_up_nll_weight(multiplier):
            if args.rampup_nll_losses:

                def wrapped(epoch):
                    strength = min(1.0, max(0.0, (epoch / args.epochs - 0.1) * 10.0))
                    return 0.01 * strength * multiplier

                return wrapped
            return multiplier * 0.01

        poselosses += [
            C("nllrot", NLL.QuatPoseNLLLoss(), ramped_up_nll_weight(0.5)),
            C("nllcoord", NLL.CorrelatedCoordPoseNLLLoss(), ramped_up_nll_weight(0.5)),
        ]
        if args.with_roi_train:
            roilosses += [C("nllbox", NLL.BoxNLLLoss(distribution="gaussian"), ramped_up_nll_weight(0.01))]
        if args.with_pointhead:
            pointlosses += [
                C("nllpoints3d", NLL.Points3dNLLLoss(chin_weight=0.8, eye_weight=0.0, distribution="gaussian"),
                  ramped_up_nll_weight(0.5))
            ]
            pointlosses25d += [
                C("nllpoints3d",
                  NLL.Points3dNLLLoss(chin_weight=0.8, eye_weight=0.0, pointdimension=2, distribution="gaussian"),
                  ramped_up_nll_weight(0.5))
            ]

    poselosses += [
        C("rot", rot_loss, 1.0),
        C("xy", losses.PoseXYLoss("l2"), 0.5 * 0.5),
        C("sz", losses.PoseSizeLoss("l2"), 0.5 * 0.5),
    ]
    if args.with_roi_train:
        roilosses += [C("box", losses.BoxLoss("l2"), 0.01)]
    if args.with_pointhead:
        pointlosses += [C("points3d", losses.Points3dLoss("l2", chin_weight=0.8, eye_weights=0.0), 0.5)]
        pointlosses25d += [
            C("points3d", losses.Points3dLoss("l2", pointdimension=2, chin_weight=0.8, eye_weights=0.0), 0.5)
        ]
        shapeparamloss += [C("shp_l2", losses.ShapeParameterLoss(), 0.1)]
        cregularize += [C("nll_shp_gmm", losses.ShapePlausibilityLoss.from_npz(), 0.1)]

    G = CriterionGroup
    train_criterions = {
        Tag.ONLY_POSE: G(poselosses + cregularize + roilosses),
        Tag.POSE_WITH_LMKS_NO_SHAPE_PARAMS: G(poselosses + cregularize + pointlosses + roilosses),
        Tag.POSE_WITH_LANDMARKS: G(poselosses + cregularize + pointlosses + shapeparamloss + roilosses),
        Tag.POSE_WITH_LANDMARKS_3D_AND_2D: G(poselosses + cregularize + pointlosses + shapeparamloss + roilosses),
        Tag.ONLY_LANDMARKS: G(pointlosses + cregularize),
        Tag.ONLY_LANDMARKS_25D: G(pointlosses25d + cregularize),
        Tag.ONLY_LANDMARKS_2D: G(pointlosses25d + cregularize),
    }
    present = {t: g for t, g in train_criterions.items() if t in tag_order}
    return MaskedMultiTaskCriterion(present, tag_order)


def run_training(
    trainer: PoseTrainer,
    state: TrainState,
    train_batches: Callable[[int], Iterator[Dict[str, Any]]],
    validation,
    outdir: str,
    generator: Optional[torch.Generator] = None,
    resume: Optional[str] = None,
    steps_per_dispatch: int = 1,
    plotter=None,
) -> Tuple[TrainState, List[Dict[str, Any]]]:
    """Train for `trainer.config.epochs` epochs of `steps_per_epoch` steps,
    the augmentation drawing from `generator`; write `last.ckpt`,
    `best.ckpt`, `swa.ckpt` (when SWA is on) and `resume.pt` into `outdir`.
    `train_batches(step)` gives the batches from the run's step on (after a
    resume, the step the state file recorded), e.g.
    `lambda step: iterate_fused_batches(packed, B, make_concat_dataset_item_sampler(
    ConcatDataset([frames]), [1.0], seed=s), start=step)`. With
    `steps_per_dispatch` K above 1 it gives groups of K batches stacked on a
    leading axis (`data/loader.py:stack_batches` of that iterator, or
    `device_prefetch_stacked` of a host loader's), and an epoch is rounded
    down to a multiple of K steps, as the JAX package's training CLI does.
    With `resume` naming an existing state file the run continues after the
    epoch it recorded, bit for bit as if it had not stopped. Returns the
    final state and one record per epoch (host seconds of the steps, images/s,
    images/s sustained since the run's second step with validation and
    checkpoints included, validation loss and milliseconds, milliseconds of
    each checkpoint file written, the epoch's mean of each train metric, and
    with the trainer's tracer on `tracing.summarize` of the epoch's blocks,
    which the epoch's line prints too).
    `plotter` (a `train/plotting.py:TrainHistoryPlotter`) gets the points the
    console gets and renders them at every epoch's end."""
    cfg = trainer.config
    K = int(steps_per_dispatch)
    if K < 1:
        raise ValueError(f"steps_per_dispatch must be at least 1, got {K}")
    dispatches = cfg.steps_per_epoch // K
    if dispatches == 0:
        raise ValueError(f"{cfg.steps_per_epoch} steps an epoch make no dispatch of {K}")
    if cfg.steps_per_epoch % K:
        print(f"note: {cfg.steps_per_epoch} steps/epoch rounded down to {dispatches * K} "
              f"(multiple of --steps-per-dispatch {K})")
    step_fn = trainer.train_step if K == 1 else trainer.train_step_multi
    parallel = trainer.parallel
    writer = parallel.rank == 0
    os.makedirs(outdir, exist_ok=True)
    resume_path = os.path.join(outdir, "resume.pt")
    console = ConsoleTrainOutput()
    recorders = [console] if plotter is None else [plotter, console]
    start_epoch, best_val = 0, math.inf
    if resume is not None and os.path.exists(resume):
        state, extra = load_train_state(trainer, resume, generator, state=state)
        start_epoch = int(extra.get("epoch", -1)) + 1
        best_val = float(extra.get("best_val", math.inf))
        if writer:
            print(f"Resumed from {resume} at epoch {start_epoch}")
    batches = train_batches(state.step)
    meter = ThroughputMeter(warmup_steps=2, devices=parallel.local_ranks)
    records = []
    for epoch in range(start_epoch, cfg.epochs):
        W = trainer.weight_matrix(epoch)
        t0 = time.perf_counter()
        history = []
        for _ in range(dispatches):
            batch = next(batches)
            state, metrics = step_fn(state, batch, W, generator=generator)
            history.append(metrics)
            meter.step(cfg.batchsize * K)
        names = list(history[0])
        # the epoch's one transfer: every metric of every step (a dispatch's metrics are (K,))
        table = torch.cat([torch.stack([m[n].float() for n in names], -1).reshape(-1, len(names))
                           for m in history]).cpu()
        train_s = time.perf_counter() - t0
        trace = None
        if trainer.tracer.on:  # the epoch's blocks, read before validation queues work of its own
            trace = summarize(trainer.tracer.records())
            trainer.tracer.clear()
        steps = table.shape[0]
        per_step = {n: table[:, i] for i, n in enumerate(names)}
        check_not_nan(per_step, trainer.params(), batch, os.path.join(outdir, "notgood.pt"))
        step0 = state.step - steps
        if writer:
            for j in range(steps):
                for n in names:
                    for rec in recorders:
                        rec.add_train_point(epoch, step0 + j + 1, n, float(per_step[n][j]))

        t_val = time.perf_counter()
        val_loss = validation.run(epoch, *recorders)
        val_ms = (time.perf_counter() - t_val) * 1e3
        for rec in recorders:
            rec.add_test_point(epoch, "lr", cfg.lr * trainer.epoch_schedule(epoch))
        if cfg.swa_start_epoch is not None and epoch > cfg.swa_start_epoch:
            state = trainer.update_swa(state)
        checkpoint_ms = {}
        improved = val_loss < best_val
        best_val = min(best_val, val_loss)
        if writer:
            t_ckpt = time.perf_counter()
            trainer.save_checkpoint(state, os.path.join(outdir, "last.ckpt"))
            checkpoint_ms["last"] = (time.perf_counter() - t_ckpt) * 1e3
            t_ckpt = time.perf_counter()
            save_train_state(trainer, state, resume_path, extra={"epoch": epoch, "best_val": best_val},
                             generator=generator)
            checkpoint_ms["resume"] = (time.perf_counter() - t_ckpt) * 1e3
            if improved:
                t_ckpt = time.perf_counter()
                trainer.save_checkpoint(state, os.path.join(outdir, "best.ckpt"))
                checkpoint_ms["best"] = (time.perf_counter() - t_ckpt) * 1e3
            for rec in recorders:
                rec.summarize_train_values()
                rec.update_graph()
        parallel.barrier()
        ips, sustained = steps * cfg.batchsize / train_s, meter.images_per_sec
        if writer:
            per_device = f", {meter.per_device:.0f} img/s per device" if parallel.active else ""
            print(f"epoch {epoch + 1}/{cfg.epochs}: {ips:.0f} img/s (sustained {sustained:.0f} img/s incl. "
                  f"validation{per_device}), val_loss {val_loss:.4f} (best {best_val:.4f})"
                  + ("" if trace is None else "; " + format_summary(trace)))
        records.append(dict(
            epoch=epoch, steps=steps, train_s=train_s, images_per_s=ips, sustained_images_per_s=sustained,
            val_loss=val_loss, val_ms=val_ms, checkpoint_ms=checkpoint_ms,
            train_metrics={n: float(per_step[n].double().mean()) for n in names}, trace=trace,
        ))
    # a generator's clean-up (the profiler's trace, the loader's workers) runs now, not when the collector finds it
    close = getattr(batches, "close", None)
    if close is not None:
        close()
    if cfg.swa_start_epoch is not None and writer:
        trainer.save_checkpoint(state, os.path.join(outdir, "swa.ckpt"), swa=True)
    parallel.barrier()
    return state, records
