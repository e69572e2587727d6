"""Train the head pose estimator (counterpart of the JAX package's
`scripts/train_poseestimator.py`, with its flags and defaults).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.train_poseestimator \\
        --ds 300wlp+synface:10000 --with-nll-loss --with-swa --outdir model_files [--device cpu]

`--ds` mixes the datasets of `$DATADIR` ("name[:weight]+name2[:weight2]");
the weights are sampling frequencies, or loss weights with `--ds-weighting`.
Batches come from `FusedBatchLoader` (`$NUM_WORKERS` workers, default 4)
through `device_prefetch` to the card; on the card the workers only
entropy-decode the JPEGs and K4 finishes the decode there
(`jpeg_decode="device"`; `$NNTC_NO_NATIVE=1` decodes with cv2 on the host,
as `--device cpu` does). Validation runs on the aflw2k3d test split. The run writes `last.ckpt`, `best.ckpt`, `swa.ckpt` (with
`--with-swa`) and `resume.pt` into `<outdir>/<network name>`; `--resume
auto` continues from that `resume.pt`.

`--steps-per-dispatch K` runs K optimizer steps a call: on the card one
replay of a CUDA graph of K whole steps (`PoseTrainer.train_step_multi`),
the batches grouped by `device_prefetch_stacked`; on the CPU K eager steps,
the same trajectory. The default (0) is the JAX CLI's rule
(`steps_per_dispatch`): on the card with batches of at most 128, the largest
of 8, 4 and 2 that divides the epoch's steps; else 1. An explicit K that
does not divide the epoch rounds it down. `--profile-dir` traces the first
8 calls (dispatches) with `torch.profiler` and turns the trainer's tracer on
(`train/tracing.py`): every epoch's line then adds the device ms a block by
section, the device's idle share between blocks and the host part a block.
Every epoch the loss plot is
written to `--plot-save-filename`, by default `<outdir>/<network
name>/train.pdf` (`train/plotting.py:TrainHistoryPlotter`). Where matplotlib
does not import, the CLI says at its start that `train.pdf` will not be
written and trains; `--plot-save-filename` there raises before any data is
read.

On R GPUs of a machine, data-parallel (`parallel/distributed.py`):

    torchrun --nproc-per-node=R -m neuralnet_tracker_traincode_torch.scripts.train_poseestimator ...

`--batchsize` is the node's batch, of which each rank trains on its
batchsize / R rows, as `--batchsize` is per process in the JAX package; the
run is the one-process run on the whole batch up to the order of the
reductions. The backend follows `--device` (NCCL on the card, gloo on the
CPU). Rank 0 validates, prints and writes the files. Without `torchrun` the
script runs one process as before.
"""

import argparse
import os
import sys
import time
from os.path import dirname, join

DSMAP_NAMES = {
    "300wlp": "_300WLP",
    "synface": "SYNFACE",
    "aflw2k": "AFLW2k3d",
    "biwi": "BIWI",
    "wider": "WIDER",
    "repro_300_wlp": "REPO_300WLP",
    "repro_300_wlp_woextra": "REPO_300WLP_WO_EXTRA",
    "wflw_lp": "WFLW_LP",
    "lapa_megaface_lp": "LAPA_MEGAFACE_LP",
    "panoptic": "PANOPTIC_CMU",
    "replicantface": "REPLICANT_FACE",
}


def parse_dataset_definition(arg: str):
    """"name1[:weight1]+name2[:weight2]+..." -> (dataset ids, weight overrides)."""
    from neuralnet_tracker_traincode_torch.data.fields import DatasetId

    dsmap = {k: DatasetId[v] for k, v in DSMAP_NAMES.items()}
    splitted = arg.split("+")
    dataset_weights = {dsmap[k]: float(v) for k, v in (tuple(s.split(":")) for s in splitted if ":" in s)}
    dsids = list(frozenset(dsmap[s.split(":")[0]] for s in splitted))
    return dsids, dataset_weights


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Trains the model")
    parser.add_argument("--backbone", default="mobilenetv1")
    parser.add_argument("--batchsize", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1.0e-3)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--ds", type=str, default="300wlp")
    parser.add_argument("--with-swa", action="store_true", default=False, dest="swa")
    parser.add_argument("--outdir", type=str, default=join(dirname(__file__), "..", "..", "model_files"))
    parser.add_argument("--ds-weighting", action="store_false", default=True, dest="ds_weight_are_sampling_frequencies")
    parser.add_argument("--no-pointhead", action="store_false", default=True, dest="with_pointhead")
    parser.add_argument("--with-nll-loss", default=False, action="store_true")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the model init, the augmentation and the sampler stream "
                             "(None: fixed init, random augmentation and sampling per run)")
    parser.add_argument("--raug", default=30, type=float, dest="rotation_aug_angle")
    parser.add_argument("--no-imgaug", default=True, action="store_false", dest="with_image_aug")
    parser.add_argument("--blurpool", default=False, action="store_true", dest="with_blurpool")
    parser.add_argument("--roi-override", default="original", type=str,
                        choices=["extent_to_forehead", "original", "landmarks"])
    parser.add_argument("--no-roi-train", default=True, action="store_false", dest="with_roi_train")
    parser.add_argument("--rampup-nll-losses", default=False, action="store_true")
    parser.add_argument("--enable-6drot", default=False, action="store_true")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--pad-size", type=int, default=None)
    parser.add_argument("--plot-save-filename", "--save-plot", default=None)
    parser.add_argument("--samples-per-epoch", default=10 * 1024, type=int)
    parser.add_argument("--resume", default=None, type=str,
                        help="resume from a training-state file ('auto' = <outdir>/<network>/resume.pt)")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="trace the first 8 dispatches with torch.profiler into this directory, and print "
                             "every epoch the device ms a block by section, the idle share and the host part")
    parser.add_argument("--steps-per-dispatch", default=0, type=int,
                        help="optimizer steps per call, one CUDA graph replay on the card (0: auto, 8/4/2 on the "
                             "card at batch <= 128, else 1)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    """The flags; `--plot-save-filename` raises where matplotlib does not
    import (`args.plot_error`: the error of its import, or None)."""
    from neuralnet_tracker_traincode_torch.vis import matplotlib_import_error

    args = build_parser().parse_args(argv)
    args.plot_error = matplotlib_import_error()
    if args.plot_save_filename is not None and args.plot_error is not None:
        raise ImportError(f"--plot-save-filename needs matplotlib, which does not import: {args.plot_error}")
    args.input_size = 129
    return args


def steps_per_dispatch(requested: int, batchsize: int, steps_per_epoch: int, device_type: str) -> int:
    """K of `--steps-per-dispatch`: as given when above 0; else the JAX
    CLI's auto rule: 1 on the CPU (no dispatch gap to hide), and on the card
    at batch <= 128 the largest of 8, 4 and 2 that divides `steps_per_epoch`
    (so the default run takes the reference protocol's step count), else 1."""
    if requested > 0:
        return requested
    if batchsize <= 128 and device_type != "cpu":
        return next((k for k in (8, 4, 2) if steps_per_epoch % k == 0), 1)
    return 1


def main(argv=None) -> int:
    args = parse_args(argv)

    from neuralnet_tracker_traincode_torch.parallel.distributed import init_from_env

    parallel, dev = init_from_env(args.device)
    try:
        return _train(args, parallel, dev)
    finally:
        parallel.close()


def _train(args, parallel, dev) -> int:
    import torch

    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.data.loader import (
        LABEL_CATEGORIES,
        device_prefetch,
        device_prefetch_stacked,
    )
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.plotting import TrainHistoryPlotter
    from neuralnet_tracker_traincode_torch.train.profiling import profile_batches
    from neuralnet_tracker_traincode_torch.train.run import run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    if args.plot_error is not None and parallel.rank == 0:
        print(f"train.pdf will not be written: matplotlib does not import ({args.plot_error})")
    from neuralnet_tracker_traincode_torch.scripts.convergence_band import seed_streams

    # every rank of a node must sample the node's batches and draw the augmentation alike
    streams = seed_streams(parallel.agreed_seed(args.seed))
    dsids, dataset_weights = parse_dataset_definition(args.ds)
    train_loader, test_set, _, tag_order, aug_cfg = pipelines.make_pose_estimation_loaders(
        inputsize=args.input_size,
        batchsize=args.batchsize,
        datasets=dsids,
        dataset_weights=dataset_weights,
        use_weights_as_sampling_frequency=args.ds_weight_are_sampling_frequencies,
        enable_image_aug=args.with_image_aug,
        rotation_aug_angle=args.rotation_aug_angle,
        roi_override=args.roi_override,
        pad_size=args.pad_size,
        seed=streams.sampler,
        parallel=parallel,
        jpeg_decode="device" if dev.type == "cuda" else "host",
    )

    model = NetworkWithPointHead(
        enable_point_head=args.with_pointhead,
        enable_face_detector=False,
        config=args.backbone,
        enable_uncertainty=args.with_nll_loss,
        backbone_args={"use_blurpool": args.with_blurpool},
        enable_6drot=args.enable_6drot,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
    )
    criterion = setup_losses(args, tag_order, validation_tags=[test_set.dataset.dataclass])
    cfg = TrainerConfig(
        batchsize=args.batchsize,
        lr=args.lr,
        epochs=args.epochs,
        samples_per_epoch=args.samples_per_epoch,
        swa_start_epoch=(args.epochs * 2 // 3) if args.swa else None,
        aug=aug_cfg,
    )
    trainer = PoseTrainer(model, criterion, cfg, LABEL_CATEGORIES, device=dev, parallel=parallel)
    if args.profile_dir:
        trainer.tracer.enable()
    # the init is the fixed one without --seed, also where the ranks agreed on a drawn seed
    state = trainer.init_state(torch.Generator().manual_seed(seed_streams(args.seed).init))
    generator = torch.Generator()
    if streams.steps is None:
        generator.seed()
    else:
        generator.manual_seed(streams.steps)

    model_out_dir = join(args.outdir, model.name_tag)
    os.makedirs(model_out_dir, exist_ok=True)
    resume = None
    if args.resume:
        resume = join(model_out_dir, "resume.pt") if args.resume == "auto" else args.resume
        if not os.path.exists(resume):
            print(f"No resume state at {resume}; starting fresh")
    validation = FusedValidation(trainer, test_set, batchsize=args.batchsize * 2)
    K = steps_per_dispatch(args.steps_per_dispatch, args.batchsize, cfg.steps_per_epoch, dev.type)
    if args.steps_per_dispatch <= 0 and K > 1 and parallel.rank == 0:
        print(f"auto --steps-per-dispatch {K} (batch {args.batchsize})")

    def batches(step):
        it = train_loader.iterate(step)
        prefetched = device_prefetch(it, dev, size=2) if K == 1 else device_prefetch_stacked(it, dev, K, size=2)
        return profile_batches(prefetched, args.profile_dir if parallel.rank == 0 else None)

    plotter = None
    if args.plot_error is None:
        plotter = TrainHistoryPlotter(args.plot_save_filename or join(model_out_dir, "train.pdf"))

    t0 = time.perf_counter()
    state, records = run_training(trainer, state, batches, validation, model_out_dir, generator, resume=resume,
                                  steps_per_dispatch=K, plotter=plotter)
    total = time.perf_counter() - t0
    samples = sum(r["steps"] for r in records) * args.batchsize * parallel.nodes
    if parallel.rank == 0:
        print(f"Done: {samples} samples in {total:.0f}s ({samples / max(total, 1e-9):.0f} images/s incl. validation); "
              f"model files in {model_out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
