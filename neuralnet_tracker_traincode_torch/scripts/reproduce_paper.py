"""The paper-reproduction protocol on AFLW2000-3D and Biwi, end to end
(counterpart of the JAX package's `scripts/reproduce_paper.sh`): convert the
source archives, train the baseline, evaluate on AFLW2000-3D and on Biwi
with the opal23 protocol.

    DATADIR=/data AFLW2000_ZIP=... W300LP_ZIP=... BIWI_ZIP=... BIWI_ANN=... \\
        python -m neuralnet_tracker_traincode_torch.scripts.reproduce_paper [--device cpu]

Inputs, from the environment as the shell script reads them:
  DATADIR            the converters' output directory (required)
  AFLW2000_ZIP       AFLW2000-3D.zip (from the 3DDFA project page)
  W300LP_ZIP         300W-LP.zip (the same page), for training
  BIWI_ZIP, BIWI_ANN the Biwi kinect head-pose zip and the opal23 `biwi_ann.txt` (optional)
  EPOCHS             default 1500 (the paper's schedule)
  CKPT               evaluate this checkpoint or ONNX file instead of training
  DS                 the training mixture, default "300wlp"
  EXTRA_TRAIN_FLAGS  more flags for the training CLI (e.g. "--samples-per-epoch 256")

The steps, each a child process of the port's CLIs with the environment
passed on, each skipped where the shell script skips it:
  1. `dsprocess_aflw2k` into `$DATADIR/aflw2k.h5` where it is missing;
  2. `dsprocess_biwi --opal-annotation` into `$DATADIR/biwi-v3.h5` where it
     is missing and `BIWI_ZIP` is set;
  3. unless `CKPT` is given: `dsprocess_300wlp` into `$DATADIR/300wlp.h5`
     where it is missing, then `train_poseestimator --lr 1.e-3 --epochs
     $EPOCHS --ds $DS --with-swa --with-nll-loss --backbone mobilenetv1
     --roi-override original --outdir $DATADIR/run --resume auto
     $EXTRA_TRAIN_FLAGS`; CKPT is then its `swa.ckpt`, else its `best.ckpt`;
  4. `evaluate_pose_network $CKPT --ds aflw2k3d --json
     $DATADIR/aflw2k3d_results.json`;
  5. where `$DATADIR/biwi-v3.h5` exists, the same on `--ds biwi
     --roi-expansion 0.8 --perspective-correction --json
     $DATADIR/biwi_results.json`.
`--device` (default cuda) goes to every child that takes one. Each step
prints a `==== step` line first. A child's non-zero exit ends the run with
its exit code, as `set -e` ends the shell script; a required variable that
is not set ends it with code 1.
"""

import argparse
import os
import shlex
import sys
from typing import List, Optional

from neuralnet_tracker_traincode_torch.scripts.convergence_band import child_env, run_child

NETWORK = "NetworkWithPointHead_mobilenetv1"


class StepFailed(Exception):
    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


def step(text: str):
    print(f"\n==== {text}", flush=True)


def required(name: str) -> str:
    value = os.environ.get(name)
    if not value:
        print(f"reproduce_paper: {name}: set {name}", file=sys.stderr)
        raise StepFailed(1)
    return value


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert the archives, train the baseline and evaluate it on AFLW2000-3D and Biwi "
                    "(environment: DATADIR, AFLW2000_ZIP, W300LP_ZIP, BIWI_ZIP, BIWI_ANN, EPOCHS, CKPT, DS, "
                    "EXTRA_TRAIN_FLAGS)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu, for every CLI that takes it")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        reproduce(args.device)
    except StepFailed as e:
        return e.code
    return 0


def reproduce(device: str):
    datadir = os.environ.get("DATADIR")
    if not datadir:
        print("reproduce_paper: DATADIR: set DATADIR to the preprocessing output directory", file=sys.stderr)
        raise StepFailed(1)
    epochs = os.environ.get("EPOCHS") or "1500"
    ds = os.environ.get("DS") or "300wlp"
    os.makedirs(datadir, exist_ok=True)
    env = child_env(datadir)
    dev = ["--device", device]

    def run(cli: str, *cli_args: str):
        code = run_child(cli, list(cli_args), env)
        if code != 0:
            print(f"reproduce_paper: {cli} exited {code}", file=sys.stderr)
            raise StepFailed(code)

    # 1. the evaluation sets
    if not os.path.isfile(os.path.join(datadir, "aflw2k.h5")):
        step("convert AFLW2000-3D")
        run("dsprocess_aflw2k", required("AFLW2000_ZIP"), os.path.join(datadir, "aflw2k.h5"))
    biwi = os.path.join(datadir, "biwi-v3.h5")
    if not os.path.isfile(biwi) and os.environ.get("BIWI_ZIP"):
        step("convert Biwi (opal23 annotation protocol)")
        run("dsprocess_biwi", "--opal-annotation", required("BIWI_ANN"), os.environ["BIWI_ZIP"], biwi, *dev)

    # 2. the training data and the baseline (skipped when CKPT is given)
    ckpt = os.environ.get("CKPT")
    if not ckpt:
        if not os.path.isfile(os.path.join(datadir, "300wlp.h5")):
            step("convert 300W-LP")
            run("dsprocess_300wlp", required("W300LP_ZIP"), os.path.join(datadir, "300wlp.h5"))
        step(f"train baseline (MobileNetV1 + NLL + SWA, {epochs} epochs)")
        run("train_poseestimator", "--lr", "1.e-3", "--epochs", epochs, "--ds", ds, "--with-swa", "--with-nll-loss",
            "--backbone", "mobilenetv1", "--roi-override", "original", "--outdir", os.path.join(datadir, "run"),
            "--resume", "auto", *dev, *shlex.split(os.environ.get("EXTRA_TRAIN_FLAGS", "")))
        ckpt = os.path.join(datadir, "run", NETWORK, "swa.ckpt")
        if not os.path.isfile(ckpt):
            ckpt = os.path.join(datadir, "run", NETWORK, "best.ckpt")

    # 3. the benchmarks, with the reference's flags
    step("AFLW2000-3D benchmark")
    run("evaluate_pose_network", ckpt, "--ds", "aflw2k3d", "--json", os.path.join(datadir, "aflw2k3d_results.json"),
        *dev)
    if os.path.isfile(biwi):
        step("Biwi benchmark (opal23 protocol: --roi-expansion 0.8 --perspective-correction)")
        run("evaluate_pose_network", ckpt, "--ds", "biwi", "--roi-expansion", "0.8", "--perspective-correction",
            "--json", os.path.join(datadir, "biwi_results.json"), *dev)
    step(f"done — tables in {datadir}/{{aflw2k3d,biwi}}_results.json")


if __name__ == "__main__":
    sys.exit(main())
