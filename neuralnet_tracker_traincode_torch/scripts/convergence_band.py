"""The convergence band: the miniature benchmark of the JAX package's
`tests/test_convergence.py` trained from several seeds (counterpart of the
JAX package's `scripts/convergence_band.sh`).

    python -m neuralnet_tracker_traincode_torch.scripts.convergence_band WORK [EPOCHS] [--seeds 1 2 3] [--device cpu]

Where `WORK/aflw2k.h5` is missing it writes 4,096 synthetic marker frames at
160^2 from seed 3 there (`data/synthetic.py:write_synthetic_pose_dataset`).
Then, for each seed S, it runs two child processes with `$DATADIR=WORK`: the
training CLI (`--ds aflw2k --epochs EPOCHS --batchsize 128
--samples-per-epoch 10240 --outdir WORK/run_seedS --with-nll-loss
--with-swa --seed S`; EPOCHS defaults to 16) and the eval CLI on the run's
`best.ckpt` (`--ds aflw2k3d --json WORK/metrics_seedS.json`). It writes
`WORK/band.json` in the shell script's layout, `{metrics file: {"geo":
geodesic degrees, "nme3d": NME3d %}}`, and prints the band
(`band_summary`: each seed's row, the min, median and max). A child's
non-zero exit ends the run with its exit code. `--batchsize` and
`--samples-per-epoch` shrink the runs for a rehearsal, with a smaller
`aflw2k.h5` written beforehand (more than 400 frames: the first 400
validate).

The machine with the card has no h5py, so these CLIs cannot read their
files there: `chip_smoke.py` phase 21 trains the same band in memory, with
the streams `seed_streams` gives.
"""

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional

PACKAGE = "neuralnet_tracker_traincode_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXED_INIT_SEED = 1234  # the model init where no seed is given


class SeedStreams(NamedTuple):
    init: int  # the model's initial weights
    steps: Optional[int]  # the step generator: the augmentation's draws (None: from the OS)
    sampler: Optional[int]  # the training sampler, before `process_local_seed` folds in the node


def seed_streams(seed: Optional[int]) -> SeedStreams:
    """The seeds that the training CLI derives from `--seed`: the model
    init from the seed (a fixed one without it), the step generator from
    seed + 1 and the sampler from the seed itself."""
    if seed is None:
        return SeedStreams(FIXED_INIT_SEED, None, None)
    return SeedStreams(seed, seed + 1, seed)


def band_summary(rows: Dict[str, Dict[str, float]]) -> Dict[str, Dict]:
    """{"rows": each seed's row, "min" / "median" / "max": of each metric
    over the rows} for rows `{name: {"geo": ..., "nme3d": ...}}` (a metric
    that some row lacks, None, is left out of its statistics)."""
    out = {"rows": rows}
    metrics = sorted({k for r in rows.values() for k in r})
    for name, fn in (("min", min), ("median", statistics.median), ("max", max)):
        out[name] = {k: fn(vs) if (vs := [r[k] for r in rows.values() if r.get(k) is not None]) else None
                     for k in metrics}
    return out


def read_band(work: str) -> Dict[str, Dict[str, float]]:
    """The rows of `band.json` from the eval CLI's `metrics_seed*.json` in `work`."""
    rows = {}
    for fn in sorted(glob.glob(os.path.join(work, "metrics_seed*.json"))):
        with open(fn) as f:
            (r,) = json.load(f).values()
        rows[fn] = {"geo": r["Geodesic°"][0], "nme3d": r.get("NME3d%", [None])[0]}
    return rows


def run_child(cli: str, args: List[str], env: Dict[str, str]) -> int:
    """`python -m <package>.scripts.<cli> args` with `env`; its exit code."""
    return subprocess.call([sys.executable, "-u", "-m", f"{PACKAGE}.scripts.{cli}"] + list(args), env=env, cwd=ROOT)


def child_env(datadir: str) -> Dict[str, str]:
    """This environment with `$DATADIR` and the port's root on the path."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, DATADIR=datadir, PYTHONPATH=ROOT if not path else ROOT + os.pathsep + path)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the miniature benchmark from several seeds")
    parser.add_argument("work", help="work directory: aflw2k.h5, run_seed*/, metrics_seed*.json, band.json")
    parser.add_argument("epochs", nargs="?", type=int, default=16)
    parser.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--batchsize", type=int, default=128)
    parser.add_argument("--samples-per-epoch", type=int, default=10240)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "aflw2k.h5")
    if not os.path.exists(data):
        from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset

        write_synthetic_pose_dataset(data, 4096, 160, seed=3, device=args.device)
    env = child_env(work)
    for seed in args.seeds:
        out = os.path.join(work, f"run_seed{seed}")
        runs = [
            ("train_poseestimator", ["--ds", "aflw2k", "--epochs", str(args.epochs), "--batchsize", str(args.batchsize),
                                     "--samples-per-epoch", str(args.samples_per_epoch), "--outdir", out,
                                     "--with-nll-loss", "--with-swa", "--seed", str(seed), "--device", args.device]),
            ("evaluate_pose_network", [os.path.join(out, "NetworkWithPointHead_mobilenetv1", "best.ckpt"),
                                       "--ds", "aflw2k3d", "--json", os.path.join(work, f"metrics_seed{seed}.json"),
                                       "--device", args.device]),
        ]
        for cli, cli_args in runs:
            code = run_child(cli, cli_args, env)
            if code != 0:
                print(f"{cli} (seed {seed}) exited {code}", file=sys.stderr)
                return code
    rows = read_band(work)
    print(json.dumps(rows, indent=1))
    with open(os.path.join(work, "band.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print("band: " + json.dumps(band_summary(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
