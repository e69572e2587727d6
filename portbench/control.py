"""The readings the check's limits are set from, for one cell, on the card:

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--kinds sound control witness half_batch altered_answer frozen_state] [--out FILE]

For each seed and kind it drives the cell's first block, as a run's set-up
does, and prints the numbers the check compares as one JSON line:
"sound" is the program as the configuration states it; "control" is the
reference in the program's place, computed in the precision below the
configuration's; "witness" the reference computed at the configuration's
own precision (its convolutions' and linears' operands rounded to
bfloat16) in the program's place; the others are the program with the timed path broken
underneath (`harness/drive.py:plant`). The last lines give, per kind and
number, the largest and the smallest reading over the seeds."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, kind: str, device, overrides=None):
    from portbench.harness import drive

    if kind == "control":
        return drive.control_numbers(name, seed, device, overrides)
    if kind == "witness":  # the reference at the configuration's own precision in the program's place
        return drive.control_numbers(name, seed, device, overrides, precision="bfloat16")
    run = drive.Setup(name, seed, device, overrides, None if kind == "sound" else kind)
    inputs = run.release()
    return drive.reference_numbers(run.config, run.sd0, inputs, run.first_metrics, run.after_first, seed, run.dev)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--kinds", nargs="+", default=["sound", "control", "half_batch", "altered_answer"])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    seen = {}
    try:
        for seed in args.seeds:
            for kind in args.kinds:
                t0 = time.perf_counter()
                numbers = readings(args.workload, seed, kind, "cuda:0")
                line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind, "numbers": numbers,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
                for k, v in numbers.items():
                    if isinstance(v, float):
                        seen.setdefault((kind, k), []).append(v)
    finally:
        if out:
            out.close()
    for (kind, k), vs in sorted(seen.items()):
        print(f"{args.workload} {kind} {k}: max {max(vs)!r} min {min(vs)!r} over {len(vs)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
