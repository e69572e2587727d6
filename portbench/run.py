"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. It builds
the cell's configuration and traffic from the seed, warms up, measures for
`--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of its standard
output (`--trace 0`: the cell's end-to-end metrics; `--trace 1`: its
per-layer metrics from a profiled part of the window). The numbers the
check compares, each beside its limit, are the last lines of its standard
error. Without a card, or with fewer than the cell asks for, it exits
non-zero and prints no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache in the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import drive

    _, cell, _, _, _ = drive.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return emit(drive.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                               t_start=T_START))


def emit(result) -> int:
    """Print a run's result: the numbers compared beside their limits as the
    last lines of standard error, the result as the last line of standard
    output; none where the run loaded JAX or the JAX package."""
    loaded = result.pop("_loaded_jax")
    if loaded:
        print(f"portbench: the run loaded {loaded}; the port must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
