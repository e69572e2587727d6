"""Each cell's dry run on the CPU at a tiny size, through the result's
printing: a well-formed last line, the check passing, and no module of JAX
or of the JAX package loaded in the process."""

import json
import os
import subprocess
import sys

import pytest
from tiny import CELLS, SEED, TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "neuralnet_tracker_traincode_tpu"}

RUNNER = """
import json, sys
from portbench import run
from portbench.harness import drive
r = drive.run_cell(sys.argv[1], int(sys.argv[2]), 2.0, sys.argv[3] == "1", device="cpu", overrides=json.loads(sys.argv[4]),
                   checkout=sys.argv[5])
rc = run.emit(r)
print("MODULES=" + json.dumps(sorted({n.split(".")[0] for n in sys.modules})), file=sys.stderr)
sys.exit(rc)
"""


def dry_run(cell, trace):
    env = {**{k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}, "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", RUNNER, cell, str(SEED), str(int(trace)), json.dumps(TINY), ROOT],
                       cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-4000:]
    modules = json.loads(p.stderr.strip().splitlines()[-1][len("MODULES="):])
    return json.loads(p.stdout.strip().splitlines()[-1]), modules, p.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_a_well_formed_line(cell, trace):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    line, modules, stderr = dry_run(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    layer = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    if trace:
        assert set(line["metrics"]) <= layer and "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == e2e
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    # every number compared beside its limit, last on standard error
    tail = stderr.strip().splitlines()[-1 - len(line["compared"]):-1]
    assert [t.split(":")[0] for t in tail] == [f"compared {k}" for k in line["compared"]]
    assert not FORBIDDEN & set(modules), FORBIDDEN & set(modules)


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(SEED), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
