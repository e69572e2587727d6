"""On the card only (they skip elsewhere): a short run of each cell through
`portbench/run.py`, correct; and the control and each fault of the timed
path at each cell's own size not correct. Run there with
`python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_portbench_card.py`."""

import json
import os
import subprocess
import sys

import pytest
from tiny import CELLS, SEED

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    need_card()
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    need_card()
    sys.path.insert(0, ROOT)
    from portbench.harness import check, drive

    limits = json.load(open(os.path.join(ROOT, "portbench", "limits", cell + ".json")))
    numbers = drive.control_numbers(cell, SEED, "cuda:0")
    assert not check.judged(numbers, {k: v for k, v in limits.items() if k in numbers}), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half_batch", "altered_answer", "frozen_state"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_fails_at_the_cells_size(cell, fault):
    need_card()
    sys.path.insert(0, ROOT)
    from portbench.harness import drive

    r = drive.run_cell(cell, SEED, 1.0, False, device="cuda:0", overrides={"traffic": {"settle_s": 0}}, fault=fault,
                       log=lambda *a: None)
    assert r["correct"] is False, r["compared"]
