"""The check's own test: the run's path driven on the CPU at a tiny size
with the harness's look for a card skipped, the timed path broken
underneath, and `correct` coming out false for each fault a training cell
can have; and the control (the reference in the precision below the
configuration's in the program's place) failing a number."""

import json
import os

import pytest
from tiny import CELLS, SEED, tiny

from portbench.harness import check, drive

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def limits(cell):
    return json.load(open(os.path.join(ROOT, "portbench", "limits", cell + ".json")))


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in drive.FAULTS])
def test_a_broken_step_is_not_correct(cell, fault):
    r = drive.run_cell(cell, SEED, 0.5, False, device="cpu", overrides=tiny(), fault=fault, log=lambda *a: None)
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    t = tiny()
    t["config"]["dtype"] = "bfloat16"  # the configuration's precision: its control is float8
    numbers = drive.control_numbers(cell, SEED, "cpu", t)
    assert not check.judged(numbers, {k: v for k, v in limits(cell).items() if k in numbers}), numbers
