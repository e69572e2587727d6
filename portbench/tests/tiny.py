"""Sizes at which a cell runs on the CPU in seconds: the program and the
reference in float32, batch 8, K = 2, 160^2 sources."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {
    "traffic": {"batch": 8, "steps_per_dispatch": 2, "blocks": 2, "source_size": 160, "roi_side": 70,
                "warmup_blocks": 1, "trace_blocks": 1, "settle_s": 0},
    "config": {"dtype": "float32"},
}
SEED = 2**31 + 12345
CELLS = tuple(w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"])


def tiny():
    return copy.deepcopy(TINY)
