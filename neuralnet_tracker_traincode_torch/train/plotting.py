"""Loss histories and the console summary of a training run (counterpart of
the JAX package's `train/plotting.py`). `TrainHistoryPlotter`, which renders
the histories to a PDF with matplotlib, waits (ROADMAP.md)."""

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class History:
    train: List[Any] = dataclasses.field(default_factory=list)
    test: List[Any] = dataclasses.field(default_factory=list)
    current_train_buffer: List[Any] = dataclasses.field(default_factory=list)
    logplot: bool = True


def summarize_single_train_history(k, h: History):
    if not h.current_train_buffer:
        return
    epochs, values = zip(*h.current_train_buffer)
    values = np.asarray([np.asarray(v) for v in values], dtype=np.float64)
    with np.errstate(all="ignore"):
        h.train.append((np.average(epochs), np.nanmean(values), np.nanstd(values)))
    h.current_train_buffer = []


class ConsoleTrainOutput:
    def __init__(self):
        self.histories: Dict[str, History] = defaultdict(History)

    def add_train_point(self, epoch, step, name, value):
        self.histories[name].current_train_buffer.append((epoch, value))

    def add_test_point(self, epoch, name, value):
        self.histories[name].test.append((epoch, np.asarray(value)))

    def summarize_train_values(self):
        for k, h in self.histories.items():
            summarize_single_train_history(k, h)

    def update_graph(self):
        print("Losses:")
        for name, h in self.histories.items():
            train_str = f"{h.train[-1][1]:.4f} +/- {h.train[-1][2]:.4f}" if h.train else "----"
            test_str = f"{float(h.test[-1][1]):.4f}" if h.test else "----"
            print(f"{name}: Train: {train_str}, Test: {test_str}")
            h.test = []
            h.train = []

    def close(self):
        pass
