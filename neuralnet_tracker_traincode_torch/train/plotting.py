"""Loss histories of a training run: the console summary and the PDF of
every history (counterpart of the JAX package's `train/plotting.py`).
`TrainHistoryPlotter` renders with matplotlib, imported where it draws."""

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional

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


class TrainHistoryPlotter:
    """Keeps every history and renders them to `save_filename` (a PDF) at
    each `update_graph`: one panel a history, the train points' mean and
    spread an epoch in red, the test points in blue."""

    def __init__(self, save_filename: Optional[str] = None):
        self.histories: Dict[str, History] = defaultdict(History)
        self.save_filename = save_filename

    def add_train_point(self, epoch, step, name, value):
        self.histories[name].current_train_buffer.append((epoch, value))

    def add_test_point(self, epoch, name, value):
        self.histories[name].test.append((epoch, np.asarray(value)))

    def summarize_train_values(self):
        for k, h in self.histories.items():
            summarize_single_train_history(k, h)

    def update_graph(self):
        if not self.save_filename:
            return
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot

        histories = {k: h for k, h in self.histories.items() if (h.train or h.test)}
        num_rows = len(histories)
        if num_rows == 0:
            return
        if num_rows > 5:
            r, c = (num_rows + 1) // 2, 2
        else:
            r, c = num_rows, 1
        fig, axes = pyplot.subplots(r, c, figsize=(10, 3 * r))
        axes = np.atleast_1d(axes).ravel()
        for ax, (name, h) in zip(axes, histories.items()):
            if h.train:
                t, x, xerr = np.asarray(h.train).T
                ax.errorbar(t, x, yerr=xerr, label=name, color="r")
            if h.test:
                t, x = zip(*h.test)
                ax.plot(t, [float(v) for v in x], label="test " + name, marker="x", color="b")
            if h.logplot and not name.startswith("nll") and name != "loss":
                try:
                    ax.set_yscale("log")
                except ValueError:
                    pass
            ax.grid(axis="y", which="both")
            ax.legend()
        fig.tight_layout()
        fig.savefig(self.save_filename)
        pyplot.close(fig)

    def close(self):
        self.update_graph()
