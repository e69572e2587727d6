"""Dataset composition and weighted multi-dataset sampling (the port's own
copy of the JAX package's `data/sampling.py`; numpy and scipy only).

The infinite `ConcatDatasetSampler` picks a dataset index from weights
(pseudo-random or Sobol quasi-random), then takes the next index of that
dataset's shuffling sampler, cycled. For the same seeds and weights the
index stream is the JAX package's, so both packages train on the same
batches.
"""

import bisect
import copy
import sys
from typing import Callable, Optional, Sequence

import numpy as np

from neuralnet_tracker_traincode_torch import utils


class Dataset:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise NotImplementedError


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - start]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[int(self.indices[idx])]


class TransformedDataset(Dataset):
    def __init__(self, dataset, transform):
        self.dataset = dataset
        self.transform = transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.transform(self.dataset[idx])


class RandomSampler:
    """Shuffled permutation over a dataset, re-shuffled each pass."""

    def __init__(self, dataset, seed: Optional[int] = None):
        self._n = len(dataset)
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self._n

    def __iter__(self):
        yield from self._rng.permutation(self._n).tolist()


def weights_normalized(w):
    w = np.asarray(w, dtype=np.float64)
    assert w.ndim == 1
    wsum = np.sum(w)
    assert wsum > 0.0
    return w / wsum


class SobolChoices:
    """Quasi-random weighted choice via a scrambled Sobol sequence."""

    def __init__(self, weights, seed=None):
        from scipy.stats import qmc

        probs = weights_normalized(weights)
        self.accum = np.cumsum(probs)
        assert abs(self.accum[-1] - 1.0) < 1.0e-6
        self.qrng = qmc.Sobol(1, scramble=True, seed=seed)

    def __call__(self) -> int:
        u = float(self.qrng.random(1)[0, 0])
        i = int(np.searchsorted(self.accum, u))
        return min(max(i, 0), len(self.accum) - 1)


class PseudoRandomChoices:
    def __init__(self, weights, seed=None):
        self.probs = weights_normalized(weights)
        self.n = len(self.probs)
        self.rng = np.random.RandomState(seed=seed)

    def __call__(self) -> int:
        return int(self.rng.choice(self.n, p=self.probs))


class ConcatDatasetSampler:
    """Interleaves per-dataset samplers according to a weighted dataset choice.

    Infinite by default (`stop_after=sys.maxsize`); yields global indices into
    the ConcatDataset. Each iteration starts the dataset choice from a copy of
    `dataset_index_sampler`, as the JAX package does.
    """

    def __init__(
        self,
        dataset: ConcatDataset,
        wrapped: Sequence,
        dataset_index_sampler: Callable[[], int],
        stop_after: int = sys.maxsize,
    ):
        self.stop_after = stop_after
        self.samplers = wrapped
        self.dataset_index_sampler = dataset_index_sampler
        self.offsets = np.roll(dataset.cumulative_sizes, 1)
        self.offsets[0] = 0

    def _generate_item(self, sampler_output, dataset_start_index):
        if isinstance(sampler_output, (int, np.integer)):
            return int(sampler_output + dataset_start_index)
        return [int(j + dataset_start_index) for j in sampler_output]

    def __iter__(self):
        rng = copy.deepcopy(self.dataset_index_sampler)
        iters = [utils.cycle(ds) for ds in self.samplers]
        for _ in range(self.stop_after):
            i = rng()
            yield self._generate_item(next(iters[i]), self.offsets[i])

    def __len__(self):
        return self.stop_after


def make_concat_dataset_item_sampler(
    dataset: ConcatDataset,
    weights: Sequence[float],
    wrapped: Optional[Sequence] = None,
    stop_after: int = sys.maxsize,
    seed: Optional[int] = None,
):
    """The training CLIs' sampler: a `RandomSampler` per dataset and a
    pseudo-random weighted dataset choice, all from `seed`."""
    if wrapped is None:
        wrapped = [RandomSampler(ds, seed=seed) for ds in dataset.datasets]
    return ConcatDatasetSampler(dataset, wrapped, PseudoRandomChoices(weights, seed=seed), stop_after)
