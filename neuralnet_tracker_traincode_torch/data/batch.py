"""Batch container: a dict of arrays with shared metadata, and tag-segmented
collation (counterpart of the JAX package's `data/batch.py`).

Values may be numpy arrays (the host side: samples, metrics) or tensors (the
device side: predictions); collation concatenates each field with
`np.concatenate` or `torch.cat` after its first value. A single frame, as
the datasets give it and the fused-batch packer and the Predictor take it,
is a Batch with batch size 0 (`frame`): the port has one sample type.
"""

import copy
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.data.fields import POSE_FIELD_CATEGORIES


@dataclass
class Metadata:
    _imagesize: Union[None, int, Tuple[int, int]]
    batchsize: int
    tag: Optional[Any] = field(default=None)
    seq: Optional[List[int]] = field(default=None)
    categories: Dict[str, Any] = field(default_factory=dict)

    @property
    def image_wh(self):
        if self._imagesize is None or isinstance(self._imagesize, tuple):
            return self._imagesize
        return (self._imagesize, self._imagesize)

    @property
    def sequence_start_end(self):
        assert self.seq
        return list(zip(self.seq[:-1], self.seq[1:]))

    @property
    def prefixshape(self):
        return (self.seq[-1],) if self.seq else ((self.batchsize,) if self.batchsize else ())

    @property
    def is_single_frame(self):
        return self.seq is None and self.batchsize == 0


def _concat(arrays):
    if isinstance(arrays[0], torch.Tensor):
        return torch.cat(arrays, dim=0)
    return np.concatenate(arrays, axis=0)


class Batch:
    """Dict of per-field arrays with shared Metadata."""

    def __init__(self, meta: Metadata, *data, **kwargs):
        self.meta: Metadata = meta
        self._data: Dict[str, Any] = dict(*data, **kwargs)

    def items(self):
        return self._data.items()

    def __getitem__(self, k):
        return self._data[k]

    def __setitem__(self, k, v):
        self._data[k] = v

    def __delitem__(self, k):
        del self._data[k]

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def __contains__(self, k):
        return k in self._data

    def pop(self, k, *default):
        return self._data.pop(k, *default)

    def get(self, k, default=None):
        return self._data.get(k, default)

    def __str__(self):
        seq_str = f",N={self.meta.seq[-1]}" if self.meta.seq is not None else ""
        return f"Batch({self.meta.tag},B={self.meta.batchsize}{seq_str})"

    def get_category(self, k, default=None):
        assert k in self._data
        return self.meta.categories.get(k, default)

    def with_batchdim(self) -> "Batch":
        """View with batchsize >= 1, adding the batch dim to all arrays if absent."""
        if self.meta.batchsize > 0:
            return self
        meta = copy.copy(self.meta)
        meta.batchsize = max(meta.batchsize, 1)
        if self.meta.seq is not None:
            return Batch(meta, self.items())
        return Batch(meta, ((k, v[None, ...]) for k, v in self.items()))

    def iter_frames(self) -> Iterator["Batch"]:
        if self.meta.is_single_frame:
            yield self
        else:
            (n,) = self.meta.prefixshape
            meta = copy.copy(self.meta)
            meta.batchsize = 0
            meta.seq = None
            for i in range(n):
                yield Batch(meta, ((k, v[i, ...]) for k, v in self.items()))

    def iter_sequences(self) -> Iterator["Batch"]:
        assert self.meta.seq is not None
        for a, b in self.meta.sequence_start_end:
            meta = copy.copy(self.meta)
            meta.batchsize = 0
            meta.seq = [0, b - a]
            yield Batch(meta, ((k, v[a:b, ...]) for k, v in self.items()))

    def undo_collate(self) -> Iterator["Batch"]:
        if self.meta.seq:
            yield from self.iter_sequences()
        else:
            yield from self.iter_frames()

    def copy(self):
        """Shallow copy."""
        return Batch(copy.copy(self.meta), **self._data)

    def map_arrays(self, fn: Callable[[Any], Any]) -> "Batch":
        return Batch(copy.copy(self.meta), ((k, fn(v)) for k, v in self.items()))

    def to_numpy(self) -> "Batch":
        return self.map_arrays(lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))

    def to(self, device) -> "Batch":
        return self.map_arrays(lambda v: torch.as_tensor(v).to(device))

    class Collation:
        """Concatenate sample Batches; optionally grouped by a key (e.g. tag)."""

        def __init__(self, key_getter: Optional[Callable[["Batch"], Any]] = None):
            self._key_getter = key_getter if key_getter is not None else (lambda b: True)
            self._divide_samples = key_getter is not None

        def __call__(self, samples: List["Batch"]):
            divisions = defaultdict(list)
            for item in samples:
                assert isinstance(item, Batch), f"Expected list of Batch, got {type(item)}"
                divisions[self._key_getter(item)].append(item)
            batches = list(map(self._collate_single_class, divisions.values()))
            if not self._divide_samples:
                (batches,) = batches
            return batches

        def _collate_single_class(self, samples: List["Batch"]) -> "Batch":
            first = samples[0]
            if first.meta.seq is None:
                return Batch(self._combine_metadata(samples, first),
                             self._combine_samples([s.with_batchdim() for s in samples], first))
            return Batch(self._combine_metadata(samples, first), self._combine_samples(samples, first))

        def _combine_metadata(self, samples, first) -> Metadata:
            meta = copy.copy(first.meta)
            if first.meta.seq is None:
                meta.batchsize = sum(max(s.meta.batchsize, 1) for s in samples)
            else:
                lengths = np.asarray([0] + [s.meta.seq[-1] for s in samples])
                offsets = np.cumsum(lengths)[:-1]
                seq = np.concatenate(
                    [np.zeros((1,), dtype=np.int32)] + [np.asarray(s.meta.seq[1:]) + o for s, o in zip(samples, offsets)]
                ).tolist()
                meta.batchsize = len(seq) - 1
                meta.seq = seq
            return meta

        def _combine_samples(self, samples, first) -> Dict[str, Any]:
            assert all(s.meta.prefixshape != () for s in samples)
            return {k: _concat([s[k] for s in samples]) for k in first.keys()}

    collate = None  # assigned below


Batch.collate = Batch.Collation()


def frame(tag, fields: Mapping[str, Any]) -> Batch:
    """One labelled frame held in memory, as a single-frame Batch: field ->
    array ("image" (H, W, C) uint8 and labels in source pixels), the image
    size from the image (None for an undecoded image), and the pose-sample
    categories of the fields."""
    shape = np.shape(fields["image"])
    wh = (int(shape[1]), int(shape[0])) if len(shape) >= 2 else None
    cats = {k: POSE_FIELD_CATEGORIES[k] for k in fields if k in POSE_FIELD_CATEGORIES}
    return Batch(Metadata(wh, 0, tag=tag, categories=cats), fields)
