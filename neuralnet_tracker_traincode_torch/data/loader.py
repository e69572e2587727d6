"""Fused-batch packing (counterpart of the JAX package's `data/loader.py`).

`pack_fused_batch` packs labelled frames held in memory into the fixed-shape
fused-batch dict that `PoseTrainer.train_step` and `FusedValidation` take:
images zero-padded (not rescaled) to (B, pad, pad, C) uint8, every field of
`LABEL_SCHEMA` present (zero where a frame lacks it, masked by the per-tag
loss weights), `hasface` label-smoothed to 0.9 / 0.1, and `tag_id`,
`dataset_weight`, `param_index` and `coord_convention_id` per frame.

A frame is any mapping of field -> array with a `meta` that carries the
dataset `tag` and the image size `image_wh`: a single-frame `Batch` of
either package (`data/batch.py:frame` makes the port's).
`plan_batches` cuts a sampler's index stream (`data/sampling.py`) into
batch plans as the JAX loader's `FusedBatchLoader.plan_batches` does, for
single frames; `iterate_fused_batches` makes training batches of a packed set
held on the card from the same cut of such a stream. The host loader
(`FusedBatchLoader`, its workers, HDF5 and JPEG decoding) and sequences wait
(ROADMAP.md).
"""

import itertools
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.data.fields import POSE_FIELD_CATEGORIES
from neuralnet_tracker_traincode_torch.device import not_ported, resolve_device
from neuralnet_tracker_traincode_torch.utils import ceil_to_multiple

LABEL_SCHEMA = {
    "pose": (4,),
    "coord": (3,),
    "roi": (4,),
    "pt3d_68": (68, 3),
    "shapeparam": (50,),
    "hasface": (),
}

LABEL_CATEGORIES = {k: POSE_FIELD_CATEGORIES[k] for k in LABEL_SCHEMA}


def _image(im) -> np.ndarray:
    if isinstance(im, torch.Tensor):
        return im.detach().cpu().numpy()
    if not isinstance(im, np.ndarray):
        raise not_ported(f"packing {type(im).__name__} images (JPEG buffers come with the loader)")
    return im


def pack_fused_batch(
    samples: Sequence[Mapping[str, Any]],
    tag_ids: Sequence[int],
    pad_size: int,
    dataset_weights: Optional[Sequence[float]] = None,
) -> Dict[str, np.ndarray]:
    """Pack single frames into one fused batch dict of numpy arrays. An image
    larger than `pad_size` grows this batch's padding to the next multiple of 64."""
    for s in samples:
        if getattr(getattr(s, "meta", None), "seq", None):
            raise not_ported("packing sequences (they come with the loader)")
    images = [_image(s["image"]) for s in samples]
    B = len(images)
    largest = max(max(im.shape[:2]) for im in images)
    if largest > pad_size:
        pad_size = ceil_to_multiple(largest)
    out: Dict[str, np.ndarray] = {"image": np.zeros((B, pad_size, pad_size, images[0].shape[-1]), np.uint8)}
    for i, im in enumerate(images):
        out["image"][i, : im.shape[0], : im.shape[1], :] = im
    for k, shape in LABEL_SCHEMA.items():
        out[k] = np.zeros((B,) + shape, np.float32)
    out["coord_convention_id"] = np.zeros((B,), np.int32)
    for i, f in enumerate(samples):
        for k in LABEL_SCHEMA:
            if k in f:
                v = np.asarray(f[k])
                if v.dtype == np.bool_ or k == "hasface":
                    v = np.where(v.astype(np.float32) > 0.5, 0.9, 0.1)  # label smoothing of binary labels
                out[k][i] = v.astype(np.float32)
        if "coord_convention_id" in f:
            out["coord_convention_id"][i] = int(f["coord_convention_id"])
    out["tag_id"] = np.asarray(tag_ids, np.int32)
    out["dataset_weight"] = np.asarray([1.0] * B if dataset_weights is None else dataset_weights, np.float32)
    out["param_index"] = np.arange(B, dtype=np.int32)
    return out


class BatchPlan(NamedTuple):
    """The composition of one fused batch: global indices into the concat
    dataset and the tag id and loss weight of each sample."""

    indices: List[int]
    tag_ids: List[int]
    weights: List[float]


def _has_sequences(ds) -> bool:
    """Whether a dataset, through its Concat/Subset/Transformed wrappers,
    holds sequences (the JAX loader's `sequence_frame_count`)."""
    if hasattr(ds, "sequence_frame_count"):
        return True
    if hasattr(ds, "datasets"):
        return any(_has_sequences(d) for d in ds.datasets)
    if hasattr(ds, "dataset"):
        return _has_sequences(ds.dataset)
    return False


def plan_batches(
    concat_dataset,
    tags_by_dataset_index: Callable[[int], Any],
    tag_to_id: Dict[Any, int],
    sampler: Iterable[int],
    batchsize: int,
    dataset_weight_by_index: Optional[Callable[[int], float]] = None,
) -> Iterator[BatchPlan]:
    """Cut the sampler's stream into plans of `batchsize` single frames, with
    the tag id and weight of each frame's dataset: the plans of the JAX
    loader's `FusedBatchLoader.plan_batches` when every sample is one frame.
    A finite stream ends with its last, shorter plan."""
    if _has_sequences(concat_dataset):
        raise not_ported("batch plans of sequences (they come with the loader)")
    cumsizes = np.asarray(concat_dataset.cumulative_sizes)
    n_ds = len(concat_dataset.datasets)
    tag_id_by_ds = [tag_to_id[tags_by_dataset_index(i)] for i in range(n_ds)]
    weight_by_ds = [1.0 if dataset_weight_by_index is None else float(dataset_weight_by_index(i)) for i in range(n_ds)]
    it = iter(sampler)
    while True:
        indices = [int(i) for i in itertools.islice(it, batchsize)]
        if not indices:
            return
        dsi = np.searchsorted(cumsizes, indices, side="right").tolist()
        yield BatchPlan(indices, [tag_id_by_ds[d] for d in dsi], [weight_by_ds[d] for d in dsi])
        if len(indices) < batchsize:
            return


def iterate_fused_batches(
    packed: Dict[str, Any], batchsize: int, sampler: Iterable[int], device=None, start: int = 0
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of `batchsize` frames from a packed set (one fused batch dict
    of all frames), held on `device` (default: the card), in the order of
    `sampler`'s indices into the set, as the training CLI's sampler gives
    them: `make_concat_dataset_item_sampler(ConcatDataset([frames]), [1.0],
    seed=seed)`. With `start`, the first batch is the one an iterator of an
    equal sampler gives after `start` batches (a resumed run's step): the
    first `start * batchsize` indices of the stream are skipped."""
    dev = resolve_device(device)
    data = {k: torch.as_tensor(v).to(dev) for k, v in packed.items()}
    n = data["tag_id"].shape[0]
    if n < batchsize:
        raise ValueError(f"{n} frames make no batch of {batchsize}")
    it = iter(sampler)
    for _ in itertools.islice(it, start * batchsize):
        pass
    while True:
        indices = list(itertools.islice(it, batchsize))
        if len(indices) < batchsize:
            return
        idx = torch.as_tensor(indices, dtype=torch.int64).to(dev)
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        batch["param_index"] = torch.arange(batchsize, dtype=torch.int32, device=dev)
        yield batch
