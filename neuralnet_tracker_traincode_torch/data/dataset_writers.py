"""Writing pose files (the port's own copy of the JAX package's
`data/dataset_writers.py`): the schema-enforcing writer of the dataset
converters, and the boxes they label with.

`full_head_bbox` needs the full face model: without `$BFM_PATH` it returns
None, as the JAX package does; with it, the posed full mesh's box.
"""

from typing import Dict, Iterable, Optional, Sequence

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

OPTIONAL_FIELD_SPECS = {
    "pt3d_68": dict(kind=C.points, name="pt3d_68", shape_wo_batch_dim=(68, 3)),
    "pt2d_68": dict(kind=C.points, name="pt2d_68", shape_wo_batch_dim=(68, 2)),
    "shapeparam": dict(kind=C.general, name="shapeparams", shape_wo_batch_dim=(50,), dtype=np.float16),
    "hasface": dict(kind=C.general, name="hasface", dtype=np.bool_),
}


def write_pose_hdf5(
    f,
    sample_iterator: Iterable[Dict[str, np.ndarray]],
    count: int,
    sequence_starts: Optional[Sequence[int]] = None,
    first_sample: Optional[Dict[str, np.ndarray]] = None,
    with_images: bool = True,
    progress: bool = True,
):
    """Write `count` samples (dicts of `image`, `pose`, `coord`, `roi` and
    the optional fields of `OPTIONAL_FIELD_SPECS`) into the open HDF5 file
    `f`, with the `max_image_hw` root attribute that sizes the loader's
    padding."""
    it = iter(sample_iterator)
    if first_sample is None:
        first_sample = next(it)
        it = _chain_one(first_sample, it)

    if sequence_starts is not None:
        f.create_dataset("sequence_starts", data=np.asarray(sequence_starts))

    datasets = {}
    if with_images:
        datasets["image"] = create_pose_dataset(f, C.image, count=count)
    datasets["roi"] = create_pose_dataset(f, C.roi, count=count, dtype=np.float32)
    datasets["pose"] = create_pose_dataset(f, C.quat, count=count, dtype=np.float32)
    datasets["coord"] = create_pose_dataset(f, C.xys, count=count, dtype=np.float32)
    for key, spec in OPTIONAL_FIELD_SPECS.items():
        if key in first_sample:
            spec = dict(spec)
            if "dtype" not in spec and spec["kind"] == C.points:
                spec["dtype"] = np.float32
            datasets[key] = create_pose_dataset(f, spec.pop("kind"), count=count, **spec)

    bar = None
    if progress:
        import tqdm

        bar = tqdm.tqdm(total=count)
    i = 0
    max_h = max_w = 0
    for sample in it:
        for key, ds in datasets.items():
            if key in sample:
                ds[i] = sample[key]
        img = sample.get("image")
        if isinstance(img, np.ndarray) and img.ndim >= 2:
            max_h, max_w = max(max_h, img.shape[0]), max(max_w, img.shape[1])
        i += 1
        if bar:
            bar.update(1)
        if i >= count:
            break
    if bar:
        bar.close()
    assert i == count, f"Expected {count} samples, got {i}"
    if max_h:
        f.attrs["max_image_hw"] = np.asarray([max_h, max_w], np.int32)


def _chain_one(first, rest):
    yield first
    yield from rest


def landmark_bbox(pt3d: np.ndarray) -> np.ndarray:
    """Axis-aligned box of (3, 68) or (68, 3) landmarks."""
    pts = pt3d if pt3d.shape[0] == 68 else pt3d.T
    x0, y0 = np.amin(pts[:, :2], axis=0)
    x1, y1 = np.amax(pts[:, :2], axis=0)
    return np.asarray([x0, y0, x1, y1], np.float32)


def full_head_bbox(coord, rot, shapeparam) -> Optional[np.ndarray]:
    """The posed full mesh's box (`rot` a scipy `Rotation`): None without
    `$BFM_PATH` (the keypoint model has no cranium)."""
    from neuralnet_tracker_traincode_torch.facemodel.bfm import full_model_from_env, posed_full_mesh

    model = full_model_from_env()
    if model is None:
        return None
    out = posed_full_mesh(model, shapeparam, rot, np.asarray(coord))
    x0, y0 = np.amin(out[:, :2], axis=0)
    x1, y1 = np.amax(out[:, :2], axis=0)
    return np.asarray([x0, y0, x1, y1], np.float32)
