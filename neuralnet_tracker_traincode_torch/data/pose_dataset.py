"""Pose datasets over the HDF5 schema (the port's own copy of the JAX
package's `data/pose_dataset.py`).

A sample is a single-frame `Batch` (`data/batch.py`) with the category of
each field, the HDF5 names mapped to the runtime names (`quats` -> `pose`,
...), f16 and f64 arrays as f32, images with a channel axis, and the extras
`individual` (where the file has sequences or individuals), `index` and
`coord_convention_id`. `Hdf5PoseVideoDataset` groups the frames of one
individual into mini-sequences, each a `Batch` with `meta.seq`.
"""

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata
from neuralnet_tracker_traincode_torch.data.fields import (
    FieldCategory,
    field_default_names,
    imagelike_categories,
    inconsistent_name_mapping,
)
from neuralnet_tracker_traincode_torch.data.hdf5 import (
    Hdf5DatasetBase,
    ImageVariableLengthBufferDs,
    Whitelist,
    create_dataset,
)

Tag = Any


def _identity(x):
    """Module-level identity: a lambda would not pickle into a worker process."""
    return x


def create_pose_dataset(
    g,
    kind: FieldCategory,
    name: Optional[str] = None,
    count: Optional[int] = None,
    shape_wo_batch_dim: Optional[Tuple[int, ...]] = None,
    data=None,
    dtype=None,
    exists_ok=False,
    **kwargs,
):
    """Create one field of a pose file with the schema's shape for its
    category (quat (N, 4), xys (N, 3), roi (N, 4), points (N, P, D); images
    as variable-length buffers) and its `category` attribute."""

    def equal_or_updated(x, update):
        assert (x is None) or (update is None) or (x == update)
        return update if x is None else x

    shape_postfix_by_kind = {FieldCategory.quat: (4,), FieldCategory.xys: (3,), FieldCategory.roi: (4,)}.get(kind)
    if name is None:
        name = field_default_names.get(kind, None)
    if kind in (FieldCategory.image, FieldCategory.semseg):
        assert shape_wo_batch_dim is None
        assert dtype is None
        shape = (count,)
    elif kind in (FieldCategory.quat, FieldCategory.xys, FieldCategory.roi):
        shape = (count,) + shape_postfix_by_kind
    elif kind == FieldCategory.points:
        shape = (count,) + (None, None)
    elif kind == FieldCategory.general:
        shape = (count,)
    else:
        raise AssertionError("Not implemented")
    if kind in (FieldCategory.quat, FieldCategory.xys, FieldCategory.roi, FieldCategory.points):
        assert np.dtype(dtype) in (np.float16, np.float32, np.float64)
    elif kind == FieldCategory.general:
        assert (dtype is not None) or (data is not None)
    if shape_wo_batch_dim is not None:
        if kind == FieldCategory.general:
            shape = (count,) + shape_wo_batch_dim
        shape = (count,) + tuple(equal_or_updated(x, u) for x, u in zip(shape[1:], shape_wo_batch_dim))
    if data is not None:
        data = np.asarray(data)
        shape = shape + tuple([None] * (data.ndim - len(shape)))
        shape = tuple(equal_or_updated(x, u) for x, u in zip(shape, data.shape))
        assert data.shape == shape, f"Expected shape {shape} but data has {data.shape}"
    assert all(x is not None for x in shape)
    if exists_ok and name in g:
        del g[name]
    if kind == FieldCategory.image:
        ds = ImageVariableLengthBufferDs.create(g, name, count, **kwargs)
    elif kind == FieldCategory.semseg:
        ds = ImageVariableLengthBufferDs.create(g, name, count, lossy=False, **kwargs)
    else:
        ds = create_dataset(g, name, shape, dtype, shape, data, **kwargs)
    ds.attrs["category"] = kind.value
    return ds


def _find_image_size_and_give_channel_dim(values, categories):
    h, w = None, None
    for i, (category, value) in enumerate(zip(categories, values)):
        if category not in imagelike_categories:
            continue
        if isinstance(value, np.ndarray) and value.ndim == 2:
            values[i] = value = value[..., None]
        new_h, new_w, _ = value.shape
        if h is None:
            h, w = new_h, new_w
        else:
            assert (h, w) == (new_h, new_w), "Differently sized images in one sample"
    assert (w is not None) and (h is not None), f"Requires an image. Got categories {categories}"
    return w, h


def _change_strange_types(value):
    if isinstance(value, np.ndarray) and value.dtype in (np.float16, np.float64):
        value = value.astype(np.float32)
    return value


Field2Categories = Dict[str, FieldCategory]


def _get_categories_of_h5datasets(names_datasets) -> Field2Categories:
    return {name: FieldCategory(ds.attrs.get("category", FieldCategory.general.value)) for name, ds in names_datasets}


default_whitelist = [
    "/images",
    "/keys",
    "/rois",
    "/coords",
    "/quats",
    "/pt3d_68",
    "/pt2d_68",
    "/shapeparams",
    "/semseg",
    "/seg_image",
    "/hasface",
]


def _transform_to_pose_sample(sample: List[Tuple[str, Any]], dataclass: Tag, categories_mapping: Field2Categories
                              ) -> Batch:
    names, values = list(zip(*sample))
    categories = [categories_mapping[n] for n in names]
    values = list(map(_change_strange_types, values))
    names = [inconsistent_name_mapping.get(n, n) for n in names]
    w, h = _find_image_size_and_give_channel_dim(values, categories)
    return Batch(Metadata((w, h), 0, dataclass, None, categories=dict(zip(names, categories))), dict(zip(names, values)))


class Hdf5PoseDataset(Hdf5DatasetBase):
    """Single frames of a pose file, each through `transform`."""

    def __init__(
        self,
        filename,
        transform=None,
        monochrome=True,
        dataclass: Tag = None,
        whitelist: Whitelist = None,
        coord_convention_id: int = 0,
    ):
        whitelist = whitelist or default_whitelist
        self._sequence_starts = None
        self._frame_to_individual = None
        super().__init__(filename, monochrome, whitelist)
        self.transform = _identity if transform is None else transform
        self.dataclass = dataclass
        self.coord_convention_id = coord_convention_id

    def _init_from_file(self, f, whitelist: Whitelist):
        names_datasets = super()._init_from_file(f, whitelist)
        self._categories = _get_categories_of_h5datasets(names_datasets)
        hw = f.attrs.get("max_image_hw")
        self._max_image_hw = None if hw is None else tuple(int(v) for v in hw)
        if "sequence_starts" in f:
            self._sequence_starts = np.array(f["sequence_starts"][...]).astype(np.int32)
            self._frame_to_individual = np.concatenate(
                [np.full(b - a, i, dtype=np.int32) for i, (a, b) in enumerate(self.sequences)]
            )
        elif "individual" in f:
            self._frame_to_individual = f["individual"][...].astype(np.int32)
        return names_datasets

    @property
    def max_image_hw(self):
        """(H, W) bound stored by the writers (the `max_image_hw` root
        attribute), or None for files without it."""
        return self._max_image_hw

    @property
    def sequence_starts(self):
        return self._sequence_starts

    @property
    def sequences(self):
        return np.stack([self._sequence_starts[:-1], self._sequence_starts[1:]], axis=-1)

    def __getitem__(self, index):
        sample = _transform_to_pose_sample(super().__getitem__(index), self.dataclass, self._categories)
        if self._frame_to_individual is not None:
            sample["individual"] = np.asarray(self._frame_to_individual[index], dtype=np.int32)
        sample["index"] = np.asarray(index, dtype=np.int32)
        sample["coord_convention_id"] = np.asarray(self.coord_convention_id, dtype=np.int32)
        return self.transform(sample)


class Hdf5PoseVideoDataset(Hdf5DatasetBase):
    """The frames of one individual grouped into mini-sequences of
    `min_sequence_size` to `max_sequence_size` frames."""

    def __init__(
        self,
        filename,
        min_sequence_size,
        max_sequence_size,
        frame_transform=None,
        transform=None,
        monochrome=True,
        dataclass: Tag = None,
        whitelist: Whitelist = None,
    ):
        self.min_sequence_size = min_sequence_size
        self.max_sequence_size = max_sequence_size
        super().__init__(filename, monochrome=monochrome, whitelist=whitelist or default_whitelist)
        self.dataclass = dataclass
        self.transform = _identity if transform is None else transform
        self.frame_transform = _identity if frame_transform is None else frame_transform

    def _init_from_file(self, f, whitelist: Whitelist):
        names_datasets = super()._init_from_file(f, whitelist)
        self._categories = _get_categories_of_h5datasets(names_datasets)
        assert "sequence_starts" in f, "Video dataset requires sequences"
        self.sequence_starts = np.array(f["sequence_starts"])
        self.sequences = [
            s for a, b in zip(self.sequence_starts[:-1], self.sequence_starts[1:])
            for s in self._postprocess_sequence(a, b, self.min_sequence_size, self.max_sequence_size)
        ]
        return names_datasets

    @staticmethod
    def _postprocess_sequence(a, b, min_sequence_size, max_sequence_size):
        """Drop a sequence shorter than the minimum; split one longer than the
        maximum into equal parts widened symmetrically to the maximum (they
        may overlap)."""
        if b - a < min_sequence_size:
            return []
        if b - a > max_sequence_size:
            splits = math.ceil((b - a) / max_sequence_size)
            centers = np.floor((np.arange(splits) + 0.5) * (b - a) / splits)
            starts = np.maximum(0, centers - max_sequence_size // 2)
            starts = np.minimum(b - a - max_sequence_size, starts)
            starts = starts.astype(np.int64) + a
            return [*zip(starts, starts + max_sequence_size)]
        return [(a, b)]

    def __len__(self):
        return len(self.sequences)

    def sequence_frame_count(self, index: int) -> int:
        """Frames in mini-sequence `index`, from the metadata alone (the
        loader's batch plans use it)."""
        a, b = self.sequences[index]
        return int(b - a)

    def _load_sample(self, sequence_index, index):
        s = _transform_to_pose_sample(Hdf5DatasetBase.__getitem__(self, index), self.dataclass, self._categories)
        s["individual"] = np.asarray(sequence_index, dtype=np.int32)
        return self.frame_transform(s)

    def __getitem__(self, index):
        if index < 0 or index >= len(self):
            raise IndexError
        a, b = self.sequences[index]
        out = Batch.collate([self._load_sample(index, i) for i in range(a, b)])
        out.meta.batchsize = 0
        out.meta.seq = [0, b - a]
        return self.transform(out)
