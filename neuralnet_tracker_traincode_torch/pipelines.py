"""The dataset registry and the loaders of the CLIs (counterpart of the JAX
package's `pipelines.py`).

Each `make_*_dataset` opens its file in `$DATADIR` with its tag (and its
split); `make_pose_estimation_loaders` mixes the training sets by weights,
as sampling frequencies or as loss weights, into a `FusedBatchLoader` with
the training CLI's sampler, and gives the aflw2k3d test split for
validation. With `roi_override="original"` the training sets serve
undecoded JPEGs, which the loader's workers decode a batch at a time (with
`jpeg_decode="device"`, the training CLI's on the card, they only
entropy-decode and K4 finishes the decode on the card).
`make_validation_dataset` and `make_validation_loader` give the eval CLI's
single-frame samples (half-pixel offset, the ROI from the landmarks).
"""

import os
from functools import partial
from os.path import join
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.data import host_transforms
from neuralnet_tracker_traincode_torch.data.fields import DatasetId as Id
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.data.host_transforms import PutRoiFromLandmarks, offset_points_by_half_pixel_np
from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader
from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset
from neuralnet_tracker_traincode_torch.data.sampling import (
    ConcatDataset,
    Subset,
    TransformedDataset,
    make_concat_dataset_item_sampler,
)
from neuralnet_tracker_traincode_torch.parallel.distributed import DataParallel, process_local_seed


def _datadir() -> str:
    return os.environ["DATADIR"]


def make_biwi_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "biwi-v3.h5"), transform=transform, dataclass=Tag.ONLY_POSE)


def make_300vw_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "300vw.h5"), transform=transform, dataclass=Tag.ONLY_LANDMARKS_2D)


def make_lapa_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "lapa.h5"), transform=transform, dataclass=Tag.ONLY_LANDMARKS_2D)


def make_lapa_megaface_lp_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "lapa-megaface-augmented-v2.h5"), transform=transform,
                           dataclass=Tag.POSE_WITH_LANDMARKS)


def make_synface_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "microsoft_synface_100000-v1.1.h5"), transform=transform,
                           dataclass=Tag.ONLY_LANDMARKS_25D)


def make_wflw_relabeled_datasets(transform=None):
    train = Hdf5PoseDataset(join(_datadir(), "wflw_train.h5"), transform=transform, dataclass=Tag.ONLY_LANDMARKS_2D)
    test = Hdf5PoseDataset(join(_datadir(), "wflw_test.h5"), transform=transform, dataclass=Tag.ONLY_LANDMARKS_2D)
    return train, test


def make_wflw_lp_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "wflw_augmented_v4.h5"), transform=transform,
                           dataclass=Tag.POSE_WITH_LANDMARKS)


def make_widerface_datasets(transform=None):
    """(train, test): the rows from 500 on, and the first 500."""
    ds = Hdf5PoseDataset(join(_datadir(), "widerfacessingle.h5"), transform=transform, dataclass=Tag.FACE_DETECTION)
    return Subset(ds, np.arange(500, len(ds))), Subset(ds, np.arange(500))


def make_panoptic_datasets(transform=None):
    """(train, test): 1,024 test rows drawn by `RandomState(1234567)`."""
    ds = Hdf5PoseDataset(join(_datadir(), "panoptic-v2.h5"), transform=transform, dataclass=Tag.ONLY_POSE,
                         coord_convention_id=1)
    test_indices = np.random.RandomState(seed=1234567).choice(len(ds), 1024, replace=False)
    train_indices = np.setdiff1d(np.arange(len(ds)), test_indices)
    return Subset(ds, train_indices), Subset(ds, test_indices)


def make_panoptic_trainset(transform=None):
    return make_panoptic_datasets(transform)[0]


def make_replicant_face_datasets(transform=None):
    train = Hdf5PoseDataset(join(_datadir(), "replicant-face-v4-wider-100k.h5"), transform=transform,
                            dataclass=Tag.POSE_WITH_LMKS_NO_SHAPE_PARAMS)
    test = Hdf5PoseDataset(join(_datadir(), "replicant-face-v4-eval-10k.h5"), transform=transform,
                           dataclass=Tag.POSE_WITH_LMKS_NO_SHAPE_PARAMS)
    return train, test


def make_replicant_face_stability_test(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "replicant-face-stability-test-wider.h5"), transform=transform,
                           dataclass=Tag.POSE_WITH_LMKS_NO_SHAPE_PARAMS)


def indices_without_extreme_poses(filename):
    """The rows of a pose file whose AFLW pitch, yaw and roll are all below
    99 degrees in magnitude and whose head size is not negative."""
    import h5py

    with h5py.File(filename, "r") as f:
        quats, coords = f["quats"][...], f["coords"][...]
    return host_transforms.indices_without_extreme_poses(quats, coords)


def make_aflw2k3d_dataset(remove_extreme_poses=True, transform=None, filename=None):
    filename = filename or join(_datadir(), "aflw2k.h5")
    aflw = Hdf5PoseDataset(filename, transform=transform, dataclass=Tag.POSE_WITH_LANDMARKS)
    if remove_extreme_poses:
        indices = indices_without_extreme_poses(filename)
        print(f"Filtering {len(aflw) - len(indices)} extreme poses from aflw2k-3d dataset")
        aflw = Subset(aflw, indices)
    return aflw


def make_aflw2k3d_closedeyes_dataset(remove_extreme_poses=True, transform=None):
    return make_aflw2k3d_dataset(remove_extreme_poses, transform, join(_datadir(), "aflw2k3d-closedeyes.h5"))


# the grimaces among the first 400 faces (the test split)
_GRIMACE_INDICES = np.array(
    [39, 236, 0, 129, 164, 356, 359, 256, 136, 375, 226, 392, 119, 366, 293, 56, 305,
     303, 397, 10, 11, 96, 173, 124, 115, 153, 337, 29, 121, 266, 387, 122, 8, 59, 108,
     380, 187, 192, 353, 257, 162, 363, 331, 14, 163]
)


def make_aflw2k3d_grimaces_dataset(transform=None):
    ds = Hdf5PoseDataset(join(_datadir(), "aflw2k.h5"), transform=transform, dataclass=Tag.POSE_WITH_LANDMARKS)
    return Subset(ds, _GRIMACE_INDICES)


def make_aflw2k3d_datasets(transform=None):
    """(train, test): the rows from 400 on, and the first 400 (fewer in a
    smaller file)."""
    ds = Hdf5PoseDataset(join(_datadir(), "aflw2k.h5"), transform=transform, dataclass=Tag.POSE_WITH_LANDMARKS)
    n_test = min(400, len(ds))
    return Subset(ds, np.arange(n_test, len(ds))), Subset(ds, np.arange(n_test))


def make_300wlp_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "300wlp.h5"), transform=transform,
                           dataclass=Tag.POSE_WITH_LANDMARKS_3D_AND_2D)


def make_repro_300wlp_dataset(transform=None, with_eye_aug=True):
    filename = {True: "reproduction_300wlp-v12.h5", False: "reproduction_300wlp_simple.h5"}[with_eye_aug]
    return Hdf5PoseDataset(join(_datadir(), filename), transform=transform, dataclass=Tag.POSE_WITH_LANDMARKS)


def make_myself_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "myself.h5"), transform=transform)


def make_myselfyaw_dataset(transform=None):
    return Hdf5PoseDataset(join(_datadir(), "myself-yaw.h5"), transform=transform)


def _innermost(ds):
    while hasattr(ds, "dataset"):
        ds = ds.dataset
    return ds


def probe_pad_size(datasets: Sequence, num_probe: int = 16, multiple: int = 64) -> int:
    """The padding of the fused batches: the `max_image_hw` bound of each
    file where it has one, else the largest of `num_probe` samples spread
    over the set, rounded up to `multiple` (a larger image later grows its
    batch's padding)."""
    maxdim = 0
    for ds in datasets:
        hw = getattr(_innermost(ds), "max_image_hw", None)
        if hw is not None:
            maxdim = max(maxdim, *hw)
            continue
        n = len(ds)
        for i in np.linspace(0, n - 1, min(num_probe, n)).astype(int):
            w, h = ds[int(i)].meta.image_wh
            maxdim = max(maxdim, w, h)
    return utils.ceil_to_multiple(maxdim, multiple)


def _train_host_transform(roi_override: str):
    """The host transform of the training sets: none for the labelled ROI
    ("original"), else the ROI from the landmarks (with the head sphere for
    "extent_to_forehead"). Everything else runs on the card."""
    if roi_override == "original":
        return None
    if roi_override in ("landmarks", "extent_to_forehead"):
        return PutRoiFromLandmarks(extend_to_forehead=(roi_override == "extent_to_forehead"))
    raise ValueError(roi_override)


_TRAIN_DATASETS: List[Tuple[Id, Callable, float]] = [
    (Id.SYNFACE, make_synface_dataset, 10_000.0),
    (Id.BIWI, make_biwi_dataset, 1000.0),
    (Id._300VW, make_300vw_dataset, 5000.0),
    (Id.LAPA, make_lapa_dataset, 20000.0),
    (Id.WFLW_LP, make_wflw_lp_dataset, 40000.0),
    (Id.LAPA_MEGAFACE_LP, make_lapa_megaface_lp_dataset, 10000.0),
    (Id.PANOPTIC_CMU, make_panoptic_trainset, 20_000.0),
]

_TRAIN_TEST_DATASETS: List[Tuple[Id, Callable, float]] = [
    (Id.WFLW_RELABEL, make_wflw_relabeled_datasets, 10000.0),
    (Id.REPLICANT_FACE, make_replicant_face_datasets, 10_000.0),
]


def make_pose_estimation_loaders(
    inputsize: int,
    batchsize: int,
    datasets: Sequence[Id],
    dataset_weights: Optional[Dict[Id, float]] = None,
    use_weights_as_sampling_frequency: bool = True,
    enable_image_aug: bool = True,
    rotation_aug_angle: float = 30.0,
    roi_override: str = "original",
    pad_size: Optional[int] = None,
    seed: Optional[int] = None,
    num_workers: Optional[int] = None,
    parallel: Optional[DataParallel] = None,
    jpeg_decode: str = "host",
):
    """The training CLI's data: (train loader, aflw2k3d test split, number of
    training samples, tag order, augmentation config). The sampler draws
    from `seed`; with `parallel` (a data-parallel rank) from the node's
    `process_local_seed(seed, node, nodes)`, as each JAX process does, and
    the loader packs this rank's rows of the node's batches of `batchsize`.
    `jpeg_decode` is the loader's (`FusedBatchLoader`)."""
    parallel = parallel or DataParallel()
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig

    dataset_weights = dict(dataset_weights or {})
    transform = _train_host_transform(roi_override)
    extension_factor = {"original": 1.1, "extent_to_forehead": 1.1, "landmarks": 1.2}[roi_override]

    train_sets: List = []
    tags: List[Any] = []
    weights: List[float] = []
    ds_with_sizes = []

    def add(id_, ds, default_weight):
        assert len(ds) > 0, (
            f"dataset {id_} resolved to an EMPTY train split — check the file contents (e.g. aflw2k.h5 needs > 400 "
            f"rows: the first 400 are the held-out test split)"
        )
        train_sets.append(ds)
        tags.append(ds.dataset.dataclass if isinstance(ds, Subset) else ds.dataclass)
        weights.append(dataset_weights.get(id_, default_weight))
        ds_with_sizes.append((id_, len(ds)))

    for id_, ctor, w in _TRAIN_DATASETS:
        if id_ in datasets:
            add(id_, ctor(transform=transform), w)
    for id_, ctor, w in _TRAIN_TEST_DATASETS:
        if id_ in datasets:
            add(id_, ctor(transform=transform)[0], w)
    if Id.AFLW2k3d in datasets:
        add(Id.AFLW2k3d, make_aflw2k3d_datasets(transform=transform)[0], 1000.0)

    variants = [x for x in datasets if x in (Id._300WLP, Id.REPO_300WLP, Id.REPO_300WLP_WO_EXTRA)]
    if variants:
        (id_,) = variants
        ctor = {
            Id._300WLP: make_300wlp_dataset,
            Id.REPO_300WLP: partial(make_repro_300wlp_dataset, with_eye_aug=True),
            Id.REPO_300WLP_WO_EXTRA: partial(make_repro_300wlp_dataset, with_eye_aug=False),
        }[id_]
        add(id_, ctor(transform=transform), 60_000.0)

    if Id.WIDER in datasets:
        train, _ = make_widerface_datasets(transform=None)
        add(Id.WIDER, TransformedDataset(train, transform) if transform else train, 10_000.0)

    assert train_sets, "No training datasets selected"
    weights_arr = np.asarray(weights, np.float64)
    if use_weights_as_sampling_frequency:
        frequencies = weights_arr / weights_arr.sum()
        loss_weights = None
    else:
        frequencies = np.ones_like(weights_arr) / len(weights_arr)
        loss_weights = (weights_arr / np.amax(weights_arr)).tolist()

    print("Train datasets:\n\t" + ",\n\t".join(
        f"{id_}: {sz}  frequency: {f * 100:0.1f}%" for (id_, sz), f in zip(ds_with_sizes, frequencies)))

    concat = ConcatDataset(train_sets)
    sampler = make_concat_dataset_item_sampler(concat, frequencies,
                                               seed=process_local_seed(seed, parallel.node, parallel.nodes))
    if pad_size is None:
        pad_size = probe_pad_size(train_sets)
        print(f"Probed pad size: {pad_size}")

    if transform is None:
        # no host-side pixel work: the workers decode whole batches of undecoded JPEGs
        for ds in train_sets:
            inner = _innermost(ds)
            if isinstance(inner, Hdf5PoseDataset):
                inner.use_raw_images = True

    tag_order = sorted(set(tags), key=lambda t: t.value)
    tag_to_id = {t: i for i, t in enumerate(tag_order)}
    train_loader = FusedBatchLoader(
        concat,
        tags_by_dataset_index=tags.__getitem__,
        tag_to_id=tag_to_id,
        sampler=sampler,
        batchsize=batchsize,
        pad_size=pad_size,
        dataset_weight_by_index=None if loss_weights is None else loss_weights.__getitem__,
        num_workers=num_workers if num_workers is not None else utils.num_workers(),
        parallel=parallel,
        jpeg_decode=jpeg_decode,
    )

    _, test_set = make_aflw2k3d_datasets(transform=transform)
    aug_config = TrainAugmentationConfig(
        inputsize=inputsize,
        rotation_aug_angle=rotation_aug_angle,
        extension_factor=extension_factor,
        enable_image_aug=enable_image_aug,
    )
    return train_loader, test_set, len(concat), tag_order, aug_config


def make_validation_dataset(
    name: str,
    order: Optional[Sequence[int]] = None,
    use_head_roi: bool = True,
    additional_transforms: Optional[List[Any]] = None,
):
    """The eval CLI's samples of dataset `name` (or of the pose file at a
    `.h5` path): labels offset by half a pixel, the ROI from the landmarks
    (with `use_head_roi`: the posed full mesh's box under `$BFM_PATH`, else the
    head sphere's), in `order` where given."""
    transforms = [offset_points_by_half_pixel_np, PutRoiFromLandmarks(extend_to_forehead=use_head_roi)]
    transforms += list(additional_transforms or [])

    def transform(sample):
        for t in transforms:
            sample = t(sample)
        return sample

    ctors = {
        "aflw2k3d": make_aflw2k3d_dataset,
        "aflw2k3d_grimaces": make_aflw2k3d_grimaces_dataset,
        "aflw2k3d_closedeyes": make_aflw2k3d_closedeyes_dataset,
        "myself": make_myself_dataset,
        "myself_yaw": make_myselfyaw_dataset,
        "biwi": make_biwi_dataset,
        "repro_300_wlp": make_repro_300wlp_dataset,
        "wflw_lp": make_wflw_lp_dataset,
        "lapa_megaface_lp": make_lapa_megaface_lp_dataset,
        "panoptic": lambda transform: make_panoptic_datasets(transform)[1],
        "replicantface-stability": make_replicant_face_stability_test,
        "replicantface": lambda transform: make_replicant_face_datasets(transform)[1],
    }
    if name.endswith((".h5", ".hdf5")):
        ds = Hdf5PoseDataset(name, transform=transform, dataclass=Tag.POSE_WITH_LANDMARKS)
    elif name == "replicantface-train":
        ds, _ = make_replicant_face_datasets(transform=transform)
        ds = Subset(ds, np.random.default_rng(seed=42).integers(0, len(ds) - 1, size=1000))
    else:
        assert name in ctors, f"Unknown dataset {name}"
        ds = ctors[name](transform=transform)
    if order is not None:
        ds = Subset(ds, order)
    return ds


class ValidationLoader:
    """The single samples of a validation dataset (the Predictor batches
    them itself)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        return (self.dataset[i] for i in range(len(self.dataset)))

    def __len__(self):
        return len(self.dataset)


def make_validation_loader(name: str, order: Optional[Sequence[int]] = None, use_head_roi: bool = True,
                           additional_sample_transform=None) -> ValidationLoader:
    return ValidationLoader(make_validation_dataset(
        name, order, use_head_roi,
        additional_transforms=list(additional_sample_transform) if additional_sample_transform else None,
    ))
