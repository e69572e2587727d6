"""The port's dataset registry and loader assembly (`pipelines.py`) against
the JAX package's, on a `$DATADIR` of synthetic files.

`make_pose_estimation_loaders` gives the JAX package's training-set size,
tag order, padding, augmentation config and batches (every field equal:
images bit-equal, labels exact) for a two-dataset mix, with the weights as
sampling frequencies and as loss weights, on the raw-JPEG path
(`roi_override="original"`) and with the ROI from the landmarks;
`make_validation_dataset` gives the same samples on a name and on a `.h5`
path; the panoptic and WIDER FACE splits are the JAX package's.
"""

import itertools

import numpy as np
import pytest

from neuralnet_tracker_traincode_tpu import pipelines as JPL
from neuralnet_tracker_traincode_tpu.data.fields import DatasetId as JId
from neuralnet_tracker_traincode_torch import pipelines as TPL
from neuralnet_tracker_traincode_torch.data.fields import DatasetId as TId
from neuralnet_tracker_traincode_torch.data.hdf5 import RawJpegBuffer
from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset
from torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse: the rendering of the fixture files
from torch_port_helpers import write_random_pose_file


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    d = tmp_path_factory.mktemp("datadir")
    write_synthetic_pose_dataset(str(d / "aflw2k.h5"), 424, 48, seed=3, device="cpu")  # with max_image_hw
    write_random_pose_file(d / "300wlp.h5", 30, size=56, seed=1)  # without: the pad is probed
    write_random_pose_file(d / "biwi-v3.h5", 12, size=40, seed=2, with_landmarks=False)
    write_random_pose_file(d / "panoptic-v2.h5", 1030, size=8, seed=4, with_landmarks=False)
    write_random_pose_file(d / "widerfacessingle.h5", 510, size=8, seed=5, with_landmarks=False)
    return str(d)


def _first_batches(P, Id, datadir, monkeypatch, n=3, **kwargs):
    monkeypatch.setenv("DATADIR", datadir)
    ids = [getattr(Id, name) for name in ("_300WLP", "BIWI", "AFLW2k3d")]
    loader, test_set, size, tag_order, aug = P.make_pose_estimation_loaders(
        inputsize=129, batchsize=8, datasets=ids, dataset_weights={Id.BIWI: 30_000.0, Id.AFLW2k3d: 20_000.0}, seed=11, num_workers=1,
        **kwargs)
    return list(itertools.islice(iter(loader), n)), loader, test_set, size, tag_order, aug


@pytest.mark.parametrize("frequencies", [True, False])
@pytest.mark.parametrize("roi_override", ["original", "landmarks"])
def test_pose_estimation_loaders_match_jax(datadir, monkeypatch, frequencies, roi_override):
    kwargs = dict(use_weights_as_sampling_frequency=frequencies, roi_override=roi_override, rotation_aug_angle=20.0)
    got, loader, test_set, size, tags, aug = _first_batches(TPL, TId, datadir, monkeypatch, **kwargs)
    want, jloader, jtest_set, jsize, jtags, jaug = _first_batches(JPL, JId, datadir, monkeypatch, **kwargs)
    assert size == jsize == 30 + 12 + 24  # aflw2k: the rows beyond the first 400
    assert [t.name for t in tags] == [t.name for t in jtags]
    assert loader.pad_size == jloader.pad_size == 64
    for k in ("inputsize", "rotation_aug_angle", "extension_factor", "enable_image_aug"):
        assert getattr(aug, k) == getattr(jaug, k), k
    assert len(test_set) == len(jtest_set) == 400
    raw = isinstance(loader.ds.datasets[0][0]["image"], RawJpegBuffer)
    assert raw == (roi_override == "original")
    for b, (x, y) in enumerate(zip(got, want)):
        assert set(x) == set(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"batch {b}, {k}")
    weights = set(np.concatenate([b["dataset_weight"] for b in got]).tolist())
    assert weights == ({1.0} if frequencies else {np.float32(1.0), np.float32(0.5), np.float32(1.0 / 3.0)})
    assert len(set(np.concatenate([b["tag_id"] for b in got]).tolist())) == 3


@pytest.mark.parametrize("use_head_roi", [True, False])
def test_validation_dataset_matches_jax(datadir, monkeypatch, use_head_roi):
    monkeypatch.setenv("DATADIR", datadir)
    for name in ("aflw2k3d", f"{datadir}/300wlp.h5"):
        got = TPL.make_validation_dataset(name, order=[5, 1, 3], use_head_roi=use_head_roi)
        want = JPL.make_validation_dataset(name, order=[5, 1, 3], use_head_roi=use_head_roi)
        assert len(got) == len(want) == 3
        for i in range(3):
            x, y = got[i], want[i]
            assert sorted(x.keys()) == sorted(y.keys()) and x.meta.image_wh == y.meta.image_wh
            for k in y.keys():
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    full = TPL.make_validation_dataset("aflw2k3d")
    assert len(full) == len(JPL.make_validation_dataset("aflw2k3d"))
    loader = TPL.make_validation_loader("aflw2k3d", order=[0, 2], use_head_roi=use_head_roi)
    assert len(loader) == 2 and [int(s["index"]) for s in loader] == [int(full.indices[0]), int(full.indices[2])]


def test_splits_match_jax(datadir, monkeypatch):
    monkeypatch.setenv("DATADIR", datadir)
    for got, want in zip(TPL.make_panoptic_datasets(), JPL.make_panoptic_datasets()):
        np.testing.assert_array_equal(got.indices, want.indices)
    train, test = TPL.make_panoptic_datasets()
    assert len(test) == 1024 and len(train) == 6 and test[0]["coord_convention_id"] == 1
    for got, want in zip(TPL.make_widerface_datasets(), JPL.make_widerface_datasets()):
        np.testing.assert_array_equal(got.indices, want.indices)
        assert got.dataset.dataclass.name == want.dataset.dataclass.name == "FACE_DETECTION"
    np.testing.assert_array_equal(TPL.indices_without_extreme_poses(f"{datadir}/aflw2k.h5"),
                                  JPL.indices_without_extreme_poses(f"{datadir}/aflw2k.h5"))
    grimaces = TPL.make_aflw2k3d_grimaces_dataset()
    np.testing.assert_array_equal(grimaces.indices, JPL.make_aflw2k3d_grimaces_dataset().indices)
    ds = [TPL.make_300wlp_dataset(), TPL.make_biwi_dataset()]
    assert TPL.probe_pad_size(ds) == JPL.probe_pad_size([JPL.make_300wlp_dataset(), JPL.make_biwi_dataset()]) == 64
    assert TPL.probe_pad_size([TPL.make_aflw2k3d_datasets()[0]]) == 64  # from max_image_hw (48)
    with pytest.raises(ValueError):
        TPL._train_host_transform("nonsense")
