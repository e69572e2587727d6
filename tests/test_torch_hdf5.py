"""The port's HDF5 layer (`data/hdf5.py`, `data/pose_dataset.py`,
`data/dataset_writers.py`, `data/synthetic.py:write_synthetic_pose_dataset`,
`data/preprocessing.py`) against the JAX package's, in both directions: a
file written by one package is read by the other.

Tolerances: labels exact, decoded images bit-equal, encoded buffers
byte-equal (both packages encode with cv2 at the same flags; the JAX package
decodes JPEGs with the native libjpeg loader where it loads, the port with
cv2, which agree bit for bit). `write_synthetic_pose_dataset`: with the same
labels and rendered images the two writers' files are equal field for field;
from a seed alone the labels agree to 1e-5 relative (the keypoint model in
f32 in torch and in XLA) and the rendered images to one gray level
(`test_torch_train_run.py`), which at the seed and size here decode equal.

Reference defects the port does not reproduce:
 - the JAX `Hdf5PoseVideoDataset` bounds a frame index by its count of
   sequences, so every sequence past that count raises IndexError; the
   port bounds it by the frames;
 - the JAX `imrescale` names `cv2.INTER_BILINEAR`, which cv2 lacks, so an
   upscale raises AttributeError; the port upscales with `INTER_LINEAR`.
"""

import multiprocessing as mp
import pickle

import h5py
import numpy as np
import pytest

from neuralnet_tracker_traincode_tpu.data import dataset_writers as JW
from neuralnet_tracker_traincode_tpu.data import hdf5 as JH
from neuralnet_tracker_traincode_tpu.data import pose_dataset as JP
from neuralnet_tracker_traincode_tpu.data import preprocessing as JPre
from neuralnet_tracker_traincode_tpu.data import synthetic as JS
from neuralnet_tracker_traincode_tpu.data.fields import FieldCategory as JC
from neuralnet_tracker_traincode_torch.data import dataset_writers as TW
from neuralnet_tracker_traincode_torch.data import hdf5 as TH
from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
from neuralnet_tracker_traincode_torch.data import preprocessing as TPre
from neuralnet_tracker_traincode_torch.data import synthetic as TS
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as TC
from neuralnet_tracker_traincode_torch.data.fields import Tag
from torch_port_helpers import JaxVideoDataset as _JaxVideoDataset
from torch_port_helpers import two_intra_op_threads  # noqa: F401 - autouse: the synthetic writers render in torch

PACKAGES = {"jax": (JH, JP, JC), "port": (TH, TP, TC)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _smooth_image(rng, h, w):
    import cv2

    return cv2.GaussianBlur((rng.rand(h, w) * 255).astype(np.uint8), (5, 5), 2)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("lossy", [True, False])
def test_image_buffers_cross_packages(tmp_path, writer, reader, lossy):
    rng = np.random.RandomState(1)
    images = [_smooth_image(rng, 24 + 8 * i, 40 - 4 * i) for i in range(3)]
    path = tmp_path / "images.h5"
    with h5py.File(path, "w") as f:
        ds = PACKAGES[writer][0].ImageVariableLengthBufferDs.create(f, "images", 3, lossy=lossy)
        for i, img in enumerate(images):
            ds[i] = img
    other = PACKAGES["port" if writer == "jax" else "jax"][0]
    with h5py.File(path, "r") as f:
        got = PACKAGES[reader][0].open_dataset(f, "images")
        assert isinstance(got, PACKAGES[reader][0].ImageVariableLengthBufferDs)
        want = PACKAGES[writer][0].open_dataset(f, "images")
        for i, img in enumerate(images):
            out = got[i]
            assert out.dtype == np.uint8 and out.shape == img.shape
            np.testing.assert_array_equal(out, want[i])
            if not lossy:
                np.testing.assert_array_equal(out, img)
            else:
                assert np.mean(np.abs(out.astype(int) - img.astype(int))) < 3
        raw = [np.asarray(f["images"][i]) for i in range(3)]
    # the other package's writer makes the same bytes
    with h5py.File(tmp_path / "again.h5", "w") as f:
        ds = other.ImageVariableLengthBufferDs.create(f, "images", 3, lossy=lossy)
        for i, img in enumerate(images):
            ds[i] = img
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(f["images"][i]), raw[i])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_image_buffer_format_mismatch_raises(tmp_path, package):
    H = PACKAGES[package][0]
    rng = np.random.RandomState(2)
    png = TPre.imencode((rng.rand(8, 8) * 255).astype(np.uint8), format=TPre.ImageFormat.PNG)
    jpg = TPre.imencode((rng.rand(8, 8) * 255).astype(np.uint8))
    np.testing.assert_array_equal(png, JPre.imencode(np.frombuffer(TPre.imdecode(png), np.uint8).reshape(8, 8),
                                                     format=JPre.ImageFormat.PNG))
    with h5py.File(tmp_path / "m.h5", "w") as f:
        lossy = H.ImageVariableLengthBufferDs.create(f, "jpg", 1, lossy=True)
        lossless = H.ImageVariableLengthBufferDs.create(f, "png", 1, lossy=False)
        with pytest.raises(ValueError):
            lossy[0] = png
        with pytest.raises(ValueError):
            lossless[0] = jpg
        lossy[0] = jpg  # an encoded buffer of the right format is stored as it is
        np.testing.assert_array_equal(np.asarray(f["jpg"][0]), jpg)
    assert TPre.which_image_format(jpg) == TPre.ImageFormat.JPG == JPre.which_image_format(jpg)
    with pytest.raises(ValueError):
        TPre.which_image_format(np.zeros(16, np.uint8))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_quantized_varsize_arrays_cross_packages(tmp_path, writer, reader):
    rng = np.random.RandomState(3)
    values = [rng.rand(7, 3).astype(np.float32) * 10.0, rng.randn(2, 5).astype(np.float64)]
    with h5py.File(tmp_path / "q.h5", "w") as f:
        ds = PACKAGES[writer][0].QuantizedVarsizeArrayDs.create(f, "arr", 2, sample_dimensionality=2)
        for i, v in enumerate(values):
            ds[i] = v
    with h5py.File(tmp_path / "q.h5", "r") as f:
        got = PACKAGES[reader][0].open_dataset(f, "arr")
        want = PACKAGES[writer][0].open_dataset(f, "arr")
        assert isinstance(got, PACKAGES[reader][0].QuantizedVarsizeArrayDs)
        for i, v in enumerate(values):
            assert got[i].dtype == np.float32 and got[i].shape == v.shape
            np.testing.assert_array_equal(got[i], want[i])
            assert np.abs(got[i] - v).max() < (v.max() - v.min() + 1) / 256 + 1e-6


def test_open_dataset_dispatch(tmp_path):
    with h5py.File(tmp_path / "d.h5", "w") as f:
        JH.ImageVariableLengthBufferDs.create(f, "images", 1)
        JH.QuantizedVarsizeArrayDs.create(f, "quant", 1, 1)
        f.create_dataset("plain", data=np.arange(5))
        f.create_dataset("names", data=np.asarray([b"a", b"b"]))
        f["names"].attrs["storage"] = "no such storage"
        assert isinstance(TH.open_dataset(f, "images"), TH.ImageVariableLengthBufferDs)
        assert isinstance(TH.open_dataset(f, "quant"), TH.QuantizedVarsizeArrayDs)
        assert isinstance(TH.open_dataset(f, "plain"), h5py.Dataset)
        with pytest.raises(RuntimeError, match="storage"):
            TH.open_dataset(f, "names")
        assert [n for n, _ in TH.open_all_datasets(f, ["/images", "/plain"])] == ["images", "plain"]


def _write_pose_file(P, C, path, n=6, sequence_starts=None, seed=0, size=24):
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        ds = P.create_pose_dataset(f, C.image, count=n)
        for i in range(n):
            ds[i] = _smooth_image(rng, size, size + 4)
        P.create_pose_dataset(f, C.quat, count=n, dtype=np.float16,
                              data=np.tile([0.0, 0, 0, 1], (n, 1)).astype(np.float16))
        P.create_pose_dataset(f, C.xys, count=n, dtype=np.float32, data=rng.rand(n, 3).astype(np.float32))
        P.create_pose_dataset(f, C.roi, count=n, dtype=np.float32, data=rng.rand(n, 4).astype(np.float32))
        P.create_pose_dataset(f, C.points, name="pt3d_68", count=n, shape_wo_batch_dim=(68, 3), dtype=np.float32,
                              data=rng.rand(n, 68, 3).astype(np.float32))
        P.create_pose_dataset(f, C.general, name="hasface", count=n, dtype=np.bool_, data=rng.rand(n) > 0.5)
        if sequence_starts is not None:
            f.create_dataset("sequence_starts", data=np.asarray(sequence_starts, np.int32))


def _assert_same_sample(got, want):
    assert sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert str(got.get_category(k)) == str(want.get_category(k)), k
    assert got.meta.image_wh == want.meta.image_wh
    assert got.meta.batchsize == want.meta.batchsize and got.meta.seq == want.meta.seq


class _Spy:
    def __init__(self):
        self.calls = 0

    def __call__(self, sample):
        self.calls += 1
        sample["spied"] = np.asarray(self.calls, np.int32)
        return sample


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pose_dataset_cross_packages(tmp_path, writer):
    _, P, C = PACKAGES[writer]
    path = str(tmp_path / "pose.h5")
    _write_pose_file(P, C, path, n=6, sequence_starts=[0, 2, 6])
    spy_j, spy_t = _Spy(), _Spy()
    jds = JP.Hdf5PoseDataset(path, transform=spy_j, dataclass="T", coord_convention_id=2)
    tds = TP.Hdf5PoseDataset(path, transform=spy_t, dataclass="T", coord_convention_id=2)
    assert len(tds) == len(jds) == 6 and tds.max_image_hw is None
    np.testing.assert_array_equal(tds.sequences, jds.sequences)
    for i in range(6):
        _assert_same_sample(tds[i], jds[i])
    assert spy_t.calls == spy_j.calls == 6
    sample = tds[3]
    assert sample["pose"].dtype == np.float32 and sample["image"].shape == (24, 28, 1)
    assert sample["individual"] == 1 and sample["index"] == 3 and sample["coord_convention_id"] == 2
    assert sample.get_category("pt3d_68") == TC.points and sample.meta.tag == "T"
    with pytest.raises(IndexError):
        tds[6]
    # the raw-image path: undecoded JPEGs that decode to the decoded path's pixels
    jds.use_raw_images = tds.use_raw_images = True
    raw_t, raw_j = tds[4], jds[4]
    assert isinstance(raw_t["image"], TH.RawJpegBuffer) and raw_t["image"].shape == raw_j["image"].shape == (24, 28, 1)
    np.testing.assert_array_equal(raw_t["image"].buffer, raw_j["image"].buffer)
    np.testing.assert_array_equal(raw_t["image"].decode(), raw_j["image"].decode())
    assert raw_t.meta.image_wh == (28, 24)


def test_pose_dataset_reads_what_the_port_writer_wrote(tmp_path):
    """`write_pose_hdf5` of both packages on the same samples: equal files,
    and the JAX reader reads the port's as its own."""
    rng = np.random.RandomState(4)
    samples = [dict(image=_smooth_image(rng, 20 + i, 30), pose=np.float32([0, 0, 0.6, 0.8]),
                    coord=rng.rand(3).astype(np.float32), roi=rng.rand(4).astype(np.float32),
                    pt3d_68=rng.rand(68, 3).astype(np.float32), shapeparam=rng.randn(50).astype(np.float32),
                    hasface=np.bool_(i % 2)) for i in range(5)]
    for W, name in ((JW, "j.h5"), (TW, "t.h5")):
        with h5py.File(tmp_path / name, "w") as f:
            W.write_pose_hdf5(f, iter(samples), 5, sequence_starts=[0, 2, 5], progress=False)
    with h5py.File(tmp_path / "j.h5", "r") as fj, h5py.File(tmp_path / "t.h5", "r") as ft:
        assert sorted(fj) == sorted(ft) and dict(fj.attrs).keys() == dict(ft.attrs).keys()
        np.testing.assert_array_equal(ft.attrs["max_image_hw"], [24, 30])
        for k in fj:
            assert dict(fj[k].attrs) == dict(ft[k].attrs), k
            for i in range(len(fj[k])):
                np.testing.assert_array_equal(np.asarray(ft[k][i]), np.asarray(fj[k][i]), err_msg=k)
    jds = JP.Hdf5PoseDataset(str(tmp_path / "t.h5"))
    tds = TP.Hdf5PoseDataset(str(tmp_path / "t.h5"))
    for i in range(5):
        _assert_same_sample(tds[i], jds[i])
    assert tds[1]["hasface"] and not tds[0]["hasface"] and tds[3]["individual"] == 1


def test_boxes_of_the_writers(tmp_path, monkeypatch):
    rng = np.random.RandomState(5)
    pts = rng.rand(68, 3).astype(np.float32)
    np.testing.assert_array_equal(TW.landmark_bbox(pts), JW.landmark_bbox(pts))
    np.testing.assert_array_equal(TW.landmark_bbox(pts.T), JW.landmark_bbox(pts.T))
    monkeypatch.delenv("BFM_PATH", raising=False)
    assert TW.full_head_bbox(np.float32([1, 2, 3]), None, np.zeros(50)) is None
    assert JW.full_head_bbox(np.float32([1, 2, 3]), None, np.zeros(50)) is None
    from scipy.spatial.transform import Rotation

    from torch_port_helpers import write_synthetic_bfm_pickle

    monkeypatch.setenv("BFM_PATH", write_synthetic_bfm_pickle(tmp_path / "bfm.pkl"))
    rot = Rotation.random(random_state=rng)
    coord, shape = np.float32([40, 35, 20]), rng.randn(50).astype(np.float32)
    box = TW.full_head_bbox(coord, rot, shape)
    np.testing.assert_array_equal(box, JW.full_head_bbox(coord, rot, shape))
    assert box.dtype == np.float32 and box.shape == (4,) and np.all(box[2:] > box[:2])


def _video_file(P, C, path):
    _write_pose_file(P, C, path, n=10, sequence_starts=[0, 1, 5, 10], seed=6)


def test_video_pose_dataset_cross_packages(tmp_path):
    path = str(tmp_path / "video.h5")
    _video_file(TP, TC, path)
    tds = TP.Hdf5PoseVideoDataset(path, min_sequence_size=2, max_sequence_size=3, dataclass=Tag.ONLY_POSE)
    jds = JP.Hdf5PoseVideoDataset(path, min_sequence_size=2, max_sequence_size=3)
    fixed = _JaxVideoDataset(path, min_sequence_size=2, max_sequence_size=3)
    # [0,1) dropped (too short), [1,5) and [5,10) each split into two overlapping windows of 3
    assert len(tds) == len(jds) == 4
    assert [tuple(map(int, s)) for s in tds.sequences] == [tuple(map(int, s)) for s in jds.sequences]
    assert [tds.sequence_frame_count(i) for i in range(4)] == [jds.sequence_frame_count(i) for i in range(4)] == [3] * 4
    sample = tds[0]
    assert sample.meta.seq == [0, 3] and sample["image"].shape == (3, 24, 28, 1) and sample.meta.tag == Tag.ONLY_POSE
    np.testing.assert_array_equal(sample["individual"], [0, 0, 0])
    for i in range(4):
        want = fixed[i]
        got = tds[i]
        for k in want.keys():
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_same_sample(tds[0], jds[0])
    with pytest.raises(IndexError):  # the reference defect: frame 4 against 4 sequences
        jds[1]


@pytest.mark.parametrize("ab,limits", [((0, 1), (2, 4)), ((0, 3), (2, 4)), ((0, 10), (2, 4)), ((5, 18), (1, 5)),
                                       ((3, 7), (4, 4))])
def test_video_postprocess_sequence_is_the_jax_one(ab, limits):
    got = TP.Hdf5PoseVideoDataset._postprocess_sequence(*ab, *limits)
    want = JP.Hdf5PoseVideoDataset._postprocess_sequence(*ab, *limits)
    assert [tuple(map(int, s)) for s in got] == [tuple(map(int, s)) for s in want]


def _read_in_child(blob, index):
    ds = pickle.loads(blob)
    s = ds[index]
    return {k: np.asarray(v) for k, v in s.items()}, s.meta.image_wh


def test_pickled_dataset_reads_in_a_spawned_process(tmp_path):
    path = str(tmp_path / "pose.h5")
    _write_pose_file(TP, TC, path)
    ds = TP.Hdf5PoseDataset(path, dataclass=Tag.POSE_WITH_LANDMARKS)
    want = ds[2]  # opens the file in this process: the pickle carries no handle
    blob = pickle.dumps(ds)
    assert ds._h5file is not None and pickle.loads(blob)._h5file is None
    with mp.get_context("spawn").Pool(1) as pool:
        got, wh = pool.apply(_read_in_child, (blob, 2))
    assert wh == want.meta.image_wh
    for k in want.keys():
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ds.close()
    assert ds._h5file is None
    _assert_same_sample(ds[2], want)  # reopens lazily


def test_synthetic_writers_make_equal_files(tmp_path, monkeypatch):
    """The same labels and images through both writers: equal files. From
    the seed alone: labels within 1e-5, images decoding equal (this seed)."""
    n, size, seed = 12, 64, 5
    labels = [a.numpy() for a in TS.make_labels(n, size, seed, device="cpu")]
    images = TS.render_marker_images(*[__import__("torch").from_numpy(labels[i]) for i in (2, 1)], size).numpy()
    TS.write_synthetic_pose_dataset(str(tmp_path / "t.h5"), n, size, seed, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(JS, "make_labels", lambda n_, s_, seed_: tuple(labels))
        m.setattr(JS, "render_marker_images", lambda pt3d, coords, s_: images)
        JS.write_synthetic_pose_dataset(str(tmp_path / "j_injected.h5"), n, size, seed)
    JS.write_synthetic_pose_dataset(str(tmp_path / "j.h5"), n, size, seed)
    with h5py.File(tmp_path / "t.h5", "r") as ft, h5py.File(tmp_path / "j_injected.h5", "r") as fj:
        assert sorted(ft) == sorted(fj) and set(ft.attrs) == set(fj.attrs) == {"max_image_hw"}
        np.testing.assert_array_equal(ft.attrs["max_image_hw"], fj.attrs["max_image_hw"])
        for k in fj:
            assert dict(ft[k].attrs) == dict(fj[k].attrs), k
            for i in range(n):
                np.testing.assert_array_equal(np.asarray(ft[k][i]), np.asarray(fj[k][i]), err_msg=k)
    tds = TP.Hdf5PoseDataset(str(tmp_path / "t.h5"))
    jds = JP.Hdf5PoseDataset(str(tmp_path / "j.h5"))
    assert tds.max_image_hw == jds.max_image_hw == (size, size)
    for i in range(n):
        got, want = tds[i], jds[i]
        np.testing.assert_array_equal(got["image"], want["image"])
        for k in ("pose", "coord", "roi", "pt3d_68", "shapeparam"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)
    assert tds[0]["image"].max() > 100


def test_preprocessing_helpers_match_jax():
    rng = np.random.RandomState(7)
    img = _smooth_image(rng, 30, 40)
    np.testing.assert_array_equal(TPre.imrescale(img, 0.5), JPre.imrescale(img, 0.5))
    up = TPre.imrescale(img, 1.5)
    assert up.shape == (45, 60)
    with pytest.raises(AttributeError):  # the reference defect: cv2 has no INTER_BILINEAR
        JPre.imrescale(img, 1.5)
    from PIL import Image

    pil = Image.fromarray(img)
    assert TPre.imrescale(pil, 0.5).size == JPre.imrescale(pil, 0.5).size == (20, 15)
    assert TPre.imshape(img) == JPre.imshape(img) == (30, 40) and TPre.imshape(pil) == (30, 40)
    rgb = np.stack([img, img[::-1], img[:, ::-1]], -1)
    for q in (None, 90):
        np.testing.assert_array_equal(TPre.imencode(rgb, quality=q), JPre.imencode(rgb, quality=q))
    buf = TPre.imencode(rgb)
    np.testing.assert_array_equal(TPre.imdecode(buf, color="rgb"), JPre.imdecode(buf, color="rgb"))
    np.testing.assert_array_equal(TPre.imdecode(bytes(buf)), JPre.imdecode(bytes(buf)))
    for roi, square in (((5.2, 3.1, 25.7, 20.0), False), ((-4.0, -2.5, 30.0, 45.0), True)):
        a, oa = TPre.extract_image_roi(img, roi, 0.1, square=square, return_offset=True)
        b, ob = JPre.extract_image_roi(img, roi, 0.1, square=square, return_offset=True)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(oa, ob)
    b1, b2 = rng.rand(3, 2, 4) * 10, rng.rand(5, 4) * 10
    b1[..., 2:] += b1[..., :2]
    b2[..., 2:] += b2[..., :2]
    np.testing.assert_array_equal(TPre.box_iou(b1, b2), JPre.box_iou(b1, b2))
    assert TPre.box_iou(b1, b2).shape == (3, 2, 5)


def test_images_in_files_beside_the_hdf5_file(tmp_path):
    """`ImagePathDs`: names without extension, found in the directory named
    after the file, decoded as the JAX package decodes them."""
    import cv2

    rng = np.random.RandomState(8)
    (tmp_path / "paths").mkdir()
    for name in ("a", "b"):
        cv2.imwrite(str(tmp_path / "paths" / f"{name}.png"), _smooth_image(rng, 12, 16))
    with h5py.File(tmp_path / "paths.h5", "w") as f:
        JH.ImagePathDs.create(f, "images", np.asarray([b"a", b"b"]))
    with h5py.File(tmp_path / "paths.h5", "r") as f:
        got, want = TH.open_dataset(f, "images"), JH.open_dataset(f, "images")
        assert isinstance(got, TH.ImagePathDs) and len(got) == len(want) == 2
        for i in range(2):
            np.testing.assert_array_equal(got[i], want[i])
        got.monochrome = want.monochrome = False
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].shape == (12, 16, 3)
