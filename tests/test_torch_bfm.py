"""The port's full face model (`facemodel/bfm.py:FullBFMModel`) and the head
boxes that pose it, against the JAX package's, on a synthetic pickle in the
3DDFA layout (`torch_port_helpers.write_synthetic_bfm_pickle`; the real
`bfm_noneck_v3.pkl` is not distributable).

Tolerance: none. Every array equals the JAX one bit for bit (the same numpy
f32 arithmetic); `PutRoiFromLandmarks(extend_to_forehead=True)` and
`full_head_bbox` under `$BFM_PATH` give the JAX package's boxes exactly.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_tpu.data.batch import Batch as JBatch, Metadata as JMetadata
from neuralnet_tracker_traincode_tpu.data.host_transforms import PutRoiFromLandmarks as JPut
from neuralnet_tracker_traincode_tpu.facemodel import bfm as JB
from neuralnet_tracker_traincode_torch.data.batch import frame
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.data.host_transforms import PutRoiFromLandmarks
from neuralnet_tracker_traincode_torch.facemodel import bfm as TB
from torch_port_helpers import BFM_VERTICES, write_synthetic_bfm_pickle


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    return write_synthetic_bfm_pickle(tmp_path_factory.mktemp("bfm") / "bfm_noneck_v3.pkl")


@pytest.fixture(scope="module")
def models(pkl):
    return TB.FullBFMModel(pkl), JB.FullBFMModel(pkl)


ARRAYS = ["u", "w_shp", "w_exp", "keypoints", "scaled_shp_base", "scaled_exp_base", "scaled_bases",
          "scaled_vertices"]


@pytest.mark.parametrize("name", ARRAYS)
def test_full_model_array_is_the_jax_one(models, name):
    ours, ref = models
    a, b = getattr(ours, name), getattr(ref, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_full_model_layout(models):
    ours, ref = models
    assert ours.vertexcount == ref.vertexcount == BFM_VERTICES
    assert ours.scaled_bases.shape == (50, BFM_VERTICES, 3)
    assert list(ours.keypoints[[36, 37, 38, 39, 41, 40]]) == TB.LEFT_EYE_NEW == JB.LEFT_EYE_NEW
    assert list(ours.keypoints[[42, 43, 44, 45, 47, 46]]) == TB.RIGHT_EYE_NEW == JB.RIGHT_EYE_NEW
    np.testing.assert_array_equal(TB.ACTUAL_CENTER, JB.ACTUAL_CENTER)
    assert ours.tri is None and ref.tri is None  # no tri.pkl ships with either package
    with pytest.raises(AssertionError):
        ours.scaled_tri


@pytest.mark.parametrize("dims", [(40, 10), (12, 3)])
def test_truncated_bases(pkl, dims):
    ours, ref = TB.FullBFMModel(pkl, *dims), JB.FullBFMModel(pkl, *dims)
    np.testing.assert_array_equal(ours.scaled_bases, ref.scaled_bases)
    assert ours.scaled_bases.shape[0] == sum(dims)


def test_keypoint_subset_export(models, tmp_path):
    ours, ref = models
    a, b = ours.export_keypoint_subset(str(tmp_path / "t.npz")), ref.export_keypoint_subset(str(tmp_path / "j.npz"))
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_full_model_from_env(pkl, tmp_path, monkeypatch):
    monkeypatch.delenv("BFM_PATH", raising=False)
    assert TB.full_model_from_env() is None
    monkeypatch.setenv("BFM_PATH", str(tmp_path / "missing.pkl"))
    assert TB.full_model_from_env() is None
    monkeypatch.setenv("BFM_PATH", pkl)
    np.testing.assert_array_equal(TB.full_model_from_env().scaled_vertices, JB.FullBFMModel(pkl).scaled_vertices)


def _samples(n, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        lm = np.concatenate([40 + 30 * rng.rand(68, 2), rng.rand(68, 1)], -1).astype(np.float32)
        fields = dict(image=np.zeros((100, 100, 1), np.uint8), pt3d_68=lm,
                      coord=np.float32([50 + 5 * rng.randn(), 50 + 5 * rng.randn(), 20 + 10 * rng.rand()]),
                      pose=Rotation.random(random_state=rng).as_quat().astype(np.float32))
        if i % 2 == 0:
            fields["shapeparam"] = rng.randn(50).astype(np.float32)
        yield fields


def test_head_box_from_the_posed_mesh(pkl, monkeypatch):
    monkeypatch.setenv("BFM_PATH", pkl)
    ours, ref = PutRoiFromLandmarks(extend_to_forehead=True), JPut(extend_to_forehead=True)
    for fields in _samples(6, 3):
        out = ours(frame(Tag.POSE_WITH_LANDMARKS, fields))
        want = ref(JBatch(JMetadata((100, 100), 0, categories={}), **{k: v.copy() for k, v in fields.items()}))
        np.testing.assert_array_equal(out["roi"], want["roi"])
        # the mesh reaches past the landmarks: the cranium widens the box
        lm = fields["pt3d_68"]
        assert np.all(out["roi"][:2] <= lm[:, :2].min(0)) or np.all(out["roi"][2:] >= lm[:, :2].max(0))


def test_posed_full_mesh_is_the_jax_transform(pkl, monkeypatch):
    monkeypatch.setenv("BFM_PATH", pkl)
    ref = JPut(extend_to_forehead=True)
    model = TB.FullBFMModel(pkl)
    for fields in _samples(2, 4):
        sample = JBatch(JMetadata((100, 100), 0, categories={}), **fields)
        rot = Rotation.from_quat(fields["pose"])
        shape = fields.get("shapeparam", np.zeros((50,), np.float32))
        np.testing.assert_array_equal(TB.posed_full_mesh(model, shape, rot, fields["coord"]),
                                      ref._posed_vertices(sample))
