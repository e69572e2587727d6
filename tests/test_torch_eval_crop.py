"""The eval path's crop and its host-side sample transforms against the JAX
package, on the CPU.

Tolerances:
 - `warp_affine`, `croprescale` and `crop_for_eval`'s crop: <= 1e-3 gray max
   (the same f32 arithmetic; the oversample mean may sum in another order).
   The two packages' inverse transforms differ by an ulp (XLA's dot and
   torch's matmul round the translation differently), which moves a sample
   point by ~1e-5 px: on white noise (255 gray/px) that alone is up to
   3e-3 gray. So the sources are smooth, as faces are (<= 26 gray/px).
 - `focus_roi_transform` and the backtransform: every entry of the (2, 3)
   matrices within 1e-6 absolute + 1e-6 relative (a few f32 ulp; entries
   up to ~130).
 - `PutRoiFromLandmarks`, the half-pixel offset, the extreme-pose filter,
   `Batch` collation and the cv2 crop: exact.
 - The batch normalization transforms: <= 1e-6 absolute.

The file takes about 25 s alone on one CPU process, most of it JAX's first
compiles.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import geometric as JG
from neuralnet_tracker_traincode_tpu.augmentation import normalization as JN
from neuralnet_tracker_traincode_tpu.augmentation import warp as JW
from neuralnet_tracker_traincode_tpu.augmentation.pipeline import crop_for_eval as jax_crop_for_eval
from neuralnet_tracker_traincode_tpu.data import host_transforms as JH
from neuralnet_tracker_traincode_tpu.data.batch import Batch as JBatch, Metadata as JMetadata
from neuralnet_tracker_traincode_tpu.data.fields import FieldCategory as JFC
from neuralnet_tracker_traincode_tpu.ops.affine2d import Affine2d as JAffine2d
from neuralnet_tracker_traincode_torch.augmentation import geometric as TG
from neuralnet_tracker_traincode_torch.augmentation import normalization as TN
from neuralnet_tracker_traincode_torch.augmentation import warp as TW
from neuralnet_tracker_traincode_torch.augmentation.pipeline import crop_for_eval
from neuralnet_tracker_traincode_torch.data import host_transforms as TH
from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata, frame
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d
from tests.torch_port_helpers import t

PAD = 128
SIZES = [(128, 100), (90, 128), (128, 128), (64, 77), (111, 50), (100, 128)]


def _ragged_padded(rng):
    """Ragged smooth uint8 sources (two plane waves of up to 0.1 rad/px)
    zero-padded into (B, 128, 128, 1)."""
    out = np.zeros((len(SIZES), PAD, PAD, 1), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        y, x = np.mgrid[:h, :w]
        k = rng.uniform(-0.1, 0.1, (2, 2))
        phase = rng.uniform(0, 2 * np.pi, 2)
        img = 127.5 + 63.5 * (np.sin(k[0, 0] * x + k[0, 1] * y + phase[0]) + np.sin(k[1, 0] * x + k[1, 1] * y + phase[1]))
        out[i, :h, :w, 0] = np.round(img)
    return out


def _transforms(rng, out_size):
    """Source->output transforms: scales 0.3-3, any rotation, centres that put
    part of the crop outside the image."""
    B = len(SIZES)
    scales = np.exp(rng.uniform(np.log(0.3), np.log(3.0), B)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    centres = rng.uniform(-10.0, 130.0, (B, 2)).astype(np.float32)
    to_origin = JAffine2d.trs(translations=jnp.asarray(-centres))
    rs = JAffine2d.trs(angles=jnp.asarray(angles), scales=jnp.asarray(scales))
    to_out = JAffine2d.trs(translations=jnp.full((B, 2), 0.5 * out_size, jnp.float32))
    return np.asarray((to_out @ rs @ to_origin).tensor())


def _rois_partly_outside(rng, B):
    lo = rng.uniform(-40.0, 100.0, (B, 2))
    return np.concatenate([lo, lo + rng.uniform(20.0, 90.0, (B, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("oversample", [1, 2])
def test_warp_affine_matches_jax(rng, oversample):
    images = _ragged_padded(rng)
    m = _transforms(rng, 40)
    ref = np.asarray(JW.warp_affine(jnp.asarray(images), JAffine2d(jnp.asarray(m)), 40, oversample))
    out = TW.warp_affine(t(images), Affine2d(t(m)), 40, oversample)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (len(SIZES), 40, 40, 1)
    assert np.abs(out.numpy() - ref).max() <= 1e-3
    assert ref.max() > 100  # the crops see the images


@pytest.mark.parametrize("oversample", [1, 2])
def test_croprescale_matches_jax(rng, oversample):
    images = _ragged_padded(rng)
    roi = _rois_partly_outside(rng, len(SIZES))
    ref = np.asarray(JW.croprescale(jnp.asarray(images), jnp.asarray(roi), 33, oversample))
    out = TW.croprescale(t(images), t(roi), 33, oversample)
    assert tuple(out.shape) == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-3


def test_focus_roi_transform_matches_jax(rng):
    B = 16
    roi = _rois_partly_outside(rng, B)
    scales = rng.uniform(0.6, 1.6, B).astype(np.float32)
    angles = rng.uniform(-0.6, 0.6, B).astype(np.float32)
    transl = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    jp = JG.RoiFocusRandomizationParameters(jnp.asarray(scales), jnp.asarray(angles), jnp.asarray(transl))
    tp = TG.RoiFocusRandomizationParameters(t(scales), t(angles), t(transl))
    for round_roi in (True, False):
        ref = np.asarray(JG.focus_roi_transform(jnp.asarray(roi), jp, 129, round_roi).tensor())
        out = TG.focus_roi_transform(t(roi), tp, 129, round_roi).tensor().numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_crop_for_eval_matches_jax(rng):
    images = _ragged_padded(rng)
    roi = _rois_partly_outside(rng, len(SIZES))
    x_ref, back_ref = jax_crop_for_eval(jnp.asarray(images), jnp.asarray(roi), 48, 1.2)
    x, back = crop_for_eval(t(images), t(roi), 48, 1.2)
    assert tuple(x.shape) == (len(SIZES), 48, 48, 1)
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() * 256 <= 1e-3
    np.testing.assert_allclose(back.numpy(), np.asarray(back_ref), rtol=1e-6, atol=1e-6)


def _jax_sample(rng, with_landmarks=True):
    fields = {
        "image": rng.randint(0, 256, (70, 60, 1)).astype(np.uint8),
        "pose": rng.randn(4).astype(np.float32),
        "coord": np.asarray([30.0, 35.0, 12.0], np.float32) + rng.randn(3).astype(np.float32),
        "roi": np.asarray([5.0, 6.0, 50.0, 60.0], np.float32),
    }
    if with_landmarks:
        fields["pt3d_68"] = (rng.rand(68, 3) * [40, 50, 10] + [10, 10, -5]).astype(np.float32)
    cats = {"image": JFC.image, "pose": JFC.quat, "coord": JFC.xys, "roi": JFC.roi, "pt3d_68": JFC.points}
    return JBatch(JMetadata((60, 70), 0, categories={k: cats[k] for k in fields}), fields)


def _port_sample(js):
    return frame(Tag.POSE_WITH_LANDMARKS, {k: np.array(v, copy=True) for k, v in js.items()})


@pytest.mark.parametrize("extend_to_forehead", [False, True])
def test_put_roi_from_landmarks_matches_jax(rng, monkeypatch, extend_to_forehead):
    monkeypatch.delenv("BFM_PATH", raising=False)  # the JAX package's head-sphere branch
    js = _jax_sample(rng)
    ref = JH.PutRoiFromLandmarks(extend_to_forehead)(JH.offset_points_by_half_pixel_np(js))
    out = TH.PutRoiFromLandmarks(extend_to_forehead)(TH.offset_points_by_half_pixel_np(_port_sample(js)))
    assert set(out.keys()) == set(ref.keys())
    for k in ref.keys():
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert out.get_category("roi") == "roi" and out["roi"].dtype == np.float32
    without = _jax_sample(rng, with_landmarks=False)
    assert TH.PutRoiFromLandmarks(extend_to_forehead)(_port_sample(without))["roi"] is not None


def test_extreme_pose_filter_matches_jax(rng, tmp_path):
    """The JAX package's filter reads the HDF5 file; the port's takes the arrays."""
    import h5py
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_tpu.pipelines import indices_without_extreme_poses as jax_filter

    n = 64
    quats = Rotation.random(n, random_state=rng).as_quat().astype(np.float32)
    quats[:8] = Rotation.from_rotvec(rng.randn(8, 3) * 0.1).as_quat()  # some easy poses
    coords = rng.rand(n, 3).astype(np.float32) * 100
    coords[::7, 2] *= -1  # some negative sizes
    with h5py.File(tmp_path / "poses.h5", "w") as f:
        f["quats"] = quats
        f["coords"] = coords
    ref = jax_filter(str(tmp_path / "poses.h5"))
    out = TH.indices_without_extreme_poses(quats, coords)
    np.testing.assert_array_equal(out, ref)
    assert 8 <= len(out) < n


def test_batch_collate_matches_jax(rng):
    """Stills and sequences, collated and split again, as in the JAX package."""
    stills = [_jax_sample(rng) for _ in range(3)]
    ref = JBatch.collate(stills)
    out = Batch.collate([_port_sample(s) for s in stills])
    assert out.meta.batchsize == ref.meta.batchsize == 3 and out.meta.tag == Tag.POSE_WITH_LANDMARKS
    for k in ref.keys():
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    frames = list(out.undo_collate())
    assert len(frames) == 3 and frames[1].meta.is_single_frame
    np.testing.assert_array_equal(frames[1]["pt3d_68"], stills[1]["pt3d_68"])

    def seq(n, j):
        return {"x": np.arange(n * 2, dtype=np.float32).reshape(n, 2) + j}

    jseqs = [JBatch(JMetadata((4, 4), 0, seq=[0, n]), seq(n, j)) for j, n in enumerate((2, 3))]
    tseqs = [Batch(Metadata((4, 4), 0, seq=[0, n]), seq(n, j)) for j, n in enumerate((2, 3))]
    ref, out = JBatch.collate(jseqs), Batch.collate(tseqs)
    assert out.meta.seq == ref.meta.seq == [0, 2, 5] and out.meta.batchsize == ref.meta.batchsize
    np.testing.assert_array_equal(out["x"], ref["x"])
    assert [s["x"].shape[0] for s in out.undo_collate()] == [2, 3]
    as_tensors = Batch.collate([_port_sample(s).to("cpu") for s in stills])
    np.testing.assert_array_equal(as_tensors["roi"].numpy(), ref_roi := JBatch.collate(stills)["roi"])
    assert as_tensors.to_numpy()["roi"].dtype == ref_roi.dtype


def test_batch_normalization_matches_jax(rng):
    js = JBatch.collate([_jax_sample(rng) for _ in range(4)])
    js["flag"] = np.asarray([True, False, True, True])
    ts = Batch(Metadata((60, 70), 4, categories=dict(js.meta.categories)), {k: np.array(v) for k, v in js.items()})
    steps = [
        (JN.offset_points_by_half_pixel, TN.offset_points_by_half_pixel),
        (JN.normalize_batch, TN.normalize_batch),
        (JN.whiten_batch, TN.whiten_batch),
    ]
    for jfn, tfn in steps:
        js, ts = jfn(js), tfn(ts)
        for k in js.keys():
            np.testing.assert_allclose(np.asarray(ts[k], np.float64), np.asarray(js[k], np.float64), rtol=0, atol=1e-6,
                                       err_msg=f"{jfn.__name__}: {k}")
    js["image"], ts["image"] = JN.unwhiten_image(js["image"]), TN.unwhiten_image(ts["image"])
    jb, tb = JN.unnormalize_batch(js), TN.unnormalize_batch(ts)
    for k in ("image", "coord", "roi", "pt3d_68", "pose"):
        np.testing.assert_allclose(np.asarray(tb[k], np.float64), np.asarray(jb[k], np.float64), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_cv2_crop_matches_jax(rng):
    pytest.importorskip("cv2")
    from neuralnet_tracker_traincode_tpu.eval import cv2_crop as JC
    from neuralnet_tracker_traincode_torch.eval import cv2_crop as TC

    roi = _rois_partly_outside(rng, 6)
    for factor in (1.0, 1.1, 1.2):
        np.testing.assert_array_equal(TC.compute_view_roi_np(roi, factor), JC.compute_view_roi_np(roi, factor))
    images = _ragged_padded(rng)
    for i, vroi in enumerate(TC.compute_view_roi_np(roi, 1.1)):
        im = images[i, : SIZES[i][0], : SIZES[i][1]]
        for size in (33, 129):  # shrinking (area) and growing (bilinear)
            np.testing.assert_array_equal(TC.croprescale_cv2(im, vroi, size), JC.croprescale_cv2(im, vroi, size))


def test_cv2_backend_without_cv2_raises(monkeypatch):
    """Where cv2 is missing the cv2 backend says so; it never falls back to
    the device crop."""
    from neuralnet_tracker_traincode_torch.eval import cv2_crop as TC
    from neuralnet_tracker_traincode_torch.eval.predictor import InferenceNetwork, Predictor

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="crop_backend='cv2' needs OpenCV"):
        TC.resize_cv2(np.zeros((8, 8, 1), np.uint8), 4)

    class Dummy(InferenceNetwork):
        device = torch.device("cpu")
        input_resolution = 129

        def __call__(self, images):
            raise AssertionError("never reached")

    with pytest.raises(ImportError, match="OpenCV"):
        Predictor(Dummy(), device="cpu", crop_backend="cv2")
