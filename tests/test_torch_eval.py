"""The eval path against the JAX package, on the CPU: the rotation
alignments, every metric, the Predictor with weights carried over by
`models/weights.py:posenet_state_dict_from_jax`, the evaluation table
against the JAX script's `report()`, and the f32 eval forward.

Tolerances:
 - `PerspectiveCorrector`, `make_look_at_matrix`, the opal23 alignment and
   every metric class: <= 1e-6 absolute (the same f32 or f64 arithmetic).
 - `Predictor.predict_batch` (quaternion and 6D network, widen 0.25, random
   weights): `pose` <= 1e-4 after sign alignment, `coord`, `roi` and
   `pt3d_68` <= 1e-3 px (the crops differ by an ulp of the transform, the
   forwards by f32 rounding in another order).
 - The table row of `Predictor.evaluate` on 32 synthetic frames: <= 1e-3 in
   every printed column of the JAX script's row; `TableBuilder`'s markdown
   and JSON strings equal to the JAX script's for the same rows.
 - The eval forward and `Predictor.predict_batch` under an outer bf16
   autocast with the TF32 flags on: bit-equal.
 - `load_pose_network` on an exported `.onnx` file: the Predictor's
   predictions within 1e-4 of the checkpoint network's.

The file takes about 65 s alone on one CPU process: the first network's
flax init and the JAX Predictor's first jit take about 30 s of it, the JAX
script's `report()` about 10 s. The tests share the networks of each kind
(`_jax_and_port_nets`) to compile no more than that.
"""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_tpu.data import synthetic as JS
from neuralnet_tracker_traincode_tpu.eval import alignment as JA
from neuralnet_tracker_traincode_tpu.eval import metrics as JM
from neuralnet_tracker_traincode_tpu.eval.predictor import CheckpointPoseNetwork as JNet, Predictor as JPredictor
from neuralnet_tracker_traincode_torch.data.batch import frame
from neuralnet_tracker_traincode_torch.data.fields import Tag
from neuralnet_tracker_traincode_torch.data.host_transforms import (
    PutRoiFromLandmarks,
    indices_without_extreme_poses,
    offset_points_by_half_pixel_np,
)
from neuralnet_tracker_traincode_torch.eval import alignment as TA
from neuralnet_tracker_traincode_torch.eval import metrics as TM
from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork, Predictor, load_pose_network
from neuralnet_tracker_traincode_torch.eval.report import RoiConfig, TableBuilder, add_report_row, comprehensive_roi_configs
from tests.torch_port_helpers import SMALL_NET, jax_posenet_variables, torch_posenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = {"quat": SMALL_NET, "6d": dict(SMALL_NET, enable_6drot=True)}


def _quats(rng, n):
    return Rotation.random(n, random_state=rng).as_quat().astype(np.float32)


def test_perspective_corrector_matches_jax(rng):
    n = 32
    sizes = rng.randint(100, 800, (n, 2)).astype(np.float32)
    coord = np.concatenate([rng.rand(n, 2) * sizes, rng.rand(n, 1) * 50 + 5], -1).astype(np.float32)
    pose = _quats(rng, n)
    for fov in (57.0, 90.0):
        ref = np.asarray(JA.PerspectiveCorrector(fov).corrected_rotation(sizes, coord, pose))
        out = TA.PerspectiveCorrector(fov).corrected_rotation(sizes, coord, pose).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    pos = rng.randn(n, 3).astype(np.float32)
    np.testing.assert_allclose(TA.make_look_at_matrix(torch.from_numpy(pos)).numpy(),
                               np.asarray(JA.make_look_at_matrix(jnp.asarray(pos))), rtol=0, atol=1e-6)


def test_opal_alignment_matches_jax(rng):
    target = Rotation.random(60, random_state=rng)
    ids = np.repeat([0, 1, 2], 20)
    offsets = Rotation.from_rotvec(rng.randn(3, 3) * 0.2)
    pred = (target * offsets[ids] * Rotation.from_rotvec(rng.randn(60, 3) * 0.02)).as_quat().astype(np.float32)
    ref = JA.compute_opal_paper_alignment(pred, target.as_quat().astype(np.float32), ids)
    out = TA.compute_opal_paper_alignment(pred, target.as_quat().astype(np.float32), ids)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert np.mean((Rotation.from_quat(out).inv() * target).magnitude()) < 0.05


def _metric_inputs(rng, n):
    """Predictions and targets of `n` frames, with the fields every metric reads."""
    roi = np.concatenate([rng.rand(n, 2) * 50, rng.rand(n, 2) * 50 + 80], -1).astype(np.float32)
    target_pose = Rotation.from_euler("XYZ", rng.uniform(-1.4, 1.4, (n, 3))).as_quat().astype(np.float32)
    pred_pose = (Rotation.from_quat(target_pose) * Rotation.from_rotvec(rng.randn(n, 3) * 0.2)).as_quat()
    pts = (rng.rand(n, 68, 3) * [80, 90, 30] + [20, 20, -15]).astype(np.float32)
    targets = {
        "pose": target_pose, "roi": roi, "pt3d_68": pts, "individual": rng.randint(0, 3, n).astype(np.int32),
        "coord": np.concatenate([roi[:, :2] + 40, np.full((n, 1), 30.0)], -1).astype(np.float32),
        "hasface": rng.rand(n).astype(np.float32),
        "image": [np.zeros((rng.randint(150, 300), rng.randint(150, 300), 1), np.uint8) for _ in range(n)],
    }
    preds = {
        "pose": pred_pose.astype(np.float32),
        "coord": (targets["coord"] + rng.randn(n, 3) * 3).astype(np.float32),
        "roi": (roi + rng.randn(n, 4) * 4).astype(np.float32),
        "pt3d_68": (pts + rng.randn(n, 68, 3) * 2).astype(np.float32),
        "hasface": rng.rand(n).astype(np.float32),
    }
    return preds, targets


METRICS = {
    "LabelExtractor": lambda P: P.LabelExtractor("coord"),
    "PredExtractor": lambda P: P.PredExtractor("roi"),
    "GeodesicError": lambda P: P.GeodesicError(),
    "EulerAngleErrors": lambda P: P.EulerAngleErrors(),
    "NormalizedXYSError": lambda P: P.NormalizedXYSError(),
    "UnweightedKptNME": lambda P: P.UnweightedKptNME(),
    "UnweightedKptNME_2d": lambda P: P.UnweightedKptNME(dimensions=2),
    "KptNME": lambda P: P.KptNME(),
    "KptNME_2d": lambda P: P.KptNME(dimensions=2),
    "Aligned_geo_perspective": lambda P: P.AlignedRotationErrorMetric("geo", "perspective", 57.0),
    "Aligned_euler_perspective": lambda P: P.AlignedRotationErrorMetric("euler", "perspective", 57.0),
    "Aligned_geo_opal23": lambda P: P.AlignedRotationErrorMetric("geo", "opal23"),
    "Aligned_euler_opal23": lambda P: P.AlignedRotationErrorMetric("euler", "opal23"),
    "LocalizerIsFaceMatches": lambda P: P.LocalizerIsFaceMatches(0.5),
    "LocalizerBoxMeanSquareErrors": lambda P: P.LocalizerBoxMeanSquareErrors(0.5),
    "MetricCollection": lambda P: P.MetricCollection({"geo": P.GeodesicError(), "xys": P.NormalizedXYSError()}),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(rng, name):
    """Two updates (cat semantics), the port's predictions as tensors."""
    jm, tm = METRICS[name](JM), METRICS[name](TM)
    for n in (24, 17):
        preds, targets = _metric_inputs(rng, n)
        jm.update(preds, targets)
        tm.update({k: torch.from_numpy(v) for k, v in preds.items()}, targets)
    ref, out = jm.compute(), tm.compute()
    ref, out = (ref, out) if isinstance(ref, dict) else ({"": ref}, {"": out})
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k], np.float64), np.asarray(ref[k], np.float64), rtol=0, atol=1e-6)
    tm.reset()
    with pytest.raises(ValueError):  # nothing left to concatenate
        tm.compute()


def _synthetic_images(n, size, seed):
    """Marker frames of the JAX package's synthetic set: labels and images."""
    quats, coords, pt3d, shapeparams, rois = JS.make_labels(n, size, seed)
    return quats, coords, pt3d, shapeparams, rois, JS.render_marker_images(pt3d, coords, size, chunk=16)


@pytest.fixture(scope="module")
def ragged_frames():
    """Six marker frames cut to ragged sizes, with their face ROIs."""
    _, _, _, _, rois, images = _synthetic_images(6, 112, seed=6)
    cuts = [(112, 112), (100, 112), (112, 90), (96, 96), (112, 104), (80, 112)]
    return [images[i, :h, :w, None] for i, (h, w) in enumerate(cuts)], rois


@functools.cache
def _jax_and_port_nets(kind, seed=21):
    """The JAX package's eval network and the port's, with the same weights."""
    jmodel, variables = jax_posenet_variables(seed, **NETS[kind])
    return JNet(jmodel, variables), CheckpointPoseNetwork(torch_posenet(variables, **NETS[kind]), device="cpu")


def _sign_aligned(q, ref):
    return q * np.sign(np.sum(q * ref, axis=-1, keepdims=True))


@pytest.mark.parametrize("kind", sorted(NETS))
def test_predict_batch_matches_jax(ragged_frames, kind):
    images, rois = ragged_frames
    jnet, tnet = _jax_and_port_nets(kind)
    ref = JPredictor(jnet, 1.1).predict_batch(images, rois)
    out = Predictor(tnet, 1.1, device="cpu").predict_batch(images, rois)
    assert out.meta.image_wh == ref.meta.image_wh == (128, 128) and out.meta.batchsize == 6
    assert set(out.keys()) == set(ref.keys())
    pose = out["pose"].numpy()
    np.testing.assert_allclose(_sign_aligned(pose, np.asarray(ref["pose"])), np.asarray(ref["pose"]), rtol=0, atol=1e-4)
    for k in ("coord", "roi", "pt3d_68"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-3, err_msg=k)
    assert np.all(out["coord"].numpy()[:, 2] > 0)


def test_eval_forward_ignores_outer_autocast(ragged_frames):
    """An outer bf16 autocast and TF32 settings leave the eval forward and the
    caller's backend flags as they were."""
    _, tnet = _jax_and_port_nets("6d")
    x = torch.rand((4, 129, 129, 1), generator=torch.Generator().manual_seed(3)) - 0.5
    want = tnet(x)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tnet(x)
        assert torch.is_autocast_enabled("cpu")
    assert flags == (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.deterministic)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    model = tnet.model
    with torch.autocast("cpu", dtype=torch.bfloat16):
        drifted = model(x)["pose"]  # the same network, outside the eval wrapper
    assert not torch.equal(drifted, want["pose"])


def test_predict_batch_ignores_outer_autocast_and_tf32(ragged_frames, monkeypatch):
    """An outer bf16 autocast with the TF32 flags on: the Predictor's crop
    transform, crop and backtransform run with autocast and TF32 off (the
    flags have no effect on the CPU, so the test reads them where each stage
    is called), the chunk's output is bit-equal, and the caller's settings
    are back afterwards."""
    from neuralnet_tracker_traincode_torch.eval import predictor as P

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            seen.append((fn.__name__, cudnn.allow_tf32, matmul.allow_tf32, torch.is_autocast_enabled("cpu")))
            return fn(*args, **kwargs)
        return call

    for name in ("focus_roi_transform", "warp_affine", "apply_affine2d"):
        monkeypatch.setattr(P, name, spy(getattr(P, name)))
    images, rois = ragged_frames
    _, tnet = _jax_and_port_nets("6d")
    predictor = Predictor(tnet, 1.1, device="cpu")
    want = predictor.predict_batch(images, rois)
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = predictor.predict_batch(images, rois)
            assert torch.is_autocast_enabled("cpu")
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert {name for name, *_ in seen} == {"focus_roi_transform", "warp_affine", "apply_affine2d"}
    assert all(entry[1:] == (False, False, False) for entry in seen), seen
    assert set(got.keys()) == set(want.keys())
    for k in want.keys():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def synthetic_set(tmp_path_factory):
    """32 synthetic marker frames at 96^2 in the JAX package's HDF5 pose
    schema (its `write_synthetic_pose_dataset`, rendered in chunks of 16),
    and the port's samples of the same rows through its own host transforms."""
    import h5py

    from neuralnet_tracker_traincode_tpu.data.fields import FieldCategory as C
    from neuralnet_tracker_traincode_tpu.data.pose_dataset import Hdf5PoseDataset, create_pose_dataset
    from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag

    n, size = 32, 96
    quats, coords, pt3d, shapeparams, rois, images = _synthetic_images(n, size, seed=3)
    datadir = tmp_path_factory.mktemp("data")
    path = str(datadir / "aflw2k.h5")
    with h5py.File(path, "w") as f:
        ds = create_pose_dataset(f, C.image, count=n)
        for i in range(n):
            ds[i] = images[i]
        create_pose_dataset(f, C.quat, count=n, dtype=np.float32, data=quats)
        create_pose_dataset(f, C.xys, count=n, dtype=np.float32, data=coords)
        create_pose_dataset(f, C.roi, count=n, dtype=np.float32, data=rois)
        create_pose_dataset(f, C.points, name="pt3d_68", count=n, shape_wo_batch_dim=(68, 3), dtype=np.float32,
                            data=pt3d)
        create_pose_dataset(f, C.general, name="shapeparams", count=n, shape_wo_batch_dim=(50,), dtype=np.float16,
                            data=shapeparams.astype(np.float16))
    raw = Hdf5PoseDataset(path, dataclass=JTag.POSE_WITH_LANDMARKS)
    put = PutRoiFromLandmarks(extend_to_forehead=True)
    samples = []
    for i in indices_without_extreme_poses(quats, coords):
        s = raw[int(i)]
        samples.append(put(offset_points_by_half_pixel_np(
            frame(Tag.POSE_WITH_LANDMARKS, {k: np.array(v) for k, v in s.items()}))))
    return str(datadir), samples


def _eval_script():
    """The JAX package's `scripts/evaluate_pose_network.py` as a module."""
    spec = importlib.util.spec_from_file_location("evaluate_pose_network",
                                                  os.path.join(ROOT, "scripts", "evaluate_pose_network.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _jax_report_row(datadir, net_file, monkeypatch):
    """The JAX script's `report()` for one network on aflw2k3d, head ROI, 1.1."""
    script = _eval_script()
    monkeypatch.setenv("DATADIR", datadir)
    monkeypatch.delenv("BFM_PATH", raising=False)
    builder = script.TableBuilder()
    args = types.SimpleNamespace(device=None, alignment_scheme="none", vis="none")
    script.report(net_file, "aflw2k3d", script.RoiConfig(), args, builder)
    return builder


def test_evaluate_table_row_matches_jax_script(synthetic_set, tmp_path, monkeypatch):
    from neuralnet_tracker_traincode_tpu.models.io import save_model

    datadir, samples = synthetic_set
    jnet, _ = _jax_and_port_nets("quat")  # the weights of the predict test, without another init
    net_file = str(tmp_path / "net.ckpt")
    save_model(jnet.model, jnet.variables, net_file)
    jbuilder = _jax_report_row(datadir, net_file, monkeypatch)
    (ref,) = jbuilder._entries_by_model[net_file]

    builder = TableBuilder()
    predictor = Predictor(CheckpointPoseNetwork(net_file, device="cpu"), RoiConfig().expansion_factor, device="cpu")
    stage_ms = {}
    row = add_report_row(builder, predictor, samples, net_file, "aflw2k3d", RoiConfig(), chunksize=128,
                         stage_ms=stage_ms)
    assert builder._header == jbuilder._header and row[0] == ref[0] == "AFLW 2k 3d / (H_roi)ROI1.1"
    np.testing.assert_allclose(np.asarray(row[1:], np.float64), np.asarray(ref[1:], np.float64), rtol=0, atol=1e-3)
    assert np.isfinite(row[1:10]).all() and row[5] > 1.0  # an untrained network errs
    assert set(stage_ms) == {"pack_copy_ms", "crop_ms", "forward_backtransform_ms", "metrics_ms"}
    assert all(len(v) == 1 for v in stage_ms.values())
    with pytest.raises(ValueError, match="expansion"):
        add_report_row(TableBuilder(), predictor, samples, net_file, "aflw2k3d", RoiConfig(1.2))


def test_table_builder_strings_match_jax_script():
    script = _eval_script()
    rows = [
        ("runs/a/best.ckpt", "aflw2k3d", [3.25, 2.5, 2.125], 4.97, 2.1, 2.9, 0.0813, (0.07, 0.08, float("nan")),
         " / " + str(RoiConfig())),
        ("runs/a/swa.ckpt", "aflw2k3d_grimaces", [3.5, 2.75, 2.25], 5.26, 2.2, 3.1, None, None,
         " / " + str(RoiConfig(1.2, False, False))),
        ("runs/a/swa.ckpt", "biwi", [1.0, 2.0, 3.0], 4.0, 5.0, 6.0, 0.07, (0.1, 0.2, 0.3), None),
    ]
    jb, tb = script.TableBuilder(), TableBuilder()
    for r in rows:
        for b in (jb, tb):
            b.add_row(*r[:-1], data_aux_string=r[-1])
    assert tb.build() == jb.build()
    assert tb.build_json() == jb.build_json()
    assert [str(c) for c in comprehensive_roi_configs] == [str(c) for c in script.comprehensive_roi_configs]


def test_cv2_backend_matches_jax(ragged_frames):
    pytest.importorskip("cv2")
    images, rois = ragged_frames
    jnet, tnet = _jax_and_port_nets("quat")
    ref = JPredictor(jnet, 1.1, crop_backend="cv2").predict_batch(images, rois)
    out = Predictor(tnet, 1.1, device="cpu", crop_backend="cv2").predict_batch(images, rois)
    assert out.meta.image_wh == ref.meta.image_wh == (112, 112)
    np.testing.assert_allclose(_sign_aligned(out["pose"].numpy(), np.asarray(ref["pose"])), np.asarray(ref["pose"]),
                               rtol=0, atol=1e-4)
    for k in ("coord", "roi", "pt3d_68"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-3, err_msg=k)


def test_onnx_models_wait_for_the_export_slice(ragged_frames, tmp_path):
    """(The name is that of the refusal this test held before the export
    slice.) `load_pose_network` reads an exported `.onnx` file into an
    `OnnxPoseNetwork`; the Predictor over it gives the checkpoint network's
    predictions within 1e-4."""
    from neuralnet_tracker_traincode_torch.eval.predictor import OnnxPoseNetwork
    from neuralnet_tracker_traincode_torch.export.onnx_export import build_posenet_onnx

    images, rois = ragged_frames
    _, tnet = _jax_and_port_nets("quat")
    path = tmp_path / "net.onnx"
    path.write_bytes(build_posenet_onnx(tnet.model, outputs="full"))
    onnx_net = load_pose_network(str(path), device="cpu")
    assert isinstance(onnx_net, OnnxPoseNetwork) and onnx_net.input_resolution == 129
    out = Predictor(onnx_net, 1.1, device="cpu").predict_batch(images, rois)
    ref = Predictor(tnet, 1.1, device="cpu").predict_batch(images, rois)
    assert set(ref.keys()) <= set(out.keys())
    for k in ("pose", "coord", "roi", "pt3d_68", "shapeparam"):
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-4, err_msg=k)
