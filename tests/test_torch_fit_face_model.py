"""The port's face-model fit (`scripts/fit_face_model.py`) and its posed
keypoint head against the JAX package's, on the CPU.

Both scripts run on two copies of one HDF5 file of synthetic faces, made as
tests/test_fit_face_model.py makes them. Tolerances, set from the f32
arithmetic of two libraries that sum in other orders (measured: at 20 steps
quats 1.2e-7, coords 7.6e-6 px, pt3d_68 1.9e-5 px, shapeparams 1 f16 ulp;
at 800 steps 6.9e-7, 3.4e-5 px, 1.7e-4 px, 5 ulps):
 - `PosedDeformableHead`: 1e-5 px at coordinates of ~200 px;
 - 20 steps: quats 1e-6, coords 1e-4 px, pt3d_68 2e-4 px, shapeparams
   (f16) within 1 ulp;
 - 800 steps at lr 0.08: both pass the JAX test's recovery limits, and
   agree to quats 1e-5, coords 1e-3 px, pt3d_68 2e-3 px, shapeparams 1e-3.
"""

import hashlib
import shutil
import sys
from os.path import dirname, join, realpath

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_tpu.models import components as JC
from neuralnet_tracker_traincode_tpu.ops.rotrepr import Mat33Repr as JMat33, QuatRepr as JQuat
from neuralnet_tracker_traincode_torch.models import components as TC
from neuralnet_tracker_traincode_torch.ops.rotrepr import Mat33Repr, QuatRepr
from neuralnet_tracker_traincode_torch.scripts import fit_face_model as T
from torch_port_helpers import two_intra_op_threads  # noqa: F401

sys.path.insert(0, join(dirname(realpath(__file__)), "..", "scripts"))
import fit_face_model as J  # noqa: E402

GROUP = "2dfit_v3"
FIELDS = ("quats", "coords", "pt3d_68", "shapeparams")


def synthetic_faces(N=12, seed=12345):
    """Ground truth and noisy 2D landmarks, as tests/test_fit_face_model.py makes them."""
    rng = np.random.RandomState(seed)
    rots = Rotation.from_euler("XYZ", rng.uniform(-35, 35, (N, 3)), degrees=True)
    quats = rots.as_quat().astype(np.float32)
    coord = np.concatenate([rng.uniform(100, 140, (N, 2)), rng.uniform(40, 60, (N, 1))], axis=-1).astype(np.float32)
    shape = (rng.randn(N, 50) * 0.3).astype(np.float32)
    head = JC.PosedDeformableHead(JC.DeformableHeadKeypoints())
    pts = np.asarray(head(jnp.asarray(coord), JQuat(jnp.asarray(quats)), jnp.asarray(shape)))
    pt2d = pts[..., :2] + rng.randn(N, 68, 2).astype(np.float32) * 0.2
    rois = np.concatenate([pt2d.min(axis=1), pt2d.max(axis=1)], axis=-1).astype(np.float32)
    return dict(quats=quats, coord=coord, pt2d=pt2d, rois=rois)


def write_pair(tmp_path, faces, init_quats=None):
    a, b = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    with h5py.File(a, "w") as f:
        f.create_dataset("pt2d_68", data=faces["pt2d"])
        f.create_dataset("rois", data=faces["rois"])
        if init_quats is not None:
            f.create_dataset("pseudolabels/quats", data=init_quats)
    shutil.copy(a, b)
    return a, b


def run_both(monkeypatch, a, b, *flags):
    monkeypatch.setattr(sys, "argv", ["fit_face_model.py", a, *flags])
    J.main()
    assert T.main([b, *flags, "--device", "cpu"]) == 0


def read_group(path):
    with h5py.File(path, "r") as f:
        return {k: f[f"{GROUP}/{k}"][...] for k in FIELDS} if GROUP in f else None


def recovery(fit, faces):
    rot = (Rotation.from_quat(fit["quats"]).inv() * Rotation.from_quat(faces["quats"])).magnitude()
    xy = np.linalg.norm(fit["coords"][:, :2] - faces["coord"][:, :2], axis=-1)
    size = np.abs(fit["coords"][:, 2] - faces["coord"][:, 2]) / faces["coord"][:, 2]
    return np.rad2deg(np.mean(rot)), np.mean(xy), np.mean(size)


def assert_groups_agree(ours, ref, quats, coords, pts, shape_ulps=None, shape_abs=None):
    for k in FIELDS:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
    assert ours["shapeparams"].dtype == np.float16
    np.testing.assert_allclose(ours["quats"], ref["quats"], rtol=0, atol=quats)
    np.testing.assert_allclose(ours["coords"], ref["coords"], rtol=0, atol=coords)
    np.testing.assert_allclose(ours["pt3d_68"], ref["pt3d_68"], rtol=0, atol=pts)
    if shape_ulps is not None:  # f16 bit patterns of one sign are ordered
        a, b = ours["shapeparams"], ref["shapeparams"]
        assert (np.sign(a) * np.sign(b) >= 0).all()
        assert np.abs(a.view(np.int16).astype(int) - b.view(np.int16).astype(int)).max() <= shape_ulps
    else:
        np.testing.assert_allclose(ours["shapeparams"].astype(np.float32), ref["shapeparams"].astype(np.float32),
                                   rtol=0, atol=shape_abs)


@pytest.mark.parametrize("rotation", ["quat", "mat33"])
def test_posed_deformable_head_is_the_jax_one(rotation):
    rng = np.random.RandomState(7)
    N = 16
    rots = Rotation.random(N, random_state=rng)
    coord = np.concatenate([rng.uniform(50, 200, (N, 2)), rng.uniform(20, 80, (N, 1))], -1).astype(np.float32)
    shape = rng.randn(N, 50).astype(np.float32)
    if rotation == "quat":
        r = rots.as_quat().astype(np.float32)
        ours_rot, ref_rot = QuatRepr(torch.from_numpy(r)), JQuat(jnp.asarray(r))
    else:
        r = rots.as_matrix().astype(np.float32)
        ours_rot, ref_rot = Mat33Repr(torch.from_numpy(r)), JMat33(jnp.asarray(r))
    head = TC.PosedDeformableHead(TC.DeformableHeadKeypoints())
    ref = np.asarray(JC.PosedDeformableHead(JC.DeformableHeadKeypoints())(jnp.asarray(coord), ref_rot,
                                                                          jnp.asarray(shape)))
    ours = head(torch.from_numpy(coord), ours_rot, torch.from_numpy(shape))
    assert ours.shape == (N, 68, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    with torch.autocast("cpu", dtype=torch.bfloat16):  # f32 whatever autocast is set to
        under = head(torch.from_numpy(coord), ours_rot, torch.from_numpy(shape))
    assert under.dtype == torch.float32
    np.testing.assert_allclose(under.numpy(), ref, rtol=0, atol=1e-5)


def test_twenty_steps_agree_with_the_jax_script(tmp_path, monkeypatch):
    a, b = write_pair(tmp_path, synthetic_faces())
    run_both(monkeypatch, a, b, "--steps", "20")
    assert_groups_agree(read_group(b), read_group(a), quats=1e-6, coords=1e-4, pts=2e-4, shape_ulps=1)


def test_the_fit_recovers_poses_as_the_jax_script_does(tmp_path, monkeypatch):
    """tests/test_fit_face_model.py's run and limits, for both scripts."""
    faces = synthetic_faces()
    a, b = write_pair(tmp_path, faces)
    run_both(monkeypatch, a, b, "--steps", "800", "--lr", "0.08")
    ours, ref = read_group(b), read_group(a)
    for fit in (ours, ref):
        assert fit["pt3d_68"].shape == (12, 68, 3)
        rot, xy, size = recovery(fit, faces)
        assert rot < 6.0 and xy < 3.0 and size < 0.1, (rot, xy, size)
    assert_groups_agree(ours, ref, quats=1e-5, coords=1e-3, pts=2e-3, shape_abs=1e-3)


def test_pseudolabel_quats_start_the_fit(tmp_path, monkeypatch):
    faces = synthetic_faces()
    near = (Rotation.from_quat(faces["quats"]) * Rotation.from_euler("x", 3, degrees=True)).as_quat()
    a, b = write_pair(tmp_path, faces, init_quats=near.astype(np.float32))
    run_both(monkeypatch, a, b, "--steps", "20")
    ours = read_group(b)
    assert_groups_agree(ours, read_group(a), quats=1e-6, coords=1e-4, pts=2e-4, shape_ulps=1)
    quiet = dict(steps=20, device="cpu", log=lambda s: None)
    started = T.fit_face_model(faces["pt2d"], faces["rois"], near.astype(np.float32), **quiet)
    np.testing.assert_array_equal(ours["quats"], started["quats"])
    from_identity = T.fit_face_model(faces["pt2d"], faces["rois"], **quiet)
    assert np.abs(from_identity["quats"] - started["quats"]).max() > 0.01


def test_dry_run_writes_nothing(tmp_path, monkeypatch):
    _, b = write_pair(tmp_path, synthetic_faces(N=4))
    before = hashlib.sha256(open(b, "rb").read()).hexdigest()
    assert T.main([b, "--steps", "3", "--dry-run", "--device", "cpu"]) == 0
    assert hashlib.sha256(open(b, "rb").read()).hexdigest() == before
    assert read_group(b) is None


def test_each_sample_fits_alone_as_in_the_batch():
    """The loss is a sum of per-sample terms and Adam works element by element:
    the first rows of a batch fit follow the same trajectory fitted alone (to
    the rounding of the batch's other reduction sizes)."""
    faces = synthetic_faces(N=12, seed=5)
    quiet = dict(steps=60, device="cpu", log=lambda s: None)
    whole = T.fit_face_model(faces["pt2d"], faces["rois"], **quiet)
    part = T.fit_face_model(faces["pt2d"][:4], faces["rois"][:4], **quiet)
    for k in ("quats", "coords", "pt3d_68", "shapeparams", "residual"):
        np.testing.assert_allclose(part[k], whole[k][:4], rtol=0, atol=1e-4, err_msg=k)
    assert whole["losses"].shape == (11, 2) and np.isfinite(whole["losses"]).all()
    assert list(whole["losses"][:, 0]) == [0, 6, 12, 18, 24, 30, 36, 42, 48, 54, 59]


def test_the_step_tables_are_optax_adam_and_cosine_decay():
    import optax

    tables = T.step_tables(0.05, 3000)
    assert tables.shape == (3, 3000) and tables.dtype == np.float32
    sched = optax.cosine_decay_schedule(0.05, 3000)
    for t in (0, 1, 17, 1499, 2999):
        assert tables[0, t] == pytest.approx(float(sched(t)), rel=1e-6, abs=1e-12)
        for row, b in ((1, 0.9), (2, 0.999)):  # optax divides by 1 - b ** count, its pow within 2 ulps of 1.0
            ref = 1.0 / optax.tree_utils.tree_bias_correction(jnp.ones((), jnp.float32), b, jnp.int32(t + 1))
            assert abs(tables[row, t] - float(ref)) <= 2.5e-7, (row, t)
    assert tables[0, 0] == np.float32(0.05)
