"""Shared fixtures of the PyTorch-port parity tests (`tests/test_torch_*.py`).

Inputs are made from a seed with numpy and handed to both packages; random
augmentation draws are derived from a JAX key with the same splits the JAX
package uses and injected into the port, since `jax.random` and
`torch.Generator` streams differ.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnet_tracker_traincode_tpu.augmentation import geometric as JG
from neuralnet_tracker_traincode_tpu.data.fields import Tag as JTag
from neuralnet_tracker_traincode_tpu.losses import losses as JL, nll as JNLL
from neuralnet_tracker_traincode_tpu.losses import criterion as JC
from neuralnet_tracker_traincode_torch.augmentation import geometric as TG, intensity as TI
from neuralnet_tracker_traincode_torch.augmentation.pipeline import AugmentationParameters
from neuralnet_tracker_traincode_torch.data.fields import Tag as TTag
from neuralnet_tracker_traincode_torch.losses import losses as TL, nll as TNLL
from neuralnet_tracker_traincode_torch.losses import criterion as TC

OP_PROBS = (0.2, 0.01, 0.2, 0.2, 0.2, 0.1)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def jax_op_draws(key, op: int, B: int):
    """(mask, value) that the JAX package's `_stage1_op` draws for `op` from `key`."""
    k_mask, k_param = jax.random.split(key)
    mask = np.asarray(jax.random.bernoulli(k_mask, OP_PROBS[op], (B,)))
    value = np.zeros((B,), np.float32)
    if op == 1:
        value = np.floor(np.asarray(jax.random.uniform(k_param, (B,), minval=4.0, maxval=6.0)))
    elif op == 2:
        value = np.asarray(jax.random.uniform(k_param, (B,), minval=0.5, maxval=2.0))
    elif op in (3, 4):
        value = np.asarray(jax.random.uniform(k_param, (B,), minval=0.7, maxval=1.5))
    return mask, value.astype(np.float32)


def jax_stage1_draws(key, B: int) -> TI.Stage1Parameters:
    """Stage-1 draws with the splits of `intensity_augmentation_stage1`."""
    k_perm, k_ops = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, 6))
    masks, values = zip(*(jax_op_draws(jax.random.fold_in(k_ops, op), op, B) for op in range(6)))
    return TI.Stage1Parameters(t(perm).long(), t(np.stack(masks)), t(np.stack(values)))


def jax_noise_sigma(key, B: int) -> np.ndarray:
    """Combined sigma with the splits of `intensity_augmentation_noise`."""
    k_mask, _ = jax.random.split(key)
    probs = jnp.asarray([0.25, 0.25**2, 0.25**3, 0.25**4])
    applied = np.asarray(jax.random.bernoulli(k_mask, probs[None, :], (B, 4)))
    return TI.combine_noise_sigma(t(applied)).numpy()


def jax_augmentation_draws(key, B: int, cfg, seed_base: int = 12345) -> AugmentationParameters:
    """Every draw of the JAX `augment_batch_for_training(key, ...)`, as the
    port's parameters. Noise seeds are free (the JAX CPU path uses no seeds)."""
    k_roi, k_fliprot, k_intensity = jax.random.split(key, 3)
    p = JG.make_roi_randomization_parameters(k_roi, (B,), cfg.rotation_aug_angle, cfg.extension_factor)
    roi = TG.RoiFocusRandomizationParameters(t(p.scales), t(p.angles), t(p.translations))
    do_flip, rot_dir = JG.sample_flip_rot90(k_fliprot, (B,), cfg.p_flip_rot90)
    k1, k2 = jax.random.split(k_intensity)
    stage1 = jax_stage1_draws(k1, B)
    noise = TI.NoiseParameters(
        t(jax_noise_sigma(k2, B)), torch.arange(seed_base, seed_base + B, dtype=torch.int32)
    )
    return AugmentationParameters(roi, t(do_flip), t(rot_dir), stage1, noise)


def make_batch(rng, B=8, src=96):
    """Synthetic labelled batch in the JAX package's fused-batch layout."""
    lo = src * 0.2 + rng.rand(B, 2) * src * 0.1
    size = src * (0.35 + rng.rand(B, 1) * 0.2)
    roi = np.concatenate([lo, lo + size], axis=-1).astype(np.float32)
    q = rng.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "image": rng.randint(0, 256, size=(B, src, src, 1), dtype=np.uint8),
        "pose": q,
        "coord": np.concatenate([roi[:, :2] + size * 0.5, size * 0.5], -1).astype(np.float32),
        "roi": roi,
        "pt3d_68": np.concatenate(
            [roi[:, None, :2] + rng.rand(B, 68, 2) * size[:, None], rng.rand(B, 68, 1) * 20], -1
        ).astype(np.float32),
        "shapeparam": rng.randn(B, 50).astype(np.float32),
        "hasface": np.full((B,), 0.9, np.float32),
        "coord_convention_id": np.zeros((B,), np.int32),
        "tag_id": np.zeros((B,), np.int32),
        "dataset_weight": np.ones((B,), np.float32),
        "param_index": np.arange(B, dtype=np.int32),
    }


LABEL_KEYS = ("pose", "coord", "roi", "pt3d_68", "shapeparam", "hasface", "coord_convention_id")


def _terms(L, NLL):
    return [
        ("nllrot", NLL.QuatPoseNLLLoss(), 0.005),
        ("nllcoord", NLL.CorrelatedCoordPoseNLLLoss(), 0.005),
        ("rot", L.QuatPoseLoss("approx_distance"), 1.0),
        ("xy", L.PoseXYLoss("l2"), 0.25),
        ("sz", L.PoseSizeLoss("l2"), 0.25),
        ("points3d", L.Points3dLoss("l2", chin_weight=0.8), 0.5),
        ("box", L.BoxLoss("l2"), 0.01),
        ("quatreg", L.QuaternionNormalizationSoftConstraint(), 1e-6),
    ]


@functools.cache
def cli_setup_losses():
    """`setup_losses` of the JAX package's training CLI (`scripts/train_poseestimator.py`)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("train_poseestimator", os.path.join(root, "scripts", "train_poseestimator.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.setup_losses


def flagship_criteria():
    """The 8-term flagship criterion in both packages (JAX, port)."""
    jc = JC.MaskedMultiTaskCriterion(
        {JTag.POSE_WITH_LANDMARKS: JC.CriterionGroup([JC.Criterion(*a) for a in _terms(JL, JNLL)])},
        [JTag.POSE_WITH_LANDMARKS],
    )
    tc = TC.MaskedMultiTaskCriterion(
        {TTag.POSE_WITH_LANDMARKS: TC.CriterionGroup([TC.Criterion(*a) for a in _terms(TL, TNLL)])},
        [TTag.POSE_WITH_LANDMARKS],
    )
    return jc, tc


SMALL_NET = dict(
    enable_point_head=True, enable_uncertainty=True, config="mobilenetv1", backbone_args={"widen_factor": 0.25}
)


def jax_posenet_variables(seed: int, noise: float = 0.05, **net):
    """Variables of the JAX `NetworkWithPointHead(**net)` as numpy trees.

    Every parameter gets `noise` * N(0, 1) added and the BatchNorm statistics
    are randomised, so that zero biases, unit scales and identity statistics
    cannot hide a mapping fault."""
    from neuralnet_tracker_traincode_tpu.models.posenet import NetworkWithPointHead as JNet

    model = JNet(**net)
    x = jnp.zeros((2, 129, 129, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), x, coord_convention_id=jnp.zeros((2,), jnp.int32), train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + noise * rng.randn(*np.shape(a))).astype(np.float32), variables["params"]
    )

    def stat(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    return model, {"params": params, "batch_stats": stats}


def torch_posenet(variables, **net):
    """The port's network with the JAX variables moved across by the bridge."""
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead as TNet
    from neuralnet_tracker_traincode_torch.models.weights import posenet_state_dict_from_jax

    model = TNet(**net)
    model.load_state_dict(posenet_state_dict_from_jax(variables, net))
    return model


def leaf_rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b|| (absolute where b is all zero)."""
    nb = np.linalg.norm(b)
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d / nb) if nb > 0 else float(d)


def normalized_labels(rng, B: int):
    """Labels in the normalised crop frame that the losses see."""
    q = rng.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    lo = rng.uniform(-0.8, 0.0, (B, 2))
    roi = np.concatenate([lo, lo + rng.uniform(0.3, 0.8, (B, 2))], -1)
    return {
        "pose": q,
        "coord": np.concatenate([rng.uniform(-0.3, 0.3, (B, 2)), rng.uniform(0.2, 0.6, (B, 1))], -1).astype(np.float32),
        "roi": roi.astype(np.float32),
        "pt3d_68": (0.5 * rng.randn(B, 68, 3)).astype(np.float32),
        "shapeparam": rng.randn(B, 50).astype(np.float32),
        "hasface": np.full((B,), 0.9, np.float32),
    }


def _jax_video_dataset_class():
    from neuralnet_tracker_traincode_tpu.data import pose_dataset as JP

    class JaxVideoDataset(JP.Hdf5PoseVideoDataset):
        """The JAX package's video dataset reading a frame by its index, as
        the port does: the JAX one bounds a frame index by its count of
        sequences (a reference defect), so it fails past that count."""

        def _load_sample(self, sequence_index, index):
            self._ensure_h5opened()
            raw = [(name, self._get_field(ds, index)) for name, ds in self._names_datasets.items()]
            s = JP._transform_to_pose_sample(raw, self.dataclass, self._categories)
            s["individual"] = np.asarray(sequence_index, dtype=np.int32)
            return self.frame_transform(s)

    return JaxVideoDataset


JaxVideoDataset = _jax_video_dataset_class()


def write_random_pose_file(path, n, size=48, seed=0, sequence_starts=None, with_landmarks=True, big=()):
    """A pose file of `n` smooth random images (those in `big` at 2.2x
    `size`) with random labels, by the port's writer; no `max_image_hw`."""
    import cv2
    import h5py

    from neuralnet_tracker_traincode_torch.data import pose_dataset as TP
    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        ds = TP.create_pose_dataset(f, C.image, count=n)
        for i in range(n):
            s = int(size * 2.2) if i in big else size
            ds[i] = cv2.GaussianBlur((rng.rand(s, s + 2) * 255).astype(np.uint8), (5, 5), 2)
        q = rng.randn(n, 4).astype(np.float32)
        TP.create_pose_dataset(f, C.quat, count=n, dtype=np.float32, data=q / np.linalg.norm(q, axis=-1, keepdims=True))
        TP.create_pose_dataset(f, C.xys, count=n, dtype=np.float32, data=(rng.rand(n, 3) * size).astype(np.float32))
        TP.create_pose_dataset(f, C.roi, count=n, dtype=np.float32, data=(rng.rand(n, 4) * size).astype(np.float32))
        if with_landmarks:
            TP.create_pose_dataset(f, C.points, name="pt3d_68", count=n, shape_wo_batch_dim=(68, 3),
                                   dtype=np.float32, data=(rng.rand(n, 68, 3) * size).astype(np.float32))
            TP.create_pose_dataset(f, C.general, name="shapeparams", count=n, shape_wo_batch_dim=(50,),
                                   dtype=np.float16, data=rng.randn(n, 50).astype(np.float16))
        TP.create_pose_dataset(f, C.general, name="hasface", count=n, dtype=np.bool_, data=rng.rand(n) > 0.3)
        if sequence_starts is not None:
            f.create_dataset("sequence_starts", data=np.asarray(sequence_starts, np.int32))
    return str(path)


BFM_VERTICES = 15000  # more than the largest fixed-up eye row (14327)


def write_synthetic_bfm_pickle(path, seed: int = 20260817) -> str:
    """A pickle in the layout of the 3DDFA `bfm_noneck_v3.pkl` (which is not
    distributable), with random contents at head-radius scale: a flattened
    mean shape `u`, per-coordinate eigvector columns (more than the 40 and 10
    the model keeps), and the 68 keypoints as flattened coordinate indices."""
    import pickle

    rnd = np.random.RandomState(seed)
    vidx = np.sort(rnd.choice(BFM_VERTICES, size=68, replace=False)).astype(np.int64)
    blob = {
        "u": (rnd.uniform(-1.0, 1.0, size=(3 * BFM_VERTICES, 1)) * 1.0e5).astype(np.float32),
        "w_shp": rnd.normal(size=(3 * BFM_VERTICES, 45)).astype(np.float32) * 1e-3,
        "w_exp": rnd.normal(size=(3 * BFM_VERTICES, 12)).astype(np.float32) * 1e2,
        "keypoints": np.stack([3 * vidx, 3 * vidx + 1, 3 * vidx + 2], axis=1).ravel().astype(np.float64),
    }
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def two_intra_op_threads():
    """Two intra-op threads for a test module whose torch work is heavy on
    the CPU (full-width networks, rendering): with every core's worth of
    threads in each of several test processes sharing the host, their
    spinning threads slow one another down many times over. Imported into
    a module, it applies to that module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---- the dataset converters' synthetic sources --------------------------------------
# Built as the JAX package's converter tests build them inline (tests/test_converters.py,
# tests/test_bfm_gated.py); the functions those files define at module level are imported
# from there instead.


def _png(arr) -> bytes:
    import cv2

    return cv2.imencode(".PNG", arr)[1].tobytes()


def _jpg(arr) -> bytes:
    import cv2

    return cv2.imencode(".JPEG", arr)[1].tobytes()


def make_aflw2k_zip(tmp_path) -> str:
    """One AFLW2000-3D sample whose GT landmarks agree with its pose."""
    import zipfile

    from neuralnet_tracker_traincode_tpu.data.preprocessing import compute_keypoints
    from neuralnet_tracker_traincode_tpu.utils import aflw_rotation_conversion
    from tests.test_converters import _mat_bytes

    rng = np.random.RandomState(6)
    img = (rng.rand(450, 450) * 255).astype(np.uint8)
    rot = aflw_rotation_conversion(0.15, -0.3, 0.05)
    radius = 0.5 * 0.001 / 224.0 * 450 * 1e5
    raw_pt3d = np.array(compute_keypoints(np.zeros(40), np.zeros(10), radius, rot, 220.0, 450.0 - 200.0))
    raw_pt3d[2] *= -1  # converter flips z back
    blob = _mat_bytes({
        "Pose_Para": np.asarray([[0.15, -0.3, 0.05, 220.0, 200.0, 0.0, 0.001]], np.float64),
        "Shape_Para": np.zeros((199, 1)),
        "Exp_Para": np.zeros((29, 1)),
        "pt3d_68": raw_pt3d,
    })
    src = str(tmp_path / "aflw.zip")
    with zipfile.ZipFile(src, "w") as zf:
        zf.writestr("AFLW2000/image00002.mat", blob)
        zf.writestr("AFLW2000/image00002.jpg", _jpg(img))
    return src


def make_synface_zip(tmp_path, skin: int = 1) -> str:
    """Two FaceSynthetics samples, the second's face too small."""
    import zipfile

    rng = np.random.RandomState(8)
    img = (rng.rand(128, 128, 3) * 255).astype(np.uint8)
    seg = np.zeros((128, 128), np.uint8)
    seg[30:100, 25:95] = skin
    seg_small = np.zeros((128, 128), np.uint8)
    seg_small[60:80, 60:80] = skin
    lmk = "\n".join(f"{x:.2f} {y:.2f}" for x, y in rng.rand(70, 2) * 128)
    src = str(tmp_path / "synface.zip")
    with zipfile.ZipFile(src, "w") as zf:
        for i, s in enumerate((seg, seg_small)):
            zf.writestr(f"{i:06d}.png", _png(img))
            zf.writestr(f"{i:06d}_seg.png", _png(s))
            zf.writestr(f"{i:06d}_ldmks.txt", lmk)
    return src


def make_wflw_tree(tmp_path) -> str:
    """A WFLW tree of one image with the same line in both splits."""
    import cv2

    src = tmp_path / "wflw_src"
    (src / "WFLW_annotations" / "list_98pt_rect_attr_train_test").mkdir(parents=True)
    (src / "WFLW_images" / "0--sub").mkdir(parents=True)
    rng = np.random.RandomState(3)
    cv2.imwrite(str(src / "WFLW_images" / "0--sub" / "a.png"), (rng.rand(300, 300, 3) * 255).astype(np.uint8))
    pts = (rng.rand(98, 2) * 100 + 100).ravel()
    line = " ".join(f"{v:.3f}" for v in pts) + " 100 100 250 240 0 0 0 0 0 0 0--sub/a.png\n"
    for split in ("train", "test"):
        with open(src / "WFLW_annotations" / "list_98pt_rect_attr_train_test" / f"list_98pt_rect_attr_{split}.txt",
                  "w") as f:
            f.write(line)
    return str(src)


def make_lapa_tree(tmp_path, names=("12345", "notmegafacename")) -> str:
    """A LaPa tree of one image under each of `names` (only numeric names
    are Megaface's)."""
    import cv2

    rng = np.random.RandomState(12)
    src = tmp_path / "lapa_src"
    (src / "train" / "images").mkdir(parents=True)
    (src / "train" / "landmarks").mkdir(parents=True)
    img = (rng.rand(280, 280, 3) * 255).astype(np.uint8)
    lmk106 = rng.rand(106, 2) * 160 + 60
    for name in names:
        cv2.imwrite(str(src / "train" / "images" / f"{name}.jpg"), img)
        with open(src / "train" / "landmarks" / f"{name}.txt", "w") as f:
            f.write("106\n" + "\n".join(f"{x:.3f} {y:.3f}" for x, y in lmk106))
    return str(src)


def make_widerface_dir(tmp_path) -> str:
    """The three WIDER FACE zips: two single-face images, one with two faces."""
    import zipfile

    rng = np.random.RandomState(4)
    img = (rng.rand(360, 480, 3) * 255).astype(np.uint8)
    annot = {
        "train": (
            "0--a/one.jpg\n1\n100 80 120 140 0 0 0 0 0 0\n"
            "0--a/two.jpg\n2\n10 10 50 50 0 0 0 0 0 0\n200 40 60 70 0 0 0 0 0 0\n"
        ),
        "val": "1--b/v.jpg\n1\n150 60 100 120 0 0 0 0 0 0\n",
    }
    with zipfile.ZipFile(str(tmp_path / "wider_face_split.zip"), "w") as zf:
        zf.writestr("wider_face_split/wider_face_train_bbx_gt.txt", annot["train"])
        zf.writestr("wider_face_split/wider_face_val_bbx_gt.txt", annot["val"])
    with zipfile.ZipFile(str(tmp_path / "WIDER_train.zip"), "w") as zf:
        zf.writestr("WIDER_train/images/0--a/one.jpg", _jpg(img))
        zf.writestr("WIDER_train/images/0--a/two.jpg", _jpg(img))
    with zipfile.ZipFile(str(tmp_path / "WIDER_val.zip"), "w") as zf:
        zf.writestr("WIDER_val/images/1--b/v.jpg", _jpg(img))
    return str(tmp_path)


def make_biwi_zip(tmp_path):
    """(zip, opal23-style annotation file) of one Biwi video of two frames."""
    import zipfile

    rng = np.random.RandomState(13)
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    pose_txt = "1 0 0\n0 1 0\n0 0 1\n\n50 -20 1000 \n"
    cal_txt = "\n" * 6 + "1 0 0\n0 1 0\n0 0 1\n\n0 0 0 \n"
    src = str(tmp_path / "biwi.zip")
    with zipfile.ZipFile(src, "w") as zf:
        for frame in ("00003", "00004"):
            zf.writestr(f"faces_0/01/frame_{frame}_rgb.png", _png(img))
            zf.writestr(f"faces_0/01/frame_{frame}_pose.txt", pose_txt)
        zf.writestr("faces_0/01/rgb.cal", cal_txt)
    ann = str(tmp_path / "biwi_ann.txt")
    with open(ann, "w") as f:
        f.write("idx;image;tl_x;tl_y;br_x;br_y\n")
        for frame in ("00003", "00004"):
            f.write(f"kinect_head_pose_db/01/frame_{frame}_rgb.png;200;150;400;370;\n")
    return src, ann


def make_300vw_zip(tmp_path):
    """A 300-VW zip of one two-frame MJPG video, or None where cv2 cannot
    write MJPG."""
    import zipfile

    import cv2

    rng = np.random.RandomState(14)
    avi_path = str(tmp_path / "vid.avi")
    vw = cv2.VideoWriter(avi_path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (320, 240))
    if not vw.isOpened():
        return None
    for _ in range(2):
        vw.write((rng.rand(240, 320, 3) * 255).astype(np.uint8))
    vw.release()

    def pts(points):
        body = "\n".join(f"{x:.3f} {y:.3f}" for x, y in points)
        return f"version: 1\nn_points: 68\n{{\n{body}\n}}\n"

    lmks = rng.rand(2, 68, 2) * 100 + 80
    src = str(tmp_path / "300vw.zip")
    with zipfile.ZipFile(src, "w") as zf:
        zf.write(avi_path, "300VW_Dataset/007/vid.avi")
        for i in range(2):
            zf.writestr(f"300VW_Dataset/007/annot/{i + 1:06d}.pts", pts(lmks[i]))
    return src


def make_replicantface_tree(tmp_path, color_face=(204, 91, 118)) -> str:
    """Two renders of a 100-vertex head, the second too dark."""
    import cv2

    rng = np.random.RandomState(15)
    src = tmp_path / "repl_src"
    src.mkdir()
    np.savez(src / "head_indices.npz", indices=np.arange(100))
    np.savez(src / "landmark_indices.npz", indices=np.arange(68))
    np.savez(src / "face_indices.npz", indices=np.arange(68, 100))
    f = 2.0
    projection = np.array([[f, 0, 0, 0], [0, f, 0, 0], [0, 0, 1.0, 0], [0, 0, 1.0, 0]])
    modelview = np.eye(4)
    modelview[2, 3] = -2.0
    vertices = (rng.rand(100, 3) * 0.2 - 0.1).astype(np.float64)
    img = (rng.rand(256, 256, 3) * 200 + 40).astype(np.uint8)
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[60:200, 70:210] = color_face
    for i, name in enumerate(["face_0", "face_1"]):
        np.savez(src / f"{name}.npz", modelview=modelview, projection=projection, vertices=vertices,
                 resolution=np.asarray(256.0))
        cv2.imwrite(str(src / f"{name}_img.jpg"), img if i == 0 else np.zeros_like(img))
        cv2.imwrite(str(src / f"{name}_mask.png"), mask)
    return str(src)


def make_unlabeled_image_dir(tmp_path) -> str:
    """Two sequences of frames <prefix><number>.<ext> of smooth random
    images, one frame large enough for the converter's thumbnail, and a
    file without a number (skipped)."""
    import cv2

    rng = np.random.RandomState(16)
    src = tmp_path / "unlabeled"
    src.mkdir()
    for name, (h, w) in (("cam_a001.jpg", (120, 160)), ("cam_a002.jpg", (120, 160)), ("cam_a010.png", (130, 150)),
                         ("clip7.jpg", (800, 760)), ("clip8.jpg", (96, 128)), ("readme.png", (20, 20))):
        img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8), (7, 7), 3)
        cv2.imwrite(str(src / name), img)
    return str(src)


def write_fitted_pose_file(path):
    """The fitted file that `create_largepose_dataset` reads (the
    `fitted_pose_h5` fixture of tests/test_bfm_gated.py): images, ROIs, the
    MTCNN `has_one_face` field and a `2dfit_v3` group."""
    import h5py

    from neuralnet_tracker_traincode_tpu.data.fields import FieldCategory
    from neuralnet_tracker_traincode_tpu.data.pose_dataset import create_pose_dataset

    n = 5
    rnd = np.random.RandomState(7)
    quats = rnd.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    coords = (rnd.rand(n, 3).astype(np.float32) * 100) + 50
    with h5py.File(path, "w") as f:
        images = create_pose_dataset(f, FieldCategory.image, count=n)
        for i in range(n):
            images[i] = np.full((16, 16), i * 10, np.uint8)
        rois = np.asarray([[0, 0, 300, 10], [0, 0, 100, 10], [0, 0, 300, 10], [0, 0, 300, 10], [0, 0, 300, 10]],
                          np.float32)
        create_pose_dataset(f, FieldCategory.roi, count=n, dtype=np.float32, data=rois)
        f.create_dataset("has_one_face", data=np.asarray([1, 1, 1, 0, 1], "?"))
        g = f.create_group("2dfit_v3")
        create_pose_dataset(g, FieldCategory.quat, data=quats)
        create_pose_dataset(g, FieldCategory.xys, data=coords)
        create_pose_dataset(g, FieldCategory.points, name="pt3d_68", data=rnd.rand(n, 68, 3).astype(np.float32) * 200)
        create_pose_dataset(g, FieldCategory.general, name="shapeparams", dtype=np.float16,
                            data=rnd.randn(n, 50).astype(np.float16))
    return str(path)


def stub_closed_eyes_package(monkeypatch, written, passthrough_calls):
    """The external `face3drotationaugmentation` modules that
    `create_aflw2k3d_closed_eyes` imports, stubbed as
    tests/test_bfm_gated.py stubs them."""
    import contextlib
    import sys
    import types

    class FakeDataset:
        def __init__(self, fn):
            self.samples = [{"name": "a", "scale": 1.0}, {"name": "b", "scale": -1.0}, {"name": "c", "scale": 2.0}]

        def __len__(self):
            return len(self.samples)

        def __iter__(self):
            return iter(self.samples)

        def close(self):
            pass

    class FakeWriter:
        def write(self, name, generated):
            written.append((name, generated))

    @contextlib.contextmanager
    def fake_dataset_writer(fn):
        yield FakeWriter()

    def fake_augment(prob, rng, sample):
        assert isinstance(rng, np.random.RandomState)
        return {"aug": sample["name"], "prob": prob, "draw": rng.rand()}

    def fake_passthrough(sample):
        passthrough_calls.append(sample["name"])
        return {"pass": sample["name"]}

    pkg = types.ModuleType("face3drotationaugmentation")
    ds_mod = types.ModuleType("face3drotationaugmentation.dataset300wlp")
    ds_mod.DatasetAFLW2k3D = FakeDataset
    wr_mod = types.ModuleType("face3drotationaugmentation.datasetwriter")
    wr_mod.dataset_writer = fake_dataset_writer
    gen_mod = types.ModuleType("face3drotationaugmentation.generate")
    gen_mod.augment_eyes_only = fake_augment
    gen_mod.make_sample_for_passthrough = fake_passthrough
    pkg.dataset300wlp, pkg.datasetwriter, pkg.generate = ds_mod, wr_mod, gen_mod
    for name, mod in [("face3drotationaugmentation", pkg), ("face3drotationaugmentation.dataset300wlp", ds_mod),
                      ("face3drotationaugmentation.datasetwriter", wr_mod),
                      ("face3drotationaugmentation.generate", gen_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)


def assert_h5_files_equal(path_a, path_b):
    """Two HDF5 files hold the same groups and datasets (names, dtypes,
    shapes), bit-equal values (variable-length buffers element by element)
    and equal attributes, the root's included."""
    import h5py

    def attrs(obj):
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in obj.attrs.items()}

    def walk(a, b, where):
        assert sorted(a.keys()) == sorted(b.keys()), where
        assert attrs(a) == attrs(b), where
        for name in a.keys():
            x, y = a[name], b[name]
            at = f"{where}/{name}"
            assert isinstance(x, h5py.Group) == isinstance(y, h5py.Group), at
            if isinstance(x, h5py.Group):
                walk(x, y, at)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (at, x.dtype, y.dtype, x.shape, y.shape)
            assert attrs(x) == attrs(y), at
            u, v = x[()], y[()]
            if x.dtype.kind == "O" or (x.dtype.fields and any(
                    h5py.check_vlen_dtype(x.dtype.fields[k][0]) for k in x.dtype.fields)):
                assert len(u) == len(v), at
                for i, (p, q) in enumerate(zip(u, v)):
                    assert np.array_equal(np.asarray(p), np.asarray(q)), f"{at}[{i}]"
            else:
                assert np.array_equal(u, v, equal_nan=u.dtype.kind == "f"), at

    with h5py.File(path_a, "r") as a, h5py.File(path_b, "r") as b:
        walk(a, b, "")
