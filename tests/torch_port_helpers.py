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
