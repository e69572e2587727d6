"""Evaluation metrics as accumulate-then-compute objects (counterpart of the
JAX package's `eval/metrics.py`). They accumulate numpy on the host (cat
semantics); predictions may come as tensors on any device and are copied to
the host where a metric reads them. Rotation distances are computed in f32,
as the JAX package computes them."""

from typing import Dict, List, Literal, NamedTuple, Optional

import numpy as np
import torch

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.eval.alignment import PerspectiveCorrector, compute_opal_paper_alignment
from neuralnet_tracker_traincode_torch.ops import quaternion as Q


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def geodesic_distance_np(a, b) -> np.ndarray:
    """Geodesic distance of two quaternion arrays, in f32 on the host."""
    f32 = lambda q: torch.as_tensor(as_numpy(q), dtype=torch.float32)  # noqa: E731
    return Q.geodesicdistance(f32(a), f32(b)).numpy()


class Metric:
    def update(self, preds, targets):
        raise NotImplementedError

    def compute(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class MetricCollection(Metric):
    def __init__(self, metrics: Dict[str, Metric]):
        self.metrics = metrics

    def update(self, preds, targets):
        for m in self.metrics.values():
            m.update(preds, targets)

    def compute(self):
        return {k: m.compute() for k, m in self.metrics.items()}

    def reset(self):
        for m in self.metrics.values():
            m.reset()


class _ConcatenatingMetric(Metric):
    def __init__(self):
        self._chunks: List[np.ndarray] = []

    def update(self, preds, targets):
        self._chunks.append(as_numpy(self.compute_on_batch(preds, targets)))

    def compute(self):
        return np.concatenate(self._chunks)

    def reset(self):
        self._chunks = []

    def compute_on_batch(self, preds, targets):
        raise NotImplementedError


class LabelExtractor(_ConcatenatingMetric):
    def __init__(self, key):
        super().__init__()
        self._key = key

    def compute_on_batch(self, preds, targets):
        return targets[self._key]


class PredExtractor(_ConcatenatingMetric):
    def __init__(self, key):
        super().__init__()
        self._key = key

    def compute_on_batch(self, preds, targets):
        return preds[self._key]


class GeodesicError(_ConcatenatingMetric):
    def compute_on_batch(self, preds, targets):
        return geodesic_distance_np(targets["pose"], preds["pose"])


def _quat_to_aflw3d_rotations(quats) -> np.ndarray:
    return utils.inv_aflw_rotation_conversion(utils.convert_to_rot(as_numpy(quats)))


def _angle_errors(euler1: np.ndarray, euler2: np.ndarray) -> np.ndarray:
    v1 = np.stack([np.cos(euler1), np.sin(euler1)], axis=-1)
    v2 = np.stack([np.cos(euler2), np.sin(euler2)], axis=-1)
    return np.arccos(np.clip(np.sum(v1 * v2, axis=-1), -1.0, 1.0))


def aflw3d_euler_errors(quats1, quats2) -> np.ndarray:
    return _angle_errors(_quat_to_aflw3d_rotations(quats1), _quat_to_aflw3d_rotations(quats2))


class EulerAngleErrors(_ConcatenatingMetric):
    """Pitch/yaw/roll errors in the AFLW convention; shape (N, 3)."""

    def compute_on_batch(self, preds, targets):
        return aflw3d_euler_errors(preds["pose"], targets["pose"])


class NormalizedXYSError(_ConcatenatingMetric):
    def compute_on_batch(self, preds, targets):
        coord_target = as_numpy(targets["coord"])
        coord = as_numpy(preds["coord"])
        roi = as_numpy(targets["roi"])
        width = (roi[:, 2] - roi[:, 0])[:, None]
        return np.abs(coord - coord_target) / width


def eval_keypoints(pred: np.ndarray, gt: np.ndarray, dims=3) -> np.ndarray:
    """SADRNet-style NME: z-mean-centred, normalized by sqrt(bbox area)."""
    pred = np.array(pred, copy=True)
    gt = np.array(gt, copy=True)
    B, N, D = pred.shape
    assert D == 3 and pred.shape == gt.shape
    pred[:, :, 2] -= np.mean(pred[:, :, 2], axis=-1, keepdims=True)
    gt[:, :, 2] -= np.mean(gt[:, :, 2], axis=-1, keepdims=True)
    dist = np.mean(np.linalg.norm(pred[:, :, :dims] - gt[:, :, :dims], axis=-1), axis=-1)
    left = np.amin(gt[:, :, 0], axis=1)
    right = np.amax(gt[:, :, 0], axis=1)
    top = np.amin(gt[:, :, 1], axis=1)
    bottom = np.amax(gt[:, :, 1], axis=1)
    bbox_size = np.sqrt((right - left) * (bottom - top))
    return dist / bbox_size


class UnweightedKptNME(_ConcatenatingMetric):
    def __init__(self, dimensions=3):
        super().__init__()
        self.dims = dimensions

    def compute_on_batch(self, preds, targets):
        return eval_keypoints(as_numpy(preds["pt3d_68"]), as_numpy(targets["pt3d_68"]), self.dims)


class KptNmeResults(NamedTuple):
    bin_30_nme: float
    bin_60_nme: float
    bin_90_nme: float
    avg_nme: float


class KptNME(Metric):
    """NME binned by |yaw|: 0-30, 30-60, 60-90 degrees (literature protocol)."""

    def __init__(self, dimensions=3):
        self.dims = dimensions
        self.reset()

    def reset(self):
        self._errors: List[np.ndarray] = []
        self._masks: List[np.ndarray] = []

    def update(self, preds, targets):
        self._masks.append(self._compute_bin_masks(as_numpy(targets["pose"])))
        self._errors.append(eval_keypoints(as_numpy(preds["pt3d_68"]), as_numpy(targets["pt3d_68"]), self.dims))

    def compute(self) -> KptNmeResults:
        errors = np.concatenate(self._errors)
        masks = np.concatenate(self._masks)
        nme_by_bins = [float(np.mean(errors[masks[:, i]])) for i in range(3)]
        return KptNmeResults(*nme_by_bins, float(np.average(nme_by_bins)))

    @staticmethod
    def _compute_bin_masks(pose_gt: np.ndarray) -> np.ndarray:
        pyr_gt = _quat_to_aflw3d_rotations(pose_gt)
        abs_yaw_deg = np.abs(pyr_gt[:, 1]) * 180.0 / np.pi
        bounds = [(0.0, 30.0), (30.0, 60.0), (60.0, 90.0)]
        return np.stack([(a <= abs_yaw_deg) & (abs_yaw_deg < b) for a, b in bounds], axis=-1)


class AlignedRotationErrorMetric(Metric):
    """Euler/geodesic error after perspective or opal23 alignment."""

    def __init__(
        self,
        error_mode: Literal["euler", "geo"],
        correction_mode: Literal["perspective", "opal23"],
        fov: Optional[float] = None,
    ):
        self._error_mode = error_mode
        self._correction_mode = correction_mode
        self._fov = fov
        self.reset()

    def reset(self):
        self._image_sizes: List[np.ndarray] = []
        self._target_quats: List[np.ndarray] = []
        self._pred_quats: List[np.ndarray] = []
        self._pred_coord: List[np.ndarray] = []
        self._individual: List[np.ndarray] = []

    def update(self, preds, targets):
        self._target_quats.append(as_numpy(targets["pose"]))
        self._pred_quats.append(as_numpy(preds["pose"]))
        self._pred_coord.append(as_numpy(preds["coord"]))
        if self._correction_mode == "perspective":
            # targets['image'] is a ragged list of HWC images
            self._image_sizes.append(np.asarray([np.shape(t)[:2] for t in targets["image"]]))  # (N, [H, W])
        else:
            self._individual.append(as_numpy(targets["individual"]))

    def compute(self):
        target_quats = np.concatenate(self._target_quats)
        pred_quats = np.concatenate(self._pred_quats)
        pred_coord = np.concatenate(self._pred_coord)
        if self._correction_mode == "perspective":
            image_sizes = np.flip(np.concatenate(self._image_sizes), axis=-1)  # -> [W, H]
            corrector = PerspectiveCorrector(self._fov)
            pred_quats = corrector.corrected_rotation(image_sizes, pred_coord, pred_quats).numpy()
        else:
            individual = np.concatenate(self._individual)
            pred_quats = compute_opal_paper_alignment(pred_quats, target_quats, individual)
        if self._error_mode == "euler":
            return aflw3d_euler_errors(pred_quats, target_quats)
        return geodesic_distance_np(pred_quats, target_quats)


class LocalizerIsFaceMatches(_ConcatenatingMetric):
    def __init__(self, threshold):
        super().__init__()
        self.threshold = threshold

    def compute_on_batch(self, preds, targets):
        target = as_numpy(targets["hasface"])
        score = as_numpy(preds["hasface"])
        return (target > self.threshold) == (score > self.threshold)


class LocalizerBoxMeanSquareErrors(_ConcatenatingMetric):
    def __init__(self, threshold):
        super().__init__()
        self.threshold = threshold

    def compute_on_batch(self, preds, targets):
        target = as_numpy(targets["roi"])
        mask = (as_numpy(targets["hasface"]) > self.threshold) & (as_numpy(preds["hasface"]) > self.threshold)
        err = (as_numpy(preds["roi"]) - target) ** 2
        err[~mask, :] = np.nan
        err0 = np.sum(err[:, :2], axis=1)
        err1 = np.sum(err[:, 2:], axis=1)
        return np.stack([err0, err1], axis=1)
