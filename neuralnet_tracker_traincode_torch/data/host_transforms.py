"""Host-side (numpy) per-sample transforms of the eval loaders (counterpart
of the JAX package's `data/host_transforms.py`), and the extreme-pose filter
of its aflw2k3d validation set as arithmetic on label arrays (the port's
`pipelines.py:indices_without_extreme_poses` reads them from the file).

`PutRoiFromLandmarks(extend_to_forehead=True)` takes the box of the posed
full mesh (`facemodel/bfm.py:FullBFMModel`) when `$BFM_PATH` names the 3DDFA
pickle (the reference's `misc.py:9-31`); without it, the head-sphere extent
(centre coord[:2], radius coord[2]) merged with the landmarks' box, as the
JAX package does.
"""

import numpy as np
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.data.batch import Batch
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
from neuralnet_tracker_traincode_torch.facemodel.bfm import full_model_from_env, posed_full_mesh


def offset_points_by_half_pixel_np(sample: Batch) -> Batch:
    sample = sample.copy()
    for k, v in sample.items():
        if sample.get_category(k) in (FieldCategory.points, FieldCategory.xys):
            v = np.array(v, copy=True)
            v[..., :2] += 0.5
            sample[k] = v
    return sample


class PutRoiFromLandmarks:
    """Rebuild the face ROI from the 68 landmarks: their box, or with
    `extend_to_forehead` the posed full mesh's box (with `$BFM_PATH`) or
    the landmarks' box merged with the head sphere's."""

    def __init__(self, extend_to_forehead: bool = False):
        self.extend_to_forehead = extend_to_forehead
        self._full_model = full_model_from_env() if extend_to_forehead else None

    def __call__(self, sample: Batch) -> Batch:
        if "pt3d_68" not in sample:
            return sample
        sample = sample.copy()
        sample.meta.categories = dict(sample.meta.categories)
        lm = np.asarray(sample["pt3d_68"])
        min_ = np.amin(lm[..., :2], axis=-2)
        max_ = np.amax(lm[..., :2], axis=-2)
        if self._full_model is not None:
            shapeparam = np.asarray(sample.get("shapeparam", np.zeros((50,), np.float32)))
            verts = posed_full_mesh(self._full_model, shapeparam, Rotation.from_quat(np.asarray(sample["pose"])),
                                    np.asarray(sample["coord"]))
            min_ = np.amin(verts[..., :2], axis=-2)
            max_ = np.amax(verts[..., :2], axis=-2)
        elif self.extend_to_forehead:
            coord = np.asarray(sample["coord"])
            c, s = coord[..., :2], coord[..., 2:]
            min_ = np.minimum(min_, c - s)
            max_ = np.maximum(max_, c + s)
        sample["roi"] = np.concatenate([min_, max_], axis=-1).astype(np.float32)
        sample.meta.categories["roi"] = FieldCategory.roi
        return sample


def indices_without_extreme_poses(quats: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Indices of the samples whose AFLW pitch, yaw and roll are all below
    99 degrees in magnitude and whose head size is not negative."""
    p, y, r = utils.inv_aflw_rotation_conversion(Rotation.from_quat(quats)).T
    threshold = np.pi * 99.0 / 180.0
    mask = (np.abs(p) < threshold) & (np.abs(y) < threshold) & (np.abs(r) < threshold) & (coords[:, -1] >= 0.0)
    (indices,) = np.nonzero(mask)
    return indices
