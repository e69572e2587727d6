"""68-keypoint deformable head model (BFM / 3DDFA `bfm_noneck_v3` subset).

Counterpart of the JAX package's `facemodel/bfm.py`. The port ships its own
byte-identical copy of `assets/bfm_keypoints_subset.npz`:

    keypts      (68, 3)     head-radius-unit mean keypoint positions
    w_shp       (40, 68, 3) scaled shape eigvectors at the keypoints
    w_exp       (10, 68, 3) scaled expression eigvectors at the keypoints
    source      what it was made from: "bfm_noneck_v3.pkl"
                (`scripts/convert_bfm.py`) or "fitted_fallback"
                (`scripts/make_bfm_fallback.py`); `BFMModel.is_authentic`

`FullBFMModel` loads the full mesh from the 3DDFA pickle
(`bfm_noneck_v3.pkl`, which is not distributable: `$BFM_PATH` names it);
the head boxes of `data/host_transforms.py:PutRoiFromLandmarks` and
`data/dataset_writers.py:full_head_bbox` pose it.
"""

import functools
import os
import pickle
from os.path import dirname, isfile, join
from typing import Optional

import numpy as np

_ASSETS = join(dirname(__file__), "assets")
SUBSET_ARTIFACT = join(_ASSETS, "bfm_keypoints_subset.npz")

# the reference's keypoint fix-ups (`bfm.py:38-42`): the eye landmarks move to
# rows that stay consistent under closed-eye deformations
LEFT_EYE_NEW = [1959, 3887, 5048, 6216, 3513, 4674]
RIGHT_EYE_NEW = [9956, 11223, 12384, 14327, 11495, 12656]

# recentering of the raw 3DDFA mean shape (reference `bfm.py:69`)
ACTUAL_CENTER = np.array([0.0, -0.26, -0.9], dtype=np.float32)


class FullBFMModel:
    """The full mesh from the 3DDFA pickle: `u` (3V, 1), the first
    `shape_dim` and `exp_dim` eigvector columns, the 68 keypoint rows (the
    eye rows fixed up) and, where `assets/tri.pkl` is present, the
    triangles."""

    def __init__(self, pkl_path: str, shape_dim=40, exp_dim=10):
        with open(pkl_path, "rb") as f:
            bfm = pickle.load(f)
        self.u = bfm.get("u").astype(np.float32)
        self.w_shp = bfm.get("w_shp").astype(np.float32)[..., :shape_dim]
        self.w_exp = bfm.get("w_exp").astype(np.float32)[..., :exp_dim]
        self.vertexcount = self.u.shape[0] // 3
        self.keypoints = bfm.get("keypoints").astype(np.int64)[::3] // 3
        self.keypoints[[36, 37, 38, 39, 41, 40]] = LEFT_EYE_NEW
        self.keypoints[[42, 43, 44, 45, 47, 46]] = RIGHT_EYE_NEW
        tri_path = join(_ASSETS, "tri.pkl")
        self.tri = None
        if isfile(tri_path):
            with open(tri_path, "rb") as f:
                tri = pickle.load(f)
            self.tri = np.ascontiguousarray(tri.T).astype(np.int32)

    @property
    def scaled_shp_base(self) -> np.ndarray:
        w_shp = 20.0 * self.w_shp.reshape((self.vertexcount, 3, -1))
        w_shp = w_shp.transpose([2, 0, 1])
        return w_shp * np.array([[[1.0, -1.0, -1.0]]], dtype=np.float32)

    @property
    def scaled_exp_base(self) -> np.ndarray:
        w_exp = 5.0e-5 * self.w_exp.reshape((self.vertexcount, 3, -1))
        w_exp = w_exp.transpose([2, 0, 1])
        return w_exp * np.array([[[1.0, -1.0, -1.0]]], dtype=np.float32)

    @property
    def scaled_bases(self) -> np.ndarray:
        """(num eigvecs, num vertices, 3)"""
        return np.concatenate([self.scaled_shp_base, self.scaled_exp_base], axis=0)

    @property
    def scaled_vertices(self) -> np.ndarray:
        """(num vertices, 3), head-radius units, recentered."""
        vertices = self.u.reshape((-1, 3)) * 1.0e-5 * np.array([[1.0, -1.0, -1.0]], dtype=np.float32)
        vertices = vertices - ACTUAL_CENTER[None, :]
        return np.ascontiguousarray(vertices)

    @property
    def scaled_tri(self) -> np.ndarray:
        assert self.tri is not None, "tri.pkl not available"
        return np.ascontiguousarray(self.tri[..., [2, 1, 0]])

    def export_keypoint_subset(self, out_path: str = SUBSET_ARTIFACT) -> str:
        keypts = self.scaled_vertices[self.keypoints]
        bases = self.scaled_bases[:, self.keypoints, :]
        np.savez_compressed(
            out_path,
            keypts=keypts.astype(np.float32),
            w_shp=bases[:40].astype(np.float32),
            w_exp=bases[40:].astype(np.float32),
            source="bfm_noneck_v3.pkl",
        )
        return out_path


def full_model_from_env() -> Optional[FullBFMModel]:
    """The full model from the pickle `$BFM_PATH` names, or None."""
    path = os.environ.get("BFM_PATH")
    if path and isfile(path):
        return FullBFMModel(path)
    return None


def posed_full_mesh(model: FullBFMModel, shapeparam, rot, coord) -> np.ndarray:
    """The full mesh deformed by `shapeparam` (50,), rotated by the scipy
    `Rotation` `rot`, scaled by coord[2] and moved by coord[:2]: (V, 3)."""
    verts = model.scaled_vertices + np.einsum("k,kvd->vd", shapeparam, model.scaled_bases)
    out = rot.apply(verts) * coord[..., 2]
    out[..., :2] += coord[..., :2]
    return out


class BFMModel:
    """68-keypoint deformable model: keypts + 50 eigvectors at the keypoints."""

    def __init__(self, shape_dim=40, exp_dim=10):
        keypts, w_shp, w_exp, source = _load_subset_arrays()
        assert shape_dim <= w_shp.shape[0] and exp_dim <= w_exp.shape[0]
        self.keypts = keypts  # (68, 3)
        self.w_shp = w_shp[:shape_dim]
        self.w_exp = w_exp[:exp_dim]
        self.source = source  # what the artifact was made from (its `source` entry)

    @property
    def scaled_bases(self) -> np.ndarray:
        """(50, 68, 3): shape then expression eigvectors."""
        return np.concatenate([self.w_shp, self.w_exp], axis=0)

    @property
    def num_eigvecs(self) -> int:
        return self.w_shp.shape[0] + self.w_exp.shape[0]

    @property
    def is_authentic(self) -> bool:
        """True when the artifact was exported from the real `bfm_noneck_v3.pkl`
        (`scripts/convert_bfm.py`), false for the fitted fallback
        (`scripts/make_bfm_fallback.py`)."""
        return self.source == "bfm_noneck_v3.pkl"


@functools.lru_cache(1)
def _load_subset_arrays():
    with np.load(SUBSET_ARTIFACT) as f:
        return (
            f["keypts"].astype(np.float32),
            f["w_shp"].astype(np.float32),
            f["w_exp"].astype(np.float32),
            str(f["source"]),
        )
