"""68-keypoint deformable head model (BFM / 3DDFA `bfm_noneck_v3` subset).

Counterpart of the JAX package's `facemodel/bfm.py`. The port ships its own
byte-identical copy of `assets/bfm_keypoints_subset.npz`:

    keypts      (68, 3)     head-radius-unit mean keypoint positions
    w_shp       (40, 68, 3) scaled shape eigvectors at the keypoints
    w_exp       (10, 68, 3) scaled expression eigvectors at the keypoints

The full-mesh model (`FullBFMModel`, from the 3DDFA pickle) waits (ROADMAP.md).
"""

import functools
from os.path import dirname, join

import numpy as np

from neuralnet_tracker_traincode_torch.device import not_ported

SUBSET_ARTIFACT = join(dirname(__file__), "assets", "bfm_keypoints_subset.npz")


class FullBFMModel:
    def __init__(self, *args, **kwargs):
        raise not_ported("FullBFMModel")


class BFMModel:
    """68-keypoint deformable model: keypts + 50 eigvectors at the keypoints."""

    def __init__(self, shape_dim=40, exp_dim=10):
        keypts, w_shp, w_exp = _load_subset_arrays()
        assert shape_dim <= w_shp.shape[0] and exp_dim <= w_exp.shape[0]
        self.keypts = keypts  # (68, 3)
        self.w_shp = w_shp[:shape_dim]
        self.w_exp = w_exp[:exp_dim]

    @property
    def scaled_bases(self) -> np.ndarray:
        """(50, 68, 3): shape then expression eigvectors."""
        return np.concatenate([self.w_shp, self.w_exp], axis=0)

    @property
    def num_eigvecs(self) -> int:
        return self.w_shp.shape[0] + self.w_exp.shape[0]


@functools.lru_cache(1)
def _load_subset_arrays():
    with np.load(SUBSET_ARTIFACT) as f:
        return (
            f["keypts"].astype(np.float32),
            f["w_shp"].astype(np.float32),
            f["w_exp"].astype(np.float32),
        )
