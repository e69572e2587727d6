"""Rotation alignment schemes for protocol-correct pose evaluation
(counterpart of the JAX package's `eval/alignment.py`):
 - PerspectiveCorrector: premultiplies the pose with a look-at rotation
   derived from the crop position and the camera FOV (Biwi protocol), on
   tensors in f32;
 - compute_opal_paper_alignment: per-cluster Karcher-mean alignment
   (opal23), through scipy's `Rotation` as in the JAX package.
"""

import math

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from neuralnet_tracker_traincode_torch.ops import quaternion as Q


def _compute_displacement(mean_rot: Rotation, rots: Rotation):
    return (mean_rot.inv() * rots).as_rotvec()


def compute_mean_rotation(rots: Rotation, tol=0.0001, max_iter=100000) -> Rotation:
    """Iterative Karcher mean over the rotations within the pi/2 ball."""
    rots = rots[rots.magnitude() < np.pi / 2]
    mean_rot = rots[0]
    for _ in range(max_iter):
        displacement = np.mean(_compute_displacement(mean_rot, rots), axis=0)
        if np.linalg.norm(displacement) < tol:
            break
        mean_rot = mean_rot * Rotation.from_rotvec(displacement)
    return mean_rot


def compute_opal_paper_alignment(pose_pred, pose_target, cluster_ids) -> np.ndarray:
    """Per-cluster alignment of predictions to targets; returns the updated quats."""
    pose_pred = np.asarray(pose_pred)
    pose_target = np.asarray(pose_target)
    cluster_ids = np.asarray(cluster_ids)
    out = np.empty_like(pose_pred)
    for id_ in np.unique(cluster_ids):
        mask = cluster_ids == id_
        pred_rot = Rotation.from_quat(pose_pred[mask])
        target_rot = Rotation.from_quat(pose_target[mask])
        align_rot = compute_mean_rotation(target_rot.inv() * pred_rot)
        pred_rot = pred_rot * align_rot.inv()
        out[mask] = pred_rot.as_quat().astype(pose_pred.dtype)
    return out


def make_look_at_matrix(pos: torch.Tensor) -> torch.Tensor:
    """Rotation whose z-axis points along `pos`, x in the horizontal plane."""
    z = pos / torch.linalg.norm(pos, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=pos.dtype, device=pos.device).expand(z.shape)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    return torch.stack([x, y, z], dim=-1)


class PerspectiveCorrector:
    def __init__(self, fov: float):
        self._fov = fov
        self.f = 1.0 / math.tan(fov * math.pi / 180.0 * 0.5)

    def corrected_rotation(self, image_sizes, coord, pose) -> torch.Tensor:
        """Premultiply the pose with the look-at rotation of the crop position.

        image_sizes: (B, 2) [W, H]; coord: (B, 3); pose: (B, 4) quats; f32."""
        coord = torch.as_tensor(coord, dtype=torch.float32)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=coord.device)
        image_sizes = torch.as_tensor(np.ascontiguousarray(image_sizes), dtype=torch.float32, device=coord.device)
        xy_image = coord[..., :2]
        half = 0.5 * image_sizes
        xy_normalized = (xy_image - half) / half[..., 0:1]
        fs = torch.full_like(xy_normalized[..., :1], self.f)
        xyz = torch.cat([xy_normalized, fs], dim=-1)
        m = make_look_at_matrix(xyz)
        return Q.mult(Q.from_matrix(m), pose)
