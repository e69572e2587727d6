"""Learnable synthetic pose data: rendered keypoint-marker heads
(counterpart of the JAX package's `data/synthetic.py`).

Each sample renders the 68 BFM keypoints of a randomly posed, randomly
deformed head as small gaussian markers whose base intensity identifies the
keypoint and whose brightness follows depth, so pose, landmarks and shape
parameters are fully determined by the image. The draws come from a numpy
`RandomState(seed)` in the JAX package's order, so both packages make the same
labels; the keypoints and the images are computed in torch on `device`.
`write_synthetic_pose_dataset` writes a set as a pose file in the JAX
writer's schema (JPEG quality 95, the `max_image_hw` attribute).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, rigid_transformation_25d
from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr


def _random_quats(rng: np.random.RandomState, n: int, max_angle_deg: float) -> np.ndarray:
    """Random rotations, real-last quats, rotation angle uniform in [0, max]."""
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(0.0, np.deg2rad(max_angle_deg), n)
    return np.concatenate([axis * np.sin(0.5 * angle)[:, None], np.cos(0.5 * angle)[:, None]], axis=-1).astype(
        np.float32
    )


@torch.no_grad()
def make_labels(n: int, image_size: int, seed: int = 0, device: DeviceLike = None) -> Tuple[torch.Tensor, ...]:
    """(quats (n, 4), coords (n, 3), pt3d (n, 68, 3), shapeparams (n, 50),
    rois (n, 4)) as f32 tensors on `device`, in source pixels."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    S = image_size
    quats = _random_quats(rng, n, max_angle_deg=70.0)
    xy = rng.uniform(0.38 * S, 0.62 * S, (n, 2)).astype(np.float32)
    size = rng.uniform(0.16 * S, 0.26 * S, (n, 1)).astype(np.float32)
    shapeparams = (rng.randn(n, 50) * 0.6).astype(np.float32)
    quats, xy, size, shapeparams = (torch.from_numpy(a).to(dev) for a in (quats, xy, size, shapeparams))
    local = DeformableHeadKeypoints(40, 10).to(dev)(shapeparams)  # (n, 68, 3) head-radius units
    pt3d = rigid_transformation_25d(QuatRepr(quats), xy, size, local)
    rois = torch.cat([pt3d[..., :2].amin(dim=1), pt3d[..., :2].amax(dim=1)], dim=-1)
    return quats, torch.cat([xy, size], dim=-1), pt3d, shapeparams, rois


@torch.no_grad()
def render_marker_images(
    pt3d: torch.Tensor, coords: torch.Tensor, image_size: int, chunk: int = 128, sigma: float = 1.6
) -> torch.Tensor:
    """(N, S, S) uint8 images of identity-coded, depth-shaded markers, on
    the device of `pt3d`; the running maximum over the markers takes the
    place of the JAX package's max over a (B, 68, S, S) stack."""
    S = image_size
    dev = pt3d.device
    ident = torch.from_numpy((70.0 + 185.0 * np.arange(68) / 67.0).astype(np.float32)).to(dev)
    grid = torch.arange(S, dtype=torch.float32, device=dev)
    out = torch.empty((pt3d.shape[0], S, S), dtype=torch.uint8, device=dev)
    for i in range(0, pt3d.shape[0], chunk):
        pts, size = pt3d[i : i + chunk], coords[i : i + chunk, 2:]
        zn = pts[..., 2] / size  # depth in head-radius units, roughly [-1.2, 1.2]
        amp = ident[None, :] * torch.clamp(0.65 + 0.3 * zn, 0.3, 1.0)  # (B, 68)
        d2x = torch.square(grid[None, None, :] - pts[..., 0][:, :, None])  # (B, 68, S)
        d2y = torch.square(grid[None, None, :] - pts[..., 1][:, :, None])
        img = torch.zeros((pts.shape[0], S, S), dtype=torch.float32, device=dev)
        for k in range(68):
            g = torch.exp(-(d2y[:, k, :, None] + d2x[:, k, None, :]) / (2.0 * sigma * sigma))
            img = torch.maximum(img, amp[:, k, None, None] * g)
        out[i : i + chunk] = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
    return out


def write_synthetic_pose_dataset(
    path: str,
    n: int,
    image_size: int = 160,
    seed: int = 0,
    sequence_starts: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> str:
    """Write `n` marker frames from `seed` as a pose file at `path`: the
    labels and images of `make_labels` and `render_marker_images`, computed
    on `device` (default: the card), encoded and written on the host."""
    import h5py

    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    quats, coords, pt3d, shapeparams, rois = make_labels(n, image_size, seed, device=device)
    images = render_marker_images(pt3d, coords, image_size).cpu().numpy()
    quats, coords, pt3d, shapeparams, rois = (a.cpu().numpy() for a in (quats, coords, pt3d, shapeparams, rois))
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
        if sequence_starts is not None:
            f.create_dataset("sequence_starts", data=np.asarray(sequence_starts, np.int32))
        f.attrs["max_image_hw"] = np.asarray([image_size, image_size], np.int32)  # the loader's exact pad bound
    return path
