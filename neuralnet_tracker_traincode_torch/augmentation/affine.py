"""Category-dispatched application of 2D affine transforms to labels.

Counterpart of the JAX package's `augmentation/affine.py`:
 - points: xy affine; z scaled by sqrt|det|; 68-landmark flip reindex on reflection
 - roi: transform the 4 corners, take the AABB
 - coord: xy affine + size * isotropic scale
 - quat: premultiply the in-plane z-rotation read from the matrix's y-column;
   mirror-conjugate the imaginary parts on reflection.
"""

import torch

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory, imagelike_categories
from neuralnet_tracker_traincode_torch.device import device_constant
from neuralnet_tracker_traincode_torch.facemodel.keypoints68 import flip_map
from neuralnet_tracker_traincode_torch.ops import quaternion as Q
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d
from neuralnet_tracker_traincode_torch.ops.mathfn import affinevecmul


def position_normalization(w: int, h: int) -> Affine2d:
    return Affine2d.range_remap_2d([0.0, 0.0], [float(w), float(h)], [-1.0, -1.0], [1.0, 1.0])


def position_unnormalization(w: int, h: int) -> Affine2d:
    return Affine2d.range_remap_2d([-1.0, -1.0], [1.0, 1.0], [0.0, 0.0], [float(w), float(h)])


def transform_points(tr: Affine2d, points: torch.Tensor) -> torch.Tensor:
    assert points.shape[-1] in (2, 3), f"Bad point array shape: {points.shape}"
    m = tr.tensor()
    batch_dimensions = tuple(m.shape[:-2])
    assert tuple(points.shape[: len(batch_dimensions)]) == batch_dimensions
    extra = points.dim() - len(batch_dimensions) - 1
    m = m.reshape(batch_dimensions + (1,) * extra + (2, 3))
    if points.shape[-1] == 2:
        return affinevecmul(m, points)
    xy = affinevecmul(m, points[..., :2])
    # Scale z like x and y; never invert z on reflections.
    detscale = torch.sqrt(torch.abs(tr.det)).reshape(batch_dimensions + (1,) * extra + (1,))
    z = (detscale * points[..., 2:]).expand(xy.shape[:-1] + (1,))
    return torch.cat([xy, z], dim=-1)


def transform_keypoints(tr: Affine2d, points: torch.Tensor) -> torch.Tensor:
    """Like transform_points but reindexes the 68 landmarks under reflection."""
    out = transform_points(tr, points)
    flipped = out[..., device_constant(flip_map, out.device, torch.int64), :]
    mask = (tr.det < 0.0).reshape(tr.det.shape + (1, 1))
    return torch.where(mask, flipped, out)


def transform_roi(tr: Affine2d, roi: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = roi.unbind(-1)
    corners = torch.stack(
        [torch.stack([x0, y0], -1), torch.stack([x0, y1], -1), torch.stack([x1, y0], -1), torch.stack([x1, y1], -1)],
        dim=-2,
    )
    pts = transform_points(tr, corners)
    return torch.cat([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-1)


def transform_coord(tr: Affine2d, coord: torch.Tensor) -> torch.Tensor:
    xy = affinevecmul(tr.tensor(), coord[..., :2])
    size = tr.scales * coord[..., 2]
    return torch.cat([xy, size[..., None]], dim=-1)


def transform_rot(tr: Affine2d, quat: torch.Tensor) -> torch.Tensor:
    m = tr.tensor()
    # The "y"-vector gives the in-plane angle, so a pure horizontal flip
    # yields zero rotation.
    sn = -m[..., 0, 1]
    cs = m[..., 1, 1]
    detsign = torch.sign(tr.det)
    alpha = torch.atan2(sn, cs)
    qw = torch.cos(alpha * 0.5)
    qk = torch.sin(alpha * 0.5) * detsign
    zeros = torch.zeros_like(qw)
    zrot = torch.stack([zeros, zeros, qk, qw], dim=-1).expand(quat.shape)
    out = Q.mult(zrot, quat)
    # Reflecting one axis negates the imaginary parts of the other two.
    return torch.cat([out[..., :1], detsign[..., None] * out[..., 1:3], out[..., 3:]], dim=-1)


_transform_table = {
    FieldCategory.xys: transform_coord,
    FieldCategory.quat: transform_rot,
    FieldCategory.roi: transform_roi,
    FieldCategory.points: transform_keypoints,
}


def apply_affine2d(trafo: Affine2d, key: str, value: torch.Tensor, category: FieldCategory):
    assert category not in imagelike_categories
    if key == "image_backtransform":
        # BT' = BT @ trafo^-1: maps post-transform points back to the original image.
        return (Affine2d(value) @ trafo.inv()).tensor()
    fn = _transform_table.get(category)
    if fn is None:
        return value
    return fn(trafo, value)
