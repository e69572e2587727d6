"""Drawing of samples and predictions with cv2 (the port's own copy of the
parts of the JAX package's `vis.py` that the CLIs' `--vis-outdir` needs):
pose axes, landmarks, ROIs, the head circle, the no-face cross, and the
ground truth (green) beside the prediction (red) on one image. Images are
RGB. cv2 is imported where a function draws; the matplotlib browsers of the
JAX package wait (ROADMAP.md)."""

from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

PRED_COLOR = (0, 0, 255)
GT_COLOR = (0, 200, 0)


def _cv2():
    import cv2

    return cv2


def ensure_image_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        return img[..., None]
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        return np.moveaxis(img, 0, -1)
    return img


def _with3channels_hwc(img: np.ndarray) -> np.ndarray:
    img = ensure_image_hwc(img)
    assert img.ndim == 3
    if img.shape[-1] == 1:
        img = np.tile(img, (1, 1, 3))
    return np.ascontiguousarray(img)


def draw_axis(img, rot, tdx=None, tdy=None, size=100, brgt=255, lw=3, color: Optional[Tuple[int, int, int]] = None):
    """Draw the rotated coordinate frame (x red, y green, z blue unless
    `color` is given) at (tdx, tdy), the image centre by default."""
    cv2 = _cv2()
    if isinstance(rot, Rotation):
        rot = rot.as_matrix()
    else:
        rot = np.asarray(rot)
        if rot.shape == (4,):
            rot = Rotation.from_quat(rot).as_matrix()
    if tdx is None or tdy is None:
        height, width = img.shape[:2]
        tdx, tdy = width / 2, height / 2
    m = size * rot
    x1, x2, x3 = m[0, :] + tdx
    y1, y2, y3 = m[1, :] + tdy
    if color is None:
        xcolor, ycolor, zcolor = (brgt, 0, 0), (0, brgt, 0), (0, 0, brgt)
    else:
        r, g, b = color
        xcolor = ycolor = zcolor = (brgt * r // 255, brgt * g // 255, brgt * b // 255)
    cv2.line(img, (int(tdx), int(tdy)), (int(x1), int(y1)), xcolor, lw)
    cv2.line(img, (int(tdx), int(tdy)), (int(x2), int(y2)), ycolor, lw)
    cv2.line(img, (int(tdx), int(tdy)), (int(x3), int(y3)), zcolor, lw)
    return img


def draw_points3d(img, pt3d, size=3, color=None, labels=False):
    cv2 = _cv2()
    pt3d = np.asarray(pt3d)
    assert pt3d.shape[-1] in (2, 3)
    r, g, b = (255, 255, 255) if color is None else color
    for i, p in enumerate(pt3d[:, :2]):
        p = tuple(p.astype(int))
        if labels:
            cv2.putText(img, str(i), (p[0] + 2, p[1]), cv2.FONT_HERSHEY_SIMPLEX, 0.3, (255, 255, 255), 1, cv2.LINE_AA)
        cv2.circle(img, p, size + 1, (255, 255, 255), -1)
        cv2.circle(img, p, size, (r, g, b), -1)


def draw_roi(img, roi, color, linewidth):
    _cv2().rectangle(img, (round(float(roi[0])), round(float(roi[1]))), (round(float(roi[2])), round(float(roi[3]))),
                     color, linewidth)


def draw_pose(img, sample, color=None, linewidth=3):
    """The pose axes at the head centre and the head circle of radius
    coord[2] (a dot at the centre in `color`)."""
    cv2 = _cv2()
    rot = np.asarray(sample["pose"])
    x, y, s = np.asarray(sample["coord"])
    draw_axis(img, rot, tdx=x, tdy=y, brgt=255, lw=linewidth, color=None)
    if color is not None:
        cv2.circle(img, (int(x), int(y)), 4, color, -1)
    if s <= 0.0:
        print(f"Error, head size {s} not positive!")
    else:
        cv2.circle(img, (int(x), int(y)), int(s), (200, 200, 0) if color is None else color, linewidth)


def maybe_draw_no_face_indication(img, sample, brightness=255, linewidth=3):
    if "hasface" in sample and float(np.asarray(sample["hasface"])) < 0.5:
        cv2 = _cv2()
        color = (brightness, 0, 0)
        cv2.line(img, (0, 0), (img.shape[1], img.shape[0]), color, linewidth)
        cv2.line(img, (0, img.shape[0]), (img.shape[1], 0), color, linewidth)


def draw_prediction(gt_pred, linewidth=2):
    """The sample's image (RGB) with the ground truth in green and the
    prediction in red: ROI, landmarks, pose axes and head circle."""
    gt, pred = gt_pred
    img = _with3channels_hwc(np.asarray(gt["image"]))
    if "roi" in gt:
        draw_roi(img, np.asarray(gt["roi"]), GT_COLOR, linewidth)
    if "pt3d_68" in gt:
        draw_points3d(img, np.asarray(gt["pt3d_68"]), size=1, color=GT_COLOR)
    if "pose" in gt and "coord" in gt:
        draw_pose(img, gt, color=GT_COLOR, linewidth=linewidth)
    maybe_draw_no_face_indication(img, gt, 200, linewidth)
    if pred is not None:
        if "roi" in pred:
            draw_roi(img, np.asarray(pred["roi"]), PRED_COLOR, linewidth)
        if "pt3d_68" in pred:
            draw_points3d(img, np.asarray(pred["pt3d_68"]), size=1, color=PRED_COLOR)
        if "pose" in pred and "coord" in pred:
            draw_pose(img, pred, color=PRED_COLOR, linewidth=linewidth)
    return img
