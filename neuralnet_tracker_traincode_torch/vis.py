"""Drawing of samples and predictions (the port's own copy of the JAX
package's `vis.py`): pose axes, landmarks, ROIs, the head circle, the
no-face cross, and the ground truth (green) beside the prediction (red) on
one image, with cv2; the iBUG colours of a semantic segmentation, with
numpy; the 3D landmark scatter and the paging browser, with matplotlib.
Images are RGB. cv2 and matplotlib are imported where a function draws."""

from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

PRED_COLOR = (0, 0, 255)
GT_COLOR = (0, 200, 0)


def matplotlib_import_error() -> Optional[ImportError]:
    """None where matplotlib imports, else the error its import raised (the
    machine with the card may have no matplotlib)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return e
    return None


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


def plot3dlandmarks(ax, keypts):
    """The keypoints (N, 3) on a 3D matplotlib axis, each with its index."""
    keypts = np.asarray(keypts)
    xs, ys, zs = keypts.T
    ax.scatter(xs, ys, zs, s=3.0)
    for i, p in enumerate(keypts):
        ax.text(p[0], p[1], p[2], s=str(i), size=9)
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")


# iBUG face parsing class colours
_ibug_semseg_colors = np.asarray(
    [
        (0, 0, 0), (255, 255, 0), (139, 76, 57), (139, 54, 38), (0, 205, 0),
        (0, 138, 0), (154, 50, 205), (72, 118, 255), (255, 165, 0), (0, 0, 139),
        (255, 0, 0),
    ],
    dtype=np.uint8,
)


def draw_semseg_class_indices(semseg: np.ndarray) -> np.ndarray:
    """(H, W, 1) class indices -> (H, W, 3) uint8 colours."""
    H, W, C = semseg.shape
    assert C == 1, f"bad shape {semseg.shape}"
    return _ibug_semseg_colors[semseg.ravel(), :].reshape((H, W, -1))


def draw_semseg_logits(semseg: np.ndarray) -> np.ndarray:
    """(H, W, classes) log-probabilities -> (H, W, 3) uint8, the classes'
    colours weighted by their probabilities."""
    probs = np.exp(semseg)
    colored = np.sum(_ibug_semseg_colors[None, None, :, :].astype(np.float32) * probs[..., None], axis=-2)
    return np.clip(colored, 0.0, 255.0).astype(np.uint8)


def matplotlib_plot_iterable(iterable, drawfunc, rows=3, cols=3, figsize=(10, 10)):
    """A paging grid over an iterable of samples, each drawn by `drawfunc`
    into an image; the "Next" button shows the next page. Returns (figure,
    button): keep the button referenced while the window is open."""
    from matplotlib import pyplot
    from matplotlib.widgets import Button

    fig, axes = pyplot.subplots(rows, cols, figsize=figsize)
    axes = np.atleast_1d(axes).ravel()
    iterator = iter(iterable)

    def show_next(event=None):
        for ax in axes:
            ax.clear()
            ax.axis("off")
            try:
                item = next(iterator)
            except StopIteration:
                break
            ax.imshow(drawfunc(item))
        fig.canvas.draw_idle()

    ax_button = fig.add_axes([0.81, 0.01, 0.15, 0.05])
    button = Button(ax_button, "Next")
    button.on_clicked(show_next)
    show_next()
    return fig, button
