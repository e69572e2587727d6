"""Image codecs, ROI helpers and the 3DDFA label helpers on the host (the
port's own copy of the JAX package's `data/preprocessing.py`, which the
loader, the writers, the CLIs and the dataset converters use).

The codecs are OpenCV's, with the JAX package's flags (JPEG quality 99
unless given, grayscale decode by default, RGB colour images), so that a
file written by either package decodes to the same pixels in both. cv2 and
PIL are imported where a function needs them: importing this module needs
neither.
"""

import enum
import functools
from typing import Tuple

import numpy as np


def _cv2():
    import cv2

    return cv2


class ImageFormat(enum.IntEnum):
    JPG = 1
    PNG = 2


def which_image_format(buffer) -> ImageFormat:
    head = bytes(buffer[:16].tobytes() if isinstance(buffer, np.ndarray) else buffer[:16])
    if head.startswith(b"\xff\xd8\xff"):
        return ImageFormat.JPG
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return ImageFormat.PNG
    raise ValueError("Unknown image format")


def imencode(img: np.ndarray, format=ImageFormat.JPG, quality=None) -> np.ndarray:
    """Encode an (H, W), (H, W, 1) or RGB (H, W, 3) uint8 image; JPEG at
    `quality` (default 99), PNG lossless."""
    cv2 = _cv2()
    cv_format = {ImageFormat.JPG: ".JPEG", ImageFormat.PNG: ".PNG"}[format]
    assert format == ImageFormat.JPG or quality is None
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    if format == ImageFormat.JPG:
        quality = 99 if quality is None else quality
        _, img = cv2.imencode(cv_format, img, (cv2.IMWRITE_JPEG_QUALITY, quality))
    else:
        _, img = cv2.imencode(cv_format, img)
    return np.frombuffer(img, dtype="uint8")


def imdecode(blob, color=False) -> np.ndarray:
    """color=False -> (H, W) grayscale; truthy -> (H, W, 3) RGB."""
    cv2 = _cv2()
    if isinstance(blob, bytes):
        blob = np.frombuffer(blob, dtype="B")
    img = cv2.imdecode(np.asarray(blob), cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    assert img is not None, "undecodable image buffer"
    if color:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def imread(fn) -> np.ndarray:
    cv2 = _cv2()
    img = cv2.imread(fn)
    assert img is not None, f"Failed to load image {fn}!"
    if len(img.shape) == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def rgb2gray(img):
    cv2 = _cv2()
    return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)


def imrescale(img, factor: float):
    """Rescale a numpy image (area for downscale, bilinear for upscale) or a
    PIL image (HAMMING) by `factor`."""
    from PIL import Image

    h, w = img.shape[:2] if isinstance(img, np.ndarray) else (img.height, img.width)
    new_w, new_h = round(w * factor), round(h * factor)
    if isinstance(img, np.ndarray):
        cv2 = _cv2()
        return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA if factor < 1.0 else cv2.INTER_LINEAR)
    if isinstance(img, Image.Image):
        return img.resize((new_w, new_h), resample=Image.HAMMING, reducing_gap=3.0)
    raise TypeError("Unsupported input")


def imshape(img) -> Tuple[int, int]:
    """(height, width), numpy convention, of a numpy or PIL image."""
    if isinstance(img, np.ndarray):
        assert img.ndim <= 3
        return tuple(map(int, img.shape[:2]))
    return (img.height, img.width)


def extend_rect(roi, padding_fraction, abs_padding):
    x0, y0, x1, y1 = roi
    border = max(x1 - x0, y1 - y0) * padding_fraction + abs_padding
    return np.array([x0 - border, y0 - border, x1 + border, y1 + border])


def squarize_roi(roi, crop=False):
    x0, y0, x1, y1 = roi
    roi_w, roi_h = x1 - x0, y1 - y0
    cx, cy = 0.5 * (x1 + x0), 0.5 * (y1 + y0)
    roi_w = min(roi_w, roi_h) if crop else max(roi_w, roi_h)
    return (cx - roi_w * 0.5, cy - roi_w * 0.5, cx + roi_w * 0.5, cy + roi_w * 0.5)


def compute_padding(roi, w, h):
    x0, y0, x1, y1 = roi
    assert all(isinstance(v, int) for v in roi)
    return max(max(-x0, 0), max(-y0, 0), max(x1 - w, 0), max(y1 - h, 0))


def roi_to_ints(roi):
    x0, y0, x1, y1 = roi
    roi_w, roi_h = round(x1 - x0), round(y1 - y0)  # keeps width == height where it was
    x0, y0 = round(x0), round(y0)
    return (x0, y0, x0 + roi_w, y0 + roi_h)


def extract_image_roi(image, roi, padding_fraction, square=False, return_offset=False):
    """Crop `roi` from `image`, zero padded beyond the borders. The offset is
    the vector to add to landmarks so they match the crop."""
    h, w = image.shape[:2]
    roi = extend_rect(roi, padding_fraction, 0)
    offset = np.array([0.0, 0.0])
    if square:
        roi = squarize_roi(roi)
    roi = roi_to_ints(roi)
    padding = compute_padding(roi, w, h)
    if padding > 0:
        cv2 = _cv2()
        image = cv2.copyMakeBorder(image, padding, padding, padding, padding, cv2.BORDER_CONSTANT, value=(0, 0, 0))
        roi = tuple((v + padding) for v in roi)
        offset[:] = padding
    x0, y0, x1, y1 = roi
    image = np.ascontiguousarray(image[y0:y1, x0:x1, ...])
    offset[0] -= x0
    offset[1] -= y0
    if return_offset:
        return image, offset
    return image


@functools.lru_cache(1)
def load_shape_components():
    """(keypts (68, 3), w_shp (40, 68, 3), w_exp (10, 68, 3)) of the port's
    68-keypoint face model (`facemodel/bfm.py`)."""
    from neuralnet_tracker_traincode_torch.facemodel.bfm import BFMModel

    bfm = BFMModel()
    return bfm.keypts, bfm.w_shp, bfm.w_exp


def get_3ddfa_shape_parameters(params):
    """3DDFA .mat params -> rescaled (40 shape, 10 expression) coefficients."""
    f_shp = params["Shape_Para"][:40, 0] / 20.0 / 1.0e5
    f_exp = params["Exp_Para"][:10, 0] / 5.0
    return f_shp, f_exp


def compute_keypoints(f_shp, f_exp, head_size, rotation, tx, ty):
    """(3, 68) keypoints of the face model posed by `rotation` at head radius
    `head_size` and image position (tx, ty)."""
    keypts, w_shp, w_exp = load_shape_components()
    pts3d = (
        keypts
        + np.sum(f_shp[:40, None, None] * w_shp, axis=0)
        + np.sum(f_exp[:10, None, None] * w_exp, axis=0)
    )
    pts3d = pts3d * head_size
    pts3d = rotation.apply(pts3d)
    pts3d = pts3d.T
    pts3d[0] += tx
    pts3d[1] += ty
    return pts3d


def sanity_check_landmarks(coord, rotation, pt3d_68, params=None, reltol=0.4, img=None):
    """Whether the labelled landmarks lie within `reltol` head radii of the
    face model posed at the labelled pose."""
    if params is None:
        f_shp, f_exp = np.zeros((40,)), np.zeros((10,))
    else:
        f_shp, f_exp = params
    expected = compute_keypoints(f_shp, f_exp, coord[2], rotation, coord[0], coord[1])
    ok = np.allclose(expected, pt3d_68, rtol=0.0, atol=coord[2] * reltol)
    if not ok:
        print("Large deviation between base shape and point labels detected. Check for coordinate flips.")
    return ok


def depth_centered_keypoints(kpts):
    """(3, 68) keypoints with the eye corners' mean depth moved to 0."""
    eye_corner_indices = [45, 42, 39, 36]
    center = np.average(kpts[:, eye_corner_indices], axis=1)
    kpts = np.array(kpts, copy=True)
    kpts[2] -= center[2]
    return kpts


def move_aflw_head_center_to_between_eyes(coords, rot):
    offset_my_mangled_shape_data = np.array([0.0, -0.26, -0.9])
    offset = rot.apply(offset_my_mangled_shape_data) * coords[2]
    coords = np.array(coords, copy=True)
    coords[0:2] += offset[:2]
    return coords


def box_iou(box1, box2):
    """IoU of two sets of (xmin, ymin, xmax, ymax) boxes; shape
    box1.shape[:-1] + box2.shape[:-1]."""
    shape1, shape2 = box1.shape[:-1], box2.shape[:-1]
    box1 = np.reshape(box1, (-1, 4))
    box2 = np.reshape(box2, (-1, 4))
    lt = np.maximum(box1[:, None, :2], box2[:, :2])
    rb = np.minimum(box1[:, None, 2:], box2[:, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    iou = inter / (area1[:, None] + area2 - inter)
    return np.reshape(iou, shape1 + shape2)
