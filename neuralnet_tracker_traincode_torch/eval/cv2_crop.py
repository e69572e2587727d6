"""Host-side cv2 eval-crop backend, bit-compatible with the reference's
eval pixels (counterpart of the JAX package's `eval/cv2_crop.py`).

The expanded face ROI is rounded to integer pixels, extracted with zero
padding, and resized with cv2 INTER_AREA when shrinking (bilinear when
growing). cv2 is imported when a crop is made; where it is missing,
`Predictor(crop_backend="cv2")` raises an ImportError and never falls back
to the device crop.
"""

from typing import Tuple, Union

import numpy as np

from neuralnet_tracker_traincode_torch.augmentation.geometric import MAX_BEYOND_BORDER_SHIFT


def import_cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "crop_backend='cv2' needs OpenCV (the cv2 module), which is not installed here; "
            "the default crop_backend='device' needs no cv2"
        ) from e
    return cv2


def compute_view_roi_np(
    face_bbox: np.ndarray, extent_factor: float, beyond_border_shift: float = MAX_BEYOND_BORDER_SHIFT
) -> np.ndarray:
    """The expanded square view ROI of the deterministic eval crop (no
    translation), rounded to int32 before cropping as the reference does."""
    face_bbox = np.asarray(face_bbox, np.float32)
    x0, y0, x1, y1 = np.moveaxis(face_bbox, -1, 0)
    size = np.maximum(x1 - x0, y1 - y0) * np.float32(extent_factor)
    cx = 0.5 * (x0 + x1)
    cy = 0.5 * (y0 + y1)
    roi = np.stack([cx - 0.5 * size, cy - 0.5 * size, cx + 0.5 * size, cy + 0.5 * size], axis=-1)
    return np.round(roi).astype(np.int32)


def extract_roi_zero_padded(img: np.ndarray, roi: np.ndarray) -> np.ndarray:
    """Extract an integer ROI from an HWC image; out-of-bounds reads are zero."""
    assert img.ndim == 3
    h, w, c = img.shape
    x0, y0, x1, y1 = (int(v) for v in roi)
    canvas = np.zeros((y1 - y0, x1 - x0, c), dtype=img.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1, sy1 = min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        canvas[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return canvas


def resize_cv2(
    img: np.ndarray, new_size: Union[int, Tuple[int, int]], downfilter: str = "area", upfilter: str = "linear"
) -> np.ndarray:
    """cv2.resize with the reference's filter selection: `downfilter` when
    the mean scale factor < 1, else `upfilter`."""
    cv2 = import_cv2()
    new_w, new_h = (new_size, new_size) if isinstance(new_size, int) else new_size
    old_h, old_w = img.shape[:2]
    scale_factor = 0.5 * (new_w / old_w + new_h / old_h)
    filt = downfilter if scale_factor < 1.0 else upfilter
    interp = {
        "linear": cv2.INTER_LINEAR,
        "cubic": cv2.INTER_CUBIC,
        "lanczos": cv2.INTER_LANCZOS4,
        "area": cv2.INTER_AREA,
    }[filt]
    out = cv2.resize(img, dsize=(new_w, new_h), interpolation=interp)
    if out.ndim == 2:
        out = out[..., None]
    return out


def croprescale_cv2(img: np.ndarray, roi_int: np.ndarray, new_size: int) -> np.ndarray:
    """Zero-padded integer-ROI crop + anti-aliased resize (HWC in, HWC out)."""
    return resize_cv2(extract_roi_zero_padded(img, roi_int), new_size)
