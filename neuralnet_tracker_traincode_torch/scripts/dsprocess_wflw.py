"""Convert WFLW (98-point annotations) to the pose HDF5 schema, 2D landmarks
(counterpart of the JAX package's `scripts/dsprocess_wflw.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_wflw SOURCE_DIR [DEST_DIR] [-n COUNT]

98 -> 68 landmark conversion (chin subsampling, brow pair averaging, eye
midpoints), downscaled and cropped storage around the face ROI, faces
narrower than 129 px dropped, f16 labels, `wflw_train.h5` and `wflw_test.h5`.
The crop helpers (`cropped`, `apply_crop_trafo_*`) serve the 300-VW, LaPa
and unlabeled-image converters too. Host only: h5py and PIL are imported
inside the functions.
"""

import argparse
import itertools
import sys
from os.path import join
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import extend_rect, imrescale, imshape


def cvt_landmarks_68pt(lmk: np.ndarray) -> np.ndarray:
    """(..., 2, 98) WFLW landmarks -> (..., 68, 2) iBUG landmarks."""
    assert lmk.shape[-2:] == (2, 98)
    chin = lmk[..., :33:2]
    brows_pairs_left = [(34, 41), (35, 40), (36, 39), (37, 38)]
    brows_pairs_right = [(42, 50), (43, 49), (44, 48), (45, 47)]

    def avg(*pairs):
        a, b = zip(*pairs)
        return np.average([lmk[..., a], lmk[..., b]], axis=0)

    def rng(start, end=None):
        return lmk[..., start : (start + 1 if end is None else end)]

    lmk68 = np.concatenate(
        [
            chin,
            rng(33), avg(*brows_pairs_left), avg(*brows_pairs_right), rng(46),  # brows
            rng(51, 60),  # nose
            rng(60), avg((61, 62), (62, 63)), rng(64), avg((66, 65), (67, 66)),  # left eye
            rng(68), avg((69, 70), (70, 71)), rng(72), avg((74, 73), (75, 74)),  # right eye
            rng(76, 96),  # mouth
        ],
        axis=-1,
    )
    lmk68 = lmk68.swapaxes(-1, -2)
    assert lmk68.shape[-2:] == (68, 2), f"Bad shape {lmk68.shape}"
    return lmk68


def parse_annotation_file(f):
    def cvtline(line):
        vals = [s.strip() for s in line.split(" ")]
        landmarks = np.array(list(map(float, vals[: 98 * 2])))
        landmarks = np.stack([landmarks[::2], landmarks[1::2]], axis=-1).T
        x0, y0, x1, y1 = map(float, vals[98 * 2 : 98 * 2 + 4])
        image_name = join("WFLW_images", vals[-1])
        return image_name, landmarks, np.asarray([x0, y0, x1, y1])

    paths, landmarks, rois = map(np.asarray, zip(*[cvtline(l) for l in f.readlines()]))
    return paths, cvt_landmarks_68pt(landmarks).astype(np.float32), rois.astype(np.float32)


def cropped(img, roi, desired_roi_size=129, padding_factor=0.5, abs_padding=10):
    """Downscale large faces and crop with padding; returns (image, (scale, tx, ty)).

    The returned affine maps ORIGINAL image coordinates to the stored crop:
    p' = scale * p + (tx, ty).
    """
    roi = np.asarray(roi, np.float64)
    rw, rh = roi[2] - roi[0], roi[3] - roi[1]
    h, w = imshape(img)
    scale = 1.0
    # Only downscale (upscaling happens in augmentation), and only for faces
    # substantially larger than the training resolution.
    alpha = 1.5
    if rw > alpha * desired_roi_size and rh > alpha * desired_roi_size:
        s = desired_roi_size / min(rh, rw)
        img = imrescale(img, s)
        scale = imshape(img)[1] / w
        h, w = imshape(img)
        roi = scale * roi
    cropbox = extend_rect(roi, padding_factor, abs_padding)
    cropbox[0] = max(cropbox[0], 0)
    cropbox[1] = max(cropbox[1], 0)
    cropbox[2] = min(cropbox[2], w)
    cropbox[3] = min(cropbox[3], h)
    x0, y0, x1, y1 = cropbox.astype(int)
    img = np.ascontiguousarray(np.asarray(img)[y0:y1, x0:x1, ...])
    return img, (scale, -float(x0), -float(y0))


def apply_crop_trafo_points(points, trafo):
    scale, tx, ty = trafo
    out = np.array(points, np.float32, copy=True)
    out[..., 0] = out[..., 0] * scale + tx
    out[..., 1] = out[..., 1] * scale + ty
    return out


def apply_crop_trafo_roi(roi, trafo):
    scale, tx, ty = trafo
    out = np.array(roi, np.float32, copy=True)
    out[..., [0, 2]] = out[..., [0, 2]] * scale + tx
    out[..., [1, 3]] = out[..., [1, 3]] * scale + ty
    return out


def generate_hdf5_dataset(sourcedir, outdir, count=None, min_box_width=129):
    import h5py
    import tqdm
    from PIL import Image

    from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset, create_pose_dataset

    annodir = join(sourcedir, "WFLW_annotations", "list_98pt_rect_attr_train_test")
    for split in ["test", "train"]:
        with open(join(annodir, f"list_98pt_rect_attr_{split}.txt"), encoding="utf-8") as f:
            paths, landmarks, rois = parse_annotation_file(f)
        if count is not None:
            paths, landmarks, rois = paths[:count], landmarks[:count], rois[:count]
        good = (rois[:, 2] - rois[:, 0]) >= min_box_width
        paths, landmarks, rois = paths[good], landmarks[good], rois[good]
        N = len(paths)

        outfile = join(outdir, f"wflw_{split}.h5")
        with h5py.File(outfile, "w") as f:
            ds_img = create_pose_dataset(f, C.image, count=N)
            out_lmk = np.empty_like(landmarks)
            out_roi = np.empty_like(rois)
            for i, path, roi in tqdm.tqdm(zip(itertools.count(), paths, rois), total=N):
                img = Image.open(join(sourcedir, path))
                img, trafo = cropped(img, roi, desired_roi_size=224, padding_factor=0.5, abs_padding=10)
                ds_img[i] = img
                out_lmk[i] = apply_crop_trafo_points(landmarks[i], trafo)
                out_roi[i] = apply_crop_trafo_roi(roi, trafo)
            create_pose_dataset(f, C.points, name="pt2d_68", dtype=np.float16, data=out_lmk)
            create_pose_dataset(f, C.roi, dtype=np.float16, data=out_roi)
        # Smoke-check readability.
        assert Hdf5PoseDataset(outfile)[0] is not None
        print(f"Wrote {N} samples to {outfile}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert WFLW")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str, nargs="?", default=None)
    parser.add_argument("-n", dest="count", type=int, default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    generate_hdf5_dataset(args.source, args.destination or args.source, args.count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
