"""Convert "replicant face" synthetic renders (face_<n>.npz, _img.jpg,
_mask.png) to the pose HDF5 schema (counterpart of the JAX package's
`scripts/dsprocess_replicantface.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_replicantface SOURCE_DIR DEST.h5 \\
        [--with-variation-postfix] [-n COUNT] [--write-limit N]

The pose from the modelview matrix (Blender's axes flipped to the
project's), a weak-perspective head size from the projection, landmarks
from mesh vertex subsets (`landmark_indices.npz` and the others in the
dataset's root), the ROI from the projected face vertices, renders dropped
by brightness and face-mask extent, optional variation sequences
(face_<num>_<postfix> grouped by <num>). Host only: h5py and cv2 are
imported inside the functions.
"""

import argparse
import contextlib
import functools
import re
import sys
from contextlib import closing
from pathlib import Path
from pprint import pprint
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import depth_centered_keypoints, imread

COLOR_FACE = (204, 91, 118)
COLOR_CLOTHES = (135, 198, 199)
COLOR_BG = (0, 0, 0)

HEAD_RADIUS_METERS = 0.1  # approximate, shared across individuals
HEADBONE_TO_EYE_CENTER = np.asarray([0.0, -0.064, -0.086, 1.0])


def map_indices(full_head_points, subset_indices):
    m = np.full(np.amax(full_head_points) + 1, fill_value=-1, dtype=np.int64)
    m[full_head_points] = np.arange(len(full_head_points))
    out = m[subset_indices]
    assert np.all(out >= 0)
    return out


@functools.lru_cache()
def get_landmark_indices(dataset_root: Path):
    with closing(np.load(dataset_root / "head_indices.npz")) as f:
        head_indices = f["indices"]
    with closing(np.load(dataset_root / "landmark_indices.npz")) as f:
        landmark_indices = f["indices"]
    with closing(np.load(dataset_root / "face_indices.npz")) as f:
        face_indices = f["indices"]
    return (map_indices(head_indices, landmark_indices), map_indices(head_indices, face_indices))


def _screen_to_image(p, img_size):
    return (1.0 - p) / 2.0 * img_size


def check_valid(image_filename: Path) -> bool:
    image = imread(str(image_filename))
    avg_brightness = np.average(image)
    if avg_brightness < 20 and np.percentile(np.ravel(np.average(image, axis=-1)), 98) < 20:
        return False  # too dark, no bright areas
    return True


def _mask_for_class(seg, color):
    return np.amax(np.abs(seg.astype(np.int32) - np.asarray(color)), axis=-1) < 20


def roi_from_points(points):
    min_ = np.amin(points[..., :2], axis=-2)
    max_ = np.amax(points[..., :2], axis=-2)
    return np.concatenate([min_, max_], axis=-1).astype(np.float32)


def roi_from_seg(mask_filename: Path):
    import cv2

    seg = imread(str(mask_filename))
    h, w, _ = seg.shape
    points = cv2.findNonZero(_mask_for_class(seg, COLOR_FACE).astype(np.uint8))
    if points is None:
        print(f"Warning: ROI fallback for {mask_filename}")
        fg = ~(_mask_for_class(seg, COLOR_CLOTHES) | _mask_for_class(seg, COLOR_BG))
        points = cv2.findNonZero(fg.astype(np.uint8))
    # cv2 < 5 returns (N, 1, 2); cv2 5.x returns (N, 2).
    bbox = roi_from_points(np.asarray(points).reshape(-1, 2))
    bw, bh = bbox[2:] - bbox[:2]
    if (bw < 32 or bh < 32) or (bw > 2 * w // 3 or bh > 2 * h // 3):
        return np.zeros((4,), np.int64)
    return bbox


def convert(filename: Path):
    from scipy.spatial.transform import Rotation

    with contextlib.closing(np.load(filename)) as f:
        modelview = f["modelview"]
        projection = f["projection"]
        vertices = f["vertices"]
        resolution = f["resolution"]
    assert np.isclose(projection[0, 0], projection[1, 1]), "FOV should be symmetric"
    # Blender -> this project: flip around x.
    rx = Rotation.from_rotvec([np.pi, 0.0, 0.0]).as_matrix()
    rx44 = np.eye(4)
    rx44[:3, :3] = rx

    facepos3d = rx44.T @ modelview @ rx44 @ HEADBONE_TO_EYE_CENTER
    img_size = float(resolution)
    p = projection @ facepos3d
    p = p / p[3]
    depth = facepos3d[2]
    p[:2] = _screen_to_image(p[:2], img_size)
    # Weak-perspective head size (0.5 from the [-1,1] screen-to-image span).
    p[2] = HEAD_RADIUS_METERS * projection[0, 0] / depth * img_size * 0.5
    quat = Rotation.from_matrix(rx.T @ modelview[:3, :3] @ rx).as_quat()

    landmark_indices, face_indices = get_landmark_indices(filename.parent)
    vertices = np.pad(vertices, [(0, 0), (0, 1)], constant_values=1.0)
    proj = (projection @ rx44.T @ modelview) @ vertices[face_indices].T
    proj /= proj[3, :]
    proj = _screen_to_image(proj[:2], img_size).T
    bbox = roi_from_points(proj)

    landmarks = (rx44.T @ modelview @ vertices[landmark_indices].T).T
    landmarks = -projection[0, 0] / depth * landmarks  # weak perspective
    landmarks = _screen_to_image(landmarks[:, :3], img_size)
    landmarks = depth_centered_keypoints(landmarks.T).T
    return quat, p[:3], bbox, landmarks


def npz_to_other_files(f: Path):
    return (f.with_name(f.stem + "_img.jpg"), f.with_name(f.stem + "_mask.png"))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert replicant-face renders")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str)
    parser.add_argument(
        "--with-variation-postfix", action="store_true", default=False,
        help="face_<num>_<postfix> naming; same <num> packed into a sequence",
    )
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--write-limit", type=int, default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    if not args.with_variation_postfix:
        label_files = sorted(Path(args.source).glob("face_[0-9]*.npz"))
        if args.count:
            label_files = label_files[: args.count]
        label_files = np.asarray(label_files, dtype=object)
        individuals = np.arange(len(label_files))
    else:
        regex = re.compile(r"face_([0-9]*)_(.*)\.npz")
        entries = []
        for p in Path(args.source).glob("face_[0-9]*_*.npz"):
            m = regex.match(p.name)
            assert m is not None
            entries.append((p, m.group(1), m.group(2)))
        entries = sorted(entries, key=lambda x: x[1:])
        if args.count:
            keep = frozenset(sorted({e[1] for e in entries})[: args.count])
            entries = [e for e in entries if e[1] in keep]
        label_files = np.asarray([e[0] for e in entries], dtype=object)
        individuals = np.asarray([e[1] for e in entries], dtype=object)

    print("processing:", len(label_files))
    valid = np.asarray([check_valid(npz_to_other_files(fn)[0]) for fn in tqdm.tqdm(label_files, desc="validity")])
    seg_rois = np.asarray([roi_from_seg(npz_to_other_files(fn)[1]) for fn in tqdm.tqdm(label_files, desc="masks")])
    quats, xys, pts_rois, landmarks = map(
        np.asarray, zip(*[convert(lbl) for lbl in tqdm.tqdm(label_files, desc="labels")])
    )
    rw, rh = (seg_rois[:, 2:] - seg_rois[:, :2]).T
    valid = valid & (rw > 32) & (rh > 32)
    invalid = [str(fn) for fn in label_files[~valid]]
    print(f"Invalid images: {len(invalid)} ({len(invalid) / max(1, len(label_files)) * 100:0.3f}%)")
    pprint(invalid[:50])

    (idx,) = np.nonzero(valid)
    if args.write_limit:
        idx = idx[: args.write_limit]
    label_files, rois = label_files[idx], pts_rois[idx]
    quats, xys, landmarks = quats[idx], xys[idx], landmarks[idx]
    individuals = individuals[idx]
    assert np.all(np.sort(individuals) == individuals)

    print(f"Writing {len(label_files)} samples")
    with h5py.File(args.destination, "w") as f:
        if args.with_variation_postfix:
            _, starts = np.unique(individuals, return_index=True)
            f.create_dataset("sequence_starts", data=np.concatenate([starts, [len(individuals)]]))
        create_pose_dataset(f, C.quat, data=quats, dtype=np.float32)
        create_pose_dataset(f, C.xys, data=xys, dtype=np.float16)
        create_pose_dataset(f, C.roi, data=rois, dtype=np.float16)
        create_pose_dataset(f, C.points, name="pt3d_68", data=landmarks, dtype=np.float16)
        ds_img = create_pose_dataset(f, C.image, count=len(label_files), lossy=True)
        for i, name in tqdm.tqdm(list(enumerate(label_files)), desc="images"):
            img_filename, _ = npz_to_other_files(name)
            with open(img_filename, "rb") as fi:
                ds_img[i] = np.frombuffer(fi.read(), dtype=np.uint8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
