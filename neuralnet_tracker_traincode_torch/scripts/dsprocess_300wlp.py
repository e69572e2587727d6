"""Convert the 300W-LP zip (3DDFA .mat annotations) to the pose HDF5 schema
(counterpart of the JAX package's `scripts/dsprocess_300wlp.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_300wlp 300W_LP.zip [DEST.h5] \\
        [-n COUNT] [--subset large|original|both] [--reconstruct-head-bbox]

AFLW euler-angle conversion, head-radius coordinate scale (100 mm at scale
0.5/224 per image width), eye-center head origin shift, 3D landmarks
reconstructed from the 3DDFA shape parameters with the port's face model
(the zip's 2D landmark files lack depth), per-identity sequence grouping of
the artificially rotated variants, f16 shape params. Host only: h5py, cv2
and scipy are imported inside the functions.
"""

import argparse
import collections
import io
import os
import re
import sys
import zipfile
from os.path import basename, splitext
from typing import Dict, List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.dataset_writers import full_head_bbox, landmark_bbox, write_pose_hdf5
from neuralnet_tracker_traincode_torch.data.preprocessing import (
    compute_keypoints,
    depth_centered_keypoints,
    get_3ddfa_shape_parameters,
    move_aflw_head_center_to_between_eyes,
    sanity_check_landmarks,
)
from neuralnet_tracker_traincode_torch.utils import aflw_rotation_conversion

HUMAN_HEAD_RADIUS_MICRON = 100.0e3
SUBSETS = frozenset(["AFW", "HELEN", "IBUG", "LFPW"])


def discover_samples(zf: zipfile.ZipFile) -> List[str]:
    def in_subset(fn):
        parts = fn.split(os.path.sep)
        return len(parts) > 1 and parts[1] in SUBSETS

    return sorted(
        f.filename
        for f in zf.filelist
        if splitext(f.filename)[1] == ".mat" and in_subset(f.filename) and not f.is_dir()
        and "landmarks" not in f.filename
    )


def make_groups(filenames: List[str]) -> Dict[str, List[str]]:
    """Group the artificially rotated variants of each source face."""
    regex = re.compile(r"([\w| ]+)_(\d+).mat")
    groups = collections.defaultdict(list)
    for fn in filenames:
        match = regex.match(basename(fn))
        assert match is not None, f"Failed to match {fn}"
        groups[match.groups()[0]].append(fn)
    return groups


def landmarks_filename(matfile: str) -> str:
    parts = matfile.split(os.path.sep)
    name = splitext(parts[-1])[0] + "_pts.mat"
    return os.path.sep.join(parts[:-2] + ["landmarks"] + parts[-2:-1] + [name])


def read_sample(
    zf: zipfile.ZipFile,
    matfile: str,
    load_pt2d_68: bool = True,
    full_face_bounding_box: bool = False,
    sanity_check: bool = True,
):
    import cv2
    import scipy.io

    with io.BytesIO(zf.read(matfile)) as f:
        data = scipy.io.loadmat(f)
    jpgbuffer = zf.read(splitext(matfile)[0] + ".jpg")
    img_shape = cv2.imdecode(np.frombuffer(jpgbuffer, "B"), 0).shape
    h, w = img_shape[:2]

    pitch, yaw, roll, tx, ty, tz, scale = data["Pose_Para"][0]
    rot = aflw_rotation_conversion(pitch, yaw, roll)
    ty = h - ty  # matlab's y axis points up
    proj_radius = 0.5 * scale / 224.0 * w * HUMAN_HEAD_RADIUS_MICRON
    coord = move_aflw_head_center_to_between_eyes(np.asarray([tx, ty, proj_radius]), rot)
    tx, ty, proj_radius = coord

    f_shp, f_exp = get_3ddfa_shape_parameters(data)
    shapeparam = np.concatenate([f_shp, f_exp])

    # 300W-LP ships no 3D landmarks; reconstruct them from the deformable model
    # for consistency with the stored shape parameters.
    pt3d = compute_keypoints(f_shp, f_exp, proj_radius, rot, tx, ty)
    assert pt3d.shape == (3, 68)
    pt3d = depth_centered_keypoints(pt3d)

    if full_face_bounding_box:
        roi = full_head_bbox(coord, rot, shapeparam)
        if roi is None:
            roi = landmark_bbox(pt3d)
    else:
        roi = landmark_bbox(pt3d)

    if sanity_check:
        sanity_check_landmarks(coord, rot, pt3d, (f_shp, f_exp), 0.2)

    out = {
        "pose": rot.as_quat().astype(np.float32),
        "coord": coord.astype(np.float32),
        "roi": roi,
        "image": np.frombuffer(jpgbuffer, dtype="B"),
        "pt3d_68": np.ascontiguousarray(pt3d.T, np.float32),
        "shapeparam": shapeparam.astype(np.float32),
    }
    if load_pt2d_68:
        with io.BytesIO(zf.read(landmarks_filename(matfile))) as f:
            landmarkdata = scipy.io.loadmat(f)
        out["pt2d_68"] = np.ascontiguousarray(landmarkdata["pts_2d"], np.float32)
    return out


def generate_hdf5_dataset(source_file, outfilename, count, subset, full_face_bounding_box):
    import h5py

    with zipfile.ZipFile(source_file) as zf:
        filenames = discover_samples(zf)
        if subset == "large":
            filenames = [fn for fn in filenames if not fn.endswith("_0.mat")]
        elif subset == "original":
            filenames = [fn for fn in filenames if fn.endswith("_0.mat")]
        groups = list(make_groups(filenames).values())
        if count:
            groups = groups[:count]
        sequence_starts = np.cumsum([0] + [len(g) for g in groups])
        N = int(sequence_starts[-1])

        def samples():
            for group in groups:
                for fn in group:
                    yield read_sample(zf, fn, full_face_bounding_box=full_face_bounding_box)

        with h5py.File(outfilename, "w") as f:
            write_pose_hdf5(f, samples(), N, sequence_starts=sequence_starts)
    print(f"Wrote {N} samples to {outfilename}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert 300W-LP")
    parser.add_argument("source", help="source zip", type=str)
    parser.add_argument("destination", type=str, nargs="?", default=None)
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--subset", choices=["large", "original", "both"], default="both")
    parser.add_argument("--reconstruct-head-bbox", default=False, action="store_true")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dst = args.destination or splitext(args.source)[0] + ".h5"
    generate_hdf5_dataset(args.source, dst, args.count, args.subset, args.reconstruct_head_bbox)
    return 0


if __name__ == "__main__":
    sys.exit(main())
