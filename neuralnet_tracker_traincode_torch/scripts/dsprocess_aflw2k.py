"""Convert the AFLW2000-3D zip to the pose HDF5 schema (counterpart of the
JAX package's `scripts/dsprocess_aflw2k.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_aflw2k AFLW2000-3D.zip [DEST.h5] [-n COUNT]

The 300W-LP pipeline, but with the ground-truth pt3d_68 landmarks of the
.mat files (depth-centered, z flipped) and no per-identity sequences. Host
only: h5py, cv2 and scipy are imported inside the functions.
"""

import argparse
import io
import sys
import zipfile
from os.path import dirname, sep, splitext
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.dataset_writers import full_head_bbox, landmark_bbox, write_pose_hdf5
from neuralnet_tracker_traincode_torch.data.preprocessing import (
    depth_centered_keypoints,
    get_3ddfa_shape_parameters,
    move_aflw_head_center_to_between_eyes,
    sanity_check_landmarks,
)
from neuralnet_tracker_traincode_torch.utils import aflw_rotation_conversion

HUMAN_HEAD_RADIUS_MICRON = 100.0e3


def discover_samples(zf):
    return sorted(
        f.filename
        for f in zf.filelist
        if splitext(f.filename)[1] == ".mat" and not f.filename.endswith(sep) and dirname(f.filename) == "AFLW2000"
    )


def read_sample(zf, matfile):
    import cv2
    import scipy.io

    with io.BytesIO(zf.read(matfile)) as f:
        data = scipy.io.loadmat(f)
    jpgbuffer = zf.read(splitext(matfile)[0] + ".jpg")
    h, w = cv2.imdecode(np.frombuffer(jpgbuffer, "B"), 0).shape[:2]

    pitch, yaw, roll, tx, ty, tz, scale = data["Pose_Para"][0]
    rot = aflw_rotation_conversion(pitch, yaw, roll)
    ty = h - ty
    proj_radius = 0.5 * scale / 224.0 * w * HUMAN_HEAD_RADIUS_MICRON
    coord = move_aflw_head_center_to_between_eyes(np.asarray([tx, ty, proj_radius]), rot)

    f_shp, f_exp = get_3ddfa_shape_parameters(data)
    shapeparam = np.concatenate([f_shp, f_exp])

    # AFLW2000-3D ships GT 3D landmarks.
    pt3d = depth_centered_keypoints(np.asarray(data["pt3d_68"], np.float64))
    pt3d[2] *= -1

    roi = full_head_bbox(coord, rot, shapeparam)
    if roi is None:
        roi = landmark_bbox(pt3d)

    sanity_check_landmarks(coord, rot, pt3d, (f_shp, f_exp), 0.4)

    return {
        "pose": rot.as_quat().astype(np.float32),
        "coord": coord.astype(np.float32),
        "roi": roi,
        "image": np.frombuffer(jpgbuffer, dtype="B"),
        "pt3d_68": np.ascontiguousarray(pt3d.T, np.float32),
        "shapeparam": shapeparam.astype(np.float32),
    }


def generate_hdf5_dataset(source_file, outfilename, count=None):
    import h5py

    with zipfile.ZipFile(source_file) as zf:
        filenames = discover_samples(zf)
        if count:
            filenames = filenames[:count]
        with h5py.File(outfilename, "w") as f:
            write_pose_hdf5(f, (read_sample(zf, fn) for fn in filenames), len(filenames))
    print(f"Wrote {len(filenames)} samples to {outfilename}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert AFLW2000-3D")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str, nargs="?", default=None)
    parser.add_argument("-n", dest="count", type=int, default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dst = args.destination or splitext(args.source)[0] + ".h5"
    generate_hdf5_dataset(args.source, dst, args.count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
