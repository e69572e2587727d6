"""Convert the Microsoft FaceSynthetics zip to the pose HDF5 schema
(counterpart of the JAX package's `scripts/dsprocess_synface.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_synface dataset_100000.zip DEST.h5 [-n COUNT]

68 of the 70 landmarks (pupils dropped, z padded with zeros), the ROI from
the skin and nose segmentation (the whole foreground as fallback), faces of
32 px or less dropped, the PNG sources re-encoded as JPEG quality 95. Host
only: h5py and cv2 are imported inside the functions.
"""

import argparse
import itertools
import sys
import zipfile
from typing import List, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import imdecode, imencode

# FaceSynthetics segmentation classes.
BACKGROUND, SKIN, NOSE = 0, 1, 2


def iterfiles(zf: zipfile.ZipFile):
    contents = frozenset(zf.namelist())
    for i in itertools.count():
        img = f"{i:06d}.png"
        if img not in contents:
            break
        seg = f"{i:06d}_seg.png"
        lmk = f"{i:06d}_ldmks.txt"
        assert seg in contents and lmk in contents, f"incomplete sample {i}"
        yield img, lmk, seg


def read_landmarks(zf, lmk_filename) -> np.ndarray:
    with zf.open(lmk_filename, "r") as f:
        lines = f.readlines()
    lmks = np.asarray([[float(u) for u in line.split()] for line in lines])
    assert lmks.shape == (70, 2), f"Bad shape {lmks.shape}"
    return lmks


def roi_from_seg(zf, seg_filename) -> np.ndarray:
    import cv2

    seg = imdecode(zf.read(seg_filename), color=False)
    mask = np.logical_or(seg == SKIN, seg == NOSE).astype(np.uint8)
    points = cv2.findNonZero(mask)
    if points is None:
        print(f"Warning: ROI fallback for {seg_filename}")
        points = cv2.findNonZero((seg != BACKGROUND).astype(np.uint8))
    # cv2 < 5 returns (N, 1, 2); cv2 5.x returns (N, 2).
    pts = np.asarray(points).reshape(-1, 2)
    min_ = np.amin(pts, axis=0)
    max_ = np.amax(pts, axis=0)
    return np.concatenate([min_, max_]).astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert FaceSynthetics")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str)
    parser.add_argument("-n", dest="count", type=int, default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    with zipfile.ZipFile(args.source, "r") as zf:
        files = list(iterfiles(zf))
        if args.count:
            files = files[: args.count]
        names = np.array([a for a, _, _ in files], dtype=object)
        lmks = np.asarray([read_landmarks(zf, b) for _, b, _ in tqdm.tqdm(files, desc="LMK")])
        roi = np.asarray([roi_from_seg(zf, c) for _, _, c in tqdm.tqdm(files, desc="ROI")])
        w, h = (roi[:, 2:] - roi[:, :2]).T
        ok = (w > 32) & (h > 32)
        lmks, roi, names = lmks[ok], roi[ok], names[ok]
        # Drop the two pupil points and pad z with zeros.
        pts = np.concatenate([lmks[:, :68, :], np.zeros((lmks.shape[0], 68, 1))], axis=-1).astype(np.float32)

        with h5py.File(args.destination, "w") as f:
            create_pose_dataset(f, C.points, "pt3d_68", data=pts, dtype=np.float32)
            create_pose_dataset(f, C.roi, data=roi, dtype=np.float32)
            ds_img = create_pose_dataset(f, C.image, count=len(names), lossy=True)
            for i, name in tqdm.tqdm(list(enumerate(names)), desc="IMG"):
                ds_img[i] = imencode(imdecode(zf.read(name), color=True), quality=95)
    print(f"Wrote {len(names)} samples to {args.destination}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
