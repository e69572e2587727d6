"""Convert the Biwi Kinect head pose database to the pose HDF5 schema
(counterpart of the JAX package's `scripts/dsprocess_biwi.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_biwi biwi.zip [DEST.h5] [-n COUNT] \\
        [--opal-annotation biwi_ann.txt | --localizer LOCALIZER.ckpt] [--device cpu]

The FSA-Net evaluation protocol with the reference's deliberate
differences: camera-matrix projection, aspect-preserving crops,
head-center-guided box selection, and optional `--opal-annotation` boxes
(github.com/pcr-upm/opal23_headpose) for reproducible comparisons. Boxes are
refined by a LocalizerNet (`--localizer`, run on `--device`: the card
unless `cpu` is given). h5py, pandas and scipy are imported inside the
functions.
"""

import argparse
import io
import math
import re
import sys
from collections import defaultdict
from os.path import splitext
from typing import Dict, List, Optional, Sequence, Tuple
from zipfile import ZipFile

import numpy as np

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import imdecode

PROJ_FOV = 65.0
HEAD_SIZE_MM = 100.0
PREFIX1 = "faces_0/"
PREFIX2 = "kinect_head_pose_db/"

# Head-center offset in the local frame (eye measure; rotation-invariant so it
# does not affect the benchmarks).
LOCAL_HEAD_OFFSET = np.array([0.03, -0.35, -0.2])


def get_pose_from_mat(f):
    from scipy.spatial.transform import Rotation

    lines = f.readlines()
    matrix = np.array([[*map(float, row.split(" ")[:3])] for row in lines[:3]])
    pos = np.array([*map(float, lines[4].split(" ")[:3])])
    return Rotation.from_matrix(matrix), pos


def get_camera_extrinsics(zf: ZipFile, fn):
    from scipy.spatial.transform import Rotation

    lines = io.StringIO(zf.read(fn).decode("ascii")).readlines()
    m1, m2, m3 = lines[6:9]
    pos = lines[10]
    matrix = np.array([[*map(float, row.split(" ")[:3])] for row in [m1, m2, m3]])
    return Rotation.from_matrix(matrix), np.array([*map(float, pos.split(" ")[:3])])


class PinholeCam:
    def __init__(self, fov, w, h):
        self.f = 1.0 / math.tan(fov * np.pi / 180.0 * 0.5)
        self.w, self.h = w, h
        self.aspect = w / h

    def project_to_image(self, p):
        x, y, z = p
        xs = self.f * x / z
        ys = self.f * y / z * self.aspect
        return (xs + 1.0) * 0.5 * self.w, (ys + 1.0) * 0.5 * self.h

    def project_size_to_image(self, depth, scale):
        return self.w * (self.f * scale / depth) * 0.5


def find_image_file_names(filelist: Sequence[str]) -> Dict[int, list]:
    regex = re.compile(PREFIX1 + r"(\d\d)/frame_(\d\d\d\d\d)_rgb.png")
    samples = defaultdict(list)
    for f in filelist:
        m = regex.match(f)
        if m:
            samples[int(m.group(1))].append((m.group(2), f))
    return {k: [fn for _, fn in sorted(v)] for k, v in samples.items()}


def find_cal_files(zf: ZipFile) -> Dict[int, str]:
    regex = re.compile(PREFIX1 + r"(\d\d)/rgb.cal")
    return {int(m.group(1)): f.orig_filename for f in zf.filelist if (m := regex.match(f.orig_filename))}


def read_data(zf, imagefile, cam_extrinsics_inv, refiner, box_annotation) -> Tuple[dict, bool]:
    posefile = imagefile[: -len("_rgb.png")] + "_pose.txt"
    imgbuffer = zf.read(imagefile)
    img = imdecode(imgbuffer, True)
    h, w, _ = img.shape

    with io.StringIO(zf.read(posefile).decode("ascii")) as f:
        rot, pos = get_pose_from_mat(f)
    rot, pos = utils.affine3d_chain(cam_extrinsics_inv, (rot, pos))

    cam = PinholeCam(PROJ_FOV, w, h)
    x, y = cam.project_to_image(pos)
    size = cam.project_size_to_image(pos[2], HEAD_SIZE_MM)

    if box_annotation is not None:
        roi = np.asarray(box_annotation, np.float64)
        ok = True
    else:
        roi = np.array([x - size, y - size, x + size, y + size])
        ok = True
        if refiner is not None:
            roi, ok = refiner(img, roi, iou_threshold=0.01)
            if not ok:
                print(f"WARNING: no detection overlapping the projected head. Frame {imagefile}.")

    offset = rot.apply(LOCAL_HEAD_OFFSET) * size
    return {
        "pose": rot.as_quat(),
        "coord": np.array([x + offset[0], y + offset[1], size]),
        "roi": roi,
        "image": img,
    }, ok


def generate_hdf5_dataset(source_file, outfilename, opal_annotation, localizer, count=None, device="cuda"):
    import h5py
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    refiner = None
    box_annotations = None
    sequence_frames = None
    if opal_annotation:
        import pandas

        dataframe = pandas.read_csv(opal_annotation, header=0, sep=";")
        dataframe.columns = dataframe.columns[1:].append(pandas.Index(["dummy"]))
        filelist = [f.replace(PREFIX2, PREFIX1) for f in dataframe["image"].values.tolist()]
        boxes = dataframe[list("tl_x;tl_y;br_x;br_y".split(";"))].values.tolist()
        box_annotations = dict(zip(filelist, boxes))
        sequence_frames = find_image_file_names(filelist)
        assert sum(len(v) for v in sequence_frames.values()) == len(filelist)
    elif localizer:
        from neuralnet_tracker_traincode_torch.scripts.dsprocess_lapa import LocalizerRoiRefiner

        refiner = LocalizerRoiRefiner(localizer, device)

    with ZipFile(source_file, "r") as zf:
        calibration = {k: get_camera_extrinsics(zf, fn) for k, fn in find_cal_files(zf).items()}
        for ident, (rot, _) in calibration.items():
            assert np.allclose(rot.as_matrix(), np.eye(3), atol=0.04), (
                f"Extrinsic rotation of {ident} far from identity"
            )
        if sequence_frames is None:
            sequence_frames = find_image_file_names([f.orig_filename for f in zf.filelist])
        if count:
            sequence_frames = {k: v[:count] for k, v in sequence_frames.items()}
        max_num_frames = sum(len(v) for v in sequence_frames.values())
        print("Found videos (id, length):", [(k, len(v)) for k, v in sequence_frames.items()])

        with h5py.File(outfilename, "w") as f:
            # create_pose_dataset sets maxshape=shape, so shrinking to the
            # number of good frames below is allowed.
            ds_img = create_pose_dataset(f, C.image, count=max_num_frames)
            ds_roi = create_pose_dataset(f, C.roi, count=max_num_frames, dtype=np.float32)
            ds_quats = create_pose_dataset(f, C.quat, count=max_num_frames, dtype=np.float32)
            ds_coords = create_pose_dataset(f, C.xys, count=max_num_frames, dtype=np.float32)
            i = 0
            sequence_starts = [0]
            with tqdm.tqdm(total=max_num_frames) as bar:
                for ident, frames in sequence_frames.items():
                    for fn in frames:
                        sample, ok = read_data(
                            zf, fn, calibration[ident], refiner,
                            box_annotations[fn] if box_annotations else None,
                        )
                        if ok:
                            ds_img[i] = sample["image"]  # RGB (imdecode converts)
                            ds_quats[i] = sample["pose"]
                            ds_coords[i] = sample["coord"]
                            ds_roi[i] = sample["roi"]
                            i += 1
                        bar.update(1)
                    assert i != sequence_starts[-1], "Each sequence needs one good frame"
                    sequence_starts.append(i)
            for ds in [ds_img, ds_roi, ds_quats, ds_coords]:
                ds.resize(i, axis=0)
            f.create_dataset("sequence_starts", data=sequence_starts)
    print(f"Wrote {i} of {max_num_frames} frames to {outfilename}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert Biwi")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str, nargs="?", default=None)
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--opal-annotation", type=str, nargs="?", default=None)
    parser.add_argument("--localizer", type=str, default=None)
    parser.add_argument("--device", default="cuda", help="where the localizer runs: cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dst = args.destination or splitext(args.source)[0] + ".h5"
    generate_hdf5_dataset(args.source, dst, args.opal_annotation, args.localizer, args.count, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
