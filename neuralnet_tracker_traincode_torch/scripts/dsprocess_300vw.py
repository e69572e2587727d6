"""Convert 300-VW (videos with per-frame 68-point annotations) to the pose
HDF5 schema (counterpart of the JAX package's `scripts/dsprocess_300vw.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_300vw 300VW.zip DEST.h5 \\
        [--localizer LOCALIZER.ckpt] [-n COUNT] [--device cpu]

Frames decoded from each video's .avi, downscaled and cropped around the ROI
across its frames, stored in grayscale with `sequence_starts` per video; the
ROIs come from the landmarks, optionally refined by a LocalizerNet
(`--localizer`, run on `--device`: the card unless `cpu` is given). h5py and
cv2 are imported inside the functions.
"""

import argparse
import io
import re
import sys
import tempfile
import zipfile
from collections import defaultdict
from dataclasses import dataclass, field
from os.path import join
from typing import List, Optional, Tuple

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import imencode
from neuralnet_tracker_traincode_torch.scripts.dsprocess_wflw import (
    apply_crop_trafo_points,
    apply_crop_trafo_roi,
    cropped,
)


@dataclass
class VideoInfo:
    annot: List[Tuple[int, str]] = field(default_factory=list)
    video: Optional[str] = None


def discover_items(zf):
    match_annotation = re.compile(r".*(\d\d\d)/annot/(\d\d\d\d\d\d)\.pts")
    match_video = re.compile(r".*(\d\d\d)/(.+)\.avi")
    infos = defaultdict(VideoInfo)
    for f in zf.filelist:
        if (m := match_annotation.match(f.filename)) is not None:
            infos[m.group(1)].annot.append((int(m.group(2)), f.filename))
        elif (m := match_video.match(f.filename)) is not None:
            infos[m.group(1)].video = f.filename
    return infos


def read_annotation(f: io.StringIO) -> np.ndarray:
    lines = f.readlines()[3:-1]
    assert len(lines) == 68, "Expected 68 landmarks"
    return np.asarray([[float(s) for s in l.split()] for l in lines])


def iter_annotation_files(zf, vi: VideoInfo):
    for _, fn in sorted(vi.annot, key=lambda x: x[0]):
        yield read_annotation(io.StringIO(zf.read(fn).decode("ascii")))


def iter_frames(zf, vi: VideoInfo):
    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        tmpfilename = join(tmp, "video.avi")
        with open(tmpfilename, "wb") as f:
            f.write(zf.read(vi.video))
        vidcap = cv2.VideoCapture(tmpfilename)
        while True:
            success, image = vidcap.read()
            if not success:
                break
            yield image


def roi_from_points(points: np.ndarray) -> np.ndarray:
    tl = np.amin(points, axis=-2)
    br = np.amax(points, axis=-2)
    return np.concatenate([tl, br], axis=-1)


def process_video(zf, vi: VideoInfo, refiner):
    import cv2

    landmarks = np.asarray(list(iter_annotation_files(zf, vi)), "f4")
    rois = roi_from_points(landmarks)
    roi_across_frames = roi_from_points(landmarks.reshape(-1, 2))

    diag = np.linalg.norm(rois[..., 2:] - rois[..., :2], axis=-1)
    maxlen = np.amax(rois[..., 2:] - rois[..., :2])
    scaling = min(1.0, 129 * 1.5 / maxlen)
    abs_padding = scaling * max(10, float(np.amax(diag)) * 0.5)

    for roi, landmark, img in zip(rois, landmarks, iter_frames(zf, vi)):
        h, w = img.shape[:2]
        myscale = int(w * scaling) / w
        img = cv2.resize(img, (int(w * myscale), int(h * myscale)), interpolation=cv2.INTER_AREA)
        img, trafo = cropped(
            img, myscale * roi_across_frames,
            desired_roi_size=1 << 16,  # disables the downscale branch
            padding_factor=0, abs_padding=abs_padding,
        )
        landmark = apply_crop_trafo_points(myscale * landmark, trafo)
        roi = apply_crop_trafo_roi(myscale * roi, trafo)
        roi_ok = True
        if refiner is not None:
            roi, roi_ok = refiner(img[..., ::-1], roi)  # BGR -> RGB
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        yield img, landmark, roi, roi_ok


def do_conversion(zf, videoinfos, f, refiner, max_count=None):
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    if max_count is not None:
        videoinfos = videoinfos[:max_count]
    sequence_starts = np.cumsum([0] + [len(vi.annot) for vi in videoinfos])
    N = int(sequence_starts[-1])
    ds_img = create_pose_dataset(f, C.image, count=N)
    f.create_dataset("sequence_starts", data=sequence_starts)

    pt2ds_68, rois = [], []
    i = 0
    with tqdm.tqdm(total=N) as bar:
        for vi in videoinfos:
            for frame, points, roi, roi_ok in process_video(zf, vi, refiner):
                if not roi_ok:
                    print(f"face detection failure frame {i}, original {vi.video}")
                pt2ds_68.append(points)
                rois.append(roi)
                ds_img[i] = imencode(frame, quality=95)
                i += 1
                bar.update(1)
    create_pose_dataset(f, C.points, name="pt2d_68", data=np.asarray(pt2ds_68), dtype=np.float16)
    create_pose_dataset(f, C.roi, data=np.asarray(rois), dtype=np.float16)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert 300-VW")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str)
    parser.add_argument("--localizer", default=None, help="LocalizerNet checkpoint for roi refinement")
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="where the localizer runs: cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py

    refiner = None
    if args.localizer:
        from neuralnet_tracker_traincode_torch.scripts.dsprocess_lapa import LocalizerRoiRefiner

        refiner = LocalizerRoiRefiner(args.localizer, args.device)
    with zipfile.ZipFile(args.source) as zf, h5py.File(args.destination, "w") as f:
        do_conversion(zf, list(discover_items(zf).values()), f, refiner, max_count=args.count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
