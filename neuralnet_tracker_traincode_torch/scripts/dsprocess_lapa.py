"""Convert the LaPa dataset (106-point annotations) to the pose HDF5 schema
(counterpart of the JAX package's `scripts/dsprocess_lapa.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_lapa SOURCE_DIR DEST.h5 \\
        [--only-megaface] [--localizer LOCALIZER.ckpt] [-n COUNT] [--device cpu]

106 -> 68 landmark conversion with quadratic chin re-interpolation, the ROI
from the landmarks, optionally refined by a LocalizerNet checkpoint
(`--localizer`, a file of either package), downscaled and cropped storage.
Beware: the images intersect with 300W-LP and Megaface.

`LocalizerRoiRefiner` runs the network on `--device` (the card unless
`cpu` is given), one image a call as in the JAX package; the resize and
the normalisation stay on the host. The 300-VW, Biwi and unlabeled-image
converters use it too. h5py, cv2 and scipy are imported inside the
functions.
"""

import argparse
import re
import sys
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import box_iou, imdecode, imencode
from neuralnet_tracker_traincode_torch.device import DeviceLike
from neuralnet_tracker_traincode_torch.scripts.dsprocess_wflw import (
    apply_crop_trafo_points,
    apply_crop_trafo_roi,
    cropped,
)


class DatasetInfo(NamedTuple):
    imagedir: Path
    lmkdir: Path
    itemnames: List[str]


def discover_items(source_dir) -> DatasetInfo:
    root = Path(source_dir) / "train" / "images"
    items = sorted(p.relative_to(root).stem for p in Path.glob(root, "*.jpg"))
    return DatasetInfo(root, Path(source_dir) / "train" / "landmarks", items)


def filter_megaface(info: DatasetInfo) -> DatasetInfo:
    # Megaface files carry purely numeric names.
    regex = re.compile(r"^(\d|\_)+$")
    return info._replace(itemnames=[x for x in info.itemnames if regex.match(x)])


def read_annotation(f) -> np.ndarray:
    lines = f.readlines()
    assert lines[0].strip() == "106"
    lines = lines[1:]
    assert len(lines) == 106
    return np.asarray([[float(s) for s in l.split()] for l in lines], np.float32)


def cvt_landmarks_68pt(lmk: np.ndarray, improved_chin=True) -> np.ndarray:
    """(106, 2) LaPa landmarks -> (68, 2) iBUG landmarks."""
    from scipy.interpolate import interp1d

    lmk = lmk.swapaxes(-1, -2)
    assert lmk.shape == (2, 106)
    if not improved_chin:
        chin = lmk[..., :33:2]
    else:
        # LaPa's chin endpoints start above the eyes; clip the contour ends and
        # re-interpolate to 17 points.
        xs = np.linspace(0.0, 32.0, 33)
        chin = interp1d(xs, lmk[..., :33], kind="quadratic", axis=-1, fill_value="extrapolate")(
            np.linspace(1.5, 32.0 - 1.5, 17)
        )
    assert chin.shape == (2, 17)
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
            rng(51, 55),  # nose back
            rng(57), avg((58, 59)), rng(60), avg((61, 62)), rng(63),  # nose bottom
            rng(66), avg((67, 68), (68, 69)), rng(70), avg((71, 72), (72, 73)),  # left eye
            rng(75), avg((76, 77), (77, 78)), rng(79), avg((80, 81), (81, 82)),  # right eye
            rng(84, 104),  # mouth
        ],
        axis=-1,
    )
    lmk68 = lmk68.swapaxes(-1, -2)
    assert lmk68.shape[-2:] == (68, 2), f"Bad shape {lmk68.shape}"
    return lmk68


def poor_mans_roi(points: np.ndarray) -> np.ndarray:
    x0, y0 = np.amin(points, axis=0)
    x1, y1 = np.amax(points, axis=0)
    return np.asarray([x0, y0, x1, y1], np.float32)


class LocalizerRoiRefiner:
    """Refine landmark-derived ROIs with a LocalizerNet checkpoint, run in f32
    on `device` (default: the card)."""

    def __init__(self, checkpoint: str, device: DeviceLike = None):
        import torch

        from neuralnet_tracker_traincode_torch.device import resolve_device
        from neuralnet_tracker_traincode_torch.models import io as model_io
        from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

        self.device = resolve_device(device)
        model = model_io.load_model(checkpoint, [LocalizerNet])
        model.dtype = torch.float32
        self.model = model.to(self.device)

    @staticmethod
    def network_input(img) -> np.ndarray:
        """(1, 224, 288, 1) f32: the grayscale image resized by area and
        whitened, on the host."""
        import cv2

        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
        inp = cv2.resize(gray, (288, 224), interpolation=cv2.INTER_AREA)
        return np.asarray(inp[None, :, :, None], np.float32) / np.float32(256.0) - np.float32(0.5)

    def predict(self, img) -> Tuple[float, np.ndarray]:
        """(hasface probability, box in [-1, 1] crop units (4,)) of one image."""
        import torch

        from neuralnet_tracker_traincode_torch.eval.predictor import f32_eval
        from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

        x = torch.from_numpy(self.network_input(img)).to(self.device)
        with torch.inference_mode(), f32_eval(self.device):
            out = LocalizerNet.inference_outputs(self.model(x))
            hasface, box = out["hasface"][0].cpu(), out["roi"][0].cpu()
        return float(hasface), box.numpy()

    def __call__(self, img, roi, iou_threshold=0.25):
        """(refined ROI, True), or (`roi`, False) where the network sees no
        face or its box overlaps `roi` by no more than `iou_threshold`."""
        return self.refine(img.shape[:2], roi, *self.predict(img), iou_threshold=iou_threshold)

    @staticmethod
    def refine(hw, roi, hasface: float, box: np.ndarray, iou_threshold=0.25):
        """`__call__`'s decision on a prediction `predict` made for an image
        of size `hw`."""
        h, w = hw
        if hasface < 0.5:
            return roi, False
        # [-1, 1] -> pixels of the original image
        new_roi = np.asarray(
            [
                (box[0] + 1) * 0.5 * w, (box[1] + 1) * 0.5 * h,
                (box[2] + 1) * 0.5 * w, (box[3] + 1) * 0.5 * h,
            ],
            np.float32,
        )
        iou = float(box_iou(roi[None], new_roi[None])[0, 0])
        if iou > iou_threshold:
            return new_roi, True
        return roi, False


def do_conversion(source_dir, f, max_count, only_megaface, refiner: Optional[LocalizerRoiRefiner]):
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    info = discover_items(source_dir)
    if only_megaface:
        info = filter_megaface(info)
    if max_count is not None:
        info = info._replace(itemnames=info.itemnames[:max_count])
    N = len(info.itemnames)
    ds_img = create_pose_dataset(f, C.image, count=N)
    pt2ds, rois = [], []
    for i, name in enumerate(tqdm.tqdm(info.itemnames)):
        with open(info.imagedir / (name + ".jpg"), "rb") as fi:
            rawjpg = fi.read()
        img = imdecode(rawjpg, "rgb")
        with open(info.lmkdir / (name + ".txt"), "r") as fl:
            lmk106 = read_annotation(fl)
        roi = poor_mans_roi(lmk106)
        if refiner is not None:
            roi, _ = refiner(img, roi)
        points = cvt_landmarks_68pt(lmk106)
        img, trafo = cropped(img, roi, desired_roi_size=224, padding_factor=0.5, abs_padding=10)
        pt2ds.append(apply_crop_trafo_points(points, trafo))
        rois.append(apply_crop_trafo_roi(roi, trafo))
        ds_img[i] = imencode(img, quality=95)
    create_pose_dataset(f, C.points, "pt2d_68", data=np.asarray(pt2ds, np.float32), dtype="f2")
    create_pose_dataset(f, C.roi, data=np.asarray(rois, np.float32), dtype="f2")
    print(f"Wrote {N} samples")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert LaPa")
    parser.add_argument("source", help="source dir", type=str)
    parser.add_argument("destination", help="destination file", type=str)
    parser.add_argument("--only-megaface", default=False, action="store_true")
    parser.add_argument("--localizer", default=None, help="LocalizerNet checkpoint for roi refinement")
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="where the localizer runs: cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import h5py

    refiner = LocalizerRoiRefiner(args.localizer, args.device) if args.localizer else None
    with h5py.File(args.destination, "w") as f:
        do_conversion(args.source, f, args.count, args.only_megaface, refiner)
    return 0


if __name__ == "__main__":
    sys.exit(main())
