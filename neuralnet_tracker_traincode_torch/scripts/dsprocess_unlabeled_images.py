"""Build an unlabeled-sequence HDF5 file (images and detected ROIs) from
image files (counterpart of the JAX package's
`scripts/dsprocess_unlabeled_images.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_unlabeled_images SOURCE_DIR DEST.h5 \\
        [--localizer LOCALIZER.ckpt] [-n COUNT] [--device cpu]

Frames named <prefix><number>.<ext> are grouped into sequences by prefix,
face boxes are detected by a LocalizerNet (`--localizer`, run on `--device`:
the card unless `cpu` is given; without it, or without a detection, the
whole frame), and every frame of a sequence is cropped to the union of its
boxes. For the pseudo-labeling pipeline. h5py and PIL are imported inside
the functions.
"""

import argparse
import os
import re
import sys
from collections import defaultdict
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.scripts.dsprocess_wflw import apply_crop_trafo_roi, cropped


class SampleFile(NamedTuple):
    filename: Path
    ident: Optional[str]
    number: Optional[int]


def detect_box(refiner, image):
    if refiner is None:
        return None, "no detector"
    img = np.asarray(image.convert("RGB"))
    full = np.asarray([0.0, 0.0, image.width, image.height], np.float32)
    box, ok = refiner(img, full, iou_threshold=-1.0)  # accept any detection
    return (box if ok else None), ("" if ok else "no face detected")


def convert_unlabeled_sequences(directory: Path, outputfile, refiner, max_sample_count):
    import h5py
    import tqdm
    from PIL import Image

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    regex = re.compile(r"(.+?)(\d+)\.(jpg|png|jpeg|bmp)")

    def make_sample(filename):
        m = regex.match(filename)
        if m is None:
            return SampleFile(directory / filename, None, None)
        return SampleFile(directory / filename, m.group(1), int(m.group(2)))

    sample_files = [make_sample(fn) for fn in os.listdir(directory)]
    sample_files = [x for x in sample_files if x.number is not None]
    sample_files = sorted(sample_files, key=lambda x: (x.ident, x.number))
    if max_sample_count is not None:
        sample_files = sample_files[:max_sample_count]

    by_ident = defaultdict(list)
    for sf in sample_files:
        by_ident[sf.ident].append(sf)

    sequence_starts = np.cumsum([0] + [len(v) for v in by_ident.values()])
    N = int(sequence_starts[-1])
    print(f"Found {len(sequence_starts) - 1} sequences, {N} frames.")

    with h5py.File(outputfile, "w") as f:
        f.create_dataset("sequence_starts", data=sequence_starts)
        ds_roi = create_pose_dataset(f, C.roi, count=N, dtype=np.float16)
        ds_img = create_pose_dataset(f, C.image, count=N)
        i = 0
        for ident, files in tqdm.tqdm(by_ident.items(), postfix="Sequence"):
            boxes, images = [], []
            for sf in files:
                image = Image.open(sf.filename)
                if image.width > 720 and image.height > 720:
                    image.thumbnail((640, 640), Image.Resampling.HAMMING)
                box, error = detect_box(refiner, image)
                if box is None:
                    box = (0, 0, image.width, image.height)
                if error:
                    print(f"Detection issue {sf.filename}: {error}")
                images.append(image.convert("RGB"))
                boxes.append(np.asarray(box, np.float32))
            boxes = np.asarray(boxes)
            combined = np.concatenate([np.amin(boxes[:, :2], axis=0), np.amax(boxes[:, 2:], axis=0)])
            for img, box in zip(images, boxes):
                img_arr, trafo = cropped(
                    np.asarray(img), combined, desired_roi_size=224,
                    padding_factor=0.25, abs_padding=10,
                )
                ds_img[i] = img_arr
                ds_roi[i] = apply_crop_trafo_roi(box, trafo)
                i += 1
    print(f"Wrote {i} frames to {outputfile}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert unlabeled image sequences")
    parser.add_argument("source", type=str)
    parser.add_argument("destination", type=str)
    parser.add_argument("--localizer", default=None, help="LocalizerNet checkpoint")
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="where the localizer runs: cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    refiner = None
    if args.localizer:
        from neuralnet_tracker_traincode_torch.scripts.dsprocess_lapa import LocalizerRoiRefiner

        refiner = LocalizerRoiRefiner(args.localizer, args.device)
    convert_unlabeled_sequences(Path(args.source), args.destination, refiner, args.count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
