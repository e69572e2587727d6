"""Convert WIDER FACE to single-face localizer training crops (counterpart
of the JAX package's `scripts/dsprocess_widerface.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.dsprocess_widerface WIDER_DIR [DEST.h5] \\
        [-n COUNT] [--maxsize 640]

Single-face images only; for each, one face crop (the face a random 10-33%
of the width at 4:3) and one face-free background crop, shuffled, with
`hasface` flags and boxes; images capped at `--maxsize`. Host only: h5py
and cv2 are imported inside the functions.
"""

import argparse
import itertools
import sys
import zipfile
from collections import namedtuple
from os.path import join
from typing import List, Optional, Union

import numpy as np

from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
from neuralnet_tracker_traincode_torch.data.preprocessing import imdecode

Annotation = namedtuple("Annotation", "filename boxes")


class WiderFace:
    """Reads the WIDER FACE zips and the box annotation list."""

    def __init__(self, root_dir, validation):
        self.root_dir = root_dir
        self.validation = validation
        self.subset = "wider_face_val_bbx_gt.txt" if validation else "wider_face_train_bbx_gt.txt"
        self.annotation_file = join(root_dir, "wider_face_split.zip")
        self.image_zip = zipfile.ZipFile(join(root_dir, "WIDER_val.zip" if validation else "WIDER_train.zip"))
        self.annotations = self._read_annotation()

    def _read_annotation(self):
        imagenames = frozenset(f.filename for f in self.image_zip.filelist if not f.is_dir())
        with zipfile.ZipFile(self.annotation_file) as zf:
            lines = zf.read("wider_face_split/" + self.subset).decode("ascii").splitlines()
        annos = []
        it = iter(lines)
        prefix = "WIDER_" + ("val" if self.validation else "train") + "/images/"
        for fn in it:
            fn = prefix + fn
            numboxes = int(next(it))
            boxes = []
            for _ in range(max(1, numboxes)):  # a 0-count still has one placeholder line
                parts = next(it).split()
                x0, y0, w, h = map(int, parts[:4])
                if w and h:
                    boxes.append((x0, y0, x0 + w, y0 + h))
            if fn in imagenames and numboxes > 0:
                annos.append(Annotation(fn, boxes))
        return annos

    def image(self, a: Union[Annotation, int]):
        if isinstance(a, int):
            a = self.annotations[a]
        return imdecode(self.image_zip.read(a.filename), "rgb")

    def close(self):
        if self.image_zip is not None:
            self.image_zip.close()
            self.image_zip = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def face_crop(imgshape, box, target_aspect, target_face_size_frac, rnd):
    """Random crop containing the face at the requested size fraction."""
    x0, y0, x1, y1 = box
    h, w, _ = imgshape
    crop_w = min(w, (x1 - x0) / target_face_size_frac)
    crop_h = crop_w / target_aspect
    if crop_h > h:
        crop_w *= h / crop_h
        crop_h = h
    xmax = x0 - max(0, x0 + crop_w - w)
    xmin = x1 - crop_w - min(0, x1 - crop_w)
    ymax = y0 - max(0, y0 + crop_h - h)
    ymin = y1 - crop_h - min(0, y1 - crop_h)
    rx, ry = rnd.uniform(0.0, 1.0, size=2)
    xc = xmin + rx * (xmax - xmin)
    yc = ymin + ry * (ymax - ymin)
    return (xc, yc, xc + crop_w, yc + crop_h)


def no_face_crop(imgshape, box, aspect, rnd):
    """Background crop beside the face box (the wider free side)."""
    h, w, _ = imgshape
    x0, y0, x1, y1 = box
    if x0 < w - x1:
        u0, u1 = x1, w
    else:
        u0, u1 = 0, x0
    dv = (u1 - u0) / aspect
    if dv > h:
        du = h * aspect
        u0 = u0 + rnd.randint(0, max(0, int(u1 - u0 - du)) + 1)
        u1 = u0 + du
        dv = h
    r = rnd.randint(0, int(h - dv) + 1)
    return (u0, r, u1, r + dv)


class SingleWiderFaces:
    def __init__(self, root, validation, max_image_size=640):
        self.rnd = np.random.RandomState(seed=123)
        self.validation = validation
        self.root = root
        self.maxsize = max_image_size
        with WiderFace(root, validation) as wf:
            self.singleface_annos = [a for a in wf.annotations if len(a.boxes) == 1]

    def __len__(self):
        return len(self.singleface_annos) * 2

    def _cropimg(self, img, cropbox, box):
        h, w, _ = img.shape
        x0, y0, x1, y1 = map(int, cropbox)
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w, x1), min(h, y1)
        img = img[y0:y1, x0:x1, ...]
        u0, v0, u1, v1 = box
        return img, (u0 - x0, v0 - y0, u1 - x0, v1 - y0)

    def _maybe_scale(self, img, box):
        import cv2

        h, w, _ = img.shape
        if max(h, w) > self.maxsize:
            f = self.maxsize / max(h, w)
            img = cv2.resize(img, (round(w * f), round(h * f)), interpolation=cv2.INTER_AREA)
            box = tuple(v * f for v in box)
        return img, box

    @staticmethod
    def _box_for_noface(img):
        h, w, _ = img.shape
        return (w // 4, h // 4, w * 3 // 4, h * 3 // 4)

    def _make_sample(self, img, cropbox, box, hasface):
        img, box = self._cropimg(img, cropbox, box)
        img, box = self._maybe_scale(img, box)
        return {
            "image": np.ascontiguousarray(img),
            "roi": np.asarray(box if hasface else self._box_for_noface(img), np.float32),
            "hasface": hasface,
        }

    def __iter__(self):
        with WiderFace(self.root, self.validation) as wf:
            for a in self.singleface_annos:
                box = a.boxes[0]
                img = wf.image(a)
                size_frac = self.rnd.uniform(0.1, 0.33)
                fcrop = face_crop(img.shape, box, 4.0 / 3.0, size_frac, self.rnd)
                ecrop = no_face_crop(img.shape, box, 4.0 / 3.0, self.rnd)
                yield self._make_sample(img, fcrop, box, True)
                yield self._make_sample(img, ecrop, box, False)


def generate_hdf5_dataset(source_dir, outfilename, count, maxsize):
    import h5py
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    wfval = SingleWiderFaces(source_dir, validation=True, max_image_size=maxsize)
    wftrain = SingleWiderFaces(source_dir, validation=False, max_image_size=maxsize)
    N = len(wftrain) + len(wfval)
    if count is not None:
        N = min(count, N)
    with h5py.File(outfilename, "w") as f:
        ds_img = create_pose_dataset(f, C.image, count=N)
        ds_roi = create_pose_dataset(f, C.roi, count=N, dtype=np.float32)
        ds_hasface = create_pose_dataset(f, C.general, name="hasface", count=N, dtype="?")
        indices = np.random.RandomState(seed=42).permutation(N)
        with tqdm.tqdm(total=N) as bar:
            for i, sample in zip(indices, itertools.chain(wftrain, wfval)):
                ds_img[i] = sample["image"]
                ds_roi[i] = sample["roi"]
                ds_hasface[i] = sample["hasface"]
                bar.update(1)
    print(f"Wrote {N} localizer crops to {outfilename}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Convert WIDER FACE")
    parser.add_argument("source", help="directory with the WIDER zips", type=str)
    parser.add_argument("destination", type=str, nargs="?", default=None)
    parser.add_argument("-n", dest="count", type=int, default=None)
    parser.add_argument("--maxsize", type=int, default=640)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dst = args.destination or args.source + ".h5"
    generate_hdf5_dataset(args.source, dst, args.count, args.maxsize)
    return 0


if __name__ == "__main__":
    sys.exit(main())
