"""Large-pose dataset synthesis from offline face-model fits (counterpart of
the JAX package's `scripts/create_largepose_dataset.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.create_largepose_dataset FITTED.h5 OUT.h5 \\
        [--fit-group 2dfit_v3] [--min-diameter 196] [--bad-frames F | --good-frames F] [--detect-one-face] \\
        [--angle-step 5] [--prob-closed-eyes 0.5] [--prob-spotlight 0.001] [--seed 12345678] \\
        [--jpg-quality 95] [-n N]

The generation halves of the reference's large-pose notebooks: select the
well-fitted frames, promote the offline fit group (written by
`fit_face_model`, default `2dfit_v3`) to top-level pose fields, and expand
every remaining frame into a fan of large-pose renders through the external
`face3drotationaugmentation` package. The interactive curation becomes
`--bad-frames` / `--good-frames` index files (a JSON list or whitespace or
comma separated text); the MTCNN single-face pre-filter is behind
`--detect-one-face` (the external `facenet_pytorch` package, on the CPU as
in the JAX script), stored as `has_one_face` in the input file and reused;
the small-face exclusion is `--min-diameter`. Without the external packages
the script exits with a message that names them. Host only: h5py, PIL and
scipy are imported inside the functions.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

# Promotion map of the notebooks: flat pose fields for the augmentation
# input are taken from the offline fit, images/rois pass through.
FIT_FIELD_MAP = (
    ("images", "images"),
    ("rois", "rois"),
    ("{fit}/quats", "quats"),
    ("{fit}/coords", "coords"),
    ("{fit}/pt3d_68", "pt3d_68"),
    ("{fit}/shapeparams", "shapeparams"),
)


def detect_single_faces(filename: str) -> np.ndarray:
    """MTCNN pass marking frames that contain exactly one detectable face;
    result is stored as a boolean `has_one_face` dataset in the file."""
    try:
        from facenet_pytorch import MTCNN
    except ImportError as e:
        raise SystemExit(
            "--detect-one-face requires the `facenet_pytorch` package "
            f"(not part of the baked environment). Import failed: {e}"
        )
    import h5py
    import tqdm
    from PIL import Image

    from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset

    mtcnn = MTCNN(keep_all=True, device="cpu", min_face_size=32)
    ds = Hdf5PoseDataset(filename, monochrome=False, whitelist=["/images"])
    mask = np.zeros((len(ds),), dtype="?")
    for i in tqdm.trange(len(ds)):
        image = np.asarray(ds[i]["image"])
        if image.ndim == 3 and image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        _, probs = mtcnn.detect(Image.fromarray(image))
        mask[i] = probs is not None and len(probs) == 1
    ds.close()
    with h5py.File(filename, "r+") as f:
        out = f.require_dataset("has_one_face", shape=mask.shape, dtype=mask.dtype)
        out[...] = mask
    print(f"has_one_face: {np.count_nonzero(mask)}/{len(mask)} frames")
    return mask


def load_index_file(path: str) -> np.ndarray:
    """Frame indices from a JSON list or comma/whitespace-separated text."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return np.zeros((0,), dtype=np.int64)
    if text.lstrip().startswith("["):
        values = json.loads(text)
    else:
        values = [tok for tok in text.replace(",", " ").split() if tok]
    return np.asarray(sorted(set(int(v) for v in values)), dtype=np.int64)


def select_good_frames(f, min_diameter: float, bad_frames=None) -> np.ndarray:
    """The notebooks' selection: exactly one face (when the MTCNN field is
    present), roi diagonal >= min_diameter, minus the curated bad set."""
    n = f["images"].shape[0] if "images" in f else f["rois"].shape[0]
    mask = np.ones((n,), dtype=bool)
    if "has_one_face" in f:
        mask &= np.asarray(f["has_one_face"][...], dtype=bool)
    if min_diameter > 0.0:
        rois = np.asarray(f["rois"][...], dtype=np.float64)
        diameters = np.linalg.norm(rois[:, [2, 3]] - rois[:, [0, 1]], axis=-1)
        mask &= diameters >= min_diameter
    good = np.nonzero(mask)[0]
    if bad_frames is not None and len(bad_frames):
        good = np.setdiff1d(good, bad_frames)
    return good


def promote_and_filter(input_filename: str, filtered_filename: str, fit_group: str,
                       good_indices: np.ndarray) -> None:
    """Copy images/rois + the fit group's pose fields into a flat file and
    keep only the selected frames (`filter_file_by_frames`)."""
    import h5py

    from neuralnet_tracker_traincode_torch.scripts.filter_dataset import filter_file_by_frames

    unfiltered = filtered_filename + ".unfiltered"
    with h5py.File(input_filename, "r") as f_in, h5py.File(unfiltered, "w") as f_out:
        for src_tpl, dst in FIT_FIELD_MAP:
            src = src_tpl.format(fit=fit_group)
            if src not in f_in:
                raise SystemExit(
                    f"{input_filename} has no '{src}' dataset — run "
                    "fit_face_model first to produce the fit group."
                )
            f_in.copy(src, f_out, dst)
    try:
        with h5py.File(unfiltered, "r") as f_out, h5py.File(filtered_filename, "w") as f_flt:
            filter_file_by_frames(f_out, f_flt, good_frame_indices=good_indices)
    finally:
        os.unlink(unfiltered)


def as_rotaug_sample(sample) -> dict:
    """Map a pose sample to the augmentation package's input convention
    (scipy Rotation + split xy/scale), as the notebooks' `as_rotaug_sample`."""
    from scipy.spatial.transform import Rotation

    fields = dict(sample)
    fields.pop("coord_convention_id", None)  # framework-internal key
    fields["rot"] = Rotation.from_quat(np.asarray(fields.pop("pose"), dtype=np.float64))
    xys = np.asarray(fields.pop("coord"))
    fields["xy"] = xys[:2]
    fields["scale"] = xys[2]
    image = np.asarray(fields.pop("image"))
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    fields["image"] = image
    return fields


def generate(filtered_filename: str, output_filename: str, *, angle_step: float,
             prob_closed_eyes: float, prob_spotlight: float, seed: int,
             jpg_quality: int, max_num_frames: int) -> int:
    try:
        import face3drotationaugmentation
    except ImportError as e:
        raise SystemExit(
            "This script requires the `face3drotationaugmentation` package "
            "(github.com/DaWelter/face-3d-rotation-augmentation). "
            f"Import failed: {e}"
        )
    import tqdm

    from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset

    rng = np.random.RandomState(seed=seed)
    ds = Hdf5PoseDataset(filtered_filename, monochrome=False)
    num_frames = min(len(ds), max_num_frames)
    with face3drotationaugmentation.dataset_writer(output_filename) as writer:
        writer.jpgquality = jpg_quality
        for i in tqdm.trange(num_frames):
            sample = as_rotaug_sample(ds[i])
            generated = face3drotationaugmentation.augment_sample(
                rng=rng,
                angle_step=angle_step,
                prob_closed_eyes=prob_closed_eyes,
                prob_spotlight=prob_spotlight,
                sample=sample,
            )
            name = f"sample{i:02d}"
            for new_sample in generated:
                writer.write(name, new_sample)
    ds.close()
    return num_frames


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("input", help="fitted dataset .h5 (images, rois + fit group)")
    parser.add_argument("output", help="augmented output .h5")
    parser.add_argument("--fit-group", default="2dfit_v3",
                        help="fit group written by fit_face_model.py")
    parser.add_argument("--min-diameter", type=float, default=196.0,
                        help="exclude frames whose roi diagonal is smaller")
    parser.add_argument("--bad-frames", default=None,
                        help="index file of curated bad frames to exclude")
    parser.add_argument("--good-frames", default=None,
                        help="index file overriding the frame selection entirely")
    parser.add_argument("--detect-one-face", action="store_true",
                        help="run the MTCNN single-face pre-filter first "
                             "(requires facenet_pytorch)")
    parser.add_argument("--angle-step", type=float, default=5.0)
    parser.add_argument("--prob-closed-eyes", type=float, default=0.5)
    parser.add_argument("--prob-spotlight", type=float, default=0.001)
    parser.add_argument("--seed", type=int, default=12345678)
    parser.add_argument("--jpg-quality", type=int, default=95)
    parser.add_argument("-n", "--max-num-frames", type=int, default=1 << 32)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.output.lower().endswith((".h5", ".hdf5")):
        raise SystemExit("output must have an hdf5 extension")

    import h5py

    if args.detect_one_face:
        detect_single_faces(args.input)

    if args.good_frames is not None:
        good = load_index_file(args.good_frames)
    else:
        bad = load_index_file(args.bad_frames) if args.bad_frames else None
        with h5py.File(args.input, "r") as f:
            good = select_good_frames(f, args.min_diameter, bad)
    if len(good) == 0:
        raise SystemExit("Frame selection is empty — nothing to augment.")
    print(f"Selected {len(good)} frames for augmentation")

    filtered = args.output + ".selected"
    promote_and_filter(args.input, filtered, args.fit_group, good)
    try:
        n = generate(
            filtered,
            args.output,
            angle_step=args.angle_step,
            prob_closed_eyes=args.prob_closed_eyes,
            prob_spotlight=args.prob_spotlight,
            seed=args.seed,
            jpg_quality=args.jpg_quality,
            max_num_frames=args.max_num_frames,
        )
    finally:
        if os.path.isfile(filtered):
            os.unlink(filtered)
    print(f"Augmented {n} frames into {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
