"""Eye-closing mesh augmentation of AFLW2000-3D (counterpart of the JAX
package's `scripts/create_aflw2k3d_closed_eyes.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.create_aflw2k3d_closed_eyes AFLW2000-3D.zip OUT.h5 \\
        [-n N] [--prob-closed-eyes P]

A thin wrapper over the external `face3drotationaugmentation` package (the
companion mesh augmentation project of the paper), gated on its
availability: without it, `convert` exits with a message that names it.
Host only.
"""

import argparse
import sys
from contextlib import closing
from typing import List, Optional

import numpy as np


def convert(filename, outputfilename, max_num_frames, prob_closed_eyes):
    """The JAX script's `main(filename, outputfilename, max_num_frames,
    prob_closed_eyes)`."""
    try:
        from face3drotationaugmentation.dataset300wlp import DatasetAFLW2k3D
        from face3drotationaugmentation.datasetwriter import dataset_writer
        from face3drotationaugmentation.generate import augment_eyes_only, make_sample_for_passthrough
    except ImportError as e:
        raise SystemExit(
            "This script requires the `face3drotationaugmentation` package "
            "(github.com/DaWelter/face-3d-rotation-augmentation). "
            f"Import failed: {e}"
        )
    import tqdm

    rng = np.random.RandomState(seed=1234567)
    with closing(DatasetAFLW2k3D(filename)) as ds, dataset_writer(outputfilename) as writer:
        num_frames = min(max_num_frames, len(ds))
        for _, sample in tqdm.tqdm(zip(range(num_frames), ds), total=num_frames):
            if sample["scale"] <= 0.0:
                print(f"Error: invalid head size = {sample['scale']}. Passing through!")
                generated = make_sample_for_passthrough(sample)
            else:
                generated = augment_eyes_only(prob_closed_eyes, rng, sample)
            writer.write(sample["name"], generated)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Only Eye Augmentation")
    parser.add_argument("aflw2k3d", type=str, help="zip file")
    parser.add_argument("outputfilename", type=str, help="hdf5 file")
    parser.add_argument("-n", type=int, default=1 << 32)
    parser.add_argument("--prob-closed-eyes", type=float, default=0.0)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.outputfilename.lower().endswith((".h5", ".hdf5")):
        raise ValueError("outputfilename must have an hdf5 extension")
    convert(args.aflw2k3d, args.outputfilename, args.n, args.prob_closed_eyes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
