"""Convert the 3DDFA `bfm_noneck_v3.pkl` into the 68-keypoint artifact the
port ships (`facemodel/assets/bfm_keypoints_subset.npz`; counterpart of the
JAX package's `scripts/convert_bfm.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.convert_bfm /path/to/bfm_noneck_v3.pkl [--out subset.npz]

Host only: numpy over `facemodel/bfm.py:FullBFMModel`, no device.
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from neuralnet_tracker_traincode_torch.facemodel.bfm import SUBSET_ARTIFACT

    parser = argparse.ArgumentParser(description="Convert bfm_noneck_v3.pkl into the 68-keypoint artifact")
    parser.add_argument("pkl", help="Path to bfm_noneck_v3.pkl")
    parser.add_argument("--out", default=SUBSET_ARTIFACT)
    return parser


def main(argv=None) -> int:
    from neuralnet_tracker_traincode_torch.facemodel.bfm import FullBFMModel

    args = build_parser().parse_args(argv)
    out = FullBFMModel(args.pkl).export_keypoint_subset(args.out)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
