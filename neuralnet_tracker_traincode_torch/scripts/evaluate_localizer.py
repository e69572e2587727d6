"""Evaluate the face localizer: is-face accuracy and the box corner RMSE
(counterpart of the JAX package's `scripts/evaluate_localizer.py`, with its
flags and result lines).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.evaluate_localizer \\
        model_files/LocalizerNet/last.ckpt [--protocol full|crop] [--vis-outdir DIR] [--device cpu]

The samples are the first `-n` rows of `--ds`, or of the held-out split of
`$DATADIR/widerfacessingle.h5` (its first 500 rows). Protocols (see
`eval/localizer.py`): `full` rescales the whole image to the 224x288 input,
`crop` takes the deterministic context crop around the labelled ROI.
`--vis-outdir` writes overlays of the first 32 network inputs (labelled box
green, predicted box red) as PNGs.
"""

import argparse
import os
import sys
from os.path import join

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate the face localizer")
    parser.add_argument("checkpoint", type=str, help="LocalizerNet .ckpt")
    parser.add_argument("--ds", type=str, default=None,
                        help="HDF5 file (default $DATADIR/widerfacessingle.h5, first 500 rows)")
    parser.add_argument("-n", type=int, default=500, help="number of held-out samples")
    parser.add_argument("--protocol", choices=["full", "crop"], default="full")
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--thresholds", type=float, nargs="*", default=[0.25, 0.5, 0.75])
    parser.add_argument("--vis-outdir", type=str, default=None, help="Save the first 32 prediction overlays here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset
    from neuralnet_tracker_traincode_torch.data.sampling import Subset
    from neuralnet_tracker_traincode_torch.eval.localizer import LocalizerEvaluator, result_lines

    if args.ds is not None:
        ds = Hdf5PoseDataset(args.ds, dataclass=Tag.FACE_DETECTION)
        test = Subset(ds, np.arange(min(args.n, len(ds))))
    else:
        _, test = pipelines.make_widerface_datasets()
        test = Subset(test, np.arange(min(args.n, len(test))))
    evaluator = LocalizerEvaluator(args.checkpoint, device=args.device)
    print(f"Evaluating {args.checkpoint} on {len(test)} samples ({args.protocol} protocol)")

    saved = [0]
    on_chunk = None
    if args.vis_outdir:
        os.makedirs(args.vis_outdir, exist_ok=True)

        def on_chunk(x, preds, targets):
            import cv2

            from neuralnet_tracker_traincode_torch import vis

            crops = np.clip((x + 0.5) * 256.0, 0, 255).astype(np.uint8)
            for j in range(min(len(crops), 32 - saved[0])):
                img = vis.draw_prediction(({"image": crops[j], "roi": targets["roi"][j]}, {"roi": preds["roi"][j]}))
                cv2.imwrite(join(args.vis_outdir, f"loc_{saved[0]:03d}.png"), img[..., ::-1])
                saved[0] += 1

    results = evaluator.evaluate([test[i] for i in range(len(test))], args.protocol, args.batchsize,
                                 args.thresholds, on_chunk=on_chunk)
    print(result_lines(results))
    if args.vis_outdir:
        print(f"Wrote {saved[0]} overlays to {args.vis_outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
