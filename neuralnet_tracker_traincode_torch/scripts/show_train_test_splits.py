"""Page through augmented training samples as the training step sees them
(counterpart of the JAX package's `scripts/show_train_test_splits.py`, with
its flags).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.show_train_test_splits \\
        --ds 300wlp [--outdir DIR] [--seed 0] [--device cpu]

The training CLI's loader gives batches of the `--ds` mix; the port's
training augmentation (`augmentation/pipeline.py:augment_batch_for_training`,
with K1, K2 and K3 on the card) runs on `--device`, its draws from a
`torch.Generator` seeded by `--seed`. The labels are un-normalized back to
crop pixels and the images un-whitened. `--outdir` writes the first 32
samples as PNGs with cv2; otherwise a matplotlib window pages through them.
"""

import argparse
import os
import sys
from os.path import join
from typing import Callable, Iterator, Optional

import numpy as np


def iterate_samples(loader, aug_cfg, generator, device, draws: Optional[Callable] = None) -> Iterator:
    """(sample, None) for every real row of each of `loader`'s batches,
    after the training augmentation on `device`: the sample's `image` (H, W,
    C) uint8 and its `pt3d_68`, `coord`, `roi` (crop pixels) and `pose`.
    The draws come from `generator`, or from `draws(step, batchsize)` where
    given (the test surface: injected parameters)."""
    import torch

    from neuralnet_tracker_traincode_torch.augmentation.affine import (
        position_unnormalization,
        transform_coord,
        transform_points,
        transform_roi,
    )
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import augment_batch_for_training
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d

    dev = resolve_device(device)
    shown_by = {"pt3d_68": transform_points, "coord": transform_coord, "roi": transform_roi}
    for step, batch in enumerate(loader):
        labels = {k: v for k, v in batch.items() if k in LABEL_CATEGORIES}
        B = len(batch["image"])
        params = None if draws is None else draws(step, B)
        x, out = augment_batch_for_training(batch["image"], labels, LABEL_CATEGORIES, aug_cfg, params=params,
                                            generator=generator, param_index=batch["param_index"], device=dev)
        un = Affine2d(position_unnormalization(x.shape[2], x.shape[1]).tensor().to(dev)).broadcast_to((B,))
        imgs = torch.clamp((x + 0.5) * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        shown = {k: fn(un, out[k]).cpu().numpy() for k, fn in shown_by.items() if k in out}
        if "pose" in out:
            shown["pose"] = out["pose"].cpu().numpy()
        weights = np.asarray(torch.as_tensor(batch["dataset_weight"]).cpu())
        for i in range(B):
            if not weights[i]:
                continue  # a padding row
            sample = {"image": imgs[i]}
            sample.update({k: v[i] for k, v in shown.items()})
            yield sample, None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Shows augmented training samples")
    parser.add_argument("--ds", type=str, default="repro_300_wlp")
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--raug", default=30.0, type=float, dest="rotation_aug_angle")
    parser.add_argument("--no-imgaug", default=True, action="store_false", dest="with_image_aug")
    parser.add_argument("--roi-override", default="original", choices=["extent_to_forehead", "original", "landmarks"])
    parser.add_argument("--seed", type=int, default=0, help="seed of the sampler and the augmentation")
    parser.add_argument("--outdir", default=None, help="write the first 32 samples here as PNGs instead of a window")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    import torch

    from neuralnet_tracker_traincode_torch import pipelines, vis
    from neuralnet_tracker_traincode_torch.scripts.train_poseestimator import parse_dataset_definition

    args = build_parser().parse_args(argv)
    dsids, weights = parse_dataset_definition(args.ds)
    loader, _, size, tag_order, aug = pipelines.make_pose_estimation_loaders(
        inputsize=129,
        batchsize=args.batchsize,
        datasets=dsids,
        dataset_weights=weights,
        enable_image_aug=args.with_image_aug,
        rotation_aug_angle=args.rotation_aug_angle,
        roi_override=args.roi_override,
        seed=args.seed,
    )
    print(f"Training pipeline over {size} samples, tags {tag_order}")
    samples = iterate_samples(loader, aug, torch.Generator().manual_seed(args.seed), args.device)
    if args.outdir:
        import cv2

        os.makedirs(args.outdir, exist_ok=True)
        for i, gp in zip(range(32), samples):
            cv2.imwrite(join(args.outdir, f"sample_{i:03d}.png"), vis.draw_prediction(gp)[..., ::-1])
        samples.close()
        print(f"Wrote 32 augmented samples to {args.outdir}")
        return 0
    from matplotlib import pyplot  # the backend of the user's matplotlib settings

    _keepalive = vis.matplotlib_plot_iterable(samples, vis.draw_prediction)
    pyplot.show()
    samples.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
