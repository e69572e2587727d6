"""Train the face localizer on WIDER FACE single-face crops (counterpart of
the JAX package's `scripts/train_localizer.py`, with its flags and defaults).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.train_localizer \\
        --epochs 50 --outdir model_files [--device cpu]

The training split of `$DATADIR/widerfacessingle.h5` (rows from 500 on)
goes through `FusedBatchLoader` and `device_prefetch` into
`train/localizer.py:run_localizer_training`, which writes
`<outdir>/LocalizerNet/last.ckpt` every epoch.
"""

import argparse
import sys
from os.path import dirname, join


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the face localizer on WIDER FACE single-face crops")
    parser.add_argument("--batchsize", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1.0e-3)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--outdir", type=str, default=join(dirname(__file__), "..", "..", "model_files"))
    parser.add_argument("--pad-size", type=int, default=None)
    parser.add_argument("--no-imgaug", default=True, action="store_false", dest="with_image_aug")
    parser.add_argument("--samples-per-epoch", default=10 * 1024, type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline import LocalizerAugConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader, device_prefetch
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet
    from neuralnet_tracker_traincode_torch.train.localizer import (
        LocalizerTrainer,
        LocalizerTrainerConfig,
        run_localizer_training,
    )

    dev = resolve_device(args.device)
    train_set, test_set = pipelines.make_widerface_datasets()
    concat = ConcatDataset([train_set])
    sampler = make_concat_dataset_item_sampler(concat, [1.0])
    pad_size = args.pad_size or pipelines.probe_pad_size([train_set])
    print(f"Localizer training: {len(train_set)} train / {len(test_set)} test, pad {pad_size}")
    loader = FusedBatchLoader(concat, tags_by_dataset_index=lambda i: Tag.FACE_DETECTION,
                              tag_to_id={Tag.FACE_DETECTION: 0}, sampler=sampler, batchsize=args.batchsize,
                              pad_size=pad_size)
    cfg = LocalizerTrainerConfig(batchsize=args.batchsize, lr=args.lr, epochs=args.epochs,
                                 samples_per_epoch=args.samples_per_epoch,
                                 aug=LocalizerAugConfig(enable_image_aug=args.with_image_aug))
    trainer = LocalizerTrainer(LocalizerNet(dtype=torch.bfloat16), cfg, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(1234))
    generator = torch.Generator()
    generator.seed()
    run_localizer_training(trainer, state, device_prefetch(iter(loader), dev), join(args.outdir, "LocalizerNet"),
                           generator)
    return 0


if __name__ == "__main__":
    sys.exit(main())
