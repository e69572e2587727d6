"""Benchmark the host input pipeline stage by stage (counterpart of the JAX
package's `scripts/bench_loader.py`, with its flags and stages):

  h5 read      raw varsize-JPEG buffer reads from the file
  decode       cv2's grayscale decode on the host, beside the port's split
               decode: the host's scan stage (`data/native_loader.py:
               scan_batch`: markers, tables, the Y scan unstuffed) and the
               old host entropy decode (`entropy_decode`), each on one
               thread, then K5 and K4 on `--device` over the images
               (`kernels/jpeg_huffman.py`, `kernels/jpeg.py`; their plain
               versions with `--device cpu`)
  pack         `FusedBatchLoader` end to end through `device_prefetch`;
               with `--raw` (undecoded JPEGs, decoded a batch at a time) in
               both modes, cv2 on the host (`jpeg_decode="host"`) and the
               split decode (`"device"`: the host parses, the card decodes),
               else the dataset decodes each
               image as it is read
  train        (`--train`, with `--memory`) the pose training CLI's path at
               K = 8 steps a CUDA graph replay over the loader in both
               modes: phase 7's configuration of `chip_smoke.py` (the CLI's
               `--with-nll-loss --enable-6drot`, bf16, 4 epochs of 1,024
               samples), the training thread's wait in `next()` a step,
               images/s an epoch, then the loader alone on its workers

    python -m neuralnet_tracker_traincode_torch.scripts.bench_loader [--ds F.h5] [-n 512] [--raw] [--workers 4]
    python -m neuralnet_tracker_traincode_torch.scripts.bench_loader --memory noise [--size 448] [--ab] [--train]

With `--memory markers|noise|colour` the frames are made in memory and need
no h5py (the card's machine has none): `-n` frames at `--size`^2, JPEG
quality 95, served undecoded; `markers` are `data/synthetic.py`'s marker
frames (mostly flat 8x8 blocks), `noise` uniform noise (every block dense),
`colour` the marker frames tinted by smooth colour fields with sensor-like
noise (sigma 6), encoded in colour with cv2's default 4:2:0 sampling, the
layout of the datasets that `scripts/dsprocess_*.py` write.
`--ab` runs the pack (and train) stage in both modes in turns, device,
host, host, device. Without `--ds` or `--memory` it writes a synthetic file
of 256 x 256 noise JPEGs into a temporary directory. `decode_stage`,
`loader_stage` and `training_stage` take buffers and datasets in memory
(`chip_smoke.py` phases 12a and 18 run them on `JpegFrames`). Rates on the
card are taken after `torch.cuda.synchronize()`; the card's name and power
limit are printed beside them.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Sequence

import numpy as np


class JpegFrames:
    """Labelled frames held as JPEG buffers; item i is the single-frame
    `Batch` that `Hdf5PoseDataset` gives under `use_raw_images` (the image a
    `RawJpegBuffer`, the labels, `index` and `coord_convention_id`). Defined
    at a module's top level so that the loader's spawned workers can
    unpickle it."""

    def __init__(self, buffers, labels, size, tag):
        self.offsets = [0]
        for b in buffers:
            self.offsets.append(self.offsets[-1] + len(b))
        self.blob = np.concatenate(buffers)
        self.labels, self.size, self.tag = labels, size, tag

    def __len__(self):
        return len(self.offsets) - 1

    def buffer(self, i) -> np.ndarray:
        return self.blob[self.offsets[i]:self.offsets[i + 1]]

    def __getitem__(self, i):
        from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata
        from neuralnet_tracker_traincode_torch.data.fields import POSE_FIELD_CATEGORIES, FieldCategory
        from neuralnet_tracker_traincode_torch.data.hdf5 import RawJpegBuffer

        if not 0 <= i < len(self):
            raise IndexError(i)
        fields = {"image": RawJpegBuffer(self.buffer(i), self.size, self.size)}
        fields.update((k, v[i]) for k, v in self.labels.items())
        fields["index"] = np.asarray(i, np.int32)
        fields["coord_convention_id"] = np.asarray(0, np.int32)
        cats = {k: POSE_FIELD_CATEGORIES.get(k, FieldCategory.general) for k in fields}
        return Batch(Metadata((self.size, self.size), 0, self.tag, None, categories=cats), fields)


def jpeg_frames(n: int, size: int, seed: int, device, content: str = "markers", quality: int = 95) -> JpegFrames:
    """`n` labelled frames at `size`^2 from `seed` (`data/synthetic.py`'s
    labels), encoded on the host by the port's `imencode` at the JAX
    writer's quality: the marker images rendered on `device` ("markers"),
    uniform noise from the seed ("noise"), or the marker images tinted in
    colour with noise, encoded 4:2:0 ("colour")."""
    from concurrent.futures import ThreadPoolExecutor

    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.preprocessing import imencode
    from neuralnet_tracker_traincode_torch.data.synthetic import make_labels, render_marker_images

    quats, coords, pt3d, shapeparams, rois = make_labels(n, size, seed=seed, device=device)
    if content == "markers":
        images = render_marker_images(pt3d, coords, size).cpu().numpy()
    elif content == "noise":
        images = np.random.default_rng(seed).integers(0, 256, (n, size, size), dtype=np.uint8)
    elif content == "colour":
        rng = np.random.default_rng(seed)
        base = render_marker_images(pt3d, coords, size).cpu().numpy().astype(np.float32)[..., None]
        yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
        phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3)).astype(np.float32)
        tint = np.sin(np.stack([3 * xx, 2 * yy, 2 * (xx + yy)], -1)[None] + phase)
        noise = rng.normal(0, 6, (n, size, size, 3)).astype(np.float32)
        images = np.clip(0.7 * base + 60 * tint + 40 + noise, 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"content is 'markers', 'noise' or 'colour', not {content!r}")
    with ThreadPoolExecutor(8) as pool:  # cv2 releases the GIL while it encodes
        buffers = list(pool.map(lambda im: imencode(im, quality=quality), images))
    labels = {k: a.cpu().numpy() for k, a in
              zip(("pose", "coord", "pt3d_68", "shapeparam", "roi"), (quats, coords, pt3d, shapeparams, rois))}
    return JpegFrames(buffers, labels, size, Tag.POSE_WITH_LANDMARKS)


def card(device) -> str:
    """Where `device` is: the card's name and power limit as nvidia-smi
    gives them, else the device's type."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def decode_stage(buffers: Sequence[np.ndarray], pad: int, device) -> Dict[str, float]:
    """images/s of cv2's decode (one thread, image by image, as the host
    decode runs), of the host's scan stage and of the old host entropy
    decode (one thread each, a call a batch of 64, as a worker takes a
    batch), and of K5 and K4 a batch at a time on `device` (the upload
    excluded, the status read back)."""
    import cv2
    import torch

    from neuralnet_tracker_traincode_torch.data import native_loader

    batches = [buffers[i:i + 64] for i in range(0, len(buffers), 64)]
    t0 = time.perf_counter()
    for b in buffers:
        cv2.imdecode(b, cv2.IMREAD_GRAYSCALE)
    cv2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bs in batches:
        native_loader.scan_batch(bs, pad, nthreads=1)
    scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bs in batches:
        native_loader.entropy_decode(bs, pad, nthreads=1)
    entropy_s = time.perf_counter() - t0
    payloads = [native_loader.scan_batch(bs, pad).to(device) for bs in batches]
    outs = [p.decode() for p in payloads]  # the first call builds the kernels on a card
    sync = torch.cuda.synchronize if outs[0].is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for p, out in zip(payloads, outs):
        p.decode(out=out)
    sync()
    card_s = time.perf_counter() - t0
    n = len(buffers)
    return {"cv2": n / cv2_s, "scan": n / scan_s, "entropy": n / entropy_s, "card": n / card_s}


def loader_stage(concat, tag, batchsize: int, pad: int, steps: int, device, jpeg_decode: str, **loader_kwargs
                 ) -> Dict[str, float]:
    """images/s of `FusedBatchLoader` over `concat` through `device_prefetch`
    to `device`, `steps` batches after the first (workers' start-up)."""
    import torch

    from neuralnet_tracker_traincode_torch.data.loader import FusedBatchLoader, device_prefetch
    from neuralnet_tracker_traincode_torch.data.sampling import make_concat_dataset_item_sampler

    loader = FusedBatchLoader(concat, lambda i: tag, {tag: 0}, make_concat_dataset_item_sampler(concat, [1.0]),
                              batchsize, pad, jpeg_decode=jpeg_decode, **loader_kwargs)
    it = device_prefetch(loader.iterate(), device)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(steps):
            batch = next(it)
        if batch["image"].is_cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return {"images_per_s": steps * batchsize / dt, "workers": loader.num_workers, "worker_type": loader.worker_type}


def training_stage(train, val, pad: int, device, jpeg_decode: str, batchsize: int = 64, epochs: int = 4,
                   samples_per_epoch: int = 1024, steps_per_dispatch: int = 8, workers: int = 4,
                   alone_batches: int = 32) -> Dict[str, Any]:
    """`chip_smoke.py` phase 7's training run (the CLI's `--with-nll-loss
    --enable-6drot`: 6D head, point and NLL heads, 12 terms, bf16, SWA after
    epoch 1) over `train` (a dataset of one tag, e.g. `JpegFrames`) through
    the training CLI's sampler (seed 3), `FusedBatchLoader(jpeg_decode=)`
    with `workers` process workers and shared memory, and
    `device_prefetch_stacked` at K = `steps_per_dispatch` (one CUDA graph
    replay a group on a card), validated on `val`. The launch counts are
    reset just before the run and read just after it; then the loader alone
    is timed on the run's workers, `alone_batches` batches once their queues
    are full. Returns the mode, the launches, the first group (copied), the
    waits in `next()` (ms a group), the run's records, the loader alone's
    images/s, the run's seconds, the steps and (untrained, final)
    validation losses."""
    import torch

    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import (
        LABEL_CATEGORIES,
        FusedBatchLoader,
        device_prefetch_stacked,
    )
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    tag = train[0].meta.tag
    concat = ConcatDataset([train])
    opts = LossOptions(epochs=epochs, with_nll_loss=True, with_pointhead=True, with_roi_train=True, enable_6drot=True)
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                 enable_6drot=True, dtype=torch.bfloat16)
    cfg = TrainerConfig(batchsize=batchsize, epochs=epochs, samples_per_epoch=samples_per_epoch, swa_start_epoch=1,
                        aug=TrainAugmentationConfig(enable_image_aug=True))
    trainer = PoseTrainer(model, setup_losses(opts, [tag]), cfg, LABEL_CATEGORIES, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    validation = FusedValidation(trainer, val, batchsize=2 * batchsize)
    untrained_loss = float(validation.evaluate(0)["loss"])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    waits, host_iters, streams, first = [], [], [], {}

    def batches(start):  # the training CLI's sampler
        sampler = make_concat_dataset_item_sampler(concat, [1.0], seed=3)
        source = FusedBatchLoader(concat, lambda i: tag, {tag: 0}, sampler, batchsize, pad, num_workers=workers,
                                  worker_type="process", shared_memory=True, jpeg_decode=jpeg_decode)
        host_iters.append((source, source.iterate(start)))
        stream = device_prefetch_stacked(host_iters[-1][1], device, steps_per_dispatch, size=2)
        streams.append(stream)

        def timed():  # the training thread's wait in next() on the prefetcher, a group of K steps
            while True:
                t = time.perf_counter()
                try:
                    group = next(stream)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - t) * 1e3)
                if not first:
                    first.update((n, v.clone()) for n, v in group.items())
                yield group

        return timed()

    outdir = tempfile.mkdtemp(prefix="bench_loader_train_")
    try:
        sync()
        ext.reset_launch_counts()
        t_run = time.perf_counter()
        state, records = run_training(trainer, state, batches, validation, outdir, torch.Generator().manual_seed(7),
                                      steps_per_dispatch=steps_per_dispatch)
        sync()
        run_s = time.perf_counter() - t_run
        launches = dict(ext.LAUNCHES)
        # the loader alone on the run's workers: once their queues are full, take what they hold, then time
        source, it = host_iters[0]
        time.sleep(2.0)
        for _ in range(workers * (max(2, source.prefetch // workers) + 2)):
            next(it)
        t0 = time.perf_counter()
        for _ in range(alone_batches):
            next(it)
        alone = alone_batches * batchsize / (time.perf_counter() - t0)
    finally:
        for stream in streams:
            stream.close()
        shutil.rmtree(outdir, ignore_errors=True)
    return dict(mode=jpeg_decode, launches=launches, first=first, waits=waits, records=records, alone=alone,
                run_s=run_s, steps=state.step, k=steps_per_dispatch, workers=workers, batchsize=batchsize,
                losses=(untrained_loss, records[-1]["val_loss"]))


def print_training(r: Dict[str, Any], what: str, where: str):
    """`training_stage`'s result: images/s an epoch, the wait in `next()` a
    step after the first group (median, p90), the loader alone."""
    k = r["k"]
    per_step = sorted(w / k for w in (r["waits"][1:] or r["waits"]))
    for rec in r["records"]:
        print(f"{what} epoch {rec['epoch'] + 1}/{len(r['records'])}: {rec['steps']} steps in "
              f"{rec['train_s'] * 1e3:.1f} ms, {rec['images_per_s']:.1f} images/s; validation loss "
              f"{rec['val_loss']:.4f} on {where}")
    print(f"{what}: {r['steps']} steps of batch {r['batchsize']} at K = {k} from {r['workers']} process workers, "
          f"the JPEGs decoded {'on the card' if r['mode'] == 'device' else 'by cv2 on the host'}; the training thread "
          f"waited in next() median {np.median(per_step):.3f} ms, p90 {per_step[int(0.9 * (len(per_step) - 1))]:.3f} "
          f"ms a step after the first group (first {r['waits'][0]:.1f} ms a group, worker start-up included); "
          f"validation loss {r['losses'][0]:.4f} -> {r['losses'][1]:.4f}; the loader alone afterwards "
          f"{r['alone']:.1f} images/s; launches {r['launches']}; run {r['run_s']:.2f} s on {where}")


def _write_synthetic(fn: str, n: int):
    import h5py

    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset

    rng = np.random.RandomState(0)
    with h5py.File(fn, "w") as f:
        ds = create_pose_dataset(f, FieldCategory.image, count=n)
        for i in range(n):
            ds[i] = (rng.rand(256, 256) * 255).astype(np.uint8)
        create_pose_dataset(f, FieldCategory.quat, count=n, dtype=np.float32,
                            data=np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1)))
        create_pose_dataset(f, FieldCategory.xys, count=n, dtype=np.float32,
                            data=np.tile(np.asarray([128, 128, 40], np.float32), (n, 1)))
        create_pose_dataset(f, FieldCategory.roi, count=n, dtype=np.float32,
                            data=np.tile(np.asarray([64, 64, 192, 192], np.float32), (n, 1)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ds", type=str, default=None, help=".h5 file (default: a generated synthetic one)")
    parser.add_argument("--memory", default=None, choices=("markers", "noise", "colour"),
                        help="frames made in memory instead of a file (no h5py), served undecoded")
    parser.add_argument("--size", type=int, default=448, help="the in-memory frames' side")
    parser.add_argument("-n", type=int, default=512, help="samples per stage (with --memory: the frames made)")
    parser.add_argument("--batchsize", type=int, default=64)
    parser.add_argument("--raw", action="store_true", default=False,
                        help="serve undecoded JPEGs: the loader decodes whole batches")
    parser.add_argument("--workers", type=int, default=1, help="loader workers")
    parser.add_argument("--worker-type", default="auto", choices=("auto", "thread", "process"))
    parser.add_argument("--no-shm", action="store_false", dest="shared_memory", default=True,
                        help="pickle image payloads through the mp queue instead of the shared-memory slot ring")
    parser.add_argument("--ab", action="store_true", default=False,
                        help="the pack (and train) stage in both decodes in turns: device, host, host, device")
    parser.add_argument("--train", action="store_true", default=False,
                        help="with --memory: the training CLI's path at K = 8 over the loader, both decodes")
    parser.add_argument("--device", default="cuda", help="where K5, K4 and the batches go (default: the card)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.train and args.memory is None:
        parser.error("--train needs --memory")
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset
    from neuralnet_tracker_traincode_torch.device import resolve_device

    dev = resolve_device(args.device)
    where = card(dev)
    tmp = None
    try:
        if args.memory:
            t0 = time.perf_counter()
            ds = jpeg_frames(args.n, args.size, 3, dev, args.memory)
            pad, tag, raw = args.size, ds.tag, True
            buffers = [ds.buffer(i) for i in range(len(ds))]
            print(f"made:     {len(ds)} {args.memory} frames at {pad}^2, JPEG q95, {len(ds.blob) / len(ds) / 1e3:.1f} "
                  f"KB each, in {time.perf_counter() - t0:.1f} s")
        else:
            import h5py

            from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset

            fn = args.ds
            if fn is None:
                tmp = tempfile.TemporaryDirectory(prefix="bench_loader_")
                fn = os.path.join(tmp.name, "bench_loader.h5")
                _write_synthetic(fn, max(args.n, 256))
                print(f"Generated synthetic {fn} ({max(args.n, 256)} x 256x256 jpegs)")
            with h5py.File(fn, "r") as f:
                images = f["images"]
                count = min(args.n, len(images))
                t0 = time.perf_counter()
                buffers = [np.asarray(images[i % len(images)]) for i in range(count)]
                dt = time.perf_counter() - t0
            print(f"h5 read:  {count / dt:8.0f} samples/s ({dt / count * 1e3:.2f} ms ea)")
            ds = Hdf5PoseDataset(fn, dataclass=Tag.ONLY_POSE)
            pad = 0
            for i in range(min(8, len(ds))):
                pad = max(pad, *ds[i]["image"].shape[:2])
            ds.use_raw_images, tag, raw = args.raw, Tag.ONLY_POSE, args.raw

        if buffers and buffers[0].ndim == 1:
            r = decode_stage(buffers, pad, dev)
            print(f"decode:   {r['cv2']:8.0f} samples/s (cv2, one thread); host scan stage {r['scan']:.0f} samples/s "
                  f"(one thread); old host entropy decode {r['entropy']:.0f} samples/s (one thread); K5 and K4 "
                  f"{r['card']:.0f} samples/s on {where}")
        else:
            print("decode:   images stored raw; skipped")

        steps = max(1, args.n // args.batchsize)
        modes = ("device", "host", "host", "device") if args.ab else ("host", "device") if raw else ("host",)
        for mode in modes:
            r = loader_stage(ConcatDataset([ds]), tag, args.batchsize, pad, steps, dev, mode,
                             num_workers=args.workers, worker_type=args.worker_type,
                             shared_memory=args.shared_memory)
            transport = ""
            if r["worker_type"] == "process":
                transport = ", shm ring" if args.shared_memory else ", pickled queue"
            what = ("raw-jpeg batch decode, "
                    + ("cv2 on the host" if mode == "host" else "parse on the host, K5 and K4")
                    if raw else "per-sample decode")
            print(f"pack:     {r['images_per_s']:8.0f} samples/s (FusedBatchLoader end-to-end through device_prefetch "
                  f"to {where}, batch {args.batchsize}, pad {pad}, {what}, {r['workers']} {r['worker_type']} "
                  f"worker(s){transport})")

        if args.train:
            val = jpeg_frames(256, args.size, 4, dev, args.memory)
            for mode in modes:
                r = training_stage(ds, val, pad, dev, mode, batchsize=args.batchsize, workers=args.workers)
                print_training(r, f"train ({mode})", where)
    finally:
        if tmp is not None:
            tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
