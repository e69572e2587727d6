"""Write ensemble pseudo-labels (pose, coord, landmarks, shape) back into a
pose file (counterpart of the JAX package's `scripts/add_pose_pseudolabels.py`,
with its flags).

    python -m neuralnet_tracker_traincode_torch.scripts.add_pose_pseudolabels data.h5 \\
        -c a/best.ckpt b_full.onnx [--hdf-group-name g] [--overwrite] [--dryrun] [--device cpu]

Each network (a quaternion network's checkpoint, or its ONNX file exported
with `--full`, which carries `unnormalized_quat`, `pt3d_68` and
`shapeparam`) runs over every frame through the Predictor (expansion 1.2)
on `--device` (default `cuda`).
The ensemble's quaternions are the pivot-sign-aligned mean of the
unnormalized ones (`ops/quaternion.py:quat_average`); coords, landmarks and
shape parameters are plain means. They are written with the pose schema.
"""

import argparse
import gc
import sys
from collections import defaultdict
from os.path import isfile

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Write ensemble pseudo-labels into a pose file")
    parser.add_argument("filename", type=str, help="the dataset to label")
    parser.add_argument("-c", "--checkpoints", help="model checkpoints or --full ONNX files", nargs="*", type=str)
    parser.add_argument("-b", "--batchsize", type=int, default=512)
    parser.add_argument("--hdf-group-name", type=str, default="", dest="hdfgroupname",
                        help="Group to store the annotations in")
    parser.add_argument("--dryrun", default=False, action="store_true")
    parser.add_argument("--overwrite", "-f", default=False, action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def setup_dataset(filename: str):
    from neuralnet_tracker_traincode_torch.data.host_transforms import offset_points_by_half_pixel_np
    from neuralnet_tracker_traincode_torch.data.pose_dataset import Hdf5PoseDataset

    return Hdf5PoseDataset(filename, transform=offset_points_by_half_pixel_np)


def fit_dataset(predictor, ds, batchsize: int):
    """The predictions the pseudo-labels need, per sample, in dataset order."""
    from neuralnet_tracker_traincode_torch import utils
    from neuralnet_tracker_traincode_torch.eval.metrics import as_numpy

    outputs = defaultdict(list)
    for chunk in utils.iter_batched((ds[i] for i in range(len(ds))), batchsize):
        images = [as_numpy(s.pop("image")) for s in chunk]
        rois = np.stack([as_numpy(s["roi"]) for s in chunk])
        preds = predictor.predict_batch(images, rois).to_numpy()
        if "unnormalized_quat" not in preds:
            raise ValueError("pseudo-labels average the quaternion head's unnormalized_quat: a quaternion network's "
                             "checkpoint or --full export is needed (a 6D network has none)")
        for k in ("unnormalized_quat", "coord", "pt3d_68", "shapeparam"):
            outputs[k].append(np.asarray(preds[k]))
        outputs["index"].append(np.stack([np.asarray(s["index"]) for s in chunk]))
    outputs = {k: np.concatenate(v, axis=0) for k, v in outputs.items()}
    ordering = np.argsort(outputs.pop("index"))
    return {k: v[ordering] for k, v in outputs.items()}


def fitall(args):
    import h5py

    from neuralnet_tracker_traincode_torch.data.fields import FieldCategory as C
    from neuralnet_tracker_traincode_torch.data.pose_dataset import create_pose_dataset
    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor, load_pose_network
    from neuralnet_tracker_traincode_torch.ops.quaternion import quat_average

    assert all(isfile(f) for f in args.checkpoints)
    print("Inferring from networks:", args.checkpoints)
    device = resolve_device(getattr(args, "device", "cuda"))

    if not args.dryrun:
        with h5py.File(args.filename, "r+") as f:
            g = f.require_group(args.hdfgroupname) if args.hdfgroupname else f
            for key in "coords quats pt3d_68 shapeparams".split():
                if key in g:
                    del g[key]

    ds = setup_dataset(args.filename)
    num_samples = len(ds)
    outputs_per_net = defaultdict(list)
    for modelfile in args.checkpoints:
        predictor = Predictor(load_pose_network(modelfile, device), focus_roi_expansion_factor=1.2, device=device)
        for k, v in fit_dataset(predictor, ds, args.batchsize).items():
            outputs_per_net[k].append(v)
    outputs_per_net = {k: np.stack(v) for k, v in outputs_per_net.items()}
    ds.close()
    del ds
    gc.collect()  # the file must be closed before it is opened for writing

    # the mean of normalized quaternions is unstable near sign flips: the reference averages the unnormalized
    # outputs, sign-aligned on a pivot axis
    quats = quat_average(outputs_per_net.pop("unnormalized_quat"))
    coords = np.average(outputs_per_net.pop("coord"), axis=0)
    pt3d_68 = np.average(outputs_per_net.pop("pt3d_68"), axis=0)
    shapeparams = np.average(outputs_per_net.pop("shapeparam"), axis=0)
    assert len(quats) == num_samples

    if args.dryrun:
        print("Dry run: not writing. Stats:")
        print("  quat mean:", quats.mean(axis=0))
        print("  coord mean:", coords.mean(axis=0))
        return

    with h5py.File(args.filename, "r+") as f:
        g = f.require_group(args.hdfgroupname) if args.hdfgroupname else f
        create_pose_dataset(g, C.quat, count=num_samples, dtype=np.float32, data=quats.astype(np.float32),
                            exists_ok=args.overwrite)
        create_pose_dataset(g, C.xys, count=num_samples, dtype=np.float32, data=coords.astype(np.float32),
                            exists_ok=args.overwrite)
        create_pose_dataset(g, C.points, name="pt3d_68", count=num_samples, shape_wo_batch_dim=(68, 3),
                            dtype=np.float32, data=pt3d_68.astype(np.float32), exists_ok=args.overwrite)
        create_pose_dataset(g, C.general, name="shapeparams", count=num_samples, shape_wo_batch_dim=(50,),
                            dtype=np.float32, data=shapeparams.astype(np.float32), exists_ok=args.overwrite)
    print(f"Wrote pseudo-labels for {num_samples} samples into {args.filename}")


def main(argv=None) -> int:
    fitall(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
