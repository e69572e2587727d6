"""Evaluate pose networks: models x datasets x ROI configurations
(counterpart of the JAX package's `scripts/evaluate_pose_network.py`, with
its flags and table).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.evaluate_pose_network \\
        model_files/NetworkWithPointHead_mobilenetv1/best.ckpt --ds aflw2k3d [--json out.json] [--device cpu]

`--ds` takes names of the dataset registry ("+"-joined) or a `.h5` path.
A file is a checkpoint or an exported `.onnx` file (`eval/predictor.py:
OnnxPoseNetwork`, run in the port's executor on `--device`). Each row is
`eval/report.py:add_report_row` over the Predictor in f32 (`--precision
bfloat16`: a checkpoint's forward under bf16 autocast instead; an ONNX file
stays f32, as the JAX package's executor does). `--vis kpts|rot|size` with
`--vis-outdir` writes overlays of the 32 worst samples as PNGs; without
`--vis-outdir` it pages through the worst samples, worst first, in a
matplotlib window (`vis.matplotlib_plot_iterable`).
"""

import argparse
import os
import sys
from os.path import join

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate pose networks")
    parser.add_argument("filenames", help="checkpoint or onnx model files", type=str, nargs="*")
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    parser.add_argument("--comprehensive-roi", action="store_true", default=False)
    parser.add_argument("--alignment-scheme", choices=["perspective", "opal23", "none"], default="none")
    parser.add_argument("--perspective-correction", dest="alignment_scheme", action="store_const", const="perspective")
    parser.add_argument("--roi-expansion", default=None, type=float)
    parser.add_argument("--json", type=str, default=None)
    parser.add_argument("--ds", type=str, default="aflw2k3d")
    parser.add_argument("--vis", default="none", choices=["none", "kpts", "rot", "size"],
                        help="overlays of the worst samples by this error quantity")
    parser.add_argument("--vis-outdir", default=None, type=str,
                        help="write the overlays here as PNG files (else a matplotlib window pages through them)")
    parser.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                        help="float32: the f32 eval; bfloat16: the forward under bf16 autocast")
    return parser


def bf16_network(net):
    """`net` (a `CheckpointPoseNetwork`) with its forward under bf16 autocast."""
    import torch

    from neuralnet_tracker_traincode_torch.eval.predictor import InferenceNetwork

    class Bf16Network(InferenceNetwork):
        device = net.device
        input_resolution = net.input_resolution

        def __call__(self, images):
            with torch.autocast(self.device.type, dtype=torch.bfloat16), torch.inference_mode():
                out = net.model.eval()(images.to(self.device, torch.float32))
            out.pop("rot", None)
            return {k: v.float() for k, v in out.items()}

    return Bf16Network()


def report(net_filename, data_name, roi_config, args, builder, device):
    """One row: `net_filename` on dataset `data_name` at `roi_config`."""
    from neuralnet_tracker_traincode_torch import pipelines
    from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork, Predictor, load_pose_network
    from neuralnet_tracker_traincode_torch.eval.report import add_report_row

    loader = pipelines.make_validation_loader(data_name, use_head_roi=roi_config.use_head_roi)
    net = load_pose_network(net_filename, device)
    if args.precision == "bfloat16" and isinstance(net, CheckpointPoseNetwork):
        net = bf16_network(net)
    predictor = Predictor(net, roi_config.expansion_factor, device=device)
    errors = {}
    add_report_row(builder, predictor, loader, net_filename, data_name, roi_config, args.alignment_scheme,
                   errors_out=errors)
    if args.vis != "none":
        show_worst_cases(args, data_name, roi_config, predictor, errors[args.vis])


def show_worst_cases(args, data_name, roi_config, predictor, quantity, count: int = 32):
    """Overlays (ground truth green, prediction red) of the samples by
    decreasing `quantity`: the first `count` as `worst_NNN.png` in
    `--vis-outdir`, else all of them in a matplotlib pager."""
    from neuralnet_tracker_traincode_torch import pipelines, vis

    if quantity is None:
        print(f"Prediction for {args.vis} is not available.")
        return
    order = np.ascontiguousarray(np.argsort(np.asarray(quantity))[::-1])
    if args.vis_outdir:
        order = order[:count]
    loader = pipelines.make_validation_loader(data_name, order=order, use_head_roi=roi_config.use_head_roi)

    def gt_and_preds():
        for sample in loader:
            image = np.asarray(sample["image"])
            pred = predictor.predict_batch([image], np.asarray(sample["roi"])[None]).to_numpy()
            yield sample, next(iter(pred.undo_collate()))

    if args.vis_outdir:
        import cv2

        os.makedirs(args.vis_outdir, exist_ok=True)
        for i, gp in enumerate(gt_and_preds()):
            cv2.imwrite(join(args.vis_outdir, f"worst_{i:03d}.png"), vis.draw_prediction(gp)[..., ::-1])
        print(f"Wrote worst-case overlays to {args.vis_outdir}")
        return
    from matplotlib import pyplot  # the backend of the user's matplotlib settings

    fig, _button = vis.matplotlib_plot_iterable(gt_and_preds(), vis.draw_prediction)
    fig.suptitle(f"{data_name} / {roi_config}")
    pyplot.show()


def run(args) -> str:
    """Every row into the table; writes `--json` or prints the table, and
    returns what it wrote."""
    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.eval.report import RoiConfig, TableBuilder, comprehensive_roi_configs

    device = resolve_device(args.device)
    builder = TableBuilder()
    if args.comprehensive_roi:
        assert args.roi_expansion is None, "Conflicting arguments"
        roi_configs = comprehensive_roi_configs
    else:
        roi_configs = [RoiConfig(expansion_factor=args.roi_expansion) if args.roi_expansion is not None
                       else RoiConfig()]
    for net_filename in args.filenames:
        for name in args.ds.split("+"):
            for roi_config in roi_configs:
                report(net_filename, name, roi_config, args, builder, device)
    if args.json:
        assert args.json.endswith(".json")
        print(f"writing {args.json}")
        out = builder.build_json()
        with open(args.json, "w") as f:
            f.write(out)
        return out
    out = builder.build()
    print(out)
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
