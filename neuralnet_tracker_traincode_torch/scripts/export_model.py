"""Export a trained checkpoint to ONNX for the opentrack plugin (counterpart
of the JAX package's `scripts/export_model.py`, with its flags).

    python -m neuralnet_tracker_traincode_torch.scripts.export_model \\
        model_files/NetworkWithPointHead_mobilenetv1/best.ckpt [--output m.onnx] [--full] [--half] \\
        [--quantize --calib-ds aflw2k3d] [--localizer] [--torch-checkpoint m.pt] [--device cpu]

The file is written by `export/onnx_export.py` (tiny weights scrubbed, BN
folded, opset 13, model_version 4); for the same weights it is byte-equal
to the JAX exporter's. Then the parity check runs the written file in
`TorchOnnxSession` against the eager network, both on `--device` (default
`cuda`) in f32, on one random input: within 1e-4 (5e-2 with `--half`, 2e-1
with `--quantize`, where the scale heads are informational). A failure
exits non-zero. The int8 scheme is the JAX package's (per-tensor
activations, min/max ranges): on a trained network its error can exceed
2e-1 on the check's random input (`PERF.md`); `--atol` or
`--no-parity-check` then decide. `--quantize` calibrates the int8 backbone on eval crops of
`--calib-ds` (a dataset name or a `.h5` path, read from `$DATADIR`).
`--torch-checkpoint` also writes `{state_dict, class_name, config}` in the
reference implementation's key layout.
"""

import argparse
import sys
from os.path import splitext
from typing import Iterator, List

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export a trained checkpoint to ONNX")
    parser.add_argument("checkpoint", help="model checkpoint (.ckpt)")
    parser.add_argument("--output", default=None, help="output .onnx path (default: the checkpoint's, .onnx)")
    parser.add_argument("--localizer", action="store_true", help="export a LocalizerNet checkpoint")
    parser.add_argument("--no-parity-check", dest="parity", action="store_false", default=True)
    parser.add_argument("--full", action="store_true", default=False,
                        help="every eval output under its own name (coord/pose/roi/unnormalized_quat/pt3d_68/"
                             "shapeparam/hasface + scales) instead of the opentrack subset")
    parser.add_argument("--atol", type=float, default=None,
                        help="parity tolerance (default 1e-4, 5e-2 for --half, 2e-1 for --quantize)")
    parser.add_argument("--half", "--posehalf", dest="half", action="store_true", default=False,
                        help="store the weights as FLOAT16")
    parser.add_argument("--quantize", action="store_true", default=False,
                        help="static int8 PTQ of the backbone convs (QDQ form), calibrated on --calib-ds crops")
    parser.add_argument("--calib-ds", type=str, default="aflw2k3d",
                        help="dataset name or .h5 path for the quantization's calibration")
    parser.add_argument("--calib-samples", type=int, default=256)
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="also write a reference-format torch checkpoint ({state_dict, class_name, config})")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def eval_crop_batches(samples, inputsize: int, device, limit: int, batchsize: int = 32) -> Iterator:
    """NCHW whitened eval crops (`augmentation/pipeline.py:crop_for_eval`,
    expansion 1.2) of the first `limit` samples (each with an `image` and a
    `roi`), `batchsize` at a time, on `device`: the JAX script's
    calibration input."""
    import torch

    from neuralnet_tracker_traincode_torch.augmentation.pipeline import crop_for_eval
    from neuralnet_tracker_traincode_torch.eval.metrics import as_numpy

    images: List[np.ndarray] = []
    rois: List[np.ndarray] = []

    def crops():
        pad = max(max(im.shape[0], im.shape[1]) for im in images)
        x = np.zeros((len(images), pad, pad, 1), np.uint8)
        for j, im in enumerate(images):
            x[j, : im.shape[0], : im.shape[1]] = im[..., :1]
        c, _ = crop_for_eval(torch.from_numpy(x).to(device), torch.from_numpy(np.stack(rois)), inputsize)
        return c.permute(0, 3, 1, 2)

    for count, sample in enumerate(samples):
        if count >= limit:
            break
        img = as_numpy(sample["image"])
        images.append(img[..., None] if img.ndim == 2 else img)
        rois.append(np.asarray(sample["roi"], np.float32))
        if len(images) == batchsize:
            yield crops()
            images, rois = [], []
    if images:
        yield crops()


def clear_model_denormals(model):
    """The model's float weights with |w| < 1e-20 set to 0, in place."""
    import torch

    from neuralnet_tracker_traincode_torch.export.onnx_export import clear_denormals

    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in clear_denormals(sd).items()})
    return model


def output_errors(model, sess, x_nhwc, full: bool = False, quat_sign_free: bool = False):
    """max |file - eager network| of each of the file's outputs on `x_nhwc`
    (whitened crops, NHWC, on the session's device), the eager network in
    eval mode under `f32_eval` on the same device. With `quat_sign_free`,
    a quaternion output's error is that of the nearer of q and -q (the same
    rotation: rounding flips the sign where the real part is near 0)."""
    import torch

    from neuralnet_tracker_traincode_torch.eval.predictor import f32_eval
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

    outs = dict(zip(sess.output_names, sess.run(None, {"x": x_nhwc.permute(0, 3, 1, 2)})))
    model = model.to(sess.device).eval()
    with f32_eval(sess.device), torch.inference_mode():
        if isinstance(model, LocalizerNet):
            ref = {"logit_box": model(x_nhwc)}
        else:
            r = model(x_nhwc)
            if full:
                ref = {k: r[k] for k in sess.output_names}
            else:
                ref = {"pos_size": r["coord"], "quat": r["pose"], "box": r["roi"]}
                if model.enable_uncertainty:
                    ref.update(pos_size_scales=r["coord_scales"], rotaxis_scales_tril=r["pose_scales_tril"],
                               box_scales=r["roi_scales"])
    return max_errors(outs, ref, quat_sign_free)


def max_errors(outs, ref, quat_sign_free: bool = False):
    """max |outs[k] - ref[k]| for each key of `ref` (on `ref`'s device); see
    `output_errors` for `quat_sign_free`."""
    import torch

    errors = {}
    for k, v in ref.items():
        a, b = outs[k].float().to(v.device), v.float()
        d = (a - b).abs()
        if quat_sign_free and k in ("quat", "pose"):
            d = torch.minimum(d.amax(-1), (a + b).abs().amax(-1))
        errors[k] = float(d.max())
    return errors


def parity_check(model, blob: bytes, args, device) -> float:
    """The largest error of the file's outputs against the eager network's
    on one random input (the scale heads of an int8 file aside); prints
    each output's error and exits non-zero above the tolerance."""
    import torch

    from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

    atol = args.atol if args.atol is not None else (2e-1 if args.quantize else 5e-2 if args.half else 1e-4)
    res = model.input_resolution
    shape = (1,) + tuple(res) + (1,) if isinstance(model, LocalizerNet) else (1, res, res, 1)
    x_nhwc = torch.from_numpy(np.random.RandomState(0).rand(*shape).astype(np.float32) - 0.5).to(device)
    worst = 0.0
    for k, err in output_errors(model, TorchOnnxSession(blob, device), x_nhwc, args.full).items():
        # int8: the uncertainty scale heads amplify the backbone's quantization noise (the reference calls its
        # PTQ result "too noisy" for mobilenet): informational only
        informational = args.quantize and "scales" in k
        if not informational:
            worst = max(worst, err)
        status = "OK" if err <= atol else ("INFO" if informational else "FAIL")
        print(f"  parity {k}: max err {err:.2e} [{status}]")
    if worst > atol:
        raise SystemExit(f"Parity check failed: {worst} > {atol}")
    print("Parity check passed.")
    return worst


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.export import onnx_export
    from neuralnet_tracker_traincode_torch.models.io import load_posenet
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

    device = resolve_device(args.device)
    model = clear_model_denormals(load_posenet(args.checkpoint))
    out_path = args.output or splitext(args.checkpoint)[0] + ".onnx"

    if args.torch_checkpoint:
        torch.save({"state_dict": model.state_dict(), "class_name": type(model).__name__,
                    "config": model.get_config()}, args.torch_checkpoint)
        print(f"Wrote reference-format torch checkpoint {args.torch_checkpoint}")

    if args.localizer or isinstance(model, LocalizerNet):
        assert not args.half and not args.quantize, "fp16 and int8 export are implemented for the pose network"
        blob = onnx_export.build_localizer_onnx(model)
    else:
        quant_ranges = None
        if args.quantize:
            from neuralnet_tracker_traincode_torch import pipelines

            loader = pipelines.make_validation_loader(args.calib_ds)
            batches = list(eval_crop_batches(loader, model.input_resolution, device, args.calib_samples))
            print(f"Calibrating on {sum(len(b) for b in batches)} samples from {args.calib_ds}")
            quant_ranges = onnx_export.calibrate_conv_ranges(onnx_export.build_posenet_onnx(model), batches, device)
        blob = onnx_export.build_posenet_onnx(model, outputs="full" if args.full else "opentrack", fp16=args.half,
                                              quant_ranges=quant_ranges)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"Wrote {out_path} ({len(blob)} bytes)")
    if args.parity:
        parity_check(model, blob, args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
