"""Temporal and robustness analyses of pose networks (counterpart of the JAX
package's `scripts/evaluate_stability.py`, with its modes, files and
printed lines).

    DATADIR=/path/to/h5 python -m neuralnet_tracker_traincode_torch.scripts.evaluate_stability \\
        MODE model_files/NetworkWithPointHead_mobilenetv1/best.ckpt [...] [--outdir DIR] [--max-samples N] \\
        [--device cpu]

Modes:
  open-loop      track the frames of the "myself" video with the ground-truth
                 ROIs; the blink-window report
  closed-loop    the same, each frame cropped at the previous frame's predicted ROI
  pitch-yaw      pitch against yaw over the yaw video and six Biwi sections
  noise-resist   geodesic error against gaussian input noise (host noise from
                 numpy's RandomState(1234), as the JAX script draws it)
  uncertainty-correlation  the predicted pose uncertainty against the error
  variation-resist  the spread of the predictions over frames of one pose
                 that vary in expression and background

A file is a checkpoint or an exported `.onnx` file; a directory stands for
its model files. Each mode is an analysis on the port's `Predictor` (on
`--device`, the card by default), which returns arrays, and a drawing
function, which writes the mode's figure into `--outdir` with matplotlib;
noise-resist also writes `noise_resist.pkl` (levels, {level: [error per
model]}). `main` imports matplotlib at its start, so a machine without it
fails before any model is loaded. The analyses run under
`np.errstate(all="raise")`, as the JAX script runs under `np.seterr`.
"""

import argparse
import itertools
import os
import pickle
import sys
from collections import defaultdict
from os.path import isdir, join
from typing import Dict, List, NamedTuple, Optional

import numpy as np

# blink frame intervals of the "myself" video (the reference's developer recording)
BLINKS = [(90, 110), (570, 590), (1610, 1630), (2000, 2020)]
CROP_FACTORS = (1.0, 1.2)
NOISE_LEVELS = (0.0, 2.0, 8.0, 16.0, 32.0, 48.0, 64.0)  # sigma on the [0, 255] scale
NOISE_SEED, NOISE_CHUNK = 1234, 128
BIWI_SECTIONS = [(145, 216), (1360, 1464), (3030, 3120), (8020, 8100), (6570, 6600), (9030, 9080)]


class Poses(NamedTuple):
    hpb: np.ndarray  # (N, 3) heading, pitch, bank
    xy: np.ndarray  # (N, 2)
    sz: np.ndarray  # (N,)


def convertlabels(labels: Dict[str, np.ndarray]) -> Poses:
    from neuralnet_tracker_traincode_torch import utils

    coord = np.asarray(labels["coord"])
    return Poses(hpb=utils.as_hpb(utils.convert_to_rot(np.asarray(labels["pose"]))), xy=coord[:, :2], sz=coord[:, 2])


def limit(loader, max_samples: Optional[int]):
    """The first `max_samples` samples as a list, or the loader itself."""
    return loader if max_samples is None else list(itertools.islice(iter(loader), max_samples))


def find_models(path: str) -> List[str]:
    if isdir(path):
        return [join(path, fn) for fn in sorted(os.listdir(path)) if fn.endswith((".ckpt", ".nnckpt", ".onnx"))]
    return [path]


# ---------------------------------------------------------------------------------------------------------------
# the analyses: a Predictor and samples in, arrays out


def blink_stability(poses_list: List[Poses], blinks=None) -> Optional[Dict[str, np.ndarray]]:
    """The root mean square of the differences between the frames 5 before
    and 5 after each blink window's edges, averaged over `poses_list`, for
    "hpb" (degrees), "sz" and "xy"; None when no window fits the shortest
    sequence."""
    blinks = blinks or BLINKS
    n = min(len(p.hpb) for p in poses_list)
    blinks = [(a, b) for a, b in blinks if b + 5 < n and a - 5 >= 0]
    if not blinks:
        return None
    xs = np.asarray([a for a, b in blinks] + [b for a, b in blinks], dtype=np.int64)
    lefts, rights = xs - 5, xs + 5

    def rms(vals):
        return np.sqrt(np.mean(np.square(vals[lefts] - vals[rights]), axis=0))

    out = {}
    for name in ["hpb", "sz", "xy"]:
        vals = np.average([np.atleast_1d(rms(getattr(p, name))) for p in poses_list], axis=0)
        out[name] = vals * 180.0 / np.pi if name == "hpb" else vals
    return out


def report_blink_stability(poses_list: List[Poses], blinks=None) -> Optional[Dict[str, np.ndarray]]:
    """Prints the JAX script's lines for `blink_stability` and returns its numbers."""
    out = blink_stability(poses_list, blinks)
    if out is None:
        print("\t (sequence too short for the blink windows)")
        return None
    for name, vals in out.items():
        print(f"\t {name:4s}: " + ", ".join(f"{x:0.2f}" for x in np.atleast_1d(vals)))
    return out


def open_loop_tracking(predictor, loader) -> Poses:
    """Each frame cropped at its ground-truth ROI."""
    from neuralnet_tracker_traincode_torch.eval import metrics as M

    metric = M.MetricCollection({"pose": M.PredExtractor("pose"), "coord": M.PredExtractor("coord")})
    return convertlabels(predictor.evaluate(metric, loader))


def closed_loop_tracking(predictor, loader) -> Poses:
    """Frame t cropped at frame t-1's predicted ROI (clipped to the image),
    the first at its ground-truth ROI: one frame a call, since each crop
    needs the previous prediction."""
    current_roi = None
    poses, coords = [], []
    for sample in loader:
        image = np.asarray(sample["image"])
        roi = np.asarray(sample["roi"], np.float32) if current_roi is None else current_roi
        pred = predictor.predict_batch([image], roi[None, :]).to_numpy()
        x0, y0, x1, y1 = pred["roi"][0]
        h, w = image.shape[:2]
        current_roi = np.asarray([max(0.0, x0), max(0.0, y0), min(x1, w), min(y1, h)], np.float32)
        poses.append(pred["pose"][0])
        coords.append(pred["coord"][0])
    return convertlabels({"pose": np.stack(poses), "coord": np.stack(coords)})


def pitch_yaw_poses(predictor, loader) -> Poses:
    """The predictions with heading, pitch and bank in degrees."""
    poses = open_loop_tracking(predictor, loader)
    return poses._replace(hpb=poses.hpb * 180.0 / np.pi)


def noisy_images(samples, noiselevel: float, rng: np.random.RandomState) -> List[np.ndarray]:
    """The samples' images plus gaussian noise of sigma `noiselevel` drawn
    from `rng` in f64 on the host, clipped and cast to uint8."""
    out = []
    for s in samples:
        im = np.asarray(s["image"], np.float32)
        im = im + rng.randn(*im.shape) * noiselevel
        out.append(np.clip(im, 0, 255).astype(np.uint8))
    return out


def noise_resist(predictor, samples, noiselevels, rng: np.random.RandomState) -> np.ndarray:
    """(levels, N) geodesic errors (radians) of the predictions on the
    samples' images under each noise level, in chunks of 128; the noise is
    drawn level by level, chunk by chunk, sample by sample."""
    from neuralnet_tracker_traincode_torch.data.batch import Batch
    from neuralnet_tracker_traincode_torch.eval import metrics as M
    from neuralnet_tracker_traincode_torch.utils import iter_batched

    errors = []
    for noiselevel in noiselevels:
        metric = M.GeodesicError()
        for chunk in iter_batched(samples, NOISE_CHUNK):
            images = noisy_images(chunk, noiselevel, rng)
            labels = [s.copy() for s in chunk]
            for s in labels:
                s.pop("image")
            batch = Batch.collate(labels)
            preds = predictor.predict_batch(images, np.stack([np.asarray(s["roi"]) for s in chunk])).to_numpy()
            metric.update(preds, batch)
        errors.append(np.asarray(metric.compute()))
    return np.stack(errors)


def uncertainty_error_correlation(predictor, loader):
    """(geodesic errors (N,), uncertainties (N,), their correlation): the
    uncertainty is sqrt(||tril tril^T||_F) of the pose head's scale factor;
    the correlation is nan where either is constant."""
    from neuralnet_tracker_traincode_torch.eval import metrics as M

    metric = M.MetricCollection({"pose": M.GeodesicError(), "pose_scales_tril": M.PredExtractor("pose_scales_tril")})
    results = predictor.evaluate(metric, loader)
    tril = np.asarray(results["pose_scales_tril"])
    cov = np.matmul(tril, np.swapaxes(tril, -1, -2))
    uncertainty = np.sqrt(np.linalg.norm(cov, axis=(-1, -2)))
    rot_err = np.asarray(results["pose"])
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = np.corrcoef(rot_err, uncertainty)[0, 1]
    return rot_err, uncertainty, corr


def stability_vs_variations(predictor, loader):
    """(mean rotation of each individual's predictions (I, 4) quaternions,
    the mean geodesic deviation from it (I,), the ground-truth poses (N, 4)):
    the frames of one individual share a pose and vary in expression and
    background."""
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch.eval import metrics as M
    from neuralnet_tracker_traincode_torch.eval.alignment import compute_mean_rotation

    metric = M.MetricCollection({"pose": M.PredExtractor("pose"), "individual": M.LabelExtractor("individual"),
                                 "pose_gt": M.LabelExtractor("pose")})
    results = predictor.evaluate(metric, loader)
    quats, individuals = np.asarray(results["pose"]), np.asarray(results["individual"])
    means, deviations = [], []
    for ind in np.unique(individuals):
        rots = Rotation.from_quat(quats[individuals == ind])
        mean = compute_mean_rotation(rots)
        means.append(mean.as_quat())
        deviations.append(np.mean((mean.inv() * rots).magnitude()))
    return np.stack(means), np.asarray(deviations), np.asarray(results["pose_gt"])


# ---------------------------------------------------------------------------------------------------------------
# the figures


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    return pyplot


def _save(fig, outdir: str, name: str):
    fn = join(outdir, name)
    fig.savefig(fn)
    _pyplot().close(fig)
    print(f"saved {fn}")


def draw_tracking(runs: List[Poses], crop_size_factor: float, outdir: str):
    fig, axes = _pyplot().subplots(3, 1, figsize=(14, 8), sharex=True)
    for poses in runs:
        axes[0].plot(poses.hpb * 180 / np.pi)
        axes[1].plot(poses.xy)
        axes[2].plot(poses.sz)
    axes[0].set(ylabel="hpb [deg]")
    axes[1].set(ylabel="xy")
    axes[2].set(ylabel="size")
    fig.suptitle(f"crop={crop_size_factor}")
    _save(fig, outdir, f"tracking_crop{crop_size_factor:.1f}.pdf")


def draw_pitch_vs_yaw(yaw_video: Dict[str, Poses], biwi: Dict[str, Poses], starts, outdir: str):
    fig, axes = _pyplot().subplots(2, 1, figsize=(20, 8))
    for name, poses in yaw_video.items():
        axes[0].scatter(poses.hpb[:, 0], poses.hpb[:, 1], label=name, s=5.0)
    axes[0].set(xlabel="yaw", ylabel="pitch")
    axes[0].legend()
    for j, poses in enumerate(biwi.values()):
        for i, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
            axes[1].plot(poses.hpb[a:b, 0], poses.hpb[a:b, 1], c="rgbcmy"[i % 6], alpha=1.0 if j == 0 else 0.5)
    axes[1].set(xlabel="yaw", ylabel="pitch")
    _save(fig, outdir, "pitch_vs_yaw.pdf")


def draw_noise_resist(levels, errors_deg: np.ndarray, outdir: str):
    """errors_deg: (levels, models)."""
    fig, ax = _pyplot().subplots(1, 1)
    ax.errorbar(levels, errors_deg.mean(axis=-1), yerr=errors_deg.std(axis=-1), capsize=10.0)
    ax.set(xlabel="input noise", ylabel="rot err [deg]")
    _save(fig, outdir, "noise_resist.pdf")


def draw_uncertainty_vs_error(runs, outdir: str):
    """runs: (geodesic errors, uncertainties) of each model, radians."""
    fig, ax = _pyplot().subplots(1, 1, dpi=120, figsize=(4, 3))
    for rot_err, uncertainty in runs:
        ax.scatter(rot_err * 180 / np.pi, uncertainty * 180 / np.pi, s=10.0, alpha=0.5, edgecolor="none",
                   rasterized=True)
    ax.set(xlabel="geo. err. deg", ylabel="uncertainty deg")
    ax.grid()
    _save(fig, outdir, "uncertainty_vs_err.pdf")


def draw_variations(runs, gt_quats: np.ndarray, outdir: str):
    """runs: (label, mean quaternions of the individuals) of each model."""
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch import utils

    fig, ax = _pyplot().subplots(1, 1, figsize=(8, 8))
    for label, means in runs:
        hpb = utils.as_hpb(Rotation.from_quat(means)) * 180 / np.pi
        ax.scatter(hpb[:, 0], hpb[:, 1], s=40.0, marker="x", label=label)
    gt = utils.as_hpb(Rotation.from_quat(gt_quats))
    ax.scatter(gt[:, 0] * 180 / np.pi, gt[:, 1] * 180 / np.pi, c="k", marker="+", label="GT")
    ax.set(xlabel="yaw [deg]", ylabel="pitch [deg]")
    ax.legend()
    _save(fig, outdir, "variation_resist.pdf")


# ---------------------------------------------------------------------------------------------------------------
# the modes


def _predictor(checkpoint, crop_size_factor, args):
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor

    return Predictor(checkpoint, crop_size_factor, device=args.device)


def _loader(name, args, **kwargs):
    from neuralnet_tracker_traincode_torch import pipelines

    return limit(pipelines.make_validation_loader(name, **kwargs), args.max_samples)


def _track(args, tracking_fn):
    loader = _loader("myself", args)
    poses_by_path = defaultdict(list)
    for crop_size_factor in CROP_FACTORS:
        runs = []
        for path in args.filename:
            for checkpoint in find_models(path):
                runs.append(tracking_fn(_predictor(checkpoint, crop_size_factor, args), loader))
                poses_by_path[path].append(runs[-1])
        draw_tracking(runs, crop_size_factor, args.outdir)
    for path in args.filename:
        print(f"Checkpoint: {path} (blink-window MSE)")
        report_blink_stability(poses_by_path[path])


def main_open_loop(args):
    _track(args, open_loop_tracking)


def main_closed_loop(args):
    _track(args, closed_loop_tracking)


def biwi_sections_loader(max_samples: Optional[int]):
    """The Biwi sections' frames and the sections' starts; `max_samples`
    cuts the list of sections, so that the starts stay those of the frames."""
    from neuralnet_tracker_traincode_torch import pipelines

    intervals = BIWI_SECTIONS
    if max_samples is not None:
        left, kept = max_samples, []
        for a, b in intervals:
            n = min(b - a, left)
            if n <= 0:
                break
            kept.append((a, a + n))
            left -= n
        intervals = kept
    indices = np.concatenate([np.arange(a, b) for a, b in intervals])
    loader = pipelines.make_validation_loader("biwi", order=indices)
    return loader, np.cumsum([0] + [(b - a) for a, b in intervals])


def main_analyze_pitch_vs_yaw(args):
    def predict_all(loader):
        return {path: pitch_yaw_poses(_predictor(path, 1.1, args), loader) for path in args.filename}

    yaw_video = predict_all(_loader("myself_yaw", args))
    loader, starts = biwi_sections_loader(args.max_samples)
    draw_pitch_vs_yaw(yaw_video, predict_all(loader), starts, args.outdir)


def main_analyze_noise_resist(args):
    rng = np.random.RandomState(NOISE_SEED)
    metrics_by_noise = defaultdict(list)
    for path in args.filename:
        for checkpoint in find_models(path):
            predictor = _predictor(checkpoint, 1.2, args)
            samples = list(_loader("aflw2k3d", args, use_head_roi=True))
            for noiselevel, errors in zip(NOISE_LEVELS, noise_resist(predictor, samples, NOISE_LEVELS, rng)):
                err = float(np.mean(errors))
                metrics_by_noise[noiselevel].append(err)
                print(f"{checkpoint} noise={noiselevel}: geo err {err * 180 / np.pi:.2f} deg")
    levels = list(NOISE_LEVELS)
    draw_noise_resist(levels, np.asarray([metrics_by_noise[lv] for lv in levels]) * 180.0 / np.pi, args.outdir)
    with open(join(args.outdir, "noise_resist.pkl"), "wb") as f:
        pickle.dump((levels, dict(metrics_by_noise)), f)


def main_analyze_uncertainty_error_correlation(args):
    runs = []
    for path in args.filename:
        for checkpoint in find_models(path):
            loader = _loader("aflw2k3d", args, use_head_roi=True)
            rot_err, uncertainty, corr = uncertainty_error_correlation(_predictor(checkpoint, 1.2, args), loader)
            runs.append((rot_err, uncertainty))
            print(f"{checkpoint}: corr(err, uncertainty) = {corr:.3f}")
    draw_uncertainty_vs_error(runs, args.outdir)


def main_analyze_stability_vs_variations(args):
    loader = _loader("replicantface-stability", args)
    runs = []
    for path in args.filename:
        for checkpoint in find_models(path):
            means, deviations, gt = stability_vs_variations(_predictor(checkpoint, 1.2, args), loader)
            runs.append((checkpoint[-20:], means))
            print(f"{checkpoint}: mean deviation {np.average(deviations) * 180 / np.pi:.2f} deg")
    draw_variations(runs, gt, args.outdir)


DISPATCH = {
    "open-loop": main_open_loop,
    "closed-loop": main_closed_loop,
    "pitch-yaw": main_analyze_pitch_vs_yaw,
    "noise-resist": main_analyze_noise_resist,
    "uncertainty-correlation": main_analyze_uncertainty_error_correlation,
    "variation-resist": main_analyze_stability_vs_variations,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluates model stability")
    parser.add_argument("mode", choices=list(DISPATCH))
    parser.add_argument("filename", nargs="+", type=str)
    parser.add_argument("--outdir", default="stability", type=str,
                        help="where the figures go (default: ./stability)")
    parser.add_argument("--max-samples", type=int, default=None, help="cap every analysis to the first N samples")
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    from neuralnet_tracker_traincode_torch.device import resolve_device
    from neuralnet_tracker_traincode_torch.vis import matplotlib_import_error

    args = build_parser().parse_args(argv)
    error = matplotlib_import_error()
    if error is not None:  # before any model is loaded
        raise ImportError(f"evaluate_stability draws its figures with matplotlib, which does not import: {error}")
    args.device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    with np.errstate(all="raise"):
        DISPATCH[args.mode](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
