"""The localizer's evaluation (counterpart of the JAX package's
`scripts/evaluate_localizer.py`, as a library): is-face accuracy and the
box corner RMSE in input pixels at thresholds 0.25, 0.5 and 0.75.

Two protocols:
  full  the whole image rescaled, keeping its aspect, to the 224x288 input
        (`aspect_corrected_full_roi`), as a tracker feeds the localizer;
  crop  the deterministic context crop around the labelled ROI (the training
        distribution at extension 2.2, `augment_batch_for_localizer`).

Images are zero-padded to the largest side of the set and run in chunks of
`batchsize` (the last one zero-filled), as the script does. The forward and
the crops run under `eval/predictor.py:f32_eval` with the network in f32
and eval mode. `evaluate(..., on_chunk=...)` hands each chunk's network
inputs, predictions and targets to the caller (the CLI's overlays).
"""

import copy
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.augmentation.affine import transform_roi
from neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline import (
    LocalizerAugConfig,
    augment_batch_for_localizer,
)
from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.eval.metrics import LocalizerBoxMeanSquareErrors, LocalizerIsFaceMatches
from neuralnet_tracker_traincode_torch.eval.predictor import f32_eval
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d

OUT_H, OUT_W = 224, 288
THRESHOLDS = (0.25, 0.5, 0.75)


def aspect_corrected_full_roi(sizes_wh: np.ndarray) -> np.ndarray:
    """[0, 0, w, h] expanded (centred) to the 288/224 input aspect."""
    aspect = OUT_W / OUT_H
    w, h = sizes_wh[:, 0].astype(np.float32), sizes_wh[:, 1].astype(np.float32)
    tw = np.maximum(w, h * aspect)
    th = tw / aspect
    cx, cy = 0.5 * w, 0.5 * h
    return np.stack([cx - 0.5 * tw, cy - 0.5 * th, cx + 0.5 * tw, cy + 0.5 * th], axis=-1)


class LocalizerEvaluator:
    """A localizer from a checkpoint file or a module (copied), held in f32
    and eval mode on `device` (default: the card)."""

    def __init__(self, filename_or_model: Union[str, torch.nn.Module], device: DeviceLike = None):
        from neuralnet_tracker_traincode_torch.models.io import load_model
        from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet

        self.device = resolve_device(device)
        if isinstance(filename_or_model, str):
            model = load_model(filename_or_model, [LocalizerNet])
        else:
            model = copy.deepcopy(filename_or_model)
        model.dtype = torch.float32
        self.model = model.to(self.device).eval()
        # predictions and labels in input pixels: [-1, 1] crop units -> pixels
        self.px = torch.tensor([OUT_W, OUT_H, OUT_W, OUT_H], dtype=torch.float32, device=self.device) * 0.5

    def _outputs(self, x: torch.Tensor):
        pred = self.model.inference_outputs(self.model(x))
        return pred["hasface"], (pred["roi"] + 1.0) * self.px

    @torch.inference_mode()
    def eval_full(self, images: torch.Tensor, view_roi: torch.Tensor, roi_gt: torch.Tensor):
        """The `full` protocol on one chunk: (network input, face score,
        predicted box, labelled box), the boxes in input pixels."""
        with f32_eval(self.device):
            B = images.shape[0]
            tr = Affine2d.range_remap_2d(
                view_roi[..., :2], view_roi[..., 2:], torch.zeros((B, 2), device=self.device),
                torch.tensor([float(OUT_W), float(OUT_H)], device=self.device).expand(B, 2),
            )
            x = warp_affine(images, tr, (OUT_H, OUT_W), 1) * (1.0 / 256.0) - 0.5
            score, pred_roi = self._outputs(x)
            return x, score, pred_roi, transform_roi(tr, roi_gt)

    @torch.inference_mode()
    def eval_crop(self, images: torch.Tensor, roi_gt: torch.Tensor, hasface: torch.Tensor):
        """The `crop` protocol on one chunk, as `eval_full` returns it."""
        cfg = LocalizerAugConfig(deterministic=True, enable_image_aug=False)
        with f32_eval(self.device):
            x, labels = augment_batch_for_localizer(images, {"roi": roi_gt, "hasface": hasface}, cfg,
                                                    device=self.device)
            score, pred_roi = self._outputs(x)
            return x, score, pred_roi, (labels["roi"] + 1.0) * self.px

    def evaluate(
        self,
        samples: Sequence[Mapping],
        protocol: str = "full",
        batchsize: int = 32,
        thresholds: Sequence[float] = THRESHOLDS,
        on_chunk: Optional[Callable[[np.ndarray, Dict[str, np.ndarray], Dict[str, np.ndarray]], None]] = None,
    ) -> Dict[float, Tuple[float, float]]:
        """Accuracy (a fraction) and corner RMSE (pixels) at each threshold
        over `samples` (each with `image` (H, W[, C]) uint8, `roi` and an
        optional `hasface`, 1 where absent). `on_chunk(x, preds, targets)`
        gets each chunk's whitened network inputs (B, 224, 288, 1) and its
        predictions and targets, the chunk's filler rows cut off."""
        assert protocol in ("full", "crop"), protocol
        pad = max(max(np.asarray(s["image"]).shape[:2]) for s in samples)
        metrics = {t: (LocalizerIsFaceMatches(t), LocalizerBoxMeanSquareErrors(t)) for t in thresholds}
        for start in range(0, len(samples), batchsize):
            chunk = samples[start:start + batchsize]
            B = len(chunk)
            images = np.zeros((batchsize, pad, pad, 1), np.uint8)
            sizes = np.zeros((batchsize, 2), np.int32)
            roi = np.zeros((batchsize, 4), np.float32)
            hasface = np.zeros((batchsize,), np.float32)
            for j, s in enumerate(chunk):
                img = np.asarray(s["image"])
                if img.ndim == 2:
                    img = img[..., None]
                h, w = img.shape[:2]
                images[j, :h, :w] = img[..., :1]
                sizes[j] = (w, h)
                roi[j] = np.asarray(s["roi"], np.float32)
                hasface[j] = float(np.asarray(s.get("hasface", 1.0)))
            dev = self.device
            images_d, roi_d = torch.from_numpy(images).to(dev), torch.from_numpy(roi).to(dev)
            if protocol == "full":
                view = torch.from_numpy(aspect_corrected_full_roi(sizes)).to(dev)
                x, score, pred_roi, gt_roi = self.eval_full(images_d, view, roi_d)
            else:
                x, score, pred_roi, gt_roi = self.eval_crop(images_d, roi_d, torch.from_numpy(hasface).to(dev))
            preds = {"hasface": score.cpu().numpy()[:B], "roi": pred_roi.cpu().numpy()[:B]}
            targets = {"hasface": hasface[:B], "roi": gt_roi.cpu().numpy()[:B]}
            for acc, mse in metrics.values():
                acc.update(preds, targets)
                mse.update(preds, targets)
            if on_chunk is not None:
                on_chunk(x[:B].cpu().numpy(), preds, targets)
        results = {}
        for t, (acc_m, mse_m) in metrics.items():
            matches = np.asarray(acc_m.compute(), np.float64)
            err = np.asarray(mse_m.compute())
            err = err[np.isfinite(err)]
            rmse = float(np.sqrt(np.average(err.ravel()))) if err.size else float("nan")
            results[t] = (float(np.average(matches)), rmse)
        return results


def result_lines(results: Dict[float, Tuple[float, float]]) -> str:
    """The script's result lines, one per threshold."""
    return "\n".join(f"Threshold {t} => Acc {acc * 100:.0f}%, corner RMSE {rmse:.2f} px"
                     for t, (acc, rmse) in results.items())
