"""Inference networks and the crop -> infer -> backtransform Predictor
(counterpart of the JAX package's `eval/predictor.py`).

The Predictor packs a chunk of ragged HWC uint8 images on the host into one
pinned buffer, zero-padded to a multiple of 64, copies it to its device once,
crops each face ROI there (`augmentation/warp.py:warp_affine`, 2x
oversampled; the recorded transform is inverted for the backtransform), runs
the network, un-normalizes the predictions to crop pixels and maps them back
into the image frame. Its device is CUDA unless the caller asks for the CPU.

The eval runs in f32 whatever the caller's context: bf16 or TF32 rounding
trips the 6D head's orthonormality fallback, which turns trained rotations
into the identity (`docs/CONVERGENCE.md`), and rounds the crop transform and
the backtransformed coordinates. So `CheckpointPoseNetwork` and the
Predictor's whole chunk (transform, crop, forward, backtransform) run under
`f32_eval`: autocast off, TF32 off for cuDNN and cuBLAS and cuDNN
deterministic (the flags restored afterwards); the network in eval mode
under `torch.inference_mode()`. `OnnxPoseNetwork` runs an exported `.onnx`
file in the port's executor (`export/onnx_run.py:TorchOnnxSession`) on the
same device, under the same `f32_eval`.
"""

import contextlib
import copy
import time
from abc import ABCMeta, abstractmethod
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from neuralnet_tracker_traincode_torch import utils
from neuralnet_tracker_traincode_torch.augmentation.affine import apply_affine2d, position_unnormalization
from neuralnet_tracker_traincode_torch.augmentation.geometric import focus_roi_transform, no_roi_randomization
from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
from neuralnet_tracker_traincode_torch.data.batch import Batch, Metadata
from neuralnet_tracker_traincode_torch.data.fields import FieldCategory
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.eval.metrics import as_numpy
from neuralnet_tracker_traincode_torch.ops.affine2d import Affine2d

PRED_CATEGORIES = {
    "coord": FieldCategory.xys,
    "pose": FieldCategory.quat,
    "pt3d_68": FieldCategory.points,
    "roi": FieldCategory.roi,
}


class InferenceNetwork(metaclass=ABCMeta):
    device: torch.device

    @abstractmethod
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: whitened f32 (B, S, S, 1)."""

    @property
    @abstractmethod
    def input_resolution(self) -> int: ...


@contextlib.contextmanager
def f32_eval(device: torch.device):
    """Autocast off on `device`, no TF32 in cuDNN or cuBLAS, deterministic
    cuDNN; the backend flags are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = False, False, True
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


class CheckpointPoseNetwork(InferenceNetwork):
    """A pose network from a checkpoint file (`models/io.py:load_posenet`)
    or a module (copied), held in f32 on `device` (default: the card)."""

    def __init__(self, filename_or_model: Union[str, torch.nn.Module], device: DeviceLike = None):
        from neuralnet_tracker_traincode_torch.models.io import load_posenet

        self.device = resolve_device(device)
        if isinstance(filename_or_model, str):
            model = load_posenet(filename_or_model)
        else:
            model = copy.deepcopy(filename_or_model)
        model.dtype = torch.float32  # the eval forward runs in f32, whatever the model trained in
        self.model = model.to(self.device).eval()

    @property
    def input_resolution(self) -> int:
        return self.model.input_resolution

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with f32_eval(self.device), torch.inference_mode():
            out = self.model.eval()(images.to(self.device, torch.float32))
        out.pop("rot", None)  # eval consumers use the quaternion 'pose'
        return out


class OnnxPoseNetwork(InferenceNetwork):
    """An exported pose network (`.onnx`) in `TorchOnnxSession` on `device`
    (default: the card), its opentrack output names mapped to the eval's.

    Files with a `model_version` other than 2, 3 and 4 give quaternions in
    the legacy coordinates, remapped here; a graph whose batch dimension is
    fixed runs one frame at a time. The input resolution comes from the
    graph's input shape, 129 where it is symbolic or implausible (a raw
    `dim_value` of -1 decodes as a huge unsigned varint)."""

    NAMEMAP = {
        "pos_size": "coord",
        "quat": "pose",
        "box": "roi",
        "eyes": "eyeparam",
        "pos_size_scales": "coord_scales",
        "pos_size_std": "coord_scales",
        "rotaxis_scales_tril": "pose_scales_tril",
        "rotaxis_std": "pose_scales_tril",
        "rot_conc_tril": "pose_conc_tril",
        "box_scales": "roi_scales",
        "box_std": "roi_scales",
    }

    def __init__(self, modelfile: str, device: DeviceLike = None):
        from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession

        self.device = resolve_device(device)
        self.session = TorchOnnxSession(modelfile, self.device)
        self.output_names = [self.NAMEMAP.get(n, n) for n in self.session.output_names]
        self._legacy_coords = self.session.model_version not in (2, 3, 4)
        # legacy exports may list initializers among the graph's inputs: the data input is the first
        dims = next(iter(self.session.input_dims.values()), None) or []
        plausible = [d is not None and 0 < d < 10_000 for d in dims]
        self._input_resolution = int(dims[-1]) if len(dims) == 4 and plausible[-1] else 129
        self._single_frame = bool(dims) and plausible[0]

    @property
    def input_resolution(self) -> int:
        return self._input_resolution

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()  # the graphs take NCHW
        if self._single_frame:
            per_frame = [self.session.run(None, {"x": x[i : i + 1]}) for i in range(x.shape[0])]
            outputs = [torch.cat(o) for o in zip(*per_frame)]
        else:
            outputs = self.session.run(None, {"x": x})
        outputs = dict(zip(self.output_names, outputs))
        if self._legacy_coords:
            q = outputs["pose"]
            outputs["pose"] = torch.stack([-q[..., 2], -q[..., 1], -q[..., 0], q[..., 3]], dim=-1)
        return outputs


def load_pose_network(filename: str, device: DeviceLike = None) -> InferenceNetwork:
    if filename.endswith(".onnx"):
        return OnnxPoseNetwork(filename, device)
    return CheckpointPoseNetwork(filename, device)


class _StageClock:
    """Host milliseconds of each stage of a chunk, appended to `record[name]`,
    with the device synchronized at the stage's end; does nothing without
    a record."""

    def __init__(self, record: Optional[Dict[str, List[float]]], device: torch.device):
        self.record, self.device = record, device
        self.t = time.perf_counter()

    def lap(self, name: str):
        if self.record is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.record.setdefault(name, []).append((now - self.t) * 1e3)
        self.t = now


class Predictor:
    """Crop -> infer -> backtransform to the original image frame."""

    def __init__(
        self,
        net: Union[InferenceNetwork, str],
        focus_roi_expansion_factor: float = 1.1,
        device: DeviceLike = None,
        crop_backend: str = "device",
    ):
        """crop_backend: "device" (the gather warp on the Predictor's
        device) or "cv2" (the reference's host crop, `cv2_crop.py`)."""
        assert crop_backend in ("device", "cv2"), crop_backend
        self.device = resolve_device(device)
        self._net = net if isinstance(net, InferenceNetwork) else load_pose_network(net, self.device)
        self._expansion = focus_roi_expansion_factor
        self._crop_backend = crop_backend
        if crop_backend == "cv2":
            from neuralnet_tracker_traincode_torch.eval.cv2_crop import import_cv2

            import_cv2()

    @property
    def net(self) -> InferenceNetwork:
        return self._net

    @property
    def expansion_factor(self) -> float:
        return self._expansion

    def _pack(self, images: List[np.ndarray], maxdim: int) -> torch.Tensor:
        """The chunk zero-padded into one (pinned, for a card) host buffer,
        copied to the device once."""
        C = images[0].shape[2]
        packed = torch.zeros((len(images), maxdim, maxdim, C), dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        host = packed.numpy()
        for i, im in enumerate(images):
            host[i, : im.shape[0], : im.shape[1], :] = im
        return packed.to(self.device, non_blocking=True)

    def _crop_images_cv2(self, images: List[np.ndarray], rois: np.ndarray, size: int) -> torch.Tensor:
        from neuralnet_tracker_traincode_torch.eval.cv2_crop import compute_view_roi_np, croprescale_cv2

        view_rois = compute_view_roi_np(rois, self._expansion)
        crops = np.empty((len(images), size, size, 1), np.uint8)
        for i, (im, vroi) in enumerate(zip(images, view_rois)):
            crops[i] = croprescale_cv2(im, vroi, size)
        return torch.from_numpy(crops).to(self.device).float()

    def predict_batch(self, images: List[np.ndarray], rois, _clock: Optional[_StageClock] = None) -> Batch:
        """images: list of HWC (or HW) uint8 arrays (ragged); rois: (B, 4).
        The predictions are tensors on the Predictor's device."""
        clock = _clock or _StageClock(None, self.device)
        images = [np.asarray(im)[..., None] if np.ndim(im) == 2 else np.asarray(im) for im in images]
        B = len(images)
        rois = np.asarray(rois, np.float32)
        assert rois.shape == (B, 4), f"Bad roi shape {rois.shape}"
        size = self._net.input_resolution
        maxdim = max(max(im.shape[0], im.shape[1]) for im in images)
        with f32_eval(self.device), torch.inference_mode():
            tr = focus_roi_transform(
                torch.from_numpy(rois).to(self.device), no_roi_randomization((B,), self._expansion, self.device), size
            )
            if self._crop_backend == "cv2":
                clock.lap("pack_copy_ms")
                crops = self._crop_images_cv2(images, rois, size)
            else:
                maxdim = utils.ceil_to_multiple(maxdim)
                packed = self._pack(images, maxdim)
                clock.lap("pack_copy_ms")
                crops = warp_affine(packed, tr, size)
            x = crops * (1.0 / 256.0) - 0.5
            clock.lap("crop_ms")
            preds = dict(self._net(x))
            # un-normalize from [-1, 1] crop space to crop pixels, then back to the image
            tr_unnorm = Affine2d(position_unnormalization(size, size).tensor().to(self.device))
            back = tr.inv()
            for k, c in PRED_CATEGORIES.items():
                if k in preds:
                    preds[k] = apply_affine2d(back, k, apply_affine2d(tr_unnorm, k, preds[k], c), c)
        clock.lap("forward_backtransform_ms")
        return Batch(Metadata((maxdim, maxdim), B, categories=dict(PRED_CATEGORIES)), preds)

    def evaluate(self, metric, loader, chunksize: int = 128, stage_ms: Optional[Dict[str, List[float]]] = None):
        """Stream single-frame samples through the predictor into a metric.
        With `stage_ms`, each chunk appends its host milliseconds per stage
        (packing and copy, crop, forward and backtransform, metrics), the
        device synchronized at each stage's end."""
        for samples in utils.iter_batched(loader, chunksize):
            clock = _StageClock(stage_ms, self.device)
            # shallow copies: callers may iterate the same samples again
            samples = [s.copy() for s in samples]
            images = [as_numpy(s.pop("image")) for s in samples]
            batch = Batch.collate(samples)
            preds = self.predict_batch(images, as_numpy(batch["roi"]), clock).to_numpy()
            batch["image"] = images  # ragged, for the perspective-correction metrics
            metric.update(preds, batch)
            clock.lap("metrics_ms")
        return metric.compute()

    def predict_cropped_normalized_batch(self, images) -> Batch:
        """For crops already cut and normalized to [0, 1]: (B, S, S, 1)."""
        with f32_eval(self.device), torch.inference_mode():
            x = torch.as_tensor(images).to(self.device) - 0.5
            preds = self._net(x)
        meta = Metadata(tuple(x.shape[1:3]), x.shape[0], categories=dict(PRED_CATEGORIES))
        return Batch(meta, dict(preds))

    def evaluate_cropped_normalized(self, metric, loader):
        for batch in loader:
            preds = self.predict_cropped_normalized_batch(batch["image"])
            metric.update(preds, batch)
        return metric.compute()
