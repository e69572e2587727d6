"""The localizer's trainer (counterpart of the JAX package's
`scripts/train_localizer.py`, as a library).

One step: `augment_batch_for_localizer` on the device (K2 and K3 in its
intensity stage) -> `LocalizerNet` forward in train mode (bf16 autocast when
the model asks for it, as the CLI builds it) -> the mean prob loss plus the
mean box loss -> backward -> global-norm clip 1.0 and Adam with one group
(`ClippedGroupAdam`) at the CLI's learning rate times the per-epoch table of
`exponential_up_then_steps(max(1, E // 10), 0.1, [E // 2])`.

`run_localizer_training` is the CLI's epoch loop: the losses stay on the
device during an epoch and come back in one transfer, the NaN watchdog,
`last.ckpt` every epoch (the JAX package's model file layout), the console
lines. Its batches are fused-batch dicts (`data/loader.py`) of frames tagged
`Tag.FACE_DETECTION`.
"""

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import record_function

from neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline import (
    LocalizerAugConfig,
    LocalizerAugParameters,
    augment_batch_for_localizer,
)
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.losses.losses import LocalizerBoxLoss, LocalizerProbLoss
from neuralnet_tracker_traincode_torch.train.loop import AdamState, ClippedGroupAdam, check_not_nan
from neuralnet_tracker_traincode_torch.train.plotting import ConsoleTrainOutput
from neuralnet_tracker_traincode_torch.train.schedules import exponential_up_then_steps


@dataclasses.dataclass
class LocalizerTrainerConfig:
    """The localizer CLI's options and defaults."""

    batchsize: int = 64
    lr: float = 1.0e-3
    epochs: int = 50
    samples_per_epoch: int = 10 * 1024
    grad_clip_norm: float = 1.0
    aug: LocalizerAugConfig = dataclasses.field(default_factory=LocalizerAugConfig)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.samples_per_epoch // self.batchsize)


@dataclasses.dataclass
class LocalizerTrainState:
    step: int
    opt_state: AdamState


class LocalizerTrainer:
    """Owns the localizer, its losses and optimizer; the parameters and
    BatchNorm statistics live in `model` (on `device`), updated in place."""

    def __init__(self, model: torch.nn.Module, config: LocalizerTrainerConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        n = config.epochs
        self.epoch_schedule = exponential_up_then_steps(max(1, n // 10), 0.1, [n // 2])
        groups = {name: "main" for name, _ in model.named_parameters()}
        self.tx = ClippedGroupAdam(config.lr, self.epoch_schedule, config.steps_per_epoch, n, groups,
                                   config.grad_clip_norm)
        self.prob_loss = LocalizerProbLoss()
        self.box_loss = LocalizerBoxLoss()

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(self, generator: Optional[torch.Generator] = None,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None) -> LocalizerTrainState:
        """Initialise the weights (flax's default init drawn from `generator`,
        or `state_dict`) and the optimizer state."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.cpu().init_weights(generator)
        self.model.to(self.device)
        return LocalizerTrainState(step=0, opt_state=self.tx.init(self.params()))

    def loss(self, pred: torch.Tensor, labels: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.mean(self.prob_loss(pred, labels)) + torch.mean(self.box_loss(pred, labels))

    def train_step(
        self,
        state: LocalizerTrainState,
        batch: Dict[str, Any],
        aug_params: Optional[LocalizerAugParameters] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[LocalizerTrainState, torch.Tensor]:
        """One optimizer step on a fused-batch dict (`image`, `roi`,
        `hasface`); the augmentation uses `aug_params` where given, else
        draws from `generator`. Returns the new state and the loss (a device
        scalar)."""
        dev = self.device
        with record_function("augment"):
            batch = {k: torch.as_tensor(batch[k]).to(dev) for k in ("image", "roi", "hasface")}
            x, labels = augment_batch_for_localizer(
                batch["image"], {"roi": batch["roi"], "hasface": batch["hasface"]}, self.config.aug,
                params=aug_params, generator=generator, device=dev,
            )
        self.model.train()
        with record_function("forward"):
            pred = self.model(x)
        with record_function("loss"):
            loss = self.loss(pred, labels)
        params = self.params()
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        with record_function("optimizer"):
            opt_state = self.tx.step(params, dict(zip(params, grads)), state.opt_state)
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), loss.detach()

    def save_checkpoint(self, filename: str):
        from neuralnet_tracker_traincode_torch.models import io as model_io

        model_io.save_model(self.model, None, filename)


def run_localizer_training(
    trainer: LocalizerTrainer,
    state: LocalizerTrainState,
    batches: Iterator[Dict[str, Any]],
    outdir: str,
    generator: Optional[torch.Generator] = None,
    log: Callable[[str], None] = print,
) -> Tuple[LocalizerTrainState, List[Dict[str, Any]]]:
    """`trainer.config.epochs` epochs of `steps_per_epoch` steps over
    `batches`, the augmentation drawing from `generator`; `last.ckpt` in
    `outdir` after every epoch. Returns the final state and one record per
    epoch (steps, host seconds, images/s, the mean and last loss)."""
    cfg = trainer.config
    os.makedirs(outdir, exist_ok=True)
    console = ConsoleTrainOutput()
    records = []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for _ in range(cfg.steps_per_epoch):
            batch = next(batches)
            state, loss = trainer.train_step(state, batch, generator=generator)
            losses.append(loss)
        per_step = torch.stack(losses).float().cpu()  # the epoch's one transfer
        train_s = time.perf_counter() - t0
        check_not_nan({"loss": per_step}, trainer.params(), batch, os.path.join(outdir, "notgood.pt"))
        step0 = state.step - len(losses)
        for i, v in enumerate(per_step.tolist()):
            console.add_train_point(epoch, step0 + i, "loss", v)
        console.summarize_train_values()
        console.update_graph()
        trainer.save_checkpoint(os.path.join(outdir, "last.ckpt"))
        ips = len(losses) * cfg.batchsize / train_s
        log(f"epoch {epoch + 1}/{cfg.epochs}: loss {float(per_step[-1]):.4f}, {ips:.0f} img/s")
        records.append(dict(epoch=epoch, steps=len(losses), train_s=train_s, images_per_s=ips,
                            loss=float(per_step.double().mean()), last_loss=float(per_step[-1])))
    log(f"Saved localizer to {os.path.join(outdir, 'last.ckpt')}")
    return state, records
