"""The training step (counterpart of the JAX package's `train/loop.py`).

One step: augmentation on the device (K1, K2, K3) -> forward of the pose
network in train mode (bf16 autocast when the model asks for it) -> masked
multi-task loss -> backward through autograd -> global-norm clip -> Adam with
parameter groups on the epoch-table schedule.

The optimizer is written out rather than taken from `torch.optim`, because
it must do what the JAX package's optax chain does:
 - `optax.clip_by_global_norm` scales by max/norm only when norm > max
   (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead);
 - `optax.adam` (b1 0.9, b2 0.999, eps 1e-8 outside the square root) with
   the learning rate of the step count BEFORE the increment;
 - NLL scale parameters ('variance') train at 0.1x the learning rate;
   the transformer blocks of hybrid_vit ('transformer') at 0.01x with
   decoupled weight decay 0.01 (`optax.adamw`).

SWA keeps an equal-weight running average of the parameters and the
BatchNorm running statistics in the `TrainState` (`update_swa`);
`save_checkpoint` writes the current or the averaged weights in the JAX
package's model file layout (`models/io.py`).
"""

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
    AugmentationParameters,
    TrainAugmentationConfig,
    augment_batch_for_training,
)
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.losses.criterion import MaskedMultiTaskCriterion
from neuralnet_tracker_traincode_torch.models.nll import SCALE_MODULES
from neuralnet_tracker_traincode_torch.train.schedules import exponential_up_then_steps

_GROUP_LR = {"main": 1.0, "variance": 0.1, "transformer": 0.01}
_GROUP_WEIGHT_DECAY = {"transformer": 0.01}
_NOT_LABELS = ("image", "param_index", "tag_id", "dataset_weight")


def label_parameters(model: torch.nn.Module) -> Dict[str, str]:
    """Optimizer group of each named parameter: 'variance' for the NLL scale
    modules (the JAX package's `uncertainty*` modules), 'transformer' for the
    parameters under a module named `transformer` (hybrid_vit's encoder and
    decoder, the JAX package's `transformer_*`), 'main' otherwise."""
    variance = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, SCALE_MODULES):
            variance.update(f"{prefix}.{n}" if prefix else n for n, _ in mod.named_parameters())

    def label(name: str) -> str:
        if name in variance:
            return "variance"
        return "transformer" if "transformer" in name.split(".") else "main"

    return {n: label(n) for n, _ in model.named_parameters()}


@dataclasses.dataclass
class AdamState:
    count: int  # steps taken (optax's count, shared by all groups)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class ClippedGroupAdam:
    """clip_by_global_norm(max_norm) then Adam per group (AdamW for the
    'transformer' group), as the JAX package's `make_optimizer` chains them
    in optax."""

    def __init__(
        self,
        base_lr: float,
        epoch_schedule: Callable[[int], float],
        steps_per_epoch: int,
        num_epochs: int,
        groups: Dict[str, str],
        grad_clip_norm: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.table = [float(epoch_schedule(e)) for e in range(max(1, num_epochs))]
        self.base_lr = base_lr
        self.steps_per_epoch = steps_per_epoch
        self.groups = dict(groups)
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def learning_rate(self, count: int, group: str) -> float:
        epoch = min(max(count // self.steps_per_epoch, 0), len(self.table) - 1)
        return self.base_lr * _GROUP_LR[group] * self.table[epoch]

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: AdamState) -> AdamState:
        """Update `params` in place from `grads`; returns the advanced state.

        Every scalar is computed on the host from the step count, so the
        update enqueues without waiting for the device."""
        names = list(params)
        g = [grads[n] for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        # optax: t if norm < max else (t / norm) * max; here t * (max / norm),
        # which differs from it by at most an ulp
        scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm), self.grad_clip_norm / norm)
        g = torch._foreach_mul(g, scale)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state.count + 1
        # bias corrections in f32, as optax computes decay ** count
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        for group in _GROUP_LR:
            idx = [i for i, n in enumerate(names) if self.groups[n] == group]
            if idx:
                lr = self.learning_rate(state.count, group)
                group_params, group_upd = [params[names[i]] for i in idx], [upd[i] for i in idx]
                if group in _GROUP_WEIGHT_DECAY:  # optax.adamw: adam + wd * params, then the learning rate
                    torch._foreach_add_(group_upd, group_params, alpha=_GROUP_WEIGHT_DECAY[group])
                torch._foreach_add_(group_params, group_upd, alpha=-lr)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(
    model: torch.nn.Module,
    base_lr: float,
    epoch_schedule: Callable[[int], float],
    steps_per_epoch: int,
    num_epochs: int,
    grad_clip_norm: float = 1.0,
) -> ClippedGroupAdam:
    groups = label_parameters(model)
    return ClippedGroupAdam(base_lr, epoch_schedule, steps_per_epoch, num_epochs, groups, grad_clip_norm)


@dataclasses.dataclass
class TrainerConfig:
    batchsize: int = 64
    lr: float = 1.0e-3
    epochs: int = 200
    samples_per_epoch: int = 10 * 1024  # `limit_train_batches` of the reference
    grad_clip_norm: float = 1.0
    swa_start_epoch: Optional[int] = None  # enables SWA when set
    aug: TrainAugmentationConfig = dataclasses.field(default_factory=TrainAugmentationConfig)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.samples_per_epoch // self.batchsize)


_SWA_BUFFERS = ("running_mean", "running_var")


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: AdamState
    swa_params: Dict[str, torch.Tensor]  # running averages, own copies of the model's tensors
    swa_buffers: Dict[str, torch.Tensor]  # the BatchNorm running statistics' averages
    swa_count: int


class PoseTrainer:
    """Owns the model, criterion and optimizer of a pose-network training run.

    The parameters and buffers live in `model` (on `device`) and are updated
    in place; `TrainState` carries the step count, the Adam moments and the
    SWA averages.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        criterion: MaskedMultiTaskCriterion,
        config: TrainerConfig,
        categories: Dict[str, Any],
        epoch_schedule: Optional[Callable[[int], float]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.criterion = criterion
        self.config = config
        self.categories = dict(categories)
        if epoch_schedule is None:
            n = config.epochs
            epoch_schedule = exponential_up_then_steps(max(1, n // 10), 0.1, [n // 2])
        self.epoch_schedule = epoch_schedule
        self.tx = make_optimizer(
            model, config.lr, epoch_schedule, config.steps_per_epoch, config.epochs, config.grad_clip_norm
        )

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_state(
        self,
        generator: Optional[torch.Generator] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
    ) -> TrainState:
        """Initialise the weights (flax's default init drawn from `generator`,
        or `state_dict`, e.g. from `models.weights.posenet_state_dict_from_jax`)
        and the optimizer state."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.cpu().init_weights(generator)
        self.model.to(self.device)
        # SWA slots are copies: the model's tensors change in place every step.
        # SWA averages BatchNorm's running statistics, not `num_batches_tracked` nor the constant tables.
        return TrainState(
            step=0,
            opt_state=self.tx.init(self.params()),
            swa_params={n: p.detach().clone() for n, p in self.params().items()},
            swa_buffers={n: b.detach().clone() for n, b in self.model.named_buffers() if n.endswith(_SWA_BUFFERS)},
            swa_count=0,
        )

    def weight_matrix(self, epoch: int) -> torch.Tensor:
        return torch.as_tensor(self.criterion.weight_matrix(epoch), device=self.device)

    def train_step(
        self,
        state: TrainState,
        batch: Dict[str, Any],
        weight_matrix: torch.Tensor,
        aug_params: Optional[AugmentationParameters] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on `batch` (the JAX package's fused-batch dict).

        The augmentation uses `aug_params` where given, else draws from
        `generator`; the network's dropout and stochastic-depth masks (of the
        backbones that have them) draw from `generator` too. Returns the new state and device scalars: 'loss' and the
        mean of each loss term over the samples whose tag defines it."""
        dev = self.device
        with record_function("augment"):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            labels = {k: v for k, v in batch.items() if k not in _NOT_LABELS}
            x, labels = augment_batch_for_training(
                batch["image"], labels, self.categories, self.config.aug,
                params=aug_params, generator=generator, param_index=batch.get("param_index"), device=dev,
            )
        self.model.train()
        with record_function("forward"):
            out = self.model(x, coord_convention_id=labels.get("coord_convention_id"), generator=generator)
        with record_function("loss"):
            loss, byname = self.criterion(
                out, labels, batch["tag_id"], weight_matrix, dataset_weight=batch.get("dataset_weight")
            )
        params = self.params()
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in zip(params.items(), grads)}
        with record_function("optimizer"):
            opt_state = self.tx.step(params, grads, state.opt_state)
        metrics = {"loss": loss.detach()}
        for name, (vals, ws) in byname.items():
            metrics[name] = vals.detach().sum() / torch.clamp((ws != 0).sum(), min=1)
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    def train_step_multi(
        self,
        state: TrainState,
        batches: Dict[str, Any],
        weight_matrix: torch.Tensor,
        aug_params: Optional[Sequence[AugmentationParameters]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K = leading-axis length optimizer steps on `batches` (every entry
        (K, B, ...)), with per-step metrics stacked on a leading (K,) axis:
        the same trajectory as K `train_step` calls."""
        K = len(next(iter(batches.values())))
        history = []
        for k in range(K):
            state, m = self.train_step(
                state, {n: v[k] for n, v in batches.items()}, weight_matrix,
                aug_params=None if aug_params is None else aug_params[k], generator=generator,
            )
            history.append(m)
        return state, {n: torch.stack([m[n] for m in history]) for n in history[0]}

    @torch.no_grad()
    def update_swa(self, state: TrainState) -> TrainState:
        """Equal-weight running average of the parameters and the BatchNorm
        running statistics: old + (new - old) / (n + 1), in f32."""
        n1 = float(state.swa_count + 1)
        current = {**self.params(), **dict(self.model.named_buffers())}

        def avg(slots):
            return {k: old + (current[k].detach() - old) / n1 for k, old in slots.items()}

        return dataclasses.replace(
            state, swa_params=avg(state.swa_params), swa_buffers=avg(state.swa_buffers), swa_count=state.swa_count + 1
        )

    # ---- checkpointing ------------------------------------------------------
    def variables_of(self, state: TrainState, swa: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state dict, with the SWA averages in place of the
        parameters and running statistics when `swa`."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        if swa:
            sd.update(state.swa_params)
            sd.update(state.swa_buffers)
        return sd

    def save_checkpoint(self, state: TrainState, filename: str, swa: bool = False):
        from neuralnet_tracker_traincode_torch.models import io as model_io

        model_io.save_model(self.model, self.variables_of(state, swa), filename)


def nonfinite_metrics(metrics: Dict[str, torch.Tensor]) -> List[str]:
    """Names of the metrics that are not finite (one device sync)."""
    names = list(metrics)
    ok = torch.isfinite(torch.stack([metrics[n].float() for n in names])).cpu().tolist()
    return [n for n, good in zip(names, ok) if not good]


def check_not_nan(
    metrics: Dict[str, torch.Tensor],
    params: Dict[str, torch.Tensor],
    batch: Dict[str, Any],
    dump_path: Optional[str] = None,
):
    """NaN watchdog: when the loss is not finite, write the metrics, the
    batch and the parameters (`torch.save`, CPU copies) to `dump_path`
    (default: notgood.pt in the temporary directory) and raise
    FloatingPointError. `metrics["loss"]` may be a scalar or the (K,) losses
    of several steps; reading it is one device sync."""
    loss = float(torch.as_tensor(metrics["loss"]).double().sum())
    if np.isfinite(loss):
        return
    dump_path = dump_path or os.path.join(tempfile.gettempdir(), "notgood.pt")
    cpu = lambda tree: {k: torch.as_tensor(v).detach().cpu() for k, v in tree.items()}  # noqa: E731
    try:
        torch.save({"metrics": cpu(metrics), "batch": cpu(batch), "params": cpu(params)}, dump_path)
    except Exception as e:  # noqa: BLE001 - the dump must not mask the error
        print(f"Failed writing NaN dump: {e}")
    raise FloatingPointError(f"Non-finite loss detected: {loss}; dump at {dump_path}")
