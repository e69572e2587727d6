"""The training step (counterpart of the JAX package's `train/loop.py`).

One step: augmentation on the device (K1, K2, K3) -> forward of the pose
network in train mode (bf16 autocast when the model asks for it) -> masked
multi-task loss -> backward through autograd -> global-norm clip -> Adam with
parameter groups on the epoch-table schedule. `train_step_multi` runs K
steps in one call: on the card as one replay of a CUDA graph of K steps, the
counterpart of the JAX package's `lax.scan` over K steps in one dispatch.

The optimizer is written out rather than taken from `torch.optim`, because
it must do what the JAX package's optax chain does:
 - `optax.clip_by_global_norm` scales by max/norm only when norm > max
   (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead);
 - `optax.adam` (b1 0.9, b2 0.999, eps 1e-8 outside the square root) with
   the learning rate of the step count BEFORE the increment;
 - NLL scale parameters ('variance') train at 0.1x the learning rate;
   the transformer blocks of hybrid_vit ('transformer') at 0.01x with
   decoupled weight decay 0.01 (`optax.adamw`).

With a `parallel.distributed.DataParallel` the trainer is one rank of a
data-parallel run: it trains on its rows of the batch of all ranks with the
draws of the whole batch, BatchNorm reduces over the ranks, the gradients
and the reported metrics are those of the whole batch, and the host values
that shape a step (K1's plan, whether a CUDA graph captures) are agreed
across the ranks first. The parameters, buffers and Adam moments stay
bit-equal across ranks.

SWA keeps an equal-weight running average of the parameters and the
BatchNorm running statistics in the `TrainState` (`update_swa`);
`save_checkpoint` writes the current or the averaged weights in the JAX
package's model file layout (`models/io.py`).
"""

import collections
import dataclasses
import hashlib
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
    AugmentationParameters,
    TrainAugmentationConfig,
    augment_batch_for_training,
    crop_scale_bounds,
    draws_for_rows,
    sample_augmentation_parameters,
)
from neuralnet_tracker_traincode_torch.device import DeviceLike, resolve_device
from neuralnet_tracker_traincode_torch.kernels import ext
from neuralnet_tracker_traincode_torch.kernels import warp as K1
from neuralnet_tracker_traincode_torch.losses.criterion import MaskedMultiTaskCriterion
from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d, draw_mask_seed
from neuralnet_tracker_traincode_torch.models.nll import SCALE_MODULES
from neuralnet_tracker_traincode_torch.parallel.distributed import DataParallel
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
    count: torch.Tensor  # () int32 on the parameters' device: steps taken (optax's count, shared by all groups)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class _DeviceTables(NamedTuple):
    lr: Dict[str, torch.Tensor]  # (epochs,) f32 learning rate of each group in each epoch
    bc1: torch.Tensor  # (N,) f32 1 - b1 ** c for c < N, then 1 - b1 ** (N - 1) == 1
    bc2: torch.Tensor


class ClippedGroupAdam:
    """clip_by_global_norm(max_norm) then Adam per group (AdamW for the
    'transformer' group), as the JAX package's `make_optimizer` chains them
    in optax.

    The step count lives on the device and the step reads every scalar it
    needs from tables there, indexed by the count: the learning rate of each
    group per epoch and the bias corrections 1 - b ** count, computed once
    on the host in numpy f32 as optax computes them. So an update waits for
    nothing on the host and can be captured in a CUDA graph."""

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

        self._tables: Dict[torch.device, _DeviceTables] = {}

    def learning_rate(self, count: int, group: str) -> float:
        epoch = min(max(count // self.steps_per_epoch, 0), len(self.table) - 1)
        return self.base_lr * _GROUP_LR[group] * self.table[epoch]

    def tables(self, device: torch.device) -> _DeviceTables:
        """The step's tables on `device`, built on first use."""
        if device not in self._tables:
            lr = {g: np.asarray([self.learning_rate(e * self.steps_per_epoch, g) for e in range(len(self.table))],
                                np.float32) for g in _GROUP_LR}

            def corrections(b):  # until 1 - b ** c rounds to 1 in f32; optax computes decay ** count in f32
                out = []
                while not out or (out[-1] != 1.0 and len(out) < 2**20):
                    out.append(np.float32(1.0) - np.float32(b) ** np.float32(len(out)))
                return np.asarray(out, np.float32)

            bc1, bc2 = corrections(self.b1), corrections(self.b2)
            n = max(len(bc1), len(bc2))
            pad = lambda a: np.concatenate([a, np.full(n - len(a), a[-1], np.float32)])  # noqa: E731
            to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            self._tables[device] = _DeviceTables({g: to(v) for g, v in lr.items()}, to(pad(bc1)), to(pad(bc2)))
        return self._tables[device]

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        device = next(iter(params.values())).device
        self.tables(device)
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: AdamState) -> AdamState:
        """Update `params`, the moments and the count in place from `grads`;
        returns the state. No value goes to or comes from the host."""
        names = list(params)
        tab = self.tables(state.count.device)
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
        # the learning rate of the count before the increment, the bias corrections of the one after it
        count = state.count.reshape(1).long()
        epoch = torch.clamp(torch.div(count, self.steps_per_epoch, rounding_mode="floor"), 0, len(self.table) - 1)
        after = torch.clamp(count + 1, max=len(tab.bc1) - 1)
        bc1 = torch.index_select(tab.bc1, 0, after).reshape(())
        bc2 = torch.index_select(tab.bc2, 0, after).reshape(())
        state.count.add_(1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        for group in _GROUP_LR:
            idx = [i for i, n in enumerate(names) if self.groups[n] == group]
            if idx:
                lr = torch.index_select(tab.lr[group], 0, epoch).reshape(())
                group_params, group_upd = [params[names[i]] for i in idx], [upd[i] for i in idx]
                if group in _GROUP_WEIGHT_DECAY:  # optax.adamw: adam + wd * params, then the learning rate
                    torch._foreach_add_(group_upd, group_params, alpha=_GROUP_WEIGHT_DECAY[group])
                # optax: p + u * (-lr), which is p - u * lr to the bit
                torch._foreach_sub_(group_params, torch._foreach_mul(group_upd, lr))
        return state


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


class StepInputs(NamedTuple):
    """What the device part of one step reads: the batch and the draws on the
    trainer's device, K1's launch plan (None on the CPU) and the generator of
    the network's masks (None when the network draws none, or draws from
    torch's global generator)."""

    batch: Dict[str, torch.Tensor]
    aug: AugmentationParameters
    plan: Optional[K1.LaunchPlan]
    mask_generator: Optional[torch.Generator]


def _draw_leaves(params: AugmentationParameters) -> Dict[str, torch.Tensor]:
    """The tensors of `params` by dotted name ('roi.scales', 'stage1.perm', ...)."""
    out = {}
    for name, v in params._asdict().items():
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif v is not None:
            out.update((f"{name}.{k}", t) for k, t in v._asdict().items())
    return out


def _draws_from_leaves(template: AugmentationParameters, leaves: Dict[str, torch.Tensor]) -> AugmentationParameters:
    fields = {}
    for name, v in template._asdict().items():
        if v is None or isinstance(v, torch.Tensor):
            fields[name] = None if v is None else leaves[name]
        else:
            fields[name] = type(v)(**{k: leaves[f"{name}.{k}"] for k in v._fields})
    return AugmentationParameters(**fields)


class _Packing:
    """One byte buffer holding named tensors (each at a 16-byte offset), so
    that a step's draws go to the card in one copy from pinned memory."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]):
        self.layout, n = {}, 0  # name -> (byte offset, bytes, shape, dtype)
        for name, (shape, dtype) in specs.items():
            size = math.prod(shape) * dtype.itemsize
            self.layout[name] = (n, size, shape, dtype)
            n += (size + 15) // 16 * 16
        self.nbytes = max(n, 16)

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[o : o + size].view(dtype).view(shape)
                for name, (o, size, shape, dtype) in self.layout.items()}

    def pinned(self, stacked: Dict[str, Sequence[torch.Tensor]]) -> torch.Tensor:
        """A pinned buffer holding, for each name, its K tensors stacked."""
        buf = torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
        for name, view in self.views(buf).items():
            for k, t in enumerate(stacked[name]):
                view[k].copy_(t)
        return buf


def _host_field(batch: Dict[str, Any], key: str) -> torch.Tensor:
    """`batch[key]` on the host: the copy a prefetcher kept (its `host`), else
    the value itself, read back from the card if it lies there."""
    host = getattr(batch, "host", None)
    v = host[key] if host is not None and key in host else batch[key]
    return torch.as_tensor(v).cpu()


class PoseTrainer:
    """Owns the model, criterion and optimizer of a pose-network training run.

    The parameters and buffers live in `model` (on `device`) and are updated
    in place; `TrainState` carries the step count, the Adam moments (updated
    in place too) and the SWA averages.

    A step is a host part and a device part. The host part (`prepare_step`)
    draws the augmentation and the mask seed from the generator, plans K1
    from the host copies of the ROIs, and uploads the draws in one copy from
    pinned memory. The device part (`device_step`) computes from those
    tensors only: no value goes back to the host and none comes from
    pageable memory. `train_step` runs the two eagerly; on the card
    `train_step_multi` replays a CUDA graph that captured the device part
    once for each of K slots of input buffers (`_StepGraph`), so the graph
    runs the eager step's kernels on the eager step's inputs.

    With `parallel` (module docstring) a batch holds this rank's rows of the
    batch of all ranks, with `param_index` in the row numbers of its node's
    batch; given draws (`aug_params`) are those of the batch of all ranks.
    """

    MAX_GRAPHS = 4  # captured graphs kept (by input shapes, K1 plan and state); the oldest goes first

    def __init__(
        self,
        model: torch.nn.Module,
        criterion: MaskedMultiTaskCriterion,
        config: TrainerConfig,
        categories: Dict[str, Any],
        epoch_schedule: Optional[Callable[[int], float]] = None,
        device: DeviceLike = None,
        parallel: Optional[DataParallel] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.parallel = parallel or DataParallel()
        if self.parallel.ranks > 1:
            for m in self.model.modules():
                if isinstance(m, BatchNorm2d):
                    m.sync = self.parallel
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
        self._mask_generator = torch.Generator(device=self.device)
        self._graphs: "collections.OrderedDict[tuple, _StepGraph]" = collections.OrderedDict()
        # what the captures cost, for reports: graphs captured, warm-up steps run, seconds, pool bytes
        self.graph_stats = {"captures": 0, "warmup_steps": 0, "capture_s": 0.0, "instantiate_s": 0.0,
                            "pool_bytes": 0}

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

    # ---- the host part -------------------------------------------------------
    def _draws(self, batch: Dict[str, Any], aug_params: Optional[AugmentationParameters],
               generator: Optional[torch.Generator]) -> Tuple[AugmentationParameters, Optional[int]]:
        """One step's draws on the host, in the order the step consumes the
        generator: the augmentation (unless given), then the mask seed. With
        a process group the augmentation is drawn (or given) for the batch of
        all ranks and resolved to this rank's rows (`draws_for_rows`), and
        the mask seed has the rank folded in."""
        P = self.parallel
        B = len(batch["tag_id"])
        if aug_params is None:
            aug_params = sample_augmentation_parameters(generator, B * P.ranks, self.config.aug)
        if P.active:
            pidx = None
            if "param_index" in batch:  # the node's row numbers -> those of the batch of all ranks
                pidx = _host_field(batch, "param_index").long() + P.node * B * P.local_ranks
            aug_params = draws_for_rows(aug_params, P.rows(B * P.ranks), pidx)
        draws_masks = getattr(getattr(self.model, "convnet", None), "draws_masks", False)
        seed = draw_mask_seed(generator) if generator is not None and draws_masks else None
        return aug_params, None if seed is None else P.mask_seed(seed)

    def _device_fields(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The fields the device part reads: with a process group the draws
        are resolved on the host, so not `param_index`."""
        if not self.parallel.active:
            return batch
        return {k: v for k, v in batch.items() if k != "param_index"}

    def _plan(self, batches: Sequence[Dict[str, Any]], draws: Sequence[AugmentationParameters]
              ) -> Optional[K1.LaunchPlan]:
        """K1's launch plan on the card (`k1_plan`); None on the CPU, whose
        plain K1 needs none."""
        if self.device.type != "cuda":
            return None
        return self.k1_plan(batches, draws)

    def k1_plan(self, batches: Sequence[Dict[str, Any]], draws: Sequence[AugmentationParameters]) -> K1.LaunchPlan:
        """K1's launch plan for steps on `batches` with `draws`, from the host
        copies of their ROIs; with a process group, for the largest scales of
        all ranks, so that every rank launches K1 alike."""
        cfg = self.config.aug
        sy = sx = 0.0
        for batch, aug in zip(batches, draws):
            pidx = None
            if "param_index" in batch and not self.parallel.active:  # a rank's draws are resolved already
                pidx = _host_field(batch, "param_index")
            by, bx = crop_scale_bounds(_host_field(batch, cfg.roi_key), aug, self.categories, cfg, pidx)
            sy, sx = max(sy, by), max(sx, bx)
        if self.parallel.active:
            sy, sx = self.parallel.host_all_reduce([sy, sx], "max")
        skip = cfg.deterministic or not cfg.rotation_aug_angle
        S = cfg.inputsize
        cs = S if skip else K1.canvas_size(S, cfg.rotation_aug_angle)
        return K1.rounded_plan(batches[0]["image"].shape[-2], cs, not skip, sy, sx)

    def _upload(self, draws: Sequence[AugmentationParameters]) -> List[AugmentationParameters]:
        """Each step's draws on the trainer's device; on the card in one copy
        from pinned memory."""
        if self.device.type != "cuda":
            return list(draws)  # the CPU's tensors already
        leaves = [_draw_leaves(d) for d in draws]
        packing = _Packing({n: ((len(draws),) + tuple(t.shape), t.dtype) for n, t in leaves[0].items()})
        buf = packing.pinned({n: [lv[n] for lv in leaves] for n in leaves[0]}).to(self.device, non_blocking=True)
        views = packing.views(buf)
        return [_draws_from_leaves(draws[0], {n: v[k] for n, v in views.items()}) for k in range(len(draws))]

    def prepare_step(
        self,
        batch: Dict[str, Any],
        aug_params: Optional[AugmentationParameters] = None,
        generator: Optional[torch.Generator] = None,
    ) -> StepInputs:
        """The host part of one step (class docstring)."""
        dev = self.device
        aug, seed = self._draws(batch, aug_params, generator)
        plan = self._plan([batch], [aug])
        on_device = {k: torch.as_tensor(v).to(dev) for k, v in self._device_fields(batch).items()}
        (aug,) = self._upload([aug])
        mask_gen = None
        if seed is not None:
            mask_gen = self._mask_generator
            mask_gen.manual_seed(seed)
        return StepInputs(on_device, aug, plan, mask_gen)

    def prepare_block(
        self,
        batches: Dict[str, Any],
        aug_params: Optional[Sequence[AugmentationParameters]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[List[Tuple[AugmentationParameters, Optional[int]]], Optional[K1.LaunchPlan]]:
        """The host draws of K steps on stacked `batches` ((augmentation, mask
        seed) per step, consuming `generator` as K `prepare_step` calls do)
        and one K1 plan that holds for all of them."""
        K = len(next(iter(batches.values())))
        steps = [_BatchSlice(batches, k) for k in range(K)]
        drawn = [self._draws(steps[k], None if aug_params is None else aug_params[k], generator) for k in range(K)]
        return drawn, self._plan(steps, [a for a, _ in drawn])

    # ---- the device part -----------------------------------------------------
    def device_step(self, state: TrainState, inputs: StepInputs, weight_matrix: torch.Tensor
                    ) -> Tuple[List[str], torch.Tensor]:
        """The device part of one step: augmentation (K1, K2, K3), forward,
        loss, backward, clip and Adam, updating the parameters, the BatchNorm
        statistics and `state.opt_state` in place. Returns the metric names
        and their values, one f32 vector: 'loss' and the mean of each loss
        term over the samples whose tag defines it."""
        batch = inputs.batch
        with record_function("augment"):
            labels = {k: v for k, v in batch.items() if k not in _NOT_LABELS}
            x, labels = augment_batch_for_training(
                batch["image"], labels, self.categories, self.config.aug, params=inputs.aug,
                param_index=batch.get("param_index"), device=self.device, k1_plan=inputs.plan,
            )
        self.model.train()
        with record_function("forward"):
            out = self.model(x, coord_convention_id=labels.get("coord_convention_id"),
                             mask_generator=inputs.mask_generator)
        with record_function("loss"):
            loss, byname = self.criterion(
                out, labels, batch["tag_id"], weight_matrix, dataset_weight=batch.get("dataset_weight")
            )
        params = self.params()
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g) for (n, p), g in zip(params.items(), grads)}
        if self.parallel.active:
            with record_function("gradient_mean"):
                grads = self._mean_over_ranks(grads)
        with record_function("optimizer"):
            self.tx.step(params, grads, state.opt_state)
        names = ["loss"] + list(byname)
        if self.parallel.active:  # the numerators and counts of all ranks
            P, m = self.parallel, len(byname)
            sums = torch.stack([loss.detach().float()] + [vals.detach().sum() for vals, _ in byname.values()]
                               + [(ws != 0).sum().float() for _, ws in byname.values()])
            P.all_reduce_(sums)
            return names, torch.cat([sums[:1] / P.ranks, sums[1:1 + m] / torch.clamp(sums[1 + m:], min=1)])
        values = [loss.detach().float()]
        for vals, ws in byname.values():
            values.append(vals.detach().sum() / torch.clamp((ws != 0).sum(), min=1))
        return names, torch.stack(values)

    def _mean_over_ranks(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients summed over the ranks in one flat buffer, then
        divided by their number: each rank's loss is its rows' sum over its
        row count, so with equal row counts this is the gradient of the
        whole batch's loss."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        self.parallel.all_reduce_(flat).div_(self.parallel.ranks)
        out, o = {}, 0
        for n, g in grads.items():
            out[n] = flat[o:o + g.numel()].view_as(g)
            o += g.numel()
        return out

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
        with record_function("draws"):
            inputs = self.prepare_step(batch, aug_params, generator)
        names, values = self.device_step(state, inputs, torch.as_tensor(weight_matrix).to(self.device))
        return dataclasses.replace(state, step=state.step + 1), {n: values[i] for i, n in enumerate(names)}

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
        the same trajectory as K `train_step` calls.

        On the CPU they are K `train_step` calls. On the card they are one
        replay of a CUDA graph of K device parts, captured at the first call
        for these input shapes, this K1 plan and this state's tensors (after
        a warm-up of the device part on a side stream, from which the state
        is restored); the captured launches count in `kernels.ext.LAUNCHES`
        once per replay. A capture or a replay that fails raises. With a
        process group, every rank captures where any rank would, so that the
        collectives of the capture's warm-up pair across ranks; NCCL's are
        captured into the graph, gloo's cannot be (it raises)."""
        K = len(next(iter(batches.values())))
        if self.device.type != "cuda":
            history = []
            for k in range(K):
                state, m = self.train_step(
                    state, {n: v[k] for n, v in batches.items()}, weight_matrix,
                    aug_params=None if aug_params is None else aug_params[k], generator=generator,
                )
                history.append(m)
            return state, {n: torch.stack([m[n] for m in history]) for n in history[0]}
        if self.parallel.active:
            import torch.distributed as dist

            if dist.get_backend(self.parallel.group) != "nccl":
                raise ValueError("a CUDA graph cannot capture the collectives of the "
                                 f"{dist.get_backend(self.parallel.group)} backend; train eagerly (train_step)")
        with record_function("draws"):
            drawn, plan = self.prepare_block(batches, aug_params, generator)
            fields = self._device_fields(batches)
            graph, capture = self._graph_for(state, fields, drawn[0], plan)
            graph.load(fields, drawn, weight_matrix)
        if capture:
            graph.capture(self, state)
        with record_function("replay"):
            graph.graph.replay()
        for name, n in graph.launches.items():
            ext.LAUNCHES[name] += n
        values = graph.metrics.clone()
        return (dataclasses.replace(state, step=state.step + K),
                {n: values[:, i] for i, n in enumerate(graph.metric_names)})

    def _graph_for(self, state: TrainState, batches, first_draws, plan) -> Tuple["_StepGraph", bool]:
        """The graph of this block's key, and whether it captures now: where
        it has none yet, or, with a process group, where any rank's has none
        (after a check that every rank has the same shapes and plan)."""
        aug, seed = first_draws
        shared = (
            tuple((k, tuple(v.shape), torch.as_tensor(v[:1]).dtype) for k, v in batches.items()),
            tuple((n, tuple(t.shape), t.dtype) for n, t in _draw_leaves(aug).items()),
            seed is not None,
            plan,
        )
        key = shared + (state.opt_state.count.data_ptr(), next(iter(self.params().values())).data_ptr())
        graph = self._graphs.get(key)
        if graph is None:
            while len(self._graphs) >= self.MAX_GRAPHS:
                self._graphs.popitem(last=False)
            graph = self._graphs[key] = _StepGraph(self, batches, aug, seed is not None, plan)
        self._graphs.move_to_end(key)
        capture = graph.graph is None
        if self.parallel.active:
            digest = int.from_bytes(hashlib.sha256(repr(shared).encode()).digest()[:7], "little")
            top, neg_bottom, any_capture = self.parallel.host_all_reduce([digest, -digest, int(capture)], "max",
                                                                         torch.int64)
            if top != -neg_bottom:
                raise RuntimeError(f"the ranks' blocks differ in shapes or K1 plan; this rank's: {shared}")
            capture = bool(any_capture)
        return graph, capture

    def _state_tensors(self, state: TrainState) -> List[torch.Tensor]:
        """Every tensor a step changes in place."""
        opt = state.opt_state
        return ([p.detach() for p in self.model.parameters()] + list(self.model.buffers())
                + [opt.mu[n] for n in opt.mu] + [opt.nu[n] for n in opt.nu] + [opt.count])

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


class _BatchSlice(dict):
    """Step k of stacked batches, with the host copies a prefetcher kept."""

    def __init__(self, batches: Dict[str, Any], k: int):
        super().__init__((n, v[k]) for n, v in batches.items())
        host = getattr(batches, "host", None)
        self.host = None if host is None else {n: v[k] for n, v in host.items()}


class _StepGraph:
    """K slots of input buffers on the card, and a CUDA graph that captured
    `PoseTrainer.device_step` once over each slot, in order; its static
    output `metrics` is (K, number of metrics)."""

    def __init__(self, trainer: PoseTrainer, batches: Dict[str, Any], aug: AugmentationParameters,
                 with_masks: bool, plan: Optional[K1.LaunchPlan]):
        dev = trainer.device
        self.K = K = len(next(iter(batches.values())))
        self.batch = {n: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v[:1]).dtype, device=dev)
                      for n, v in batches.items()}
        self.packing = _Packing({n: ((K,) + tuple(t.shape), t.dtype) for n, t in _draw_leaves(aug).items()})
        self.draws = torch.empty(self.packing.nbytes, dtype=torch.uint8, device=dev)
        self.weight_matrix: Optional[torch.Tensor] = None
        self.generators = [torch.Generator(device=dev) for _ in range(K)] if with_masks else None
        self.seeds: List[Optional[int]] = [None] * K
        views = self.packing.views(self.draws)
        self.inputs = [
            StepInputs({n: v[k] for n, v in self.batch.items()},
                       _draws_from_leaves(aug, {n: v[k] for n, v in views.items()}), plan,
                       None if self.generators is None else self.generators[k])
            for k in range(K)
        ]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Optional[torch.Tensor] = None
        self.metric_names: List[str] = []
        self.launches: Dict[str, int] = {}  # kernel launches per replay
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0

    def load(self, batches: Dict[str, Any], drawn: Sequence[Tuple[AugmentationParameters, Optional[int]]],
             weight_matrix):
        """Copy a block's batches, draws and weight matrix into the slots and
        seed each slot's mask generator, all queued before the next replay."""
        for n, v in batches.items():
            self.batch[n].copy_(torch.as_tensor(v), non_blocking=True)
        leaves = [_draw_leaves(a) for a, _ in drawn]
        self.draws.copy_(self.packing.pinned({n: [lv[n] for lv in leaves] for n in leaves[0]}), non_blocking=True)
        W = torch.as_tensor(weight_matrix)
        if self.weight_matrix is None:
            self.weight_matrix = torch.empty(W.shape, dtype=W.dtype, device=self.draws.device)
        self.weight_matrix.copy_(W, non_blocking=True)
        self.seeds = [seed for _, seed in drawn]
        self._seed()

    def _seed(self):
        if self.generators is not None:
            for g, seed in zip(self.generators, self.seeds):
                g.manual_seed(seed)

    def capture(self, trainer: PoseTrainer, state: TrainState):
        """Warm up the device part on a side stream (max(3, K) steps over the
        slots), put back every tensor it changed, then capture the K steps."""
        dev = trainer.device
        tensors = trainer._state_tensors(state)
        with torch.no_grad():
            snapshot = [t.clone() for t in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        warmup = max(3, self.K)
        with torch.cuda.stream(side):
            for i in range(warmup):
                trainer.device_step(state, self.inputs[i % self.K], self.weight_matrix)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, snapshot):
                t.copy_(s)
        del snapshot
        self._seed()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators or ():
            graph.register_generator_state(g)
        before = dict(ext.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(dev)
            outs = [trainer.device_step(state, inputs, self.weight_matrix) for inputs in self.inputs]
            self.metric_names = outs[0][0]
            self.metrics = torch.stack([values for _, values in outs])
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {n: ext.LAUNCHES[n] - before[n] for n in before}
        ext.LAUNCHES.update(before)  # capturing launched nothing; each replay adds `launches`
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1
        self.graph = graph
        self._seed()
        stats = trainer.graph_stats
        stats["captures"] += 1
        stats["warmup_steps"] += warmup
        stats["capture_s"] += self.capture_s
        stats["instantiate_s"] += self.instantiate_s
        stats["pool_bytes"] += self.pool_bytes
