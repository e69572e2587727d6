"""Profile the parts of the flagship training step on the card (counterpart of
the JAX package's `scripts/profile_step.py`).

    python -m neuralnet_tracker_traincode_torch.scripts.profile_step [dwconv] [aug] [model] [step] [layout] \\
        [--device cpu]

Sections (default `step`), at batch `$PROF_BATCH` (512) with `$PROF_REPS`
(30) timed calls each:

  step    the flagship step (`train/flagship.py`: MobileNetV1, point and NLL
          heads, the 8-term criterion, bf16 autocast, 448^2 uint8 sources
          cropped to 129^2) through `PoseTrainer.train_step` (K = 1) and
          through `train_step_multi` at K = 8, the training CLI's default on
          the card (one CUDA graph replay of 8 steps): ms a step, images/s;
  aug     `augment_batch_for_training` whole (K1, K2 up to 4 times, K3),
          intensity stage 1 alone and the noise alone, on 129^2 crops;
  model   the network's forward in training mode, and forward + backward
          (the gradient of the sum of every output);
  dwconv  the 3x3 depthwise convolution at the five MobileNetV1 sizes in
          bf16: `F.conv2d(groups=C)` (cuDNN) against 9 shifted
          multiply-adds, forward and gradient;
  layout  every distinct MobileNetV1 conv shape (the 8-channel zero-padded
          stem beside the 1-channel one) in bf16, forward and forward +
          backward, under `torch.contiguous_format` (NCHW) and
          `torch.channels_last`; the totals weighted by each shape's count
          in the network (`$PROF_LAYOUT_SHAPES` = n keeps the first n shapes).

Timing: on the card, CUDA events after two warm-up calls. Every timed call
gets its own inputs: draws made on the host before the timing and uploaded,
or input sets cycled so that together they exceed the 50 MB L2. `step`,
`aug` and `model` time each call between its own pair of events and report
the median and the range over the calls; `dwconv` and `layout` time rounds
of back-to-back calls (the median round's mean per call, with the range
over the rounds), since a layer takes microseconds. On the CPU the same
with the host's clock. The JAX script's slope over dispatch counts and its
chained marginals answer its TPU runtime's dispatch floor, which the card
does not have.

The script launches no kernel of its own: the step and the augmentation go
through the port's K1, K2 and K3 (their counts in `kernels/ext.LAUNCHES`);
the convolutions are PyTorch's (cuDNN on the card). Each section function
returns its times and how many calls of each kind it made.
"""

import argparse
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuralnet_tracker_traincode_torch.device import resolve_device

SECTIONS = ("dwconv", "aug", "model", "step", "layout")
WARMUP = 2
MULTI_K = 8  # steps a dispatch: the training CLI's default on the card
L2_BYTES = 50 * 2**20
DW_SIZES = [(65, 64), (33, 128), (17, 256), (9, 512), (5, 1024)]
# (name, S_in, cin, cout, k, stride, groups, occurrences): every distinct MobileNetV1 conv shape at width 1.0
LAYOUT_SHAPES = [
    ("stem 5x5 s2", 129, 1, 32, 5, 2, 1, 1),
    ("stem 5x5 s2 pad8", 129, 8, 32, 5, 2, 1, 1),
    ("dw 65^2 c32", 65, 32, 32, 3, 1, 32, 1),
    ("pw 65^2 32->64", 65, 32, 64, 1, 1, 1, 1),
    ("dw 65^2 c64 s2", 65, 64, 64, 3, 2, 64, 1),
    ("pw 33^2 64->128", 33, 64, 128, 1, 1, 1, 1),
    ("dw 33^2 c128", 33, 128, 128, 3, 1, 128, 1),
    ("pw 33^2 128->128", 33, 128, 128, 1, 1, 1, 1),
    ("dw 33^2 c128 s2", 33, 128, 128, 3, 2, 128, 1),
    ("pw 17^2 128->256", 17, 128, 256, 1, 1, 1, 1),
    ("dw 17^2 c256", 17, 256, 256, 3, 1, 256, 1),
    ("pw 17^2 256->256", 17, 256, 256, 1, 1, 1, 1),
    ("dw 17^2 c256 s2", 17, 256, 256, 3, 2, 256, 1),
    ("pw 9^2 256->512", 9, 256, 512, 1, 1, 1, 1),
    ("dw 9^2 c512", 9, 512, 512, 3, 1, 512, 5),
    ("pw 9^2 512->512", 9, 512, 512, 1, 1, 1, 5),
    ("dw 9^2 c512 s2", 9, 512, 512, 3, 2, 512, 1),
    ("pw 5^2 512->1024", 5, 512, 1024, 1, 1, 1, 1),
    ("dw 5^2 c1024", 5, 1024, 1024, 3, 1, 1024, 1),
    ("pw 5^2 1024->1024", 5, 1024, 1024, 1, 1, 1, 1),
]
LAYOUTS = (("NCHW", torch.contiguous_format), ("channels_last", torch.channels_last))

Stat = Tuple[float, float, float]  # (median, min, max) ms


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def per_call_ms(fn: Callable[[int], None], n: int, dev: torch.device) -> Stat:
    """`fn(i)` for i < WARMUP, then n timed calls `fn(WARMUP + i)`, each
    between its own pair of CUDA events (on the CPU, the host's clock)."""
    for i in range(WARMUP):
        fn(i)
    _sync(dev)
    times = []
    if dev.type == "cuda":
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for i, (a, b) in enumerate(events):
            a.record()
            fn(WARMUP + i)
            b.record()
        _sync(dev)
        times = [a.elapsed_time(b) for a, b in events]
    else:
        for i in range(n):
            t0 = time.perf_counter()
            fn(WARMUP + i)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


ROUNDS = 3
SPIN_CYCLES = 40_000_000  # ~20 ms of device spin while the host queues a round
UNQUEUED = {"rounds": 0, "of": 0}  # rounds whose spin ended before the host had queued all their calls


def back_to_back_ms(fn: Callable[[int], None], reps: int, dev: torch.device) -> Stat:
    """`fn(i)` for i < WARMUP, then ROUNDS rounds of back-to-back calls, reps
    in all: (the median round's mean per call, the least, the largest). On
    the card each round is queued behind a device spin, so that its calls
    run back to back at the device's pace, not the host's; a round whose
    spin ended before the host had queued it counts in `UNQUEUED`."""
    for i in range(WARMUP):
        fn(i)
    _sync(dev)
    n = max(1, math.ceil(reps / ROUNDS))
    means = []
    for r in range(ROUNDS):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for i in range(n):
                fn(r * n + i)
            UNQUEUED["rounds"] += int(a.query())
            UNQUEUED["of"] += 1
            b.record()
            b.synchronize()
            means.append(a.elapsed_time(b) / n)
        else:
            t0 = time.perf_counter()
            for i in range(n):
                fn(r * n + i)
            means.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(means), min(means), max(means)


def input_sets(make: Callable[[int], Sequence[torch.Tensor]], limit: int) -> List[Sequence[torch.Tensor]]:
    """At least 2 (at most `limit`) distinct input sets `make(i)`, together
    more than the L2, to cycle through."""
    first = make(0)
    nbytes = sum(t.numel() * t.element_size() for t in first)
    n = min(limit, max(2, math.ceil(2 * L2_BYTES / max(1, nbytes))))
    return [first] + [make(i) for i in range(1, n)]


def _unqueued_line(dev: torch.device):
    if dev.type == "cuda":
        print(f"rounds not all queued behind the spin (host-bound): {UNQUEUED['rounds']} of {UNQUEUED['of']}")
        UNQUEUED.update(rounds=0, of=0)


def fmt(stat: Stat) -> str:
    return f"{stat[0]:.3f} ms [{stat[1]:.3f}-{stat[2]:.3f}]"


# ---- sections -------------------------------------------------------------------------


def conv_dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 depthwise convolution, (B, C, H, W) by (C, 1, 3, 3), zero padded."""
    return F.conv2d(x, w, padding=1, groups=x.shape[1])


def shift_dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same as 9 shifted multiply-adds (no convolution)."""
    xp = F.pad(x, (1, 1, 1, 1))
    H, W = x.shape[2], x.shape[3]
    acc = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            acc = acc + xp[:, :, i : i + H, j : j + W] * w[:, 0, i, j][None, :, None, None]
    return acc


def section_dwconv(dev: torch.device, B: int, reps: int) -> Dict:
    """cuDNN's depthwise conv against 9 shifted multiply-adds, per layer size."""
    gen = torch.Generator(dev).manual_seed(0)
    times = {}
    for hw, c in DW_SIZES:
        x0 = torch.rand((B, c, hw, hw), generator=gen, device=dev).to(torch.bfloat16)
        w0 = torch.rand((c, 1, 3, 3), generator=gen, device=dev).to(torch.bfloat16)
        sets = input_sets(lambda i: (x0 * (1 + i * 1e-2),), reps)
        for name, f in (("conv", conv_dw), ("shift", shift_dw)):
            xs = [s[0].detach().requires_grad_(True) for s in sets]
            w = w0.detach().requires_grad_(True)
            with torch.no_grad():
                tf = back_to_back_ms(lambda i: f(xs[i % len(xs)], w), reps, dev)

            def grad(i):
                torch.autograd.grad(f(xs[i % len(xs)], w).float().sum(), (xs[i % len(xs)], w))

            tg = back_to_back_ms(grad, reps, dev)
            times[(hw, c, name)] = (tf, tg)
            print(f"dw {hw}x{hw}x{c:4d} {name:5s}: fwd {tf[0]:7.3f} ms  grad {tg[0]:7.3f} ms"
                  f"  (fwd {fmt(tf)}, grad {fmt(tg)})")
        del x0, sets, xs
    _unqueued_line(dev)
    return {"times": times}


def _labels(rng, B: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    labels = {
        "pose": np.tile(np.asarray([0.0, 0, 0, 1], np.float32), (B, 1)),
        "coord": (rng.rand(B, 3) * 100 + 100).astype(np.float32),
        "roi": np.tile(np.asarray([100.0, 100, 350, 350], np.float32), (B, 1)),
        "pt3d_68": (rng.rand(B, 68, 3) * 200 + 100).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in labels.items()}


def _draws_to(params, dev: torch.device):
    """`AugmentationParameters` with every leaf on `dev`."""
    return type(params)(*(None if p is None else p.to(dev) for p in params))


def section_aug(dev: torch.device, B: int, reps: int) -> Dict:
    """The whole augmentation, intensity stage 1 alone, the noise alone."""
    from neuralnet_tracker_traincode_torch.augmentation import intensity as I
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
        TrainAugmentationConfig,
        augment_batch_for_training,
        crop_scale_bounds,
        sample_augmentation_parameters,
    )
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.train.flagship import SRC

    cfg = TrainAugmentationConfig(inputsize=129, enable_image_aug=True)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 256, size=(B, SRC, SRC, 1), dtype=np.uint8)).to(dev)
    labels = _labels(rng, B, dev)
    cats = {k: LABEL_CATEGORIES[k] for k in labels}
    calls = WARMUP + reps
    gen = torch.Generator().manual_seed(3)
    draws = [sample_augmentation_parameters(gen, B, cfg) for _ in range(calls)]
    plans = [None] * calls
    if dev.type == "cuda":  # K1's plan from the host copies, as the trainer makes it
        cs = K1.canvas_size(cfg.inputsize, cfg.rotation_aug_angle)
        roi = labels["roi"].cpu()
        plans = [K1.rounded_plan(SRC, cs, True, *crop_scale_bounds(roi, d, cats, cfg)) for d in draws]
    draws = [_draws_to(d, dev) for d in draws]

    t = per_call_ms(lambda i: augment_batch_for_training(img, labels, cats, cfg, params=draws[i], device=dev,
                                                         k1_plan=plans[i]), reps, dev)
    print(f"aug program:     {t[0]:.2f} ms  ({fmt(t)})")
    x129 = torch.from_numpy(rng.rand(B, 129, 129, 1).astype(np.float32)).to(dev)
    stage1 = [I.sample_stage1_parameters(gen, B).to(dev) for _ in range(calls)]
    t1 = per_call_ms(lambda i: I.intensity_augmentation_stage1(x129, stage1[i]), reps, dev)
    print(f"intensity stage1:{t1[0]:.2f} ms  ({fmt(t1)})")
    noise = [I.sample_noise_parameters(gen, B).to(dev) for _ in range(calls)]
    t2 = per_call_ms(lambda i: I.intensity_augmentation_noise(x129, noise[i], -0.5), reps, dev)
    print(f"intensity noise: {t2[0]:.2f} ms  ({fmt(t2)})")
    return {"times": {"aug program": t, "intensity stage1": t1, "intensity noise": t2},
            "calls": {"aug program": calls, "intensity stage1": calls, "intensity noise": calls}}


def section_model(dev: torch.device, B: int, reps: int) -> Dict:
    """The network in training mode: forward, and forward + backward."""
    from neuralnet_tracker_traincode_torch.train.flagship import flagship_trainer

    trainer, _, _ = flagship_trainer(B, dev)
    model = trainer.model.train()
    params = list(model.parameters())
    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.rand(B, 129, 129, 1).astype(np.float32)).to(dev)
    xs = [s[0] for s in input_sets(lambda i: (x0 + i * 1e-6,), reps)]
    cid = torch.zeros((B,), dtype=torch.int32, device=dev)

    def leaves(out):
        if isinstance(out, dict):
            for v in out.values():
                yield from leaves(v)
        elif isinstance(out, (list, tuple)):
            for v in out:
                yield from leaves(v)
        elif isinstance(out, torch.Tensor) and out.is_floating_point():
            yield out

    def fwd(i):
        with torch.no_grad():
            model(xs[i % len(xs)], coord_convention_id=cid)

    def fwd_bwd(i):
        out = model(xs[i % len(xs)], coord_convention_id=cid)
        loss = sum(v.float().sum() for v in leaves(out))
        torch.autograd.grad(loss, params, allow_unused=True)

    t = per_call_ms(fwd, reps, dev)
    print(f"model fwd:       {t[0]:.2f} ms  ({fmt(t)})")
    tg = per_call_ms(fwd_bwd, reps, dev)
    print(f"model fwd+bwd:   {tg[0]:.2f} ms  ({fmt(tg)})")
    return {"times": {"model fwd": t, "model fwd+bwd": tg}}


def section_step(dev: torch.device, B: int, reps: int) -> Dict:
    """The flagship step: `train_step` (K = 1), then `train_step_multi` at
    K = 8 (a CUDA graph replay on the card; K eager steps on the CPU)."""
    from neuralnet_tracker_traincode_torch.train.flagship import flagship_trainer, synthetic_batch

    trainer, state, W = flagship_trainer(B, dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(B, seed).items()} for seed in range(2)]
    gen = torch.Generator().manual_seed(7)
    box = [state]

    def step(i):
        box[0], _ = trainer.train_step(box[0], batches[i % 2], W, generator=gen)

    t = per_call_ms(step, reps, dev)
    print(f"full train_step: {t[0]:.2f} ms  ({B / t[0] * 1e3:.0f} img/s; {fmt(t)})")
    stacked = [{k: torch.stack([batches[(j + s) % 2][k] for j in range(MULTI_K)]) for k in batches[0]}
               for s in range(2)]
    replays = math.ceil(reps / MULTI_K)

    def multi(i):
        box[0], _ = trainer.train_step_multi(box[0], stacked[i % 2], W, generator=gen)

    tm = per_call_ms(multi, replays, dev)
    per_step = tuple(v / MULTI_K for v in tm)
    print(f"full train_step_multi (K={MULTI_K}): {per_step[0]:.2f} ms/step  ({B / per_step[0] * 1e3:.0f} img/s; "
          f"{fmt(per_step)} a step over {replays} calls)")
    return {"times": {"full train_step": t, f"full train_step_multi (K={MULTI_K})": per_step},
            "calls": {"train_step": WARMUP + reps, "train_step_multi": WARMUP + replays}, "steps_per_call": MULTI_K,
            "graph_warmup_steps": trainer.graph_stats["warmup_steps"]}


def section_layout(dev: torch.device, B: int, reps: int, cap: Optional[int] = None) -> Dict:
    """Per-layer conv time under NCHW and channels-last, bf16."""
    gen = torch.Generator(dev).manual_seed(0)
    shapes = LAYOUT_SHAPES[: len(LAYOUT_SHAPES) if cap is None else cap]
    tot = {lay: [0.0, 0.0] for lay, _ in LAYOUTS}
    rows = {}
    print(f"{'layer':24} {'NCHW f/fb ms':>16} {'channels_last f/fb ms':>22}")
    for name, S, cin, cout, k, stride, groups, count in shapes:
        x32 = torch.rand((B, cin, S, S), generator=gen, device=dev)
        w32 = torch.rand((cout, cin // groups, k, k), generator=gen, device=dev) * 0.01
        r = {}
        for lay, fmt_ in LAYOUTS:
            x0 = x32.to(torch.bfloat16).contiguous(memory_format=fmt_)
            w = w32.to(torch.bfloat16).contiguous(memory_format=fmt_).requires_grad_(True)
            xs = [s[0].contiguous(memory_format=fmt_).detach().requires_grad_(True)
                  for s in input_sets(lambda i: (x0 * (1 + i * 1e-2),), reps)]

            def conv(x):
                return F.conv2d(x, w, stride=stride, padding=k // 2, groups=groups)

            with torch.no_grad():
                gy = conv(xs[0]).detach().normal_()  # a dense cotangent in the output's layout
                tf = back_to_back_ms(lambda i: conv(xs[i % len(xs)]), reps, dev)
            tb = back_to_back_ms(
                lambda i: torch.autograd.grad(conv(xs[i % len(xs)]), (xs[i % len(xs)], w), grad_outputs=gy),
                reps, dev)
            r[lay] = (tf[0], tb[0])
            del x0, xs, gy
        del x32
        rows[name] = (r, count)
        print(f"{name:24} {r['NCHW'][0]:7.3f}/{r['NCHW'][1]:7.3f} "
              f"{r['channels_last'][0]:10.3f}/{r['channels_last'][1]:7.3f}  x{count}")
        if "pad8" not in name:  # the padded stem is an alternative, not additive
            for lay in tot:
                tot[lay][0] += r[lay][0] * count
                tot[lay][1] += r[lay][1] * count
    for lay, (f, fb) in tot.items():
        print(f"TOTAL {lay}: fwd {f:.2f} ms, fwd+bwd {fb:.2f} ms")
    _unqueued_line(dev)
    return {"rows": rows, "totals": {lay: tuple(v) for lay, v in tot.items()}}


def run_section(name: str, dev: torch.device, B: int, reps: int) -> Dict:
    print(f"== {name} (batch {B}) ==")
    if name == "layout":
        cap = os.environ.get("PROF_LAYOUT_SHAPES")
        return section_layout(dev, B, reps, None if cap is None else int(cap))
    return globals()[f"section_{name}"](dev, B, reps)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sections", nargs="*", metavar="SECTION", help=f"any of {', '.join(SECTIONS)} (default: step)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    want = set(args.sections) or {"step"}
    if want - set(SECTIONS):
        parser.error(f"unknown sections {sorted(want - set(SECTIONS))}; choose from {', '.join(SECTIONS)}")
    dev = resolve_device(args.device)
    B = int(os.environ.get("PROF_BATCH", 512))
    reps = int(os.environ.get("PROF_REPS", 30))
    for name in SECTIONS:
        if name in want:
            run_section(name, dev, B, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
