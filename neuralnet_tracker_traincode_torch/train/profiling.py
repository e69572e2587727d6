"""Profiling of the training step and the throughput meter (counterpart of
the JAX package's `train/profiling.py`).

`PoseTrainer` marks its stages with `torch.profiler.record_function` ranges
named in `STAGES`, the trainer's tracer's sections and host spans
(`train/tracing.py`); they cost a few microseconds a step when no profiler
runs. On the card `train_step_multi`'s ranges are its host part ('draws',
with 'sample' and 'load' inside it) and the graph's replay ('replay'): the
captured sections run on the device without the host, so a profile shows
their kernels and not their ranges. Their device time in a replay comes from
the tracer's stamps (`Tracer.enable`, `tracing.summarize`), and a profile of
replays with the tracer on is cut into sections at the stamp kernels
(`tracing.device_ops_by_section`).

`profile_steps` runs calls of a step function under `torch.profiler` and
returns where the time went, per optimizer step: host time per stage, the
device's busy share, kernel launches per step and the kernels that take the
most device time. `profile_batches` traces the first calls of a training run
into a directory (the training CLI's `--profile-dir`, which also turns the
trainer's tracer on: its first 8 dispatches).
"""

import os
import time
from typing import Callable, Dict, Iterator, Optional, TypeVar

import torch

from neuralnet_tracker_traincode_torch.train.tracing import HOST_SPANS, SECTIONS

STAGES = HOST_SPANS + SECTIONS
T = TypeVar("T")


def profile_steps(step: Callable[[], None], steps: int, trace_path: Optional[str] = None, top: int = 12,
                  steps_per_call: int = 1) -> Dict:
    """Run `step` `steps` times under the profiler (after one unprofiled call)
    and summarise per optimizer step, a call being `steps_per_call` of them
    (K for `train_step_multi`); optionally write a Chrome trace to
    `trace_path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    calls, steps = steps, steps * steps_per_call
    if trace_path:
        prof.export_chrome_trace(trace_path)
    kernels: Dict[str, list] = {}
    host: Dict[str, float] = {s: 0.0 for s in STAGES}
    for e in prof.events():
        if e.name in host:
            # a stage range shows on the host and, as an annotation, on the device
            if e.device_type == DeviceType.CPU:
                host[e.name] += e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "calls": calls,
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ops_per_step": sum(v[0] for v in kernels.values()) / steps,
        "host_ms_per_step": {s: v / steps / 1e3 for s, v in host.items()},
        "top_device_ops": [
            {"name": n[:90], "per_step": c / steps, "ms_per_step": us / steps / 1e3} for n, (c, us) in ranked
        ],
    }


def profile_batches(batches: Iterator[T], logdir: Optional[str], steps: int = 8) -> Iterator[T]:
    """The batches of `batches`; with `logdir`, the steps that consume the
    first `steps` of them run under `torch.profiler` (host and, where there
    is a card, device activity), whose Chrome trace goes to
    `logdir/trace.json`."""
    if not logdir:
        yield from batches
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        for i, batch in enumerate(batches):
            if i == steps and prof is not None:
                _stop(prof, logdir)
                prof = None
            yield batch
    finally:
        if prof is not None:
            _stop(prof, logdir)


def _stop(prof, logdir: str):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Wrote profiler trace to {path}")


class ThroughputMeter:
    """Images per second on the host's clock, after `warmup_steps` steps
    (the first steps build kernels and pick algorithms), of the node's
    batches; `per_device` divides them over the node's `devices` (the JAX
    package's `per_chip`)."""

    def __init__(self, warmup_steps: int = 1, devices: int = 1):
        self.warmup_steps = warmup_steps
        self.devices = devices
        self.reset()

    def reset(self):
        self._seen_steps = 0
        self._images = 0
        self._t0 = None

    def step(self, batchsize: int):
        self._seen_steps += 1
        if self._seen_steps == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._images = 0
        elif self._seen_steps > self.warmup_steps:
            self._images += batchsize

    @property
    def images_per_sec(self) -> float:
        # 0, not nan, when warmup took every step so far
        if self._t0 is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._t0)

    @property
    def per_device(self) -> float:
        return self.images_per_sec / max(1, self.devices)
