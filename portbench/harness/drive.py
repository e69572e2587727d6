"""One run of one cell: set-up, the measured window, the traced part of it,
the per-layer readers, and the check against the reference.

A cell names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`); its limits are `limits/<cell>.json`; each metric
is read by `metrics/<metric>.py`. The traffic's `path` picks the feed from
`PATHS` ("resident" replays blocks held on the device), which drives
`PoseTrainer.train_step_multi` at K steps a call, the entry the training
CLI uses on the card."""

import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from portbench.harness import bounds, check, program
from portbench.harness import trace as T
from portbench.harness import traffic as TR

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "neuralnet_tracker_traincode_tpu")
FAULTS = ("frozen_state", "half_batch", "altered_answer")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str, checkout: Optional[str] = None):
    """(benchmark, cell, configuration, traffic, limits) of a cell by name,
    from `checkout`'s BENCHMARK.json and files (default: this one's)."""
    checkout = checkout or CHECKOUT
    bench = load_json(checkout, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(checkout, cfg_entry["file"])
    traffic = load_json(checkout, "portbench", "traffic", cell["traffic"] + ".json")
    return bench, cell, config, traffic, load_json(checkout, "portbench", "limits", name + ".json")


def metrics_of(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: its end-to-end ones untraced, its
    per-layer ones traced (those that list it, or without a list, those of
    an end-to-end metric it reports)."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if name in m.get("workloads", [name] if m["moves"] in names else [])]


def reader(metric: str, checkout: Optional[str] = None) -> Callable:
    """`read(ctx)` of `portbench/metrics/<metric>.py`."""
    path = os.path.join(checkout or CHECKOUT, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """Completion times of the device's work: CUDA events on the card, the
    host clock after the work on the CPU (which has no queue)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Context:
    """What a metric's reader reads: the window (host clock), the traced
    part of it, the run's own counters, the cell's configuration
    and traffic, and the yardstick's arithmetic (`bounds`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def plant(tr, fault: Optional[str]):
    """Break the timed path underneath, for the check's own tests: a step
    that leaves the state as it was; the loss over half of the batch, its
    mean taken over the rest; the step's loss altered (by 10%) where it is
    computed."""
    if fault is None:
        return
    if fault == "frozen_state":
        tr.tx.step = lambda params, grads, state: state
        return
    crit = tr.criterion
    inner = crit.__call__

    def half(v):
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            return v[: v.shape[0] // 2]
        if hasattr(v, "value"):
            return type(v)(v.value[: v.value.shape[0] // 2])
        return v

    class Broken:
        def __getattr__(self, name):
            return getattr(crit, name)

        def __call__(self, preds, batch, tag_id, weight_matrix, dataset_weight=None):
            if fault == "half_batch":
                h = tag_id.shape[0] // 2
                return inner({k: half(v) for k, v in preds.items()}, {k: half(v) for k, v in batch.items()},
                             tag_id[:h], weight_matrix, None if dataset_weight is None else dataset_weight[:h])
            total, byname = inner(preds, batch, tag_id, weight_matrix, dataset_weight)
            return total * 1.1, byname

    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    tr.criterion = Broken()


def initial_state(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    from portbench.reference import model as M

    return M.initial_values(M.PoseNetwork(config), TR.device_generator(seed, device, 0), device)


class Resident:
    """Blocks held on the device, replayed in turn."""

    def __init__(self, t: Dict, seed: int, device):
        from neuralnet_tracker_traincode_torch.data.loader import StackedBatch

        self.t, self.seed, self.device = t, seed, device
        self.blocks = []
        for b in TR.resident_blocks(t, seed, device):
            host = {k: v.cpu().pin_memory() if device.type == "cuda" else v for k, v in b.items() if k != "image"}
            self.blocks.append(StackedBatch(b, host))

    def next(self, i: int):
        return self.blocks[i % len(self.blocks)]

    def first_block_inputs(self):
        """The check's inputs of the first block, made again from the seed."""
        b = TR.resident_blocks({**self.t, "blocks": 1}, self.seed, self.device)[0]
        return b["image"], {k: b[k] for k in TR.LABEL_FIELDS}

    def close(self):
        self.blocks = []


PATHS = {"resident": Resident}


class Setup:
    """A cell's system under test driven from the seed through its first
    block (the timed path's own call and feed), and what the check keeps of it."""

    def __init__(self, name: str, seed: int, device, overrides: Optional[Dict] = None, fault: Optional[str] = None,
                 checkout: Optional[str] = None, train: bool = True):
        self.bench, self.cell, config, t, self.limits = cell_spec(name, checkout)
        overrides = overrides or {}
        self.t = {**t, **overrides.get("traffic", {})}
        self.config = {**config, **overrides.get("config", {})}
        self.seed, self.dev = seed, torch.device(device or "cuda")
        self.phases: Dict[str, float] = {}
        self.phases_t = time.perf_counter()
        self.sd0 = initial_state(self.config, seed, self.dev)
        self._phase("weights")
        self.feed = PATHS[self.t["path"]](self.t, seed, self.dev)
        self._phase("traffic")
        self.gen = torch.Generator().manual_seed(TR.seeded(seed, 3))
        self.tr = self.state = None
        self.first = self.feed.next(0)
        self._phase("first feed")
        if train:
            self.tr, self.W = program.trainer(self.config, self.dev)
            plant(self.tr, fault)
            self.state = self.tr.init_state(state_dict=self.sd0)
            self._phase("trainer")
            self.state, m = self.tr.train_step_multi(self.state, self.first, self.W, generator=self.gen)
            terms = ["loss"] + [c["name"] for c in self.config["criterion"]]
            if list(m) != terms:  # the check compares the metrics in this order
                raise RuntimeError(f"the program reports {list(m)}, the configuration's terms are {terms}")
            self.first_metrics = torch.stack([m[n] for n in m], dim=-1).float().cpu()
            self._phase("first block (kernels loaded, graph captured)")
            self.after_first = program.state_tensors(self.tr, self.state)
            self._phase("state copied for the check")

    def _phase(self, name: str):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.phases[name] = now - self.phases_t
        self.phases_t = now

    def step(self, i: int):
        self.state, m = self.tr.train_step_multi(self.state, self.feed.next(i), self.W, generator=self.gen)
        return m

    def release(self):
        """The check's inputs, once the program's state is freed."""
        inputs = self.feed.first_block_inputs()
        self.feed.close()
        self.tr = self.state = self.first = self.feed = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return inputs


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, t_start: Optional[float] = None,
             overrides: Optional[Dict] = None, fault: Optional[str] = None, checkout: Optional[str] = None,
             log=print) -> Dict[str, Any]:
    """One run; returns the result line's object. `overrides` replaces
    entries of the traffic and the configuration (the CPU tests' tiny
    sizes); `fault` breaks the timed path (`plant`)."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    t_start = time.perf_counter() if t_start is None else t_start
    imports = time.perf_counter() - t_start
    run = Setup(name, seed, device, overrides, fault, checkout)
    run.phases = {"start and imports": imports, **run.phases}
    bench, cell, config, t, limits, dev = run.bench, run.cell, run.config, run.t, run.limits, run.dev
    clock = Clock(dev)
    K, B = t["steps_per_dispatch"], t["batch"]
    for i in range(1, t["warmup_blocks"]):
        run.step(i)
    if trace:  # the profiler's first start initialises its tracing of the device: a set-up cost
        start_profiler(dev, clock).stop()
    clock.sync()
    time.sleep(t.get("settle_s", 0))  # the device left idle until its blocks run at their steady pace
    setup_s = time.perf_counter() - t_start
    run.phases["warmup and settle"] = time.perf_counter() - run.phases_t
    log(f"portbench: set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.phases.items()))
    tr = run.tr
    captures0 = tr.graph_stats["captures"]
    ext.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window ----
    marks, losses = [clock.mark()], []
    lead, n_traced = t["lead_blocks"], t["trace_blocks"]
    prof = traced = None
    i = t["warmup_blocks"]
    t0 = time.perf_counter()
    while True:
        if len(marks) > lead:
            clock.wait(marks[-lead])
        elapsed = time.perf_counter() - t0
        if trace and prof is None and elapsed >= 0.3 * seconds:
            prof = start_profiler(dev, clock)
            traced = {"first": len(marks), "start": clock.mark(), "blocks": None}
        if elapsed >= seconds and (prof is None or traced["blocks"] is not None):  # a traced part runs whole
            break
        with record_function("portbench.block"):
            m = run.step(i)
        losses.append(m["loss"])
        marks.append(clock.mark())
        i += 1
        if prof is not None and traced["blocks"] is None and len(marks) - traced["first"] >= n_traced:
            traced.update(blocks=n_traced, end=clock.mark())
            clock.sync()
            prof.stop()
    clock.sync()
    window_s = time.perf_counter() - t0
    blocks = len(marks) - 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    captures = tr.graph_stats["captures"] - captures0
    block_ms = [clock.ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
    q = sorted(block_ms) or [0.0]
    log("portbench: block ms p5/p25/p50/p75/p95 " + "/".join(f"{q[int(p * (len(q) - 1))]:.2f}"
                                                          for p in (0.05, 0.25, 0.5, 0.75, 0.95))
        + "; in order: " + " ".join(f"{v:.1f}" for v in block_ms))
    log(f"portbench: {blocks} blocks of {K} x {B} in {window_s:.4f} s; graph captures in the window {captures} "
        f"(graph stats {tr.graph_stats}); kernel launches {dict(ext.LAUNCHES)}")
    nonfinite = int((~torch.isfinite(torch.stack(losses).float())).any(1).sum()) if losses else 0

    ctx = Context(config=config, traffic=t, bounds=bounds, device=dev,
                  window={"seconds": window_s, "blocks": blocks, "images": blocks * K * B, "setup_s": setup_s,
                          "block_ms": block_ms},
                  counters={"captures": captures, "launches": dict(ext.LAUNCHES)},
                  trace=None, traced=None, draws=None)
    out: Dict[str, Any] = {}
    if trace and prof is not None:
        tr_events = T.collect(prof)
        traced_s = clock.ms(traced["start"], traced["end"]) / 1e3
        ctx.trace, ctx.traced = tr_events, {"blocks": traced["blocks"], "window_s": traced_s,
                                            "first_block": traced["first"] - 1,
                                            "images": traced["blocks"] * K * B, "busy_s": T.busy_s(tr_events)}
        ctx.draws = draws_of(config, t, seed, traced["first"] - 1 + t["warmup_blocks"], traced["blocks"])
        out["breakdown"] = T.breakdown(tr_events)
    values = {}
    for metric in metrics_of(bench, cell, trace):
        v = reader(metric["name"], checkout)(ctx)
        if v is not None:
            values[metric["name"]] = {"value": float(v), "unit": metric["unit"]}

    # ---- the check, once the program's state is freed ----
    tr = m = None
    first_inputs = run.release()
    numbers = reference_numbers(config, run.sd0, first_inputs, run.first_metrics, run.after_first, seed, dev)
    numbers["nonfinite"] = float(nonfinite)
    correct = check.judged(numbers, limits)
    loaded = sorted({n.split(".")[0] for n in sys.modules} & set(JAX_NAMES))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace and ctx.traced is not None:
        device_info.update(busy_s=ctx.traced["busy_s"], window_s=ctx.traced["window_s"])
    result = {"correct": bool(correct), "attempted": blocks + t["warmup_blocks"], "failed": nonfinite,
              "metrics": values, "device": device_info}
    result.update(out)
    result["compared"] = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    result["_loaded_jax"] = loaded
    return result


def start_profiler(dev, clock):
    from torch.profiler import ProfilerActivity, profile

    clock.sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def draws_of(config: Dict, t: Dict, seed: int, first_block: int, n: int):
    """The augmentation draws of blocks first_block .. first_block + n - 1,
    made again from the run's seed (the reference's sampler)."""
    from portbench.reference import augment as A

    gen = torch.Generator().manual_seed(TR.seeded(seed, 3))
    K, B = t["steps_per_dispatch"], t["batch"]
    out = []
    for blk in range(first_block + n):
        for _ in range(K):
            d = A.draw(gen, B, config["augmentation"])
            if blk >= first_block:
                out.append(d)
    return out


def follow_reference(config, sd0, first_inputs, seed, precision=None):
    """The reference over the first block: (metrics, state dict, first moment)."""
    from portbench.reference import augment as A
    from portbench.reference import train as RT

    images, labels = first_inputs
    K, B = images.shape[:2]
    gen = torch.Generator().manual_seed(TR.seeded(seed, 3))
    draws = [A.draw(gen, B, config["augmentation"]) for _ in range(K)]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rm, rstate, mu, nu = RT.follow(config, sd0, images, labels, draws, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return rm, rstate, mu, nu


def reference_numbers(config, sd0, first_inputs, first_metrics, after_first, seed, dev) -> Dict[str, float]:
    """The numbers compared: the program's first block against the reference's."""
    rm, rstate, mu, nu = follow_reference(config, sd0, first_inputs, seed)
    return check.training_numbers(first_metrics, after_first, rm, rstate, mu, nu, sd0)


CONTROL_PRECISION = {"bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn", "float32": "bfloat16"}


def control_numbers(name: str, seed: int, device=None, overrides: Optional[Dict] = None,
                    checkout: Optional[str] = None, precision: Optional[str] = None) -> Dict[str, float]:
    """The control: the reference in the program's place, computed in the
    precision below the configuration's (float8 e4m3 for bfloat16), or in
    `precision`, against the reference, on the first block's inputs."""
    run = Setup(name, seed, device, overrides, checkout=checkout, train=False)
    inputs = run.release()
    low = getattr(torch, precision or CONTROL_PRECISION[run.config["dtype"]])
    cm, cstate, cmu, cnu = follow_reference(run.config, run.sd0, inputs, seed, precision=low)
    rm, rstate, rmu, rnu = follow_reference(run.config, run.sd0, inputs, seed)
    control = {"state": {k: v.float().cpu() for k, v in cstate.items()}, "mu": {k: v.cpu() for k, v in cmu.items()},
               "nu": {k: v.cpu() for k, v in cnu.items()}}
    return check.training_numbers(cm, control, rm, rstate, rmu, rnu, run.sd0)
