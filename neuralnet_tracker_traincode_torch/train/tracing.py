"""The training step's tracer: stamps on the device and spans on the host,
put on one clock.

`PoseTrainer.device_step` opens its sections (`SECTIONS`) with
`Tracer.section`, and the trainer's host part its spans (`HOST_SPANS`) with
`Tracer.span`. Both always open a `torch.profiler.record_function` range of
the same name, so that a profile names them as before. Only while the tracer
is on (`enable`) does a section also launch a stamp (`kernels/stamp.py`: one
thread writes its kind and the card's clock into the next slot of a ring on
the card), and a span also keep its host times (`time.perf_counter_ns`) in a
preallocated array. A section's stamp is queued where its kernels are, and
so it is captured into the K-step CUDA graph with them: the ring times the
sections of every replay, which a profiler sees only as one graph launch.
On the CPU, whose work is done when the call returns, a stamp takes the
host's clock.

A block is what one call of `train_step_multi` (or `train_step`) queues on
the device: a `load` stamp before the slot copies (its argument is the
block's number), each step's section stamps and a `step_end` stamp (their
argument the step's index), and a `block_end` stamp after the metrics (its
argument the number of steps). A section's device time runs from its stamp
to the next stamp, so the launch gaps inside a section are its own; from a
`block_end` to the next block's `load` the device is idle. On the CPU a
block is one step (`train_step_multi` runs K `train_step` calls there).

`anchor` puts the device's clock on the host's: synchronise, read the host's
clock, stamp, synchronise, read it again; the stamp lies within that
bracket. The tracer takes an anchor when it turns on and another when its
records are read, which also gives the drift between the two clocks. The
idle gaps, put on the host's clock, are named by the host span open where
each begins (`host_span_at`), or `OUTSIDE` where the trainer had none open.

Whether the stamps are on is part of a CUDA graph's key (`key`): a graph
captured with the tracer off has exactly the kernels it had before the
tracer existed, and costs nothing more in a replay.
"""

import contextlib
import re
import statistics
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from neuralnet_tracker_traincode_torch.kernels import stamp as S

SECTIONS = ("augment", "forward", "loss", "backward", "gradient_mean", "optimizer")
KINDS = ("load",) + SECTIONS + ("step_end", "block_end", "anchor")  # a stamp's kind is its index here
KIND = {name: i for i, name in enumerate(KINDS)}
HOST_SPANS = ("draws", "sample", "load", "replay")  # 'sample' and 'load' lie inside 'draws'
OUTSIDE = "outside the trainer"
STAMP_KERNEL = re.compile(r"nntc_stamp_kernel<(\d+)>")


class Anchor(NamedTuple):
    host_ns: int  # the middle of the host's bracket
    device_ns: int  # the stamp's time on the device's clock
    half_ns: int  # half the bracket's width: how far host_ns may be off

    @property
    def offset_ns(self) -> int:
        return self.device_ns - self.host_ns


class Records(NamedTuple):
    stamps: np.ndarray  # (n, 3) int64: kind, argument, device ns; oldest first
    stamps_lost: int  # overwritten by a full ring
    spans: np.ndarray  # (m, 4) int64: index in HOST_SPANS, block number, host start ns, host end ns
    spans_lost: int
    anchors: Tuple[Anchor, ...]


class Block(NamedTuple):
    number: int
    marks: np.ndarray  # (n, 3) of `Records.stamps`, from the load stamp to the block_end stamp

    @property
    def start(self) -> int:
        return int(self.marks[0, 2])

    @property
    def end(self) -> int:
        return int(self.marks[-1, 2])


class Tracer:
    """Off until `enable`; a trainer keeps one (`PoseTrainer.tracer`)."""

    def __init__(self, device, capacity: int = 1 << 16):
        self.device = torch.device(device)
        self.capacity = capacity
        self.on = False
        self.block = 0  # the number of the block being prepared (`next_block`)
        self._step = 0  # steps stamped since the block's load stamp
        self._ring = self._cursor = None
        self._spans = np.zeros((0, 4), np.int64)
        self._span_count = 0
        self._anchors: List[Anchor] = []

    def enable(self) -> "Tracer":
        """Turn the stamps and spans on (the ring is made once, at the first
        call) and take the first anchor."""
        if self._ring is None:
            self._ring, self._cursor = S.new_ring(self.capacity, self.device)
            self._anchor_ring, self._anchor_cursor = S.new_ring(1, self.device)
            self._spans = np.zeros((self.capacity, 4), np.int64)
        if not self.on:
            self.on = True
            self._anchors.append(self.anchor())
        return self

    def disable(self):
        self.on = False

    def key(self) -> Optional[int]:
        """What a CUDA graph captured now depends on: the ring, or None when off."""
        return self._ring.data_ptr() if self.on else None

    @contextlib.contextmanager
    def paused(self):
        """No stamp and no span inside (a graph's warm-up steps)."""
        on, self.on = self.on, False
        try:
            yield
        finally:
            self.on = on

    # ---- what the trainer calls ----
    def next_block(self):
        if self.on:
            self.block += 1

    def stamp(self, kind: str):
        """A stamp of `kind` (`KINDS`) where the tracer is on; its argument is
        the block's number for 'load', else the steps stamped since it."""
        if not self.on:
            return
        arg = self.block if kind == "load" else self._step
        S.stamp(self._ring, self._cursor, KIND[kind], arg)
        if kind == "load":
            self._step = 0
        elif kind == "step_end":
            self._step += 1

    def section(self, name: str):
        """The device section `name`: its profiler range, and its stamp at the start where the tracer is on."""
        return _Section(self, name) if self.on else record_function(name)

    def span(self, name: str):
        """The host span `name`: its profiler range, and its host times where the tracer is on."""
        return _Span(self, name) if self.on else record_function(name)

    def _add_span(self, name: str, t0: int, t1: int):
        self._spans[self._span_count % self.capacity] = (HOST_SPANS.index(name), self.block, t0, t1)
        self._span_count += 1

    # ---- the clocks and the records ----
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def anchor(self) -> Anchor:
        """The narrowest of 5 brackets of host clock around a stamp (module
        docstring); nothing may be queued meanwhile by another thread."""
        best = None
        for _ in range(5):
            self._sync()
            h0 = time.perf_counter_ns()
            S.stamp(self._anchor_ring, self._anchor_cursor, KIND["anchor"])
            self._sync()
            h1 = time.perf_counter_ns()
            a = Anchor((h0 + h1) // 2, int(self._anchor_ring[0, 1]), (h1 - h0 + 1) // 2)
            if best is None or a.half_ns < best.half_ns:
                best = a
        return best

    def records(self) -> Records:
        """Everything recorded since `enable` or `clear`, after a last anchor
        (it waits for the device)."""
        if self._ring is None:
            return Records(np.zeros((0, 3), np.int64), 0, np.zeros((0, 4), np.int64), 0, ())
        self._anchors.append(self.anchor())
        stamps, lost = S.unroll(self._ring, self._cursor)
        n, cap = self._span_count, self.capacity
        spans = self._spans[:n] if n <= cap else np.roll(self._spans, -(n % cap), axis=0)
        return Records(stamps, lost, spans.copy(), max(0, n - cap), tuple(self._anchors))

    def clear(self):
        """Forget the records (the ring's cursor is zeroed in stream order);
        the last anchor stays as the first of what follows."""
        if self._ring is not None:
            self._cursor.zero_()
        self._span_count = 0
        self._anchors = self._anchors[-1:]


class _Section:
    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name, self.range = tracer, name, record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.tracer.stamp(self.name)
        return self

    def __exit__(self, *exc):
        return self.range.__exit__(*exc)


class _Span:
    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name, self.range = tracer, name, record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer._add_span(self.name, self.t0, time.perf_counter_ns())
        return self.range.__exit__(*exc)


# ---- reading the records ----
def split_blocks(stamps: np.ndarray) -> List[Block]:
    """The whole blocks among `stamps`: each load stamp with the stamps up to
    the next block_end. Stamps before the first load (a full ring's oldest
    were overwritten) and a block with no end yet are left out."""
    out, start = [], None
    for i, kind in enumerate(stamps[:, 0]):
        if kind == KIND["load"]:
            start = i
        elif kind == KIND["block_end"] and start is not None:
            out.append(Block(int(stamps[start, 1]), stamps[start:i + 1]))
            start = None
    return out


def section_ns(block: Block) -> Dict[str, int]:
    """Device ns of the block by the kind of the stamp that opens each
    interval, summed over its steps: 'load' (the slot copies), each section,
    and 'step_end' (from a step's end to the next stamp: the metrics' stack
    after the last step)."""
    out: Dict[str, int] = {}
    for kind, ns in zip(block.marks[:-1, 0], np.diff(block.marks[:, 2])):
        out[KINDS[kind]] = out.get(KINDS[kind], 0) + int(ns)
    return out


def device_idle_pct(blocks: Sequence[Block]) -> Optional[float]:
    """100 x the device's idle time between consecutive blocks over their
    whole extent (the blocks' own time plus those gaps); None without a block."""
    busy = sum(b.end - b.start for b in blocks)
    idle = sum(n.start - b.end for b, n in zip(blocks, blocks[1:]) if n.number == b.number + 1)
    return 100.0 * idle / (busy + idle) if busy + idle > 0 else None


def to_host_ns(device_ns: int, anchors: Sequence[Anchor]) -> int:
    """A time on the device's clock on the host's: minus the anchors'
    offset, interpolated between them (held at the first and the last
    outside them)."""
    d0, o0 = anchors[0].device_ns, anchors[0].offset_ns
    if len(anchors) == 1:
        return int(device_ns - o0)
    xs = [a.device_ns - d0 for a in anchors]
    ys = [a.offset_ns - o0 for a in anchors]
    return int(device_ns - o0 - round(float(np.interp(device_ns - d0, xs, ys))))


def clock_stats(anchors: Sequence[Anchor]) -> Optional[Dict[str, float]]:
    """The anchors' worst uncertainty and the drift of the device's clock
    against the host's from the first anchor to the last (us, over s)."""
    if not anchors:
        return None
    first, last = anchors[0], anchors[-1]
    span_s = (last.host_ns - first.host_ns) / 1e9
    return {"uncertainty_us": max(a.half_ns for a in anchors) / 1e3,
            "drift_us": (last.offset_ns - first.offset_ns) / 1e3, "over_s": span_s}


def host_span_at(spans: np.ndarray, host_ns: int) -> str:
    """The innermost host span open at `host_ns`, or `OUTSIDE`."""
    open_ = spans[(spans[:, 2] <= host_ns) & (host_ns <= spans[:, 3])]
    if not len(open_):
        return OUTSIDE
    return HOST_SPANS[int(open_[np.argmin(open_[:, 3] - open_[:, 2]), 0])]


def idle_gaps(blocks: Sequence[Block], spans: np.ndarray, anchors: Sequence[Anchor]) -> List[Tuple[str, int, int]]:
    """(host span open where it began, its start on the host's clock, ns) of
    every gap between consecutive blocks."""
    out = []
    for b, n in zip(blocks, blocks[1:]):
        if n.number == b.number + 1 and n.start > b.end:
            t = to_host_ns(b.end, anchors)
            out.append((host_span_at(spans, t), t, n.start - b.end))
    return out


def summarize(rec: Records, skip_blocks: Iterable[int] = ()) -> Dict:
    """What the records say, over their whole blocks but those numbered in
    `skip_blocks`: device ms a block by section (the median over blocks,
    each section summed over the block's steps), the block's median ms from
    load to block_end, the device's idle share between blocks, the host part
    (the mean 'draws' span), the idle gaps by host span, the clocks."""
    skip = set(skip_blocks)
    blocks = [b for b in split_blocks(rec.stamps) if b.number not in skip]
    per = [section_ns(b) for b in blocks]
    names = [n for n in ("load",) + SECTIONS + ("step_end",) if any(n in p for p in per)]
    spans = rec.spans[~np.isin(rec.spans[:, 1], list(skip))] if skip else rec.spans
    draws = spans[spans[:, 0] == HOST_SPANS.index("draws")]
    gaps: Dict[str, float] = {}
    if rec.anchors:
        for name, _, ns in idle_gaps(blocks, rec.spans, rec.anchors):
            gaps[name] = gaps.get(name, 0.0) + ns / 1e6
    return {
        "blocks": len(blocks),
        "steps_per_block": int(statistics.median(int(b.marks[-1, 1]) for b in blocks)) if blocks else 0,
        "section_ms": {n: statistics.median(p.get(n, 0) / 1e6 for p in per) for n in names},
        "block_ms": statistics.median((b.end - b.start) / 1e6 for b in blocks) if blocks else None,
        "device_idle_pct": device_idle_pct(blocks),
        "host_part_ms": float((draws[:, 3] - draws[:, 2]).mean() / 1e6) if len(draws) else None,
        "idle_gaps_ms": gaps,
        "clock": clock_stats(rec.anchors),
        "lost": rec.stamps_lost + rec.spans_lost,
    }


def format_summary(s: Dict) -> str:
    """One line of `summarize`'s numbers."""
    if not s["blocks"]:
        return "trace: no whole block"
    secs = " ".join(f"{n} {ms:.3f}" for n, ms in s["section_ms"].items())
    gaps = ", ".join(f"{n} {ms:.2f} ms" for n, ms in sorted(s["idle_gaps_ms"].items(), key=lambda kv: -kv[1]))
    clock = s["clock"]
    host = "n/a" if s["host_part_ms"] is None else f"{s['host_part_ms']:.2f} ms"
    idle = "n/a" if s["device_idle_pct"] is None else f"{s['device_idle_pct']:.2f}%"
    return (f"trace: {s['blocks']} blocks of {s['steps_per_block']} steps, device ms a block {s['block_ms']:.3f} "
            f"({secs}); device idle {idle}" + (f" ({gaps})" if gaps else "")
            + f"; host part {host} a block; clocks +-{clock['uncertainty_us']:.1f} us, drift "
            f"{clock['drift_us']:.1f} us over {clock['over_s']:.1f} s" + (f"; {s['lost']} lost" if s["lost"] else ""))


def device_ops_by_section(ops: Iterable[Tuple[str, float, float]]) -> Dict:
    """A profiler trace's device operations ((name, start us, end us)) of
    blocks run with the tracer on, each in the section whose stamp kernel
    (`nntc_stamp_kernel<kind>`, by name) started last before it; the stamps
    themselves and what precedes the first are not counted. Per section the
    operations, their ms and the 10 names with the most ms ([name, ms, count]);
    'steps', the step_end stamps seen; 'ops_per_step', the operations of the
    sections inside a step (`SECTIONS`) over the steps."""
    top = 10
    current, steps, out = None, 0, {}
    for name, start, end in sorted(ops, key=lambda o: o[1]):
        m = STAMP_KERNEL.search(name)
        if m:
            current = KINDS[int(m.group(1))]
            steps += current == "step_end"
            continue
        if current is None:
            continue
        sec = out.setdefault(current, {"ops": 0, "ms": 0.0, "names": {}})
        sec["ops"] += 1
        sec["ms"] += (end - start) / 1e3
        c = sec["names"].setdefault(name, [0.0, 0])
        c[0] += (end - start) / 1e3
        c[1] += 1
    for sec in out.values():
        names = sec.pop("names")
        sec["top"] = [[n, ms, c] for n, (ms, c) in sorted(names.items(), key=lambda kv: -kv[1][0])[:top]]
    inside = sum(out[s]["ops"] for s in SECTIONS if s in out)
    return {"sections": out, "steps": steps, "ops_per_step": inside / steps if steps else None}
