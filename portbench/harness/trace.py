"""The profiler's events reduced to what the per-layer readers and the
breakdown need: the device's operations (kernels, copies, fills) as
intervals, the host's ranges, the union of the device intervals (busy
time) and the idle gaps between them, the longest of them named by the
innermost host range open where it begins."""

from typing import Dict, List, NamedTuple, Tuple


class Interval(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Trace(NamedTuple):
    device_ops: List[Interval]  # kernels, copies and fills on the device
    host_ranges: List[Interval]  # ranges and operations of the main thread


def collect(prof) -> Trace:
    """The events of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device, host = [], []
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CPU:
            host.append(Interval(e.name, r.start, r.end))
        elif e.device_type == DeviceType.CUDA and e.name not in host_names:  # not a range's device copy
            device.append(Interval(e.name, r.start, r.end))
    return Trace(sorted(device, key=lambda i: i.start_us), sorted(host, key=lambda i: i.start_us))


def merged(ops: List[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for o in ops:
        if out and o.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end_us)
        else:
            out.append([o.start_us, o.end_us])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in merged(trace.device_ops)) / 1e6


def device_totals(trace: Trace) -> Dict[str, float]:
    """Seconds on the device by operation name."""
    out: Dict[str, float] = {}
    for o in trace.device_ops:
        out[o.name] = out.get(o.name, 0.0) + (o.end_us - o.start_us) / 1e6
    return out


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """(start in us, seconds) of every gap between the device's busy intervals."""
    spans = merged(trace.device_ops)
    return [(a, (b - a) / 1e6) for (_, a), (b, _) in zip(spans[:-1], spans[1:])]


def host_range_at(trace: Trace, t_us: float) -> str:
    """The innermost host range open at `t_us`."""
    open_ = [h for h in trace.host_ranges if h.start_us <= t_us <= h.end_us]
    return min(open_, key=lambda h: h.end_us - h.start_us).name if open_ else "no host range"


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing."""
    ops = sorted(device_totals(trace).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_range_at(trace, t), s] for t, s in gaps]}


def host_range_ms(trace: Trace, name: str) -> List[float]:
    return [(h.end_us - h.start_us) / 1e3 for h in trace.host_ranges if h.name == name]


def kernel_seconds(trace: Trace, fragment: str) -> Tuple[int, float]:
    """(launches, seconds) of the device operations whose name holds `fragment`."""
    hits = [o for o in trace.device_ops if fragment in o.name]
    return len(hits), sum((o.end_us - o.start_us) / 1e6 for o in hits)
