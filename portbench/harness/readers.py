"""Readings that several metrics' readers share. Each takes the run's
`Context` and returns a number, or None where the run has nothing to read
(no traced part, no such kernel in it)."""

from typing import Optional

from portbench.harness import trace as T

K1, K2, K3 = "warp_roi_rotate_kernel", "equalize_kernel", "noise_seeded_kernel"


def images_per_s(ctx) -> float:
    """Images trained over the window, over the window's seconds (it ends once the device has finished)."""
    return ctx.window["images"] / ctx.window["seconds"]


def mfu_pct(ctx) -> Optional[float]:
    """The model FLOPs of the traced blocks' images over the device's busy
    time in them (the union of every operation's interval in the trace:
    K1-K3, the model's kernels, Adam, copies), as a share of the bf16 dense
    peak. Idle time is left out: the profiler slows the host's launch of
    the graph, so the traced window's idle share is the profiler's."""
    if not ctx.traced or not ctx.traced["busy_s"] or ctx.device.type != "cuda":
        return None
    flops = ctx.bounds.model_flops_per_image(ctx.config) * ctx.traced["images"]
    return 100.0 * flops / ctx.traced["busy_s"] / ctx.bounds.BF16_DENSE_FLOPS


def aug_roofline_pct(ctx) -> Optional[float]:
    """K1-K3's bounds for the traced steps' draws over their device time."""
    if ctx.trace is None or not ctx.draws:
        return None
    t, S = ctx.traffic, ctx.config["inputsize"]
    B, P = t["batch"], S * S
    theta = ctx.config["augmentation"]["rotation_aug_angle"]
    k1 = [ctx.bounds.k1_bound(t["roi_side"] * d.scales / S, t["roi_side"] * d.scales / S, t["source_size"], S, theta)
          for d in ctx.draws]
    k3 = [ctx.bounds.k3_bound(int((d.sigma > 0).sum()), B, P) for d in ctx.draws]
    k2 = ctx.bounds.k2_bound(B, P)
    total_bound, total_s = 0.0, 0.0
    for fragment, per_launch in ((K1, sum(k1) / len(k1)), (K2, k2), (K3, sum(k3) / len(k3))):
        n, s = T.kernel_seconds(ctx.trace, fragment)
        if n == 0:
            return None
        total_bound += n * per_launch
        total_s += s
    return 100.0 * total_bound / total_s


def mean_range_ms(ctx, name: str) -> Optional[float]:
    """The mean length of the host range `name` in the traced window."""
    if ctx.trace is None:
        return None
    ms = T.host_range_ms(ctx.trace, name)
    return sum(ms) / len(ms) if ms else None
