"""The general traffic generator. A traffic mix is a JSON file of parameters
under `portbench/traffic/`; everything it describes is made here from the
run's seed, on the device in a few large calls where it lives there.

Parameters every mix has: `path` ("resident": blocks of batches held on the
device and replayed in turn), `batch`, `steps_per_dispatch` (K), `source_size`,
`roi_side` (every face box a square of this side, so every block asks K1
for the same launch plan and one CUDA graph serves the window),
`warmup_blocks`, `lead_blocks` (replays the host may queue ahead of the
device), `trace_blocks` (blocks the profiler records in a traced run),
`settle_s` (seconds the device is left idle at the end of set-up: on the
H100 the graph's blocks run ~7.5 ms slower for a while after set-up, and
not after such a pause; PERF.md, section 5).
"resident" adds `blocks`."""

from typing import Dict

import torch

LABEL_FIELDS = ("pose", "coord", "roi", "pt3d_68", "shapeparam", "hasface", "coord_convention_id")


def seeded(seed: int, stream: int) -> int:
    """The seed of one of the run's streams: the run's seed and the stream's number mixed into 63 bits."""
    return (int(seed) * 1000003 + stream) % 2**63


def device_generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one of the run's streams."""
    return torch.Generator(device=device).manual_seed(seeded(seed, stream))


def labels(n: int, side: float, roi_side: float, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """`n` samples' labels in source pixels: a rotation up to 70 degrees
    about a random axis, a head centred in the middle quarter of the frame
    with its box a square of `roi_side`, a size of 0.4-0.5 of it, 68 points
    in the box, 50 shape parameters (sd 0.6)."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    axis = torch.randn((n, 3), generator=gen, device=device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = 0.5 * torch.deg2rad(70.0 * u(n))
    pose = torch.cat([axis * torch.sin(half)[:, None], torch.cos(half)[:, None]], dim=-1)
    centre = side * (0.38 + 0.24 * u(n, 2))
    size = roi_side * (0.4 + 0.1 * u(n, 1))
    roi = torch.cat([centre - roi_side / 2.0, centre + roi_side / 2.0], dim=-1)
    local = (2.0 * u(n, 68, 3) - 1.0) * (roi_side / 2.0)
    pt3d = torch.cat([centre[:, None, :] + local[..., :2], local[..., 2:]], dim=-1)
    return {
        "pose": pose, "coord": torch.cat([centre, size], dim=-1), "roi": roi, "pt3d_68": pt3d,
        "shapeparam": 0.6 * torch.randn((n, 50), generator=gen, device=device),
        "hasface": torch.full((n,), 0.9, device=device),
        "coord_convention_id": torch.zeros((n,), dtype=torch.int32, device=device),
    }


def batch_fields(B: int, device) -> Dict[str, torch.Tensor]:
    """The fields of a fused batch that are not labels: one dataset, one tag, single frames."""
    return {"tag_id": torch.zeros((B,), dtype=torch.int32, device=device),
            "dataset_weight": torch.ones((B,), dtype=torch.float32, device=device),
            "param_index": torch.arange(B, dtype=torch.int32, device=device)}


def resident_blocks(t: Dict, seed: int, device):
    """`blocks` blocks of K x B uniform-noise sources of `source_size`^2 and
    their labels, on `device`: a list of dicts of (K, B, ...) tensors."""
    K, B, side = t["steps_per_dispatch"], t["batch"], t["source_size"]
    gen = device_generator(seed, device, 1)
    out = []
    for _ in range(t["blocks"]):
        lab = labels(K * B, side, t["roi_side"], gen, device)
        block = {k: v.reshape((K, B) + tuple(v.shape[1:])) for k, v in lab.items()}
        block["image"] = torch.randint(0, 256, (K, B, side, side, 1), generator=gen, device=device,
                                       dtype=torch.uint8)
        for k, v in batch_fields(B, device).items():
            block[k] = v[None].expand((K,) + tuple(v.shape)).contiguous()
        out.append(block)
    return out
