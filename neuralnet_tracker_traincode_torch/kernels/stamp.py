"""The training step's stamp (`csrc/stamp.cu`): (kind | arg << 8, a time in
ns) into the next slot of a ring, the cursor beside it.

A ring is a (capacity, 2) int64 tensor and its cursor a (1,) int64 tensor
that counts every stamp written; slot `cursor % capacity` takes the next, so
a full ring overwrites its oldest stamps (`unroll` reads them back in order
with the count lost). On the card the kernel reads the card's %globaltimer;
for CPU tensors the plain version writes the host's `time.perf_counter_ns()`,
since the CPU's work is done by the time the stamp is written.
"""

import time
from typing import Tuple

import numpy as np
import torch

from neuralnet_tracker_traincode_torch.kernels import ext

KINDS = 16  # csrc/nntc_kernels.h: NNTC_STAMP_KINDS; each kind its own kernel name


def new_ring(capacity: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """An empty ring of `capacity` slots and its cursor on `device`."""
    if capacity < 1:
        raise ValueError(f"a ring needs a slot, got capacity {capacity}")
    return (torch.zeros((capacity, 2), dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))


def stamp_plain(ring: torch.Tensor, cursor: torch.Tensor, kind: int, arg: int, ns: int):
    c = int(cursor[0])
    ring[c % ring.shape[0]] = torch.tensor([kind | (arg << 8), ns])
    cursor[0] = c + 1


def stamp(ring: torch.Tensor, cursor: torch.Tensor, kind: int, arg: int = 0):
    """One stamp of `kind` (0 to 15) with `arg` (>= 0): the kernel, queued on
    the current stream (or captured into a CUDA graph), for a CUDA ring; the
    plain version with the host's clock for a CPU ring."""
    if not 0 <= kind < KINDS or arg < 0:
        raise ValueError(f"no stamp of kind {kind} and argument {arg}")
    if ring.device.type == "cpu":
        stamp_plain(ring, cursor, kind, arg, time.perf_counter_ns())
        return
    ext.extension().stamp(ring, cursor, int(kind), int(arg))
    ext.LAUNCHES["stamp"] += 1


def unroll(ring, cursor) -> Tuple[np.ndarray, int]:
    """(stamps (n, 3) int64 of kind, arg and ns, oldest first; the number of
    stamps overwritten) of a ring and its cursor, read on the host."""
    ring = np.asarray(torch.as_tensor(ring).cpu())
    c, cap = int(torch.as_tensor(cursor).reshape(-1)[0]), len(ring)
    rows = ring[:c] if c <= cap else np.roll(ring, -(c % cap), axis=0)
    return np.stack([rows[:, 0] & 0xFF, rows[:, 0] >> 8, rows[:, 1]], axis=1), max(0, c - cap)
