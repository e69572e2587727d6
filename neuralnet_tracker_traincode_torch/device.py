"""Device selection shared by the port's entry points, and the constants
that the training step keeps on its device."""

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks otherwise;
    under `torchrun` (`LOCAL_RANK` set), the card without an index is
    `cuda:LOCAL_RANK`.

    Raises instead of falling back to the CPU when CUDA is requested but
    absent, so a run never silently measures the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (see ROADMAP.md)")


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(values, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values` (a list or an array) as a `dtype` tensor on `device`, copied
    from the host once per device and kept. The training step reads its
    host constants through this, so that after its first call it copies
    nothing from the host: a CUDA graph capture refuses a pageable copy.
    The tensor is shared: callers must not change it in place."""
    a = np.asarray(values)
    device = torch.device(device)
    key = (device, dtype, a.dtype.str, a.shape, a.tobytes())
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a).to(dtype=dtype).to(device)
    return t
