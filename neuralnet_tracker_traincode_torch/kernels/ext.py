"""Build, load and count the hand-written CUDA kernels.

All sources in `csrc/` are compiled in one `torch.utils.cpp_extension.load`
call for `sm_90a` (Hopper), at first use, into `.cache/torch_kernels/` at the
root of the checkout. Only `bindings.cpp` includes PyTorch's headers; the
`.cu` files have a plain C++ interface (`nntc_kernels.h`). No
`--use_fast_math`: the kernels must round as PyTorch's own ops do.

`LAUNCHES` counts, per kernel, the calls that launched it on the card (the
wrappers add one where they launch, and nowhere else), so a run can show
which kernels its path went through.
"""

import os
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, ".cache", "torch_kernels")
SOURCES = ("bindings.cpp", "warp.cu", "equalize.cu", "noise.cu", "jpeg_idct.cu")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {
    "warp_roi_rotate": 0,
    "equalize": 0,
    "gaussian_noise": 0,
    "gaussian_noise_from_bits": 0,
    "jpeg_idct": 0,
}

_ext = None
_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def extension(verbose: bool = False):
    """The compiled extension module, built on first call (once per process)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name="nntc_torch_kernels",
                sources=[os.path.join(_CSRC, s) for s in SOURCES],
                extra_include_paths=[_CSRC],
                extra_cflags=["-O2"],
                extra_cuda_cflags=CUDA_FLAGS,
                build_directory=BUILD_DIR,
                verbose=verbose,
            )
        return _ext


def require_cuda_tensor(t, name: str, dtype, ndim: int):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` with `ndim` dims."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
