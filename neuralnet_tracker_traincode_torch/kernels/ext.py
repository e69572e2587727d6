"""Build, load and count the hand-written CUDA kernels.

All sources in `csrc/` are compiled in one `torch.utils.cpp_extension.load`
call for `sm_90a` (Hopper), at first use, into `.cache/torch_kernels/` at the
root of the checkout. Only `bindings.cpp` includes PyTorch's headers; the
`.cu` files have a plain C++ interface (`nntc_kernels.h`). No
`--use_fast_math`: the kernels must round as PyTorch's own ops do. The
build runs with `-Xptxas=-v` and its output is kept in `BUILD_LOG`
(`ptxas_summary` reads each kernel's registers, spills and shared memory
from it).

`LAUNCHES` counts, per kernel, the calls that launched it on the card (the
wrappers add one where they launch, and nowhere else), so a run can show
which kernels its path went through.
"""

import os
import sys
import threading
from typing import Dict, List

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, ".cache", "torch_kernels")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
SOURCES = ("bindings.cpp", "warp.cu", "equalize.cu", "noise.cu", "jpeg_idct.cu", "jpeg_huffman.cu", "stamp.cu",
           "heads.cu")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {
    "warp_roi_rotate": 0,
    "equalize": 0,
    "gaussian_noise": 0,
    "gaussian_noise_from_bits": 0,
    "jpeg_idct": 0,
    "jpeg_huffman": 0,
    "stamp": 0,
    "pose_heads_forward": 0,
    "pose_heads_backward": 0,
}

_ext = None
_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def extension(verbose: bool = False):
    """The compiled extension module, built on first call (once per process).
    The build's output goes to `BUILD_LOG` (the process's standard output is
    pointed there while it runs); `verbose` prints it after."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            sys.stdout.flush()
            saved = os.dup(1)
            try:
                with open(BUILD_LOG, "w") as log:
                    os.dup2(log.fileno(), 1)
                    try:
                        _ext = load(
                            name="nntc_torch_kernels",
                            sources=[os.path.join(_CSRC, s) for s in SOURCES],
                            extra_include_paths=[_CSRC],
                            extra_cflags=["-O2"],
                            extra_cuda_cflags=CUDA_FLAGS + ["-Xptxas=-v"],
                            build_directory=BUILD_DIR,
                            verbose=True,
                        )
                    finally:
                        sys.stdout.flush()
                        os.dup2(saved, 1)
            except Exception as e:  # the compiler's messages went to the log: raise them with the error
                with open(BUILD_LOG) as log:
                    raise RuntimeError(f"building the kernels failed ({type(e).__name__}: {e}); the end of "
                                       f"{BUILD_LOG}:\n{log.read()[-6000:]}") from e
            finally:
                os.close(saved)
            if verbose:
                with open(BUILD_LOG) as log:
                    print(log.read())
        return _ext


def ptxas_summary(kernels) -> List[str]:
    """For each kernel (function names) that the last build compiled, its
    registers, stack and spills and shared memory as ptxas reported them
    (`BUILD_LOG`); none where the build compiled nothing (it was up to
    date)."""
    if not os.path.exists(BUILD_LOG):
        return []
    out, entry = {}, None
    with open(BUILD_LOG) as log:
        for line in log:
            text = line.split("ptxas info    : ")[-1].strip()
            if "Compiling entry function" in text:
                entry = next((k for k in kernels if k in text), None)
            elif entry is not None and ("spill" in text or "registers" in text):
                out.setdefault(entry, []).append(text)
    return [f"{k}: " + "; ".join(out[k]) for k in kernels if k in out]


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
