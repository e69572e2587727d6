"""Phase 15 of `chip_smoke.py` (data-parallel training) with faults planted
in memory, one after another, its checks recorded instead of failing: the
readings of the sound run and of each fault, between which `chip_smoke.py`'s
`DP_*` limits are fixed; and phase 18 (a) (K4 against its plain version and
cv2, bit for bit) with faults planted in K4's arithmetic. Needs the card;
from the repo's root:

    python3 chip_smoke_faults.py none bn_xmu_dropped bn_dx_sign bn_count_doubled bn_unsynced grads_summed
    python3 chip_smoke_faults.py k4_none k4_range_wrap k4_descale_round

The faults: `bn_xmu_dropped`, `bn_dx_sign` and `bn_count_doubled` patch
`torch.batch_norm_backward_elemt` (the synchronized BatchNorm's input
gradient on the card: the `sum(dy * x_hat)` term dropped, the sign flipped,
the count doubled); `bn_unsynced` normalises each rank by its own rows;
`grads_summed` sums the gradients over the ranks instead of averaging them.
The spawned ranks of part (b) plant the same fault. Nothing of the repo
changes.

The K4 faults are copies of `kernels/csrc/jpeg_idct.cu` patched in a
temporary directory and built there by `nvcc` with a plain C entry
(`k4_none` unpatched, through the same route): `k4_range_wrap` limits the
row pass's value as jidctint.c's table does, read as a signed 10-bit number
(`& RANGE_MASK`), in place of the saturation that libjpeg-turbo's SIMD code
(and cv2) apply; `k4_descale_round` rounds the row pass's DESCALE with
2^17 - 1 in place of 2^17. While one is planted, `kernels/ext.extension()`
gives that build's K4; phase 18 (a) then runs on 64 of phase 12a's frames
(rendered here), its 64 noise frames and its seeded set.

Exits 1 unless each sound run (`none`, `k4_none`) passes every check and
every other fault but `grads_summed` fails one: Adam and the global-norm
clip divide the gradient's scale out, so summing instead of averaging
changes no result while the clip binds, as it does at the flagship's first
steps.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402

RECORDED = []
INVISIBLE = {"grads_summed"}
SOUND = {"none", "k4_none"}
# (the sound source's text, the fault's) in kernels/csrc/jpeg_idct.cu
K4_FAULTS = {
    "k4_none": None,
    "k4_range_wrap": ("max(-128, min(127, o[k])) + 128", "max(-128, min(127, ((o[k] & 1023) ^ 512) - 512)) + 128"),
    "k4_descale_round": ("constexpr int half = 1 << (shift - 1);",
                         "constexpr int half = (1 << (shift - 1)) - (shift == CONST_BITS + PASS1_BITS + 3 ? 1 : 0);"),
}
_K4_SHIM = """
#include "nntc_kernels.h"
extern "C" int k4(const int16_t* c, const int32_t* bs, const int32_t* q, const int32_t* m, uint8_t* o, long nc,
                  long nb, int n, int pad, cudaStream_t s) {
    return static_cast<int>(nntc_jpeg_idct_pack(c, bs, q, m, o, nc, nb, n, pad, s));
}
"""


def record_check(cond, msg):
    """`chip_smoke.check`, recording a failure instead of exiting."""
    if not cond:
        RECORDED.append(msg)
        print("CHECK WOULD FAIL: " + msg[:700], flush=True)


def plant(fault):
    """Plant `fault`; returns a function that removes it."""
    import torch

    from neuralnet_tracker_traincode_torch.models.backbones import common
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer

    C.check = record_check
    if fault == "none":
        return lambda: None
    if fault.startswith("bn_"):
        if fault == "bn_unsynced":  # each rank normalises by its own rows
            forward = common.BatchNorm2d.forward

            def unsynced(self, x):
                sync, self.sync = self.sync, None
                try:
                    return forward(self, x)
                finally:
                    self.sync = sync

            common.BatchNorm2d.forward = unsynced
            return lambda: setattr(common.BatchNorm2d, "forward", forward)
        orig = torch.batch_norm_backward_elemt

        def fake(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count):
            if fault == "bn_xmu_dropped":
                return orig(dy, x, mean, invstd, weight, sum_dy, torch.zeros_like(sum_dy_xmu), count)
            if fault == "bn_dx_sign":
                return -orig(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count)
            if fault == "bn_count_doubled":
                return orig(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count * 2)
            raise ValueError(fault)

        torch.batch_norm_backward_elemt = fake
        return lambda: setattr(torch, "batch_norm_backward_elemt", orig)
    if fault == "grads_summed":  # the gradients summed over the ranks, not averaged
        mean = PoseTrainer._mean_over_ranks

        def summed(self, grads):
            return {k: v * self.parallel.ranks for k, v in mean(self, grads).items()}

        PoseTrainer._mean_over_ranks = summed
        return lambda: setattr(PoseTrainer, "_mean_over_ranks", mean)
    raise ValueError(fault)


class _FaultedK4:
    """`kernels/ext.extension()` with K4 from `k4` (the C entry of an nvcc build)."""

    def __init__(self, real, k4):
        self.real, self.k4 = real, k4

    def __getattr__(self, name):
        return getattr(self.real, name)

    def jpeg_idct_pack(self, coeffs, block_start, qtables, meta, out, pad):
        import torch

        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        rc = self.k4(coeffs.data_ptr(), block_start.data_ptr(), qtables.data_ptr(), meta.data_ptr(), out.data_ptr(),
                     coeffs.shape[0], block_start.shape[0] - 1, meta.shape[0], int(pad), stream)
        if rc != 0:
            raise RuntimeError(f"K4 launch failed: cudaError {rc}")


def build_k4(fault, workdir):
    """`jpeg_idct.cu` with `fault` patched in, built by nvcc into `workdir`."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    src = os.path.join(os.path.dirname(ext.__file__), "csrc")
    for name in ("jpeg_idct.cu", "nntc_kernels.h"):
        shutil.copy(os.path.join(src, name), workdir)
    cu = os.path.join(workdir, "jpeg_idct.cu")
    text = open(cu).read()
    if K4_FAULTS[fault] is not None:
        old, new = K4_FAULTS[fault]
        assert text.count(old) == 1, f"{fault}: the sound text is not in jpeg_idct.cu once"
        text = text.replace(old, new)
    with open(cu, "w") as f:
        f.write(text)
    with open(os.path.join(workdir, "shim.cu"), "w") as f:
        f.write(_K4_SHIM)
    lib = os.path.join(workdir, "libk4.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, *ext.CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-I", workdir, cu,
           os.path.join(workdir, "shim.cu"), "-o", lib]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    k4 = ctypes.CDLL(lib).k4
    p = ctypes.c_void_p
    k4.argtypes = [p, p, p, p, p, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int, p]
    k4.restype = ctypes.c_int
    return k4


def k4_faults(faults, smi):
    """Phase 18 (a) once per K4 fault; {fault: checks failed}."""
    import cv2
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames

    dev = torch.device("cuda")
    C.check = record_check
    frames = C.jpeg_frames(torch, np, C.B, 3, dev)
    buffers = [frames.buffer(i) for i in range(len(frames))]
    noise = jpeg_frames(C.B, C.LOADER_SRC, C.JPEG_SEED, dev, "noise")
    dense = [noise.buffer(i) for i in range(len(noise))]
    cases = [b for _, b in C.jpeg_cases(np, cv2)]
    real = ext.extension()
    failed = {}
    for fault in faults:
        print(f"===== fault {fault}", flush=True)
        RECORDED.clear()
        workdir = tempfile.mkdtemp(prefix=f"k4_{fault}_")
        t0 = time.time()
        try:
            ext._ext = _FaultedK4(real, build_k4(fault, workdir))
            print(f"fault {fault}: built in {time.time() - t0:.1f} s", flush=True)
            C.k4_against_cv2_and_plain(torch, np, cv2, buffers, C.LOADER_SRC, dev, f"{C.B} of phase 12a's frames")
            C.k4_against_cv2_and_plain(torch, np, cv2, dense, C.LOADER_SRC, dev, f"{C.B} noise frames")
            C.k4_against_cv2_and_plain(torch, np, cv2, cases, 320, dev, "the seeded set")
        except Exception as e:  # a fault may break the launch itself: that counts as caught
            RECORDED.append(f"raised {type(e).__name__}: {e}")
            print(f"fault {fault}: raised {type(e).__name__}: {e}", flush=True)
        finally:
            ext._ext = real
            shutil.rmtree(workdir, ignore_errors=True)
        print(f"===== fault {fault}: {len(RECORDED)} checks would fail; {time.time() - t0:.1f} s on {smi}", flush=True)
        failed[fault] = len(RECORDED)
    return failed


def rank_main(rank, port, workdir):
    """A rank of phase 15 (b) with the fault named in `DP_FAULT` planted."""
    plant(os.environ["DP_FAULT"])
    C.dp_rank_main(rank, port, workdir)


def main() -> int:
    """Phase 14a's reference (its batches, eager and graph metrics), then
    phase 15 once per fault named on the command line."""
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext

    smi = C.card_line()
    print(smi)
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())
    t0 = time.time()
    ext.extension()
    print("built", time.time() - t0)
    failed = k4_faults([f for f in sys.argv[1:] if f in K4_FAULTS], smi)
    dp = [f for f in sys.argv[1:] if f not in K4_FAULTS]
    if not dp:
        print(smi)
        print(json.dumps({"checks_failed": failed}))
        return int(any((n > 0) if f in INVISIBLE | SOUND else (n == 0) for f, n in failed.items()))
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, state, W = C.flagship_trainer(torch, dev)
    singles, groups = C.flagship_batches(torch, np, dev, C.B, 2 * C.MS_K, C.MS_K)
    saved = C.state_snapshot(trainer, state)
    trainer.train_step(state, singles[0], W, generator=torch.Generator().manual_seed(1))
    C.state_restore(torch, trainer, state, saved)
    floor, diff, _, graph_ms, launches, eager_metrics, graph_metrics = C.against_eager(
        torch, trainer, state, singles, groups, W, "flagship, K=8")
    print(f"phase 14a's reference: eager floor {floor}, graph {diff}, {graph_ms:.3f} ms a step, launches {launches}")
    flagship = dict(eager_metrics=eager_metrics, graph_metrics=graph_metrics, graph_ms=graph_ms)
    del trainer, state
    C.dp_rank_main = rank_main
    for fault in dp:
        print(f"===== fault {fault}", flush=True)
        os.environ["DP_FAULT"] = fault
        RECORDED.clear()
        undo = plant(fault)
        t0 = time.time()
        try:
            C.data_parallel_phase(torch, np, dev, smi, flagship, {C.B: [("graph", graph_ms)]})
        except Exception as e:  # a fault may break the run itself: that counts as caught
            RECORDED.append(f"raised {type(e).__name__}: {e}")
            print(f"fault {fault}: the phase raised {type(e).__name__}: {e}", flush=True)
        finally:
            undo()
        print(f"===== fault {fault}: {len(RECORDED)} checks would fail; {time.time() - t0:.1f} s", flush=True)
        failed[fault] = len(RECORDED)
    print(smi)
    print(json.dumps({"checks_failed": failed}))
    return int(any((n > 0) if f in INVISIBLE | SOUND else (n == 0) for f, n in failed.items()))


if __name__ == "__main__":
    sys.exit(main())
