"""Phase 15 of `chip_smoke.py` (data-parallel training) with faults planted
in memory, one after another, its checks recorded instead of failing: the
readings of the sound run and of each fault, between which `chip_smoke.py`'s
`DP_*` limits are fixed; and phase 18 (a) (K5 against the host decoder and
its plain version; K4 against its plain version and cv2; bit for bit; the corrupt files against the host
decoder's messages and K5's plain version's status) with faults planted in
K4's arithmetic and in K5's algorithm. Needs the card;
from the repo's root:

    python3 chip_smoke_faults.py none bn_xmu_dropped bn_dx_sign bn_count_doubled bn_unsynced grads_summed
    python3 chip_smoke_faults.py k4_none k4_range_wrap k4_descale_round k5_none k5_dc_no_reset k5_sync_bits_only \
        k5_unwaited_flag k5_fault_per_cta k5_batch_layout

The faults: `bn_xmu_dropped`, `bn_dx_sign` and `bn_count_doubled` patch
`torch.batch_norm_backward_elemt` (the synchronized BatchNorm's input
gradient on the card: the `sum(dy * x_hat)` term dropped, the sign flipped,
the count doubled); `bn_unsynced` normalises each rank by its own rows;
`grads_summed` sums the gradients over the ranks instead of averaging them.
The spawned ranks of part (b) plant the same fault. Nothing of the repo
changes.

The JPEG faults are copies of `kernels/csrc/jpeg_idct.cu` (K4) or
`jpeg_huffman.cu` (K5) patched in a temporary directory and built there by
`nvcc` with a plain C entry (`k4_none`, `k5_none` unpatched, through the
same route): `k5_dc_no_reset` runs the DC scan along the whole image
instead of restarting it at each restart marker; `k5_sync_bits_only`
ends a sequence's passes when its exits' bit offsets stop changing,
whatever their block and zigzag index; `k5_unwaited_flag` reads the
predecessor sequence's exit without waiting for its flag;
`k5_batch_layout` lays every image out as the batch's mean image (the
mixed batch's noise frame then takes the flat frames' short sequences);
`k5_fault_per_cta` keeps the first fault per CTA, the image's word taking
the last CTA's instead of the least; `k4_range_wrap` limits the
row pass's value as jidctint.c's table does, read as a signed 10-bit number
(`& RANGE_MASK`), in place of the saturation that libjpeg-turbo's SIMD code
(and cv2) apply; `k4_descale_round` rounds the row pass's DESCALE with
2^17 - 1 in place of 2^17. While one is planted, `kernels/ext.extension()`
gives that build's kernel; phase 18 (a) then runs on 64 of phase 12a's
frames (rendered here), its 64 noise frames, its 64 colour 4:2:0 frames,
its mixed batch (63 of the first with one of the second), its seeded set
and its corrupt files.

Exits 1 unless each sound run (`none`, `k4_none`, `k5_none`) passes every check and
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
SOUND = {"none", "k4_none", "k5_none"}
# (the source, the sound text, the fault's) in kernels/csrc/
JPEG_FAULTS = {
    "k4_none": ("jpeg_idct.cu", None, None),
    "k4_range_wrap": ("jpeg_idct.cu", "max(-128, min(127, o[k])) + 128",
                      "max(-128, min(127, ((o[k] & 1023) ^ 512) - 512)) + 128"),
    "k4_descale_round": ("jpeg_idct.cu", "constexpr int half = 1 << (shift - 1);",
                         "constexpr int half = (1 << (shift - 1)) - (shift == CONST_BITS + PASS1_BITS + 3 ? 1 : 0);"),
    "k5_none": ("jpeg_huffman.cu", None, None),
    # the DC predictor not reset at a restart marker: one scan along the whole image
    "k5_dc_no_reset": ("jpeg_huffman.cu", "const long head = rst ? (mcu / rst) * rst * (yh * yv) : 0;",
                       "const long head = 0;"),
    # a sequence's passes end when its exits' bit offsets stop changing, whatever their block and zigzag index
    "k5_sync_bits_only": ("jpeg_huffman.cu", "changed = y != ex;", "changed = (y >> 16) != (ex >> 16);"),
    # a CTA reads its predecessor's exit without waiting for the flag that publishes it
    "k5_unwaited_flag": ("jpeg_huffman.cu", "while (flag_of(chain, s) < level) __nanosleep(100);",
                         "(void)flag_of(chain, s);"),
    # every image laid out as the batch's mean image, whatever its own scan (the plain version lays out each its own)
    "k5_batch_layout": ("jpeg_huffman.cu",
                        "if (k >= -1 ? (bits_total << (k + 1)) <= num : bits_total <= (num << (-(k + 1)))) e = k;",
                        "if (k <= 0) e = k;"),
    # the first fault kept per CTA: the image's word takes the last CTA's, not the least
    "k5_fault_per_cta": ("jpeg_huffman.cu", "if (sh.fault != kNoFault) atomicMin(sc.fault + n, sh.fault);",
                         "if (sh.fault != kNoFault) atomicExch(sc.fault + n, sh.fault);"),
}
_SHIMS = {
    "jpeg_idct.cu": """
#include "nntc_kernels.h"
extern "C" int kernel(const int16_t* s, const uint8_t* l, const int32_t* q, const int32_t* m, uint8_t* o, long nb,
                      int mc, int n, int pad, cudaStream_t st) {
    return static_cast<int>(nntc_jpeg_idct_pack(s, l, q, m, o, nb, mc, n, pad, st));
}
""",
    "jpeg_huffman.cu": """
#include "nntc_kernels.h"
extern "C" int kernel(const uint8_t* sc, const int32_t* iv, const int32_t* tb, const int32_t* m, int16_t* s,
                      uint8_t* l, int32_t* status, int32_t* stats, long long* scratch, int n, int nt, int seq,
                      int bits, long bits_total, long subs, long nint, cudaStream_t st) {
    return static_cast<int>(nntc_jpeg_huffman_decode(sc, iv, tb, m, s, l, status, stats, scratch, n, nt, seq, bits,
                                                     bits_total, subs, nint, st));
}
""",
}


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


class _Faulted:
    """`kernels/ext.extension()` with K4 or K5 from `kernel` (the C entry of
    an nvcc build of `source`)."""

    def __init__(self, real, source, kernel):
        self.real, self.source, self.kernel = real, source, kernel

    def __getattr__(self, name):
        return getattr(self.real, name)

    def _run(self, *args):
        rc = self.kernel(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source} launch failed: cudaError {rc}")

    def jpeg_idct_pack(self, slots, lens, qtables, meta, out, pad):
        import torch

        if self.source != "jpeg_idct.cu":
            return self.real.jpeg_idct_pack(slots, lens, qtables, meta, out, pad)
        stream = torch.cuda.current_stream(slots.device).cuda_stream
        self._run(slots.data_ptr(), lens.data_ptr(), qtables.data_ptr(), meta.data_ptr(), out.data_ptr(),
                  slots.shape[0], meta.shape[1], meta.shape[0], int(pad), stream)

    def jpeg_huffman_decode(self, scan, intervals, tables, meta, slots, lens, status, stats, scratch, seq, bits,
                            bits_total, subs, nint):
        import torch

        if self.source != "jpeg_huffman.cu":
            return self.real.jpeg_huffman_decode(scan, intervals, tables, meta, slots, lens, status, stats, scratch,
                                                 seq, bits, bits_total, subs, nint)
        stream = torch.cuda.current_stream(scan.device).cuda_stream
        self._run(scan.data_ptr(), intervals.data_ptr(), tables.data_ptr(), meta.data_ptr(), slots.data_ptr(),
                  lens.data_ptr(), status.data_ptr(), stats.data_ptr(), scratch.data_ptr(), meta.shape[0],
                  tables.shape[0], int(seq), int(bits), int(bits_total), int(subs), int(nint), stream)


def build_fault(fault, workdir):
    """The fault's source with the fault patched in, built by nvcc with a
    plain C entry into `workdir`; returns (source, the entry)."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    source, old, new = JPEG_FAULTS[fault]
    src = os.path.join(os.path.dirname(ext.__file__), "csrc")
    for name in (source, "nntc_kernels.h"):
        shutil.copy(os.path.join(src, name), workdir)
    cu = os.path.join(workdir, source)
    text = open(cu).read()
    if old is not None:
        assert text.count(old) == 1, f"{fault}: the sound text is not in {source} once"
        text = text.replace(old, new)
    with open(cu, "w") as f:
        f.write(text)
    with open(os.path.join(workdir, "shim.cu"), "w") as f:
        f.write(_SHIMS[source])
    lib = os.path.join(workdir, "libfault.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, *ext.CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-I", workdir, cu,
           os.path.join(workdir, "shim.cu"), "-o", lib]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    kernel = ctypes.CDLL(lib).kernel
    p = ctypes.c_void_p
    if source == "jpeg_idct.cu":
        kernel.argtypes = [p, p, p, p, p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    else:
        kernel.argtypes = [p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_long] * 3 + [p]
    kernel.restype = ctypes.c_int
    return source, kernel


def jpeg_faults(faults, smi):
    """Phase 18 (a) once per K4 or K5 fault; {fault: checks failed}."""
    import cv2
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames

    dev = torch.device("cuda")
    C.check = record_check
    buffers = C.phase12a_buffers(torch, np, dev)
    noise = jpeg_frames(C.B, C.LOADER_SRC, C.JPEG_SEED, dev, "noise")
    dense = [noise.buffer(i) for i in range(len(noise))]
    colour = C.colour_frames(np, C.B, C.JPEG_SEED + 1)
    seeded = C.jpeg_cases(np, cv2)
    cases = [b for _, b in seeded]
    real = ext.extension()
    failed = {}
    for fault in faults:
        print(f"===== fault {fault}", flush=True)
        RECORDED.clear()
        workdir = tempfile.mkdtemp(prefix=f"{fault}_")
        t0 = time.time()
        try:
            ext._ext = _Faulted(real, *build_fault(fault, workdir))
            print(f"fault {fault}: built in {time.time() - t0:.1f} s", flush=True)
            for bufs, pad, what in ((buffers, C.LOADER_SRC, f"{C.B} of phase 12a's frames"),
                                    (dense, C.LOADER_SRC, f"{C.B} noise frames"),
                                    (colour, C.LOADER_SRC, f"{C.B} colour 4:2:0 frames"),
                                    (buffers[:C.B - 1] + dense[:1], C.LOADER_SRC,
                                     f"{C.B - 1} of phase 12a's frames and a noise frame"),
                                    (cases, 320, "the seeded set")):
                try:
                    C.decode_against_plain_and_cv2(torch, np, cv2, bufs, pad, dev, what,
                                                   bits=C.CHECK_BITS if bufs is cases else None)
                except Exception as e:  # a fault may make the decode raise: that counts as caught
                    RECORDED.append(f"raised {type(e).__name__} on {what}: {e}")
                    print(f"fault {fault}: raised {type(e).__name__} on {what}: {str(e)[:300]}", flush=True)
            try:
                C.corrupt_against_host(torch, seeded, dev)
            except Exception as e:
                RECORDED.append(f"raised {type(e).__name__} on the corrupt files: {e}")
                print(f"fault {fault}: raised {type(e).__name__} on the corrupt files: {str(e)[:300]}", flush=True)
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
    failed = jpeg_faults([f for f in sys.argv[1:] if f in JPEG_FAULTS], smi)
    dp = [f for f in sys.argv[1:] if f not in JPEG_FAULTS]
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
