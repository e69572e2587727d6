"""K4's two designs and K5 on phase 18's three sets of 64 frames at 448^2
(`chip_smoke.py`), on the card.

K4's shipped design (`kernels/csrc/jpeg_idct.cu`: persistent CTAs walking
8-row strips, the slots staged by `cp.async`, 16-byte row stores) and its
earlier design on the same slots (`kernels/csrc/jpeg_idct_tiles.cu`: a CTA
a 32-tile run, each thread loading its chunk straight from global memory)
are built here by `nvcc` into one library with a plain C entry, with the
extension's flags. Each set is first decoded as phase 18 (a) decodes it (K5
against the host entropy decoder, K4 against its plain version and cv2, bit
for bit); each design is then held bit-equal to the shipped K4's output and
timed as `chip_smoke.py` times K4 (`ms`: median of 25 launches after an L2
flush; `ms_stream`: 50 launches back to back over >= 100 MB), in the order
shipped, earlier, earlier, shipped; K5 is timed through the extension as
phase 18 times it. Needs the card; from the repo's root:

    python3 chip_smoke_jpeg_designs.py

Prints a line a set and kernel, the card's name and power limit, and a JSON
object of the times last. Exits 1 if a check fails.
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

DESIGNS = ("shipped", "earlier")  # the C entry's `design` 0 and 1


def build_designs(workdir):
    """`jpeg_idct_tiles.cu` (which includes `jpeg_idct.cu`) built by nvcc
    into `workdir`; returns its C entry."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    src = os.path.join(os.path.dirname(ext.__file__), "csrc")
    lib = os.path.join(workdir, "libk4designs.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    r = subprocess.run([nvcc, *ext.CUDA_FLAGS, "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", src,
                        os.path.join(src, "jpeg_idct_tiles.cu"), "-o", lib], check=True, capture_output=True,
                       text=True, timeout=300)
    for line in r.stderr.splitlines():  # each kernel's registers, spills and shared memory
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas: " + line.split("ptxas info    : ")[-1])
    so = ctypes.CDLL(lib)
    entry = so.jpeg_idct_design
    p = ctypes.c_void_p
    entry.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    entry.restype = ctypes.c_int
    print("CTAs an SM: " + ", ".join(f"{d} design {so.jpeg_idct_design_ctas_per_sm(i)}" for i, d in enumerate(DESIGNS)))
    return entry


def main() -> int:
    import cv2
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
    from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as K5
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames

    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is False: this script runs on an NVIDIA GPU")
    smi = C.card_line()
    print(smi)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ext.extension()
    workdir = tempfile.mkdtemp(prefix="k4_designs_")
    try:
        entry = build_designs(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)  # the library stays loaded
    print(f"built in {time.perf_counter() - t0:.1f} s")
    pad = C.LOADER_SRC
    flat = C.jpeg_frames(torch, np, C.B, 3, dev)
    noise = jpeg_frames(C.B, pad, C.JPEG_SEED, dev, "noise")
    sets = [("flat", f"{C.B} of phase 12a's frames", [flat.buffer(i) for i in range(C.B)]),
            ("dense", f"{C.B} noise frames", [noise.buffer(i) for i in range(C.B)]),
            ("colour", f"{C.B} colour 4:2:0 q95 frames", C.colour_frames(np, C.B, C.JPEG_SEED + 1))]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    report = {}
    for key, what, bufs in sets:
        r = C.decode_against_plain_and_cv2(torch, np, cv2, bufs, pad, dev, what, plain_k5=False)
        r["bits"] = K5.auto_subsequence_bits(r["payload"].counts[2], len(bufs))
        t5 = C.k5_timing(torch, r, dev)
        print(C.k5_line(t5, r, what, smi))
        _, _, _, meta, qtables = r["payload"].arrays
        want = r["payload"].decode()
        out = torch.empty_like(want)
        nbytes, ops, blocks, full = C.k4_work(K4, r["slots"], r["lens"], out)
        nbytes += qtables.numel() * qtables.element_size() + meta.shape[0] * 4 * 4
        bound = C.bound_ms(nbytes, i32_ops=ops)
        row = dict(k5_ms=t5["ms"], k5_ms_stream=t5["ms_stream"], k5_bound_ms=t5["bound"][0], k4_bound_ms=bound[0])
        for design in (0, 1, 1, 0):

            def launch(s, ln, q, m, design=design):
                rc = entry(design, s.data_ptr(), ln.data_ptr(), q.data_ptr(), m.data_ptr(), out.data_ptr(),
                           s.shape[0], m.shape[1], m.shape[0], pad, stream)
                if rc:
                    C.fail(f"K4 ({DESIGNS[design]} design) launch failed: cudaError {rc}")

            out.fill_(7)
            launch(r["slots"], r["lens"], qtables, meta)
            torch.cuda.synchronize()
            C.check(torch.equal(out, want), f"K4's {DESIGNS[design]} design differs from the shipped K4 on {what}")
            args = (r["slots"], r["lens"], qtables, meta)
            ms = C.time_ms(torch, lambda: launch(*args), flush)
            ms_stream = C.stream_ms(torch, launch, C.rotating(torch, *args))
            row.setdefault(f"k4_{DESIGNS[design]}_ms", []).append(ms)
            row.setdefault(f"k4_{DESIGNS[design]}_ms_stream", []).append(ms_stream)
            print(f"K4 ({DESIGNS[design]} design) on {what}: {ms:.4f} ms ({ms_stream:.4f} ms_stream) a batch of "
                  f"{C.B}, bound {bound[0]:.4f} ms ({bound[1]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.4f} G integer "
                  f"operations, {full} of {blocks} blocks with terms past their first row) on {smi}", flush=True)
        report[key] = row
        del r, want, out
    print(smi)
    print(json.dumps({"card": smi, "sets": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
