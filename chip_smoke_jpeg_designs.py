"""K5's and K4's designs on phase 18's sets of 64 frames at 448^2
(`chip_smoke.py`: the first 64 of phase 12a's frames, noise, colour 4:2:0,
63 of phase 12a's frames with a noise frame), on 64 marker frames made
alone from seed 3, and what K5 takes from the training step, on the card.

K5's shipped design (`kernels/csrc/jpeg_huffman.cu`: a CTA a sequence of
32 or 128 subsequences, chained across an image's sequences) and its earlier
design (`kernels/csrc/jpeg_huffman_ctas.cu`: a CTA of 512 threads an image,
the scan staged in shared memory), K4's shipped design
(`kernels/csrc/jpeg_idct.cu`) and its earlier one on the same slots
(`kernels/csrc/jpeg_idct_tiles.cu`) are built here by `nvcc`, all at once,
into libraries with plain C entries, with the extension's flags and
`-Xptxas=-v` (each kernel's registers, spills and shared memory printed;
the shipped K5's from the extension's build log); the earlier K5 also with
`-DNNTC_K5_CLOCKS`, whose CTAs stamp `clock64()`
and the global timer at the end of each phase. Each set is first decoded as
phase 18 (a) decodes it (K5 against the host entropy decoder, K4 against
its plain version and cv2, bit for bit); the earlier K5 is held bit-equal to
the shipped one (slots up to each length, lengths, status), its phases are
timed on one launch of the diagnostics build, and both forms are timed as
`chip_smoke.py:k5_timing` times K5 (`ms`: median of 25 launches after an L2
flush; `ms_stream`: 50 launches back to back over >= 100 MB; the same
bound) in the order earlier, shipped, shipped, earlier; K4's two designs the
same way in the order shipped, earlier, earlier, shipped. Last, phase 14's
graph (the flagship step at batch 64, K = 8 a replay) is timed alone and
with one K5 launch over the 64 noise frames queued on a side stream a
replay, for each K5 form, in the order alone, earlier, shipped, shipped,
earlier, alone. Needs the card; from the repo's root:

    python3 chip_smoke_jpeg_designs.py

Prints a line a set and kernel, the card's name and power limit, and a JSON
object of the times last. Exits 1 if a check fails.
"""

import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402

DESIGNS = ("shipped", "earlier")  # K4's C entry's `design` 0 and 1
K5_PHASES = ("scan staged, tables", "guess", "passes", "(b) block scan", "(c) decode", "(d) DC scan")
STEP_REPLAYS, STEP_WARMUP = 10, 30


def nvcc(src, sources, lib, *defines):
    """Start nvcc on `sources` (in `src`) into the library `lib`."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return subprocess.Popen([cuda, *ext.CUDA_FLAGS, "-Xptxas=-v", *defines, "-shared", "-Xcompiler", "-fPIC",
                             "-I", src, *sources, "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def ptxas_lines(what, err):
    for line in err.splitlines():  # each kernel's registers, spills and shared memory
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas ({what}): " + line.split("ptxas info    : ")[-1].strip())


def build_designs(workdir):
    """K4's designs and K5's earlier design (plain and with clocks), built by
    nvcc at once into `workdir`; returns K4's entry and the earlier K5's two
    entries. The shipped K5's ptxas lines come from the extension's build
    log, its CTAs an SM from the extension."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    src = os.path.join(os.path.dirname(ext.__file__), "csrc")
    libs = {k: os.path.join(workdir, f"lib{k}.so") for k in ("k4", "k5_earlier", "k5_clocks")}
    procs = {"k4": nvcc(src, [os.path.join(src, "jpeg_idct_tiles.cu")], libs["k4"]),
             "k5_earlier": nvcc(src, [os.path.join(src, "jpeg_huffman_ctas.cu")], libs["k5_earlier"]),
             "k5_clocks": nvcc(src, [os.path.join(src, "jpeg_huffman_ctas.cu")], libs["k5_clocks"],
                               "-DNNTC_K5_CLOCKS")}
    ext.extension()  # beside the three nvcc builds
    for key, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            C.fail(f"nvcc ({key}) failed: {err[-3000:]}")
        if key != "k5_clocks":
            ptxas_lines(key, err)
    for line in ext.ptxas_summary(C.K5_KERNELS):
        print(f"ptxas (K5 shipped, the extension's build log): {line}")
    so = ctypes.CDLL(libs["k4"])
    k4 = so.jpeg_idct_design
    p = ctypes.c_void_p
    k4.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    k4.restype = ctypes.c_int
    print("K4 CTAs an SM: " + ", ".join(f"{d} design {so.jpeg_idct_design_ctas_per_sm(i)}"
                                        for i, d in enumerate(DESIGNS)))
    k5 = []
    for key in ("k5_earlier", "k5_clocks"):
        entry = ctypes.CDLL(libs[key]).jpeg_huffman_ctas_design
        entry.argtypes = [p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_long, p, p]
        entry.restype = ctypes.c_int
        k5.append(entry)
    print(f"K5 CTAs an SM: shipped design {ext.extension().jpeg_huffman_ctas_per_sm()} of 128 threads (taking "
          f"sequences by ticket); earlier design 1 (512 threads, 200 KB of shared memory, a CTA an image)")
    return k4, k5[0], k5[1]


def earlier_bits(bits_total, images):
    """The earlier design's subsequence size for a batch: about two
    subsequences a thread of its 512 at the mean scan, a power of two in
    256-1,024 bits."""
    target = max(1.0, bits_total / max(1, images) / 1024)
    return int(min(1024, max(256, 2 ** round(math.log2(target)))))


def earlier_launcher(torch, entry, payload, dev, clocks=None):
    """The earlier K5's launch on `payload` with its own outputs and
    scratch: (launch(scan, intervals, tables, meta), its outputs)."""
    _, _, _, meta, _ = payload.arrays
    blocks, ys, bits, nint = payload.counts
    N = meta.shape[0]
    S = earlier_bits(bits, N)
    subs = bits // S + nint + N
    out = dict(slots=torch.empty((blocks, 64), dtype=torch.int16, device=dev),
               lens=torch.empty(blocks, dtype=torch.uint8, device=dev),
               status=torch.empty((N, 4), dtype=torch.int32, device=dev),
               stats=torch.empty((N, 3), dtype=torch.int32, device=dev),
               scratch=torch.empty(5 * subs + nint + N + ys + 2, dtype=torch.int64, device=dev), bits=S)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(sc, iv, tb, m):
        rc = entry(sc.data_ptr(), iv.data_ptr(), tb.data_ptr(), m.data_ptr(), out["slots"].data_ptr(),
                   out["lens"].data_ptr(), out["status"].data_ptr(), out["stats"].data_ptr(),
                   out["scratch"].data_ptr(), N, S, subs, nint, 0 if clocks is None else clocks.data_ptr(), stream)
        if rc:
            C.fail(f"K5 (earlier design) launch failed: cudaError {rc}")

    return launch, out


def k5_phases(torch, clocks_entry, payload, dev, what, smi):
    """One launch of the earlier K5's diagnostics build: each phase's mean
    and largest time over the CTAs (the global timer, microseconds) and its
    mean cycles (clock64)."""
    N = payload.meta.shape[0]
    clocks = torch.zeros((N, 8, 2), dtype=torch.int64, device=dev)
    launch, _ = earlier_launcher(torch, clocks_entry, payload, dev, clocks)
    launch(*payload.arrays[:4])
    torch.cuda.synchronize()
    c = clocks[:, :7].cpu().double()
    cycles, ns = (c[:, 1:, 0] - c[:, :-1, 0]), (c[:, 1:, 1] - c[:, :-1, 1])
    total = (c[:, -1, 1] - c[:, 0, 1]) / 1e3
    parts = [f"{name} {float(ns[:, i].mean()) / 1e3:.1f} us mean ({float(ns[:, i].max()) / 1e3:.1f} max, "
             f"{float(cycles[:, i].mean()):.0f} cycles)" for i, name in enumerate(K5_PHASES)]
    print(f"K5 earlier design by phase on {what} (a CTA an image, {N} CTAs): {'; '.join(parts)}; a CTA "
          f"{float(total.mean()):.1f} us mean, {float(total.max()):.1f} max on {smi}", flush=True)
    return dict(mean_us=[float(ns[:, i].mean()) / 1e3 for i in range(len(K5_PHASES))],
                max_us=[float(ns[:, i].max()) / 1e3 for i in range(len(K5_PHASES))],
                mean_cycles=[float(cycles[:, i].mean()) for i in range(len(K5_PHASES))],
                cta_us_mean=float(total.mean()), cta_us_max=float(total.max()))


def step_cost(torch, np, dev, k5_launches, smi):
    """Phase 14's K = 8 graph at batch 64: ms a step alone and with one K5
    launch (each of `k5_launches`: name -> launch()) queued on a side stream
    a replay, in turns, after STEP_WARMUP replays (the first replays run
    several times slower)."""
    torch.backends.cudnn.allow_tf32 = True  # as in phase 14
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, state, W = C.flagship_trainer(torch, dev)
    _, groups = C.flagship_batches(torch, np, dev, C.B, 2 * C.MS_K, C.MS_K)
    gen = torch.Generator().manual_seed(5)
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    for i in range(STEP_WARMUP):  # the capture, then replays with each K5 beside them until the times settle
        with torch.cuda.stream(side):
            k5_launches["earlier" if i % 2 else "shipped"]()
        trainer.train_step_multi(state, groups[i % len(groups)], W, generator=gen)
    torch.cuda.synchronize()
    order = ["alone", "earlier", "shipped", "shipped", "earlier", "alone"]
    rows = []
    for kind in order:
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        side.wait_stream(main)
        for i in range(STEP_REPLAYS):
            if kind != "alone":
                with torch.cuda.stream(side):
                    k5_launches[kind]()
            trainer.train_step_multi(state, groups[i % len(groups)], W, generator=gen)
        main.wait_stream(side)
        b.record()
        b.synchronize()
        rows.append((kind, a.elapsed_time(b) / (STEP_REPLAYS * C.MS_K)))
    print("step cost: phase 14's graph at batch 64, K = 8, ms a step " + ", ".join(f"{k} {v:.4f}" for k, v in rows)
          + f" ({STEP_REPLAYS} replays each; a K5 launch over {C.B} noise frames on a side stream a replay, "
          f"CUDA events) on {smi}", flush=True)
    return rows


def main() -> int:
    import cv2
    import numpy as np
    import torch

    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames

    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is False: this script runs on an NVIDIA GPU")
    smi = C.card_line()
    print(smi)
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}: {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="jpeg_designs_")
    try:
        k4_entry, k5_earlier, k5_clocks = build_designs(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)  # the libraries stay loaded
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    pad = C.LOADER_SRC
    flat = C.phase12a_buffers(torch, np, dev)
    seeded = C.jpeg_frames(torch, np, C.B, 3, dev)
    noise = [b for b in (jpeg_frames(C.B, pad, C.JPEG_SEED, dev, "noise").buffer(i) for i in range(C.B))]
    sets = [("flat", f"{C.B} of phase 12a's frames (the first {C.B} of its {C.RUN_TRAIN})", flat),
            ("flat_seed3", f"{C.B} marker frames made alone from seed 3 (not phase 12a's: the labels depend on the "
             f"count)", [seeded.buffer(i) for i in range(C.B)]),
            ("dense", f"{C.B} noise frames", noise),
            ("colour", f"{C.B} colour 4:2:0 q95 frames", C.colour_frames(np, C.B, C.JPEG_SEED + 1)),
            ("mixed", f"{C.B - 1} of phase 12a's frames and a noise frame", flat[:C.B - 1] + noise[:1])]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    report, noise_payload = {}, None
    for key, what, bufs in sets:
        r = C.decode_against_plain_and_cv2(torch, np, cv2, bufs, pad, dev, what, plain_k5=False)
        payload = r["payload"]
        if key == "dense":
            noise_payload = payload
        # the earlier K5 bit-equal to the shipped one
        launch, out = earlier_launcher(torch, k5_earlier, payload, dev)
        launch(*payload.arrays[:4])
        torch.cuda.synchronize()
        within = torch.arange(64, device=dev) < out["lens"][:, None].long()
        C.check(torch.equal(out["lens"], r["lens"]) and torch.equal(torch.where(within, out["slots"], 0),
                                                                    torch.where(within, r["slots"], 0))
                and not bool(out["status"].any()), f"K5's earlier design differs from the shipped one on {what}")
        earlier_passes = out["stats"][:, 0].long().cpu()
        row = dict(phases=k5_phases(torch, k5_clocks, payload, dev, what, smi), layout=C.layout_text(r),
                   earlier_bits=out["bits"], passes_median=int(r["stats"][:, 0].median()),
                   passes_max=int(r["stats"][:, 0].max()), earlier_passes_median=int(earlier_passes.median()),
                   earlier_passes_max=int(earlier_passes.max()))
        for design in ("earlier", "shipped", "shipped", "earlier"):
            t5 = C.k5_timing(torch, r, dev, launch if design == "earlier" else None)
            row.setdefault(f"k5_{design}_ms", []).append(t5["ms"])
            row.setdefault(f"k5_{design}_ms_stream", []).append(t5["ms_stream"])
            row.update(k5_bound_ms=t5["bound"][0], grid=t5["grid"], sequences=t5["sequences"],
                       ctas_per_sm=t5["ctas_per_sm"])
            if design == "shipped":
                print(C.k5_line(t5, r, what, smi), flush=True)
            else:
                print(f"K5 (earlier design) on {what}: {t5['ms']:.4f} ms ({t5['ms_stream']:.4f} ms_stream), bound "
                      f"{t5['bound'][0]:.4f} ms; {C.B} CTAs of 512 threads, subsequences of {out['bits']} bits, passes "
                      f"median {row['earlier_passes_median']}, max {row['earlier_passes_max']} on {smi}", flush=True)
        row["k5_ratio_ms_stream"] = statistics.mean(row["k5_shipped_ms_stream"]) / statistics.mean(
            row["k5_earlier_ms_stream"])
        print(f"K5 shipped / earlier design on {what}: ms_stream {row['k5_ratio_ms_stream']:.3f} (means of two "
              f"each, in turns) on {smi}", flush=True)
        _, _, _, meta, qtables = payload.arrays
        want = payload.decode()
        out4 = torch.empty_like(want)
        nbytes, ops, blocks, full = C.k4_work(K4, r["slots"], r["lens"], out4)
        nbytes += qtables.numel() * qtables.element_size() + meta.shape[0] * 4 * 4
        bound = C.bound_ms(nbytes, i32_ops=ops)
        row["k4_bound_ms"] = bound[0]
        for design in (0, 1, 1, 0):

            def launch4(s, ln, q, m, design=design):
                rc = k4_entry(design, s.data_ptr(), ln.data_ptr(), q.data_ptr(), m.data_ptr(), out4.data_ptr(),
                              s.shape[0], m.shape[1], m.shape[0], pad, stream)
                if rc:
                    C.fail(f"K4 ({DESIGNS[design]} design) launch failed: cudaError {rc}")

            out4.fill_(7)
            launch4(r["slots"], r["lens"], qtables, meta)
            torch.cuda.synchronize()
            C.check(torch.equal(out4, want), f"K4's {DESIGNS[design]} design differs from the shipped K4 on {what}")
            args = (r["slots"], r["lens"], qtables, meta)
            ms = C.time_ms(torch, lambda: launch4(*args), flush)
            ms_stream = C.stream_ms(torch, launch4, C.rotating(torch, *args))
            row.setdefault(f"k4_{DESIGNS[design]}_ms", []).append(ms)
            row.setdefault(f"k4_{DESIGNS[design]}_ms_stream", []).append(ms_stream)
            print(f"K4 ({DESIGNS[design]} design) on {what}: {ms:.4f} ms ({ms_stream:.4f} ms_stream) a batch of "
                  f"{C.B}, bound {bound[0]:.4f} ms ({bound[1]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.4f} G integer "
                  f"operations, {full} of {blocks} blocks with terms past their first row) on {smi}", flush=True)
        report[key] = row
        del r, want, out4
    # what one K5 launch a replay takes from the graph's step (the noise batch, each form's own buffers)
    from neuralnet_tracker_traincode_torch.kernels import jpeg_huffman as K5

    arrays = noise_payload.arrays[:4]
    blocks, ys, bits, nint = noise_payload.counts
    earlier, _ = earlier_launcher(torch, k5_earlier, noise_payload, dev)
    steps = step_cost(torch, np, dev, {
        "earlier": lambda: earlier(*arrays),
        "shipped": lambda: K5.huffman_decode(*arrays, blocks, ys, nint, bits)}, smi)
    report["step_ms"] = steps
    report["step_ms_alone_mean"] = statistics.mean(v for k, v in steps if k == "alone")
    print(smi)
    print(json.dumps({"card": smi, "sets": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
