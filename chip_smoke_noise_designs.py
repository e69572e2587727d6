"""K3b (`kernels/csrc/noise.cu:nntc_gaussian_noise_from_bits`, the gaussian
noise from injected bits) beside its first, scalar form (a thread a pixel,
every sample's bits read), at the pose step's shape (64 x 129^2) on the card.

The shipped `noise.cu` and the first form, from the `noise.cu` of an earlier
checkout (`--parent DIR`, default `.cache/parent`, e.g. `git archive` of the
parent commit unpacked there), are built by `nvcc` at once, each as one
library with a plain C entry (a small file that includes the `noise.cu`),
with the extension's flags and `-Xptxas=-v`; each K3b kernel's registers,
spills and blocks an SM are printed. Each build is held to the plain version
(1e-6) at phase 3's drawn sigma, with every sigma > 0, and at P = 999 from a
misaligned x and from x, bits and output all one word off. Then each is
timed as `chip_smoke.py` phase 3 times K3b (`ms`: median of 25 launches
after an L2 flush; `ms_stream`: 50 launches back to back over >= 100 MB) at
the drawn sigma, with every sigma > 0 and with every sigma 0, in turns: the
first form, the shipped form (aligned arrays: its vector path), the shipped
form on x, bits1 and bits2 one word off (its scalar path), the same in
reverse. Last, the launch floor: the shipped form on one sample of 4
pixels, back to back. Needs the card; from the repo's root:

    python3 chip_smoke_noise_designs.py [--parent DIR]

Prints a line a build and timing, the card's name and power limit, and a
JSON object of the times last. Exits 1 if a check fails.
"""

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402

CSRC = os.path.join(C.ROOT, "neuralnet_tracker_traincode_torch", "kernels", "csrc")
SHIPPED, SCALAR, FIRST = "shipped (vector path)", "shipped, inputs one word off (scalar path)", "first form"
ENTRY = """#include "{src}"
extern "C" int k3b_entry(const float* x, const int32_t* b1, const int32_t* b2, const float* sigma, float* out,
                         int B, int P, cudaStream_t stream) {{
    return (int)nntc_gaussian_noise_from_bits(x, b1, b2, sigma, out, B, P, stream);
}}
extern "C" int k3b_blocks_per_sm() {{
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, {kernel}, {threads}, 0) ? -1 : n;
}}
"""


def build(workdir, parent):
    """Start nvcc for both builds at once; returns {name: (entry, blocks an SM)}."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    jobs = {SHIPPED: os.path.join(CSRC, "noise.cu")}
    parent_cu = os.path.join(parent, "neuralnet_tracker_traincode_torch", "kernels", "csrc", "noise.cu")
    if os.path.exists(parent_cu):
        if "kBitsThreads" in open(parent_cu).read():
            C.fail(f"{parent_cu} is not K3b's first form (it has the vector path)")
        jobs[FIRST] = parent_cu
    else:
        print(f"no earlier checkout at {parent}: the first form is not built (compare with PERF.md's row from the "
              f"same card model)")
    procs = {}
    for i, (name, src) in enumerate(jobs.items()):
        entry = os.path.join(workdir, f"entry{i}.cu")
        with open(entry, "w") as f:
            f.write(ENTRY.format(src=src, kernel="noise_bits_kernel<true>" if name == SHIPPED else "noise_bits_kernel",
                                 threads="kBitsThreads" if name == SHIPPED else "kThreads"))
        lib = os.path.join(workdir, f"lib{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda, *ext.CUDA_FLAGS, "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", os.path.dirname(src),
             "-I", CSRC, entry, "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            C.fail(f"nvcc ({name}) failed: {err[-3000:]}")
        so = ctypes.CDLL(lib)
        so.k3b_entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        so.k3b_entry.restype = ctypes.c_int
        built[name] = (so.k3b_entry, so.k3b_blocks_per_sm())
        kernel, info = None, []
        for line in err.splitlines():  # the K3b kernels' registers and spills
            text = line.split("ptxas info    : ")[-1].strip()
            if "Compiling entry function" in text:
                kernel = text.split("'")[1] if "noise_bits_kernel" in text else None
            elif kernel and ("registers" in text or "spill" in text):
                info.append(f"{kernel}: {text}")
        print(f"ptxas ({name}): " + " | ".join(info) + f"; blocks an SM {built[name][1]}", flush=True)
    return built


def main() -> int:
    import torch

    from neuralnet_tracker_traincode_torch.kernels import noise as K3

    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is False: this script runs on an NVIDIA GPU")
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else os.path.join(C.ROOT, ".cache",
                                                                                                  "parent")
    smi = C.card_line()
    print(smi)
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}: {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="noise_designs_")
    try:
        builds = build(workdir, parent)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)  # the libraries stay loaded
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    B, P = C.B, C.S * C.S
    noise = C.phase3_draws(torch)[-1]
    sigma, seeds = noise.sigma.to(dev), noise.seeds.to(dev)
    sigma_on = torch.full((B,), 16.0 / 255.0, device=dev)
    n_on = int((sigma > 0).sum())
    x = torch.rand(B, P, generator=torch.Generator().manual_seed(3)).to(dev)
    b1, b2 = K3.philox_bits(seeds, P)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(entry, out):
        def launch(xs, c1, c2, sg):
            rc = entry(xs.data_ptr(), c1.data_ptr(), c2.data_ptr(), sg.data_ptr(), out.data_ptr(), xs.shape[0],
                       xs.shape[1], stream)
            if rc:
                C.fail(f"K3b launch failed: cudaError {rc}")
        return launch

    odd = x[:7, :999].contiguous()
    mixed = torch.where(torch.arange(7, device=dev) % 2 == 0, sigma_on[:7], 0.0)
    cases = [("drawn sigma", x, b1, b2, sigma), ("every sigma > 0", x, b1, b2, sigma_on),
             ("P=999, x 4 bytes off 16", C.misaligned(torch, odd), b1[:7, :999].contiguous(),
              b2[:7, :999].contiguous(), sigma_on[:7]),
             ("P=999, x, bits, out 4 bytes off 16", C.misaligned(torch, odd),
              C.misaligned(torch, b1[:7, :999].contiguous()), C.misaligned(torch, b2[:7, :999].contiguous()),
              mixed)]
    for name, (entry, _) in builds.items():
        err = 0.0
        for what, xs, c1, c2, sg in cases:
            out = C.misaligned(torch, torch.empty_like(xs)) if "out 4 bytes" in what else torch.empty_like(xs)
            launcher(entry, out)(xs, c1, c2, sg)
            torch.cuda.synchronize()
            d = float((out - K3.add_gaussian_noise_from_bits_plain(xs, c1, c2, sg)).abs().max())
            C.check(d <= 1e-6, f"K3b ({name}, {what}) disagrees with its plain version: {d}")
            err = max(err, d)
        print(f"K3b ({name}): max |kernel - plain| {err:.3e} (tolerance 1e-6) over {', '.join(c[0] for c in cases)}")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    inputs = C.rotating(torch, x, b1, b2)
    off = [tuple(C.misaligned(torch, t) for t in s) for s in inputs]  # every array of every set one word off
    out = torch.empty_like(x)
    draws = {"drawn": sigma, "all_on": sigma_on, "all_quiet": torch.zeros(B, device=dev)}
    bounds = {"drawn": C.k3b_bound(n_on, B, P), "all_on": C.k3b_bound(B, B, P), "all_quiet": C.k3b_bound(0, B, P)}
    forms = {FIRST: inputs, SHIPPED: inputs, SCALAR: off} if FIRST in builds else {SHIPPED: inputs, SCALAR: off}
    order = list(forms) + list(forms)[::-1]
    report = {name: {} for name in forms}
    for name in order:
        launch = launcher(builds[SHIPPED if name == SCALAR else name][0], out)
        sets = forms[name]
        for key, sg in draws.items():
            ms = C.time_ms(torch, lambda: launch(*sets[0], sg), flush)
            ms_stream = C.stream_ms(torch, lambda xs, c1, c2: launch(xs, c1, c2, sg), sets)
            report[name].setdefault(f"ms_{key}", []).append(ms)
            report[name].setdefault(f"ms_stream_{key}", []).append(ms_stream)
            print(f"K3b ({name}) at sigma {key}: {ms:.4f} ms ({ms_stream:.4f} ms_stream), bound {bounds[key][0]:.4f} "
                  f"ms ({bounds[key][1]}) on {smi}", flush=True)
    for name, row in report.items():
        parts = []
        for key in draws:
            mean = statistics.mean(row[f"ms_stream_{key}"])
            row[f"bound_ms_{key}"] = bounds[key][0]
            parts.append(f"{key} ms_stream {mean:.4f} ms = {bounds[key][0] / mean:.0%} of its bound")
        print(f"K3b ({name}): " + "; ".join(parts) + f" (means of two, in turns) on {smi}")
    # the launch floor: the shipped form on one sample of 4 pixels (one block), back to back
    launch = launcher(builds[SHIPPED][0], out)
    tiny = [t[:1, :4].contiguous() for t in (x, b1, b2)]
    for key, sg in (("quiet", torch.zeros(1, device=dev)), ("noisy", sigma_on[:1])):
        report[f"floor_ms_stream_{key}"] = [C.stream_ms(torch, lambda: launch(*tiny, sg), [()]) for _ in range(2)]
        print(f"K3b (shipped) on one sample of 4 pixels, {key}, back to back: ms_stream "
              + ", ".join(f"{t:.4f}" for t in report[f"floor_ms_stream_{key}"]) + f" ms on {smi}")
    for name in (FIRST, SCALAR):
        if name not in report:
            continue
        for key in draws:
            ratio = statistics.mean(report[SHIPPED][f"ms_stream_{key}"]) / statistics.mean(
                report[name][f"ms_stream_{key}"])
            report[f"shipped_over_{'first' if name == FIRST else 'scalar'}_{key}"] = ratio
            print(f"K3b shipped / {name}, ms_stream at sigma {key}: {ratio:.3f}")
    print(smi)
    print(json.dumps({"card": smi, "n_on": n_on, "B": B, "P": P,
                      "blocks_per_sm": {name: b[1] for name, b in builds.items()}, "forms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
