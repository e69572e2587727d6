#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to
their plain PyTorch versions.

    python3 chip_smoke.py [--profile [TRACE.json]]

Phases (any failure ends the run with a non-zero exit code):
 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from `neuralnet_tracker_traincode_torch/kernels/csrc`
    (into `.cache/torch_kernels/`);
 3. each kernel (K1 crop warp, K2 equalize, K3 gaussian noise seeded and
    from injected bits) against its plain PyTorch version at the shapes of
    the training step (B=64, 448^2 uint8 sources -> 129^2 crops), with TF32
    off; K1 also at exactly +-30 degrees and with minifying and magnifying
    ROIs; K2 bit-equal with the gate drawn and all on, and on a one-bin and
    a two-bin image; K3 at the drawn sigma (mostly 0), at all sigma > 0 and
    at an odd P, at offsets 0 and -0.5, its bits equal to K3b's on
    `philox_bits`. Two times per kernel, with CUDA events: `ms`, the median
    of 25 single launches, each after an L2 flush (it includes the launch
    latency); `ms_stream`, the mean per launch over 50 back-to-back launches
    that cycle through at least 16 input buffers (together over 100 MB, twice
    the 50 MB L2). Then a line with K2's and K3's `ms_stream` with every
    sample on (gate 1, sigma > 0), beside the drawn ones, which skip work;
    and `torch.clamp` over the same buffers, a yardstick of one launch that
    reads and writes as many bytes;
 4. the port's output against the port on the CPU on a small input (the
    augmentation and one forward of the full-width model, f32, TF32 off);
 5. the flagship training step (MobileNetV1 x1.0, point head, NLL heads, the
    8-term criterion, batch 64, bf16 autocast) for 3 + 20 steps with the
    launch counts reset just before and read just after: every loss finite,
    K1 and K3 launched once a step, K2 at least once;
 6. with `--profile`: 5 more steps under `torch.profiler`, summarised on a
    `profile:` line (host time per stage, device busy share, kernel launches
    per step, the top kernels), and a Chrome trace if a path is given; the
    same for 5 steps of phase 7's and of phase 9's trainers after their runs;
 7. a training run (`train/run.py:run_training`): the 6D-rotation network
    (MobileNetV1 x1.0, point head, NLL heads, bf16 autocast) with the training
    CLI's full loss setup (NLL, point head, ROI, 6D: 12 terms, the shape prior
    from its npz) on synthetic marker data rendered on the card
    (`data/synthetic.py`: 2,048 training and 256 validation frames at 160^2),
    batch 64, 4 epochs of 1,024 samples, SWA after epoch 1, checkpoints in a
    temporary directory. Validation runs once before the first step and K1's
    validation crops (`skip_rotation`, 192^2 padded sources) are held against
    the plain version; then the run, with the launch counts reset just before
    and read just after, and K1's rotated training crops of the first step of
    each epoch (64 x 160^2 sources) held against the plain version after it,
    with K3's launches of the same steps and every 16th K2 launch (the run's
    own gates, sigmas and seeds; K2 bit-equal, K3 within 1e-6).
    It fails unless every loss is finite, the final
    validation loss is below the untrained model's, `swa.ckpt` read back by
    `load_posenet` gives outputs bit-equal to the trainer's SWA variables, and
    the resume file loaded into a fresh trainer gives back every tensor. It
    prints per-epoch images/s, validation and checkpoint milliseconds and the
    phase's seconds;
 8. the eval path (`eval/predictor.py`, `eval/report.py`): phase 7's
    `best.ckpt` and `swa.ckpt` loaded from disk and its untrained network,
    each through `Predictor.evaluate` over phase 7's 256 validation frames
    (half-pixel offset, head ROI from the landmarks, expansion 1.1), one row
    of the evaluation table each, printed with the card. It fails unless
    both trained rows have a geodesic error below the untrained one, every
    predicted quaternion is unit and finite, a second pass under bf16
    autocast with TF32 on for cuDNN and cuBLAS gives bit-equal rows, and `warp_affine` on the card is within 1e-3 gray of the same call
    on the CPU (128 frames). It prints the Predictor's milliseconds per chunk
    of 128 by stage (packing and copy, crop, forward and backtransform,
    metrics);
 9. the convergence gate of the JAX package's `tests/test_convergence.py`:
    4,096 synthetic frames at 160^2 from seed 3 (rows 0-399 validation, the
    rest training), the training CLI's defaults with `--with-nll-loss
    --with-swa` (quaternion head, point head, ROI training; SWA after epoch
    10), bf16, batch 128, 16 epochs of 10,240 samples through `run_training`
    at the CLI's default on the card, 8 steps a dispatch (one CUDA graph
    replay); then the Predictor on `best.ckpt` and `swa.ckpt` over the frames
    without extreme poses, with the head ROI. It fails unless `best.ckpt`
    reaches a geodesic error below 16 degrees and NME3d below 16%, and K1 and
    K3 at every training launch and every 4th K2 launch (each step's first)
    agree with their plain versions: the warm-up's, eager, and the graph's,
    whose copies, made inside the graph, hold the last replay's inputs and
    outputs (128 x 160^2 and 128 x 129^2); it prints the rows, images/s per
    epoch and the phase's seconds;
 10. the face localizer (`train/localizer.py`, `eval/localizer.py`): the
    training CLI's `LocalizerNet` (bf16, batch 64, lr 1e-3, image
    augmentation on) for 4 epochs of 1,024 samples (the CLI: 50 of 10,240)
    on 2,048 frames at 256^2 rendered on the card here, half marker faces
    (`data/synthetic.py`, their ROI, hasface true) and half noise (the
    pixels of other marker frames shuffled, a random box, hasface false),
    batches from the CLI's sampler. K2 and K3 are held
    to their plain versions at the run's own launches (64 x 224 x 288, every
    16th; K2 bit-equal, K3 within 1e-6) and timed there with phase 3's
    `ms_stream`. It fails unless every loss is finite, `last.ckpt` read back
    by `load_model` equals the trained weights bit for bit, and the trained
    network is ahead of the untrained one at threshold 0.5 in accuracy and
    corner RMSE under both eval protocols on 256 held-out frames (an RMSE of
    no detection at all counts as the worst), each row bit-equal on a second
    pass under bf16 autocast with TF32 on. It prints images/s per epoch;
 11. the other backbones: resnet18 with BlurPool (with the face detector
    head), efficientnet_b0, efficientnet_b4 and hybrid_vit, each full width
    inside `NetworkWithPointHead` with the point head and the NLL heads, for
    3 + 10 flagship steps (batch 64, the 8-term criterion, bf16, as phase 5)
    with K1, K2 and K3 held to their plain versions at their first launch,
    a model file round trip (the face detector's `hasface` bit-equal after
    it), and a Predictor pass over 256 frames whose rows are bit-equal on a
    second pass. It prints ms per step for each;
 12. the host loader and the CLIs. (a) Phase 7's run (6D head, point and NLL
    heads, the 12-term criterion, bf16, batch 64, 4 epochs of 1,024 samples,
    SWA after epoch 1) on 2,048 training and 256 validation marker frames at
    448^2 rendered on the card and JPEG-encoded on the host (quality 95),
    held as `scripts/bench_loader.py:JpegFrames` (the samples `Hdf5PoseDataset` gives under
    `use_raw_images`), through the training CLI's sampler (seed 3),
    `FusedBatchLoader` with 4 process workers and shared memory, and
    `device_prefetch`. It fails unless the first 8 batches of the process
    workers and of 1 thread worker equal, field for field, packing the same
    plans in this process after a cv2 decode; every loss is finite; the
    final validation loss is below the untrained model's; K1, K2 and K3 agree
    with their plain versions at the run's launches as in phase 7; and no
    worker process outlives its iterator. It prints the loader alone
    (batches/s and images/s over 32 batches, no training), the training
    thread's wait in `next()` on the prefetcher (median and p90 ms a step),
    images/s per epoch and the phase's seconds. (b) Where h5py imports:
    `aflw2k.h5` (1,024 frames at 160^2, `write_synthetic_pose_dataset`) in a
    temporary `$DATADIR`, the training CLI for one epoch and the eval CLI on
    its `best.ckpt`, each as a process that must exit 0; else one line says
    that 12b did not run;
 13. export and the ONNX runtime (`export/`, `eval/predictor.py:
    OnnxPoseNetwork`): from phase 7's `best.ckpt` (6D head, point and NLL
    heads, MobileNetV1 x1.0, 129^2) the `opentrack`, `full`, fp16 and int8
    files (int8 calibrated on the eval crops of phase 7's 256 validation
    frames), each conformant (`validate_model`) and run in `TorchOnnxSession`
    on the card in chunks of 128 against the eager network under `f32_eval`
    (1e-4, 1e-4, 5e-2; a quaternion's error is that of the nearer of q and
    -q) and against the same executor on the CPU (printed); the int8 file's
    errors over the crops and on the export CLI's random input are printed,
    not held (the JAX package's PTQ scheme errs above the CLI's 2e-1 on the
    trained network, `PERF.md`), its outputs finite; then
    `Predictor.evaluate` with `OnnxPoseNetwork` on the `full` file over the
    256 frames: its row within 0.01 deg geodesic and 0.01 NME3d points of
    the checkpoint's, bit-equal on a second pass. Phase 10's localizer is
    exported and run against its eager forward (1e-4); the export CLI runs
    as two processes on the card (pose network, `--localizer`) that must
    exit 0 with their parity checks; the pseudo-label CLI runs over an HDF5
    file where h5py imports (else one line says so). It prints each file's
    size and node count, the Predictor's forward milliseconds per chunk for
    the ONNX file and the checkpoint, and the phase's seconds;
 14. several optimizer steps in one dispatch (`PoseTrainer.train_step_multi`,
    one replay of a CUDA graph of K whole steps). (a) Phase 5's flagship
    configuration: from one saved state, 16 eager steps twice (is eager
    deterministic run to run?), then 2 replays of K = 8 on the same batches
    and draws; every metric, parameter, buffer, Adam moment and the count
    must be bit-equal to the eager steps' (or within the eager runs' own
    difference, printed as the floor), and K1, K2 and K3 launched in the
    replays (counted, with the capture's warm-up). K1 at one step's own
    inputs under the plan it reads back, the step's rounded host plan and a
    larger one (printed: are the crops equal?); one eager device part under
    `torch.cuda.set_sync_debug_mode("error")`. ms per step, eager / graph /
    graph / eager with CUDA events (10 replays of K = 8, or 80 eager steps,
    each) at batch 64 and 128; each graph's capture and instantiate seconds
    and pool MB; with `--profile`, the graph path's profile. (b) resnet18 +
    BlurPool (face detector), efficientnet_b0 (stochastic depth) and
    hybrid_vit (dropout): 2 replays of K = 4 against 8 eager steps, as in
    (a), ms per step. (c) Phase 7's run through `run_training(...,
    steps_per_dispatch=8)` on phase 7's frames: every loss finite, the final
    validation loss below the untrained model's, the resume file read back
    into a fresh trainer gives every tensor, and the first block of each
    epoch, rerun eagerly on a second trainer from the same state, generator
    and batches, bit-equal to the graph's, with K1, K2 and K3 held to their
    plain versions in the rerun as phase 7 holds them; images/s per epoch
    beside phase 7's;
 15. data-parallel training (`parallel/distributed.py`, the path that the
    training CLI runs under `torchrun`) at phase 5's flagship configuration
    and full width. Its limits (`DP_*`) are fixed between the readings of
    sound runs and of planted faults. (a) One rank in a process group over
    NCCL, synchronized BatchNorm forced on (`sync` set on every BatchNorm)
    so that every collective runs: the port's BatchNorm with `sync` against
    `torch.native_batch_norm`'s autograd at the flagship's first and last
    BatchNorm inputs (output, input, weight and bias gradients, running
    statistics; f32 within 1e-4 and bf16 within 1e-2 of the largest value);
    one eager step against one process from the same weights, batch and
    draws (the loss within 1e-3 relative, BatchNorm statistics within 1e-2
    a leaf, Adam's first moment, which reads the gradient, within 0.2
    relative over all leaves, every parameter within 2 lr: Adam moves an
    element whose gradient is rounding noise by up to lr of either sign;
    printed beside one process on the rows reversed); one device part under
    `set_sync_debug_mode("error")`; then 2 replays of K = 8 through the CUDA
    graph, NCCL's collectives captured in it, on phase 14a's batches and
    draws, each step's loss within 4e-3 relative of phase 14a's graph run
    (printed beside one process stepping eagerly on the same batches and
    draws with their rows reversed, the floor that another order of the
    reductions sets under bf16); K1, K2 and K3 launched every step and held
    to their plain versions at the first; ms per step through the graph
    beside phase 14a's, the capture's seconds. (b) Two ranks of 32 rows in
    two spawned processes sharing the card over gloo (CUDA tensors, eager:
    gloo cannot be captured): BatchNorm over the two ranks against torch's
    on the whole batch as in (a); 4 steps on the rows of phase 14a's batches
    and draws; the two ranks' parameters, buffers, moments and metrics
    bit-equal, the first moment after the first step within 0.2 of (a)'s
    one process, the losses within 4e-3 relative of phase 14a's eager
    steps, K1, K2 and K3 on each rank against their plain versions at the
    first step; ms per step per rank (not a speed: two processes share one
    card);
 16. the face-model tools. `PosedDeformableHead` on the card bit-equal to itself
    under bf16 autocast with TF32 on. (a) `scripts/fit_face_model.py:
    fit_face_model` on 20,000 synthetic faces (as the JAX package's
    tests/test_fit_face_model.py makes them: XYZ Euler angles within +-35
    deg, xy 100-140 px, size 40-60 px, 0.2 px landmark noise) on the card at
    the CLI's defaults (3,000 steps, lr 0.05): every logged loss finite, the
    JAX test's recovery limits over all faces (mean rotation error < 6 deg,
    xy < 3 px, relative size < 0.1), and the first 256 faces fitted alone on
    the CPU against the card's rows (the fit's per-face trajectories are
    independent; `FIT_AGREE_*`). Before it, 60 steps through the CUDA graph
    (the default on the card) bit-equal to 60 eager steps. It prints ms a
    step eager and through the graph (CUDA events), the fit's seconds and
    the residual's mean and p90. (b)
    `vis3d.rasterize_mesh` on a closed ellipsoid of the full BFM mesh's size
    (38,162 vertices, 76,320 triangles) at 640 x 480, three poses, card
    against CPU (coverage equal, depth within 1e-4, colours within 1 level;
    the pixels where the depth test ties are counted), ms a render (CUDA
    events after warm-up); `FaceRender` on the card through stub head
    models (the tetrahedron of tests/test_vis3d.py; the ellipsoid with 50
    deformation bases, against `FaceRender` on the CPU). No kernel of K1-K3
    is on this path: their launch counts, reset before, must read 0 after;
 17. the analysis and viewer CLIs. (a) `scripts/evaluate_stability.py`'s
    analyses on the card on phase 9's `best.ckpt` (quaternion, point and NLL
    heads), through the Predictor's f32 eval, on marker frames rendered on
    the card: a "video" of 2,100 frames at 160^2 (yaw +-40 and pitch +-20
    degrees as slow sines, position and size drifting; every blink window
    fits), a yaw sweep of 200 frames, phase 9's 400 validation frames and 4
    individuals x 6 frames of one pose each and other shape parameters.
    Open-loop and closed-loop tracking at crops 1.0 and 1.2 with the blink
    report, pitch-vs-yaw, noise-resist at the JAX script's levels (0-64),
    the uncertainty correlation and variation-resist, under
    `np.errstate(all="raise")`. It fails unless every output is finite and
    every quaternion unit, open and closed loop agree on frame 0,
    noise-resist at sigma 0 is `Predictor.evaluate`'s `GeodesicError` within
    1e-6 rad, tril tril^T is positive definite and the open loop's first 128
    frames agree with the CPU's (hpb 4e-4 rad, 1e-3 px); it prints the blink
    lines, closed-loop ms a frame (CUDA events) and one frame's device time,
    operations and busy share (`torch.profiler`), the noise curve, the
    correlation and the mean deviation. (b)
    `scripts/show_train_test_splits.py:iterate_samples` on 32 of phase 7's
    training frames with the training augmentation, the launch counts reset
    before and read after (K1 once, K2 four times, K3 once), each launch
    held to its plain version (K1 0.02 gray, K2 bit-equal, K3 1e-6); the 32
    PNGs written with cv2 read back equal. (c) One line says that the
    figures and the pagers are not drawn where matplotlib does not import
    (the CPU tests draw them);
 18. the JPEG decode on the card (`data/native_loader.py`: the host entropy
    decode; K4, `kernels/csrc/jpeg_idct.cu`: dequantization, libjpeg's
    ISLOW IDCT, the range limit, the zero-padded batch). (a) K4 against its
    plain version and `cv2.imdecode(..., IMREAD_GRAYSCALE)`, bit-equal, on
    64 of phase 12a's 448^2 q95 frames, 64 noise frames at 448^2 q95 (every
    block dense) and a seeded set (noise at q 1, 50 and 100; 1 x 1, 7 x 9
    and 123 x 301; colour 4:2:0 and 4:4:4; a restart interval; two files
    whose quantization tables were raised to 255 after encoding, one of
    flat blocks); K4's `ms`, `ms_stream` and plain version at 64 x 448^2 on
    phase 12a's frames, and its `ms` and `ms_stream` on the noise frames,
    each beside its bound (`k4_work`: the bytes and the integer operations
    that the payload needs), and the host's cv2 decode and entropy decode
    in images/s on one core on both (`scripts/bench_loader.py:decode_stage`).
    (b) Phase 12a's frames through `FusedBatchLoader(jpeg_decode="device")`
    (4 process workers, shared memory): its first 8 batches, through
    `device_prefetch_stacked` at K = 8, equal field for field phase 12a's
    host decode of the same plans; the loader alone in images/s beside
    phase 12a's. (c) Phase 7's run (as 12a) through that stream at K = 8,
    one CUDA graph replay a group, the launch counts reset just before and
    read just after: every loss finite, the validation loss below the
    untrained model's, K4 once a batch (the groups prefetched past the
    run's end included), K1, K2 and K3 launched; the training thread's wait
    in `next()` a step (median, p90), images/s per epoch
    (`scripts/bench_loader.py:training_stage`, whose `--ab --train` runs
    the same in both decodes);
 19. the `kernels` line (`launches` from phase 5's steps, but K4's from
    phase 18's run, its own main path; `launches_training_run`
    from phase 7's run, `launches_convergence_run` from phase 9's,
    `launches_localizer_run` from phase 10's, `launches_backbones` from
    phase 11's steps, `launches_loader_run` from phase 12a's run,
    `launches_export` from phase 13, `launches_multistep` from phase 14
    (a)'s graph run, `launches_data_parallel` from phase 15's graph run and
    both ranks of (b), `launches_face_tools` from phase 16, which are 0,
    `launches_viewer` from phase 17 (b), `launches_jpeg_run` from phase 18
    (c)), then `{"ok": true, "device": ...}` as the last line.

Before phase 2 a `host probe:` line says which of h5py, PIL, cv2,
torchvision and matplotlib import, whether libjpeg is found and whether
`native/nntc_loader.so` loads; it fails nothing. Phase 12a decodes JPEGs
with cv2 on the host and phase 18 on the card (both need cv2: 18 holds K4
to it), and the port reads HDF5 files with h5py (phase 12b runs only where
it imports).

Imports nothing of JAX. Numbers it prints are of the card it ran on.
"""

import concurrent.futures
import contextlib
import copy
import itertools
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B, SRC, S, THETA = 64, 448, 129, 30.0
STEPS_WARMUP, STEPS_TIMED = 3, 20
# several steps in one dispatch (phase 14): K, the replays timed, the backbones and their K
MS_K, MS_TIMED_REPLAYS, MS_BACKBONE_K = 8, 10, 4
MS_BACKBONES = [("resnet18", {"use_blurpool": True}, True), ("efficientnet_b0", {}, False), ("hybrid_vit", {}, False)]
# data parallel (phase 15): part (b)'s eager steps, and the time its two processes may take
DP_STEPS, DP_TIMEOUT_S = 4, 240
# its limits, fixed between the readings of sound runs and of planted faults (PERF.md section 6): the
# losses (relative, every step; sound <= 2.9e-3, faults >= 5.0e-3), Adam's first moment after the first step
# (relative norm over all leaves; sound <= 0.130, faults >= 0.302), synchronized BatchNorm against torch's
# (relative to the largest value; f32 sound <= 9.1e-7, faults >= 2.9e-2; bf16 sound <= 2.0e-3, faults >= 2.9e-2)
DP_LOSS_LIMIT, DP_MU_LIMIT, DP_BN_TOL = 4e-3, 0.2, {"float32": 1e-4, "bfloat16": 1e-2}
# synchronized BatchNorm against torch's: the flagship's first and last BatchNorm inputs, (dtype, memory format)
DP_BN_CASES = [(shape, dtype, layout) for dtype, layout in (("float32", "contiguous_format"),
                                                            ("bfloat16", "channels_last"))
               for shape in ((B, 32, 65, 65), (B, 1024, 5, 5))]
RUN_SRC, RUN_TRAIN, RUN_VAL, RUN_EPOCHS, RUN_SAMPLES_PER_EPOCH = 160, 2048, 256, 4, 1024
# the convergence gate: tests/test_convergence.py of the JAX package
CONV_N, CONV_SEED, CONV_VAL, CONV_B, CONV_EPOCHS, CONV_SAMPLES = 4096, 3, 400, 128, 16, 10240
# the localizer: scripts/train_localizer.py's defaults, cut to 4 epochs of 1,024 samples
LOC_SRC, LOC_TRAIN, LOC_VAL, LOC_B, LOC_EPOCHS, LOC_SAMPLES = 256, 2048, 256, 64, 4, 1024
# the other backbones: (config, backbone_args, face detector head)
BACKBONES = [("resnet18", {"use_blurpool": True}, True), ("efficientnet_b0", {}, False),
             ("efficientnet_b4", {}, False), ("hybrid_vit", {}, False)]
BACKBONE_WARMUP, BACKBONE_STEPS, BACKBONE_EVAL = 3, 10, 256
# the host loader: phase 7's run on JPEG frames at 448^2 through FusedBatchLoader's process workers
LOADER_SRC, LOADER_WORKERS, LOADER_CHECK_BATCHES, LOADER_ALONE_BATCHES = 448, 4, 8, 32
# the JPEG decode on the card (phase 18): the seeded set's seed, and the frames the host decodes are timed on
JPEG_SEED, JPEG_DECODE_N = 20261017, 256
# the CLIs through files (where h5py imports): aflw2k.h5 at 160^2
CLI_N, CLI_SRC = 1024, 160
# export and the ONNX runtime: the Predictor's chunk
EXPORT_CHUNK = 128
# the face-model tools (phase 16): the fit at the size the reference's notebooks fit (WFLW 10,000 faces, LaPa
# about 22,000) with the CLI's defaults; the first FIT_CPU_N faces fitted alone on the CPU
FIT_N, FIT_SEED, FIT_STEPS, FIT_LR, FIT_CPU_N, FIT_TIMED_FROM = 20000, 20261017, 3000, 0.05, 256, 300
# the graph's replays against eager steps on the card: steps, and the logged step the timing starts from
FIT_EAGER_STEPS, FIT_EAGER_TIMED_FROM = 60, 6
# recovery limits of the JAX package's tests/test_fit_face_model.py: mean rotation error (deg), xy error (px), size
FIT_ROT_LIMIT, FIT_XY_LIMIT, FIT_SIZE_LIMIT = 6.0, 3.0, 0.1
# card against CPU on the first FIT_CPU_N faces: mean and largest rotation difference (deg), largest parameter
# difference (quaternion components, coords in px, shape parameters). Fixed between the measured agreement (mean
# 2.5e-6 deg, max 1.2e-5 deg, parameters 1.9e-5) and the recovery limits, several hundred times from each (PERF.md
# section 6)
FIT_AGREE_MEAN_DEG, FIT_AGREE_MAX_DEG, FIT_AGREE_PARAM = 1e-3, 1e-2, 1e-2
# the rasterizer: a closed latitude-longitude ellipsoid the size of the full BFM mesh (38,365 vertices, 76,073
# triangles) at a webcam frame, posed three ways; the full BFM itself is not distributable
RENDER_H, RENDER_W, RENDER_LAT, RENDER_LON, RENDER_SCALE, RENDER_TIMED = 480, 640, 160, 240, 150.0, 20
RENDER_POSES = [("xyz", (0, 0, 0)), ("xyz", (0, 40, 0)), ("xyz", (-25, -20, 15))]
# evaluate_stability and show_train_test_splits (phase 17): a "video" long enough for every blink window, a yaw
# sweep, individuals x frames of one pose each for the variation analysis, the open-loop frames held against the
# CPU, and the samples show_train_test_splits writes
VIEW_VIDEO_N, VIEW_YAW_N, VIEW_INDIVIDUALS, VIEW_PER_INDIVIDUAL, VIEW_CPU_N, VIEW_SAMPLES = 2100, 200, 4, 6, 128, 32
# the eval's tolerances (tests/test_torch_eval.py): hpb within what 1e-4 per quaternion component allows, px
VIEW_HPB_TOL, VIEW_PX_TOL = 4e-4, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
I32_OPS_PER_S = 33.5e12  # 32-bit integer: half the f32 lanes per SM on Hopper


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, n=25, warmup=3):
    """Median device time of `fn()` over `n` launches, each after an L2 flush."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stream_ms(torch, launch, inputs, n=50):
    """Mean device time per launch of `launch(*inputs[i % len(inputs)])` over
    `n` back-to-back launches: cycling through the input sets keeps each one
    out of L2 until it comes round again. The device first spins for ~20 ms
    while the host queues all `n` launches, so that they run back to back and
    the time is the device's, not the host's rate of launching."""
    for args in inputs:
        launch(*args)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    a.record()
    for i in range(n):
        launch(*inputs[i % len(inputs)])
    check(not a.query(), "stream timing: the device finished its spin before the host had queued the launches")
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def rotating(torch, *tensors, min_bytes=100 * 2**20, min_sets=16):
    """At least `min_sets` copies of the input set `tensors`, together at
    least `min_bytes`, for `stream_ms`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(min_sets, math.ceil(min_bytes / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def k1_cases(torch, view_roi, angles):
    """K1's checks beyond the main path's draws: every angle at exactly +-30
    degrees, and the same ROIs (folds kept) resized to |scale| 3.5 and 0.7."""
    centre = (view_roi[:, :2] + view_roi[:, 2:]) / 2
    direction = torch.sign(view_roi[:, 2:] - view_roi[:, :2])
    signs = 1.0 - 2.0 * (torch.arange(angles.shape[0], device=angles.device) % 2)
    yield "+-30 deg", view_roi, signs * math.radians(THETA)
    for name, scale in (("minify", 3.5), ("magnify", 0.7)):
        half = direction * (scale * S / 2)
        yield name, torch.cat([centre - half, centre + half], -1), angles


@contextlib.contextmanager
def k1_captured(K1, keep):
    """Within the block, the K1 wrapper that the pipeline calls also keeps a
    copy of the inputs and output of each launch for which
    `keep(skip_rotation, n)` holds, `n` counting the earlier launches of the
    same kind; for `k1_against_plain`."""
    captured, launch, seen = [], K1.warp_roi_rotate, {False: 0, True: 0}

    def capture(images, view_roi, angles, out_size, theta_max_deg, skip_rotation=False, plan=None):
        out = launch(images, view_roi, angles, out_size, theta_max_deg, skip_rotation, plan=plan)
        if keep(skip_rotation, seen[skip_rotation]):
            captured.append((images.clone(), view_roi.clone(), angles.clone(), out_size, theta_max_deg, skip_rotation,
                             out.clone()))
        seen[skip_rotation] += 1
        return out

    K1.warp_roi_rotate = capture
    try:
        yield captured
    finally:
        K1.warp_roi_rotate = launch


@contextlib.contextmanager
def wrapper_captured(module, name, every):
    """Within the block, the kernel wrapper `module.name` that the pipeline
    calls also keeps a copy of the arguments and output of its first call and
    of every `every`-th call after it; for `k2_k3_against_plain`."""
    captured, launch, seen = [], getattr(module, name), [0]

    def capture(*args):
        out = launch(*args)
        if seen[0] % every == 0:
            captured.append((tuple(a.clone() if hasattr(a, "clone") else a for a in args), out.clone()))
        seen[0] += 1
        return out

    setattr(module, name, capture)
    try:
        yield captured
    finally:
        setattr(module, name, launch)


def k2_k3_against_plain(torch, K2, K3, equalized, noised, what):
    """Captured K2 launches bit-equal to `equalize_plain` and captured K3
    launches within 1e-6 of `add_gaussian_noise_plain` at their own
    offsets; returns the largest errors by kernel."""
    check(equalized and noised, f"{what}: {len(equalized)} K2 and {len(noised)} K3 launches captured")
    err = {"equalize": 0.0, "gaussian_noise": 0.0}
    for (x, gate), out in equalized:
        ref = K2.equalize_plain(x, gate)
        err["equalize"] = max(err["equalize"], float((out - ref).abs().max()))
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"K2 ({what}, {tuple(x.shape)}) is not bit-equal to its plain version: max {err['equalize']}")
    for (x, seeds, sigma, offset), out in noised:
        d = float((out - K3.add_gaussian_noise_plain(x, seeds, sigma, offset)).abs().max())
        err["gaussian_noise"] = max(err["gaussian_noise"], d)
        check(d <= 1e-6, f"K3 ({what}, {tuple(x.shape)}, offset {offset}) disagrees with its plain version: {d}")
    shapes = {tuple(x.shape) for (x, *_), _ in equalized + noised}
    print(f"{what}: K2 at {len(equalized)} launches bit-equal to its plain version, K3 at {len(noised)} launches max "
          f"|kernel - plain| {err['gaussian_noise']:.3e} (tolerance 1e-6), shapes {sorted(shapes)}")
    return err


def k1_against_plain(K1, captured, what):
    """Each captured K1 launch against the plain version at K1's tolerance
    (0.02 gray max, 0.002 mean); returns the largest error."""
    err = 0.0
    for images, view_roi, angles, out_size, theta, skip, out in captured:
        cs = out_size if skip else K1.canvas_size(out_size, theta)
        plain = K1.warp_roi_rotate_plain(images, K1.warp_params(view_roi, angles, out_size, cs), out_size, cs, not skip)
        d = (out - plain).abs()
        check(bool(out.isfinite().all()) and float(d.max()) < 0.02 and float(d.mean()) < 0.002,
              f"K1 ({what}) disagrees: max {float(d.max())}, mean {float(d.mean())}")
        err = max(err, float(d.max()))
    return err


def bound_ms(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_OPS_PER_S + i32_ops / I32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_batch(np, n, seed=0):
    """The training batch of the JAX package's bench.py, at batch n (other
    seeds give other images and points)."""
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, size=(n, SRC, SRC, 1), dtype=np.uint8),
        "pose": np.tile(np.asarray([0.0, 0, 0, 1], np.float32), (n, 1)),
        "coord": (rng.rand(n, 3) * 100 + 100).astype(np.float32),
        "roi": np.tile(np.asarray([100.0, 100, 350, 350], np.float32), (n, 1)),
        "pt3d_68": (rng.rand(n, 68, 3) * 200 + 100).astype(np.float32),
        "shapeparam": rng.randn(n, 50).astype(np.float32),
        "hasface": np.full((n,), 0.9, np.float32),
        "coord_convention_id": np.zeros((n,), np.int32),
        "tag_id": np.zeros((n,), np.int32),
        "dataset_weight": np.ones((n,), np.float32),
        "param_index": np.arange(n, dtype=np.int32),
    }


def flagship_criterion():
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.losses import losses as L
    from neuralnet_tracker_traincode_torch.losses import nll as NLL
    from neuralnet_tracker_traincode_torch.losses.criterion import Criterion, CriterionGroup, MaskedMultiTaskCriterion

    terms = [
        Criterion("nllrot", NLL.QuatPoseNLLLoss(), 0.005),
        Criterion("nllcoord", NLL.CorrelatedCoordPoseNLLLoss(), 0.005),
        Criterion("rot", L.QuatPoseLoss("approx_distance"), 1.0),
        Criterion("xy", L.PoseXYLoss("l2"), 0.25),
        Criterion("sz", L.PoseSizeLoss("l2"), 0.25),
        Criterion("points3d", L.Points3dLoss("l2", chin_weight=0.8), 0.5),
        Criterion("box", L.BoxLoss("l2"), 0.01),
        Criterion("quatreg", L.QuaternionNormalizationSoftConstraint(), 1e-6),
    ]
    return MaskedMultiTaskCriterion({Tag.POSE_WITH_LANDMARKS: CriterionGroup(terms)}, [Tag.POSE_WITH_LANDMARKS])


def kernel_phase(torch, np, dev):
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    from neuralnet_tracker_traincode_torch.augmentation import geometric as G
    from neuralnet_tracker_traincode_torch.augmentation.intensity import sample_noise_parameters
    from neuralnet_tracker_traincode_torch.augmentation.warp_fast import fold_fliprot
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("kernel checks: TF32 off (cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False)")
    gen = torch.Generator().manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = []
    x_np = synthetic_batch(np, B)
    images = torch.from_numpy(x_np["image"][..., 0]).to(dev)

    # K1 at the main path's view ROIs, angles and folded flips
    params = G.make_roi_randomization_parameters(gen, (B,), THETA, 1.1)
    view_roi, _ = G.focus_roi_components(torch.from_numpy(x_np["roi"]) + 0.5, params, S)
    do_flip, rot_dir = G.sample_flip_rot90(gen, (B,), 0.5)
    view_roi, angles, _ = fold_fliprot(view_roi, params.angles, do_flip, rot_dir)
    view_roi, angles = view_roi.to(dev), angles.to(dev)
    cs = K1.canvas_size(S, THETA)
    kp = K1.warp_params(view_roi, angles, S, cs)
    crop = K1.warp_roi_rotate(images, view_roi, angles, S, THETA)  # the wrapper the step calls
    ref = K1.warp_roi_rotate_plain(images, kp, S, cs, True)
    torch.cuda.synchronize()
    d = (crop - ref).abs()
    err_k1 = float(d.max())
    check(err_k1 < 0.02 and float(d.mean()) < 0.002, f"K1 disagrees: max {err_k1}, mean {float(d.mean())}")
    print(f"K1 warp_roi_rotate (main path draws): max |kernel - plain| {err_k1:.3e} gray (tolerance 0.02), "
          f"mean {float(d.mean()):.3e}")
    for case, vr, an in list(k1_cases(torch, view_roi, angles)) + [("skip_rotation", view_roi, angles)]:
        skip = case == "skip_rotation"
        ccs = S if skip else cs
        out = K1.warp_roi_rotate(images, vr, an, S, THETA, skip_rotation=skip)
        plain = K1.warp_roi_rotate_plain(images, K1.warp_params(vr, an, S, ccs), S, ccs, not skip)
        torch.cuda.synchronize()
        d = (out - plain).abs()
        check(bool(torch.isfinite(out).all()) and float(d.max()) < 0.02 and float(d.mean()) < 0.002,
              f"K1 ({case}) disagrees: max {float(d.max())}, mean {float(d.mean())}")
        err_k1 = max(err_k1, float(d.max()))
        print(f"K1 ({case}): max {float(d.max()):.3e}, mean {float(d.mean()):.3e} gray")
    plan = K1.launch_plan(SRC, cs, True, *kp[:, [1, 3]].abs().amax(0).tolist())
    print(f"K1 launch plan at the main path's draws: {plan}")
    k1_out = torch.empty((B, S, S), device=dev)
    launch_k1 = lambda img: ext.extension().warp_roi_rotate(img, kp, k1_out, S, cs, True, *plan[:4])  # noqa: E731
    sy, sx = kp[:, 1].abs().clamp(min=1.0), kp[:, 3].abs().clamp(min=1.0)
    taps_y, taps_x = 2 * torch.ceil(sy) + 1, 2 * torch.ceil(sx) + 1
    k1_ops = float((cs * SRC * taps_y * 2 + cs * cs * taps_x * 2).sum()) + B * 3 * cs * cs * 3
    rows.append(dict(
        name="warp_roi_rotate", source="neuralnet_tracker_traincode_torch/kernels/csrc/warp.cu",
        replaces="neuralnet_tracker_traincode_tpu/augmentation/warp_pallas.py:193", max_abs_err=err_k1,
        ms=time_ms(torch, lambda: launch_k1(images), flush), ms_stream=stream_ms(torch, launch_k1, rotating(torch, images)),
        plain_ms=time_ms(torch, lambda: K1.warp_roi_rotate_plain(images, kp, S, cs, True), flush),
        bound=bound_ms(B * SRC * SRC + B * 6 * 4 + B * S * S * 4, f32_ops=k1_ops), library_ms=None,
    ))

    # K2 on the crops the main path equalizes, with a draw of its p=0.2 gate
    x = (crop / 256.0).reshape(B, -1).contiguous()
    P = x.shape[1]
    gate = (torch.rand(B, generator=gen) < 0.2).to(torch.int32).to(dev)
    on = torch.ones_like(gate)
    few_bins = x.clone()
    few_bins[0] = 0.3  # one bin: step 0, passes through
    few_bins[1] = torch.where(x[1] < 0.5, 0.2, 0.9)  # two bins
    err_k2 = 0.0
    for xs, g in ((x, gate), (x, on), (few_bins, on)):
        out, ref = K2.equalize(xs, g), K2.equalize_plain(xs, g)
        err_k2 = max(err_k2, float((out - ref).abs().max()))
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"K2 is not bit-equal to its plain version: max {err_k2}")
    eq_out = torch.empty_like(x)
    k2_inputs = rotating(torch, x)

    def launch_k2(xs, g=gate):
        ext.extension().equalize(xs, g, eq_out)

    rows.append(dict(
        name="equalize", source="neuralnet_tracker_traincode_torch/kernels/csrc/equalize.cu",
        replaces="neuralnet_tracker_traincode_tpu/augmentation/equalize_pallas.py:123", max_abs_err=err_k2,
        ms=time_ms(torch, lambda: launch_k2(x), flush), ms_stream=stream_ms(torch, launch_k2, k2_inputs),
        plain_ms=time_ms(torch, lambda: K2.equalize_plain(x, gate), flush),
        bound=bound_ms(2 * B * P * 4 + B * 4, f32_ops=4 * B * P), library_ms=None,
    ))
    k2_all_on = stream_ms(torch, lambda xs: launch_k2(xs, on), k2_inputs)
    print(f"K2 equalize: bit-equal to the plain version (gate drawn, {int(gate.sum())} of {B} on; all on; "
          f"a one-bin and a two-bin image)")

    # K3 at the main path's combined sigmas and base + arange seeds; the main
    # path adds the whitening's -0.5 in the kernel
    noise = sample_noise_parameters(gen, B)
    sigma, seeds = noise.sigma.to(dev), noise.seeds.to(dev)
    n_on = int((sigma > 0).sum())
    sigma_on = torch.full((B,), 16.0 / 255.0, device=dev)
    odd = (x[:7, :999].contiguous(), seeds[:7], torch.where(torch.arange(7, device=dev) % 2 == 0, sigma_on[:7], 0.0))
    err_k3 = 0.0
    for xs, sd, sg in ((x, seeds, sigma), (x, seeds, sigma_on), odd):
        for offset in (0.0, -0.5):
            d = float((K3.add_gaussian_noise(xs, sd, sg, offset) - K3.add_gaussian_noise_plain(xs, sd, sg, offset)).abs().max())
            err_k3 = max(err_k3, d)
            check(d <= 1e-6, f"K3 (P={xs.shape[1]}, offset {offset}) disagrees with its plain version: {d}")
    out = K3.add_gaussian_noise(x, seeds, sigma_on)
    b1, b2 = K3.philox_bits(seeds, P)
    out_bits = K3.add_gaussian_noise_from_bits(x, b1, b2, sigma_on)
    check(torch.equal(out_bits, out), "K3 seeded and K3 with the plain version's Philox bits differ")
    err_k3b = float((out_bits - K3.add_gaussian_noise_from_bits_plain(x, b1, b2, sigma_on)).abs().max())
    check(err_k3b <= 1e-6, f"K3 (injected bits) disagrees with its plain version: {err_k3b}")
    check(torch.equal(K3.add_gaussian_noise(x, seeds, sigma_on), out), "K3 is not deterministic")
    check(not torch.equal(K3.add_gaussian_noise(x, seeds + B, sigma_on), out), "K3 ignores its seeds")
    half = torch.full((B, P), 0.5, device=dev)
    z = ((K3.add_gaussian_noise(half, seeds, torch.full((B,), 0.05, device=dev)) - 0.5) / 0.05).double()
    c = torch.corrcoef(z[:16])[torch.triu_indices(16, 16, 1).unbind(0)].abs()
    check(abs(float(z.mean())) < 5e-3 and abs(float(z.std()) - 1.0) < 1e-2, f"K3 moments {float(z.mean())}, {float(z.std())}")
    check(float(c.max()) < 5.0 / P**0.5, f"K3 fields of neighbouring seeds correlate: {float(c.max())}")
    check(torch.equal(K3.add_gaussian_noise(x, seeds, torch.zeros_like(sigma)), x), "K3 with sigma 0 is not a pass-through")
    n_out = torch.empty_like(x)
    k3_inputs = rotating(torch, x)

    def launch_k3(xs, sg=sigma):
        ext.extension().gaussian_noise(xs, seeds, sg, n_out, -0.5)

    launch_k3b = lambda xs, c1, c2: ext.extension().gaussian_noise_from_bits(xs, c1, c2, sigma, n_out)  # noqa: E731
    # what these draws need: half a Philox call (~50 integer operations) and the Box-Muller tail, scale, add,
    # clip and offset (13 f32 operations) for each pixel of a sample with sigma > 0; clip and offset otherwise
    k3_bound = bound_ms(2 * B * P * 4 + 8 * B, f32_ops=(13 * n_on + 3 * (B - n_on)) * P, i32_ops=50 * n_on * P)
    rows.append(dict(
        name="gaussian_noise", source="neuralnet_tracker_traincode_torch/kernels/csrc/noise.cu",
        replaces="neuralnet_tracker_traincode_tpu/augmentation/noise_pallas.py:83", max_abs_err=err_k3,
        ms=time_ms(torch, lambda: launch_k3(x), flush), ms_stream=stream_ms(torch, launch_k3, k3_inputs),
        plain_ms=time_ms(torch, lambda: K3.add_gaussian_noise_plain(x, seeds, sigma, -0.5), flush),
        bound=k3_bound, library_ms=None,
    ))
    k3_all_on = stream_ms(torch, lambda xs: launch_k3(xs, sigma_on), k3_inputs)
    k3_all_on_bound = bound_ms(2 * B * P * 4 + 8 * B, f32_ops=13 * B * P, i32_ops=50 * B * P)
    rows.append(dict(
        name="gaussian_noise_from_bits", source="neuralnet_tracker_traincode_torch/kernels/csrc/noise.cu",
        replaces="neuralnet_tracker_traincode_tpu/augmentation/noise_pallas.py:109", max_abs_err=err_k3b,
        ms=time_ms(torch, lambda: launch_k3b(x, b1, b2), flush),
        ms_stream=stream_ms(torch, launch_k3b, rotating(torch, x, b1, b2)),
        plain_ms=time_ms(torch, lambda: K3.add_gaussian_noise_from_bits_plain(x, b1, b2, sigma), flush),
        bound=bound_ms(4 * B * P * 4 + 4 * B, f32_ops=12 * B * P), library_ms=None,
    ))
    print(f"K3 gaussian_noise: {n_on} of {B} samples have sigma > 0 at the main path's draw; max |kernel - plain| "
          f"{err_k3:.3e} (tolerance 1e-6) at that draw, all sigma > 0 and odd P=999, offsets 0 and -0.5; bits equal "
          f"to K3b's on philox_bits; moments {float(z.mean()):.2e} / {float(z.std()):.4f}; from bits {err_k3b:.3e}")
    print(f"all samples on: equalize (every gate 1) ms_stream {k2_all_on:.4f} ms beside {rows[1]['ms_stream']:.4f} "
          f"at the drawn gate; gaussian_noise (every sigma > 0) ms_stream {k3_all_on:.4f} ms, bound "
          f"{k3_all_on_bound[0]:.4f} ms ({k3_all_on_bound[1]}), beside {rows[2]['ms_stream']:.4f} at the drawn sigma")
    # a yardstick, not a kernel of the port: PyTorch's own elementwise pass over the same (B, P) f32 buffers
    # reads and writes what K2 and K3 must, so it shows what a launch of that size takes on this card
    clamp_out = torch.empty_like(x)
    floor_ms = stream_ms(torch, lambda xs: torch.clamp(xs, 0.0, 1.0, out=clamp_out), k3_inputs)
    print(f"elementwise yardstick: torch.clamp over the same ({B}, {P}) f32 buffers, ms_stream {floor_ms:.4f} ms")
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, stream {r['ms_stream']:.4f} ms/launch, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    torch.cuda.synchronize()
    return rows


def reference_phase(torch, np, dev):
    """Phase 4: the port on the card against the port on the CPU, small input."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
        TrainAugmentationConfig,
        augment_batch_for_training,
        sample_augmentation_parameters,
    )
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    n = 8
    batch = synthetic_batch(np, n)
    labels = {k: batch[k] for k in ("pose", "coord", "roi", "pt3d_68", "shapeparam", "hasface", "coord_convention_id")}
    diffs = []
    for image_aug in (False, True):
        cfg = TrainAugmentationConfig(inputsize=S, enable_image_aug=image_aug, p_flip_rot90=0.5)
        params = sample_augmentation_parameters(torch.Generator().manual_seed(5), n, cfg)
        x_gpu, l_gpu = augment_batch_for_training(batch["image"], labels, LABEL_CATEGORIES, cfg, params=params, device=dev)
        x_cpu, l_cpu = augment_batch_for_training(batch["image"], labels, LABEL_CATEGORIES, cfg, params=params, device="cpu")
        d = (x_gpu.cpu() - x_cpu).abs()
        diffs.append(d)
        for k in l_cpu:
            check(torch.allclose(l_gpu[k].cpu().float(), l_cpu[k].float(), atol=1e-4), f"label {k}: card vs CPU")
    # geometry only: K1's tolerance, 0.02 gray (images are gray / 256 - 0.5)
    check(float(diffs[0].max()) * 256 < 0.02, f"crop card vs CPU: {float(diffs[0].max()) * 256} gray")
    # with stage 1 and noise: crops that differ by float noise may fall on two
    # sides of an equalize bin or a posterize step, which moves a pixel by a
    # whole LUT or posterize level; such pixels must stay rare
    moved = float((diffs[1] > 1e-4).float().mean())
    check(moved < 1e-3 and float(diffs[1].mean()) < 1e-4, f"augmentation card vs CPU: {moved} of pixels moved")
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1")
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    with torch.no_grad():
        ref = model(x_cpu)
        out = model.to(dev)(x_gpu)
    for k in ("coord", "roi", "pose", "pt3d_68", "pose_scales_tril", "coord_scales"):
        check(torch.allclose(out[k].cpu(), ref[k], rtol=1e-3, atol=1e-4), f"model output {k}: card vs CPU")
    print(f"reference: crop card vs CPU max {float(diffs[0].max()) * 256:.3e} gray; with image aug "
          f"{moved:.2e} of pixels moved, mean {float(diffs[1].mean()):.3e}; full-width forward card vs CPU within 1e-3")


def training_phase(torch, np, dev, name):
    """Phase 5: the flagship training step, the main path of the port."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig, nonfinite_metrics

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults; the model runs in bf16 autocast
    torch.backends.cuda.matmul.allow_tf32 = False
    model = NetworkWithPointHead(
        enable_point_head=True, enable_uncertainty=True, config="mobilenetv1", dtype=torch.bfloat16
    )
    cfg = TrainerConfig(batchsize=B, epochs=100, samples_per_epoch=10240,
                        aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
    trainer = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(np, B).items()}
    W = trainer.weight_matrix(50)
    gen = torch.Generator().manual_seed(7)
    losses = []
    torch.cuda.synchronize()
    ext.reset_launch_counts()
    for _ in range(STEPS_WARMUP):
        state, m = trainer.train_step(state, batch, W, generator=gen)
        losses.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS_TIMED):
        state, m = trainer.train_step(state, batch, W, generator=gen)
        losses.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS_TIMED
    launches = dict(ext.LAUNCHES)
    steps = STEPS_WARMUP + STEPS_TIMED
    bad = [(i, nonfinite_metrics(m)) for i, m in enumerate(losses)]
    bad = [b for b in bad if b[1]]
    check(not bad, f"non-finite losses: {bad[:3]}")
    check(launches["warp_roi_rotate"] == steps, f"K1 launched {launches['warp_roi_rotate']} times in {steps} steps")
    check(launches["gaussian_noise"] == steps, f"K3 launched {launches['gaussian_noise']} times in {steps} steps")
    check(launches["equalize"] >= 1, "K2 never launched")
    check(state.step == steps, "the step count did not advance")
    print(f"training: {steps} steps, loss {float(losses[0]['loss']):.4f} -> {float(losses[-1]['loss']):.4f}; "
          f"launches {launches}")
    print(f"training step (flagship, batch {B}, {SRC}^2 uint8 -> {S}^2, bf16 autocast): {step_s * 1e3:.3f} ms/step, "
          f"{B / step_s:.1f} images/s on {name}")

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch, W, generator=gen)

    return launches, step


def synthetic_frames(n, seed, dev):
    """Marker frames rendered on the card, as the port's single-frame `Batch`es."""
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.batch import frame
    from neuralnet_tracker_traincode_torch.data.synthetic import make_labels, render_marker_images

    quats, coords, pt3d, shapeparams, rois = make_labels(n, RUN_SRC, seed=seed, device=dev)
    images = render_marker_images(pt3d, coords, RUN_SRC)
    host = [a.cpu().numpy() for a in (images[..., None], quats, coords, pt3d, shapeparams, rois)]
    names = ("image", "pose", "coord", "pt3d_68", "shapeparam", "roi")
    return [frame(Tag.POSE_WITH_LANDMARKS, {k: a[i] for k, a in zip(names, host)}) for i in range(n)]


def training_run_phase(torch, np, dev, smi):
    """Phase 7: the training run around the step, at full width."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES, iterate_fused_batches, pack_fused_batch
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.io import load_posenet
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.checkpointing import load_train_state
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    tags = [Tag.POSE_WITH_LANDMARKS]
    train_frames = synthetic_frames(RUN_TRAIN, 3, dev)
    val_frames = synthetic_frames(RUN_VAL, 4, dev)
    opts = LossOptions(epochs=RUN_EPOCHS, with_nll_loss=True, with_pointhead=True, with_roi_train=True, enable_6drot=True)

    def make_trainer():
        model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                     enable_6drot=True, dtype=torch.bfloat16)
        cfg = TrainerConfig(batchsize=B, epochs=RUN_EPOCHS, samples_per_epoch=RUN_SAMPLES_PER_EPOCH, swa_start_epoch=1,
                            aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
        return PoseTrainer(model, setup_losses(opts, tags), cfg, LABEL_CATEGORIES, device=dev)

    trainer = make_trainer()
    check(len(trainer.criterion.terms) == 12, f"setup_losses gave {len(trainer.criterion.terms)} terms, not 12")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    untrained_model = copy.deepcopy(trainer.model)  # for phase 8
    validation = FusedValidation(trainer, val_frames, batchsize=2 * B)
    pad = validation._batches[0]["image"].shape[1]
    check(pad == 192, f"validation pads {RUN_SRC}^2 sources to {pad}, not 192")

    # validation before the first step; K1 at the validation crop's shapes against its plain version
    with k1_captured(K1, lambda skip, n: True) as captured:
        ext.reset_launch_counts()
        untrained = validation.evaluate(0)
        torch.cuda.synchronize()
        val_launches = dict(ext.LAUNCHES)
    untrained_loss = float(untrained["loss"])
    n_val = len(validation._batches)
    check(val_launches["warp_roi_rotate"] == n_val and len(captured) == n_val,
          f"validation launched K1 {val_launches['warp_roi_rotate']} times for {n_val} batches")
    for images, _, _, _, _, skip, _ in captured:
        check(skip and tuple(images.shape) == (2 * B, 192, 192), f"validation K1 at {tuple(images.shape)}, skip {skip}")
    err_val = k1_against_plain(K1, captured, "validation crop")
    print(f"training run: K1 at the validation crop ({n_val} launches, {2 * B} x 192^2 uint8 -> {S}^2, "
          f"skip_rotation): max |kernel - plain| {err_val:.3e} gray (tolerance 0.02); untrained validation loss "
          f"{untrained_loss:.4f}")

    packed = pack_fused_batch(train_frames, [0] * len(train_frames), RUN_SRC)

    def batches(start):  # the training CLI's sampler
        sampler = make_concat_dataset_item_sampler(ConcatDataset([train_frames]), [1.0], seed=5)
        return iterate_fused_batches(packed, B, sampler, device=dev, start=start)

    outdir = tempfile.mkdtemp(prefix="chip_smoke_run_")
    steps_per_epoch = trainer.config.steps_per_epoch
    # K1's rotated training crops of each epoch's first step, and K3's launches of the same steps (one a step) and
    # every steps_per_epoch-th K2 launch, kept for the checks after the run
    with k1_captured(K1, lambda skip, n: not skip and n % steps_per_epoch == 0) as train_crops, \
            wrapper_captured(K2, "equalize", steps_per_epoch) as equalized, \
            wrapper_captured(K3, "add_gaussian_noise", steps_per_epoch) as noised:
        torch.cuda.synchronize()
        ext.reset_launch_counts()
        t_run = time.perf_counter()
        state, records = run_training(trainer, state, batches, validation, outdir, torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(ext.LAUNCHES)
    steps = RUN_EPOCHS * steps_per_epoch
    check(state.step == steps and state.swa_count == RUN_EPOCHS - 2, f"step {state.step}, SWA count {state.swa_count}")
    for r in records:
        bad = [k for k, v in r["train_metrics"].items() if not math.isfinite(v)]
        check(not bad and math.isfinite(r["val_loss"]), f"epoch {r['epoch']}: non-finite {bad or 'validation loss'}")
    final_loss = records[-1]["val_loss"]
    check(final_loss < untrained_loss, f"validation loss {final_loss} is not below the untrained {untrained_loss}")
    check(launches["warp_roi_rotate"] == steps + RUN_EPOCHS * n_val,
          f"K1 launched {launches['warp_roi_rotate']} times in {steps} steps and {RUN_EPOCHS} validations")
    check(launches["gaussian_noise"] == steps, f"K3 launched {launches['gaussian_noise']} times in {steps} steps")
    check(launches["equalize"] >= 1, "K2 never launched in the training run")
    check(sorted(os.listdir(outdir)) == ["best.ckpt", "last.ckpt", "resume.pt", "swa.ckpt"],
          f"the run wrote {sorted(os.listdir(outdir))}")
    check(len(train_crops) == RUN_EPOCHS, f"{len(train_crops)} training crops kept, not {RUN_EPOCHS}")
    for images, _, _, _, _, skip, _ in train_crops:
        check(not skip and tuple(images.shape) == (B, RUN_SRC, RUN_SRC), f"training K1 at {tuple(images.shape)}")
    err_train = k1_against_plain(K1, train_crops, "training run's crop")
    print(f"training run: K1 at the training crop ({RUN_EPOCHS} launches of the run checked, {B} x {RUN_SRC}^2 uint8 "
          f"-> {S}^2, rotated): max |kernel - plain| {err_train:.3e} gray (tolerance 0.02)")
    errs = k2_k3_against_plain(torch, K2, K3, equalized, noised, "training run")
    errs["warp_roi_rotate"] = max(err_val, err_train)
    del train_crops, equalized, noised

    # swa.ckpt read back by load_posenet against the trainer's SWA variables, on the card
    loaded = load_posenet(os.path.join(outdir, "swa.ckpt")).to(dev)
    reference = NetworkWithPointHead(**loaded.get_config()).to(dev).eval()
    reference.load_state_dict(trainer.variables_of(state, swa=True))
    torch.backends.cudnn.deterministic = True
    x = torch.rand((2 * B, S, S, 1), generator=torch.Generator().manual_seed(9)).to(dev) - 0.5
    with torch.no_grad():
        a, b = loaded(x), reference(x)
    torch.backends.cudnn.deterministic = False
    differ = [k for k in b if k != "rot" and not torch.equal(a[k], b[k])]
    check(not differ and torch.equal(a["rot"].value, b["rot"].value), f"swa.ckpt outputs differ: {differ}")

    # the resume file into a fresh trainer
    fresh = make_trainer()
    resumed, extra = load_train_state(fresh, os.path.join(outdir, "resume.pt"))
    pairs = [(fresh.model.state_dict(), trainer.model.state_dict()), (resumed.opt_state.mu, state.opt_state.mu),
             (resumed.opt_state.nu, state.opt_state.nu), (resumed.swa_params, state.swa_params),
             (resumed.swa_buffers, state.swa_buffers)]
    differ = [k for got, want in pairs for k in want if not torch.equal(got[k], want[k])]
    check(not differ and (resumed.step, resumed.opt_state.count, resumed.swa_count) ==
          (state.step, state.opt_state.count, state.swa_count) and extra["epoch"] == RUN_EPOCHS - 1,
          f"the resume file gives back other tensors: {differ[:5]}")
    n_tensors = sum(len(want) for _, want in pairs)

    for r in records:
        print(f"training run epoch {r['epoch'] + 1}/{RUN_EPOCHS}: {r['steps']} steps in {r['train_s'] * 1e3:.1f} ms, "
              f"{r['images_per_s']:.1f} images/s ({r['sustained_images_per_s']:.1f} sustained since step 2, "
              f"validation and checkpoints included); validation {r['val_ms']:.1f} ms ({RUN_VAL} frames), "
              f"loss {r['val_loss']:.4f}; checkpoint writes {sum(r['checkpoint_ms'].values()):.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in r["checkpoint_ms"].items()) + f") on {smi}")
    print(f"training run: {steps} steps, validation loss {untrained_loss:.4f} -> {final_loss:.4f}; swa.ckpt outputs "
          f"bit-equal to the SWA variables; resume file gives back {n_tensors} tensors equal; launches {launches}; "
          f"run {run_s:.2f} s, phase {time.perf_counter() - t_phase:.2f} s (data, validation check and read-backs "
          f"included) on {smi}")
    W = trainer.weight_matrix(RUN_EPOCHS - 1)
    gen = torch.Generator().manual_seed(11)
    more = batches(state.step)

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, next(more), W, generator=gen)

    return launches, errs, step, dict(outdir=outdir, val_frames=val_frames, untrained=untrained_model,
                                      train_frames=train_frames, records=records, untrained_loss=untrained_loss)


def eval_samples(frames):
    """The eval loader's samples of `frames`: labels offset by half a pixel
    and the head ROI from the landmarks, as the JAX package's
    `make_validation_dataset` builds them (no full face model: the head
    sphere)."""
    from neuralnet_tracker_traincode_torch.data.host_transforms import PutRoiFromLandmarks, offset_points_by_half_pixel_np

    put = PutRoiFromLandmarks(extend_to_forehead=True)
    return [put(offset_points_by_half_pixel_np(f)) for f in frames]


def report_rows(torch, np, dev, nets, samples, data, smi, repeat=False):
    """One evaluation-table row per network through `Predictor.evaluate`
    (expansion 1.1, head ROI), the quaternions checked unit and finite, and
    with `repeat` each row computed a second time under bf16 autocast with
    TF32 on, bit-equal. Returns the
    rows and each stage's milliseconds per chunk of the last network (the
    first one pays the device's warm-up)."""
    from neuralnet_tracker_traincode_torch.eval import metrics as M
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor
    from neuralnet_tracker_traincode_torch.eval.report import RoiConfig, TableBuilder, add_report_row

    builder, rows, stages = TableBuilder(), {}, {}
    for name, net in nets.items():
        predictor = Predictor(net, RoiConfig().expansion_factor, device=dev)
        stage_ms = {}
        rows[name] = add_report_row(builder, predictor, samples, name, data, RoiConfig(), stage_ms=stage_ms)
        stages = stage_ms
        if repeat:  # under the training's settings, which the eval must not see: bf16 autocast, TF32 on
            cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
            saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            try:
                with torch.autocast(dev.type, dtype=torch.bfloat16):
                    again = add_report_row(TableBuilder(), predictor, samples, name, data, RoiConfig())
            finally:
                cudnn.allow_tf32, matmul.allow_tf32 = saved
            check(json.dumps(again) == json.dumps(rows[name]), f"{name}: a second pass gives another row: {again}")
        quats = predictor.evaluate(M.PredExtractor("pose"), samples)
        norm = np.linalg.norm(quats, axis=-1)
        check(quats.shape == (len(samples), 4) and bool(np.isfinite(quats).all()) and float(np.abs(norm - 1).max()) < 1e-5,
              f"{name}: predicted quaternions not unit and finite (|q| in [{norm.min()}, {norm.max()}])")
    table = builder.build()
    print(table)
    print(f"(table above: {len(samples)} frames, {smi})")
    return rows, stages


def eval_phase(torch, np, dev, smi, run):
    """Phase 8: the eval path on phase 7's checkpoints and its validation frames."""
    from neuralnet_tracker_traincode_torch.augmentation.geometric import focus_roi_transform, no_roi_randomization
    from neuralnet_tracker_traincode_torch.augmentation.warp import warp_affine
    from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork

    t_phase = time.perf_counter()
    samples = eval_samples(run["val_frames"])
    nets = {"untrained": CheckpointPoseNetwork(run["untrained"], dev)}
    for f in ("best.ckpt", "swa.ckpt"):
        nets[f] = CheckpointPoseNetwork(os.path.join(run["outdir"], f), dev)
        check(nets[f].model.enable_6drot, f"{f} is not the 6D network")
    rows, stages = report_rows(torch, np, dev, nets, samples, "phase 7 validation", smi, repeat=True)
    geo = {k: r[5] for k, r in rows.items()}
    check(geo["best.ckpt"] < geo["untrained"] and geo["swa.ckpt"] < geo["untrained"], f"geodesic errors {geo}")

    # the eval crop on the card against the same call on the CPU, one chunk
    images = torch.from_numpy(np.stack([s["image"] for s in samples[:128]]))
    rois = torch.from_numpy(np.stack([s["roi"] for s in samples[:128]]))
    tr = focus_roi_transform(rois, no_roi_randomization((len(rois),), 1.1), S)
    on_card = warp_affine(images.to(dev), tr, S).cpu()
    err = float((on_card - warp_affine(images, tr, S)).abs().max())
    check(err <= 1e-3, f"warp_affine card vs CPU: {err} gray")
    print(f"eval: rows bit-equal on a second pass (bf16 autocast, TF32 on); quaternions unit and finite; geodesic "
          f"untrained {geo['untrained']:.3f}, best {geo['best.ckpt']:.3f}, swa {geo['swa.ckpt']:.3f} deg; warp_affine card vs "
          f"CPU max {err:.3e} gray ({len(rois)} x {RUN_SRC}^2 -> {S}^2); Predictor ms per chunk of 128 (swa.ckpt, "
          f"median of {len(stages['crop_ms'])} chunks): "
          + ", ".join(f"{k} {statistics.median(v):.2f}" for k, v in stages.items())
          + f"; phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return stages


def convergence_phase(torch, np, dev, smi, keep_dir):
    """Phase 9: the convergence gate of the JAX package's
    `tests/test_convergence.py` on the card. `best.ckpt` is copied into
    `keep_dir` (for phase 17); returns the validation frames last."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.host_transforms import indices_without_extreme_poses
    from neuralnet_tracker_traincode_torch.data.loader import (
        LABEL_CATEGORIES,
        iterate_fused_batches,
        pack_fused_batch,
        stack_batches,
    )
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.scripts.train_poseestimator import steps_per_dispatch
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    torch.backends.cudnn.allow_tf32 = True  # as in phases 5 and 7
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    frames = synthetic_frames(CONV_N, CONV_SEED, dev)
    val_frames, train_frames = frames[:CONV_VAL], frames[CONV_VAL:]  # the aflw2k3d split of `pipelines.py`
    opts = LossOptions(epochs=CONV_EPOCHS, with_nll_loss=True)  # the CLI's defaults with --with-nll-loss
    tags = [Tag.POSE_WITH_LANDMARKS]
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                 dtype=torch.bfloat16)
    cfg = TrainerConfig(batchsize=CONV_B, epochs=CONV_EPOCHS, samples_per_epoch=CONV_SAMPLES,
                        swa_start_epoch=CONV_EPOCHS * 2 // 3,  # --with-swa
                        aug=TrainAugmentationConfig(inputsize=S, rotation_aug_angle=THETA, extension_factor=1.1))
    trainer = PoseTrainer(model, setup_losses(opts, tags), cfg, LABEL_CATEGORIES, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(1234))
    validation = FusedValidation(trainer, val_frames, batchsize=2 * CONV_B)
    packed = pack_fused_batch(train_frames, [0] * len(train_frames), RUN_SRC)
    steps_per_epoch = cfg.steps_per_epoch
    K = steps_per_dispatch(0, CONV_B, steps_per_epoch, dev.type)  # the training CLI's default on the card

    def batches(start):  # the training CLI's sampler, K batches a group
        sampler = make_concat_dataset_item_sampler(ConcatDataset([train_frames]), [1.0], seed=CONV_SEED)
        it = iterate_fused_batches(packed, CONV_B, sampler, device=dev, start=start)
        return it if K == 1 else stack_batches(it, K)

    outdir = tempfile.mkdtemp(prefix="chip_smoke_convergence_")
    t_data = time.perf_counter() - t_phase
    try:
        # K1 and K3 at every training launch, every 4th K2 launch (each step's first of its 4): the warm-up's,
        # eager, and the graph's, whose copies (made inside the graph) hold the last replay's inputs and outputs
        with k1_captured(K1, lambda skip, n: not skip) as train_crops, \
                wrapper_captured(K2, "equalize", 4) as equalized, \
                wrapper_captured(K3, "add_gaussian_noise", 1) as noised:
            torch.cuda.synchronize()
            ext.reset_launch_counts()
            t_run = time.perf_counter()
            state, records = run_training(trainer, state, batches, validation, outdir, torch.Generator().manual_seed(7),
                                          steps_per_dispatch=K)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = dict(ext.LAUNCHES)
        steps = CONV_EPOCHS * steps_per_epoch
        warm = trainer.graph_stats["warmup_steps"]
        check(K == 8 and state.step == steps, f"the run took {state.step} steps in blocks of {K}, not {steps} of 8")
        check(launches["warp_roi_rotate"] == steps + warm + CONV_EPOCHS * len(validation._batches),
              f"K1 launched {launches['warp_roi_rotate']} times")
        check(launches["gaussian_noise"] == steps + warm and launches["equalize"] == 4 * (steps + warm),
              f"launches {launches}")
        check(len(train_crops) == warm + K * trainer.graph_stats["captures"],
              f"{len(train_crops)} training crops kept for {trainer.graph_stats}")
        for images, _, _, _, _, skip, _ in train_crops:
            check(not skip and tuple(images.shape) == (CONV_B, RUN_SRC, RUN_SRC), f"K1 at {tuple(images.shape)}")
        err_k1 = k1_against_plain(K1, train_crops, "convergence run's crop")
        errs = k2_k3_against_plain(torch, K2, K3, equalized, noised, "convergence run")
        errs["warp_roi_rotate"] = err_k1
        del train_crops, equalized, noised

        quats = np.stack([f["pose"] for f in frames])
        coords = np.stack([f["coord"] for f in frames])
        keep = indices_without_extreme_poses(quats, coords)
        samples = eval_samples([frames[i] for i in keep])
        t_eval = time.perf_counter()
        nets = {f: CheckpointPoseNetwork(os.path.join(outdir, f), dev) for f in ("best.ckpt", "swa.ckpt")}
        rows, stages = report_rows(torch, np, dev, nets, samples, f"synthetic {CONV_N} (seed {CONV_SEED})", smi)
        eval_s = time.perf_counter() - t_eval
        shutil.copy(os.path.join(outdir, "best.ckpt"), keep_dir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    for r in records:
        print(f"convergence run epoch {r['epoch'] + 1}/{CONV_EPOCHS}: {r['steps']} steps in {r['train_s']:.2f} s, "
              f"{r['images_per_s']:.1f} images/s ({r['sustained_images_per_s']:.1f} sustained); validation "
              f"{r['val_ms']:.1f} ms, loss {r['val_loss']:.4f}; checkpoints {sum(r['checkpoint_ms'].values()):.1f} ms")
    best_geo, best_nme = rows["best.ckpt"][5], rows["best.ckpt"][8]
    print(f"convergence gate: best.ckpt geodesic {best_geo:.3f} deg (< 16), NME3d {best_nme:.3f}% (< 16); swa.ckpt "
          f"geodesic {rows['swa.ckpt'][5]:.3f}, NME3d {rows['swa.ckpt'][8]:.3f}; {len(samples)} of {CONV_N} frames "
          f"without extreme poses; K1 at the run's crops max |kernel - plain| {err_k1:.3e} gray; {K} steps a "
          f"dispatch, graphs {trainer.graph_stats}; launches {launches} ({warm} warm-up steps); data {t_data:.2f} s, "
          f"run {run_s:.2f} s ({steps * CONV_B / run_s:.1f} images/s with "
          f"validation and checkpoints), eval {eval_s:.2f} s (Predictor ms per chunk of 128, swa.ckpt, median of "
          f"{len(stages['crop_ms'])} chunks: "
          + ", ".join(f"{k} {statistics.median(v):.2f}" for k, v in stages.items())
          + f"), phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    check(best_geo < 16.0 and best_nme < 16.0, f"convergence gate failed: geodesic {best_geo}, NME3d {best_nme}")
    W = trainer.weight_matrix(CONV_EPOCHS - 1)
    gen = torch.Generator().manual_seed(11)
    more = batches(state.step)

    def step():
        nonlocal state
        state, _ = trainer.train_step_multi(state, next(more), W, generator=gen)

    return launches, errs, step, val_frames


def host_probe():
    """Which of the loader's libraries this machine has (cv2 decodes the
    JPEGs, h5py reads the files); prints only."""
    import ctypes
    import ctypes.util
    import importlib

    found = {}
    for mod in ("h5py", "PIL", "cv2", "torchvision", "matplotlib"):
        try:
            found[mod] = getattr(importlib.import_module(mod), "__version__", "yes")
        except Exception as e:  # noqa: BLE001 - a probe: any failure to import is the answer
            found[mod] = f"no ({type(e).__name__})"
    found["libjpeg"] = ctypes.util.find_library("jpeg") or "not found"
    so = os.path.join(ROOT, "native", "nntc_loader.so")
    if not os.path.exists(so):
        found["native/nntc_loader.so"] = "absent (built from native/nntc_loader.cpp, not committed)"
    else:
        try:
            ctypes.CDLL(so)
            found["native/nntc_loader.so"] = "loads"
        except OSError as e:
            found["native/nntc_loader.so"] = f"does not load ({e})"
    print("host probe: " + json.dumps(found))


def localizer_frames(torch, np, n, seed, dev):
    """Frames for the localizer rendered on the card, as `Tag.FACE_DETECTION`
    `Batch`es: the first half marker faces at LOC_SRC^2 with their ROI and
    hasface true, the second half noise with a random box and hasface false.
    The noise is the pixels of other marker frames shuffled, so that the two
    halves have the same gray-level histogram and only the markers' shape
    tells them apart."""
    from neuralnet_tracker_traincode_torch.data.batch import frame
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.synthetic import make_labels, render_marker_images

    half = n // 2
    _, coords, pt3d, _, rois = make_labels(n, LOC_SRC, seed=seed, device=dev)
    rendered = render_marker_images(pt3d, coords, LOC_SRC)
    g = torch.Generator(device=dev).manual_seed(seed)
    shuffle = torch.argsort(torch.rand((n - half, LOC_SRC * LOC_SRC), generator=g, device=dev), dim=-1)
    noise = torch.gather(rendered[half:].reshape(n - half, -1), 1, shuffle).reshape(n - half, LOC_SRC, LOC_SRC)
    lo = torch.rand((n - half, 2), generator=g, device=dev) * (0.6 * LOC_SRC)
    size = (0.15 + 0.25 * torch.rand((n - half, 1), generator=g, device=dev)) * LOC_SRC
    images = torch.cat([rendered[:half], noise])[..., None].cpu().numpy()
    roi = torch.cat([rois[:half], torch.cat([lo, lo + size], -1)]).cpu().numpy()
    return [frame(Tag.FACE_DETECTION, dict(image=images[i], roi=roi[i], hasface=np.asarray(i < half))) for i in range(n)]


def localizer_phase(torch, np, dev, smi):
    """Phase 10: the face localizer's training run and evaluation."""
    from neuralnet_tracker_traincode_torch.augmentation.localizer_pipeline import LocalizerAugConfig
    from neuralnet_tracker_traincode_torch.data.loader import iterate_fused_batches, pack_fused_batch
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.eval.localizer import LocalizerEvaluator, result_lines
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.models.io import load_model
    from neuralnet_tracker_traincode_torch.models.localizer import LocalizerNet
    from neuralnet_tracker_traincode_torch.train.localizer import (
        LocalizerTrainer,
        LocalizerTrainerConfig,
        run_localizer_training,
    )

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    train_frames = localizer_frames(torch, np, LOC_TRAIN, 21, dev)
    held_out = localizer_frames(torch, np, LOC_VAL, 22, dev)
    packed = pack_fused_batch(train_frames, [0] * len(train_frames), LOC_SRC)
    sampler = make_concat_dataset_item_sampler(ConcatDataset([train_frames]), [1.0], seed=21)
    cfg = LocalizerTrainerConfig(batchsize=LOC_B, lr=1e-3, epochs=LOC_EPOCHS, samples_per_epoch=LOC_SAMPLES,
                                 aug=LocalizerAugConfig(enable_image_aug=True))
    trainer = LocalizerTrainer(LocalizerNet(dtype=torch.bfloat16), cfg, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(1234))
    untrained = copy.deepcopy(trainer.model)
    outdir = tempfile.mkdtemp(prefix="chip_smoke_localizer_")
    spe = cfg.steps_per_epoch
    P = 224 * 288
    try:
        # K3's launch of each epoch's first step and every spe-th K2 launch, kept for the checks after the run
        with wrapper_captured(K2, "equalize", spe) as equalized, wrapper_captured(K3, "add_gaussian_noise", spe) as noised:
            torch.cuda.synchronize()
            ext.reset_launch_counts()
            t_run = time.perf_counter()
            state, records = run_localizer_training(trainer, state, iterate_fused_batches(packed, LOC_B, sampler, device=dev),
                                                    outdir, torch.Generator().manual_seed(7))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = dict(ext.LAUNCHES)
        steps = LOC_EPOCHS * spe
        check(state.step == steps, f"the localizer took {state.step} steps, not {steps}")
        check(all(math.isfinite(r["loss"]) for r in records), f"non-finite localizer losses: {records}")
        check(launches["gaussian_noise"] == steps and launches["equalize"] >= 1 and launches["warp_roi_rotate"] == 0,
              f"localizer launches {launches}")
        for (x, *_), _ in equalized + noised:
            check(tuple(x.reshape(x.shape[0], -1).shape) == (LOC_B, P), f"localizer K2/K3 at {tuple(x.shape)}")
        errs = k2_k3_against_plain(torch, K2, K3, equalized, noised, "localizer run")
        # K2 and K3 at this shape, timed as phase 3 times them, on the run's own inputs
        (xe, gate), _ = equalized[0]
        (xn, seeds, sigma, offset), _ = noised[0]
        gate, xn = gate.to(torch.int32).contiguous(), xn.reshape(LOC_B, P)
        eq_out, n_out = torch.empty_like(xe), torch.empty_like(xn)
        n_on = int((sigma > 0).sum())
        loc = {
            "equalize": (stream_ms(torch, lambda xs: ext.extension().equalize(xs, gate, eq_out), rotating(torch, xe)),
                         bound_ms(2 * LOC_B * P * 4 + LOC_B * 4, f32_ops=4 * LOC_B * P)),
            "gaussian_noise": (stream_ms(torch, lambda xs: ext.extension().gaussian_noise(xs, seeds, sigma, n_out, offset),
                                         rotating(torch, xn)),
                               bound_ms(2 * LOC_B * P * 4 + 8 * LOC_B, f32_ops=(13 * n_on + 3 * (LOC_B - n_on)) * P,
                                        i32_ops=50 * n_on * P)),
        }
        del equalized, noised
        for k, (ms, (b, by)) in loc.items():
            print(f"localizer shape ({LOC_B}, {P}): {k} ms_stream {ms:.4f} ms, bound {b:.4f} ms ({by}), "
                  f"{launches[k]} launches in {steps} steps")
        loaded = load_model(os.path.join(outdir, "last.ckpt"), [LocalizerNet])
        want = trainer.model.state_dict()
        differ = [k for k, v in loaded.state_dict().items()
                  if not k.endswith("num_batches_tracked") and not torch.equal(v, want[k].cpu())]
        check(not differ, f"last.ckpt read back differs from the trained weights: {differ[:5]}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    samples = [dict(image=f["image"], roi=f["roi"], hasface=float(f["hasface"])) for f in held_out]
    results = {}
    t_eval = time.perf_counter()
    for name, net in (("untrained", untrained), ("trained", trainer.model)):
        evaluator = LocalizerEvaluator(net, device=dev)
        for protocol in ("full", "crop"):
            rows = evaluator.evaluate(samples, protocol)
            # again under the training's settings, which the eval must not see: bf16 autocast, TF32 on
            cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
            saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            try:
                with torch.autocast(dev.type, dtype=torch.bfloat16):
                    again = evaluator.evaluate(samples, protocol)
            finally:
                cudnn.allow_tf32, matmul.allow_tf32 = saved
            check(json.dumps(again) == json.dumps(rows), f"localizer {name} {protocol}: a second pass gives {again}")
            results[name, protocol] = rows
            print(f"localizer eval, {name} network, {protocol} protocol ({len(samples)} held-out frames, half faces):\n"
                  + result_lines(rows))
    eval_s = time.perf_counter() - t_eval
    for protocol in ("full", "crop"):
        (acc, rmse), (acc0, rmse0) = results["trained", protocol][0.5], results["untrained", protocol][0.5]
        check(acc > acc0, f"localizer {protocol}: trained accuracy {acc} is not above the untrained {acc0} at 0.5")
        check(math.isfinite(rmse) and (not math.isfinite(rmse0) or rmse < rmse0),
              f"localizer {protocol}: trained corner RMSE {rmse} is not below the untrained {rmse0} at 0.5")
    for r in records:
        print(f"localizer run epoch {r['epoch'] + 1}/{LOC_EPOCHS}: {r['steps']} steps in {r['train_s'] * 1e3:.1f} ms, "
              f"{r['images_per_s']:.1f} images/s, loss {r['loss']:.4f}")
    print(f"localizer: {steps} steps (batch {LOC_B}, bf16, image augmentation), loss {records[0]['loss']:.4f} -> "
          f"{records[-1]['loss']:.4f}; last.ckpt read back bit-equal; eval rows bit-equal on a second pass; launches "
          f"{launches}; run {run_s:.2f} s, eval {eval_s:.2f} s, phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, errs, loc, trainer.model


def backbones_phase(torch, np, dev, smi):
    """Phase 11: the flagship step, a model file and the Predictor with each other backbone."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.io import load_posenet
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig, nonfinite_metrics

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(np, B).items()}
    samples = eval_samples(synthetic_frames(BACKBONE_EVAL, 6, dev))
    outdir = tempfile.mkdtemp(prefix="chip_smoke_backbones_")
    errs = {"warp_roi_rotate": 0.0, "equalize": 0.0, "gaussian_noise": 0.0}
    steps = BACKBONE_WARMUP + BACKBONE_STEPS
    step_ms = {}
    torch.cuda.synchronize()
    ext.reset_launch_counts()
    try:
        for config, args, face in BACKBONES:
            model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config=config,
                                         backbone_args=args, enable_face_detector=face, dtype=torch.bfloat16)
            cfg = TrainerConfig(batchsize=B, epochs=100, samples_per_epoch=10240,
                                aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
            trainer = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, device=dev)
            state = trainer.init_state(torch.Generator().manual_seed(0))
            W = trainer.weight_matrix(50)
            gen = torch.Generator().manual_seed(7)
            losses = []
            # the first launch of each kernel in these steps, for the checks after them
            with k1_captured(K1, lambda skip, n: n == 0) as crops, wrapper_captured(K2, "equalize", 10**9) as equalized, \
                    wrapper_captured(K3, "add_gaussian_noise", 10**9) as noised:
                for i in range(steps):
                    if i == BACKBONE_WARMUP:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    state, m = trainer.train_step(state, batch, W, generator=gen)
                    losses.append(m)
                torch.cuda.synchronize()
                step_ms[config] = (time.perf_counter() - t0) / BACKBONE_STEPS * 1e3
            bad = [b for b in (nonfinite_metrics(m) for m in losses) if b]
            check(not bad, f"{config}: non-finite losses {bad[:3]}")
            check(len(crops) == 1, f"{config}: {len(crops)} K1 launches captured")
            errs["warp_roi_rotate"] = max(errs["warp_roi_rotate"], k1_against_plain(K1, crops, f"{config} step"))
            for k, v in k2_k3_against_plain(torch, K2, K3, equalized, noised, f"{config} step").items():
                errs[k] = max(errs[k], v)
            del crops, equalized, noised

            # the model file, read back
            path = os.path.join(outdir, f"{config}.ckpt")
            trainer.save_checkpoint(state, path)
            loaded = load_posenet(path)
            want = trainer.variables_of(state)
            differ = [k for k, v in loaded.state_dict().items()
                      if not k.endswith("num_batches_tracked") and not torch.equal(v, want[k].cpu())]
            check(not differ and loaded.get_config() == model.get_config(), f"{config}: the model file differs: {differ[:5]}")
            if face:
                reference = NetworkWithPointHead(**loaded.get_config()).to(dev).eval()
                reference.load_state_dict(want)
                x = torch.rand((2 * B, S, S, 1), generator=torch.Generator().manual_seed(9)).to(dev) - 0.5
                torch.backends.cudnn.deterministic = True
                with torch.no_grad():
                    a, b = loaded.to(dev)(x), reference(x)
                torch.backends.cudnn.deterministic = False
                check(a["hasface"].shape == (2 * B,) and bool(((a["hasface"] > 0) & (a["hasface"] < 1)).all())
                      and torch.equal(a["hasface"], b["hasface"]), f"{config}: the face detector's hasface differs")
            report_rows(torch, np, dev, {config: CheckpointPoseNetwork(trainer.model, dev)}, samples,
                        f"phase 11 synthetic {BACKBONE_EVAL}", smi, repeat=True)
            print(f"backbone {config} {args or ''}{' + face detector' if face else ''}: {steps} steps, loss "
                  f"{float(losses[0]['loss']):.4f} -> {float(losses[-1]['loss']):.4f}, {step_ms[config]:.2f} ms/step "
                  f"(batch {B}, bf16) on {smi}; model file round trip bit-equal; Predictor rows bit-equal on a second pass")
        torch.cuda.synchronize()
        launches = dict(ext.LAUNCHES)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    n = len(BACKBONES) * steps
    check(launches["warp_roi_rotate"] == n and launches["gaussian_noise"] == n and launches["equalize"] >= len(BACKBONES),
          f"backbone launches {launches} in {n} steps")
    print(f"backbones: ms per step {json.dumps(step_ms)}; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, errs


def jpeg_frames(torch, np, n, seed, dev):
    """`n` marker frames at LOADER_SRC^2 rendered on the card from `seed`,
    encoded on the host at the JAX writer's quality (95), as `JpegFrames`
    (`scripts/bench_loader.py`)."""
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames as frames

    return frames(n, LOADER_SRC, seed, dev)


def loader_phase(torch, np, dev, smi):
    """Phase 12a: phase 7's training run on JPEG frames at 448^2 through the
    host loader (`FusedBatchLoader` with process workers and shared memory,
    then `device_prefetch`), the JPEGs decoded by cv2 on the host. Returns
    the launches, the errors and, for phase 18, the frames, the padding, the
    first batches packed here and the loader alone's images/s."""
    import multiprocessing as mp

    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import (
        LABEL_CATEGORIES,
        FusedBatchLoader,
        device_prefetch,
        pack_fused_batch,
        plan_batches,
    )
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.pipelines import probe_pad_size
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    torch.backends.cudnn.allow_tf32 = True  # as in phase 7
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    train = jpeg_frames(torch, np, RUN_TRAIN, 3, dev)
    val = jpeg_frames(torch, np, RUN_VAL, 4, dev)
    t_data = time.perf_counter() - t_phase
    concat = ConcatDataset([train])
    pad = probe_pad_size([train])
    check(pad == LOADER_SRC, f"the probe pads {LOADER_SRC}^2 frames to {pad}")
    tags = {Tag.POSE_WITH_LANDMARKS: 0}

    def loader(num_workers, worker_type):  # each with its own sampler: a sampler's iteration advances its state
        sampler = make_concat_dataset_item_sampler(concat, [1.0], seed=3)  # the training CLI's sampler
        return FusedBatchLoader(concat, lambda i: Tag.POSE_WITH_LANDMARKS, tags, sampler, B, pad,
                                num_workers=num_workers, worker_type=worker_type, shared_memory=True)

    # the first batches of 4 process workers and of 1 thread worker against packing the same plans here
    plans = list(itertools.islice(plan_batches(concat, lambda i: Tag.POSE_WITH_LANDMARKS, tags,
                                               make_concat_dataset_item_sampler(concat, [1.0], seed=3), B),
                                  LOADER_CHECK_BATCHES))
    want = []
    for p in plans:
        samples = []
        for gi in p.indices:
            s = train[gi]
            s["image"] = s["image"].decode()
            samples.append(s)
        want.append(pack_fused_batch(samples, p.tag_ids, pad, p.weights))
    for workers, kind in ((LOADER_WORKERS, "process"), (1, "thread")):
        source = loader(workers, kind)
        it = iter(source)
        t0 = time.perf_counter()
        got = list(itertools.islice(it, LOADER_CHECK_BATCHES))
        first_s = time.perf_counter() - t0
        if kind == "process":
            # the loader alone on the same workers: once the queues are full, take what they hold (per worker its
            # queue, a blocked put and the batch in the making), then time LOADER_ALONE_BATCHES batches at the rate
            # the workers make them
            time.sleep(2.0)
            for _ in range(workers * (max(2, source.prefetch // workers) + 2)):
                next(it)
            t0 = time.perf_counter()
            for _ in range(LOADER_ALONE_BATCHES):
                next(it)
            alone_bps = LOADER_ALONE_BATCHES / (time.perf_counter() - t0)
            host_alone = alone_bps * B
            print(f"loader alone ({LOADER_WORKERS} process workers, {os.cpu_count()} host cores, {pad}^2 JPEG q95, "
                  f"batch {B}): {alone_bps:.2f} batches/s, {alone_bps * B:.1f} images/s over {LOADER_ALONE_BATCHES} "
                  f"batches (the first {LOADER_CHECK_BATCHES} took {first_s:.2f} s, worker start-up included) on {smi}")
        it.close()
        check(len(got) == LOADER_CHECK_BATCHES, f"{kind} workers gave {len(got)} batches")
        for b, (x, y) in enumerate(zip(got, want)):
            differ = [k for k in y if x[k].shape != y[k].shape or not np.array_equal(x[k], y[k])]
            check(set(x) == set(y) and not differ, f"{workers} {kind} worker(s), batch {b}: {differ} differ")
        check(not mp.active_children(), f"{len(mp.active_children())} worker processes outlived their iterator")
    print(f"loader: the first {LOADER_CHECK_BATCHES} batches of {LOADER_WORKERS} process workers (shared memory) "
          f"and of 1 thread worker equal, field for field, packing the same plans in this process after a cv2 decode "
          f"({B} x {pad}^2 JPEG frames)")

    opts = LossOptions(epochs=RUN_EPOCHS, with_nll_loss=True, with_pointhead=True, with_roi_train=True, enable_6drot=True)
    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                 enable_6drot=True, dtype=torch.bfloat16)
    cfg = TrainerConfig(batchsize=B, epochs=RUN_EPOCHS, samples_per_epoch=RUN_SAMPLES_PER_EPOCH, swa_start_epoch=1,
                        aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
    trainer = PoseTrainer(model, setup_losses(opts, [Tag.POSE_WITH_LANDMARKS]), cfg, LABEL_CATEGORIES, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    validation = FusedValidation(trainer, val, batchsize=2 * B)
    untrained_loss = float(validation.evaluate(0)["loss"])
    waits, streams = [], []

    def batches(start):
        stream = device_prefetch(loader(LOADER_WORKERS, "process").iterate(start), dev, size=2)
        streams.append(stream)

        def timed():  # the training thread's wait in next() on the prefetcher
            while True:
                t = time.perf_counter()
                try:
                    batch = next(stream)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - t) * 1e3)
                yield batch

        return timed()

    outdir = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    steps_per_epoch = cfg.steps_per_epoch
    try:
        with k1_captured(K1, lambda skip, n: not skip and n % steps_per_epoch == 0) as train_crops, \
                wrapper_captured(K2, "equalize", steps_per_epoch) as equalized, \
                wrapper_captured(K3, "add_gaussian_noise", steps_per_epoch) as noised:
            torch.cuda.synchronize()
            ext.reset_launch_counts()
            t_run = time.perf_counter()
            state, records = run_training(trainer, state, batches, validation, outdir, torch.Generator().manual_seed(7))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = dict(ext.LAUNCHES)
        for stream in streams:
            stream.close()
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    check(not mp.active_children(), f"{len(mp.active_children())} loader workers outlived the run")
    steps = RUN_EPOCHS * steps_per_epoch
    check(state.step == steps and len(waits) == steps, f"step {state.step}, {len(waits)} batches taken")
    for r in records:
        bad = [k for k, v in r["train_metrics"].items() if not math.isfinite(v)]
        check(not bad and math.isfinite(r["val_loss"]), f"loader run epoch {r['epoch']}: non-finite {bad or 'val'}")
    final_loss = records[-1]["val_loss"]
    check(final_loss < untrained_loss, f"validation loss {final_loss} is not below the untrained {untrained_loss}")
    check(launches["gaussian_noise"] == steps and launches["equalize"] >= 1 and launches["warp_roi_rotate"] ==
          steps + RUN_EPOCHS * len(validation._batches), f"loader run launches {launches}")
    check(len(train_crops) == RUN_EPOCHS, f"{len(train_crops)} training crops kept, not {RUN_EPOCHS}")
    for images, *_ in train_crops:
        check(tuple(images.shape) == (B, pad, pad), f"loader run K1 at {tuple(images.shape)}")
    errs = k2_k3_against_plain(torch, K2, K3, equalized, noised, "loader run")
    errs["warp_roi_rotate"] = k1_against_plain(K1, train_crops, "loader run's crop")
    del train_crops, equalized, noised
    later = sorted(waits[1:])
    for r in records:
        print(f"loader run epoch {r['epoch'] + 1}/{RUN_EPOCHS}: {r['steps']} steps in {r['train_s'] * 1e3:.1f} ms, "
              f"{r['images_per_s']:.1f} images/s ({r['sustained_images_per_s']:.1f} sustained since step 2); "
              f"validation loss {r['val_loss']:.4f} on {smi}")
    print(f"loader run: {steps} steps of batch {B} from {LOADER_WORKERS} process workers through device_prefetch; "
          f"the training thread waited in next() median {statistics.median(later):.3f} ms, p90 "
          f"{later[int(0.9 * (len(later) - 1))]:.3f} ms, max {later[-1]:.3f} ms a step after the first (first "
          f"{waits[0]:.1f} ms, worker start-up included); validation loss {untrained_loss:.4f} -> {final_loss:.4f}; "
          f"K1 at the run's crops max |kernel - plain| {errs['warp_roi_rotate']:.3e} gray; launches {launches}; "
          f"data {t_data:.2f} s, run {run_s:.2f} s, phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, errs, dict(train=train, val=val, pad=pad, want=want, host_alone=host_alone)


def cli_phase(np, smi):
    """Phase 12b: the training and eval CLIs as processes over a pose file
    in a temporary `$DATADIR`, where h5py imports."""
    try:
        import h5py  # noqa: F401 - the probe: the CLIs read HDF5 files
    except ImportError:
        print("phase 12b: not run, h5py does not import on this host; the CLIs over HDF5 are held on the CPU by "
              "tests/test_torch_cli.py")
        return
    from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset

    t_phase = time.perf_counter()
    datadir = tempfile.mkdtemp(prefix="chip_smoke_datadir_")
    try:
        write_synthetic_pose_dataset(os.path.join(datadir, "aflw2k.h5"), CLI_N, CLI_SRC, seed=3)
        env = dict(os.environ, DATADIR=datadir, PYTHONPATH=ROOT)
        outdir = os.path.join(datadir, "out")
        runs = [
            ["train_poseestimator", "--ds", "aflw2k", "--epochs", "1", "--samples-per-epoch", "1024", "--outdir",
             outdir],
            ["evaluate_pose_network", os.path.join(outdir, "NetworkWithPointHead_mobilenetv1", "best.ckpt"),
             "--ds", "aflw2k3d"],
        ]
        for args in runs:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", f"neuralnet_tracker_traincode_torch.scripts.{args[0]}"]
                                 + args[1:], env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
            tail = "\n".join(res.stdout.strip().splitlines()[-6:])
            check(res.returncode == 0, f"{args[0]} exited {res.returncode}: {res.stderr[-3000:]}")
            print(f"phase 12b: {args[0]} exited 0 in {time.perf_counter() - t0:.1f} s; its last lines:\n{tail}")
    finally:
        shutil.rmtree(datadir, ignore_errors=True)
    print(f"phase 12b: {time.perf_counter() - t_phase:.1f} s on {smi}")


def export_phase(torch, np, dev, smi, ckpt, samples, localizer):
    """Phase 13: export and the ONNX runtime on the card, on phase 7's
    `best.ckpt` (a copy at `ckpt`) and its validation `samples`, and phase
    10's trained `localizer`."""
    from neuralnet_tracker_traincode_torch.eval.predictor import CheckpointPoseNetwork, OnnxPoseNetwork, Predictor
    from neuralnet_tracker_traincode_torch.eval.report import RoiConfig, TableBuilder, add_report_row
    from neuralnet_tracker_traincode_torch.export import onnx_export as E
    from neuralnet_tracker_traincode_torch.export.onnx_conformance import validate_model
    from neuralnet_tracker_traincode_torch.export.onnx_run import TorchOnnxSession
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.models.io import load_posenet, save_model
    from neuralnet_tracker_traincode_torch.scripts.export_model import eval_crop_batches, max_errors, output_errors

    t_phase = time.perf_counter()
    outdir = os.path.dirname(ckpt)
    torch.cuda.synchronize()
    ext.reset_launch_counts()
    model = load_posenet(ckpt)
    check(model.enable_6drot and model.enable_point_head and model.enable_uncertainty, "best.ckpt is not phase 7's")
    # the eval crops of the frames in chunks of 128 (NHWC) for the checks; of 32 for the calibration, as the CLI
    chunks = [c.permute(0, 2, 3, 1).contiguous() for c in eval_crop_batches(samples, S, dev, len(samples), EXPORT_CHUNK)]
    t0 = time.perf_counter()
    files = {"opentrack": E.build_posenet_onnx(model), "full": E.build_posenet_onnx(model, outputs="full"),
             "fp16": E.build_posenet_onnx(model, fp16=True)}
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranges = E.calibrate_conv_ranges(files["opentrack"], eval_crop_batches(samples, S, dev, len(samples)), dev)
    calib_s = time.perf_counter() - t0
    files["int8"] = E.build_posenet_onnx(model, quant_ranges=ranges)
    tolerance = {"opentrack": 1e-4, "full": 1e-4, "fp16": 5e-2}
    x_cli = torch.from_numpy(np.random.RandomState(0).rand(1, S, S, 1).astype(np.float32) - 0.5).to(dev)
    for name, blob in files.items():
        decoded = validate_model(blob)
        sess = TorchOnnxSession(blob, dev)
        full = name == "full"
        worst = {}
        for x in chunks:
            for k, e in output_errors(model, sess, x, full, quat_sign_free=True).items():
                worst[k] = max(worst.get(k, 0.0), e)
        # the card's run against the same executor on the CPU (the plain semantics), on the first chunk
        x = chunks[0].permute(0, 3, 1, 2)
        on_cpu = TorchOnnxSession(blob, "cpu").run(None, {"x": x.cpu()})
        card_cpu = max(max_errors(dict(zip(sess.output_names, sess.run(None, {"x": x}))),
                                  dict(zip(sess.output_names, on_cpu)), quat_sign_free=True).values())
        if name == "int8":
            # the JAX package's PTQ scheme (per-tensor activations, min/max ranges; the file is byte-equal to its
            # exporter's) errs above the export CLI's 2e-1 on this trained network, on the crops and on the CLI's
            # random input alike (PERF.md): both are printed, not held
            cli = output_errors(model, sess, x_cli)
            check(all(math.isfinite(e) for e in list(cli.values()) + list(worst.values())), f"int8: {cli}, {worst}")
            gated = {}
            what = ("on the export CLI's random input: " + ", ".join(f"{k} {e:.2e}" for k, e in cli.items())
                    + f"; over {len(samples)} eval crops in chunks of {EXPORT_CHUNK}, informational too")
        else:
            gated = worst
            what = f"over {len(samples)} eval crops in chunks of {EXPORT_CHUNK} (tolerance {tolerance[name]})"
        check(all(math.isfinite(e) and e <= tolerance[name] for e in gated.values()),
              f"{name} file against the eager network: {gated} (tolerance {tolerance.get(name)})")
        with open(os.path.join(outdir, f"{name}.onnx"), "wb") as f:
            f.write(blob)
        print(f"export {name}: {len(blob)} bytes, {len(decoded.graph.nodes)} nodes, conformant; max |file - eager| "
              f"{what} (quaternions up to sign): " + ", ".join(f"{k} {e:.2e}" for k, e in worst.items())
              + f"; card against the CPU executor {card_cpu:.2e} ({EXPORT_CHUNK} crops) on {smi}")

    # the evaluation table from the full file against the checkpoint's, and the same row on a second pass
    nets = {"best.ckpt": CheckpointPoseNetwork(model, dev),
            "full.onnx": OnnxPoseNetwork(os.path.join(outdir, "full.onnx"), dev)}
    rows, stages = {}, {}
    for name, net in nets.items():
        predictor = Predictor(net, RoiConfig().expansion_factor, device=dev)
        stages[name] = {}
        rows[name] = add_report_row(TableBuilder(), predictor, samples, name, "phase 7 validation", RoiConfig(),
                                    stage_ms=stages[name])
        if name == "full.onnx":
            again = add_report_row(TableBuilder(), predictor, samples, name, "phase 7 validation", RoiConfig())
            check(json.dumps(again) == json.dumps(rows[name]), f"the ONNX row differs on a second pass: {again}")
    (geo, nme), (geo_c, nme_c) = ((rows[n][5], rows[n][8]) for n in ("full.onnx", "best.ckpt"))
    check(abs(geo - geo_c) <= 0.01 and abs(nme - nme_c) <= 0.01,
          f"ONNX row geodesic {geo}, NME3d {nme}; checkpoint row {geo_c}, {nme_c}")
    forward = {n: statistics.median(v["forward_backtransform_ms"]) for n, v in stages.items()}

    # phase 10's localizer
    loc = copy.deepcopy(localizer).float()
    loc.dtype = torch.float32
    blob = E.build_localizer_onnx(loc)
    decoded = validate_model(blob)
    x = torch.rand((LOC_B, 224, 288, 1), generator=torch.Generator().manual_seed(13)).to(dev) - 0.5
    loc_err = output_errors(loc, TorchOnnxSession(blob, dev), x)["logit_box"]
    check(loc_err <= 1e-4, f"the localizer's file against its eager forward: {loc_err}")
    loc_ckpt = os.path.join(outdir, "localizer.ckpt")
    save_model(loc, None, loc_ckpt)
    print(f"export localizer: {len(blob)} bytes, {len(decoded.graph.nodes)} nodes, conformant; max |file - eager| "
          f"{loc_err:.2e} on {LOC_B} random inputs (tolerance 1e-4) on {smi}")
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)

    # the export CLI as processes on the card, each with its own parity check
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {"pose network": [ckpt, "--output", os.path.join(outdir, "cli.onnx")],
            "localizer": [loc_ckpt, "--localizer", "--output", os.path.join(outdir, "cli_localizer.onnx")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", "neuralnet_tracker_traincode_torch.scripts.export_model"] + a,
                                 env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, a in runs.items()}
    try:
        outs = {k: proc.communicate(timeout=300)[0] for k, proc in procs.items()}
    finally:
        for proc in procs.values():
            proc.kill()
    for k, out in outs.items():
        check(procs[k].returncode == 0, f"export_model ({k}) exited {procs[k].returncode}: {out[-3000:]}")
        check("Parity check passed." in out, f"export_model ({k}) printed no parity result: {out[-3000:]}")
    cli_s = time.perf_counter() - t0
    pseudo_labels_phase(np, dev, outdir, env)

    print(f"export: Predictor rows, full.onnx against best.ckpt over {len(samples)} frames: geodesic {geo:.4f} / "
          f"{geo_c:.4f} deg, NME3d {nme:.4f} / {nme_c:.4f} %, the ONNX row bit-equal on a second pass; Predictor "
          f"forward_backtransform ms per chunk of {EXPORT_CHUNK} (median of {len(stages['full.onnx']['crop_ms'])} "
          f"chunks): full.onnx {forward['full.onnx']:.2f}, best.ckpt {forward['best.ckpt']:.2f}; the export CLI "
          f"(pose network and localizer, two processes at once) exited 0 with its parity check in {cli_s:.1f} s; "
          f"build {build_s:.2f} s (3 files), calibration {calib_s:.2f} s; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches


def pseudo_labels_phase(np, dev, outdir, env):
    """Phase 13, last: the pseudo-label CLI as a process on a quaternion
    network's `--full` file over an HDF5 file, where h5py imports."""
    try:
        import h5py
    except ImportError:
        print("export: the pseudo-label CLI not run, h5py does not import on this host; it is held on the CPU by "
              "tests/test_torch_cli.py")
        return
    import torch

    from neuralnet_tracker_traincode_torch.data.synthetic import write_synthetic_pose_dataset
    from neuralnet_tracker_traincode_torch.export.onnx_export import build_posenet_onnx
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead

    net = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True)  # the pseudo-labels need quaternions
    net.init_weights(torch.Generator().manual_seed(17))
    path, data = os.path.join(outdir, "quat_full.onnx"), os.path.join(outdir, "label.h5")
    with open(path, "wb") as f:
        f.write(build_posenet_onnx(net, outputs="full"))
    write_synthetic_pose_dataset(data, RUN_VAL, RUN_SRC, seed=4, device=dev)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "neuralnet_tracker_traincode_torch.scripts.add_pose_pseudolabels",
                          data, "-c", path, "--overwrite", "--device", dev.type], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"add_pose_pseudolabels exited {res.returncode}: {res.stderr[-3000:]}")
    with h5py.File(data, "r") as f:
        quats = f["quats"][...]
    check(quats.shape == (RUN_VAL, 4) and np.allclose(np.linalg.norm(quats, axis=-1), 1.0, atol=1e-4),
          f"pseudo-labels: quaternions {quats.shape}")
    print(f"export: the pseudo-label CLI exited 0 in {time.perf_counter() - t0:.1f} s over {RUN_VAL} frames")


def host_kept(batch):
    """`batch` (tensors on the card) with host copies of its fields, as
    `device_prefetch_stacked` keeps them: a step's host part then plans K1
    without waiting for the card."""
    from neuralnet_tracker_traincode_torch.data.loader import StackedBatch

    return StackedBatch(batch, {k: v.cpu() for k, v in batch.items()})


def state_snapshot(trainer, state):
    """Copies of every tensor a step changes (parameters, buffers, Adam moments and count)."""
    return [t.detach().clone() for t in trainer._state_tensors(state)]


def state_restore(torch, trainer, state, snapshot):
    with torch.no_grad():
        for t, s in zip(trainer._state_tensors(state), snapshot):
            t.copy_(s)


def max_diff(torch, a, b):
    """(bit-equal, largest |a - b|) over two lists of tensors."""
    equal, d = True, 0.0
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            equal = False
            d = max(d, float((x.double() - y.double()).abs().max()))
    return equal, d


def eager_block(torch, trainer, state, batches, W, seed):
    """`train_step` over `batches` from a generator seeded `seed`: the
    metrics (steps, names) and ms per step (CUDA events around the calls)."""
    gen = torch.Generator().manual_seed(seed)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rows = []
    a.record()
    for batch in batches:
        state, m = trainer.train_step(state, batch, W, generator=gen)
        rows.append(torch.stack([m[n] for n in m]))
    b.record()
    b.synchronize()
    return torch.stack(rows), a.elapsed_time(b) / len(batches)


def graph_block(torch, trainer, state, groups, W, seed):
    """`train_step_multi` over the stacked `groups`: the metrics (steps,
    names) and ms per step of the calls after the first (which captures)."""
    gen = torch.Generator().manual_seed(seed)
    rows, times = [], []
    for group in groups:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trainer.train_step_multi(state, group, W, generator=gen)
        b.record()
        rows.append(torch.stack([m[n] for n in m], -1))
        times.append((a, b, len(group["tag_id"])))
    torch.cuda.synchronize()
    return torch.cat(rows), statistics.mean(a.elapsed_time(b) / k for a, b, k in times[1:])


def against_eager(torch, trainer, state, singles, groups, W, what):
    """From one saved state: the eager steps twice, then the graph's
    replays over the same batches and draws. Every metric, parameter,
    buffer, Adam moment and the count must be bit-equal to the first eager
    run's, or, where the two eager runs differ, within their difference (the
    floor). Leaves the state as it found it. Returns the eager runs'
    floor (0 when bit-equal), the graph's largest difference, ms per step
    eager and graph, the kernel launches of the graph's run and the metrics
    (steps, names) of the first eager run and of the graph's run."""
    from neuralnet_tracker_traincode_torch.kernels import ext

    saved = state_snapshot(trainer, state)
    runs, ms = [], []
    for kind in ("eager", "eager", "graph"):
        state_restore(torch, trainer, state, saved)
        torch.cuda.synchronize()
        if kind == "graph":
            ext.reset_launch_counts()
            metrics, t = graph_block(torch, trainer, state, groups, W, 7)
            launches = dict(ext.LAUNCHES)
        else:
            metrics, t = eager_block(torch, trainer, state, singles, W, 7)
        runs.append([metrics] + state_snapshot(trainer, state))
        ms.append(t)
    state_restore(torch, trainer, state, saved)
    eager_equal, floor = max_diff(torch, runs[0], runs[1])
    graph_equal, diff = max_diff(torch, runs[0], runs[2])
    check(bool(torch.isfinite(runs[2][0]).all()), f"{what}: non-finite metrics through the graph")
    if eager_equal:
        check(graph_equal, f"{what}: the graph's steps differ from the eager steps by up to {diff}")
    else:
        check(diff <= floor, f"{what}: the graph differs from the eager steps by {diff}, above the eager floor {floor}")
    return floor, diff, ms[1], ms[2], launches, runs[0][0], runs[2][0]


def flagship_trainer(torch, dev, config="mobilenetv1", args=None, face=False, parallel=None):
    """Phase 5's flagship configuration (or another backbone in it): the
    trainer, its state from seed 0 and the criterion's weights at epoch 50."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import LABEL_CATEGORIES
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig

    model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config=config,
                                 backbone_args=args or {}, enable_face_detector=face, dtype=torch.bfloat16)
    cfg = TrainerConfig(batchsize=B, epochs=100, samples_per_epoch=10240,
                        aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
    trainer = PoseTrainer(model, flagship_criterion(), cfg, LABEL_CATEGORIES, device=dev, parallel=parallel)
    return trainer, trainer.init_state(torch.Generator().manual_seed(0)), trainer.weight_matrix(50)


def flagship_batches(torch, np, dev, n, count, K):
    """`count` synthetic batches of `n` on the card (seeds 100, 101, ...) with
    their host copies, and the same stacked in groups of K."""
    singles = [host_kept({k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(np, n, 100 + i).items()})
               for i in range(count)]
    groups = [host_kept({k: torch.stack([b[k] for b in singles[j:j + K]]) for k in singles[0]})
              for j in range(0, count, K)]
    return singles, groups


def k1_plan_sizes(torch, trainer, batch, smi):
    """K1 at one step's own inputs with the plan read back, the step's
    rounded host plan and a plan for |scale| 2 larger: are the crops equal?"""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import (
        augment_batch_for_training,
        sample_augmentation_parameters,
    )
    from neuralnet_tracker_traincode_torch.kernels import warp as K1

    cfg = trainer.config.aug
    aug = sample_augmentation_parameters(torch.Generator().manual_seed(3), B, cfg)
    plan = trainer.prepare_step(batch, aug_params=aug).plan
    labels = {k: v for k, v in batch.items() if k not in ("image", "param_index", "tag_id", "dataset_weight")}
    with k1_captured(K1, lambda skip, n: True) as captured:
        augment_batch_for_training(batch["image"], labels, trainer.categories, cfg, params=aug,
                                   param_index=batch["param_index"], device=batch["image"].device, k1_plan=plan)
    (images, view_roi, angles, out_size, theta, skip, out), = captured
    cs = K1.canvas_size(out_size, theta)
    p = K1.warp_params(view_roi, angles, out_size, cs)
    max_sy, max_sx = p[:, [1, 3]].abs().amax(0).tolist()
    exact = K1.launch_plan(images.shape[2], cs, True, max_sy, max_sx)
    larger = K1.rounded_plan(images.shape[2], cs, True, max_sy + 2.0, max_sx + 2.0)
    crops = {name: K1.warp_roi_rotate(images, view_roi, angles, out_size, theta, plan=pl)
             for name, pl in (("read back", None), ("rounded", plan), ("larger", larger))}
    equal = {name: torch.equal(c, crops["read back"]) for name, c in crops.items()}
    print(f"multistep: K1 at a step's own inputs, |scale| up to {max_sy:.3f} / {max_sx:.3f}: plan read back {exact}, "
          f"rounded host plan {plan}, larger {larger}; crops bit-equal to the read-back plan's: {equal} on {smi}")
    check(plan.taps_x >= exact.taps_x and plan.taps_y >= exact.taps_y, f"the host plan {plan} is below {exact}")
    return all(equal.values())


def multistep_phase(torch, np, dev, smi, profile=False):
    """Phase 14 (a) and (b): the graph's replays against eager steps at the
    flagship configuration and with the other backbones; timing; the
    device part under `set_sync_debug_mode("error")`."""
    from neuralnet_tracker_traincode_torch.train.profiling import profile_steps

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()

    def make_trainer(config="mobilenetv1", args=None, face=False):
        return flagship_trainer(torch, dev, config, args, face)

    def batches(n, count, K):
        return flagship_batches(torch, np, dev, n, count, K)

    def graphs_line(trainer):
        return "; ".join(f"{g.K} steps of batch {len(g.batch['tag_id'][0])}: capture {g.capture_s:.2f} s, "
                         f"instantiate {g.instantiate_s:.3f} s, pool {g.pool_bytes / 2**20:.0f} MB"
                         for g in trainer._graphs.values())

    # (a) the flagship configuration, batch 64: 16 eager steps twice, then 2 replays of K = 8
    trainer, state, W = make_trainer()
    singles, groups = batches(B, 2 * MS_K, MS_K)
    saved = state_snapshot(trainer, state)
    trainer.train_step(state, singles[0], W, generator=torch.Generator().manual_seed(1))  # first calls at these shapes
    state_restore(torch, trainer, state, saved)
    floor, diff, _, graph_ms, launches, eager_metrics, graph_metrics = against_eager(
        torch, trainer, state, singles, groups, W, "flagship, K=8")
    flagship = dict(eager_metrics=eager_metrics, graph_metrics=graph_metrics, graph_ms=graph_ms,
                    capture_s=trainer.graph_stats["capture_s"])
    warm = trainer.graph_stats["warmup_steps"]
    steps = 2 * MS_K + warm
    check(launches["warp_roi_rotate"] == steps and launches["gaussian_noise"] == steps
          and launches["equalize"] == 4 * steps and launches["gaussian_noise_from_bits"] == 0,
          f"graph run launches {launches} in {2 * MS_K} replayed steps and {warm} warm-up steps")
    print(f"multistep (a) flagship, batch {B}, K={MS_K}: 2 replays against 16 eager steps from one state: "
          + ("eager bit-equal run to run; " if floor == 0 else f"eager run to run differs by up to {floor:.3e}; ")
          + ("graph bit-equal to eager in every metric, parameter, buffer, Adam moment and the count"
             if diff == 0 else f"graph within {diff:.3e} of eager")
          + f"; launches {launches} ({warm} of each step's launches are the warm-up's, eager on a side stream); "
          f"{graphs_line(trainer)} on {smi}")
    plan_equal = k1_plan_sizes(torch, trainer, singles[0], smi)

    # one eager device part under the sync debug mode: no sync and no pageable copy
    inputs = trainer.prepare_step(singles[1], generator=torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.device_step(state, inputs, W)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    state_restore(torch, trainer, state, saved)
    print(f"multistep: one eager device part ran under torch.cuda.set_sync_debug_mode('error') on {smi}")

    # ms per step, eager / graph / graph / eager, 10 replays' worth each, at batch 64 and 128
    timing = {}
    for n in (B, 2 * B):
        if n != B:
            singles, groups = batches(n, 2 * MS_K, MS_K)
        gen = torch.Generator().manual_seed(5)
        i = [0]

        def eager():
            trainer.train_step(state, singles[i[0] % len(singles)], W, generator=gen)
            i[0] += 1

        def graph():
            trainer.train_step_multi(state, groups[i[0] % len(groups)], W, generator=gen)
            i[0] += 1

        graph()  # captures at batch 128
        eager()
        rows = []
        for kind in ("eager", "graph", "graph", "eager"):
            calls = MS_TIMED_REPLAYS * (MS_K if kind == "eager" else 1)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                (eager if kind == "eager" else graph)()
            b.record()
            b.synchronize()
            rows.append((kind, a.elapsed_time(b) / (MS_TIMED_REPLAYS * MS_K)))
        timing[n] = rows
        print(f"multistep timing, batch {n}: ms per step " + ", ".join(f"{k} {v:.3f}" for k, v in rows)
              + f" ({MS_TIMED_REPLAYS} replays of K={MS_K} or {MS_TIMED_REPLAYS * MS_K} eager steps each, CUDA "
              f"events) on {smi}")
        if profile:
            print(f"profile (multistep graph, batch {n}): "
                  + json.dumps(profile_steps(graph, 3, steps_per_call=MS_K)))
    print(f"multistep graphs: {graphs_line(trainer)}; all {trainer.graph_stats} on {smi}")
    del trainer, state, groups

    # (b) the other backbones: 2 replays of K = 4 against 8 eager steps
    singles, groups = batches(B, 2 * MS_BACKBONE_K, MS_BACKBONE_K)
    backbone_ms = {}
    for config, args, face in MS_BACKBONES:
        trainer, state, W = make_trainer(config, args, face)
        saved = state_snapshot(trainer, state)
        trainer.train_step(state, singles[0], W, generator=torch.Generator().manual_seed(1))
        state_restore(torch, trainer, state, saved)
        floor, diff, eager_ms, graph_ms, *_ = against_eager(torch, trainer, state, singles, groups, W,
                                                            f"{config}, K={MS_BACKBONE_K}")
        backbone_ms[config] = (eager_ms, graph_ms)
        print(f"multistep (b) {config} {args or ''}{' + face detector' if face else ''}: 2 replays of "
              f"K={MS_BACKBONE_K} against {2 * MS_BACKBONE_K} eager steps: "
              + ("eager bit-equal run to run, " if floor == 0 else f"eager run to run within {floor:.3e}, ")
              + ("graph bit-equal" if diff == 0 else f"graph within {diff:.3e}")
              + f"; ms per step eager {eager_ms:.3f}, graph {graph_ms:.3f}; {graphs_line(trainer)} on {smi}")
        del trainer, state
    print(f"multistep (a)+(b): phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, timing, backbone_ms, plan_equal, flagship


def multistep_run_phase(torch, np, dev, smi, run):
    """Phase 14 (c): phase 7's run through `run_training(steps_per_dispatch=8)`,
    the first block of each epoch rerun eagerly on a second trainer from the
    same state, generator and batches, and held equal; in the rerun K1, K2
    and K3 against their plain versions."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.loader import (
        LABEL_CATEGORIES,
        iterate_fused_batches,
        pack_fused_batch,
        stack_batches,
    )
    from neuralnet_tracker_traincode_torch.data.sampling import ConcatDataset, make_concat_dataset_item_sampler
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.posenet import NetworkWithPointHead
    from neuralnet_tracker_traincode_torch.train.checkpointing import load_train_state
    from neuralnet_tracker_traincode_torch.train.loop import PoseTrainer, TrainerConfig
    from neuralnet_tracker_traincode_torch.train.run import LossOptions, run_training, setup_losses
    from neuralnet_tracker_traincode_torch.train.validation import FusedValidation

    torch.backends.cudnn.allow_tf32 = True  # as in phase 7
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    opts = LossOptions(epochs=RUN_EPOCHS, with_nll_loss=True, with_pointhead=True, with_roi_train=True, enable_6drot=True)

    def make_trainer():  # phase 7's
        model = NetworkWithPointHead(enable_point_head=True, enable_uncertainty=True, config="mobilenetv1",
                                     enable_6drot=True, dtype=torch.bfloat16)
        cfg = TrainerConfig(batchsize=B, epochs=RUN_EPOCHS, samples_per_epoch=RUN_SAMPLES_PER_EPOCH, swa_start_epoch=1,
                            aug=TrainAugmentationConfig(inputsize=S, enable_image_aug=True))
        return PoseTrainer(model, setup_losses(opts, [Tag.POSE_WITH_LANDMARKS]), cfg, LABEL_CATEGORIES, device=dev)

    trainer = make_trainer()
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rerun = make_trainer()
    rerun_state = rerun.init_state(torch.Generator().manual_seed(0))
    validation = FusedValidation(trainer, run["val_frames"], batchsize=2 * B)
    train_frames = run["train_frames"]
    packed = pack_fused_batch(train_frames, [0] * len(train_frames), RUN_SRC)

    def batches(start):  # phase 7's sampler, K batches a group
        sampler = make_concat_dataset_item_sampler(ConcatDataset([train_frames]), [1.0], seed=5)
        return stack_batches(iterate_fused_batches(packed, B, sampler, device=dev, start=start), MS_K)

    steps_per_epoch = trainer.config.steps_per_epoch
    replay = trainer.train_step_multi
    errs = {"warp_roi_rotate": 0.0, "equalize": 0.0, "gaussian_noise": 0.0}
    checked, rerun_s = [], []  # the step of each block rerun, and the host seconds each check took

    def first_block_rerun(state, group, W, aug_params=None, generator=None):
        if state.step % steps_per_epoch:
            return replay(state, group, W, aug_params, generator)
        t_check = time.perf_counter()
        before, gen_state = state_snapshot(trainer, state), generator.get_state()
        block = {k: v.clone() for k, v in group.items()}
        t_replay = time.perf_counter()
        state, m = replay(state, group, W, aug_params, generator)
        t_check += time.perf_counter() - t_replay  # the replay is the run's, the rest the check's
        graph_side = [torch.stack([m[n] for n in m], -1)] + state_snapshot(trainer, state)
        # the same block, eagerly, on the second trainer (its launches are a check's, not the run's)
        counts = dict(ext.LAUNCHES)
        state_restore(torch, rerun, rerun_state, before)
        g = torch.Generator()
        g.set_state(gen_state)
        rows, st = [], rerun_state
        with k1_captured(K1, lambda skip, n: n == 0) as crops, wrapper_captured(K2, "equalize", 4) as equalized, \
                wrapper_captured(K3, "add_gaussian_noise", 10**9) as noised:
            for k in range(MS_K):
                st, mk = rerun.train_step(st, {n: v[k] for n, v in block.items()}, W, generator=g)
                rows.append(torch.stack([mk[n] for n in mk]))
            torch.cuda.synchronize()
        equal, d = max_diff(torch, graph_side, [torch.stack(rows)] + state_snapshot(rerun, st))
        check(equal, f"run epoch {state.step // steps_per_epoch}: the graph's first block differs from its eager "
                     f"rerun by up to {d}")
        errs["warp_roi_rotate"] = max(errs["warp_roi_rotate"], k1_against_plain(K1, crops, "multistep run rerun"))
        for k, v in k2_k3_against_plain(torch, K2, K3, equalized, noised, "multistep run rerun").items():
            errs[k] = max(errs[k], v)
        ext.LAUNCHES.update(counts)
        checked.append(state.step)
        rerun_s.append(time.perf_counter() - t_check)
        return state, m

    trainer.train_step_multi = first_block_rerun
    outdir = tempfile.mkdtemp(prefix="chip_smoke_multistep_run_")
    try:
        torch.cuda.synchronize()
        ext.reset_launch_counts()
        t_run = time.perf_counter()
        state, records = run_training(trainer, state, batches, validation, outdir, torch.Generator().manual_seed(7),
                                      steps_per_dispatch=MS_K)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(ext.LAUNCHES)
        steps = RUN_EPOCHS * steps_per_epoch
        check(state.step == steps and len(checked) == RUN_EPOCHS, f"step {state.step}, {len(checked)} blocks rerun")
        for r in records:
            bad = [k for k, v in r["train_metrics"].items() if not math.isfinite(v)]
            check(not bad and math.isfinite(r["val_loss"]), f"epoch {r['epoch']}: non-finite {bad or 'validation loss'}")
        final_loss, untrained_loss = records[-1]["val_loss"], run["untrained_loss"]
        check(final_loss < untrained_loss, f"validation loss {final_loss} is not below the untrained {untrained_loss}")
        fresh = make_trainer()
        resumed, extra = load_train_state(fresh, os.path.join(outdir, "resume.pt"))
        pairs = [(fresh.model.state_dict(), trainer.model.state_dict()), (resumed.opt_state.mu, state.opt_state.mu),
                 (resumed.opt_state.nu, state.opt_state.nu), (resumed.swa_params, state.swa_params),
                 (resumed.swa_buffers, state.swa_buffers)]
        differ = [k for got, want in pairs for k in want if not torch.equal(got[k], want[k])]
        check(not differ and int(resumed.opt_state.count) == int(state.opt_state.count) == steps
              and extra["epoch"] == RUN_EPOCHS - 1, f"the resume file gives back other tensors: {differ[:5]}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    for r, r7, c in zip(records, run["records"], rerun_s):
        s = r["train_s"] - c
        print(f"multistep run epoch {r['epoch'] + 1}/{RUN_EPOCHS}: {r['steps']} steps in {s * 1e3:.1f} ms without the "
              f"{c * 1e3:.1f} ms of the eager rerun's check, {r['steps'] * B / s:.1f} images/s (phase 7, eager, this "
              f"call: {r7['images_per_s']:.1f}); validation loss {r['val_loss']:.4f} (phase 7: {r7['val_loss']:.4f}) "
              f"on {smi}")
    print(f"multistep run (c): {steps} steps in blocks of {MS_K}, validation loss {untrained_loss:.4f} -> "
          f"{final_loss:.4f}; each epoch's first block bit-equal to its eager rerun; the resume file gives back "
          f"every tensor; launches {launches} ({trainer.graph_stats['warmup_steps']} warm-up steps); graphs "
          f"{trainer.graph_stats}; run {run_s:.2f} s, phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return errs


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, ranks: int, port: int):
    """`torchrun`'s variables for rank `rank` of `ranks` on this machine."""
    return {"RANK": str(rank), "WORLD_SIZE": str(ranks), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(ranks),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def reversed_rows(torch, batch, draws):
    """`batch` (on the card, with host copies) and its draws with the rows in
    reverse order: each sample's crop, intensity stages and noise are its
    own, so a step on them differs from one on `batch` only in the order of
    the reductions over the rows."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import draws_for_rows

    rev = torch.arange(B - 1, -1, -1)
    flipped = host_kept({k: v.flip(0) for k, v in batch.items() if k != "param_index"})
    flipped["param_index"] = batch["param_index"]  # arange: each row takes its own (reversed) draws
    flipped.host["param_index"] = flipped["param_index"].cpu()
    d = draws_for_rows(draws, slice(None), rev)
    stage1 = d.stage1._replace(masks=draws.stage1.masks[:, rev], values=draws.stage1.values[:, rev])
    return flipped, d._replace(stage1=stage1, noise=d.noise._replace(sigma=draws.noise.sigma[rev],
                                                                    seeds=draws.noise.seeds[rev]))


def reversed_rows_floor(torch, dev, singles, ref):
    """The relative differences of each step's loss from `ref`'s (phase
    14a's run) of one process stepping eagerly on `singles` with their rows
    reversed (the same draws, reversed): the floor that another order of
    the reductions sets."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import sample_augmentation_parameters

    trainer, state, W = flagship_trainer(torch, dev)
    gen, out = torch.Generator().manual_seed(7), []
    for k, batch in enumerate(singles):
        batch, draws = reversed_rows(torch, batch, sample_augmentation_parameters(gen, B, trainer.config.aug))
        state, m = trainer.train_step(state, batch, W, aug_params=draws)
        out.append(float((m["loss"] - ref[k, 0]).abs() / ref[k, 0].abs()))
    return out


def mu_difference(torch, got, want):
    """Adam's first moments `got` against `want` (dicts of leaves): the norm
    of the difference over all leaves relative to `want`'s. After a first
    step the moment is the clipped gradient times 1 - b1, so this reads the
    gradient."""
    flat = lambda tree: torch.cat([t.detach().double().flatten() for t in tree.values()])  # noqa: E731
    return float((flat(got) - flat(want)).norm() / flat(want).norm())


def first_step_against_one_process(torch, trainer, state, batch, W, what):
    """One eager step of `trainer` (a rank) and of one process on the whole
    batch from the same weights, batch and draws, and for scale, of one
    process on the rows in reverse order (another order of the reductions).
    Per run against the one process: the loss's relative difference, the
    largest BatchNorm-statistics leaf difference (relative), the first
    moment's (`mu_difference`), the share of parameters within 1e-5 and
    the largest parameter difference. Fails
    unless the loss agrees within 1e-3 relative, the statistics within 1e-2
    a leaf, the first moment within DP_MU_LIMIT over all leaves (this reads
    the gradient) and every parameter within 2 lr of the step (Adam moves an
    element whose gradient is rounding noise by up to lr of either sign).
    Leaves `trainer`'s state as it found it; returns the readings, the lr
    and the one process's first moments (on the host)."""
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import sample_augmentation_parameters

    draws = sample_augmentation_parameters(torch.Generator().manual_seed(7), B, trainer.config.aug)
    saved = state_snapshot(trainer, state)
    runs = {}
    for name, (tr, st), (b, d) in (("one", flagship_trainer(torch, trainer.device)[:2], (batch, draws)),
                                   ("reversed", flagship_trainer(torch, trainer.device)[:2],
                                    reversed_rows(torch, batch, draws)),
                                   ("rank", (trainer, state), (batch, draws))):
        st, m = tr.train_step(st, b, W, aug_params=d)
        runs[name] = (tr.model.state_dict(), list(tr.model.parameters()),
                      {k: v.detach().clone() for k, v in st.opt_state.mu.items()}, m)
    lr = trainer.tx.learning_rate(0, "main")
    sd, params, mu, m = runs["one"]
    out = {}
    for name in ("reversed", "rank"):
        got_sd, got_params, got_mu, got_m = runs[name]
        moved = torch.cat([(p.detach() - q.detach()).abs().flatten() for p, q in zip(got_params, params)])
        out[name] = dict(
            loss=float((got_m["loss"] - m["loss"]).abs() / m["loss"].abs()),
            stats=max(float((got_sd[k] - sd[k]).norm() / sd[k].norm()) for k in sd if "running" in k),
            mu=mu_difference(torch, got_mu, mu), share=float((moved <= 1e-5).float().mean()),
            largest=float(moved.max()))
    state_restore(torch, trainer, state, saved)
    r = out["rank"]
    check(r["loss"] <= 1e-3 and r["stats"] <= 1e-2 and r["mu"] <= DP_MU_LIMIT and r["largest"] <= 2 * lr + 1e-6,
          f"{what}: the first step differs from one process: {r} (lr {lr}, first moment limit {DP_MU_LIMIT}); "
          f"one process on the rows reversed: {out['reversed']}")
    return out, lr, {k: v.cpu() for k, v in mu.items()}


def sync_batchnorm_against_torch(torch, dev, dp, what):
    """The port's BatchNorm2d in training with `sync` = `dp`, each rank on
    its rows of a batch of B, against `torch.native_batch_norm`'s autograd
    on the whole batch, at the flagship's first and last BatchNorm inputs
    (`DP_BN_CASES`): the output, the input gradient, the weight and bias
    gradients (summed over the ranks) and the running statistics (flax's:
    the biased variance), each relative to its largest value. Fails above
    `DP_BN_TOL` of the dtype; returns the largest error per dtype."""
    from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d

    rows, worst = dp.rows(B), {}
    for shape, key, layout in DP_BN_CASES:
        dtype, layout = getattr(torch, key), getattr(torch, layout)
        C, g = shape[1], torch.Generator().manual_seed(11)
        x = (torch.randn(shape, generator=g) * 3 + 1).to(dev, dtype).contiguous(memory_format=layout)
        dy = torch.randn(shape, generator=g).to(dev, dtype).contiguous(memory_format=layout)
        weight, bias = (torch.rand(C, generator=g) + 0.5).to(dev), torch.randn(C, generator=g).to(dev)
        xr, wr, br = x.clone().requires_grad_(), weight.clone().requires_grad_(), bias.clone().requires_grad_()
        y_ref, mean, invstd = torch.native_batch_norm(xr, wr, br, None, None, True, 0.0, 1e-5)
        y_ref.backward(dy)
        bn = BatchNorm2d(C).to(dev)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        bn.sync = dp
        xs = x[rows].clone().requires_grad_()
        y = bn(xs)
        y.backward(dy[rows])
        grads = dp.all_reduce_(torch.cat([bn.weight.grad, bn.bias.grad]))
        var = invstd.double().pow(-2) - 1e-5
        pairs = [(y, y_ref[rows]), (xs.grad, xr.grad[rows]), (grads[:C], wr.grad), (grads[C:], br.grad),
                 (bn.running_mean, 0.1 * mean), (bn.running_var, 0.9 + 0.1 * var)]
        err = max(float((a.detach().double() - b.detach().double()).abs().max() / b.detach().double().abs().max())
                  for a, b in pairs)
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= DP_BN_TOL[key], f"{what}: synchronized BatchNorm at {shape} {key} differs from "
              f"torch.native_batch_norm by {err:.3e} (relative to the largest value), above {DP_BN_TOL[key]}")
    return worst


def dp_rank_main(rank: int, port: int, workdir: str):
    """Phase 15 (b), one of two ranks on the one card (a spawned process):
    gloo on CUDA tensors, synchronized BatchNorm against torch's over the
    two ranks, `DP_STEPS` eager flagship steps on its rows of phase 14a's
    batches and draws; K1, K2 and K3 held to their plain versions at the
    first step; writes its metrics, state, first moments after the first
    step, launches, errors and ms per step to `workdir`."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.parallel.distributed import init_from_env

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    ext.extension()
    os.environ.update(rank_env(rank, 2, port))
    dp, dev = init_from_env("cuda:0", backend="gloo")
    try:
        what = f"data parallel (b) rank {rank}"
        bn_errs = sync_batchnorm_against_torch(torch, dev, dp, what)
        trainer, state, W = flagship_trainer(torch, dev, parallel=dp)
        rows = dp.rows(B)
        batches = [{k: v[rows] for k, v in synthetic_batch(np, B, 100 + i).items()} for i in range(DP_STEPS)]
        gen = torch.Generator().manual_seed(7)
        ext.reset_launch_counts()
        with k1_captured(K1, lambda skip, n: True) as crops, wrapper_captured(K2, "equalize", 1) as equalized, \
                wrapper_captured(K3, "add_gaussian_noise", 1) as noised:
            state, m = trainer.train_step(state, batches[0], W, generator=gen)
        rows_of_metrics = [torch.stack([m[n] for n in m])]
        mu = {k: v.cpu() for k, v in state.opt_state.mu.items()}
        errs = dict(k2_k3_against_plain(torch, K2, K3, equalized, noised, what))
        errs["warp_roi_rotate"] = k1_against_plain(K1, crops, what)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for batch in batches[1:]:
            state, m = trainer.train_step(state, batch, W, generator=gen)
            rows_of_metrics.append(torch.stack([m[n] for n in m]))
        b.record()
        b.synchronize()
        torch.save(dict(metrics=torch.stack(rows_of_metrics).cpu(), launches=dict(ext.LAUNCHES), errs=errs,
                        mu=mu, bn_errs=bn_errs,
                        state=[t.cpu() for t in state_snapshot(trainer, state)],
                        ms=a.elapsed_time(b) / (DP_STEPS - 1)), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dp.close()


def data_parallel_phase(torch, np, dev, smi, flagship, timing):
    """Phase 15: data-parallel training (`parallel/distributed.py`) at phase
    5's flagship configuration, (a) one rank over NCCL with synchronized
    BatchNorm forced on (`sync` set on every BatchNorm), K = 8 through the
    CUDA graph, against phase 14a's graph run; (b) two ranks sharing the
    card over gloo, eager, against phase 14a's eager steps. The limits are
    fixed constants (`DP_*`). Returns the kernel launches of (a)'s graph run
    and of (b)'s ranks, summed, and the kernels' largest errors."""
    import multiprocessing as mp

    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d
    from neuralnet_tracker_traincode_torch.parallel.distributed import init_from_env

    torch.backends.cudnn.allow_tf32 = True  # as in phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    singles, groups = flagship_batches(torch, np, dev, B, 2 * MS_K, MS_K)

    # (a) one rank over NCCL, synchronized BatchNorm forced on
    saved_env = {k: os.environ.get(k) for k in rank_env(0, 1, 0)}
    os.environ.update(rank_env(0, 1, free_port()))
    try:
        dp, _ = init_from_env("cuda")
    finally:
        for k, v in saved_env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    try:
        bn_errs = sync_batchnorm_against_torch(torch, dev, dp, "data parallel (a)")
        trainer, state, W = flagship_trainer(torch, dev, parallel=dp)
        for m in trainer.model.modules():  # one rank: PoseTrainer syncs only over several
            if isinstance(m, BatchNorm2d):
                m.sync = dp
        first, lr0, mu_one = first_step_against_one_process(torch, trainer, state, singles[0], W,
                                                            "data parallel (a)")
        saved = state_snapshot(trainer, state)
        inputs = trainer.prepare_step(singles[1], generator=torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer.device_step(state, inputs, W)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        state_restore(torch, trainer, state, saved)
        ext.reset_launch_counts()
        with k1_captured(K1, lambda skip, n: n == 0) as crops, wrapper_captured(K2, "equalize", 10**9) as equalized, \
                wrapper_captured(K3, "add_gaussian_noise", 10**9) as noised:
            metrics, _ = graph_block(torch, trainer, state, groups, W, 7)
        launches_a = dict(ext.LAUNCHES)
        warm = trainer.graph_stats["warmup_steps"]
        steps = 2 * MS_K + warm
        check(launches_a["warp_roi_rotate"] == steps and launches_a["gaussian_noise"] == steps
              and launches_a["equalize"] == 4 * steps, f"data parallel (a): launches {launches_a} in {steps} steps")
        errs = dict(k2_k3_against_plain(torch, K2, K3, equalized, noised, "data parallel (a)"))
        errs["warp_roi_rotate"] = k1_against_plain(K1, crops, "data parallel (a)")
        ref = flagship["graph_metrics"]
        per_step = ((metrics[:, 0] - ref[:, 0]).abs() / ref[:, 0].abs()).tolist()
        floor = reversed_rows_floor(torch, dev, singles, ref)
        print(f"data parallel (a): the losses' relative differences from phase 14a's graph run, step by step: "
              + " ".join(f"{v:.1e}" for v in per_step) + "; one process eagerly on the rows reversed: "
              + " ".join(f"{v:.1e}" for v in floor) + f" on {smi}")
        loss_rel = max(per_step)
        check(bool(torch.isfinite(metrics).all()) and loss_rel <= DP_LOSS_LIMIT,
              f"data parallel (a): the losses differ from phase 14a's graph run by up to {loss_rel} (relative), "
              f"above {DP_LOSS_LIMIT}")
        gen, i = torch.Generator().manual_seed(5), [0]

        def replay():
            trainer.train_step_multi(state, groups[i[0] % len(groups)], W, generator=gen)
            i[0] += 1

        replay()  # these draws may give another K1 plan, whose graph captures here
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(MS_TIMED_REPLAYS):
            replay()
        b.record()
        b.synchronize()
        dp_ms = a.elapsed_time(b) / (MS_TIMED_REPLAYS * MS_K)
        stats = trainer.graph_stats
        print(f"data parallel (a) one rank over NCCL, synchronized BatchNorm, flagship batch {B}: BatchNorm "
              f"against torch.native_batch_norm " + ", ".join(f"{k} {v:.2e}" for k, v in bn_errs.items())
              + f" (relative); the first eager step against one process (lr {lr0:.3e}): " + "; ".join(
                  f"{name}: loss {r['loss']:.2e}, BatchNorm statistics {r['stats']:.2e} a leaf, first moment "
                  f"{r['mu']:.3e}, {r['share'] * 100:.2f}% of the parameters within 1e-5, largest "
                  f"{r['largest']:.2e}"
                  for name, r in (("one rank", first["rank"]), ("one process, rows reversed", first["reversed"])))
              + f"; 2 replays of "
              f"K={MS_K}: losses within {loss_rel:.2e} (relative) of phase 14a's graph run"
              + (" (bit-equal)" if torch.equal(metrics, ref) else "")
              + f"; one device part ran under set_sync_debug_mode('error'); launches {launches_a} ({warm} warm-up "
              f"steps); capture {stats['capture_s']:.2f} s, instantiate {stats['instantiate_s']:.3f} s; ms per step "
              f"through the graph {dp_ms:.3f} ({MS_TIMED_REPLAYS} replays), phase 14a's "
              + ", ".join(f"{v:.3f}" for k, v in timing[B] if k == "graph") + f" on {smi}")
        del trainer, state
    finally:
        dp.close()

    # (b) two ranks sharing the card over gloo, eager
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=dp_rank_main, args=(r, port, workdir)) for r in range(2)]
        t_b = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=DP_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        check(all(p.exitcode == 0 for p in procs), f"data parallel (b): ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    equal, d = max_diff(torch, ranks[0]["state"] + [ranks[0]["metrics"]], ranks[1]["state"] + [ranks[1]["metrics"]])
    check(equal, f"data parallel (b): the two ranks' parameters, buffers or moments differ by up to {d}")
    ref = flagship["eager_metrics"][:DP_STEPS].cpu()
    loss_rel_b = ((ranks[0]["metrics"][:, 0] - ref[:, 0]).abs() / ref[:, 0].abs()).max().item()
    check(bool(torch.isfinite(ranks[0]["metrics"]).all()) and loss_rel_b <= DP_LOSS_LIMIT,
          f"data parallel (b): the losses differ from one process's by up to {loss_rel_b} (relative), "
          f"above {DP_LOSS_LIMIT}")
    mu_b = mu_difference(torch, ranks[0]["mu"], mu_one)
    check(mu_b <= DP_MU_LIMIT, f"data parallel (b): the first moment after the first step differs from one "
          f"process's by {mu_b} (relative), above {DP_MU_LIMIT}")
    launches = {k: launches_a[k] + sum(r["launches"][k] for r in ranks) for k in launches_a}
    for r in ranks:
        check(r["launches"]["warp_roi_rotate"] == DP_STEPS and r["launches"]["gaussian_noise"] == DP_STEPS
              and r["launches"]["equalize"] == 4 * DP_STEPS, f"data parallel (b): a rank's launches {r['launches']}")
        for k, v in r["errs"].items():
            errs[k] = max(errs[k], v)
    print(f"data parallel (b) two ranks on one card over gloo, {B // 2} rows each, {DP_STEPS} eager steps: BatchNorm "
          f"over the ranks against torch.native_batch_norm " + ", ".join(
              f"{k} {max(r['bn_errs'][k] for r in ranks):.2e}" for k in ranks[0]["bn_errs"])
          + f" (relative); the ranks' parameters, buffers, moments and metrics bit-equal; the first moment after the "
          f"first step {mu_b:.3e} from one process's; losses within {loss_rel_b:.2e} (relative) of phase 14a's one "
          f"process on the same batches and draws; launches per rank {ranks[0]['launches']}; ms per step "
          + ", ".join(f"rank {i} {r['ms']:.3f}" for i, r in enumerate(ranks))
          + f" (two processes share the card, host-staged collectives: not a speed); (b) "
          f"{time.perf_counter() - t_b:.1f} s with the processes' start-up; phase "
          f"{time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, errs


def synthetic_faces(torch, np, n, seed):
    """Ground truth and noisy 2D landmarks, as the JAX package's tests/test_fit_face_model.py makes them: XYZ
    Euler angles within +-35 deg, xy in 100-140 px, size 40-60 px, shape ~ 0.3 N(0, 1), 0.2 px landmark noise,
    ROIs from the landmarks' extent; the keypoints posed by the port's head on the CPU."""
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, PosedDeformableHead
    from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

    rng = np.random.RandomState(seed)
    quats = Rotation.from_euler("XYZ", rng.uniform(-35, 35, (n, 3)), degrees=True).as_quat().astype(np.float32)
    coord = np.concatenate([rng.uniform(100, 140, (n, 2)), rng.uniform(40, 60, (n, 1))], axis=-1).astype(np.float32)
    shape = (rng.randn(n, 50) * 0.3).astype(np.float32)
    with torch.no_grad():
        pts = PosedDeformableHead(DeformableHeadKeypoints())(
            torch.from_numpy(coord), QuatRepr(torch.from_numpy(quats)), torch.from_numpy(shape)).numpy()
    pt2d = pts[..., :2] + rng.randn(n, 68, 2).astype(np.float32) * 0.2
    rois = np.concatenate([pt2d.min(axis=1), pt2d.max(axis=1)], axis=-1).astype(np.float32)
    return dict(quats=quats, coord=coord, pt2d=pt2d, rois=rois)


def rotation_deg(np, a, b):
    """Angle (deg) between the rotations of the quaternion rows of a and b."""
    from scipy.spatial.transform import Rotation

    return np.rad2deg((Rotation.from_quat(a).inv() * Rotation.from_quat(b)).magnitude())


def ellipsoid_mesh(np):
    """A closed latitude-longitude ellipsoid in head-radius units (semi-axes 0.75, 1.0, 0.85): RENDER_LAT - 1
    rings of RENDER_LON vertices and two poles, (V, 3) f32 and (F, 3) int64."""
    lat = np.pi * np.arange(1, RENDER_LAT) / RENDER_LAT
    lon = 2 * np.pi * np.arange(RENDER_LON) / RENDER_LON
    ring = np.stack([np.sin(lat)[:, None] * np.cos(lon), np.cos(lat)[:, None] * np.ones_like(lon),
                     np.sin(lat)[:, None] * np.sin(lon)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]]) * np.array([0.75, 1.0, 0.85])
    R, L, last = RENDER_LAT - 1, RENDER_LON, (RENDER_LAT - 1) * RENDER_LON + 1
    j = np.arange(L)
    tris = [np.stack([np.zeros(L, int), 1 + j, 1 + (j + 1) % L], -1)]
    for r in range(R - 1):
        a, b = 1 + r * L + j, 1 + r * L + (j + 1) % L
        tris += [np.stack([a, a + L, b], -1), np.stack([b, a + L, b + L], -1)]
    tris.append(np.stack([np.full(L, last), 1 + (R - 1) * L + (j + 1) % L, 1 + (R - 1) * L + j], -1))
    return verts.astype(np.float32), np.concatenate(tris).astype(np.int64)


def face_tools_phase(torch, np, dev, smi):
    """Phase 16: the face-model tools. (a) `scripts/fit_face_model.py:fit_face_model` on FIT_N synthetic faces
    on the card at the CLI's defaults: every logged loss finite, the JAX test's recovery limits over all faces,
    and the first FIT_CPU_N faces fitted alone on the CPU against the card's rows (each face's trajectory is
    independent of the others). (b) `vis3d.rasterize_mesh` on a mesh the size of the full BFM at 640 x 480,
    three poses, card against CPU; `FaceRender` on the card through stub head models. No kernel of K1-K3 runs:
    the launch counts, reset before, must read 0 after. Returns them."""
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, PosedDeformableHead
    from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ext.reset_launch_counts()

    # the posed head is full f32 on the card whatever autocast and TF32 are set to
    faces = synthetic_faces(torch, np, 64, FIT_SEED + 1)
    args = [torch.from_numpy(faces[k]).to(dev) for k in ("coord", "quats")] + [torch.randn(64, 50, device=dev)]
    head = PosedDeformableHead(DeformableHeadKeypoints()).to(dev)
    with torch.no_grad():
        want = head(args[0], QuatRepr(args[1]), args[2])
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                got = head(args[0], QuatRepr(args[1]), args[2])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    check(got.dtype == torch.float32 and torch.equal(got, want), "PosedDeformableHead under bf16 autocast and TF32 "
          f"is not its f32 self: {float((got.float() - want).abs().max())}")

    # (a) the fit; the CPU fits the first FIT_CPU_N faces alone meanwhile, in a spawned process
    faces = synthetic_faces(torch, np, FIT_N, FIT_SEED)
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_fit = pool.submit(cpu_reference_fit, faces["pt2d"][:FIT_CPU_N], faces["rois"][:FIT_CPU_N], FIT_STEPS,
                              FIT_LR)
        launches = face_tools_on_the_card(torch, np, dev, smi, faces, cpu_fit)
    print(f"face-model tools: launches {launches}; phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def face_tools_on_the_card(torch, np, dev, smi, faces, cpu_fit):
    """Phase 16 from the fit on: the checks of `face_tools_phase`; returns the kernels' launch counts."""
    from scipy.spatial.transform import Rotation

    from neuralnet_tracker_traincode_torch import vis3d
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.scripts.fit_face_model import fit_face_model

    def timed_fit(steps, timed_from, echo, **kwargs):
        """The fit on the card, and its ms a step by CUDA events recorded where it logs (each log reads the loss
        back, so the device is idle there), from the logged step `timed_from` to the last."""
        events = {}

        def log(line):
            if line.lstrip().startswith("step"):
                events[int(line.split()[1].rstrip(":"))] = torch.cuda.Event(enable_timing=True)
                events[max(events)].record()
            if echo:
                print(f"fit (card): {line.strip()}")

        fit = fit_face_model(faces["pt2d"], faces["rois"], steps=steps, lr=FIT_LR, device=dev, log=log, **kwargs)
        last = max(events)
        return fit, events[timed_from].elapsed_time(events[last]) / (last - timed_from)

    eager, ms_eager = timed_fit(FIT_EAGER_STEPS, FIT_EAGER_TIMED_FROM, False, cuda_graph=False)
    graph, ms_graph = timed_fit(FIT_EAGER_STEPS, FIT_EAGER_TIMED_FROM, False)
    unequal = [k for k in eager if not np.array_equal(eager[k], graph[k])]
    check(not unequal, f"fit: {FIT_EAGER_STEPS} steps through the CUDA graph differ from eager steps in {unequal}")
    print(f"fit (card), {FIT_EAGER_STEPS} steps of {FIT_N} faces: the graph's replays bit-equal to eager steps; "
          f"{ms_eager:.4f} ms a step eager, {ms_graph:.4f} through the graph (steps {FIT_EAGER_TIMED_FROM}-"
          f"{FIT_EAGER_STEPS - 1}), on {smi}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, ms_step = timed_fit(FIT_STEPS, FIT_TIMED_FROM, True)
    fit_s = time.perf_counter() - t0
    check(fit["losses"].shape[0] == 11 and bool(np.isfinite(fit["losses"]).all()),
          f"fit: logged losses {fit['losses'].tolist()}")
    for k, shape in (("quats", (FIT_N, 4)), ("coords", (FIT_N, 3)), ("pt3d_68", (FIT_N, 68, 3)),
                     ("shapeparams", (FIT_N, 50)), ("residual", (FIT_N,))):
        check(fit[k].shape == shape and bool(np.isfinite(fit[k]).all()), f"fit: {k} {fit[k].shape} or not finite")
    rot = rotation_deg(np, fit["quats"], faces["quats"])
    xy = np.linalg.norm(fit["coords"][:, :2] - faces["coord"][:, :2], axis=-1)
    size = np.abs(fit["coords"][:, 2] - faces["coord"][:, 2]) / faces["coord"][:, 2]
    print(f"fit (card) of {FIT_N} faces, {FIT_STEPS} steps at lr {FIT_LR}: recovery mean rotation error "
          f"{rot.mean():.4f} deg (limit {FIT_ROT_LIMIT}), p90 {np.percentile(rot, 90):.4f}, max {rot.max():.4f}; mean "
          f"xy error {xy.mean():.4f} px (limit {FIT_XY_LIMIT}); mean relative size error {size.mean():.5f} (limit "
          f"{FIT_SIZE_LIMIT}); residual mean {fit['residual'].mean():.5f}, p90 "
          f"{np.percentile(fit['residual'], 90):.5f} (roi units)")
    check(rot.mean() < FIT_ROT_LIMIT and xy.mean() < FIT_XY_LIMIT and size.mean() < FIT_SIZE_LIMIT,
          "fit: the recovery of the synthetic poses misses the JAX test's limits")
    print(f"fit (card): {ms_step:.4f} ms a step through the graph (CUDA events, steps {FIT_TIMED_FROM}-"
          f"{FIT_STEPS - 1}), the fit {fit_s:.2f} s with its set-up, capture and read-back, on {smi}")

    # (b) the rasterizer on a mesh of the full BFM's size
    verts, tris = ellipsoid_mesh(np)
    tris_dev = torch.from_numpy(tris).to(dev)
    renders = []
    for axes, angles in RENDER_POSES:
        posed = Rotation.from_euler(axes, angles, degrees=True).apply(verts.astype(np.float64)) * RENDER_SCALE
        posed[:, :2] += (RENDER_W / 2, RENDER_H / 2)
        posed = posed.astype(np.float32)
        v_dev = torch.from_numpy(posed).to(dev)
        color, depth = (a.cpu().numpy() for a in vis3d.rasterize_mesh(v_dev, tris_dev, (RENDER_H, RENDER_W)))
        ccpu, dcpu = (a.numpy() for a in vis3d.rasterize_mesh(posed, tris, (RENDER_H, RENDER_W), device="cpu"))
        cover, cover_cpu = color.any(-1), ccpu.any(-1)
        both = cover & cover_cpu
        dd = float(np.abs(depth[both] - dcpu[both]).max())
        dc = int(np.abs(color.astype(int) - ccpu.astype(int)).max())
        vn = vis3d.estimate_vertex_normals(v_dev, tris_dev).cpu()
        intensity = torch.ones(len(verts), device=dev)
        pix, z, tri, _ = vis3d.rasterize_fragments(v_dev, tris_dev, intensity, RENDER_H, RENDER_W)
        _, ties = vis3d.depth_test(pix, z, tri, RENDER_H * RENDER_W)
        dn = float((vn - vis3d.estimate_vertex_normals(torch.from_numpy(posed), torch.from_numpy(tris))).abs().max())
        check(np.array_equal(cover, cover_cpu), f"render {angles}: coverage differs at "
              f"{int((cover != cover_cpu).sum())} pixels, {ties} of the card's pixels tie in depth")
        check(dd <= 1e-4 and dc <= 1, f"render {angles}: card against CPU depth {dd}, colour {dc} levels")
        check(0.05 < cover.mean() < 0.9, f"render {angles}: coverage {cover.mean()}")

        def render_once():
            return vis3d.rasterize_mesh(v_dev, tris_dev, (RENDER_H, RENDER_W))

        for _ in range(3):
            render_once()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(RENDER_TIMED):
            render_once()
        b.record()
        b.synchronize()
        renders.append(a.elapsed_time(b) / RENDER_TIMED)
        print(f"render {axes} {angles} ({len(verts)} vertices, {len(tris)} triangles, {RENDER_W} x {RENDER_H}): "
              f"{len(pix)} fragments, coverage {cover.mean():.4f} equal on card and CPU, {ties} pixels tie in depth; "
              f"card vs CPU depth max {dd:.3e}, colour max {dc} levels, normals max {dn:.3e}; {renders[-1]:.3f} ms a "
              f"render (CUDA events over {RENDER_TIMED} after warm-up), host "
              f"{(time.perf_counter() - t0) * 1e3 / RENDER_TIMED:.3f} ms, on {smi}")

    # FaceRender on the card through stub head models: the tetrahedron of tests/test_vis3d.py, and the ellipsoid
    # with 50 random deformation bases at the frame size
    class Tetrahedron:
        scaled_vertices = np.array([[0.0, -1.0, -0.5], [-1.0, 0.8, 0.0], [1.0, 0.8, 0.0], [0.0, 0.2, 0.9]], np.float32)
        scaled_bases = np.zeros((50, 4, 3), np.float32)
        scaled_tri = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)

    class Ellipsoid:
        scaled_vertices, scaled_tri = verts, tris.astype(np.int32)
        scaled_bases = np.random.RandomState(FIT_SEED).normal(scale=0.01, size=(50, len(verts), 3)).astype(np.float32)

    require = vis3d._require_full_mesh
    try:
        vis3d._require_full_mesh = Tetrahedron
        r = vis3d.FaceRender(backend="software")
        check(r.device.type == "cuda" and r._pyrender is None, f"FaceRender: {r.device}, pyrender {r._pyrender}")
        rot = Rotation.from_euler("y", 20, degrees=True)
        r.set(xy=(32.0, 32.0), scale=20.0, rot=rot, shapeparams=np.zeros(50), image_shape=(64, 64))
        color, depth = r.render()
        cover = (depth != 0).mean()
        check(isinstance(color, np.ndarray) and color.shape == (64, 64, 3) and depth.shape == (64, 64)
              and 0.05 < cover < 0.9 and (color[depth != 0] > 0).any(), f"FaceRender (tetrahedron): cover {cover}")
        r.set(xy=(8.0, 8.0), scale=6.0, rot=rot, shapeparams=np.zeros(50), image_shape=(64, 64))
        check((r.render()[1] != 0).mean() < cover, "FaceRender (tetrahedron): the smaller head covers no less")
        vis3d._require_full_mesh = Ellipsoid
        card, host = vis3d.FaceRender(backend="software"), vis3d.FaceRender(backend="software", device="cpu")
        sp = np.random.RandomState(1).normal(size=50)
        for x in (card, host):
            x.set(xy=(RENDER_W / 2, RENDER_H / 2), scale=RENDER_SCALE, rot=Rotation.from_euler("xy", (10, -30),
                  degrees=True), shapeparams=sp, image_shape=(RENDER_H, RENDER_W))
        (cc, cd), (hc, hd) = card.render(), host.render()
        both = cc.any(-1) & hc.any(-1)
        check(np.array_equal(cc.any(-1), hc.any(-1)) and float(np.abs(cd[both] - hd[both]).max()) <= 1e-4
              and int(np.abs(cc.astype(int) - hc.astype(int)).max()) <= 1, "FaceRender (ellipsoid): card vs CPU")
    finally:
        vis3d._require_full_mesh = require
    print(f"FaceRender on the card: the tetrahedron covers {cover:.4f} of 64 x 64; the deformed ellipsoid at "
          f"{RENDER_W} x {RENDER_H} equal in coverage to the CPU's, depth within 1e-4, colour within 1 level")

    alone, cpu_s = cpu_fit.result(timeout=900)
    drot = rotation_deg(np, fit["quats"][:FIT_CPU_N], alone["quats"])
    dparam = {k: float(np.abs(fit[k][:FIT_CPU_N] - alone[k]).max()) for k in ("quats", "coords", "shapeparams")}
    print(f"fit card against CPU, first {FIT_CPU_N} faces fitted alone on the CPU ({cpu_s:.1f} s in a process of "
          f"its own): rotation difference mean {drot.mean():.3e} deg, max {drot.max():.3e} deg (limits "
          f"{FIT_AGREE_MEAN_DEG}, {FIT_AGREE_MAX_DEG}); largest parameter difference "
          + ", ".join(f"{k} {v:.3e}" for k, v in dparam.items()) + f" (limit {FIT_AGREE_PARAM})")
    check(drot.mean() <= FIT_AGREE_MEAN_DEG and drot.max() <= FIT_AGREE_MAX_DEG
          and max(dparam.values()) <= FIT_AGREE_PARAM, "fit: the card's rows disagree with the CPU's fit")
    torch.cuda.synchronize()
    launches = dict(ext.LAUNCHES)
    check(not any(launches.values()), f"face-model tools: kernels launched {launches}")
    return launches


def cpu_reference_fit(pt2d, rois, steps, lr):
    """Phase 16's fit on the CPU, run in a spawned process: (the fit, its seconds)."""
    from neuralnet_tracker_traincode_torch.scripts.fit_face_model import fit_face_model

    t0 = time.perf_counter()
    fit = fit_face_model(pt2d, rois, steps=steps, lr=lr, device="cpu", log=lambda line: None)
    return fit, time.perf_counter() - t0


def posed_frames(torch, np, dev, hpb_deg, xy, size, shapeparams, individual=None):
    """Marker frames of the given poses (heading, pitch, bank in degrees),
    positions, sizes and shape parameters, rendered on the card with
    `data/synthetic.py`'s pieces, as the eval loader's samples (head ROI)."""
    from neuralnet_tracker_traincode_torch import utils
    from neuralnet_tracker_traincode_torch.data.batch import frame
    from neuralnet_tracker_traincode_torch.data.fields import Tag
    from neuralnet_tracker_traincode_torch.data.synthetic import render_marker_images
    from neuralnet_tracker_traincode_torch.models.components import DeformableHeadKeypoints, rigid_transformation_25d
    from neuralnet_tracker_traincode_torch.ops.rotrepr import QuatRepr

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    quats = f32(utils.from_hpb(np.radians(hpb_deg)).as_quat())
    xy, size, shapeparams = f32(xy), f32(np.reshape(size, (-1, 1))), f32(shapeparams)
    with torch.no_grad():
        pt3d = rigid_transformation_25d(QuatRepr(quats), xy, size, DeformableHeadKeypoints(40, 10).to(dev)(shapeparams))
    rois = torch.cat([pt3d[..., :2].amin(dim=1), pt3d[..., :2].amax(dim=1)], dim=-1)
    coords = torch.cat([xy, size], dim=-1)
    images = render_marker_images(pt3d, coords, RUN_SRC)[..., None]
    host = {k: v.cpu().numpy() for k, v in dict(image=images, pose=quats, coord=coords, pt3d_68=pt3d,
                                                   shapeparam=shapeparams, roi=rois).items()}
    frames = []
    for i in range(len(host["pose"])):
        fields = {k: v[i] for k, v in host.items()}
        if individual is not None:
            fields["individual"] = np.asarray(individual[i], np.int32)
        frames.append(frame(Tag.POSE_WITH_LANDMARKS, fields))
    return eval_samples(frames)


def stability_sets(torch, np, dev):
    """Phase 17's data: the "video" (slow sines of yaw +-40 and pitch +-20
    degrees, drifting position and size, one face), the yaw sweep, and the
    individuals who each keep one pose over frames of other shape parameters."""
    rng = np.random.RandomState(17)
    t = np.arange(VIEW_VIDEO_N, dtype=np.float64)
    face = np.tile(rng.randn(1, 50) * 0.6, (VIEW_VIDEO_N, 1))
    hpb = np.stack([40 * np.sin(2 * np.pi * t / 700), 20 * np.sin(2 * np.pi * t / 450 + 1.0), 5 * np.sin(t / 300)], -1)
    xy = RUN_SRC * np.stack([0.5 + 0.08 * np.sin(t / 400), 0.5 + 0.06 * np.cos(t / 500)], -1)
    video = posed_frames(torch, np, dev, hpb, xy, RUN_SRC * (0.21 + 0.03 * np.sin(t / 600)), face)
    yaw = np.linspace(-40, 40, VIEW_YAW_N)
    sweep = posed_frames(torch, np, dev, np.stack([yaw, 0 * yaw, 0 * yaw], -1), np.full((VIEW_YAW_N, 2), RUN_SRC / 2),
                         np.full(VIEW_YAW_N, 0.21 * RUN_SRC), np.tile(rng.randn(1, 50) * 0.6, (VIEW_YAW_N, 1)))
    n = VIEW_INDIVIDUALS * VIEW_PER_INDIVIDUAL
    individual = np.repeat(np.arange(VIEW_INDIVIDUALS), VIEW_PER_INDIVIDUAL)
    poses = rng.uniform([-35, -20, -10], [35, 20, 10], (VIEW_INDIVIDUALS, 3))[individual]
    variations = posed_frames(torch, np, dev, poses, np.full((n, 2), RUN_SRC / 2), np.full(n, 0.21 * RUN_SRC),
                              rng.randn(n, 50) * 0.6, individual)
    return video, sweep, variations


def unit_quats(np, predictor, samples, what):
    """The predictions' quaternions on `samples`, checked finite and unit."""
    from neuralnet_tracker_traincode_torch.eval import metrics as M

    quats = predictor.evaluate(M.PredExtractor("pose"), samples)
    norm = np.linalg.norm(quats, axis=-1)
    check(bool(np.isfinite(quats).all()) and float(np.abs(norm - 1).max()) < 1e-5,
          f"stability {what}: quaternions not unit and finite (|q| in [{norm.min()}, {norm.max()}])")
    return quats


def stability_phase(torch, np, dev, ckpt, val_samples):
    """Phase 17 (a): evaluate_stability's analyses on the card on phase 9's
    `best.ckpt` (quaternion, point and NLL heads), the f32 eval."""
    from neuralnet_tracker_traincode_torch.eval import metrics as M
    from neuralnet_tracker_traincode_torch.eval.predictor import Predictor
    from neuralnet_tracker_traincode_torch.scripts import evaluate_stability as ES

    t_data = time.perf_counter()
    video, sweep, variations = stability_sets(torch, np, dev)
    t_data = time.perf_counter() - t_data
    finite = lambda poses: all(bool(np.isfinite(a).all()) for a in poses)  # noqa: E731
    out = {}
    with np.errstate(all="raise"):  # as the CLI runs its analyses
        runs = {"open-loop": [], "closed-loop": []}
        for crop in ES.CROP_FACTORS:
            predictor = Predictor(ckpt, crop, device=dev)
            unit_quats(np, predictor, video, f"video at crop {crop}")
            runs["open-loop"].append(ES.open_loop_tracking(predictor, video))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            runs["closed-loop"].append(ES.closed_loop_tracking(predictor, video))
            end.record()
            torch.cuda.synchronize()
            out[f"closed_loop_ms_per_frame_crop{crop}"] = start.elapsed_time(end) / len(video)
            for a, b in zip(runs["open-loop"][-1], runs["closed-loop"][-1]):  # frame 0: both at its ground-truth ROI
                tol = VIEW_HPB_TOL if a.ndim == 2 and a.shape[1] == 3 else VIEW_PX_TOL
                check(float(np.abs(a[0] - b[0]).max()) <= tol, f"open and closed loop differ on frame 0: {a[0]} {b[0]}")
        # where a closed-loop frame's time goes: one frame a call, 20 calls under the profiler
        from neuralnet_tracker_traincode_torch.train.profiling import profile_steps

        prof = profile_steps(lambda: ES.closed_loop_tracking(predictor, video[:1]), 20, top=4)
        out["closed_loop_frame_profile"] = {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                                                 "device_busy_share", "device_ops_per_step")}
        for mode, poses in runs.items():
            check(all(finite(p) and len(p.hpb) == VIEW_VIDEO_N for p in poses), f"stability: {mode} not finite")
            print(f"stability {mode} (blink-window MSE over crops {ES.CROP_FACTORS}, {VIEW_VIDEO_N} frames):")
            blink = ES.report_blink_stability(poses)
            check(blink is not None and all(bool(np.isfinite(v).all()) for v in blink.values()),
                  f"stability {mode}: blink report {blink}")
            out[f"blink_{mode}"] = {k: v.tolist() for k, v in blink.items()}
        # the same analysis on the CPU, the first frames
        cpu = ES.open_loop_tracking(Predictor(ckpt, ES.CROP_FACTORS[0], device="cpu"), video[:VIEW_CPU_N])
        card = runs["open-loop"][0]
        hpb_err = float(np.abs(cpu.hpb - card.hpb[:VIEW_CPU_N]).max())
        px_err = max(float(np.abs(cpu.xy - card.xy[:VIEW_CPU_N]).max()),
                     float(np.abs(cpu.sz - card.sz[:VIEW_CPU_N]).max()))
        check(hpb_err <= VIEW_HPB_TOL and px_err <= VIEW_PX_TOL,
              f"open loop, card against CPU on {VIEW_CPU_N} frames: hpb {hpb_err} rad, xy/size {px_err} px")
        out["open_loop_card_vs_cpu"] = dict(hpb_rad=hpb_err, px=px_err)

        predictor = Predictor(ckpt, 1.1, device=dev)
        unit_quats(np, predictor, sweep, "yaw sweep")
        yaw_poses = ES.pitch_yaw_poses(predictor, sweep)
        check(finite(yaw_poses), "stability pitch-yaw not finite")
        out["pitch_yaw_deg_first_last"] = [yaw_poses.hpb[0, :2].tolist(), yaw_poses.hpb[-1, :2].tolist()]

        predictor = Predictor(ckpt, 1.2, device=dev)
        unit_quats(np, predictor, val_samples, "phase 9 validation")
        errors = ES.noise_resist(predictor, val_samples, ES.NOISE_LEVELS, np.random.RandomState(ES.NOISE_SEED))
        check(bool(np.isfinite(errors).all()), "stability noise-resist not finite")
        direct = predictor.evaluate(M.GeodesicError(), val_samples)
        zero_err = float(np.abs(errors[0] - direct).max())
        check(zero_err <= 1e-6, f"noise-resist at sigma 0 is {zero_err} rad from Predictor.evaluate")
        out["noise_resist_deg"] = {lv: float(np.mean(e)) * 180 / np.pi for lv, e in zip(ES.NOISE_LEVELS, errors)}
        out["noise_zero_vs_evaluate_rad"] = zero_err
        rot_err, uncertainty, corr = ES.uncertainty_error_correlation(predictor, val_samples)
        tril = predictor.evaluate(M.PredExtractor("pose_scales_tril"), val_samples)
        eig = np.linalg.eigvalsh(np.matmul(tril, np.swapaxes(tril, -1, -2)))
        check(bool(np.isfinite(uncertainty).all()) and np.isfinite(corr) and float(eig.min()) > 0,
              f"stability uncertainty: corr {corr}, least eigenvalue {eig.min()}")
        out["corr_err_uncertainty"] = float(corr)

        unit_quats(np, predictor, variations, "variations")
        means, deviations, gt = ES.stability_vs_variations(predictor, variations)
        check(means.shape == (VIEW_INDIVIDUALS, 4) and bool(np.isfinite(deviations).all())
              and float(np.abs(np.linalg.norm(means, axis=-1) - 1).max()) < 1e-5, f"stability variations: {deviations}")
        out["variation_mean_deviation_deg"] = float(np.average(deviations)) * 180 / np.pi
    print(f"stability (a): data {t_data:.2f} s on the card; " + json.dumps(out))
    return out


def viewer_phase(torch, np, dev, frames):
    """Phase 17 (b): show_train_test_splits' `iterate_samples` on the card on
    one batch of `frames`, with the training augmentation (K1, K2, K3 held to
    their plain versions at these launches); the PNGs written and read back.
    Returns the launch counts and the errors."""
    import cv2

    from neuralnet_tracker_traincode_torch import vis
    from neuralnet_tracker_traincode_torch.augmentation.pipeline import TrainAugmentationConfig
    from neuralnet_tracker_traincode_torch.data.loader import pack_fused_batch
    from neuralnet_tracker_traincode_torch.kernels import equalize as K2
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import noise as K3
    from neuralnet_tracker_traincode_torch.kernels import warp as K1
    from neuralnet_tracker_traincode_torch.scripts.show_train_test_splits import iterate_samples

    batch = pack_fused_batch(frames[:VIEW_SAMPLES], [0] * VIEW_SAMPLES, RUN_SRC)
    cfg = TrainAugmentationConfig(inputsize=S, rotation_aug_angle=THETA, extension_factor=1.1)
    with k1_captured(K1, lambda skip, n: True) as crops, wrapper_captured(K2, "equalize", 1) as equalized, \
            wrapper_captured(K3, "add_gaussian_noise", 1) as noised:
        torch.cuda.synchronize()
        ext.reset_launch_counts()
        samples = list(iterate_samples([batch], cfg, torch.Generator().manual_seed(17), dev))
        torch.cuda.synchronize()
        launches = dict(ext.LAUNCHES)
    check(launches == {"warp_roi_rotate": 1, "equalize": 4, "gaussian_noise": 1, "gaussian_noise_from_bits": 0,
                       "jpeg_idct": 0},
          f"show_train_test_splits: launches {launches}")
    errs = k2_k3_against_plain(torch, K2, K3, equalized, noised, "show_train_test_splits")
    errs["warp_roi_rotate"] = k1_against_plain(K1, crops, "show_train_test_splits")
    check(len(samples) == VIEW_SAMPLES, f"{len(samples)} samples from a batch of {VIEW_SAMPLES}")
    outdir = tempfile.mkdtemp(prefix="chip_smoke_splits_")
    try:
        for i, gp in enumerate(samples):
            check(all(bool(np.isfinite(v).all()) for k, v in gp[0].items() if k != "image"), f"sample {i} not finite")
            img = vis.draw_prediction(gp)
            path = os.path.join(outdir, f"sample_{i:03d}.png")
            check(cv2.imwrite(path, img[..., ::-1]), f"cv2 wrote no {path}")
            check(np.array_equal(cv2.imread(path)[..., ::-1], img), f"{path} reads back otherwise")
        written = len(os.listdir(outdir))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    print(f"show_train_test_splits (b): {written} PNGs written and read back equal; K1 max |kernel - plain| "
          f"{errs['warp_roi_rotate']:.3e} gray; launches {launches}")
    return launches, errs


def analysis_phase(torch, np, dev, smi, ckpt, val_frames, train_frames):
    """Phase 17: (a) `stability_phase`, (b) `viewer_phase`, (c) the figures."""
    from neuralnet_tracker_traincode_torch.vis import matplotlib_import_error

    t_phase = time.perf_counter()
    stability_phase(torch, np, dev, ckpt, eval_samples(val_frames))
    launches, errs = viewer_phase(torch, np, dev, train_frames)
    error = matplotlib_import_error()
    if error is not None:
        print(f"analysis (c): the figures of (a) and the pager of (b) are not drawn here: matplotlib does not import "
              f"({error}); the CPU tests draw them (tests/test_torch_stability.py, tests/test_torch_viewers.py)")
    else:
        print("analysis (c): matplotlib imports here; the figures are drawn and held by the CPU tests")
    print(f"analysis: phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return launches, errs


def raise_dqt(buf: bytes, value: int = 255) -> bytes:
    """`buf` with every entry of its quantization tables set to `value`
    after encoding: its coefficients then dequantize past 16 bits, where
    libjpeg-turbo's SIMD lanes wrap and saturate (`kernels/jpeg.py`)."""
    b = bytearray(buf)
    i = 2
    while b[i + 1] != 0xDA:
        n = (b[i + 2] << 8) | b[i + 3]
        j = i + 4
        while b[i + 1] == 0xDB and j < i + 2 + n:
            wide = b[j] >> 4
            for k in range(64):
                if wide:
                    b[j + 1 + 2 * k:j + 3 + 2 * k] = bytes([value >> 8, value & 255])
                else:
                    b[j + 1 + k] = value
            j += 1 + 64 * (wide + 1)
        i += 2 + n
    return bytes(b)


def jpeg_cases(np, cv2):
    """Phase 18 (a)'s seeded set: (name, JPEG bytes)."""
    rng = np.random.default_rng(JPEG_SEED)

    def enc(img, *params):
        return cv2.imencode(".jpg", img, list(params))[1].tobytes()

    noise = rng.integers(0, 256, (123, 301), dtype=np.uint8)
    color = rng.integers(0, 256, (123, 301, 3), dtype=np.uint8)
    bands = np.repeat(np.repeat(np.arange(96, 176, dtype=np.uint8).reshape(8, 10), 8, 0), 8, 1)  # flat blocks
    cases = [(f"noise q{q}", enc(noise, cv2.IMWRITE_JPEG_QUALITY, q)) for q in (1, 50, 100)]
    cases += [(f"{h}x{w}", enc(rng.integers(0, 256, (h, w), dtype=np.uint8))) for h, w in ((1, 1), (7, 9), (123, 301))]
    cases += [("colour 4:2:0", enc(color, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
              ("colour 4:4:4", enc(color, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
              ("restart interval 3", enc(noise, cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)),
              ("DQT raised to 255", raise_dqt(enc(noise[:96, :128], cv2.IMWRITE_JPEG_QUALITY, 95))),
              ("DQT raised to 255, flat blocks", raise_dqt(enc(bands, cv2.IMWRITE_JPEG_QUALITY, 95)))]
    return cases


def k4_against_cv2_and_plain(torch, np, cv2, buffers, pad, dev, what):
    """K4 on the card over `buffers` decoded into slots of `pad`, against its
    plain version and cv2, bit for bit; returns the payload on the card and
    max |kernel - plain|."""
    from neuralnet_tracker_traincode_torch.data import native_loader as NL
    from neuralnet_tracker_traincode_torch.kernels import jpeg as K4

    payload = NL.entropy_decode(buffers, pad).to(dev)
    got = payload.decode()
    plain = K4.idct_pack_plain(*payload.arrays, pad)
    want = np.zeros((len(buffers), pad, pad, 1), np.uint8)
    for i, b in enumerate(buffers):
        im = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
        want[i, :im.shape[0], :im.shape[1], 0] = im
    torch.cuda.synchronize()
    err = float((got.int() - plain.int()).abs().max())
    check(torch.equal(got, plain), f"K4 differs from its plain version on {what}: max {err}")
    differ = [i for i in range(len(buffers)) if not np.array_equal(got[i].cpu().numpy(), want[i])]
    check(not differ, f"K4 differs from cv2 on {what}: images {differ}")
    return payload, err


def k4_work(K4, coeffs, block_start, out):
    """K4's work on a payload, for its bound: the bytes (the payload's arrays
    read once, `out` written once) and the integer operations that this
    payload needs. Each coefficient present: its dequantization (a product,
    its low 16 bits), 2. A block whose run is its DC alone: one value for
    its 64 pixels (x 4, low 16 bits, the row pass's x 2^13, add and shift,
    the clamp and + 128), 8. A block with terms in its first row only
    (each column its first value x 4): that shortcut on 8 columns (16), one
    row pass for its eight equal rows (66) and 8 range limits (24), 106.
    Any other block: 8 column and 8 row passes of 66 operations each, the
    column pass's saturation (2 a value) and the range limit (clamp and
    + 128, 3 a pixel), 1,376. Returns (bytes, operations, blocks, blocks of
    the last kind)."""
    blocks = block_start.shape[0] - 1
    runs = block_start[1:] - block_start[:-1]
    dc_only = int((runs == 1).sum())
    full = int((K4.dense_blocks(coeffs, block_start, 0, blocks).reshape(-1, 8, 8)[:, 1:, :] != 0).any(2).any(1).sum())
    present = int(block_start[-1] - block_start[0])
    ops = 2 * present + 8 * dc_only + 106 * (blocks - dc_only - full) + 1376 * full
    nbytes = sum(t.numel() * t.element_size() for t in (coeffs, block_start)) + out.numel()
    return nbytes, ops, blocks, full


def k4_timing(torch, payload, pad, dev):
    """K4 on `payload` into a (N, pad, pad, 1) batch: `ms`, `ms_stream` and
    the bound with the work it is computed from."""
    from neuralnet_tracker_traincode_torch.kernels import ext
    from neuralnet_tracker_traincode_torch.kernels import jpeg as K4

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    out = torch.empty((payload.meta.shape[0], pad, pad, 1), dtype=torch.uint8, device=dev)
    launch = lambda c, s, q, m: ext.extension().jpeg_idct_pack(c, s, q, m, out, pad)  # noqa: E731
    coeffs, block_start, qtables, meta = payload.arrays
    nbytes, ops, blocks, full = k4_work(K4, coeffs, block_start, out)
    nbytes += qtables.numel() * qtables.element_size() + meta.numel() * meta.element_size()
    return dict(ms=time_ms(torch, lambda: launch(*payload.arrays), flush),
                ms_stream=stream_ms(torch, launch, rotating(torch, *payload.arrays)),
                bound=bound_ms(nbytes, i32_ops=ops), bytes=nbytes, ops=ops, blocks=blocks, full=full)


def k4_line(t, what, smi):
    return (f"K4 on {what}: {t['ms']:.4f} ms ({t['ms_stream']:.4f} ms_stream) a batch of {B}, bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]}: {t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.4f} G integer "
            f"operations, {t['full']} of {t['blocks']} blocks with terms past their first row) on {smi}")


def jpeg_phase(torch, np, dev, smi, frames):
    """Phase 18: the JPEG decode on the card (host entropy decode, K4) for
    the training loader, on phase 12a's frames, and K4 and the host decode
    on dense frames (noise)."""
    import cv2

    from neuralnet_tracker_traincode_torch.kernels import jpeg as K4
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import decode_stage, print_training
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import jpeg_frames as make_frames

    t_phase = time.perf_counter()
    train, val, pad = frames["train"], frames["val"], frames["pad"]
    buffers = [train.buffer(i) for i in range(len(train))]
    noise = make_frames(B, pad, JPEG_SEED, dev, "noise")
    dense = [noise.buffer(i) for i in range(B)]

    # (a) K4 against its plain version and cv2, bit for bit
    cases = jpeg_cases(np, cv2)
    payload, err = k4_against_cv2_and_plain(torch, np, cv2, buffers[:B], pad, dev, f"{B} of phase 12a's frames")
    dense_payload, err_dense = k4_against_cv2_and_plain(torch, np, cv2, dense, pad, dev, f"{B} noise frames")
    _, err_cases = k4_against_cv2_and_plain(torch, np, cv2, [b for _, b in cases], 320, dev, "the seeded set")
    err = max(err, err_dense, err_cases)
    print(f"jpeg (a): K4 bit-equal to its plain version and to cv2.imdecode(..., IMREAD_GRAYSCALE) on {B} of phase "
          f"12a's {pad}^2 q95 frames, on {B} noise frames at {pad}^2 q95 and on the seeded set "
          f"({', '.join(n for n, _ in cases)}) on {smi}")

    # K4 at the main path's shape (phase 12a's frames, mostly flat) and on dense frames: ms, ms_stream, the bound
    row = dict(name="jpeg_idct", source="neuralnet_tracker_traincode_torch/kernels/csrc/jpeg_idct.cu",
               replaces="neuralnet_tracker_traincode_tpu/data/native_loader.py:93", max_abs_err=err, library_ms=None,
               plain_ms=time_ms(torch, lambda: K4.idct_pack_plain(*payload.arrays, pad), torch.empty(
                   64 * 2**20, dtype=torch.uint8, device=dev), n=5, warmup=1))
    flat_t, dense_t = k4_timing(torch, payload, pad, dev), k4_timing(torch, dense_payload, pad, dev)
    row.update((k, flat_t[k]) for k in ("ms", "ms_stream", "bound"))
    row.update(ms_dense=dense_t["ms"], ms_stream_dense=dense_t["ms_stream"], bound_ms_dense=dense_t["bound"][0])
    del payload, dense_payload
    print(k4_line(flat_t, f"{B} of phase 12a's frames", smi) + f"; plain {row['plain_ms']:.3f} ms")
    print(k4_line(dense_t, f"{B} noise frames", smi))
    for what, bufs in ((f"{JPEG_DECODE_N} of phase 12a's frames", buffers[:JPEG_DECODE_N]),
                       (f"{B} noise frames", dense)):
        rates = decode_stage(bufs, pad, dev)
        print(f"jpeg decode on the host, one thread each, {what} at {pad}^2 q95: cv2 {rates['cv2']:.1f} images/s, the "
              f"entropy decode {rates['entropy']:.1f} images/s per core ({os.cpu_count()} host cores) on {smi}")

    # (b) and (c): phase 7's run (as phase 12a) on phase 12a's frames through FusedBatchLoader decoding on the
    # card and device_prefetch_stacked at K = 8, the CLI's default on the card
    r = jpeg_loader_run(torch, np, dev, train, val, pad, "device")
    for k, want in enumerate(frames["want"][:MS_K]):
        differ = [n for n in want if not np.array_equal(r["first"][n][k].cpu().numpy(), want[n])]
        check(set(r["first"]) == set(want) and not differ,
              f"device-decoded batch {k} differs from the host decode: {differ}")
    print(f"jpeg (b): the first {MS_K} batches of {LOADER_WORKERS} process workers decoding on the card, through "
          f"device_prefetch_stacked at K = {MS_K}, equal field for field the host decode's (phase 12a); loader alone "
          f"({LOADER_WORKERS} process workers, {os.cpu_count()} host cores, {pad}^2 JPEG q95, batch {B}): "
          f"{r['alone']:.1f} images/s entropy-decoding, {frames['host_alone']:.1f} images/s decoding by cv2 "
          f"(phase 12a) on {smi}")
    print_training(r, "jpeg (c)", smi)
    print(f"jpeg: phase {time.perf_counter() - t_phase:.2f} s on {smi}")
    return r["launches"], row


def jpeg_loader_run(torch, np, dev, train, val, pad, mode):
    """Phase 7's run (the configuration of phase 12a) at K = 8 through
    `FusedBatchLoader(jpeg_decode=mode)` (4 process workers) and
    `device_prefetch_stacked` (`scripts/bench_loader.py:training_stage`),
    held to what it must show."""
    from neuralnet_tracker_traincode_torch.scripts.bench_loader import training_stage

    torch.backends.cudnn.allow_tf32 = True  # as in phase 7
    torch.backends.cuda.matmul.allow_tf32 = False
    r = training_stage(train, val, pad, dev, mode, batchsize=B, epochs=RUN_EPOCHS,
                       samples_per_epoch=RUN_SAMPLES_PER_EPOCH, steps_per_dispatch=MS_K, workers=LOADER_WORKERS,
                       alone_batches=LOADER_ALONE_BATCHES)
    check(not multiprocessing.active_children(), "loader workers outlived the run")
    steps = RUN_EPOCHS * RUN_SAMPLES_PER_EPOCH // B
    check(r["steps"] == steps and len(r["waits"]) == steps // MS_K, f"step {r['steps']}, {len(r['waits'])} groups")
    for rec in r["records"]:
        bad = [k for k, v in rec["train_metrics"].items() if not math.isfinite(v)]
        check(not bad and math.isfinite(rec["val_loss"]), f"jpeg run epoch {rec['epoch']}: non-finite {bad or 'val'}")
    untrained_loss, final_loss = r["losses"]
    check(final_loss < untrained_loss, f"validation loss {final_loss} is not below the untrained {untrained_loss}")
    # K4 once a batch decoded on the card (the groups prefetched past the run's end included); K1, K2, K3 in the
    # graph's warm-up, capture and replays
    launches = r["launches"]
    k4 = (steps, steps + 2 * MS_K) if mode == "device" else (0, 0)
    check(k4[0] <= launches["jpeg_idct"] <= k4[1] and launches["warp_roi_rotate"] > 0 and launches["equalize"] > 0
          and launches["gaussian_noise"] > 0, f"jpeg run ({mode} decode) launches {launches}")
    return r


def main() -> int:
    t_script = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "neuralnet_tracker_traincode_torch")):
        fail(f"the port's package is not beside this script in {ROOT}")
    sys.path.insert(0, ROOT)
    from neuralnet_tracker_traincode_torch.kernels import ext

    smi = card_line()
    print(smi)
    host_probe()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    ext.extension()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s into {ext.BUILD_DIR}")
    rows = kernel_phase(torch, np, dev)
    reference_phase(torch, np, dev)
    launches, step = training_phase(torch, np, dev, f"{name} ({smi})")
    profile = "--profile" in sys.argv
    if profile:
        from neuralnet_tracker_traincode_torch.train.profiling import profile_steps

        trace = sys.argv[sys.argv.index("--profile") + 1] if len(sys.argv) > sys.argv.index("--profile") + 1 else None
        print("profile: " + json.dumps(profile_steps(step, 5, trace)))
    run_launches, errs_run, run_step, run = training_run_phase(torch, np, dev, f"{name} ({smi})")
    export_dir = tempfile.mkdtemp(prefix="chip_smoke_export_")  # phase 7's best.ckpt for phase 13
    conv_dir = tempfile.mkdtemp(prefix="chip_smoke_conv_best_")  # phase 9's best.ckpt for phase 17
    try:
        try:
            if profile:
                print("profile (training run's step): " + json.dumps(profile_steps(run_step, 5)))
            eval_phase(torch, np, dev, f"{name} ({smi})", run)
            shutil.copy(os.path.join(run["outdir"], "best.ckpt"), export_dir)
        finally:
            shutil.rmtree(run["outdir"], ignore_errors=True)
        conv_launches, errs_conv, conv_step, conv_val = convergence_phase(torch, np, dev, f"{name} ({smi})", conv_dir)
        if profile:
            print("profile (convergence run's dispatch of 8 steps): "
                  + json.dumps(profile_steps(conv_step, 2, steps_per_call=8)))
        loc_launches, errs_loc, loc_stream, localizer = localizer_phase(torch, np, dev, f"{name} ({smi})")
        bb_launches, errs_bb = backbones_phase(torch, np, dev, f"{name} ({smi})")
        ld_launches, errs_ld, jpeg_inputs = loader_phase(torch, np, dev, f"{name} ({smi})")
        cli_phase(np, f"{name} ({smi})")
        ex_launches = export_phase(torch, np, dev, f"{name} ({smi})", os.path.join(export_dir, "best.ckpt"),
                                   eval_samples(run["val_frames"]), localizer)
        ms_launches, timing, _, _, flagship = multistep_phase(torch, np, dev, f"{name} ({smi})", profile)
        errs_ms = multistep_run_phase(torch, np, dev, f"{name} ({smi})", run)
        dp_launches, errs_dp = data_parallel_phase(torch, np, dev, f"{name} ({smi})", flagship, timing)
        ft_launches = face_tools_phase(torch, np, dev, f"{name} ({smi})")
        vw_launches, errs_vw = analysis_phase(torch, np, dev, f"{name} ({smi})", os.path.join(conv_dir, "best.ckpt"),
                                              conv_val, run["train_frames"])
        jp_launches, jpeg_row = jpeg_phase(torch, np, dev, f"{name} ({smi})", jpeg_inputs)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
        shutil.rmtree(conv_dir, ignore_errors=True)
    for r in rows:  # the errors at the runs' own launches join those of phase 3
        r["max_abs_err"] = max([r["max_abs_err"]] + [e.get(r["name"], 0.0) for e in (
            errs_run, errs_conv, errs_loc, errs_bb, errs_ld, errs_ms, errs_dp, errs_vw)])
    # K4's own main path is phase 18's run: its `launches` are that run's
    launches = dict(launches, jpeg_idct=jp_launches["jpeg_idct"])

    kernels = []
    for r in rows + [jpeg_row]:
        (b_ms, b_by) = r.pop("bound")
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"], replaces=r["replaces"],
            launches=launches[r["name"]], launches_training_run=run_launches[r["name"]],
            launches_convergence_run=conv_launches[r["name"]], launches_localizer_run=loc_launches[r["name"]],
            launches_backbones=bb_launches[r["name"]], launches_loader_run=ld_launches[r["name"]],
            launches_export=ex_launches[r["name"]], launches_multistep=ms_launches[r["name"]],
            launches_data_parallel=dp_launches[r["name"]], launches_face_tools=ft_launches[r["name"]],
            launches_viewer=vw_launches[r["name"]], launches_jpeg_run=jp_launches[r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], ms_stream=r["ms_stream"],
            plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
        ))
        if "ms_dense" in r:  # K4 on dense frames (noise) at the main path's shape
            kernels[-1].update(ms_dense=r["ms_dense"], ms_stream_dense=r["ms_stream_dense"],
                               bound_ms_dense=r["bound_ms_dense"])
        if r["name"] in loc_stream:  # at the localizer's shape, (64, 224 x 288)
            ms, (b, _) = loc_stream[r["name"]]
            kernels[-1].update(ms_stream_localizer=ms, bound_ms_localizer=b)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_script:.1f} s, the kernel build included, on "
          f"{name} ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
