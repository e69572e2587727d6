// Launchers of the port's kernels (the augmentation's and the JPEG decode's). Plain C++ interface: the .cu
// files do not include PyTorch's headers (that keeps nvcc fast); only
// bindings.cpp does. Each launcher enqueues on `stream`, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launches.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// K1: crop warp, one launch of one 2-CTA cluster per sample, the canvas in
// shared memory. img (B, H, W) uint8; params (B, 6) f32 rows
// [y0', sy, x0', sx, a, b]; out (B, S, S) f32 (CS == S when rotate == 0).
// taps_x, taps_y: filter taps per canvas column / row for the batch's largest
// |sx|, |sy|; chunk: canvas rows filtered per step; band_rows: source rows a
// chunk may tap (kernels/warp.py:launch_plan). Returns cudaErrorInvalidValue
// when the shared memory this takes exceeds 227 KB.
cudaError_t nntc_warp_roi_rotate(const uint8_t* img, const float* params, float* out, int B, int H, int W, int S,
                                 int CS, int rotate, int taps_x, int taps_y, int chunk, int band_rows,
                                 cudaStream_t stream);

// K2: per-image histogram equalization, one cluster of 8 CTAs per image.
// x, out (B, P) f32; gate (B,) int32. Returns cudaErrorInvalidValue when a
// CTA's slice (kernels/equalize.py:slice_capacity) does not fit in 227 KB of
// shared memory.
cudaError_t nntc_equalize(const float* x, const int32_t* gate, float* out, int B, int P,
                          cudaStream_t stream);

// K3: gaussian noise from per-sample Philox-4x32-10 streams (key = seeds[b],
// counter = pixel pair p >> 1, words 0-1 for an even pixel and 2-3 for an odd
// one), clipped to [0, 1], plus `offset`. x, out (B, P) f32; seeds (B,) int32;
// sigma (B,) f32.
cudaError_t nntc_gaussian_noise(const float* x, const int32_t* seeds, const float* sigma, float* out,
                                int B, int P, float offset, cudaStream_t stream);

// K3 with the random bits injected: bits1, bits2 (B, P) int32, low 24 bits used.
cudaError_t nntc_gaussian_noise_from_bits(const float* x, const int32_t* bits1, const int32_t* bits2,
                                          const float* sigma, float* out, int B, int P,
                                          cudaStream_t stream);

// K4: the JPEG decode's device half. For image n of N (meta (N, 4) int32:
// height, width, block-grid width ceil(w/8), first block) and every 8x8 tile
// of its pad x pad slot of out (N, pad, pad) uint8: the block's pixels
// (dequantized by qtables (N, 64) int32, libjpeg-turbo's ISLOW IDCT, + 128,
// range limit) inside (h, w), zeros elsewhere. Block b is its coefficients in
// zigzag order up to its last nonzero one, coeffs[block_start[b] ..
// block_start[b + 1]) (num_coeffs int16; block_start num_blocks + 1 int32).
// Returns cudaErrorInvalidValue for more than 65,535 images.
cudaError_t nntc_jpeg_idct_pack(const int16_t* coeffs, const int32_t* block_start, const int32_t* qtables,
                                const int32_t* meta, uint8_t* out, long num_coeffs, long num_blocks, int N, int pad,
                                cudaStream_t stream);
