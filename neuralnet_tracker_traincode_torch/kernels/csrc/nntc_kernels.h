// Launchers of the port's kernels (the augmentation's, the JPEG decode's, the tracer's stamp and the pose heads'). Plain C++ interface: the .cu
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

// K4: the JPEG decode's IDCT half. For image n of N (meta (N, meta_cols)
// int32, columns 0-3: height, width, block-grid width ceil(w/8), first
// block) and every 8x8 tile of its pad x pad slot of out (N, pad, pad) uint8:
// the block's pixels (dequantized by qtables (N, 64) int32, libjpeg-turbo's
// ISLOW IDCT, + 128, range limit) inside (h, w), zeros elsewhere. Block b is
// slots[b][0 .. lens[b]) in zigzag order (slots (num_blocks, 64) int16,
// 16-byte aligned; lens clamped to 1-64), the rest zero. Returns
// cudaErrorInvalidValue for fewer than 4 meta columns or unaligned slots.
cudaError_t nntc_jpeg_idct_pack(const int16_t* slots, const uint8_t* lens, const int32_t* qtables,
                                const int32_t* meta, uint8_t* out, long num_blocks, int meta_cols, int N, int pad,
                                cudaStream_t stream);

// K5: the Huffman decode of N images' Y scans (kernels/jpeg_huffman.py says
// what the arrays hold): scan (bytes, 4-byte aligned), intervals (NI, 4),
// tables (num_tables, 804), meta (N, 34) int32 in; slots (num_blocks, 64)
// int16, lens (num_blocks,) uint8, status (N, 4) and stats (N, 3) int32 out;
// scratch int64 as kernels/jpeg_huffman.py:scratch_words lays it out, subs
// the subsequences' bound. Each image's layout follows its scan against the
// batch's (bits_total over N, sequence_bits: kernels/jpeg_huffman.py:
// image_layout), its subsequences of subsequence_bits (a multiple of 32)
// where that is not 0. Three launches: the tables and each image's layout,
// CTAs of 128 threads as many as the SMs hold taking the sequences by
// ticket, a CTA an image for the DC values and the status. Returns
// cudaErrorInvalidValue for an unaligned scan, S not a multiple of 32 or no
// table.
cudaError_t nntc_jpeg_huffman_decode(const uint8_t* scan, const int32_t* intervals, const int32_t* tables,
                                     const int32_t* meta, int16_t* slots, uint8_t* lens, int32_t* status,
                                     int32_t* stats, long long* scratch, int N, int num_tables, int sequence_bits,
                                     int subsequence_bits, long bits_total, long subs, long intervals_total,
                                     cudaStream_t stream);

// K5's decode CTAs (128 threads) an SM at most on the current device (-1 on an error).
int nntc_jpeg_huffman_ctas_per_sm();

// The tracer's stamp: one thread writes (kind | arg << 8, %globaltimer in ns)
// into slot *cursor % capacity of ring (capacity, 2) int64, then increments
// *cursor (int64). kind in [0, NNTC_STAMP_KINDS), each its own kernel name
// (nntc_stamp_kernel<kind>). Returns cudaErrorInvalidValue for another kind,
// capacity <= 0 or arg < 0.
#define NNTC_STAMP_KINDS 16
cudaError_t nntc_stamp(long long* ring, long long* cursor, long long capacity, int kind, long long arg,
                       cudaStream_t stream);

// The pose heads after their linear layers, one launch forward and one
// backward (kernels/heads.py says what each tensor holds). `slots` holds a
// pointer a slot, in kernels/heads.py:SLOTS's order (this enum): inputs, the
// forward's outputs, the outputs' gradients, the inputs' gradients, the
// samples' shares of the offsets' gradients (B, 8) f32 and the ticket (1,)
// int32; null where absent: the scales' slots without uncertainty, set_id
// without ids (row 0), an output's gradient that is zero. B samples, `rows`
// rows of each offset's parameters. The forward zeroes the ticket, which the
// backward's last CTA takes and zeroes again. Returns cudaErrorInvalidValue
// for B or rows below 1 or a slot missing that the launch needs.
namespace nntc_heads {
enum Slot : int {
    quat, xy, size, box, shape, neck_rot, neck_coord, offset, offset_kpts, set_id, keypts, keyeigvecs,
    min_diag_rot, min_diag_coord, hidden_roi, hidden_pt3d, hidden_shape, rot, unnormalized_quat, coord, roi,
    pt3d_68, pose_scales_tril, coord_scales, roi_scales, pt3d_68_scales, shapeparam_scales, g_rot,
    g_unnormalized_quat, g_coord, g_roi, g_pt3d_68, g_pose_scales_tril, g_coord_scales, g_roi_scales,
    g_pt3d_68_scales, g_shapeparam_scales, d_quat, d_xy, d_size, d_box, d_shape, d_neck_rot, d_neck_coord,
    d_offset, d_offset_kpts, d_hidden_roi, d_hidden_pt3d, d_hidden_shape, partial, ticket, count
};
}  // namespace nntc_heads

cudaError_t nntc_pose_heads_forward(void* const* slots, int B, int rows, cudaStream_t stream);
cudaError_t nntc_pose_heads_backward(void* const* slots, int B, int rows, cudaStream_t stream);
