// K4: the JPEG decode's device half, by hand for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. Its counterpart in the JAX package is the host
// decode of neuralnet_tracker_traincode_tpu/data/native_loader.py:
// pack_jpeg_batch_gray (native/nntc_loader.cpp:nntc_pack_batch_gray, libjpeg
// to JCS_GRAYSCALE straight into the zero-padded batch). Here the host only
// entropy-decodes (data/csrc/jpeg_entropy.cpp); this kernel does the rest.
//
// What it computes, for image n of the payload (meta[n] = height, width,
// block-grid width gw = ceil(w/8), first block) and each 8x8 tile (ty, tx) of
// its pad x pad slot: where the tile lies in the ceil(h/8) x gw block grid,
// the block's pixels (dequantize, libjpeg-turbo's ISLOW IDCT, + 128, range
// limit), zeroed outside (h, w); elsewhere zeros. A block is its run of
// coefficients in zigzag order up to its last nonzero one,
// coeffs[block_start[b] .. block_start[b + 1]), the rest zero. The arithmetic is what
// libjpeg-turbo's x86 SIMD ISLOW (jidctint-sse2/avx2) computes, as cv2 and the
// JAX package's libjpeg run it (kernels/jpeg.py says where that departs from
// jidctint.c's 64-bit C: 16-bit dequantization and input sums, a saturating
// column pass but for the DC-only shortcut, a saturating range limit). All of
// it fits 32-bit integers: products of 16-bit values by 15-bit constants,
// sums below 2^31. No floating point.
//
// What bounds it on the H100: memory. It writes 1 byte a pixel of the slot
// and reads each block's run and start: at 64 x 448^2, 12.8 MB written and,
// for phase 12a's frames (mostly flat, a run of about one coefficient a
// block), 1.7 MB read, 0.0043 ms at 3.35 TB/s; with every coefficient set
// (noise) 26.5 MB more, 0.0117 ms. The integer work that a payload needs
// (chip_smoke.py:k4_work: a DC-only block is one value, a full block two
// passes) is 0.015 G operations on phase 12a's frames and 0.30 G on noise,
// 0.0005 and 0.0090 ms at 33.5 TOP/s. What the design does about it:
//   - a CTA of 256 threads takes 32 consecutive tiles of one image's slot
//     (grid: ceil(tiles / 32) x N); thread t handles row / column t >> 5 of
//     tile t & 31;
//   - each thread zeroes its row of the block in shared memory, then loads
//     zigzag entries 8r .. 8r + 7 of its block's run where the run has them
//     and scatters them, dequantized (int32), to their natural places, at a
//     stride of 65 words a block so that the column pass (a warp: one column
//     of 32 blocks) and the row pass (one row of 32 blocks) read without bank
//     conflicts;
//   - the column pass works in place in shared memory, the row pass in
//     registers; each thread writes its row's 8 pixels as one 8-byte store,
//     so a warp writes 256 consecutive bytes of an output row where its 32
//     tiles share a tile row;
//   - tiles outside the block grid load nothing and write zeros: the padding
//     costs only its write.
// A simple design: no TMA, no overlap of loads with the passes.

#include "nntc_kernels.h"

namespace {

constexpr int kTiles = 32;           // tiles (8x8 blocks) a CTA
constexpr int kThreads = kTiles * 8;  // one thread a row (column) of each tile
constexpr int kStride = 65;          // shared words a block: 64 + 1 against bank conflicts

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
__constant__ uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                                    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                                    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

__device__ __forceinline__ int low16(int x) { return static_cast<int>(static_cast<int16_t>(x)); }
__device__ __forceinline__ int sat16(int x) { return max(-32768, min(32767, x)); }

// One 1D ISLOW pass over in[0..7] (16-bit values), DESCALEd by `shift`.
template <int shift>
__device__ __forceinline__ void islow_pass(const int (&in)[8], int (&out)[8]) {
    // even part
    const int tmp3 = in[2] * (FIX_0_541196100 + FIX_0_765366865) + in[6] * FIX_0_541196100;
    const int tmp2 = in[2] * FIX_0_541196100 + in[6] * (FIX_0_541196100 - FIX_1_847759065);
    const int tmp0 = low16(in[0] + in[4]) * (1 << CONST_BITS);
    const int tmp1 = low16(in[0] - in[4]) * (1 << CONST_BITS);
    const int t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    // odd part
    const int z3 = low16(in[7] + in[3]), z4 = low16(in[5] + in[1]);
    const int z3p = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
    const int z4p = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
    const int t0 = in[7] * (FIX_0_298631336 - FIX_0_899976223) - in[1] * FIX_0_899976223 + z3p;
    const int t1 = in[5] * (FIX_2_053119869 - FIX_2_562915447) - in[3] * FIX_2_562915447 + z4p;
    const int t2 = -in[5] * FIX_2_562915447 + in[3] * (FIX_3_072711026 - FIX_2_562915447) + z3p;
    const int t3 = -in[7] * FIX_0_899976223 + in[1] * (FIX_1_501321110 - FIX_0_899976223) + z4p;
    constexpr int half = 1 << (shift - 1);
    out[0] = (t10 + t3 + half) >> shift;
    out[7] = (t10 - t3 + half) >> shift;
    out[1] = (t11 + t2 + half) >> shift;
    out[6] = (t11 - t2 + half) >> shift;
    out[2] = (t12 + t1 + half) >> shift;
    out[5] = (t12 - t1 + half) >> shift;
    out[3] = (t13 + t0 + half) >> shift;
    out[4] = (t13 - t0 + half) >> shift;
}

__global__ void __launch_bounds__(kThreads) jpeg_idct_pack_kernel(const int16_t* __restrict__ coeffs,
                                                                  const int32_t* __restrict__ block_start,
                                                                  const int32_t* __restrict__ qtables,
                                                                  const int32_t* __restrict__ meta,
                                                                  uint8_t* __restrict__ out, long num_coeffs,
                                                                  long num_blocks, int pad, int tiles_x,
                                                                  int tiles) {
    __shared__ int blk[kTiles * kStride];
    __shared__ int has_ac[kTiles];

    const int n = blockIdx.y;
    const int b = threadIdx.x & (kTiles - 1);  // the tile of this CTA
    const int r = threadIdx.x >> 5;            // row (load, row pass) or column (column pass)
    const int tile = blockIdx.x * kTiles + b;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int h = __ldg(meta + 4 * n), w = __ldg(meta + 4 * n + 1);
    const int gw = __ldg(meta + 4 * n + 2);
    const long first = __ldg(meta + 4 * n + 3);
    const long block = first + static_cast<long>(ty) * gw + tx;
    bool has_block = tile < tiles && ty < (h + 7) / 8 && tx < gw && block >= 0 && block < num_blocks;
    int start = 0, len = 0;
    if (has_block) {
        start = __ldg(block_start + block);
        len = __ldg(block_start + block + 1) - start;
        has_block = start >= 0 && len >= 1 && len <= 64 && start + len <= num_coeffs;
    }
    int* s = blk + b * kStride;

#pragma unroll
    for (int k = 0; k < 8; ++k) s[r * 8 + k] = 0;
    if (r == 0) has_ac[b] = 0;
    __syncthreads();
    if (has_block) {  // zigzag entries 8r .. 8r + 7 of the run, dequantized, to their natural places
        const int32_t* q = qtables + n * 64;
        bool ac = false;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int j = r * 8 + k;
            if (j < len) {
                const int c = __ldg(coeffs + start + j);
                const int p = kZigzag[j];
                s[p] = low16(c * __ldg(q + p));
                ac |= p >= 8 && c != 0;
            }
        }
        if (ac) has_ac[b] = 1;
    }
    __syncthreads();

    // column pass, in place: thread (b, r) takes column r
    if (has_block) {
        int in[8], o[8];
        if (has_ac[b]) {
#pragma unroll
            for (int k = 0; k < 8; ++k) in[k] = s[k * 8 + r];
            islow_pass<CONST_BITS - PASS1_BITS>(in, o);
#pragma unroll
            for (int k = 0; k < 8; ++k) s[k * 8 + r] = sat16(o[k]);
        } else {  // rows 1-7 all zero: the column is its DC times 4, low 16 bits
            const int dc = low16(s[r] * (1 << PASS1_BITS));
#pragma unroll
            for (int k = 0; k < 8; ++k) s[k * 8 + r] = dc;
        }
    }
    __syncthreads();

    // row pass: thread (b, r) takes row r, and writes it
    const int y = ty * 8 + r;
    if (tile >= tiles || y >= pad) return;
    uint32_t px[2] = {0u, 0u};  // the row's 8 pixels, little-endian
    if (has_block) {
        int in[8], o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) in[k] = s[r * 8 + k];
        islow_pass<CONST_BITS + PASS1_BITS + 3>(in, o);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const bool inside = y < h && tx * 8 + k < w;
            const uint32_t v = inside ? static_cast<uint32_t>(max(-128, min(127, o[k])) + 128) : 0u;
            px[k >> 2] |= v << (8 * (k & 3));
        }
    }
    uint8_t* row = out + (static_cast<long>(n) * pad + y) * pad + tx * 8;
    if ((pad & 7) == 0) {
        *reinterpret_cast<uint2*>(row) = make_uint2(px[0], px[1]);
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (tx * 8 + k < pad) row[k] = static_cast<uint8_t>(px[k >> 2] >> (8 * (k & 3)));
        }
    }
}

}  // namespace

cudaError_t nntc_jpeg_idct_pack(const int16_t* coeffs, const int32_t* block_start, const int32_t* qtables,
                                const int32_t* meta, uint8_t* out, long num_coeffs, long num_blocks, int N, int pad,
                                cudaStream_t stream) {
    const int tiles_x = (pad + 7) / 8;
    const int tiles = tiles_x * tiles_x;
    if (N <= 0 || pad <= 0) return cudaSuccess;
    if (N > 65535) return cudaErrorInvalidValue;
    const dim3 grid((tiles + kTiles - 1) / kTiles, N);
    jpeg_idct_pack_kernel<<<grid, kThreads, 0, stream>>>(coeffs, block_start, qtables, meta, out, num_coeffs,
                                                         num_blocks, pad, tiles_x, tiles);
    return cudaGetLastError();
}
