// K4: the JPEG decode's IDCT half, by hand for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. Its counterpart in the JAX package is the host
// decode of neuralnet_tracker_traincode_tpu/data/native_loader.py:
// pack_jpeg_batch_gray (native/nntc_loader.cpp:nntc_pack_batch_gray, libjpeg
// to JCS_GRAYSCALE straight into the zero-padded batch). Here the host only
// parses, K5 (jpeg_huffman.cu) decodes the scans, and this kernel does the
// rest.
//
// What it computes, for image n (meta[n * meta_cols + 0..3] = height, width,
// block-grid width gw = ceil(w/8), first block) and each 8x8 tile (ty, tx) of
// its pad x pad slot of out (N, pad, pad) uint8: where the tile lies in the
// ceil(h/8) x gw block grid, the block's pixels (dequantize, libjpeg-turbo's
// ISLOW IDCT, + 128, range limit), zeroed outside (h, w); elsewhere zeros.
// Block b is slots[b][0 .. lens[b]) in zigzag order (K5's slots: what lies
// past the length is not read), the rest zero. The arithmetic is what
// libjpeg-turbo's x86 SIMD ISLOW (jidctint-sse2/avx2) computes, as cv2 and the
// JAX package's libjpeg run it (kernels/jpeg.py says where that departs from
// jidctint.c's 64-bit C: 16-bit dequantization and input sums, a saturating
// column pass but for the DC-only shortcut, a saturating range limit). All of
// it fits 32-bit integers. No floating point.
//
// Its bound on the H100 is memory: it writes 1 byte a pixel of the slot
// (12.8 MB at 64 x 448^2) and reads each block's 32-byte sectors up to its
// length (one for a flat block, four for a dense one) and its length byte
// (chip_smoke.py:k4_work counts them, and the integer work a payload needs).
// It runs at about 4x that bound: the passes' integer and shared-memory work
// a block, not HBM, sets its time. Persistent designs with CTA-wide items
// and barriers were slower; this one is on par with the earlier one-CTA-a-
// tile-run design on flat frames and slower on dense ones
// (jpeg_idct_tiles.cu, chip_smoke_jpeg_designs.py, PERF.md). The design:
//   - persistent CTAs, four per SM, of 8 warps; each warp walks its own work
//     items, an item 8 blocks (64 pixels) of an 8-row strip of one image's
//     slot, the grid's warps taking an item each in turn (a warp along whole
//     strips left warps idle and was slower, PERF.md), and no CTA-wide
//     barrier stalls a warp: the warps of an SM hide each other's latency;
//   - each item's slots are staged into the warp's shared memory by 16-byte
//     cp.async copies of only the chunks up to each block's length (four
//     lanes a block, two chunks each), with the image's quantization table,
//     double-buffered: the next item's copies are in flight while this
//     item's passes run, and the lengths of the item after it are loaded
//     meanwhile (a length decides its block's copies, so it is loaded one
//     item ahead of them);
//   - the work follows the data: a block whose slot is its DC alone (most
//     of a flat frame) is one value for its 64 pixels, computed once, with
//     no scatter and no passes; other blocks are dequantized a 16-byte chunk
//     a lane to natural order (65 words a block against bank conflicts),
//     the column pass in place, the row pass in registers into the item's
//     8 x 64 pixels;
//   - each of the item's 8 output rows, the padding's zeros included, is
//     written as 16-byte stores along the row (byte stores where pad is not a
//     multiple of 16); tiles outside the block grid load nothing.

#include <cuda_pipeline.h>

#include "nntc_kernels.h"

namespace {

constexpr int kWarps = 8;  // warps a CTA, each walking its own items
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 4;
constexpr int kItemBlocks = 8;              // blocks (8-pixel columns) an item
constexpr int kItemBytes = kItemBlocks * 8;  // 64 pixels
constexpr int kStride = 65;                 // shared words a block: 64 + 1 against bank conflicts
static_assert(32 == 4 * kItemBlocks, "four lanes stage a block's chunks");

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int ROW_SHIFT = CONST_BITS + PASS1_BITS + 3;  // the row pass's DESCALE
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

// The pixel (range-limited, + 128) of every place of a block whose slot is
// its DC `c` alone, dequantized by `q0`: the column pass's shortcut gives
// its first column low16(dc * 4) and the others zero, so each row pass sees
// (x, 0, ..., 0) and yields (x * 2^13 + half) >> ROW_SHIFT at all 8 places.
__device__ __forceinline__ int dc_only_pixel(int c, int q0) {
    const int x = low16(low16(c * q0) * (1 << PASS1_BITS));
    return max(-128, min(127, (x * (1 << CONST_BITS) + (1 << (ROW_SHIFT - 1))) >> ROW_SHIFT)) + 128;
}

struct Item {
    int n, by, seg, blocks;  // image, block row, segment; blocks of the grid in it (0: zeros)
    int h, w;                // the image's height and width
    long first;              // its first block in the slots
};

__device__ __forceinline__ Item item_of(int item, const int32_t* __restrict__ meta, int meta_cols, int strips,
                                        int segs) {
    Item it;
    it.seg = item % segs;
    const int rest = item / segs;
    it.by = rest % strips;
    it.n = rest / strips;
    const int32_t* m = meta + static_cast<long>(it.n) * meta_cols;
    it.h = __ldg(m);
    it.w = __ldg(m + 1);
    const int gw = __ldg(m + 2);
    const int bx0 = it.seg * kItemBlocks;
    it.blocks = it.by < (it.h + 7) / 8 && bx0 < gw ? min(kItemBlocks, gw - bx0) : 0;
    it.first = __ldg(m + 3) + static_cast<long>(it.by) * gw + bx0;
    return it;
}

// The length (1-64; 0: no block) of block lane / 4 of `it`, loaded one item
// ahead of its copies.
__device__ __forceinline__ int item_len(const Item& it, bool valid, int lane, const uint8_t* __restrict__ lens,
                                        long num_blocks) {
    const int i = lane >> 2;
    if (!valid || i >= it.blocks) return 0;
    const long b = it.first + i;
    return b < num_blocks ? max(1, min(64, static_cast<int>(__ldg(lens + b)))) : 0;
}

// A warp's shared memory: two items' staging, one item's blocks and pixels.
struct WarpShared {
    int4 stage[2][kItemBlocks * 8];  // each block's 64 coefficients, as 8 chunks of 16 bytes
    int32_t q[2][64];                // the item's quantization table
    int blk[kItemBlocks * kStride];  // dequantized, natural order, then the column pass's output
    __align__(16) uint8_t px[8][kItemBytes];
    int dcv[kItemBlocks];  // a DC-only block's pixel
    int has_ac[kItemBlocks];
    uint8_t slen[2][kItemBlocks];
};

// Put `it`'s slot chunks up to each block's length in flight into the
// warp's buffer `b` (16-byte cp.async; lane l: block l / 4, chunks 2 (l % 4)
// and the next), its image's quantization table, the lengths into `slen`;
// one commit a lane.
__device__ __forceinline__ void stage_item(WarpShared& ws, int b, const Item& it, bool valid, int len, int lane,
                                           const int16_t* __restrict__ slots, const int32_t* __restrict__ qtables) {
    const int i = lane >> 2, c0 = (lane & 3) * 2;
    if ((lane & 3) == 0) ws.slen[b][i] = static_cast<uint8_t>(len);
    const int4* src = reinterpret_cast<const int4*>(slots + (it.first + i) * 64);
    for (int c = c0; c < c0 + 2 && c * 8 < len; ++c) __pipeline_memcpy_async(&ws.stage[b][i * 8 + c], &src[c], 16);
    if (valid && it.blocks) {
        __pipeline_memcpy_async(&ws.q[b][lane], qtables + it.n * 64 + lane, 4);
        __pipeline_memcpy_async(&ws.q[b][lane + 32], qtables + it.n * 64 + lane + 32, 4);
    }
    __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm) jpeg_idct_pack_kernel(
    const int16_t* __restrict__ slots, const uint8_t* __restrict__ lens, const int32_t* __restrict__ qtables,
    const int32_t* __restrict__ meta, uint8_t* __restrict__ out, long num_blocks, int meta_cols, int pad,
    int strips, int segs, int items) {
    __shared__ WarpShared shared[kWarps];
    __shared__ uint8_t zz[64];

    const int lane = threadIdx.x & 31;
    WarpShared& ws = shared[threadIdx.x >> 5];
    if (threadIdx.x < 64) zz[threadIdx.x] = kZigzag[threadIdx.x];
    __syncthreads();  // the one CTA-wide barrier
    const int stride = gridDim.x * kWarps;
    int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
    int buf = 0;
    Item it = item_of(item < items ? item : 0, meta, meta_cols, strips, segs);
    stage_item(ws, 0, it, item < items, item_len(it, item < items, lane, lens, num_blocks), lane, slots, qtables);
    int next = item + stride;
    Item nx = item_of(next < items ? next : 0, meta, meta_cols, strips, segs);
    int nx_len = item_len(nx, next < items, lane, lens, num_blocks);
    while (item < items) {
        stage_item(ws, buf ^ 1, nx, next < items, nx_len, lane, slots, qtables);
        const int after = next + stride;  // its lengths in flight while this item runs
        const Item af = item_of(after < items ? after : 0, meta, meta_cols, strips, segs);
        const int af_len = item_len(af, after < items, lane, lens, num_blocks);
        if (lane < kItemBlocks) ws.has_ac[lane] = 0;
        __pipeline_wait_prior(1);  // this item's chunks (each lane waits for its own copies)
        __syncwarp();

        // dequantize: task (block i, group g) takes zigzag entries 8g .. 8g + 7 (one 16-byte chunk), zero
        // past the length; a block of its DC alone: its one pixel value
        const uint8_t* ln = ws.slen[buf];
        const int32_t* q = ws.q[buf];
        for (int task = lane; task < it.blocks * 8; task += 32) {
            const int i = task >> 3, g = task & 7;
            const int len = ln[i];
            if (len <= 1) {
                if (len == 1 && g == 0)
                    ws.dcv[i] = dc_only_pixel(reinterpret_cast<const int16_t*>(&ws.stage[buf][i * 8])[0], q[0]);
                continue;
            }
            const int4 chunk = g * 8 < len ? ws.stage[buf][i * 8 + g] : make_int4(0, 0, 0, 0);
            const uint32_t wd[4] = {static_cast<uint32_t>(chunk.x), static_cast<uint32_t>(chunk.y),
                                    static_cast<uint32_t>(chunk.z), static_cast<uint32_t>(chunk.w)};
            int* s = ws.blk + i * kStride;
            bool ac = false;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int z = g * 8 + j;
                const int c = z < len ? static_cast<int16_t>(wd[j >> 1] >> (16 * (j & 1))) : 0;
                const int p = zz[z];
                s[p] = low16(c * q[p]);
                ac |= p >= 8 && c != 0;
            }
            if (ac) ws.has_ac[i] = 1;
        }
        __syncwarp();

        // column pass, in place: task (column c, block i), the blocks with terms past their DC
        for (int task = lane; task < kItemBlocks * 8; task += 32) {
            const int i = task & (kItemBlocks - 1), c = task / kItemBlocks;
            if (i >= it.blocks || ln[i] <= 1) continue;
            int* s = ws.blk + i * kStride;
            if (ws.has_ac[i]) {
                int in[8], o[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) in[k] = s[k * 8 + c];
                islow_pass<CONST_BITS - PASS1_BITS>(in, o);
#pragma unroll
                for (int k = 0; k < 8; ++k) s[k * 8 + c] = sat16(o[k]);
            } else {  // rows 1-7 all zero: the column is its DC times 4, low 16 bits
                const int dc = low16(s[c] * (1 << PASS1_BITS));
#pragma unroll
                for (int k = 0; k < 8; ++k) s[k * 8 + c] = dc;
            }
        }
        __syncwarp();

        // row pass: task (row r, 8-pixel column i of the item) writes its 8 pixels
        for (int task = lane; task < kItemBlocks * 8; task += 32) {
            const int i = task & (kItemBlocks - 1), r = task / kItemBlocks;
            const int y = it.by * 8 + r, x0 = (it.seg * kItemBlocks + i) * 8;
            const int len = i < it.blocks ? ln[i] : 0;
            uint32_t lo = 0u, hi = 0u;
            if (len == 1) {
                const uint32_t v = static_cast<uint32_t>(ws.dcv[i]);
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const uint32_t p = y < it.h && x0 + k < it.w ? v : 0u;
                    if (k < 4) lo |= p << (8 * k); else hi |= p << (8 * (k - 4));
                }
            } else if (len) {
                int in[8], o[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) in[k] = ws.blk[i * kStride + r * 8 + k];
                islow_pass<ROW_SHIFT>(in, o);
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const bool inside = y < it.h && x0 + k < it.w;
                    const uint32_t v = inside ? static_cast<uint32_t>(max(-128, min(127, o[k])) + 128) : 0u;
                    if (k < 4) lo |= v << (8 * k); else hi |= v << (8 * (k - 4));
                }
            }
            *reinterpret_cast<uint2*>(&ws.px[r][i * 8]) = make_uint2(lo, hi);
        }
        __syncwarp();

        // the item's 8 rows along its width, the padding included (the next item's row pass writes px only
        // after two more of the warp's barriers)
        const int x_begin = it.seg * kItemBytes, width = min(kItemBytes, pad - x_begin);
        const int rows = min(8, pad - it.by * 8);
        uint8_t* dst = out + (static_cast<long>(it.n) * pad + it.by * 8) * pad + x_begin;
        if ((pad & 15) == 0) {
            const int r = lane >> 2, v = lane & 3;
            if (r < rows && v * 16 < width)
                *reinterpret_cast<int4*>(dst + static_cast<long>(r) * pad + v * 16) =
                    *reinterpret_cast<const int4*>(&ws.px[r][v * 16]);
        } else {
            for (int task = lane; task < rows * width; task += 32) {
                const int r = task / width, x = task - r * width;
                dst[static_cast<long>(r) * pad + x] = ws.px[r][x];
            }
        }
        item = next;
        it = nx;
        next = after;
        nx = af;
        nx_len = af_len;
        buf ^= 1;
    }
    __pipeline_wait_prior(0);
}

}  // namespace

cudaError_t nntc_jpeg_idct_pack(const int16_t* slots, const uint8_t* lens, const int32_t* qtables,
                                const int32_t* meta, uint8_t* out, long num_blocks, int meta_cols, int N, int pad,
                                cudaStream_t stream) {
    if (N <= 0 || pad <= 0) return cudaSuccess;
    if (meta_cols < 4 || reinterpret_cast<uintptr_t>(slots) % 16) return cudaErrorInvalidValue;
    const int strips = (pad + 7) / 8;
    const int segs = (strips + kItemBlocks - 1) / kItemBlocks;
    const long items = static_cast<long>(N) * strips * segs;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long grid = min((items + kWarps - 1) / kWarps, static_cast<long>(kCtasPerSm) * max(sms, 1));
    if (items + 2 * grid * kWarps > 0x7fffffffL) return cudaErrorInvalidValue;
    jpeg_idct_pack_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        slots, lens, qtables, meta, out, num_blocks, meta_cols, pad, strips, segs, static_cast<int>(items));
    return cudaGetLastError();
}
