// K4's earlier design on K5's slots, kept to compare the two designs: not
// part of the extension (kernels/ext.py does not build it). chip_smoke_jpeg_designs.py
// builds it by nvcc with a plain C entry and times it beside
// nntc_jpeg_idct_pack on the same slots; both compute the same function
// (jpeg_idct.cu says which), bit for bit.
//
// The design (the kernel of jpeg_idct.cu before its redesign, reading slots
// in place of coefficient runs): a CTA of 256 threads takes 32 consecutive
// tiles of one image's slot (grid: ceil(tiles / 32) x N); thread t handles
// row / column t >> 5 of tile t & 31. Each thread zeroes its row of the
// block in shared memory, loads the 16-byte chunk of zigzag entries
// 8r .. 8r + 7 of its block's slot where the length reaches it and scatters
// them, dequantized, to their natural places; the column pass works in
// place, the row pass in registers; each thread writes its row's 8 pixels
// as one 8-byte store. No staging, no overlap of loads with the passes.

#include "jpeg_idct.cu"

namespace {

constexpr int kTiles = 32;              // tiles (8x8 blocks) a CTA
constexpr int kTileThreads = kTiles * 8;  // one thread a row (column) of each tile

__global__ void __launch_bounds__(kTileThreads) jpeg_idct_tiles_kernel(
    const int16_t* __restrict__ slots, const uint8_t* __restrict__ lens, const int32_t* __restrict__ qtables,
    const int32_t* __restrict__ meta, uint8_t* __restrict__ out, long num_blocks, int meta_cols, int pad,
    int tiles_x, int tiles) {
    __shared__ int blk[kTiles * kStride];
    __shared__ int has_ac[kTiles];

    const int n = blockIdx.y;
    const int b = threadIdx.x & (kTiles - 1);
    const int r = threadIdx.x >> 5;
    const int tile = blockIdx.x * kTiles + b;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int32_t* m = meta + static_cast<long>(n) * meta_cols;
    const int h = __ldg(m), w = __ldg(m + 1), gw = __ldg(m + 2);
    const long block = __ldg(m + 3) + static_cast<long>(ty) * gw + tx;
    const bool has_block = tile < tiles && ty < (h + 7) / 8 && tx < gw && block >= 0 && block < num_blocks;
    const int len = has_block ? max(1, min(64, static_cast<int>(__ldg(lens + block)))) : 0;
    int* s = blk + b * kStride;

#pragma unroll
    for (int k = 0; k < 8; ++k) s[r * 8 + k] = 0;
    if (r == 0) has_ac[b] = 0;
    __syncthreads();
    if (r * 8 < len) {  // zigzag entries 8r .. 8r + 7, dequantized, to their natural places
        const int4 chunk = __ldg(reinterpret_cast<const int4*>(slots + block * 64) + r);
        const uint32_t wd[4] = {static_cast<uint32_t>(chunk.x), static_cast<uint32_t>(chunk.y),
                                static_cast<uint32_t>(chunk.z), static_cast<uint32_t>(chunk.w)};
        const int32_t* q = qtables + n * 64;
        bool ac = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int z = r * 8 + j;
            if (z < len) {
                const int c = static_cast<int16_t>(wd[j >> 1] >> (16 * (j & 1)));
                const int p = kZigzag[z];
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
        islow_pass<ROW_SHIFT>(in, o);
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

// The CTAs of a design's kernel that fit an SM at once.
extern "C" int jpeg_idct_design_ctas_per_sm(int design) {
    int ctas = 0;
    if (design == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, jpeg_idct_pack_kernel, kThreads, 0);
    else
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, jpeg_idct_tiles_kernel, kTileThreads, 0);
    return ctas;
}

// The two designs through one C interface: `design` 0 the shipped kernel
// (nntc_jpeg_idct_pack), 1 this file's.
extern "C" int jpeg_idct_design(int design, const int16_t* slots, const uint8_t* lens, const int32_t* qtables,
                                const int32_t* meta, uint8_t* out, long num_blocks, int meta_cols, int N, int pad,
                                cudaStream_t stream) {
    if (design == 0)
        return static_cast<int>(nntc_jpeg_idct_pack(slots, lens, qtables, meta, out, num_blocks, meta_cols, N, pad,
                                                    stream));
    if (N <= 0 || pad <= 0) return 0;
    if (N > 65535 || meta_cols < 4 || reinterpret_cast<uintptr_t>(slots) % 16) return cudaErrorInvalidValue;
    const int tiles_x = (pad + 7) / 8;
    const int tiles = tiles_x * tiles_x;
    const dim3 grid((tiles + kTiles - 1) / kTiles, N);
    jpeg_idct_tiles_kernel<<<grid, kTileThreads, 0, stream>>>(slots, lens, qtables, meta, out, num_blocks, meta_cols,
                                                              pad, tiles_x, tiles);
    return static_cast<int>(cudaGetLastError());
}
