// K1: the training crop warp, by hand for Hopper (sm_90a).
//
// Replaces: neuralnet_tracker_traincode_tpu/augmentation/warp_pallas.py:
//   warp_roi_rotate_pallas (body _warp_kernel, helpers _tri_weights,
//   _barrel_shear_rows, _barrel_shear_cols).
//
// What it computes, per sample b with params [y0', sy, x0', sx, a, b]:
//   1. canvas = wy . img . wx^T: a separable triangle-filter resample of the
//      uint8 source onto a CS x CS canvas, filter support max(|scale|, 1)
//      (antialiased when minifying), each weight divided by its row sum
//      + 1e-8 as _tri_weights does. A negative scale (a folded flip) walks the
//      source backwards; only the support uses |scale|.
//   2. unless rotate == 0: three Paeth shears, rows by a, columns by b, rows
//      by a; each is a 2-tap lerp at a per-line fractional shift with zero
//      fill at that stage's bounds [0, CS).
//   3. the centre S x S crop.
//
// What bounds it on the H100: memory. The function reads B*H*W bytes and
// writes B*S*S*4 bytes (17.1 MB at B=64, 448^2 -> 129^2: about 5 us at
// 3.35 TB/s); its arithmetic (about 2 MFLOP a sample) is far below the f32
// rate. What the design does about it: one launch, and the canvas never
// leaves the chip.
//   - One sample per cluster of 2 CTAs. Each CTA resamples half of the canvas
//     rows into its own shared memory (113 x 225 f32 = 101.7 KB at CS = 225).
//   - The taps are computed once: a table of the horizontal taps of every
//     canvas column (window start and weights) and one of the vertical taps
//     of every canvas row of the CTA, each weight times one reciprocal of its
//     row norm.
//   - The resample runs over chunks of canvas rows. The band of source rows
//     a chunk needs, cut to the source columns the canvas touches, is copied
//     into shared memory with 16-byte cp.async while the chunk before it is
//     filtered (two buffers), so each source byte comes from device memory
//     about once per CTA. A chunk is filtered vertically into a row buffer
//     (16 source columns and one 16-byte load a tap per thread, each byte
//     turned into a float by a byte permute and one subtraction), then
//     horizontally into the canvas (the weights of a column in registers,
//     8 canvas rows a thread, the row buffer read in float2 pairs).
//   - The three shears and the crop are one pull: output pixel (r, q) lerps
//     2 values of stage 2, which lerp 4 of stage 1, which lerp 8 of the
//     canvas, with each stage's zero fill (stage 1 on the canvas column,
//     stage 2 on the row, stage 3 on the column). Neighbouring outputs share
//     a stage-2 value: a warp covers 31 outputs of a row, each lane pulls one
//     stage-2 value and takes the second from the next lane by a shuffle.
//     Rows of the partner CTA's half come through distributed shared memory;
//     a cluster barrier after both halves are written, and one before either
//     CTA exits.
//   - With rotate == 0 (CS == S) the resample writes the output directly.
// The shared memory a CTA takes depends on the batch's largest |scale|
// (taps, band rows); kernels/warp.py:launch_plan sizes it with the same
// formula as make_layout below and raises when it does not fit.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "nntc_kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 8;  // canvas rows one thread filters horizontally
constexpr int kSegment = 31;       // outputs a warp finishes per row segment: lane 31 only feeds lane 30
constexpr int kTapGroup = 8;       // horizontal taps held in registers at a time
constexpr int kMaxSharedBytes = 232448;

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets into one CTA's dynamic shared memory.
struct Layout {
    int canvas, xw, xs, yw, ys, mid, band, total;
    int rows;        // canvas rows of the larger half
    int tpad;        // horizontal window: taps + 1 (an even start) rounded up to kTapGroup
    int band_pitch;  // bytes per staged source row: W rounded up to 16
    int mid_pitch;   // floats per vertically filtered row: band_pitch + tpad
};

inline int take(int& off, int bytes) {
    const int o = off;
    off += round_up(bytes, 16);
    return o;
}

Layout make_layout(int W, int CS, int rotate, int taps_x, int taps_y, int chunk, int band_rows) {
    Layout L;
    L.rows = (CS + 1) / 2;
    L.tpad = round_up(taps_x + 1, kTapGroup);
    L.band_pitch = round_up(W, 16);
    L.mid_pitch = L.band_pitch + L.tpad;
    int off = 0;
    L.canvas = take(off, rotate ? L.rows * CS * 4 : 0);
    L.xw = take(off, L.tpad * CS * 4);
    L.xs = take(off, CS * 4);
    L.yw = take(off, L.rows * taps_y * 4);
    L.ys = take(off, L.rows * 4);
    L.mid = take(off, chunk * L.mid_pitch * 4);
    L.band = take(off, 2 * band_rows * L.band_pitch);
    L.total = off;
    return L;
}

struct Args {
    const uint8_t* img;
    const float* params;
    float* out;
    int H, W, S, CS, taps_x, taps_y, chunk, band_rows, aligned16;
    Layout L;
};

// Continuous source position of output sample c, rounded as the plain
// version's start + scale * (c + 0.5) (no fused multiply-add).
__device__ __forceinline__ float sample_pos(float start, float scale, int c) {
    return __fadd_rn(start, __fmul_rn(scale, (float)c + 0.5f));
}

// First source index whose triangle weight can be nonzero: h > p - 0.5 - supp.
__device__ __forceinline__ int first_tap(float p, float supp) { return (int)floorf(p - 0.5f - supp) + 1; }

__device__ __forceinline__ float tri_weight(int h, float p, float inv_supp) {
    return fmaxf(0.0f, 1.0f - fabsf(((float)h + 0.5f - p) * inv_supp));
}

// First row of the vertical window of a canvas row: the first tap moved
// into [0, H - taps] (its weights follow it), so every tap is a source row.
__device__ __forceinline__ int row_window(float p, float supp, int H, int taps) {
    return min(max(first_tap(p, supp), 0), max(H - taps, 0));
}

// Shear shift of line i, coef * ((i + 0.5) - CS / 2), as the plain version
// rounds it: returns the fraction, k gets the floor. Computed where it is
// used, so it needs no table in shared memory.
__device__ __forceinline__ float shear_shift(float coef, int i, float half_cs, int& k) {
    const float s = coef * (((float)i + 0.5f) - half_cs);
    const float fl = floorf(s);
    k = (int)fl;
    return s - fl;
}

// Byte k of v as a float, exactly: 0x4B0000vv is 2^23 + vv.
__device__ __forceinline__ float byte_to_float(uint32_t v, int k) {
    return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | k)) - 8388608.0f;
}

// Stage source rows [blo, blo + nb), columns [c0, c0 + wb), into dst (pitch
// bytes per row): 16-byte cp.async where the source allows, zeros past W.
__device__ __forceinline__ void stage_band(uint8_t* dst, const uint8_t* src, int W, int pitch, int blo, int nb,
                                           int c0, int wb, bool aligned16) {
    const int segs = wb / 16;
    for (int i = threadIdx.x; i < nb * segs; i += kThreads) {
        const int r = i / segs, s = i - r * segs;
        const int col = c0 + 16 * s;
        uint8_t* d = dst + r * pitch + 16 * s;
        const uint8_t* g = src + (size_t)(blo + r) * W + col;
        if (aligned16 && col + 16 <= W) {
            __pipeline_memcpy_async(d, g, 16);
        } else {
            for (int e = 0; e < 16; ++e) d[e] = (col + e < W) ? g[e] : (uint8_t)0;
        }
    }
    __pipeline_commit();
}

// Source rows [blo, blo + nb) that canvas rows [row0 + cb, row0 + ce) tap.
__device__ __forceinline__ void band_range(float y0, float sy, float supp, int row0, int cb, int ce, int H,
                                           int taps_y, int band_rows, int& blo, int& nb) {
    const int lo_a = row_window(sample_pos(y0, sy, row0 + cb), supp, H, taps_y);
    const int lo_b = row_window(sample_pos(y0, sy, row0 + ce - 1), supp, H, taps_y);
    blo = max(0, min(lo_a, lo_b));
    const int bhi = min(H, max(lo_a, lo_b) + taps_y);
    nb = min(max(0, bhi - blo), band_rows);
}

template <bool ROTATE>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1) warp_roi_rotate_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / 2;
    const int tid = threadIdx.x;
    const int H = a.H, W = a.W, CS = a.CS;
    const Layout& L = a.L;
    float* canvas = reinterpret_cast<float*>(smem + L.canvas);  // rows [row0, row0 + nrows)
    float* xw = reinterpret_cast<float*>(smem + L.xw);          // [tpad][CS] horizontal weights
    int* xs = reinterpret_cast<int*>(smem + L.xs);              // [CS] window start, relative to c0
    float* yw = reinterpret_cast<float*>(smem + L.yw);          // [rows][taps_y] vertical weights
    int* ys = reinterpret_cast<int*>(smem + L.ys);              // [rows] first source row
    float* mid = reinterpret_cast<float*>(smem + L.mid);        // [chunk][mid_pitch]
    uint8_t* band = smem + L.band;                              // [2][band_rows][band_pitch]

    const float* prm = a.params + 6 * b;
    const uint8_t* src = a.img + (size_t)b * H * W;
    const float y0 = prm[0], sy = prm[1], x0 = prm[2], sx = prm[3];
    const float supp_y = fmaxf(fabsf(sy), 1.0f), supp_x = fmaxf(fabsf(sx), 1.0f);
    const float inv_y = 1.0f / supp_y, inv_x = 1.0f / supp_x;
    const int row0 = rank * L.rows;
    const int nrows = min(CS, row0 + L.rows) - row0;
    const int chunk = a.chunk;
    const int nchunks = (nrows + chunk - 1) / chunk;

    // Source columns [c0, c0 + wb) that hold every in-source tap of every
    // canvas column (the first taps are monotonic in the column).
    const int lo_l = first_tap(sample_pos(x0, sx, 0), supp_x);
    const int lo_r = first_tap(sample_pos(x0, sx, CS - 1), supp_x);
    const int cx0 = min(W, max(0, min(lo_l, lo_r)));
    const int cx1 = min(W, max(lo_l, lo_r) + a.taps_x);
    const int c0 = cx0 & ~15;
    const int wb = max(16, (cx1 - c0 + 15) & ~15);

    // the first band is in flight while the tables are built
    int blo = 0, nb = 0;
    if (nchunks > 0) {
        band_range(y0, sy, supp_y, row0, 0, min(chunk, nrows), H, a.taps_y, a.band_rows, blo, nb);
        stage_band(band, src, W, L.band_pitch, blo, nb, c0, wb, a.aligned16);
    }

    // Horizontal taps: the taps [lo, lo + taps_x) moved into [c0, c0 + wb)
    // still hold every in-source tap with a nonzero weight; the window starts
    // at the even index at or below lo, so that it is read in float2 pairs.
    for (int j = tid; j < CS; j += kThreads) {
        const float p = sample_pos(x0, sx, j);
        const int lo = min(max(first_tap(p, supp_x), c0), c0 + wb - 1);
        const int start = lo & ~1;
        xs[j] = start - c0;
        float sum = 0.0f;
        for (int t = 0; t < L.tpad; ++t) {
            const int h = start + t;
            const float w = (h >= lo && h < lo + a.taps_x && h < W) ? tri_weight(h, p, inv_x) : 0.0f;
            xw[t * CS + j] = w;
            sum += w;
        }
        const float r = 1.0f / (sum + 1e-8f);
        for (int t = 0; t < L.tpad; ++t) xw[t * CS + j] *= r;
    }
    // Vertical taps of this CTA's canvas rows; taps outside [0, H) weigh 0.
    for (int lr = tid; lr < nrows; lr += kThreads) {
        const float p = sample_pos(y0, sy, row0 + lr);
        const int lo = row_window(p, supp_y, H, a.taps_y);
        ys[lr] = lo;
        float* w = yw + lr * a.taps_y;
        float sum = 0.0f;
        for (int t = 0; t < a.taps_y; ++t) {
            const int h = lo + t;
            w[t] = (h >= 0 && h < H) ? tri_weight(h, p, inv_y) : 0.0f;
            sum += w[t];
        }
        const float r = 1.0f / (sum + 1e-8f);
        for (int t = 0; t < a.taps_y; ++t) w[t] *= r;
    }
    // the padding past wb of the row buffer is read with weight 0: keep it 0
    for (int i = tid; i < chunk * L.mid_pitch; i += kThreads)
        if (i % L.mid_pitch >= wb) mid[i] = 0.0f;

    const int groups = wb / 16;
    for (int k = 0; k < nchunks; ++k) {
        const int cb = k * chunk, ce = min(nrows, cb + chunk), kc = ce - cb;
        const int cur_blo = blo;
        __pipeline_wait_prior(0);
        __syncthreads();  // band k landed; chunk k - 1 is done with the row buffer and the other band
        if (k + 1 < nchunks) {
            band_range(y0, sy, supp_y, row0, ce, min(nrows, ce + chunk), H, a.taps_y, a.band_rows, blo, nb);
            stage_band(band + ((k + 1) & 1) * a.band_rows * L.band_pitch, src, W, L.band_pitch, blo, nb, c0, wb,
                       a.aligned16);
        }
        // vertical: 16 source columns a thread, one 16-byte shared load a tap;
        // the band holds every row of the chunk's windows
        const uint8_t* bb = band + (k & 1) * a.band_rows * L.band_pitch;
        for (int i = tid; i < kc * groups; i += kThreads) {
            const int kk = i / groups, g = i - kk * groups;
            const int lr = cb + kk;
            const uint8_t* col = bb + (ys[lr] - cur_blo) * L.band_pitch + 16 * g;
            const float* w = yw + lr * a.taps_y;
            float acc[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
            for (int t = 0; t < a.taps_y; ++t) {
                const uint4 v = *reinterpret_cast<const uint4*>(col + t * L.band_pitch);
                const float wt = w[t];
                const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 16; ++e) acc[e] = fmaf(wt, byte_to_float(vv[e / 4], e % 4), acc[e]);
            }
            float4* m = reinterpret_cast<float4*>(mid + kk * L.mid_pitch + 16 * g);
#pragma unroll
            for (int e = 0; e < 4; ++e) m[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
        }
        __syncthreads();
        // horizontal: one canvas column and up to 8 rows a thread, the row
        // buffer read in float2 pairs
        const int row_groups = (kc + kRowsPerThread - 1) / kRowsPerThread;
        for (int i = tid; i < CS * row_groups; i += kThreads) {
            const int g = i / CS, j = i - g * CS;
            const int rbase = g * kRowsPerThread;
            const float* m0 = mid + rbase * L.mid_pitch + xs[j];
            float acc[kRowsPerThread];
#pragma unroll
            for (int rr = 0; rr < kRowsPerThread; ++rr) acc[rr] = 0.0f;
            for (int t0 = 0; t0 < L.tpad; t0 += kTapGroup) {
                float w[kTapGroup];
#pragma unroll
                for (int u = 0; u < kTapGroup; ++u) w[u] = xw[(t0 + u) * CS + j];
#pragma unroll
                for (int rr = 0; rr < kRowsPerThread; ++rr) {
                    if (rbase + rr < kc) {
                        const float2* m = reinterpret_cast<const float2*>(m0 + rr * L.mid_pitch + t0);
#pragma unroll
                        for (int u = 0; u < kTapGroup / 2; ++u) {
                            const float2 v = m[u];
                            acc[rr] = fmaf(w[2 * u], v.x, acc[rr]);
                            acc[rr] = fmaf(w[2 * u + 1], v.y, acc[rr]);
                        }
                    }
                }
            }
#pragma unroll
            for (int rr = 0; rr < kRowsPerThread; ++rr) {
                if (rbase + rr < kc) {
                    const int lr = cb + rbase + rr;
                    if (ROTATE)
                        canvas[lr * CS + j] = acc[rr];
                    else
                        a.out[((size_t)b * CS + row0 + lr) * CS + j] = acc[rr];
                }
            }
        }
    }
    if (!ROTATE) return;

    cluster.sync();  // both halves of the canvas are written and visible to the cluster
    const float* remote = cluster.map_shared_rank(canvas, rank ^ 1);
    const float* top = rank == 0 ? canvas : remote;     // canvas rows [0, rows)
    const float* bottom = rank == 0 ? remote : canvas;  // canvas rows [rows, CS)
    const int S = a.S;
    const int lo = (CS - S) / 2;
    const int out_half = (S + 1) / 2;
    const int r0 = rank * out_half, nr = min(S, r0 + out_half) - r0;
    const int nseg = (S + kSegment - 1) / kSegment;
    const int lane = tid % 32;
    const float a_row = prm[4], b_col = prm[5], half_cs = 0.5f * (float)CS;
    // A warp takes a segment of an output row. Lane l pulls the stage-2 value
    // that output q = q0 + l lerps first (2 stage-1 values, 4 canvas values)
    // and takes the one it lerps second from lane l + 1.
    for (int item = tid / 32; item < nr * nseg; item += kThreads / 32) {
        const int r = r0 + item / nseg, q = (item % nseg) * kSegment + lane;
        const int y = lo + r;
        int k3, k2, k1;
        const float f3 = shear_shift(a_row, y, half_cs, k3);
        const int x = lo + q + k3;  // stage 3: row y shifted by a
        float s2 = 0.0f;
        if (x >= 0 && x < CS) {  // stage 3's zero fill: the column
            const float f2 = shear_shift(b_col, x, half_cs, k2);
            const int ya = y + k2;  // stage 2: column x shifted by b
            float v2[2];
#pragma unroll
            for (int d = 0; d < 2; ++d) {
                const int yy = ya + d;
                float s1 = 0.0f;
                if (yy >= 0 && yy < CS) {  // stage 2's zero fill: the row
                    const float f1 = shear_shift(a_row, yy, half_cs, k1);
                    const int xx = x + k1;  // stage 1: row yy shifted by a
                    const float* line = yy < L.rows ? top + yy * CS : bottom + (yy - L.rows) * CS;
                    const float c0v = (xx >= 0 && xx < CS) ? line[xx] : 0.0f;  // stage 1's zero fill
                    const float c1v = (xx + 1 >= 0 && xx + 1 < CS) ? line[xx + 1] : 0.0f;
                    s1 = (1.0f - f1) * c0v + f1 * c1v;
                }
                v2[d] = s1;
            }
            s2 = (1.0f - f2) * v2[0] + f2 * v2[1];
        }
        const float s2_next = __shfl_down_sync(0xffffffffu, s2, 1);
        if (lane < kSegment && q < S) {
            a.out[((size_t)b * S + r) * S + q] = (1.0f - f3) * s2 + f3 * s2_next;
        }
    }
    cluster.sync();  // the partner has finished reading this CTA's half
}

}  // namespace

cudaError_t nntc_warp_roi_rotate(const uint8_t* img, const float* params, float* out, int B, int H, int W, int S,
                                 int CS, int rotate, int taps_x, int taps_y, int chunk, int band_rows,
                                 cudaStream_t stream) {
    if (B == 0) return cudaSuccess;
    if ((!rotate && CS != S) || taps_x < 1 || taps_y < 1 || chunk < 1 || band_rows < 1) return cudaErrorInvalidValue;
    Args a;
    a.img = img;
    a.params = params;
    a.out = out;
    a.H = H;
    a.W = W;
    a.S = S;
    a.CS = CS;
    a.taps_x = taps_x;
    a.taps_y = taps_y;
    a.chunk = chunk;
    a.band_rows = band_rows;
    a.aligned16 = (W % 16 == 0) && (reinterpret_cast<uintptr_t>(img) % 16 == 0);
    a.L = make_layout(W, CS, rotate, taps_x, taps_y, chunk, band_rows);
    if (a.L.total > kMaxSharedBytes) return cudaErrorInvalidValue;
    void (*kernel)(const Args) = rotate ? warp_roi_rotate_kernel<true> : warp_roi_rotate_kernel<false>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.total);
    if (e != cudaSuccess) return e;
    kernel<<<2 * B, kThreads, a.L.total, stream>>>(a);
    return cudaGetLastError();
}
