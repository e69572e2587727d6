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
//      + 1e-8 exactly as _tri_weights does. A negative scale (a folded flip)
//      walks the source backwards; only the support uses |scale|.
//   2. unless rotate == 0: three Paeth shears, rows by a, columns by b, rows
//      by a; each is a 2-tap lerp at a per-line fractional shift with zero fill.
//   3. the centre S x S crop.
//
// What bounds it on the H100: memory. The function reads B*H*W bytes and
// writes B*S*S*4 bytes (17.1 MB at B=64, 448^2 -> 129^2: about 5 us at
// 3.35 TB/s); its arithmetic (about 2 MFLOP a sample) is far below the f32
// rate. What the design does about it: the source is read once as uint8
// (1 B/px; the TPU kernel's bf16 cast is not carried over) and the resample
// is a banded filter: each canvas pixel touches only the
// 2*ceil(max(|scale|,1))+1 taps that are nonzero, not a dense 225x448
// product. The 225^2 f32 canvas (202.5 KB) leaves no room for a second buffer
// in one block's shared memory, so this first version keeps it in a global
// scratch (B x 225^2 f32, 13 MB, which stays in the 50 MB L2) and runs three
// launches, each parallel over lines:
//   A. one block per (canvas row, sample): vertical taps into a shared row of
//      W floats, horizontal taps into a shared canvas row, first row shear;
//   B. one block per (32-column tile, sample): the column shear in a shared
//      CS x 32 tile, in place;
//   C. one block per (output row, sample): the last row shear fused with the
//      crop, written straight to the output.
// Keeping the canvas in shared memory across the three passes is later work.

#include "nntc_kernels.h"

namespace {

struct Taps {
    float p;     // continuous source position of the output sample
    float supp;  // filter half-width
    int lo, hi;  // inclusive range of source indices with nonzero weight
    float norm;  // sum of weights + 1e-8
};

__device__ __forceinline__ float tri_weight(int h, float p, float supp) {
    const float t = ((float)h + 0.5f - p) / supp;
    return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Taps of output index c along an axis of n_src source samples.
__device__ __forceinline__ Taps tri_taps(float start, float scale, int c, int n_src) {
    Taps t;
    t.p = start + scale * ((float)c + 0.5f);
    t.supp = fmaxf(fabsf(scale), 1.0f);
    // weight > 0 only where |h + 0.5 - p| < supp; one extra index on each side
    // costs nothing (its weight is 0) and keeps the range robust to rounding
    t.lo = max(0, (int)floorf(t.p - 0.5f - t.supp) - 1);
    t.hi = min(n_src - 1, (int)ceilf(t.p - 0.5f + t.supp) + 1);
    float sum = 0.0f;
    for (int h = t.lo; h <= t.hi; ++h) sum += tri_weight(h, t.p, t.supp);
    t.norm = sum + 1e-8f;
    return t;
}

// 2-tap lerp of line[j + s] with zero fill outside [0, n), s = k0 + f.
__device__ __forceinline__ float lerp_zero(const float* line, int j, int k0, float f, int n, int stride) {
    const int i0 = j + k0;
    const float v0 = (i0 >= 0 && i0 < n) ? line[i0 * stride] : 0.0f;
    const float v1 = (i0 + 1 >= 0 && i0 + 1 < n) ? line[(i0 + 1) * stride] : 0.0f;
    return (1.0f - f) * v0 + f * v1;
}

// Integer and fractional part of the shear shift of line `i`.
__device__ __forceinline__ void shear_shift(float coef, int i, float c0, int& k0, float& f) {
    const float s = coef * (((float)i + 0.5f) - c0);
    const float fl = floorf(s);
    k0 = (int)fl;
    f = s - fl;
}

template <bool ROTATE>
__global__ void resample_rows_kernel(const uint8_t* __restrict__ img, const float* __restrict__ params,
                                     float* __restrict__ dst, int H, int W, int CS) {
    extern __shared__ float smem[];
    float* mid = smem;      // W: vertically filtered source row
    float* row = smem + W;  // CS: one canvas row
    const int c = blockIdx.x;
    const int b = blockIdx.y;
    const float* prm = params + 6 * b;
    const uint8_t* src = img + (size_t)b * H * W;

    const Taps ty = tri_taps(prm[0], prm[1], c, H);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        float acc = 0.0f;
        for (int h = ty.lo; h <= ty.hi; ++h)
            acc += (tri_weight(h, ty.p, ty.supp) / ty.norm) * (float)src[(size_t)h * W + w];
        mid[w] = acc;
    }
    __syncthreads();

    float* out_row = dst + ((size_t)b * CS + c) * CS;
    for (int j = threadIdx.x; j < CS; j += blockDim.x) {
        const Taps tx = tri_taps(prm[2], prm[3], j, W);
        float acc = 0.0f;
        for (int w = tx.lo; w <= tx.hi; ++w) acc += mid[w] * (tri_weight(w, tx.p, tx.supp) / tx.norm);
        if (ROTATE)
            row[j] = acc;
        else
            out_row[j] = acc;
    }
    if (!ROTATE) return;
    __syncthreads();

    int k0;
    float f;
    shear_shift(prm[4], c, 0.5f * (float)CS, k0, f);
    for (int j = threadIdx.x; j < CS; j += blockDim.x) out_row[j] = lerp_zero(row, j, k0, f, CS, 1);
}

constexpr int kTile = 32;

__global__ void shear_cols_kernel(float* __restrict__ canvas, const float* __restrict__ params, int CS) {
    extern __shared__ float tile[];  // CS x kTile, column-tile of the canvas
    const int b = blockIdx.y;
    const int x = blockIdx.x * kTile + threadIdx.x;
    const bool valid = x < CS;
    float* cv = canvas + (size_t)b * CS * CS;
    for (int i = threadIdx.y; i < CS; i += blockDim.y)
        tile[i * kTile + threadIdx.x] = valid ? cv[(size_t)i * CS + x] : 0.0f;
    __syncthreads();
    if (!valid) return;
    int k0;
    float f;
    shear_shift(params[6 * b + 5], x, 0.5f * (float)CS, k0, f);
    for (int i = threadIdx.y; i < CS; i += blockDim.y)
        cv[(size_t)i * CS + x] = lerp_zero(tile + threadIdx.x, i, k0, f, CS, kTile);
}

__global__ void shear_rows_crop_kernel(const float* __restrict__ canvas, const float* __restrict__ params,
                                       float* __restrict__ out, int CS, int S) {
    const int r = blockIdx.x;
    const int b = blockIdx.y;
    const int lo = (CS - S) / 2;
    const int y = lo + r;
    const float* line = canvas + ((size_t)b * CS + y) * CS;
    int k0;
    float f;
    shear_shift(params[6 * b + 4], y, 0.5f * (float)CS, k0, f);
    float* out_row = out + ((size_t)b * S + r) * S;
    for (int q = threadIdx.x; q < S; q += blockDim.x) out_row[q] = lerp_zero(line, lo + q, k0, f, CS, 1);
}

}  // namespace

cudaError_t nntc_warp_roi_rotate(const uint8_t* img, const float* params, float* canvas, float* out,
                                 int B, int H, int W, int S, int CS, int rotate, cudaStream_t stream) {
    const size_t smem_rows = (size_t)(W + CS) * sizeof(float);
    if (!rotate) {
        resample_rows_kernel<false><<<dim3(CS, B), 256, smem_rows, stream>>>(img, params, out, H, W, CS);
        return cudaGetLastError();
    }
    if (smem_rows > 48 * 1024) {
        cudaFuncSetAttribute(resample_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_rows);
    }
    resample_rows_kernel<true><<<dim3(CS, B), 256, smem_rows, stream>>>(img, params, canvas, H, W, CS);
    const size_t smem_tile = (size_t)CS * kTile * sizeof(float);
    if (smem_tile > 48 * 1024) {
        cudaFuncSetAttribute(shear_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_tile);
    }
    shear_cols_kernel<<<dim3((CS + kTile - 1) / kTile, B), dim3(kTile, 8), smem_tile, stream>>>(canvas, params,
                                                                                               CS);
    shear_rows_crop_kernel<<<dim3(S, B), 128, 0, stream>>>(canvas, params, out, CS, S);
    return cudaGetLastError();
}
