// K2: per-image histogram equalization, by hand for Hopper (sm_90a).
//
// Replaces: neuralnet_tracker_traincode_tpu/augmentation/equalize_pallas.py:
//   equalize_pallas (body _equalize_kernel, helper _floor_div_exact).
//
// What it computes, per image of P pixels in [0, 1], with kornia/torchvision
// semantics:
//   1. bin = floor(x * 256) clipped to 0..255; 256-bin histogram;
//   2. step = (total - count of the last nonzero bin) / 255, integer division;
//   3. lut[v] = (cum[v-1] + step / 2) / max(step, 1), integer division,
//      lut[0] = 0, clipped to 0..255 (cum = inclusive cumulative histogram);
//   4. out = lut[floor(x * 255)] / 255 (0 for an index outside 0..255);
//   5. pass-through where step == 0 or the per-sample gate is 0.
// Binning (x*256) and lookup (x*255) use different scales on purpose.
// The result is bit-equal to the plain version: all counting is integer and
// the one float division (lut / 255) is IEEE (no --use_fast_math).
//
// What bounds it on the H100: memory. It reads and writes B*P*4 bytes each
// (8.5 MB at B=64, P=129^2: about 2.5 us at 3.35 TB/s). What the design does
// about it:
//   - One cluster of kCluster = 8 CTAs per image, 8*B CTAs in all, so each
//     of the ~20% of images that the gate turns on is spread over 8 CTAs
//     instead of one block. CTA r of the cluster owns a slice of the image;
//     the slice edges inside the image fall on 16-byte boundaries of the
//     whole (B, P) array (kernels/equalize.py:slice_edges computes the
//     same), so the slice moves as float4 with at most 3 scalar pixels at
//     either end.
//   - Each CTA first copies its slice once from device memory into shared
//     memory, every load in flight at once (16-byte cp.async), while it reads
//     the gate. Gate 0 (uniform across the cluster): it writes the slice out.
//   - Otherwise it bins the staged slice into per-warp sub-histograms (shared
//     atomics spread over 8 copies of the bins) and sums them into its own
//     256 bins, which it stores into every CTA of the cluster through
//     distributed shared memory (remote stores do not wait for a reply, as
//     remote loads would). A CTA's shared memory may be touched only once
//     that CTA runs, so a relaxed cluster barrier guards the stores: each
//     CTA arrives as it starts and waits just before its first remote
//     store, with the staging and the binning in between (a gated-off CTA
//     arrives and exits: the wait counts only threads that have not
//     exited). After a second cluster barrier every CTA sums the 8 copies
//     it holds: the image's histogram.
//     It scans the bins with warp shuffles, finds the last nonzero bin by
//     warp ballots, computes step and the LUT exactly in integers, looks up
//     its staged slice and writes it once. step == 0 (uniform: every CTA
//     holds the same histogram) writes the staged slice back unchanged.
//   - No CTA touches another's shared memory after that barrier, so a CTA
//     may exit as soon as it has written its slice.
// The TPU kernel's nibble one-hot histogram on the MXU and its
// reciprocal-corrected division are not carried over.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "nntc_kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per image (4 measured no faster at any gate mix)
constexpr int kThreads = 256;  // one bin a thread in the scan and the LUT
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxSharedBytes = 232448;  // the H100's 227 KB of opt-in shared memory
static_assert(kThreads == kBins, "the scan and the LUT take one bin a thread");

// Edge c of image b's slices, as an index into the whole (B, P) array: the
// interior edges rounded up to a multiple of 4 (16 bytes), within the image.
__device__ __forceinline__ int64_t slice_edge(int64_t base, int P, int c) {
    if (c <= 0) return base;
    if (c >= kCluster) return base + P;
    const int64_t e = (base + (int64_t)c * P / kCluster + 3) & ~int64_t(3);
    return e < base + P ? e : base + P;
}

__device__ __forceinline__ int bin_of(float v) { return (int)fminf(fmaxf(floorf(v * 256.0f), 0.0f), 255.0f); }

__device__ __forceinline__ float look(const float* lut, float v) {
    const int li = (int)floorf(v * 255.0f);
    return (li >= 0 && li < kBins) ? lut[li] : 0.0f;
}

// Calls scalar(g) for the pixels of [g0, g1) outside its 16-byte aligned
// middle [a0, a1), and vec(k) for the float4s k of the middle (g = 4k).
template <typename Scalar, typename Vec>
__device__ __forceinline__ void for_slice(int64_t g0, int64_t a0, int64_t a1, int64_t g1, Scalar scalar, Vec vec) {
    const int t = threadIdx.x;
    for (int64_t g = g0 + t; g < a0; g += kThreads) scalar(g);
    for (int64_t k = a0 / 4 + t; k < a1 / 4; k += kThreads) vec(k);
    for (int64_t g = a1 + t; g < g1; g += kThreads) scalar(g);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    equalize_kernel(const float* __restrict__ x, const int32_t* __restrict__ gate, float* __restrict__ out, int P,
                    int vec) {
    extern __shared__ float4 staged4[];  // the slice; staged[i] holds pixel lo + i, lo = g0 rounded down to 4
    __shared__ int warp_hist[kWarps][kBins];
    __shared__ int parts[kCluster][kBins];  // the bins of each CTA of the cluster, written by that CTA
    __shared__ float lut[kBins];
    __shared__ int warp_sum[kWarps];
    __shared__ int warp_last[kWarps];
    __shared__ int step_sh;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / kCluster;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int64_t base = (int64_t)b * P;
    __cluster_barrier_arrive_relaxed();  // this CTA runs; waited on before the first remote store
    const int64_t g0 = slice_edge(base, P, rank), g1 = slice_edge(base, P, rank + 1);
    int64_t a0 = g1, a1 = g1;  // no aligned middle unless both pointers are 16-byte aligned
    if (vec) {
        a0 = (g0 + 3) & ~int64_t(3);
        a0 = a0 < g1 ? a0 : g1;
        a1 = g1 & ~int64_t(3);
        a1 = a1 > a0 ? a1 : a0;
    }
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int64_t lo = g0 & ~int64_t(3), lo4 = lo / 4;
    float* staged = reinterpret_cast<float*>(staged4);

    // Stage the slice before the gate is known, all loads in flight at once:
    // the aligned middle by 16-byte cp.async, the ends by plain loads.
    for (int64_t k = a0 / 4 + t; k < a1 / 4; k += kThreads) __pipeline_memcpy_async(&staged4[k - lo4], &x4[k], 16);
    __pipeline_commit();
    for (int64_t g = g0 + t; g < a0; g += kThreads) staged[g - lo] = x[g];
    for (int64_t g = a1 + t; g < g1; g += kThreads) staged[g - lo] = x[g];
    const bool on = gate[b] != 0;  // uniform across the cluster
    for (int i = t; i < kWarps * kBins; i += kThreads) (&warp_hist[0][0])[i] = 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (!on) {
        for_slice(g0, a0, a1, g1, [&](int64_t g) { out[g] = staged[g - lo]; },
                  [&](int64_t k) { o4[k] = staged4[k - lo4]; });
        return;
    }

    int* hist = warp_hist[warp];
    for (int64_t i = g0 - lo + t; i < g1 - lo; i += kThreads) atomicAdd(&hist[bin_of(staged[i])], 1);
    __syncthreads();
    int h = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) h += warp_hist[w][t];
    __cluster_barrier_wait();  // every CTA of the cluster runs
#pragma unroll 1
    for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(&parts[rank][0], r)[t] = h;
    cluster.sync();  // every CTA's bins have reached every CTA; none is read remotely after this
    h = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) h += parts[r][t];

    // bin t of the image's histogram is h: inclusive scan, last nonzero bin
    int cum = h;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xFFFFFFFFu, cum, off);
        if (lane >= off) cum += n;
    }
    const unsigned nz = __ballot_sync(0xFFFFFFFFu, h > 0);
    if (lane == 31) {
        warp_sum[warp] = cum;
        warp_last[warp] = nz ? warp * 32 + 31 - __clz(nz) : -1;
    }
    __syncthreads();
    int last = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) cum += warp_sum[w];
        last = max(last, warp_last[w]);
    }
    // total - count of the last nonzero bin = the exclusive cumulative count there
    if (t == last) step_sh = (cum - h) / 255;
    __syncthreads();
    const int step = step_sh;  // every pixel falls in a bin, so last >= 0
    if (step == 0) {
        for_slice(g0, a0, a1, g1, [&](int64_t g) { out[g] = staged[g - lo]; },
                  [&](int64_t k) { o4[k] = staged4[k - lo4]; });
    } else {
        const int v = (cum - h + step / 2) / step;  // (cum[t-1] + step/2) / step; 0 for t == 0
        lut[t] = (float)min(max(v, 0), 255) / 255.0f;
        __syncthreads();
        for_slice(
            g0, a0, a1, g1, [&](int64_t g) { out[g] = look(lut, staged[g - lo]); },
            [&](int64_t k) {
                const float4 s = staged4[k - lo4];
                o4[k] = make_float4(look(lut, s.x), look(lut, s.y), look(lut, s.z), look(lut, s.w));
            });
    }
}

}  // namespace

cudaError_t nntc_equalize(const float* x, const int32_t* gate, float* out, int B, int P, cudaStream_t stream) {
    if (B == 0 || P == 0) return cudaSuccess;
    // the slice and the up to 3 pixels before it that share its first 16 bytes
    const int cap = ((P + kCluster - 1) / kCluster + 6 + 3) / 4 * 4;
    const size_t dyn = (size_t)cap * sizeof(float);
    void (*kernel)(const float*, const int32_t*, float*, int, int) = equalize_kernel;
    static cudaFuncAttributes attr;  // the static shared memory, queried once
    static const cudaError_t attr_err = cudaFuncGetAttributes(&attr, kernel);
    if (attr_err != cudaSuccess) return attr_err;
    if (attr.sharedSizeBytes + dyn > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
    if (attr.sharedSizeBytes + dyn > 48 * 1024) {  // the default limit counts static and dynamic together
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) return e;
    }
    const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    kernel<<<B * kCluster, kThreads, dyn, stream>>>(x, gate, out, P, vec);
    return cudaGetLastError();
}
