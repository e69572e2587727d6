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
// about it: one block per image reads the image twice (histogram, lookup;
// the second read hits L2), keeps histogram, scan and LUT in shared memory
// (integer atomics, one 256-wide block scan, exact integer division), and
// writes once. The TPU kernel's nibble one-hot histogram on the MXU and its
// reciprocal-corrected division are not carried over. With one block per
// image only B blocks run (64 of 132 SMs at B=64); splitting an image over
// several blocks is later work.

#include "nntc_kernels.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 256;

__global__ void equalize_kernel(const float* __restrict__ x, const int32_t* __restrict__ gate,
                                float* __restrict__ out, int P) {
    __shared__ int hist[kBins];
    __shared__ int cum[kBins];
    __shared__ float lut[kBins];
    __shared__ int last_nz;
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const float* xi = x + (size_t)b * P;
    float* oi = out + (size_t)b * P;

    if (gate[b] == 0) {
        for (int p = t; p < P; p += kThreads) oi[p] = xi[p];
        return;
    }
    if (t < kBins) hist[t] = 0;
    if (t == 0) last_nz = -1;
    __syncthreads();
    for (int p = t; p < P; p += kThreads) {
        const float v = floorf(xi[p] * 256.0f);
        const int bin = (int)fminf(fmaxf(v, 0.0f), 255.0f);
        atomicAdd(&hist[bin], 1);
    }
    __syncthreads();
    if (t < kBins) {
        cum[t] = hist[t];
        if (hist[t] > 0) atomicMax(&last_nz, t);
    }
    __syncthreads();
    // inclusive Hillis-Steele scan over the 256 bins
    for (int off = 1; off < kBins; off <<= 1) {
        int v = 0;
        if (t < kBins && t >= off) v = cum[t - off];
        __syncthreads();
        if (t < kBins) cum[t] += v;
        __syncthreads();
    }
    const int total = cum[kBins - 1];
    const int step = (total - (last_nz >= 0 ? hist[last_nz] : 0)) / 255;
    if (step == 0) {
        for (int p = t; p < P; p += kThreads) oi[p] = xi[p];
        return;
    }
    if (t < kBins) {
        const int v = t == 0 ? 0 : (cum[t - 1] + step / 2) / step;
        lut[t] = (float)min(max(v, 0), 255) / 255.0f;
    }
    __syncthreads();
    for (int p = t; p < P; p += kThreads) {
        const int li = (int)floorf(xi[p] * 255.0f);
        oi[p] = (li >= 0 && li < kBins) ? lut[li] : 0.0f;
    }
}

}  // namespace

cudaError_t nntc_equalize(const float* x, const int32_t* gate, float* out, int B, int P, cudaStream_t stream) {
    equalize_kernel<<<B, kThreads, 0, stream>>>(x, gate, out, P);
    return cudaGetLastError();
}
