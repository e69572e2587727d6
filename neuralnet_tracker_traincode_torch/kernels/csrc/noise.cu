// K3: the gaussian-noise augmentation, by hand for Hopper (sm_90a).
//
// Replaces: neuralnet_tracker_traincode_tpu/augmentation/noise_pallas.py:
//   add_gaussian_noise_pallas (body _noise_kernel) and, for the entry with
//   injected bits, add_gaussian_noise_from_bits (_noise_kernel_from_bits);
//   shared math _apply_noise_from_bits.
//
// What it computes, per pixel p of sample b: two 24-bit words b1, b2;
// u1 = (b1 + 1) / 2^24, u2 = b2 / 2^24; z = sqrt(-2 ln u1) * cos(2 pi u2);
// out = clip(x + sigma[b] * z, 0, 1) + offset (offset 0 is the TPU kernel's
// function; the training pipeline passes -0.5, its whitening). The TPU kernel
// draws b1, b2 from the TPU's hardware generator, which has no GPU
// counterpart: here they come from a counter-based Philox-4x32-10. Pixel pair
// q = p >> 1 takes key (seeds[b], 0) and counter (q, 0, 0, 0); the even pixel
// takes words 0 and 1, the odd pixel words 2 and 3, each masked to 24 bits
// (when P is odd the last pair has one pixel). The plain version computes the
// same Philox in torch integer ops, so the two agree bit for bit in the bits.
// Products and sums of the Box-Muller tail are rounded one by one
// (__fmul_rn/__fadd_rn) so no FMA contraction separates the kernel from
// PyTorch's elementwise ops; logf/cosf/sqrtf are the IEEE-accurate library
// functions PyTorch's own CUDA ops call (no --use_fast_math).
//
// What bounds it on the H100: memory. It reads and writes B*P*4 bytes each
// (8.5 MB at B=64, P=129^2: about 2.5 us at 3.35 TB/s); Philox costs about
// 50 integer operations a pixel, and only pixels of samples with sigma > 0
// need it (about 31% of the samples on the main path). What the design does
// about it:
//   - one sample per blockIdx.y, so sigma == 0 is uniform across the block:
//     such a block skips Philox and Box-Muller and writes clip(x, 0, 1) +
//     offset over 2 * kThreads consecutive pixels, coalesced (bit-equal to
//     the noisy formula, since x + 0 * z == x);
//   - otherwise one thread per pixel pair, one Philox call for both pixels;
//   - the random bits are made in registers and never stored; one read and
//     one write a pixel, the whitening fused as the offset.
// With every sigma > 0 the SM's instruction issue bounds it instead: half a
// Philox call and the IEEE logf, cosf and sqrtf come to a few hundred
// instructions a pixel pair.
// CUDA rather than Triton, so that all three kernels share one build.
//
// K3b, the injected-bits entry (the TPU kernel's test surface): the TPU
// kernel's function, no offset; bits1 and bits2 are (B, P) int32, low 24
// bits used. What bounds it: memory. A sample with sigma > 0 needs x, both
// words and the output, 16 bytes a pixel; a sample with sigma 0 needs only
// x and the output, since its result is clip(x, 0, 1) (x + 0 * z == x for
// the finite z of this function: u1 in (0, 1], |z| <= 5.77). At B=64,
// P=129^2 with 19 samples on (phase 3's draw) that is 11.05 MB, about 3.3
// us at 3.35 TB/s; 17.0 MB with every sample on. The design:
//   - one sample per blockIdx.y, so sigma is uniform across the block: a
//     block whose sigma is 0 reads x only, never bits1 or bits2;
//   - 16-byte accesses: a thread takes 4 consecutive pixels, one float4 /
//     int4 of each array; the loads go through the streaming path (__ldcs)
//     and are all issued before the arithmetic, the stores are streaming
//     too (__stcs: nothing in the launch reads the output again);
//   - a sample's row starts at b * P * 4 bytes, on a 16-byte boundary only
//     when b * P % 4 == 0: each sample has a scalar head up to its first
//     aligned pixel and a scalar tail (at most 3 pixels each, taken by the
//     sample's first block and loaded with its groups, so that no thread's
//     first load waits). The vector path needs x, bits1, bits2 and out to
//     start on 16-byte boundaries; where one does not (a caller's view that
//     starts off its allocation), every pixel takes the scalar path, 4
//     pixels a thread 128 apart, same blocks, same skip. No vector access is
//     misaligned.
// At this size a back-to-back launch has a fixed cost of its own, and the
// arithmetic of the noisy samples runs only once their words have arrived;
// both add to the bytes' time (PERF.md, section 6).

#include "nntc_kernels.h"

namespace {

constexpr int kThreads = 128;  // pixel pairs a block: 2 * kThreads pixels

// Philox-4x32-10 of counter (ctr, 0, 0, 0) and key (k0, 0): the four words.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t ctr, uint32_t k0) {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
    uint32_t c0 = ctr, c1 = 0u, c2 = 0u, c3 = 0u, k1 = 0u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
        const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
        k0 += W0;
        k1 += W1;
    }
    return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float clip01(float y) { return fminf(fmaxf(y, 0.0f), 1.0f); }

__device__ __forceinline__ float apply_noise(int32_t bits1, int32_t bits2, float x, float sigma) {
    const float u1 = __fmul_rn((float)(bits1 + 1), 1.0f / 16777216.0f);
    const float u2 = __fmul_rn((float)bits2, 1.0f / 16777216.0f);
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float z = __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
    return clip01(__fadd_rn(x, __fmul_rn(sigma, z)));
}

__global__ void __launch_bounds__(kThreads) noise_seeded_kernel(const float* __restrict__ x,
                                                                const int32_t* __restrict__ seeds,
                                                                const float* __restrict__ sigma,
                                                                float* __restrict__ out, int P, float offset) {
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int p0 = blockIdx.x * (2 * kThreads);  // the block's first pixel
    const size_t base = (size_t)b * P;
    const float s = sigma[b];
    if (s == 0.0f) {  // both loads in flight before either store
        const int pa = p0 + t, pb = p0 + kThreads + t;
        const float va = pa < P ? x[base + pa] : 0.0f, vb = pb < P ? x[base + pb] : 0.0f;
        if (pa < P) out[base + pa] = __fadd_rn(clip01(va), offset);
        if (pb < P) out[base + pb] = __fadd_rn(clip01(vb), offset);
        return;
    }
    const int q = (p0 >> 1) + t;  // pixel pair
    const int p = 2 * q;
    if (p >= P) return;
    const uint4 w = philox4x32_10((uint32_t)q, (uint32_t)seeds[b]);
    out[base + p] = __fadd_rn(apply_noise((int32_t)(w.x & 0xFFFFFFu), (int32_t)(w.y & 0xFFFFFFu), x[base + p], s),
                              offset);
    if (p + 1 < P)
        out[base + p + 1] = __fadd_rn(
            apply_noise((int32_t)(w.z & 0xFFFFFFu), (int32_t)(w.w & 0xFFFFFFu), x[base + p + 1], s), offset);
}

// K3b's shape: 4 pixels a thread, 128 threads a block. The vector kernel
// takes 32 registers, no spills (a 32-byte stack frame: cosf's slow path),
// 16 blocks an SM, so the pose step's 64 x 129^2 is one wave of 2,112
// blocks; 8 pixels a thread took 40 registers and were slower with every
// sigma > 0 (PERF.md, section 6).
constexpr int kBitsThreads = 128;
constexpr int kBitsChunk = 4 * kBitsThreads;  // pixels a block

__device__ __forceinline__ float4 clip01(float4 v) {
    return make_float4(clip01(v.x), clip01(v.y), clip01(v.z), clip01(v.w));
}

__device__ __forceinline__ float4 apply_noise(int4 c1, int4 c2, float4 v, float s) {
    return make_float4(apply_noise(c1.x & 0xFFFFFF, c2.x & 0xFFFFFF, v.x, s),
                       apply_noise(c1.y & 0xFFFFFF, c2.y & 0xFFFFFF, v.y, s),
                       apply_noise(c1.z & 0xFFFFFF, c2.z & 0xFFFFFF, v.z, s),
                       apply_noise(c1.w & 0xFFFFFF, c2.w & 0xFFFFFF, v.w, s));
}

// kVec: x, bits1, bits2 and out start on 16-byte boundaries; sample b's
// pixel p is then 16-byte aligned where (b * P + p) % 4 == 0.
template <bool kVec>
__global__ void __launch_bounds__(kBitsThreads) noise_bits_kernel(const float* __restrict__ x,
                                                                  const int32_t* __restrict__ bits1,
                                                                  const int32_t* __restrict__ bits2,
                                                                  const float* __restrict__ sigma,
                                                                  float* __restrict__ out, int P) {
    const int t = threadIdx.x;
    const size_t base = (size_t)blockIdx.y * P;
    const float s = sigma[blockIdx.y];
    const bool noisy = s != 0.0f;  // uniform across the block
    if constexpr (!kVec) {
        const int p0 = blockIdx.x * kBitsChunk + t;
        float v[4];
        int32_t c1[4], c2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int p = p0 + k * kBitsThreads;
            v[k] = p < P ? __ldcs(x + base + p) : 0.0f;
            c1[k] = noisy && p < P ? __ldcs(bits1 + base + p) : 0;
            c2[k] = noisy && p < P ? __ldcs(bits2 + base + p) : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int p = p0 + k * kBitsThreads;
            if (p < P)
                __stcs(out + base + p, noisy ? apply_noise(c1[k] & 0xFFFFFF, c2[k] & 0xFFFFFF, v[k], s) : clip01(v[k]));
        }
    } else {
        const int head = min((4 - (int)(base & 3)) & 3, P);  // pixels before the first aligned one
        const int groups = (P - head) >> 2;
        // the scalar head (threads 0-2 of the sample's first block) and tail
        // (threads 32-34), loaded with the group: nothing delays a thread's first load
        const int tail = head + 4 * groups;
        int q = -1;
        if (blockIdx.x == 0) q = t < head ? t : (t >= 32 && t - 32 < P - tail ? tail + (t - 32) : -1);
        const float qx = q >= 0 ? __ldcs(x + base + q) : 0.0f;
        const int32_t q1 = noisy && q >= 0 ? __ldcs(bits1 + base + q) : 0;
        const int32_t q2 = noisy && q >= 0 ? __ldcs(bits2 + base + q) : 0;
        const size_t a = base + head;  // 16-byte aligned in every array
        const int g = blockIdx.x * kBitsThreads + t;
        const bool live = g < groups;
        const float4 v =
            live ? __ldcs(reinterpret_cast<const float4*>(x + a) + g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int4 c1 = noisy && live ? __ldcs(reinterpret_cast<const int4*>(bits1 + a) + g) : make_int4(0, 0, 0, 0);
        const int4 c2 = noisy && live ? __ldcs(reinterpret_cast<const int4*>(bits2 + a) + g) : make_int4(0, 0, 0, 0);
        if (live) __stcs(reinterpret_cast<float4*>(out + a) + g, noisy ? apply_noise(c1, c2, v, s) : clip01(v));
        if (q >= 0) __stcs(out + base + q, noisy ? apply_noise(q1 & 0xFFFFFF, q2 & 0xFFFFFF, qx, s) : clip01(qx));
    }
}

}  // namespace

cudaError_t nntc_gaussian_noise(const float* x, const int32_t* seeds, const float* sigma, float* out, int B, int P,
                                float offset, cudaStream_t stream) {
    if (B == 0 || P == 0) return cudaSuccess;
    noise_seeded_kernel<<<dim3((P + 2 * kThreads - 1) / (2 * kThreads), B), kThreads, 0, stream>>>(x, seeds, sigma,
                                                                                                out, P, offset);
    return cudaGetLastError();
}

cudaError_t nntc_gaussian_noise_from_bits(const float* x, const int32_t* bits1, const int32_t* bits2,
                                          const float* sigma, float* out, int B, int P, cudaStream_t stream) {
    if (B == 0 || P == 0) return cudaSuccess;
    if (B > 65535) return cudaErrorInvalidValue;  // a sample a blockIdx.y
    const bool vec = (((uintptr_t)x | (uintptr_t)bits1 | (uintptr_t)bits2 | (uintptr_t)out) & 15) == 0;
    const dim3 grid((P + kBitsChunk - 1) / kBitsChunk, B);
    if (vec)
        noise_bits_kernel<true><<<grid, kBitsThreads, 0, stream>>>(x, bits1, bits2, sigma, out, P);
    else
        noise_bits_kernel<false><<<grid, kBitsThreads, 0, stream>>>(x, bits1, bits2, sigma, out, P);
    return cudaGetLastError();
}
