// K3: the gaussian-noise augmentation, by hand for Hopper (sm_90a).
//
// Replaces: neuralnet_tracker_traincode_tpu/augmentation/noise_pallas.py:
//   add_gaussian_noise_pallas (body _noise_kernel) and, for the entry with
//   injected bits, add_gaussian_noise_from_bits (_noise_kernel_from_bits);
//   shared math _apply_noise_from_bits.
//
// What it computes, per pixel p of sample b: two 24-bit words b1, b2;
// u1 = (b1 + 1) / 2^24, u2 = b2 / 2^24; z = sqrt(-2 ln u1) * cos(2 pi u2);
// out = clip(x + sigma[b] * z, 0, 1). The TPU kernel draws b1, b2 from the
// TPU's hardware generator, which has no GPU counterpart: here they are words
// 0 and 1 of a counter-based Philox-4x32-10 (key = (seeds[b], 0), counter =
// (p, 0, 0, 0)), masked to 24 bits. The plain version computes the same
// Philox in torch integer ops, so the two agree bit for bit in the bits.
// Products and sums of the Box-Muller tail are rounded one by one
// (__fmul_rn/__fadd_rn) so no FMA contraction separates the kernel from
// PyTorch's elementwise ops; logf/cosf/sqrtf are the IEEE-accurate library
// functions PyTorch's own CUDA ops call (no --use_fast_math).
//
// What bounds it on the H100: memory. It reads and writes B*P*4 bytes each
// (8.5 MB at B=64, P=129^2: about 2.5 us at 3.35 TB/s); Philox costs about
// 100 integer operations a pixel, below that at the card's rate. What the
// design does about it: one thread per pixel, the random bits made in
// registers and never stored, one coalesced read and one write a pixel. The
// injected-bits entry reads two more words a pixel; it is the test surface.
// CUDA rather than Triton, so that all three kernels share one build.

#include "nntc_kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
    constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
        const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
        const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
        c[0] = n0;
        c[1] = lo1;
        c[2] = n2;
        c[3] = lo0;
        k0 += W0;
        k1 += W1;
    }
}

__device__ __forceinline__ float apply_noise(int32_t bits1, int32_t bits2, float x, float sigma) {
    const float u1 = __fmul_rn((float)(bits1 + 1), 1.0f / 16777216.0f);
    const float u2 = __fmul_rn((float)bits2, 1.0f / 16777216.0f);
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    const float z = __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
    const float y = __fadd_rn(x, __fmul_rn(sigma, z));
    return fminf(fmaxf(y, 0.0f), 1.0f);
}

__global__ void noise_seeded_kernel(const float* __restrict__ x, const int32_t* __restrict__ seeds,
                                    const float* __restrict__ sigma, float* __restrict__ out, int P) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (p >= P) return;
    uint32_t c[4] = {(uint32_t)p, 0u, 0u, 0u};
    philox4x32_10(c, (uint32_t)seeds[b], 0u);
    const size_t i = (size_t)b * P + p;
    out[i] = apply_noise((int32_t)(c[0] & 0xFFFFFFu), (int32_t)(c[1] & 0xFFFFFFu), x[i], sigma[b]);
}

__global__ void noise_bits_kernel(const float* __restrict__ x, const int32_t* __restrict__ bits1,
                                  const int32_t* __restrict__ bits2, const float* __restrict__ sigma,
                                  float* __restrict__ out, int P) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    const int b = blockIdx.y;
    if (p >= P) return;
    const size_t i = (size_t)b * P + p;
    out[i] = apply_noise(bits1[i] & 0xFFFFFF, bits2[i] & 0xFFFFFF, x[i], sigma[b]);
}

}  // namespace

cudaError_t nntc_gaussian_noise(const float* x, const int32_t* seeds, const float* sigma, float* out, int B, int P,
                                cudaStream_t stream) {
    noise_seeded_kernel<<<dim3((P + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(x, seeds, sigma, out, P);
    return cudaGetLastError();
}

cudaError_t nntc_gaussian_noise_from_bits(const float* x, const int32_t* bits1, const int32_t* bits2,
                                          const float* sigma, float* out, int B, int P, cudaStream_t stream) {
    noise_bits_kernel<<<dim3((P + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(x, bits1, bits2, sigma,
                                                                                     out, P);
    return cudaGetLastError();
}
