// The training step's stamp: one thread writes (kind | arg << 8, the card's
// %globaltimer in ns) into the next slot of a ring on the card.
//
// Replaces no TPU kernel. It was added so that the sections of the K-step CUDA
// graph (train/tracing.py) can be timed inside a replay: the graph's kernels
// run with no host call between them, so only work queued among them can say
// when one section ends and the next begins. The cursor lives on the card
// beside the ring; the stamps of one stream run in stream order, so a plain
// read, write and increment is safe without atomics.
//
// The kind is a template argument, so that each kind is its own kernel name
// in a profiler's trace (`nntc_stamp_kernel<3>`): a trace of a replay can be
// cut at the stamps by name alone.
//
// What bounds it: the launch. It moves 24 bytes; a stamp costs the gap a
// graph leaves between two kernels, about a microsecond.

#include "nntc_kernels.h"

template <int KIND>
__global__ void nntc_stamp_kernel(long long* ring, long long* cursor, long long capacity, long long arg) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    const long long c = *cursor;
    long long* slot = ring + 2 * (c % capacity);
    slot[0] = (long long)KIND | (arg << 8);
    slot[1] = (long long)ns;
    *cursor = c + 1;
}

#define NNTC_STAMP_CASE(k)                                                         \
    case k:                                                                        \
        nntc_stamp_kernel<k><<<1, 1, 0, stream>>>(ring, cursor, capacity, arg);    \
        break;

cudaError_t nntc_stamp(long long* ring, long long* cursor, long long capacity, int kind, long long arg,
                       cudaStream_t stream) {
    if (capacity <= 0 || arg < 0) return cudaErrorInvalidValue;
    switch (kind) {
        NNTC_STAMP_CASE(0)
        NNTC_STAMP_CASE(1)
        NNTC_STAMP_CASE(2)
        NNTC_STAMP_CASE(3)
        NNTC_STAMP_CASE(4)
        NNTC_STAMP_CASE(5)
        NNTC_STAMP_CASE(6)
        NNTC_STAMP_CASE(7)
        NNTC_STAMP_CASE(8)
        NNTC_STAMP_CASE(9)
        NNTC_STAMP_CASE(10)
        NNTC_STAMP_CASE(11)
        NNTC_STAMP_CASE(12)
        NNTC_STAMP_CASE(13)
        NNTC_STAMP_CASE(14)
        NNTC_STAMP_CASE(15)
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

#undef NNTC_STAMP_CASE
