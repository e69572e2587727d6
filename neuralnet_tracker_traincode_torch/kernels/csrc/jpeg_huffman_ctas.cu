// K5's design before its redesign (one CTA of 512 threads an image), kept to
// compare the two designs: not part of the extension (kernels/ext.py does not
// build it). chip_smoke_jpeg_designs.py builds it by nvcc with a plain C entry
// (`jpeg_huffman_ctas_design`) and times it beside nntc_jpeg_huffman_decode
// (jpeg_huffman.cu) on the same payloads; both compute the same slots, lengths
// and status, bit for bit. Built with -DNNTC_K5_CLOCKS, thread 0 of each CTA
// stamps clock64() and %globaltimer at the end of each phase (a barrier before
// each stamp) into `clocks` (8 pairs a CTA): the start, the scan staged and
// the tables built, the guess, the passes, (b), (c), (d).
//
// The design: the Huffman (entropy) decode of a batch of baseline JPEG scans, by
// hand for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. Its counterpart in the JAX package is the host
// decode of neuralnet_tracker_traincode_tpu/data/native_loader.py:
// pack_jpeg_batch_gray (libjpeg). Here the host only parses, builds the
// decode tables and unstuffs the Y scan (data/csrc/jpeg_entropy.cpp:
// nntc_jpeg_scan_batch); this kernel decodes it into each kept Y block's
// quantized coefficients (K4, jpeg_idct.cu, does the rest).
//
// What it computes (kernels/jpeg_huffman.py has the algorithm and the plain
// version it is held to, bit for bit): each restart interval cut into
// subsequences of S bits; (a) each subsequence but an interval's last decoded
// from a guessed state (block 0 of the MCU, zigzag index 0) to its first
// codeword boundary at or past its end, then passes, each subsequence decoded
// again from its predecessor's exit state where that changed, until a pass
// changes no exit: the fixed point is the sequential decode's; (b) a
// scan of the blocks begun in each subsequence gives its first block; (c)
// each subsequence decoded from its exact state, each block begun in it to
// its end, a kept Y block's AC coefficients written to its slot in zigzag
// order up to the last nonzero one (zeros between) and its length to `lens`,
// each Y block's DC difference to a scratch array; (d) the DC values by a scan
// of the differences along each interval (uint32, low 16 bits kept). The
// first fault of an image in scan order goes to its status word.
//
// What bounds it on the H100: neither bytes nor operations but the serial
// chain of a decode: each codeword's position depends on the one before, so
// a thread decodes at the latency of its lookups and integer operations, and
// the passes of (a) add the bits a guessed decode takes to fall onto the
// sequential decode's state (thousands of bits on photos, tens of thousands
// on dense noise, where no EOB resets the zigzag index). The bytes (the scan
// read a few times, the slots written) are microseconds of HBM time. What
// the design does about it:
//   - one CTA of 512 threads per image, all images in one launch;
//   - the image's scan is staged into shared memory at the CTA's start (up
//     to ~170 KB; what does not fit is read from global memory), so that a
//     thread's 64-bit register window refills from shared memory, one 32-bit
//     word at a time; bits at or past the interval's end read as zeros, as
//     the host's reader feeds them;
//   - the decode tables in shared memory: for each of the 8 tables, fast
//     entries by the next 10 bits (a code and its magnitude in one lookup:
//     total length, symbol, value), then a 9-bit lookahead and maxcode for
//     the longer codes;
//   - each thread takes a contiguous range of subsequences; a pass decodes
//     only those whose entry changed, and feeds each one's fresh exit to the
//     next of its range (Gauss-Seidel within a range, Jacobi between ranges:
//     the synchronized front moves a range a pass, not one subsequence); the
//     states (bit, block in the MCU, k) are one int64 each in global scratch;
//   - (c) keeps each block's place (its index in the MCU, the MCU's column
//     and row) up as it advances, without divisions; the scans of (b) and
//     (d) are block-wide, in shared memory (no warp shuffles: the CPU
//     rehearsal runs one std::thread per CUDA thread).
// A simple design: one CTA per image leaves SMs idle at small batches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMetaCols = 34;
constexpr int kTableWords = 804;
constexpr int kMaxMcuBlocks = 10;
// meta's columns (kernels/jpeg_huffman.py: M_*)
constexpr int M_GW = 2, M_FIRST_BLOCK = 3, M_GH = 4, M_MCUS_X = 5, M_MCUS_Y = 6, M_RST = 7, M_NB = 8, M_YH = 9,
              M_YV = 10, M_FIRST_INTERVAL = 11, M_INTERVALS = 12, M_DC_BASE = 13, M_BITS = 14, M_DEFERRED = 15,
              M_DC_TABLES = 16, M_BLOCKS = 24;  // the AC tables' ids follow the DC tables'
constexpr int ERR_NO_CODE = 1, ERR_DC_CATEGORY = 2, ERR_AC_RUN = 3, ERR_ZERO_RUN = 4, ERR_OVERRUN = 5,
              ERR_BLOCK_COUNT = 6;
constexpr long long kErrState = -1;
constexpr unsigned long long kNoFault = ~0ull;

struct Table {
    uint16_t look[512];  // (length << 8) | symbol by the next 9 bits, 0: a longer code
    int32_t maxcode[18];
    int32_t valoff[18];
    uint8_t vals[256];
};

// Dynamic shared memory: the 8 tables' fast entries (kFastWords each), then
// the image's scan words (big-endian corrected), as many as fit.
constexpr int kFastBits = 10;
constexpr int kFastWords = 1 << kFastBits;
constexpr int kDynamicBytes = 200 * 1024;
constexpr int kScanWords = kDynamicBytes / 4 - 8 * kFastWords;

struct Shared {
    Table tab[8];  // DC table ids 0-3, AC table ids 0-3
    int32_t meta[kMetaCols];
    uint8_t dc_slot[kMaxMcuBlocks], ac_slot[kMaxMcuBlocks];
    int8_t yq[kMaxMcuBlocks], qx[kMaxMcuBlocks], qy[kMaxMcuBlocks];  // Y's block in the MCU, its column and row
    long long scan[kThreads];
    unsigned long long fault;
    long long sub_base, ib_base;
    int codewords;
};

// The interval's bits through a 64-bit window (words wi, wi + 1), big-endian,
// zero at or past bit `e`; words [sb, sb + ns) come from shared memory (`sw`).
struct Reader {
    const uint32_t* words;
    const uint32_t* sw;
    long sb, ns;
    long e;
    long wi = -2;
    uint32_t w0 = 0, w1 = 0;

    __device__ __forceinline__ uint32_t load(long i) const {
        const long bit = i * 32;
        if (bit >= e) return 0u;
        const long si = i - sb;
        uint32_t x = si >= 0 && si < ns ? sw[si] : __byte_perm(__ldg(words + i), 0, 0x0123);
        const long rem = e - bit;
        if (rem < 32) x &= ~0u << (32 - rem);
        return x;
    }
    __device__ __forceinline__ uint32_t peek(long p) {
        const long i = p >> 5;
        if (i != wi) {
            if (i == wi + 1) {
                w0 = w1;
                w1 = load(i + 1);
            } else {
                w0 = load(i);
                w1 = load(i + 1);
            }
            wi = i;
        }
        return __funnelshift_l(w1, w0, static_cast<unsigned>(p & 31));
    }
};

__device__ __forceinline__ long long pack_state(long p, int j, int k) {
    return (static_cast<long long>(p) << 16) | (j << 8) | k;
}

// One codeword (and its magnitude) at bit p in state (j, k): advances them;
// returns a fault code or 0. `sym`: the symbol; `val`: the DC difference or
// the AC coefficient; `pos`: the zigzag position of a nonzero AC coefficient
// (64: none); `end`: the block ended. A code and its magnitude of at most
// kFastBits bits are one lookup of the table's fast entries (total length,
// symbol, value); longer ones take the 9-bit lookahead and maxcode.
__device__ __forceinline__ int decode_one(const Shared& sh, const uint32_t* fast, Reader& rd, long& p, int& j, int& k,
                                          int nb, int& sym, int& val, int& pos, bool& end) {
    const uint32_t w = rd.peek(p);
    const int slot = k == 0 ? sh.dc_slot[j] : sh.ac_slot[j];
    const uint32_t f = fast[slot * kFastWords + (w >> (32 - kFastBits))];
    int bits, sy;
    if (f) {
        bits = f & 31;
        sy = (f >> 5) & 255;
        val = static_cast<int16_t>(f >> 16);
    } else {
        const Table& t = sh.tab[slot];
        const int look = t.look[w >> 23];
        int ln;
        if (look) {
            ln = look >> 8;
            sy = look & 255;
        } else {
            ln = 10;
            while (ln <= 16 && static_cast<int>(w >> (32 - ln)) > t.maxcode[ln]) ++ln;
            if (ln > 16) {
                sym = 0;
                return ERR_NO_CODE;
            }
            sy = t.vals[(static_cast<int>(w >> (32 - ln)) + t.valoff[ln]) & 255];
        }
        if (k == 0 && sy > 15) {
            sym = sy;
            return ERR_DC_CATEGORY;
        }
        const int s = k == 0 ? sy : sy & 15;
        const int v = s ? static_cast<int>((w << ln) >> (32 - s)) : 0;
        val = s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
        bits = ln + s;
    }
    sym = sy;
    end = false;
    pos = 64;
    if (k == 0) {
        k = 1;
        pos = 0;
    } else {
        const int r = sy >> 4;
        if (sy & 15) {
            const int kk = k + r;
            if (kk > 63) return ERR_AC_RUN;
            pos = kk;
            k = kk + 1;
        } else if (r == 15) {
            if (k > 48) return ERR_ZERO_RUN;
            k += 16;
        } else {
            k = 64;
        }
    }
    p += bits;
    if (k >= 64) {
        k = 0;
        j = j + 1 == nb ? 0 : j + 1;
        end = true;
    }
    return 0;
}

// Decode from `state` to the first codeword boundary at or past `stop`:
// the exit state (kErrState at a fault), the blocks begun before `stop`.
__device__ __forceinline__ long long run_to(const Shared& sh, const uint32_t* fast, Reader& rd, long long state,
                                            long stop, int nb, int& count) {
    long p = state >> 16;
    int j = (state >> 8) & 255, k = state & 255;
    count = 0;
    while (p < stop) {
        count += k == 0;
        int sym, val, pos;
        bool end;
        if (decode_one(sh, fast, rd, p, j, k, nb, sym, val, pos, end)) return kErrState;
    }
    return pack_state(p, j, k);
}

// The fast entry for `peek` (the next kFastBits bits) of a table slot
// (0-3 DC, 4-7 AC): (total length) | symbol << 5 | value << 16, 0 where the
// code and its magnitude take more bits (or the DC category is faulty).
__device__ __forceinline__ uint32_t fast_entry(const Table& t, int slot, int peek) {
    const int look = t.look[peek >> (kFastBits - 9)];
    if (!look) return 0u;
    const int ln = look >> 8, sy = look & 255;
    if (slot < 4 && sy > 15) return 0u;
    const int s = slot < 4 ? sy : sy & 15;
    if (ln + s > kFastBits) return 0u;
    const int v = s ? (peek >> (kFastBits - ln - s)) & ((1 << s) - 1) : 0;
    const int val = s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    return static_cast<uint32_t>(ln + s) | (static_cast<uint32_t>(sy) << 5) |
           (static_cast<uint32_t>(static_cast<uint16_t>(val)) << 16);
}

// In-place inclusive scan of data[0, n) by the whole CTA.
template <typename T>
__device__ void block_scan(T* data, long n, long long* sh) {
    T carry = 0;
    for (long base = 0; base < n; base += kThreads) {
        const long i = base + threadIdx.x;
        T v = i < n ? data[i] : T(0);
        sh[threadIdx.x] = static_cast<long long>(v);
        __syncthreads();
        for (int off = 1; off < kThreads; off <<= 1) {
            const T x = threadIdx.x >= off ? static_cast<T>(sh[threadIdx.x - off]) : T(0);
            __syncthreads();
            v = static_cast<T>(v + x);
            sh[threadIdx.x] = static_cast<long long>(v);
            __syncthreads();
        }
        const T total = static_cast<T>(sh[kThreads - 1]);
        if (i < n) data[i] = static_cast<T>(v + carry);
        __syncthreads();
        carry = static_cast<T>(carry + total);
    }
}

__global__ void __launch_bounds__(kThreads) jpeg_huffman_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ intervals, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ meta_all, int16_t* __restrict__ slots, uint8_t* __restrict__ lens,
    int32_t* __restrict__ status, int32_t* __restrict__ stats, long long* __restrict__ scratch, int S, long subs,
    long ib_total, long long* __restrict__ clocks) {
    __shared__ Shared sh;
    const int n = blockIdx.x, tid = threadIdx.x;
#ifdef NNTC_K5_CLOCKS
    auto stamp = [&](int i) {
        __syncthreads();
        if (tid == 0) {
            unsigned long long ns;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
            clocks[16L * n + 2 * i] = clock64();
            clocks[16L * n + 2 * i + 1] = static_cast<long long>(ns);
        }
    };
#else
    auto stamp = [](int) {};
    (void)clocks;
#endif
    stamp(0);
    if (tid < kMetaCols) sh.meta[tid] = meta_all[static_cast<long>(n) * kMetaCols + tid];
    if (tid == 0) {
        sh.fault = kNoFault;
        sh.sub_base = sh.ib_base = 0;
        sh.codewords = 0;
    }
    __syncthreads();
    // this image's scratch: the subsequences and interval instances of the images before it
    long long sb = 0, ib = 0;
    for (int m = tid; m < n; m += kThreads) {
        const int32_t* mm = meta_all + static_cast<long>(m) * kMetaCols;
        sb += mm[M_BITS] / S + mm[M_INTERVALS] + 1;
        ib += mm[M_INTERVALS] + 1;
    }
    atomicAdd(reinterpret_cast<unsigned long long*>(&sh.sub_base), static_cast<unsigned long long>(sb));
    atomicAdd(reinterpret_cast<unsigned long long*>(&sh.ib_base), static_cast<unsigned long long>(ib));
    const int nb = sh.meta[M_NB];
    if (tid < kMaxMcuBlocks) {
        const int code = tid < nb ? sh.meta[M_BLOCKS + tid] : 0;
        sh.dc_slot[tid] = code & 15;
        sh.ac_slot[tid] = 4 + ((code >> 4) & 15);
        const int q = (code >> 8) - 1, yh = max(1, sh.meta[M_YH]);
        sh.yq[tid] = static_cast<int8_t>(q);
        sh.qx[tid] = static_cast<int8_t>(q >= 0 ? q % yh : 0);
        sh.qy[tid] = static_cast<int8_t>(q >= 0 ? q / yh : 0);
    }
    for (int i = tid; i < 8 * 512; i += kThreads) {
        const int id = sh.meta[M_DC_TABLES + (i >> 9)];
        if (id >= 0) sh.tab[i >> 9].look[i & 511] = static_cast<uint16_t>(tables[static_cast<long>(id) * kTableWords + (i & 511)]);
    }
    for (int i = tid; i < 8 * 18; i += kThreads) {
        const int id = sh.meta[M_DC_TABLES + i / 18];
        if (id >= 0) {
            sh.tab[i / 18].maxcode[i % 18] = tables[static_cast<long>(id) * kTableWords + 512 + i % 18];
            sh.tab[i / 18].valoff[i % 18] = tables[static_cast<long>(id) * kTableWords + 530 + i % 18];
        }
    }
    for (int i = tid; i < 8 * 256; i += kThreads) {
        const int id = sh.meta[M_DC_TABLES + (i >> 8)];
        if (id >= 0) sh.tab[i >> 8].vals[i & 255] = static_cast<uint8_t>(tables[static_cast<long>(id) * kTableWords + 548 + (i & 255)]);
    }
    const int nint = sh.meta[M_INTERVALS];
    const int32_t* iv = intervals + 4L * sh.meta[M_FIRST_INTERVAL];
    // the image's scan words into shared memory, as many as fit (the rest is read from global memory)
    extern __shared__ uint32_t dyn[];
    uint32_t* fast = dyn;
    uint32_t* sw = dyn + 8 * kFastWords;
    const long wb = nint ? iv[0] >> 5 : 0;
    const long nw = nint ? min(static_cast<long>(kScanWords), ((static_cast<long>(iv[4 * (nint - 1) + 1]) + 31) >> 5) + 1 - wb) : 0;
    for (long i = tid; i < nw; i += kThreads) sw[i] = __byte_perm(__ldg(words + wb + i), 0, 0x0123);
    __syncthreads();
    for (int i = tid; i < 8 * kFastWords; i += kThreads) {
        const int slot = i / kFastWords;
        fast[i] = sh.meta[M_DC_TABLES + slot] >= 0 ? fast_entry(sh.tab[slot], slot, i % kFastWords) : 0u;
    }
    __syncthreads();
    stamp(1);

    long long* ex0 = scratch + sh.sub_base;
    long long* ex1 = ex0 + subs;
    long long* ent = ex1 + subs;
    long long* first_block = ent + subs;
    long long* cnt = first_block + subs;
    long long* ibase = scratch + 5 * subs + sh.ib_base;
    uint32_t* dcs = reinterpret_cast<uint32_t*>(scratch + 5 * subs + ib_total);  // Y blocks: dc_base + ordinal
    const int rst = sh.meta[M_RST];
    const long mcus = static_cast<long>(sh.meta[M_MCUS_X]) * sh.meta[M_MCUS_Y];

    // the interval instances' subsequences: ibase[li] the first, ibase[nint] the image's count
    for (int li = tid; li <= nint; li += kThreads) {
        const long len = li < nint ? iv[4 * li + 1] - iv[4 * li] : 0;
        ibase[li] = li < nint ? (len + S - 1) / S + (len == 0) : 0;
    }
    __syncthreads();
    block_scan<long long>(ibase, nint + 1, sh.scan);
    for (int li = tid; li <= nint; li += kThreads) {
        const long len = li < nint ? iv[4 * li + 1] - iv[4 * li] : 0;
        ibase[li] -= li < nint ? (len + S - 1) / S + (len == 0) : 0;  // exclusive
    }
    __syncthreads();
    const long nsub = ibase[nint];

    // a row (local subsequence): its interval instance, start, stop, end bit
    auto row = [&](long t, int& li, long& start, long& stop, long& e, bool& first, bool& last) {
        int lo = 0, hi = nint - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (ibase[mid] <= t) lo = mid; else hi = mid - 1;
        }
        li = lo;
        const long u = t - ibase[li], ns = ibase[li + 1] - ibase[li];
        e = iv[4 * li + 1];
        start = iv[4 * li] + u * S;
        first = u == 0;
        last = u == ns - 1;
        stop = last ? e : start + S;
    };

    // (a) the guess, then passes until none changes an exit. Each thread takes a contiguous range of the
    // subsequences and, within a pass, carries its own fresh exits along it (the front moves a range a pass)
    const long per = (nsub + kThreads - 1) / kThreads;
    const long t0 = min(nsub, tid * per), t1 = min(nsub, t0 + per);
    for (long t = t0; t < t1; ++t) {
        int li;
        long start, stop, e;
        bool first, last;
        row(t, li, start, stop, e, first, last);
        const long long g = pack_state(start, 0, 0);
        long long x = kErrState;
        int c = 0;
        if (!last) {
            Reader rd{words, sw, wb, nw, e};
            x = run_to(sh, fast, rd, g, stop, nb, c);
        }
        ex0[t] = x;
        ent[t] = g;
        cnt[t] = c;
    }
    stamp(2);
    long long* cur = ex0;
    long long* nxt = ex1;
    int passes = 1;
    for (;;) {
        __syncthreads();
        ++passes;
        int changed = 0;
        for (long t = t0; t < t1; ++t) {
            int li;
            long start, stop, e;
            bool first, last;
            row(t, li, start, stop, e, first, last);
            long long x = cur[t];
            if (!last) {
                const long long g = pack_state(start, 0, 0);
                long long entry = first ? g : t > t0 ? nxt[t - 1] : cur[t - 1];
                if (entry == kErrState) entry = g;
                if (entry != ent[t]) {
                    Reader rd{words, sw, wb, nw, e};
                    int c;
                    const long long y = run_to(sh, fast, rd, entry, stop, nb, c);
                    changed |= y != x;
                    x = y;
                    cnt[t] = c;
                    ent[t] = entry;
                }
            }
            nxt[t] = x;
        }
        const int any = __syncthreads_or(changed);
        long long* tmp = cur;
        cur = nxt;
        nxt = tmp;
        if (!any) break;
    }
    stamp(3);
    // (b) each subsequence's first block: a scan of the blocks begun, less its instance's start
    for (long t = tid; t < nsub; t += kThreads) {
        int li;
        long start, stop, e;
        bool first, last;
        row(t, li, start, stop, e, first, last);
        first_block[t] = last ? 0 : cnt[t];
    }
    __syncthreads();
    block_scan<long long>(first_block, nsub, sh.scan);  // inclusive
    stamp(4);

    // (c) each subsequence from its exact entry, its blocks to their ends
    const int yh = sh.meta[M_YH], yv = sh.meta[M_YV], mx = sh.meta[M_MCUS_X], gw = sh.meta[M_GW],
              gh = sh.meta[M_GH];
    const long fb0 = sh.meta[M_FIRST_BLOCK], dcb = sh.meta[M_DC_BASE];
    int codewords = 0;
    for (long t = tid; t < nsub; t += kThreads) {
        int li;
        long start, stop, e;
        bool first, last;
        row(t, li, start, stop, e, first, last);
        const long long entry = first ? pack_state(start, 0, 0) : cur[t - 1];
        if (entry == kErrState) continue;
        // the blocks begun before it in its interval: exclusive scans at it and at the interval's first
        const long h = ibase[li];
        const long own = last ? 0 : cnt[t], at_h = ibase[li + 1] - h == 1 ? 0 : cnt[h];
        int b = static_cast<int>((first_block[t] - own) - (first_block[h] - at_h));
        const int first_mcu = li * rst;
        const int total = static_cast<int>(rst ? min(static_cast<long>(rst), mcus - first_mcu) : mcus) * nb;
        Reader rd{words, sw, wb, nw, e};
        long p = entry >> 16;
        int j = (entry >> 8) & 255, k = entry & 255;
        int sym, val, pos;
        bool end;
        bool bad = false;
        while (k != 0) {  // the tail of a block begun before this subsequence: its decode is the other's
            if (decode_one(sh, fast, rd, p, j, k, nb, sym, val, pos, end)) {
                bad = true;
                break;
            }
        }
        if (bad || b >= total) continue;
        const unsigned long long seq0 = static_cast<unsigned long long>(first_mcu) * nb;
        // block b's place, kept up as b advances: its index in the MCU, the MCU and its column and row
        int jb = b % nb, mcu = first_mcu + b / nb;
        int mcx = mcu % mx, mcy = mcu / mx;
        while (b < total && (last || p < stop)) {
            if (j != jb) {
                atomicMin(&sh.fault, ((seq0 + b) << 16) | (ERR_BLOCK_COUNT << 8));
                break;
            }
            const int q = sh.yq[j];
            const int bx = mcx * yh + sh.qx[j], by = mcy * yv + sh.qy[j];
            const bool kept = q >= 0 && bx < gw && by < gh;
            const long sb = fb0 + static_cast<long>(by) * gw + bx;
            int lastw = 0;
            int fault = 0;
            do {
                const int k0 = k;
                fault = decode_one(sh, fast, rd, p, j, k, nb, sym, val, pos, end);
                if (fault) break;
                ++codewords;
                if (k0 == 0) {
                    if (q >= 0) dcs[dcb + static_cast<long>(mcu) * (yh * yv) + q] = static_cast<uint32_t>(val);
                } else if (kept && pos < 64) {
                    int16_t* slot = slots + sb * 64;
                    for (int z = lastw + 1; z < pos; ++z) slot[z] = 0;
                    slot[pos] = static_cast<int16_t>(val);
                    lastw = pos;
                }
            } while (!end);
            if (fault) {
                atomicMin(&sh.fault, ((seq0 + b) << 16) | (fault << 8) | (sym & 255));
                break;
            }
            if (p > e) {
                atomicMin(&sh.fault, ((seq0 + b) << 16) | (ERR_OVERRUN << 8) | (iv[4 * li + 2] & 255));
                break;
            }
            if (kept) lens[sb] = static_cast<uint8_t>(lastw + 1);
            ++b;
            if (++jb == nb) {
                jb = 0;
                ++mcu;
                if (++mcx == mx) {
                    mcx = 0;
                    ++mcy;
                }
            }
        }
    }
    atomicAdd(&sh.codewords, codewords);
    __syncthreads();
    stamp(5);

    // (d) the DC values: a scan of the differences (mod 2^32), less the scan before each interval's first
    const long ny = mcus * yh * yv;
    block_scan<uint32_t>(dcs + dcb, ny, sh.scan);
    for (long o = tid; o < ny; o += kThreads) {
        const long mcu = o / (yh * yv);
        const int q = static_cast<int>(o % (yh * yv));
        const long head = rst ? (mcu / rst) * rst * (yh * yv) : 0;
        const uint32_t v = dcs[dcb + o] - (head > 0 ? dcs[dcb + head - 1] : 0u);
        const int bx = static_cast<int>(mcu % mx) * yh + q % yh;
        const int by = static_cast<int>(mcu / mx) * yv + q / yh;
        if (bx < gw && by < gh) slots[(fb0 + static_cast<long>(by) * gw + bx) * 64] = static_cast<int16_t>(v);
    }
    stamp(6);
    if (tid == 0) {
        // a fault the parse met at an interval's end, after that interval's blocks
        const int deferred = sh.meta[M_DEFERRED];
        unsigned long long f = sh.fault;
        if (deferred) {
            const long after = (rst ? min(static_cast<long>(nint) * rst, mcus) : mcus) * nb;
            f = min(f, (static_cast<unsigned long long>(after) << 16) | ((deferred & 255) << 8) | ((deferred >> 8) & 255));
        }
        int32_t* st = status + 4L * n;
        st[0] = f == kNoFault ? 0 : static_cast<int>((f >> 8) & 255);
        st[1] = f == kNoFault ? 0 : static_cast<int>(f & 255);
        st[2] = f == kNoFault ? 0 : static_cast<int>(min(f >> 16, 0x7fffffffull));
        st[3] = f != kNoFault && deferred && static_cast<int>((f >> 8) & 255) == (deferred & 255) ? deferred >> 16 : 0;
        int32_t* sx = stats + 3L * n;
        sx[0] = passes;
        sx[1] = static_cast<int>(nsub);
        sx[2] = sh.codewords;
    }
}

}  // namespace

// The earlier design's launch: a CTA an image. Returns a cudaError_t.
extern "C" int jpeg_huffman_ctas_design(const uint8_t* scan, const int32_t* intervals, const int32_t* tables,
                                        const int32_t* meta, int16_t* slots, uint8_t* lens, int32_t* status,
                                        int32_t* stats, long long* scratch, int N, int subsequence_bits, long subs,
                                        long intervals_total, long long* clocks, cudaStream_t stream) {
    if (N <= 0) return cudaSuccess;
    if (subsequence_bits < 32 || reinterpret_cast<uintptr_t>(scan) % 4) return cudaErrorInvalidValue;
    const cudaError_t attr =
        cudaFuncSetAttribute(jpeg_huffman_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynamicBytes);
    if (attr != cudaSuccess) return attr;
    jpeg_huffman_kernel<<<N, kThreads, kDynamicBytes, stream>>>(reinterpret_cast<const uint32_t*>(scan), intervals, tables,
                                                    meta, slots, lens, status, stats, scratch, subsequence_bits,
                                                    subs, intervals_total + N, clocks);
    return cudaGetLastError();
}

