// K5: the Huffman (entropy) decode of a batch of baseline JPEG scans, by
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
// version it is held to, bit for bit, stats included): each restart interval
// cut into subsequences of S bits, an image's subsequences grouped into
// sequences of T = 32 or 128 (a sequence a CTA, a subsequence a thread; S
// and T an image, from its scan against the batch's mean:
// kernels/jpeg_huffman.py:image_layout); (a) each subsequence but an
// interval's last decoded from a guessed state (block 0 of the MCU, zigzag
// index 0) to its first codeword boundary at or past its end, then passes
// within the sequence, each subsequence decoded again from its predecessor's
// exit where that changed (the sequence's head keeps its guess), until a
// pass changes no exit; then the chain across the image's sequences: a CTA
// re-decodes its head subsequences from its predecessor's tentative exit
// until an exit equals the one it holds, then from the predecessor's final
// exit if that differs, and publishes its own final exit with the blocks
// begun in its last interval so far; (b) a scan of the blocks begun in each
// subsequence, within the CTA plus that count, gives its first block; (c)
// each subsequence decoded from its exact entry, each block begun in it to
// its end, a kept Y block's AC coefficients written to its slot in zigzag
// order up to the last nonzero one (zeros between) and its length to `lens`,
// each Y block's DC difference to a scratch array; (d) in a last small
// launch, the DC values by a scan of the differences along each interval
// (uint32, low 16 bits kept), and the status and stats. The first fault of
// an image in scan order goes to its status word (a 64-bit atomicMin across
// its CTAs). Stats an image: passes (the most of any of its sequences, plus
// the head subsequences all its sequences re-decoded), subsequences,
// codewords decoded in (c).
//
// What bounds it on the H100: neither bytes nor operations but the serial
// chain of a decode: each codeword's position depends on the one before, and
// a lone thread takes hundreds of cycles a codeword. A guessed decode falls
// into step with the sequential one only after D bits (thousands on flat
// frames, whose flat blocks are a periodic 6-bit pattern, and on photos;
// tens of thousands on dense noise, where no EOB resets the zigzag index):
// the passes cost about D bits of serial decode, and so does the chain's
// head re-decode. The bytes (the scan read a few times, the slots written)
// are microseconds of HBM time. What the design does about it:
//   - the grid is the batch's sequences, not its images: about 8 sequences an
//     image, so that the head re-decodes of neighbouring CTAs run at once and
//     a sequence is longer than D; 32 subsequences a sequence where 128 would
//     leave them under 256 bits (flat frames), which keeps the passes few;
//   - the layout is an image's own: an image far larger than the batch's mean
//     (a dense frame among flat ones) takes its own longer sequences, so that
//     its chain does not walk one short sequence after another;
//   - CTAs of 128 threads (a sequence of 32 runs on the first warp), as many
//     as the SMs hold, each taking sequence after sequence by an atomic
//     ticket, so that a sequence's predecessor is running or done (no
//     cooperative launch: K5 shares the card with the training graph); the
//     chain passes exits in a record a sequence with a flag (1: tentative, 2:
//     final). A predecessor's tentative exit is final unless its own head
//     re-decode ran through its whole sequence, so the CTAs re-decode their
//     heads in parallel and the chain waits only for flags; an image's first
//     sequence, and one whose head starts an interval, start in a known
//     state;
//   - exits pass between threads by warp shuffles and between warps through
//     shared memory; a pass ends in one __syncthreads_or;
//   - a codeword is one lookup of a 32-bit code entry by the next 10 bits
//     (its bits with the magnitude's, k's advance, its faults), built once a
//     batch by a first small launch: each distinct table's entries, and each
//     image's layout, interval bases, first sequence and DC entries, in which
//     a flat block (a DC codeword and its AC table's EOB in the window) is one
//     entry; a CTA stages only the tables its image uses (31 KB of shared
//     memory at most, 7 CTAs an SM);
//   - the scan is read through L1 into a 64-bit shift register refilled
//     without a branch (a warp's threads cross words at different
//     codewords), the next word in flight; (c) is one loop over codewords,
//     not blocks over codewords (which ran a warp at its densest block);
//   - bit positions are 32-bit, a state (bit, block in the MCU, k) is one
//     64-bit word; (c) keeps each block's place up without divisions.

#include <algorithm>

#include "nntc_kernels.h"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kThreads = 128;  // a decode CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMetaCols = 34;
constexpr int kTableWords = 804;
constexpr int kMaxMcuBlocks = 10;
constexpr int kSlots = 6;  // the tables an image's blocks use at most: a DC and an AC table each of 1 or 3 components
// meta's columns (kernels/jpeg_huffman.py: M_*)
constexpr int M_GW = 2, M_FIRST_BLOCK = 3, M_GH = 4, M_MCUS_X = 5, M_MCUS_Y = 6, M_RST = 7, M_NB = 8, M_YH = 9,
              M_YV = 10, M_FIRST_INTERVAL = 11, M_INTERVALS = 12, M_DC_BASE = 13, M_BITS = 14, M_DEFERRED = 15,
              M_DC_TABLES = 16, M_BLOCKS = 24;  // the AC tables' ids follow the DC tables'
constexpr int ERR_NO_CODE = 1, ERR_DC_CATEGORY = 2, ERR_AC_RUN = 3, ERR_ZERO_RUN = 4, ERR_OVERRUN = 5,
              ERR_BLOCK_COUNT = 6;
constexpr long long kErrState = -1;
constexpr unsigned long long kNoFault = ~0ull;
constexpr int kFastBits = 10;
constexpr int kFastWords = 1 << kFastBits;
// an image's layout (kernels/jpeg_huffman.py: image_layout): its sequence bits are the batch's times 2^e, e in
// [-kRatioSteps, kRatioSteps] the largest with 2^(e+1) * bits_total <= 3 * bits * N (e = 0 from 2/3 to 4/3 of the
// mean scan), within 2^11-2^20; 128 subsequences where that leaves 256 bits a subsequence, else 32; S = the
// sequence bits / T within 64-8,192, or the caller's S for every image
constexpr int kRatioSteps = 8;
// a code entry (code_entry): the bits of the code and its magnitude (bits 0-4; 0 in a table: a code longer than
// kFastBits), k's advance (5-11; an EOB 64), a DC category above 15 (12), a run that faults if it passes the 64th
// coefficient (13), the code's length (14-18), the magnitude's bits (19-22), an EOB follows in the window (23: a
// DC entry only; the bits and k's advance are the whole block's), the symbol (24-31)
constexpr uint32_t kDcFault = 1u << 12, kRunFault = 1u << 13, kEobFollows = 1u << 23;

// The scratch (int64 words; kernels/jpeg_huffman.py: scratch_words), carved by the three launches alike.
struct Scratch {
    unsigned int* ctl;  // the ticket, the images laid out, the batch's sequences (zeroed before launch 1)
    long long* chain;   // a sequence: tentative exit, final exit, (flag << 32) | blocks begun in its last interval
    unsigned long long* fault;  // an image: the first fault's key
    int* passes;                // an image: the most passes of a sequence, the head re-decodes
    int* counts;                // an image: codewords decoded in (c), subsequences
    int* lay;                   // an image: S, T, its first interval instance, its first sequence
    uint32_t* codes;            // a table: its DC form's kFastWords code entries, then its AC form's
    uint32_t* dccodes;          // an image: the entries of its DC tables 0-3, a flat block one entry
    int* ibase;                 // an interval instance: its first subsequence in its image; an image's count last
    uint32_t* dcs;              // a Y block: its DC difference, then the DC value
    __device__ __host__ Scratch(long long* s, int N, int T, long G, long intervals_total) {
        ctl = reinterpret_cast<unsigned int*>(s);
        chain = s + 2;
        fault = reinterpret_cast<unsigned long long*>(chain + 3 * G);
        passes = reinterpret_cast<int*>(fault + N);
        counts = passes + 2 * N;
        lay = counts + 2 * N;
        codes = reinterpret_cast<uint32_t*>(lay + 4 * N);
        dccodes = codes + 2L * T * kFastWords;
        ibase = reinterpret_cast<int*>(dccodes + 4L * N * kFastWords);
        dcs = reinterpret_cast<uint32_t*>(ibase + ((intervals_total + N + 1) & ~1L));
    }
};

// codes of 11-16 bits: canonical maxcode and value offset by length, the symbols
struct Slow {
    int32_t maxcode[18];
    int32_t valoff[18];
    uint8_t vals[256];
};

// An image's decode tables (its kSlots used ones) and MCU layout, in shared memory.
struct Tables {
    uint32_t codes[kSlots][kFastWords];
    Slow slow[kSlots];
    int32_t meta[kMetaCols];
    uint8_t dc_slot[kMaxMcuBlocks], ac_slot[kMaxMcuBlocks];  // each block's tables in `codes`
    int8_t yq[kMaxMcuBlocks], qx[kMaxMcuBlocks], qy[kMaxMcuBlocks];  // Y's block in the MCU, its column and row
    int8_t table[kSlots];  // each slot's table: 0-3 the DC tables, 4-7 the AC tables (meta's M_DC_TABLES + it)
    int used;
};

struct Shared : Tables {
    // the sequence's subsequences: the state each was decoded from, its exit, the blocks begun in it, its bits
    long long ent[kThreads], ex[kThreads];
    int cnt[kThreads];
    uint32_t start[kThreads], stop[kThreads], end[kThreads];
    uint8_t last[kThreads];
    long long warp_last[kWarps];
    int warp_sum[kWarps], warp_head[kWarps];
    unsigned long long fault;
    long long pred_exit;
    int pred_count, heads, codewords;
    int ticket, image, q, staged;
};

// The interval's bits from bit p on, as a 64-bit shift register (`buf`, its
// first `nbits` bits valid, 32 at least) refilled a word at a time without a
// branch (a warp's threads cross words at different codewords); the next word
// is in flight as loaded. Big-endian; zero at or past bit `e`; read through L1.
struct Reader {
    const uint32_t* words;
    uint32_t e;
    uint64_t buf;
    int nbits, next;
    uint32_t raw;

    __device__ __forceinline__ uint32_t fetch(int i) const {
        return (static_cast<uint32_t>(i) << 5) < e ? __ldg(words + i) : 0u;
    }
    // word i as read (`x`: its bytes as loaded)
    __device__ __forceinline__ uint32_t word(int i, uint32_t x) const {
        const uint32_t bit = static_cast<uint32_t>(i) << 5, rem = e - bit;
        const uint32_t mask = bit >= e ? 0u : rem >= 32 ? ~0u : ~0u << (32 - rem);
        return __byte_perm(x, 0, 0x0123) & mask;
    }
    __device__ __forceinline__ Reader(const uint32_t* w, uint32_t end, uint32_t p) : words(w), e(end) {
        const int i = static_cast<int>(p >> 5);
        const int off = p & 31;
        buf = ((static_cast<uint64_t>(word(i, fetch(i))) << 32) | word(i + 1, fetch(i + 1))) << off;
        nbits = 64 - off;
        next = i + 2;
        raw = fetch(next);
    }
    __device__ __forceinline__ uint32_t peek() const { return static_cast<uint32_t>(buf >> 32); }
    __device__ __forceinline__ void skip(int n) {
        buf <<= n;
        nbits -= n;
        const bool refill = nbits < 32;
        buf |= refill ? static_cast<uint64_t>(word(next, raw)) << (32 - nbits) : 0ull;
        nbits += refill ? 32 : 0;
        next += refill;
        if (refill) raw = fetch(next);
    }
};

__device__ __forceinline__ long long pack_state(uint32_t p, int j, int k) {
    return (static_cast<long long>(p) << 16) | (j << 8) | k;
}

// The code entry of a code of `ln` bits and its symbol `sy` (`dc`: a DC code).
__device__ __forceinline__ uint32_t code_entry(int ln, int sy, bool dc) {
    const int r = sy >> 4, s = dc ? (sy > 15 ? 0 : sy) : sy & 15;
    const int adv = dc ? 1 : s ? r + 1 : r == 15 ? 16 : 64;
    const uint32_t faults = dc ? (sy > 15 ? kDcFault : 0u) : (s || r == 15 ? kRunFault : 0u);
    return static_cast<uint32_t>(ln + s) | (static_cast<uint32_t>(adv) << 5) | faults |
           (static_cast<uint32_t>(ln) << 14) | (static_cast<uint32_t>(s) << 19) | (static_cast<uint32_t>(sy) << 24);
}

// The code entry at window `w` for table slot `slot`: one lookup by the next
// kFastBits bits; a longer code by the canonical maxcode search; 0: no code.
__device__ __forceinline__ uint32_t lookup(const Tables& sh, int slot, uint32_t w, bool dc) {
    const uint32_t f = sh.codes[slot][w >> (32 - kFastBits)];
    if (f) return f;
    const Slow& t = sh.slow[slot];
    int ln = kFastBits + 1;
    while (ln <= 16 && static_cast<int>(w >> (32 - ln)) > t.maxcode[ln]) ++ln;
    if (ln > 16) return 0u;
    return code_entry(ln, t.vals[(static_cast<int>(w >> (32 - ln)) + t.valoff[ln]) & 255], dc);
}

// One codeword (and its magnitude) at bit p in state (j, k), or a DC
// codeword and the EOB after it: advances them; returns a fault code or 0.
// `sym`: the symbol; `val`: the DC difference or the AC coefficient; `pos`:
// the zigzag position of a nonzero AC coefficient (64: none); `end`: the
// block ended; `codewords`: counts the codewords.
__device__ __forceinline__ int decode_one(const Tables& sh, Reader& rd, uint32_t& p, int& j, int& k, int nb, int& sym,
                                          int& val, int& pos, bool& end, int& codewords) {
    const uint32_t w = rd.peek();
    const uint32_t f = lookup(sh, k == 0 ? sh.dc_slot[j] : sh.ac_slot[j], w, k == 0);
    if (!f) {
        sym = 0;
        return ERR_NO_CODE;
    }
    sym = f >> 24;
    if (f & kDcFault) return ERR_DC_CATEGORY;
    const int ln = (f >> 14) & 31, s = (f >> 19) & 15;
    codewords += 1 + ((f & kEobFollows) != 0);
    const int nk = k + ((f >> 5) & 127);
    if ((f & kRunFault) && nk > 64) return s ? ERR_AC_RUN : ERR_ZERO_RUN;
    const int v = s ? static_cast<int>((w << ln) >> (32 - s)) : 0;
    val = s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    pos = k == 0 ? 0 : s ? nk - 1 : 64;
    p += f & 31;
    rd.skip(f & 31);
    end = nk >= 64;
    if (end) {
        k = 0;
        j = j + 1 == nb ? 0 : j + 1;
    } else {
        k = nk;
    }
    return 0;
}

// Decode from `state` to the first codeword boundary at or past `stop`:
// the exit state (kErrState at a fault), the blocks begun before `stop`.
// One lookup of a code entry a codeword (`lookup`), the block's table slots
// kept in registers.
__device__ __forceinline__ long long run_to(const Tables& sh, const uint32_t* words, uint32_t e, long long state,
                                            uint32_t stop, int nb, int& count) {
    uint32_t p = static_cast<uint32_t>(state >> 16);
    Reader rd(words, e, p);
    int j = (state >> 8) & 255, k = state & 255;
    int dcs = sh.dc_slot[j], acs = sh.ac_slot[j];
    int c = 0;
    long long exit = kErrState;
    for (;;) {
        if (p >= stop) {
            exit = pack_state(p, j, k);
            break;
        }
        c += k == 0;
        const uint32_t w = rd.peek();
        const int slot = k == 0 ? dcs : acs;
        uint32_t f = lookup(sh, slot, w, k == 0);
        if ((f & kEobFollows) && p + ((f >> 14) & 31) + ((f >> 19) & 15) >= stop)  // the DC codeword alone
            f = (f & ~(31u | (127u << 5) | kEobFollows)) | (((f >> 14) & 31) + ((f >> 19) & 15)) | (1u << 5);
        const int nk = k + ((f >> 5) & 127);
        if (!f || (f & kDcFault) || ((f & kRunFault) && nk > 64)) break;
        p += f & 31;
        rd.skip(f & 31);
        k = nk >= 64 ? 0 : nk;
        if (nb > 1 && k == 0) {
            j = j + 1 == nb ? 0 : j + 1;
            dcs = sh.dc_slot[j];
            acs = sh.ac_slot[j];
        }
    }
    count = c;
    return exit;
}

__device__ __forceinline__ int flag_of(const long long* chain, long s) {
    return static_cast<int>(static_cast<unsigned long long>(*reinterpret_cast<volatile const long long*>(
                                chain + 3 * s + 2)) >> 32);
}

// Wait until sequence s has published at least `level` (1: tentative, 2: final).
__device__ __forceinline__ void wait_for(const long long* chain, long s, int level) {
    while (flag_of(chain, s) < level) __nanosleep(100);
    __threadfence();
}

// Publish sequence s's exit at `level` (the data first, then the flag).
__device__ __forceinline__ void publish(long long* chain, long s, int level, long long exit, int blocks) {
    volatile long long* rec = chain + 3 * s;
    rec[level - 1] = exit;
    __threadfence();
    rec[2] = (static_cast<long long>(level) << 32) | static_cast<unsigned int>(blocks);
}

// The code of up to kFastBits bits that starts `peek` (the next kFastBits
// bits) in table `t` (its 804 words): its length (0: none) and symbol.
__device__ __forceinline__ int short_code(const int32_t* t, int peek, int& sy) {
    const int look = t[peek >> (kFastBits - 9)];
    if (look) {
        sy = look & 255;
        return look >> 8;
    }
    if (peek <= t[512 + kFastBits]) {  // maxcode of length kFastBits
        sy = t[548 + ((peek + t[530 + kFastBits]) & 255)];
        return kFastBits;
    }
    sy = 0;
    return 0;
}

// In-place inclusive scan of data[0, n) by the whole CTA (kPrepThreads threads).
template <typename V>
__device__ void block_scan(V* data, long n, V* sh) {
    V carry = 0;
    for (long base = 0; base < n; base += kPrepThreads) {
        const long i = base + threadIdx.x;
        V v = i < n ? data[i] : V(0);
        sh[threadIdx.x] = v;
        __syncthreads();
        for (int off = 1; off < kPrepThreads; off <<= 1) {
            const V x = threadIdx.x >= off ? sh[threadIdx.x - off] : V(0);
            __syncthreads();
            v += x;
            sh[threadIdx.x] = v;
            __syncthreads();
        }
        const V total = sh[kPrepThreads - 1];
        if (i < n) data[i] = v + carry;
        __syncthreads();
        carry += total;
    }
}

// Launch 1: the fast entries of each table (blocks [N, N + 2T)); each image's layout, interval bases and DC
// entries (blocks [0, N)), and, in the last image block to finish, each image's first sequence and the chain reset.
__global__ void __launch_bounds__(kPrepThreads) jpeg_huffman_prep(
    const int32_t* __restrict__ intervals, const int32_t* __restrict__ tables, const int32_t* __restrict__ meta_all,
    long long* __restrict__ scratch, int N, int T, int sequence_bits, int fixed_bits, long bits_total, long G,
    long intervals_total) {
    Scratch sc(scratch, N, T, G, intervals_total);
    const int tid = threadIdx.x, b = blockIdx.x;
    if (b >= N) {
        const int id = (b - N) >> 1, form = (b - N) & 1;
        const int32_t* t = tables + static_cast<long>(id) * kTableWords;
        for (int i = tid; i < kFastWords; i += kPrepThreads) {
            int sy;
            const int ln = short_code(t, i, sy);
            sc.codes[(2L * id + form) * kFastWords + i] = ln ? code_entry(ln, sy, form == 0) : 0u;
        }
        return;
    }
    __shared__ int part[kPrepThreads];
    __shared__ int ib0, carry, S, TS, pair[4], eob[4];
    __shared__ bool last_block;
    const int32_t* m = meta_all + static_cast<long>(b) * kMetaCols;
    const int nb = m[M_NB];
    if (tid == 0) {  // the layout (kRatioSteps)
        const long long num = 3LL * m[M_BITS] * N;
        int e = -kRatioSteps;
        for (int k = -kRatioSteps + 1; k <= kRatioSteps; ++k)
            if (k >= -1 ? (bits_total << (k + 1)) <= num : bits_total <= (num << (-(k + 1)))) e = k;
        long long seq = e >= 0 ? static_cast<long long>(sequence_bits) << e : sequence_bits >> -e;
        seq = seq < 2048 ? 2048 : seq > (1 << 20) ? (1 << 20) : seq;
        TS = seq >= 128 * 256 ? 128 : 32;
        const long long s = seq / TS;
        S = fixed_bits ? fixed_bits : static_cast<int>(s < 64 ? 64 : s > 8192 ? 8192 : s);
        ib0 = carry = 0;
    }
    if (tid < 4) {  // the one AC table each DC table pairs with in this image's blocks (-2: several; -1: none)
        int ac = -1;
        for (int j = 0; j < nb; ++j) {
            const int code = m[M_BLOCKS + j];
            if ((code & 15) == tid) ac = ac == -1 || ac == ((code >> 4) & 15) ? (code >> 4) & 15 : -2;
        }
        pair[tid] = ac;
        eob[tid] = kFastWords;
    }
    // this image's interval instances follow those of the images before it (a count after each)
    int before = 0;
    for (int n = tid; n < b; n += kPrepThreads) before += meta_all[static_cast<long>(n) * kMetaCols + M_INTERVALS] + 1;
    __syncthreads();
    atomicAdd(&ib0, before);
    __syncthreads();
    const int nint = m[M_INTERVALS];
    const int32_t* iv = intervals + 4L * m[M_FIRST_INTERVAL];
    int* ib = sc.ibase + ib0;
    for (int base = 0; base <= nint; base += kPrepThreads) {  // an exclusive scan of the intervals' subsequences
        const int li = base + tid;
        const int len = li < nint ? iv[4 * li + 1] - iv[4 * li] : 0;
        int v = li < nint ? (len + S - 1) / S + (len == 0) : 0;
        part[tid] = v;
        __syncthreads();
        for (int off = 1; off < kPrepThreads; off <<= 1) {
            const int x = tid >= off ? part[tid - off] : 0;
            __syncthreads();
            part[tid] += x;
            __syncthreads();
        }
        if (li <= nint) ib[li] = carry + part[tid] - v;
        __syncthreads();
        if (tid == 0) carry += part[kPrepThreads - 1];
        __syncthreads();
    }
    // the DC tables' entries; where a DC table pairs with one AC table, an entry whose code and magnitude are
    // followed, in the window, by that table's EOB (symbol 0) decodes the whole block
    for (int d = 0; d < 4; ++d) {
        const int id = pair[d] >= 0 ? m[M_DC_TABLES + 4 + pair[d]] : -1;
        if (id < 0) continue;
        const int32_t* t = tables + static_cast<long>(id) * kTableWords;
        for (int i = tid; i < kFastWords; i += kPrepThreads) {
            int sy;
            if (short_code(t, i, sy) && sy == 0) atomicMin(&eob[d], i);
        }
    }
    __syncthreads();
    if (tid < 4) {  // the EOB's code (<< 8) and length, -1 where it takes more than kFastBits bits
        const int i = eob[tid];
        int sy, len = 0;
        if (i < kFastWords) len = short_code(tables + static_cast<long>(m[M_DC_TABLES + 4 + pair[tid]]) * kTableWords,
                                             i, sy);
        eob[tid] = pair[tid] >= 0 && i < kFastWords ? ((i >> (kFastBits - len)) << 8) | len : -1;
    }
    __syncthreads();
    for (int d = 0; d < 4; ++d) {
        const int id = m[M_DC_TABLES + d];
        if (pair[d] == -1 || id < 0) continue;  // no block uses it
        const int32_t* t = tables + static_cast<long>(id) * kTableWords;
        const int len = eob[d] & 255, code = eob[d] >> 8;
        uint32_t* out = sc.dccodes + (4L * b + d) * kFastWords;
        for (int i = tid; i < kFastWords; i += kPrepThreads) {
            int sy;
            const int ln = short_code(t, i, sy);
            uint32_t f = ln ? code_entry(ln, sy, true) : 0u;
            const int w = f & 31;
            if (eob[d] >= 0 && f && !(f & kDcFault) && w + len <= kFastBits &&
                ((i >> (kFastBits - w - len)) & ((1 << len) - 1)) == code)
                f = (f & ~(31u | (127u << 5))) | static_cast<uint32_t>(w + len) | (64u << 5) | kEobFollows;
            out[i] = f;
        }
    }
    if (tid == 0) {
        sc.fault[b] = kNoFault;
        sc.passes[2 * b] = sc.passes[2 * b + 1] = 0;
        sc.counts[2 * b] = 0;
        sc.counts[2 * b + 1] = ib[nint];
        int* l = sc.lay + 4 * b;
        l[0] = S;
        l[1] = TS;
        l[2] = ib0;
        l[3] = (ib[nint] + TS - 1) / TS;  // its sequences, then (below) its first
        __threadfence();
        last_block = atomicAdd(sc.ctl + 1, 1u) == static_cast<unsigned>(N - 1);
    }
    __syncthreads();
    if (!last_block) return;
    // the last image block: the first sequence of each image (an exclusive scan), the batch's, the chain reset
    __threadfence();
    int carry_seq = 0;
    for (int base = 0; base < N; base += kPrepThreads) {
        const int n = base + tid;
        const int v = n < N ? *reinterpret_cast<volatile int*>(sc.lay + 4 * n + 3) : 0;
        part[tid] = v;
        __syncthreads();
        for (int off = 1; off < kPrepThreads; off <<= 1) {
            const int x = tid >= off ? part[tid - off] : 0;
            __syncthreads();
            part[tid] += x;
            __syncthreads();
        }
        if (n < N) sc.lay[4 * n + 3] = carry_seq + part[tid] - v;
        carry_seq += part[kPrepThreads - 1];
        __syncthreads();
    }
    if (tid == 0) sc.ctl[2] = static_cast<unsigned>(carry_seq);
    for (long i = tid; i < 3L * carry_seq; i += kPrepThreads) sc.chain[i] = i % 3 == 2 ? 0 : kErrState;
}

// Stage image n's tables and MCU layout into shared memory (the whole CTA).
__device__ void stage(Shared& sh, const Scratch& sc, const int32_t* tables, const int32_t* meta_all, int n) {
    const int tid = threadIdx.x;
    if (tid < kMetaCols) sh.meta[tid] = meta_all[static_cast<long>(n) * kMetaCols + tid];
    __syncthreads();
    const int nb = sh.meta[M_NB];
    if (tid == 0) {  // each block's tables, numbered in order of first use (the parse admits 1 or 3 components)
        int8_t slot_of[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
        int used = 0;
        for (int j = 0; j < nb; ++j) {
            const int code = sh.meta[M_BLOCKS + j];
            const int dc = code & 15, ac = 4 + ((code >> 4) & 15);
            if (slot_of[dc] < 0 && used < kSlots) sh.table[slot_of[dc] = static_cast<int8_t>(used++)] = dc;
            if (slot_of[ac] < 0 && used < kSlots) sh.table[slot_of[ac] = static_cast<int8_t>(used++)] = ac;
            sh.dc_slot[j] = static_cast<uint8_t>(slot_of[dc]);
            sh.ac_slot[j] = static_cast<uint8_t>(slot_of[ac]);
        }
        sh.used = used;
    }
    if (tid < kMaxMcuBlocks) {
        const int code = tid < nb ? sh.meta[M_BLOCKS + tid] : 0;
        const int yq = (code >> 8) - 1, yh = max(1, sh.meta[M_YH]);
        sh.yq[tid] = static_cast<int8_t>(yq);
        sh.qx[tid] = static_cast<int8_t>(yq >= 0 ? yq % yh : 0);
        sh.qy[tid] = static_cast<int8_t>(yq >= 0 ? yq / yh : 0);
    }
    __syncthreads();
    for (int slot = 0; slot < sh.used; ++slot) {
        const int tb = sh.table[slot], id = sh.meta[M_DC_TABLES + tb];
        if (id < 0) continue;
        const uint32_t* src = tb < 4 ? sc.dccodes + (4L * n + tb) * kFastWords : sc.codes + (2L * id + 1) * kFastWords;
        for (int i = tid; i < kFastWords; i += kThreads) sh.codes[slot][i] = src[i];
        const int32_t* t = tables + static_cast<long>(id) * kTableWords;
        for (int i = tid; i < 18; i += kThreads) {
            sh.slow[slot].maxcode[i] = __ldg(t + 512 + i);
            sh.slow[slot].valoff[i] = __ldg(t + 530 + i);
        }
        for (int i = tid; i < 256; i += kThreads) sh.slow[slot].vals[i] = static_cast<uint8_t>(__ldg(t + 548 + i));
    }
}

// Launch 2: CTAs as many as the SMs hold, each taking sequence after sequence by ticket, a thread a subsequence:
// (a), (b), (c).
__global__ void __launch_bounds__(kThreads) jpeg_huffman_decode_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ intervals, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ meta_all, int16_t* __restrict__ slots, uint8_t* __restrict__ lens,
    long long* __restrict__ scratch, int N, int T, long G, long intervals_total) {
    __shared__ Shared sh;
    const Scratch sc(scratch, N, T, G, intervals_total);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int sequences = static_cast<int>(sc.ctl[2]);
    // the batch's first sequences go to the CTAs of the lowest indices, which the block scheduler spreads over the
    // SMs; the CTAs past the batch's sequences leave without a ticket
    if (static_cast<int>(blockIdx.x) >= sequences) return;
    if (tid == 0) sh.staged = -1;
    for (;;) {
        __syncthreads();  // the last sequence is done with the shared state
        if (tid == 0) {
            const int ticket = static_cast<int>(atomicAdd(sc.ctl, 1u));
            sh.ticket = ticket;
            sh.fault = kNoFault;
            sh.heads = sh.codewords = 0;
            sh.pred_exit = kErrState;
            sh.pred_count = 0;
            if (ticket < sequences) {  // its image: the last whose first sequence is at or before it
                int lo = 0, hi = N - 1;
                while (lo < hi) {
                    const int mid = (lo + hi + 1) >> 1;
                    if (sc.lay[4 * mid + 3] <= ticket) lo = mid; else hi = mid - 1;
                }
                sh.image = lo;
                sh.q = ticket - sc.lay[4 * lo + 3];
            }
        }
        __syncthreads();
        const int ticket = sh.ticket;
        if (ticket >= sequences) break;
        const int n = sh.image, q = sh.q;
        const long s = ticket;  // the sequences are numbered in image order
        if (n != sh.staged) {
            stage(sh, sc, tables, meta_all, n);
            if (tid == 0) sh.staged = n;
        }
        __syncthreads();
        const int nb = sh.meta[M_NB];
        const int S = sc.lay[4 * n], TS = sc.lay[4 * n + 1], nsub = sc.counts[2 * n + 1];

        // this thread's subsequence
        const int* ibase = sc.ibase + sc.lay[4 * n + 2];
        const int nint = sh.meta[M_INTERVALS];
        const int32_t* iv = intervals + 4L * sh.meta[M_FIRST_INTERVAL];
        const int t = q * TS + tid;
        const int nvalid = min(TS, nsub - q * TS);
        const bool valid = tid < nvalid;
        int li = 0;
        uint32_t start = 0, stop = 0, e = 0;
        bool first = true, last = true;
        if (valid) {
            int lo = 0, hi = nint - 1;
            while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (__ldg(ibase + mid) <= t) lo = mid; else hi = mid - 1;
            }
            li = lo;
            const int u = t - __ldg(ibase + li), ns = __ldg(ibase + li + 1) - __ldg(ibase + li);
            e = static_cast<uint32_t>(iv[4 * li + 1]);
            start = static_cast<uint32_t>(iv[4 * li]) + static_cast<uint32_t>(u) * S;
            first = u == 0;
            last = u == ns - 1;
            stop = last ? e : start + S;
        }
        sh.start[tid] = start;
        sh.stop[tid] = stop;
        sh.end[tid] = e;
        sh.last[tid] = last;
        __syncthreads();

        // (a) the guess, then passes until none changes an exit: Jacobi, the head keeping its guess
        const long long g = pack_state(start, 0, 0);
        long long ent = g, ex = kErrState;
        int cnt = 0;
        if (valid && !last) ex = run_to(sh, words, e, g, stop, nb, cnt);
        int passes = 1;
        if (lane == 31) sh.warp_last[warp] = ex;
        __syncthreads();
        for (;;) {
            ++passes;
            long long prev = __shfl_up_sync(0xffffffffu, ex, 1);
            if (lane == 0) prev = warp ? sh.warp_last[warp - 1] : kErrState;
            __syncthreads();
            const long long entry = tid == 0 || first || prev == kErrState ? g : prev;
            int changed = 0;
            if (valid && !last && entry != ent) {
                int c;
                const long long y = run_to(sh, words, e, entry, stop, nb, c);
                changed = y != ex;
                ex = y;
                cnt = c;
                ent = entry;
            }
            if (lane == 31) sh.warp_last[warp] = ex;
            if (!__syncthreads_or(changed)) break;
        }
        sh.ent[tid] = ent;
        sh.ex[tid] = ex;
        sh.cnt[tid] = cnt;
        if (tid == nvalid - 1) publish(sc.chain, s, 1, ex, 0);  // the tentative exit
        __syncthreads();

        // the chain: the head re-decoded from the predecessor's tentative exit, then from its final one if it differs
        if (tid == 0 && q > 0 && !first) {
            auto walk = [&](long long en) {
                int h = 0;
                if (en == kErrState) en = pack_state(sh.start[0], 0, 0);
                for (int m = 0; m < nvalid && !sh.last[m] && en != sh.ent[m];) {
                    sh.ent[m] = en;
                    int c;
                    const long long x = run_to(sh, words, sh.end[m], en, sh.stop[m], nb, c);
                    ++h;
                    sh.cnt[m] = c;
                    if (x == sh.ex[m]) break;
                    sh.ex[m] = x;
                    if (++m < nvalid) en = x == kErrState ? pack_state(sh.start[m], 0, 0) : x;
                }
                return h;
            };
            wait_for(sc.chain, s - 1, 1);
            const long long tentative = *reinterpret_cast<volatile const long long*>(sc.chain + 3 * (s - 1));
            int h = walk(tentative);
            wait_for(sc.chain, s - 1, 2);
            const long long fin = *reinterpret_cast<volatile const long long*>(sc.chain + 3 * (s - 1) + 1);
            if (fin != tentative) h += walk(fin);
            sh.heads = h;
            sh.pred_exit = fin;
            sh.pred_count = static_cast<int>(*reinterpret_cast<volatile const long long*>(sc.chain + 3 * (s - 1) + 2) &
                                             0xffffffffll);
        }
        __syncthreads();
        ex = sh.ex[tid];

        // (b) the blocks begun before each subsequence in its interval: a segmented scan (an interval's first
        // subsequence starts a segment), the predecessor's count carried into the first segment
        const int own = valid && !last ? sh.cnt[tid] : 0;
        int x = own, hx = first ? 1 : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, off), hy = __shfl_up_sync(0xffffffffu, hx, off);
            if (lane >= off && !hx) {
                x += y;
                hx = hy;
            }
        }
        if (lane == 31) {
            sh.warp_sum[warp] = x;
            sh.warp_head[warp] = hx;
        }
        __syncthreads();
        int incl = x;
        for (int w = warp - 1; w >= 0 && !hx; --w) {
            incl += sh.warp_sum[w];
            hx = sh.warp_head[w];
        }
        if (!hx) incl += sh.pred_count;
        if (tid == nvalid - 1) publish(sc.chain, s, 2, ex, incl);  // the final exit, the blocks begun so far
        int b = incl - own;

        // (c) each subsequence from its exact entry, its blocks to their ends
        const int yh = sh.meta[M_YH], yv = sh.meta[M_YV], mx = sh.meta[M_MCUS_X], gw = sh.meta[M_GW],
                  gh = sh.meta[M_GH], rst = sh.meta[M_RST];
        const long mcus = static_cast<long>(mx) * sh.meta[M_MCUS_Y];
        const long fb0 = sh.meta[M_FIRST_BLOCK], dcb = sh.meta[M_DC_BASE];
        const long long entry = first ? g : tid > 0 ? sh.ex[tid - 1] : sh.pred_exit;
        int codewords = 0;
        if (valid && entry != kErrState) {
            const int first_mcu = li * rst;
            const int total = static_cast<int>(rst ? min(static_cast<long>(rst), mcus - first_mcu) : mcus) * nb;
            uint32_t p = static_cast<uint32_t>(entry >> 16);
            Reader rd(words, e, p);
            int j = (entry >> 8) & 255, k = entry & 255;
            int sym, val, pos;
            bool end;
            bool bad = false;
            while (k != 0) {  // the tail of a block begun before this subsequence: its decode is the other's
                int skipped = 0;
                if (decode_one(sh, rd, p, j, k, nb, sym, val, pos, end, skipped)) {
                    bad = true;
                    break;
                }
            }
            if (!bad && b < total) {
                const unsigned long long seq0 = static_cast<unsigned long long>(first_mcu) * nb;
                // block b's place, kept up as b advances: its index in the MCU, the MCU and its column and row
                int jb = b % nb, mcu = first_mcu + b / nb;
                int mcx = mcu % mx, mcy = mcu / mx;
                int yq = -1, lastw = 0;
                bool kept = false;
                long sb = 0;
                for (;;) {  // a codeword an iteration (a loop over blocks around one over codewords would run a
                            // warp's blocks at its densest thread's length)
                    if (k == 0) {  // block b begins
                        if (b >= total || !(last || p < stop)) break;
                        if (j != jb) {
                            atomicMin(&sh.fault, ((seq0 + b) << 16) | (ERR_BLOCK_COUNT << 8));
                            break;
                        }
                        yq = sh.yq[j];
                        const int bx = mcx * yh + sh.qx[j], by = mcy * yv + sh.qy[j];
                        kept = yq >= 0 && bx < gw && by < gh;
                        sb = fb0 + static_cast<long>(by) * gw + bx;
                        lastw = 0;
                    }
                    const int k0 = k;
                    const int fault = decode_one(sh, rd, p, j, k, nb, sym, val, pos, end, codewords);
                    if (fault) {
                        atomicMin(&sh.fault, ((seq0 + b) << 16) | (fault << 8) | (sym & 255));
                        break;
                    }
                    if (k0 == 0) {
                        if (yq >= 0) sc.dcs[dcb + static_cast<long>(mcu) * (yh * yv) + yq] = static_cast<uint32_t>(val);
                    } else if (kept && pos < 64) {
                        int16_t* slot = slots + sb * 64;
                        for (int z = lastw + 1; z < pos; ++z) slot[z] = 0;
                        slot[pos] = static_cast<int16_t>(val);
                        lastw = pos;
                    }
                    if (end) {
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
            }
        }
        for (int off = 16; off > 0; off >>= 1) codewords += __shfl_down_sync(0xffffffffu, codewords, off);
        if (lane == 0) atomicAdd(&sh.codewords, codewords);
        __syncthreads();
        if (tid == 0) {
            if (sh.fault != kNoFault) atomicMin(sc.fault + n, sh.fault);
            atomicMax(sc.passes + 2 * n, passes);
            atomicAdd(sc.passes + 2 * n + 1, sh.heads);
            atomicAdd(sc.counts + 2 * n, sh.codewords);
        }
    }
}

// Launch 3: a CTA an image: (d) the DC values, the status and the stats.
__global__ void __launch_bounds__(kPrepThreads) jpeg_huffman_finish(
    const int32_t* __restrict__ meta_all, int16_t* __restrict__ slots, int32_t* __restrict__ status,
    int32_t* __restrict__ stats, long long* __restrict__ scratch, int N, int T, long G, long intervals_total) {
    __shared__ uint32_t part[kPrepThreads];
    Scratch sc(scratch, N, T, G, intervals_total);
    const int n = blockIdx.x, tid = threadIdx.x;
    const int32_t* m = meta_all + static_cast<long>(n) * kMetaCols;
    const int yh = m[M_YH], yv = m[M_YV], mx = m[M_MCUS_X], gw = m[M_GW], gh = m[M_GH], rst = m[M_RST];
    const long mcus = static_cast<long>(mx) * m[M_MCUS_Y];
    const long fb0 = m[M_FIRST_BLOCK], dcb = m[M_DC_BASE];
    // (d) the DC values: a scan of the differences (mod 2^32), less the scan before each interval's first
    const long ny = mcus * yh * yv;
    block_scan(sc.dcs + dcb, ny, part);
    for (long o = tid; o < ny; o += kPrepThreads) {
        const long mcu = o / (yh * yv);
        const int yq = static_cast<int>(o % (yh * yv));
        const long head = rst ? (mcu / rst) * rst * (yh * yv) : 0;
        const uint32_t v = sc.dcs[dcb + o] - (head > 0 ? sc.dcs[dcb + head - 1] : 0u);
        const int bx = static_cast<int>(mcu % mx) * yh + yq % yh;
        const int by = static_cast<int>(mcu / mx) * yv + yq / yh;
        if (bx < gw && by < gh) slots[(fb0 + static_cast<long>(by) * gw + bx) * 64] = static_cast<int16_t>(v);
    }
    if (tid == 0) {
        // a fault the parse met at an interval's end, after that interval's blocks
        const int deferred = m[M_DEFERRED], nint = m[M_INTERVALS], nb = m[M_NB];
        unsigned long long f = sc.fault[n];
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
        sx[0] = sc.passes[2 * n] + sc.passes[2 * n + 1];
        sx[1] = sc.counts[2 * n + 1];
        sx[2] = sc.counts[2 * n];
    }
}

}  // namespace

int nntc_jpeg_huffman_ctas_per_sm() {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, jpeg_huffman_decode_kernel, kThreads, 0) != cudaSuccess)
        return -1;
    return n;
}

cudaError_t nntc_jpeg_huffman_decode(const uint8_t* scan, const int32_t* intervals, const int32_t* tables,
                                     const int32_t* meta, int16_t* slots, uint8_t* lens, int32_t* status,
                                     int32_t* stats, long long* scratch, int N, int num_tables, int sequence_bits,
                                     int subsequence_bits, long bits_total, long subs, long intervals_total,
                                     cudaStream_t stream) {
    if (N <= 0) return cudaSuccess;
    if (subsequence_bits < 0 || subsequence_bits % 32 || sequence_bits < 1 || reinterpret_cast<uintptr_t>(scan) % 4 ||
        num_tables < 1)
        return cudaErrorInvalidValue;
    const long G = (subs + 31) / 32 + N;  // the sequences at most
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long grid = std::min(G, static_cast<long>(sms) * std::max(1, nntc_jpeg_huffman_ctas_per_sm()));
    err = cudaMemsetAsync(scratch, 0, 2 * sizeof(long long), stream);  // the ticket and the images laid out
    if (err != cudaSuccess) return err;
    jpeg_huffman_prep<<<N + 2 * num_tables, kPrepThreads, 0, stream>>>(intervals, tables, meta, scratch, N,
                                                                      num_tables, sequence_bits, subsequence_bits,
                                                                      bits_total, G, intervals_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    jpeg_huffman_decode_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(scan), intervals, tables, meta, slots, lens, scratch, N, num_tables, G,
        intervals_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    jpeg_huffman_finish<<<N, kPrepThreads, 0, stream>>>(meta, slots, status, stats, scratch, N, num_tables, G,
                                                        intervals_total);
    return cudaGetLastError();
}
