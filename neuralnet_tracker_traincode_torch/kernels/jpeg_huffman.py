"""K5: the Huffman (entropy) decode of a batch of baseline JPEG scans on the
card (counterpart of the JAX package's `data/native_loader.py`, where
libjpeg decodes on the host; no Pallas kernel).

The host only parses: `data/csrc/jpeg_entropy.cpp:nntc_jpeg_scan_batch`
unstuffs the scan that holds Y, cuts it at its restart markers and builds
the decode tables (`data/native_loader.py:JpegScans`). K5 turns the scans
into each kept Y block's quantized coefficients, as the host entropy
decoder (`nntc_jpeg_entropy_batch`) does, exactly:

(a) Synchronization. Every restart interval is cut into subsequences of S
    bits; the first starts at the interval's first bit in a known state.
    A state is (bit offset, block index within the MCU, zigzag index k): in
    an interleaved scan the MCU's blocks take other tables, so landing on a
    codeword boundary is not enough. An image's subsequences are grouped
    into sequences (one CTA of the kernel, a thread each); S and the
    sequence's length are the image's own (`image_layout`: those of the
    batch's mean scan for an image near it).
    Each subsequence but an interval's last is first decoded from a guess
    (block 0, k = 0) to the first codeword boundary at or past its end,
    giving its exit state and the blocks begun in it. Then passes within
    each sequence: each subsequence whose entry state (its predecessor's
    exit of the last pass; the sequence's head keeps its guess) differs
    from the one it was decoded from is decoded again; a sequence's passes
    end when one changes none of its exits. Then the chain across an
    image's sequences: a sequence re-decodes its head subsequences from its
    predecessor's tentative exit (that sequence's last exit after its
    passes) until an exit equals the one it holds, and again from the
    predecessor's final exit where that differs from the tentative one; its
    own final exit is then exact. The result is the sequential decode's,
    whatever the data; only the work depends on it (a Huffman code
    re-synchronizes after a few codewords where EOBs reset the zigzag
    index; blocks dense to their 63rd coefficient take tens of thousands of
    bits).
(b) Counting. An exclusive scan of the blocks begun in each subsequence of
    an interval gives each subsequence its first block (on the card: within
    the sequence, plus the count its predecessor publishes with its exit).
(c) Decoding. Each subsequence is decoded again from its exact entry: the
    tail of a block begun before it is skipped, then every block begun in it
    is decoded to its end (an interval's last subsequence: up to the
    interval's blocks). A kept Y block's AC coefficients go to its slot of
    64 int16 in zigzag order up to its last nonzero one, with the zeros
    between, and the prefix's length (at least 1) to a u8; the entries past
    it are not written. Chroma blocks and Y blocks outside the grid (a
    4:2:0 MCU row's padding) are decoded and dropped. Each Y block's DC
    difference goes to a scratch array in scan order.
(d) DC. An inclusive scan of the differences along the Y blocks of each
    restart interval (reset at each restart) gives the DC values; their low
    16 bits go to slot entry 0 (the host adds through unsigned ints: the scan
    is exact modulo 2^32).

What the host decoder raises on, K5 reports in a status word per image
(the first fault in scan order): no Huffman code matches, a DC category
above 15, an AC or zero run past the 64th coefficient, a block that reads
past its interval's data (the bits there read as zeros, as the host's
reader feeds them), and a block index that disagrees with the state's
(`ERR_BLOCK_COUNT`). `raise_for_status` turns it into the host decoder's
ValueError, naming the image. Nothing is filled with zeros silently.

`huffman_decode` launches the kernel (`kernels/csrc/jpeg_huffman.cu`) on a
CUDA tensor and raises on anything else but a CPU tensor, for which it runs
`huffman_decode_plain`: the same algorithm in lockstep PyTorch ops, one row
per subsequence, one codeword a step, the same sequences, passes, head
re-decodes and counts. Both report per image the passes (the most of any
of its sequences, plus the head subsequences its sequences re-decoded), the
subsequences and the codewords decoded in (c).

The payload's arrays (`JpegScans`): `scan` uint8, the unstuffed scans
(their bits MSB first; each interval's bits are [start, end) of
`intervals`); `intervals` (NI, 4) int32: start bit, end bit, the marker
that ends the interval's data, image; `tables` (T, TABLE_WORDS) int32, the
batch's distinct decode tables; `meta` (N, META_COLS) int32 (M_* below).
"""

import math
from typing import Optional, Sequence, Tuple

import torch

from neuralnet_tracker_traincode_torch.kernels import ext

# meta's columns
M_H, M_W, M_GW, M_FIRST_BLOCK, M_GH, M_MCUS_X, M_MCUS_Y, M_RST = 0, 1, 2, 3, 4, 5, 6, 7
M_NB, M_YH, M_YV, M_FIRST_INTERVAL, M_INTERVALS, M_DC_BASE, M_BITS, M_DEFERRED = 8, 9, 10, 11, 12, 13, 14, 15
M_DC_TABLES, M_AC_TABLES, M_BLOCKS, META_COLS = 16, 20, 24, 34  # tables by id 0-3; an MCU's blocks
MAX_MCU_BLOCKS = 10
# a decode table: 512 lookahead entries by the next 9 bits ((length << 8) | symbol, 0: longer), maxcode and
# valoffset by code length 0-17, the 256 symbols
TABLE_LOOK, TABLE_MAXCODE, TABLE_VALOFFSET, TABLE_VALS, TABLE_WORDS = 0, 512, 530, 548, 804
LOOK_BITS = 9
SEQUENCES_PER_IMAGE = 8  # the batch's layout: sequences of about an eighth of the mean image's scan
ERR_NO_CODE, ERR_DC_CATEGORY, ERR_AC_RUN, ERR_ZERO_RUN, ERR_OVERRUN, ERR_BLOCK_COUNT = 1, 2, 3, 4, 5, 6
# faults the parse meets at an interval's end (meta's M_DEFERRED: code | marker << 8 | the RSTn due << 16),
# the decode's if that interval decodes; END_OF_FILE stands for the marker where the file ends
ERR_MARKER_NOT_RST, ERR_FILE_ENDS_BEFORE_RST, ERR_FILE_ENDS_AFTER_SCAN, END_OF_FILE = 7, 8, 9, 0xFF
# the host decoder's messages (data/csrc/jpeg_entropy.cpp)
MESSAGES = {
    ERR_NO_CODE: "corrupt scan data: no Huffman code matches",
    ERR_DC_CATEGORY: "corrupt scan data: DC magnitude category {aux}",
    ERR_AC_RUN: "corrupt scan data: an AC run past the 64th coefficient",
    ERR_ZERO_RUN: "corrupt scan data: a zero run past the 64th coefficient",
    ERR_OVERRUN: "truncated or corrupt scan data: it runs into marker 0x{aux:02X}",
    ERR_BLOCK_COUNT: "corrupt scan data: its blocks do not add up to its MCUs",
    ERR_MARKER_NOT_RST: "corrupt scan data: marker 0x{aux:02X} where RST{rst} was due",
    ERR_FILE_ENDS_BEFORE_RST: "truncated scan data: the file ends before restart marker RST{rst}",
    ERR_FILE_ENDS_AFTER_SCAN: "the file ends after a scan without an EOI marker",
}
ERR_STATE = -1  # an exit state at a fault
STATS = 3  # the stats an image: passes, subsequences, codewords decoded
FAST_BITS = 10  # the kernel's code entries by the next 10 bits, built once a batch for each table


def raise_for_status(status, names: Optional[Sequence[str]] = None):
    """Raise the host decoder's ValueError for the first image whose status
    (an (N, 4) int32 array on the host: code, aux, block, the RSTn due) is
    not 0."""
    st = torch.as_tensor(status).cpu()
    bad = torch.nonzero(st[:, 0]).flatten()
    if bad.numel():
        i = int(bad[0])
        code, aux, rst = int(st[i, 0]), int(st[i, 1]), int(st[i, 3])
        name = names[i] if names is not None else f"image {i} of {st.shape[0]}"
        if code == ERR_OVERRUN and aux == END_OF_FILE:
            msg = "truncated scan data: the file ends inside a scan"
        else:
            msg = MESSAGES.get(code, f"status {code}").format(aux=aux, rst=rst)
        raise ValueError(f"JPEG decode: {name}: {msg}")


def sequence_bits(bits_total: int, images: int) -> int:
    """The batch's sequence, in bits: about an eighth of the mean image's
    scan, a power of two in 2,048-2^20."""
    per = bits_total / max(1, images) / SEQUENCES_PER_IMAGE
    return int(min(1 << 20, max(2048, 2 ** round(math.log2(max(per, 1.0))))))


def threads_for(seq_bits):
    """The subsequences of a sequence of `seq_bits` bits (the kernel runs a
    sequence a CTA, a thread each): 128 where that leaves subsequences of 256
    bits or more, else 32 (works on ints and tensors)."""
    if isinstance(seq_bits, torch.Tensor):
        return torch.where(seq_bits >= 128 * 256, 128, 32)
    return 128 if seq_bits >= 128 * 256 else 32


def sequence_threads(bits_total: int, images: int) -> int:
    """The subsequences of a sequence for an image of the batch's mean scan
    (flat frames, ~5 KB a scan: 32)."""
    return threads_for(sequence_bits(bits_total, images))


def auto_subsequence_bits(bits_total: int, images: int) -> int:
    """S for an image of the batch's mean scan: its sequence
    (`sequence_threads` subsequences) of about an eighth of the scan, S in
    64-8,192 bits (flat frames at 448^2, ~5 KB a scan: 128 bits; colour
    4:2:0 q95, ~64 KB: 512; noise, ~200 KB: 2,048). A guessed decode takes
    up to a few thousand bits to fall into step on photos and flat frames,
    tens of thousands on dense noise: the passes within a sequence and the
    head re-decodes that chain the sequences cost about that many bits of
    serial decode each, so the sequences are long and the subsequences as
    short as the CTA's threads allow."""
    return int(min(8192, max(64, sequence_bits(bits_total, images) // sequence_threads(bits_total, images))))


RATIO_STEPS = 8  # an image's sequence is the batch's times 2^e, |e| <= RATIO_STEPS


def image_layout(meta: torch.Tensor, bits_total: Optional[int] = None, subsequence_bits: Optional[int] = None):
    """Each image's S and sequence length T (int64 tensors on `meta`'s
    device), as the kernel's first launch computes them: its sequence is the
    batch's (`sequence_bits`) times 2^e, e the largest in +-RATIO_STEPS with
    2^(e+1) * bits_total <= 3 * bits * N (e = 0 from 2/3 to 4/3 of the mean
    scan: a batch of like images takes one layout), within 2^11-2^20; T
    `threads_for` it; S the sequence / T within 64-8,192, or
    `subsequence_bits` for every image. An image far larger than the rest
    (a dense frame among flat ones) so takes sequences longer than its
    synchronization distance rather than the batch's."""
    m = meta.to(torch.int64)
    N, bits = m.shape[0], m[:, M_BITS]
    if bits_total is None:
        bits_total = int(bits.sum())
    seq_b = sequence_bits(bits_total, N)
    num = 3 * bits * N
    e = torch.full_like(bits, -RATIO_STEPS)
    for k in range(-RATIO_STEPS + 1, RATIO_STEPS + 1):
        ok = (bits_total << (k + 1)) <= num if k >= -1 else bits_total <= (num << -(k + 1))
        e = torch.where(ok, k, e)
    base = torch.full_like(e, seq_b)
    seq = torch.where(e >= 0, base << e.clamp(min=0), base >> (-e).clamp(min=0)).clamp(2048, 1 << 20)
    T = threads_for(seq)
    S = (seq // T).clamp(64, 8192) if subsequence_bits is None else torch.full_like(seq, int(subsequence_bits))
    return S, T


def subsequences_bound(meta_rows: int, intervals_total: int, bits_total: int,
                       subsequence_bits: Optional[int] = None) -> int:
    """The subsequences of a batch at most (image n's at most bits_n // S_n
    + intervals_n + 1, S_n 64 at least or `subsequence_bits`)."""
    return bits_total // (subsequence_bits or 64) + intervals_total + meta_rows


def sequences_bound(meta_rows: int, subs: int) -> int:
    """The sequences of a batch at most (an image's subsequences, `subs` at
    most in all, in runs of 32 or more)."""
    return (subs + 31) // 32 + meta_rows


def scratch_words(meta_rows: int, num_tables: int, intervals_total: int, num_y: int, subs: int) -> int:
    """The kernel's int64 scratch (`csrc/jpeg_huffman.cu`: Scratch): the
    ticket and counters (2 words), a chain record a sequence (3: the
    tentative and the final exit state; the flag and the block count), 5
    words an image (the first fault; passes and head re-decodes; codewords
    and subsequences; S, T, its first interval instance and first sequence),
    the code entries of each table (its DC and AC forms, 2 x 2^FAST_BITS
    uint32), each image's DC entries (4 tables x 2^FAST_BITS uint32), each
    interval instance's first subsequence (int32, an image's count after
    its last) and each Y block's DC difference (uint32)."""
    return (2 + 3 * sequences_bound(meta_rows, subs) + 5 * meta_rows + num_tables * (1 << FAST_BITS)
            + meta_rows * 2 * (1 << FAST_BITS) + (intervals_total + meta_rows + 1) // 2 + (num_y + 1) // 2)


# the most bits one block can take: a DC code and magnitude (16 + 15), 63 AC codes and magnitudes
BLOCK_BITS_MAX = 31 + 63 * 31


class _Lockstep:
    """Plain K5's decoder: one codeword a step for a set of rows. It reads a
    copy of the scans in which each restart interval is followed by zero
    bytes (the bits the host's reader feeds past the data), through a 40-bit
    window at each byte, and decodes by 16-bit lookup tables built from the
    payload's decode tables (the same function as their 9-bit lookahead and
    maxcode)."""

    def __init__(self, scan, intervals, tables, meta, inst_iv):
        dev = scan.device
        iv = intervals.to(torch.int64)
        a, e = iv[:, 0] // 8, iv[:, 1] // 8
        gap = BLOCK_BITS_MAX // 8 + 8
        size = e - a + gap
        self.base = torch.cumsum(size, 0) - size  # each interval's first byte in the copy
        src = torch.cat([torch.arange(int(x), int(y), device=dev) for x, y in zip(a.tolist(), e.tolist())]
                        or [torch.zeros(0, device=dev)])
        dst = torch.cat([torch.arange(int(x), int(x) + int(y - z), device=dev) for x, y, z in
                         zip(self.base.tolist(), e.tolist(), a.tolist())] or [torch.zeros(0, device=dev)])
        stream = torch.zeros(int(size.sum()) + 8, dtype=torch.int64, device=dev)
        stream[dst.to(torch.int64)] = scan.to(torch.int64)[src.to(torch.int64)]
        n = stream.numel() - 4
        self.w40 = ((stream[:n] << 32) | (stream[1:n + 1] << 24) | (stream[2:n + 2] << 16)
                    | (stream[3:n + 3] << 8) | stream[4:n + 4])
        self.inst_a = self.base[inst_iv] * 8  # an instance's first and end bit in the copy
        self.inst_e = (self.base + e - a)[inst_iv] * 8
        # 16-bit lookup: (length << 8) | symbol, 0 where no code matches
        t = tables.to(torch.int64)
        T = t.shape[0]
        peek = torch.arange(65536, dtype=torch.int64, device=dev)
        look = t[:, TABLE_LOOK:TABLE_LOOK + 512][:, peek >> 7]
        lut = look.clone()
        for length in range(16, 9, -1):  # the shortest matching length wins
            code = peek >> (16 - length)
            ok = (look == 0) & (code <= t[:, TABLE_MAXCODE + length, None])
            sym = t.gather(1, (TABLE_VALS + (code + t[:, TABLE_VALOFFSET + length, None]).clamp(0, 255)))
            lut = torch.where(ok, (length << 8) | sym, lut)
        self.lut = lut.reshape(-1) if T else torch.zeros(0, dtype=torch.int64, device=dev)
        # by symbol, DC (0-255) then AC (256-511): magnitude bits, k's advance (EOB: 64), the fault's code
        sym = torch.arange(256, device=dev)
        r, s4 = sym >> 4, sym & 15
        self.mag = torch.cat([torch.where(sym <= 15, sym, 0), s4])
        ac_adv = torch.where(s4 > 0, r + 1, torch.where(r == 15, 16, 64))
        self.adv = torch.cat([torch.ones(256, dtype=torch.int64, device=dev), ac_adv])
        self.errc = torch.cat([torch.where(sym > 15, ERR_DC_CATEGORY, 0),
                               torch.where(s4 > 0, ERR_AC_RUN, torch.where(r == 15, ERR_ZERO_RUN, 0))])
        self.half = (1 << torch.arange(32, device=dev)) >> 1
        self.full = (1 << torch.arange(32, device=dev)) - 1
        m = meta.to(torch.int64)
        blocks = m[:, M_BLOCKS:M_BLOCKS + MAX_MCU_BLOCKS]
        dc = m[:, M_DC_TABLES:M_DC_TABLES + 4].gather(1, blocks & 15)
        ac = m[:, M_AC_TABLES:M_AC_TABLES + 4].gather(1, (blocks >> 4) & 15)
        self.tid = torch.stack([dc, ac], 2).reshape(-1).clamp(min=0) * 65536  # by (image, block, AC)
        self.yq = (blocks >> 8) - 1
        # run_to's lookup by (table, DC or AC form, the next 16 bits): the bits of a codeword and its magnitude
        # (0-5), k's advance (6-12), and from bit 16 the largest k after it that is no fault, + 1,024 (-1: no
        # code matches, a DC category above 15; 64: an AC or zero run; none for an EOB)
        ln, sy = lut >> 8, lut & 255
        r, s4 = sy >> 4, sy & 15
        dc_lim = torch.where((lut == 0) | (sy > 15), -1, 1000)
        ac_lim = torch.where(lut == 0, -1, torch.where((s4 > 0) | (r == 15), 64, 1000))
        dc = (ln + torch.where(sy <= 15, sy, 0)) | (1 << 6) | ((dc_lim + 1024) << 16)
        ac = (ln + s4) | (torch.where(s4 > 0, r + 1, torch.where(r == 15, 16, 64)) << 6) | ((ac_lim + 1024) << 16)
        self.walk_lut = torch.stack([dc, ac], 1).reshape(-1)
        self.walk_tid = self.tid // 65536 * 2 * 65536 + torch.arange(self.tid.numel(), device=dev) % 2 * 65536

    def step(self, p, j, k, img_blocks, nb):
        """Decode one codeword (and its magnitude) at bit p in state (j, k) of
        each row (`img_blocks`: image * MAX_MCU_BLOCKS; `nb`: blocks an MCU).
        Returns (p, j, k) after it, the fault code (0: none), the symbol, the
        value (DC difference or AC coefficient), the zigzag position of a
        nonzero AC coefficient (64: none) and whether a block ended."""
        peek = (self.w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
        ac = (k > 0).to(torch.int64)
        e16 = self.lut[self.tid[(img_blocks + j) * 2 + ac] + (peek >> 16)]
        ln, sym = e16 >> 8, e16 & 255
        ci = sym + (ac << 8)
        s = self.mag[ci]
        nk = k + self.adv[ci]
        err = torch.where(e16 == 0, ERR_NO_CODE, torch.where((nk > 64) | (ac == 0), self.errc[ci], 0))
        end = nk >= 64
        v = ((peek << ln) & 0xFFFFFFFF) >> (32 - s)
        val = torch.where(v < self.half[s], v - self.full[s], v)
        pos = torch.where(s > 0, nk - 1, 64)
        return p + ln + s, (j + end) % nb, torch.where(end, 0, nk), err, sym, val, pos, end

    def advance(self, p, j, k, img_blocks, nb):
        """`step` for `run_to`, by one lookup a codeword: (p, j, k) after one
        codeword of each row, and whether it faults."""
        e = self.walk_lut[self.walk_tid[(img_blocks + j) * 2 + (k > 0)] + ((self.w40[p >> 3] >> (24 - (p & 7))) & 0xFFFF)]
        nk = k + ((e >> 6) & 127)
        bad = nk > (e >> 16) - 1024
        end = nk >= 64
        return p + (e & 63), (j + end) % nb, torch.where(end, 0, nk), bad

    def _steps(self, p, j, k, ib, nb, st, c, bad, n):
        """`n` lockstep steps of the rows, in place: a row that has reached
        its exit or a fault stands still."""
        for _ in range(n):
            live = (p < st) & ~bad
            c += (k == 0) & live
            np_, nj, nk, b = self.advance(p, j, k, ib, nb)
            b &= live
            ok = live & ~b
            p.copy_(torch.where(ok, np_, p))
            j.copy_(torch.where(ok, nj, j))
            k.copy_(torch.where(ok, nk, k))
            bad |= b

    def run_to(self, p, j, k, img_blocks, nb, stop):
        """Decode each row from (p, j, k) to its first codeword boundary at or
        past `stop`: its exit state (ERR_STATE at a fault) and the blocks
        begun before `stop`. Steps go 8 at a time with no read-back between:
        on a card as one CUDA graph of them, replayed (a step is ~30 small
        ops, whose launches would set its time), elsewhere with the rows
        that reached their exits compacted away."""
        state = (p << 16) | (j << 8) | k
        count = torch.zeros_like(p)
        rows = torch.nonzero(p < stop).flatten()
        p, j, k, ib, nb, st = (x[rows] for x in (p, j, k, img_blocks, nb, stop))
        c, bad = torch.zeros_like(p), torch.zeros_like(p, dtype=torch.bool)
        if p.is_cuda and rows.numel():
            self._steps(p, j, k, ib, nb, st, c, bad, 8)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._steps(p, j, k, ib, nb, st, c, bad, 8)
            while bool(((p < st) & ~bad).any()):
                graph.replay()
            state[rows] = torch.where(bad, ERR_STATE, (p << 16) | (j << 8) | k)
            count[rows] = c
            return state, count
        while rows.numel():
            self._steps(p, j, k, ib, nb, st, c, bad, 8)
            keep = (p < st) & ~bad
            if not bool(keep.all()):
                done = ~keep
                state[rows[done]] = torch.where(bad[done], ERR_STATE, (p[done] << 16) | (j[done] << 8) | k[done])
                count[rows[done]] = c[done]
                keep = torch.nonzero(keep).flatten()  # one sync, not one a tensor
                rows, p, j, k, ib, nb, st, c, bad = (x[keep] for x in (rows, p, j, k, ib, nb, st, c, bad))
        return state, count


def huffman_decode_plain(scan: torch.Tensor, intervals: torch.Tensor, tables: torch.Tensor, meta: torch.Tensor,
                         num_blocks: int, num_y: int, subsequence_bits: Optional[int] = None):
    """K5 in plain PyTorch ops, on the arrays' device (the CPU, or the card to
    hold the kernel to it). Returns (slots (num_blocks, 64) int16, lens
    (num_blocks,) uint8, status (N, 4) int32, stats (N, 3) int32: the
    passes (the most of any of the image's sequences, plus the head
    subsequences its sequences re-decoded), the subsequences and the
    codewords decoded in (c), its blocks to their ends, as the kernel
    reports them)."""
    if subsequence_bits is not None and int(subsequence_bits) < 32:
        raise ValueError(f"subsequences of {int(subsequence_bits)} bits: 32 at least")
    S_n, T_n = image_layout(meta, None, subsequence_bits)
    dev = scan.device
    m = meta.to(torch.int64)
    N = m.shape[0]
    iv = intervals.to(torch.int64)
    # the interval instances, image by image (a selection may repeat an image)
    n_int = m[:, M_INTERVALS]
    inst_img = torch.repeat_interleave(torch.arange(N, device=dev), n_int)
    inst_local = (torch.arange(inst_img.numel(), device=dev)
                  - torch.repeat_interleave(torch.cumsum(n_int, 0) - n_int, n_int))
    inst_iv = m[inst_img, M_FIRST_INTERVAL] + inst_local
    ls = _Lockstep(scan, intervals, tables, meta, inst_iv)
    a, e, marker = ls.inst_a, ls.inst_e, iv[inst_iv, 2]
    rst, nb = m[inst_img, M_RST], m[inst_img, M_NB]
    mcus = m[inst_img, M_MCUS_X] * m[inst_img, M_MCUS_Y]
    first_mcu = inst_local * rst
    total = torch.where(rst > 0, torch.minimum(rst, mcus - first_mcu), mcus) * nb
    S = S_n[inst_img]
    nsub = torch.clamp((e - a + S - 1) // S, min=1)
    # the subsequences
    row_inst = torch.repeat_interleave(torch.arange(nsub.numel(), device=dev), nsub)
    t = torch.arange(row_inst.numel(), device=dev) - torch.repeat_interleave(torch.cumsum(nsub, 0) - nsub, nsub)
    img, re = inst_img[row_inst], e[row_inst]
    ib, rnb = img * MAX_MCU_BLOCKS, nb[row_inst]
    start = a[row_inst] + t * S[row_inst]
    last = t == nsub[row_inst] - 1
    first = t == 0
    stop = torch.where(last, re, start + S[row_inst])
    guess = start << 16
    R = row_inst.numel()
    # the sequences: each image's subsequences cut into runs of its T, one CTA of the kernel each
    rows_n = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(0, img, torch.ones_like(img))
    row0_n = torch.cumsum(rows_n, 0) - rows_n
    local = torch.arange(R, device=dev) - row0_n[img]
    nseq_n = (rows_n + T_n - 1) // T_n
    seq0_n = torch.cumsum(nseq_n, 0) - nseq_n
    seq = seq0_n[img] + local // T_n[img]
    Q = int(nseq_n.sum())
    seq_img = torch.repeat_interleave(torch.arange(N, device=dev), nseq_n)
    seq_q = torch.arange(Q, device=dev) - seq0_n[seq_img]
    seq_head = row0_n[seq_img] + seq_q * T_n[seq_img]  # each sequence's first and last row
    seq_end = torch.minimum(seq_head + T_n[seq_img], row0_n[seq_img] + rows_n[seq_img]) - 1
    head = local % T_n[img] == 0

    def decode_rows(sel, entry):
        en = entry[sel]
        return ls.run_to(en >> 16, (en >> 8) & 255, en & 255, ib[sel], rnb[sel], stop[sel])

    # (a) within each sequence: the guess, then passes until none changes an exit; a row's entry is its
    # predecessor's exit of the last pass, the sequence's head row its guess (an interval's first row: its state)
    ex = torch.full((R,), ERR_STATE, dtype=torch.int64, device=dev)
    count = torch.zeros(R, dtype=torch.int64, device=dev)
    nonlast = torch.nonzero(~last).flatten()
    ex[nonlast], count[nonlast] = decode_rows(nonlast, guess)
    ent = guess.clone()
    last_changed = torch.ones(Q, dtype=torch.int64, device=dev)
    passes = 1
    while True:
        passes += 1
        prev = torch.cat([ex.new_full((1,), ERR_STATE), ex[:-1]])
        entry = torch.where(first | head | (prev == ERR_STATE), guess, prev)
        redo = torch.nonzero(~last & (entry != ent)).flatten()
        changed = torch.zeros(R, dtype=torch.bool, device=dev)
        if redo.numel():
            st, cnt = decode_rows(redo, entry)
            changed[redo] = st != ex[redo]
            ex[redo], count[redo], ent[redo] = st, cnt, entry[redo]
        hit = torch.zeros(Q, dtype=torch.bool, device=dev)
        hit[seq[changed]] = True
        last_changed = torch.where(hit, passes, last_changed)
        if not bool(changed.any()):
            break
    seq_passes = last_changed + 1

    # across sequences, the chain: each sequence re-decodes its head rows from its predecessor's tentative exit
    # (its last row's exit after the passes) until an exit equals the one it holds, then again from the
    # predecessor's final exit where that differs from the tentative one; an image's first sequence, and one
    # whose head row starts an interval, start in a known state
    heads = torch.zeros(Q, dtype=torch.int64, device=dev)

    def walk(sel, pred_exit):
        r, en = seq_head[sel], pred_exit
        en = torch.where(en == ERR_STATE, guess[r], en)
        while sel.numel():
            go = ~last[r] & (en != ent[r])
            go = torch.nonzero(go).flatten()
            sel, r, en = sel[go], r[go], en[go]
            if not sel.numel():
                break
            ent[r] = en
            x, c = decode_rows(r, ent)
            heads.index_add_(0, sel, torch.ones_like(sel))
            count[r] = c
            go = x != ex[r]
            ex[r] = x
            go = torch.nonzero(go & (r < seq_end[sel])).flatten()
            sel, r, x = sel[go], r[go] + 1, x[go]
            en = torch.where(x == ERR_STATE, guess[r], x)

    chained = torch.nonzero((seq_q > 0) & ~first[seq_head]).flatten()
    tentative = ex[seq_end]
    walk(chained, tentative[chained - 1])
    final = ex[seq_end]
    for q in range(1, int(nseq_n.max()) if N else 0):
        sel = chained[seq_q[chained] == q]
        sel = sel[final[sel - 1] != tentative[sel - 1]]
        if sel.numel():
            walk(sel, final[sel - 1])
            final[sel] = ex[seq_end[sel]]
    stats = torch.zeros((N, STATS), dtype=torch.int64, device=dev)
    stats[:, 0].scatter_reduce_(0, seq_img, seq_passes, "amax")
    stats[:, 0].index_add_(0, seq_img, heads)
    stats[:, 1] = rows_n

    # (b) each subsequence's first block: the blocks begun before it in its interval
    cnt = torch.where(last, 0, count)
    incl = torch.cumsum(cnt, 0)
    inst_base = (incl - cnt)[torch.cumsum(nsub, 0) - nsub]
    fblock = incl - cnt - inst_base[row_inst]

    # (c) each subsequence from its exact entry, its blocks to their ends; each step's events are recorded and
    # written after the loop
    prev = torch.cat([ex.new_full((1,), ERR_STATE), ex[:-1]])
    entry = torch.where(first, guess, prev)
    rows = torch.nonzero(entry != ERR_STATE).flatten()
    en = entry[rows]
    p, j, k = en >> 16, (en >> 8) & 255, en & 255
    bk, tail, alive = fblock[rows], k > 0, torch.ones_like(rows, dtype=torch.bool)
    cons = [ib, rnb, re, stop, ~last, total[row_inst]]
    ibl, nbr, er, sp, nlst, tot = (c[rows] for c in cons)
    records = []
    steps = 0
    while True:
        begin = (k == 0) & ~tail
        alive = alive & ~(begin & ((bk >= tot) | (nlst & (p >= sp))))
        wrong = begin & alive & (j != bk % nbr)
        np_, nj, nk, err, sym, val, pos, end = ls.step(p, j, k, ibl, nbr)
        live = alive & ~tail
        err = torch.where(wrong, ERR_BLOCK_COUNT, err)
        overrun = end & (np_ > er)
        records.append(torch.stack([rows, bk, j, k, val, pos, err, sym, live.to(torch.int64),
                                    (end & ~overrun).to(torch.int64), overrun.to(torch.int64)], 1))
        alive = alive & (err == 0) & ~(live & overrun)
        p, j, k = torch.where(alive, np_, p), torch.where(alive, nj, j), torch.where(alive, nk, k)
        bk = bk + (live & end).to(torch.int64)
        tail = tail & ~end
        steps += 1
        if steps % 16 == 0:
            n_alive = int(alive.sum())
            if not n_alive:
                break
            if n_alive * 2 < alive.numel():
                idx = torch.nonzero(alive).flatten()
                p, j, k, bk, tail, alive, rows, ibl, nbr, er, sp, nlst, tot = (
                    x[idx] for x in (p, j, k, bk, tail, alive, rows, ibl, nbr, er, sp, nlst, tot))
    rec = torch.cat(records)
    rec = rec[rec[:, 8] == 1]  # steps of live rows
    r_row, r_b, r_j, r_k, r_val, r_pos, r_err, r_sym, _, r_end, r_over = rec.unbind(1)
    im = img[r_row]
    stats[:, 2].index_add_(0, im[r_err == 0], torch.ones_like(im[r_err == 0]))  # the codewords decoded
    inst = row_inst[r_row]
    seq = first_mcu[inst] * nb[inst] + r_b
    err_key = torch.full((N,), 2**62, dtype=torch.int64, device=dev)
    fault = r_err > 0
    aux = torch.where(r_err == ERR_BLOCK_COUNT, 0, r_sym)
    err_key.scatter_reduce_(0, im[fault], seq[fault] * 65536 + r_err[fault] * 256 + aux[fault], "amin")
    err_key.scatter_reduce_(0, im[r_over == 1], seq[r_over == 1] * 65536 + ERR_OVERRUN * 256
                            + marker[inst[r_over == 1]], "amin")
    ok = ~fault & (r_over == 0)
    # where each block lies: its MCU, its place among Y's blocks, its slot
    mcu = seq // nb[inst]
    yq = ls.yq[im, r_j]
    yh, yv = m[im, M_YH], m[im, M_YV]
    bx = (mcu % m[im, M_MCUS_X]) * yh + yq % yh
    by = (mcu // m[im, M_MCUS_X]) * yv + yq // yh
    kept = (yq >= 0) & (bx < m[im, M_GW]) & (by < m[im, M_GH])
    sb = m[im, M_FIRST_BLOCK] + by * m[im, M_GW] + bx
    dcs = torch.zeros(num_y, dtype=torch.int64, device=dev)
    dcw = ok & (r_k == 0) & (yq >= 0)
    dcs[(m[im, M_DC_BASE] + mcu * yh * yv + yq)[dcw]] = r_val[dcw]
    slots = torch.zeros((num_blocks, 64), dtype=torch.int16, device=dev)
    acw = ok & kept & (r_k > 0) & (r_pos < 64)
    slots.view(-1)[(sb * 64 + r_pos)[acw]] = r_val[acw].to(torch.int16)
    last_nz = torch.zeros(num_blocks, dtype=torch.int64, device=dev)
    last_nz.scatter_reduce_(0, sb[acw], r_pos[acw], "amax")
    lens = torch.zeros(num_blocks, dtype=torch.uint8, device=dev)
    fin = (r_end == 1) & kept
    lens[sb[fin]] = (last_nz[sb[fin]] + 1).to(torch.uint8)

    # (d) the DC values: a scan of the differences along each restart interval's Y blocks
    ny = m[:, M_MCUS_X] * m[:, M_MCUS_Y] * m[:, M_YH] * m[:, M_YV]
    oimg = torch.repeat_interleave(torch.arange(N, device=dev), ny)
    o = torch.arange(oimg.numel(), device=dev) - torch.repeat_interleave(torch.cumsum(ny, 0) - ny, ny)
    nyb = m[oimg, M_YH] * m[oimg, M_YV]
    mcu, q = o // nyb, o % nyb
    orst = m[oimg, M_RST]
    head = (o == 0) | ((orst > 0) & (q == 0) & (mcu % orst.clamp(min=1) == 0))
    d = dcs[m[oimg, M_DC_BASE] + o]
    cs = torch.cumsum(d, 0)
    hs = torch.cummax(torch.where(head, torch.arange(o.numel(), device=dev), 0), 0).values
    value = cs - cs[hs] + d[hs]
    yh = m[oimg, M_YH]
    bx = (mcu % m[oimg, M_MCUS_X]) * yh + q % yh
    by = (mcu // m[oimg, M_MCUS_X]) * m[oimg, M_YV] + q // yh
    kept = (bx < m[oimg, M_GW]) & (by < m[oimg, M_GH])
    sb = m[oimg, M_FIRST_BLOCK] + by * m[oimg, M_GW] + bx
    slots[sb[kept], 0] = (((value[kept] + 32768) & 0xFFFF) - 32768).to(torch.int16)

    # a fault the parse met at an interval's end, after that interval's blocks
    deferred = m[:, M_DEFERRED]
    mcus_n = m[:, M_MCUS_X] * m[:, M_MCUS_Y]
    rst_n = m[:, M_RST]
    after = torch.where(rst_n > 0, torch.minimum(n_int * rst_n, mcus_n), mcus_n) * m[:, M_NB]
    key = after * 65536 + (deferred & 255) * 256 + ((deferred >> 8) & 255)
    err_key = torch.where(deferred != 0, torch.minimum(err_key, key), err_key)
    status = torch.zeros((N, 4), dtype=torch.int64, device=dev)
    bad = err_key < 2**62
    status[bad, 0] = (err_key[bad] >> 8) & 255
    status[bad, 1] = err_key[bad] & 255
    status[bad, 2] = (err_key[bad] >> 16).clamp(max=2**31 - 1)
    status[:, 3] = torch.where(bad & (status[:, 0] == deferred & 255) & (deferred != 0), deferred >> 16, 0)
    return slots, lens, status.to(torch.int32), stats.to(torch.int32)


def _check_shapes(scan, intervals, tables, meta):
    if scan.dim() != 1 or intervals.dim() != 2 or intervals.shape[1] != 4 or tables.dim() != 2 \
            or tables.shape[1] != TABLE_WORDS or meta.dim() != 2 or meta.shape[1] != META_COLS:
        raise ValueError(f"bad scan payload shapes: scan {tuple(scan.shape)}, intervals {tuple(intervals.shape)}, "
                         f"tables {tuple(tables.shape)}, meta {tuple(meta.shape)}")


def huffman_decode(scan: torch.Tensor, intervals: torch.Tensor, tables: torch.Tensor, meta: torch.Tensor,
                   num_blocks: int, num_y: int, intervals_total: int, bits_total: int,
                   subsequence_bits: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """K5 for CUDA tensors, the plain version for CPU tensors: (slots, lens,
    status, stats) as `huffman_decode_plain` gives them (on the card the slot
    entries past each block's length are not written). Each image's layout
    follows its scan (`image_layout`), its subsequences of `subsequence_bits`
    where given. Nothing is read back to the host: the status is raised on
    by `raise_for_status`."""
    _check_shapes(scan, intervals, tables, meta)
    if scan.device.type == "cpu":
        return huffman_decode_plain(scan, intervals, tables, meta, num_blocks, num_y, subsequence_bits)
    ext.require_cuda_tensor(scan, "scan", torch.uint8, 1)
    ext.require_cuda_tensor(intervals, "intervals", torch.int32, 2)
    ext.require_cuda_tensor(tables, "tables", torch.int32, 2)
    ext.require_cuda_tensor(meta, "meta", torch.int32, 2)
    if scan.data_ptr() % 4 or scan.numel() % 4:
        raise ValueError("the scan buffer must be 4-byte aligned and a whole number of 32-bit words")
    S = 0 if subsequence_bits is None else int(subsequence_bits)
    if subsequence_bits is not None and (S < 32 or S % 32):
        raise ValueError(f"subsequences of {S} bits: a multiple of 32")
    N, dev = meta.shape[0], scan.device
    slots = torch.empty((num_blocks, 64), dtype=torch.int16, device=dev)
    lens = torch.empty(num_blocks, dtype=torch.uint8, device=dev)
    status = torch.empty((N, 4), dtype=torch.int32, device=dev)
    stats = torch.empty((N, STATS), dtype=torch.int32, device=dev)
    subs = subsequences_bound(N, intervals_total, bits_total, S or None)
    scratch = torch.empty(scratch_words(N, tables.shape[0], intervals_total, num_y, subs), dtype=torch.int64,
                          device=dev)
    if N:
        ext.extension().jpeg_huffman_decode(scan, intervals, tables, meta, slots, lens, status, stats, scratch,
                                            sequence_bits(bits_total, N), S, int(bits_total), subs,
                                            int(intervals_total))
        ext.LAUNCHES["jpeg_huffman"] += 1
    return slots, lens, status, stats
