// Host half of the port's JPEG decode, the counterpart of the libjpeg decode
// in native/nntc_loader.cpp. Two entry points share one marker parser:
//   - nntc_jpeg_scan_batch (the loader's path): parse the markers, build the
//     Huffman decode tables, and unstuff the scan that holds Y, cut at its
//     restart markers; no bit-level work. The card decodes the scan
//     (kernels/csrc/jpeg_huffman.cu, K5) and runs the IDCT (jpeg_idct.cu, K4).
//   - nntc_jpeg_entropy_batch: the whole baseline Huffman decode on the host
//     into quantized DCT coefficients (K5's oracle in the tests).
//
// Standalone: no libjpeg and no jpeglib.h (the card's machine has neither).
// Built with `g++ -O3 -shared -fPIC` at first use (data/native_loader.py)
// and called through ctypes with a plain C interface.
//
// What it decodes, as libjpeg decodes it to JCS_GRAYSCALE:
//   - SOF0 / SOF1 frames of 8-bit samples with 1 or 3 components, their scans
//     interleaved or not, restart intervals (DRI, RSTn);
//   - only the first component (Y) is kept: with 3 components the chroma data
//     is decoded and dropped, as libjpeg's grayscale output from YCbCr copies
//     the Y plane;
//   - the Y blocks that cover the image, ceil(w/8) x ceil(h/8) in raster
//     order, each as its int16 coefficients in zigzag order up to its last
//     nonzero one (at least the DC), the blocks back to back, with each
//     block's count; and Y's quantization table in natural order as latched
//     at its scan. Most blocks end early (a flat block holds its DC alone),
//     so this is what the host writes, copies and uploads, in place of 64
//     coefficients a block.
// What it refuses (nonzero return, a message naming the marker): progressive,
// lossless, hierarchical and arithmetic-coded frames, other than 8-bit
// samples, 2 or 4 components, a Y component sampled below the frame's largest
// factors (libjpeg would upsample it), a 3-component frame that libjpeg reads
// as RGB (an Adobe APP14 with transform 0 and no JFIF APP0, or component ids
// 'R', 'G', 'B'), and truncated or corrupt entropy-coded data. libjpeg warns
// on the last and fills the rest of the image with zeros instead; here it is
// an error.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;
// nntc_jpeg_scan_batch's per-image columns (kernels/jpeg_huffman.py: META_*)
constexpr int kMetaCols = 34;
// the scan stage's faults deferred to the card's decode (column 15: code | marker << 8 | RST due << 16), and the
// marker code that stands for the file's end (kernels/jpeg_huffman.py: ERR_*, END_OF_FILE)
constexpr int kMarkerNotRst = 7, kFileEndsBeforeRst = 8, kFileEndsAfterScan = 9, kEndOfFile = 0xFF;
constexpr int kMaxMcuBlocks = 10;
constexpr int kFastBits = 10;  // AC codes whose code and magnitude bits fit are decoded in one lookup

struct DecodeError {
    std::string msg;
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
    char buf[256];
    std::snprintf(buf, sizeof(buf), fmt, a, b);
    throw DecodeError{buf};
}

struct HuffTable {
    bool defined = false;
    // canonical decoding: codes of length l are maxcode[l] - count + 1 .. maxcode[l]
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    // lookahead: (length << 8) | symbol for codes of at most kLookBits bits, 0 otherwise
    uint16_t look[1 << kLookBits];
    // AC fast path, by the next kFastBits bits: the code's and the magnitude's bits together (0: none fit),
    // the symbol (run << 4 | size) and the coefficient's value
    uint8_t fast_len[1 << kFastBits];
    uint8_t fast_rs[1 << kFastBits];
    int16_t fast_val[1 << kFastBits];
};

// The s-bit magnitude v as a signed value (JPEG's EXTEND), without a branch: v - 2^s + 1 below 2^(s-1)
inline int extend(int v, int s) { return v + (((v - (1 << (s - 1))) >> 31) & (static_cast<int>(~0u << s) + 1)); }

void build_table(HuffTable& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
    std::memset(t.look, 0, sizeof(t.look));
    std::memcpy(t.vals, vals, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        t.valoffset[l] = k - code;
        const int n = counts[l - 1];
        if (n) {
            for (int i = 0; i < n; ++i, ++k, ++code) {
                if (l <= kLookBits) {
                    const int shift = kLookBits - l;
                    for (int f = 0; f < (1 << shift); ++f) {
                        t.look[(code << shift) | f] = static_cast<uint16_t>((l << 8) | vals[k]);
                    }
                }
            }
            t.maxcode[l] = code - 1;
        } else {
            t.maxcode[l] = -1;
        }
        if (code > (1 << l)) fail("bad Huffman table (DHT): more codes than length %d allows", l);
        code <<= 1;
    }
    t.maxcode[17] = 0x7fffffff;  // sentinel: a code longer than 16 bits is corrupt
    std::memset(t.fast_len, 0, sizeof(t.fast_len));
    for (int peek = 0; peek < (1 << kFastBits); ++peek) {
        const uint16_t e = t.look[peek >> (kFastBits - kLookBits)];
        if (!e) continue;
        const int l = e >> 8, rs = e & 0xFF, size = rs & 15;
        if (l + size > kFastBits) continue;
        t.fast_len[peek] = static_cast<uint8_t>(l + size);
        t.fast_rs[peek] = static_cast<uint8_t>(rs);
        const int bits = (peek >> (kFastBits - l - size)) & ((1 << size) - 1);
        t.fast_val[peek] = static_cast<int16_t>(size ? extend(bits, size) : 0);
    }
    t.defined = true;
}

// Reads the entropy-coded segment MSB first, unstuffing 0xFF00. At a marker
// (or the end of the buffer) it stops and feeds zero bits, counting them: a
// decode that consumes one of them has run past the data, which is an error.
struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t pos;
    uint64_t acc = 0;  // left-aligned: the top `nbits` bits are unread
    int nbits = 0;
    int fake = 0;        // zero bits fed past the data's end, at the bottom of `nbits`
    int marker = -1;     // the marker code that ended the data, or -1 while data lasts
    bool at_end = false;

    // 8 bytes at a time while the next ones hold no 0xFF (no stuffing, no marker)
    void fill() {
        if (marker < 0 && pos + 8 <= len) {
            uint64_t w;
            std::memcpy(&w, data + pos, 8);
            w = __builtin_bswap64(w);
            const int k = (64 - nbits) >> 3;
            const uint64_t top = k >= 8 ? ~0ULL : ~(~0ULL >> (8 * k));
            const uint64_t inv = ~w;  // a 0xFF byte is a zero byte here
            if ((((inv - 0x0101010101010101ULL) & ~inv & 0x8080808080808080ULL) & top) == 0) {
                acc |= (w & top) >> nbits;
                nbits += 8 * k;
                pos += k;
                return;
            }
        }
        fill_bytes();
    }
    void fill_bytes() {
        while (nbits <= 56) {
            uint32_t byte = 0;
            if (marker < 0 && !at_end) {
                if (pos >= len) {
                    at_end = true;
                } else {
                    uint32_t c = data[pos++];
                    if (c == 0xFF) {
                        uint32_t d;
                        do {  // fill bytes before a marker
                            if (pos >= len) {
                                at_end = true;
                                break;
                            }
                            d = data[pos++];
                        } while (d == 0xFF);
                        if (!at_end) {
                            if (d == 0) {
                                byte = 0xFF;
                            } else {
                                marker = static_cast<int>(d);
                            }
                        }
                    } else {
                        byte = c;
                    }
                }
            }
            if (marker >= 0 || at_end) {
                fake += 8;
            }
            acc |= static_cast<uint64_t>(byte) << (56 - nbits);
            nbits += 8;
        }
    }
    void consume(int n) {
        acc <<= n;
        nbits -= n;
    }
    // The zero bits fed past the data must not have been read (checked once a block).
    void check() const {
        if (nbits < fake) {
            if (marker >= 0) fail("truncated or corrupt scan data: it runs into marker 0x%02X", marker);
            fail("truncated scan data: the file ends inside a scan");
        }
    }
    int bits(int n) {  // n in 1..16
        if (nbits < 16) fill();
        const int v = static_cast<int>(acc >> (64 - n));
        consume(n);
        return v;
    }
    int decode(const HuffTable& t) {
        if (nbits < 16) fill();
        return decode_filled(t);
    }
    // decode() with at least 16 bits in `acc`
    int decode_filled(const HuffTable& t) {
        const uint32_t peek = static_cast<uint32_t>(acc >> (64 - kLookBits));
        const uint16_t e = t.look[peek];
        if (e) {
            consume(e >> 8);
            return e & 0xFF;
        }
        int l = kLookBits + 1;
        int32_t code = static_cast<int32_t>(acc >> (64 - l));
        while (code > t.maxcode[l]) {
            ++l;
            if (l > 16) fail("corrupt scan data: no Huffman code matches");
            code = static_cast<int32_t>(acc >> (64 - l));
        }
        consume(l);
        return t.vals[code + t.valoffset[l]];
    }
    // Drop the bits left in the current segment (padding) and return the
    // marker that follows it, skipping stray bytes as libjpeg does.
    int next_marker() {
        acc = 0;
        nbits = 0;
        fake = 0;
        if (marker < 0) {
            while (!at_end) {
                if (pos >= len) {
                    at_end = true;
                    break;
                }
                if (data[pos++] != 0xFF) continue;
                while (pos < len && data[pos] == 0xFF) ++pos;
                if (pos >= len) {
                    at_end = true;
                    break;
                }
                const uint8_t d = data[pos++];
                if (d != 0) {
                    marker = d;
                    break;
                }
            }
        }
        const int m = marker;
        marker = -1;
        return m;
    }
};

struct Component {
    int id, h, v, tq;
    int dc_tbl = 0, ac_tbl = 0;
};

struct Frame {
    bool seen = false;
    int width = 0, height = 0;
    int hmax = 1, vmax = 1;
    std::vector<Component> comps;
};

// What one decode gives for the Y plane: each block's zigzag prefix in a
// 64-entry slot, in raster order (an interleaved scan decodes blocks out of
// raster order), and its length.
struct Output {
    std::vector<int16_t>* slots = nullptr;
    std::vector<uint8_t>* lens = nullptr;
    int32_t* qtable = nullptr;  // 64 entries, natural order
    struct Scan* scan = nullptr;  // the scan stage: unstuff the Y scan instead of decoding it
};

// What the scan stage keeps of one image: the Y scan's unstuffed bytes go to
// `out` (room for the file's length); the rest is for nntc_jpeg_scan_batch.
struct Scan {
    uint8_t* out = nullptr;
    size_t used = 0;
    std::vector<int32_t> intervals;  // (start byte, end byte, the marker that ends the data) per restart interval
    int32_t meta[kMetaCols] = {};    // the columns the host fills (see nntc_jpeg_scan_batch)
    std::string tables[2][4];        // the raw tables the Y scan uses (empty: not used)
};

// Copy the entropy-coded bytes from buf[pos] on into out[n] on, unstuffing
// 0xFF00 and dropping the fill bytes before a marker, up to the next marker;
// returns its code (pos just past it) or -1 where the buffer ends first.
// With out == nullptr the bytes are only skipped.
int unstuff(const uint8_t* buf, size_t len, size_t& pos, uint8_t* out, size_t& n) {
    for (;;) {
        const uint8_t* p = buf + pos;
        const void* ff = std::memchr(p, 0xFF, len - pos);
        const size_t run = ff ? static_cast<size_t>(static_cast<const uint8_t*>(ff) - p) : len - pos;
        if (out != nullptr) std::memcpy(out + n, p, run);
        n += run;
        pos += run;
        if (ff == nullptr) return -1;
        ++pos;
        while (pos < len && buf[pos] == 0xFF) ++pos;
        if (pos >= len) return -1;
        const uint8_t d = buf[pos++];
        if (d != 0) return d;
        if (out != nullptr) out[n] = 0xFF;
        ++n;
    }
}

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

struct Decoder {
    const uint8_t* buf;
    size_t len;
    size_t pos = 0;
    Frame frame;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    // each table as its DHT segment gives it (16 counts, then the symbols), for the scan stage
    std::string raw[2][4];
    int restart_interval = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    bool y_done = false;

    Decoder(const uint8_t* b, size_t l) : buf(b), len(l) {}

    size_t segment(int marker, size_t need) {  // the segment's payload length, checked against the buffer
        if (pos + 2 > len) fail("truncated marker segment 0x%02X", marker);
        const size_t n = be16(buf + pos);
        if (n < 2 || pos + n > len) fail("truncated marker segment 0x%02X", marker);
        if (n - 2 < need) fail("marker segment 0x%02X too short", marker);
        return n - 2;
    }

    int read_marker() {
        if (pos >= len || buf[pos] != 0xFF) {
            // libjpeg skips stray bytes to the next marker with a warning
            while (pos < len && buf[pos] != 0xFF) ++pos;
            if (pos >= len) fail("the file ends before its EOI marker");
        }
        while (pos < len && buf[pos] == 0xFF) ++pos;
        if (pos >= len) fail("the file ends inside a marker");
        return buf[pos++];
    }

    void app(int marker) {
        const size_t n = segment(marker, 0);
        const uint8_t* p = buf + pos + 2;
        if (marker == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
        if (marker == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = p[11];
        }
        pos += n + 2;
    }

    void dqt() {
        size_t n = segment(0xDB, 0);
        const uint8_t* p = buf + pos + 2;
        pos += n + 2;
        while (n > 0) {
            const int pq = p[0] >> 4, tq = p[0] & 15;
            if (tq > 3 || pq > 1) fail("bad DQT: table %d, precision %d", tq, pq);
            const size_t need = 1 + 64 * (pq + 1);
            if (n < need) fail("DQT segment too short");
            for (int k = 0; k < 64; ++k) {
                qt[tq][kZigzag[k]] = pq ? be16(p + 1 + 2 * k) : p[1 + k];
            }
            qt_defined[tq] = true;
            p += need;
            n -= need;
        }
    }

    void dht() {
        size_t n = segment(0xC4, 0);
        const uint8_t* p = buf + pos + 2;
        pos += n + 2;
        while (n > 0) {
            if (n < 17) fail("DHT segment too short");
            const int tc = p[0] >> 4, th = p[0] & 15;
            if (tc > 1 || th > 3) fail("bad DHT: class %d, table %d", tc, th);
            int total = 0;
            for (int i = 0; i < 16; ++i) total += p[1 + i];
            if (total > 256 || n < static_cast<size_t>(17 + total)) fail("bad DHT: %d symbols", total);
            build_table(tc ? ac[th] : dc[th], p + 1, p + 17, total);
            raw[tc][th].assign(reinterpret_cast<const char*>(p + 1), 16 + total);
            p += 17 + total;
            n -= 17 + total;
        }
    }

    void sof(int marker) {
        if (frame.seen) fail("a second SOF marker (0x%02X)", marker);
        const size_t n = segment(marker, 6);
        const uint8_t* p = buf + pos + 2;
        pos += n + 2;
        if (p[0] != 8) fail("SOF%d: %d-bit samples are not supported (8-bit only)", marker - 0xC0, p[0]);
        frame.height = be16(p + 1);
        frame.width = be16(p + 3);
        const int nf = p[5];
        if (frame.height == 0) fail("SOF%d: a height defined by a DNL marker is not supported", marker - 0xC0);
        if (frame.width == 0) fail("SOF%d: zero width", marker - 0xC0);
        if (nf != 1 && nf != 3) fail("SOF%d: %d components (1 or 3 supported)", marker - 0xC0, nf);
        if (n < static_cast<size_t>(6 + 3 * nf)) fail("SOF%d segment too short", marker - 0xC0);
        for (int i = 0; i < nf; ++i) {
            Component c;
            c.id = p[6 + 3 * i];
            c.h = p[7 + 3 * i] >> 4;
            c.v = p[7 + 3 * i] & 15;
            c.tq = p[8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("SOF: bad component %d", i);
            frame.hmax = std::max(frame.hmax, c.h);
            frame.vmax = std::max(frame.vmax, c.v);
            frame.comps.push_back(c);
        }
        if (nf == 3) {
            // libjpeg's default_decompress_parms: JFIF means YCbCr; else Adobe's transform; else the ids
            bool rgb = false;
            if (!jfif && adobe) {
                rgb = adobe_transform == 0;
            } else if (!jfif) {
                rgb = frame.comps[0].id == 'R' && frame.comps[1].id == 'G' && frame.comps[2].id == 'B';
            }
            if (rgb) fail("SOF: a 3-component frame that libjpeg reads as RGB (gray would be computed from RGB)");
        }
        const Component& y = frame.comps[0];
        if (nf > 1 && (y.h != frame.hmax || y.v != frame.vmax)) {
            fail("SOF: the Y component is sampled %dx%d below the frame's largest factors (libjpeg would upsample)",
                 y.h, y.v);
        }
        frame.seen = true;
    }

    int grid_w() const { return (frame.width + 7) / 8; }
    int grid_h() const { return (frame.height + 7) / 8; }

    void scan(Output& out) {
        if (!frame.seen) fail("SOS before SOF");
        size_t n = segment(0xDA, 1);
        const uint8_t* p = buf + pos + 2;
        pos += n + 2;
        const int ns = p[0];
        if (ns < 1 || ns > 4 || n < static_cast<size_t>(4 + 2 * ns)) fail("bad SOS: %d components", ns);
        std::vector<int> sc;
        for (int i = 0; i < ns; ++i) {
            const int cid = p[1 + 2 * i];
            int ci = -1;
            for (size_t k = 0; k < frame.comps.size(); ++k) {
                if (frame.comps[k].id == cid) ci = static_cast<int>(k);
            }
            if (ci < 0) fail("SOS names component id %d, which the frame lacks", cid);
            frame.comps[ci].dc_tbl = p[2 + 2 * i] >> 4;
            frame.comps[ci].ac_tbl = p[2 + 2 * i] & 15;
            if (frame.comps[ci].dc_tbl > 3 || frame.comps[ci].ac_tbl > 3) fail("SOS: bad table selector");
            sc.push_back(ci);
        }
        const int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahl = p[3 + 2 * ns];
        if (ss != 0 || se != 63 || ahl != 0) fail("SOS: spectral selection %d-%d in a sequential frame", ss, se);
        for (int ci : sc) {
            if (!dc[frame.comps[ci].dc_tbl].defined || !ac[frame.comps[ci].ac_tbl].defined) {
                fail("SOS: component %d uses an undefined Huffman table", ci);
            }
        }
        bool has_y = false;
        for (int ci : sc) has_y |= ci == 0;
        if (has_y) {
            if (y_done) fail("a second scan of the Y component");
            const int tq = frame.comps[0].tq;
            if (!qt_defined[tq]) fail("the Y component's quantization table %d is not defined", tq);
            for (int k = 0; k < 64; ++k) out.qtable[k] = qt[tq][k];  // latched, as libjpeg does
            if (out.slots != nullptr) {
                out.slots->resize(static_cast<size_t>(grid_w()) * grid_h() * 64);
                out.lens->assign(static_cast<size_t>(grid_w()) * grid_h(), 0);
            }
        }

        // the MCU layout: one block a MCU for one component, else the sampling factors
        int mcus_x, mcus_y;
        if (ns == 1) {
            const Component& c = frame.comps[sc[0]];
            const int cw = (frame.width * c.h + 8 * frame.hmax - 1) / (8 * frame.hmax);
            const int ch = (frame.height * c.v + 8 * frame.vmax - 1) / (8 * frame.vmax);
            mcus_x = cw;
            mcus_y = ch;
        } else {
            mcus_x = (frame.width + 8 * frame.hmax - 1) / (8 * frame.hmax);
            mcus_y = (frame.height + 8 * frame.vmax - 1) / (8 * frame.vmax);
        }
        const int gw = grid_w(), gh = grid_h();
        if (out.scan != nullptr) {
            if (has_y) {
                keep_scan(*out.scan, sc, ns, mcus_x, mcus_y);
                y_done = true;
            } else {  // another component's scan: skipped to its terminating marker (past its restart markers)
                size_t skipped = 0;
                int mk;
                do {
                    mk = unstuff(buf, len, pos, nullptr, skipped);
                } while (mk >= 0xD0 && mk <= 0xD7);
                if (mk < 0) fail("truncated scan data: the file ends inside a scan");
                pending_marker = mk;
            }
            return;
        }
        BitReader br{buf, len, pos};
        int pred[4] = {0, 0, 0, 0};
        int16_t* slots = has_y ? out.slots->data() : nullptr;
        uint8_t* lens = has_y ? out.lens->data() : nullptr;
        int next_rst = 0, to_restart = restart_interval;
        for (int my = 0; my < mcus_y; ++my) {
            for (int mx = 0; mx < mcus_x; ++mx) {
                if (restart_interval && to_restart-- == 0) {
                    const int mk = br.next_marker();
                    if (mk != 0xD0 + next_rst) {
                        if (mk < 0) fail("truncated scan data: the file ends before restart marker RST%d", next_rst);
                        fail("corrupt scan data: marker 0x%02X where RST%d was due", mk, next_rst);
                    }
                    next_rst = (next_rst + 1) & 7;
                    pred[0] = pred[1] = pred[2] = pred[3] = 0;
                    to_restart = restart_interval - 1;
                }
                for (int si = 0; si < ns; ++si) {
                    const int ci = sc[si];
                    const Component& c = frame.comps[ci];
                    const int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
                    for (int v = 0; v < bv; ++v) {
                        for (int h = 0; h < bh; ++h) {
                            const int bx = mx * bh + h, by = my * bv + v;
                            const size_t b = static_cast<size_t>(by) * gw + bx;
                            const bool keep = ci == 0 && bx < gw && by < gh;
                            decode_block(br, c, pred[si], keep ? slots + b * 64 : nullptr, keep ? lens + b : nullptr);
                        }
                    }
                }
            }
        }
        // the rest of the segment is padding; the next marker follows
        const int mk = br.next_marker();
        if (mk < 0) fail("the file ends after a scan without an EOI marker");
        pos = br.pos;  // just past the marker code
        pending_marker = mk;
        if (has_y) y_done = true;
    }

    // The scan stage's part of the Y scan: its MCU layout, tables and unstuffed
    // bytes, cut at its restart markers (their sequence checked as the decode
    // checks it); the card decodes it.
    void keep_scan(Scan& sc_out, const std::vector<int>& sc, int ns, int mcus_x, int mcus_y) {
        int32_t* m = sc_out.meta;
        int nb = 0;
        for (int ci : sc) {
            const Component& c = frame.comps[ci];
            const int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
            for (int v = 0; v < bv; ++v) {
                for (int h = 0; h < bh; ++h) {
                    if (nb == kMaxMcuBlocks) fail("SOS: an MCU of more than %d blocks", kMaxMcuBlocks);
                    const int yq = ci == 0 ? v * bh + h : -1;
                    m[24 + nb++] = c.dc_tbl | (c.ac_tbl << 4) | ((yq + 1) << 8);
                }
            }
            sc_out.tables[0][c.dc_tbl] = raw[0][c.dc_tbl];
            sc_out.tables[1][c.ac_tbl] = raw[1][c.ac_tbl];
        }
        const Component& y = frame.comps[0];
        m[0] = frame.height;
        m[1] = frame.width;
        m[2] = grid_w();
        m[4] = grid_h();
        m[5] = mcus_x;
        m[6] = mcus_y;
        m[7] = restart_interval;
        m[8] = nb;
        m[9] = ns == 1 ? 1 : y.h;
        m[10] = ns == 1 ? 1 : y.v;
        const long mcus = static_cast<long>(mcus_x) * mcus_y;
        const long intervals = restart_interval ? (mcus + restart_interval - 1) / restart_interval : 1;
        // A fault at an interval's end (the file ends there, or the marker is
        // not the RSTn due) is the decode's only if the interval's data
        // decodes: it is deferred to the card (column 15) and the parse ends.
        int next_rst = 0;
        long kept = 0;
        for (long i = 0; i < intervals; ++i) {
            const size_t start = sc_out.used;
            const int mk = unstuff(buf, len, pos, sc_out.out, sc_out.used);
            sc_out.intervals.push_back(static_cast<int32_t>(start));
            sc_out.intervals.push_back(static_cast<int32_t>(sc_out.used));
            sc_out.intervals.push_back(mk < 0 ? kEndOfFile : mk);
            ++kept;
            if (i + 1 < intervals) {
                if (mk != 0xD0 + next_rst) {
                    m[15] = mk < 0 ? kFileEndsBeforeRst | (next_rst << 16)
                                   : kMarkerNotRst | (mk << 8) | (next_rst << 16);
                    parse_done = true;
                    break;
                }
                next_rst = (next_rst + 1) & 7;
            } else if (mk < 0) {
                m[15] = kFileEndsAfterScan;
                parse_done = true;
            } else {
                pending_marker = mk;  // a stray RSTn here is ignored as the decode ignores it
            }
        }
        m[12] = static_cast<int32_t>(kept);
        if (sc_out.used * 8 >= (size_t{1} << 31)) fail("a scan of more than 256 MB");
        m[14] = static_cast<int32_t>(sc_out.used * 8);
    }

    // One block's coefficients, in zigzag order, into `zz` (zero between the
    // ones written), then its prefix up to the last nonzero one into `slot`
    // and the prefix's length into `len` (both null for a block not kept).
    void decode_block(BitReader& br, const Component& c, int& pred, int16_t* slot, uint8_t* len) {
        const HuffTable& dct = dc[c.dc_tbl];
        const HuffTable& act = ac[c.ac_tbl];
        int s = br.decode(dct);
        if (s > 15) fail("corrupt scan data: DC magnitude category %d", s);
        const int diff = s ? extend(br.bits(s), s) : 0;
        // libjpeg adds through unsigned ints and keeps the low 16 bits in the block
        pred = static_cast<int>(static_cast<unsigned>(pred) + static_cast<unsigned>(diff));
        zz[0] = static_cast<int16_t>(pred);
        int last = 0;
        for (int k = 1; k < 64; ++k) {
            if (br.nbits < 32) br.fill();  // a code (16 bits at most) and its magnitude (15) without another fill
            const uint32_t peek = static_cast<uint32_t>(br.acc >> (64 - kFastBits));
            int rs, val = 0;
            if (const int fl = act.fast_len[peek]) {
                br.consume(fl);
                rs = act.fast_rs[peek];
                val = act.fast_val[peek];
            } else {
                rs = br.decode_filled(act);
                if (const int size = rs & 15) {
                    val = extend(static_cast<int>(br.acc >> (64 - size)), size);
                    br.consume(size);
                }
            }
            const int r = rs >> 4;
            if (rs & 15) {
                k += r;
                if (k > 63) fail("corrupt scan data: an AC run past the 64th coefficient");
                zz[k] = static_cast<int16_t>(val);
                last = k;
            } else {
                if (r != 15) break;  // EOB
                k += 15;             // ZRL
                if (k > 63) fail("corrupt scan data: a zero run past the 64th coefficient");
            }
        }
        br.check();
        if (slot != nullptr) {
            for (int k = 0; k <= last; ++k) slot[k] = zz[k];
            *len = static_cast<uint8_t>(last + 1);
        }
        for (int k = 1; k <= last; ++k) zz[k] = 0;
    }

    int16_t zz[64] = {};

    int pending_marker = -1;

    int next() {
        if (pending_marker >= 0) {
            const int m = pending_marker;
            pending_marker = -1;
            return m;
        }
        return read_marker();
    }

    // Parse to the frame header only (dims and refusals that the header shows).
    void probe() {
        if (len < 2 || buf[0] != 0xFF || buf[1] != 0xD8) fail("not a JPEG file: no SOI marker");
        pos = 2;
        while (!frame.seen) dispatch(next(), nullptr);
    }

    bool parse_done = false;  // the scan stage met a fault that the card's decode reports

    void decode(Output& out) {
        probe();
        for (;;) {
            if (parse_done) return;
            const int m = next();
            if (m == 0xD9) break;  // EOI
            dispatch(m, &out);
        }
        if (!y_done) fail("no scan of the Y component before EOI");
    }

    void dispatch(int m, Output* out) {
        switch (m) {
            case 0xC0:
            case 0xC1:
                sof(m);
                return;
            case 0xC2:
            case 0xC6:
            case 0xCA:
            case 0xCE:
                fail("SOF%d: progressive JPEG is not supported", m - 0xC0);
            case 0xC3:
            case 0xC7:
            case 0xCB:
            case 0xCF:
                fail("SOF%d: lossless JPEG is not supported", m - 0xC0);
            case 0xC5:
                fail("SOF5: hierarchical JPEG is not supported");
            case 0xC9:
                fail("SOF9: arithmetic coding is not supported");
            case 0xCC:
                fail("DAC: arithmetic coding is not supported");
            case 0xC4:
                dht();
                return;
            case 0xDB:
                dqt();
                return;
            case 0xDD: {
                const size_t n = segment(m, 2);
                restart_interval = be16(buf + pos + 2);
                pos += n + 2;
                return;
            }
            case 0xDA:
                if (out == nullptr) fail("SOS before SOF");
                scan(*out);
                return;
            case 0xD9:
                fail("EOI before the frame's scans");
            case 0xD8:
                fail("a second SOI marker");
            case 0x01:
                return;  // TEM: no payload
            default:
                if (m >= 0xD0 && m <= 0xD7) return;  // a stray RSTn: libjpeg ignores it
                if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM; DNL is skipped as libjpeg does
                    app(m);
                    return;
                }
                fail("unexpected marker 0x%02X", m);
        }
    }
};

// Minimal worker pool (persistent, as native/nntc_loader.cpp's).
class Pool {
   public:
    explicit Pool(int n) {
        for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Run(); });
    }
    ~Pool() {
        {
            std::unique_lock<std::mutex> lock(m_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }
    void Submit(std::function<void()> f) {
        {
            std::unique_lock<std::mutex> lock(m_);
            queue_.push(std::move(f));
        }
        cv_.notify_one();
    }

   private:
    void Run() {
        for (;;) {
            std::function<void()> task;
            {
                std::unique_lock<std::mutex> lock(m_);
                cv_.wait(lock, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                task = std::move(queue_.front());
                queue_.pop();
            }
            task();
        }
    }
    std::mutex m_;
    std::condition_variable cv_;
    std::queue<std::function<void()>> queue_;
    std::vector<std::thread> workers_;
    bool stop_ = false;
};

// One pool for each thread count asked for, kept for the life of the process:
// callers on other threads may be using any of them.
std::mutex g_pool_mutex;
std::map<int, Pool*> g_pools;

Pool* pool(int nthreads) {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    Pool*& p = g_pools[nthreads];
    if (p == nullptr) p = new Pool(nthreads);
    return p;
}

void copy_message(const std::string& msg, char* err, int errlen) {
    if (err == nullptr || errlen <= 0) return;
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

// Runs work(i) for i in [0, n) on nthreads threads; returns the first
// failing index (its message in err), or -1.
int run_batch(int n, int nthreads, char* err, int errlen, const std::function<void(int)>& work) {
    std::mutex m;
    std::condition_variable done_cv;
    int remaining = n;
    int failed = -1;
    std::string failed_msg;
    auto one = [&](int i) {
        std::string msg;
        bool bad = false;
        try {
            work(i);
        } catch (const DecodeError& e) {
            bad = true;
            msg = e.msg;
        } catch (const std::exception& e) {
            bad = true;
            msg = e.what();
        }
        std::lock_guard<std::mutex> lock(m);
        if (bad && (failed < 0 || i < failed)) {
            failed = i;
            failed_msg = msg;
        }
        if (--remaining == 0) done_cv.notify_one();
    };
    if (nthreads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) one(i);
    } else {
        Pool* p = pool(nthreads);
        for (int i = 0; i < n; ++i) p->Submit([&, i] { one(i); });
        std::unique_lock<std::mutex> lock(m);
        done_cv.wait(lock, [&] { return remaining == 0; });
    }
    if (failed >= 0) copy_message(failed_msg, err, errlen);
    return failed;
}

// A decode table for the card, kTableWords int32 (kernels/jpeg_huffman.py:
// TABLE_*): 512 lookahead entries by the next 9 bits, (length << 8) | symbol
// or 0; maxcode by length 0-17; valoffset by length 0-17; the 256 symbols.
constexpr int kTableWords = 512 + 18 + 18 + 256;

void append_decode_table(std::vector<int32_t>& out, const std::string& raw) {
    HuffTable t;
    const auto* p = reinterpret_cast<const uint8_t*>(raw.data());
    build_table(t, p, p + 16, static_cast<int>(raw.size()) - 16);
    const size_t at = out.size();
    out.resize(at + kTableWords, 0);
    int32_t* w = out.data() + at;
    for (int i = 0; i < 512; ++i) w[i] = t.look[i];
    for (int l = 0; l < 18; ++l) {
        w[512 + l] = l >= 1 ? t.maxcode[l] : -1;
        w[530 + l] = l >= 1 && l <= 16 ? t.valoffset[l] : 0;
    }
    const int nvals = static_cast<int>(raw.size()) - 16;
    for (int i = 0; i < 256; ++i) w[548 + i] = i < nvals ? t.vals[i] : 0;
}

struct ScanBatch {
    std::vector<Scan> scans;
    std::vector<int32_t> tables;
    int64_t num_intervals = 0;
};

}  // namespace

extern "C" {

// The frame header of each of n JPEGs (offsets[i], lengths[i] into blob):
// dims[4 i + 0..3] = height, width, ceil(width / 8), ceil(height / 8).
// Returns -1, or the first image whose header is refused (message in err).
int nntc_jpeg_probe_batch(const uint8_t* blob, const size_t* offsets, const size_t* lengths, int n, int32_t* dims,
                          int nthreads, char* err, int errlen) {
    return run_batch(n, nthreads, err, errlen, [&](int i) {
        Decoder d(blob + offsets[i], lengths[i]);
        d.probe();
        dims[4 * i + 0] = d.frame.height;
        dims[4 * i + 1] = d.frame.width;
        dims[4 * i + 2] = d.grid_w();
        dims[4 * i + 3] = d.grid_h();
    });
}

// Entropy-decode n JPEGs, image i's num_blocks-long block grid (ceil(w/8) x
// ceil(h/8), raster order) from block first_block[i] on. Each block is its
// coefficients in zigzag order up to its last nonzero one (at least the DC);
// the blocks of all images go to coeffs back to back (coeffs has room for
// 64 a block), block b's from block_start[b] on (block_start has
// num_blocks + 1 entries, the last one the total, also in *total); image i's
// quantization table (natural order) to qtables[64 i ...]. Returns -1, or
// the first image that failed (message in err).
int nntc_jpeg_entropy_batch(const uint8_t* blob, const size_t* offsets, const size_t* lengths, int n,
                            const int64_t* first_block, int64_t num_blocks, int16_t* coeffs, int32_t* block_start,
                            int64_t* total, int32_t* qtables, int nthreads, char* err, int errlen) {
    std::vector<uint8_t> lens_all(static_cast<size_t>(num_blocks));
    std::vector<int64_t> used(static_cast<size_t>(n));
    const int failed = run_batch(n, nthreads, err, errlen, [&](int i) {
        static thread_local std::vector<int16_t> slots;
        static thread_local std::vector<uint8_t> lens;
        Decoder d(blob + offsets[i], lengths[i]);
        Output out;
        out.slots = &slots;
        out.lens = &lens;
        out.qtable = qtables + 64 * static_cast<size_t>(i);
        d.decode(out);
        // each image's runs first where its blocks could start at 64 coefficients a block
        int16_t* dst = coeffs + first_block[i] * 64;
        int64_t u = 0;
        for (size_t b = 0; b < lens.size(); ++b) {
            for (int k = 0; k < lens[b]; ++k) dst[u + k] = slots[b * 64 + k];
            u += lens[b];
        }
        std::memcpy(lens_all.data() + first_block[i], lens.data(), lens.size());
        used[static_cast<size_t>(i)] = u;
    });
    if (failed >= 0) return failed;
    // then all back to back, in order (each moves down or stays)
    int64_t at = 0, b = 0;
    for (int i = 0; i < n; ++i) {
        std::memmove(coeffs + at, coeffs + first_block[i] * 64, sizeof(int16_t) * used[static_cast<size_t>(i)]);
        const int64_t end = i + 1 < n ? first_block[i + 1] : num_blocks;
        for (; b < end; ++b) {
            block_start[b] = static_cast<int32_t>(at);
            at += lens_all[static_cast<size_t>(b)];
        }
    }
    block_start[num_blocks] = static_cast<int32_t>(at);
    *total = at;
    return -1;
}

// The scan stage (the loader's path): parse each of n JPEGs, unstuff the
// scan that holds Y into scan[scan_offsets[i] ..] (room up to
// scan_offsets[i + 1], the rest of it zeroed), write Y's quantization table
// to qtables[64 i ...] and the image's columns to meta[34 i ...]:
//   0 height, 1 width, 2 ceil(w/8), 4 ceil(h/8), 5, 6 the MCUs across and
//   down, 7 the restart interval (MCUs, 0: none), 8 blocks an MCU, 9, 10 Y's
//   blocks across and down an MCU, 11 the first restart interval (below),
//   12 the intervals, 14 the scan's bits, 15 a fault met at an interval's end
//   that the decode reports if the interval decodes (code | marker << 8 |
//   the RSTn due << 16, 0: none), 16-19 the batch's table of each DC
//   table id 0-3 and 20-23 of each AC table id (-1: not used), 24-33 each
//   block of an MCU: DC table id | AC table id << 4 | (Y's block in the MCU
//   + 1, or 0) << 8. Columns 3, 13 and 15 are left for the caller.
// Returns -1 with *handle holding the intervals and the batch's distinct
// tables (totals[0], totals[1] of them) for nntc_jpeg_scan_collect, or the
// first image that failed (message in err; no handle).
int nntc_jpeg_scan_batch(const uint8_t* blob, const size_t* offsets, const size_t* lengths, int n, uint8_t* scan,
                         const size_t* scan_offsets, int32_t* meta, int32_t* qtables, int nthreads, char* err,
                         int errlen, int64_t* totals, void** handle) {
    auto* batch = new ScanBatch();
    batch->scans.resize(static_cast<size_t>(n));
    const int failed = run_batch(n, nthreads, err, errlen, [&](int i) {
        Scan& sc = batch->scans[static_cast<size_t>(i)];
        sc.out = scan + scan_offsets[i];
        Decoder d(blob + offsets[i], lengths[i]);
        Output out;
        out.scan = &sc;
        out.qtable = qtables + 64 * static_cast<size_t>(i);
        d.decode(out);
        std::memset(sc.out + sc.used, 0, scan_offsets[i + 1] - scan_offsets[i] - sc.used);
        std::memcpy(meta + kMetaCols * static_cast<size_t>(i), sc.meta, sizeof(sc.meta));
    });
    if (failed >= 0) {
        delete batch;
        return failed;
    }
    std::map<std::string, int> seen;
    int64_t first = 0;
    for (int i = 0; i < n; ++i) {
        Scan& sc = batch->scans[static_cast<size_t>(i)];
        int32_t* m = meta + kMetaCols * static_cast<size_t>(i);
        m[11] = static_cast<int32_t>(first);
        first += m[12];
        for (int tc = 0; tc < 2; ++tc) {
            for (int th = 0; th < 4; ++th) {
                const std::string& t = sc.tables[tc][th];
                int id = -1;
                if (!t.empty()) {
                    const std::string key = std::string(1, static_cast<char>(tc)) + t;
                    auto it = seen.find(key);
                    if (it == seen.end()) {
                        it = seen.emplace(key, static_cast<int>(seen.size())).first;
                        append_decode_table(batch->tables, t);
                    }
                    id = it->second;
                }
                m[16 + 4 * tc + th] = id;
            }
        }
    }
    batch->num_intervals = first;
    totals[0] = first;
    totals[1] = static_cast<int64_t>(seen.size());
    *handle = batch;
    return -1;
}

// The intervals of nntc_jpeg_scan_batch's images, image by image, each as
// (first bit, end bit, the marker that ends its data (0xFF: the file's end),
// image) with the bits
// counted from the start of `scan` (scan_offsets as given there), and the
// distinct tables, kTableWords int32 each (kernels/jpeg_huffman.py says
// how); frees the handle.
void nntc_jpeg_scan_collect(void* handle, const size_t* scan_offsets, int32_t* intervals, int32_t* tables) {
    auto* batch = static_cast<ScanBatch*>(handle);
    size_t at = 0;
    for (size_t i = 0; i < batch->scans.size(); ++i) {
        const std::vector<int32_t>& iv = batch->scans[i].intervals;
        const int64_t base = static_cast<int64_t>(scan_offsets[i]) * 8;
        for (size_t k = 0; k < iv.size(); k += 3) {
            intervals[at++] = static_cast<int32_t>(base + 8 * static_cast<int64_t>(iv[k]));
            intervals[at++] = static_cast<int32_t>(base + 8 * static_cast<int64_t>(iv[k + 1]));
            intervals[at++] = iv[k + 2];
            intervals[at++] = static_cast<int32_t>(i);
        }
    }
    std::memcpy(tables, batch->tables.data(), batch->tables.size() * sizeof(int32_t));
    delete batch;
}

void nntc_jpeg_scan_free(void* handle) { delete static_cast<ScanBatch*>(handle); }

}  // extern "C"
