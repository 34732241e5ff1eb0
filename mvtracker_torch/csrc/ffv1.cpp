// FFV1 (RFC 9043) frame codec for 8-bit RGB, the depth-video codec of the
// DROID factory: depth in millimetres as uint16, low byte in B, high byte in
// G. Host code with a plain C interface, built with g++ and loaded with
// ctypes by `mvtracker_torch/droid/ffv1.py`; the Matroska container around
// the frames is Python (`mvtracker_torch/droid/matroska.py`).
//
// Decoder: version 3 configuration records (micro version 0-4), RGB
// (colourspace 1, reversible colour transform, coefficients 1/1), 8 bits,
// with or without the alpha plane; Golomb-Rice coding (coder 0, the one
// FFmpeg's encoder uses by default) or the range coder with its default
// state-transition table (coder 1); any slice layout; keyframes and the
// frames between them, whose contexts carry over; slice CRCs are checked.
// Anything else fails with a message that names it.
//
// Encoder: the simplest stream of the same kind: version 3, range coder
// with the default table, one 3-input quantisation table, slice CRCs, every
// frame a keyframe, no alpha plane.
//
// Slices decode and encode in parallel (OpenMP). Every entry point returns
// 0 (or a size) on success and -1 with a message in `err` on failure.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int CONTEXT_SIZE = 32;
constexpr int MAX_SLICES = 1024;
const int LOG2_RUN[41] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6,
                          6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

struct Error {
    std::string msg;
};

// ---------------------------------------------------------------- CRC-32
// MSB-first, polynomial 0x04C11DB7, initial value 0, no final xor: a block
// followed by its CRC stored big-endian has CRC 0 (RFC 9043 section 4.9.3).
struct CrcTable {
    uint32_t t[256];
    CrcTable() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i << 24;
            for (int k = 0; k < 8; ++k) c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : c << 1;
            t[i] = c;
        }
    }
};
const CrcTable CRC;

uint32_t crc32(const uint8_t* p, size_t n) {
    uint32_t c = 0;
    for (size_t i = 0; i < n; ++i) c = (c << 8) ^ CRC.t[(c >> 24) ^ p[i]];
    return c;
}

// ------------------------------------------------------ state transitions
struct States {
    uint8_t zero[256], one[256];
    States() {
        // FFmpeg's ff_build_rac_states(factor = 0.05 * 2^32, max_p = 248):
        // the default table of RFC 9043 section 3.8.1.3.
        const int64_t ONE = int64_t(1) << 32;
        const int64_t factor = int64_t(0.05 * double(ONE));
        const int max_p = 256 - 8;
        std::memset(zero, 0, sizeof zero);
        std::memset(one, 0, sizeof one);
        int last_p8 = 0;
        int64_t p = ONE / 2;
        for (int i = 0; i < 128; ++i) {
            int p8 = int((256 * p + ONE / 2) >> 32);
            if (p8 <= last_p8) p8 = last_p8 + 1;
            if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = uint8_t(p8);
            p += ((ONE - p) * factor + ONE / 2) >> 32;
            last_p8 = p8;
        }
        for (int i = 256 - max_p; i <= max_p; ++i) {
            if (one[i]) continue;
            p = (int64_t(i) * ONE + 128) >> 8;
            p += ((ONE - p) * factor + ONE / 2) >> 32;
            int p8 = int((256 * p + ONE / 2) >> 32);
            if (p8 <= i) p8 = i + 1;
            if (p8 > max_p) p8 = max_p;
            one[i] = uint8_t(p8);
        }
        for (int i = 1; i < 255; ++i) zero[i] = uint8_t(256 - one[256 - i]);
    }
};
const States STATES;

// ------------------------------------------------------------ range coder
struct RangeDecoder {
    const uint8_t* pos;
    const uint8_t* end;
    const uint8_t* start;
    int low, range;

    RangeDecoder(const uint8_t* buf, const uint8_t* buf_end) : pos(buf), end(buf_end), start(buf) {
        low = (buf_end - buf >= 2) ? (buf[0] << 8) | buf[1] : 0xFF00;
        pos += 2;
        range = 0xFF00;
        if (low >= 0xFF00) {
            low = 0xFF00;
            end = pos;
        }
    }
    inline void refill() {
        if (range < 0x100) {
            range <<= 8;
            low <<= 8;
            if (pos < end) low += *pos;
            ++pos;  // past the end reads as 0, and still counts
        }
    }
    inline int get(uint8_t* state) {
        int range1 = (range * (*state)) >> 8;
        range -= range1;
        if (low < range) {
            *state = STATES.zero[*state];
            refill();
            return 0;
        }
        low -= range;
        *state = STATES.one[*state];
        range = range1;
        refill();
        return 1;
    }
    int symbol(uint8_t* state, bool is_signed) {
        if (get(state)) return 0;
        int e = 0;
        while (get(state + 1 + std::min(e, 9))) {
            if (++e > 31) throw Error{"FFV1: symbol exponent above 31 (corrupt stream)"};
        }
        unsigned a = 1;
        for (int i = e - 1; i >= 0; --i) a += a + get(state + 22 + std::min(i, 9));
        if (is_signed && get(state + 11 + std::min(e, 10))) return -int(a);
        return int(a);
    }
    // Bytes consumed from `start`, the 2 bytes read ahead at init included.
    int64_t consumed() const { return pos - start; }
};

struct RangeEncoder {
    std::vector<uint8_t>* out;
    int low = 0, range = 0xFF00, outstanding_count = 0, outstanding_byte = -1;

    explicit RangeEncoder(std::vector<uint8_t>* o) : out(o) {}
    inline void renorm() {
        while (range < 0x100) {
            if (outstanding_byte < 0) {
                outstanding_byte = low >> 8;
            } else if (low <= 0xFF00) {
                out->push_back(uint8_t(outstanding_byte));
                for (; outstanding_count; --outstanding_count) out->push_back(0xFF);
                outstanding_byte = low >> 8;
            } else if (low >= 0x10000) {
                out->push_back(uint8_t(outstanding_byte + 1));
                for (; outstanding_count; --outstanding_count) out->push_back(0x00);
                outstanding_byte = (low >> 8) - 0x100;
            } else {
                ++outstanding_count;
            }
            low = (low & 0xFF) << 8;
            range <<= 8;
        }
    }
    inline void put(uint8_t* state, int bit) {
        int range1 = (range * (*state)) >> 8;
        if (!bit) {
            range -= range1;
            *state = STATES.zero[*state];
        } else {
            low += range - range1;
            range = range1;
            *state = STATES.one[*state];
        }
        renorm();
    }
    void symbol(uint8_t* state, int v, bool is_signed) {
        if (!v) {
            put(state, 1);
            return;
        }
        const unsigned a = is_signed ? unsigned(v < 0 ? -v : v) : unsigned(v);
        int e = 31 - __builtin_clz(a);
        put(state, 0);
        for (int i = 0; i < e; ++i) put(state + 1 + std::min(i, 9), 1);
        put(state + 1 + std::min(e, 9), 0);
        for (int i = e - 1; i >= 0; --i) put(state + 22 + std::min(i, 9), (a >> i) & 1);
        if (is_signed) put(state + 11 + std::min(e, 10), v < 0);
    }
    // Sentinel mode ends with a 0 of state 129 (RFC 9043 section 3.8.1.1.1);
    // closed mode (the configuration record) without it.
    void terminate(bool sentinel) {
        if (sentinel) {
            uint8_t s = 129;
            put(&s, 0);
        }
        range = 0xFF;
        low += 0xFF;
        renorm();
        range = 0xFF;
        renorm();
    }
};

// -------------------------------------------------------------- Golomb-Rice
struct BitReader {
    const uint8_t* buf;
    int64_t size_bits, pos = 0;

    BitReader(const uint8_t* b, int64_t nbytes) : buf(b), size_bits(nbytes * 8) {}
    inline int bit() {
        int v = 0;
        if (pos < size_bits) v = (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
        ++pos;
        return v;
    }
    inline unsigned bits(int n) {
        unsigned v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | unsigned(bit());
        return v;
    }
    // Unsigned Golomb-Rice code with an escape after `limit` zeros.
    inline unsigned ur_golomb(int k, int limit, int esc_len) {
        int q = 0;
        while (q < limit && bit() == 0) ++q;
        if (q < limit) return (unsigned(q) << k) + bits(k);
        return bits(esc_len) + unsigned(limit) - 1;
    }
};

struct VlcState {
    int error_sum = 4, drift = 0, bias = 0, count = 1;
    void update(int v) {
        int d = drift, c = count;
        error_sum += v < 0 ? -v : v;
        d += v;
        if (c == 128) {
            c >>= 1;
            d >>= 1;
            error_sum >>= 1;
        }
        ++c;
        if (d <= -c) {
            bias = std::max(bias - 1, -128);
            d = std::max(d + c, -c + 1);
        } else if (d > 0) {
            bias = std::min(bias + 1, 127);
            d = std::min(d - c, 0);
        }
        drift = d;
        count = c;
    }
};

inline int fold(int v, int bits) {
    const int m = 1 << bits;
    v &= m - 1;
    return v >= m / 2 ? v - m : v;
}

inline int get_vlc_symbol(BitReader& br, VlcState& st, int bits) {
    int i = st.count, k = 0;
    while (i < st.error_sum) {
        ++k;
        i += i;
    }
    unsigned u = br.ur_golomb(k, 12, bits);
    int v = int(u >> 1) ^ -int(u & 1);
    if (2 * st.drift + st.count < 0) v = ~v;
    int ret = fold(v + st.bias, bits);
    st.update(v);
    return ret;
}

// --------------------------------------------------------- context, predict
using QuantTable = std::array<std::array<int16_t, 256>, 5>;

inline int mid_pred(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// `cur` is the row being coded, `prev` the row above, `prev2` the one above
// that; each has valid entries at [-2, w] (see the edge rules in code_slice).
inline int get_context(const QuantTable& q, bool five, const int* cur, const int* prev, const int* prev2) {
    const int LT = prev[-1], T = prev[0], RT = prev[1], L = cur[-1];
    int c = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
    if (five) c += q[3][(cur[-2] - L) & 0xFF] + q[4][(prev2[0] - T) & 0xFF];
    return c;
}

inline int predict(const int* cur, const int* prev) {
    const int LT = prev[-1], T = prev[0], L = cur[-1];
    return mid_pred(L, L + T - LT, T);
}

// ------------------------------------------------------------- parameters
struct Params {
    int version = 0, micro = 0, coder = 0, colorspace = 0, bits = 0, chroma_planes = 0;
    int hshift = 0, vshift = 0, transparency = 0, nh = 1, nv = 1, ec = 0, intra = 0;
    int plane_count = 0;
    std::vector<QuantTable> qt;
    std::vector<bool> five;
    std::vector<int> context_count;
    std::vector<std::vector<uint8_t>> initial_states;  // [table][context * 32]
};

int read_quant_table(RangeDecoder& c, std::array<int16_t, 256>& q, int scale) {
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    int i = 0, v = 0;
    for (; i < 128; ++v) {
        unsigned len = unsigned(c.symbol(state, false)) + 1u;
        if (len > unsigned(128 - i) || !len) throw Error{"FFV1: bad quantisation table in the configuration record"};
        while (len--) q[i++] = int16_t(scale * v);
    }
    for (i = 1; i < 128; ++i) q[256 - i] = int16_t(-q[i]);
    q[128] = int16_t(-q[127]);
    return 2 * v - 1;
}

Params parse_record(const uint8_t* rec, int64_t len) {
    if (len < 4) throw Error{"FFV1: configuration record shorter than 4 bytes"};
    Params p;
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    RangeDecoder c(rec, rec + len);
    p.version = c.symbol(state, false);
    if (p.version != 3)
        throw Error{"FFV1 version " + std::to_string(p.version) +
                    " is not supported (only version 3, the one FFmpeg writes with a configuration record)"};
    if (crc32(rec, size_t(len)) != 0) throw Error{"FFV1: configuration record CRC mismatch"};
    c.end = rec + len - 4;
    p.micro = c.symbol(state, false);
    p.coder = c.symbol(state, false);
    if (p.coder == 2)
        throw Error{"FFV1 coder_type 2 (range coder with a custom state-transition table) is not supported"};
    if (p.coder != 0 && p.coder != 1) throw Error{"FFV1 coder_type " + std::to_string(p.coder) + " is not supported"};
    p.colorspace = c.symbol(state, false);
    p.bits = c.symbol(state, false);
    p.chroma_planes = c.get(state);
    p.hshift = c.symbol(state, false);
    p.vshift = c.symbol(state, false);
    p.transparency = c.get(state);
    p.nh = 1 + c.symbol(state, false);
    p.nv = 1 + c.symbol(state, false);
    if (p.colorspace != 1)
        throw Error{"FFV1 colorspace_type " + std::to_string(p.colorspace) + " (YCbCr) is not supported, only RGB (1)"};
    if (p.bits != 8 && p.bits != 0)
        throw Error{"FFV1 bits_per_raw_sample " + std::to_string(p.bits) + " is not supported, only 8"};
    if (!p.chroma_planes || p.hshift || p.vshift) throw Error{"FFV1: RGB without its chroma planes or with subsampling"};
    if (p.nh < 1 || p.nv < 1 || p.nh * p.nv > MAX_SLICES) throw Error{"FFV1: bad slice grid in the configuration record"};
    p.plane_count = 2 + p.transparency;
    int count = c.symbol(state, false);
    if (count < 1 || count > 8) throw Error{"FFV1: bad quant_table_set_count " + std::to_string(count)};
    for (int t = 0; t < count; ++t) {
        QuantTable q;
        int cc = 1;
        for (int i = 0; i < 5; ++i) {
            cc *= read_quant_table(c, q[i], cc);
            if (cc > 32768) throw Error{"FFV1: quantisation table with more than 32768 contexts"};
        }
        p.qt.push_back(q);
        p.five.push_back(q[3][127] != 0 || q[4][127] != 0);
        p.context_count.push_back((cc + 1) / 2);
        p.initial_states.emplace_back(size_t(p.context_count.back()) * CONTEXT_SIZE, 128);
    }
    uint8_t state2[32][CONTEXT_SIZE];
    std::memset(state2, 128, sizeof state2);
    for (int t = 0; t < count; ++t) {
        if (c.get(state)) {
            auto& init = p.initial_states[t];
            for (int j = 0; j < p.context_count[t]; ++j)
                for (int k = 0; k < CONTEXT_SIZE; ++k) {
                    int pred = j ? init[size_t(j - 1) * CONTEXT_SIZE + k] : 128;
                    init[size_t(j) * CONTEXT_SIZE + k] = uint8_t((pred + c.symbol(state2[k], true)) & 0xFF);
                }
        }
    }
    p.ec = c.symbol(state, false);
    if (p.micro >= 3) p.intra = c.symbol(state, false);
    return p;
}

// ------------------------------------------------------------------ slices
struct PlaneState {
    int qidx = -1;
    std::vector<uint8_t> state;  // range coder: context * 32
    std::vector<VlcState> vlc;   // Golomb-Rice: one per context
};

struct SliceState {
    bool ready = false;
    std::vector<PlaneState> planes;
};

struct SliceGeom {
    int x, y, w, h;
};

// Row buffers with two samples of padding on the left and one on the right.
struct Rows {
    int w;
    std::vector<int> buf;
    int* row[3];  // 0: current, 1: above, 2: two above
    explicit Rows(int width) : w(width), buf(size_t(3) * (width + 6), 0) {
        for (int i = 0; i < 3; ++i) row[i] = buf.data() + size_t(i) * (width + 6) + 3;
    }
    // New row: rotate, then the edge rules of RFC 9043 section 3.1 (the
    // sample left of the slice is the one above the first, the one right of
    // the row above repeats its last).
    void advance() {
        int* t = row[2];
        row[2] = row[1];
        row[1] = row[0];
        row[0] = t;
        row[0][-1] = row[1][0];
        row[1][w] = row[1][w - 1];
    }
};

// Decode one plane's row into rows.row[0].
void decode_line(const Params& p, PlaneState& ps, Rows& rows, RangeDecoder* rc, BitReader* br, int& run_index) {
    const QuantTable& q = p.qt[ps.qidx];
    const bool five = p.five[ps.qidx];
    const int bits = 9, mask = (1 << bits) - 1, w = rows.w;
    int* cur = rows.row[0];
    const int* prev = rows.row[1];
    const int* prev2 = rows.row[2];
    if (rc) {
        for (int x = 0; x < w; ++x) {
            int ctx = get_context(q, five, cur + x, prev + x, prev2 + x);
            bool sign = ctx < 0;
            if (sign) ctx = -ctx;
            int diff = rc->symbol(&ps.state[size_t(ctx) * CONTEXT_SIZE], true);
            if (sign) diff = -diff;
            cur[x] = (predict(cur + x, prev + x) + diff) & mask;
        }
        return;
    }
    int run_mode = 0, run_count = 0;
    for (int x = 0; x < w; ++x) {
        int ctx = get_context(q, five, cur + x, prev + x, prev2 + x);
        bool sign = ctx < 0;
        if (sign) ctx = -ctx;
        int diff;
        if (ctx == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
            if (run_count == 0 && run_mode == 1) {
                if (br->bit()) {
                    run_count = 1 << LOG2_RUN[run_index];
                    if (x + run_count <= w) ++run_index;
                    if (run_index > 40) throw Error{"FFV1: run index past its table (corrupt stream)"};
                } else {
                    run_count = LOG2_RUN[run_index] ? int(br->bits(LOG2_RUN[run_index])) : 0;
                    if (run_index) --run_index;
                    run_mode = 2;
                }
            }
            if (--run_count < 0) {
                run_mode = 0;
                run_count = 0;
                diff = get_vlc_symbol(*br, ps.vlc[size_t(ctx)], bits);
                if (diff >= 0) ++diff;
            } else {
                diff = 0;
            }
        } else {
            diff = get_vlc_symbol(*br, ps.vlc[size_t(ctx)], bits);
        }
        if (sign) diff = -diff;
        cur[x] = (predict(cur + x, prev + x) + diff) & mask;
    }
}

void reset_states(const Params& p, SliceState& s) {
    for (auto& ps : s.planes) {
        ps.state = p.initial_states[ps.qidx];
        ps.vlc.assign(size_t(p.context_count[ps.qidx]), VlcState());
    }
    s.ready = true;
}

struct Decoder {
    Params p;
    int width, height;
    bool key_seen = false;
    std::vector<SliceState> slices;
};

// Decode slice `si` of a packet into the BGR output.
void decode_slice(Decoder& d, int si, RangeDecoder& rc, bool key, const uint8_t* slice_end, int trailer, uint8_t* bgr) {
    const Params& p = d.p;
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    int sx = rc.symbol(state, false), sy = rc.symbol(state, false);
    int sw = rc.symbol(state, false) + 1, sh = rc.symbol(state, false) + 1;
    if (sx < 0 || sy < 0 || sx + sw > p.nh || sy + sh > p.nv)
        throw Error{"FFV1: slice position outside the slice grid"};
    SliceGeom g;
    g.x = int(int64_t(sx) * d.width / p.nh);
    g.y = int(int64_t(sy) * d.height / p.nv);
    g.w = int(int64_t(sx + sw) * d.width / p.nh) - g.x;
    g.h = int(int64_t(sy + sh) * d.height / p.nv) - g.y;
    if (g.w <= 0 || g.h <= 0) throw Error{"FFV1: empty slice"};
    SliceState& s = d.slices[size_t(si)];
    if (s.planes.size() != size_t(p.plane_count)) s.planes.assign(size_t(p.plane_count), PlaneState());
    bool changed = false;
    for (auto& ps : s.planes) {
        int idx = rc.symbol(state, false);
        if (idx < 0 || idx >= int(p.qt.size())) throw Error{"FFV1: quant_table_index out of range"};
        changed |= ps.qidx != idx;
        ps.qidx = idx;
    }
    rc.symbol(state, false);  // picture structure
    rc.symbol(state, false);  // sample aspect ratio
    rc.symbol(state, false);
    if (key) {
        reset_states(p, s);
    } else if (!s.ready || changed) {
        throw Error{"FFV1: a frame between keyframes changes its slices"};
    }

    RangeDecoder* rcp = nullptr;
    BitReader* brp = nullptr;
    BitReader br(nullptr, 0);
    if (p.coder == 0) {
        uint8_t sentinel = 129;
        rc.get(&sentinel);
        int64_t ac_bytes = rc.consumed() - 1;
        const uint8_t* bits_start = rc.start + ac_bytes;
        br = BitReader(bits_start, (slice_end - trailer) - bits_start);
        brp = &br;
    } else {
        rcp = &rc;
    }
    const int np = 3 + p.transparency;
    std::vector<Rows> rows;
    for (int i = 0; i < np; ++i) rows.emplace_back(g.w);
    int run_index = 0;
    for (int y = 0; y < g.h; ++y) {
        for (int pi = 0; pi < np; ++pi) {
            rows[size_t(pi)].advance();
            decode_line(p, s.planes[size_t((pi + 1) / 2)], rows[size_t(pi)], rcp, brp, run_index);
        }
        uint8_t* out = bgr + (size_t(g.y + y) * d.width + g.x) * 3;
        const int* Y = rows[0].row[0];
        const int* Cb = rows[1].row[0];
        const int* Cr = rows[2].row[0];
        for (int x = 0; x < g.w; ++x) {
            int b = Cb[x] - 256, r = Cr[x] - 256;
            int gg = Y[x] - ((b + r) >> 2);
            b += gg;
            r += gg;
            out[3 * x + 0] = uint8_t(b);
            out[3 * x + 1] = uint8_t(gg);
            out[3 * x + 2] = uint8_t(r);
        }
    }
    if (p.coder != 0) {
        uint8_t sentinel = 129;
        rc.get(&sentinel);
        if ((slice_end - rc.pos) != trailer - 1) throw Error{"FFV1: slice does not end where its size says"};
    }
}

// ----------------------------------------------------------------- encoder
struct Encoder {
    int width, height, nh, nv;
    QuantTable qt;
    int context_count;
    std::vector<uint8_t> packet;
};

// Runs 1, 1, 3, 7, 20, 96 over |difference| 0..127: 11 levels, the shape of
// FFmpeg's default 8-bit table, for the three inputs L-LT, LT-T and T-RT.
const int ENC_RUNS[6] = {1, 1, 3, 7, 20, 96};

void make_encoder_table(QuantTable& q, int& contexts) {
    int scale = 1;
    for (int i = 0; i < 5; ++i) {
        int v = 0, k = 0;
        if (i < 3) {
            for (; v < 6; ++v)
                for (int r = 0; r < ENC_RUNS[v]; ++r) q[i][k++] = int16_t(scale * v);
        } else {
            for (; k < 128; ++k) q[i][k] = 0;
            v = 1;
        }
        for (k = 1; k < 128; ++k) q[i][256 - k] = int16_t(-q[i][k]);
        q[i][128] = int16_t(-q[i][127]);
        scale *= 2 * v - 1;
    }
    contexts = (scale + 1) / 2;
}

void encode_slice(const Encoder& e, const uint8_t* bgr, const SliceGeom& g, int sx, int sy, RangeEncoder& rc) {
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    rc.symbol(state, sx, false);
    rc.symbol(state, sy, false);
    rc.symbol(state, 0, false);  // width - 1 and height - 1, in slices
    rc.symbol(state, 0, false);
    rc.symbol(state, 0, false);  // quant table of plane 0 (luma)
    rc.symbol(state, 0, false);  // of plane 1 (chroma)
    rc.symbol(state, 3, false);  // progressive
    rc.symbol(state, 0, false);  // sample aspect ratio 0/1: unknown
    rc.symbol(state, 1, false);
    std::vector<uint8_t> states[2];
    for (auto& s : states) s.assign(size_t(e.context_count) * CONTEXT_SIZE, 128);
    std::vector<Rows> rows;
    for (int i = 0; i < 3; ++i) rows.emplace_back(g.w);
    for (int y = 0; y < g.h; ++y) {
        for (auto& r : rows) r.advance();
        const uint8_t* in = bgr + (size_t(g.y + y) * e.width + g.x) * 3;
        for (int x = 0; x < g.w; ++x) {
            int b = in[3 * x], gg = in[3 * x + 1], r = in[3 * x + 2];
            b -= gg;
            r -= gg;
            rows[0].row[0][x] = gg + ((b + r) >> 2);
            rows[1].row[0][x] = b + 256;
            rows[2].row[0][x] = r + 256;
        }
        for (int pi = 0; pi < 3; ++pi) {
            Rows& rw = rows[size_t(pi)];
            uint8_t* st = states[(pi + 1) / 2].data();
            const int* cur = rw.row[0];
            const int* prev = rw.row[1];
            const int* prev2 = rw.row[2];
            for (int x = 0; x < g.w; ++x) {
                int ctx = get_context(e.qt, false, cur + x, prev + x, prev2 + x);
                int diff = cur[x] - predict(cur + x, prev + x);
                if (ctx < 0) {
                    ctx = -ctx;
                    diff = -diff;
                }
                rc.symbol(st + size_t(ctx) * CONTEXT_SIZE, fold(diff, 9), true);
            }
        }
    }
    rc.terminate(true);
}

void put_be(std::vector<uint8_t>& v, uint32_t x, int n) {
    for (int i = n - 1; i >= 0; --i) v.push_back(uint8_t(x >> (8 * i)));
}

void copy_err(const std::string& m, char* err, int err_len) {
    if (err && err_len > 0) std::snprintf(err, size_t(err_len), "%s", m.c_str());
}

}  // namespace

extern "C" {

void* ffv1_decoder_new(const uint8_t* rec, int64_t rec_len, int width, int height, char* err, int err_len) {
    try {
        if (width <= 0 || height <= 0) throw Error{"FFV1: frame size must be positive"};
        auto* d = new Decoder{parse_record(rec, rec_len), width, height, false, {}};
        return d;
    } catch (const Error& e) {
        copy_err(e.msg, err, err_len);
        return nullptr;
    }
}

void ffv1_decoder_free(void* dec) { delete static_cast<Decoder*>(dec); }

int ffv1_decoder_info(void* dec, int* out) {
    const Params& p = static_cast<Decoder*>(dec)->p;
    int vals[9] = {p.version, p.micro, p.coder, p.colorspace, p.bits, p.transparency, p.nh * p.nv, p.ec, p.intra};
    std::memcpy(out, vals, sizeof vals);
    return 0;
}

// Decode one packet into `bgr` [height, width, 3] uint8.
int ffv1_decoder_decode(void* dec, const uint8_t* pkt, int64_t len, uint8_t* bgr, char* err, int err_len) {
    Decoder& d = *static_cast<Decoder*>(dec);
    try {
        const int trailer = 3 + (d.p.ec ? 5 : 0);
        std::vector<std::pair<int64_t, int64_t>> spans;
        int64_t end = len;
        while (end > trailer && spans.size() < MAX_SLICES) {
            const uint8_t* t = pkt + end - trailer;
            int64_t size = (int64_t(t[0]) << 16) | (int64_t(t[1]) << 8) | t[2];
            if (size + trailer > end) throw Error{"FFV1: slice size points before the packet"};
            spans.emplace_back(end - size - trailer, end);
            end -= size + trailer;
        }
        if (end != 0 || spans.empty()) throw Error{"FFV1: the slice sizes do not add up to the packet"};
        std::reverse(spans.begin(), spans.end());
        if (d.p.ec)
            for (auto& sp : spans)
                if (crc32(pkt + sp.first, size_t(sp.second - sp.first)) != 0)
                    throw Error{"FFV1: slice CRC mismatch"};
        if (d.slices.empty()) d.slices.resize(spans.size());
        if (d.slices.size() != spans.size()) throw Error{"FFV1: the number of slices changed"};

        RangeDecoder rc0(pkt, pkt + spans[0].second);
        uint8_t keystate = 128;
        bool key = rc0.get(&keystate);
        if (!key && !d.key_seen) throw Error{"FFV1: a frame between keyframes without its keyframe"};
        if (key) d.key_seen = true;
        std::vector<std::string> errors(spans.size());
        const int n = int(spans.size());
#pragma omp parallel for schedule(dynamic)
        for (int si = 0; si < n; ++si) {
            try {
                const uint8_t* s0 = pkt + spans[size_t(si)].first;
                const uint8_t* s1 = pkt + spans[size_t(si)].second;
                RangeDecoder rc = si ? RangeDecoder(s0, s1) : rc0;
                decode_slice(d, si, rc, key, s1, trailer, bgr);
            } catch (const Error& e) {
                errors[size_t(si)] = e.msg;
            }
        }
        for (auto& m : errors)
            if (!m.empty()) throw Error{m};
        return 0;
    } catch (const Error& e) {
        d.key_seen = false;
        copy_err(e.msg, err, err_len);
        return -1;
    }
}

void* ffv1_encoder_new(int width, int height, int nh, int nv) {
    if (width <= 0 || height <= 0 || nh < 1 || nv < 1 || nh > width || nv > height || nh * nv > MAX_SLICES)
        return nullptr;
    auto* e = new Encoder{width, height, nh, nv, {}, 0, {}};
    make_encoder_table(e->qt, e->context_count);
    return e;
}

void ffv1_encoder_free(void* enc) { delete static_cast<Encoder*>(enc); }

// The configuration record (Matroska CodecPrivate) of the encoder's stream.
int64_t ffv1_encoder_record(void* enc, uint8_t* out, int64_t cap) {
    const Encoder& e = *static_cast<Encoder*>(enc);
    std::vector<uint8_t> rec;
    RangeEncoder rc(&rec);
    uint8_t state[CONTEXT_SIZE];
    std::memset(state, 128, sizeof state);
    rc.symbol(state, 3, false);  // version
    rc.symbol(state, 4, false);  // micro version
    rc.symbol(state, 1, false);  // range coder, default state-transition table
    rc.symbol(state, 1, false);  // RGB
    rc.symbol(state, 8, false);  // bits per raw sample
    rc.put(state, 1);            // chroma planes
    rc.symbol(state, 0, false);  // no subsampling
    rc.symbol(state, 0, false);
    rc.put(state, 0);  // no alpha plane
    rc.symbol(state, e.nh - 1, false);
    rc.symbol(state, e.nv - 1, false);
    rc.symbol(state, 1, false);  // one quantisation table set
    for (int i = 0; i < 5; ++i) {
        uint8_t qs[CONTEXT_SIZE];
        std::memset(qs, 128, sizeof qs);
        if (i < 3) {
            for (int v = 0; v < 6; ++v) rc.symbol(qs, ENC_RUNS[v] - 1, false);
        } else {
            rc.symbol(qs, 127, false);
        }
    }
    rc.put(state, 0);            // initial states not coded: all 128
    rc.symbol(state, 1, false);  // slice CRCs
    rc.symbol(state, 1, false);  // intra: every frame a keyframe
    rc.terminate(false);
    put_be(rec, crc32(rec.data(), rec.size()), 4);
    if (int64_t(rec.size()) > cap) return -1;
    std::memcpy(out, rec.data(), rec.size());
    return int64_t(rec.size());
}

// Encode a BGR frame [height, width, 3] uint8 as a keyframe; returns the
// packet size (the bytes are at ffv1_encoder_packet until the next call).
int64_t ffv1_encoder_encode(void* enc, const uint8_t* bgr) {
    Encoder& e = *static_cast<Encoder*>(enc);
    const int n = e.nh * e.nv;
    auto parts = std::vector<std::vector<uint8_t>>(size_t(n));
#pragma omp parallel for schedule(dynamic)
    for (int si = 0; si < n; ++si) {
        const int sx = si % e.nh, sy = si / e.nh;
        SliceGeom g;
        g.x = int(int64_t(sx) * e.width / e.nh);
        g.y = int(int64_t(sy) * e.height / e.nv);
        g.w = int(int64_t(sx + 1) * e.width / e.nh) - g.x;
        g.h = int(int64_t(sy + 1) * e.height / e.nv) - g.y;
        auto& out = parts[size_t(si)];
        out.reserve(size_t(g.w) * g.h * 3);
        RangeEncoder rc(&out);
        if (si == 0) {
            uint8_t keystate = 128;
            rc.put(&keystate, 1);
        }
        encode_slice(e, bgr, g, sx, sy, rc);
        const uint32_t size = uint32_t(out.size());
        put_be(out, size, 3);
        out.push_back(0);  // error status
        put_be(out, crc32(out.data(), out.size()), 4);
    }
    e.packet.clear();
    for (auto& part : parts) e.packet.insert(e.packet.end(), part.begin(), part.end());
    return int64_t(e.packet.size());
}

const uint8_t* ffv1_encoder_packet(void* enc) { return static_cast<Encoder*>(enc)->packet.data(); }

}  // extern "C"
