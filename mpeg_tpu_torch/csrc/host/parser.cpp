// Native MPEG-1 video ES parser: the hot serial half of the decoder.
//
// Fills the same dense "picture plan" arrays as the Python parser
// (mpeg_tpu/video.py), with identical semantics — including the
// junk-tolerance quirks the golden hashes depend on (invalid VLC prefixes
// decode to value 0, persistent blockData scratch with partial clearing,
// plan resets on re-prediction).  The Python parser remains the readable
// oracle; tests/test_native.py checks plan-for-plan equality.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC parser.cpp -o libmpegtpu.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "vlc_tables.h"

namespace {

constexpr int PIC_I = 1, PIC_P = 2, PIC_B = 3;
constexpr int START_PICTURE = 0x00;
constexpr int START_SEQUENCE = 0xB3;
constexpr int START_EXTENSION = 0xB5;
constexpr int START_USER_DATA = 0xB2;

struct CorruptStream {};    // invalid VLC prefix (unreachable prefixes)
struct Truncated {};        // bit read past the end of available data

// Growable POD array with caller-managed capacity checks: the record
// pools append up to 64 records per coded block, so one ensure() per
// block replaces a size/capacity branch per record (std::vector's
// push_back was ~6% of parse).
template <typename T>
struct PodVec {
    T* p = nullptr;
    size_t n = 0, cap = 0;
    PodVec() = default;
    PodVec(const PodVec&) = delete;
    PodVec& operator=(const PodVec&) = delete;
    ~PodVec() { std::free(p); }
    void ensure(size_t extra) {
        if (n + extra > cap) {
            size_t nc = cap ? cap * 2 : 4096;
            while (nc < n + extra) nc *= 2;
            T* np_ = (T*)std::realloc(p, nc * sizeof(T));
            if (np_ == nullptr) throw std::bad_alloc{};
            p = np_;
            cap = nc;
        }
    }
    void push(T v) { p[n++] = v; }   // capacity ensured by the caller
    void clear() { n = 0; }
    T* data() { return p; }
    const T* data() const { return p; }
    size_t size() const { return n; }
};

// ---------------------------------------------------------------------------
// Bit reader over the whole buffered ES (no refill callbacks: the caller
// feeds bytes; parse_picture only runs when a whole picture is buffered
// or the stream has ended — same contract as the Python decode loop).
// ---------------------------------------------------------------------------
struct BitReader {
    const uint8_t* data = nullptr;
    int64_t size = 0;       // bytes
    int64_t bit = 0;        // bit cursor

    bool has(int64_t count) const { return (size << 3) - bit >= count; }

    // One 8-byte big-endian load of the window at the cursor (fast path
    // for read/peek when 8 bytes remain — the overwhelmingly common case
    // in the per-picture VLC loop).
    __attribute__((always_inline)) uint64_t window64(int64_t byte_pos) const {
        uint64_t w;
        std::memcpy(&w, data + byte_pos, 8);
        return __builtin_bswap64(w);
    }

    __attribute__((always_inline)) int read(int count) {
        int64_t byte_pos = bit >> 3;
        if (count <= 24 && byte_pos + 8 <= size) {
            uint64_t w = window64(byte_pos);
            int v = (int)((w >> (64 - (bit & 7) - count)) &
                          ((1u << count) - 1));
            bit += count;
            return v;
        }
        int value = 0;
        while (count) {
            byte_pos = bit >> 3;
            if (byte_pos >= size) throw Truncated{};
            int current = data[byte_pos];
            int remaining = 8 - (int)(bit & 7);
            int n = count < remaining ? count : remaining;
            int shift = remaining - n;
            int mask = 0xFF >> (8 - n);
            value = (value << n) | ((current & (mask << shift)) >> shift);
            bit += n;
            count -= n;
        }
        return value;
    }

    __attribute__((always_inline)) int read1() {
        int64_t byte_pos = bit >> 3;
        if (byte_pos >= size) throw Truncated{};
        int v = (data[byte_pos] >> (7 - (bit & 7))) & 1;
        bit += 1;
        return v;
    }

    // Peek up to 16 bits; bits past the end read as zero.
    __attribute__((always_inline)) int peek16(int count) const {
        int64_t byte_pos = bit >> 3;
        if (byte_pos + 8 <= size) {
            return (int)((window64(byte_pos) >> (64 - (bit & 7) - count)) &
                         ((1u << count) - 1));
        }
        uint32_t w = 0;
        for (int i = 0; i < 3; i++) {
            w <<= 8;
            if (byte_pos + i < size) w |= data[byte_pos + i];
        }
        return (int)((w >> (24 - (bit & 7) - count)) & ((1u << count) - 1));
    }

    void align() { bit = ((bit + 7) >> 3) << 3; }
    void skip(int count) { if (has(count)) bit += count; }

    // Align, then skip consecutive bytes equal to v; returns the count
    // (parity: buffer.go:257-277 — PES stuffing-byte removal).
    int skip_bytes(uint8_t v) {
        align();
        int n = 0;
        while ((bit >> 3) < size && data[bit >> 3] == v) {
            bit += 8;
            n++;
        }
        return n;
    }

    bool peek_non_zero(int count) {
        if (!has(count)) return false;
        int64_t byte_pos = bit >> 3;
        if (count <= 24 && byte_pos + 8 <= size) {
            return ((window64(byte_pos) >> (64 - (bit & 7) - count)) &
                    ((1u << count) - 1)) != 0;
        }
        int64_t save = bit;
        int v = read(count);
        bit = save;
        return v != 0;
    }

    // Next byte-aligned 00 00 01 xx start code; -1 when exhausted.
    // Parity with buffer.go:279-302 (resting position 4 bytes from end).
    // memchr-driven: jump between 0x01 bytes (SIMD) instead of a
    // byte-at-a-time triple compare.
    int next_start_code() {
        align();
        int64_t stop = size - 4;
        int64_t from = (bit >> 3) + 2;
        int64_t limit = stop + 2;   // exclusive bound for the 0x01 byte
        while (from < limit) {
            const uint8_t* hit = (const uint8_t*)std::memchr(
                data + from, 0x01, (size_t)(limit - from));
            if (hit == nullptr) break;
            int64_t m = hit - data;
            if (data[m - 2] == 0x00 && data[m - 1] == 0x00) {
                bit = (m + 2) << 3;
                return data[m + 1];
            }
            from = m + 1;
        }
        if (stop > (bit >> 3)) bit = stop << 3;
        return -1;
    }

    int find_start_code(int code) {
        for (;;) {
            int current = next_start_code();
            if (current == code || current == -1) return current;
        }
    }

    // Peek variant: is there a `code` start code ahead?
    int has_start_code(int code) {
        int64_t save = bit;
        int current = find_start_code(code);
        bit = save;
        return current;
    }

    template <typename T>
    __attribute__((always_inline)) int read_vlc(const T* values,
            const uint8_t* lengths, int bits) {
        int idx = peek16(bits);
        int len = lengths[idx];
        if (len == 0) throw CorruptStream{};
        bit += len;
        return (int)values[idx];
    }

};

// Combined run/level/sign table for the AC loop: for codes of <= 11 bits
// (excluding the escape 0xFFFF and the EOB-ambiguous 0x0001, whose extra
// bit depends on coefficient count), the SIGN bit lives inside the same
// 12-bit window, so one load yields the fully-decoded coefficient:
// entry = bits(8) | run << 8 | signed_level << 16; 0 = fall back to the
// full 16-bit direct table.  4096 x 4 B = 16 KB — L1-resident alongside
// the other VLC tables, and wide enough that the fallback only fires on
// escapes and the rare >= 12-bit codes.  (Every 16-bit completion of a
// <= 12-bit prefix shares the symbol by construction of the direct
// table, so indexing DCT_COEFF_* at prefix << 4 is exact.)
static uint32_t DCT_FAST12[4096];

// Subsequent-coefficient variant (n > 0): the '1'-prefixed family is
// unambiguous there — '10' is EOB and '11s' is run-0/level-±1 (the
// single most frequent AC code) — so both become direct entries
// instead of routing through the type-1 marker's bit-by-bit re-derive.
// EOB is marker type 3 (it must break, so it can't ride the normal
// run/level path; the level field holds signed values, so bit 31 is
// not available as a flag either).
static uint32_t DCT_FAST12_SUB[4096];

// Combined (value << 8 | length) direct table for the FAST12 misses:
// one 256 KB table = one cache access per long-code lookup, instead of
// two (the split LEN + VAL tables cost two L2 misses each).
static uint32_t DCT_COMB16[65536];

static const bool DCT_FAST_INIT = [] {
    for (int i = 0; i < 65536; i++)
        DCT_COMB16[i] = ((uint32_t)DCT_COEFF_VAL[i] << 8) | DCT_COEFF_LEN[i];
    for (int i = 0; i < 4096; i++) {
        int idx = i << 4;
        uint8_t len = DCT_COEFF_LEN[idx];
        DCT_FAST12[i] = 0;
        if (len == 0) { DCT_FAST12_SUB[i] = 0; continue; }
        uint16_t v = DCT_COEFF_VAL[idx];
        if (v == 0x0001 && len + 2 <= 12) {
            // EOB-ambiguous code: marker entry, low byte 0, type 1,
            // prefix length in bits 8..15 (first-coefficient table
            // only — the SUB entries below resolve it directly).
            DCT_FAST12[i] = (1u << 30) | ((uint32_t)len << 8);
            if ((i >> 10) == 2) {
                // '10' = EOB: marker type 3, full length in bits 8..15
                DCT_FAST12_SUB[i] = (3u << 30) | (((uint32_t)len + 1) << 8);
            } else {
                // '11s' = run 0, level +/-1, len + EOB-check bit + sign
                int16_t slevel = (i >> 9) & 1 ? -1 : 1;
                DCT_FAST12_SUB[i] = (uint32_t)(len + 2) |
                                    ((uint32_t)(uint16_t)slevel << 16);
            }
        } else if (v == 0xFFFF) {
            // escape: marker type 2 — run/level read from the window
            DCT_FAST12[i] = (2u << 30) | ((uint32_t)len << 8);
            DCT_FAST12_SUB[i] = DCT_FAST12[i];
        } else if (len + 1 <= 12) {
            int sign = (i >> (11 - len)) & 1;
            int16_t slevel = (int16_t)(v & 0xFF);
            if (sign) slevel = -slevel;
            DCT_FAST12[i] = (uint32_t)(len + 1) |
                            ((uint32_t)(v >> 8) << 8) |
                            ((uint32_t)(uint16_t)slevel << 16);
            DCT_FAST12_SUB[i] = DCT_FAST12[i];
        } else {
            DCT_FAST12_SUB[i] = 0;
        }
    }
    // Init-time proof for the COMB16 fallback's 0x0001/n>0 EOB re-check
    // (decode_block): every EOB-ambiguous '1'-family code must resolve
    // inside the 12-bit tables, so the fallback never sees value
    // 0x0001 and its re-check stays dead insurance.  If a future table
    // regeneration breaks that gating, fail loudly at load instead of
    // silently changing stream semantics.
    for (int i = 0; i < 65536; i++) {
        if (DCT_COEFF_LEN[i] != 0 && DCT_COEFF_VAL[i] == 0x0001 &&
            (DCT_FAST12[i >> 4] == 0 || DCT_FAST12_SUB[i >> 4] == 0)) {
            std::fprintf(stderr, "mpeg_tpu: DCT table init violates the "
                                 "FAST12 0x0001 gating invariant\n");
            std::abort();
        }
    }
    return true;
}();

// ---------------------------------------------------------------------------
// Host-only reconstruction (the C++ CPU fallback, SURVEY §2b N6/N7):
// consumes the same picture plans as the device path and produces frames
// entirely on the CPU.  Integer semantics identical to the device kernels
// (IDCT variants, MPEG rounding MC, clamped stores).
// ---------------------------------------------------------------------------

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One 8-point pass of the integer IDCT butterfly (video.go:801-928).
static inline void idct_pass(const int32_t* in, int stride, int32_t* out,
                             int out_stride, bool sparse, bool final_shift) {
    int32_t b1, b3, b4, tmp1, tmp2, b6, m0, x2;
    if (sparse) {
        b1 = 0;
        b3 = in[2 * stride];
        b4 = -in[3 * stride];
        tmp1 = in[1 * stride];
        tmp2 = in[3 * stride];
        b6 = in[1 * stride];
        x2 = ((in[2 * stride] * 362 + 128) >> 8) - b3;
    } else {
        b1 = in[4 * stride];
        b3 = in[2 * stride] + in[6 * stride];
        b4 = in[5 * stride] - in[3 * stride];
        tmp1 = in[1 * stride] + in[7 * stride];
        tmp2 = in[3 * stride] + in[5 * stride];
        b6 = in[1 * stride] - in[7 * stride];
        x2 = (((in[2 * stride] - in[6 * stride]) * 362 + 128) >> 8) - b3;
    }
    m0 = in[0];
    int32_t b7 = tmp1 + tmp2;
    int32_t x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7;
    int32_t x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8);
    int32_t x1 = m0 - b1;
    int32_t x3 = m0 + b1;
    int32_t y3 = x1 + x2, y4 = x3 + b3, y5 = x1 - x2, y6 = x3 - b3;
    int32_t y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8);
    int32_t o[8] = {b7 + y4, x4 + y3, y5 - x0, y6 - y7,
                    y6 + y7, x0 + y5, y3 - x4, y4 - b7};
    for (int i = 0; i < 8; i++)
        out[i * out_stride] = final_shift ? (o[i] + 128) >> 8 : o[i];
}

// In-place 2-D IDCT with exact variant selection by n.
static void idct_block(int32_t* blk, int n, int32_t* out) {
    if (n == 1) {
        int32_t v = (blk[0] + 128) >> 8;
        for (int i = 0; i < 64; i++) out[i] = v;
        return;
    }
    bool sparse = n < 10;
    int ncols = sparse ? 4 : 8;
    int32_t mid[64] = {0};
    for (int c = 0; c < ncols; c++)
        idct_pass(blk + c, 8, mid + c, 8, sparse, false);
    for (int r = 0; r < 8; r++)
        idct_pass(mid + r * 8, 1, out + r * 8, 1, sparse, true);
}

static inline int trunc_div2(int v) { return v / 2; }   // C++ truncates

// Motion-compensate one plane block over flat frame buffers
// (semantics: video_noasm.go:28-80, flat shared-buffer addressing).
static void mc_block(const uint8_t* src, uint8_t* dst, int64_t base,
                     int stride, int64_t si, int64_t di, int size,
                     bool odd_h, bool odd_v) {
    src += base;
    dst += base;
    for (int r = 0; r < size; r++) {
        const uint8_t* s0 = src + si + (int64_t)r * stride;
        const uint8_t* s1 = s0 + stride;
        uint8_t* d = dst + di + (int64_t)r * stride;
        if (!odd_h && !odd_v) {
            std::memcpy(d, s0, size);
        } else if (odd_h && !odd_v) {
            for (int x = 0; x < size; x++)
                d[x] = (uint8_t)((s0[x] + s0[x + 1] + 1) >> 1);
        } else if (!odd_h && odd_v) {
            for (int x = 0; x < size; x++)
                d[x] = (uint8_t)((s0[x] + s1[x] + 1) >> 1);
        } else {
            for (int x = 0; x < size; x++)
                d[x] = (uint8_t)((s0[x] + s0[x + 1] + s1[x] + s1[x + 1] + 2)
                                 >> 2);
        }
    }
}

// ---------------------------------------------------------------------------
// Parser state (mirrors mpeg_tpu/video.py field-for-field)
// ---------------------------------------------------------------------------
struct Motion {
    int full_px = 0, r_size = 0, h = 0, v = 0;
    bool is_set = false;
};

struct VideoParser {
    std::vector<uint8_t> buf;
    int64_t base_bit = 0;     // consumed bits compacted away so far
    bool ended = false;

    BitReader br;

    // sequence state
    bool has_seq_header = false;
    int width = 0, height = 0, mb_width = 0, mb_height = 0, mb_size = 0;
    double frame_rate = 0, aspect = 0;
    int bit_rate = 0;
    uint8_t intra_q[64], non_intra_q[64];

    // picture / slice / mb state
    int start_code = -1;
    int picture_type = 0;
    Motion fwd, bwd;
    int quantizer_scale = 0;
    bool slice_begin = false;
    int mb_address = 0, mb_row = 0, mb_col = 0;
    int mb_type = 0;
    bool mb_intra = false;
    int dc_pred[3] = {0, 0, 0};

    // persistent blockData scratch (video.go:101 semantics)
    int32_t block_data[64] = {0};
    // Parallel quotient scratch: block_data[p] == block_quot[p] *
    // PREMULTIPLIER[p] by construction (AC stores level, which the clip
    // bounds to int16; the intra DC stores dc*8 since dc<<8 == (dc*8)*32).
    // Leaks/clears mirror block_data exactly, so the blob encoder never
    // needs a division.
    //
    // Pool mode maintains ONLY block_quot per AC coefficient (nothing
    // there reads the premultiplied value; escapes derive it on the
    // fly) — a dense-plan mode entered afterwards restores the pairing
    // for the occupied slots via sync_scratch_premult(), preserving the
    // reference's cross-block scratch-leak semantics across the switch.
    int32_t block_quot[64] = {0};
    // Occupancy bitmask over the scratch: bit p set <=> block_data[p]/
    // block_quot[p] was written and not yet cleared.  Lets the emit
    // scan and the end-of-block clear walk only the ~popcount occupied
    // slots instead of all 64 (the full scan was the top parse hotspot
    // on sparse film content).  Leak semantics are untouched: an
    // invalid-run early return keeps values AND bits for the next
    // block, exactly like the reference's persistent blockData.
    uint64_t scratch_occ = 0;

    // plan outputs (borrowed numpy buffers, set per parse call)
    int32_t* coeffs = nullptr;     // [mb, 6, 64]
    int32_t* nblocks = nullptr;    // [mb, 6]
    int32_t* intra_blk = nullptr;  // [mb, 6]
    int32_t* src_sel = nullptr;    // [mb]
    int32_t* mv_h = nullptr;       // [mb]
    int32_t* mv_v = nullptr;       // [mb]

    // internal plan storage for direct blob emission
    std::vector<int32_t> own_coeffs, own_quots, own_nblocks, own_intra,
        own_sel, own_mvh, own_mvv;
    // Eagerly-packed per-MB metadata (blob mode): the exact nbcls/misc
    // encoding vp_blob_emit ships, maintained at block-code/predict time
    // so emit copies bytes instead of re-deriving classes from the plan.
    std::vector<uint16_t> own_nbcls;
    std::vector<uint8_t> own_misc;
    std::vector<int32_t> dirty_stamp;   // per-MB generation stamp
    std::vector<int32_t> dirty_mbs;
    int32_t generation = 0;
    int last_ptype = 0;

    // Pool-record tracking (blob transport): records are appended
    // EAGERLY as each block is coded (the quotient scratch is scanned
    // once, while it is hot), so vp_blob_counts is O(1) and vp_blob_emit
    // is a linear segment copy — the v1 full rescan of every dirty MB's
    // 384 coefficients was ~40% of the parse cost, and the v2
    // emit-time per-block rescan + 512 B scratch clears another ~30%.
    // Sequential-rewrite semantics (a re-touched block's latest values
    // win, a re-predicted MB erases its residuals) are kept by marking
    // a block's previous segment dead.
    bool track_pool = false;
    bool plan_pending = false;          // prepared picture awaiting emit
    std::vector<int32_t> coded_stamp;   // per-block generation stamp
    std::vector<int32_t> mb_any_stamp;  // per-MB any-block-coded stamp
    std::vector<int32_t> coded_blocks;  // block ids (mb*6+b) this picture
    // Emit ABI: pool records leave vp_blob_emit in ascending flat-index
    // order (the device scatter is declared indices_are_sorted).  Blocks
    // code in ascending bid on well-formed streams; an out-of-order
    // slice (corrupt stream) clears this and emit sorts coded_blocks.
    bool blocks_monotone = true;
    int32_t last_coded_bid = -1;
    // Records are appended with pool_base (the picture's idx_base, set
    // by the window driver BEFORE prepare) already added, so the common
    // emit is a straight memcpy; emit with a different idx_base adds the
    // delta.  dead_segs counts re-touched/re-predicted segments — when
    // zero and blocks are monotone (every well-formed stream), the
    // record pools ARE the emit stream verbatim.
    int64_t pool_base = 0;
    int32_t dead_segs = 0;
    std::vector<uint16_t> blk_main, blk_esc;
    int64_t pool_main = 0, pool_esc = 0;
    struct RecSeg {
        int32_t bid;
        uint32_t m_start, e_start;
        uint16_t m_len, e_len;
        bool dead;
    };
    std::vector<RecSeg> rec_segs;       // per coded-block record segments
    std::vector<int32_t> seg_of;        // bid -> its live segment index
    PodVec<uint32_t> rec_midx;          // idx = bid * 64 + pos (pic-rel)
    PodVec<int16_t> rec_mval;           // quotient (blob ABI: int16 lane)
    PodVec<uint32_t> rec_eidx;
    PodVec<int32_t> rec_eval;
    // Emit ships uint16 index DELTAS; when every within-picture gap
    // fits 16 bits (tracked eagerly at append: one compare per record)
    // the conversion is a single vectorizable adjacent-difference loop
    // with no hop records except at the picture boundary.  Any
    // out-of-order append (rewrites, corrupt streams) trips the flag
    // via unsigned underflow and emit falls to the exact scalar path.
    bool mgaps_small = true;
    bool midx_any = false;
    uint32_t last_midx = 0;

    // Restore block_data[j] == block_quot[j] * PREMULTIPLIER[j] for the
    // occupied scratch slots.  Pool mode skips the premultiplied stores
    // (nothing reads them there); a dense-plan mode entered afterwards
    // must see the exact leaked scratch the reference would have
    // (video.go:101 cross-block leak semantics).
    void sync_scratch_premult() {
        for (uint64_t occ = scratch_occ; occ; occ &= occ - 1) {
            int j = __builtin_ctzll(occ);
            block_data[j] = block_quot[j] * (int32_t)PREMULTIPLIER[j];
        }
    }

    void mark_dirty(int mb) {
        if (dirty_stamp.empty()) return;   // dense mode: no tracking
        if (mb >= 0 && mb < mb_size && dirty_stamp[mb] != generation) {
            dirty_stamp[mb] = generation;
            dirty_mbs.push_back(mb);
        }
    }

    // Append this block's (main, escape) pool records from the quotient
    // scratch (division-free); a re-touched block's earlier segment is
    // marked dead so only the latest values emit (sequential-rewrite).
    void note_coded_block(int bid) {
        mb_any_stamp[bid / 6] = generation;
        if (coded_stamp[bid] != generation) {
            coded_stamp[bid] = generation;
            coded_blocks.push_back(bid);
            if (bid < last_coded_bid) blocks_monotone = false;
            last_coded_bid = bid;
        } else {
            pool_main -= blk_main[bid];
            pool_esc -= blk_esc[bid];
            int s = seg_of[bid];
            if (s >= 0) {
                rec_segs[s].dead = true;
                seg_of[bid] = -1;
                dead_segs++;
            }
        }
        uint32_t m0 = (uint32_t)rec_midx.size();
        uint32_t e0 = (uint32_t)rec_eidx.size();
        uint32_t base = (uint32_t)(pool_base + (int64_t)bid * 64);
        rec_midx.ensure(64);
        rec_mval.ensure(64);
        rec_eidx.ensure(64);
        rec_eval.ensure(64);
        for (uint64_t occ = scratch_occ; occ; occ &= occ - 1) {
            int j = __builtin_ctzll(occ);
            int32_t q = block_quot[j];
            if (q == 0) continue;   // e.g. a zero intra DC
            if (__builtin_expect(q >= -32768 && q <= 32767, 1)) {
                uint32_t idx = base + (uint32_t)j;
                if (midx_any && idx - last_midx > 0xFFFFu)
                    mgaps_small = false;
                last_midx = idx;
                midx_any = true;
                rec_midx.push(idx);
                rec_mval.push((int16_t)q);
            } else {
                // escape carries the full coefficient (level * premult),
                // derived from the quotient (pool mode does not keep the
                // premultiplied scratch up to date — see block_quot)
                rec_eidx.push(base + (uint32_t)j);
                rec_eval.push(block_quot[j] * (int32_t)PREMULTIPLIER[j]);
            }
        }
        int m = (int)(rec_midx.size() - m0);
        int e = (int)(rec_eidx.size() - e0);
        seg_of[bid] = (int32_t)rec_segs.size();
        rec_segs.push_back({bid, m0, e0, (uint16_t)m, (uint16_t)e, false});
        blk_main[bid] = (uint16_t)m;
        blk_esc[bid] = (uint16_t)e;
        pool_main += m;
        pool_esc += e;
    }

    // A new prediction erases this MB's residual stores (nblocks -> 0),
    // so its blocks no longer emit records.  The common flow codes an
    // MB's blocks only AFTER its prediction, so one per-MB stamp check
    // skips the 6-block sweep for nearly every call.
    void note_predicted(int mb) {
        if (mb_any_stamp[mb] != generation) return;
        for (int b = 0; b < 6; b++) {
            int bid = mb * 6 + b;
            if (coded_stamp[bid] == generation) {
                pool_main -= blk_main[bid];
                pool_esc -= blk_esc[bid];
                blk_main[bid] = 0;
                blk_esc[bid] = 0;
                int s = seg_of[bid];
                if (s >= 0) {
                    rec_segs[s].dead = true;
                    seg_of[bid] = -1;
                    dead_segs++;
                }
            }
        }
    }

    // -- host-only decode state (C++ CPU fallback) --
    std::vector<uint8_t> host_frames[3];
    int hf_cur = 0, hf_fwd = 1, hf_bwd = 2;
    bool host_has_ref = false;
    int host_last_type = 0;
    bool host_flushed = false;

    void ensure_own_plan() {
        if ((int)own_sel.size() != mb_size) {
            own_coeffs.assign((size_t)mb_size * 6 * 64, 0);
            own_quots.assign((size_t)mb_size * 6 * 64, 0);
            own_nblocks.assign((size_t)mb_size * 6, 0);
            own_intra.assign((size_t)mb_size * 6, 0);
            own_sel.assign(mb_size, 0);
            own_mvh.assign(mb_size, 0);
            own_mvv.assign(mb_size, 0);
            dirty_stamp.assign(mb_size, -1);
            coded_stamp.assign((size_t)mb_size * 6, -1);
            mb_any_stamp.assign(mb_size, -1);
            blk_main.assign((size_t)mb_size * 6, 0);
            blk_esc.assign((size_t)mb_size * 6, 0);
            seg_of.assign((size_t)mb_size * 6, -1);
            own_nbcls.assign(mb_size, 0);
            own_misc.assign(mb_size, 0);
        }
    }

    void sync() { br.data = buf.data(); br.size = (int64_t)buf.size(); }

    // Reset to a freshly-constructed parser WITHOUT dropping the
    // allocated plan/record buffers (a new VideoParser re-zeroes ~25 MB
    // of plan arrays at 1080p; looping sources reset instead).
    void reset_stream() {
        buf.clear();
        base_bit = 0;
        ended = false;
        br.bit = 0;
        sync();
        has_seq_header = false;
        start_code = -1;
        picture_type = 0;
        fwd = Motion{};
        bwd = Motion{};
        quantizer_scale = 0;
        slice_begin = false;
        mb_address = mb_row = mb_col = 0;
        mb_type = 0;
        mb_intra = false;
        dc_pred[0] = dc_pred[1] = dc_pred[2] = 0;
        std::memset(block_data, 0, sizeof(block_data));
        std::memset(block_quot, 0, sizeof(block_quot));
        scratch_occ = 0;
        // Restore the all-zero plan invariant for MBs an abandoned
        // (prepared-but-unemitted) picture touched.
        if (!own_sel.empty()) {
            for (int mb : dirty_mbs) {
                std::memset(own_nblocks.data() + (int64_t)mb * 6, 0,
                            6 * sizeof(int32_t));
                std::memset(own_intra.data() + (int64_t)mb * 6, 0,
                            6 * sizeof(int32_t));
                own_sel[mb] = 0;
                own_mvh[mb] = 0;
                own_mvv[mb] = 0;
                own_nbcls[mb] = 0;
                own_misc[mb] = 0;
            }
        }
        dirty_mbs.clear();
        coded_blocks.clear();
        blocks_monotone = true;
        last_coded_bid = -1;
        rec_segs.clear();
        rec_midx.clear();
        rec_mval.clear();
        rec_eidx.clear();
        rec_eval.clear();
        pool_main = pool_esc = 0;
        pool_base = 0;
        dead_segs = 0;
        mgaps_small = true;
        midx_any = false;
        last_midx = 0;
        plan_pending = false;
        last_ptype = 0;
        generation++;   // stale stamps (dirty/coded) become invalid
        for (auto& f : host_frames)
            if (!f.empty()) std::fill(f.begin(), f.end(), 0);
        host_has_ref = false;
        host_last_type = 0;
        host_flushed = false;
        hf_cur = 0;
        hf_fwd = 1;
        hf_bwd = 2;
    }

    void compact() {
        // Amortized: erase the consumed prefix only once it is both
        // sizable and at least as large as the live tail.  Erasing
        // every picture/frame/packet memmoves the whole remaining
        // buffer each time — O(n^2) on large pre-fed sources (measured
        // ~50% of 1080p long-form parse CPU).  This schedule is O(n)
        // total while keeping memory bounded by ~2x the live data.
        int64_t byte_pos = br.bit >> 3;
        int64_t remaining = (int64_t)buf.size() - byte_pos;
        if (byte_pos >= (64 << 10) && byte_pos >= remaining) {
            buf.erase(buf.begin(), buf.begin() + byte_pos);
            br.bit -= byte_pos << 3;
            sync();
        }
    }

    bool decode_sequence_header() {
        if (!br.has(64 + 2 * 64 * 8)) return false;
        width = br.read(12);
        height = br.read(12);
        if (width <= 0 || height <= 0) return false;
        aspect = ASPECT_RATIO[br.read(4)];
        frame_rate = PICTURE_RATE[br.read(4)];
        bit_rate = br.read(18);
        br.skip(1 + 10 + 1);
        if (br.read1()) {
            for (int i = 0; i < 64; i++) intra_q[ZIG_ZAG[i]] = (uint8_t)br.read(8);
        } else {
            std::memcpy(intra_q, INTRA_QUANT_DEFAULT, 64);
        }
        if (br.read1()) {
            for (int i = 0; i < 64; i++) non_intra_q[ZIG_ZAG[i]] = (uint8_t)br.read(8);
        } else {
            std::memset(non_intra_q, 16, 64);
        }
        mb_width = (width + 15) >> 4;
        mb_height = (height + 15) >> 4;
        mb_size = mb_width * mb_height;
        has_seq_header = true;
        return true;
    }

    bool has_header() {
        if (has_seq_header) return true;
        if (start_code != START_SEQUENCE)
            start_code = br.find_start_code(START_SEQUENCE);
        if (start_code == -1) return false;
        return decode_sequence_header();
    }

    int decode_motion_vector(int r_size, int motion) {
        int fscale = 1 << r_size;
        int m_code = br.read_vlc(MOTION_VAL, MOTION_LEN, MOTION_BITS);
        int d;
        if (m_code != 0 && fscale != 1) {
            int r = br.read(r_size);
            d = (((m_code < 0 ? -m_code : m_code) - 1) << r_size) + r + 1;
            if (m_code < 0) d = -d;
        } else {
            d = m_code;
        }
        motion += d;
        if (motion > (fscale << 4) - 1) motion -= fscale << 5;
        else if (motion < -(fscale << 4)) motion += fscale << 5;
        return motion;
    }

    // Both components of one motion vector from a single 64-bit window
    // (11-bit code + <= 6 residual bits, twice = <= 41 bits incl. the
    // byte phase) — one load instead of up to four.
    void decode_motion_pair(Motion& m) {
        int r_size = m.r_size;
        int64_t byte_pos = br.bit >> 3;
        if (byte_pos + 8 > br.size) {   // buffer tail: generic path
            m.h = decode_motion_vector(r_size, m.h);
            m.v = decode_motion_vector(r_size, m.v);
            return;
        }
        uint64_t w = br.window64(byte_pos);
        int off = (int)(br.bit & 7);
        int fscale = 1 << r_size;
        int vals[2] = {m.h, m.v};
        for (int i = 0; i < 2; i++) {
            uint32_t idx = (uint32_t)((w >> (64 - off - MOTION_BITS)) &
                                      ((1u << MOTION_BITS) - 1));
            int len = MOTION_LEN[idx];
            if (len == 0) throw CorruptStream{};
            off += len;
            int m_code = (int)MOTION_VAL[idx];
            int d;
            if (m_code != 0 && fscale != 1) {
                int r = (int)((w >> (64 - off - r_size)) &
                              ((1 << r_size) - 1));
                off += r_size;
                d = (((m_code < 0 ? -m_code : m_code) - 1) << r_size) + r + 1;
                if (m_code < 0) d = -d;
            } else {
                d = m_code;
            }
            int motion = vals[i] + d;
            if (motion > (fscale << 4) - 1) motion -= fscale << 5;
            else if (motion < -(fscale << 4)) motion += fscale << 5;
            vals[i] = motion;
        }
        br.bit = (byte_pos << 3) + off;
        m.h = vals[0];
        m.v = vals[1];
    }

    void decode_motion_vectors() {
        if (fwd.is_set) {
            decode_motion_pair(fwd);
        } else if (picture_type == PIC_P) {
            fwd.h = 0;
            fwd.v = 0;
        }
        if (bwd.is_set) decode_motion_pair(bwd);
    }

    void predict_macroblock() {
        // *2, not <<1: motion vectors go negative (UB pre-C++20).
        int fh = fwd.h, fv = fwd.v;
        if (fwd.full_px) { fh *= 2; fv *= 2; }
        int sel, mh, mv;
        if (picture_type == PIC_B) {
            int bh = bwd.h, bv = bwd.v;
            if (bwd.full_px) { bh *= 2; bv *= 2; }
            if (fwd.is_set && !bwd.is_set) { sel = 1; mh = fh; mv = fv; }
            else { sel = 2; mh = bh; mv = bv; }
        } else {
            sel = 1; mh = fh; mv = fv;
        }
        if (mb_address < 0 || mb_address >= mb_size) return;
        mark_dirty(mb_address);
        src_sel[mb_address] = sel;
        mv_h[mb_address] = mh;
        mv_v[mb_address] = mv;
        // New prediction erases earlier residuals/intra stores of this MB.
        if (track_pool) {
            // Blob mode reads per-MB metadata only through the packed
            // nbcls/misc; the dense nblocks/intra entries this MB may
            // have are cleared by emit's dirty walk (or the reset
            // paths), so the dense erase is skipped here.
            note_predicted(mb_address);
            own_nbcls[mb_address] = 0;
            own_misc[mb_address] = (uint8_t)(sel << 6);
        } else {
            std::memset(nblocks + mb_address * 6, 0, 6 * sizeof(int32_t));
            std::memset(intra_blk + mb_address * 6, 0, 6 * sizeof(int32_t));
        }
    }

    // noinline: with the SUB-table body this function is big enough
    // that 6-way inlining into decode_macroblock loses to the call
    // (interleaved A/B: noinline ahead in 9/11 laps, ~+2-8%; the
    // pre-SUB body measured the other way — re-measure if it changes).
    __attribute__((noinline)) void decode_block(int block) {
        int n = 0;
        const uint8_t* quant;

        if (mb_intra) {
            int plane_index = block > 3 ? block - 3 : 0;
            int predictor = dc_pred[plane_index];
            int dct_size = plane_index == 0
                ? br.read_vlc(DC_SIZE_L_VAL, DC_SIZE_L_LEN, DC_SIZE_L_BITS)
                : br.read_vlc(DC_SIZE_C_VAL, DC_SIZE_C_LEN, DC_SIZE_C_BITS);
            if (dct_size > 0) {
                int differential = br.read(dct_size);
                if (differential & (1 << (dct_size - 1)))
                    block_data[0] = predictor + differential;
                else
                    block_data[0] = predictor +
                        ((int)(~0u << dct_size) | (differential + 1));
            } else {
                block_data[0] = predictor;
            }
            dc_pred[plane_index] = block_data[0];
            block_quot[0] = block_data[0] * 8;
            scratch_occ |= 1;
            // *256, not <<(3+5): the junk-stream DC can be negative, and
            // Go's shift semantics are multiplication (video.go:668).
            block_data[0] *= 1 << (3 + 5);
            quant = intra_q;
            n = 1;
        } else {
            quant = non_intra_q;
        }

        for (;;) {
            int run, level;
            // Fast lane: one 64-bit window load serves the whole
            // iteration — codes of <= 11 bits with the sign bit in the
            // same 12-bit view decode in one table hit (the bulk of
            // real ACs); longer codes fall through to the 16-bit direct
            // table with EOB/sign bits read from the SAME window.
            int64_t byte_pos = br.bit >> 3;
            if (byte_pos + 8 <= br.size) {
                uint64_t w = br.window64(byte_pos);
                int sh = (int)(br.bit & 7);
                // n == 0 only on a non-intra block's first coefficient:
                // there the '1'-prefix family is unambiguous run-0/
                // level-1 (type-1 marker, no EOB bit); every later
                // iteration uses the SUB table whose '10'/'11s' entries
                // are direct (EOB = marker type 3).
                uint32_t f = (n ? DCT_FAST12_SUB
                                : DCT_FAST12)[(w >> (52 - sh)) & 0xFFF];
                if (f & 0xFF) {
                    br.bit += f & 0xFF;
                    run = (int)((f >> 8) & 0xFF);
                    level = (int16_t)(f >> 16);
                } else if (f) {
                    // Marker entries: the EOB-ambiguous 0x0001 family
                    // (type 1, first-coefficient table only), the
                    // escape (type 2), and EOB (type 3, SUB table),
                    // all decoded from the SAME window — no second
                    // table load.
                    int len = (int)((f >> 8) & 0xFF);
                    int off = sh + len;
                    if ((f >> 30) == 3) {
                        br.bit += len;
                        break;   // EOB
                    }
                    if ((f >> 30) == 1) {
                        br.bit += len;
                        // n == 0 here (the SUB table has no type-1
                        // entries): '1 s' — sign follows the prefix.
                        int s = (int)((w >> (63 - off)) & 1);
                        br.bit += 1;
                        run = 0;
                        level = s ? -1 : 1;
                    } else {
                        // escape: run(6), level(8), extension byte for
                        // 0/128; max 7 + 6 + 6 + 8 + 8 = 35 bits of w.
                        run = (int)((w >> (58 - off)) & 0x3F);
                        level = (int)((w >> (50 - off)) & 0xFF);
                        off += 14;
                        if (level == 0) {
                            level = (int)((w >> (56 - off)) & 0xFF);
                            off += 8;
                        } else if (level == 128) {
                            level = (int)((w >> (56 - off)) & 0xFF) - 256;
                            off += 8;
                        } else if (level > 128) {
                            level -= 256;
                        }
                        br.bit = (byte_pos << 3) + off;
                    }
                } else {
                    uint32_t idx = (uint32_t)((w >> (48 - sh)) & 0xFFFF);
                    uint32_t vl = DCT_COMB16[idx];
                    int len = (int)(vl & 0xFF);
                    if (len == 0) throw CorruptStream{};
                    br.bit += len;
                    int coeff = (int)(vl >> 8);
                    if (coeff == 0x0001 && n > 0) {
                        // (unreachable via the 12-bit view — kept for
                        // exact parity should the marker gating change)
                        int b = (int)((w >> (63 - sh - len)) & 1);
                        br.bit += 1;
                        if (b == 0) break;   // EOB
                    }
                    if (coeff == 0xFFFF) {
                        run = br.read(6);
                        level = br.read(8);
                        if (level == 0) level = br.read(8);
                        else if (level == 128) level = br.read(8) - 256;
                        else if (level > 128) level -= 256;
                    } else {
                        run = coeff >> 8;
                        level = coeff & 0xFF;
                        // sign: next bit, still inside the window
                        // (<= 7 + 16 + 1 + 1 bits consumed of 64)
                        int off = (int)(br.bit - (byte_pos << 3));
                        br.bit += 1;
                        if ((w >> (63 - off)) & 1) level = -level;
                    }
                }
            } else {
                // Tail of the buffer: generic bit-serial path.
                int coeff = (int)(uint16_t)br.read_vlc(
                    DCT_COEFF_VAL, DCT_COEFF_LEN, 16);
                if (coeff == 0x0001 && n > 0 && br.read1() == 0)
                    break;   // EOB
                if (coeff == 0xFFFF) {
                    run = br.read(6);
                    level = br.read(8);
                    if (level == 0) level = br.read(8);
                    else if (level == 128) level = br.read(8) - 256;
                    else if (level > 128) level -= 256;
                } else {
                    run = coeff >> 8;
                    level = coeff & 0xFF;
                    if (br.read1()) level = -level;
                }
            }

            n += run;
            if (n < 0 || n >= 64) return;   // invalid: no store, no clear
            int pos = ZIG_ZAG[n] & 63;
            n++;

            // Branchless dequant chain (the sign-dependent branches here
            // are data-random and mispredict heavily on grainy content).
            level *= 2;   // not <<: level may be negative (UB pre-C++20)
            if (!mb_intra) level += (level >> 31) | 1;   // +1 / -1 (0 -> +1)
            level = (level * quantizer_scale * quant[pos]) >> 4;
            // oddify toward zero when even (+1 for level <= 0, -1 for > 0)
            level += ((level & 1) ^ 1) * (1 - 2 * (int)(level > 0));
            level = level > 2047 ? 2047 : (level < -2048 ? -2048 : level);

            block_quot[pos] = level;
            // Pool mode never reads the premultiplied scratch (records
            // carry the quotient; the device premultiplies at densify) —
            // skipping the store/mul here is ~2 of the ~30 cycles each
            // AC coefficient costs.  sync_scratch_premult() restores the
            // pairing if a dense-plan mode follows.
            if (!track_pool) block_data[pos] = level * PREMULTIPLIER[pos];
            scratch_occ |= 1ull << pos;
        }

        if (mb_address >= 0 && mb_address < mb_size) {
            mark_dirty(mb_address);
            if (track_pool) {
                // Blob mode reads coefficients only through the eager
                // record segments, and per-MB metadata only through the
                // eager nbcls/misc packing — the dense plan stores are
                // skipped entirely (nothing reads them in this mode).
                note_coded_block(mb_address * 6 + block);
                int cls = n == 1 ? 1 : (n < 10 ? 2 : 3);
                int sh2 = 2 * block;
                own_nbcls[mb_address] = (uint16_t)(
                    (own_nbcls[mb_address] & ~(3 << sh2)) | (cls << sh2));
                if (mb_intra) own_misc[mb_address] |= (uint8_t)(1 << block);
                else own_misc[mb_address] &= (uint8_t)~(1 << block);
            } else {
                std::memcpy(coeffs + ((int64_t)mb_address * 6 + block) * 64,
                            block_data, 64 * sizeof(int32_t));
                nblocks[mb_address * 6 + block] = n;
                intra_blk[mb_address * 6 + block] = mb_intra ? 1 : 0;
            }
        }
        // Partial clear exactly like the reference (video.go:777,790-796):
        // DC-only blocks clear slot 0 only (earlier leaks persist); full
        // blocks clear everything -- walking the occupied bits writes
        // the same zeros the memsets did.
        if (n == 1) {
            block_data[0] = 0;
            block_quot[0] = 0;
            scratch_occ &= ~1ull;
        } else {
            for (uint64_t occ = scratch_occ; occ; occ &= occ - 1) {
                int j = __builtin_ctzll(occ);
                block_data[j] = 0;
                block_quot[j] = 0;
            }
            scratch_occ = 0;
        }
    }

    void decode_macroblock() {
        int increment = 0;
        // Shared-window fast path: the address-increment VLC, the
        // macroblock-type VLC and the optional 5-bit quantizer all fit
        // one 64-bit load (<= 11 + 6 + 5 bits + 7 phase).  Stuffing/
        // escape codes (34/35), buffer tails and anything odd fall back
        // to the generic bit-serial reads with nothing consumed.
        int64_t byte_pos = br.bit >> 3;
        uint64_t w = 0;
        int off = -1;               // >= 0 while the fast window is live
        int t;
        if (byte_pos + 8 <= br.size) {
            w = br.window64(byte_pos);
            int o = (int)(br.bit & 7);
            uint32_t idx = (uint32_t)((w >> (64 - o - MB_ADDR_INC_BITS)) &
                                      ((1u << MB_ADDR_INC_BITS) - 1));
            int len = MB_ADDR_INC_LEN[idx];
            if (len == 0) throw CorruptStream{};
            int v = (int)MB_ADDR_INC_VAL[idx];
            if (v < 34) {
                off = o + len;
                br.bit = (byte_pos << 3) + off;
                t = v;
            }
        }
        if (off < 0) {
            t = br.read_vlc(MB_ADDR_INC_VAL, MB_ADDR_INC_LEN, MB_ADDR_INC_BITS);
            while (t == 34) t = br.read_vlc(MB_ADDR_INC_VAL, MB_ADDR_INC_LEN, MB_ADDR_INC_BITS);
            while (t == 35) {
                increment += 33;
                t = br.read_vlc(MB_ADDR_INC_VAL, MB_ADDR_INC_LEN, MB_ADDR_INC_BITS);
            }
        }
        increment += t;

        if (slice_begin) {
            slice_begin = false;
            mb_address += increment;
        } else {
            if (mb_address + increment >= mb_size) return;
            if (increment > 1) {
                dc_pred[0] = dc_pred[1] = dc_pred[2] = 128;
                if (picture_type == PIC_P) { fwd.h = 0; fwd.v = 0; }
            }
            while (increment > 1) {
                mb_address++;
                mb_row = mb_address / mb_width;
                mb_col = mb_address % mb_width;
                predict_macroblock();
                increment--;
            }
            mb_address++;
        }

        // Go-style truncated division/modulo (mb_address may be negative
        // with junk streams; C++ '/' and '%' truncate toward zero like Go).
        mb_row = mb_address / mb_width;
        mb_col = mb_address % mb_width;
        if (mb_col >= mb_width || mb_row >= mb_height) return;

        if (off >= 0) {
            // Same window (off <= 7 + 11 here; + 6 + 5 stays < 64).
            const int16_t* tv;
            const uint8_t* tl;
            int tb;
            switch (picture_type) {
                case PIC_I: tv = MB_TYPE_I_VAL; tl = MB_TYPE_I_LEN;
                            tb = MB_TYPE_I_BITS; break;
                case PIC_P: tv = MB_TYPE_P_VAL; tl = MB_TYPE_P_LEN;
                            tb = MB_TYPE_P_BITS; break;
                default:    tv = MB_TYPE_B_VAL; tl = MB_TYPE_B_LEN;
                            tb = MB_TYPE_B_BITS; break;
            }
            uint32_t idx = (uint32_t)((w >> (64 - off - tb)) &
                                      ((1u << tb) - 1));
            int len = tl[idx];
            if (len == 0) throw CorruptStream{};
            mb_type = (int)tv[idx];
            off += len;
            if (mb_type & 0x10) {
                quantizer_scale = (int)((w >> (64 - off - 5)) & 31);
                off += 5;
            }
            br.bit = (byte_pos << 3) + off;
        } else {
            switch (picture_type) {
                case PIC_I: mb_type = br.read_vlc(MB_TYPE_I_VAL, MB_TYPE_I_LEN, MB_TYPE_I_BITS); break;
                case PIC_P: mb_type = br.read_vlc(MB_TYPE_P_VAL, MB_TYPE_P_LEN, MB_TYPE_P_BITS); break;
                default:    mb_type = br.read_vlc(MB_TYPE_B_VAL, MB_TYPE_B_LEN, MB_TYPE_B_BITS); break;
            }
            if (mb_type & 0x10) quantizer_scale = br.read(5);
        }
        mb_intra = (mb_type & 0x01) != 0;
        fwd.is_set = (mb_type & 0x08) != 0;
        bwd.is_set = (mb_type & 0x04) != 0;

        if (mb_intra) {
            bwd.h = fwd.h = 0;
            bwd.v = fwd.v = 0;
        } else {
            dc_pred[0] = dc_pred[1] = dc_pred[2] = 128;
            decode_motion_vectors();
            predict_macroblock();
        }

        int cbp = 0;
        if (mb_type & 0x02)
            cbp = br.read_vlc(CBP_VAL, CBP_LEN, CBP_BITS);
        else if (mb_intra)
            cbp = 0x3F;

        for (int block = 0, mask = 0x20; block < 6; block++, mask >>= 1)
            if (cbp & mask) decode_block(block);
    }

    void decode_slice(int slice) {
        slice_begin = true;
        mb_address = (slice - 1) * mb_width - 1;
        bwd.h = fwd.h = 0;
        bwd.v = fwd.v = 0;
        dc_pred[0] = dc_pred[1] = dc_pred[2] = 128;
        quantizer_scale = br.read(5);
        while (br.read1() != 0) br.skip(8);

        for (;;) {
            decode_macroblock();
            if (mb_address >= mb_size - 1 || !br.peek_non_zero(23)) break;
        }
    }

    // Parse one picture; plan arrays are pre-zeroed by the caller.
    // Returns picture_type (may be an ignored D/invalid type with no plan).
    bool decode_picture() {
        br.skip(10);
        picture_type = br.read(3);
        br.skip(16);

        if (picture_type <= 0 || picture_type > PIC_B) return false;

        if (picture_type == PIC_P || picture_type == PIC_B) {
            fwd.full_px = br.read1();
            int f_code = br.read(3);
            if (f_code == 0) return false;
            fwd.r_size = f_code - 1;
        }
        if (picture_type == PIC_B) {
            bwd.full_px = br.read1();
            int f_code = br.read(3);
            if (f_code == 0) return false;
            bwd.r_size = f_code - 1;
        }

        for (;;) {
            start_code = br.next_start_code();
            if (start_code != START_EXTENSION && start_code != START_USER_DATA)
                break;
        }

        while (start_code >= 0x01 && start_code <= 0xAF) {
            try {
                decode_slice(start_code & 0xFF);
            } catch (const CorruptStream&) {
                break;
            } catch (const Truncated&) {
                break;
            }
            if (mb_address >= mb_size - 2) break;
            start_code = br.next_start_code();
        }
        return true;
    }

    // -- host-only reconstruction over the internal plan --

    int64_t luma_w() const { return (int64_t)mb_width << 4; }
    int64_t total_size() const {
        int64_t lw = luma_w(), lh = (int64_t)mb_height << 4;
        return lw * lh + 2 * (lw / 2) * (lh / 2) + lw * 16;
    }

    void ensure_host_frames() {
        if (host_frames[0].empty())
            for (auto& f : host_frames) f.assign(total_size(), 0);
    }

    void host_reconstruct() {
        const int64_t lw = luma_w(), lh = (int64_t)mb_height << 4;
        const int64_t cw = lw / 2;
        const int64_t luma_size = lw * lh, chroma_size = cw * (lh / 2);
        const int64_t total = total_size();
        const bool is_ref = picture_type == PIC_I || picture_type == PIC_P;

        uint8_t* cur = host_frames[hf_cur].data();
        // Reference pictures alias forward=backward before the slices.
        const uint8_t* fwd =
            host_frames[is_ref ? hf_bwd : hf_fwd].data();
        const uint8_t* bwd = host_frames[hf_bwd].data();

        for (int mb : dirty_mbs) {
            int mb_r = mb / mb_width, mb_c = mb % mb_width;
            int sel = own_sel[mb];
            if (sel > 0) {
                const uint8_t* src = sel == 2 ? bwd : fwd;
                int mh = own_mvh[mb], mv = own_mvv[mb];
                int hp = mh >> 1, vp = mv >> 1;
                int64_t lsi = ((int64_t)(mb_r << 4) + vp) * lw +
                    (mb_c << 4) + hp;
                int64_t ldi = (int64_t)(mb_r << 4) * lw + (mb_c << 4);
                if (lsi >= 0 && lsi + 16 * lw + 17 <= total)
                    mc_block(src, cur, 0, (int)lw, lsi, ldi, 16,
                             mh & 1, mv & 1);
                int cm_h = trunc_div2(mh), cm_v = trunc_div2(mv);
                int chp = cm_h >> 1, cvp = cm_v >> 1;
                int64_t csi = ((int64_t)(mb_r << 3) + cvp) * cw +
                    (mb_c << 3) + chp;
                int64_t cdi = (int64_t)(mb_r << 3) * cw + (mb_c << 3);
                if (csi >= 0 &&
                    luma_size + chroma_size + csi + 8 * cw + 9 <= total) {
                    mc_block(src, cur, luma_size, (int)cw, csi, cdi, 8,
                             cm_h & 1, cm_v & 1);
                    mc_block(src, cur, luma_size + chroma_size, (int)cw,
                             csi, cdi, 8, cm_h & 1, cm_v & 1);
                }
            }

            for (int b = 0; b < 6; b++) {
                int n = own_nblocks[mb * 6 + b];
                if (n == 0) continue;
                int32_t out[64];
                idct_block(own_coeffs.data() + ((int64_t)mb * 6 + b) * 64,
                           n, out);

                uint8_t* d;
                int64_t di;
                int scan;
                if (b < 4) {
                    d = cur;
                    di = ((int64_t)mb_r * lw + mb_c) << 4;
                    scan = (int)lw - 8;
                    if (b & 1) di += 8;
                    if (b & 2) di += lw << 3;
                } else {
                    d = cur + luma_size + (b == 5 ? chroma_size : 0);
                    di = (((int64_t)mb_r * lw) << 2) + (mb_c << 3);
                    scan = (int)(lw >> 1) - 8;
                }
                bool intra = own_intra[mb * 6 + b] != 0;
                for (int r = 0; r < 8; r++) {
                    for (int x = 0; x < 8; x++) {
                        int v = out[r * 8 + x];
                        d[di + x] = intra ? clamp255(v)
                            : clamp255((int)d[di + x] + v);
                    }
                    di += scan + 8;
                }
            }

            // clear the plan entry (consumed)
            std::memset(own_coeffs.data() + (int64_t)mb * 6 * 64, 0,
                        6 * 64 * sizeof(int32_t));
            std::memset(own_quots.data() + (int64_t)mb * 6 * 64, 0,
                        6 * 64 * sizeof(int32_t));
            std::memset(own_nblocks.data() + mb * 6, 0, 6 * sizeof(int32_t));
            std::memset(own_intra.data() + mb * 6, 0, 6 * sizeof(int32_t));
            own_sel[mb] = 0;
            own_mvh[mb] = 0;
            own_mvv[mb] = 0;
        }
        dirty_mbs.clear();
        generation++;
    }

    // Host decode loop: parse + reconstruct until a display frame is due.
    // Returns 1 with the frame copied into `out`, 0 at end of data.
    int host_decode(uint8_t* out) {
        sync();
        if (!has_header()) return 0;
        ensure_host_frames();
        ensure_own_plan();
        if (track_pool) sync_scratch_premult();
        track_pool = false;
        coeffs = own_coeffs.data();
        nblocks = own_nblocks.data();
        intra_blk = own_intra.data();
        src_sel = own_sel.data();
        mv_h = own_mvh.data();
        mv_v = own_mvv.data();

        for (;;) {
            int ptype;
            try {
                ptype = parse_picture();
            } catch (const Truncated&) {
                ptype = 0;
            } catch (const CorruptStream&) {
                ptype = 0;
            }
            if (ptype == 0) {
                // EOF flush of the pending reference frame.
                if (host_has_ref && ended && !host_flushed &&
                    host_last_type != PIC_B) {
                    host_flushed = true;
                    host_has_ref = false;
                    std::memcpy(out, host_frames[hf_bwd].data(),
                                total_size());
                    return 1;
                }
                return 0;
            }

            host_reconstruct();
            host_last_type = ptype;
            bool is_ref = ptype == PIC_I || ptype == PIC_P;
            int disp = is_ref ? hf_bwd : hf_cur;   // pre-rotation backward
            if (is_ref) {
                int new_bwd = hf_cur, new_cur = hf_fwd, new_fwd = hf_bwd;
                hf_cur = new_cur;
                hf_fwd = new_fwd;
                hf_bwd = new_bwd;
                // display = OLD backward = current hf_fwd after rotation
                disp = hf_fwd;
            }
            if (ptype == PIC_B) {
                std::memcpy(out, host_frames[hf_cur].data(), total_size());
                return 1;
            }
            if (host_has_ref) {
                std::memcpy(out, host_frames[disp].data(), total_size());
                return 1;
            }
            host_has_ref = true;
        }
    }

    // parse_next_plan equivalent: returns picture_type >= 1 when a plan
    // was produced, 0 when more data is needed / stream exhausted.
    int parse_picture() {
        sync();
        if (!has_header()) return 0;
        for (;;) {
            if (start_code != START_PICTURE) {
                start_code = br.find_start_code(START_PICTURE);
                if (start_code == -1) return 0;
            }
            // When the stream has ended, the whole-picture-buffered
            // check is moot — skip the lookahead scan (it re-scans to
            // the NEXT picture header, ~a picture's bytes, per call).
            if (!ended && br.has_start_code(START_PICTURE) == -1) return 0;
            compact();
            if (decode_picture()) return picture_type;
            // D-frame / invalid: keep scanning.
        }
    }
};

// ---------------------------------------------------------------------------
// MP2 audio parser (mirrors mpeg_tpu/audio.py field-for-field); emits the
// dequantized subband samples int32[36][2][32] per frame — the device
// filterbank consumes them.
// ---------------------------------------------------------------------------
struct AudioParser {
    std::vector<uint8_t> buf;
    bool ended = false;
    BitReader br;

    int samplerate_index = 3, bitrate_index = 0;
    int version = 0, layer = 0, mode = 0, channels = 0, bound = 0;
    int next_frame_size = 0;
    bool has_header_flag = false;

    const int (*allocation[2][32])[3];   // pointers into QUANT_TAB rows
    int scale_factor_info[2][32] = {};
    int scale_factor[2][32][3] = {};
    int sample[2][32][3] = {};

    void sync() { br.data = buf.data(); br.size = (int64_t)buf.size(); }

    void compact() {
        // Amortized: erase the consumed prefix only once it is both
        // sizable and at least as large as the live tail.  Erasing
        // every picture/frame/packet memmoves the whole remaining
        // buffer each time — O(n^2) on large pre-fed sources (measured
        // ~50% of 1080p long-form parse CPU).  This schedule is O(n)
        // total while keeping memory bounded by ~2x the live data.
        int64_t byte_pos = br.bit >> 3;
        int64_t remaining = (int64_t)buf.size() - byte_pos;
        if (byte_pos >= (64 << 10) && byte_pos >= remaining) {
            buf.erase(buf.begin(), buf.begin() + byte_pos);
            br.bit -= byte_pos << 3;
            sync();
        }
    }

    bool find_frame_sync() {
        // parity: buffer.go:326-339
        int64_t i = br.bit >> 3;
        for (; i < br.size - 1; i++) {
            if (br.data[i] == 0xFF && (br.data[i + 1] & 0xFE) == 0xFC) {
                br.bit = ((i + 1) << 3) + 3;
                return true;
            }
        }
        br.bit = (i + 1) << 3;
        return false;
    }

    int skip_zero_bytes() {
        br.align();
        while (br.has(8) && br.data[br.bit >> 3] == 0x00) br.bit += 8;
        return 0;
    }

    // Returns frame payload size in bytes; 0 when invalid/unavailable.
    int decode_header() {
        if (!br.has(48)) return 0;
        skip_zero_bytes();
        if (!br.has(48)) return 0;
        int sync_bits = br.read(11);
        if (sync_bits != 0x7FF && !find_frame_sync()) return 0;

        version = br.read(2);
        layer = br.read(2);
        bool has_crc = br.read1() == 0;
        if (version != 0x3 || layer != 0x2) return 0;   // MPEG-1 Layer II

        int bi = br.read(4) - 1;
        if (bi > 13 || bi < 0) return 0;
        int si = br.read(2);
        if (si == 3) return 0;
        int padding = br.read1();
        br.skip(1);
        int md = br.read(2);

        if (has_header_flag && (bitrate_index != bi ||
                                samplerate_index != si || mode != md))
            return 0;

        bitrate_index = bi;
        samplerate_index = si;
        mode = md;
        has_header_flag = true;
        // Parity quirk (audio.go:237-241): dual-channel (0x2) leaves
        // the channel count untouched; decode still runs 2 channels.
        if (md == 0x0 || md == 0x1) channels = 2;
        else if (md == 0x3) channels = 1;

        if (md == 0x1) {                       // joint stereo
            bound = (br.read(2) + 1) << 2;
        } else {
            br.skip(2);
            bound = (md == 0x3) ? 0 : 32;
        }
        br.skip(4);
        if (has_crc) br.skip(16);

        int frame_size = (144000 * BIT_RATE[bitrate_index]) /
            SAMPLE_RATE[samplerate_index] + padding;
        return frame_size - (has_crc ? 6 : 4);
    }

    const int (*read_allocation(int sb, int tab3))[3] {
        int tab4 = QUANT_LUT_STEP_3[tab3][sb];
        int qtab = QUANT_LUT_STEP_4[tab4 & 15][br.read(tab4 >> 4)];
        return qtab != 0 ? &QUANT_TAB[qtab - 1] : nullptr;
    }

    void read_samples(int ch, int sb, int part) {
        auto q = allocation[ch][sb];
        int sf = scale_factor[ch][sb][part];
        int* s = sample[ch][sb];
        if (q == nullptr) { s[0] = s[1] = s[2] = 0; return; }

        if (sf == 63) {
            sf = 0;
        } else {
            int shift = sf / 3;
            sf = (SCALEFACTOR_BASE[sf % 3] + ((1 << shift) >> 1)) >> shift;
        }

        int levels = (*q)[0], group = (*q)[1], bits = (*q)[2];
        int adj = levels;
        if (group != 0) {
            int val = br.read(bits);
            s[0] = val % adj;
            val /= adj;
            s[1] = val % adj;
            s[2] = val / adj;
        } else {
            s[0] = br.read(bits);
            s[1] = br.read(bits);
            s[2] = br.read(bits);
        }

        int scale = 65536 / (adj + 1);
        adj = ((adj + 1) >> 1) - 1;
        for (int i = 0; i < 3; i++) {
            int val = (adj - s[i]) * scale;
            s[i] = (val * (sf >> 12) + ((val * (sf & 4095) + 2048) >> 12)) >> 12;
        }
    }

    // Parse one frame's payload into out[36][2][32] int32.
    void parse_frame(int32_t* out) {
        int tab1 = (mode == 0x3) ? 0 : 1;
        int tab2 = QUANT_LUT_STEP_1[tab1][bitrate_index];
        int tab3 = QUANT_LUT_STEP_2[tab2][samplerate_index];
        int sblimit = tab3 & 63;
        tab3 >>= 6;

        if (bound > sblimit) bound = sblimit;

        for (int sb = 0; sb < bound; sb++) {
            allocation[0][sb] = read_allocation(sb, tab3);
            allocation[1][sb] = read_allocation(sb, tab3);
        }
        for (int sb = bound; sb < sblimit; sb++) {
            allocation[0][sb] = read_allocation(sb, tab3);
            allocation[1][sb] = allocation[0][sb];
        }

        int nch = (mode == 0x3) ? 1 : 2;
        for (int sb = 0; sb < sblimit; sb++) {
            for (int ch = 0; ch < nch; ch++)
                if (allocation[ch][sb]) scale_factor_info[ch][sb] = br.read(2);
            if (mode == 0x3) scale_factor_info[1][sb] = scale_factor_info[0][sb];
        }

        for (int sb = 0; sb < sblimit; sb++) {
            for (int ch = 0; ch < nch; ch++) {
                if (allocation[ch][sb]) {
                    int* sf = scale_factor[ch][sb];
                    switch (scale_factor_info[ch][sb]) {
                        case 0:
                            sf[0] = br.read(6); sf[1] = br.read(6); sf[2] = br.read(6);
                            break;
                        case 1:
                            sf[0] = sf[1] = br.read(6); sf[2] = br.read(6);
                            break;
                        case 2:
                            sf[0] = sf[1] = sf[2] = br.read(6);
                            break;
                        default:
                            sf[0] = br.read(6); sf[1] = sf[2] = br.read(6);
                            break;
                    }
                }
            }
            if (mode == 0x3)
                for (int i = 0; i < 3; i++)
                    scale_factor[1][sb][i] = scale_factor[0][sb][i];
        }

        int step = 0;
        for (int part = 0; part < 3; part++) {
            for (int granule = 0; granule < 4; granule++) {
                for (int sb = 0; sb < bound; sb++) {
                    read_samples(0, sb, part);
                    read_samples(1, sb, part);
                }
                for (int sb = bound; sb < sblimit; sb++) {
                    read_samples(0, sb, part);
                    for (int i = 0; i < 3; i++)
                        sample[1][sb][i] = sample[0][sb][i];
                }
                for (int sb = sblimit; sb < 32; sb++)
                    for (int i = 0; i < 3; i++)
                        sample[0][sb][i] = sample[1][sb][i] = 0;

                for (int p = 0; p < 3; p++) {
                    for (int ch = 0; ch < 2; ch++)
                        for (int sb = 0; sb < 32; sb++)
                            out[((int64_t)step * 2 + ch) * 32 + sb] =
                                sample[ch][sb][p];
                    step++;
                }
            }
        }
        br.align();
    }

    // Returns 1 when a frame was parsed into out, 0 otherwise.
    int parse(int32_t* out) {
        sync();
        if (next_frame_size == 0) next_frame_size = decode_header();
        if (next_frame_size == 0 || !br.has((int64_t)next_frame_size << 3))
            return 0;
        compact();
        parse_frame(out);
        next_frame_size = 0;
        return 1;
    }
};

// ---------------------------------------------------------------------------
// MPEG-PS demuxer (mirrors mpeg_tpu/demux.py packet path field-for-field;
// reference: demux.go:478-584).  The steady-state hot path only — seek /
// start-time / duration estimation stay in the Python demuxer (control
// plane, not per-packet work).  Payloads are zero-copy (offset, length)
// views into the internal buffer, valid until the next decode().
// ---------------------------------------------------------------------------
struct Demuxer {
    std::vector<uint8_t> buf;
    bool ended = false;
    BitReader br;

    int start_code = -1;
    bool has_pack = false, has_sys = false, has_hdrs = false;
    int num_audio = 0, num_video = 0;
    double sys_clock_ref = 0.0;

    int64_t cur_len = 0;      // current packet payload, skipped next call
    int nxt_type = 0;
    int64_t nxt_len = 0;
    double nxt_pts = -1.0;

    // last decoded packet (exposed via the C ABI)
    int pkt_type = 0;
    double pkt_pts = -1.0;
    int64_t pkt_off = 0, pkt_len = 0;

    void sync() { br.data = buf.data(); br.size = (int64_t)buf.size(); }

    void compact() {
        // Amortized: erase the consumed prefix only once it is both
        // sizable and at least as large as the live tail.  Erasing
        // every picture/frame/packet memmoves the whole remaining
        // buffer each time — O(n^2) on large pre-fed sources (measured
        // ~50% of 1080p long-form parse CPU).  This schedule is O(n)
        // total while keeping memory bounded by ~2x the live data.
        int64_t byte_pos = br.bit >> 3;
        int64_t remaining = (int64_t)buf.size() - byte_pos;
        if (byte_pos >= (64 << 10) && byte_pos >= remaining) {
            buf.erase(buf.begin(), buf.begin() + byte_pos);
            br.bit -= byte_pos << 3;
            sync();
        }
    }

    double decode_time() {   // 33-bit 90 kHz clock (demux.go:520-529)
        int64_t clock = (int64_t)br.read(3) << 30;
        br.skip(1);
        clock |= (int64_t)br.read(15) << 15;
        br.skip(1);
        clock |= (int64_t)br.read(15);
        br.skip(1);
        return (double)clock / 90000.0;
    }

    bool has_headers() {     // pack 0xBA + system 0xBB (demux.go:85-138)
        if (has_hdrs) return true;
        if (!has_pack) {
            if (start_code != 0xBA && br.find_start_code(0xBA) == -1)
                return false;
            start_code = 0xBA;
            if (!br.has(64)) return false;
            start_code = -1;
            if (br.read(4) != 0x02) return false;   // MPEG-1 only
            sys_clock_ref = decode_time();
            br.skip(1);
            br.skip(22);   // mux rate * 50
            br.skip(1);
            has_pack = true;
        }
        if (!has_sys) {
            if (start_code != 0xBB && br.find_start_code(0xBB) == -1)
                return false;
            start_code = 0xBB;
            if (!br.has(56)) return false;
            start_code = -1;
            br.skip(16);   // header length
            br.skip(24);   // rate bound
            num_audio = br.read(6);
            br.skip(5);
            num_video = br.read(5);
            has_sys = true;
        }
        has_hdrs = true;
        return true;
    }

    // PES header: length, 0xFF stuffing, P-STD, PTS(+DTS) markers
    // (demux.go:531-568).  Resumable: partially-parsed state survives
    // underflow exactly like the Python demuxer.
    int decode_packet(int typ) {
        if (!br.has(16 << 3)) return 0;
        start_code = -1;
        nxt_type = typ;
        nxt_len = br.read(16);
        nxt_len -= br.skip_bytes(0xFF);
        if (br.read(2) == 0x01) {   // P-STD buffer size
            br.skip(16);
            nxt_len -= 2;
        }
        int marker = br.read(2);
        if (marker == 0x03) {
            nxt_pts = decode_time();
            br.skip(40);   // DTS
            nxt_len -= 10;
        } else if (marker == 0x02) {
            nxt_pts = decode_time();
            nxt_len -= 5;
        } else if (marker == 0x00) {
            nxt_pts = -1.0;
            br.skip(4);
            nxt_len -= 1;
        } else {
            return 0;   // invalid marker; pending state kept (parity)
        }
        return make_packet();
    }

    int make_packet() {
        if (!br.has(nxt_len << 3)) return 0;
        pkt_off = br.bit >> 3;
        pkt_type = nxt_type;
        pkt_pts = nxt_pts;
        pkt_len = nxt_len;
        cur_len = nxt_len;
        nxt_len = 0;
        return 1;
    }

    // Next packet; 1 on success, 0 when more data is needed / stream done
    // (demux.go:473-511).
    int decode() {
        sync();
        if (!has_headers()) return 0;
        if (cur_len != 0) {
            int64_t bits = cur_len << 3;
            if (!br.has(bits)) return 0;
            br.bit += bits;
            cur_len = 0;
        }
        compact();   // previous payload consumed; keep memory bounded
        if (nxt_len != 0) return make_packet();
        if (start_code != -1) return decode_packet(start_code);
        for (;;) {
            start_code = br.next_start_code();
            if (start_code == 0xE0 || start_code == 0xBD ||
                (start_code >= 0xC0 && start_code <= 0xC3))
                return decode_packet(start_code);
            if (start_code == -1) break;
        }
        return 0;
    }

    int decode_catch() {
        try {
            return decode();
        } catch (const Truncated&) {
            return 0;
        }
    }
};

// ---------------------------------------------------------------------------
// Fully-native PS pipeline: Demuxer + both ES parsers in one object, so
// MPEG-class steady-state decode does ZERO per-packet Python work.  The
// pull model mirrors mpeg.go:634-669: when a decoder starves, demux
// packets, routing video payloads to the video parser and selected-audio
// payloads to the audio parser, until one of the requested type lands.
// ---------------------------------------------------------------------------
struct Pipeline {
    Demuxer dmx;
    VideoParser vp;
    AudioParser ap;
    int audio_type = 0xC0;   // PACKET_AUDIO_1 + stream index
    bool es_end_signaled = false;
    bool video_on = true;    // MPEG.set_video_enabled routing gate
    bool audio_on = true;    // MPEG.set_audio_enabled routing gate
    // Audio PTS gate for the native seek protocol (mpeg.go:544-573):
    //  -2 = off (route every selected-audio packet)
    //  -1 = drop all (video-side seek decode in progress)
    // >=0 = drop until a packet with pts > threshold; that packet's PTS
    //       is latched in audio_kept and routing resumes.
    double audio_drop_until = -2.0;
    double audio_kept = -1.0;

    void feed(const uint8_t* data, int64_t n) {
        dmx.buf.insert(dmx.buf.end(), data, data + n);
        dmx.ended = false;
        dmx.sync();
        es_end_signaled = false;
    }

    void route(int typ) {
        const uint8_t* payload = dmx.buf.data() + dmx.pkt_off;
        int64_t n = dmx.pkt_len > 0 ? dmx.pkt_len : 0;
        if (typ == 0xE0) {
            if (!video_on) return;
            vp.buf.insert(vp.buf.end(), payload, payload + n);
            vp.ended = false;
            vp.sync();
        } else if (typ == audio_type) {
            if (!audio_on) return;
            if (audio_drop_until == -1.0) return;
            if (audio_drop_until >= 0.0) {
                // PTS-less packets (-1) are dropped too, exactly like the
                // reference's `packet.pts - startTime > time` test.
                if (!(dmx.pkt_pts > audio_drop_until)) return;
                audio_kept = dmx.pkt_pts;
                audio_drop_until = -2.0;
            }
            ap.buf.insert(ap.buf.end(), payload, payload + n);
            ap.ended = false;
            ap.sync();
        }
        // other audio streams / private packets: dropped
    }

    // Demux until a packet of `want` lands in its parser; false when the
    // demuxer runs dry (more PS bytes needed, or true end of stream).
    bool fill_for(int want) {
        for (;;) {
            if (!dmx.decode_catch()) {
                if (dmx.ended && !es_end_signaled) {
                    es_end_signaled = true;   // leftover ES bytes are final
                    vp.ended = true;
                    ap.ended = true;
                }
                return false;
            }
            route(dmx.pkt_type);
            if (dmx.pkt_type == want) return true;
        }
    }

    bool ensure_video_header() {
        for (;;) {
            vp.sync();
            if (vp.has_header()) return true;
            if (!fill_for(0xE0)) return false;
        }
    }

    bool audio_header_ready() {
        ap.sync();
        if (ap.has_header_flag) return true;
        if (ap.next_frame_size == 0) {
            int64_t save = ap.br.bit;
            try {
                ap.next_frame_size = ap.decode_header();
            } catch (const Truncated&) {
                ap.br.bit = save;
                return false;
            }
        }
        return ap.has_header_flag;
    }

    bool ensure_audio_header() {
        for (;;) {
            if (audio_header_ready()) return true;
            if (!fill_for(audio_type)) return false;
        }
    }
};

}   // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

void* vp_create() { return new VideoParser(); }
void vp_reset(void* p) { ((VideoParser*)p)->reset_stream(); }
void vp_destroy(void* p) { delete (VideoParser*)p; }

void vp_feed(void* p, const uint8_t* data, int64_t n) {
    auto* v = (VideoParser*)p;
    v->buf.insert(v->buf.end(), data, data + n);
    v->ended = false;   // mirrors Buffer.Write clearing hasEnded
    v->sync();
}

void vp_signal_end(void* p) { ((VideoParser*)p)->ended = true; }

// Rewind: clear the stream buffer/position but KEEP the sequence state
// (dimensions, quant matrices) — parity with Video.Rewind
// (video.go:195-201), which seeding a seek target depends on.
// Bytes fed but not yet consumed by the parse position.
int64_t vp_unconsumed(void* p) {
    auto* v = (VideoParser*)p;
    return v->br.size - (v->br.bit >> 3);
}

void vp_rewind(void* p) {
    auto* v = (VideoParser*)p;
    v->buf.clear();
    v->br.bit = 0;
    v->sync();
    v->start_code = -1;
    v->ended = false;
    v->host_has_ref = false;
    v->host_flushed = false;
    v->last_ptype = 0;
    // Discard any prepared-but-unemitted plan: clear touched blocks so
    // stale coefficients cannot leak into post-rewind pictures.
    for (int bid : v->coded_blocks) {
        std::memset(v->own_coeffs.data() + (int64_t)bid * 64, 0,
                    64 * sizeof(int32_t));
        std::memset(v->own_quots.data() + (int64_t)bid * 64, 0,
                    64 * sizeof(int32_t));
    }
    for (int mb : v->dirty_mbs) {
        std::memset(v->own_nblocks.data() + mb * 6, 0, 6 * sizeof(int32_t));
        std::memset(v->own_intra.data() + mb * 6, 0, 6 * sizeof(int32_t));
        v->own_sel[mb] = 0;
        v->own_mvh[mb] = 0;
        v->own_mvv[mb] = 0;
        v->own_nbcls[mb] = 0;
        v->own_misc[mb] = 0;
    }
    v->dirty_mbs.clear();
    v->coded_blocks.clear();
    v->blocks_monotone = true;
    v->last_coded_bid = -1;
    v->rec_segs.clear();
    v->rec_midx.clear();
    v->rec_mval.clear();
    v->rec_eidx.clear();
    v->rec_eval.clear();
    v->pool_main = 0;
    v->pool_esc = 0;
    v->pool_base = 0;
    v->dead_segs = 0;
    v->mgaps_small = true;
    v->midx_any = false;
    v->last_midx = 0;
    v->plan_pending = false;
    v->generation++;
}

int vp_has_header(void* p) {
    auto* v = (VideoParser*)p;
    v->sync();
    return v->has_header() ? 1 : 0;
}

int vp_width(void* p) { return ((VideoParser*)p)->width; }
int vp_height(void* p) { return ((VideoParser*)p)->height; }
double vp_framerate(void* p) { return ((VideoParser*)p)->frame_rate; }

// Two-phase blob parse: prepare parses one picture into internal plan
// storage, tracking (main, escape) pool-record counts as blocks are
// coded, and returns picture_type (0 = need data / end); counts returns
// the two totals; emit writes the picture's pool records (main records
// carry the exact int16 quotient value/premultiplier[pos]; everything
// else escapes as int32) and packed per-MB metadata into caller-sized
// arrays, then clears the internal plan for the next picture.
int vp_parse_blob_prepare(void* p) {
    auto* v = (VideoParser*)p;
    if (v->plan_pending) return v->last_ptype;   // idempotent until emit
    v->sync();
    if (!v->has_header()) return 0;
    v->ensure_own_plan();
    v->track_pool = true;
    v->coeffs = v->own_coeffs.data();
    v->nblocks = v->own_nblocks.data();
    v->intra_blk = v->own_intra.data();
    v->src_sel = v->own_sel.data();
    v->mv_h = v->own_mvh.data();
    v->mv_v = v->own_mvv.data();
    try {
        v->last_ptype = v->parse_picture();
    } catch (const Truncated&) {
        v->last_ptype = 0;
    } catch (const CorruptStream&) {
        v->last_ptype = 0;
    }
    v->plan_pending = v->last_ptype != 0;
    return v->last_ptype;
}

void vp_blob_counts(void* p, int64_t* out) {
    auto* v = (VideoParser*)p;
    out[0] = v->pool_main;
    out[1] = v->pool_esc;
}

// Emit the prepared picture as delta-encoded records.  main/esc arrays
// are sized by the caller from vp_blob_counts PLUS a hop bound of
// (pic_span >> 16) + 2; records leave as uint16 deltas continuing the
// chains at io[0]/io[1] (the device cumsum-decodes nondecreasing
// absolute indices — scatter ABI: indices_are_sorted).  Gaps over
// 0xFFFF emit value-0 HOP records of delta 0xFFFF.  mvh/mvv/nbcls/misc
// point at this picture's metadata slot in the window blob; idx_base is
// picture_index * mb_size * 6 * 64.  io = {prev_m, prev_e (in/out),
// nm_out, ne_out}.  Returns the flags word (bit0 = is_ref, bit1 =
// valid).
int vp_blob_emit(void* p, uint16_t* main_rec,
                 uint16_t* esc_didx, int32_t* esc_val,
                 int16_t* mvh, int16_t* mvv, uint16_t* nbcls, uint8_t* misc,
                 int64_t idx_base, int64_t* io) {
    auto* v = (VideoParser*)p;
    int64_t nm = 0, ne = 0;
    uint32_t prev_m = (uint32_t)io[0], prev_e = (uint32_t)io[1];
    // Records were appended with pool_base already added; emit at a
    // different base adds the delta (pending-picture re-emit, direct
    // blob_emit callers that never set pool_base).
    uint32_t delta = (uint32_t)(idx_base - v->pool_base);
    auto emit_m = [&](uint32_t idx, int16_t val) {
        uint32_t d = idx - prev_m;
        while (d > 0xFFFFu) {
            main_rec[2 * nm] = 0xFFFF;
            main_rec[2 * nm + 1] = 0;
            nm++;
            d -= 0xFFFFu;
        }
        main_rec[2 * nm] = (uint16_t)d;
        main_rec[2 * nm + 1] = (uint16_t)val;
        nm++;
        prev_m = idx;
    };
    auto emit_e = [&](uint32_t idx, int32_t val) {
        uint32_t d = idx - prev_e;
        while (d > 0xFFFFu) {
            esc_didx[ne] = 0xFFFF;
            esc_val[ne] = 0;
            ne++;
            d -= 0xFFFFu;
        }
        esc_didx[ne] = (uint16_t)d;
        esc_val[ne] = val;
        ne++;
        prev_e = idx;
    };
    if (v->blocks_monotone && v->dead_segs == 0) {
        // Well-formed stream: every segment is live, appended in
        // ascending bid order — the pools ARE the emit stream.
        int64_t n = (int64_t)v->rec_midx.size();
        const uint32_t* mi = v->rec_midx.data();
        const int16_t* mv = v->rec_mval.data();
        if (v->mgaps_small && n > 0) {
            // Every within-picture gap fits uint16: one boundary record
            // (hops as needed), then a vectorizable interleaved
            // adjacent-difference + value loop.
            emit_m(mi[0] + delta, mv[0]);
            uint16_t* dd = main_rec + 2 * (nm - 1);
            for (int64_t k = 1; k < n; k++) {
                dd[2 * k] = (uint16_t)(mi[k] - mi[k - 1]);
                dd[2 * k + 1] = (uint16_t)mv[k];
            }
            nm += n - 1;
            prev_m = mi[n - 1] + delta;
        } else {
            for (int64_t k = 0; k < n; k++) emit_m(mi[k] + delta, mv[k]);
        }
        int64_t e = (int64_t)v->rec_eidx.size();
        const uint32_t* ei = v->rec_eidx.data();
        const int32_t* ev = v->rec_eval.data();
        for (int64_t k = 0; k < e; k++) emit_e(ei[k] + delta, ev[k]);
    } else {
        // Corrupt-stream path: emit live segments in ascending-bid order
        // (within a block note_coded_block already scans positions 0..63
        // in order, so per-record deltas stay nonnegative).
        if (!v->blocks_monotone)
            std::sort(v->coded_blocks.begin(), v->coded_blocks.end());
        for (int bid : v->coded_blocks) {
            int si = v->seg_of[bid];
            if (si < 0) continue;   // re-predicted/re-touched: latest only
            const auto& s = v->rec_segs[si];
            const uint32_t* mi = v->rec_midx.data() + s.m_start;
            const int16_t* mv = v->rec_mval.data() + s.m_start;
            for (int k = 0; k < s.m_len; k++) emit_m(mi[k] + delta, mv[k]);
            const uint32_t* ei = v->rec_eidx.data() + s.e_start;
            const int32_t* ev = v->rec_eval.data() + s.e_start;
            for (int k = 0; k < s.e_len; k++) emit_e(ei[k] + delta, ev[k]);
        }
    }
    io[0] = prev_m;
    io[1] = prev_e;
    io[2] = nm;
    io[3] = ne;

    for (int mb : v->dirty_mbs) {
        // Metadata was packed eagerly at code/predict time.  (The dense
        // own_nblocks/own_intra entries need no clearing: blob-mode
        // decode_block never writes them.)
        mvh[mb] = (int16_t)v->own_mvh[mb];
        mvv[mb] = (int16_t)v->own_mvv[mb];
        nbcls[mb] = v->own_nbcls[mb];
        misc[mb] = v->own_misc[mb];
        v->own_nbcls[mb] = 0;
        v->own_misc[mb] = 0;
        v->own_sel[mb] = 0;
        v->own_mvh[mb] = 0;
        v->own_mvv[mb] = 0;
    }
    bool is_ref = v->last_ptype == PIC_I || v->last_ptype == PIC_P;
    v->dirty_mbs.clear();
    v->coded_blocks.clear();
    v->blocks_monotone = true;
    v->last_coded_bid = -1;
    v->rec_segs.clear();     // capacity kept; seg_of entries are stale
    v->rec_midx.clear();     // but gated by coded_stamp != generation
    v->rec_mval.clear();
    v->rec_eidx.clear();
    v->rec_eval.clear();
    v->pool_main = 0;
    v->pool_esc = 0;
    v->dead_segs = 0;
    v->mgaps_small = true;
    v->midx_any = false;
    v->last_midx = 0;
    v->generation++;
    v->plan_pending = false;
    return (is_ref ? 1 : 0) | 2;
}

// Whole-window parse+emit in one call (the per-picture ctypes round
// trips cost more than the parse itself at 1080p).  Fills pictures
// [start_pic, max_pics) with record offsets continuing at (nm0, ne0);
// stops early when the stream runs dry or the pool capacity would
// overflow — the overflowing picture stays prepared (out[2] = its type;
// size it via vp_blob_counts, grow, re-call to continue the window).
// out = {nm, ne, pending_type}; returns pictures emitted this call.
//
// Every byte of the window's fields is written (per-picture metadata is
// zeroed before emit; record tails, unused picture slots, flags and
// types are zeroed at the end), so callers may hand in uninitialized or
// recycled buffers — the zeroing runs here, off the GIL, instead of as
// np.zeros on the Python dispatch thread.
// hw_nm / hw_ne: the caller's promise that [hw_nm, km) of the main pool
// and [hw_ne, ke) of the escape pool ALREADY hold the pad pattern
// (all-zero records: delta 0, value 0 — layout-independent) — true for
// a buffer this function previously filled with the same (max_pics, mb,
// km, ke).  The tail fill then covers only [nm, hw) instead of [nm, km)
// — the full fill is O(pool capacity) per window, not O(live records),
// and dominates the film-content tail where records are sparse.  Pass
// hw = km/ke for a fresh or unknown buffer.
//
// prev_m0 / prev_e0: the delta chains' absolute tails at entry (0 for a
// fresh window; thread out[3]/out[4] back in on growth re-calls).
static int64_t blob_window_impl(
        VideoParser* v, int (*prepare)(void*), void* prepare_arg,
        int64_t start_pic, int64_t max_pics, int64_t km, int64_t ke,
        int64_t nm0, int64_t ne0, int64_t hw_nm, int64_t hw_ne,
        int64_t prev_m0, int64_t prev_e0,
        uint16_t* main_rec,
        uint16_t* esc_didx, int32_t* esc_val,
        int16_t* mvh, int16_t* mvv, uint16_t* nbcls, uint8_t* misc,
        int32_t* flags, int32_t* types, int64_t mb, int64_t* out) {
    int64_t nm = nm0, ne = ne0, w = start_pic;
    int64_t prev_m = prev_m0, prev_e = prev_e0;
    const int64_t pic_span = mb * 6 * 64;
    out[2] = 0;
    while (w < max_pics) {
        // Pre-add this picture's idx_base to the records as they are
        // appended (emit then converts in one pass).  A pending picture
        // keeps the base it was prepared with; emit adds the delta if
        // it differs.
        if (!v->plan_pending) v->pool_base = w * pic_span;
        int t = prepare(prepare_arg);
        if (t == 0) break;
        // Capacity check with a conservative hop bound: this picture's
        // total index gap is at most (base + pic_span) - prev, and one
        // hop covers 0xFFFF of gap (+2 absorbs the 0xFFFF-vs-0x10000
        // rounding).  The Python growth path adds a whole-window slack
        // that dominates this bound, so one growth always suffices.
        int64_t base = w * pic_span;
        int64_t bm = v->pool_main +
            (v->pool_main ? ((base + pic_span - prev_m) >> 16) + 2 : 0);
        int64_t be = v->pool_esc +
            (v->pool_esc ? ((base + pic_span - prev_e) >> 16) + 2 : 0);
        if (nm + bm > km || ne + be > ke) {
            out[2] = t;
            break;
        }
        // vp_blob_emit writes only dirty MBs: clear this picture's
        // metadata slot first so non-dirty MBs read as zeros.
        std::memset(mvh + w * mb, 0, mb * sizeof(int16_t));
        std::memset(mvv + w * mb, 0, mb * sizeof(int16_t));
        std::memset(nbcls + w * mb, 0, mb * sizeof(uint16_t));
        std::memset(misc + w * mb, 0, mb * sizeof(uint8_t));
        int64_t io[4] = {prev_m, prev_e, 0, 0};
        flags[w] = vp_blob_emit(
            v, main_rec + 2 * nm, esc_didx + ne, esc_val + ne,
            mvh + w * mb, mvv + w * mb, nbcls + w * mb, misc + w * mb,
            base, io);
        types[w] = t;
        prev_m = io[0];
        prev_e = io[1];
        nm += io[2];
        ne += io[3];
        w++;
    }
    // Overwrite everything after what this call wrote: record-pool
    // tails (stale deltas/values from a recycled buffer would not be
    // no-ops) and the unemitted picture slots (flags bit1 = 0 ->
    // is_noop).  Pad records are zeros: delta 0 keeps the decoded
    // chain at its final index, value 0 makes the add a no-op.
    int64_t fm = hw_nm < nm ? nm : (hw_nm > km ? km : hw_nm);
    int64_t fe = hw_ne < ne ? ne : (hw_ne > ke ? ke : hw_ne);
    std::memset(main_rec + 2 * nm, 0, (size_t)(fm - nm) * 4);
    std::memset(esc_didx + ne, 0, (fe - ne) * sizeof(uint16_t));
    std::memset(esc_val + ne, 0, (fe - ne) * sizeof(int32_t));
    if (w < max_pics) {
        std::memset(flags + w, 0, (max_pics - w) * sizeof(int32_t));
        std::memset(types + w, 0, (max_pics - w) * sizeof(int32_t));
        std::memset(mvh + w * mb, 0, (max_pics - w) * mb * sizeof(int16_t));
        std::memset(mvv + w * mb, 0, (max_pics - w) * mb * sizeof(int16_t));
        std::memset(nbcls + w * mb, 0,
                    (max_pics - w) * mb * sizeof(uint16_t));
        std::memset(misc + w * mb, 0, (max_pics - w) * mb * sizeof(uint8_t));
    }
    out[0] = nm;
    out[1] = ne;
    out[3] = prev_m;
    out[4] = prev_e;
    return w - start_pic;
}

int64_t vp_blob_window(void* p, int64_t start_pic, int64_t max_pics,
                       int64_t km, int64_t ke, int64_t nm0, int64_t ne0,
                       int64_t hw_nm, int64_t hw_ne,
                       int64_t prev_m0, int64_t prev_e0,
                       uint16_t* main_rec,
                       uint16_t* esc_didx, int32_t* esc_val,
                       int16_t* mvh, int16_t* mvv, uint16_t* nbcls,
                       uint8_t* misc, int32_t* flags, int32_t* types,
                       int64_t mb, int64_t* out) {
    return blob_window_impl((VideoParser*)p, vp_parse_blob_prepare, p,
                            start_pic, max_pics, km, ke, nm0, ne0,
                            hw_nm, hw_ne, prev_m0, prev_e0,
                            main_rec, esc_didx, esc_val,
                            mvh, mvv, nbcls, misc, flags, types, mb, out);
}

int vp_parse_picture(void* p, int32_t* coeffs, int32_t* nblocks,
                     int32_t* intra_blk, int32_t* src_sel,
                     int32_t* mv_h, int32_t* mv_v) {
    auto* v = (VideoParser*)p;
    if (v->track_pool) v->sync_scratch_premult();
    v->track_pool = false;
    v->coeffs = coeffs;
    v->nblocks = nblocks;
    v->intra_blk = intra_blk;
    v->src_sel = src_sel;
    v->mv_h = mv_h;
    v->mv_v = mv_v;
    try {
        return v->parse_picture();
    } catch (const Truncated&) {
        return 0;
    } catch (const CorruptStream&) {
        return 0;
    }
}

// Host-only decode (C++ CPU fallback): decodes the next display frame
// into out (flat shared-layout buffer of vp_total_size bytes).
int64_t vp_total_size(void* p) { return ((VideoParser*)p)->total_size(); }

int vp_host_decode(void* p, uint8_t* out) {
    return ((VideoParser*)p)->host_decode(out);
}

// -- audio --

void* ap_create() { return new AudioParser(); }
void ap_destroy(void* p) { delete (AudioParser*)p; }

void ap_feed(void* p, const uint8_t* data, int64_t n) {
    auto* a = (AudioParser*)p;
    a->buf.insert(a->buf.end(), data, data + n);
    a->ended = false;   // mirrors Buffer.Write clearing hasEnded
    a->sync();
}

void ap_signal_end(void* p) { ((AudioParser*)p)->ended = true; }

// Rewind: clear the stream buffer/position, keep the header state
// (parity with Audio.Rewind, audio.go:149-154).
int64_t ap_unconsumed(void* p) {
    auto* a = (AudioParser*)p;
    return a->br.size - (a->br.bit >> 3);
}

void ap_rewind(void* p) {
    auto* a = (AudioParser*)p;
    a->buf.clear();
    a->br.bit = 0;
    a->sync();
    a->ended = false;
    a->next_frame_size = 0;
}

int ap_has_header(void* p) {
    auto* a = (AudioParser*)p;
    a->sync();
    if (a->has_header_flag) return 1;
    if (a->next_frame_size == 0) {
        int64_t save = a->br.bit;
        try {
            a->next_frame_size = a->decode_header();
        } catch (const Truncated&) {
            a->br.bit = save;
            return 0;
        }
    }
    return a->has_header_flag ? 1 : 0;
}

int ap_samplerate(void* p) {
    auto* a = (AudioParser*)p;
    return a->has_header_flag ? SAMPLE_RATE[a->samplerate_index] : 0;
}

int ap_channels(void* p) { return ((AudioParser*)p)->channels; }

// out: int32[36*2*32]; returns 1 on success, 0 when more data is needed.
int ap_parse_frame(void* p, int32_t* out) {
    auto* a = (AudioParser*)p;
    try {
        return a->parse(out);
    } catch (const Truncated&) {
        return 0;
    } catch (const CorruptStream&) {
        return 0;
    }
}

// -- MPEG-PS demuxer (standalone; parity-tested vs mpeg_tpu/demux.py) --

void* dx_create() { return new Demuxer(); }
void dx_destroy(void* p) { delete (Demuxer*)p; }

void dx_feed(void* p, const uint8_t* data, int64_t n) {
    auto* d = (Demuxer*)p;
    d->buf.insert(d->buf.end(), data, data + n);
    d->ended = false;
    d->sync();
}

void dx_signal_end(void* p) { ((Demuxer*)p)->ended = true; }

int dx_has_headers(void* p) {
    auto* d = (Demuxer*)p;
    d->sync();
    try {
        return d->has_headers() ? 1 : 0;
    } catch (const Truncated&) {
        return 0;
    }
}

int dx_num_video_streams(void* p) { return ((Demuxer*)p)->num_video; }
int dx_num_audio_streams(void* p) { return ((Demuxer*)p)->num_audio; }
double dx_system_clock_ref(void* p) { return ((Demuxer*)p)->sys_clock_ref; }

// Decode the next packet; returns 1 and fills (type, pts, len) on
// success.  The payload pointer (dx_payload) is valid until the next
// dx_decode/dx_feed.
int dx_decode(void* p, int32_t* type_out, double* pts_out,
              int64_t* len_out) {
    auto* d = (Demuxer*)p;
    if (!d->decode_catch()) return 0;
    *type_out = d->pkt_type;
    *pts_out = d->pkt_pts;
    *len_out = d->pkt_len > 0 ? d->pkt_len : 0;
    return 1;
}

const uint8_t* dx_payload(void* p) {
    auto* d = (Demuxer*)p;
    return d->buf.data() + d->pkt_off;
}

// -- fully-native PS pipeline (demux + both ES parsers) --

void* pp_create() { return new Pipeline(); }
void pp_destroy(void* p) { delete (Pipeline*)p; }

void pp_feed(void* p, const uint8_t* data, int64_t n) {
    ((Pipeline*)p)->feed(data, n);
}

void pp_signal_end(void* p) { ((Pipeline*)p)->dmx.ended = true; }

int pp_has_headers(void* p) {
    auto* pp = (Pipeline*)p;
    pp->dmx.sync();
    try {
        return pp->dmx.has_headers() ? 1 : 0;
    } catch (const Truncated&) {
        return 0;
    }
}

int pp_num_video_streams(void* p) { return ((Pipeline*)p)->dmx.num_video; }
int pp_num_audio_streams(void* p) { return ((Pipeline*)p)->dmx.num_audio; }

void pp_set_audio_stream(void* p, int idx) {
    if (idx >= 0 && idx <= 3) ((Pipeline*)p)->audio_type = 0xC0 + idx;
}

int pp_video_has_header(void* p) {
    return ((Pipeline*)p)->ensure_video_header() ? 1 : 0;
}

int pp_width(void* p) {
    auto* pp = (Pipeline*)p;
    return pp->ensure_video_header() ? pp->vp.width : 0;
}

int pp_height(void* p) {
    auto* pp = (Pipeline*)p;
    return pp->ensure_video_header() ? pp->vp.height : 0;
}

double pp_framerate(void* p) {
    auto* pp = (Pipeline*)p;
    return pp->ensure_video_header() ? pp->vp.frame_rate : 0.0;
}

int pp_audio_has_header(void* p) {
    return ((Pipeline*)p)->ensure_audio_header() ? 1 : 0;
}

int pp_samplerate(void* p) {
    auto* pp = (Pipeline*)p;
    return pp->ensure_audio_header() ? SAMPLE_RATE[pp->ap.samplerate_index]
                                     : 0;
}

int pp_channels(void* p) {
    auto* pp = (Pipeline*)p;
    return pp->ensure_audio_header() ? pp->ap.channels : 0;
}

// Video pull: identical two-phase blob contract as vp_* — prepare parses
// the next picture (demuxing more PS packets on demand), counts/emit are
// direct delegates.
int pp_video_blob_prepare(void* p) {
    auto* pp = (Pipeline*)p;
    for (;;) {
        int t = vp_parse_blob_prepare(&pp->vp);
        if (t != 0) return t;
        if (!pp->fill_for(0xE0)) {
            if (!pp->vp.ended) return 0;
            // end signaled: one final attempt over the leftover ES bytes
            return vp_parse_blob_prepare(&pp->vp);
        }
    }
}

void pp_video_blob_counts(void* p, int64_t* out) {
    vp_blob_counts(&((Pipeline*)p)->vp, out);
}

int pp_video_blob_emit(void* p, uint16_t* main_rec,
                       uint16_t* esc_didx, int32_t* esc_val,
                       int16_t* mvh, int16_t* mvv, uint16_t* nbcls,
                       uint8_t* misc, int64_t idx_base, int64_t* io) {
    return vp_blob_emit(&((Pipeline*)p)->vp, main_rec,
                        esc_didx, esc_val, mvh, mvv, nbcls, misc,
                        idx_base, io);
}

int64_t pp_blob_window(void* p, int64_t start_pic, int64_t max_pics,
                       int64_t km, int64_t ke, int64_t nm0, int64_t ne0,
                       int64_t hw_nm, int64_t hw_ne,
                       int64_t prev_m0, int64_t prev_e0,
                       uint16_t* main_rec,
                       uint16_t* esc_didx, int32_t* esc_val,
                       int16_t* mvh, int16_t* mvv, uint16_t* nbcls,
                       uint8_t* misc, int32_t* flags, int32_t* types,
                       int64_t mb, int64_t* out) {
    auto* pp = (Pipeline*)p;
    return blob_window_impl(&pp->vp, pp_video_blob_prepare, p,
                            start_pic, max_pics, km, ke, nm0, ne0,
                            hw_nm, hw_ne, prev_m0, prev_e0,
                            main_rec, esc_didx, esc_val,
                            mvh, mvv, nbcls, misc, flags, types, mb, out);
}

// Audio pull: next MP2 frame's subband samples int32[36][2][32].
int pp_audio_parse_frame(void* p, int32_t* out) {
    auto* pp = (Pipeline*)p;
    for (;;) {
        if (ap_parse_frame(&pp->ap, out)) return 1;
        if (!pp->fill_for(pp->audio_type)) {
            if (!pp->ap.ended) return 0;
            return ap_parse_frame(&pp->ap, out);
        }
    }
}

// Dense video pull (interactive MPEG class): parse the next picture into
// caller-provided plan arrays, demuxing more PS packets on demand —
// identical contract to vp_parse_picture.
int pp_parse_picture(void* p, int32_t* coeffs, int32_t* nblocks,
                     int32_t* intra_blk, int32_t* src_sel,
                     int32_t* mv_h, int32_t* mv_v) {
    auto* pp = (Pipeline*)p;
    for (;;) {
        int t = vp_parse_picture(&pp->vp, coeffs, nblocks, intra_blk,
                                 src_sel, mv_h, mv_v);
        if (t != 0) return t;
        if (!pp->fill_for(0xE0)) {
            if (!pp->vp.ended) return 0;
            return vp_parse_picture(&pp->vp, coeffs, nblocks, intra_blk,
                                    src_sel, mv_h, mv_v);
        }
    }
}

// Native seek protocol (reference contract demux.go:216-349 +
// mpeg.go:460-512): the caller re-feeds the stream from the target
// packet's byte offset after this reset.  Demux HEADER state (stream
// counts, clock ref) and the video sequence/audio header state are kept
// — exactly what Video.Rewind/Audio.Rewind preserve (video.go:195-201,
// audio.go:149-154) — so a mid-stream re-feed decodes immediately.
void pp_reset(void* p) {
    auto* pp = (Pipeline*)p;
    pp->dmx.buf.clear();
    pp->dmx.br.bit = 0;
    pp->dmx.sync();
    pp->dmx.start_code = -1;
    pp->dmx.cur_len = 0;
    pp->dmx.nxt_len = 0;
    pp->dmx.nxt_pts = -1.0;
    pp->dmx.ended = false;
    vp_rewind(&pp->vp);
    ap_rewind(&pp->ap);
    pp->es_end_signaled = false;
    pp->audio_drop_until = -2.0;
    pp->audio_kept = -1.0;
}

void pp_set_video_enabled(void* p, int on) {
    ((Pipeline*)p)->video_on = on != 0;
}

void pp_set_audio_enabled(void* p, int on) {
    ((Pipeline*)p)->audio_on = on != 0;
}

// mode: -2 route all, -1 drop all, >=0 drop until pts > mode.
void pp_audio_set_drop(void* p, double mode) {
    auto* pp = (Pipeline*)p;
    pp->audio_drop_until = mode;
    pp->audio_kept = -1.0;
}

double pp_audio_kept_pts(void* p) { return ((Pipeline*)p)->audio_kept; }

// Total bytes currently buffered across the native pipeline (demux
// window + both ES buffers) — the bounded-memory observability the
// Python-side Buffer occupancy checks used to provide.
int64_t pp_occupancy(void* p) {
    auto* pp = (Pipeline*)p;
    return (int64_t)pp->dmx.buf.size() + (int64_t)pp->vp.buf.size() +
           (int64_t)pp->ap.buf.size();
}

// Bytes fed to the demuxer but not yet consumed by it.  The owner's
// absolute demux position is feed_offset - backlog (needed to re-anchor
// the control-plane seek estimator to the live decode position).
int64_t pp_demux_backlog(void* p) {
    auto* pp = (Pipeline*)p;
    return (int64_t)pp->dmx.buf.size() - (pp->dmx.br.bit >> 3);
}

}   // extern "C"
