// Scalar LShape rolling hash + DIndex query + gap-module hash streams.
// Native twin of linear_tpu/ops/hashing.py (HashStream) and
// linear_tpu/index/dindex.py (query_anchors); reference:
// src/shape_extend.cpp (hashInit :86, hashNexth :173, hashNextX :341),
// getDIndexMatchAll src/pmpfinder.cpp:1856, val2Anchor src/index_util.cpp:1509,
// g_mapHs_kmer_ src/gap_util.cpp:632, c_stream_ :1694.
#pragma once
#ifdef _OPENMP
#include <omp.h>
#endif
#include "le_common.hpp"

namespace le {

struct HashStream {
    int span, weight;
    u64 h = 0, crh = 0;
    i64 x = 0;
    u64 left = 0;
    int strand = 0;
    u64 xval = 0, yval = 0;

    HashStream(int span_, int weight_) : span(span_), weight(weight_) {}

    // hashInit (src/shape_extend.cpp:86): returns skip k, or -1 when no
    // N-free span window exists to the end of the sequence
    i64 init(const u8* seq, i64 n, i64 it) {
        int s = span;
        left = 0; h = 0; crh = 0; x = -3;
        i64 k = 0, count = 0;
        while (count < s) {
            if (it + k + count >= n) return -1;
            if (seq[it + k + count] == 4) { k += count + 1; count = 0; }
            else count++;
        }
        int bit = 2;
        for (int i = 0; i < s - 1; i++) {
            u64 val = seq[it + k + i];
            x += ((i64)val << 1) - 3;
            h = (h << 2) + val;
            crh = crh + ((3 - val) << bit);
            bit += 2;
        }
        return k;
    }

    // hashNexth (src/shape_extend.cpp:173)
    void nexth(const u8* seq, i64 it) {
        int s = span;
        u64 mask = (1ull << (2 * s - 2)) - 1;
        u64 v2 = seq[it + s - 1];
        h = ((h & mask) << 2) + v2;
        crh = ((crh >> 2) & mask) + ((3 - v2) << (2 * s - 2));
        x += ((i64)v2 - (i64)left) << 1;
        left = seq[it];
    }

    // hashNextX = hashNextXX + hashNextXY2 (src/shape_extend.cpp:341)
    u64 nextx(const u8* seq, i64 n, i64 it) {
        int s = span, w = weight;
        int span2 = 2 * s, weight2 = 2 * w;
        u64 v2 = (x > 0) ? h : crh;
        strand = (x > 0) ? 0 : 1;
        u64 xv = (1ull << span2) - 1;
        int t = 0;
        for (int k = 64 - span2; k <= 64 - weight2; k += 2) {
            u64 v1 = (v2 << k) >> (64 - weight2);
            if (xv > v1) { xv = v1; t = k; }
        }
        xval = xv;
        u64 yv = 0;
        if (x > 0) {
            i64 d_it = (t >> 1) + s + w - 32;
            for (i64 i = d_it; i < d_it + 4; i++) {
                i64 p = it + i;
                i64 val = (p >= 0 && p < n) ? (i64)seq[p] : 0;
                yv = (val > 3) ? (yv << 2) : ((yv << 2) + (u64)val);
            }
        } else {
            i64 d_it = -(t >> 1) - w + 31;
            for (i64 i = d_it; i > d_it - 4; i--) {
                i64 p = it + i;
                i64 val = 3 - ((p >= 0 && p < n) ? (i64)seq[p] : 0);
                yv = (val < 0) ? (yv << 2) : ((yv << 2) + (u64)val);
            }
        }
        yval = yv;
        return xv;
    }
};

// DIndex view (tables owned by the Python side; int32 dir, u64 hs)
struct DIndexView {
    const i32* dir;
    const u64* hs;
    int span, weight;
    // optional non-empty-bucket bitmap (bit x set iff dir[x+1] > dir[x]):
    // 4^weight bits = 8.4 MB at weight 13 — largely cache-resident, so the
    // ~85% of probes that hit EMPTY buckets never touch the 268 MB dir
    // table (each such touch is a guaranteed DRAM+TLB miss)
    const u64* nz = nullptr;
    bool bucket_nonempty(u64 x) const {
        return nz == nullptr || ((nz[x >> 6] >> (x & 63)) & 1);
    }
};

// val2Anchor emission for a precomputed bucket span
static inline void emit_bucket2(const DIndexView& ix, const HashStream& st,
                                i64 lo, i64 hi, i64 j, i64 read_len,
                                std::vector<u64>& anchors) {
    for (i64 e = lo; e < hi; e++) {
        u64 ent = ix.hs[e];
        u64 val = (ent & MASK_Y) ^ st.yval;
        if (val != 0) {
            int ctz = __builtin_ctzll(val);
            if ((val >> ctz) >= 4) continue;
        }
        int same = (cstrand(ent) == st.strand);
        u64 cordy = same ? (u64)j : (u64)(read_len - 1 - j);
        u64 anc = ent - (cordy << 20) + cordy - (ent & MASK_Y);
        anc = same ? (anc & ~FLAG_STRAND) : (anc | FLAG_STRAND);
        anchors.push_back(anc);
    }
}

// bucket probe + val2Anchor emission for one sampled position (shared by
// the rolling and closed-form paths of query_anchors)
static inline void emit_bucket(const DIndexView& ix, const HashStream& st,
                               i64 j, i64 read_len, std::vector<u64>& anchors) {
    i64 lo = ix.dir[st.xval], hi = ix.dir[st.xval + 1];
    for (i64 e = lo; e < hi; e++) {
        u64 ent = ix.hs[e];
        u64 val = (ent & MASK_Y) ^ st.yval;
        if (val != 0) {
            int ctz = __builtin_ctzll(val);
            if ((val >> ctz) >= 4) continue;
        }
        int same = (cstrand(ent) == st.strand);
        u64 cordy = same ? (u64)j : (u64)(read_len - 1 - j);
        u64 anc = ent - (cordy << 20) + cordy - (ent & MASK_Y);
        anc = same ? (anc & ~FLAG_STRAND) : (anc | FLAG_STRAND);
        anchors.push_back(anc);
    }
}

// getDIndexMatchAll (src/pmpfinder.cpp:1856-1913) + val2Anchor
// (src/index_util.cpp:1509): emit anchors for read range [read_str, read_end)
static inline void query_anchors(const DIndexView& ix, const u8* read,
                                 i64 read_len, i64 read_str, i64 read_end,
                                 i64 thd_alpha, std::vector<u64>& anchors) {
    int span = ix.span;
    // Fast path: the rolling state at a sampled call position j telescopes
    // to a closed form once j >= 2*span - 1 (same algebra the device seed
    // kernel uses, ops/seeding.py _closed_form_states):
    //   h    = pack(read[j .. j+span)) MSB-first
    //   crh  = sum_i (3 - read[j+i]) * 4^i
    //   x    = 2*S(j, j+span) - 3*span + bias,
    //   bias = 2*(S(0, span-1) - S(span, 2*span-1))
    // Exact only for read_str == 0 and N-free prefixes, so scan for N once;
    // mixed early samples (j < 2*span - 1) and N reads take the roll below.
    // This skips the per-position hashNexth roll (~15 positions advanced
    // per sample at thd_alpha=15): seeding drops ~3x on CLR-length reads.
    if (read_str == 0 && read_end - span > read_str + span) {
        bool has_n = false;
        i64 scan_end = std::min(read_len, read_end);
        for (i64 i = 0; i < scan_end && !has_n; i++) has_n = read[i] == 4;
        if (!has_n) {
            HashStream st(span, ix.weight);
            i64 bias = 0;
            for (int i = 0; i < span - 1; i++) bias += read[i];
            for (int i = span; i < 2 * span - 1; i++) bias -= read[i];
            bias *= 2;
            u64 xpre = 0;
            i64 j_end = read_end - span;
            i64 j = span + thd_alpha - 1;
            // leading mixed samples: exact short roll from hashInit
            if (j < j_end && j < 2 * span - 1) {
                st.init(read, read_len, 0);
                for (i64 p = span; j < j_end && j < 2 * span - 1;
                     j += thd_alpha) {
                    for (; p <= j; p++) st.nexth(read, p);
                    st.nextx(read, read_len, j);
                    if (st.xval != xpre) {
                        xpre = st.xval;
                        if (ix.bucket_nonempty(st.xval))
                            emit_bucket(ix, st, j, read_len, anchors);
                    }
                }
            }
            // pass 1: closed-form states + minimizer at every remaining
            // sample, prefetching the dir cache line a few samples ahead —
            // the probe is ~460 independent random accesses into a 268 MB
            // table per CLR read, so memory-level parallelism (not the
            // hash math) decides the seeding rate
            struct Sample { u64 xval, yval; i64 j; int strand; };
            std::vector<Sample> ss;
            ss.reserve((j_end - j) / thd_alpha + 1);
            for (; j < j_end; j += thd_alpha) {
                u64 h = 0, crh = 0;
                i64 s = 0;
                for (int i = 0; i < span; i++) {
                    u64 v = read[j + i];
                    h = (h << 2) + v;
                    crh += (3 - v) << (2 * i);
                    s += (i64)v;
                }
                st.h = h;
                st.crh = crh;
                st.x = 2 * s - 3 * span + bias;
                st.nextx(read, read_len, j);
                if (st.xval == xpre) continue;
                xpre = st.xval;
                if (!ix.bucket_nonempty(st.xval)) continue;
                __builtin_prefetch(&ix.dir[st.xval], 0, 1);
                ss.push_back({st.xval, st.yval, j, st.strand});
            }
            // pass 2: bucket spans (dir lines are warm), prefetch hs
            // entries one sample ahead, then emit. Repeat-family buckets
            // run to thd_omit_block (400) entries = ~50 cache lines, so
            // prefetch strides through the whole span, not just its head.
            size_t m = ss.size();
            std::vector<std::pair<i32, i32>> spans_(m);
            for (size_t t = 0; t < m; t++) {
                spans_[t] = {ix.dir[ss[t].xval], ix.dir[ss[t].xval + 1]};
                for (i32 e = spans_[t].first; e < spans_[t].second; e += 8)
                    __builtin_prefetch(&ix.hs[e], 0, 1);
            }
            for (size_t t = 0; t < m; t++) {
                st.xval = ss[t].xval;
                st.yval = ss[t].yval;
                st.strand = ss[t].strand;
                emit_bucket2(ix, st, spans_[t].first, spans_[t].second,
                             ss[t].j, read_len, anchors);
            }
            return;
        }
    }
    // rolling path (N reads / sub-range re-apx): same two-pass prefetched
    // probe — the roll fills the sample list, then dir/hs lines stream in
    // with memory-level parallelism instead of one DRAM stall per sample
    HashStream st(span, ix.weight);
    if (st.init(read, read_len, 0) < 0) return;
    u64 xpre = 0;
    i64 dt = 0;
    i64 j_end = read_end - span;
    struct RSample { u64 xval, yval; i64 j; int strand; };
    std::vector<RSample> rs;
    for (i64 j = read_str + span; j < j_end; j++) {
        st.nexth(read, j);
        if (++dt < thd_alpha) continue;
        dt = 0;
        st.nextx(read, read_len, j);
        if (st.xval == xpre) continue;
        xpre = st.xval;
        if (!ix.bucket_nonempty(st.xval)) continue;
        __builtin_prefetch(&ix.dir[st.xval], 0, 1);
        rs.push_back({st.xval, st.yval, j, st.strand});
    }
    size_t m = rs.size();
    std::vector<std::pair<i32, i32>> spans_(m);
    for (size_t t = 0; t < m; t++) {
        spans_[t] = {ix.dir[rs[t].xval], ix.dir[rs[t].xval + 1]};
        if (spans_[t].second > spans_[t].first)
            __builtin_prefetch(&ix.hs[spans_[t].first], 0, 1);
    }
    for (size_t t = 0; t < m; t++) {
        st.xval = rs[t].xval;
        st.yval = rs[t].yval;
        st.strand = rs[t].strand;
        emit_bucket2(ix, st, spans_[t].first, spans_[t].second,
                     rs[t].j, read_len, anchors);
    }
}

// ---------------------------------------------------- gap-module streams
// g_hs: N/A[1]|xval[30]|type[2]|strand[1]|coordinate[30] (src/gap_util.cpp:522)

static inline u64 g_hs_make(u64 xval, int typ, int std, i64 coord) {
    return (xval << 33) + ((u64)typ << 31) + ((u64)std << 30) + (u64)coord;
}
static inline i64 g_hs_cord(u64 v) { return (i64)(v & ((1ull << 30) - 1)); }
static inline u64 g_hs_xt(u64 v) { return (v >> 31) & ((1ull << 32) - 1); }

// g_mapHs_kmer_ (src/gap_util.cpp:632): double-strand canonical stream
// (hashInit + per-base roll; value = x<0 ? crh : h; strand = x<0)
static inline void g_map_hs_kmer(const u8* seq, i64 n, std::vector<u64>& g_hs,
                                 i64 s, i64 e, int shape_len, i64 step, int typ) {
    if (n < shape_len) return;
    i64 stop = std::min(e, n - shape_len);
    HashStream st(shape_len, shape_len);
    if (st.init(seq, n, s) < 0) return;
    u64 vmask = (1ull << (2 * shape_len)) - 1;
    i64 count = 0;
    for (i64 k = s; k < stop; k++) {
        st.nexth(seq, k);
        int std_ = st.x < 0 ? 1 : 0;
        u64 val = std_ ? st.crh : st.h;
        if (++count == step) {
            g_hs.push_back(g_hs_make(val & vmask, typ, std_, k));
            count = 0;
        }
    }
}

// c_stream_ (src/gap_util.cpp:1694): single-strand rolling hash
static inline void c_stream(const u8* seq, i64 n, std::vector<u64>& g_hs,
                            i64 sq_str, i64 sq_end, i64 step, int shape_len,
                            int typ) {
    if (n < shape_len) return;
    i64 stop = std::min(sq_end, n - shape_len);
    u64 h = 0;
    for (int i = 0; i < shape_len - 1; i++) {
        i64 p = sq_str + i;
        h = (h << 2) + ((p >= 0 && p < n) ? (u64)seq[p] : 0);
    }
    u64 mask = (1ull << (2 * shape_len - 2)) - 1;
    i64 count = 0;
    for (i64 k = sq_str; k < stop; k++) {
        u64 v2 = seq[k + shape_len - 1];
        h = ((h & mask) << 2) + v2;
        if (++count == step) {
            g_hs.push_back(g_hs_make(h, typ, 0, k));
            count = 0;
        }
    }
}

}  // namespace le
