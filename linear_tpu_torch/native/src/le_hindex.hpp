// HIndex (-i 2) query: getHIndexMatchAll (src/pmpfinder.cpp:1918-1978) +
// getXDir (src/index_util.cpp:1071-1093). The tables are built host-side
// (linear_tpu/index/hindex.py) and pinned by the caller; this header only
// queries them. Bit-identical to the Python oracle (tests/test_nengine.py).
#pragma once
#include <vector>

#include "le_common.hpp"
#include "le_hash.hpp"

namespace le {

struct HIndexView {
    const u64* ysa = nullptr;
    i64 n_ysa = 0;
    const u64* xs_val1 = nullptr;
    const i64* xs_val2 = nullptr;  // C++ uint32 values; stored widened
    u64 xs_mask = 0;
    i64 empty_dir = 0;
    int span = 17, weight = 9;
};

// XNodeFunc::hash (src/index_util.cpp:971-982): Wang 64-bit mix
static inline u64 wang_hash64(u64 val) {
    u64 key = ~val;
    key = key + (val << 21);
    key ^= key >> 24;
    key = key + (key << 3) + (key << 8);
    key ^= key >> 14;
    key = key + (key << 2) + (key << 4);
    key ^= key >> 28;
    key = key + (key << 31);
    return key;
}

// getXDir (src/index_util.cpp:1071-1093): open-addressing probe with the
// virtual-head re-key on (yval<<40)+xval for oversized blocks
static inline i64 hx_get_x_dir(const HIndexView& hi, u64 xval, u64 yval) {
    u64 mask = hi.xs_mask;
    u64 h1 = wang_hash64(xval) & mask;
    u64 val = (xval << 2) + 1;
    u64 delta = 0;
    while (hi.xs_val1[h1]) {
        u64 c = (hi.xs_val1[h1] ^ val) & ((1ull << 62) - 1);
        if (c == 0) return hi.xs_val2[h1];
        if (c == 2) {  // virtual head
            val = (yval << 42) + (xval << 2) + 1;
            h1 = wang_hash64((yval << 40) + xval) & mask;
            delta = 0;
            continue;
        }
        h1 = (h1 + delta + 1) & mask;
        delta += 1;
    }
    return hi.empty_dir;
}

// getHIndexMatchAll: 17-mer sample stream (hashInit at 0, NO N-skip — the
// rolling hash carries code-4 bases exactly as the C++), consecutive-xval
// dedup (xpre init 0), XString probe, ysa body scan
static inline void query_anchors_h(const HIndexView& hi, const u8* read,
                                   i64 read_len, i64 read_str, i64 read_end,
                                   i64 thd_alpha, u64 idx_str, u64 idx_end,
                                   std::vector<u64>& anchors) {
    const int span = hi.span;
    if (read_end - span <= read_str) return;
    HashStream st(span, hi.weight);
    if (st.init(read, read_len, 0) < 0) return;
    const u64 MASK23 = (1ull << 23) - 1;
    const u64 MASK40_ = (1ull << 40) - 1;
    const u64 MASK20 = (1ull << 20) - 1;
    const u64 MASK30 = (1ull << 30) - 1;
    const u64 thd_delta = 64;
    i64 dt = 0;
    u64 xpre = 0;
    for (i64 k = read_str; k < read_end - span; k++) {
        st.nexth(read, k);
        if (++dt != thd_alpha) continue;
        dt = 0;
        st.nextx(read, read_len, k);
        if (st.xval == xpre) continue;
        xpre = st.xval;
        i64 pos = hx_get_x_dir(hi, st.xval, st.yval);
        if (pos == hi.empty_dir) continue;
        if (((hi.ysa[pos - 1] >> 40) & MASK23) >= thd_delta) continue;
        while (true) {
            u64 body = hi.ysa[pos];
            u64 by = (body >> 41) & MASK20;
            if (by != st.yval && by != 0) break;
            u64 idx = body & MASK40_;
            if (idx >= idx_str && idx < idx_end) {
                i64 gid = (i64)(idx >> 30);
                i64 gx = (i64)(idx & MASK30);
                if (((body >> 40) & 1) ^ (u64)st.strand)
                    anchors.push_back(make_cord(
                        gid, gx - (read_len - 1 - k) + (i64)ANCHOR_ZERO,
                        read_len - 1 - k, 1));
                else
                    anchors.push_back(make_cord(
                        gid, gx - k + (i64)ANCHOR_ZERO, k, 0));
            }
            pos += 1;
            if (pos > hi.n_ysa - 1) break;
        }
    }
}

}  // namespace le
