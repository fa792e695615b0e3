// Common types + packed-u64 cord/hit/anchor helpers.
//
// Native (C++) twin of linear_tpu/utils/cordscalar.py — the per-read host
// runtime of the framework. Layout (reference include/cords.h,
// src/cords.cpp:21-37):
//   main[1]@63 | recd[1]@62 | strand[1]@61 | blockEnd[1]@60 |
//   id[10]@50  | x[30]@20   | y[20]@0
#pragma once
#include <cstdint>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <cmath>
#include <cstring>
#include <string>

namespace le {

typedef uint64_t u64;
typedef int64_t i64;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint8_t u8;

static const u64 MASK_Y = (1ull << 20) - 1;
static const u64 MASK_X30 = (1ull << 30) - 1;
static const u64 MASK_XID = (1ull << 40) - 1;
static const u64 MASK_ID = (1ull << 10) - 1;
static const u64 FLAG_END = 1ull << 60;
static const u64 FLAG_STRAND = 1ull << 61;
static const u64 FLAG_RECD = 1ull << 62;
static const u64 FLAG_MAIN = 1ull << 63;
static const u64 FLAG_LONG_PATTERN = 1ull << 62;  // hits only
static const u64 VALUE_MASK = (1ull << 60) - 1;
static const u64 VALUE_MASK_DSTR = VALUE_MASK | FLAG_STRAND;
static const u64 ANCHOR_ZERO = 1ull << 20;  // const_anchor_zero (src/cords.cpp:8)
static const i64 MAX_CORD_ID = (1 << 10) - 1;
static const i64 MAX_CORD_X = (1 << 30) - 1;
static const i32 INT_MIN32 = -2147483647 - 1;
static const i64 LLMAX = 0x7fffffffffffffffLL;
static const i64 LLMIN = -0x7fffffffffffffffLL - 1;

static inline i64 cy(u64 c) { return (i64)(c & MASK_Y); }
static inline i64 cx(u64 c) { return (i64)((c >> 20) & MASK_X30); }
static inline i64 cxid(u64 c) { return (i64)((c >> 20) & MASK_XID); }
static inline i64 cid(u64 c) { return (i64)((c >> 50) & MASK_ID); }
static inline int cstrand(u64 c) { return (int)((c >> 61) & 1); }
static inline u64 is_end(u64 c) { return c & FLAG_END; }
static inline u64 set_end(u64 c) { return c | FLAG_END; }
static inline u64 unset_end(u64 c) { return c & ~FLAG_END; }

// create_cord (src/cords.cpp:195)
static inline u64 make_cord(i64 gid, i64 x, i64 y, int std) {
    return ((((u64)gid << 30) + (u64)x) << 20) + (u64)y + ((u64)std << 61);
}

// Cord::shift (src/cords.cpp:135); uint64 wrap semantics
static inline u64 shiftc(u64 c, i64 dx, i64 dy) {
    return c + ((u64)dx << 20) + (u64)dy;
}

// hit2Cord_dstr (src/cords.cpp:81)
static inline u64 hit2cord_dstr(u64 h) {
    u64 nw = (h + ((h & MASK_Y) << 20) - (ANCHOR_ZERO << 20)) & VALUE_MASK_DSTR;
    return nw & ~FLAG_LONG_PATTERN;
}

// getAnchorX (src/cords.cpp:463)
static inline i64 anchor_x(u64 a) { return cx(hit2cord_dstr(a)); }

// isCordsConsecutive_ (src/cords.cpp:306)
static inline bool is_consecutive(u64 c1, u64 c2, i64 thd) {
    i64 x1 = cx(c1), x2 = cx(c2), y1 = cy(c1), y2 = cy(c2);
    return cstrand(c1 ^ c2) == 0 && x1 <= x2 && y1 <= y2 && x2 - x1 < thd &&
           y2 - y1 < thd;
}

// getUPForwardy (src/cords.cpp:469)
static inline void up_forward_y(u64 first, u64 second, i64 read_len, i64* y1,
                                i64* y2) {
    if (cstrand(first)) {
        *y1 = read_len - 1 - cy(second);
        *y2 = read_len - 1 - cy(first);
    } else {
        *y1 = cy(first);
        *y2 = cy(second);
    }
}

// Cord::setMaxLen / getMaxLen (src/cords.cpp:122)
static inline void set_max_len(std::vector<u64>& cords, i64 len) {
    if (!cords.empty() && (u64)len > (cords[0] & MASK_Y))
        cords[0] = (u64)len + (cords[0] & ~MASK_Y);
}
static inline i64 get_max_len(const std::vector<u64>& cords) {
    return cords.empty() ? 0 : (i64)(cords[0] & MASK_Y);
}

// C-style truncating integer division (what the reference's int math does)
static inline i64 tdiv(i64 a, i64 b) { return a / b; }

// C++ int32 wrap of an int64 value (gap-score accumulation semantics)
static inline i64 wrap_i32(i64 v) { return (i64)(i32)(u64)v; }

}  // namespace le
