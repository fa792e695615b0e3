// Feature scripts (2-mer composition of 48-base windows, packed int96) and
// the 96-base window distance — native twin of linear_tpu/ops/features.py
// (reference: createFeatures2_48 src/pmpfinder.cpp:541-652, _scriptDist63_31
// :497, _windowDist2_48 :523, _windowDist :680).
#pragma once
#include "le_common.hpp"

namespace le {

static const int SCPT_STEP = 16;
static const int WINDOW48 = 48;
static const int WINDOW = 96;
static const int CELL_BIT = 4;
static const int SUP = 6;  // cell_num
static const int MED = 5;  // ceil(0.75 * 6)
static const int INF = 3;  // ceil(0.5 * 6)
static const i64 WTHR = 36;
static const i64 WTHR_REJ = 50;
static const i64 ABORT_SCORE = 1000;

static const u32 MXU31 =
    (31u << 24) + (31u << 18) + (31u << 12) + (31u << 6) + 31u;

// Feature rows: flat (n, 3) int32, row-major.
struct Feats {
    const i32* rows;  // external or owned
    i64 n;
    std::vector<i32> own;  // backing store when built locally
    Feats() : rows(nullptr), n(0) {}
    void set_external(const i32* p, i64 nrows) { rows = p; n = nrows; }
};

// units table (src/pmpfinder.cpp:541): 2-mer ord (5a+b) -> (int_idx<<8)|bit;
// N*, *N, TT -> bit 31 (masked off)
static inline void feat_units(int* unit_int, i64* unit_add) {
    static const int U[25] = {
        0, 6, 12, 18, 31,
        24, (1 << 8) + 0, (1 << 8) + 6, (1 << 8) + 12, 31,
        (1 << 8) + 18, (1 << 8) + 24, (2 << 8) + 0, (2 << 8) + 6, 31,
        (2 << 8) + 12, (2 << 8) + 18, (2 << 8) + 24, 31, 31,
        31, 31, 31, 31, 31};
    for (int i = 0; i < 25; i++) {
        unit_int[i] = U[i] >> 8;
        int bit = U[i] & 255;
        unit_add[i] = (i64)((1ll << bit) & ((1ll << 31) - 1));
    }
}

// Serial-builder script count (src/pmpfinder.cpp:556): reads use this.
static inline i64 n_scripts_serial(i64 len) {
    if (len < WINDOW48) return 0;
    i64 v = (len - 50) >> CELL_BIT;
    return 1 + (v > 0 ? v : 0);
}

// Parallel-builder script count (src/pmpfinder.cpp:596): genomes use this
// (unless range < threads, src/pmpfinder.cpp:598 — caller decides).
static inline i64 n_scripts_parallel(i64 len) {
    if (len < WINDOW48) return 0;
    return ((len - WINDOW48) >> CELL_BIT) + 1;
}

// Feature scripts with an explicit row count (values identical between the
// serial and parallel builders; only the count differs). The final scripts'
// 2-mers may read one phantom base past the end, treated as 'A' (zero fill
// past SeqAn buffers; see ops/features.py).
static inline void create_features_n(const u8* seq, i64 len, i64 n, Feats& out);

static inline void create_features_read(const u8* seq, i64 len, Feats& out) {
    create_features_n(seq, len, n_scripts_serial(len), out);
}

static inline void create_features_n(const u8* seq, i64 len, i64 n, Feats& out) {
    out.own.assign((size_t)(n > 0 ? n * 3 : 0), 0);
    out.rows = out.own.data();
    out.n = n;
    if (n <= 0) return;
    // per-lane addend tables: acc0..2 stay in REGISTERS (the indexed
    // acc[unit_int[o]] form forces the accumulator array to memory);
    // bit-31 (N*/TT) entries add 0 everywhere
    static i64 t0[25], t1[25], t2[25];
    static bool init = false;
    if (!init) {
        int unit_int[25];
        i64 unit_add[25];
        feat_units(unit_int, unit_add);
        for (int i = 0; i < 25; i++) {
            t0[i] = unit_int[i] == 0 ? unit_add[i] : 0;
            t1[i] = unit_int[i] == 1 ? unit_add[i] : 0;
            t2[i] = unit_int[i] == 2 ? unit_add[i] : 0;
        }
        init = true;
    }
    // rolling: script i sums 2-mer addends over positions [16i, 16i+48)
    i64 a0 = 0, a1 = 0, a2 = 0;
    // position p contributes 2-mer (seq[p], seq[p+1]); seq[len] phantom 'A'
    auto ord2 = [&](i64 p) -> int {
        int a = seq[p];
        int b = (p + 1 < len) ? seq[p + 1] : 0;
        return a * 5 + b;
    };
    for (i64 p = 0; p < WINDOW48 && p < len; p++) {
        int o = ord2(p);
        a0 += t0[o];
        a1 += t1[o];
        a2 += t2[o];
    }
    out.own[0] = (i32)(u32)(a0 & 0xFFFFFFFF);
    out.own[1] = (i32)(u32)(a1 & 0xFFFFFFFF);
    out.own[2] = (i32)(u32)(a2 & 0xFFFFFFFF);
    for (i64 i = 1; i < n; i++) {
        i64 lo = (i - 1) * SCPT_STEP;
        for (i64 p = lo; p < lo + SCPT_STEP; p++) {
            int o = ord2(p);
            a0 -= t0[o];
            a1 -= t1[o];
            a2 -= t2[o];
            o = ord2(p + WINDOW48);
            a0 += t0[o];
            a1 += t1[o];
            a2 += t2[o];
        }
        out.own[i * 3 + 0] = (i32)(u32)(a0 & 0xFFFFFFFF);
        out.own[i * 3 + 1] = (i32)(u32)(a1 & 0xFFFFFFFF);
        out.own[i * 3 + 2] = (i32)(u32)(a2 & 0xFFFFFFFF);
    }
}

// _scriptDist63_31 (src/pmpfinder.cpp:497) with the C++ int32 wrap
static inline i64 sdist(const i32* s1, const i32* s2) {
    i64 t = 0;
    for (int i = 0; i < 3; i++) {
        u32 d = (u32)s1[i] + MXU31 - (u32)s2[i];
        t += std::abs((i64)((d >> 24) & 63) - 31) +
             std::abs((i64)((d >> 18) & 63) - 31) +
             std::abs((i64)((d >> 12) & 63) - 31) +
             std::abs((i64)((d >> 6) & 63) - 31) +
             std::abs((i64)(d & 63) - 31);
    }
    return t;
}

// __windowDist / _windowDist2_48 (src/pmpfinder.cpp:655,523): unchecked;
// clamped OOB reads return huge (valid call sites never go OOB)
static inline i64 window_dist_u(const Feats& f1, const Feats& f2, i64 a, i64 b) {
    if (a + 3 >= f1.n || b + 3 >= f2.n || a < 0 || b < 0) return 1ll << 30;
    return sdist(f1.rows + a * 3, f2.rows + b * 3) +
           sdist(f1.rows + (a + 3) * 3, f2.rows + (b + 3) * 3);
}

// _windowDist (src/pmpfinder.cpp:680): bounds-checked, OOB -> abort_score
static inline i64 window_dist_c(const Feats& f1, const Feats& f2, i64 a, i64 b) {
    const i64 d = 4;
    if (a + d < f1.n && b + d < f2.n)
        return sdist(f1.rows + a * 3, f2.rows + b * 3) +
               sdist(f1.rows + (a + 3) * 3, f2.rows + (b + 3) * 3);
    return ABORT_SCORE;
}

}  // namespace le
