// Gap / SV resolution module — native twin of linear_tpu/map/gap.py
// (reference: mapGaps src/gap.cpp:407, mapGap_ :16, gap_util.cpp seeding
// :632-750, scores :966-1176, tiles :1177-1498, clips :2126-2274, extends
// :3272-3985, mapExtend(s) :4035-4121, mapInterval :4444, reform/splice
// :3042-3271, reformCords src/cords.cpp:504-601).
#pragma once
#include "le_pmp.hpp"

namespace le {

static const int G_MAP_LEFT = -1;
static const int G_MAP_CLOSED = 0;
static const int G_MAP_RGHT = 1;

// Tile sgn bits (src/gap_util.cpp:261): start = 1<<62, end = 1<<63
static const u64 TILE_SGN_STR = 1ull << 62;
static const u64 TILE_SGN_END = 1ull << 63;
static const u64 TILE_SGN = TILE_SGN_STR | TILE_SGN_END;

static inline i64 tile_x(u64 t) { return cx(t); }
static inline i64 tile_y(u64 t) { return cy(t); }
static inline int tile_strand(u64 t) { return cstrand(t); }
static inline u64 is_tile_end(u64 t) { return t & TILE_SGN_END; }
static inline u64 is_tile_start(u64 t) { return t & TILE_SGN_STR; }
static inline u64 set_tile_end(u64 t) { return t | TILE_SGN_END; }
static inline u64 set_tile_start(u64 t) { return t | TILE_SGN_STR; }
static inline u64 remove_tile_sgn(u64 t) { return t & ~TILE_SGN; }
static inline u64 remove_tile_sgn_end(u64 t) { return t & ~TILE_SGN_END; }
static inline u64 remove_tile_sgn_start(u64 t) { return t & ~TILE_SGN_STR; }
static inline u64 copy_tile_sgn(u64 t1, u64 t2) {
    return (t1 & TILE_SGN) | (t2 & ~TILE_SGN);
}
static inline u64 set_tile_strand(u64 t) { return t | (1ull << 61); }

// g_hs_anchor: N/A[13]|strand[1]|anchorX[30]|cord_y[20] (src/gap_util.cpp:482)
static const u64 GA_MASK1 = (1ull << 20) - 1;
static const u64 GA_MASK3 = (1ull << 30) - 1;
static const u64 GA_MASK5 = (1ull << 31) - 1;
static const int GA_BIT1 = 20;
static const int GA_BIT2 = 50;
static const u64 GA_ZERO = 1ull << 20;

static inline i64 ganchor_get_anchor(u64 a) { return (i64)((a >> GA_BIT1) & GA_MASK3); }
static inline i64 ganchor_str_anchor(u64 a) {
    return (i64)((a >> GA_BIT1) & GA_MASK5) - (i64)GA_ZERO;
}
static inline i64 ganchor_x(u64 a) {
    return (i64)((a >> GA_BIT1) & GA_MASK3) - (i64)GA_ZERO + (i64)(a & GA_MASK1);
}
static inline i64 ganchor_y(u64 a) { return (i64)(a & GA_MASK1); }
static inline int ganchor_strand(u64 a) { return (int)((a >> GA_BIT2) & 1); }

// uint64-wrap str-anchor sort key (_createGapAnchorsList src/gap_util.cpp:4286)
static inline u64 ganchor_sa_u64(u64 a) {
    return ((a >> GA_BIT1) & GA_MASK5) - GA_ZERO;
}

// g_hs_Cord2StrAnchor (src/gap_util.cpp:543)
static inline i64 g_hs_cord2str_anchor(u64 cord) {
    return cx(cord) - cy(cord) + ((i64)cstrand(cord) << (GA_BIT2 - GA_BIT1));
}

// g_hs_setAnchor_ (src/gap_util.cpp:548); hs1 genome, hs2 read
static inline u64 g_hs_set_anchor(u64 hs1, u64 hs2, i64 revscomp_const) {
    u64 std_ = ((hs1 ^ hs2) >> 30) & 1;
    i64 n = 2 * (i64)std_ - 1;
    u64 x = (u64)((i64)revscomp_const * (i64)std_ - n * (i64)(hs2 & GA_MASK3));
    return (((hs1 + GA_ZERO - x) & GA_MASK3) << 20) + x + (std_ << GA_BIT2);
}

// c_2Anchor_ (src/gap_util.cpp:558)
static inline u64 c_2anchor(u64 hs1, u64 hs2) {
    u64 x = hs2 & GA_MASK3;
    return (((hs1 - x + GA_ZERO) & GA_MASK3) << GA_BIT1) + x;
}

// g_hs_anchor2Tile (src/gap_util.cpp:574)
static inline u64 ganchor2tile(u64 a) {
    u64 std_ = (a >> GA_BIT2) & 1;
    u64 y = a & GA_MASK1;
    u64 val = a - (GA_ZERO << 20) + ((a & GA_MASK1) << 20);
    val = (val & ~(1ull << GA_BIT2)) & ~GA_MASK1;
    return val + y + (std_ << 61);
}

// ------------------------------------------------------------------ parms

struct ChainMetric {
    i64 thd_min_chain_len;
    i64 thd_abort_score;
    int score_sel;  // anchors: 0 GapAnchorsChainScore, 1 ...Score2, 2 ExtendClip
                    // blocks: 0 GapBlocksChainScore2, 1 ...Score3
};

struct GapParms {
    double thd_err = 0.2;
    int direction = 0;
    i64 int_precision = 10000;
    i64 thd_tile_size = 96;
    i64 ref_len = 0;
    i64 read_len = 0;

    i64 thd_ecr_shape_len = 3;
    i64 thd_ecr_reject_da = 20;
    int f_rfts_clip = 1;
    i64 thd_accept_score = 32;
    int f_me_map_extend = 0;
    i64 thd_me_reject_gap = 200;
    i64 thd_ctfcs_accept_score = 32;
    i64 thd_ctfcs_pattern_in_window = 1;
    int f_gmsa_direction = 0;
    double thd_gmsa_d_anchor_rate = 0.1;
    i64 thd_cts_major_limit = 1;
    i64 thd_ctfas2_connect_danchor = 50;
    i64 thd_ctfas2_connect_dy_dx = 150;
    int f_eis_raw_clip = 1;
    int f_eis_raw_clip_ins = 1;
    i64 thd_eis_shape_len = 9;
    i64 thd_eis_step1 = 5;
    i64 thd_eis_step2 = 1;
    i64 thd_dcgx_window_size = 5;
    i64 thd_dcgx_Xdrop_peak = 125;
    i64 thd_dcgx_Xdrop_sum = 300;
    i64 thd_tts_overlap_size = 81;
    i64 thd_tts_gap_size = 100;
    i64 thd_smcn_danchor = 12;
    i64 thd_dcomx_err_dx = 25;
    i64 thd_dcomx_err_dy = 25;
    i64 thd_eicos_clip_dxy = 30;
    i64 thd_eicos_window_size = 8;
    bool thd_eicos_f_as_ins = true;
    i64 thd_etfas_shape_len = 5;
    i64 thd_etfas_step1 = 3;
    i64 thd_etfas_step2 = 1;
    i64 thd_ccps_window_size = 5;
    i64 thd_ccps_clip_min = 1000;
    i64 thd_ccps_clip_init = 2000;
    i64 thd_ccps_clip1_upper = 80000;
    i64 thd_ccps_clip2_lower = 120000;
    i64 thd_mg1_danc_indel = 80;
    i64 thd_max_extend2 = 5000;
    int f_dup = 0;
    i64 thd_gap_len_min = 50;

    ChainMetric chn_score1 = {1, 50, 0};
    ChainMetric chn_score2 = {1, 0, 0};
    ChainMetric chn_ext_clip_metric1 = {1, 0, 2};

    // GapParms::clipChainParms (src/gap_util.cpp:82)
    void clip_chain_parms(i64 /*shape_len*/, double thd_err_rate) {
        thd_ccps_window_size = 5;
        thd_ccps_clip_min = (i64)(std::min(thd_err_rate, 0.1) * (double)int_precision);
        thd_ccps_clip_init = (i64)(thd_err_rate * (double)int_precision);
        thd_ccps_clip1_upper = 8 * int_precision;
        thd_ccps_clip2_lower = 12 * int_precision;
    }
};

// ------------------------------------------------------------ gap scores

// getGapAnchorsChainScore (src/gap_util.cpp:966)
static inline i64 get_gap_anchors_chain_score(u64 a1, u64 a2,
                                              const ChainScoreParms&) {
    i64 dy = ganchor_y(a1) - ganchor_y(a2);
    i64 dx = ganchor_x(a1) - ganchor_x(a2);
    if (dy < 0 || ganchor_strand(a1 ^ a2) || (std::abs(dx) < 8 && dx != dy))
        return -10000;
    const i64 thd_min_dy = 50;
    i64 da = std::abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1));
    i64 derr = tdiv(100 * da, std::max(dy, thd_min_dy));
    i64 score_derr;
    if (derr < 10) score_derr = 0;
    else if (derr < 15) score_derr = 10 + 2 * derr;
    else score_derr = tdiv(derr * derr, 10) + 40;
    i64 score_dy;
    if (dy < 100) score_dy = tdiv(dy, 4);
    else if (dy < 200) score_dy = tdiv(dy, 3) - 9;
    else score_dy = dy - 145;
    return 100 - score_dy - score_derr;
}

// getGapAnchorsChainScore2 (src/gap_util.cpp:1013)
static inline i64 get_gap_anchors_chain_score2(u64 a1, u64 a2,
                                               const ChainScoreParms&) {
    i64 dy = ganchor_y(a1) - ganchor_y(a2);
    i64 dx = ganchor_x(a1) - ganchor_x(a2);
    if (dy < 0 || ganchor_strand(a1 ^ a2) ||
        ((std::abs(dx) < 8 || std::abs(dy) < 8) && dx != dy))
        return -10000;
    const i64 thd_min_dy = 50;
    i64 da = std::abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1));
    i64 derr = tdiv(100 * da, std::max(std::max(dx, dy), thd_min_dy));
    i64 score_derr;
    if (derr < 5) score_derr = 4 * derr;
    else if (derr < 10) score_derr = 6 * derr - 10;
    else score_derr = derr * derr - 5 * derr;
    i64 score_dy = tdiv(dy * (dy + 300), 300);
    return 100 - score_dy - score_derr;
}

// getExtendClipScore (src/gap_util.cpp:2126)
static inline i64 get_extend_clip_score(u64 a1, u64 a2, const ChainScoreParms&) {
    i64 dy = ganchor_y(a1) - ganchor_y(a2);
    i64 dx = ganchor_x(a1) - ganchor_x(a2);
    if (dy <= 0 || ganchor_strand(a1 ^ a2) ||
        ((std::abs(dx) < 3 || std::abs(dy) < 3) && dx != dy))
        return -10000;
    i64 da = std::abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1));
    i64 score_da;
    if (da < 2) score_da = 30 + 5 * da;
    else if (da < 5) score_da = 36 + 2 * da;
    else score_da = 41 + da;
    i64 score_dy = tdiv(dy * (12 * dy + 650), 450);
    return 100 - score_dy - score_da;
}

static inline AnchorScoreFn gap_anchor_score_fn(int sel) {
    switch (sel) {
        case 0: return get_gap_anchors_chain_score;
        case 1: return get_gap_anchors_chain_score2;
        default: return get_extend_clip_score;
    }
}

// getGapBlocksChainScore2 (src/gap_util.cpp:1049)
static inline i64 get_gap_blocks_chain_score2(u64 c11, u64 c12, u64 c21, u64 c22,
                                              i64 read_len,
                                              const ChainScoreParms& parms) {
    i64 dx, dy;
    int f_type = get_chain_block_dxdy(c11, c12, c21, c22, read_len,
                                      parms.chn_block_strand, &dx, &dy);
    const i64 thd_dup_trigger = -50;
    i64 dx_ = std::abs(dx), dy_ = std::abs(dy);
    i64 da = dx - dy;
    if (dx < -40 || dy < -40) return INT_MIN32;
    i64 score_dy = dy_ > 300 ? tdiv(dy_, 4) - 25 : tdiv(dy_, 6);
    i64 score_dx = dx_ > 300 ? tdiv(dx_, 4) - 25 : tdiv(dx_, 6);
    if (f_type == 1) return 80 - score_dy;
    if (da < -std::max(tdiv(dx_, 4), (i64)50)) {
        if (dx > thd_dup_trigger) return 80 - score_dx;
        return 40 - score_dy;
    }
    if (da > std::max(tdiv(dy, 4), (i64)50)) return 80 - score_dy;
    return 100 - score_dy;
}

// getGapBlocksChainScore3 (src/gap_util.cpp:1107)
static inline i64 get_gap_blocks_chain_score3(u64 c11, u64 c12, u64 c21, u64 c22,
                                              i64 read_len,
                                              const ChainScoreParms& parms) {
    i64 dx, dy;
    int f_type = get_chain_block_dxdy(c11, c12, c21, c22, read_len,
                                      parms.chn_block_strand, &dx, &dy);
    i64 dx_ = std::abs(dx), dy_ = std::abs(dy);
    i64 da = dx - dy;
    if (dx < 0 || dy < 0) return INT_MIN32;
    i64 score_dy = dy_ > 300 ? tdiv(dy_, 4) - 25 : tdiv(dy_, 6);
    if (f_type == 1) return 20 - score_dy;
    i64 da_ratio = tdiv(100 * std::abs(da), std::max(std::max(dx_, dy_), (i64)100));
    i64 score_da;
    if (da < 15) score_da = tdiv(da_ratio * (da_ratio + 20), 40);
    else if (da < 30) score_da = tdiv(da_ratio * (da_ratio + 50), 45);
    else score_da = tdiv(da_ratio * (da_ratio + 100), 45);
    i64 max_dxy = std::max(dx_, dy_);
    i64 score_dist = tdiv(max_dxy * (max_dxy + 450), 2000);
    return 100 - score_da - score_dist;
}

static inline BlockScoreFn gap_block_score_fn(int sel) {
    return sel == 0 ? get_gap_blocks_chain_score2 : get_gap_blocks_chain_score3;
}

// --------------------------------------------------------- anchor creation

// g_mapHs_setAnchors_ (src/gap_util.cpp:669) for one (p1, p2, k) xval group
static inline void set_anchors_group(const std::vector<u64>& g_hs,
                                     std::vector<u64>& g_anchor, i64 p1, i64 p2,
                                     i64 k, i64 revscomp_const, i64 anchor_lower,
                                     i64 anchor_upper, u64 gap_str, u64 gap_end,
                                     int direction, const GapParms& gp) {
    if (direction == 0) {
        for (i64 i = p1; i < p2; i++)
            for (i64 j = p2; j < k; j++) {
                u64 a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const);
                i64 tmp = ganchor_str_anchor(a);
                if (anchor_lower <= tmp && tmp < anchor_upper) g_anchor.push_back(a);
            }
    } else if (direction < 0) {
        i64 y_end = cy(gap_end);
        i64 anchor_base = g_hs_cord2str_anchor(gap_end);
        i64 d_anchor = (i64)((1 << 7) * gp.thd_gmsa_d_anchor_rate);
        for (i64 i = p1; i < p2; i++)
            for (i64 j = p2; j < k; j++) {
                u64 a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const);
                i64 tmp = ganchor_str_anchor(a);
                i64 dy = y_end - ganchor_y(a);
                if (dy < 0 || (ganchor_strand(a) ^ cstrand(gap_str))) continue;
                i64 d_acc = std::max((dy >> 7) * d_anchor, (i64)50);
                i64 lo = std::max(anchor_base - d_acc, (i64)0);
                i64 hi = anchor_base + d_acc;
                if (lo <= tmp && tmp < hi) g_anchor.push_back(a);
            }
    } else {
        i64 y_str = cy(gap_str);
        i64 anchor_base = g_hs_cord2str_anchor(gap_str);
        i64 d_anchor = (i64)((1 << 7) * gp.thd_gmsa_d_anchor_rate);
        for (i64 i = p1; i < p2; i++)
            for (i64 j = p2; j < k; j++) {
                u64 a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const);
                i64 tmp = ganchor_str_anchor(a);
                i64 dy = ganchor_y(a) - y_str;
                if (dy < 0 || (ganchor_strand(a) ^ cstrand(gap_str))) continue;
                i64 d_acc = std::max((dy >> 7) * d_anchor, (i64)50);
                i64 lo = std::max(anchor_base - d_acc, (i64)0);
                i64 hi = anchor_base + d_acc;
                if (lo <= tmp && tmp < hi) g_anchor.push_back(a);
            }
    }
}

// the (p1, p2, k) xval-group walk (g_create_anchors_ src/gap_util.cpp:1596);
// the trailing group (no following boundary) is never emitted — same as C++
template <class Fn>
static inline void walk_groups(const std::vector<u64>& g_hs, u64 mask, Fn&& fn) {
    i64 p1 = 0, p2 = 0;
    for (i64 k = 1; k < (i64)g_hs.size(); k++) {
        u64 xt = g_hs_xt((g_hs[k] ^ g_hs[k - 1]) & mask);
        if (xt == 0) {
        } else if (xt == 1) {
            p2 = k;
        } else {
            fn(p1, p2, k);
            p1 = k;
            p2 = k;
        }
    }
}

// g_create_anchors_ (src/gap_util.cpp:1596)
static inline void g_create_anchors(std::vector<u64>& g_hs,
                                    std::vector<u64>& g_anchor, int shape_len,
                                    int direction, i64 anchor_lower,
                                    i64 anchor_upper, i64 rvcp_const, u64 gap_str,
                                    u64 gap_end, const GapParms& gp) {
    u64 mask = (1ull << (2 * shape_len + 33)) - 1;
    // std::sort asc by (a & mask) (src/gap_util.cpp:1608)
    std::sort(g_hs.begin(), g_hs.end(),
              [&](u64 a, u64 b) { return (a & mask) < (b & mask); });
    walk_groups(g_hs, mask, [&](i64 p1, i64 p2, i64 k) {
        set_anchors_group(g_hs, g_anchor, p1, p2, k, rvcp_const, anchor_lower,
                          anchor_upper, gap_str, gap_end, direction, gp);
    });
}

// g_CreateExtendAnchorsPair_ (src/gap_util.cpp:1628)
static inline void g_create_extend_anchors_pair(
    std::vector<u64>& g_hs, std::vector<u64>& anchors1, std::vector<u64>& anchors2,
    int shape_len, i64 rvcp_const, u64 gap_str1, u64 gap_end1, u64 gap_str2,
    u64 gap_end2, const GapParms& gp) {
    u64 mask = (1ull << (2 * shape_len + 33)) - 1;
    std::sort(g_hs.begin(), g_hs.end(),
              [&](u64 a, u64 b) { return (a & mask) < (b & mask); });
    walk_groups(g_hs, mask, [&](i64 p1, i64 p2, i64 k) {
        set_anchors_group(g_hs, anchors1, p1, p2, k, rvcp_const, 0, 0, gap_str1,
                          gap_end1, 1, gp);
    });
    walk_groups(g_hs, mask, [&](i64 p1, i64 p2, i64 k) {
        set_anchors_group(g_hs, anchors2, p1, p2, k, rvcp_const, 0, 0, gap_str2,
                          gap_end2, -1, gp);
    });
}

// c_createAnchors2 (src/gap_util.cpp:1818)
static inline void c_create_anchors2(std::vector<u64>& g_hs,
                                     std::vector<u64>& g_anchors, i64 g_hs_end,
                                     i64 anchor_lower, i64 anchor_upper) {
    std::sort(g_hs.begin(), g_hs.end());
    i64 p1 = 0, p2 = 0;
    for (i64 k = 1; k < g_hs_end; k++) {
        u64 xt = g_hs_xt(g_hs[k] ^ g_hs[k - 1]);
        if (xt == 0) {
        } else if (xt == 1) {
            p2 = k;
        } else {
            for (i64 i = p1; i < p2; i++) {
                i64 x = g_hs_cord(g_hs[i]);
                for (i64 j = p2; j < k; j++) {
                    i64 y = g_hs_cord(g_hs[j]);
                    if (anchor_lower <= x - y && x - y < anchor_upper)
                        g_anchors.push_back(c_2anchor(g_hs[i], g_hs[j]));
                }
            }
            p1 = k;
            p2 = k;
        }
    }
}

// ---------------------------------------------------------- chain helpers

typedef i64 (*TileGetFn)(u64);

// dropChainGapX (src/gap_util.cpp:757)
static inline i64 drop_chain_gap_x(std::vector<u64>& chains, TileGetFn get_x,
                                   TileGetFn get_y, int direction, bool f_erase,
                                   const GapParms& gp) {
    if (direction == G_MAP_RGHT) {
        for (i64 i = 1; i < (i64)chains.size(); i++) {
            i64 di = (i + 1 >= gp.thd_dcgx_window_size) ? gp.thd_dcgx_window_size : 1;
            if (i + 1 - di < 0 || i >= (i64)chains.size()) continue;
            if (get_x(chains[i]) - get_x(chains[i - 1]) > gp.thd_dcgx_Xdrop_peak ||
                get_x(chains[i]) - get_x(chains[i + 1 - di]) > gp.thd_dcgx_Xdrop_sum ||
                get_y(chains[i]) - get_y(chains[i - 1]) > gp.thd_dcgx_Xdrop_peak ||
                get_y(chains[i]) - get_y(chains[i + 1 - di]) > gp.thd_dcgx_Xdrop_sum) {
                if (f_erase) {
                    chains.resize(i);
                    return (i64)chains.size();
                }
                return i;
            }
        }
        return (i64)chains.size();
    }
    if (direction == G_MAP_LEFT) {
        for (i64 i = (i64)chains.size() - 2; i > 0; i--) {
            i64 di = ((i64)chains.size() - i >= gp.thd_dcgx_window_size)
                         ? gp.thd_dcgx_window_size
                         : 1;
            if (get_x(chains[i + 1]) - get_x(chains[i]) > gp.thd_dcgx_Xdrop_peak ||
                get_x(chains[i + di - 1]) - get_x(chains[i]) > gp.thd_dcgx_Xdrop_sum ||
                get_y(chains[i + 1]) - get_y(chains[i]) > gp.thd_dcgx_Xdrop_peak ||
                get_y(chains[i + di - 1]) - get_y(chains[i]) > gp.thd_dcgx_Xdrop_sum) {
                if (f_erase) {
                    chains.erase(chains.begin(), chains.begin() + i + 1);
                    return 0;
                }
                return i;
            }
        }
        return 0;
    }
    return 0;
}

// accumulateSimpleGapScore1 (src/gap_util.cpp:2169); int32 wrap semantics
static inline void accumulate_simple_gap_score1(const std::vector<u64>& chain,
                                                i64 shape_len, TileGetFn get_x,
                                                const GapParms& gp,
                                                std::vector<i64>& scores) {
    scores.clear();
    if (chain.empty()) return;
    scores.assign(chain.size(), 0);
    i64 pre_x = get_x(chain[0]);
    for (size_t i = 1; i < chain.size(); i++) {
        i64 x_i = get_x(chain[i]);
        i64 d32 = wrap_i32((i64)((u64)x_i - (u64)pre_x));
        i64 new_gap =
            d32 > shape_len ? wrap_i32((i64)((u64)x_i - (u64)pre_x - (u64)shape_len)) : 0;
        scores[i] = wrap_i32(scores[i - 1] + wrap_i32(new_gap * gp.int_precision));
        pre_x = x_i;
    }
}

// clipChain_ (src/gap_util.cpp:2191)
static inline i64 clip_chain_(std::vector<u64>& chain, const std::vector<i64>& gsx,
                              const std::vector<i64>& gsy, int direction,
                              bool f_clip, const GapParms& gp) {
    if (chain.empty()) return -1;
    i64 clip_i = direction <= 0 ? -1 : (i64)chain.size() - 1;
    i64 w = gp.thd_ccps_window_size;
    i64 max_d_clip = INT_MIN32;
    int f_found = 0;
    for (i64 i = 1; i < (i64)chain.size() - 1; i++) {
        i64 i_str = std::max(i - w, (i64)0);
        i64 i_end = std::min(i + w, (i64)chain.size() - 1);
        i64 d1 = i - i_str;
        i64 d2 = i_end - i;
        i64 cx1 = tdiv(wrap_i32(gsx[i] - gsx[i_str]), d1);
        i64 cx2 = tdiv(wrap_i32(gsx[i_end] - gsx[i]), d2);
        i64 cy1 = tdiv(wrap_i32(gsy[i] - gsy[i_str]), d1);
        i64 cy2 = tdiv(wrap_i32(gsy[i_end] - gsy[i]), d2);
        if (direction <= 0) {
            std::swap(cx1, cx2);
            std::swap(cy1, cy2);
        }
        i64 d_clip = wrap_i32(cx2 - cx1 + cy2 - cy1);
        if (d_clip > max_d_clip && cx1 < gp.thd_ccps_clip1_upper &&
            cy1 < gp.thd_ccps_clip1_upper &&
            (cx2 > gp.thd_ccps_clip2_lower || cy2 > gp.thd_ccps_clip2_lower)) {
            max_d_clip = d_clip;
            clip_i = i;
            f_found = 1;
        }
    }
    if (f_clip && f_found) {
        if (direction <= 0)
            chain.erase(chain.begin(), chain.begin() + clip_i + 1);
        else
            chain.resize(clip_i + 1);
    }
    return clip_i + 1;
}

// clipChain (src/gap_util.cpp:2252)
static inline i64 clip_chain(std::vector<u64>& chain, i64 shape_len, int direction,
                             bool f_clip, TileGetFn get_x, TileGetFn get_y,
                             GapParms& gp) {
    gp.clip_chain_parms(shape_len, gp.thd_err);
    std::vector<i64> gsx, gsy;
    accumulate_simple_gap_score1(chain, shape_len, get_x, gp, gsx);
    accumulate_simple_gap_score1(chain, shape_len, get_y, gp, gsy);
    return clip_chain_(chain, gsx, gsy, direction, f_clip, gp);
}

// stickMainChain (src/gap_util.cpp:2276)
static inline void stick_main_chain(std::vector<u64>& chain1,
                                    const std::vector<u64>& chain2, TileGetFn gx1,
                                    TileGetFn gy1, TileGetFn gx2, TileGetFn gy2,
                                    const GapParms& gp) {
    if (chain1.empty() || chain2.empty()) return;
    i64 di = 0;
    i64 jj = (i64)chain2.size() - 1;
    i64 x2 = gx2(chain2[jj]);
    for (i64 i = 0; i < (i64)chain1.size(); i++) {
        i64 x1 = gx1(chain1[i]);
        if (x1 < x2) {
            for (i64 j = jj - 1; j >= 0; j--) {
                x2 = gx2(chain2[j]);
                if (x1 >= x2) { jj = j; break; }
            }
        }
        if (x1 < x2) jj = 0;
        i64 anchor1 = x1 - gy1(chain1[i]);
        i64 anchor2 = gx2(chain2[jj]) - gy2(chain2[jj]);
        if (anchor1 >= anchor2 + gp.thd_smcn_danchor ||
            anchor1 < anchor2 - gp.thd_smcn_danchor)
            di++;
        else
            chain1[i - di] = chain1[i];
    }
    chain1.resize(chain1.size() - di);
}

// ---------------------------------------------------------- tiles scoring

struct GapContext {
    const u8* const* genomes;
    const i64* genome_lens;
    i64 n_genomes;
    const u8* read;
    const u8* comstr;  // reverse complement
    i64 read_len;
    const Feats* f1;         // [2]
    const Feats* const* f2;  // per genome
};

// _get_tile_f_ (src/gap_util.cpp:805)
static inline i64 get_tile_f(const GapContext& cx_, u64 tile) {
    int n1 = tile_strand(tile);
    i64 n2 = cid(tile);
    if (n1 < 2 && n2 < cx_.n_genomes)
        return window_dist_c(cx_.f1[n1], *cx_.f2[n2], tile_y(tile) >> 4,
                             tile_x(tile) >> 4);
    return (1ll << 32) - 1;
}

// _get_tile_f_tri_ (src/gap_util.cpp:870)
static inline u64 get_tile_f_tri(const GapContext& cx_, u64 new_tile, i64 lower_x,
                                 i64 lower_y, i64 upper_x, i64 upper_y,
                                 i64 thd_tile_size, i64* min_score_out) {
    i64 x = tile_x(new_tile);
    i64 y = tile_y(new_tile);
    i64 sh = std::min(thd_tile_size / 4, std::min(x - lower_x, y - lower_y));
    i64 f1s = get_tile_f(cx_, new_tile);
    i64 min_score = f1s;
    u64 tile_l = shiftc(new_tile, -sh, -sh);
    i64 f2s = get_tile_f(cx_, tile_l);
    if (f2s < f1s) { new_tile = tile_l; min_score = f2s; }
    sh = std::min(thd_tile_size / 4, std::min(upper_x - x - 1, upper_y - y - 1));
    u64 tile_r = shiftc(new_tile, sh, sh);
    i64 f3s = get_tile_f(cx_, tile_r);
    if (f3s < min_score) { new_tile = tile_r; min_score = f3s; }
    *min_score_out = min_score;
    return new_tile;
}

// ---------------------------------------------------- chains from anchors

static inline void gather_blocks_tiles(std::vector<u64>& tiles, i64 read_len,
                                       i64 thd_large_gap,
                                       std::vector<PII>& str_ends_p) {
    std::vector<PII> str_ends;
    gather_blocks(tiles, 0, (i64)tiles.size(), read_len, thd_large_gap, 0, false,
                  str_ends, str_ends_p, is_tile_end, set_tile_end);
}

// chainTiles (src/gap_util.cpp:1177)
static inline void chain_tiles(std::vector<u64>& tiles, i64 read_len,
                               i64 thd_gather_block_gap_size, const GapParms& gp) {
    std::vector<PII> str_ends_p;
    gather_blocks_tiles(tiles, read_len, thd_gather_block_gap_size, str_ends_p);
    ChainScoreParms parms;
    chain_blocks_cords(tiles, str_ends_p, gap_block_score_fn(gp.chn_score2.score_sel),
                       parms, gp.chn_score2.thd_min_chain_len,
                       gp.chn_score2.thd_abort_score, read_len, 64,
                       gp.thd_cts_major_limit, false, remove_tile_sgn_end,
                       set_tile_end);
}

// g_CreateChainsFromAnchors_ (src/gap_util.cpp:1191)
static inline void g_create_chains_from_anchors(std::vector<u64>& anchors,
                                                std::vector<u64>& tiles,
                                                u64 gap_str, u64 gap_end,
                                                i64 read_len, const GapParms& gp) {
    const i64 thd_anchor_gap_size = 100;
    // std::sort desc by g_hs_anchor_getX (src/gap_util.cpp:1201)
    std::sort(anchors.begin(), anchors.end(),
              [](u64 a, u64 b) { return ganchor_x(a) > ganchor_x(b); });
    std::vector<std::vector<u64>> chains;
    ChainScoreParms parms;
    {
        auto gax = [](u64 a) { return ganchor_x(a); };
        auto run = [&](auto sf) {
            chain_anchors_base(anchors, 0, (i64)anchors.size(), 20, 80, 20, 0.7,
                               gp.chn_score1.thd_min_chain_len,
                               gp.chn_score1.thd_abort_score, sf, parms, gax,
                               chains, nullptr);
        };
        switch (gp.chn_score1.score_sel) {
            case 0:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_gap_anchors_chain_score(a, b, p);
                });
                break;
            case 1:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_gap_anchors_chain_score2(a, b, p);
                });
                break;
            default:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_extend_clip_score(a, b, p);
                });
        }
    }
    tiles.clear();
    for (auto& chain : chains) {
        for (u64 a : chain) tiles.push_back(ganchor2tile(a));
        tiles.back() = set_tile_end(tiles.back());
    }
    chain_tiles(tiles, read_len, thd_anchor_gap_size, gp);
}

// getClosestExtensionChain_ (src/gap_util.cpp:1227)
static inline PII get_closest_extension_chain(std::vector<u64>& tmp_tiles,
                                              u64 gap_str, u64 gap_end,
                                              bool f_erase, const GapParms& gp) {
    i64 pre_i = 0;
    for (i64 i = 0; i < (i64)tmp_tiles.size(); i++) {
        if (is_tile_end(tmp_tiles[i])) {
            i64 danchor = 0, dx = 0, dy = 0;
            if (gp.direction < 0) {
                dy = tile_y(gap_end) - tile_y(tmp_tiles[i]);
                dx = tile_x(gap_end) - tile_x(tmp_tiles[i]);
                danchor = dx - dy;
            } else if (gp.direction > 0) {
                dy = tile_y(tmp_tiles[pre_i]) - tile_y(gap_str);
                dx = tile_x(tmp_tiles[pre_i]) - tile_x(gap_str);
                danchor = dx - dy;
            }
            if (std::abs(danchor) < gp.thd_ctfas2_connect_danchor &&
                std::max(std::abs(dy), std::abs(dx)) < gp.thd_ctfas2_connect_dy_dx) {
                if (f_erase) {
                    tmp_tiles.resize(i + 1);
                    tmp_tiles.erase(tmp_tiles.begin(), tmp_tiles.begin() + pre_i);
                    return {0, (i64)tmp_tiles.size()};
                }
                return {pre_i, i + 1};
            }
            pre_i = i + 1;
        }
    }
    if (f_erase) tmp_tiles.clear();
    return {0, 0};
}

// g_CreateTilesFromChains_ single-output (src/gap_util.cpp:1275)
static inline void g_create_tiles_from_chains1(const std::vector<u64>& chains,
                                               std::vector<u64>& tiles,
                                               const GapContext& cx_, u64 gap_str,
                                               u64 gap_end, i64 it_str, i64 it_end,
                                               const GapParms& gp) {
    if (it_end - it_str == 0) return;
    u64 pre_chain = chains[it_str];
    u64 pre_tile = 0;
    i64 tmp_shift = gp.thd_tile_size / 2;
    i64 step = gp.thd_tile_size / 3;
    i64 kcount = 0;
    i64 scan_str = it_str;
    i64 scan_end = it_str;
    for (i64 i = it_str; i <= it_end; i++) {
        if (i == it_end || tile_strand(chains[i] ^ pre_chain) ||
            tile_x(chains[i]) > tile_x(pre_chain) + step ||
            tile_y(chains[i]) > tile_y(pre_chain) + step) {
            if (i == it_end) scan_end = it_end;
            for (i64 j = scan_end - 1; j >= scan_str; j--) {
                u64 new_tile =
                    make_cord(cid(gap_str), tile_x(chains[j]) - tmp_shift,
                              tile_y(chains[j]) - tmp_shift, tile_strand(chains[j]));
                u64 lower_tile = tiles.empty() ? gap_str : tiles.back();
                u64 upper_tile = gap_end;
                i64 score;
                new_tile = get_tile_f_tri(cx_, new_tile, tile_x(lower_tile),
                                          tile_y(lower_tile), tile_x(upper_tile),
                                          tile_y(upper_tile), gp.thd_tile_size,
                                          &score);
                if (kcount >= gp.thd_ctfcs_pattern_in_window && score <= 32 &&
                    tile_y(new_tile) > tile_y(pre_tile)) {
                    if (tiles.empty() || is_tile_end(tiles.back()))
                        new_tile = set_tile_start(new_tile);
                    tiles.push_back(new_tile);
                    pre_tile = new_tile;
                    kcount = i - j;
                    pre_chain = chains[j];
                    break;
                }
            }
            scan_str = i;
            scan_end = i + 1;
        } else {
            scan_end++;
            kcount++;
        }
    }
    if (!tiles.empty()) tiles.back() = set_tile_end(tiles.back());
}

// g_CreateTilesFromChains_ two-output (src/gap_util.cpp:1364)
static inline void g_create_tiles_from_chains2(const std::vector<u64>& chains,
                                               std::vector<u64>& tiles_str,
                                               std::vector<u64>& tiles_end,
                                               const GapContext& cx_, u64 gap_str,
                                               u64 gap_end, i64 it_str, i64 it_end,
                                               const GapParms& gp) {
    std::vector<u64> tmp_str, tmp_end;
    g_create_tiles_from_chains1(chains, tmp_str, cx_, gap_str, gap_end, it_str,
                                it_end, gp);
    if (tmp_str.empty()) return;
    i64 tile_size = gp.thd_tile_size;
    for (i64 i = 0; i < (i64)tmp_str.size(); i++) {
        i64 dx1 = tile_x(chains[it_str]) - tile_x(tmp_str[i]);
        i64 dy1 = tile_y(chains[it_str]) - tile_y(tmp_str[i]);
        if (dx1 <= 0 && dy1 <= 0) {
            if (dx1 == 0 && dy1 == 0) break;
            u64 new_head = remove_tile_sgn(
                make_cord(cid(gap_str), tile_x(chains[it_str]),
                          tile_y(chains[it_str]), tile_strand(chains[it_str])));
            if (i == 0) {
                tmp_str.insert(tmp_str.begin(), new_head);
            } else {
                tmp_str[i - 1] = new_head;
                tmp_str.erase(tmp_str.begin(), tmp_str.begin() + (i - 1));
            }
            break;
        }
        if (i == (i64)tmp_str.size() - 1) {
            tmp_str.clear();
            tmp_str.push_back(make_cord(cid(gap_str), tile_x(chains[it_str]),
                                        tile_y(chains[it_str]),
                                        tile_strand(chains[it_str])));
        }
    }
    tmp_end.resize(tmp_str.size());
    for (size_t i = 0; i < tmp_str.size(); i++)
        tmp_end[i] = shiftc(tmp_str[i], tile_size, tile_size);
    for (i64 i = (i64)tmp_end.size() - 1; i >= 0; i--) {
        i64 dx1 = tile_x(chains[it_end - 1]) - tile_x(tmp_end[i]);
        i64 dy1 = tile_y(chains[it_end - 1]) - tile_y(tmp_end[i]);
        if (dx1 >= 0 && dy1 >= 0) {
            if (dx1 == 0 && dy1 == 0) break;
            tmp_str.resize(i + 1);
            tmp_end.resize(i + 1);
            u64 new_tail_end = make_cord(cid(gap_str), tile_x(chains[it_end - 1]),
                                         tile_y(chains[it_end - 1]),
                                         tile_strand(chains[it_end - 1]));
            u64 new_tail_str = shiftc(new_tail_end, -tile_size, -tile_size);
            if (is_tile_end(tmp_str[i])) {
                tmp_str[i] = remove_tile_sgn(tmp_str[i]);
                tmp_end[i] = remove_tile_sgn(tmp_end[i]);
                new_tail_str = set_tile_end(new_tail_str);
                new_tail_end = set_tile_end(new_tail_end);
            }
            tmp_str.push_back(new_tail_str);
            tmp_end.push_back(new_tail_end);
            break;
        }
        if (i == 0) {
            tmp_str.resize(1);
            tmp_end.resize(1);
            tmp_end[0] = shiftc(tmp_end[0], dx1, dy1);
        }
    }
    tiles_str.insert(tiles_str.end(), tmp_str.begin(), tmp_str.end());
    tiles_end.insert(tiles_end.end(), tmp_end.begin(), tmp_end.end());
}

// extendPatch (src/pmpfinder.cpp:2881)
static inline i64 extend_patch(const GapContext& cx_, std::vector<u64>& cords,
                               i64 kk, u64 cord1, u64 cord2, i64 revscomp_const,
                               i64 overlap_size, i64 gap_size,
                               i64 thd_accept_score) {
    double score = 0.0;
    int s1 = cstrand(cord1), s2 = cstrand(cord2);
    if (std::abs(cxid(cord1) - cxid(cord2)) < overlap_size &&
        std::abs(cy(cord1) - cy(cord2)) < overlap_size && !(s1 ^ s2))
        return 0;
    u64 pcord = cord1;
    u64 scord = cord2;
    int strand1 = cstrand(pcord);
    int strand2 = cstrand(scord);
    i64 gid1 = cid(pcord);
    i64 gid2 = cid(scord);
    i64 ln = 0;
    u64 cord = pcord;
    std::vector<u64> tmp;
    i64 x_bound = cx(scord);
    i64 y_bound = cy(scord);
    i64 d;
    while (cxid(cord) + gap_size <= cxid(scord)) {  // isPreGap
        cord = next_window(cx_.f1[strand1], *cx_.f2[gid1], cord, &d);
        score += (double)d;
        if (cord && cy(cord) < y_bound && cx(cord) < x_bound &&
            score < (double)thd_accept_score)
            tmp.push_back(cord);
        else
            break;
    }
    u64 nw = pcord;
    if (!tmp.empty()) {
        ln += (i64)tmp.size();
        nw = tmp.back();
        cords.insert(cords.begin() + kk, tmp.begin(), tmp.end());
        x_bound = cx(tmp.back());
        y_bound = cy(tmp.back());
        tmp.clear();
    } else {
        x_bound = cx(pcord);
        y_bound = cy(pcord);
    }
    cord = scord;
    while (cxid(nw) + gap_size <= cxid(cord)) {  // isSucGap
        cord = previous_window(cx_.f1[strand2], *cx_.f2[gid2], cord, &d);
        score += (double)d;
        if (cord && cy(cord) > y_bound && cx(cord) > x_bound &&
            score < (double)thd_accept_score)
            tmp.push_back(cord);
        else
            break;
    }
    if (!tmp.empty()) {
        std::reverse(tmp.begin(), tmp.end());
        cords.insert(cords.begin() + kk + ln, tmp.begin(), tmp.end());
        ln += (i64)tmp.size();
    }
    return ln;
}

// trimTiles (src/gap_util.cpp:1498)
static inline void trim_tiles(std::vector<u64>& tiles, const GapContext& cx_,
                              u64 gap_str, u64 gap_end, i64 revscomp_const,
                              int direction, const GapParms& gp) {
    i64 thd_gap_size = gp.thd_tts_gap_size;
    i64 thd_tile_size = gp.thd_tile_size;
    i64 thd_overlap_size = gp.thd_tts_overlap_size;
    u64 cord_str = gap_str;
    i64 shift_x = std::min(cx(gap_end) - cx(gap_str), thd_tile_size);
    i64 shift_y = std::min(cy(gap_end) - cy(gap_str), thd_tile_size);
    u64 cord_end = shiftc(gap_end, -shift_x, -shift_y);
    i64 i = 0;
    while (i < (i64)tiles.size()) {
        if (is_tile_start(tiles[i]) && direction >= 0) {
            i64 new_num = extend_patch(cx_, tiles, i, cord_str, tiles[i],
                                       revscomp_const, thd_overlap_size,
                                       thd_gap_size, gp.thd_accept_score);
            if (new_num) {
                tiles[i] = set_tile_start(tiles[i]);
                i += new_num;
                tiles[i] = remove_tile_sgn_start(tiles[i]);
            }
        }
        if (is_tile_end(tiles[i]) && direction <= 0) {
            i64 new_num = extend_patch(cx_, tiles, i + 1, tiles[i], cord_end,
                                       revscomp_const, thd_overlap_size,
                                       thd_gap_size, gp.thd_accept_score);
            if (new_num) {
                tiles[i] = remove_tile_sgn_end(tiles[i]);
                i += new_num;
                tiles[i] = set_tile_end(tiles[i]);
            }
        }
        if (i >= 1 && !is_tile_end(tiles[i - 1]) && !is_tile_start(tiles[i]))
            i += extend_patch(cx_, tiles, i, tiles[i - 1], tiles[i], revscomp_const,
                              thd_overlap_size, thd_gap_size, gp.thd_accept_score);
        i++;
    }
    i64 x_str = tile_x(gap_str);
    i64 y_str = tile_y(gap_str);
    i64 x_end = cx(gap_end);
    i64 y_end = cy(gap_end);
    i64 di = 0;
    for (i64 k = 0; k < (i64)tiles.size(); k++) {
        i64 x_t = tile_x(tiles[k]);
        i64 y_t = tile_strand(tiles[k] ^ gap_str)
                      ? revscomp_const - 1 - tile_y(tiles[k]) - thd_tile_size
                      : tile_y(tiles[k]);
        if (x_t < x_str || x_t + thd_tile_size > x_end || y_t < y_str ||
            y_t + thd_tile_size > y_end) {
            if (is_tile_start(tiles[k]) && is_tile_end(tiles[k])) {
            } else if (is_tile_start(tiles[k])) {
                if (k + 1 < (i64)tiles.size())
                    tiles[k + 1] = set_tile_start(tiles[k + 1]);
            } else if (is_tile_end(tiles[k])) {
                if (k - di - 1 > 0) tiles[k - di - 1] = set_tile_end(tiles[k - di - 1]);
            }
            di++;
        } else {
            tiles[k - di] = tiles[k];
        }
    }
    if (di) tiles.resize(tiles.size() - di);
}

// --------------------------------------------------------- along-chain map

// mapAlongChain (src/gap_util.cpp:3320) for tile chains
static inline void map_along_chain(const GapContext& cx_, const u8* seq1,
                                   i64 seq1_len, const u8* seq2, i64 seq2_len,
                                   const std::vector<u64>& chains,
                                   std::vector<u64>& tiles, i64 i_str, i64 i_end,
                                   i64 shape_len, i64 step1, i64 step2,
                                   GapParms& gp) {
    if (chains.empty() || i_str < 0 || i_end > (i64)chains.size() || i_end <= i_str)
        return;
    std::vector<u64> hs;
    std::vector<u64> anchors;
    i64 anchor_str = tile_x(chains[i_str]) - tile_y(chains[i_str]);
    i64 anchor_end = tile_x(chains[i_end - 1]) - tile_y(chains[i_end - 1]);
    c_stream(seq1, seq1_len, hs, tile_x(chains[i_str]), tile_x(chains[i_end - 1]),
             step1, (int)shape_len, 0);
    c_stream(seq2, seq2_len, hs, tile_y(chains[i_str]), tile_y(chains[i_end - 1]),
             step2, (int)shape_len, 1);
    c_create_anchors2(hs, anchors, (i64)hs.size(),
                      std::min(anchor_str, anchor_end) - 30,
                      std::max(anchor_str, anchor_end) + 30);
    // std::sort desc by g_hs_anchor_getX (src/gap_util.cpp:3349)
    std::sort(anchors.begin(), anchors.end(),
              [](u64 a, u64 b) { return ganchor_x(a) > ganchor_x(b); });
    stick_main_chain(anchors, chains, ganchor_x, ganchor_y, tile_x, tile_y, gp);
    std::vector<std::vector<u64>> chains_out;
    ChainScoreParms parms;
    {
        auto gax = [](u64 a) { return ganchor_x(a); };
        auto run = [&](auto sf) {
            chain_anchors_base(anchors, 0, (i64)anchors.size(), 15, 30, 1, 0.7,
                               gp.chn_ext_clip_metric1.thd_min_chain_len,
                               gp.chn_ext_clip_metric1.thd_abort_score, sf,
                               parms, gax, chains_out, nullptr);
        };
        switch (gp.chn_ext_clip_metric1.score_sel) {
            case 0:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_gap_anchors_chain_score(a, b, p);
                });
                break;
            case 1:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_gap_anchors_chain_score2(a, b, p);
                });
                break;
            default:
                run([](u64 a, u64 b, const ChainScoreParms& p) {
                    return get_extend_clip_score(a, b, p);
                });
        }
    }
    if (!chains_out.empty()) {
        int f_strand = tile_strand(chains[0]);
        for (u64 a : chains_out[0]) {
            u64 new_tile = ganchor2tile(a);
            if (f_strand) new_tile = set_tile_strand(new_tile);
            tiles.push_back(new_tile);
        }
    }
}

// remapChainOneEnd (src/gap_util.cpp:3761)
static inline void remap_chain_one_end(const GapContext& cx_, const u8* ref,
                                       i64 ref_len, std::vector<u64>& chain,
                                       i64 shape_len, i64 step1, i64 step2,
                                       i64 remap_num, int direction, GapParms& gp) {
    if (!direction || chain.empty()) return;
    const u8* seq2 = tile_strand(chain[0]) ? cx_.comstr : cx_.read;
    std::vector<u64> remap;
    i64 i_str, i_end;
    if (direction <= 0) {
        i_str = std::max((i64)0, (i64)chain.size() - remap_num);
        i_end = (i64)chain.size();
    } else {
        i_str = 0;
        i_end = std::min((i64)chain.size(), remap_num);
    }
    map_along_chain(cx_, ref, ref_len, seq2, cx_.read_len, chain, remap, i_str,
                    i_end, shape_len, step1, step2, gp);
    clip_chain(remap, shape_len, direction, true, tile_x, tile_y, gp);
    if (direction <= 0) {
        chain.erase(chain.begin(), chain.begin() + i_end);
        if (!remap.empty()) chain.insert(chain.begin(), remap.begin(), remap.end());
    } else {
        if (!remap.empty()) {
            chain.resize(i_str);
            chain.insert(chain.end(), remap.begin(), remap.end());
        }
    }
}

// reExtendChainOneSide (src/gap_util.cpp:3832)
static inline i64 re_extend_chain_one_side(const GapContext& cx_, const u8* ref,
                                           i64 ref_len, std::vector<u64>& chain,
                                           i64 i_ptr_str, i64 i_ptr_end, i64 lower,
                                           i64 upper, i64 shape_len, i64 step1,
                                           i64 step2, int direction, GapParms& gp) {
    if (chain.empty() || i_ptr_str < 0 || i_ptr_end < 0) return 0;
    i64 ln = (i64)chain.size();
    std::vector<u64> reextend;
    i64 i_str, i_end;
    if (direction <= 0) {
        i64 d = -std::min(std::min(cx(chain[i_ptr_str]), tile_y(chain[i_ptr_str])),
                          lower);
        i64 ii = i_ptr_str;
        while (ii < i_ptr_end) {
            if (tile_x(chain[ii]) - cx(chain[i_ptr_str]) >= upper) break;
            ii++;
        }
        reextend.assign(ii - i_ptr_str + 2, 0);
        reextend[0] = shiftc(chain[i_ptr_str], d, d);
        for (i64 i = 0; i < ii - i_ptr_str + 1; i++)
            reextend[i + 1] = chain[i_ptr_str + i];
        i_str = i_ptr_str;
        i_end = ii + 1;
    } else if (direction > 0) {
        i64 d = std::min(std::min(ref_len - cx(chain[i_ptr_end]) - 1,
                                  cx_.read_len - cy(chain[i_ptr_end]) - 1),
                         upper);
        i64 ii = i_ptr_end;
        while (ii > i_ptr_str) {
            if (tile_x(chain[i_ptr_end]) - tile_x(chain[ii]) >= lower) break;
            ii--;
        }
        reextend.assign(i_ptr_end - ii + 2, 0);
        for (i64 i = 0; i < i_ptr_end - ii + 1; i++) reextend[i] = chain[ii + i];
        reextend.back() = shiftc(chain[i_ptr_end], d, d);
        i_str = ii;
        i_end = i_ptr_end + 1;
    } else {
        return 0;
    }
    remap_chain_one_end(cx_, ref, ref_len, reextend, shape_len, step1, step2,
                        (i64)reextend.size(), direction, gp);
    chain.erase(chain.begin() + i_str, chain.begin() + i_end);
    chain.insert(chain.begin() + i_str, reextend.begin(), reextend.end());
    return (i64)chain.size() - ln;
}

// reExtendClipOneSide (src/gap_util.cpp:4129)
static inline i64 re_extend_clip_one_side(const GapContext& cx_, const u8* ref,
                                          i64 ref_len, std::vector<u64>& chain,
                                          u64 extend_lower_cord,
                                          u64 extend_upper_cord, i64 i_ptr_str,
                                          i64 i_ptr_end, int direction,
                                          GapParms& gp) {
    if (chain.empty() || i_ptr_str < 0 || i_ptr_end < 0) return 0;
    i64 lower = 60, upper = 60;
    i64 shape_len = gp.thd_etfas_shape_len;
    i64 step1 = gp.thd_etfas_step1;
    i64 step2 = gp.thd_etfas_step2;
    if (direction <= 0) {
        i64 dx = tile_x(chain[i_ptr_str]) - tile_x(extend_lower_cord);
        i64 dy = (tile_strand(chain[i_ptr_str] ^ extend_lower_cord))
                     ? tile_y(extend_upper_cord) - cx_.read_len +
                           tile_y(chain[i_ptr_str])
                     : tile_y(chain[i_ptr_str]) - tile_y(extend_lower_cord);
        lower = std::min(std::min(dx, dy), lower);
    } else if (direction > 0) {
        i64 dx = tile_x(extend_upper_cord) - 1 - tile_x(chain[i_ptr_end]);
        i64 dy = (tile_strand(chain[i_ptr_end] ^ extend_upper_cord))
                     ? cx_.read_len - 1 - tile_y(chain[i_ptr_end]) -
                           tile_y(extend_lower_cord)
                     : tile_y(extend_upper_cord) - tile_y(chain[i_ptr_end]);
        upper = std::min(std::min(dx, dy), upper);
    }
    return re_extend_chain_one_side(cx_, ref, ref_len, chain, i_ptr_str, i_ptr_end,
                                    lower, upper, shape_len, step1, step2,
                                    direction, gp);
}

// --------------------------------------------------- tiles from anchors

// createTilesFromAnchors2_ (src/gap_util.cpp:4171)
static inline void create_tiles_from_anchors2(const GapContext& cx_, const u8* ref,
                                              i64 ref_len,
                                              std::vector<u64>& anchors,
                                              std::vector<u64>& tiles_str,
                                              std::vector<u64>& tiles_end,
                                              u64 gap_str, u64 gap_end,
                                              i64 read_len, int direction,
                                              GapParms& gp) {
    std::vector<u64> tmp_tiles;
    g_create_chains_from_anchors(anchors, tmp_tiles, gap_str, gap_end, read_len, gp);
    i64 pre_i = 0;
    i64 i = 0;
    while (i < (i64)tmp_tiles.size()) {
        if (is_tile_end(tmp_tiles[i])) {
            u64 head_tile = tmp_tiles[pre_i];
            u64 tail_tile = tmp_tiles[i];
            i += re_extend_clip_one_side(cx_, ref, ref_len, tmp_tiles, gap_str,
                                         gap_end, pre_i, i, -1, gp);
            i += re_extend_clip_one_side(cx_, ref, ref_len, tmp_tiles, gap_str,
                                         gap_end, pre_i, i, 1, gp);
            if (!(tmp_tiles.empty() || pre_i < 0 || i < 0)) {
                tmp_tiles[pre_i] = copy_tile_sgn(head_tile, tmp_tiles[pre_i]);
                tmp_tiles[i] = copy_tile_sgn(tail_tile, tmp_tiles[i]);
                g_create_tiles_from_chains2(tmp_tiles, tiles_str, tiles_end, cx_,
                                            gap_str, gap_end, pre_i, i + 1, gp);
            }
            pre_i = i + 1;
        } else if (i < (i64)tmp_tiles.size() - 1 &&
                   tile_strand(tmp_tiles[i] ^ tmp_tiles[i + 1])) {
            i64 ln = (i64)tiles_str.size();
            u64 head_tile = tmp_tiles[pre_i];
            u64 tail_tile = tmp_tiles[i];
            i += re_extend_clip_one_side(cx_, ref, ref_len, tmp_tiles, gap_str,
                                         gap_end, pre_i, i, -1, gp);
            i += re_extend_clip_one_side(cx_, ref, ref_len, tmp_tiles, gap_str,
                                         gap_end, pre_i, i, 1, gp);
            if (!(tmp_tiles.empty() || pre_i < 0 || i < 0)) {
                tmp_tiles[pre_i] = copy_tile_sgn(head_tile, tmp_tiles[pre_i]);
                tmp_tiles[i] = copy_tile_sgn(tail_tile, tmp_tiles[i]);
                g_create_tiles_from_chains2(tmp_tiles, tiles_str, tiles_end, cx_,
                                            gap_str, gap_end, pre_i, i + 1, gp);
                if (ln != (i64)tiles_str.size()) {
                    tiles_str.back() = remove_tile_sgn_end(tiles_str.back());
                    tiles_end.back() = remove_tile_sgn_end(tiles_end.back());
                }
            }
            pre_i = i + 1;
        }
        i++;
    }
}

// ----------------------------------------------------- gap anchor filters

// _createGapAnchorsList (src/gap_util.cpp:4275)
static inline void create_gap_anchors_list(std::vector<u64>& anchors,
                                           i64 thd_anchor_accept_density,
                                           i64 thd_anchor_accept_min,
                                           i64 thd_anchor_err_bit,
                                           std::vector<PII>& out) {
    out.clear();
    if (anchors.size() <= 1) return;
    anchors[0] = 0;
    // std::sort asc by getStrAnchor in uint64 arithmetic: the zeroed
    // anchors[0] underflows to 2^64 - 2^20 and sorts LAST
    std::sort(anchors.begin(), anchors.end(),
              [](u64 a, u64 b) { return ganchor_sa_u64(a) < ganchor_sa_u64(b); });
    u64 ak2 = anchors[1];
    i64 block_str = 1;
    i64 count_anchors = 0;
    u64 min_y = ~0ull, max_y = 0;
    i64 n = (i64)anchors.size();
    for (i64 i = 1; i < n; i++) {
        u64 anc_y = (u64)ganchor_y(anchors[i]);
        i64 dy2 = std::abs((i64)anc_y - ganchor_y(ak2));
        bool f_continuous = (ganchor_sa_u64(anchors[i]) - ganchor_sa_u64(ak2)) <
                            (u64)(dy2 >> thd_anchor_err_bit);
        if (f_continuous) {
            if (min_y > anc_y) min_y = anc_y;
            if (max_y < anc_y) max_y = anc_y;
            ak2 = anchors[(block_str + i) >> 1];
            count_anchors++;
        }
        if (!f_continuous || i == n - 1) {
            i64 thd_accept =
                std::max((i64)(((max_y - min_y) * (u64)thd_anchor_accept_density) >> 10),
                         thd_anchor_accept_min);
            if (count_anchors > thd_accept) out.push_back({block_str, i});
            block_str = i;
            ak2 = anchors[i];
            min_y = anc_y;
            max_y = anc_y;
            count_anchors = 1;
        }
    }
}

// _filterGapAnchorsList (src/gap_util.cpp:4332)
static inline void filter_gap_anchors_list(const std::vector<u64>& anchors,
                                           std::vector<PII>& anchors_list,
                                           const GapParms& gp) {
    if (anchors_list.empty()) return;
    const double thd_fgal_median = 1.5;
    const double thd_sig_median1 = 1.5;
    const i64 thd_sig_median2 = 20;
    const i64 thd_min_len1 = 1000;
    const i64 thd_min_len2 = 10;
    const i64 thd_max_len1 = 5;
    const i64 thd_max_len2 = 2000;
    // std::sort desc by range length (src/gap_util.cpp:4356)
    std::sort(anchors_list.begin(), anchors_list.end(),
              [](const PII& a, const PII& b) {
                  return (a.second - a.first) > (b.second - b.first);
              });
    if ((i64)anchors.size() > thd_min_len1 &&
        (i64)anchors_list.size() > thd_min_len2) {
        i64 i_median = (i64)anchors_list.size() / 2;
        i64 l_median = anchors_list[i_median].second - anchors_list[i_median].first;
        i64 l_max = anchors_list[0].second - anchors_list[0].first;
        if ((double)l_max > (double)l_median * thd_sig_median1 &&
            l_max > l_median + thd_sig_median2) {
            i64 it = 0;
            i64 break_value = (i64)((double)(anchors_list[i_median].second -
                                             anchors_list[i_median].first) *
                                    thd_fgal_median);
            i64 l_s = 0;
            for (i64 i = 0; i < std::min(thd_max_len1, (i64)anchors_list.size());
                 i++) {
                it++;
                i64 l_i = anchors_list[i].second - anchors_list[i].first;
                l_s += l_i;
                if (l_i < break_value || l_s > thd_max_len2) break;
            }
            anchors_list.resize(it);
        } else {
            anchors_list.clear();
        }
    }
}

// filterGapAnchors (src/gap_util.cpp:4416)
static inline void filter_gap_anchors(std::vector<u64>& anchors, u64 gap_str,
                                      u64 gap_end, int direction,
                                      const GapParms& gp) {
    std::vector<PII> alist;
    create_gap_anchors_list(anchors, 20, 20, 0, alist);
    filter_gap_anchors_list(anchors, alist, gp);
    // ALIASED in-place compaction: alist is length-sorted (not index-sorted),
    // so later ranges may read positions already overwritten — the reference
    // does exactly this and the output depends on it
    i64 it = 0;
    for (auto& r : alist)
        for (i64 j = r.first; j < r.second; j++) anchors[it++] = anchors[j];
    anchors.resize(it);
}

}  // namespace le
