// Gap module part 2: one-side / two-sided extension, mapExtend(s),
// mapInterval/mapGeneric, tile reform + splice, mapGaps, reformCords.
// (continues le_gap.hpp; reference lines cited per function)
#pragma once
#include "le_gap.hpp"

namespace le {

// extendTilesOneSide (src/gap_util.cpp:3920)
static inline void extend_tiles_one_side(const GapContext& cx_, const u8* ref,
                                         i64 ref_len, std::vector<u64>& anchors,
                                         std::vector<u64>& tiles, u64 gap_str,
                                         u64 gap_end, i64 read_len, int direction,
                                         GapParms& gp) {
    int original_direction = gp.direction;
    std::vector<u64> chain;
    gp.direction = direction;
    g_create_chains_from_anchors(anchors, chain, gap_str, gap_end, read_len, gp);
    get_closest_extension_chain(chain, gap_str, gap_end, true, gp);
    i64 shape_len = gp.thd_etfas_shape_len;
    i64 step1 = gp.thd_etfas_step1;
    i64 step2 = gp.thd_etfas_step2;
    const i64 remap_num = 50;
    remap_chain_one_end(cx_, ref, ref_len, chain, shape_len, step1, step2,
                        remap_num, direction, gp);
    g_create_tiles_from_chains1(chain, tiles, cx_, gap_str, gap_end, 0,
                                (i64)chain.size(), gp);
    trim_tiles(tiles, cx_, gap_str, gap_end, read_len - 1, direction, gp);
    gp.direction = original_direction;
}

// extendIntervalOneSide (src/gap_util.cpp:3953)
static inline int extend_interval_one_side(const GapContext& cx_, const u8* ref,
                                           i64 ref_len, std::vector<u64>& tiles,
                                           u64 gap_str, u64 gap_end, int direction,
                                           GapParms& gp) {
    if (cstrand(gap_str ^ gap_end)) return 1;
    int original_direction = gp.direction;
    int shape_len = (int)gp.thd_eis_shape_len;
    i64 step1 = gp.thd_eis_step1;
    i64 step2 = gp.thd_eis_step2;
    gp.direction = direction;
    std::vector<u64> g_hs, anchors;
    // g_stream_ (src/gap_util.cpp:1663)
    {
        i64 gs_str = cx(gap_str), gs_end = cx(gap_end);
        i64 gr_str = cy(gap_str), gr_end = cy(gap_end);
        if (cstrand(gap_str)) {
            gr_str = cx_.read_len - gr_str - 1;
            gr_end = cx_.read_len - gr_end - 1;
            std::swap(gr_str, gr_end);
        }
        g_map_hs_kmer(ref, ref_len, g_hs, gs_str, gs_end, shape_len, step1, 0);
        g_map_hs_kmer(cx_.read, cx_.read_len, g_hs, gr_str, gr_end, shape_len,
                      step2, 1);
    }
    g_create_anchors(g_hs, anchors, shape_len, direction, 0, 0, cx_.read_len - 1,
                     gap_str, gap_end, gp);
    extend_tiles_one_side(cx_, ref, ref_len, anchors, tiles, gap_str, gap_end,
                          cx_.read_len, direction, gp);
    gp.direction = original_direction;
    return 0;
}

// getExtendsIntervalChainsOverlaps (src/gap_util.cpp:3272)
static inline PII get_extends_interval_chains_overlaps(
    const std::vector<u64>& chain1, const std::vector<u64>& chain2,
    TileGetFn get_x, TileGetFn get_y, const GapParms& gp) {
    if (chain1.empty() || chain2.empty()) return {(i64)chain1.size(), 0};
    i64 x2 = get_x(chain2[0]);
    i64 y2 = get_y(chain2[0]);
    x2 = x2 > gp.thd_dcomx_err_dx ? x2 - gp.thd_dcomx_err_dx : 0;
    y2 = y2 > gp.thd_dcomx_err_dy ? y2 - gp.thd_dcomx_err_dy : 0;
    i64 i1 = 0;
    for (i64 i = (i64)chain1.size() - 1; i >= 0; i--) {
        if (get_x(chain1[i]) < x2 && get_y(chain1[i]) < y2) {
            i1 = i + 1;
            break;
        }
    }
    i64 x1 = get_x(chain1.back()) + gp.thd_dcomx_err_dx;
    i64 y1 = get_y(chain1.back()) + gp.thd_dcomx_err_dy;
    x1 = (gp.ref_len - x1 > gp.thd_dcomx_err_dx) ? x1 + gp.thd_dcomx_err_dx
                                                 : gp.ref_len;
    y1 = (gp.read_len - y1 > gp.thd_dcomx_err_dy) ? y1 + gp.thd_dcomx_err_dy
                                                  : gp.read_len;
    i64 i2 = (i64)chain2.size();
    for (i64 i = 0; i < (i64)chain2.size(); i++) {
        if (get_x(chain2[i]) > x1 && get_y(chain2[i]) > y1) {
            i2 = i;
            break;
        }
    }
    return {i1, i2};
}

// __extendsIntervalClipOverlapsInsDel_ (src/gap_util.cpp:3382), f_clip=true.
// NOTE: clips the chains but keeps using the PRE-CLIP score arrays (indices
// misalign for chain2 after its prefix erase) — the reference does this.
static inline void extends_interval_clip_overlaps_insdel_core(
    std::vector<u64>& chain1, std::vector<u64>& chain2, i64 shape_len,
    TileGetFn get_x, TileGetFn get_y, GapParms& gp) {
    if (chain1.empty() || chain2.empty()) return;
    gp.clip_chain_parms(shape_len, gp.thd_err);
    std::vector<i64> gs11, gs12, gs21, gs22;
    accumulate_simple_gap_score1(chain1, shape_len, get_x, gp, gs11);
    accumulate_simple_gap_score1(chain1, shape_len, get_y, gp, gs12);
    accumulate_simple_gap_score1(chain2, shape_len, get_x, gp, gs21);
    accumulate_simple_gap_score1(chain2, shape_len, get_y, gp, gs22);
    clip_chain_(chain1, gs11, gs12, G_MAP_RGHT, true, gp);
    clip_chain_(chain2, gs21, gs22, G_MAP_LEFT, true, gp);
    i64 j1 = 0, j2 = 0, i_clip = 0;
    i64 j_clip = -1;
    i64 j1_pre = 0, j2_pre = 0;
    i64 min_score = (1ll << 31) - 1;
    if (chain1.empty() || chain2.empty()) return;
    i64 x21 = get_x(chain2[0]);
    i64 x22 = get_x(chain2[0]);
    for (i64 i = 0; i < (i64)chain1.size(); i++) {
        i64 x1 = get_x(chain1[i]);
        i64 x2_lower = x1;
        i64 x2_upper = x1 + gp.thd_eicos_clip_dxy;
        i64 j = j1_pre;
        while (j < (i64)chain2.size() && x21 < x2_lower) {
            x21 = get_x(chain2[j]);
            j1 = j;
            j++;
        }
        if (x21 > x2_upper) continue;
        if (x21 < x2_lower) break;
        j = j2_pre;
        while (j < (i64)chain2.size() && x22 <= x2_upper) {
            x22 = get_x(chain2[j]);
            j2 = j;
            j++;
        }
        if (x22 < x2_lower) break;
        if (j1 > j_clip || j2_pre != j2) {
            i64 score11 = i < (i64)gs11.size() ? gs11[i] : 0;
            i64 score12 = i < (i64)gs12.size() ? gs12[i] : 0;
            for (i64 jj = std::max(j1, j2_pre); jj < j2; jj++) {
                if (jj >= (i64)gs21.size()) break;
                i64 score21 = wrap_i32(gs21.back() - gs21[jj]);
                i64 score22 = wrap_i32(gs22.back() - gs22[jj]);
                i64 dxc = get_x(chain2[jj]) - get_x(chain1[i]);
                // int64 compare, then uint64 product truncated to int32
                i64 score_connect =
                    dxc > shape_len
                        ? wrap_i32((i64)((u64)(dxc - shape_len) * (u64)gp.int_precision))
                        : 0;
                i64 score =
                    wrap_i32(score11 + score12 + score21 + score22 + score_connect);
                if (score < min_score) {
                    min_score = score;
                    i_clip = i;
                    j_clip = jj;
                }
            }
        }
        j1_pre = j1;
        j2_pre = j2;
    }
    chain1.resize(i_clip);
    j_clip = j_clip < 0 ? 0 : j_clip;
    chain2.erase(chain2.begin(), chain2.begin() + j_clip);
}

// extendsIntervalClipOverlapsInsDel_ (src/gap_util.cpp:3492)
static inline void extends_interval_clip_overlaps_insdel(
    std::vector<u64>& chain1, std::vector<u64>& chain2, i64 shape_len,
    TileGetFn get_x, TileGetFn get_y, GapParms& gp) {
    if (chain1.empty() && chain2.empty()) return;
    if (chain1.empty()) {
        clip_chain(chain2, shape_len, G_MAP_LEFT, true, get_x, get_y, gp);
    } else if (chain2.empty()) {
        clip_chain(chain1, shape_len, G_MAP_RGHT, true, get_x, get_y, gp);
    } else {
        if (!gp.thd_eicos_f_as_ins) {
            clip_chain(chain1, shape_len, G_MAP_RGHT, true, get_x, get_y, gp);
            clip_chain(chain2, shape_len, G_MAP_LEFT, true, get_x, get_y, gp);
        } else {
            extends_interval_clip_overlaps_insdel_core(chain1, chain2, shape_len,
                                                       get_x, get_y, gp);
        }
    }
}

// extendsIntervalMapOverlaps_ (src/gap_util.cpp:3577)
static inline void extends_interval_map_overlaps(
    const GapContext& cx_, const u8* ref, i64 ref_len, std::vector<u64>& tiles1,
    std::vector<u64>& tiles2, u64 gap_str1, u64 gap_end1, u64 gap_str2,
    u64 gap_end2, i64 shape_len, i64 step1, i64 step2, GapParms& gp) {
    drop_chain_gap_x(tiles1, tile_x, tile_y, G_MAP_RGHT, true, gp);
    drop_chain_gap_x(tiles2, tile_x, tile_y, G_MAP_LEFT, true, gp);
    std::vector<u64> overlap1, overlap2;
    PII overlaps =
        get_extends_interval_chains_overlaps(tiles1, tiles2, tile_x, tile_y, gp);
    if (!tiles1.empty()) {
        const u8* seq2 = tile_strand(tiles1[0]) ? cx_.comstr : cx_.read;
        map_along_chain(cx_, ref, ref_len, seq2, cx_.read_len, tiles1, overlap1,
                        overlaps.first, (i64)tiles1.size(), shape_len, step1,
                        step2, gp);
    }
    if (!tiles2.empty()) {
        const u8* seq2 = tile_strand(tiles2[0]) ? cx_.comstr : cx_.read;
        map_along_chain(cx_, ref, ref_len, seq2, cx_.read_len, tiles2, overlap2, 0,
                        overlaps.second, shape_len, step1, step2, gp);
    }
    // uint64 diagonal comparison (src/gap_util.cpp:3613): negative diffs wrap
    if ((u64)(tile_x(gap_str1) - tile_y(gap_str1)) >
        (u64)(tile_x(gap_end2) - tile_y(gap_end2)))
        extends_interval_clip_overlaps_insdel(overlap1, overlap2, shape_len,
                                              tile_x, tile_y, gp);
    else
        extends_interval_clip_overlaps_insdel(overlap1, overlap2, shape_len,
                                              tile_y, tile_x, gp);
    tiles1.resize(overlaps.first);
    if (!overlap1.empty())
        tiles1.insert(tiles1.end(), overlap1.begin(), overlap1.end());
    tiles2.erase(tiles2.begin(), tiles2.begin() + overlaps.second);
    if (!overlap2.empty())
        tiles2.insert(tiles2.begin(), overlap2.begin(), overlap2.end());
}

// extendsTilesFromAnchors (src/gap_util.cpp:3643)
static inline void extends_tiles_from_anchors(
    const GapContext& cx_, const u8* ref, i64 ref_len, std::vector<u64>& anchors1,
    std::vector<u64>& anchors2, std::vector<u64>& tiles_str1,
    std::vector<u64>& tiles_end1, std::vector<u64>& tiles_str2,
    std::vector<u64>& tiles_end2, u64 gap_str1, u64 gap_end1, u64 gap_str2,
    u64 gap_end2, i64 read_len, GapParms& gp) {
    int original_direction = gp.direction;
    std::vector<u64> tmp1, tmp2;
    gp.direction = G_MAP_RGHT;
    g_create_chains_from_anchors(anchors1, tmp1, gap_str1, gap_end1, read_len, gp);
    get_closest_extension_chain(tmp1, gap_str1, gap_end1, true, gp);
    gp.direction = G_MAP_LEFT;
    g_create_chains_from_anchors(anchors2, tmp2, gap_str2, gap_end2, read_len, gp);
    get_closest_extension_chain(tmp2, gap_str2, gap_end2, true, gp);
    i64 shape_len = gp.thd_etfas_shape_len;
    i64 step1 = gp.thd_etfas_step1;
    i64 step2 = gp.thd_etfas_step2;
    extends_interval_map_overlaps(cx_, ref, ref_len, tmp1, tmp2, gap_str1,
                                  gap_end1, gap_str2, gap_end2, shape_len, step1,
                                  step2, gp);
    g_create_tiles_from_chains2(tmp1, tiles_str1, tiles_end1, cx_, gap_str1,
                                gap_end1, 0, (i64)tmp1.size(), gp);
    g_create_tiles_from_chains2(tmp2, tiles_str2, tiles_end2, cx_, gap_str2,
                                gap_end2, 0, (i64)tmp2.size(), gp);
    gp.direction = original_direction;
}

// extendsInterval (src/gap_util.cpp:3696)
static inline int extends_interval(const GapContext& cx_, const u8* ref,
                                   i64 ref_len, std::vector<u64>& tiles_str1,
                                   std::vector<u64>& tiles_end1,
                                   std::vector<u64>& tiles_str2,
                                   std::vector<u64>& tiles_end2, u64 gap_str1,
                                   u64 gap_end1, u64 gap_str2, u64 gap_end2,
                                   GapParms& gp) {
    if (cstrand(gap_str1 ^ gap_end1) || cstrand(gap_str2 ^ gap_end2) ||
        cstrand(gap_str1 ^ gap_str2))
        return 1;
    int shape_len = (int)gp.thd_eis_shape_len;
    i64 step1 = gp.thd_eis_step1;
    i64 step2 = gp.thd_eis_step2;
    std::vector<u64> g_hs, anchors1, anchors2;
    i64 gid = cid(gap_str1);
    int std_ = cstrand(gap_str1);
    i64 x1 = std::min(cx(gap_str1), cx(gap_str2));
    i64 y1 = std::min(cy(gap_str1), cy(gap_str2));
    i64 x2 = std::max(cx(gap_end1), cx(gap_end1));  // C++ quirk: gap_end1 twice
    i64 y2 = std::max(cy(gap_end1), cy(gap_end2));
    u64 stream_str = make_cord(gid, x1, y1, std_);
    u64 stream_end = make_cord(gid, x2, y2, std_);
    {
        i64 gs_str = cx(stream_str), gs_end = cx(stream_end);
        i64 gr_str = cy(stream_str), gr_end = cy(stream_end);
        if (cstrand(stream_str)) {
            gr_str = cx_.read_len - gr_str - 1;
            gr_end = cx_.read_len - gr_end - 1;
            std::swap(gr_str, gr_end);
        }
        g_map_hs_kmer(ref, ref_len, g_hs, gs_str, gs_end, shape_len, step1, 0);
        g_map_hs_kmer(cx_.read, cx_.read_len, g_hs, gr_str, gr_end, shape_len,
                      step2, 1);
    }
    g_create_extend_anchors_pair(g_hs, anchors1, anchors2, shape_len,
                                 cx_.read_len - 1, gap_str1, gap_end1, gap_str2,
                                 gap_end2, gp);
    extends_tiles_from_anchors(cx_, ref, ref_len, anchors1, anchors2, tiles_str1,
                               tiles_end1, tiles_str2, tiles_end2, gap_str1,
                               gap_end1, gap_str2, gap_end2, cx_.read_len, gp);
    return 0;
}

// ------------------------------------------------------ extend map entry

// mapExtendResultFilter_ (src/gap_util.cpp:3986)
static inline void map_extend_result_filter(std::vector<u64>& tiles_str,
                                            std::vector<u64>& tiles_end,
                                            u64 gap_str, u64 gap_end,
                                            int direction, const GapParms& gp) {
    if (direction >= 0) {
        u64 pre_tile = gap_str;
        for (i64 i = 0; i < (i64)tiles_str.size(); i++) {
            i64 dy = cy(tiles_str[i]) - tile_y(pre_tile);
            i64 dx = cy(tiles_str[i]) - tile_x(pre_tile);  // C++ quirk: y - x
            if (dy > gp.thd_me_reject_gap || dx > gp.thd_me_reject_gap) {
                tiles_str.resize(i);
                if (!tiles_end.empty() && (i64)tiles_end.size() > i)
                    tiles_end.resize(i);
                break;
            }
            pre_tile = tiles_str[i];
        }
    }
    if (direction <= 0) {
        u64 pre_tile = gap_end;
        for (i64 i = (i64)tiles_str.size() - 1; i >= 0; i--) {
            i64 dy = cy(pre_tile) - tile_y(tiles_str[i]);
            i64 dx = cy(pre_tile) - tile_x(tiles_str[i]);  // C++ quirk
            if (dy > gp.thd_me_reject_gap || dx > gp.thd_me_reject_gap) {
                tiles_str.erase(tiles_str.begin(), tiles_str.begin() + i + 1);
                if (!tiles_end.empty() && (i64)tiles_end.size() > i)
                    tiles_end.erase(tiles_end.begin(), tiles_end.begin() + i + 1);
                break;
            }
            pre_tile = tiles_str[i];
        }
    }
}

// reform_tiles (src/gap_util.cpp:3042): head/tail sentinel tiles only (the
// clip pass reform_tiles_ is dead code in the reference, early return :2995)
static inline void reform_tiles(const GapContext& cx_, std::vector<u64>& tiles_str,
                                std::vector<u64>& tiles_end, u64 gap_str,
                                u64 gap_end, int direction, const GapParms& gp) {
    i64 x1 = tile_x(gap_str), x2 = tile_x(gap_end);
    i64 y1 = tile_y(gap_str), y2 = tile_y(gap_end);
    i64 d1, d2;
    if (!tiles_str.empty()) {
        d1 = std::min(std::min(tile_x(tiles_str.back()) - x1,
                               tile_y(tiles_str.back()) - y1),
                      gp.thd_tile_size);
        d2 = std::min(std::min(x2 - tile_x(tiles_str.back()),
                               y2 - tile_y(tiles_str.back())),
                      gp.thd_tile_size);
    } else {
        d1 = d2 = std::min(std::min(x2 - x1, y2 - y1), gp.thd_tile_size);
    }
    u64 head_tile_str = gap_str;
    u64 tail_tile_end = gap_end;
    u64 head_tile_end = shiftc(head_tile_str, d1, d1);
    u64 tail_tile_str = shiftc(tail_tile_end, -d2, -d2);
    head_tile_str = remove_tile_sgn(head_tile_str);
    tail_tile_str = remove_tile_sgn(tail_tile_str);
    head_tile_end = remove_tile_sgn(head_tile_end);
    tail_tile_str = set_tile_end(tail_tile_str);
    tail_tile_end = set_tile_end(tail_tile_end);
    if (!tiles_str.empty()) {
        tail_tile_str = copy_tile_sgn(tiles_str.back(), tail_tile_str);
        head_tile_str = copy_tile_sgn(tiles_str[0], head_tile_str);
        tiles_str.back() = remove_tile_sgn(tiles_str.back());
        tiles_str[0] = remove_tile_sgn(tiles_str[0]);
    }
    if (direction != G_MAP_LEFT) tiles_str.insert(tiles_str.begin(), head_tile_str);
    if (direction != G_MAP_RGHT) tiles_str.push_back(tail_tile_str);
    if (tiles_end.empty()) {
        for (u64 t : tiles_str) {
            i64 d = std::min(std::min(x2 - tile_x(t), y2 - tile_y(t)),
                             gp.thd_tile_size);
            tiles_end.push_back(shiftc(t, d, d));
        }
    } else {
        if (direction != G_MAP_LEFT)
            tiles_end.insert(tiles_end.begin(), head_tile_end);
        if (direction != G_MAP_RGHT) tiles_end.push_back(tail_tile_end);
    }
}

// mapExtend (src/gap_util.cpp:4035)
static inline void map_extend(const GapContext& cx_, std::vector<u64>& tiles_str,
                              std::vector<u64>& tiles_end, u64 gap_str, u64 gap_end,
                              int direction, GapParms& gp) {
    double d_anchor_rate_origin = gp.thd_gmsa_d_anchor_rate;
    gp.direction = direction;
    gp.thd_ctfas2_connect_danchor = 50;
    gp.thd_ctfas2_connect_dy_dx = 150;
    gp.f_gmsa_direction = direction;
    gp.thd_cts_major_limit = 3;
    gp.f_me_map_extend = 1;
    gp.thd_gmsa_d_anchor_rate = 0.25;
    i64 gid = cid(gap_str);
    const u8* ref = cx_.genomes[gid];
    i64 ref_len = cx_.genome_lens[gid];
    extend_interval_one_side(cx_, ref, ref_len, tiles_str, gap_str, gap_end,
                             direction, gp);
    map_extend_result_filter(tiles_str, tiles_end, gap_str, gap_end, direction, gp);
    if (!tiles_str.empty() && direction >= 0)
        tiles_str.back() = remove_tile_sgn_end(tiles_str.back());
    reform_tiles(cx_, tiles_str, tiles_end, gap_str, gap_end, direction, gp);
    gp.f_me_map_extend = 0;
    gp.thd_gmsa_d_anchor_rate = d_anchor_rate_origin;
}

// mapExtends (src/gap_util.cpp:4073)
static inline void map_extends(const GapContext& cx_, std::vector<u64>& tiles_str1,
                               std::vector<u64>& tiles_end1,
                               std::vector<u64>& tiles_str2,
                               std::vector<u64>& tiles_end2, u64 gap_str1,
                               u64 gap_end1, u64 gap_str2, u64 gap_end2,
                               i64 thd_dxy_min, GapParms& gp) {
    gp.thd_ctfas2_connect_danchor = 50;
    gp.thd_ctfas2_connect_dy_dx = 150;
    gp.thd_cts_major_limit = 3;
    gp.f_me_map_extend = 1;
    int original_direction = gp.direction;
    int original_f_rfts_clip = gp.f_rfts_clip;
    gp.f_rfts_clip = 0;
    i64 gid = cid(gap_str1);
    const u8* ref = cx_.genomes[gid];
    i64 ref_len = cx_.genome_lens[gid];
    extends_interval(cx_, ref, ref_len, tiles_str1, tiles_end1, tiles_str2,
                     tiles_end2, gap_str1, gap_end1, gap_str2, gap_end2, gp);
    gp.direction = G_MAP_RGHT;
    map_extend_result_filter(tiles_str1, tiles_end1, gap_str1, gap_end1,
                             G_MAP_RGHT, gp);
    if (!tiles_str1.empty())
        tiles_str1.back() = remove_tile_sgn_end(tiles_str1.back());
    reform_tiles(cx_, tiles_str1, tiles_end1, gap_str1, gap_end1, G_MAP_RGHT, gp);
    gp.direction = G_MAP_LEFT;
    map_extend_result_filter(tiles_str2, tiles_end2, gap_str2, gap_end2,
                             G_MAP_LEFT, gp);
    reform_tiles(cx_, tiles_str2, tiles_end2, gap_str2, gap_end2, G_MAP_LEFT, gp);
    gp.direction = original_direction;
    gp.f_rfts_clip = original_f_rfts_clip;
    gp.f_me_map_extend = 0;
}

// mapInterval (src/gap_util.cpp:4444)
static inline int map_interval(const GapContext& cx_, const u8* seq1, i64 seq1_len,
                               std::vector<u64>& tiles_str,
                               std::vector<u64>& tiles_end, u64 gap_str,
                               u64 gap_end, i64 anchor_lower, i64 anchor_upper,
                               int direction, GapParms& gp, int f_filter) {
    const i64 thd_mi_filter = 1000;
    if (cstrand(gap_str ^ gap_end)) return 1;
    const int shape_len = 9;
    const i64 step1 = 5;
    const i64 step2 = 1;
    std::vector<u64> g_hs, anchors;
    {
        i64 gs_str = cx(gap_str), gs_end = cx(gap_end);
        i64 gr_str = cy(gap_str), gr_end = cy(gap_end);
        if (cstrand(gap_str)) {
            gr_str = cx_.read_len - gr_str - 1;
            gr_end = cx_.read_len - gr_end - 1;
            std::swap(gr_str, gr_end);
        }
        g_map_hs_kmer(seq1, seq1_len, g_hs, gs_str, gs_end, shape_len, step1, 0);
        g_map_hs_kmer(cx_.read, cx_.read_len, g_hs, gr_str, gr_end, shape_len,
                      step2, 1);
    }
    g_create_anchors(g_hs, anchors, shape_len, direction, anchor_lower,
                     anchor_upper, cx_.read_len - 1, gap_str, gap_end, gp);
    if ((i64)anchors.size() > thd_mi_filter && f_filter)
        filter_gap_anchors(anchors, gap_str, gap_end, direction, gp);
    create_tiles_from_anchors2(cx_, seq1, seq1_len, anchors, tiles_str, tiles_end,
                               gap_str, gap_end, cx_.read_len - 1, direction, gp);
    return 0;
}

// mapGeneric (src/gap_util.cpp:4492)
static inline void map_generic(const GapContext& cx_, std::vector<u64>& tiles_str,
                               std::vector<u64>& tiles_end, u64 gap_str,
                               u64 gap_end, GapParms& gp) {
    const int t_direction = 0;
    int f_rfts_clip = gp.f_rfts_clip;
    gp.f_rfts_clip = 0;
    i64 gid = cid(gap_str);
    map_interval(cx_, cx_.genomes[gid], cx_.genome_lens[gid], tiles_str, tiles_end,
                 gap_str, gap_end, LLMIN, LLMAX, t_direction, gp, 1);
    reform_tiles(cx_, tiles_str, tiles_end, gap_str, gap_end, t_direction, gp);
    gp.f_rfts_clip = f_rfts_clip;
}

// ------------------------------------------------------------ splice back

// set_tiles_cords_sgns (src/gap_util.cpp:619)
static inline void set_tiles_cords_sgns(std::vector<u64>& tiles, u64 sgn) {
    for (auto& t : tiles) {
        u64 v = remove_tile_sgn(t);
        v &= ~(1ull << 63);                              // set_cord_gap
        v = sgn ? (v | (1ull << 62)) : (v & ~(1ull << 62));  // set_cord_recd
        t = v;
    }
}

// insert_tiles2Cords_ single-array (src/gap_util.cpp:3148); consumes tiles
static inline i64 insert_tiles2cords_one(std::vector<u64>& cords, i64 pos,
                                         std::vector<u64>& tiles, int direction,
                                         i64 thd_max_segs_num) {
    if (((i64)tiles.size() < 2 && direction == G_MAP_CLOSED) || tiles.empty())
        return pos;
    i64 segs_num = 0;
    for (auto& t : tiles) {
        if (is_tile_end(t)) {
            t = set_end(t);
            segs_num++;
        }
    }
    if (segs_num > thd_max_segs_num) return pos;
    if (direction == G_MAP_LEFT) {
        u64 recd = cords[pos] & (1ull << 62);
        set_tiles_cords_sgns(tiles, recd);
        if (is_end(cords[pos])) tiles.back() = set_end(tiles.back());
        else tiles.back() = unset_end(tiles.back());
        cords[pos] = tiles.back();
        tiles.pop_back();
        cords.insert(cords.begin() + pos, tiles.begin(), tiles.end());
        pos += (i64)tiles.size();
        tiles.clear();
    } else if (direction == G_MAP_RGHT) {
        u64 recd = cords[pos] & (1ull << 62);
        set_tiles_cords_sgns(tiles, recd);
        u64 cordtmp = cords[pos];
        cords[pos] = tiles[0];
        tiles.erase(tiles.begin());
        cords.insert(cords.begin() + pos + 1, tiles.begin(), tiles.end());
        pos += (i64)tiles.size();
        if (is_end(cordtmp)) cords[pos] = set_end(cords[pos]);
        else cords[pos] = unset_end(cords[pos]);
        tiles.clear();
    } else if (direction == G_MAP_CLOSED) {
        u64 recd = cords[pos] & (1ull << 62);
        set_tiles_cords_sgns(tiles, recd);
        u64 cordtmp = cords[pos];
        cords[pos - 1] = tiles[0];
        cords[pos] = tiles.back();
        if (is_end(cordtmp)) cords[pos] = set_end(cords[pos]);
        else cords[pos] = unset_end(cords[pos]);
        if (tiles.size() > 2) {
            cords.insert(cords.begin() + pos, tiles.begin() + 1, tiles.end() - 1);
            pos += (i64)tiles.size() - 2;
        }
        tiles.clear();
    }
    return pos;
}

// insert_tiles2Cords_ twin-array (src/gap_util.cpp:3240)
static inline i64 insert_tiles2cords(std::vector<u64>& cords_str,
                                     std::vector<u64>& cords_end, i64 pos,
                                     std::vector<u64>& tiles_str,
                                     std::vector<u64>& tiles_end, int direction,
                                     i64 thd_cord_size, i64 thd_max_segs_num) {
    if (cords_end.empty()) {
        u64 d = ((u64)thd_cord_size << 20) + (u64)thd_cord_size;
        for (u64 c : cords_str) cords_end.push_back(c + d);
    }
    i64 postmp = pos;
    pos = insert_tiles2cords_one(cords_str, pos, tiles_str, direction,
                                 thd_max_segs_num);
    insert_tiles2cords_one(cords_end, postmp, tiles_end, direction,
                           thd_max_segs_num);
    return pos;
}

}  // namespace le
