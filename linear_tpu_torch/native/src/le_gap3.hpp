// Gap module part 3: mapGap_ / mapGaps drivers + reformCords normalization.
// (reference: src/gap.cpp:16,407; src/cords.cpp:504-601)
#pragma once
#include "le_gap2.hpp"

namespace le {

// _getMaxGapsyOverlap (src/gap_util.cpp:343)
static inline i64 get_max_gapsy_overlap(const std::vector<PII>& gapsy, u64 gap_str,
                                        u64 gap_end) {
    i64 gap_stry = cy(gap_str);
    i64 gap_endy = cy(gap_end);
    for (auto& g : gapsy) {
        i64 ystr = g.first, yend = g.second;
        if (ystr <= gap_stry && gap_stry <= yend)
            return std::min(gap_endy, yend) - gap_stry;
        if (ystr <= gap_endy && gap_endy <= yend)
            return gap_endy - std::max(gap_stry, ystr);
    }
    return 0;
}

// mapGap_ (src/gap.cpp:16)
static inline int map_gap_(const GapContext& cx_, u64 gap_str, u64 gap_end,
                           std::vector<u64>& tiles_str, std::vector<u64>& tiles_end,
                           int direction, i64 thd_dxy_min, GapParms& gp) {
    tiles_str.clear();
    tiles_end.clear();
    gap_str = remove_tile_sgn(unset_end(gap_str));
    gap_end = remove_tile_sgn(unset_end(gap_end));
    i64 gid = cid(gap_str);
    const u8* ref = cx_.genomes[gid];
    i64 ref_len = cx_.genome_lens[gid];
    const u8* read = cx_.read;
    i64 read_len = cx_.read_len;
    i64 x1 = cx(gap_str), x2 = cx(gap_end);
    i64 y1 = cy(gap_str), y2 = cy(gap_end);
    if (x1 + gp.thd_tile_size > ref_len - 1 || y1 + gp.thd_tile_size > read_len - 1 ||
        x2 > ref_len - 1 || y2 > read_len - 1 || x2 < gp.thd_tile_size ||
        y2 < gp.thd_tile_size) {
        return 0;
    } else if (cstrand(gap_str ^ gap_end)) {
        if (direction != G_MAP_CLOSED) return -1;
        const i64 thd_max_extend1 = 500;
        const i64 thd_max_extend2 = 5000;
        std::vector<u64> ts1, ts2, te1, te2;
        i64 shift_x = (x2 - x1 > 0)
                          ? std::min(std::min(thd_max_extend2, ref_len - 1 - cx(gap_str)),
                                     x2 - x1)
                          : thd_max_extend1;
        i64 shift_y = std::min((i64)((double)(x2 - x1) * (1 + gp.thd_err)),
                               read_len - 1 - cy(gap_str));
        shift_x = std::max(shift_x, (i64)0);
        shift_y = std::max(shift_y, (i64)0);
        u64 gap_str1 = gap_str;
        u64 gap_end1 = shiftc(gap_str, shift_x, shift_y);
        map_extend(cx_, ts1, te1, gap_str1, gap_end1, G_MAP_RGHT, gp);
        shift_x = (x2 - x1 > 0)
                      ? std::min(std::min(x2 - x1, cx(gap_end)), thd_max_extend2)
                      : thd_max_extend1;
        shift_y = std::min((i64)((double)(x2 - x1) * (1 + gp.thd_err)), cy(gap_end));
        shift_x = std::max(shift_x, (i64)0);
        shift_y = std::max(shift_y, (i64)0);
        u64 gap_str2 = shiftc(gap_end, -shift_x, -shift_y);
        u64 gap_end2 = gap_end;
        map_extend(cx_, ts2, te2, gap_str2, gap_end2, G_MAP_LEFT, gp);
        if (!ts1.empty()) {
            tiles_str.insert(tiles_str.end(), ts1.begin(), ts1.end());
            tiles_end.insert(tiles_end.end(), te1.begin(), te1.end());
        }
        if (!ts2.empty()) {
            tiles_str.insert(tiles_str.end(), ts2.begin(), ts2.end());
            tiles_end.insert(tiles_end.end(), te2.begin(), te2.end());
        }
    } else if (x1 + gp.thd_tile_size > x2 || y1 + gp.thd_tile_size > y2) {
        return 0;
    } else if (y1 < y2) {
        i64 danc = x1 - x2 - y1 + y2;
        if (std::abs(danc) > gp.thd_mg1_danc_indel && direction == G_MAP_CLOSED) {
            int f_extends = 1;
            ChainMetric chn1_tmp = gp.chn_score1;
            ChainMetric chn2_tmp = gp.chn_score2;
            gp.chn_score1.thd_min_chain_len = 1;
            gp.chn_score1.thd_abort_score = 0;
            gp.chn_score1.score_sel = 1;  // getGapAnchorsChainScore2
            gp.chn_score2.thd_abort_score = 0;
            gp.chn_score2.score_sel = 1;  // getGapBlocksChainScore3
            std::vector<u64> ts1, ts2, te1, te2;
            u64 gap_str1 = 0, gap_str2 = 0, gap_end1 = 0, gap_end2 = 0;
            if (danc > 0) {  // ins (x1<x2) / dup (x1>x2)
                i64 shift_y = std::min(std::min(std::max(y2 - y1, (i64)0),
                                                gp.thd_max_extend2),
                                       read_len - y1 - 1);
                i64 shift_x = std::min(std::min((i64)((double)shift_y * (1 + gp.thd_err)),
                                                gp.thd_max_extend2),
                                       ref_len - x1 - 1);
                gap_str1 = gap_str;
                gap_end1 = shiftc(gap_str, shift_x, shift_y);
                shift_y = std::min(std::min(std::max(y2 - y1, (i64)0),
                                            gp.thd_max_extend2),
                                   y2);
                shift_x = std::min(std::min((i64)((double)shift_y * (1 + gp.thd_err)),
                                            gp.thd_max_extend2),
                                   x2);
                gap_str2 = shiftc(gap_end, -shift_x, -shift_y);
                gap_end2 = gap_end;
                f_extends = x1 < x2 ? 1 : 2;
            } else if (x1 < x2) {  // del
                i64 shift_x = std::min(std::min(std::max(x2 - x1, (i64)0),
                                                gp.thd_max_extend2),
                                       ref_len - x1 - 1);
                i64 shift_y = std::min(std::min((i64)((double)shift_x * (1 + gp.thd_err)),
                                                gp.thd_max_extend2),
                                       read_len - y1 - 1);
                gap_str1 = gap_str;
                gap_end1 = shiftc(gap_str, shift_x, shift_y);
                shift_x = std::min(std::min(std::max(x2 - x1, (i64)0),
                                            gp.thd_max_extend2),
                                   x2);
                shift_y = std::min(std::min((i64)((double)shift_x * (1 + gp.thd_err)),
                                            gp.thd_max_extend2),
                                   y2);
                gap_str2 = shiftc(gap_end, -shift_x, -shift_y);
                gap_end2 = gap_end;
                f_extends = 1;
            } else {
                f_extends = 0;
            }
            if (f_extends) {
                if (f_extends == 1) {
                    map_extends(cx_, ts1, te1, ts2, te2, gap_str1, gap_end1,
                                gap_str2, gap_end2, thd_dxy_min, gp);
                } else if (f_extends == 2) {
                    map_extend(cx_, ts1, te1, gap_str1, gap_end1, G_MAP_RGHT, gp);
                    map_extend(cx_, ts2, te2, gap_str2, gap_end2, G_MAP_LEFT, gp);
                }
                if (!ts1.empty()) {
                    tiles_str.insert(tiles_str.end(), ts1.begin(), ts1.end());
                    tiles_end.insert(tiles_end.end(), te1.begin(), te1.end());
                    tiles_str.back() = remove_tile_sgn(tiles_str.back());
                    tiles_end.back() = remove_tile_sgn(tiles_end.back());
                }
                if (!ts2.empty()) {
                    ts2[0] = remove_tile_sgn(ts2[0]);
                    te2[0] = remove_tile_sgn(te2[0]);
                    tiles_str.insert(tiles_str.end(), ts2.begin(), ts2.end());
                    tiles_end.insert(tiles_end.end(), te2.begin(), te2.end());
                }
            }
            gp.chn_score2 = chn2_tmp;
            gp.chn_score1 = chn1_tmp;
        }
    }
    tiles_str.insert(tiles_str.begin(), gap_str);
    tiles_end.insert(tiles_end.begin(), shiftc(gap_str, 1, 1));
    tiles_str.push_back(shiftc(gap_end, -1, -1));
    tiles_end.push_back(gap_end);
    // addons_1: map generic gaps in residual >=90x90 holes
    {
        i64 i = 1;
        while (i < (i64)tiles_str.size()) {
            i64 dx = tile_x(tiles_str[i]) - tile_x(tiles_end[i - 1]);
            i64 dy = tile_y(tiles_str[i]) - tile_y(tiles_end[i - 1]);
            if (!tile_strand(tiles_str[i] ^ tiles_str[i - 1])) {
                if (dx > 90 && dy > 90) {
                    std::vector<u64> ts1, te1;
                    u64 t_gap_str = tiles_str[i - 1];
                    u64 t_gap_end = tiles_str[i];
                    map_generic(cx_, ts1, te1, t_gap_str, t_gap_end, gp);
                    if (!ts1.empty()) {
                        ts1.erase(ts1.begin());
                        te1.erase(te1.begin());
                        ts1.pop_back();
                        te1.pop_back();
                        if (!ts1.empty()) {
                            ts1.back() = remove_tile_sgn(ts1.back());
                            te1.back() = remove_tile_sgn(te1.back());
                            tiles_str.insert(tiles_str.begin() + i, ts1.begin(),
                                             ts1.end());
                            tiles_end.insert(tiles_end.begin() + i, te1.begin(),
                                             te1.end());
                        }
                        i += (i64)ts1.size();
                    }
                }
            }
            i++;
        }
    }
    // addons_2: dup re-detection (-dup 1)
    if (gp.f_dup) {
        const double thd_extend_range_rate1 = 0.1;
        i64 i = 1;
        while (i < (i64)tiles_str.size()) {
            if (!tile_strand(tiles_str[i] ^ tiles_str[i - 1]) &&
                !is_tile_end(tiles_str[i - 1])) {
                i64 tx1 = tile_x(tiles_end[i - 1]);
                i64 ty1 = tile_y(tiles_end[i - 1]);
                i64 tx2 = tile_x(tiles_str[i]);
                i64 ty2 = tile_y(tiles_str[i]);
                i64 dx = tx2 - tx1;
                i64 dy = ty2 - ty1;
                if (dy > 100 && dy - dx > gp.thd_mg1_danc_indel) {
                    std::vector<u64> ts1, te1;
                    i64 ex1 = -std::min((i64)((double)dy * (1 + thd_extend_range_rate1)),
                                        tx1);
                    i64 ex2 = std::min((i64)((double)dy * (1 + thd_extend_range_rate1)),
                                       ref_len - tx2 - 1);
                    u64 t_gap_str = shiftc(tiles_end[i - 1], ex1, 0);
                    u64 t_gap_end = shiftc(tiles_str[i], ex2, 0);
                    map_generic(cx_, ts1, te1, t_gap_str, t_gap_end, gp);
                    if (!ts1.empty()) {
                        ts1.erase(ts1.begin());
                        te1.erase(te1.begin());
                        ts1.pop_back();
                        te1.pop_back();
                        if (!ts1.empty()) {
                            ts1.back() = remove_tile_sgn(ts1.back());
                            te1.back() = remove_tile_sgn(te1.back());
                            if (tile_x(ts1[0]) < tile_x(tiles_str[i - 1])) {
                                tiles_str[i - 1] = set_tile_end(tiles_str[i - 1]);
                                tiles_end[i - 1] = set_tile_end(tiles_end[i - 1]);
                            }
                            if (tile_x(ts1.back()) > tile_x(tiles_str[i])) {
                                ts1.back() = set_tile_end(ts1.back());
                                te1.back() = set_tile_end(te1.back());
                            }
                            tiles_str.insert(tiles_str.begin() + i, ts1.begin(),
                                             ts1.end());
                            tiles_end.insert(tiles_end.begin() + i, te1.begin(),
                                             te1.end());
                        }
                        i += (i64)ts1.size();
                    }
                }
            }
            i++;
        }
    }
    // strip the sentinel head/tail
    tiles_str.erase(tiles_str.begin());
    tiles_end.erase(tiles_end.begin());
    tiles_str.pop_back();
    tiles_end.pop_back();
    return 0;
}

// mapGaps (src/gap.cpp:407)
static inline void map_gaps(const GapContext& cx_, std::vector<u64>& cords_str,
                            std::vector<u64>& cords_end, GapParms& gp) {
    if (cords_str.size() <= 1) return;
    std::vector<u64> tiles_str, tiles_end;
    const i64 thd_max_segs_num = 1000;
    const i64 thd_max_extend = 2000;
    const i64 thd_max_gap = 3000;
    const i64 thd_dxy_min = 80;
    const i64 thd_extend_xy = 3;
    i64 block_size = gp.thd_tile_size;
    i64 thd_cord_size = gp.thd_tile_size;
    i64 thd_cord_gap = gp.thd_gap_len_min + block_size;
    std::vector<PII> apx_gaps;
    std::vector<PII> str_ends, str_ends_p;
    gather_blocks(cords_str, 1, (i64)cords_str.size(), cx_.read_len, thd_cord_gap,
                  thd_cord_size, false, str_ends, str_ends_p);
    gather_gaps_y(str_ends, cx_.read_len, thd_cord_gap, apx_gaps);
    i64 i = 1;
    while (i < (i64)cords_str.size()) {
        i64 sid = cid(cords_str[i]);
        gp.read_len = cx_.read_len;
        gp.ref_len = cx_.genome_lens[sid];
        if (is_end(cords_str[i - 1])) {  // clip first cord of block
            i64 shift_x =
                std::min(cx_.genome_lens[sid] - 1 - cx(cords_str[i]), block_size);
            i64 shift_y = std::min(cx_.read_len - 1 - cy(cords_str[i]), block_size);
            u64 gap_end = shiftc(cords_str[i], shift_x, shift_y);
            if (cy(gap_end) > thd_cord_gap) {
                shift_x = std::min(thd_max_extend, cx(gap_end));
                shift_y = std::min(thd_max_extend, cy(gap_end));
                shift_x = std::min(shift_x, shift_y * thd_extend_xy);
                u64 gap_str = shiftc(gap_end, -shift_x, -shift_y);
                int direction = G_MAP_LEFT;
                gap_str = remove_tile_sgn(unset_end(gap_str));
                gap_end = remove_tile_sgn(unset_end(gap_end));
                if (get_max_gapsy_overlap(apx_gaps, gap_str, gap_end) > thd_cord_gap) {
                    map_gap_(cx_, gap_str, gap_end, tiles_str, tiles_end,
                             direction, thd_dxy_min, gp);
                    i = insert_tiles2cords(cords_str, cords_end, i, tiles_str,
                                           tiles_end, direction, thd_cord_size,
                                           thd_max_segs_num);
                }
            }
        } else if (!is_consecutive(cords_str[i - 1], cords_str[i], thd_cord_gap)) {
            i64 shift_x =
                std::min(cx_.genome_lens[sid] - 1 - cx(cords_str[i]), gp.thd_tile_size);
            i64 shift_y = std::min(cx_.read_len - 1 - cy(cords_str[i]), gp.thd_tile_size);
            if (!is_end(cords_str[i]) && i + 1 < (i64)cords_str.size() &&
                !cstrand(cords_str[i] ^ cords_str[i + 1])) {
                shift_x = std::min(cx(cords_str[i + 1]) - cx(cords_str[i]), shift_x);
                shift_y = std::min(cy(cords_str[i + 1]) - cy(cords_str[i]), shift_y);
            }
            u64 gap_str = cords_str[i - 1];
            u64 gap_end = shiftc(cords_str[i], shift_x, shift_y);
            i64 dx_tmp = cx(gap_end) - cx(gap_str);
            if (std::abs(dx_tmp) < thd_max_gap) {
                int direction = G_MAP_CLOSED;
                gap_str = remove_tile_sgn(unset_end(gap_str));
                gap_end = remove_tile_sgn(unset_end(gap_end));
                map_gap_(cx_, gap_str, gap_end, tiles_str, tiles_end, direction,
                         thd_dxy_min, gp);
                i = insert_tiles2cords(cords_str, cords_end, i, tiles_str,
                                       tiles_end, direction, thd_cord_size,
                                       thd_max_segs_num);
            }
        }
        if (is_end(cords_str[i])) {  // right clip end cord of block
            u64 gap_str = cords_str[i];
            if (cx_.read_len - 1 - cy(gap_str) > thd_cord_gap) {
                i64 shift_x =
                    std::min(thd_max_extend, cx_.genome_lens[sid] - cx(gap_str) - 1);
                i64 shift_y = std::min(thd_max_extend, cx_.read_len - cy(gap_str) - 1);
                shift_x = std::min(shift_x, shift_y * thd_extend_xy);
                u64 gap_end = shiftc(gap_str, shift_x, shift_y);
                int direction = G_MAP_RGHT;
                gap_str = remove_tile_sgn(unset_end(gap_str));
                gap_end = remove_tile_sgn(unset_end(gap_end));
                if (get_max_gapsy_overlap(apx_gaps, gap_str, gap_end) > thd_cord_gap) {
                    map_gap_(cx_, gap_str, gap_end, tiles_str, tiles_end,
                             direction, thd_dxy_min, gp);
                    i = insert_tiles2cords(cords_str, cords_end, i, tiles_str,
                                           tiles_end, direction, thd_cord_size,
                                           thd_max_segs_num);
                }
            }
        }
        i++;
    }
}

// ------------------------------------------------------------ reformCords

// scaleDxDy_ (src/cords.cpp:556)
static inline void scale_dxdy(i64 dx, i64* d1, i64 dy, i64* d2) {
    if (dx * dy >= 0 && (*d1) * (*d2) >= 0 && dx * (*d1) >= 0 &&
        (dx || dy || *d1 || *d2)) {
        i64 c1 = std::abs((*d1) * dy);
        i64 c2 = std::abs((*d2) * dx);
        if (c1 > c2) {
            if (dx != 0) *d2 = tdiv((*d1) * dy, dx);
        } else if (c1 < c2) {
            if (dy != 0) *d1 = tdiv((*d2) * dx, dy);
        }
    }
}

// scaleRegion (src/cords.cpp:584)
static inline void scale_region(u64* cord_str, u64* cord_end, i64 d11, i64 d12,
                                i64 d21, i64 d22) {
    i64 dx = cx(*cord_end) - cx(*cord_str);
    i64 dy = cy(*cord_end) - cy(*cord_str);
    scale_dxdy(dx, &d11, dy, &d12);
    scale_dxdy(dx, &d21, dy, &d22);
    *cord_str = shiftc(*cord_str, d11, d12);
    *cord_end = shiftc(*cord_end, d21, d22);
}

// reformCords + reformCordsDxDy1 (src/cords.cpp:540,601)
static inline void reform_cords(std::vector<u64>& cords_str,
                                std::vector<u64>& cords_end) {
    const i64 thd_min_dx = -20;
    const i64 thd_min_dy = -20;
    if (cords_str.size() != cords_end.size()) return;
    i64 it = 1;
    while (it < (i64)cords_str.size()) {
        i64 i1 = it - 1, i2 = it;
        u64 cord11 = cords_str[i1], cord12 = cords_end[i1];
        u64 cord21 = cords_str[i2], cord22 = cords_end[i2];
        i64 dx1 = cx(cord21) - cx(cord11);
        i64 dy1 = cy(cord21) - cy(cord11);
        if (cx(cords_str[it]) > cx(cords_end[it]) ||
            cy(cords_str[it]) > cy(cords_end[it])) {
            if (is_end(cords_str[it])) {
                cords_str[it - 1] = set_end(cords_str[it - 1]);
                cords_end[it - 1] = set_end(cords_end[it - 1]);
            }
            cords_str.erase(cords_str.begin() + it);
            cords_end.erase(cords_end.begin() + it);
            continue;
        } else if (cstrand(cord11 ^ cord22) || is_end(cord11)) {
            it++;
            continue;
        } else if ((dx1 < 0 && dx1 > thd_min_dx) || (dy1 < 0 && dy1 > thd_min_dy)) {
            u64 lower_bound_str, upper_bound_str;
            if (i1 == 0 || is_end(cords_str[i1 - 1])) lower_bound_str = 0;
            else if (cstrand(cords_str[i1] ^ cords_str[i1 - 1]))
                lower_bound_str = cords_str[i1];
            else lower_bound_str = cords_str[i1 - 1];
            if (i2 == (i64)cords_str.size() - 1 || is_end(cords_str[i2]))
                upper_bound_str = cords_end[i2];
            else if (cstrand(cords_str[i2] ^ cords_str[i2 + 1]))
                upper_bound_str = cords_end[i2];
            else upper_bound_str = cords_str[i2 + 1];
            i64 shift_x = std::min(tdiv(dx1 - 1, 2), (i64)0);
            i64 shift_y = std::min(tdiv(dy1 - 1, 2), (i64)0);
            scale_region(&cord11, &cord12, shift_x, shift_y, 0, 0);
            scale_region(&cord21, &cord22, -shift_x, -shift_y, 0, 0);
            i64 x11 = cx(cord11), y11 = cy(cord11);
            i64 x21 = cx(cord21), y21 = cy(cord21);
            if (x11 <= cx(cord12) && x11 > cx(lower_bound_str) &&
                y11 <= cy(cord12) && y11 > cy(lower_bound_str) &&
                x21 <= cx(cord22) && x21 < cx(upper_bound_str) &&
                y21 <= cy(cord22) && y21 < cy(upper_bound_str)) {
                cords_str[i1] = cord11;
                cords_end[i1] = cord12;
                cords_str[i2] = cord21;
                cords_end[i2] = cord22;
            }
            it++;
        } else {
            it++;
        }
    }
}

}  // namespace le
