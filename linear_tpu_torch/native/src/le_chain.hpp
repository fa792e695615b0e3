// Sparse chaining DP over anchors and blocks — native twin of
// linear_tpu/map/chaining.py (reference cluster_util.cpp: getBestChains :53,
// traceBackChains0/1 :121/:213, scores :337-443/:586/:811/:1104,
// chainBlocksBase :505, chainBlocksCords :936-1102, filters :633/:865).
//
// std::sort here IS the reference's sort — tie permutations come for free.
#pragma once
#include "le_common.hpp"

namespace le {

static const int CHAIN_END = -1;
static const i64 DELETE_SCORE = -1000;

struct ChainsRecord {
    i64 score = 0;
    i64 score2 = 0;
    i64 length = 0;
    i64 p2anchor = CHAIN_END;
    i64 root_ptr = 0;
    int f_leaf = 0;
};

struct ChainScoreParms {
    i64 mean_d = 1000;
    i64 var_d = 1000;
    int chn_block_strand = 0;
    double gacs3_ins_read_len_ratio = 1.0;
};

typedef i64 (*AnchorScoreFn)(u64, u64, const ChainScoreParms&);
typedef i64 (*BlockScoreFn)(u64, u64, u64, u64, i64, const ChainScoreParms&);
typedef i64 (*AnchorXFn)(u64);

// getBestChains (cluster_util.cpp:53): anchors sorted desc by get_anchor_x
// templated on the score/ax callables so call sites dispatching on a
// compile-time-known function (via lambda) get the score INLINED into
// the DP inner loop (the function-pointer form costs an indirect call
// per candidate edge)
template <class ScoreF, class AxF>
static inline void get_best_chains(const std::vector<u64>& anchors, i64 it_str,
                                   i64 it_end, i64 thd_chain_depth,
                                   i64 thd_chain_dx_depth, ScoreF get_score,
                                   const ChainScoreParms& parms, AxF get_ax,
                                   std::vector<ChainsRecord>& recs) {
    i64 n = (i64)anchors.size();
    recs.assign(n, ChainsRecord());
    if (n == 0) return;
    recs[0].score = 0;
    recs[0].length = 1;
    recs[0].p2anchor = CHAIN_END;
    std::vector<i64> ax(n);
    for (i64 i = 0; i < n; i++) ax[i] = get_ax(anchors[i]);
    for (i64 i = it_str; i < it_end; i++) {
        i64 j_str = std::max((i64)0, i - thd_chain_depth);
        i64 max_j = i;
        i64 new_max = -1;
        for (i64 j = i - 1;
             j >= 0 && (j >= j_str || ax[j] - ax[i] < thd_chain_dx_depth); j--) {
            i64 s = get_score(anchors[j], anchors[i], parms);
            if (s > 0 && s + recs[j].score >= new_max) {
                max_j = j;
                new_max = s + recs[j].score;
            }
        }
        if (new_max > 0) {
            recs[i].p2anchor = max_j;
            recs[i].score = new_max;
            recs[i].length = recs[max_j].length + 1;
            recs[i].score2 = new_max;
            recs[i].root_ptr = recs[max_j].root_ptr;
            recs[i].f_leaf = 1;
            recs[max_j].f_leaf = 0;
        } else {
            recs[i].p2anchor = CHAIN_END;
            recs[i].score = 0;
            recs[i].length = 1;
            recs[i].score2 = 0;
            recs[i].root_ptr = i;
            recs[i].f_leaf = 1;
        }
    }
}

// traceBackChains0 (cluster_util.cpp:121): greedy with score-deletion.
// ElemT is u64 (anchors) or std::pair<i64,i64> (block ranges).
template <class ElemT>
static inline void traceback_chains0(const std::vector<ElemT>& elements,
                                     std::vector<ChainsRecord>& recs, i64 min_len,
                                     i64 abort_score, i64 bestn, double stop_ratio,
                                     std::vector<std::vector<ElemT>>& chains,
                                     std::vector<i64>* chains_score) {
    i64 search_times = std::min((i64)50, bestn);
    for (i64 it = 0; it < search_times; it++) {
        std::vector<ElemT> chain;
        std::vector<i64> chain_score;
        bool f_done = true;
        i64 max_2nd = -1, max_score = -1, max_str = CHAIN_END, max_len = 0;
        for (i64 j = 0; j < (i64)recs.size(); j++) {
            if (recs[j].score > max_score) {
                max_2nd = max_score;
                max_str = j;
                max_score = recs[j].score;
                max_len = recs[j].length;
                f_done = false;
            }
        }
        if (!chains.empty()) {
            if ((double)max_len > (double)chains[0].size() * stop_ratio)
                f_done = false;
        }
        if (f_done || max_score == 0) break;
        if (max_len > min_len && tdiv(max_score, max_len - 1) > abort_score) {
            i64 j = max_str;
            while (j != CHAIN_END) {
                if (recs[j].score != DELETE_SCORE) {
                    chain.push_back(elements[j]);
                    chain_score.push_back(recs[j].score2);
                    recs[j].score = DELETE_SCORE;
                } else {
                    i64 infix = recs[j].score2;
                    if (max_score - infix < max_2nd) {
                        i64 k = max_str;
                        while (k != j) {
                            recs[k].score = recs[k].score2 - infix;
                            k = recs[k].p2anchor;
                        }
                        chain.clear();
                        chain_score.clear();
                    }
                    break;
                }
                j = recs[j].p2anchor;
            }
            if (!chain.empty()) {
                chains.push_back(chain);
                if (chains_score)
                    chains_score->insert(chains_score->end(), chain_score.begin(),
                                         chain_score.end());
            }
        }
        if (max_str != CHAIN_END) recs[max_str].score = DELETE_SCORE;
    }
}

// traceBackChains1 (cluster_util.cpp:213): per-root best leaf
template <class ElemT>
static inline void traceback_chains1(const std::vector<ElemT>& elements,
                                     std::vector<ChainsRecord>& recs, i64 min_len,
                                     i64 abort_score, i64 bestn, double stop_ratio,
                                     std::vector<std::vector<ElemT>>& chains,
                                     std::vector<i64>* chains_score) {
    bool f_stop = false;
    struct Leaf { i64 root, score, len, leaf; };
    std::vector<Leaf> leaves;
    for (i64 j = 0; j < (i64)recs.size(); j++) {
        ChainsRecord& r = recs[j];
        if (!r.f_leaf) continue;
        bool found = false;
        for (auto& lv : leaves) {
            if (lv.root == r.root_ptr) {
                if (r.score > lv.score) {
                    lv.score = r.score;
                    lv.len = r.length;
                    lv.leaf = j;
                }
                found = true;
            }
        }
        if (!found) leaves.push_back({r.root_ptr, r.score, r.length, j});
    }
    // std::sort desc by tree best score (cluster_util.cpp:269)
    std::sort(leaves.begin(), leaves.end(),
              [](const Leaf& a, const Leaf& b) { return a.score > b.score; });
    i64 lim = std::min(bestn, (i64)leaves.size());
    for (i64 i = 0; i < lim; i++) {
        std::vector<ElemT> chain;
        std::vector<i64> chain_score;
        i64 max_score = leaves[i].score;
        i64 max_len = leaves[i].len;
        i64 max_str = leaves[i].leaf;
        i64 mean_score =
            max_len > 1 ? tdiv(max_score, max_len - 1) : abort_score + 1;
        if (max_len > min_len && mean_score > abort_score) {
            i64 j = max_str;
            while (j != CHAIN_END) {
                chain.push_back(elements[j]);
                chain_score.push_back(recs[j].score2);
                j = recs[j].p2anchor;
            }
            if (!chain.empty()) {
                if (!chains.empty() &&
                    (double)chain.size() / (double)chains[0].size() < stop_ratio)
                    f_stop = true;
                if (!f_stop) {
                    chains.push_back(chain);
                    if (chains_score)
                        chains_score->insert(chains_score->end(),
                                             chain_score.begin(),
                                             chain_score.end());
                }
            }
        }
    }
}

template <class ElemT>
static inline void traceback_chains(const std::vector<ElemT>& elements,
                                    std::vector<ChainsRecord>& recs, i64 min_len,
                                    i64 abort_score, i64 bestn, double stop_ratio,
                                    std::vector<std::vector<ElemT>>& chains,
                                    std::vector<i64>* chains_score) {
    const i64 thd_root_num = 50;
    std::vector<i64> roots;
    for (auto& r : recs) roots.push_back(r.root_ptr);
    std::sort(roots.begin(), roots.end());
    i64 n_roots = (i64)(std::unique(roots.begin(), roots.end()) - roots.begin());
    if (n_roots > thd_root_num)
        traceback_chains0(elements, recs, min_len, abort_score, bestn, stop_ratio,
                          chains, chains_score);
    else
        traceback_chains1(elements, recs, min_len, abort_score, bestn, stop_ratio,
                          chains, chains_score);
}

// ---------------------------------------------------------- anchor scores

// getApxChainScore (cluster_util.cpp:395)
static inline i64 get_apx_chain_score(u64 a1, u64 a2, const ChainScoreParms&) {
    i64 dy = cy(a1) - cy(a2);
    if (dy < 10) return -10000;
    const i64 thd_min_dy = 50;
    i64 dx = anchor_x(a1) - anchor_x(a2);
    i64 da = std::abs(dx - dy);
    i64 derr =
        tdiv(100 * da, std::max(std::max(std::abs(dy), std::abs(dx)), thd_min_dy));
    i64 score_derr;
    if (derr < 5) score_derr = 4 * derr;
    else if (derr < 10) score_derr = 6 * derr - 10;
    else if (derr < 100) score_derr = derr * derr - 5 * derr;
    else return -1000;
    dy = tdiv(dy, 15);
    i64 score_dy;
    if (dy < 150) score_dy = tdiv(dy, 5);
    else if (dy < 100) score_dy = dy - 30;
    else if (dy < 10000) score_dy = tdiv(dy * dy, 200) + 20;
    else score_dy = 10000;
    if (da < 10) return 100 - score_dy;
    return 100 - score_dy - score_derr;
}

// getApxChainScore0 (cluster_util.cpp:337): toggle(1) re-apx variant
static inline i64 get_apx_chain_score0(u64 a1, u64 a2, const ChainScoreParms&) {
    i64 dy = cy(a1) - cy(a2);
    if (dy < 5) return -10000;
    const i64 thd_min_dy = 50;
    i64 dx = anchor_x(a1) - anchor_x(a2);
    i64 da = std::abs(dx - dy);
    i64 derr =
        tdiv(100 * da, std::max(std::max(std::abs(dy), std::abs(dx)), thd_min_dy));
    if (derr >= 100) return -1000;
    i64 score_dy = dy;
    i64 score_derr = da;
    if (da < 30) return 100 - score_dy;
    return 100 - score_dy - score_derr;
}

// chainAnchorsBase (cluster_util.cpp:445)
template <class ScoreF, class AxF>
static inline void chain_anchors_base(
    const std::vector<u64>& anchors, i64 it_str, i64 it_end, i64 thd_chain_depth,
    i64 thd_chain_dx_depth, i64 thd_best_n, double stop_ratio, i64 min_len,
    i64 abort_score, ScoreF get_score, const ChainScoreParms& parms,
    AxF get_ax, std::vector<std::vector<u64>>& chains,
    std::vector<i64>* chains_score) {
    if (anchors.size() < 2) return;
    std::vector<ChainsRecord> recs;
    get_best_chains(anchors, it_str, it_end, thd_chain_depth, thd_chain_dx_depth,
                    get_score, parms, get_ax, recs);
    traceback_chains(anchors, recs, min_len, abort_score, thd_best_n, stop_ratio,
                     chains, chains_score);
}

// ------------------------------------------------------------- block DP

typedef std::pair<i64, i64> PII;

// getBestChains2 (cluster_util.cpp:469)
static inline void get_best_chains2(const std::vector<u64>& hits,
                                    const std::vector<PII>& sp,
                                    const std::vector<i64>& scores, i64 read_len,
                                    BlockScoreFn get_score2,
                                    const ChainScoreParms& parms,
                                    std::vector<ChainsRecord>& recs,
                                    i64 thd_chain_depth = 20) {
    i64 n = (i64)sp.size();
    recs.assign(n, ChainsRecord());
    if (n == 0) return;
    recs[0].score = scores[0];
    recs[0].length = sp[0].second - sp[0].first;
    recs[0].p2anchor = CHAIN_END;
    for (i64 i = 0; i < n; i++) {
        i64 j_str = std::max((i64)0, i - thd_chain_depth);
        i64 max_j = i;
        i64 new_max = -1;
        for (i64 j = j_str; j < i; j++) {
            i64 s = get_score2(hits[sp[j].first], hits[sp[j].second - 1],
                               hits[sp[i].first], hits[sp[i].second - 1], read_len,
                               parms);
            if (s > 0 && s + recs[j].score + scores[i] >= new_max) {
                max_j = j;
                new_max = s + recs[j].score + scores[i];
            }
        }
        if (new_max > 0) {
            recs[i].p2anchor = max_j;
            recs[i].score = new_max;
            recs[i].length = sp[i].second - sp[i].first + recs[max_j].length;
            recs[i].score2 = recs[i].score;
            recs[i].root_ptr = recs[max_j].root_ptr;
            recs[i].f_leaf = 1;
            recs[max_j].f_leaf = 0;
        } else {
            recs[i].p2anchor = CHAIN_END;
            recs[i].score = scores[i];
            recs[i].length = sp[i].second - sp[i].first;
            recs[i].score2 = recs[i].score;
            recs[i].root_ptr = i;
            recs[i].f_leaf = 1;
        }
    }
}

// chainBlocksBase (cluster_util.cpp:505)
static inline void chain_blocks_base(const std::vector<u64>& records,
                                     const std::vector<PII>& str_ends_p,
                                     const std::vector<i64>& scores, i64 read_len,
                                     BlockScoreFn get_score2,
                                     const ChainScoreParms& parms, i64 min_len,
                                     i64 abort_score, i64 thd_best_n, bool f_sort,
                                     double stop_ratio,
                                     std::vector<std::vector<PII>>& chains) {
    if (str_ends_p.size() < 2) return;
    std::vector<i64> order(str_ends_p.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = (i64)i;
    if (f_sort) {
        // std::sort desc by the 40-bit id|x field (cluster_util.cpp:558)
        std::sort(order.begin(), order.end(), [&](i64 a, i64 b) {
            return ((records[str_ends_p[a].first] >> 20) & MASK_XID) >
                   ((records[str_ends_p[b].first] >> 20) & MASK_XID);
        });
    }
    std::vector<PII> sp(order.size());
    std::vector<i64> sc(order.size());
    for (size_t i = 0; i < order.size(); i++) {
        sp[i] = str_ends_p[order[i]];
        sc[i] = scores[order[i]];
    }
    std::vector<ChainsRecord> recs;
    get_best_chains2(records, sp, sc, read_len, get_score2, parms, recs);
    traceback_chains(sp, recs, min_len, abort_score, thd_best_n, stop_ratio,
                     chains, (std::vector<i64>*)nullptr);
}

// getApxChainScore2 (cluster_util.cpp:586)
static inline i64 get_apx_chain_score2(u64 c11, u64 c12, u64 c21, u64 c22,
                                       i64 read_len, const ChainScoreParms&) {
    const i64 thd_max_d = 20000;
    const i64 thd_indel_trigger = 100;
    const i64 thd_indel_op = 30;
    i64 dy = cy(c11) - cy(c22);
    i64 dx = cx(c11) - cx(c22);
    if (dx < 0 || dy < 0 || cstrand(c11 ^ c22) || dx > thd_max_d || dy > thd_max_d)
        return INT_MIN32;
    const i64 thd_min_dy = 100;
    i64 da = std::abs(dx - dy);
    i64 derr =
        tdiv(100 * da, std::max(std::max(std::abs(dy), thd_min_dy), std::abs(dx)));
    if (da > thd_indel_trigger || derr > 50) {
        if (dx < dy) return 100 - thd_indel_op - tdiv(dy, 1000) - tdiv(dx, 100);
        return 100 - thd_indel_op - tdiv(dy, 100) - tdiv(dx, 1000);
    }
    return 100 - tdiv(dy, 95);
}

// getChainBlockDxDy (cluster_util.cpp:774)
static inline int get_chain_block_dxdy(u64 c11, u64 c12, u64 c21, u64 c22,
                                       i64 read_len, int strand, i64* dx_out,
                                       i64* dy_out) {
    int s11 = cstrand(c11);
    int s22 = cstrand(c22);
    i64 dx, dy;
    if (s11 != strand) {
        if (s22 != strand) {
            dy = cy(c21) - cy(c12);
            dx = cx(c21) - cx(c12);
        } else {
            dy = read_len - cy(c12) - 1 - cy(c22);
            dx = cx(c11) - cx(c22);
        }
    } else {
        if (s22 != strand) {
            dy = cy(c11) - read_len + 1 + cy(c21);
            dx = cx(c11) - cx(c22);
        } else {
            dy = cy(c11) - cy(c22);
            dx = cx(c11) - cx(c22);
        }
    }
    *dx_out = dx;
    *dy_out = dy;
    return cstrand(c11 ^ c22);
}

// getApxChainScore3 (cluster_util.cpp:811): SV-aware block chaining
static inline i64 get_apx_chain_score3(u64 c11, u64 c12, u64 c21, u64 c22,
                                       i64 read_len,
                                       const ChainScoreParms& parms) {
    const i64 thd_min_dy = -80;
    i64 thd_min_dx = -read_len;
    i64 dx, dy;
    int f_type = get_chain_block_dxdy(c11, c12, c21, c22, read_len,
                                      parms.chn_block_strand, &dx, &dy);
    i64 thd_max_dy = (i64)(read_len * parms.gacs3_ins_read_len_ratio);
    const i64 thd_max_dx = 15000;
    const i64 thd_dup_trigger = -50;
    i64 dx_ = std::abs(dx), dy_ = std::abs(dy);
    i64 da = dx - dy;
    if (dy < thd_min_dy || dy > thd_max_dy || dx < thd_min_dx || dx_ > thd_max_dx)
        return INT_MIN32;
    i64 score_dy =
        dy_ > 2000 ? std::min(tdiv(dy_, 25) - 50, (i64)70) : tdiv(dy_, 40);
    i64 score_dx =
        dx_ > 2000 ? std::min(tdiv(dx_, 25) - 50, (i64)70) : tdiv(dx_, 40);
    i64 score = 0;
    if (f_type == 1) {
        if (dx > thd_min_dx) score = 75 - score_dy;
    } else if (da < -std::max(tdiv(dx_, 4), (i64)50)) {
        if (dx > thd_dup_trigger) score = 80 - score_dx;
        else score = 80 - score_dy;
    } else if (da > std::max(tdiv(dy, 4), (i64)50)) {
        score = 80 - score_dy;
    } else {
        score = 100 - score_dy;
    }
    return score;
}

// ---------------------------------------------------- probabilistic score

static const double ERF_NUM[31] = {
    0, 0.022564575, 0.045111106, 0.067621594, 0.090078126, 0.112462916,
    0.222702589, 0.328626759, 0.428392355, 0.520499878, 0.603856091,
    0.677801194, 0.742100965, 0.796908212, 0.842700793, 0.88020507,
    0.910313978, 0.934007945, 0.95228512, 0.966105146, 0.976348383,
    0.983790459, 0.989090502, 0.992790429, 0.995322265, 0.997020533,
    0.998137154, 0.998856823, 0.999311486, 0.999593048, 1};

// NumericalScore::erf (cluster_util.cpp:1150); float literals as in the C++
static inline double erf_num(double val) {
    double a = val < 0 ? -val : val;
    double score;
    if (a > 2.5) {
        score = 1.0;
    } else if (a < 0.1) {
        int i = (int)(a / (double)0.02f);
        score = (ERF_NUM[i] + ERF_NUM[i + 1]) * 0.5;
    } else {
        int i = (int)(5 + ((float)a - 0.1f) / 0.1f);
        score = (ERF_NUM[i] + ERF_NUM[i + 1]) * 0.5;
    }
    return val < 0 ? -score : score;
}

static inline double cdf_n(double val, double mean, double var) {
    return (1 + erf_num((val - mean) / (var * 1.414))) * 0.5;
}

static inline double variants_prob(int strand, i64 dx, i64 dy) {
    i64 da = dx - dy;
    double p = 1.0;
    if (strand) p = 0.5;
    if (da < -std::max(tdiv(dx, 4), (i64)50)) p = dx > -50 ? 0.5 : 0.25;
    else if (da > std::max(tdiv(dy, 4), (i64)50)) p = 0.5;
    return p;
}

// getChainBlocksScore1 (cluster_util.cpp:1181)
static inline i64 get_chain_blocks_score1(u64 c11, u64 c12, u64 c21, u64 c22,
                                          i64 read_len,
                                          const ChainScoreParms& parms) {
    i64 dx, dy;
    int f_type = get_chain_block_dxdy(c11, c12, c21, c22, read_len,
                                      parms.chn_block_strand, &dx, &dy);
    if (dy < -80) return INT_MIN32;
    i64 d = std::max(std::min(dx, dy), (i64)0);
    double p_0 = 1 - cdf_n((double)d, (double)parms.mean_d, (double)parms.var_d);
    double p = variants_prob(f_type ? 1 : 0, dx, dy) * p_0;
    return (i64)((float)p * 100);
}

// --------------------------------------------- dual-strand block chaining

// chainBlocksSingleStrand (cluster_util.cpp:1018)
static inline void chain_blocks_single_strand(
    const std::vector<u64>& cords, std::vector<PII> sp, BlockScoreFn get_score2,
    ChainScoreParms parms, i64 min_len, i64 abort_score, i64 read_len,
    i64 thd_init_cord_score, int strand, std::vector<std::vector<PII>>& chains,
    std::vector<PII>& sp_out) {
    parms.chn_block_strand = strand;
    auto key = [&](const PII& p) -> i64 {
        if (strand) {
            if (!cstrand(cords[p.first]))
                return read_len - 1 - cy(cords[p.second - 1]);
            return cy(cords[p.first]);
        }
        if (cstrand(cords[p.first]))
            return read_len - 1 - cy(cords[p.second - 1]);
        return cy(cords[p.first]);
    };
    // std::sort desc by strand-adjusted y (cluster_util.cpp:945/956)
    std::sort(sp.begin(), sp.end(),
              [&](const PII& a, const PII& b) { return key(a) > key(b); });
    std::vector<i64> scores(sp.size());
    for (size_t i = 0; i < sp.size(); i++)
        scores[i] = (sp[i].second - sp[i].first) * thd_init_cord_score;
    chain_blocks_base(cords, sp, scores, read_len, get_score2, parms, min_len,
                      abort_score, 3, false, 0.7, chains);
    sp_out = sp;
}

// getChainBlocksBestStrand (cluster_util.cpp:1107)
static inline int get_chain_blocks_best_strand(
    const std::vector<std::vector<PII>>& chains1,
    const std::vector<std::vector<PII>>& chains2) {
    std::vector<i64> lens1, lens2;
    for (size_t i = 0; i < chains1.size(); i++) {
        i64 v = i ? lens1[i - 1] : 0;
        for (auto& p : chains1[i]) v += p.second - p.first;
        lens1.push_back(v);
    }
    for (size_t i = 0; i < chains2.size(); i++) {
        i64 v = i ? lens2[i - 1] : 0;
        for (auto& p : chains2[i]) v += p.second - p.first;
        lens2.push_back(v);
    }
    size_t m = std::min(lens1.size(), lens2.size());
    for (size_t i = 0; i < m; i++) {
        if (lens1[i] < lens2[i]) return 1;
        if (lens1[i] > lens2[i]) return 0;
    }
    return 0;
}

// revertChainBlockStrand (cluster_util.cpp:1139)
static inline void revert_chain_block_strand(std::vector<std::vector<PII>>& chains,
                                             const std::vector<u64>& cords,
                                             int strand, i64 read_len) {
    int f_strand = strand ? 1 : 0;
    for (auto& chain : chains) {
        chain.push_back({0, 0});
        int strand_pre = 0;
        i64 swap_str = 0;
        for (i64 j = 0; j < (i64)chain.size(); j++) {
            int strand_this;
            if (j == (i64)chain.size() - 1 ||
                cstrand(cords[chain[j].first]) == f_strand)
                strand_this = 0;
            else
                strand_this = 1;
            if (strand_this && !strand_pre) swap_str = j;
            if (!strand_this && strand_pre)
                std::reverse(chain.begin() + swap_str, chain.begin() + j);
            strand_pre = strand_this;
        }
        chain.pop_back();
    }
}

// _filterBlocksCords (cluster_util.cpp:1056); end-flag setters parameterized
// (cords: blockEnd bit 60; tiles: sgn end bit 63)
typedef u64 (*CordFlagFn)(u64);

static inline void filter_blocks_cords(const std::vector<std::vector<PII>>& chains,
                                       std::vector<u64>& hits, i64 read_len,
                                       i64 thd_major_limit, bool f_header,
                                       CordFlagFn unset_end_f, CordFlagFn set_end_f) {
    if (chains.empty()) return;
    std::vector<u64> out;
    if (f_header) out.push_back(hits[0]);
    i64 len_current = 0;
    for (auto& p : chains[0]) {
        for (i64 j = p.first; j < p.second; j++) out.push_back(unset_end_f(hits[j]));
        len_current += p.second - p.first;
    }
    out.back() = set_end_f(out.back());
    double thd_major_bound = 0.8 * (double)len_current;
    i64 major_n = 1;
    for (size_t i = 1; i < chains.size() && major_n < thd_major_limit; i++) {
        auto& ch = chains[i];
        len_current = 0;
        for (auto& p : ch) len_current += p.second - p.first;
        if ((double)len_current > thd_major_bound) {
            major_n++;
            for (auto& p : ch)
                for (i64 j = p.first; j < p.second; j++)
                    out.push_back(unset_end_f(hits[j]));
            out.back() = set_end_f(out.back());
        }
    }
    hits = out;
}

// chainBlocksCords (cluster_util.cpp:1068)
static inline void chain_blocks_cords(std::vector<u64>& cords,
                                      const std::vector<PII>& str_ends_p,
                                      BlockScoreFn get_score2,
                                      const ChainScoreParms& parms, i64 min_len,
                                      i64 abort_score, i64 read_len,
                                      i64 thd_init_cord_score, i64 thd_major_limit,
                                      bool f_header, CordFlagFn unset_end_f,
                                      CordFlagFn set_end_f) {
    std::vector<std::vector<PII>> chains1, chains2;
    std::vector<PII> sp1, sp2;
    chain_blocks_single_strand(cords, str_ends_p, get_score2, parms, min_len,
                               abort_score, read_len, thd_init_cord_score, 0,
                               chains1, sp1);
    chain_blocks_single_strand(cords, str_ends_p, get_score2, parms, min_len,
                               abort_score, read_len, thd_init_cord_score, 1,
                               chains2, sp2);
    int best = get_chain_blocks_best_strand(chains1, chains2);
    std::vector<std::vector<PII>>& chains = best == 0 ? chains1 : chains2;
    revert_chain_block_strand(chains, cords, best, read_len);
    filter_blocks_cords(chains, cords, read_len, thd_major_limit, f_header,
                        unset_end_f, set_end_f);
}

// ------------------------------------------------------- hits-level filter

static inline bool _is_range_overlap(i64 s1, i64 e1, i64 s2, i64 e2) {
    return std::max(s1, s2) < std::min(e1, e2);
}

static inline bool _is_cordy_overlap(u64 c11, u64 c12, u64 c21, u64 c22,
                                     i64 read_len) {
    if (cstrand(c11 ^ c21))
        return _is_range_overlap(cy(c11), cy(c12), read_len - 1 - cy(c21),
                                 read_len - 1 - cy(c22));
    return _is_range_overlap(cy(c11), cy(c12), cy(c21), cy(c22));
}

// _filterBlocksHits (cluster_util.cpp:633)
static inline void filter_blocks_hits(const std::vector<std::vector<PII>>& chains,
                                      std::vector<u64>& hits, i64 read_len) {
    if (chains.empty()) return;
    std::vector<u64> out;
    std::vector<PII> best_chain(chains[0]);
    i64 len_current = 0;
    for (auto& p : chains[0]) {
        for (i64 j = p.first; j < p.second; j++)
            out.push_back(unset_end(hits[j]));
        len_current += p.second - p.first;
    }
    out.back() = set_end(out.back());
    double thd_major_bound = 0.8 * (double)len_current;
    const i64 thd_major_limit = 5;
    i64 major_n = 1;
    i64 thd_x_max_delta = read_len * 2;
    for (size_t i = 1; i < chains.size(); i++) {
        auto& ch = chains[i];
        len_current = 0;
        for (auto& p : ch) len_current += p.second - p.first;
        bool f_append = false;
        if (major_n < thd_major_limit && (double)len_current > thd_major_bound) {
            f_append = true;
            major_n++;
        } else if (len_current) {
            // fall through (no append)
        } else {
            // dead in practice; mirrors the C++ structure
            f_append = true;
            for (auto& p : ch) {
                if (!f_append) break;
                for (auto& q : best_chain) {
                    u64 str_major = hits[q.first];
                    u64 end_major = hits[q.second - 1];
                    u64 str_cur = hits[p.first];
                    u64 end_cur = hits[p.second - 1];
                    i64 dx_lower = cx(str_major) - cx(str_cur);
                    i64 dx_upper = cx(end_cur) - cx(end_major);
                    f_append = dx_lower <= thd_x_max_delta &&
                               dx_upper < thd_x_max_delta &&
                               !_is_cordy_overlap(str_major, end_major, str_cur,
                                                  end_cur, read_len);
                    if (!f_append) break;
                }
            }
            if (f_append)
                best_chain.insert(best_chain.end(), ch.begin(), ch.end());
        }
        if (f_append) {
            for (auto& p : ch)
                for (i64 j = p.first; j < p.second; j++)
                    out.push_back(unset_end(hits[j]));
            out.back() = set_end(out.back());
        }
        out.back() = set_end(out.back());
    }
    hits = out;
}

// chainBlocksHits (cluster_util.cpp:721)
static inline void chain_blocks_hits(std::vector<u64>& hits,
                                     const std::vector<PII>& str_ends_p,
                                     const std::vector<i64>& str_ends_p_score,
                                     i64 read_len) {
    ChainScoreParms parms;
    std::vector<std::vector<PII>> chains;
    chain_blocks_base(hits, str_ends_p, str_ends_p_score, read_len,
                      get_apx_chain_score2, parms, 1, 0, 3, true, 0.7, chains);
    filter_blocks_hits(chains, hits, read_len);
}

}  // namespace le
