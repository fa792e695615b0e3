"""Sparse chaining DP over anchors and over blocks of cords/hits.

Exact re-derivation of the reference's cluster_util.cpp:
  - get_best_chains        (getBestChains :53)        O(n * depth) DP
  - traceback 0/1          (traceBackChains0/1 :121/:213) selected by root count
  - anchor scores          (getApxChainScore/0 :337-443)
  - block DP + traceback   (getBestChains2/chainBlocksBase :469-577)
  - block scores           (getApxChainScore2 :586, getApxChainScore3 :811,
                             probabilistic getChainBlocksScore1 :1104)
  - dual-strand block chaining (chainBlocksCords :936-1102)
  - major-chain filters    (_filterBlocksHits :633, _filterBlocksCords :865)

These run on the host for oracle/testing and for the (cheap) block-level
passes; the per-anchor DP also has a batched device implementation in
ops.chain_dp (the device DP tables enter through chain_records_from_dp).

All arithmetic mirrors C++ int semantics (truncating division).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

from ..utils import cordlib as C
from ..utils import cordscalar as CS
from ..utils import cxxsort as CXS
from ..utils.dbg import dbg as _dbg

INT_MIN = -(2**31)
CHAIN_END = -1
DELETE_SCORE = -1000


def tdiv(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


@dataclass
class ChainScoreParms:
    mean_d: int = 1000
    var_d: int = 1000
    chn_block_strand: int = 0
    gacs3_ins_read_len_ratio: float = 1.0


@dataclass
class ChainsRecord:
    score: int = 0
    score2: int = 0
    length: int = 0
    p2anchor: int = CHAIN_END
    root_ptr: int = 0
    f_leaf: int = 0


def chain_records_from_dp(p2, score, length, n: int) -> List["ChainsRecord"]:
    """Rebuild the ChainsRecord list (incl. root_ptr / f_leaf) from a DP
    table computed on device (ops.chain_dp) — same sequential bookkeeping
    as get_best_chains below."""
    recs = [ChainsRecord() for _ in range(n)]
    if n == 0:
        return recs
    recs[0].score = 0
    recs[0].length = 1
    recs[0].p2anchor = -1
    for i in range(n):
        max_j = int(p2[i])
        if max_j >= 0:
            recs[i].p2anchor = max_j
            recs[i].score = int(score[i])
            recs[i].length = int(length[i])
            recs[i].score2 = recs[i].score
            recs[i].root_ptr = recs[max_j].root_ptr
            recs[i].f_leaf = 1
            recs[max_j].f_leaf = 0
        else:
            recs[i].p2anchor = -1
            recs[i].score = 0
            recs[i].length = 1
            recs[i].score2 = 0
            recs[i].root_ptr = i
            recs[i].f_leaf = 1
    return recs


# ---------------------------------------------------------------- anchor DP


def get_best_chains(
    anchors: np.ndarray,
    it_str: int,
    it_end: int,
    thd_chain_depth: int,
    thd_chain_dx_depth: int,
    get_score: Callable[[int, int, ChainScoreParms], int],
    parms: ChainScoreParms,
    get_anchor_x: Callable[[int], int],
) -> List[ChainsRecord]:
    """getBestChains: anchors must be sorted descending by get_anchor_x."""
    n = len(anchors)
    recs = [ChainsRecord() for _ in range(n)]
    if n == 0:
        return recs
    recs[0].score = 0
    recs[0].length = 1
    recs[0].p2anchor = CHAIN_END
    al = [int(a) for a in (anchors.tolist() if hasattr(anchors, 'tolist') else anchors)]
    ax = [get_anchor_x(a) for a in al]
    for i in range(it_str, it_end):
        j_str = max(0, i - thd_chain_depth)
        max_j = i
        new_max = -1
        j = i - 1
        while j >= 0 and (j >= j_str or ax[j] - ax[i] < thd_chain_dx_depth):
            s = get_score(al[j], al[i], parms)
            if s > 0 and s + recs[j].score >= new_max:
                max_j = j
                new_max = s + recs[j].score
            j -= 1
        if new_max > 0:
            recs[i].p2anchor = max_j
            recs[i].score = new_max
            recs[i].length = recs[max_j].length + 1
            recs[i].score2 = new_max
            recs[i].root_ptr = recs[max_j].root_ptr
            recs[i].f_leaf = 1
            recs[max_j].f_leaf = 0
        else:
            recs[i].p2anchor = CHAIN_END
            recs[i].score = 0
            recs[i].length = 1
            recs[i].score2 = 0
            recs[i].root_ptr = i
            recs[i].f_leaf = 1
    return recs


def tdiv_vec(a, b):
    """C truncating division, numpy arrays."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) ^ (b < 0), -q, q)


_MASK_Y = (1 << 20) - 1
_MASK_X30 = (1 << 30) - 1
_VALUE_MASK_DSTR = ((1 << 60) - 1) | (1 << 61)


def anchor_x_vec(a: np.ndarray) -> np.ndarray:
    """getAnchorX (src/cords.cpp:463), numpy int64."""
    new = (a + ((a & _MASK_Y) << 20) - (1 << 40)) & _VALUE_MASK_DSTR
    return (new >> 20) & _MASK_X30


def get_apx_chain_score_vec(a1, a2, parms):
    """Vectorized getApxChainScore (cluster_util.cpp:387)."""
    dy = (a1 & _MASK_Y) - (a2 & _MASK_Y)
    dx = anchor_x_vec(a1) - anchor_x_vec(a2)
    da = np.abs(dx - dy)
    denom = np.maximum(np.maximum(np.abs(dy), np.abs(dx)), 50)
    derr = tdiv_vec(100 * da, denom)
    score_derr = np.where(derr < 5, 4 * derr,
                          np.where(derr < 10, 6 * derr - 10, derr * derr - 5 * derr))
    dy15 = tdiv_vec(dy, 15)
    score_dy = np.where(dy15 < 150, tdiv_vec(dy15, 5),
                        np.where(dy15 < 10000, tdiv_vec(dy15 * dy15, 200) + 20, 10000))
    score = np.where(da < 10, 100 - score_dy, 100 - score_dy - score_derr)
    score = np.where(derr >= 100, -1000, score)
    return np.where(dy < 10, -10000, score)


def get_apx_chain_score0_vec(a1, a2, parms):
    """Vectorized getApxChainScore0 (cluster_util.cpp:337)."""
    dy = (a1 & _MASK_Y) - (a2 & _MASK_Y)
    dx = anchor_x_vec(a1) - anchor_x_vec(a2)
    da = np.abs(dx - dy)
    denom = np.maximum(np.maximum(np.abs(dy), np.abs(dx)), 50)
    derr = tdiv_vec(100 * da, denom)
    score = np.where(da < 30, 100 - dy, 100 - dy - da)
    score = np.where(derr >= 100, -1000, score)
    return np.where(dy < 5, -10000, score)


_EDGE_W_CAP = 512


def get_best_chains_edges(
    anchors: np.ndarray,
    it_str: int,
    it_end: int,
    thd_chain_depth: int,
    thd_chain_dx_depth: int,
    vec_score,
    parms: ChainScoreParms,
    ax: np.ndarray,
):
    """Vectorized-edge getBestChains: precompute the banded (n, W) score
    matrix with ONE numpy evaluation of the score function, then run the
    exact sequential DP over it. Returns recs, or None when the band would
    exceed _EDGE_W_CAP (caller falls back to the scalar path).

    Requires anchors sorted descending by anchor-x (as all callers do) —
    then the C++ scan's break-at-first-failure is a contiguous j range
    (stop_j, i): ax[j] - ax[i] is non-decreasing as j decreases."""
    n = len(anchors)
    recs = [ChainsRecord() for _ in range(n)]
    if n == 0:
        return recs
    a = np.asarray(anchors, dtype=np.int64)
    axd = np.asarray(ax, dtype=np.int64)
    ii = np.arange(n)
    # q(i) = largest j with ax[j] >= ax[i] + dx_depth (or -1)
    rev = axd[::-1]  # ascending
    idx_rev = np.searchsorted(rev, axd + thd_chain_dx_depth, side="left")
    q = n - 1 - idx_rev
    stop_j = np.minimum(ii - thd_chain_depth - 1, q)
    lo = np.maximum(stop_j + 1, 0)
    W = int(np.max(ii - lo)) + 1 if n > 1 else 1
    if W > _EDGE_W_CAP:
        return None
    # edge[i, w] = score(a[j], a[i]) with j = i - W + w, w in [0, W)
    j_idx = ii[:, None] - (W - np.arange(W))[None, :]
    jc = np.clip(j_idx, 0, n - 1)
    edge = vec_score(a[jc], a[:, None], parms)
    EDGE = edge.tolist()
    LO = lo.tolist()
    scores = [0] * n
    lengths = [1] * n
    p2s = [CHAIN_END] * n
    recs[0].score = 0
    recs[0].length = 1
    recs[0].p2anchor = CHAIN_END
    for i in range(it_str, it_end):
        l = LO[i]
        row = EDGE[i]
        base = i - W
        new_max = -1
        max_j = i
        for j in range(i - 1, l - 1, -1):
            s = row[j - base]
            if s > 0 and s + scores[j] >= new_max:
                max_j = j
                new_max = s + scores[j]
        r = recs[i]
        if new_max > 0:
            r.p2anchor = max_j
            r.score = new_max
            r.length = lengths[max_j] + 1
            r.score2 = new_max
            r.root_ptr = recs[max_j].root_ptr
            r.f_leaf = 1
            recs[max_j].f_leaf = 0
            scores[i] = new_max
            lengths[i] = r.length
        else:
            r.p2anchor = CHAIN_END
            r.score = 0
            r.length = 1
            r.score2 = 0
            r.root_ptr = i
            r.f_leaf = 1
            scores[i] = 0
            lengths[i] = 1
    return recs


def traceback_chains0(
    elements: list,
    recs: List[ChainsRecord],
    min_len: int,
    abort_score: int,
    bestn: int,
    stop_ratio: float,
) -> Tuple[list, list]:
    """traceBackChains0: greedy best-first extraction with score-deletion."""
    chains: list = []
    chains_score: list = []
    search_times = min(50, bestn)
    for _ in range(search_times):
        chain: list = []
        chain_score: list = []
        f_done = True
        max_2nd = -1
        max_score = -1
        max_str = CHAIN_END
        max_len = 0
        for j, r in enumerate(recs):
            if r.score > max_score:
                max_2nd = max_score
                max_str = j
                max_score = r.score
                max_len = r.length
                f_done = False
        if chains:
            if max_len > len(chains[0]) * stop_ratio:
                f_done = False
        if f_done or max_score == 0:
            break
        if max_len > min_len and tdiv(max_score, max_len - 1) > abort_score:
            j = max_str
            while j != CHAIN_END:
                if recs[j].score != DELETE_SCORE:
                    chain.append(elements[j])
                    chain_score.append(recs[j].score2)
                    recs[j].score = DELETE_SCORE
                else:
                    infix = recs[j].score2
                    if max_score - infix < max_2nd:
                        k = max_str
                        while k != j:
                            recs[k].score = recs[k].score2 - infix
                            k = recs[k].p2anchor
                        chain = []
                        chain_score = []
                    break
                j = recs[j].p2anchor
            if chain:
                chains.append(chain)
                chains_score.extend(chain_score)
        if max_str != CHAIN_END:
            recs[max_str].score = DELETE_SCORE
    return chains, chains_score


def traceback_chains1(
    elements: list,
    recs: List[ChainsRecord],
    min_len: int,
    abort_score: int,
    bestn: int,
    stop_ratio: float,
) -> Tuple[list, list]:
    """traceBackChains1: per-root best-leaf extraction (chains may share
    elements; replicated including its keep-walking-after-stop behavior)."""
    chains: list = []
    chains_score: list = []
    f_stop = False
    leaves: list = []  # [root, best_score, best_len, best_leaf]
    for j, r in enumerate(recs):
        if r.f_leaf:
            found = False
            for lv in leaves:
                if lv[0] == r.root_ptr:
                    if r.score > lv[1]:
                        lv[1], lv[2], lv[3] = r.score, r.length, j
                    found = True
            if not found:
                leaves.append([r.root_ptr, r.score, r.length, j])
    # std::sort desc by tree best score (cluster_util.cpp:269)
    ranks = [int(i) for i in CXS.std_sort_perm([lv[1] for lv in leaves], desc=True)]
    for i in range(min(bestn, len(ranks))):
        chain: list = []
        chain_score: list = []
        _, max_score, max_len, max_str = leaves[ranks[i]]
        mean_score = tdiv(max_score, max_len - 1) if max_len > 1 else abort_score + 1
        if max_len > min_len and mean_score > abort_score:
            j = max_str
            while j != CHAIN_END:
                chain.append(elements[j])
                chain_score.append(recs[j].score2)
                j = recs[j].p2anchor
            if chain:
                if chains and len(chain) / len(chains[0]) < stop_ratio:
                    f_stop = True
                if not f_stop:
                    chains.append(chain)
                    chains_score.extend(chain_score)
    return chains, chains_score


def traceback_chains(
    elements: list,
    recs: List[ChainsRecord],
    min_len: int,
    abort_score: int,
    bestn: int,
    stop_ratio: float,
) -> Tuple[list, list]:
    thd_root_num = 50
    roots = {r.root_ptr for r in recs}
    if len(roots) > thd_root_num:
        return traceback_chains0(elements, recs, min_len, abort_score, bestn, stop_ratio)
    return traceback_chains1(elements, recs, min_len, abort_score, bestn, stop_ratio)


# ------------------------------------------------------------ anchor scores


def get_apx_chain_score(a1: int, a2: int, parms: ChainScoreParms) -> int:
    """getApxChainScore (cluster_util.cpp:395): default anchor score."""
    dy = CS.cy(a1) - CS.cy(a2)
    if dy < 10:
        return -10000
    thd_min_dy = 50
    dx = CS.anchor_x(a1) - CS.anchor_x(a2)
    da = abs(dx - dy)
    derr = tdiv(100 * da, max(abs(dy), abs(dx), thd_min_dy))
    if derr < 5:
        score_derr = 4 * derr
    elif derr < 10:
        score_derr = 6 * derr - 10
    elif derr < 100:
        score_derr = derr * derr - 5 * derr
    else:
        return -1000
    dy = tdiv(dy, 15)
    if dy < 150:
        score_dy = tdiv(dy, 5)
    elif dy < 100:
        score_dy = dy - 30
    elif dy < 10000:
        score_dy = tdiv(dy * dy, 200) + 20
    else:
        score_dy = 10000
    if da < 10:
        return 100 - score_dy
    return 100 - score_dy - score_derr


def get_apx_chain_score0(a1: int, a2: int, parms: ChainScoreParms) -> int:
    """getApxChainScore0 (cluster_util.cpp:337): toggle(1) variant (re-apx)."""
    dy = CS.cy(a1) - CS.cy(a2)
    if dy < 5:
        return -10000
    thd_min_dy = 50
    dx = CS.anchor_x(a1) - CS.anchor_x(a2)
    da = abs(dx - dy)
    derr = tdiv(100 * da, max(abs(dy), abs(dx), thd_min_dy))
    if derr >= 100:
        return -1000
    # (the intermediate score_derr/score_dy branches are dead in the C++:
    #  both are overwritten with dy and da just before the return)
    score_dy = dy
    score_derr = da
    if da < 30:
        return 100 - score_dy
    return 100 - score_dy - score_derr


def chain_anchors_base(
    anchors: np.ndarray,
    it_str: int,
    it_end: int,
    thd_chain_depth: int,
    thd_chain_dx_depth: int,
    thd_best_n: int,
    stop_ratio: float,
    min_len: int,
    abort_score: int,
    get_score: Callable,
    parms: ChainScoreParms,
    get_anchor_x: Callable[[int], int],
    pre_recs: List[ChainsRecord] | None = None,
    vec_score: Callable | None = None,
    vec_anchor_x: Callable | None = None,
) -> Tuple[list, list]:
    """chainAnchorsBase (cluster_util.cpp:445). Returns (chains, scores):
    chains = list of anchor-value lists (leaf -> root order).

    pre_recs: DP table precomputed on device (ops.chain_dp) for these exact
    anchors — skips the host getBestChains, traceback unchanged.
    vec_score/vec_anchor_x: numpy implementations of the score / anchor-x
    functions; when given, the DP edges are precomputed vectorized."""
    if len(anchors) < 2:
        return [], []
    recs = pre_recs
    if recs is None and vec_score is not None:
        a64 = np.asarray(
            [int(x) for x in (anchors.tolist() if hasattr(anchors, "tolist") else anchors)],
            dtype=np.int64)
        ax = vec_anchor_x(a64) if vec_anchor_x is not None else np.asarray(
            [get_anchor_x(int(x)) for x in a64], dtype=np.int64)
        recs = get_best_chains_edges(
            a64, it_str, it_end, thd_chain_depth, thd_chain_dx_depth,
            vec_score, parms, ax)
    if recs is None:
        recs = get_best_chains(
            anchors, it_str, it_end, thd_chain_depth, thd_chain_dx_depth, get_score, parms, get_anchor_x
        )
    elements = [int(a) for a in (anchors.tolist() if hasattr(anchors, "tolist") else anchors)]
    return traceback_chains(elements, recs, min_len, abort_score, thd_best_n, stop_ratio)


# ------------------------------------------------------------- block DP


def get_best_chains2(
    hits: np.ndarray,
    str_ends_p: List[Tuple[int, int]],
    scores: List[int],
    read_len: int,
    get_score2: Callable,
    parms: ChainScoreParms,
    thd_chain_depth: int = 20,
) -> List[ChainsRecord]:
    """getBestChains2 (cluster_util.cpp:469): DP over blocks."""
    n = len(str_ends_p)
    recs = [ChainsRecord() for _ in range(n)]
    if n == 0:
        return recs
    recs[0].score = scores[0]
    recs[0].length = str_ends_p[0][1] - str_ends_p[0][0]
    recs[0].p2anchor = CHAIN_END
    for i in range(n):
        j_str = max(0, i - thd_chain_depth)
        max_j = i
        new_max = -1
        for j in range(j_str, i):
            s = get_score2(
                int(hits[str_ends_p[j][0]]),
                int(hits[str_ends_p[j][1] - 1]),
                int(hits[str_ends_p[i][0]]),
                int(hits[str_ends_p[i][1] - 1]),
                read_len,
                parms,
            )
            if s > 0 and s + recs[j].score + scores[i] >= new_max:
                max_j = j
                new_max = s + recs[j].score + scores[i]
        if new_max > 0:
            recs[i].p2anchor = max_j
            recs[i].score = new_max
            recs[i].length = str_ends_p[i][1] - str_ends_p[i][0] + recs[max_j].length
            recs[i].score2 = recs[i].score
            recs[i].root_ptr = recs[max_j].root_ptr
            recs[i].f_leaf = 1
            recs[max_j].f_leaf = 0
        else:
            recs[i].p2anchor = CHAIN_END
            recs[i].score = scores[i]
            recs[i].length = str_ends_p[i][1] - str_ends_p[i][0]
            recs[i].score2 = recs[i].score
            recs[i].root_ptr = i
            recs[i].f_leaf = 1
    return recs


def chain_blocks_base(
    records: np.ndarray,
    str_ends_p: List[Tuple[int, int]],
    scores: List[int],
    read_len: int,
    get_score2: Callable,
    parms: ChainScoreParms,
    min_len: int,
    abort_score: int,
    thd_best_n: int,
    f_sort: bool,
    stop_ratio: float,
) -> list:
    """chainBlocksBase (cluster_util.cpp:505). Returns chains of (str,end)
    block pointer pairs."""
    if len(str_ends_p) < 2:
        return []
    order = list(range(len(str_ends_p)))
    if f_sort:
        # std::sort desc by the 40-bit (id | x) field (_DefaultCord.getCordX,
        # cluster_util.cpp:558); tie permutation must match the reference
        keys = [
            int((np.uint64(records[str_ends_p[a][0]]) >> np.uint64(20))
                & np.uint64((1 << 40) - 1))
            for a in order
        ]
        order = [int(i) for i in CXS.std_sort_perm(keys, desc=True)]
    sp = [str_ends_p[i] for i in order]
    sc = [scores[i] for i in order]
    _dbg("CBBO", [int(records[p[0]]) for p in sp])
    recs = get_best_chains2(records, sp, sc, read_len, get_score2, parms)
    _dbg("GBC2", [v for r in recs for v in
                  (r.score, r.p2anchor, r.length, r.root_ptr, r.f_leaf)])
    chains, _ = traceback_chains(sp, recs, min_len, abort_score, thd_best_n, stop_ratio)
    return chains


def get_apx_chain_score2(c11, c12, c21, c22, read_len, parms: ChainScoreParms) -> int:
    """getApxChainScore2 (cluster_util.cpp:586): same-strand block chaining."""
    thd_max_d = 20000
    thd_indel_trigger = 100
    thd_indel_op = 30
    dy = CS.cy(c11) - CS.cy(c22)
    dx = CS.cx(c11) - CS.cx(c22)
    if (
        dx < 0
        or dy < 0
        or CS.strand(int(c11) ^ int(c22))
        or dx > thd_max_d
        or dy > thd_max_d
    ):
        return INT_MIN
    thd_min_dy = 100
    da = abs(dx - dy)
    derr = tdiv(100 * da, max(abs(dy), thd_min_dy, abs(dx)))
    if da > thd_indel_trigger or derr > 50:
        if dx < dy:  # ins
            return 100 - thd_indel_op - tdiv(dy, 1000) - tdiv(dx, 100)
        return 100 - thd_indel_op - tdiv(dy, 100) - tdiv(dx, 1000)
    return 100 - tdiv(dy, 95)


def get_chain_block_dxdy(c11, c12, c21, c22, read_len, strand) -> Tuple[int, int, int]:
    """getChainBlockDxDy (cluster_util.cpp:774). Returns (f_type, dx, dy)."""
    c11, c12, c21, c22 = int(c11), int(c12), int(c21), int(c22)
    s11 = CS.strand(c11)
    s22 = CS.strand(c22)
    if s11 != strand:
        if s22 != strand:
            dy = CS.cy(c21) - CS.cy(c12)
            dx = CS.cx(c21) - CS.cx(c12)
        else:
            dy = read_len - CS.cy(c12) - 1 - CS.cy(c22)
            dx = CS.cx(c11) - CS.cx(c22)
    else:
        if s22 != strand:
            dy = CS.cy(c11) - read_len + 1 + CS.cy(c21)
            dx = CS.cx(c11) - CS.cx(c22)
        else:
            dy = CS.cy(c11) - CS.cy(c22)
            dx = CS.cx(c11) - CS.cx(c22)
    return CS.strand(c11 ^ c22), dx, dy


def get_apx_chain_score3(c11, c12, c21, c22, read_len, parms: ChainScoreParms) -> int:
    """getApxChainScore3 (cluster_util.cpp:811): SV-aware block chaining."""
    thd_min_dy = -80
    thd_min_dx = -int(read_len)
    f_type, dx, dy = get_chain_block_dxdy(c11, c12, c21, c22, read_len, parms.chn_block_strand)
    thd_max_dy = int(read_len * parms.gacs3_ins_read_len_ratio)
    thd_max_dx = 15000
    thd_dup_trigger = -50
    dx_, dy_ = abs(dx), abs(dy)
    da = dx - dy
    if dy < thd_min_dy or dy > thd_max_dy or dx < thd_min_dx or dx_ > thd_max_dx:
        return INT_MIN
    score_dy = min(tdiv(dy_, 25) - 50, 70) if dy_ > 2000 else tdiv(dy_, 40)
    score_dx = min(tdiv(dx_, 25) - 50, 70) if dx_ > 2000 else tdiv(dx_, 40)
    score = 0
    if f_type == 1:  # inv
        if dx > thd_min_dx:
            score = 75 - score_dy
    elif da < -max(tdiv(dx_, 4), 50):
        if dx > thd_dup_trigger:  # ins
            score = 80 - score_dx
        else:  # dup
            score = 80 - score_dy
    elif da > max(tdiv(dy, 4), 50):  # del
        score = 80 - score_dy
    else:
        score = 100 - score_dy
    return score


# ---------------------------------------------------- probabilistic score

_ERF_NUM = [
    0, 0.022564575, 0.045111106, 0.067621594, 0.090078126, 0.112462916,
    0.222702589, 0.328626759, 0.428392355, 0.520499878, 0.603856091, 0.677801194,
    0.742100965, 0.796908212, 0.842700793, 0.88020507, 0.910313978, 0.934007945,
    0.95228512, 0.966105146, 0.976348383, 0.983790459, 0.989090502, 0.992790429,
    0.995322265, 0.997020533, 0.998137154, 0.998856823, 0.999311486, 0.999593048,
    1,
]


def erf_num(val: float) -> float:
    """NumericalScore::erf (cluster_util.cpp:1150): table approximation."""
    a = -val if val < 0 else val
    if a > 2.5:
        score = 1.0
    elif a < 0.1:
        i = int(a / np.float32(0.02))
        score = (_ERF_NUM[i] + _ERF_NUM[i + 1]) * 0.5
    else:
        i = int(5 + (np.float32(a) - np.float32(0.1)) / np.float32(0.1))
        score = (_ERF_NUM[i] + _ERF_NUM[i + 1]) * 0.5
    return -score if val < 0 else score


def cdf_n(val: float, mean: float, var: float) -> float:
    return (1 + erf_num((val - mean) / (var * 1.414))) * 0.5


def variants_prob(strand: int, dx: int, dy: int) -> float:
    da = dx - dy
    p = 1.0
    if strand:
        p = 0.5
    if da < -max(tdiv(dx, 4), 50):
        p = 0.5 if dx > -50 else 0.25
    elif da > max(tdiv(dy, 4), 50):
        p = 0.5
    return p


def get_chain_blocks_score1(c11, c12, c21, c22, read_len, parms: ChainScoreParms) -> int:
    """getChainBlocksScore1 (cluster_util.cpp:1181): erf/CDF-based."""
    f_type, dx, dy = get_chain_block_dxdy(c11, c12, c21, c22, read_len, parms.chn_block_strand)
    if dy < -80:
        return INT_MIN
    d = max(min(dx, dy), 0)
    p_0 = 1 - cdf_n(float(d), float(parms.mean_d), float(parms.var_d))
    p = variants_prob(1 if f_type else 0, dx, dy) * p_0
    return int(np.float32(p) * 100)


# --------------------------------------------- dual-strand block chaining


def chain_blocks_single_strand(
    cords: np.ndarray,
    str_ends_p: List[Tuple[int, int]],
    get_score2: Callable,
    parms: ChainScoreParms,
    min_len: int,
    abort_score: int,
    read_len: int,
    thd_init_cord_score: int,
    strand: int,
) -> Tuple[list, List[Tuple[int, int]]]:
    """chainBlocksSingleStrand (cluster_util.cpp:1018). Returns
    (chains, sorted str_ends_p)."""
    parms.chn_block_strand = strand

    def key(p):
        first, second = p
        if strand:
            if not C.cord_strand(np.uint64(cords[first])):
                return read_len - 1 - int(C.cord_y(np.uint64(cords[second - 1])))
            return int(C.cord_y(np.uint64(cords[first])))
        if C.cord_strand(np.uint64(cords[first])):
            return read_len - 1 - int(C.cord_y(np.uint64(cords[second - 1])))
        return int(C.cord_y(np.uint64(cords[first])))

    # std::sort desc by strand-adjusted y (cluster_util.cpp:945/956)
    sp = CXS.std_sort(str_ends_p, [key(p) for p in str_ends_p], desc=True)
    scores = [(p[1] - p[0]) * thd_init_cord_score for p in sp]
    chains = chain_blocks_base(
        cords, sp, scores, read_len, get_score2, parms, min_len, abort_score,
        thd_best_n=3, f_sort=False, stop_ratio=0.7,
    )
    return chains, sp


def get_chain_blocks_best_strand(chains1: list, chains2: list) -> int:
    """getChainBlocksBestStrand (cluster_util.cpp:1107)."""
    lens1, lens2 = [], []
    for i, ch in enumerate(chains1):
        v = lens1[i - 1] if i else 0
        lens1.append(v + sum(p[1] - p[0] for p in ch))
    for i, ch in enumerate(chains2):
        v = lens2[i - 1] if i else 0
        lens2.append(v + sum(p[1] - p[0] for p in ch))
    for a, b in zip(lens1, lens2):
        if a < b:
            return 1
        if a > b:
            return 0
    return 0


def revert_chain_block_strand(chains: list, cords: np.ndarray, strand: int, read_len: int) -> None:
    """revertChainBlockStrand (cluster_util.cpp:1139): reverse runs of
    opposite-strand blocks within each chain, in place."""
    f_strand = 1 if strand else 0
    for chain in chains:
        chain.append((0, 0))
        strand_pre = 0
        swap_str = 0
        for j in range(len(chain)):
            if j == len(chain) - 1 or int(C.cord_strand(np.uint64(cords[chain[j][0]]))) == f_strand:
                strand_this = 0
            else:
                strand_this = 1
            if strand_this and not strand_pre:
                swap_str = j
            if not strand_this and strand_pre:
                lo, hi = swap_str, j
                chain[lo:hi] = chain[lo:hi][::-1]
            strand_pre = strand_this
        chain.pop()


def filter_blocks_cords(
    chains: list,
    hits: np.ndarray,
    read_len: int,
    thd_major_limit: int,
    f_header: bool,
    unset_end_func: Callable = None,
    set_end_func: Callable = None,
) -> np.ndarray:
    """_filterBlocksCords (cluster_util.cpp:1056): keep the major chain plus
    up to thd_major_limit-1 optional majors (len > 0.8 * major len). End-flag
    setters parameterized (cords: blockEnd bit 60; tiles: sgn end bit 63,
    unset via remove_tile_sgn_end)."""
    if unset_end_func is None:
        unset_end_func = lambda c: int(C.unset_block_end(np.uint64(c)))
    if set_end_func is None:
        set_end_func = lambda c: int(C.set_block_end(np.uint64(c)))
    if not chains:
        return hits
    out: list = []
    if f_header:
        out.append(int(hits[0]))
    len_current = 0
    for p in chains[0]:
        for j in range(p[0], p[1]):
            out.append(unset_end_func(int(hits[j])))
        len_current += p[1] - p[0]
    out[-1] = set_end_func(out[-1])
    thd_major_bound = 0.8 * len_current
    major_n = 1
    i = 1
    while i < len(chains) and major_n < thd_major_limit:
        ch = chains[i]
        len_current = sum(p[1] - p[0] for p in ch)
        if len_current > thd_major_bound:
            major_n += 1
            for p in ch:
                for j in range(p[0], p[1]):
                    out.append(unset_end_func(int(hits[j])))
            out[-1] = set_end_func(out[-1])
        i += 1
    return np.array(out, dtype=np.uint64)


def chain_blocks_cords(
    cords: np.ndarray,
    str_ends_p: List[Tuple[int, int]],
    get_score2: Callable,
    parms: ChainScoreParms,
    min_len: int,
    abort_score: int,
    read_len: int,
    thd_init_cord_score: int,
    thd_major_limit: int,
    f_header: bool,
    unset_end_func: Callable = None,
    set_end_func: Callable = None,
) -> np.ndarray:
    """chainBlocksCords (cluster_util.cpp:1068): chain under both strand
    orders, pick the better, revert inversion runs, keep major chains."""
    import copy

    chains1, sp1 = chain_blocks_single_strand(
        cords, list(str_ends_p), get_score2, copy.copy(parms), min_len, abort_score,
        read_len, thd_init_cord_score, strand=0,
    )
    chains2, sp2 = chain_blocks_single_strand(
        cords, list(str_ends_p), get_score2, copy.copy(parms), min_len, abort_score,
        read_len, thd_init_cord_score, strand=1,
    )
    best = get_chain_blocks_best_strand(chains1, chains2)
    chains = chains1 if best == 0 else chains2
    sp = sp1 if best == 0 else sp2
    revert_chain_block_strand(chains, cords, best, read_len)
    return filter_blocks_cords(
        chains, cords, read_len, thd_major_limit, f_header, unset_end_func, set_end_func
    )


# ------------------------------------------------------- hits-level filter


def filter_blocks_hits(chains: list, hits: np.ndarray, read_len: int) -> np.ndarray:
    """_filterBlocksHits (cluster_util.cpp:633): keep major chain; allow up to
    4 optional majors (>0.8 len); append strictly co-existing chains (e.g.
    inversions) to the major chain."""
    if not chains:
        return hits
    out: list = []
    best_chain = list(chains[0])
    len_current = 0
    for p in chains[0]:
        for j in range(p[0], p[1]):
            out.append(int(C.unset_block_end(np.uint64(hits[j]))))
        len_current += p[1] - p[0]
    out[-1] = int(C.set_block_end(np.uint64(out[-1])))
    thd_major_bound = 0.8 * len_current
    thd_major_limit = 5
    major_n = 1
    thd_x_max_delta = read_len * 2
    for i in range(1, len(chains)):
        ch = chains[i]
        len_current = sum(p[1] - p[0] for p in ch)
        f_append = False
        if major_n < thd_major_limit and len_current > thd_major_bound:
            f_append = True
            major_n += 1
        elif len_current:
            pass
        else:
            # dead in practice (len_current > 0 for any nonempty chain),
            # mirrors the C++ fall-through structure
            f_append = True
            for p in ch:
                if not f_append:
                    break
                for q in best_chain:
                    str_major = np.uint64(hits[q[0]])
                    end_major = np.uint64(hits[q[1] - 1])
                    str_cur = np.uint64(hits[p[0]])
                    end_cur = np.uint64(hits[p[1] - 1])
                    dx_lower = int(C.cord_x(str_major)) - int(C.cord_x(str_cur))
                    dx_upper = int(C.cord_x(end_cur)) - int(C.cord_x(end_major))
                    f_append = (
                        dx_lower <= thd_x_max_delta
                        and dx_upper < thd_x_max_delta
                        and not _is_cordy_overlap(str_major, end_major, str_cur, end_cur, read_len)
                    )
                    if not f_append:
                        break
            if f_append:
                best_chain.extend(ch)
        if f_append:
            for p in ch:
                for j in range(p[0], p[1]):
                    out.append(int(C.unset_block_end(np.uint64(hits[j]))))
            out[-1] = int(C.set_block_end(np.uint64(out[-1])))
        out[-1] = int(C.set_block_end(np.uint64(out[-1])))
    return np.array(out, dtype=np.uint64)


def _is_range_overlap(s1, e1, s2, e2) -> bool:
    # half-open [s,e) overlap (reference: _isRangeOverLap src/cords.cpp:450)
    return max(int(s1), int(s2)) < min(int(e1), int(e2))


def _is_cordy_overlap(c11, c12, c21, c22, read_len) -> bool:
    if int(C.cord_strand(np.uint64(c11) ^ np.uint64(c21))):
        return _is_range_overlap(
            C.cord_y(c11), C.cord_y(c12),
            read_len - 1 - int(C.cord_y(c21)), read_len - 1 - int(C.cord_y(c22)),
        )
    return _is_range_overlap(C.cord_y(c11), C.cord_y(c12), C.cord_y(c21), C.cord_y(c22))


def chain_blocks_hits(
    hits: np.ndarray,
    str_ends_p: List[Tuple[int, int]],
    str_ends_p_score: List[int],
    read_len: int,
) -> np.ndarray:
    """chainBlocksHits (cluster_util.cpp:721)."""
    parms = ChainScoreParms()
    chains = chain_blocks_base(
        hits, str_ends_p, str_ends_p_score, read_len,
        get_apx_chain_score2, parms,
        min_len=1, abort_score=0, thd_best_n=3, f_sort=True, stop_ratio=0.7,
    )
    _dbg("CHNS", [len(c) for c in chains])
    _dbg("CHNC", [v for c in chains for p_ in c for v in p_])
    return filter_blocks_hits(chains, hits, read_len)
