"""Gap / SV resolution module — mapGaps and its machinery.

Host-exact re-derivation of the reference's gap layer:
  - mapGaps / mapGap_                (src/gap.cpp:407,16)
  - 9-mer / 5-mer gap-local seeding  (g_mapHs_kmer_ src/gap_util.cpp:632,
                                      c_stream_ :1694, g_stream_ :1663)
  - anchor creation with direction-dependent widening bounds
                                     (g_mapHs_setAnchors_ :669,
                                      g_create_anchors_ :1596,
                                      c_createAnchors2 :1818)
  - gap chain scores                 (getGapAnchorsChainScore/2 :966,1013,
                                      getGapBlocksChainScore2/3 :1049,1107,
                                      getExtendClipScore :2126)
  - chains -> tiles                  (g_CreateChainsFromAnchors_ :1191,
                                      chainTiles :1177,
                                      g_CreateTilesFromChains_ :1275,1364,
                                      trimTiles :1498)
  - X-drop / clip / stick            (dropChainGapX :757, clipChain :2252,
                                      stickMainChain :2276)
  - one-side extension               (extendIntervalOneSide :3953,
                                      extendTilesOneSide :3920,
                                      remapChainOneEnd :3761,
                                      reExtendChainOneSide :3832)
  - two-sided ins/del extension      (extendsInterval :3696 and helpers)
  - generic remap                    (mapInterval :4444, mapGeneric :4492)
  - tile reform / splice             (reform_tiles :3042,
                                      insert_tiles2Cords_ :3148,3240)
  - post-pass normalization          (reformCords/reformCordsDxDy1
                                      src/cords.cpp:504,601)

Note: reform_tiles_'s base-level clip path (c_clip_ et al.) is dead code in
the reference (early return at src/gap_util.cpp:2995 and the call commented
at :3129-3134), so reform_tiles only adds head/tail sentinel tiles here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

from ..ops.hashing import HashStream
from ..utils.cordscalar import (
    M64, MASK_Y, cy, cx, cid, cxid, strand as cord_strand, is_end as cord_is_end,
    set_end as cord_set_end, unset_end as cord_unset_end, shift, make_cord,
    is_consecutive,
)
from ..utils import cxxsort as CXS
from . import chaining as CH
from . import pmpfinder as PMP

INT_MIN = -(2 ** 31)
LLMAX = (1 << 63) - 1
LLMIN = -(1 << 63)

G_MAP_LEFT = -1
G_MAP_CLOSED = 0
G_MAP_RGHT = 1

tdiv = CH.tdiv

# ------------------------------------------------------------------ tiles
# Tile sgn bits (src/gap_util.cpp:261): start = 1<<62, end = 2<<62 = 1<<63

TILE_SGN_STR = 1 << 62
TILE_SGN_END = 1 << 63
TILE_SGN = TILE_SGN_STR | TILE_SGN_END


def tile_x(t: int) -> int:
    return cx(t)


def tile_y(t: int) -> int:
    return cy(t)


def tile_strand(t: int) -> int:
    return cord_strand(t)


def is_tile_end(t: int) -> int:
    return t & TILE_SGN_END


def is_tile_start(t: int) -> int:
    return t & TILE_SGN_STR


def set_tile_end(t: int) -> int:
    return t | TILE_SGN_END


def set_tile_start(t: int) -> int:
    return t | TILE_SGN_STR


def remove_tile_sgn(t: int) -> int:
    return t & ~TILE_SGN


def remove_tile_sgn_end(t: int) -> int:
    return t & ~TILE_SGN_END


def remove_tile_sgn_start(t: int) -> int:
    return t & ~TILE_SGN_STR


def copy_tile_sgn(t1: int, t2: int) -> int:
    return (t1 & TILE_SGN) | (t2 & ~TILE_SGN)


def set_tile_strand(t: int) -> int:
    return t | (1 << 61)


def create_tile(gid: int, x: int, y: int, std: int) -> int:
    return make_cord(gid, x, y, std)


shift_tile = shift

# ------------------------------------------------------------- chain metric


@dataclass
class ChainMetric:
    """ChainScoreMetric (include/cluster_util.h:22)."""

    thd_min_chain_len: int
    thd_abort_score: int
    get_score: Callable = None
    get_score2: Callable = None

    def copy(self) -> "ChainMetric":
        return ChainMetric(self.thd_min_chain_len, self.thd_abort_score,
                           self.get_score, self.get_score2)


# ----------------------------------------------------------------- parms


@dataclass
class GapParms:
    """GapParms (include/gap_util.h:81, ctor src/gap_util.cpp:27-90) with
    thd_err = 0.2 (src/mapper.cpp:207)."""

    thd_err: float = 0.2
    direction: int = 0
    int_precision: int = 10000
    thd_tile_size: int = 96
    ref_len: int = 0
    read_len: int = 0

    thd_ecr_shape_len: int = 3
    thd_ecr_reject_da: int = 20
    f_rfts_clip: int = 1
    thd_accept_score: int = 32
    f_me_map_extend: int = 0
    thd_me_reject_gap: int = 200
    thd_ctfcs_accept_score: int = 32
    thd_ctfcs_pattern_in_window: int = 1
    f_gmsa_direction: int = 0
    thd_gmsa_d_anchor_rate: float = 0.1
    thd_cts_major_limit: int = 1
    thd_ctfas2_connect_danchor: int = 50
    thd_ctfas2_connect_dy_dx: int = 150
    f_eis_raw_clip: int = 1
    f_eis_raw_clip_ins: int = 1
    thd_eis_shape_len: int = 9
    thd_eis_step1: int = 5
    thd_eis_step2: int = 1
    thd_dcgx_window_size: int = 5
    thd_dcgx_Xdrop_peak: int = 125
    thd_dcgx_Xdrop_sum: int = 300  # 60 * window_size
    thd_tts_overlap_size: int = 81  # int(96 * 0.85)
    thd_tts_gap_size: int = 100
    thd_smcn_danchor: int = 12
    thd_dcomx_err_dx: int = 25
    thd_dcomx_err_dy: int = 25
    thd_eicos_clip_dxy: int = 30
    thd_eicos_window_size: int = 8
    thd_eicos_f_as_ins: bool = True
    thd_etfas_shape_len: int = 5
    thd_etfas_step1: int = 3
    thd_etfas_step2: int = 1
    thd_ccps_window_size: int = 5
    thd_ccps_clip_min: int = 1000
    thd_ccps_clip_init: int = 2000
    thd_ccps_clip1_upper: int = 80000
    thd_ccps_clip2_lower: int = 120000
    thd_mg1_danc_indel: int = 80
    thd_max_extend2: int = 5000
    f_dup: int = 0
    thd_gap_len_min: int = 50

    chn_score1: ChainMetric = None
    chn_score2: ChainMetric = None
    chn_ext_clip_metric1: ChainMetric = None

    def __post_init__(self):
        if self.chn_score1 is None:
            self.chn_score1 = ChainMetric(1, 50, get_score=get_gap_anchors_chain_score)
        if self.chn_score2 is None:
            self.chn_score2 = ChainMetric(1, 0, get_score2=get_gap_blocks_chain_score2)
        if self.chn_ext_clip_metric1 is None:
            self.chn_ext_clip_metric1 = ChainMetric(1, 0, get_score=get_extend_clip_score)

    def clip_chain_parms(self, shape_len: int, thd_err_rate: float) -> None:
        """GapParms::clipChainParms (src/gap_util.cpp:82)."""
        self.thd_ccps_window_size = 5
        self.thd_ccps_clip_min = int(min(thd_err_rate, 0.1) * self.int_precision)
        self.thd_ccps_clip_init = int(thd_err_rate * self.int_precision)
        self.thd_ccps_clip1_upper = 8 * self.int_precision
        self.thd_ccps_clip2_lower = 12 * self.int_precision


# ----------------------------------------------------- g_hs / g_hs_anchor
# g_hs:        N/A[1]|xval[30]|type[2]|strand[1]|coordinate[30]  (:522)
# g_hs_anchor: N/A[13]|strand[1]|anchorX[30]|cord_y[20]          (:482)

G_HS_ANCHOR_MASK1 = (1 << 20) - 1
G_HS_ANCHOR_MASK3 = (1 << 30) - 1
G_HS_ANCHOR_MASK5 = (1 << 31) - 1
G_HS_ANCHOR_BIT1 = 20
G_HS_ANCHOR_BIT2 = 50
G_HS_ANCHOR_MASK2 = ~(1 << 50) & M64
G_HS_ANCHOR_ZERO = 1 << 20
G_HS_MASK2 = (1 << 30) - 1
G_HS_MASK3 = (1 << 32) - 1


def _i32(v: int) -> int:
    """C++ int32 wrap (the reference stores gap scores in String<int> and
    sums them in int; long repeat chains overflow and the clip decisions
    depend on the wrapped values)."""
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def g_hs_make(xval: int, typ: int, std: int, coord: int) -> int:
    return ((xval << 33) + (typ << 31) + (std << 30) + coord) & M64


def g_hs_cord(v: int) -> int:
    return v & G_HS_MASK2


def g_hs_xt(v: int) -> int:
    return (v >> 31) & G_HS_MASK3


def ganchor_get_anchor(a: int) -> int:
    return (a >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK3


def ganchor_str_anchor(a: int) -> int:
    return ((a >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO


def ganchor_x(a: int) -> int:
    return ((a >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK3) - G_HS_ANCHOR_ZERO + (a & G_HS_ANCHOR_MASK1)


def ganchor_y(a: int) -> int:
    return a & G_HS_ANCHOR_MASK1


def ganchor_strand(a: int) -> int:
    return (a >> G_HS_ANCHOR_BIT2) & 1


def g_hs_cord2str_anchor(cord: int) -> int:
    """g_hs_Cord2StrAnchor (src/gap_util.cpp:543)."""
    return cx(cord) - cy(cord) + (cord_strand(cord) << (G_HS_ANCHOR_BIT2 - G_HS_ANCHOR_BIT1))


def g_hs_set_anchor(hs1: int, hs2: int, revscomp_const: int) -> int:
    """g_hs_setAnchor_ (src/gap_util.cpp:548). hs1 genome, hs2 read."""
    std = ((hs1 ^ hs2) >> 30) & 1
    n = 2 * std - 1  # _nStrand (src/base.cpp:108): 0 -> -1, 1 -> +1
    x = (revscomp_const * std - n * (hs2 & G_HS_MASK2)) & M64
    return ((((hs1 + G_HS_ANCHOR_ZERO - x) & G_HS_MASK2) << 20) + x + (std << G_HS_ANCHOR_BIT2)) & M64


def c_2anchor(hs1: int, hs2: int) -> int:
    """c_2Anchor_ (src/gap_util.cpp:558): strand omitted."""
    x = hs2 & G_HS_MASK2
    return ((((hs1 - x + G_HS_ANCHOR_ZERO) & G_HS_MASK2) << G_HS_ANCHOR_BIT1) + x) & M64


def ganchor2tile(a: int) -> int:
    """g_hs_anchor2Tile (src/gap_util.cpp:574)."""
    std = (a >> G_HS_ANCHOR_BIT2) & 1
    y = ganchor_y(a)
    val = (a - (G_HS_ANCHOR_ZERO << 20) + ((a & G_HS_ANCHOR_MASK1) << 20)) & M64
    val = (val & G_HS_ANCHOR_MASK2) & ~G_HS_ANCHOR_MASK1 & M64
    return (val + y + (std << 61)) & M64


# ----------------------------------------------------------- hash streams


def g_map_hs_kmer(seq: np.ndarray, g_hs: List[int], s: int, e: int, shape_len: int, step: int, typ: int) -> None:
    """g_mapHs_kmer_ (src/gap_util.cpp:632): double-strand canonical stream
    (hashInit + hashNextV: value = x<0 ? crh : h; strand = x<0).

    Vectorized closed form for N-free ranges (the rolling state at position
    k telescopes to pure window functions of seq[k:k+span) — carries from
    any earlier N are shifted/masked out once the window is clean); ranges
    containing N fall back to the exact scalar stream."""
    if len(seq) < shape_len:
        return
    stop = min(e, len(seq) - shape_len)
    if stop > s >= 0 and not (np.asarray(seq[s: stop + shape_len - 1]) == 4).any():
        ks = np.arange(s + step - 1, stop, step, dtype=np.int64)
        if ks.size == 0:
            return
        win = np.lib.stride_tricks.sliding_window_view(
            np.asarray(seq[s: stop + shape_len - 1], dtype=np.int64), shape_len
        )[ks - s]                                            # (m, span)
        pow_f = (1 << (2 * np.arange(shape_len - 1, -1, -1, dtype=np.int64)))
        h = win @ pow_f
        crh = (3 - win) @ pow_f[::-1]
        x = 2 * win.sum(axis=1) - 3 * shape_len
        std = (x < 0).astype(np.int64)
        val = np.where(std == 1, crh, h) & ((1 << (2 * shape_len)) - 1)
        g_hs.extend(((val << 33) + (typ << 31) + (std << 30) + ks).tolist())
        return
    st = HashStream(shape_len, weight=shape_len)
    if st.init(seq, s) < 0:
        return
    count = 0
    for k in range(s, stop):
        st.nexth(seq, k)  # updates h, crh, x identically to hashNextV
        std = 1 if st.x < 0 else 0
        val = st.crh if std else st.h
        count += 1
        if count == step:
            g_hs.append(g_hs_make(val & ((1 << (2 * shape_len)) - 1), typ, std, k))
            count = 0


def c_stream(seq: np.ndarray, g_hs: List[int], sq_str: int, sq_end: int, step: int, shape_len: int, typ: int) -> None:
    """c_stream_ (src/gap_util.cpp:1694): single-strand rolling hash.

    Vectorized closed form for N-free ranges (same telescoping argument as
    g_map_hs_kmer); N-containing ranges use the exact scalar roll."""
    if len(seq) < shape_len:
        return
    stop = min(sq_end, len(seq) - shape_len)
    if stop > sq_str >= 0 and not (np.asarray(seq[sq_str: stop + shape_len - 1]) == 4).any():
        ks = np.arange(sq_str + step - 1, stop, step, dtype=np.int64)
        if ks.size == 0:
            return
        win = np.lib.stride_tricks.sliding_window_view(
            np.asarray(seq[sq_str: stop + shape_len - 1], dtype=np.int64), shape_len
        )[ks - sq_str]
        pow_f = (1 << (2 * np.arange(shape_len - 1, -1, -1, dtype=np.int64)))
        h = win @ pow_f
        g_hs.extend(((h << 33) + (typ << 31) + ks).tolist())
        return
    # hashInit_hs(shape, begin+sq_str, 0): span-1 bases from sq_str
    h = 0
    for i in range(shape_len - 1):
        p = sq_str + i
        h = ((h << 2) + (int(seq[p]) if p < len(seq) else 0)) & M64
    count = 0
    mask = (1 << (2 * shape_len - 2)) - 1
    for k in range(sq_str, stop):
        v2 = int(seq[k + shape_len - 1])
        h = (((h & mask) << 2) + v2) & M64
        count += 1
        if count == step:
            g_hs.append(g_hs_make(h, typ, 0, k))
            count = 0


def g_stream(seq1: np.ndarray, seq2: np.ndarray, g_hs: List[int], gap_str: int, gap_end: int,
             shape_len: int, step1: int, step2: int) -> None:
    """g_stream_ (src/gap_util.cpp:1663)."""
    gs_str, gs_end = cx(gap_str), cx(gap_end)
    gr_str, gr_end = cy(gap_str), cy(gap_end)
    if cord_strand(gap_str):
        gr_str = len(seq2) - gr_str - 1
        gr_end = len(seq2) - gr_end - 1
        gr_str, gr_end = gr_end, gr_str
    g_map_hs_kmer(seq1, g_hs, gs_str, gs_end, shape_len, step1, 0)
    g_map_hs_kmer(seq2, g_hs, gr_str, gr_end, shape_len, step2, 1)


# --------------------------------------------------------- anchor creation


def g_map_hs_set_anchors(g_hs: List[int], g_anchor: List[int], p1: int, p2: int, k: int,
                         revscomp_const: int, anchor_lower: int, anchor_upper: int,
                         gap_str: int, gap_end: int, direction: int, gp: GapParms) -> None:
    """g_mapHs_setAnchors_ (src/gap_util.cpp:669)."""
    if direction == 0:
        for i in range(p1, p2):
            for j in range(p2, k):
                a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const)
                tmp = ganchor_str_anchor(a)
                if anchor_lower <= tmp < anchor_upper:
                    g_anchor.append(a)
    elif direction < 0:
        y_end = cy(gap_end)
        anchor_base = g_hs_cord2str_anchor(gap_end)
        d_anchor = int((1 << 7) * gp.thd_gmsa_d_anchor_rate)
        for i in range(p1, p2):
            for j in range(p2, k):
                a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const)
                tmp = ganchor_str_anchor(a)
                dy = y_end - ganchor_y(a)
                if dy < 0 or (ganchor_strand(a) ^ cord_strand(gap_str)):
                    continue
                d_acc = max((dy >> 7) * d_anchor, 50)
                lo = max(anchor_base - d_acc, 0)
                hi = anchor_base + d_acc
                if lo <= tmp < hi:
                    g_anchor.append(a)
    else:
        y_str = cy(gap_str)
        anchor_base = g_hs_cord2str_anchor(gap_str)
        d_anchor = int((1 << 7) * gp.thd_gmsa_d_anchor_rate)
        for i in range(p1, p2):
            for j in range(p2, k):
                a = g_hs_set_anchor(g_hs[i], g_hs[j], revscomp_const)
                tmp = ganchor_str_anchor(a)
                dy = ganchor_y(a) - y_str
                if dy < 0 or (ganchor_strand(a) ^ cord_strand(gap_str)):
                    continue
                d_acc = max((dy >> 7) * d_anchor, 50)
                lo = max(anchor_base - d_acc, 0)
                hi = anchor_base + d_acc
                if lo <= tmp < hi:
                    g_anchor.append(a)


def _group_triples(g_hs: List[int], mask: int) -> List[Tuple[int, int, int]]:
    """The (p1, p2, k) group walk of g_create_anchors_ (src/gap_util.cpp:1596):
    xval groups split at the type boundary; the trailing group (no following
    boundary) is never emitted — same as the C++."""
    triples: List[Tuple[int, int, int]] = []
    p1 = p2 = 0
    for k in range(1, len(g_hs)):
        xt = g_hs_xt((g_hs[k] ^ g_hs[k - 1]) & mask)
        if xt == 0:
            pass
        elif xt == 1:
            p2 = k
        else:
            triples.append((p1, p2, k))
            p1 = k
            p2 = k
    return triples


def _set_anchors_batch(g_hs: List[int], g_anchor: List[int],
                       triples: List[Tuple[int, int, int]], rvcp_const: int,
                       anchor_lower: int, anchor_upper: int,
                       gap_str: int, gap_end: int, direction: int, gp: GapParms) -> None:
    """Vectorized g_mapHs_setAnchors_ (src/gap_util.cpp:669) over all xval
    groups at once; emission order (group, then i-major/j-minor) identical
    to the scalar double loop."""
    ii: List[np.ndarray] = []
    jj: List[np.ndarray] = []
    for p1, p2, k in triples:
        n0, n1 = p2 - p1, k - p2
        if n0 <= 0 or n1 <= 0:
            continue
        ii.append(np.repeat(np.arange(p1, p2, dtype=np.int64), n1))
        jj.append(np.tile(np.arange(p2, k, dtype=np.int64), n0))
    if not ii:
        return
    arr = np.asarray(g_hs, dtype=np.int64)
    hs1 = arr[np.concatenate(ii)]
    hs2 = arr[np.concatenate(jj)]
    std = (hs1 ^ hs2) >> 30 & 1
    n = 2 * std - 1
    x = rvcp_const * std - n * (hs2 & G_HS_MASK2)
    a = (((hs1 + G_HS_ANCHOR_ZERO - x) & G_HS_MASK2) << 20) + x + (std << G_HS_ANCHOR_BIT2)
    str_anchor = ((a >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    if direction == 0:
        keep = (anchor_lower <= str_anchor) & (str_anchor < anchor_upper)
    else:
        if direction < 0:
            anchor_base = g_hs_cord2str_anchor(gap_end)
            dy = cy(gap_end) - (a & G_HS_ANCHOR_MASK1)
        else:
            anchor_base = g_hs_cord2str_anchor(gap_str)
            dy = (a & G_HS_ANCHOR_MASK1) - cy(gap_str)
        d_anchor = int((1 << 7) * gp.thd_gmsa_d_anchor_rate)
        d_acc = np.maximum((dy >> 7) * d_anchor, 50)
        lo = np.maximum(anchor_base - d_acc, 0)
        hi = anchor_base + d_acc
        a_strand = (a >> G_HS_ANCHOR_BIT2) & 1
        keep = (dy >= 0) & (a_strand == cord_strand(gap_str)) & (lo <= str_anchor) & (str_anchor < hi)
    g_anchor.extend(a[keep].tolist())


def g_create_anchors(g_hs: List[int], g_anchor: List[int], shape_len: int, direction: int,
                     anchor_lower: int, anchor_upper: int, rvcp_const: int,
                     gap_str: int, gap_end: int, gp: GapParms) -> None:
    """g_create_anchors_ (src/gap_util.cpp:1596)."""
    mask = (1 << (2 * shape_len + 33)) - 1
    # std::sort asc by (a & mask) (src/gap_util.cpp:1608)
    arr = np.fromiter(g_hs, dtype=np.uint64, count=len(g_hs))
    perm = CXS.std_sort_perm((arr & np.uint64(mask)).astype(np.int64), desc=False)
    g_hs[:] = arr[perm].tolist()
    triples = _group_triples(g_hs, mask)
    _set_anchors_batch(g_hs, g_anchor, triples, rvcp_const,
                       anchor_lower, anchor_upper, gap_str, gap_end, direction, gp)


def g_create_extend_anchors_pair(g_hs: List[int], anchors1: List[int], anchors2: List[int],
                                 shape_len: int, rvcp_const: int,
                                 gap_str1: int, gap_end1: int, gap_str2: int, gap_end2: int,
                                 gp: GapParms) -> None:
    """g_CreateExtendAnchorsPair_ (src/gap_util.cpp:1628)."""
    mask = (1 << (2 * shape_len + 33)) - 1
    # std::sort asc by (a & mask) (src/gap_util.cpp:1640)
    arr = np.fromiter(g_hs, dtype=np.uint64, count=len(g_hs))
    perm = CXS.std_sort_perm((arr & np.uint64(mask)).astype(np.int64), desc=False)
    g_hs[:] = arr[perm].tolist()
    triples = _group_triples(g_hs, mask)
    _set_anchors_batch(g_hs, anchors1, triples, rvcp_const, 0, 0, gap_str1, gap_end1, 1, gp)
    _set_anchors_batch(g_hs, anchors2, triples, rvcp_const, 0, 0, gap_str2, gap_end2, -1, gp)


def c_create_anchors2(g_hs: List[int], g_anchors: List[int], g_hs_end: int,
                      anchor_lower: int, anchor_upper: int) -> None:
    """c_createAnchors2 (src/gap_util.cpp:1818)."""
    g_hs.sort()
    p1 = p2 = 0
    for k in range(1, g_hs_end):
        xt = g_hs_xt(g_hs[k] ^ g_hs[k - 1])
        if xt == 0:
            pass
        elif xt == 1:
            p2 = k
        else:
            for i in range(p1, p2):
                x = g_hs_cord(g_hs[i])
                for j in range(p2, k):
                    y = g_hs_cord(g_hs[j])
                    if anchor_lower <= x - y < anchor_upper:
                        g_anchors.append(c_2anchor(g_hs[i], g_hs[j]))
            p1 = k
            p2 = k


# ------------------------------------------------------------ gap scores


def get_gap_anchors_chain_score(a1: int, a2: int, parms) -> int:
    """getGapAnchorsChainScore (src/gap_util.cpp:966)."""
    dy = ganchor_y(a1) - ganchor_y(a2)
    dx = ganchor_x(a1) - ganchor_x(a2)
    if dy < 0 or ganchor_strand(a1 ^ a2) or (abs(dx) < 8 and dx != dy):
        return -10000
    thd_min_dy = 50
    da = abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1))
    derr = tdiv(100 * da, max(dy, thd_min_dy))
    if derr < 10:
        score_derr = 0
    elif derr < 15:
        score_derr = 10 + 2 * derr
    else:
        score_derr = tdiv(derr * derr, 10) + 40
    if dy < 100:
        score_dy = tdiv(dy, 4)
    elif dy < 200:
        score_dy = tdiv(dy, 3) - 9
    else:
        score_dy = dy - 145
    return 100 - score_dy - score_derr


def get_gap_anchors_chain_score2(a1: int, a2: int, parms) -> int:
    """getGapAnchorsChainScore2 (src/gap_util.cpp:1013)."""
    dy = ganchor_y(a1) - ganchor_y(a2)
    dx = ganchor_x(a1) - ganchor_x(a2)
    if dy < 0 or ganchor_strand(a1 ^ a2) or ((abs(dx) < 8 or abs(dy) < 8) and dx != dy):
        return -10000
    thd_min_dy = 50
    da = abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1))
    derr = tdiv(100 * da, max(dx, dy, thd_min_dy))
    if derr < 5:
        score_derr = 4 * derr
    elif derr < 10:
        score_derr = 6 * derr - 10
    else:
        score_derr = derr * derr - 5 * derr
    score_dy = tdiv(dy * (dy + 300), 300)
    return 100 - score_dy - score_derr


def get_gap_blocks_chain_score2(c11: int, c12: int, c21: int, c22: int, read_len: int, parms) -> int:
    """getGapBlocksChainScore2 (src/gap_util.cpp:1049)."""
    f_type, dx, dy = CH.get_chain_block_dxdy(c11, c12, c21, c22, read_len, parms.chn_block_strand)
    thd_dup_trigger = -50
    dx_, dy_ = abs(dx), abs(dy)
    da = dx - dy
    if dx < -40 or dy < -40:
        return INT_MIN
    score_dy = tdiv(dy_, 4) - 25 if dy_ > 300 else tdiv(dy_, 6)
    score_dx = tdiv(dx_, 4) - 25 if dx_ > 300 else tdiv(dx_, 6)
    if f_type == 1:
        return 80 - score_dy
    if da < -max(tdiv(dx_, 4), 50):
        if dx > thd_dup_trigger:
            return 80 - score_dx
        return 40 - score_dy
    if da > max(tdiv(dy, 4), 50):
        return 80 - score_dy
    return 100 - score_dy


def get_gap_blocks_chain_score3(c11: int, c12: int, c21: int, c22: int, read_len: int, parms) -> int:
    """getGapBlocksChainScore3 (src/gap_util.cpp:1107)."""
    f_type, dx, dy = CH.get_chain_block_dxdy(c11, c12, c21, c22, read_len, parms.chn_block_strand)
    dx_, dy_ = abs(dx), abs(dy)
    da = dx - dy
    if dx < 0 or dy < 0:
        return INT_MIN
    score_dy = tdiv(dy_, 4) - 25 if dy_ > 300 else tdiv(dy_, 6)
    if f_type == 1:
        return 20 - score_dy
    da_ratio = tdiv(100 * abs(da), max(dx_, dy_, 100))
    if da < 15:
        score_da = tdiv(da_ratio * (da_ratio + 20), 40)
    elif 15 <= da < 30:
        score_da = tdiv(da_ratio * (da_ratio + 50), 45)
    else:
        score_da = tdiv(da_ratio * (da_ratio + 100), 45)
    max_dxy = max(dx_, dy_)
    score_dist = tdiv(max_dxy * (max_dxy + 450), 2000)
    return 100 - score_da - score_dist


# numpy (vectorized-edge) twins of the anchor chain scores; used by
# chain_anchors_base(vec_score=...) to precompute DP edges in one pass

def ganchor_x_vec(a: np.ndarray) -> np.ndarray:
    return ((a >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK3) - G_HS_ANCHOR_ZERO + (a & G_HS_ANCHOR_MASK1)


def get_gap_anchors_chain_score_vec(a1, a2, parms):
    """Vectorized getGapAnchorsChainScore (src/gap_util.cpp:966)."""
    y1 = a1 & G_HS_ANCHOR_MASK1
    y2 = a2 & G_HS_ANCHOR_MASK1
    dy = y1 - y2
    dx = ganchor_x_vec(a1) - ganchor_x_vec(a2)
    bad = (dy < 0) | ((((a1 ^ a2) >> G_HS_ANCHOR_BIT2) & 1) != 0) \
        | ((np.abs(dx) < 8) & (dx != dy))
    sa1 = ((a1 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    sa2 = ((a2 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    da = np.abs(sa2 - sa1)
    derr = CH.tdiv_vec(100 * da, np.maximum(dy, 50))
    score_derr = np.where(derr < 10, 0,
                          np.where(derr < 15, 10 + 2 * derr,
                                   CH.tdiv_vec(derr * derr, 10) + 40))
    score_dy = np.where(dy < 100, CH.tdiv_vec(dy, 4),
                        np.where(dy < 200, CH.tdiv_vec(dy, 3) - 9, dy - 145))
    return np.where(bad, -10000, 100 - score_dy - score_derr)


def get_gap_anchors_chain_score2_vec(a1, a2, parms):
    """Vectorized getGapAnchorsChainScore2 (src/gap_util.cpp:1013)."""
    dy = (a1 & G_HS_ANCHOR_MASK1) - (a2 & G_HS_ANCHOR_MASK1)
    dx = ganchor_x_vec(a1) - ganchor_x_vec(a2)
    bad = (dy < 0) | ((((a1 ^ a2) >> G_HS_ANCHOR_BIT2) & 1) != 0) \
        | (((np.abs(dx) < 8) | (np.abs(dy) < 8)) & (dx != dy))
    sa1 = ((a1 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    sa2 = ((a2 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    da = np.abs(sa2 - sa1)
    derr = CH.tdiv_vec(100 * da, np.maximum(np.maximum(dx, dy), 50))
    score_derr = np.where(derr < 5, 4 * derr,
                          np.where(derr < 10, 6 * derr - 10, derr * derr - 5 * derr))
    score_dy = CH.tdiv_vec(dy * (dy + 300), 300)
    return np.where(bad, -10000, 100 - score_dy - score_derr)


def get_extend_clip_score_vec(a1, a2, parms):
    """Vectorized getExtendClipScore (src/gap_util.cpp:2126)."""
    dy = (a1 & G_HS_ANCHOR_MASK1) - (a2 & G_HS_ANCHOR_MASK1)
    dx = ganchor_x_vec(a1) - ganchor_x_vec(a2)
    bad = (dy <= 0) | ((((a1 ^ a2) >> G_HS_ANCHOR_BIT2) & 1) != 0) \
        | (((np.abs(dx) < 3) | (np.abs(dy) < 3)) & (dx != dy))
    sa1 = ((a1 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    sa2 = ((a2 >> G_HS_ANCHOR_BIT1) & G_HS_ANCHOR_MASK5) - G_HS_ANCHOR_ZERO
    da = np.abs(sa2 - sa1)
    score_da = np.where(da < 2, 30 + 5 * da,
                        np.where(da < 5, 36 + 2 * da, 41 + da))
    score_dy = CH.tdiv_vec(dy * (12 * dy + 650), 450)
    return np.where(bad, -10000, 100 - score_dy - score_da)


_SCORE_VECS = {}


def _score_vec_for(fn):
    """numpy twin of a scalar anchor score function (None if not known)."""
    if not _SCORE_VECS:
        _SCORE_VECS.update({
            get_gap_anchors_chain_score: get_gap_anchors_chain_score_vec,
            get_gap_anchors_chain_score2: get_gap_anchors_chain_score2_vec,
            get_extend_clip_score: get_extend_clip_score_vec,
        })
    return _SCORE_VECS.get(fn)


def get_extend_clip_score(a1: int, a2: int, parms) -> int:
    """getExtendClipScore (src/gap_util.cpp:2126)."""
    dy = ganchor_y(a1) - ganchor_y(a2)
    dx = ganchor_x(a1) - ganchor_x(a2)
    if dy <= 0 or ganchor_strand(a1 ^ a2) or ((abs(dx) < 3 or abs(dy) < 3) and dx != dy):
        return -10000
    da = abs(ganchor_str_anchor(a2) - ganchor_str_anchor(a1))
    if da < 2:
        score_da = 30 + 5 * da
    elif da < 5:
        score_da = 36 + 2 * da
    else:
        score_da = 41 + da
    score_dy = tdiv(dy * (12 * dy + 650), 450)
    return 100 - score_dy - score_da


# ---------------------------------------------------------- chain helpers


def drop_chain_gap_x(chains: List[int], get_x: Callable, get_y: Callable,
                     direction: int, f_erase: bool, gp: GapParms) -> int:
    """dropChainGapX (src/gap_util.cpp:757)."""
    if direction == G_MAP_RGHT:
        for i in range(1, len(chains)):
            di = gp.thd_dcgx_window_size if i + 1 >= gp.thd_dcgx_window_size else 1
            if i + 1 - di < 0 or i >= len(chains):
                continue
            if (
                get_x(chains[i]) - get_x(chains[i - 1]) > gp.thd_dcgx_Xdrop_peak
                or get_x(chains[i]) - get_x(chains[i + 1 - di]) > gp.thd_dcgx_Xdrop_sum
                or get_y(chains[i]) - get_y(chains[i - 1]) > gp.thd_dcgx_Xdrop_peak
                or get_y(chains[i]) - get_y(chains[i + 1 - di]) > gp.thd_dcgx_Xdrop_sum
            ):
                if f_erase:
                    del chains[i:]
                    return len(chains)
                return i
        return len(chains)
    if direction == G_MAP_LEFT:
        for i in range(len(chains) - 2, 0, -1):
            di = gp.thd_dcgx_window_size if len(chains) - i >= gp.thd_dcgx_window_size else 1
            if (
                get_x(chains[i + 1]) - get_x(chains[i]) > gp.thd_dcgx_Xdrop_peak
                or get_x(chains[i + di - 1]) - get_x(chains[i]) > gp.thd_dcgx_Xdrop_sum
                or get_y(chains[i + 1]) - get_y(chains[i]) > gp.thd_dcgx_Xdrop_peak
                or get_y(chains[i + di - 1]) - get_y(chains[i]) > gp.thd_dcgx_Xdrop_sum
            ):
                if f_erase:
                    del chains[: i + 1]
                    return 0
                return i
        return 0
    return 0


def accumulate_simple_gap_score1(chain: List[int], shape_len: int, get_x: Callable, gp: GapParms) -> List[int]:
    """accumulateSimpleGapScore1 (src/gap_util.cpp:2169)."""
    if not chain:
        return []
    scores = [0] * len(chain)
    pre_x = get_x(chain[0])
    for i in range(1, len(chain)):
        x_i = get_x(chain[i])
        # C++: int new_gap = int(x_i - pre_x) > shape_len ? ... (uint64 diff
        # truncated to int32 in the comparison, int32 accumulation wrap)
        d32 = _i32((x_i - pre_x) & M64)
        new_gap = _i32((x_i - pre_x - shape_len) & M64) if d32 > shape_len else 0
        scores[i] = _i32(scores[i - 1] + _i32(new_gap * gp.int_precision))
        pre_x = x_i
    return scores


def clip_chain_(chain: List[int], gsx: List[int], gsy: List[int], direction: int,
                f_clip: bool, gp: GapParms) -> int:
    """clipChain_ (src/gap_util.cpp:2191)."""
    if not chain:
        return -1
    clip_i = -1 if direction <= 0 else len(chain) - 1
    w = gp.thd_ccps_window_size
    max_d_clip = INT_MIN
    f_found = 0
    for i in range(1, len(chain) - 1):
        i_str = max(i - w, 0)
        i_end = min(i + w, len(chain) - 1)
        d1 = i - i_str
        d2 = i_end - i
        cx1 = tdiv(_i32(gsx[i] - gsx[i_str]), d1)
        cx2 = tdiv(_i32(gsx[i_end] - gsx[i]), d2)
        cy1 = tdiv(_i32(gsy[i] - gsy[i_str]), d1)
        cy2 = tdiv(_i32(gsy[i_end] - gsy[i]), d2)
        if direction <= 0:
            cx1, cx2 = cx2, cx1
            cy1, cy2 = cy2, cy1
        d_clip = _i32(cx2 - cx1 + cy2 - cy1)
        if (
            d_clip > max_d_clip
            and cx1 < gp.thd_ccps_clip1_upper and cy1 < gp.thd_ccps_clip1_upper
            and (cx2 > gp.thd_ccps_clip2_lower or cy2 > gp.thd_ccps_clip2_lower)
        ):
            max_d_clip = d_clip
            clip_i = i
            f_found = 1
    if f_clip and f_found:
        if direction <= 0:
            del chain[: clip_i + 1]
        else:
            del chain[clip_i + 1:]
    return clip_i + 1


def clip_chain(chain: List[int], shape_len: int, direction: int, f_clip: bool,
               get_x: Callable, get_y: Callable, gp: GapParms) -> int:
    """clipChain (src/gap_util.cpp:2252)."""
    gp.clip_chain_parms(shape_len, gp.thd_err)
    gsx = accumulate_simple_gap_score1(chain, shape_len, get_x, gp)
    gsy = accumulate_simple_gap_score1(chain, shape_len, get_y, gp)
    return clip_chain_(chain, gsx, gsy, direction, f_clip, gp)


def stick_main_chain(chain1: List[int], chain2: List[int],
                     get_x1: Callable, get_y1: Callable,
                     get_x2: Callable, get_y2: Callable, gp: GapParms) -> None:
    """stickMainChain (src/gap_util.cpp:2276)."""
    if not chain1 or not chain2:
        return
    di = 0
    jj = len(chain2) - 1
    x2 = get_x2(chain2[jj])
    for i in range(len(chain1)):
        x1 = get_x1(chain1[i])
        if x1 < x2:
            for j in range(jj - 1, -1, -1):
                x2 = get_x2(chain2[j])
                if x1 >= x2:
                    jj = j
                    break
        if x1 < x2:
            jj = 0
        anchor1 = x1 - get_y1(chain1[i])
        anchor2 = get_x2(chain2[jj]) - get_y2(chain2[jj])
        if anchor1 >= anchor2 + gp.thd_smcn_danchor or anchor1 < anchor2 - gp.thd_smcn_danchor:
            di += 1
        else:
            chain1[i - di] = chain1[i]
    del chain1[len(chain1) - di:]


# ---------------------------------------------------------- tiles scoring


def get_tile_f(tile: int, f1: List[PMP.Feats], f2: List[PMP.Feats]) -> int:
    """_get_tile_f_ (src/gap_util.cpp:805)."""
    n1 = tile_strand(tile)
    n2 = cid(tile)
    if n1 < len(f1) and n2 < len(f2):
        return PMP.window_dist_c(f1[n1], f2[n2], tile_y(tile) >> 4, tile_x(tile) >> 4)
    return (1 << 32) - 1


def get_tile_f_tri(new_tile: int, f1, f2, lower_x: int, lower_y: int,
                   upper_x: int, upper_y: int, thd_tile_size: int) -> Tuple[int, int]:
    """_get_tile_f_tri_ (src/gap_util.cpp:870). Returns (tile, min_score)."""
    x = tile_x(new_tile)
    y = tile_y(new_tile)
    sh = min(thd_tile_size // 4, x - lower_x, y - lower_y)
    f1s = get_tile_f(new_tile, f1, f2)
    min_score = f1s
    tile_l = shift_tile(new_tile, -sh, -sh)
    f2s = get_tile_f(tile_l, f1, f2)
    if f2s < f1s:
        new_tile = tile_l
        min_score = f2s
    sh = min(thd_tile_size // 4, upper_x - x - 1, upper_y - y - 1)
    tile_r = shift_tile(new_tile, sh, sh)
    f3s = get_tile_f(tile_r, f1, f2)
    if f3s < min_score:
        new_tile = tile_r
        min_score = f3s
    return new_tile, min_score


# ---------------------------------------------------- chains from anchors


def chain_tiles(tiles: List[int], read_len: int, thd_gather_block_gap_size: int, gp: GapParms) -> None:
    """chainTiles (src/gap_util.cpp:1177)."""
    _, str_ends_p = PMP.gather_blocks(
        tiles, 0, len(tiles), read_len, thd_gather_block_gap_size, 0, False,
        is_end_func=is_tile_end, set_end_func=set_tile_end,
    )
    parms = CH.ChainScoreParms()
    new = CH.chain_blocks_cords(
        np.array(tiles, dtype=np.uint64), str_ends_p,
        lambda c11, c12, c21, c22, rl, p: gp.chn_score2.get_score2(c11, c12, c21, c22, rl, p),
        parms,
        min_len=gp.chn_score2.thd_min_chain_len,
        abort_score=gp.chn_score2.thd_abort_score,
        read_len=read_len, thd_init_cord_score=64,
        thd_major_limit=gp.thd_cts_major_limit, f_header=False,
        unset_end_func=remove_tile_sgn_end, set_end_func=set_tile_end,
    )
    tiles[:] = [int(t) for t in new]


def g_create_chains_from_anchors(anchors: List[int], tiles: List[int],
                                 gap_str: int, gap_end: int, read_len: int, gp: GapParms) -> None:
    """g_CreateChainsFromAnchors_ (src/gap_util.cpp:1191)."""
    thd_anchor_gap_size = 100
    # std::sort desc by g_hs_anchor_getX (src/gap_util.cpp:1201)
    arr = np.fromiter(anchors, dtype=np.int64, count=len(anchors))
    perm = CXS.std_sort_perm(ganchor_x_vec(arr), desc=True)
    anchors[:] = arr[perm].tolist()
    chains, _ = CH.chain_anchors_base(
        np.array(anchors, dtype=np.uint64), 0, len(anchors),
        thd_chain_depth=20, thd_chain_dx_depth=80, thd_best_n=20, stop_ratio=0.7,
        min_len=gp.chn_score1.thd_min_chain_len, abort_score=gp.chn_score1.thd_abort_score,
        get_score=lambda a1, a2, p: gp.chn_score1.get_score(a1, a2, p),
        parms=CH.ChainScoreParms(), get_anchor_x=ganchor_x,
        vec_score=_score_vec_for(gp.chn_score1.get_score), vec_anchor_x=ganchor_x_vec,
    )
    tiles.clear()
    for chain in chains:
        for a in chain:
            tiles.append(ganchor2tile(int(a)))
        tiles[-1] = set_tile_end(tiles[-1])
    chain_tiles(tiles, read_len, thd_anchor_gap_size, gp)


def get_closest_extension_chain(tmp_tiles: List[int], gap_str: int, gap_end: int,
                                f_erase: bool, gp: GapParms) -> Tuple[int, int]:
    """getClosestExtensionChain_ (src/gap_util.cpp:1227)."""
    pre_i = 0
    for i in range(len(tmp_tiles)):
        if is_tile_end(tmp_tiles[i]):
            danchor = dx = dy = 0
            if gp.direction < 0:
                dy = tile_y(gap_end) - tile_y(tmp_tiles[i])
                dx = tile_x(gap_end) - tile_x(tmp_tiles[i])
                danchor = dx - dy
            elif gp.direction > 0:
                dy = tile_y(tmp_tiles[pre_i]) - tile_y(gap_str)
                dx = tile_x(tmp_tiles[pre_i]) - tile_x(gap_str)
                danchor = dx - dy
            if (abs(danchor) < gp.thd_ctfas2_connect_danchor
                    and max(abs(dy), abs(dx)) < gp.thd_ctfas2_connect_dy_dx):
                if f_erase:
                    del tmp_tiles[i + 1:]
                    del tmp_tiles[:pre_i]
                    return (0, len(tmp_tiles))
                return (pre_i, i + 1)
            pre_i = i + 1
    if f_erase:
        tmp_tiles.clear()
    return (0, 0)


def g_create_tiles_from_chains1(chains: List[int], tiles: List[int],
                                f1, f2, gap_str: int, gap_end: int,
                                it_str: int, it_end: int,
                                get_x: Callable, get_y: Callable, get_strand: Callable,
                                gp: GapParms) -> None:
    """g_CreateTilesFromChains_ single-output (src/gap_util.cpp:1275)."""
    if it_end - it_str == 0:
        return
    pre_chain = chains[it_str]
    pre_tile = 0
    tmp_shift = gp.thd_tile_size // 2
    step = gp.thd_tile_size // 3
    kcount = 0
    scan_str = it_str
    scan_end = it_str
    for i in range(it_str, it_end + 1):
        if (i == it_end or get_strand(chains[i] ^ pre_chain)
                or get_x(chains[i]) > get_x(pre_chain) + step
                or get_y(chains[i]) > get_y(pre_chain) + step):
            if i == it_end:
                scan_end = it_end
            for j in range(scan_end - 1, scan_str - 1, -1):
                new_tile = create_tile(cid(gap_str), get_x(chains[j]) - tmp_shift,
                                       get_y(chains[j]) - tmp_shift, get_strand(chains[j]))
                lower_tile = gap_str if not tiles else tiles[-1]
                upper_tile = gap_end
                new_tile, score = get_tile_f_tri(
                    new_tile, f1, f2, get_x(lower_tile), get_y(lower_tile),
                    get_x(upper_tile), get_y(upper_tile), gp.thd_tile_size,
                )
                if (kcount >= gp.thd_ctfcs_pattern_in_window and score <= 32
                        and tile_y(new_tile) > tile_y(pre_tile)):
                    if not tiles or is_tile_end(tiles[-1]):
                        new_tile = set_tile_start(new_tile)
                    tiles.append(new_tile)
                    pre_tile = new_tile
                    kcount = i - j
                    pre_chain = chains[j]
                    break
            scan_str = i
            scan_end = i + 1
        else:
            scan_end += 1
            kcount += 1
    if tiles:
        tiles[-1] = set_tile_end(tiles[-1])


def g_create_tiles_from_chains2(chains: List[int], tiles_str: List[int], tiles_end: List[int],
                                f1, f2, gap_str: int, gap_end: int,
                                it_str: int, it_end: int,
                                get_x: Callable, get_y: Callable, get_strand: Callable,
                                gp: GapParms) -> None:
    """g_CreateTilesFromChains_ two-output (src/gap_util.cpp:1364)."""
    tmp_str: List[int] = []
    tmp_end: List[int] = []
    g_create_tiles_from_chains1(chains, tmp_str, f1, f2, gap_str, gap_end,
                                it_str, it_end, get_x, get_y, get_strand, gp)
    if not tmp_str:
        return
    tile_size = gp.thd_tile_size
    for i in range(len(tmp_str)):
        dx1 = get_x(chains[it_str]) - tile_x(tmp_str[i])
        dy1 = get_y(chains[it_str]) - tile_y(tmp_str[i])
        if dx1 <= 0 and dy1 <= 0:
            if dx1 == 0 and dy1 == 0:
                break
            new_head = remove_tile_sgn(create_tile(
                cid(gap_str), get_x(chains[it_str]), get_y(chains[it_str]), get_strand(chains[it_str])))
            if i == 0:
                tmp_str.insert(0, new_head)
            else:
                tmp_str[i - 1] = new_head
                del tmp_str[: i - 1]
            break
        if i == len(tmp_str) - 1:
            tmp_str.clear()
            tmp_str.append(create_tile(cid(gap_str), get_x(chains[it_str]),
                                       get_y(chains[it_str]), get_strand(chains[it_str])))
    tmp_end = [shift_tile(t, tile_size, tile_size) for t in tmp_str]
    for i in range(len(tmp_end) - 1, -1, -1):
        dx1 = get_x(chains[it_end - 1]) - tile_x(tmp_end[i])
        dy1 = get_y(chains[it_end - 1]) - tile_y(tmp_end[i])
        if dx1 >= 0 and dy1 >= 0:
            if dx1 == 0 and dy1 == 0:
                break
            del tmp_str[i + 1:]
            del tmp_end[i + 1:]
            new_tail_end = create_tile(cid(gap_str), get_x(chains[it_end - 1]),
                                       get_y(chains[it_end - 1]), get_strand(chains[it_end - 1]))
            new_tail_str = shift_tile(new_tail_end, -tile_size, -tile_size)
            if is_tile_end(tmp_str[i]):
                tmp_str[i] = remove_tile_sgn(tmp_str[i])
                tmp_end[i] = remove_tile_sgn(tmp_end[i])
                new_tail_str = set_tile_end(new_tail_str)
                new_tail_end = set_tile_end(new_tail_end)
            tmp_str.append(new_tail_str)
            tmp_end.append(new_tail_end)
            break
        if i == 0:
            del tmp_str[1:]
            del tmp_end[1:]
            tmp_end[0] = shift_tile(tmp_end[0], dx1, dy1)
    tiles_str.extend(tmp_str)
    tiles_end.extend(tmp_end)


def trim_tiles(tiles: List[int], f1, f2, gap_str: int, gap_end: int,
               revscomp_const: int, direction: int, gp: GapParms) -> None:
    """trimTiles (src/gap_util.cpp:1498)."""
    thd_gap_size = gp.thd_tts_gap_size
    thd_tile_size = gp.thd_tile_size
    thd_overlap_size = gp.thd_tts_overlap_size
    cord_str = gap_str
    shift_x = min(cx(gap_end) - cx(gap_str), thd_tile_size)
    shift_y = min(cy(gap_end) - cy(gap_str), thd_tile_size)
    cord_end = shift(gap_end, -shift_x, -shift_y)
    i = 0
    while i < len(tiles):
        if is_tile_start(tiles[i]) and direction >= 0:
            new_num = extend_patch(f1, f2, tiles, i, cord_str, tiles[i],
                                   revscomp_const, thd_overlap_size, thd_gap_size, gp.thd_accept_score)
            if new_num:
                tiles[i] = set_tile_start(tiles[i])
                i += new_num
                tiles[i] = remove_tile_sgn_start(tiles[i])
        if is_tile_end(tiles[i]) and direction <= 0:
            new_num = extend_patch(f1, f2, tiles, i + 1, tiles[i], cord_end,
                                   revscomp_const, thd_overlap_size, thd_gap_size, gp.thd_accept_score)
            if new_num:
                tiles[i] = remove_tile_sgn_end(tiles[i])
                i += new_num
                tiles[i] = set_tile_end(tiles[i])
        if i >= 1 and not is_tile_end(tiles[i - 1]) and not is_tile_start(tiles[i]):
            i += extend_patch(f1, f2, tiles, i, tiles[i - 1], tiles[i],
                              revscomp_const, thd_overlap_size, thd_gap_size, gp.thd_accept_score)
        i += 1
    x_str = tile_x(gap_str)
    y_str = tile_y(gap_str)
    x_end = cx(gap_end)
    y_end = cy(gap_end)
    di = 0
    for i in range(len(tiles)):
        x_t = tile_x(tiles[i])
        y_t = (revscomp_const - 1 - tile_y(tiles[i]) - thd_tile_size
               if tile_strand(tiles[i] ^ gap_str) else tile_y(tiles[i]))
        if x_t < x_str or x_t + thd_tile_size > x_end or y_t < y_str or y_t + thd_tile_size > y_end:
            if is_tile_start(tiles[i]) and is_tile_end(tiles[i]):
                pass
            elif is_tile_start(tiles[i]):
                if i + 1 < len(tiles):
                    tiles[i + 1] = set_tile_start(tiles[i + 1])
            elif is_tile_end(tiles[i]):
                if i - di - 1 > 0:
                    tiles[i - di - 1] = set_tile_end(tiles[i - di - 1])
            di += 1
        else:
            tiles[i - di] = tiles[i]
    if di:
        del tiles[len(tiles) - di:]


def extend_patch(f1, f2, cords: List[int], kk: int, cord1: int, cord2: int,
                 revscomp_const: int, overlap_size: int, gap_size: int,
                 thd_accept_score: int) -> int:
    """extendPatch (src/pmpfinder.cpp:2881): window-extend between cord1 and
    cord2, inserting new cords at position kk. Returns number inserted."""
    score = 0.0
    # isOverlap (src/pmpfinder.cpp:2839)
    s1, s2 = cord_strand(cord1), cord_strand(cord2)
    if (abs(cxid(cord1) - cxid(cord2)) < overlap_size
            and abs(cy(cord1) - cy(cord2)) < overlap_size and not (s1 ^ s2)):
        return 0
    pcord = cord1
    scord = cord2
    strand1 = cord_strand(pcord)
    strand2 = cord_strand(scord)
    gid1 = cid(pcord)
    gid2 = cid(scord)
    ln = 0
    cord = pcord
    tmp: List[int] = []
    x_bound = cx(scord)
    y_bound = cy(scord)
    while cxid(cord) + gap_size <= cxid(scord):  # isPreGap
        cord, d = PMP.next_window_eval(f1[strand1], f2[gid1], cord)
        score += d
        if cord and cy(cord) < y_bound and cx(cord) < x_bound and score < thd_accept_score:
            tmp.append(cord)
        else:
            break
    nw = pcord
    if tmp:
        ln += len(tmp)
        nw = tmp[-1]
        cords[kk:kk] = tmp
        x_bound = cx(tmp[-1])
        y_bound = cy(tmp[-1])
        tmp = []
    else:
        x_bound = cx(pcord)
        y_bound = cy(pcord)
    cord = scord
    while cxid(nw) + gap_size <= cxid(cord):  # isSucGap
        cord, d = PMP.previous_window_eval(f1[strand2], f2[gid2], cord)
        score += d
        if cord and cy(cord) > y_bound and cx(cord) > x_bound and score < thd_accept_score:
            tmp.append(cord)
        else:
            break
    if tmp:
        tmp.reverse()
        cords[kk + ln: kk + ln] = tmp
        ln += len(tmp)
    return ln


# --------------------------------------------------------- along-chain map


def map_along_chain(seq1: np.ndarray, seq2: np.ndarray, chains: List[int], tiles: List[int],
                    i_str: int, i_end: int, shape_len: int, step1: int, step2: int,
                    get_x: Callable, get_y: Callable, get_strand: Callable,
                    set_strand: Callable, chain2tile: Callable, gp: GapParms) -> None:
    """mapAlongChain (src/gap_util.cpp:3320)."""
    if not chains or i_str < 0 or i_end > len(chains) or i_end <= i_str:
        return
    hs: List[int] = []
    anchors: List[int] = []
    anchor_str = get_x(chains[i_str]) - get_y(chains[i_str])
    anchor_end = get_x(chains[i_end - 1]) - get_y(chains[i_end - 1])
    c_stream(seq1, hs, get_x(chains[i_str]), get_x(chains[i_end - 1]), step1, shape_len, 0)
    c_stream(seq2, hs, get_y(chains[i_str]), get_y(chains[i_end - 1]), step2, shape_len, 1)
    c_create_anchors2(hs, anchors, len(hs), min(anchor_str, anchor_end) - 30,
                      max(anchor_str, anchor_end) + 30)
    # std::sort desc by g_hs_anchor_getX (src/gap_util.cpp:3349)
    arr = np.fromiter(anchors, dtype=np.int64, count=len(anchors))
    perm = CXS.std_sort_perm(ganchor_x_vec(arr), desc=True)
    anchors[:] = arr[perm].tolist()
    stick_main_chain(anchors, chains, ganchor_x, ganchor_y, get_x, get_y, gp)
    chains_out, _ = CH.chain_anchors_base(
        np.array(anchors, dtype=np.uint64), 0, len(anchors),
        thd_chain_depth=15, thd_chain_dx_depth=30, thd_best_n=1, stop_ratio=0.7,
        min_len=gp.chn_ext_clip_metric1.thd_min_chain_len,
        abort_score=gp.chn_ext_clip_metric1.thd_abort_score,
        get_score=lambda a1, a2, p: gp.chn_ext_clip_metric1.get_score(a1, a2, p),
        parms=CH.ChainScoreParms(), get_anchor_x=ganchor_x,
        vec_score=_score_vec_for(gp.chn_ext_clip_metric1.get_score),
        vec_anchor_x=ganchor_x_vec,
    )
    if chains_out:
        f_strand = get_strand(chains[0])
        for a in chains_out[0]:
            new_tile = chain2tile(int(a))
            if f_strand:
                new_tile = set_strand(new_tile)
            tiles.append(new_tile)


def remap_chain_one_end(ref: np.ndarray, read: np.ndarray, comstr: np.ndarray,
                        chain: List[int], shape_len: int, step1: int, step2: int,
                        remap_num: int, direction: int, gp: GapParms) -> None:
    """remapChainOneEnd (src/gap_util.cpp:3761) for tile chains."""
    if not direction or not chain:
        return
    seq2 = comstr if tile_strand(chain[0]) else read
    remap: List[int] = []
    if direction <= 0:
        i_str = max(0, len(chain) - remap_num)
        i_end = len(chain)
    else:
        i_str = 0
        i_end = min(len(chain), remap_num)
    map_along_chain(ref, seq2, chain, remap, i_str, i_end, shape_len, step1, step2,
                    tile_x, tile_y, tile_strand, set_tile_strand, ganchor2tile, gp)
    clip_chain(remap, shape_len, direction, True, tile_x, tile_y, gp)
    if direction <= 0:
        del chain[:i_end]
        if remap:
            chain[0:0] = remap
    else:
        if remap:
            del chain[i_str:]
            chain.extend(remap)


def re_extend_chain_one_side(ref: np.ndarray, read: np.ndarray, comstr: np.ndarray,
                             chain: List[int], i_ptr_str: int, i_ptr_end: int,
                             lower: int, upper: int, shape_len: int, step1: int, step2: int,
                             direction: int, gp: GapParms) -> int:
    """reExtendChainOneSide (src/gap_util.cpp:3832) for tile chains."""
    if not chain or i_ptr_str < 0 or i_ptr_end < 0:
        return 0
    ln = len(chain)
    reextend: List[int] = []
    if direction <= 0:
        d = -min(cx(chain[i_ptr_str]), tile_y(chain[i_ptr_str]), lower)
        ii = i_ptr_str
        while ii < i_ptr_end:
            if tile_x(chain[ii]) - cx(chain[i_ptr_str]) >= upper:
                break
            ii += 1
        reextend = [0] * (ii - i_ptr_str + 2)
        reextend[0] = shift_tile(chain[i_ptr_str], d, d)
        for i in range(ii - i_ptr_str + 1):
            reextend[i + 1] = chain[i_ptr_str + i]
        i_str = i_ptr_str
        i_end = ii + 1
    elif direction > 0:
        d = min(len(ref) - cx(chain[i_ptr_end]) - 1, len(read) - cy(chain[i_ptr_end]) - 1, upper)
        ii = i_ptr_end
        while ii > i_ptr_str:
            if tile_x(chain[i_ptr_end]) - tile_x(chain[ii]) >= lower:
                break
            ii -= 1
        reextend = [0] * (i_ptr_end - ii + 2)
        for i in range(i_ptr_end - ii + 1):
            reextend[i] = chain[ii + i]
        reextend[-1] = shift_tile(chain[i_ptr_end], d, d)
        i_str = ii
        i_end = i_ptr_end + 1
    else:
        return 0
    remap_chain_one_end(ref, read, comstr, reextend, shape_len, step1, step2,
                        len(reextend), direction, gp)
    chain[i_str:i_end] = reextend
    return len(chain) - ln


def re_extend_clip_one_side(ref, read, comstr, chain: List[int],
                            extend_lower_cord: int, extend_upper_cord: int,
                            i_ptr_str: int, i_ptr_end: int, direction: int, gp: GapParms) -> int:
    """reExtendClipOneSide (src/gap_util.cpp:4129)."""
    if not chain or i_ptr_str < 0 or i_ptr_end < 0:
        return 0
    lower, upper = 60, 60
    shape_len = gp.thd_etfas_shape_len
    step1 = gp.thd_etfas_step1
    step2 = gp.thd_etfas_step2
    if direction <= 0:
        dx = tile_x(chain[i_ptr_str]) - tile_x(extend_lower_cord)
        dy = (tile_y(extend_upper_cord) - len(read) + tile_y(chain[i_ptr_str])
              if tile_strand(chain[i_ptr_str]) ^ tile_strand(extend_lower_cord)
              else tile_y(chain[i_ptr_str]) - tile_y(extend_lower_cord))
        lower = min(dx, dy, lower)
    elif direction > 0:
        dx = tile_x(extend_upper_cord) - 1 - tile_x(chain[i_ptr_end])
        dy = (len(read) - 1 - tile_y(chain[i_ptr_end]) - tile_y(extend_lower_cord)
              if tile_strand(chain[i_ptr_end]) ^ tile_strand(extend_upper_cord)
              else tile_y(extend_upper_cord) - tile_y(chain[i_ptr_end]))
        upper = min(dx, dy, upper)
    return re_extend_chain_one_side(ref, read, comstr, chain, i_ptr_str, i_ptr_end,
                                    lower, upper, shape_len, step1, step2, direction, gp)


# --------------------------------------------------- tiles from anchors


def create_tiles_from_anchors2(ref, read, comstr, anchors: List[int],
                               tiles_str: List[int], tiles_end: List[int],
                               f1, f2, gap_str: int, gap_end: int, read_len: int,
                               direction: int, gp: GapParms) -> None:
    """createTilesFromAnchors2_ (src/gap_util.cpp:4171)."""
    tmp_tiles: List[int] = []
    g_create_chains_from_anchors(anchors, tmp_tiles, gap_str, gap_end, read_len, gp)
    PMP._dbg("GCHN", tmp_tiles)
    pre_i = 0
    i = 0
    while i < len(tmp_tiles):
        if is_tile_end(tmp_tiles[i]):
            head_tile = tmp_tiles[pre_i]
            tail_tile = tmp_tiles[i]
            i += re_extend_clip_one_side(ref, read, comstr, tmp_tiles, gap_str, gap_end,
                                         pre_i, i, -1, gp)
            i += re_extend_clip_one_side(ref, read, comstr, tmp_tiles, gap_str, gap_end,
                                         pre_i, i, 1, gp)
            PMP._dbg("GREX", tmp_tiles)
            if not (not tmp_tiles or pre_i < 0 or i < 0):
                tmp_tiles[pre_i] = copy_tile_sgn(head_tile, tmp_tiles[pre_i])
                tmp_tiles[i] = copy_tile_sgn(tail_tile, tmp_tiles[i])
                PMP._dbg("GTFC", tiles_str)
                g_create_tiles_from_chains2(tmp_tiles, tiles_str, tiles_end, f1, f2,
                                            gap_str, gap_end, pre_i, i + 1,
                                            tile_x, tile_y, tile_strand, gp)
            pre_i = i + 1
        elif i < len(tmp_tiles) - 1 and tile_strand(tmp_tiles[i] ^ tmp_tiles[i + 1]):
            ln = len(tiles_str)
            head_tile = tmp_tiles[pre_i]
            tail_tile = tmp_tiles[i]
            i += re_extend_clip_one_side(ref, read, comstr, tmp_tiles, gap_str, gap_end,
                                         pre_i, i, -1, gp)
            i += re_extend_clip_one_side(ref, read, comstr, tmp_tiles, gap_str, gap_end,
                                         pre_i, i, 1, gp)
            if not (not tmp_tiles or pre_i < 0 or i < 0):
                tmp_tiles[pre_i] = copy_tile_sgn(head_tile, tmp_tiles[pre_i])
                tmp_tiles[i] = copy_tile_sgn(tail_tile, tmp_tiles[i])
                g_create_tiles_from_chains2(tmp_tiles, tiles_str, tiles_end, f1, f2,
                                            gap_str, gap_end, pre_i, i + 1,
                                            tile_x, tile_y, tile_strand, gp)
                if ln != len(tiles_str):
                    tiles_str[-1] = remove_tile_sgn_end(tiles_str[-1])
                    tiles_end[-1] = remove_tile_sgn_end(tiles_end[-1])
            pre_i = i + 1
        i += 1


def map_tiles_from_anchors(ref, read, comstr, anchors, tiles_str, tiles_end,
                           f1, f2, gap_str, gap_end, revscomp_const, direction, gp) -> None:
    """mapTilesFromAnchors (src/gap_util.cpp:4251)."""
    create_tiles_from_anchors2(ref, read, comstr, anchors, tiles_str, tiles_end,
                               f1, f2, gap_str, gap_end, revscomp_const, direction, gp)


# ----------------------------------------------------- gap anchor filters


def _create_gap_anchors_list(anchors: List[int], thd_anchor_accept_density: int,
                             thd_anchor_accept_min: int, thd_anchor_err_bit: int
                             ) -> List[Tuple[int, int]]:
    """_createGapAnchorsList (src/gap_util.cpp:4275)."""
    out: List[Tuple[int, int]] = []
    if len(anchors) <= 1:
        return out
    anchors[0] = 0
    # std::sort asc by g_hs_anchor_getStrAnchor (src/gap_util.cpp:4286).
    # getStrAnchor is uint64 arithmetic: the zeroed anchors[0] underflows to
    # 2^64 - 2^20 and sorts LAST; the comparison below wraps the same way.
    def sa(a: int) -> int:
        return (((a >> 20) & ((1 << 31) - 1)) - (1 << 20)) & M64

    # vectorized uint64 keys; XOR the sign bit = order-preserving int64 view
    arr = np.fromiter(anchors, dtype=np.uint64, count=len(anchors))
    sa_v = (((arr >> np.uint64(20)) & np.uint64((1 << 31) - 1)) - np.uint64(1 << 20))
    keys = (sa_v ^ np.uint64(1 << 63)).view(np.int64)
    perm = CXS.std_sort_perm(keys, desc=False)
    anchors[:] = arr[perm].tolist()
    ak2 = anchors[1]
    block_str = 1
    count_anchors = 0
    min_y = M64
    max_y = 0
    n = len(anchors)
    for i in range(1, n):
        anc_y = ganchor_y(anchors[i])
        dy2 = abs(anc_y - ganchor_y(ak2))
        f_continuous = ((sa(anchors[i]) - sa(ak2)) & M64) < (dy2 >> thd_anchor_err_bit)
        if f_continuous:
            if min_y > anc_y:
                min_y = anc_y
            if max_y < anc_y:
                max_y = anc_y
            ak2 = anchors[(block_str + i) >> 1]
            count_anchors += 1
        if not f_continuous or i == n - 1:
            thd_accept = max((((max_y - min_y) & M64) * thd_anchor_accept_density) >> 10,
                             thd_anchor_accept_min)
            if count_anchors > thd_accept:
                out.append((block_str, i))
            block_str = i
            ak2 = anchors[i]
            min_y = anc_y
            max_y = anc_y
            count_anchors = 1
    return out


def _filter_gap_anchors_list(anchors: List[int], anchors_list: List[Tuple[int, int]],
                             gp: GapParms) -> List[Tuple[int, int]]:
    """_filterGapAnchorsList (src/gap_util.cpp:4332)."""
    if not anchors_list:
        return anchors_list
    thd_fgal_median = 1.5
    thd_sig_median1 = 1.5
    thd_sig_median2 = 20
    thd_min_len1 = 1000
    thd_min_len2 = 10
    thd_max_len1 = 5
    thd_max_len2 = 2000
    # std::sort desc by range length (src/gap_util.cpp:4356)
    anchors_list[:] = CXS.std_sort(
        anchors_list, [p[1] - p[0] for p in anchors_list], desc=True)
    if len(anchors) > thd_min_len1 and len(anchors_list) > thd_min_len2:
        i_median = len(anchors_list) // 2
        l_median = anchors_list[i_median][1] - anchors_list[i_median][0]
        l_max = anchors_list[0][1] - anchors_list[0][0]
        if l_max > l_median * thd_sig_median1 and l_max > l_median + thd_sig_median2:
            it = 0
            break_value = int((anchors_list[i_median][1] - anchors_list[i_median][0]) * thd_fgal_median)
            l_s = 0
            for i in range(min(thd_max_len1, len(anchors_list))):
                it += 1
                l_i = anchors_list[i][1] - anchors_list[i][0]
                l_s += l_i
                if l_i < break_value or l_s > thd_max_len2:
                    break
            del anchors_list[it:]
        else:
            anchors_list.clear()
    return anchors_list


def filter_gap_anchors(anchors: List[int], gap_str: int, gap_end: int,
                       direction: int, gp: GapParms) -> None:
    """filterGapAnchors (src/gap_util.cpp:4416): args there are
    (shape_len=0, density=20, accept_min=20, err_bit=0)."""
    alist = _create_gap_anchors_list(anchors, 20, 20, 0)
    alist = _filter_gap_anchors_list(anchors, alist, gp)
    it = 0
    for lo, hi in alist:
        for j in range(lo, hi):
            anchors[it] = anchors[j]
            it += 1
    del anchors[it:]


# ------------------------------------------------ one-side / generic maps


def extend_tiles_one_side(ref, read, comstr, anchors: List[int], tiles: List[int],
                          f1, f2, gap_str: int, gap_end: int, read_len: int,
                          direction: int, gp: GapParms) -> None:
    """extendTilesOneSide (src/gap_util.cpp:3920)."""
    original_direction = gp.direction
    chain: List[int] = []
    gp.direction = direction
    PMP._dbg("ETAN", anchors)
    g_create_chains_from_anchors(anchors, chain, gap_str, gap_end, read_len, gp)
    get_closest_extension_chain(chain, gap_str, gap_end, True, gp)
    PMP._dbg("ETCH", chain)
    shape_len = gp.thd_etfas_shape_len
    step1 = gp.thd_etfas_step1
    step2 = gp.thd_etfas_step2
    remap_num = 50
    remap_chain_one_end(ref, read, comstr, chain, shape_len, step1, step2,
                        remap_num, direction, gp)
    PMP._dbg("ETRM", chain)
    g_create_tiles_from_chains1(chain, tiles, f1, f2, gap_str, gap_end, 0, len(chain),
                                tile_x, tile_y, tile_strand, gp)
    PMP._dbg("ETTL", tiles)
    trim_tiles(tiles, f1, f2, gap_str, gap_end, read_len - 1, direction, gp)
    PMP._dbg("ETTR", tiles)
    gp.direction = original_direction


def extend_interval_one_side(ref, read, comstr, tiles: List[int], f1, f2,
                             gap_str: int, gap_end: int, direction: int, gp: GapParms) -> int:
    """extendIntervalOneSide (src/gap_util.cpp:3953)."""
    if cord_strand(gap_str ^ gap_end):
        return 1
    original_direction = gp.direction
    shape_len = gp.thd_eis_shape_len
    step1 = gp.thd_eis_step1
    step2 = gp.thd_eis_step2
    gp.direction = direction
    g_hs: List[int] = []
    anchors: List[int] = []
    g_stream(ref, read, g_hs, gap_str, gap_end, shape_len, step1, step2)
    g_create_anchors(g_hs, anchors, shape_len, direction, 0, 0, len(read) - 1,
                     gap_str, gap_end, gp)
    extend_tiles_one_side(ref, read, comstr, anchors, tiles, f1, f2,
                          gap_str, gap_end, len(read), direction, gp)
    gp.direction = original_direction
    return 0


def map_interval(seq1, read, comstr, tiles_str: List[int], tiles_end: List[int],
                 f1, f2, gap_str: int, gap_end: int, anchor_lower: int, anchor_upper: int,
                 direction: int, gp: GapParms, f_filter: int = 0) -> int:
    """mapInterval (src/gap_util.cpp:4444)."""
    thd_mi_filter = 1000
    if cord_strand(gap_str ^ gap_end):
        return 1
    shape_len = 9
    step1 = 5
    step2 = 1
    g_hs: List[int] = []
    anchors: List[int] = []
    g_stream(seq1, read, g_hs, gap_str, gap_end, shape_len, step1, step2)
    g_create_anchors(g_hs, anchors, shape_len, direction, anchor_lower, anchor_upper,
                     len(read) - 1, gap_str, gap_end, gp)
    PMP._dbg("GANC", anchors)
    if len(anchors) > thd_mi_filter and f_filter:
        filter_gap_anchors(anchors, gap_str, gap_end, direction, gp)
    PMP._dbg("GFAN", anchors)
    map_tiles_from_anchors(seq1, read, comstr, anchors, tiles_str, tiles_end,
                           f1, f2, gap_str, gap_end, len(read) - 1, direction, gp)
    PMP._dbg("GTIL", tiles_str)
    return 0


def map_generic(seqs, read, comstr, f1, f2, tiles_str: List[int], tiles_end: List[int],
                gap_str: int, gap_end: int, gp: GapParms) -> None:
    """mapGeneric (src/gap_util.cpp:4492)."""
    t_direction = 0
    f_rfts_clip = gp.f_rfts_clip
    gp.f_rfts_clip = 0
    map_interval(seqs[cid(gap_str)], read, comstr, tiles_str, tiles_end, f1, f2,
                 gap_str, gap_end, LLMIN, LLMAX, t_direction, gp, 1)
    reform_tiles(seqs[cid(gap_str)], read, comstr, tiles_str, tiles_end, [],
                 gap_str, gap_end, t_direction, gp)
    gp.f_rfts_clip = f_rfts_clip


# -------------------------------------------- two-sided ins/del extension


def get_extends_interval_chains_overlaps(chain1: List[int], chain2: List[int],
                                         get_x: Callable, get_y: Callable,
                                         gp: GapParms) -> Tuple[int, int]:
    """getExtendsIntervalChainsOverlaps (src/gap_util.cpp:3272)."""
    if not chain1 or not chain2:
        return (len(chain1), 0)
    x2 = get_x(chain2[0])
    y2 = get_y(chain2[0])
    x2 = x2 - gp.thd_dcomx_err_dx if x2 > gp.thd_dcomx_err_dx else 0
    y2 = y2 - gp.thd_dcomx_err_dy if y2 > gp.thd_dcomx_err_dy else 0
    i1 = 0
    for i in range(len(chain1) - 1, -1, -1):
        if get_x(chain1[i]) < x2 and get_y(chain1[i]) < y2:
            i1 = i + 1
            break
    x1 = get_x(chain1[-1]) + gp.thd_dcomx_err_dx
    y1 = get_y(chain1[-1]) + gp.thd_dcomx_err_dy
    x1 = x1 + gp.thd_dcomx_err_dx if gp.ref_len - x1 > gp.thd_dcomx_err_dx else gp.ref_len
    y1 = y1 + gp.thd_dcomx_err_dy if gp.read_len - y1 > gp.thd_dcomx_err_dy else gp.read_len
    i2 = len(chain2)
    for i in range(len(chain2)):
        if get_x(chain2[i]) > x1 and get_y(chain2[i]) > y1:
            i2 = i
            break
    return (i1, i2)


def __extends_interval_clip_overlaps_insdel(chain1: List[int], chain2: List[int],
                                            shape_len: int, get_x: Callable, get_y: Callable,
                                            gp: GapParms) -> None:
    """__extendsIntervalClipOverlapsInsDel_ (src/gap_util.cpp:3382) with
    f_clip=True."""
    if not chain1 or not chain2:
        return
    gp.clip_chain_parms(shape_len, gp.thd_err)
    gs11 = accumulate_simple_gap_score1(chain1, shape_len, get_x, gp)
    gs12 = accumulate_simple_gap_score1(chain1, shape_len, get_y, gp)
    gs21 = accumulate_simple_gap_score1(chain2, shape_len, get_x, gp)
    gs22 = accumulate_simple_gap_score1(chain2, shape_len, get_y, gp)
    clip_chain_(chain1, gs11, gs12, G_MAP_RGHT, True, gp)
    clip_chain_(chain2, gs21, gs22, G_MAP_LEFT, True, gp)
    PMP._dbg("XCL1", chain1)
    PMP._dbg("XCL2", chain2)
    # NOTE: the C++ clips the chains but keeps using the PRE-CLIP score
    # arrays (indices misalign for chain2 after its prefix erase) — replicated
    j1 = j2 = i_clip = 0
    j_clip = -1
    j1_pre = j2_pre = 0
    min_score = (1 << 31) - 1
    if not chain1 or not chain2:
        if not chain1:
            del chain2[:0]
        return
    x21 = get_x(chain2[0])
    x22 = get_x(chain2[0])
    for i in range(len(chain1)):
        x1 = get_x(chain1[i])
        x2_lower = x1
        x2_upper = x1 + gp.thd_eicos_clip_dxy
        j = j1_pre
        while j < len(chain2) and x21 < x2_lower:
            x21 = get_x(chain2[j])
            j1 = j
            j += 1
        if x21 > x2_upper:
            continue
        if x21 < x2_lower:
            break
        j = j2_pre
        while j < len(chain2) and x22 <= x2_upper:
            x22 = get_x(chain2[j])
            j2 = j
            j += 1
        if x22 < x2_lower:
            break
        if j1 > j_clip or j2_pre != j2:
            score11 = gs11[i] if i < len(gs11) else 0
            score12 = gs12[i] if i < len(gs12) else 0
            for jj in range(max(j1, j2_pre), j2):
                if jj >= len(gs21):
                    break
                score21 = _i32(gs21[-1] - gs21[jj])
                score22 = _i32(gs22[-1] - gs22[jj])
                dxc = get_x(chain2[jj]) - get_x(chain1[i])
                # C++: int64 compare, then uint64 product truncated to int32
                score_connect = (_i32(((dxc - shape_len) * gp.int_precision) & M64)
                                 if dxc > shape_len else 0)
                score = _i32(score11 + score12 + score21 + score22 + score_connect)
                if score < min_score:
                    min_score = score
                    i_clip = i
                    j_clip = jj
        j1_pre = j1
        j2_pre = j2
    PMP._dbg("XCLP", [i_clip & ((1 << 64) - 1), j_clip & ((1 << 64) - 1)])
    del chain1[i_clip:]
    j_clip = 0 if j_clip < 0 else j_clip
    del chain2[:j_clip]


def extends_interval_clip_overlaps_insdel(chain1: List[int], chain2: List[int],
                                          shape_len: int, get_x: Callable, get_y: Callable,
                                          gp: GapParms) -> None:
    """extendsIntervalClipOverlapsInsDel_ (src/gap_util.cpp:3492)."""
    if not chain1 and not chain2:
        return
    if not chain1:
        clip_chain(chain2, shape_len, G_MAP_LEFT, True, get_x, get_y, gp)
    elif not chain2:
        clip_chain(chain1, shape_len, G_MAP_RGHT, True, get_x, get_y, gp)
    else:
        if not gp.thd_eicos_f_as_ins:
            clip_chain(chain1, shape_len, G_MAP_RGHT, True, get_x, get_y, gp)
            clip_chain(chain2, shape_len, G_MAP_LEFT, True, get_x, get_y, gp)
        else:
            __extends_interval_clip_overlaps_insdel(chain1, chain2, shape_len, get_x, get_y, gp)


def extends_interval_map_overlaps(ref, read, comstr, tiles1: List[int], tiles2: List[int],
                                  gap_str1: int, gap_end1: int, gap_str2: int, gap_end2: int,
                                  shape_len: int, step1: int, step2: int, gp: GapParms) -> None:
    """extendsIntervalMapOverlaps_ (src/gap_util.cpp:3577)."""
    drop_chain_gap_x(tiles1, tile_x, tile_y, G_MAP_RGHT, True, gp)
    drop_chain_gap_x(tiles2, tile_x, tile_y, G_MAP_LEFT, True, gp)
    PMP._dbg("XDR1", tiles1)
    PMP._dbg("XDR2", tiles2)
    overlap1: List[int] = []
    overlap2: List[int] = []
    overlaps = get_extends_interval_chains_overlaps(tiles1, tiles2, tile_x, tile_y, gp)
    PMP._dbg("XOVP", [overlaps[0] & ((1<<64)-1), overlaps[1] & ((1<<64)-1)])
    if tiles1:
        seq2 = comstr if tile_strand(tiles1[0]) else read
        map_along_chain(ref, seq2, tiles1, overlap1, overlaps[0], len(tiles1), shape_len,
                        step1, step2, tile_x, tile_y, tile_strand, set_tile_strand,
                        ganchor2tile, gp)
    if tiles2:
        seq2 = comstr if tile_strand(tiles2[0]) else read
        map_along_chain(ref, seq2, tiles2, overlap2, 0, overlaps[1], shape_len,
                        step1, step2, tile_x, tile_y, tile_strand, set_tile_strand,
                        ganchor2tile, gp)
    PMP._dbg("XMA1", overlap1)
    PMP._dbg("XMA2", overlap2)
    # C++ compares the x-y diagonals as uint64 (negative diffs wrap huge,
    # src/gap_util.cpp:3613) — the ins/del branch choice depends on it
    if ((tile_x(gap_str1) - tile_y(gap_str1)) & M64) > ((tile_x(gap_end2) - tile_y(gap_end2)) & M64):
        extends_interval_clip_overlaps_insdel(overlap1, overlap2, shape_len, tile_x, tile_y, gp)
    else:
        extends_interval_clip_overlaps_insdel(overlap1, overlap2, shape_len, tile_y, tile_x, gp)
    del tiles1[overlaps[0]:]
    if overlap1:
        tiles1.extend(overlap1)
    del tiles2[:overlaps[1]]
    if overlap2:
        tiles2[0:0] = overlap2


def extends_tiles_from_anchors(ref, read, comstr, anchors1: List[int], anchors2: List[int],
                               tiles_str1, tiles_end1, tiles_str2, tiles_end2,
                               f1, f2, gap_str1, gap_end1, gap_str2, gap_end2,
                               read_len: int, gp: GapParms) -> None:
    """extendsTilesFromAnchors (src/gap_util.cpp:3643)."""
    original_direction = gp.direction
    tmp1: List[int] = []
    tmp2: List[int] = []
    PMP._dbg("XAN1", anchors1)
    PMP._dbg("XAN2", anchors2)
    gp.direction = G_MAP_RGHT
    g_create_chains_from_anchors(anchors1, tmp1, gap_str1, gap_end1, read_len, gp)
    get_closest_extension_chain(tmp1, gap_str1, gap_end1, True, gp)
    gp.direction = G_MAP_LEFT
    g_create_chains_from_anchors(anchors2, tmp2, gap_str2, gap_end2, read_len, gp)
    get_closest_extension_chain(tmp2, gap_str2, gap_end2, True, gp)
    PMP._dbg("XCH1", tmp1)
    PMP._dbg("XCH2", tmp2)
    shape_len = gp.thd_etfas_shape_len
    step1 = gp.thd_etfas_step1
    step2 = gp.thd_etfas_step2
    extends_interval_map_overlaps(ref, read, comstr, tmp1, tmp2, gap_str1, gap_end1,
                                  gap_str2, gap_end2, shape_len, step1, step2, gp)
    PMP._dbg("XOV1", tmp1)
    PMP._dbg("XOV2", tmp2)
    g_create_tiles_from_chains2(tmp1, tiles_str1, tiles_end1, f1, f2, gap_str1, gap_end1,
                                0, len(tmp1), tile_x, tile_y, tile_strand, gp)
    g_create_tiles_from_chains2(tmp2, tiles_str2, tiles_end2, f1, f2, gap_str2, gap_end2,
                                0, len(tmp2), tile_x, tile_y, tile_strand, gp)
    gp.direction = original_direction


def extends_interval(ref, read, comstr, tiles_str1, tiles_end1, tiles_str2, tiles_end2,
                     f1, f2, gap_str1, gap_end1, gap_str2, gap_end2, gp: GapParms) -> int:
    """extendsInterval (src/gap_util.cpp:3696)."""
    if (cord_strand(gap_str1 ^ gap_end1) or cord_strand(gap_str2 ^ gap_end2)
            or cord_strand(gap_str1 ^ gap_str2)):
        return 1
    shape_len = gp.thd_eis_shape_len
    step1 = gp.thd_eis_step1
    step2 = gp.thd_eis_step2
    g_hs: List[int] = []
    anchors1: List[int] = []
    anchors2: List[int] = []
    gid = cid(gap_str1)
    std = cord_strand(gap_str1)
    x1 = min(cx(gap_str1), cx(gap_str2))
    y1 = min(cy(gap_str1), cy(gap_str2))
    x2 = max(cx(gap_end1), cx(gap_end1))  # C++ quirk: gap_end1 twice
    y2 = max(cy(gap_end1), cy(gap_end2))
    stream_str = make_cord(gid, x1, y1, std)
    stream_end = make_cord(gid, x2, y2, std)
    g_stream(ref, read, g_hs, stream_str, stream_end, shape_len, step1, step2)
    g_create_extend_anchors_pair(g_hs, anchors1, anchors2, shape_len, len(read) - 1,
                                 gap_str1, gap_end1, gap_str2, gap_end2, gp)
    extends_tiles_from_anchors(ref, read, comstr, anchors1, anchors2,
                               tiles_str1, tiles_end1, tiles_str2, tiles_end2,
                               f1, f2, gap_str1, gap_end1, gap_str2, gap_end2,
                               len(read), gp)
    return 0


# ------------------------------------------------------ extend map entry


def map_extend_result_filter(tiles_str: List[int], tiles_end: List[int],
                             gap_str: int, gap_end: int, direction: int, gp: GapParms) -> None:
    """mapExtendResultFilter_ (src/gap_util.cpp:3986)."""
    if direction >= 0:
        pre_tile = gap_str
        for i in range(len(tiles_str)):
            dy = cy(tiles_str[i]) - tile_y(pre_tile)
            dx = cy(tiles_str[i]) - tile_x(pre_tile)  # C++ quirk: cord_y - tile_x
            if dy > gp.thd_me_reject_gap or dx > gp.thd_me_reject_gap:
                del tiles_str[i:]
                if tiles_end:
                    del tiles_end[i:]
                break
            pre_tile = tiles_str[i]
    if direction <= 0:
        pre_tile = gap_end
        for i in range(len(tiles_str) - 1, -1, -1):
            dy = cy(pre_tile) - tile_y(tiles_str[i])
            dx = cy(pre_tile) - tile_x(tiles_str[i])  # C++ quirk
            if dy > gp.thd_me_reject_gap or dx > gp.thd_me_reject_gap:
                del tiles_str[: i + 1]
                if tiles_end:
                    del tiles_end[: i + 1]
                break
            pre_tile = tiles_str[i]


def map_extend(seqs, read, comstr, f1, f2, tiles_str: List[int], tiles_end: List[int],
               gap_str: int, gap_end: int, direction: int, gp: GapParms) -> None:
    """mapExtend (src/gap_util.cpp:4035)."""
    d_anchor_rate_origin = gp.thd_gmsa_d_anchor_rate
    gp.direction = direction
    gp.thd_ctfas2_connect_danchor = 50
    gp.thd_ctfas2_connect_dy_dx = 150
    gp.f_gmsa_direction = direction
    gp.thd_cts_major_limit = 3
    gp.f_me_map_extend = 1
    gp.thd_gmsa_d_anchor_rate = 0.25
    ref = seqs[cid(gap_str)]
    extend_interval_one_side(ref, read, comstr, tiles_str, f1, f2, gap_str, gap_end,
                             direction, gp)
    map_extend_result_filter(tiles_str, tiles_end, gap_str, gap_end, direction, gp)
    if tiles_str and direction >= 0:
        tiles_str[-1] = remove_tile_sgn_end(tiles_str[-1])
    reform_tiles(ref, read, comstr, tiles_str, tiles_end, [], gap_str, gap_end,
                 direction, gp)
    gp.f_me_map_extend = 0
    gp.thd_gmsa_d_anchor_rate = d_anchor_rate_origin


def map_extends(seqs, read, comstr, f1, f2, tiles_str1, tiles_end1, tiles_str2, tiles_end2,
                gap_str1, gap_end1, gap_str2, gap_end2, thd_dxy_min: int, gp: GapParms) -> None:
    """mapExtends (src/gap_util.cpp:4073)."""
    gp.thd_ctfas2_connect_danchor = 50
    gp.thd_ctfas2_connect_dy_dx = 150
    gp.thd_cts_major_limit = 3
    gp.f_me_map_extend = 1
    original_direction = gp.direction
    original_f_rfts_clip = gp.f_rfts_clip
    gp.f_rfts_clip = 0
    ref = seqs[cid(gap_str1)]
    extends_interval(ref, read, comstr, tiles_str1, tiles_end1, tiles_str2, tiles_end2,
                     f1, f2, gap_str1, gap_end1, gap_str2, gap_end2, gp)
    gp.direction = G_MAP_RGHT
    map_extend_result_filter(tiles_str1, tiles_end1, gap_str1, gap_end1, G_MAP_RGHT, gp)
    if tiles_str1:
        tiles_str1[-1] = remove_tile_sgn_end(tiles_str1[-1])
    reform_tiles(ref, read, comstr, tiles_str1, tiles_end1, [], gap_str1, gap_end1,
                 G_MAP_RGHT, gp)
    gp.direction = G_MAP_LEFT
    map_extend_result_filter(tiles_str2, tiles_end2, gap_str2, gap_end2, G_MAP_LEFT, gp)
    reform_tiles(ref, read, comstr, tiles_str2, tiles_end2, [], gap_str2, gap_end2,
                 G_MAP_LEFT, gp)
    gp.direction = original_direction
    gp.f_rfts_clip = original_f_rfts_clip
    gp.f_me_map_extend = 0


# ------------------------------------------------------------ reform tiles


def reform_tiles(seq1, seq2, comstr, tiles_str: List[int], tiles_end: List[int],
                 sp_tiles: List[int], gap_str: int, gap_end: int, direction: int,
                 gp: GapParms) -> None:
    """reform_tiles (src/gap_util.cpp:3042): insert head/tail sentinel tiles.
    The clip pass (reform_tiles_) is dead code in the reference (early return
    src/gap_util.cpp:2995) and therefore omitted."""
    x1, x2 = tile_x(gap_str), tile_x(gap_end)
    y1, y2 = tile_y(gap_str), tile_y(gap_end)
    if tiles_str:
        d1 = min(tile_x(tiles_str[-1]) - x1, tile_y(tiles_str[-1]) - y1, gp.thd_tile_size)
        d2 = min(x2 - tile_x(tiles_str[-1]), y2 - tile_y(tiles_str[-1]), gp.thd_tile_size)
    else:
        d1 = d2 = min(x2 - x1, y2 - y1, gp.thd_tile_size)
    head_tile_str = gap_str
    tail_tile_end = gap_end
    head_tile_end = shift_tile(head_tile_str, d1, d1)
    tail_tile_str = shift_tile(tail_tile_end, -d2, -d2)
    head_tile_str = remove_tile_sgn(head_tile_str)
    tail_tile_str = remove_tile_sgn(tail_tile_str)
    head_tile_end = remove_tile_sgn(head_tile_end)
    tail_tile_str = set_tile_end(tail_tile_str)
    tail_tile_end = set_tile_end(tail_tile_end)
    if tiles_str:
        tail_tile_str = copy_tile_sgn(tiles_str[-1], tail_tile_str)
        head_tile_str = copy_tile_sgn(tiles_str[0], head_tile_str)
        tiles_str[-1] = remove_tile_sgn(tiles_str[-1])
        tiles_str[0] = remove_tile_sgn(tiles_str[0])
    if direction != G_MAP_LEFT:
        tiles_str.insert(0, head_tile_str)
    if direction != G_MAP_RGHT:
        tiles_str.append(tail_tile_str)
    if not tiles_end:
        for t in tiles_str:
            d = min(x2 - tile_x(t), y2 - tile_y(t), gp.thd_tile_size)
            tiles_end.append(shift_tile(t, d, d))
    else:
        if direction != G_MAP_LEFT:
            tiles_end.insert(0, head_tile_end)
        if direction != G_MAP_RGHT:
            tiles_end.append(tail_tile_end)


def set_tiles_cords_sgns(tiles: List[int], sgn: int) -> None:
    """set_tiles_cords_sgns (src/gap_util.cpp:619): clear tile sgn, clear
    main flag (set_cord_gap), set recd by sgn."""
    for i in range(len(tiles)):
        t = remove_tile_sgn(tiles[i])
        t &= ~(1 << 63)  # set_cord_gap
        t = (t | (1 << 62)) if sgn else (t & ~(1 << 62))  # set_cord_recd
        tiles[i] = t


def insert_tiles2cords_one(cords: List[int], pos: int, tiles: List[int],
                           direction: int, thd_max_segs_num: int) -> int:
    """insert_tiles2Cords_ single-array (src/gap_util.cpp:3148). Returns the
    updated pos. NOTE: mutates tiles (consumed)."""
    if (len(tiles) < 2 and direction == G_MAP_CLOSED) or not tiles:
        return pos
    segs_num = 0
    for i in range(len(tiles)):
        if is_tile_end(tiles[i]):
            tiles[i] = cord_set_end(tiles[i])
            segs_num += 1
    if segs_num > thd_max_segs_num:
        return pos
    if direction == G_MAP_LEFT:
        recd = cords[pos] & (1 << 62)
        set_tiles_cords_sgns(tiles, recd)
        if cord_is_end(cords[pos]):
            tiles[-1] = cord_set_end(tiles[-1])
        else:
            tiles[-1] = cord_unset_end(tiles[-1])
        cords[pos] = tiles[-1]
        del tiles[-1]
        cords[pos:pos] = tiles
        pos += len(tiles)
        tiles.clear()
    elif direction == G_MAP_RGHT:
        recd = cords[pos] & (1 << 62)
        set_tiles_cords_sgns(tiles, recd)
        cordtmp = cords[pos]
        cords[pos] = tiles[0]
        del tiles[0]
        cords[pos + 1: pos + 1] = tiles
        pos += len(tiles)
        if cord_is_end(cordtmp):
            cords[pos] = cord_set_end(cords[pos])
        else:
            cords[pos] = cord_unset_end(cords[pos])
        tiles.clear()
    elif direction == G_MAP_CLOSED:
        recd = cords[pos] & (1 << 62)
        set_tiles_cords_sgns(tiles, recd)
        cordtmp = cords[pos]
        cords[pos - 1] = tiles[0]
        cords[pos] = tiles[-1]
        if cord_is_end(cordtmp):
            cords[pos] = cord_set_end(cords[pos])
        else:
            cords[pos] = cord_unset_end(cords[pos])
        mid = tiles[1:-1]
        cords[pos:pos] = mid
        pos += len(mid)
        tiles.clear()
    return pos


def insert_tiles2cords(cords_str: List[int], cords_end: List[int], pos: int,
                       tiles_str: List[int], tiles_end: List[int], direction: int,
                       thd_cord_size: int, thd_max_segs_num: int) -> int:
    """insert_tiles2Cords_ twin-array (src/gap_util.cpp:3240). Returns new pos."""
    if not cords_end:
        d = (thd_cord_size << 20) + thd_cord_size
        cords_end.extend((c + d) & M64 for c in cords_str)
    postmp = pos
    pos = insert_tiles2cords_one(cords_str, pos, tiles_str, direction, thd_max_segs_num)
    insert_tiles2cords_one(cords_end, postmp, tiles_end, direction, thd_max_segs_num)
    return pos


# ---------------------------------------------------------------- mapGap_


def get_max_gapsy_overlap(gapsy: List[Tuple[int, int]], gap_str: int, gap_end: int) -> int:
    """_getMaxGapsyOverlap (src/gap_util.cpp:343)."""
    gap_stry = cy(gap_str)
    gap_endy = cy(gap_end)
    for ystr, yend in gapsy:
        if ystr <= gap_stry <= yend:
            return min(gap_endy, yend) - gap_stry
        if ystr <= gap_endy <= yend:
            return gap_endy - max(gap_stry, ystr)
    return 0


def map_gap_(seqs, read, comstr, gap_str: int, gap_end: int, f1, f2,
             tiles_str: List[int], tiles_end: List[int], clips: List[int],
             direction: int, thd_dxy_min: int, gp: GapParms) -> int:
    """mapGap_ (src/gap.cpp:16)."""
    tiles_str.clear()
    tiles_end.clear()
    gap_str = remove_tile_sgn(cord_unset_end(gap_str))
    gap_end = remove_tile_sgn(cord_unset_end(gap_end))
    ref = seqs[cid(gap_str)]
    x1, x2 = cx(gap_str), cx(gap_end)
    y1, y2 = cy(gap_str), cy(gap_end)
    if (x1 + gp.thd_tile_size > len(ref) - 1 or y1 + gp.thd_tile_size > len(read) - 1
            or x2 > len(ref) - 1 or y2 > len(read) - 1
            or x2 < gp.thd_tile_size or y2 < gp.thd_tile_size):
        return 0
    elif cord_strand(gap_str ^ gap_end):
        if direction != G_MAP_CLOSED:
            return -1
        thd_max_extend1 = 500
        thd_max_extend2 = 5000
        ts1: List[int] = []
        ts2: List[int] = []
        te1: List[int] = []
        te2: List[int] = []
        shift_x = (min(thd_max_extend2, len(ref) - 1 - cx(gap_str), x2 - x1)
                   if x2 - x1 > 0 else thd_max_extend1)
        shift_y = min(int((x2 - x1) * (1 + gp.thd_err)), len(read) - 1 - cy(gap_str))
        shift_x = max(shift_x, 0)
        shift_y = max(shift_y, 0)
        gap_str1 = gap_str
        gap_end1 = shift(gap_str, shift_x, shift_y)
        map_extend(seqs, read, comstr, f1, f2, ts1, te1, gap_str1, gap_end1, G_MAP_RGHT, gp)
        shift_x = (min(x2 - x1, cx(gap_end), thd_max_extend2)
                   if x2 - x1 > 0 else thd_max_extend1)
        shift_y = min(int((x2 - x1) * (1 + gp.thd_err)), cy(gap_end))
        shift_x = max(shift_x, 0)
        shift_y = max(shift_y, 0)
        gap_str2 = shift(gap_end, -shift_x, -shift_y)
        gap_end2 = gap_end
        map_extend(seqs, read, comstr, f1, f2, ts2, te2, gap_str2, gap_end2, G_MAP_LEFT, gp)
        if ts1:
            tiles_str.extend(ts1)
            tiles_end.extend(te1)
        if ts2:
            tiles_str.extend(ts2)
            tiles_end.extend(te2)
    elif x1 + gp.thd_tile_size > x2 or y1 + gp.thd_tile_size > y2:
        return 0
    elif y1 < y2:
        danc = x1 - x2 - y1 + y2
        if abs(danc) > gp.thd_mg1_danc_indel and direction == G_MAP_CLOSED:
            f_extends = 1
            chn1_tmp = gp.chn_score1.copy()
            chn2_tmp = gp.chn_score2.copy()
            gp.chn_score1.thd_min_chain_len = 1
            gp.chn_score1.thd_abort_score = 0
            gp.chn_score1.get_score = get_gap_anchors_chain_score2
            gp.chn_score2.thd_abort_score = 0
            gp.chn_score2.get_score2 = get_gap_blocks_chain_score3
            ts1: List[int] = []
            ts2: List[int] = []
            te1: List[int] = []
            te2: List[int] = []
            gap_str1 = gap_str2 = gap_end1 = gap_end2 = 0
            if danc > 0:  # ins (x1<x2) / dup (x1>x2)
                shift_y = min(max(y2 - y1, 0), gp.thd_max_extend2, len(read) - y1 - 1)
                shift_x = min(int(shift_y * (1 + gp.thd_err)), gp.thd_max_extend2, len(ref) - x1 - 1)
                gap_str1 = gap_str
                gap_end1 = shift(gap_str, shift_x, shift_y)
                shift_y = min(max(y2 - y1, 0), gp.thd_max_extend2, y2)
                shift_x = min(int(shift_y * (1 + gp.thd_err)), gp.thd_max_extend2, x2)
                gap_str2 = shift(gap_end, -shift_x, -shift_y)
                gap_end2 = gap_end
                f_extends = 1 if x1 < x2 else 2
            elif x1 < x2:  # del
                shift_x = min(max(x2 - x1, 0), gp.thd_max_extend2, len(ref) - x1 - 1)
                shift_y = min(int(shift_x * (1 + gp.thd_err)), gp.thd_max_extend2, len(read) - y1 - 1)
                gap_str1 = gap_str
                gap_end1 = shift(gap_str, shift_x, shift_y)
                shift_x = min(max(x2 - x1, 0), gp.thd_max_extend2, x2)
                shift_y = min(int(shift_x * (1 + gp.thd_err)), gp.thd_max_extend2, y2)
                gap_str2 = shift(gap_end, -shift_x, -shift_y)
                gap_end2 = gap_end
                f_extends = 1
            else:
                f_extends = 0
            if f_extends:
                if f_extends == 1:
                    map_extends(seqs, read, comstr, f1, f2, ts1, te1, ts2, te2,
                                gap_str1, gap_end1, gap_str2, gap_end2, thd_dxy_min, gp)
                elif f_extends == 2:
                    map_extend(seqs, read, comstr, f1, f2, ts1, te1,
                               gap_str1, gap_end1, G_MAP_RGHT, gp)
                    map_extend(seqs, read, comstr, f1, f2, ts2, te2,
                               gap_str2, gap_end2, G_MAP_LEFT, gp)
                if ts1:
                    tiles_str.extend(ts1)
                    tiles_end.extend(te1)
                    tiles_str[-1] = remove_tile_sgn(tiles_str[-1])
                    tiles_end[-1] = remove_tile_sgn(tiles_end[-1])
                if ts2:
                    ts2[0] = remove_tile_sgn(ts2[0])
                    te2[0] = remove_tile_sgn(te2[0])
                    tiles_str.extend(ts2)
                    tiles_end.extend(te2)
            gp.chn_score2 = chn2_tmp
            gp.chn_score1 = chn1_tmp
    PMP._dbg("MGBR", tiles_str)
    tiles_str.insert(0, gap_str)
    tiles_end.insert(0, shift_tile(gap_str, 1, 1))
    tiles_str.append(shift_tile(gap_end, -1, -1))
    tiles_end.append(gap_end)
    # addons_1: map generic gaps in residual >=90x90 holes
    i = 1
    while i < len(tiles_str):
        dx = tile_x(tiles_str[i]) - tile_x(tiles_end[i - 1])
        dy = tile_y(tiles_str[i]) - tile_y(tiles_end[i - 1])
        if not tile_strand(tiles_str[i] ^ tiles_str[i - 1]):
            if dx > 90 and dy > 90:
                ts1 = []
                te1 = []
                t_gap_str = tiles_str[i - 1]
                t_gap_end = tiles_str[i]
                map_generic(seqs, read, comstr, f1, f2, ts1, te1, t_gap_str, t_gap_end, gp)
                PMP._dbg("MGGN", ts1)
                if ts1:
                    # strip the head/tail sentinels reform_tiles inserted
                    del ts1[0]
                    del te1[0]
                    del ts1[-1]
                    del te1[-1]
                    if ts1:
                        ts1[-1] = remove_tile_sgn(ts1[-1])
                        te1[-1] = remove_tile_sgn(te1[-1])
                        tiles_str[i:i] = ts1
                        tiles_end[i:i] = te1
                    i += len(ts1)
        i += 1
    # addons_2: dup re-detection
    if gp.f_dup:
        thd_extend_range_rate1 = 0.1
        i = 1
        while i < len(tiles_str):
            if (not tile_strand(tiles_str[i] ^ tiles_str[i - 1])
                    and not is_tile_end(tiles_str[i - 1])):
                tx1 = tile_x(tiles_end[i - 1])
                ty1 = tile_y(tiles_end[i - 1])
                tx2 = tile_x(tiles_str[i])
                ty2 = tile_y(tiles_str[i])
                dx = tx2 - tx1
                dy = ty2 - ty1
                if dy > 100 and dy - dx > gp.thd_mg1_danc_indel:
                    ts1 = []
                    te1 = []
                    ex1 = -min(int(dy * (1 + thd_extend_range_rate1)), tx1)
                    ex2 = min(int(dy * (1 + thd_extend_range_rate1)),
                              len(seqs[cid(gap_str)]) - tx2 - 1)
                    t_gap_str = shift_tile(tiles_end[i - 1], ex1, 0)
                    t_gap_end = shift_tile(tiles_str[i], ex2, 0)
                    map_generic(seqs, read, comstr, f1, f2, ts1, te1, t_gap_str, t_gap_end, gp)
                    if ts1:
                        del ts1[0]
                        del te1[0]
                        del ts1[-1]
                        del te1[-1]
                        if ts1:
                            ts1[-1] = remove_tile_sgn(ts1[-1])
                            te1[-1] = remove_tile_sgn(te1[-1])
                            if tile_x(ts1[0]) < tile_x(tiles_str[i - 1]):
                                tiles_str[i - 1] = set_tile_end(tiles_str[i - 1])
                                tiles_end[i - 1] = set_tile_end(tiles_end[i - 1])
                            if tile_x(ts1[-1]) > tile_x(tiles_str[i]):
                                ts1[-1] = set_tile_end(ts1[-1])
                                te1[-1] = set_tile_end(te1[-1])
                            tiles_str[i:i] = ts1
                            tiles_end[i:i] = te1
                        i += len(ts1)
            i += 1
    # strip the sentinel head/tail
    del tiles_str[0]
    del tiles_end[0]
    del tiles_str[-1]
    del tiles_end[-1]
    return 0


def map_gaps(seqs, read, comstr, cords_str: List[int], cords_end: List[int],
             apx_gaps: List[Tuple[int, int]], f1, f2, gp: GapParms,
             clips: List[int] = None) -> None:
    """mapGaps (src/gap.cpp:407)."""
    if clips is None:
        clips = []
    if len(cords_str) <= 1:
        return
    tiles_str: List[int] = []
    tiles_end: List[int] = []
    thd_max_segs_num = 1000
    thd_max_extend = 2000
    thd_max_gap = 3000
    thd_dxy_min = 80
    thd_extend_xy = 3
    block_size = gp.thd_tile_size
    thd_cord_size = gp.thd_tile_size
    thd_cord_gap = gp.thd_gap_len_min + block_size
    apx_gaps.clear()
    str_ends, _ = PMP.gather_blocks(cords_str, 1, len(cords_str), len(read),
                                    thd_cord_gap, thd_cord_size, False)
    new_gaps, _ = PMP.gather_gaps_y(str_ends, len(read), thd_cord_gap)
    apx_gaps.extend(new_gaps)
    i = 1
    while i < len(cords_str):
        sid = cid(cords_str[i])
        gp.read_len = len(read)
        gp.ref_len = len(seqs[sid])
        if cord_is_end(cords_str[i - 1]):  # clip first cord of block
            shift_x = min(len(seqs[sid]) - 1 - cx(cords_str[i]), block_size)
            shift_y = min(len(read) - 1 - cy(cords_str[i]), block_size)
            gap_end = shift(cords_str[i], shift_x, shift_y)
            if cy(gap_end) > thd_cord_gap:
                shift_x = min(thd_max_extend, cx(gap_end))
                shift_y = min(thd_max_extend, cy(gap_end))
                shift_x = min(shift_x, shift_y * thd_extend_xy)
                gap_str = shift(gap_end, -shift_x, -shift_y)
                direction = G_MAP_LEFT
                gap_str = remove_tile_sgn(cord_unset_end(gap_str))
                gap_end = remove_tile_sgn(cord_unset_end(gap_end))
                if get_max_gapsy_overlap(apx_gaps, gap_str, gap_end) > thd_cord_gap:
                    PMP._dbg("MGPI", [gap_str, gap_end, direction & ((1 << 64) - 1)])
                    map_gap_(seqs, read, comstr, gap_str, gap_end, f1, f2,
                             tiles_str, tiles_end, clips, direction, thd_dxy_min, gp)
                    PMP._dbg("MGPO", tiles_str)
                    i = insert_tiles2cords(cords_str, cords_end, i, tiles_str, tiles_end,
                                           direction, thd_cord_size, thd_max_segs_num)
        elif not is_consecutive(cords_str[i - 1], cords_str[i], thd_cord_gap):
            shift_x = min(len(seqs[sid]) - 1 - cx(cords_str[i]), gp.thd_tile_size)
            shift_y = min(len(read) - 1 - cy(cords_str[i]), gp.thd_tile_size)
            if (not cord_is_end(cords_str[i]) and i + 1 < len(cords_str)
                    and not cord_strand(cords_str[i] ^ cords_str[i + 1])):
                shift_x = min(cx(cords_str[i + 1]) - cx(cords_str[i]), shift_x)
                shift_y = min(cy(cords_str[i + 1]) - cy(cords_str[i]), shift_y)
            gap_str = cords_str[i - 1]
            gap_end = shift(cords_str[i], shift_x, shift_y)
            dx_tmp = cx(gap_end) - cx(gap_str)
            if abs(dx_tmp) < thd_max_gap:
                direction = G_MAP_CLOSED
                gap_str = remove_tile_sgn(cord_unset_end(gap_str))
                gap_end = remove_tile_sgn(cord_unset_end(gap_end))
                PMP._dbg("MGPI", [gap_str, gap_end, direction & ((1<<64)-1)])
                map_gap_(seqs, read, comstr, gap_str, gap_end, f1, f2,
                         tiles_str, tiles_end, clips, direction, thd_dxy_min, gp)
                PMP._dbg("MGPO", tiles_str)
                i = insert_tiles2cords(cords_str, cords_end, i, tiles_str, tiles_end,
                                       direction, thd_cord_size, thd_max_segs_num)
        if cord_is_end(cords_str[i]):  # right clip end cord of block
            gap_str = cords_str[i]
            if len(read) - 1 - cy(gap_str) > thd_cord_gap:
                shift_x = min(thd_max_extend, len(seqs[sid]) - cx(gap_str) - 1)
                shift_y = min(thd_max_extend, len(read) - cy(gap_str) - 1)
                shift_x = min(shift_x, shift_y * thd_extend_xy)
                gap_end = shift(gap_str, shift_x, shift_y)
                direction = G_MAP_RGHT
                gap_str = remove_tile_sgn(cord_unset_end(gap_str))
                gap_end = remove_tile_sgn(cord_unset_end(gap_end))
                if get_max_gapsy_overlap(apx_gaps, gap_str, gap_end) > thd_cord_gap:
                    PMP._dbg("MGPI", [gap_str, gap_end, direction & ((1 << 64) - 1)])
                    map_gap_(seqs, read, comstr, gap_str, gap_end, f1, f2,
                             tiles_str, tiles_end, clips, direction, thd_dxy_min, gp)
                    PMP._dbg("MGPO", tiles_str)
                    i = insert_tiles2cords(cords_str, cords_end, i, tiles_str, tiles_end,
                                           direction, thd_cord_size, thd_max_segs_num)
        i += 1


# ------------------------------------------------------------ reformCords


def scale_dxdy(dx: int, d1: int, dy: int, d2: int) -> Tuple[int, int]:
    """scaleDxDy_ (src/cords.cpp:556). Returns (d1, d2)."""
    if dx * dy >= 0 and d1 * d2 >= 0 and dx * d1 >= 0 and (dx or dy or d1 or d2):
        c1 = abs(d1 * dy)
        c2 = abs(d2 * dx)
        if c1 > c2:
            if dx != 0:
                d2 = tdiv(d1 * dy, dx)
        elif c1 < c2:
            if dy != 0:
                d1 = tdiv(d2 * dx, dy)
    return d1, d2


def scale_region(cord_str: int, cord_end: int, d11: int, d12: int,
                 d21: int, d22: int) -> Tuple[int, int]:
    """scaleRegion (src/cords.cpp:584)."""
    dx = cx(cord_end) - cx(cord_str)
    dy = cy(cord_end) - cy(cord_str)
    d11, d12 = scale_dxdy(dx, d11, dy, d12)
    d21, d22 = scale_dxdy(dx, d21, dy, d22)
    return shift(cord_str, d11, d12), shift(cord_end, d21, d22)


def reform_cords(cords_str: List[int], cords_end: List[int]) -> None:
    """reformCords + reformCordsDxDy1 (src/cords.cpp:540,601): normalize
    small negative dx/dy steps after gap splicing."""
    thd_min_dx = -20  # CordsParms (include/cords.h:45)
    thd_min_dy = -20
    if len(cords_str) != len(cords_end):
        return
    it = 1
    while it < len(cords_str):
        i1, i2 = it - 1, it
        cord11, cord12 = cords_str[i1], cords_end[i1]
        cord21, cord22 = cords_str[i2], cords_end[i2]
        dx1 = cx(cord21) - cx(cord11)
        dy1 = cy(cord21) - cy(cord11)
        if cx(cords_str[it]) > cx(cords_end[it]) or cy(cords_str[it]) > cy(cords_end[it]):
            if cord_is_end(cords_str[it]):
                cords_str[it - 1] = cord_set_end(cords_str[it - 1])
                cords_end[it - 1] = cord_set_end(cords_end[it - 1])
            del cords_str[it]
            del cords_end[it]
            continue
        elif cord_strand(cord11 ^ cord22) or cord_is_end(cord11):
            it += 1
            continue
        elif (dx1 < 0 and dx1 > thd_min_dx) or (dy1 < 0 and dy1 > thd_min_dy):
            if i1 == 0 or cord_is_end(cords_str[i1 - 1]):
                lower_bound_str = 0
            elif cord_strand(cords_str[i1] ^ cords_str[i1 - 1]):
                lower_bound_str = cords_str[i1]
            else:
                lower_bound_str = cords_str[i1 - 1]
            if i2 == len(cords_str) - 1 or cord_is_end(cords_str[i2]):
                upper_bound_str = cords_end[i2]
            elif cord_strand(cords_str[i2] ^ cords_str[i2 + 1]):
                upper_bound_str = cords_end[i2]
            else:
                upper_bound_str = cords_str[i2 + 1]
            shift_x = min(tdiv(dx1 - 1, 2), 0)
            shift_y = min(tdiv(dy1 - 1, 2), 0)
            cord11, cord12 = scale_region(cord11, cord12, shift_x, shift_y, 0, 0)
            cord21, cord22 = scale_region(cord21, cord22, -shift_x, -shift_y, 0, 0)
            x11, y11 = cx(cord11), cy(cord11)
            x21, y21 = cx(cord21), cy(cord21)
            if (x11 <= cx(cord12) and x11 > cx(lower_bound_str)
                    and y11 <= cy(cord12) and y11 > cy(lower_bound_str)
                    and x21 <= cx(cord22) and x21 < cx(upper_bound_str)
                    and y21 <= cy(cord22) and y21 < cy(upper_bound_str)):
                cords_str[i1], cords_end[i1] = cord11, cord12
                cords_str[i2], cords_end[i2] = cord21, cord22
            it += 1
        else:
            it += 1
