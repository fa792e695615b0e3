"""Approximate mapping engine — the host-exact apxMap oracle.

Re-derivation of the reference's pmpfinder.cpp mapping core:

  seed lookup (index.dindex) -> anchors
  -> binningFilter / filterAnchorsList density filters (src/pmpfinder.cpp:1979-2183)
  -> anchor chaining DP into hits        (chainAnchorsHits :2448, cluster_util)
  -> block gathering + overlap breaking  (gather_blocks_ :1484, preFilterChains2 :2366)
  -> block chaining                      (chainBlocksHits, cluster_util.cpp:721)
  -> dense window extension              (path_dst_2 :1309, previous/nextWindow :883-1150)
  -> cords cleanup + gap collection      (clean_blocks_ :1537, gather_gaps_y_ :1592)
  -> SV-aware final block chaining       (chainApxCordsBlocks :1747)

Counterpart of linear_tpu.map.pmpfinder (the Python engine, selected by
LINEAR_TPU_ENGINE=py or -a 1). It is statement-exact against the C++
(including its integer wrap/overflow quirks); the device precomputes
(seeds, chain DP tables) enter through PMPParms.  Hits/cords are plain-int
lists (packed u64 cords); features are (n,3) int32 arrays with a cached
plain-list mirror for fast scalar window distances.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np

from ..utils.cordscalar import (
    M64, MASK_Y, FLAG_STRAND, FLAG_END, VALUE_MASK_DSTR, ANCHOR_ZERO,
    MAX_CORD_ID, MAX_CORD_X,
    cy, cx, cxid, cid, strand, is_end, set_end, unset_end,
    make_cord, shift, hit2cord_dstr, anchor_x, is_consecutive, up_forward_y,
    set_max_len, get_max_len,
)
from . import chaining as CH

# ---------------------------------------------------------------- parameters
# ApxMapParm2_48 (src/pmpfinder.cpp:211): band 0.25, cell 16, cell_num 6
WINDOW = 96
CELL_BIT = 4
SUP = 6            # cell_num
MED = 5            # ceil(0.75 * 6)
INF = 3            # ceil(0.5 * 6)
WTHR = 36          # windowThreshold
WTHR_REJ = 50      # windowThresholdReject
ABORT_SCORE = 1000
FT = 2             # active feature type (typeFeatures1_16/1_32/2_48 = 0/1/2)
SCPT_NUM1 = 6      # type-1 window-dist script count (6 for 1_32, 12 for 1_16)
INT_STEP1 = 2      # type-1 scpt_int_step (2 for 1_32, 1 for 1_16)

# ApxMapParm1_16 / ApxMapParm1_32 (src/pmpfinder.cpp:187-209): band 0.25,
# cell 16, cell_num 12 -> window 192, sup 12, med ceil(.75*12)=9,
# inf ceil(.5*12)=6; thresholds 60/80 (1_16) and 36/50 (1_32).
_FT_PARMS = {
    0: dict(WINDOW=192, SUP=12, MED=9, INF=6, WTHR=60, WTHR_REJ=80,
            SCPT_NUM1=12, INT_STEP1=1),
    1: dict(WINDOW=192, SUP=12, MED=9, INF=6, WTHR=36, WTHR_REJ=50,
            SCPT_NUM1=6, INT_STEP1=2),
    2: dict(WINDOW=96, SUP=6, MED=5, INF=3, WTHR=36, WTHR_REJ=50,
            SCPT_NUM1=6, INT_STEP1=2),
}


def set_feature_type(ft: int) -> None:
    """Select the active feature type's ApxMapParm set (FeaturesDynamic::init,
    src/pmpfinder.cpp:84-99 — the reference stores one global parm per run;
    here the window geometry/thresholds are module globals, set once before
    mapping). ft follows the C++ setFeatureType dispatch: 0 -> 1_16,
    1 -> 1_32, anything else -> 2_48."""
    if ft not in _FT_PARMS:
        ft = 2
    g = globals()
    g["FT"] = ft
    g.update(_FT_PARMS[ft])
    from ..out import apf as _APF

    _APF.WINDOW = _FT_PARMS[ft]["WINDOW"]

MXU31 = (31 << 24) + (31 << 18) + (31 << 12) + (31 << 6) + 31

# ------------------------------------------------------------ stage tracing
# Set LINEAR_TPU_DBG=<path> to dump per-stage u64 arrays (ANCH/FANC/CHA1/
# PREF/HITS/CRDS/APXF) in the same format as the instrumented reference
# binary; tools/diffstage.py diffs the two traces to localize divergences.
from ..utils import cxxsort as CXS
from ..utils.dbg import dbg as _dbg


@dataclass
class PMPParms:
    """PMPParms with toggle(i) alternates (include/pmpfinder.h:57,
    src/pmpfinder.cpp:1771-1783, :2286-2301, :2482-2503)."""

    thd_alpha: int = 15          # GetDIndexMatchAllParms.thd_alphas = [15, 7]
    gdl_list_n: int = 20         # GetDHitListParms (toggle(1) is the default)
    gdl_best_n: int = 1
    cah_score_type: int = 0      # ChainAnchorsHitsParms.f_score_type
    # ChainAnchorsHitsParms.thd_stop_chain_len_ratio is 0.7 in its ctor, but
    # the EFFECTIVE default is 0: Options ctor sets sensitivity=1
    # (src/base.cpp:43) and loadOptions preset-1 zeroes it (src/mapper.cpp:184)
    cah_stop_ratio: float = 0.0
    apx_sen: float = 0.7         # ApxParms.thd_sen
    # hybrid pipeline: device-precomputed anchors for the full-read first
    # pass (read_str=0, thd_alpha=15); re-apx passes always use the host path
    seed_anchors: object = None
    # device-precomputed anchor chaining DP for the first (main) pass:
    # (sorted_anchors_desc, ChainsRecord list); consumed once and validated
    # against the host-filtered anchors before use
    chain_pre: object = None
    # REFERENCE STATE-LEAK QUIRK: the reference's PMPParms is per-THREAD and
    # persists across reads (src/mapper.cpp:233-237); the re-apx/retry paths
    # bracket with toggle(1)..toggle(0) (src/pmpfinder.cpp:2762-2766,
    # :2806-2811), so every LATER read on that thread starts in the
    # toggle(0) state — which differs from the ctor state ONLY in
    # GetDHitListParms (ctor runs toggle(1): list 20 / best 1; toggle(0):
    # list 10 / best 999, src/pmpfinder.cpp:2287-2301). Only alg-1 (-c 0)
    # reads gdl_*, so alg-2 output is unaffected. `did_toggle` records that
    # this read toggled; the Mapper carries the per-thread flag forward.
    did_toggle: bool = False

    def toggle(self, i: int) -> None:
        self.thd_alpha = [15, 7][i] if i in (0, 1) else self.thd_alpha
        self.gdl_list_n, self.gdl_best_n = [(10, 999), (20, 1)][i if i in (0, 1) else 1]
        self.cah_score_type = 0 if i == 0 else 1


class Feats:
    """Feature scripts with both numpy and plain-list mirrors (the list
    mirror is built lazily — the native engine path never touches it)."""

    def __init__(self, arr: np.ndarray, n: int | None = None):
        self.arr = arr
        # logical SeqAn length() — for type-1 features arr is the whole
        # persistent buffer snapshot (stale tail included) and n is the
        # resize length the C++ bounds checks use
        self.n_len = len(arr) if n is None else n
        self._rows: list | None = None
        if arr.ndim == 2:
            # zero-copy uint32 view for the vectorized window-dist kernels
            self.u32 = np.ascontiguousarray(arr, dtype=np.int32).view(np.uint32)
        else:
            # type-1 (1_16/1_32) scripts: flat int16, scalar kernels only
            self.u32 = None

    @property
    def rows(self) -> list:
        if self._rows is None:
            self._rows = self.arr.tolist()
        return self._rows

    def __len__(self) -> int:
        return len(self.arr)


class FeatBuf:
    """Persistent per-thread read-feature buffer for type-1 features.

    The reference declares StringSet<FeaturesDynamic> f1 once per compute
    task / thread and re-resizes it per read (src/mapper.cpp:428-446,
    :806-821). SeqAn resize never shrinks or clears: slots in
    [filled, resize_len) and the capacity tail keep previous reads'
    values, and the type-1 _windowDist variants (src/pmpfinder.cpp:698-717)
    bound-check only the start index, so those stale values are READ.
    Growth: new capacity = n < 32 ? 32 : n + n/2 (computeGenerousCapacity,
    seqan/sequence/sequence_interface.h:857), realloc copies length()
    elements, fresh memory modeled as 0."""

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.int16)
        self.len = 0

    def update(self, vals: np.ndarray, n_resize: int) -> "Feats":
        if n_resize > len(self.buf):
            cap = 32 if n_resize < 32 else n_resize + (n_resize >> 1)
            nb = np.zeros(cap, dtype=np.int16)
            nb[: self.len] = self.buf[: self.len]
            self.buf = nb
        self.buf[: len(vals)] = vals
        self.len = n_resize
        # snapshot: later reads mutate the buffer, but the per-read Feats
        # must keep this read's view (gap phase runs after later apx runs)
        return Feats(self.buf.copy(), n=n_resize)


_SHIFTS = np.array([24, 18, 12, 6, 0], dtype=np.uint32)
_MXU31_U = np.uint32(MXU31)


def _sdist_rows(a_u32: np.ndarray, b_u32: np.ndarray) -> np.ndarray:
    """Vectorized _scriptDist63_31 over row pairs: a/b (..., 3) uint32 ->
    (...,) int64 distances with the exact C++ packed-lane wrap semantics."""
    d = a_u32 + _MXU31_U - b_u32                      # uint32 wrap == C++
    lanes = (d[..., None] >> _SHIFTS) & np.uint32(63)
    return np.abs(lanes.astype(np.int64) - 31).sum(axis=(-1, -2))


def window_dist_batch(f1: "Feats", f2: "Feats", ys: np.ndarray, xs: np.ndarray,
                      d: int, sentinel: int) -> np.ndarray:
    """Batched window distance at (ys, xs) pairs: out-of-bounds (per the
    C++ bound `idx + d >= len`) yield `sentinel`."""
    n1, n2 = len(f1.rows), len(f2.rows)
    if n1 < 4 or n2 < 4:
        return np.full(np.shape(ys), sentinel, dtype=np.int64)
    ok = (ys >= 0) & (xs >= 0) & (ys + d < n1) & (xs + d < n2)
    yc = np.clip(ys, 0, n1 - 4)
    xc = np.clip(xs, 0, n2 - 4)
    a, b = f1.u32, f2.u32
    dist = _sdist_rows(a[yc], b[xc]) + _sdist_rows(a[yc + 3], b[xc + 3])
    return np.where(ok, dist, sentinel)


def _sdist(s1, s2) -> int:
    """_scriptDist63_31 (src/pmpfinder.cpp:497): per-int 6-bit-lane |diff|
    with the C++ int32 wrap semantics."""
    t = 0
    for a, b in zip(s1, s2):
        d = (a + MXU31 - b) & 0xFFFFFFFF
        t += (
            abs(((d >> 24) & 63) - 31)
            + abs(((d >> 18) & 63) - 31)
            + abs(((d >> 12) & 63) - 31)
            + abs(((d >> 6) & 63) - 31)
            + abs((d & 63) - 31)
        )
    return t


def _wdist1(f1: Feats, f2: Feats, a: int, b: int) -> int:
    """_windowDist1_32 / _windowDist1_16 (src/pmpfinder.cpp:344,433):
    sum of segment distances over scpt_num scripts at stride scpt_int_step.
    Out-of-range script reads (the C++ reads heap memory past the end there)
    are evaluated as 0-valued scripts (fresh-page semantics)."""
    from ..ops.features import script_dist16_3

    r1, r2 = f1.rows, f2.rows
    t = 0
    for i in range(0, SCPT_NUM1 * INT_STEP1, INT_STEP1):
        s1 = r1[a + i] if 0 <= a + i < len(r1) else 0
        s2 = r2[b + i] if 0 <= b + i < len(r2) else 0
        t += script_dist16_3(s1, s2)
    return t


def window_dist_u(f1: Feats, f2: Feats, a: int, b: int) -> int:
    """__windowDist / _windowDist2_48 (src/pmpfinder.cpp:655,523): unchecked
    window distance; clamped reads past the end return huge (the C++
    reads out of bounds there; valid call sites never do)."""
    if FT != 2:
        # no bounds check in the C++ (__windowDist -> _windowDist1_xx);
        # reads beyond the logical length land in the persistent buffer's
        # stale tail (emulated in rows), past the buffer -> 0
        if a < 0 or b < 0:
            return 1 << 30
        return _wdist1(f1, f2, a, b)
    r1, r2 = f1.rows, f2.rows
    if a + 3 >= len(r1) or b + 3 >= len(r2) or a < 0 or b < 0:
        return 1 << 30
    return _sdist(r1[a], r2[b]) + _sdist(r1[a + 3], r2[b + 3])


def window_dist_c(f1: Feats, f2: Feats, a: int, b: int) -> int:
    """_windowDist (src/pmpfinder.cpp:680): bounds-checked; for 2_48
    d = scpt_num * (scpt_int_step - 1) = 4; the 1_16/1_32 branches check
    only idx < len (src/pmpfinder.cpp:698-717) — reads past the end are
    evaluated as 0-valued scripts. Out of bounds -> abort_score."""
    if FT != 2:
        if a < f1.n_len and b < f2.n_len and a >= 0 and b >= 0:
            return _wdist1(f1, f2, a, b)
        return ABORT_SCORE
    d = 4
    if a + d < len(f1.rows) and b + d < len(f2.rows):
        return _sdist(f1.rows[a], f2.rows[b]) + _sdist(f1.rows[a + 3], f2.rows[b + 3])
    return ABORT_SCORE


# ------------------------------------------------- dense window extension

def previous_window(f1: Feats, f2: Feats, cord: int):
    """previousWindow (src/pmpfinder.cpp:883). Generator: yields one sweep
    request (f1, f2, y, x0) -> receives the 3 window distances; returns
    (new_cord, dist); new_cord == 0 on failure. f1 = read-strand features,
    f2 = genome. Drive with run_serial / run_lockstep."""
    gid = cid(cord)
    std = strand(cord)
    x_suf = cx(cord) >> CELL_BIT
    y_suf = cy(cord) >> CELL_BIT
    if y_suf < MED or x_suf < SUP:
        return 0, 0
    y = y_suf - MED
    dists = yield (f1, f2, y, x_suf - SUP)
    dmin = (1 << 32) - 1
    x_min = 0
    for k in range(SUP - INF):
        tmp = dists[k]
        if tmp < dmin:
            dmin = tmp
            x_min = x_suf - SUP + k
    if dmin > WTHR:
        return 0, 0
    if x_suf - x_min > MED:
        new_cord = make_cord(gid, (x_suf - MED) << CELL_BIT, (x_suf - x_min - MED + y) << CELL_BIT, std)
    else:
        new_cord = make_cord(gid, x_min << CELL_BIT, y << CELL_BIT, std)
    return new_cord, dmin


def next_window(f1: Feats, f2: Feats, cord: int):
    """nextWindow (src/pmpfinder.cpp:1079). Generator (see previous_window)."""
    gid = cid(cord)
    std = strand(cord)
    x_pre = cx(cord) >> CELL_BIT
    y_pre = cy(cord) >> CELL_BIT
    if y_pre + SUP * 2 > f1.n_len or x_pre + SUP * 2 > f2.n_len:
        return 0, 0
    y = y_pre + MED
    dists = yield (f1, f2, y, x_pre + INF)
    dmin = (1 << 32) - 1
    x_min = 0
    for k in range(SUP - INF):
        tmp = dists[k]
        if tmp < dmin:
            dmin = tmp
            x_min = x_pre + INF + k
    if dmin > WTHR:
        return 0, 0
    if x_min - x_pre > MED:
        new_cord = make_cord(gid, (x_pre + MED) << CELL_BIT, (x_pre + MED - x_min + y) << CELL_BIT, std)
    else:
        new_cord = make_cord(gid, x_min << CELL_BIT, y << CELL_BIT, std)
    return new_cord, dmin


def next_window_eval(f1: Feats, f2: Feats, cord: int):
    """Immediate-evaluation form of next_window (gap-module call sites,
    extend_patch src/gap_util.cpp)."""
    return run_serial(next_window(f1, f2, cord))


def previous_window_eval(f1: Feats, f2: Feats, cord: int):
    """Immediate-evaluation form of previous_window."""
    return run_serial(previous_window(f1, f2, cord))


def extend_window(f1: Feats, f2: Feats, cords: List[int], cordy_str: int, cordy_end: int) -> int:
    """extendWindow (src/pmpfinder.cpp:1152): extend back(cords) left then
    right within [cordy_str, cordy_end) of the cord strand."""
    cords_p_str = len(cords) - 1
    n_new = 0
    while True:
        new_cord, _ = yield from previous_window(f1, f2, cords[-1])
        if new_cord == 0 or cy(new_cord) < cordy_str:
            break
        cords.append(new_cord)
        n_new += 1
    cords_p_end = len(cords)
    for k in range(cords_p_str, (cords_p_str + cords_p_end) // 2):
        kk = len(cords) - k + cords_p_str - 1
        cords[k], cords[kk] = cords[kk], cords[k]
    while True:
        new_cord, _ = yield from next_window(f1, f2, cords[-1])
        if new_cord == 0 or cy(new_cord) + WINDOW >= cordy_end:
            break
        cords.append(new_cord)
        n_new += 1
    return n_new


# -------------------------------------------------------------- path (dst)

def init_cords(cords: List[int]) -> None:
    """initCords (src/cords.cpp:325): header element with blockEnd set."""
    cords.clear()
    cords.append(FLAG_END)


def path_dst_1(
    hits: List[int],
    f1: List[Feats],
    f2: List[Feats],
    cords: List[int],
    read_str: int,
    read_end: int,
    read_len: int,
) -> None:
    """path_dst_1 (src/pmpfinder.cpp:1269): alg-1 extension (filter mode)."""
    if not cords:
        cords.append(FLAG_END)
    it = 1
    n = len(hits)
    if it >= n:
        cords[-1] = set_end(cords[-1])
        return
    cords.append(hits[it])
    it += 1
    pre_block_ptr = len(cords) - 1
    dist_thd = WTHR
    while True:
        std = strand(cords[-1])
        gid = cid(cords[-1])
        cordy_str = read_len - read_end if std else read_str
        cordy_end = read_len - read_str - 1 if std else read_end
        pre_cord_y = 0 if is_end(cords[-2]) else cy(cords[-2]) + 1
        cordy_str = max(pre_cord_y, cordy_str)
        yield from extend_window(f1[std], f2[gid], cords, cordy_str, cordy_end)
        # nextCord (src/pmpfinder.cpp:1218)
        new_cord = 0
        f_new_block = 0
        while it < n:
            if is_end(hits[it - 1]):
                cords[-1] = set_end(cords[-1])
                pre_block_ptr = len(cords)
                f_new_block = 1
            cand = hits[it]
            it += 1
            if cy(cand) > cy(cords[-1]) or f_new_block:
                dist = window_dist_c(f1[strand(cand)], f2[cid(cand)], cy(cand) >> CELL_BIT, cx(cand) >> CELL_BIT)
                nyf = read_len - 1 - cy(cand) if strand(cand) else cy(cand)
                if dist < dist_thd and cy(cand) + WINDOW < read_len and nyf >= read_str and nyf + WINDOW < read_end:
                    cords.append(cand)
                    new_cord = cand
                    break
        if new_cord == 0:
            if f_new_block:
                cords[-1] = set_end(cords[-1])
                pre_block_ptr = len(cords)
            break
    cords[-1] = set_end(cords[-1])
    set_max_len(cords, len(cords) - pre_block_ptr)
    cords[-1] = set_end(cords[-1])


def path_dst_2(
    hits: List[int],
    f1: List[Feats],
    f2: List[Feats],
    cords: List[int],
    read_str: int,
    read_end: int,
    read_len: int,
) -> None:
    """path_dst_2 (src/pmpfinder.cpp:1309): alg-2 (default) extension.

    Exact port, including the C++ quirk at :1366 where `cordy_str` is
    assigned the whole cord value (not its y) when f_sp_l holds.
    """
    n = len(hits)
    if 1 >= n - 1:  # hitBegin >= hitEnd - 1: at least 2 patterns
        return
    if not cords:
        init_cords(cords)
    itt = 1
    itt_next = 2
    itt_first = 1
    while itt < n:
        ready_str = read_len - read_end if strand(hits[itt]) else read_str
        ready_end = read_len - read_str + 1 if strand(hits[itt]) else read_end
        if is_end(hits[itt - 1]):  # isFirstHit
            da_l = 0
        else:
            da_l = abs((cx(hits[itt]) - cx(hits[itt - 1])) - (cy(hits[itt]) - cy(hits[itt - 1])))
        f_sp_l = (da_l > 80) or strand(hits[itt] ^ hits[itt - 1]) != 0
        f_sp_r = False
        f_block_end = False
        while True:
            if itt_next >= n or is_end(hits[itt_next - 1]):
                f_block_end = True
                itt_first = itt_next
                break
            da_r = abs(
                (cx(hits[itt_next]) - cx(hits[itt_next - 1]))
                - (cy(hits[itt_next]) - cy(hits[itt_next - 1]))
            )
            f_sp_r = (da_r > 80) or strand(hits[itt_next] ^ hits[itt_next - 1]) != 0
            if (
                cy(hits[itt]) + WINDOW < cy(hits[itt_next])
                and cx(hits[itt]) + WINDOW < cx(hits[itt_next])
            ) or f_sp_r:
                break
            itt_next += 1
        f_append = False
        cordy_str = 0
        cordy_end = 0
        if not f_sp_r and not f_block_end:  # normal case
            if f_sp_l:
                cordy_str = hits[itt]  # C++ quirk: whole cord value
            elif is_end(hits[itt - 1]):
                cordy_str = ready_str
            else:
                cordy_str = cy(cords[-1])
            cordy_end = cy(hits[itt_next])
            cords.append(unset_end(hits[itt]))
            f_append = True
        else:
            if not f_sp_l and cy(hits[itt_next - 1]) >= WINDOW and cx(hits[itt_next - 1]) >= WINDOW:
                new_cord = shift(hits[itt_next - 1], -WINDOW, -WINDOW)
                cordy_str = read_str if is_end(hits[itt - 1]) else cy(new_cord)
                cordy_end = cy(hits[itt_next - 1])
                cords.append(unset_end(new_cord))
                f_append = True
            else:
                f_append = False
        if is_end(hits[itt]) or f_block_end:
            f_block_end = True
            cordy_end = ready_end
        if f_append:
            yield from extend_window(f1[strand(hits[itt])], f2[cid(hits[itt])], cords, cordy_str, cordy_end)
        if f_block_end:
            cords[-1] = set_end(cords[-1])
        itt_next = itt_first if f_block_end else itt_next
        itt = itt_next
        itt_next += 1


def filter_hits(hits: List[int], f1: List[Feats], f2: List[Feats]) -> None:
    """_filterHits (src/pmpfinder.cpp:1417): drop hits whose window distance
    >= reject threshold, preserving blockEnd flags (in place)."""
    ii_move = 0
    for i in range(1, len(hits)):
        h = hits[i]
        dist = window_dist_c(f1[strand(h)], f2[cid(h)], cy(h) >> CELL_BIT, cx(h) >> CELL_BIT)
        _dbg("FHIT", [h, dist])
        if FT != 2:
            from ..utils.dbg import dbg_s as _dbg_s, enabled as _dbg_en

            if _dbg_en():
                a = cy(h) >> CELL_BIT
                ff = f1[strand(h)]
                if 0 <= a < ff.n_len:
                    row = [(ff.rows[a + i] if a + i < len(ff.rows) else 0)
                           for i in range(12)]
                    _dbg_s("FSCR", row)
        if dist < WTHR_REJ:
            hits[i - ii_move] = h
        else:
            ii_move += 1
        if is_end(h):
            hits[i - ii_move] = set_end(hits[i - ii_move])
    del hits[len(hits) - ii_move:]


def path_dst(
    hits: List[int],
    f1: List[Feats],
    f2: List[Feats],
    cords: List[int],
    read_str: int,
    read_end: int,
    read_len: int,
    alg_type: int,
) -> None:
    """path_dst (src/pmpfinder.cpp:1447)."""
    if len(hits) < 2:  # isHitsEmpty
        return
    if alg_type == 1:
        yield from path_dst_1(hits, f1, f2, cords, read_str, read_end, read_len)
    elif alg_type == 2:
        filter_hits(hits, f1, f2)
        yield from path_dst_2(hits, f1, f2, cords, read_str, read_end, read_len)


# ----------------------------------------------------------- anchor filters

def binning_filter(anchors: List[int]) -> None:
    """binningFilter (src/pmpfinder.cpp:1979): keep anchors whose 30kb
    genome-x bin holds > 10 anchors; if nothing survives, keep all."""
    thd_accept_bin = 10
    bin_size = 30000
    counts: dict = {}
    bins = []
    for a in anchors:
        b = cx(a) // bin_size
        bins.append(b)
        counts[b] = counts.get(b, 0) + 1
    ii = 0
    for i, a in enumerate(anchors):
        if counts[bins[i]] > thd_accept_bin:
            anchors[ii] = a
            ii += 1
    if ii != 0:
        del anchors[ii:]


def filter_anchors_list(
    anchors: List[int],
    thd_anchor_accept_density: int,
    thd_anchor_accept_min: int,
    thd_anchor_err_bit: int,
) -> List[Tuple[int, int]]:
    """filterAnchorsList (src/pmpfinder.cpp:2019): sort anchors (u64 asc,
    anchors[0] zeroed first) and accept dense runs. Returns [start, end)
    ranges into the sorted array (which is updated in place)."""
    out: List[Tuple[int, int]] = []
    if len(anchors) <= 1:
        return out
    anchors[0] = 0
    anchors.sort()
    thd_1k_bit = 10
    ak2 = anchors[1]
    block_str = 1
    count_anchors = 0
    min_y = M64
    max_y = 0
    n = len(anchors)
    for i in range(1, n):
        a = anchors[i]
        anc_y = a & MASK_Y
        dy2 = abs(anc_y - (ak2 & MASK_Y))
        f_continuous = (((a - ak2) & M64) >> 20) & ((1 << 40) - 1) < (dy2 >> thd_anchor_err_bit)
        if f_continuous:
            if min_y > anc_y:
                min_y = anc_y
            if max_y < anc_y:
                max_y = anc_y
            ak2 = anchors[(block_str + i) >> 1]
            count_anchors += 1
        if not f_continuous or i == n - 1:
            thd_accept_num = max(
                (((max_y - min_y) & M64) * thd_anchor_accept_density) >> thd_1k_bit,
                thd_anchor_accept_min,
            )
            if count_anchors > thd_accept_num:
                out.append((block_str, i))
            block_str = i
            ak2 = a
            min_y = anc_y
            max_y = anc_y
            count_anchors = 1
    return out


def filter_anchors1(
    anchors: List[int],
    thd_anchor_accept_density: int,
    thd_anchor_accept_min: int,
    thd_anchor_err_bit: int,
) -> None:
    """filterAnchors1 (src/pmpfinder.cpp:2073): compact accepted ranges."""
    if len(anchors) <= 1:
        return
    ranges = filter_anchors_list(anchors, thd_anchor_accept_density, thd_anchor_accept_min, thd_anchor_err_bit)
    ii = 0
    for lo, hi in ranges:
        for j in range(lo, hi):
            anchors[ii] = anchors[j]
            ii += 1
    del anchors[ii:]


def filter_anchors(
    anchors: List[int],
    thd_anchor_accept_density: int,
    thd_anchor_accept_min: int,
    thd_anchor_err_bit: int,
) -> None:
    """filterAnchors (src/pmpfinder.cpp:2159): binning + density (both algs
    take the filterAnchors1 path)."""
    binning_filter(anchors)
    filter_anchors1(anchors, thd_anchor_accept_density, thd_anchor_accept_min, thd_anchor_err_bit)
    _dbg("FANC", anchors)


# ------------------------------------------------------ alg-1 listing path

def get_d_anchor_list(anchors: List[int], read_str: int, read_end: int, shape_len: int) -> List[int]:
    """getDAnchorList (src/pmpfinder.cpp:2185). Sorts anchors in place and
    returns the (c_b << 40) + (sb << 20) + k acceptance list."""
    out: List[int] = []
    thd_anchor_accept_dens = 0.001
    thd_anchor_accept_lens = int(0.01 * (read_end - read_str))
    thd_anchor_err = 0.2
    if len(anchors) <= 1:
        return out
    anchors.sort()
    ak2 = anchors[0]
    ak3 = anchors[0]
    c_b = shape_len
    sb = 1
    min_y = M64
    max_y = 0
    n = len(anchors)
    for k in range(1, n):
        anc_y = anchors[k] & MASK_Y
        dy2 = abs(anc_y - (ak2 & MASK_Y))
        dy3 = abs(anc_y - (ak3 & MASK_Y))
        f_continuous = (
            cx((anchors[k] - ak2) & M64) < thd_anchor_err * dy2
            or cx((anchors[k] - ak3) & M64) < thd_anchor_err * dy3
        )
        if f_continuous:
            dy = (anchors[k] & MASK_Y) - (anchors[k - 1] & MASK_Y)
            c_b += min(abs(dy), shape_len)
            ak2 = anchors[(sb + k) >> 1]
            ak3 = anchors[k - ((k - sb) >> 2)]
            min_y = min(min_y, anchors[k] & MASK_Y)
            max_y = max(max_y, anchors[k] & MASK_Y)
        if not f_continuous or k == n - 1:
            if c_b > thd_anchor_accept_lens and (k - sb) >= int(((max_y - min_y) & M64) * thd_anchor_accept_dens):
                seg = CXS.std_sort(anchors[sb:k], [a & MASK_Y for a in anchors[sb:k]])
                anchors[sb:k] = seg
                out.append((c_b << 40) + (sb << 20) + k)
            sb = k
            ak2 = anchors[k]
            ak3 = anchors[k]
            c_b = shape_len
            min_y = anchors[k] & MASK_Y
            max_y = anchors[k] & MASK_Y
    return out


def get_d_hit_list(hits: List[int], alist: List[int], anchors: List[int], pm: PMPParms) -> int:
    """getDHitList (src/pmpfinder.cpp:2246)."""
    mask = (1 << 20) - 1
    if not alist:
        return 0
    alist.sort(key=lambda v: v & M64, reverse=True)
    tmp = pm.gdl_list_n if len(alist) > pm.gdl_list_n else len(alist)
    record_num = 1
    for k in range(tmp):
        if record_num > pm.gdl_best_n:
            break
        if (alist[0] // 10) < alist[k] and alist[k]:
            sb = (alist[k] >> 20) & mask
            sc = alist[k] & mask
            for nn in range(sb, sc):
                hits.append(hit2cord_dstr(anchors[nn]))
            hits[-1] = set_end(hits[-1])
            record_num += 1
        else:
            break
    return alist[0] >> 40


# ------------------------------------------------------- block machinery

def gather_blocks(
    cords: List[int],
    str_: int,
    end_: int,
    read_len: int,
    thd_large_gap: int,
    thd_cord_size: int,
    f_set_end: bool,
    is_end_func: Callable[[int], int] = is_end,
    set_end_func: Callable[[int], int] = set_end,
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """gather_blocks_ (src/pmpfinder.cpp:1484). Returns (str_ends,
    str_ends_p); may set end flags in cords when f_set_end. The end-flag
    accessors are parameterized (cords use bit 60, tiles bit 63)."""
    str_ends: List[Tuple[int, int]] = []
    str_ends_p: List[Tuple[int, int]] = []
    if len(cords) < 2:
        return str_ends, str_ends_p
    d_shift_max = thd_cord_size // 2
    p_str = str_
    for i in range(str_ + 1, end_):
        if is_end_func(cords[i - 1]) or not is_consecutive(cords[i - 1], cords[i], thd_large_gap):
            d_shift = min(read_len - cy(cords[p_str]) - 1, d_shift_max)
            b_str = shift(cords[p_str], d_shift, d_shift)
            d_shift = min(read_len - cy(cords[i - 1]) - 1, d_shift_max)
            b_end = shift(cords[i - 1], d_shift, d_shift)
            str_ends.append((b_str, b_end))
            str_ends_p.append((p_str, i))
            if f_set_end:
                cords[i - 1] = set_end_func(cords[i - 1])
            p_str = i
    d_shift = min(read_len - cy(cords[-1]) - 1, d_shift_max)
    b_str = shift(cords[p_str], d_shift, d_shift)
    b_end = shift(cords[-1], d_shift, d_shift)
    str_ends.append((b_str, b_end))
    str_ends_p.append((p_str, len(cords)))
    return str_ends, str_ends_p


def clean_blocks(cords: List[int], thd_drop_len: int, thd_map_error: int = 50) -> None:
    """clean_blocks_ (src/pmpfinder.cpp:1537): drop short blocks; drop
    dx/dy<0 cords within map error (in place)."""
    if not cords:
        return
    ptr = 1
    ln = 0
    for i in range(1, len(cords)):
        ln += 1
        if not is_end(cords[i - 1]):
            dx = cx(cords[i]) - cx(cords[ptr - 1])
            dy = cy(cords[i]) - cy(cords[ptr - 1])
            if dx < 0 or dy < 0:
                if abs(dx) < thd_map_error and abs(dy) < thd_map_error:
                    ln -= 1
                    ptr -= 1
                else:
                    cords[ptr] = cords[i]
            else:
                cords[ptr] = cords[i]
        else:
            cords[ptr] = cords[i]
        if is_end(cords[i]):
            ptr = ptr - ln if ln < thd_drop_len else ptr
            ln = 0
            cords[ptr] = set_end(cords[ptr])
        ptr += 1
    del cords[ptr:]


def gather_gaps_y(
    str_ends: List[Tuple[int, int]],
    read_len: int,
    thd_gap_size: int,
) -> Tuple[List[Tuple[int, int]], int]:
    """gather_gaps_y_ (src/pmpfinder.cpp:1592): collect forward-strand y
    gaps between mapped blocks. Sorts str_ends in place; returns (gaps,
    gap_lens_sum)."""
    gaps: List[Tuple[int, int]] = []
    cord_frt = 0
    cord_end = read_len - 1
    gap_lens_sum = 0
    if not str_ends:
        gaps.append((cord_frt, cord_end))
        gy = up_forward_y(gaps[-1][0], gaps[-1][1], read_len)
        gap_lens_sum += gy[1] - gy[0]
        return gaps, gap_lens_sum

    def fwd_y_key(p: Tuple[int, int]) -> int:
        return read_len - cy(p[1]) - 1 if strand(p[0]) else cy(p[0])

    # std::sort (src/pmpfinder.cpp:1610)
    str_ends[:] = CXS.std_sort(str_ends, [fwd_y_key(p) for p in str_ends])
    f_cover = 0
    cordy1 = 0
    cordy2 = 0
    y1 = up_forward_y(str_ends[0][0], str_ends[0][1], read_len)
    y2 = y1
    if y1[0] > thd_gap_size:
        cordy2 = y1[0] & MASK_Y
        gaps.append((cord_frt, cordy2))
        gy = up_forward_y(gaps[-1][0], gaps[-1][1], read_len)
        gap_lens_sum += gy[1] - gy[0]
    for i in range(1, len(str_ends)):
        if not f_cover:
            y1 = up_forward_y(str_ends[i - 1][0], str_ends[i - 1][1], read_len)
            cordy1 = y1[1] & MASK_Y
        y2 = up_forward_y(str_ends[i][0], str_ends[i][1], read_len)
        cordy2 = y2[0] & MASK_Y
        if y1[1] > y2[1]:
            f_cover = 1
        else:
            if y2[0] > y1[1] and y2[0] - y1[1] > thd_gap_size:
                gaps.append((cordy1, cordy2))
                gy = up_forward_y(gaps[-1][0], gaps[-1][1], read_len)
                gap_lens_sum += gy[1] - gy[0]
            f_cover = 0
    max_y_end = y1[1] if f_cover else y2[1]
    if read_len - max_y_end > thd_gap_size:
        gaps.append((max_y_end, cord_end))
        gy = up_forward_y(gaps[-1][0], gaps[-1][1], read_len)
        gap_lens_sum += gy[1] - gy[0]
    return gaps, gap_lens_sum


def pre_filter_chains2(
    hits: List[int],
    str_ends_p: List[Tuple[int, int]],
    get_cord_xy: Callable[[int], int] = cy,
) -> List[Tuple[int, int]]:
    """preFilterChains2 (src/pmpfinder.cpp:2366): break chains into
    non-overlapping pieces by y (or x) cuts; sets blockEnd flags. Returns
    the new str_ends_p."""
    mask = 1 << 62
    xycuts: List[int] = []
    xy_strs: List[int] = []
    for p in str_ends_p:
        xycuts.append(p[0])
        xycuts.append((p[1] - 1) | mask)
        xy_strs.append(p[0])
    # std::sort (src/pmpfinder.cpp:2384): tie permutation must match
    xycuts = CXS.std_sort(xycuts, [get_cord_xy(hits[a & ~mask]) for a in xycuts])
    out: List[Tuple[int, int]] = []
    for cut in xycuts:
        cuty = get_cord_xy(hits[cut & ~mask])
        for j in range(len(xy_strs)):
            if xy_strs[j] >= len(hits):
                break
            if cuty < get_cord_xy(hits[xy_strs[j]]):
                continue
            for k in range(xy_strs[j], str_ends_p[j][1]):
                if cut & mask:
                    if get_cord_xy(hits[k]) == cuty:
                        lo, hi = xy_strs[j], k + 1
                        if lo != hi:
                            out.append((lo, hi))
                            xy_strs[j] = hi
                        break
                    elif get_cord_xy(hits[k]) > cuty:
                        lo, hi = xy_strs[j], k
                        if lo != hi:
                            out.append((lo, hi))
                            xy_strs[j] = hi
                        break
                else:
                    if get_cord_xy(hits[k]) >= cuty:
                        lo, hi = xy_strs[j], k
                        if lo != hi:
                            out.append((lo, hi))
                            xy_strs[j] = hi
                        break
    out.sort(key=lambda p: p[1])
    for p in out:
        hits[p[1] - 1] = set_end(hits[p[1] - 1])
    return out


# ------------------------------------------------------ anchors -> hits

def chain_anchors_hits(anchors: List[int], hits: List[int], hits_score: List[int], pm: PMPParms) -> None:
    """chainAnchorsHits (src/pmpfinder.cpp:2448)."""
    get_score = CH.get_apx_chain_score if pm.cah_score_type == 0 else CH.get_apx_chain_score0
    pre_recs = None
    if pm.chain_pre is not None and pm.cah_score_type == 0:
        # device precompute already holds the filtered, desc-sorted anchors
        # (the same code path ran on the same seeds in _device_chain_block)
        pre_anchors, pre_recs = pm.chain_pre
        pm.chain_pre = None
        anchors[:] = pre_anchors
    else:
        # std::sort desc by getAnchorX (src/pmpfinder.cpp:2465): the tie
        # permutation decides which repeat copy wins downstream
        arr = np.fromiter(anchors, dtype=np.int64, count=len(anchors))
        perm = CXS.std_sort_perm(CH.anchor_x_vec(arr), desc=True)
        anchors[:] = arr[perm].tolist()
    chains, chains_score = CH.chain_anchors_base(
        anchors, 0, len(anchors),
        thd_chain_depth=20, thd_chain_dx_depth=300,
        thd_best_n=50, stop_ratio=pm.cah_stop_ratio,
        min_len=1, abort_score=45,
        get_score=get_score, parms=CH.ChainScoreParms(),
        get_anchor_x=anchor_x,
        pre_recs=pre_recs,
        vec_score=(CH.get_apx_chain_score_vec if pm.cah_score_type == 0
                   else CH.get_apx_chain_score0_vec),
        vec_anchor_x=CH.anchor_x_vec,
    )
    for chain in chains:
        for a in chain:
            hits.append(hit2cord_dstr(int(a)))
        hits[-1] = set_end(hits[-1])
    hits_score.extend(chains_score)


def get_anchor_hits_chains(
    anchors: List[int],
    hits: List[int],
    hits_score: List[int],
    read_len: int,
    pm: PMPParms,
) -> None:
    """getAnchorHitsChains (src/pmpfinder.cpp:2506). Constants from
    mnMapReadList alg-2 (src/pmpfinder.cpp:2599-2605)."""
    thd_anchor_accept_density = 1
    thd_anchor_accept_min = 2
    thd_large_gap = 600
    thd_anchor_err_bit = 2
    if not (pm.chain_pre is not None and pm.cah_score_type == 0):
        # with a device chain precompute, the filter already ran on the same
        # seeds in Mapper._device_chain_block; chain_anchors_hits installs
        # its filtered+sorted anchors
        filter_anchors(anchors, thd_anchor_accept_density, thd_anchor_accept_min, thd_anchor_err_bit)
    hits_score.clear()
    hits_score.append(0)
    chain_anchors_hits(anchors, hits, hits_score, pm)
    _dbg("CHA1", hits)
    _, str_ends_p = gather_blocks(hits, 1, len(hits), read_len, thd_large_gap, 0, False)
    str_ends_p = pre_filter_chains2(hits, str_ends_p, cy)
    _dbg("PREF", hits)
    str_ends_p_score = [
        hits_score[p[0]] - hits_score[p[1] - 1] for p in str_ends_p
    ]
    new_hits = CH.chain_blocks_hits(
        np.array(hits, dtype=np.uint64), str_ends_p, str_ends_p_score, read_len
    )
    hits[:] = [int(h) for h in new_hits]
    _dbg("HITS", hits)


def chain_apx_cords_blocks(
    cords: List[int],
    str_ends_p: List[Tuple[int, int]],
    read_len: int,
    alg_type: int,
) -> None:
    """chainApxCordsBlocks (src/pmpfinder.cpp:1747) alg 2: SV-aware dual
    strand block chaining with major-chain filter (2 majors)."""
    if alg_type != 2:
        raise NotImplementedError("alg_type 1 simple block chaining unused by default path")
    if not str_ends_p:
        return
    new = CH.chain_blocks_cords(
        np.array(cords, dtype=np.uint64),
        list(str_ends_p),
        CH.get_apx_chain_score3,
        CH.ChainScoreParms(),
        min_len=1,
        abort_score=0,
        read_len=read_len,
        thd_init_cord_score=16,
        thd_major_limit=2,
        f_header=True,
    )
    cords[:] = [int(c) for c in new]


# ------------------------------------------------------------- top level

def mn_map_read_list(
    index,
    read: np.ndarray,
    anchors: List[int],
    hits: List[int],
    hits_score: List[int],
    map_str: int,
    map_end: int,
    alg_type: int,
    pm: PMPParms,
) -> None:
    """mnMapReadList (src/pmpfinder.cpp:2560): DIndex/HIndex/SIndex
    seeding, or with a DIndex the read's device seeds when the whole read
    is asked for at the default alpha."""
    from ..index import dindex as DI
    from ..index import hindex as HI
    from ..index import sindex as SI

    read_str = cy(map_str)
    read_end = cy(map_end)
    if isinstance(index, HI.HIndex):
        got = HI.query_anchors(index, read, map_str, map_end,
                               thd_alpha=pm.thd_alpha)
        anchors.extend(int(a) for a in got)
    elif isinstance(index, SI.SIndex):
        got = SI.query_anchors(index, read, read_str, read_end,
                               thd_alpha=pm.thd_alpha)
        anchors.extend(int(a) for a in got)
    elif (pm.seed_anchors is not None and read_str == 0 and pm.thd_alpha == 15
            and read_end >= len(read)):
        anchors.extend(int(a) for a in pm.seed_anchors)
    else:
        got = DI.query_anchors(index, read, read_str, read_end, thd_alpha=pm.thd_alpha)
        anchors.extend(int(a) for a in got)
    _dbg("ANCH", anchors)
    if alg_type == 1:
        alist = get_d_anchor_list(anchors, read_str, read_end, index.span)
        _dbg("SANC", anchors)
        _dbg("ALIS", alist)
        get_d_hit_list(hits, alist, anchors, pm)
        _dbg("HIT1", hits)
    elif alg_type == 2:
        get_anchor_hits_chains(anchors, hits, hits_score, len(read), pm)


def apx_map_(
    index,
    read: np.ndarray,
    hits: List[int],
    f1: List[Feats],
    f2: List[Feats],
    cords: List[int],
    cords_info: List[int],
    map_str: int,
    map_end: int,
    alg_type: int,
    pm: PMPParms,
) -> None:
    """apxMap_ (src/pmpfinder.cpp:2632)."""
    hits.clear()
    hits.append(FLAG_END)  # initHits
    anchors: List[int] = [0]  # anchors.init(1)
    hits_score: List[int] = []
    mn_map_read_list(index, read, anchors, hits, hits_score, map_str, map_end, alg_type, pm)
    read_str = cy(map_str)
    read_end = cy(map_end)
    n_block = 0
    for i in range(1, len(hits)):
        if is_end(hits[i]):
            cords_info.append(0)
            n_block += 1
    for i in range(len(cords_info)):
        cords_info[i] = 100 - i
    yield from path_dst(hits, f1, f2, cords, read_str, read_end, len(read), alg_type)
    _dbg("CRDS", cords)


def apx_map(
    index,
    read: np.ndarray,
    f1: List[Feats],
    f2: List[Feats],
    f_chain: int = 1,
    pm: PMPParms | None = None,
) -> Tuple[List[int], List[int], List[Tuple[int, int]], List[int]]:
    """apxMap (src/pmpfinder.cpp:2709). Returns (cords_str, cords_end,
    apx_gaps, cords_info)."""
    if pm is None:
        pm = PMPParms()
    read_len = len(read)
    thd_cord_size = WINDOW
    thd_large_gap = 1000
    thd_chain_blocks_lower = -100
    thd_chain_blocks_upper = 10000
    thd_drop_len = min(2, int(read_len * 0.05 / thd_cord_size))
    thd_reapx_max_gap_ratio = 0.7
    cords_str: List[int] = []
    cords_info: List[int] = []
    hits: List[int] = []
    apx_gaps: List[Tuple[int, int]] = []
    if f_chain:
        alg_type = 2
        map_str = 0
        map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, read_len, 0)
        yield from apx_map_(index, read, hits, f1, f2, cords_str, cords_info, map_str, map_end, alg_type, pm)
        clean_blocks(cords_str, thd_drop_len, 50)
        str_ends, str_ends_p = gather_blocks(
            cords_str, 1, len(cords_str), read_len, thd_large_gap, thd_cord_size, True
        )
        apx_gaps, gap_lens_sum = gather_gaps_y(str_ends, read_len, thd_large_gap)
        if read_len > 0 and float(gap_lens_sum) / read_len >= thd_reapx_max_gap_ratio:
            for g in apx_gaps:
                y1, y2 = up_forward_y(g[0], g[1], read_len)
                pm.toggle(1)
                pm.did_toggle = True
                map_str = y1
                map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, y2, 0)
                yield from apx_map_(index, read, hits, f1, f2, cords_str, cords_info, map_str, map_end, alg_type, pm)
                pm.toggle(0)
            str_ends, str_ends_p = gather_blocks(
                cords_str, 1, len(cords_str), read_len, thd_large_gap, thd_cord_size, True
            )
        chain_apx_cords_blocks(cords_str, str_ends_p, read_len, alg_type)
        clean_blocks(cords_str, thd_drop_len, 50)
    else:
        sen_thr = pm.apx_sen / thd_cord_size
        alg_type = 1
        map_str = 0
        # the reference passes length(read) as a PLAIN int here (:2779), not
        # a cord — its x/id field is 0, which matters for the HIndex's
        # [getCordX(map_str), getCordX(map_end)) sa window
        map_end = read_len
        yield from apx_map_(index, read, hits, f1, f2, cords_str, cords_info, map_str, map_end, alg_type, pm)
        if get_max_len(cords_str) < read_len * sen_thr:
            cords_str.clear()
            pm.toggle(1)
            pm.did_toggle = True
            yield from apx_map_(index, read, hits, f1, f2, cords_str, cords_info, map_str, map_end, alg_type, pm)
            pm.toggle(0)
        clean_blocks(cords_str, thd_drop_len)
    # Mark main/recd signs; cords_end = cords_str + (96, 96)
    cords_end: List[int] = [0] * len(cords_str)
    seg = 0
    d = shift(0, thd_cord_size, thd_cord_size)
    for i in range(len(cords_str)):
        c = cords_str[i]
        c = (c | (1 << 62)) if seg else (c & ~(1 << 62))  # set_cord_recd
        c |= 1 << 63  # set_cord_main
        cords_str[i] = c
        if is_end(c):
            seg = 1 - seg
        cords_end[i] = (c + d) & M64
    _dbg("APXF", cords_str)
    return cords_str, cords_end, apx_gaps, cords_info


# ------------------------------------------------- sweep-request drivers

def _eval_sweep(req) -> list:
    """Serial evaluator of one sweep request (the oracle path)."""
    f1, f2, y, x0 = req
    return [window_dist_u(f1, f2, y, x0 + k) for k in range(SUP - INF)]


def run_serial(gen):
    """Drive a sweep-request generator to completion, evaluating each
    request immediately (exact scalar path)."""
    try:
        req = gen.send(None)
        while True:
            req = gen.send(_eval_sweep(req))
    except StopIteration as e:
        return e.value


def run_lockstep(gens: list) -> list:
    """Drive many sweep-request generators concurrently, evaluating each
    round of requests in ONE batched numpy pass (bit-identical to the
    serial evaluator). This is the wavefront form of the reference's
    per-read dense extension (path_dst src/pmpfinder.cpp:1447): all reads
    advance one window sweep per iteration."""
    if FT != 2:
        # legacy 1_16/1_32 features use the scalar kernels (difftest-scale
        # corpora only; the batched uint32-lane kernel below is 2_48-shaped)
        return [run_serial(g) for g in gens]
    results = [None] * len(gens)
    active = []
    for i, g in enumerate(gens):
        try:
            active.append([i, g, g.send(None)])
        except StopIteration as e:
            results[i] = e.value
    # feature registry: id(Feats) -> (row offset in the concat matrix, n_rows)
    reg: dict = {}
    parts: list = []
    cat = None
    n_cand = SUP - INF

    total_rows = 0

    def _register(f):
        nonlocal cat, total_rows
        ent = reg.get(id(f))
        if ent is None:
            ent = (total_rows, len(f.rows), f)
            total_rows += len(f.rows)
            reg[id(f)] = ent
            parts.append(f.u32 if len(f.rows) else np.zeros((0, 3), np.uint32))
            cat = None  # invalidate
        return ent

    while active:
        m = len(active)
        offs1 = np.empty(m, np.int64)
        n1s = np.empty(m, np.int64)
        ys = np.empty(m, np.int64)
        x0s = np.empty(m, np.int64)
        f2s = []
        for k, a in enumerate(active):
            f1, f2, y, x0 = a[2]
            off, n1, _ = _register(f1)
            offs1[k] = off
            n1s[k] = n1
            ys[k] = y
            x0s[k] = x0
            f2s.append(f2)
        if cat is None:
            cat = np.concatenate(parts + [np.zeros((8, 3), np.uint32)], axis=0)
        ok_y = (ys >= 0) & (ys + 3 < n1s)
        yc = offs1 + np.clip(ys, 0, np.maximum(n1s - 4, 0))
        A1 = cat[yc]                                # (m, 3)
        A2 = cat[yc + 3]
        xs = x0s[:, None] + np.arange(n_cand)       # (m, C)
        dist = np.empty((m, n_cand), dtype=np.int64)
        groups: dict = {}
        for k, f2 in enumerate(f2s):
            groups.setdefault(id(f2), (f2, []))[1].append(k)
        for f2, idxs in groups.values():
            sel = np.asarray(idxs)
            n2 = len(f2.rows)
            gxs = xs[sel]
            if n2 < 4:
                dist[sel] = 1 << 30
                continue
            ok = ok_y[sel, None] & (gxs >= 0) & (gxs + 3 < n2)
            xc = np.clip(gxs, 0, n2 - 4)
            b = f2.u32
            d = _sdist_rows(A1[sel][:, None, :], b[xc]) + _sdist_rows(A2[sel][:, None, :], b[xc + 3])
            dist[sel] = np.where(ok, d, 1 << 30)
        dl = dist.tolist()
        nxt = []
        for a, row in zip(active, dl):
            try:
                a[2] = a[1].send(row)
                nxt.append(a)
            except StopIteration as e:
                results[a[0]] = e.value
        active = nxt
    return results
