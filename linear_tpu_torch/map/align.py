"""The `-a` base-level alignment path: cords -> banded alignments ->
linked BAM records with REAL (=/X/I/D) CIGARs.

Reference: alignCords (src/align_interface.cpp:2527-2977) over SeqAn's
banded globalAlignment, band merging (mergeCordsBands,
src/align_bands.cpp:267-285), head/tail clipping (:603-730) and overlap
stitching (merge_align_, :731-1111). The reference CLI never reaches
this code (-a is commented out of its parser, src/args_parser.cpp:214),
so there is no reference output to be bit-identical to; this module is a
re-design validated by the base-level CIGAR replay audit
(tests/cigar_audit.py) — the same oracle the reference's own
check_cigar (src/test_units.cpp:14-164) implements.

Design:
  - colinear adjacent same-strand cords merge into ONE band region
    (mergeCordsBands' LineSegment/isColinear test) — fewer, longer
    windows cut total DP area;
  - each region runs a banded semi-global DP. The batch SCORE pass is
    the Pallas wavefront kernel (ops.align_pallas.banded_align_scores)
    on device; the traceback runs here with a vectorized banded DP
    (decayed-prefix-max row recurrence, same one the kernel uses);
  - consecutive regions of a record stitch by trimming the next
    region's alignment back to the previous end (merge_align_'s
    overlap reconciliation, simplified to prefix trimming) and
    bridging residual dx/dy with D/I;
  - record boundaries (chimeric splits, supplementary flags, leading
    soft clips) reuse the cords2bamlink conventions so the SAM/BAM
    emission path is shared.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..out.bamlink import (BAM_FLAG_RVCMP, BAM_FLAG_SUPPL, BamLinkRecord,
                           Cigar, if_create_new)
from ..utils.cordscalar import cid, cx, cy, is_end, strand

from ..ops.align_pallas import S_GAP, S_MATCH, S_MISMATCH

NEG = -(1 << 30)


def banded_align_cigar_fast(q: np.ndarray, r: np.ndarray, W: int = 128):
    """Banded semi-global DP with stored band rows for traceback,
    vectorized per row (the serial in-row gap chain resolves to a
    decayed prefix max). Same scores/semantics as
    ops.align_pallas.banded_align_cigar; ~100x faster on long regions.
    Returns (score, [(count, op)...], (q0, q1), (r0, r1))."""
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return 0, [], (0, 0), (0, 0)
    width = 2 * W + 1
    # banded storage: Hb[i, k] = H[i, j] with j = i - W + k
    Hb = np.full((n + 1, width), NEG, dtype=np.int32)
    offs = np.arange(width) - W  # j - i
    j0 = np.arange(1, n + 1)[:, None] + offs[None, :]
    # row 0: H[0, j] = 0 for j in [0, m]
    j_row0 = offs  # i = 0
    Hb[0, (j_row0 >= 0) & (j_row0 <= m)] = 0
    rext = np.concatenate([r.astype(np.int16),
                           np.full(max(n - m, 0) + W + 2, -1, np.int16)])
    ks = np.arange(width)
    g = -S_GAP  # positive gap penalty
    for i in range(1, n + 1):
        jj = i - W + ks  # j values of this row
        valid = (jj >= 1) & (jj <= m)
        # diag: H[i-1, j-1] -> Hb[i-1, k] ; up: H[i-1, j] -> Hb[i-1, k+1]
        diag = Hb[i - 1]
        up = np.concatenate([Hb[i - 1, 1:], [NEG]])
        sub = np.where(q[i - 1] == rext[np.maximum(jj - 1, 0)], S_MATCH,
                       S_MISMATCH)
        cand = np.maximum(diag + sub, up + S_GAP)
        if i <= W:
            cand[W - i] = 0  # H[i, 0] = 0 boundary (free begin)
        # left chain: H[i,j] = max over k' <= k of cand[k'] - g*(k - k')
        #           = max.accumulate(cand + g*k') - g*k
        run = np.maximum.accumulate(cand + g * ks)
        row = np.maximum(cand, run - g * ks)
        row[~valid & (jj != 0)] = NEG
        if i <= W:
            row[W - i] = 0
        Hb[i] = row
    # free end: best over last row (j in [0, m]) and last column (j = m)
    jj_n = n - W + np.arange(width)
    last_row = np.where((jj_n >= 0) & (jj_n <= m), Hb[n], NEG)
    kr = int(np.argmax(last_row))
    besti, bestj = n, int(jj_n[kr])
    best = int(last_row[kr])
    km = m - np.arange(1, n + 1) + W
    ok = (km >= 0) & (km < width)
    col = np.where(ok, Hb[1:][np.arange(n), np.clip(km, 0, width - 1)], NEG)
    kc = int(np.argmax(col))
    if int(col[kc]) > best:
        best = int(col[kc])
        besti, bestj = kc + 1, m
    i, j = besti, bestj

    def H(i_, j_):
        k_ = j_ - i_ + W
        if i_ < 0 or j_ < 0 or k_ < 0 or k_ >= width:
            return NEG
        if j_ == 0 or i_ == 0:
            return 0
        return int(Hb[i_, k_])

    ops: List[str] = []
    while i > 0 and j > 0:
        s_ = S_MATCH if q[i - 1] == r[j - 1] else S_MISMATCH
        h = H(i, j)
        if h == H(i - 1, j - 1) + s_:
            ops.append("=" if s_ == S_MATCH else "X")
            i -= 1
            j -= 1
        elif h == H(i - 1, j) + S_GAP:
            ops.append("I")
            i -= 1
        elif h == H(i, j - 1) + S_GAP:
            ops.append("D")
            j -= 1
        else:  # boundary re-entry
            break
    ops.reverse()
    cig: List[List] = []
    for op in ops:
        if cig and cig[-1][1] == op:
            cig[-1][0] += 1
        else:
            cig.append([1, op])
    return best, [(c, o) for c, o in cig], (i, besti), (j, bestj)


def _is_colinear(c1s: int, c2s: int, band: int) -> bool:
    """isColinear (src/align_bands.cpp:69-87): same strand and the 45deg
    band lines within band/2 of each other."""
    if strand(c1s ^ c2s):
        return False
    d1 = cx(c1s) - cy(c1s)
    d2 = cx(c2s) - cy(c2s)
    return abs(d1 - d2) <= band // 2


def merge_cords_bands(cords_str: List[int], cords_end: List[int],
                      lo: int, hi: int, band: int) -> List[Tuple[int, int]]:
    """mergeCordsBands1 (src/align_bands.cpp:194-266): group cords
    [lo, hi) into maximal colinear runs; returns (start, end) index
    ranges."""
    runs: List[Tuple[int, int]] = []
    s = lo
    for i in range(lo + 1, hi):
        if not _is_colinear(cords_str[s], cords_str[i], band):
            runs.append((s, i))
            s = i
    runs.append((s, hi))
    return runs


def _advance_cigar(cig: List[Tuple[int, str]], min_q: int, min_r: int
                   ) -> Tuple[List[Tuple[int, str]], int, int]:
    """Trim the alignment's PREFIX until the trimmed (q, r) advance
    reaches at least (min_q, min_r) — the overlap-reconciliation half of
    merge_align_ (src/align_interface.cpp:731-1111) reduced to prefix
    clipping. Over-trimming on one axis is safe (the caller bridges any
    residual with I/D). Returns (remaining_cigar, q_trimmed, r_trimmed)."""
    out: List[Tuple[int, str]] = []
    q = r = 0
    for cnt, op in cig:
        if q >= min_q and r >= min_r:
            out.append((cnt, op))
            continue
        dq = op in ("=", "X", "I")
        dr = op in ("=", "X", "D")
        if dq and dr:
            need = max(min_q - q, min_r - r)
        elif dq:
            # I while the genome axis is still short cannot help: drop whole
            need = (min_q - q) if r >= min_r else cnt
        else:
            need = (min_r - r) if q >= min_q else cnt
        cut = min(cnt, max(need, 0))
        q += cut if dq else 0
        r += cut if dr else 0
        rem = cnt - cut
        if rem > 0:
            if q >= min_q and r >= min_r:
                out.append((rem, op))
            else:  # the other axis still short: drop the remainder too
                q += rem if dq else 0
                r += rem if dr else 0
    return out, q, r


def align_cords(genomes: List[np.ndarray], read: np.ndarray,
                rc: np.ndarray, cords_str: List[int], cords_end: List[int],
                band: int = 100, block_size: int = 96,
                thd_min_score: int = 40,
                thd_large_X: int = 8000) -> List[BamLinkRecord]:
    """alignCords: per record-run (cords2bamlink boundary rules), merge
    colinear cords into band regions, align each, stitch, emit linked
    records with real CIGARs."""
    n = len(cords_str)
    if n < 2:
        return []
    records: List[BamLinkRecord] = []
    # partition cords [1, n) into record runs with the SAME boundary rule
    # as cords2bamlink (if_create_new: block ends, non-monotone, large
    # discordance, strand flips)
    runs: List[Tuple[int, int]] = []
    s = 1
    for i in range(1, n):
        if i == n - 1 or if_create_new(cords_str[i], cords_end[i],
                                       cords_str[i + 1], cords_end[i + 1],
                                       thd_large_X):
            runs.append((s, i + 1))
            s = i + 1
    first = True
    for lo, hi in runs:
        std = strand(cords_str[lo])
        gid = cid(cords_str[lo])
        g = genomes[gid]
        qseq = rc if std else read
        regions = merge_cords_bands(cords_str, cords_end, lo, hi, band)
        rec = BamLinkRecord(
            rID=gid,
            flag=(0 if first else BAM_FLAG_SUPPL)
            | (BAM_FLAG_RVCMP if std else 0),
        )
        cig: List[Tuple[int, str]] = []
        q_cur = r_cur = None  # global cursors (read/genome coords)
        score_sum = 0
        for rs, re_ in regions:
            gx0 = cx(cords_str[rs])
            gx1 = min(cx(cords_end[re_ - 1]), len(g))
            qy0 = cy(cords_str[rs])
            qy1 = min(cy(cords_end[re_ - 1]), len(qseq))
            if gx1 <= gx0 or qy1 <= qy0:
                continue
            score, rcig, (a0, a1), (b0, b1) = banded_align_cigar_fast(
                qseq[qy0:qy1], g[gx0:gx1], W=band)
            if not rcig or score < thd_min_score:
                # poorly aligned region: fall back to the apx rectangle
                # (the reference drops these windows and re-aligns via
                # GapRecords; the rectangle keeps coordinates consistent)
                dq, dr = qy1 - qy0, gx1 - gx0
                d = min(dq, dr)
                rcig = [(d, "X")]
                if dq > d:
                    rcig.append((dq - d, "I"))
                if dr > d:
                    rcig.append((dr - d, "D"))
                a0, a1, b0, b1 = 0, dq, 0, dr
                score = 0
            score_sum += score
            q_s, q_e = qy0 + a0, qy0 + a1
            r_s, r_e = gx0 + b0, gx0 + b1
            if q_cur is None:
                rec.beginPos = r_s
                if q_s:
                    cig.append((q_s, "S"))
                q_cur, r_cur = q_s, r_s
            else:
                if q_s < q_cur or r_s < r_cur:
                    # overlap with the previous region's alignment: trim
                    # this region's prefix back to the previous end
                    rcig, q_adv, r_adv = _advance_cigar(
                        rcig, max(q_cur - q_s, 0), max(r_cur - r_s, 0))
                    q_s += q_adv
                    r_s += r_adv
                if q_s > q_cur:
                    cig.append((q_s - q_cur, "I"))
                if r_s > r_cur:
                    cig.append((r_s - r_cur, "D"))
                q_cur, r_cur = q_s, r_s
            for cnt, op in rcig:
                if cig and cig[-1][1] == op:
                    cig[-1] = (cig[-1][0] + cnt, op)
                else:
                    cig.append((cnt, op))
                if op in ("=", "X", "I"):
                    q_cur += cnt
                if op in ("=", "X", "D"):
                    r_cur += cnt
        if q_cur is None:
            continue
        if q_cur < len(qseq):  # trailing soft clip: full read consumption
            cig.append((len(qseq) - q_cur, "S"))
        rec.cigar = [Cigar(op, cnt) for cnt, op in cig if cnt > 0]
        rec.score.s1 = score_sum
        records.append(rec)
        first = False
    # link records of the same read into a chain (SA:Z supplementaries)
    for k in range(len(records) - 1):
        records[k].next_id = -1  # separate lines (chimeric records)
    return records
