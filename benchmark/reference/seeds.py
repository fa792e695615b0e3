"""The anchors of one N-free read against a DIndex (getDIndexMatchAll,
src/pmpfinder.cpp:1856-1913), worked out from the read's codes.

The read's hash stream starts with hashInit at 0 and rolls from j = 21;
every 15th call, j = 35 + 15p with j < len - 21, takes the minimizer
(XValue, YValue, strand). At p = 0 the rolling window still holds
b[14 .. 20) followed by b[41 .. 56); later windows are b[j .. j + 21).
x carries the permanent init bias 2 * (sum b[0 .. 20) - sum b[21 .. 41)).
A position is probed when its XValue differs from the previous position's
(0 before the first). Every entry of bucket XValue whose YValue differs
from the position's in at most one 2-bit group ((y1 ^ y2) >> ctz < 4)
gives an anchor (val2Anchor, src/index_util.cpp:1509, with uint64
wraparound and the strand bit 61 set where the strands differ), in
position order, then bucket order. `probed` counts the bucket entries of
the probed positions before the YValue check.
"""
from __future__ import annotations

import numpy as np

from .dindex import SPAN, HashStream, minimizer_xy, padded_codes

U64 = np.uint64
THD_ALPHA = 15
FIRST = SPAN + THD_ALPHA - 1
MASK_Y = U64((1 << 20) - 1)
FLAG_STRAND = U64(1 << 61)


def read_states(read: np.ndarray):
    """(positions k, xval, yval, strand) of the read's sampled calls."""
    n = len(read)
    k = np.arange(FIRST, n - SPAN, THD_ALPHA, dtype=np.int64)
    if not len(k):
        z = np.zeros(0, np.int64)
        return z, z, z, z
    b = read.astype(U64)
    h = np.zeros(len(k), dtype=U64)
    crh = np.zeros(len(k), dtype=U64)
    for i in range(SPAN):
        v = b[k + i]
        h = (h << U64(2)) + v
        crh += (U64(3) - v) << U64(2 * i)
    c = np.concatenate([[0], np.cumsum(read.astype(np.int64))])
    bias = 2 * (int(c[SPAN - 1]) - int(c[2 * SPAN - 1] - c[SPAN]))
    x = 2 * (c[k + SPAN] - c[k]) - 3 * SPAN + bias
    st = HashStream()
    st.init(read, 0)
    for j in range(SPAN, FIRST + 1):
        st.nexth(read, j)
    h[0], crh[0], x[0] = U64(st.h), U64(st.crh), st.x
    xv, yv, s = minimizer_xy(padded_codes(read), k, np.where(x > 0, h, crh),
                             x)
    return k, xv, yv, s


def anchors(read: np.ndarray, dirp: np.ndarray, hs: np.ndarray):
    """(anchors uint64 in emission order, probed)."""
    k, xv, yv, s = read_states(read)
    if not len(k):
        return np.zeros(0, U64), 0
    prev = np.concatenate([[0], xv[:-1]])
    p = xv != prev
    k, xv, yv, s = k[p], xv[p], yv[p], s[p]
    lo = dirp[xv].astype(np.int64)
    cnt = dirp[xv + 1].astype(np.int64) - lo
    probed = int(cnt.sum())
    if not probed:
        return np.zeros(0, U64), 0
    pos = np.repeat(np.arange(len(k)), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ent = hs[np.repeat(lo, cnt) + np.arange(probed) - first]
    ent_y = ent & MASK_Y
    val = ent_y ^ yv[pos].astype(U64)
    low = val & (~val + U64(1))
    ok = (val == 0) | (val < (low << U64(2)))
    ent, ent_y, pos = ent[ok], ent_y[ok], pos[ok]
    same = ((ent >> U64(61)) & U64(1)).astype(np.int64) == s[pos]
    kk = k[pos]
    cordy = np.where(same, kk, len(read) - 1 - kk).astype(U64)
    anc = ent - (cordy << U64(20)) + cordy - ent_y
    anc = np.where(same, anc & ~FLAG_STRAND, anc | FLAG_STRAND)
    return anc, probed
