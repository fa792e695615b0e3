"""Double-strand canonical (span,weight) minimizer hashing.

Re-derivation of the reference's LShape rolling hash (src/shape_extend.cpp):

  - hValue   = polynomial hash of the forward window  sum b[j+i]*4^(span-1-i)
  - crhValue = polynomial hash of the reverse complement = sum (3-b[j+i])*4^i
  - x        = 2*(window base-code sum) - 3*span (+ a stream-specific init
               bias, see below); canonical strand = forward iff x > 0
  - XValue   = min over the span-weight+1 weight-mers inside the canonical
               k-mer (first minimum wins)
  - YValue   = the 4 bases adjacent to the chosen weight-mer, 2-bit packed

The C++ computes these with sequential per-base recurrences; here all
window positions are computed directly (closed forms). Two quirks of the
sequential code are reproduced exactly because output identity depends on
them:

  1. Read streams call hashInit at position 0 but start rolling at
     j = read_str + span, so (a) `x` carries a permanent init bias
     2*(sum b[0..span-2] - sum b[read_str+span .. read_str+2*span-2]) and
     (b) the first span-1 call positions mix leftover init-window bases with
     appended bases. (reference: getDIndexMatchAll src/pmpfinder.cpp:1871)
  2. Genome streams (index build) call hashInit at t_str and roll from
     j = t_str, which telescopes cleanly to pure window functions.
     (reference: createDIndex src/index_util.cpp:1737)

N bases (code 4) pollute the 2-bit lanes through carries in the C++; the
vectorized closed forms here are exact for N-free windows and the sequential
oracle (`HashStream`) is exact always. Windows near N are patched with the
oracle when requested.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U64 = np.uint64


def mask_bits(b: int) -> int:
    return (1 << b) - 1


class HashStream:
    """Exact scalar emulation of LShape hashInit/hashNexth/hashNextX.

    This is the correctness oracle; it mirrors the C++ statement-for-statement
    semantics (including N carries and uint64 wraparound).
    """

    def __init__(self, span: int = 25, weight: int | None = None):
        self.span = span
        self.weight = span - 8 if weight is None else weight
        self.h = 0
        self.crh = 0
        self.x = 0
        self.left = 0
        self.strand = 0
        self.xval = 0
        self.yval = 0

    def init(self, seq: np.ndarray, it: int) -> int:
        """hashInit (src/shape_extend.cpp:86): find first span consecutive
        non-N from `it`, pre-roll span-1 bases. Returns the skip k, or -1 if
        no valid window exists to the end of the sequence (the C++ scans past
        the buffer there — UB; observed behavior is no usable output, which
        this deterministic sentinel reproduces)."""
        s = self.span
        self.left = 0
        self.h = 0
        self.crh = 0
        self.x = 0 - 3
        k = 0
        count = 0
        n = len(seq)
        while count < s:
            if it + k + count >= n:
                return -1
            if seq[it + k + count] == 4:
                k += count + 1
                count = 0
            else:
                count += 1
        bit = 2
        for i in range(s - 1):
            val = int(seq[it + k + i])
            self.x += (val << 1) - 3
            self.h = ((self.h << 2) + val) & mask_bits(64)
            self.crh = (self.crh + ((3 - val) << bit)) & mask_bits(64)
            bit += 2
        return k

    def nexth(self, seq: np.ndarray, it: int) -> int:
        """hashNexth (src/shape_extend.cpp:173)."""
        s = self.span
        mask = mask_bits(2 * s - 2)
        v2 = int(seq[it + s - 1])
        self.h = (((self.h & mask) << 2) + v2) & mask_bits(64)
        self.crh = (((self.crh >> 2) & mask) + (((3 - v2) & mask_bits(64)) << (2 * s - 2))) & mask_bits(64)
        self.x += (v2 - self.left) << 1
        self.left = int(seq[it])
        return self.h if self.x < 0 else self.crh

    def next_full(self, seq: np.ndarray, it: int) -> int:
        """hashNext (src/shape_extend.cpp:132-168): rolls h/crh/x AND
        computes XValue/strand plus the FULL remainder-encoded YValue
        (hashNextXY semantics, not nextx's 4-adjacent-bases YValue).
        Used by the HIndex build stream (__createHsArray)."""
        s, w = self.span, self.weight
        span2, weight2 = 2 * s, 2 * w
        mask = mask_bits(span2 - 2)
        v2 = int(seq[it + s - 1])
        self.h = (((self.h & mask) << 2) + v2) & mask_bits(64)
        self.crh = (((self.crh >> 2) & mask)
                    + (((3 - v2) & mask_bits(64)) << (span2 - 2))) & mask_bits(64)
        self.xval = mask_bits(span2)
        self.x += (v2 - self.left) << 1
        self.left = int(seq[it])
        if self.x > 0:
            v = self.h
            self.strand = 0
        else:
            v = self.crh
            self.strand = 1
        t = 0
        for k in range(64 - span2, 64 - weight2 + 1, 2):
            v1 = ((v << k) & mask_bits(64)) >> (64 - weight2)
            if self.xval > v1:
                self.xval = v1
                t = k
        self.yval = (((v >> (64 - t)) << (64 - t - weight2))
                     + (v & mask_bits(64 - t - weight2))
                     + (t << (span2 - weight2 - 1)))
        return self.xval

    def nextx(self, seq: np.ndarray, it: int) -> int:
        """hashNextX = hashNextXX + hashNextXY2 (src/shape_extend.cpp:341)."""
        s, w = self.span, self.weight
        span2, weight2 = 2 * s, 2 * w
        v2 = self.h if self.x > 0 else self.crh
        self.strand = 0 if self.x > 0 else 1
        xval = mask_bits(span2)
        t = 0
        for k in range(64 - span2, 64 - weight2 + 1, 2):
            v1 = ((v2 << k) & mask_bits(64)) >> (64 - weight2)
            if xval > v1:
                xval = v1
                t = k
        self.xval = xval
        # YValue: 4 bases adjacent to the chosen weight-mer
        yval = 0
        n = 4
        if self.x > 0:
            d_it = (t >> 1) + s + w - 32
            for i in range(d_it, d_it + n):
                val = int(seq[it + i]) if 0 <= it + i < len(seq) else 0
                yval = (yval << 2) if val > 3 else (yval << 2) + val
        else:
            d_it = -(t >> 1) - w + 31
            for i in range(d_it, d_it - n, -1):
                val = 3 - (int(seq[it + i]) if 0 <= it + i < len(seq) else 0)
                yval = (yval << 2) if val < 0 else (yval << 2) + val
        self.yval = yval
        return xval


def _window_poly_u64(seq: np.ndarray, span: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized forward/revcomp polynomial hashes for every window start
    j in [0, len(seq)-span]. Exact for N-free windows.

    Logarithmic doubling: h_{a+b}[j] = (h_a[j] << 2b) + h_b[j+a] and
    crh_{a+b}[j] = crh_a[j] + (crh_b[j+a] << 2a) — O(log span) full-array
    passes instead of O(span). Base values <= 4 keep every partial sum far
    below 2^64, so the reassociation is exact (wrap-free)."""
    b = seq.astype(np.uint64)
    n = len(seq) - span + 1
    if n <= 0:
        return np.zeros(0, U64), np.zeros(0, U64)
    three = np.uint64(3)
    # powers-of-two building blocks, largest first
    h_k = {1: b}
    crh_k = {1: (three - b)}  # wraps for N, same as C++ uint64
    k = 1
    while 2 * k <= span:
        hk, ck = h_k[k], crh_k[k]
        m = len(hk) - k
        h_k[2 * k] = (hk[:m] << U64(2 * k)) + hk[k:]
        crh_k[2 * k] = ck[:m] + (ck[k:] << U64(2 * k))
        k *= 2
    # compose span from its binary decomposition, MSB block first
    h = None
    crh = None
    done = 0
    for bit in range(k.bit_length() - 1, -1, -1):
        blk = 1 << bit
        if not (span & blk):
            continue
        hb = h_k[blk]
        cb = crh_k[blk]
        if h is None:
            h, crh = hb, cb
        else:
            m = min(len(h), len(hb) - done)
            h = (h[:m] << U64(2 * blk)) + hb[done: done + m]
            crh = crh[:m] + (cb[done: done + m] << U64(2 * done))
        done += blk
    return h[:n], crh[:n]


def _window_sum(seq: np.ndarray, span: int) -> np.ndarray:
    c = np.concatenate([[0], np.cumsum(seq.astype(np.int64))])
    return c[span:] - c[: len(seq) - span + 1]


def minimizer_xy(
    seq: np.ndarray,
    j: np.ndarray,
    h: np.ndarray,
    crh: np.ndarray,
    x: np.ndarray,
    span: int,
    weight: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized hashNextX for positions `j` with hash states (h, crh, x).

    Returns (xval, yval, strand). Out-of-range YValue bases read as 'A' (0),
    matching zero-initialized memory past SeqAn buffers (see module note).
    """
    span2, weight2 = 2 * span, 2 * weight
    v2 = np.where(x > 0, h, crh)
    n_off = span - weight + 1
    xval = np.full(len(j), mask_bits(span2), dtype=U64)
    t = np.zeros(len(j), dtype=np.int64)
    for idx in range(n_off):
        k = 64 - span2 + 2 * idx
        v1 = (v2 << U64(k)) >> U64(64 - weight2)
        better = v1 < xval
        xval = np.where(better, v1, xval)
        t = np.where(better, k, t)
    # YValue
    strand = (x <= 0).astype(np.int64)
    joff = (t >> 1) - 32 + span  # chosen weight-mer offset within the window
    yval = np.zeros(len(j), dtype=np.int64)
    padded = np.concatenate([seq.astype(np.int64), np.zeros(span + 8, np.int64)])
    fwd_base = j + joff + weight
    rev_base = j + span - joff - weight - 1
    for i in range(4):
        vf = padded[np.minimum(fwd_base + i, len(padded) - 1)]
        vr = 3 - padded[np.maximum(rev_base - i, 0)]
        val = np.where(strand == 0, vf, vr)
        add = np.where((val >= 0) & (val <= 3), val, 0)
        yval = (yval << 2) + add
    return xval.astype(np.int64), yval, strand


def minimizer_x_yfull(
    h: np.ndarray, crh: np.ndarray, x: np.ndarray, span: int, weight: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized hashNext X/Y tail (src/shape_extend.cpp:146-167): XValue
    minimizer plus the FULL remainder-encoded YValue (hashNextXY formula),
    as stored by the HIndex build. Returns (xval, yval, strand)."""
    span2, weight2 = 2 * span, 2 * weight
    v2 = np.where(x > 0, h, crh)
    strand = (x <= 0).astype(np.int64)
    xval = np.full(len(h), mask_bits(span2), dtype=U64)
    t = np.zeros(len(h), dtype=np.int64)
    for idx in range(span - weight + 1):
        k = 64 - span2 + 2 * idx
        v1 = (v2 << U64(k)) >> U64(64 - weight2)
        better = v1 < xval
        xval = np.where(better, v1, xval)
        t = np.where(better, k, t)
    tu = t.astype(U64)
    rem_bits = U64(64) - tu - U64(weight2)
    yval = (
        ((v2 >> (U64(64) - tu)) << rem_bits)
        + (v2 & ((U64(1) << rem_bits) - U64(1)))
        + (tu << U64(span2 - weight2 - 1))
    )
    return xval.astype(np.int64), yval.astype(np.int64), strand


@dataclass
class StreamHashes:
    """Per-position hash states for a hash stream over one sequence."""

    j: np.ndarray  # call positions
    h: np.ndarray
    crh: np.ndarray
    x: np.ndarray


def genome_stream_hashes(seq: np.ndarray, t_str: int, t_end: int, span: int,
                         polys: tuple | None = None) -> StreamHashes:
    """Hash states for the index-build stream: hashInit at t_str, calls at
    j in [t_str, t_end). Telescopes to pure window functions (window [j, j+span)).

    Exact for N-free windows; callers needing N-exactness patch with HashStream.
    polys: optional precomputed (h_all, crh_all, ws) from window_polys() —
    callers iterating thread chunks over one genome compute them once.
    """
    j = np.arange(t_str, t_end, dtype=np.int64)
    if len(j) == 0:
        return StreamHashes(j, np.zeros(0, U64), np.zeros(0, U64), np.zeros(0, np.int64))
    h_all, crh_all, ws = polys if polys is not None else window_polys(seq, span)
    h = h_all[j]
    crh = crh_all[j]
    x = 2 * ws[j] - 3 * span
    return StreamHashes(j, h, crh, x)


def window_polys(seq: np.ndarray, span: int) -> tuple:
    """(h_all, crh_all, window_sums) for every window start of seq."""
    h_all, crh_all = _window_poly_u64(seq, span)
    return h_all, crh_all, _window_sum(seq, span)


def read_stream_hashes(
    seq: np.ndarray, read_str: int, read_end: int, span: int
) -> StreamHashes:
    """Hash states for the read-query stream: hashInit at 0, calls at
    j in [read_str+span, read_end-span) (reference: getDIndexMatchAll).

    Reproduces the init bias on `x` and the mixed windows of the first
    span-1 calls exactly (via the scalar oracle for those few positions).
    """
    return read_stream_hashes_range(seq, read_str + span, read_end - span, span)


def read_stream_hashes_range(
    seq: np.ndarray, first: int, last: int, span: int
) -> StreamHashes:
    """read_stream_hashes with an explicit call range [first, last):
    hashInit at 0, hashNexth at each j in the range. Used by the SIndex
    query stream (getSIndexMatchAll, src/pmpfinder.cpp:1797: calls start
    at read_str itself, not read_str+span)."""
    j = np.arange(first, last, dtype=np.int64)
    if len(j) <= 0:
        return StreamHashes(
            np.zeros(0, np.int64), np.zeros(0, U64), np.zeros(0, U64), np.zeros(0, np.int64)
        )
    h_all, crh_all = _window_poly_u64(seq, span)
    ws = _window_sum(seq, span)
    # x bias: init window [k0, k0+span-1) vs removed prefix [first, first+span-1)
    # (derivation in module docstring; exact when k0 == 0)
    has_leading_n = np.any(seq[: span] == 4)
    k0 = 0
    if has_leading_n:
        st = HashStream(span)
        k0 = st.init(seq, 0)
        if k0 < 0:  # no valid window anywhere: stream yields nothing
            return StreamHashes(
                np.zeros(0, np.int64), np.zeros(0, U64), np.zeros(0, U64), np.zeros(0, np.int64)
            )
    bias = 2 * (
        int(seq[k0 : k0 + span - 1].astype(np.int64).sum())
        - int(seq[first : first + span - 1].astype(np.int64).sum())
    )
    h = h_all[np.minimum(j, len(h_all) - 1)].copy()
    crh = crh_all[np.minimum(j, len(crh_all) - 1)].copy()
    x = 2 * ws[np.minimum(j, len(ws) - 1)] - 3 * span + bias
    # first span-1 calls have mixed windows: emulate exactly
    n_mixed = min(span - 1, len(j))
    if n_mixed > 0:
        st = HashStream(span)
        st.init(seq, 0)
        for c in range(n_mixed):
            st.nexth(seq, int(j[c]))
            h[c] = st.h
            crh[c] = st.crh
            x[c] = st.x
    return StreamHashes(j, h, crh, x)


def patch_n_neighborhoods(
    seq: np.ndarray, sh: StreamHashes, span: int, stream: str, read_str: int = 0
) -> None:
    """Replace closed-form states with exact oracle values for call positions
    whose exactness could be affected by an N. Returns False when no valid
    hash window exists from the init point (caller must drop the stream).

    The closed forms deviate from the C++ recurrences only while an N is
    inside (or recently left) the rolling window, and the recurrence state
    re-synchronizes with the closed form after `span` N-free steps. So each
    N neighborhood is re-rolled locally, seeded from the closed form.
    Exception: an N within the init window changes `x` permanently (init
    skip); in that case the whole stream is re-rolled (rare, bounded cost).
    """
    if not np.any(seq == 4) or len(sh.j) == 0:
        return True
    first_j = int(sh.j[0])
    j0_off = first_j  # sh arrays are indexed by (j - first_j)

    def run_exact(j_from: int, j_to: int, st: "HashStream") -> None:
        for jj in range(j_from, j_to):
            st.nexth(seq, jj)
            idx = jj - j0_off
            if 0 <= idx < len(sh.j):
                sh.h[idx] = st.h
                sh.crh[idx] = st.crh
                sh.x[idx] = st.x

    init_at = first_j if stream == "genome" else 0
    init_has_n = np.any(seq[init_at : init_at + 2 * span] == 4)
    last_j = int(sh.j[-1])
    if init_has_n:
        st = HashStream(span)
        if st.init(seq, init_at) < 0:
            return False  # no valid window from init point: drop stream
        run_exact(first_j, last_j + 1, st)
        return True
    n_pos = np.flatnonzero(seq == 4)
    # merge N positions into segments affecting call range [p-span+1, p+span]
    segs: list[list[int]] = []
    for p in n_pos.tolist():
        lo, hi = p - span + 1, p + span
        if segs and lo - 3 * span <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], hi)
        else:
            segs.append([lo, hi])
    mixed_end = first_j + span  # read streams: first span-1 calls are mixed
    for lo, hi in segs:
        j_from = max(first_j, lo - span)
        j_to = min(last_j + 1, hi + 1)
        if j_to <= j_from:
            continue
        st = HashStream(span)
        if j_from <= mixed_end and stream == "read":
            if st.init(seq, 0) < 0:
                return False
            j_from = first_j
        elif j_from == first_j:
            if st.init(seq, init_at) < 0:
                return False
        else:
            # seed from the (exact) closed form one step before j_from
            jprev = j_from - 1
            h_all, crh_all = _window_poly_u64(seq[jprev : jprev + span], span)
            st.h = int(h_all[0])
            st.crh = int(crh_all[0])
            st.x = 2 * int(seq[jprev : jprev + span].astype(np.int64).sum()) - 3 * span
            if stream == "read":
                st.x += _read_x_bias(seq, first_j, span)
            st.left = int(seq[jprev])
        run_exact(j_from, j_to, st)
    return True


def _read_x_bias(seq: np.ndarray, first_call: int, span: int) -> int:
    """Permanent x bias of a read stream (hashInit at 0, rolling from
    first_call): 2*(sum of init window bases - sum of first removed bases)."""
    st = HashStream(span)
    k0 = st.init(seq, 0) if np.any(seq[:span] == 4) else 0
    if k0 < 0:
        return 0
    return 2 * (
        int(seq[k0 : k0 + span - 1].astype(np.int64).sum())
        - int(seq[first_call : first_call + span - 1].astype(np.int64).sum())
    )


def emit_mask_index(xvals: np.ndarray, stride: int, max_step: int) -> np.ndarray:
    """Vectorized emission/dedup rule of the index build sampling loop
    (reference: createDIndex src/index_util.cpp:1737-1781):

      emit iff XValue != last-emitted XValue or j - last_emitted_j > max_step

    at sample stride `stride`. Within a run of equal consecutive XValues this
    emits every q-th sample, q = floor(max_step/stride) + 1; run starts always
    emit. Defaults (stride 9, max_step 10) give q = 2.
    """
    n = len(xvals)
    if n == 0:
        return np.zeros(0, dtype=bool)
    q = max_step // stride + 1
    run_start = np.ones(n, dtype=bool)
    run_start[1:] = xvals[1:] != xvals[:-1]
    idx = np.arange(n)
    start_idx = np.where(run_start, idx, 0)
    start_idx = np.maximum.accumulate(start_idx)
    return ((idx - start_idx) % q) == 0


def dedup_mask_query(xvals: np.ndarray) -> np.ndarray:
    """Query-side dedup (reference: getDIndexMatchAll): process a sampled
    position iff its XValue differs from the previous sampled XValue
    (xpre initialized to 0)."""
    n = len(xvals)
    if n == 0:
        return np.zeros(0, dtype=bool)
    out = np.ones(n, dtype=bool)
    out[0] = xvals[0] != 0
    out[1:] = xvals[1:] != xvals[:-1]
    return out
