"""The DIndex of a genome, worked out from its codes (createDIndex,
src/index_util.cpp:1628-1803, as the port's native builder and device
build make it), exactly, N bases included.

Per genome and per block t of `threads` (bounds[t] = len // threads * t,
bounds[threads] = len - 21; block t scans [bounds[t] + 21, bounds[t+1] - 21)),
the rolling hash starts with hashInit at the block start (skipping to the
first N-free 21-base window, k bases on) and rolls through every position,
N bases included, which carry through its 2-bit lanes. Its states at a
position j are functions of the window b[j .. j + 21), worked out here in
closed form:

  h   = 4 * (P20(j) mod 2^40) + b[j + 20],  P20(j) = sum b[j+i] 4^(19-i)
  crh = sum_{i<20} ((3 - b[j+i]) & 3) << 2i  +  ((3 - b[j+20]) mod 2^64) << 40
  x   = 2 * sum b[j .. j+21) - 63 + 2 * (sum b[s+k .. s+k+20) - sum b[s .. s+20))

(s the block start), save for the first 20 positions of a block whose
hashInit skipped (k > 0): there the states mix the init window with
appended bases, and the scalar emulation below rolls them. Samples sit at
j = s + 8 + 9i; a sample is emitted when its XValue differs from the last
emitted one or lies more than 10 positions after it (within a run of equal
XValues every second sample); buckets of more than 400 emitted samples
are dropped; dir is the exclusive prefix sum of the kept counts (int32,
4^13 + 1) and hs the kept cords ((gid << 30 | j + 2^20) << 20 | YValue,
strand at bit 61) ordered by (XValue, cord).
"""
from __future__ import annotations

import numpy as np

SPAN = 21
WEIGHT = 13
MIN_STEP = 8
MAX_STEP = 10
OMIT_BLOCK = 400
ANCHOR_ZERO = 1 << 20
N_BUCKETS = 1 << (2 * WEIGHT)
U64 = np.uint64
M40 = (1 << 40) - 1
M64 = (1 << 64) - 1


class HashStream:
    """Scalar hashInit / hashNexth / hashNextX (src/shape_extend.cpp), for
    the few mixed positions; a frozen copy of the port's ops.hashing
    HashStream, reduced to what the DIndex uses."""

    def __init__(self):
        self.h = self.crh = self.x = self.left = 0

    def init(self, seq, it: int) -> int:
        """hashInit at it; returns the skip k, or -1 where no N-free
        window is left."""
        k = count = 0
        n = len(seq)
        while count < SPAN:
            if it + k + count >= n:
                return -1
            if seq[it + k + count] == 4:
                k += count + 1
                count = 0
            else:
                count += 1
        self.init_at(seq, it + k)
        return k

    def init_at(self, seq, w: int) -> None:
        """hashInit's pre-roll of the N-free window starting at w."""
        self.left, self.h, self.crh, self.x = 0, 0, 0, -3
        bit = 2
        for i in range(SPAN - 1):
            val = int(seq[w + i])
            self.x += (val << 1) - 3
            self.h = ((self.h << 2) + val) & M64
            self.crh = (self.crh + ((3 - val) << bit)) & M64
            bit += 2

    def nexth(self, seq, it: int) -> None:
        s = SPAN
        mask = (1 << (2 * s - 2)) - 1
        v2 = int(seq[it + s - 1])
        self.h = (((self.h & mask) << 2) + v2) & M64
        self.crh = (((self.crh >> 2) & mask)
                    + (((3 - v2) & M64) << (2 * s - 2))) & M64
        self.x += (v2 - self.left) << 1
        self.left = int(seq[it])


def thread_blocks(n: int, threads: int):
    bounds = [n // threads * t for t in range(threads)] + [n - SPAN]
    return [(bounds[t] + SPAN, bounds[t + 1] - SPAN) for t in range(threads)]


def _init_skip(seq, ncum, it: int) -> int:
    """Where hashInit's window starts: the first N-free SPAN window at or
    after it, or -1 where none is left."""
    last = len(seq) - SPAN
    step = 1 << 16
    for w0 in range(it, last + 1, step):
        w = np.arange(w0, min(w0 + step, last + 1))
        ok = np.flatnonzero(ncum[w + SPAN] - ncum[w] == 0)
        if len(ok):
            return w0 + int(ok[0])
    return -1


def padded_codes(seq):
    """The codes as int64 with SPAN + 8 zeros after them (YValue reads)."""
    return np.concatenate([seq.astype(np.int64), np.zeros(SPAN + 8, np.int64)])


def minimizer_xy(padded, j, v2, x):
    """XValue, YValue and strand at positions j from the chosen hash v2
    (hashNextX): the smallest of the 9 13-mers of v2 (first wins), and the
    4 bases after the forward window or the complements of the 4 before
    the reverse one; an N base (or, forward, one past the end) adds 0."""
    span2, weight2 = 2 * SPAN, 2 * WEIGHT
    xval = np.full(len(j), (1 << span2) - 1, dtype=U64)
    t = np.zeros(len(j), dtype=np.int64)
    for idx in range(SPAN - WEIGHT + 1):
        k = 64 - span2 + 2 * idx
        v1 = (v2 << U64(k)) >> U64(64 - weight2)
        better = v1 < xval
        xval = np.where(better, v1, xval)
        t = np.where(better, k, t)
    strand = (x <= 0).astype(np.int64)
    joff = (t >> 1) - 32 + SPAN
    fwd = j + joff + WEIGHT
    rev = j + SPAN - joff - WEIGHT - 1
    yval = np.zeros(len(j), dtype=np.int64)
    for i in range(4):
        vf = padded[np.minimum(fwd + i, len(padded) - 1)]
        ri = rev - i
        vr = np.where(ri >= 0, 3 - padded[np.maximum(ri, 0)], 3)
        val = np.where(strand == 0, vf, vr)
        yval = (yval << 2) + np.where((val >= 0) & (val <= 3), val, 0)
    return xval.astype(np.int64), yval, strand


def window_states(seq, j):
    """(h, crh, window sum) at positions j, from the closed forms."""
    p20 = np.zeros(len(j), dtype=U64)
    lsum = np.zeros(len(j), dtype=U64)
    for i in range(20):
        v = seq[j + i].astype(U64)
        p20 = (p20 << U64(2)) + v
        lsum += ((U64(3) - v) & U64(3)) << U64(2 * i)
    last = seq[j + 20].astype(U64)
    h = ((p20 & U64(M40)) << U64(2)) + last
    crh = lsum + ((U64(3) - last) << U64(40))  # u64 wraparound for N
    return h, crh


def block_samples(seq, padded, ncum, wsum, t_str: int, t_end: int):
    """(xval, cord without its genome id) of the emitted samples of one
    block."""
    if t_end <= t_str:
        return None
    w = _init_skip(seq, ncum, t_str)
    if w < 0:
        return None
    j = np.arange(t_str + MIN_STEP, t_end, MIN_STEP + 1, dtype=np.int64)
    if not len(j):
        return None
    h, crh = window_states(seq, j)
    init = SPAN - 1
    bias = 2 * (int(wsum[w + init] - wsum[w])
                - int(wsum[t_str + init] - wsum[t_str]))
    x = 2 * (wsum[j + SPAN] - wsum[j]) - 3 * SPAN + bias
    if w > t_str:
        # the first SPAN - 1 calls mix the init window: roll them
        mixed = np.flatnonzero(j < t_str + SPAN - 1)
        if len(mixed):
            st = HashStream()
            st.init_at(seq, w)
            at = t_str
            for m in mixed.tolist():
                while at <= j[m]:
                    st.nexth(seq, at)
                    at += 1
                h[m] = U64(st.h)
                crh[m] = U64(st.crh)
                x[m] = st.x
    v2 = np.where(x > 0, h, crh)
    xv, yv, st_ = minimizer_xy(padded, j, v2, x)
    n = len(xv)
    run_start = np.ones(n, dtype=bool)
    run_start[1:] = xv[1:] != xv[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(run_start, idx, 0))
    emit = (idx - start) % (MAX_STEP // (MIN_STEP + 1) + 1) == 0
    cord = ((j[emit] + ANCHOR_ZERO) << 20) + yv[emit] + (st_[emit] << 61)
    return xv[emit], cord


def build(genomes, threads: int):
    """(dir int32[4^13 + 1], hs uint64[n]) of the genomes' DIndex under
    -t threads."""
    xs, cs = [], []
    for gid, seq in enumerate(genomes):
        seq = np.asarray(seq, dtype=np.uint8)
        ncum = np.concatenate([[0], np.cumsum(seq == 4)])
        # prefix sums of base codes, N counted as 4 (wsum[a + 20] - wsum[a]
        # is the init window's sum; wsum[j + 21] - wsum[j] the window's)
        wsum = np.concatenate([[0], np.cumsum(seq, dtype=np.int64)])
        padded = padded_codes(seq)
        for t_str, t_end in thread_blocks(len(seq), threads):
            got = block_samples(seq, padded, ncum, wsum, t_str, t_end)
            if got is None:
                continue
            xs.append(got[0])
            cs.append(got[1] + (gid << 50))
    x = np.concatenate(xs) if xs else np.zeros(0, np.int64)
    c = np.concatenate(cs) if cs else np.zeros(0, np.int64)
    counts = np.bincount(x, minlength=N_BUCKETS)
    kept_counts = np.where(counts > OMIT_BLOCK, 0, counts)
    dirp = np.zeros(N_BUCKETS + 1, dtype=np.int64)
    np.cumsum(kept_counts, out=dirp[1:])
    kept = kept_counts[x] > 0
    order = np.lexsort((c[kept], x[kept]))
    return dirp.astype(np.int32), c[kept][order].astype(U64)

