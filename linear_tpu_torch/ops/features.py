"""Feature scripts: 2-mer composition of 48-base windows, packed int96.

Re-derivation of the reference's type-2_48 features (src/pmpfinder.cpp:541-652):

  - One script per 16-base step: f[i] counts the 2-mers of the 48 bases
    starting at base 16*i (positions 16*i .. 16*i+47, each using base j,j+1).
  - 15 of the 16 2-mers are counted in 6-bit lanes packed 5-per-int32
    (3 ints = "int96"); TT and any 2-mer containing N map to bit 31 and are
    discarded (add 0).
  - Script distance = sum over lanes |lane1 - lane2| computed with the
    borrow-free trick d = s1 + 0x... - s2 per int (exactly as
    __scriptDist63_31, including its overflow behavior for counts > 31).
  - Window distance between 96-base windows = scriptDist(f1[a], f2[b]) +
    scriptDist(f1[a+3], f2[b+3])  (the 2 disjoint 48-base scripts).

Feature arrays are (n, 3) int32; n = floor((len - 48) / 16) + 1 scripts.
Length quirk reproduced: the reference's serial builder generates
ceil((len - 49) / 16) + 1 scripts (its loop stops at len-49), one fewer than
the parallel builder for some lengths; we follow the parallel builder
(resize((len-48)>>4)+1) which is what production runs use.
"""
from __future__ import annotations

import numpy as np

SCPT_STEP = 16
SCPT_BIT = 4
WINDOW48 = 48
WINDOW_SIZE = 96  # cell_size(16) * cell_num(6)

MAX31 = 31
MXU31 = (MAX31 << 24) + (MAX31 << 18) + (MAX31 << 12) + (MAX31 << 6) + MAX31

# units table (src/pmpfinder.cpp:541): maps 2-mer ord (5*a+b) to (int_idx, bit)
# N* , *N and TT go to bit 31 which is masked off.
_INF = 31
_UNITS = [
    0, 6, 12, 18, _INF,
    24, (1 << 8) + 0, (1 << 8) + 6, (1 << 8) + 12, _INF,
    (1 << 8) + 18, (1 << 8) + 24, (2 << 8) + 0, (2 << 8) + 6, _INF,
    (2 << 8) + 12, (2 << 8) + 18, (2 << 8) + 24, _INF, _INF,
    _INF, _INF, _INF, _INF, _INF,
]
_UNIT_INT = np.array([u >> 8 for u in _UNITS], dtype=np.int64)
_UNIT_BIT = np.array([u & 255 for u in _UNITS], dtype=np.int64)
_INFI_MASK30 = (1 << 31) - 1
# addend per 2-mer code: (1 << bit) & mask30  (N/TT -> 0)
_UNIT_ADD = ((1 << _UNIT_BIT.astype(np.int64)) & _INFI_MASK30).astype(np.int64)


def n_scripts(seq_len: int) -> int:
    """Parallel-builder script count (createFeatures2_48 threads variant,
    src/pmpfinder.cpp:596): ((len-48)>>4)+1."""
    if seq_len < WINDOW48:
        return 0
    return ((seq_len - WINDOW48) >> SCPT_BIT) + 1


def n_scripts_serial(seq_len: int) -> int:
    """Serial-builder script count (createFeatures2_48, src/pmpfinder.cpp:556):
    the stream loop runs for i in [16, len-49) step 16, yielding
    1 + max(0, (len-50)//16) scripts — one fewer than the parallel builder
    when (len-48) % 16 <= 1. Read features use THIS count (createFeatures is
    called without threads for reads, src/mapper.cpp:445)."""
    if seq_len < WINDOW48:
        return 0
    return 1 + max(0, (seq_len - 50) >> SCPT_BIT)


def create_features(seq: np.ndarray) -> np.ndarray:
    """Feature scripts for one sequence -> int32 array (n_scripts, 3).

    Vectorized: per-position 2-mer codes -> per-int addends -> 16-base cell
    sums -> 3-cell script sums. Equivalent to createFeatures2_48.
    """
    n = n_scripts(len(seq))
    if n == 0:
        return np.zeros((0, 3), dtype=np.int32)
    # The final script may touch the 2-mer at position len-1, whose second
    # base is one past the end (the C++ reads past the buffer there; we treat
    # the phantom base as 'A', consistent with zero-fill past SeqAn buffers).
    b = np.concatenate([seq.astype(np.int64), [0]])
    ord2 = b[:-1] * 5 + b[1:]  # 2-mer codes for positions 0..len-1
    which = _UNIT_INT[ord2]  # target int of each position
    add = _UNIT_ADD[ord2]
    # per-int contribution arrays
    contrib = np.zeros((3, len(ord2)), dtype=np.int64)
    for t in range(3):
        contrib[t] = np.where(which == t, add, 0)
    # script i sums positions [16i, 16i+48)
    csum = np.zeros((3, len(ord2) + 1), dtype=np.int64)
    np.cumsum(contrib, axis=1, out=csum[:, 1:])
    starts = np.arange(n) * SCPT_STEP
    ends = starts + WINDOW48
    f = (csum[:, ends] - csum[:, starts]).T  # (n, 3)
    return (f & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)


def create_features_serial(seq: np.ndarray) -> np.ndarray:
    """Feature scripts with the SERIAL builder's length (values identical to
    create_features, count per n_scripts_serial). Used for read features."""
    return create_features(seq)[: n_scripts_serial(len(seq))]


def create_features_genome(seq: np.ndarray, threads: int) -> np.ndarray:
    """Genome features: parallel builder count, EXCEPT the reference falls
    back to the serial builder when range < threads (src/pmpfinder.cpp:598)."""
    rng = n_scripts(len(seq))
    if rng < threads:
        return create_features_serial(seq)
    return create_features(seq)


def script_dist(s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """_scriptDist63_31 between int96 scripts; s1, s2 shape (..., 3) int32.

    Replicates the int32 wrap-around semantics of the C++ exactly.
    """
    d = (s1.astype(np.int64) + MXU31 - s2.astype(np.int64)).astype(np.int64)
    d = (d & 0xFFFFFFFF).astype(np.int64)  # int32 wrap like the C++
    total = np.zeros(d.shape[:-1], dtype=np.int64)
    for shift in (24, 18, 12, 6, 0):
        total = total + np.abs(((d >> shift) & 63) - MAX31).sum(axis=-1)
    return total


def window_dist(f1: np.ndarray, f2: np.ndarray, a, b) -> np.ndarray:
    """_windowDist2_48: 96-base window distance between script a of f1 and
    script b of f2 (script indices, i.e. base offset / 16). Vectorized over
    arrays a, b. No bounds checking (caller guarantees a+3, b+3 valid)."""
    return script_dist(f1[a], f2[b]) + script_dist(f1[a + 3], f2[b + 3])


def window_dist_checked(f1: np.ndarray, f2: np.ndarray, a, b, abort_score: int = 1000):
    """_windowDist (src/pmpfinder.cpp:680): bounds-checked variant used by the
    gap module; out-of-bounds gives abort_score. d = scpt_num*(int_step-1) = 4."""
    a = np.asarray(a)
    b = np.asarray(b)
    d = 2 * (3 - 1)  # scpt_num * (scpt_int_step - 1)
    ok = (a + d < len(f1)) & (b + d < len(f2)) & (a >= 0) & (b >= 0)
    out = np.full(a.shape, abort_score, dtype=np.int64)
    if np.any(ok):
        av = np.where(ok, a, 0)
        bv = np.where(ok, b, 0)
        out = np.where(ok, window_dist(f1, f2, av, bv), out)
    return out

# ---------------------------------------------------------------- type I
# Legacy single-base-count scripts (src/pmpfinder.cpp:330-483): a script is
# one int16 packing base counts of a window in three 5-bit segments
# (A -> +1, C -> +32, G -> +1024, T/N -> +0, scptCount
# src/pmpfinder.cpp:192-196).
#   type 1_32 (-f 1): 32-base windows, one script per 16-base step, rolling.
#   type 1_16 (-f 0): 16-base windows, one script per 16-base step.
# Distances: __scriptDist16_3 (src/pmpfinder.cpp:332) with mask 31 and an
# UNMASKED arithmetic >>10 for the third segment — int16 overflow semantics
# of the C++ `short` are reproduced via np.int16.

_SCPT_COUNT1 = np.array([1, 1 << 5, 1 << 10, 0, 0], dtype=np.int64)


def _counts1(seq: np.ndarray) -> np.ndarray:
    """Prefix sums of per-base scptCount addends; csum[i] = sum of [0, i)."""
    add = _SCPT_COUNT1[seq.astype(np.int64)]
    csum = np.zeros(len(seq) + 1, dtype=np.int64)
    np.cumsum(add, out=csum[1:])
    return csum


def create_features_1_32_serial(seq: np.ndarray) -> np.ndarray:
    """createFeatures1_32 serial (src/pmpfinder.cpp:355-373, used for READ
    features): window 32, step 16; returns only the entries the loop fills
    (the C++ resize length ((len-32)>>4)+1 can exceed that by one — the
    trailing slot is never written; see the 2_48 length quirk note above)."""
    L = len(seq)
    if L < 33:
        return np.zeros(0, dtype=np.int16)
    csum = _counts1(seq)
    starts = [0] + list(range(16, L - 32, 16))
    starts = np.asarray(starts, dtype=np.int64)
    # array length = the C++ resize length ((L-32)>>4)+1; slots past the
    # loop's reach stay 0 (uninitialized in the reference; see the
    # fresh-page note on create_features_1_16_parallel)
    f = np.zeros(((L - 32) >> 4) + 1, dtype=np.int16)
    f[: len(starts)] = (csum[starts + 32] - csum[starts]).astype(np.int16)
    return f


def create_features_1_32_parallel(seq: np.ndarray, threads: int) -> np.ndarray:
    """createFeatures1_32 threads variant (src/pmpfinder.cpp:394-423, used
    for GENOME features): fills range = (len-48)/16 entries (the per-thread
    rolling chains produce the same window sums as the serial builder)."""
    L = len(seq)
    rng = (L - 32 - 16) // 16 if L >= 48 else 0
    if rng <= 0:
        return np.zeros(0, dtype=np.int16)
    csum = _counts1(seq)
    starts = np.arange(rng, dtype=np.int64) * 16
    f = np.zeros(((L - 32) >> 4) + 1, dtype=np.int16)
    f[:rng] = (csum[starts + 32] - csum[starts]).astype(np.int16)
    return f


def create_features_1_16_serial(seq: np.ndarray) -> np.ndarray:
    """createFeatures1_16 serial (src/pmpfinder.cpp:440-454): window 16,
    step 16, recomputed per step; fills one entry per k in [0, len-16)."""
    L = len(seq)
    if L < 17:
        return np.zeros(0, dtype=np.int16)
    csum = _counts1(seq)
    starts = np.arange(0, L - 16, 16, dtype=np.int64)
    f = np.zeros(((L - 16) >> 4) + 1, dtype=np.int16)
    f[: len(starts)] = (csum[starts + 16] - csum[starts]).astype(np.int16)
    return f


def create_features_1_16_parallel(seq: np.ndarray, threads: int) -> np.ndarray:
    """createFeatures1_16 threads variant (src/pmpfinder.cpp:455-480).

    The reference's per-thread loop runs k in [thd_begin, thd_end - 16),
    leaving the LAST script of every thread chunk uninitialized (SeqAn
    resize does not value-construct PODs). For the genome-sized arrays those
    slots come from fresh mmap'd pages and read back as 0, which is what we
    emulate (slot value 0).
    """
    L = len(seq)
    rng = (L - 16 - 16) // 16 if L >= 32 else 0
    if rng <= 0:
        return np.zeros(0, dtype=np.int16)
    csum = _counts1(seq)
    f = np.zeros(((L - 16) >> 4) + 1, dtype=np.int16)
    # emulate parallelParm_Static chunking (src/pmpfinder.cpp:375-393)
    chunk = rng // threads
    rem = rng - chunk * threads
    pos = 0
    for t in range(threads):
        size = chunk + 1 if t < rem else chunk
        if size <= 0:
            continue
        b, e = pos, pos + size
        pos = e
        # k in [b*16, e*16 - 16) step 16 -> scripts b .. e-2; script e-1
        # stays 0 (uninitialized in the reference)
        idx = np.arange(b, e - 1, dtype=np.int64)
        if len(idx):
            starts = idx * 16
            f[idx] = (csum[starts + 16] - csum[starts]).astype(np.int16)
    return f


def script_dist16_3(s1: int, s2: int) -> int:
    """__scriptDist16_3 (src/pmpfinder.cpp:332): segment |diffs| with mask
    31, segment shifts 5/10; the >>10 segment is unmasked (C++ int
    arithmetic on promoted shorts)."""
    return (abs((s1 & 31) - (s2 & 31))
            + abs(((s1 >> 5) & 31) - ((s2 >> 5) & 31))
            + abs((s1 >> 10) - (s2 >> 10)))


def window_dist_1(f1: np.ndarray, f2: np.ndarray, a, b, int_step: int,
                  scpt_num: int) -> np.ndarray:
    """_windowDist1_32 / _windowDist1_16 (src/pmpfinder.cpp:344,433):
    vectorized over index arrays a, b; no bounds checking."""
    offs = np.arange(scpt_num, dtype=np.int64) * int_step
    av = np.asarray(a, dtype=np.int64)[..., None] + offs
    bv = np.asarray(b, dtype=np.int64)[..., None] + offs
    s1 = f1[av].astype(np.int64)
    s2 = f2[bv].astype(np.int64)
    d = (np.abs((s1 & 31) - (s2 & 31))
         + np.abs(((s1 >> 5) & 31) - ((s2 >> 5) & 31))
         + np.abs((s1 >> 10) - (s2 >> 10)))
    return d.sum(axis=-1)


def feats1_parts(seq: np.ndarray, ftype: int):
    """(filled_values, resize_len) of the type-1 serial builders — the
    caller maintains the persistent SeqAn-String emulation (slots in
    [len(filled), resize_len) keep their previous content; see
    map.pmpfinder.FeatBuf)."""
    L = len(seq)
    csum = None
    if ftype == 1:  # 1_32
        if L < 33:
            return np.zeros(0, dtype=np.int16), 0
        csum = _counts1(seq)
        starts = np.asarray([0] + list(range(16, L - 32, 16)), dtype=np.int64)
        vals = (csum[starts + 32] - csum[starts]).astype(np.int16)
        return vals, ((L - 32) >> 4) + 1
    # 1_16
    if L < 17:
        return np.zeros(0, dtype=np.int16), 0
    csum = _counts1(seq)
    starts = np.arange(0, L - 16, 16, dtype=np.int64)
    vals = (csum[starts + 16] - csum[starts]).astype(np.int16)
    return vals, ((L - 16) >> 4) + 1
