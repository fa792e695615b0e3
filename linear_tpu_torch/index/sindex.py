"""SIndex (`-i 3`): per-xval bucket lists of sampled genome positions.

Reference: class SIndex (include/index_util.h:65-84), createSIndex +
_createSIndexHsThreadUnit (src/index_util.cpp:2075-2196), selection in
createIndexDynamic (src/index_util.cpp:2504-2514: 21-mer, min_step 8,
max_step 10, omit_block 200), query getSIndexMatchAll
(src/pmpfinder.cpp:1785-1854), dispatch (src/pmpfinder.cpp:2586-2588).

Differences from the DIndex build loop (src/index_util.cpp:1661-1699)
that this module mirrors exactly:
  - thread chunks are [len/threads*t, len/threads*(t+1)), final bound
    len - span — WITHOUT the +-span trimming the DIndex applies;
  - the sample clock is `i - last_i > min_step` where last_i advances
    ONLY on emission (DIndex: a free-running ++count reset every
    sample). So after an emission at p the next emission is at p+9 when
    XValue changes there, else p+10, else forced at p+11;
  - the stored value is create_cord(genome, i, 0, strand) — the RAW
    position (no const_anchor_zero offset), y = 0;
  - buckets longer than omit_block are cleared AFTER the build
    (src/index_util.cpp:2178-2187), not during the counting pass.

Storage here is dir/hs arrays like the DIndex (the reference's
vector<vector> layout is an artifact of its CAS-append build): a STABLE
sort by xval preserves each bucket's append order, which for the
deterministic chunk-sequential build below equals the reference's
single-thread order. (The reference's own multi-thread bucket order is
CAS-race-dependent — src/index_util.cpp:2112-2122 — so `-t 1` is the
only schedule with defined output; the difftests pin that.)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import hashing as H
from ..utils import cordlib as C

U64 = np.uint64

DEFAULT_SPAN = 21       # src/index_util.cpp:2506
DEFAULT_WEIGHT = 13     # span - 8 (LShape init_shape_parm)
DEFAULT_MIN_STEP = 8    # src/index_util.cpp:2508
DEFAULT_MAX_STEP = 10   # :2509
DEFAULT_OMIT_BLOCK = 200  # :2510 (NOT the CreateSIndexParms ctor's 1024)


@dataclass
class SIndex:
    span: int
    weight: int
    dir: np.ndarray  # int32 bucket offsets, len 4^weight + 1
    hs: np.ndarray   # uint64 cords, per-bucket append order
    nz: np.ndarray = field(default=None, repr=False)  # lazy non-empty bitmap

    def full_size(self) -> int:
        return (1 << (2 * self.weight)) + 1

    def query(self, xval: int) -> np.ndarray:
        return self.hs[self.dir[xval] : self.dir[xval + 1]]


def thread_blocks(seq_len: int, span: int, threads: int) -> list[tuple[int, int]]:
    """_createSIndexHsThreadUnit chunking (src/index_util.cpp:2160-2176):
    t_blocks[t] = len/threads*t, final bound len - span; chunk t scans
    [t_blocks[t], t_blocks[t+1]) with hashInit at its own start."""
    bounds = [seq_len // threads * t for t in range(threads)]
    bounds.append(seq_len - span)
    return [(bounds[t], bounds[t + 1]) for t in range(threads)]


def sampled_positions(
    seq: np.ndarray,
    span: int,
    weight: int,
    min_step: int,
    max_step: int,
    threads_emul: int,
):
    """All emitted (i, xval, strand) for one genome, chunk-sequential order."""
    out_i: list[int] = []
    out_x: list[int] = []
    out_s: list[int] = []
    polys = H.window_polys(seq, span) if len(seq) >= span else None
    for t_str, t_end in thread_blocks(len(seq), span, threads_emul):
        if t_end <= t_str:
            continue
        sh = H.genome_stream_hashes(seq, t_str, t_end, span, polys=polys)
        if not H.patch_n_neighborhoods(seq, sh, span, "genome"):
            continue
        xv, _, st = H.minimizer_xy(seq, sh.j, sh.h, sh.crh, sh.x, span, weight)
        xl = xv.tolist()
        sl = st.tolist()
        # sequential emission scan (see module docstring): last_i starts at
        # the chunk start, first test at t_str + min_step + 1
        last = t_str
        pre = -1
        i = t_str + min_step + 1
        while i < t_end:
            x = xl[i - t_str]
            if x != pre or i - last > max_step:
                out_i.append(i)
                out_x.append(x)
                out_s.append(sl[i - t_str])
                last = i
                pre = x
                i += min_step + 1
            else:
                i += 1
    return (np.asarray(out_i, dtype=np.int64), np.asarray(out_x, dtype=np.int64),
            np.asarray(out_s, dtype=np.int64))


def build_sindex(
    seqs: list[np.ndarray],
    span: int = DEFAULT_SPAN,
    weight: int = DEFAULT_WEIGHT,
    min_step: int = DEFAULT_MIN_STEP,
    max_step: int = DEFAULT_MAX_STEP,
    omit_block: int = DEFAULT_OMIT_BLOCK,
    threads_emul: int = 16,
) -> SIndex:
    full = (1 << (2 * weight)) + 1
    all_x, all_cords = [], []
    for gid, seq in enumerate(seqs):
        i, xv, st = sampled_positions(seq, span, weight, min_step, max_step,
                                      threads_emul)
        cords = C.make_cord(
            np.full(len(i), gid, dtype=U64),
            i.astype(U64),          # raw position: NO const_anchor_zero
            np.zeros(len(i), U64),  # y = 0
            st.astype(U64),
        )
        all_x.append(xv)
        all_cords.append(cords)
    xv = np.concatenate(all_x) if all_x else np.zeros(0, np.int64)
    cords = np.concatenate(all_cords) if all_cords else np.zeros(0, U64)
    counts = np.zeros(full - 1, dtype=np.int32)
    np.add.at(counts, xv, 1)
    # post-build omission: length(hs[i]) > omit_block cleared
    # (src/index_util.cpp:2178-2187)
    omitted = counts > omit_block
    counts[omitted] = 0
    dirp = np.zeros(full, dtype=np.int32)
    np.cumsum(counts, out=dirp[1:], dtype=np.int32)
    kept = ~omitted[xv]
    # STABLE sort by xval: bucket contents keep append (scan) order
    order = np.argsort(xv[kept], kind="stable")
    hs = cords[kept][order]
    return SIndex(span=span, weight=weight, dir=dirp, hs=hs)


def query_anchors(
    index: SIndex,
    read: np.ndarray,
    read_str: int,
    read_end: int,
    thd_alpha: int = 15,
) -> np.ndarray:
    """getSIndexMatchAll (src/pmpfinder.cpp:1785-1854): every thd_alpha-th
    call position, probe the bucket; emit make_anchor(id, x, k|len-1-k,
    strand) for entries with cordx > cordy, all flagged longPattern.

    Reference quirks mirrored:
      - the call loop runs k in [read_str, read_end) — the last span-1
        windows read PAST the read's end (SeqAn heap tail). The tail is
        modeled as 'A' bases (zero heap pages / zeroed capacity observed
        to match the binary on the difftest corpora);
      - an EMPTY bucket skips the xpre update (`continue` at :1812 jumps
        over `xpre = shape.XValue` — unlike getDIndexMatchAll);
      - every emitted anchor gets setLongPattern (:1836-1839): the test
        `shape2DIndexCordy(shape) == getDIndexCordy(val)` is
        (YValue & 0xF8000) == (0 & ~0x7FFF): hashNextXY2's YValue is 4
        bases (< 2^8, src/shape_extend.cpp:283-336) so the left side is
        always 0, and the stored y is 0 so the right side is too;
      - the flag rides in bit 62 of the anchor value and is stripped at
        hit->cord conversion (hit2Cord_dstr, src/cords.cpp:77,88); the
        dead filterAnchors2 is its only reader (src/pmpfinder.cpp:2096).
    """
    span, weight = index.span, index.weight
    read_len = len(read)
    # extended read models the over-the-end windows
    ext = np.concatenate([read, np.zeros(span, np.uint8)])
    if read_str == 0:
        sh = H.genome_stream_hashes(ext, 0, read_end, span)
        ok = H.patch_n_neighborhoods(ext, sh, span, "genome")
    else:
        sh = H.read_stream_hashes_range(ext, read_str, read_end, span)
        ok = H.patch_n_neighborhoods(ext, sh, span, "read")
    if len(sh.j) == 0 or not ok:
        return np.zeros(0, U64)
    sample_idx = np.arange(thd_alpha - 1, len(sh.j), thd_alpha)
    if len(sample_idx) == 0:
        return np.zeros(0, U64)
    j = sh.j[sample_idx]
    xv, _, st = H.minimizer_xy(
        ext, j, sh.h[sample_idx], sh.crh[sample_idx], sh.x[sample_idx],
        span, weight
    )
    dirp, hs = index.dir, index.hs
    anchors = []
    xpre = 0
    for k, x, s in zip(j.tolist(), xv.tolist(), st.tolist()):
        if x == xpre:
            continue
        lo, hi = dirp[x], dirp[x + 1]
        if hi <= lo:
            continue  # empty bucket: xpre NOT updated
        ent = hs[lo:hi]
        ent_strand = C.cord_strand(ent)
        same = ent_strand == s
        cordy = np.where(same, k, read_len - 1 - k).astype(np.int64)
        cordx = C.cord_x(ent).astype(np.int64)
        keep = cordx > cordy
        if keep.any():
            idv = C.cord_id(ent[keep])
            anc = C.make_anchor(
                idv.astype(U64),
                cordx[keep].astype(U64),
                cordy[keep].astype(U64),
                (~same[keep]).astype(U64),
            )
            anchors.append(anc | U64(C.FLAG_LONG_PATTERN))
        xpre = x
    if not anchors:
        return np.zeros(0, U64)
    return np.concatenate(anchors)
