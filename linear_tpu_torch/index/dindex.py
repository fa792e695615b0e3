"""DIndex: direct-addressed counting-sort k-mer table (the default index).

Counterpart of linear_tpu.index.dindex (createDIndex,
src/index_util.cpp:1628-1803):

  dir : int32[4^weight + 1]  exclusive-prefix-sum bucket offsets
  hs  : uint64[sum]          cords (id[10] | x+2^20 [30] | YValue [20] | strand@61)
                             per bucket sorted ascending by the full u64 value

On the host the port builds it with the native builder (lt_engine's
le_build_index); sampled_minimizers gives the table's samples in numpy, as
linear_tpu's numpy builder takes them (a test holds the two packages'
samples equal). query_anchors is the Python
engine's seeding (getDIndexMatchAll) for reads without device seeds. For
N-free genomes ops.devbuild builds the same tables on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..ops import hashing as H
from ..utils import cordlib as C

U64 = np.uint64

DEFAULT_SPAN = 21  # reference: dshape_len src/index_util.cpp:1484
DEFAULT_WEIGHT = 13  # span - 8
DEFAULT_MIN_STEP = 8
DEFAULT_MAX_STEP = 10
DEFAULT_OMIT_BLOCK = 400


@dataclass
class DIndex:
    span: int
    weight: int
    dir: np.ndarray  # int32[4^weight + 1] exclusive prefix offsets
    hs: np.ndarray  # uint64[n]
    # non-empty-bucket bitmap (bit x set iff bucket x non-empty): lets the
    # native query skip the dense dir table for probes of empty buckets
    nz: "np.ndarray | None" = None

    def ensure_nz(self) -> np.ndarray:
        if self.nz is None:
            counts = np.diff(self.dir)
            nzx = np.flatnonzero(counts).astype(np.int64)
            bm = np.zeros(((self.dir.shape[0] - 1) + 63) >> 6, dtype=np.uint64)
            np.bitwise_or.at(bm, nzx >> 6,
                             np.uint64(1) << (nzx & 63).astype(np.uint64))
            self.nz = bm
        return self.nz

    @property
    def full_size(self) -> int:
        """Entries of the dense dir table: 4^weight + 1."""
        return (1 << (2 * self.weight)) + 1

    def query(self, xval: int) -> np.ndarray:
        """The cords of bucket xval, in table order."""
        return self.hs[self.dir[xval]: self.dir[xval + 1]]


def thread_blocks(seq_len: int, span: int, threads: int) -> List[tuple]:
    """The reference's per-genome OpenMP block decomposition
    (src/index_util.cpp:1650-1659): bounds[t] = len // threads * t for
    t < threads, bounds[threads] = len - span; block t scans
    [bounds[t] + span, bounds[t + 1] - span)."""
    bounds = [seq_len // threads * t for t in range(threads)]
    bounds.append(seq_len - span)
    return [(bounds[t] + span, bounds[t + 1] - span) for t in range(threads)]


def sampled_minimizers(
    seq: np.ndarray,
    span: int,
    weight: int,
    min_step: int,
    max_step: int,
    threads_emul: int,
):
    """All emitted (j, xval, yval, strand) for one genome, in scan order."""
    out_j, out_x, out_y, out_s = [], [], [], []
    stride = min_step + 1
    polys = H.window_polys(seq, span) if len(seq) >= span else None
    for t_str, t_end in thread_blocks(len(seq), span, threads_emul):
        if t_end <= t_str:
            continue
        sh = H.genome_stream_hashes(seq, t_str, t_end, span, polys=polys)
        if not H.patch_n_neighborhoods(seq, sh, span, "genome"):
            continue
        # samples: count>min_step first at t_str+min_step, then every stride
        sample_idx = np.arange(min_step, t_end - t_str, stride)
        if len(sample_idx) == 0:
            continue
        j = sh.j[sample_idx]
        xv, yv, st = H.minimizer_xy(
            seq, j, sh.h[sample_idx], sh.crh[sample_idx], sh.x[sample_idx], span, weight
        )
        emit = H.emit_mask_index(xv, stride, max_step)
        out_j.append(j[emit])
        out_x.append(xv[emit])
        out_y.append(yv[emit])
        out_s.append(st[emit])
    if not out_j:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return (
        np.concatenate(out_j),
        np.concatenate(out_x),
        np.concatenate(out_y),
        np.concatenate(out_s),
    )


def build_dindex(seqs: List[np.ndarray], threads: int) -> DIndex:
    """The default DIndex of `seqs` through the native builder. `threads`
    is the -t value: the reference's per-thread genome blocks decide which
    positions are sampled, so it changes the table."""
    from ..map import nengine as NE

    dirp, hs, nz = NE.build_dindex_native(
        seqs, DEFAULT_SPAN, DEFAULT_WEIGHT, DEFAULT_MIN_STEP,
        DEFAULT_MAX_STEP, DEFAULT_OMIT_BLOCK, threads)
    return DIndex(span=DEFAULT_SPAN, weight=DEFAULT_WEIGHT, dir=dirp, hs=hs,
                  nz=nz)


def query_anchors(
    index: DIndex,
    read: np.ndarray,
    read_str: int,
    read_end: int,
    thd_alpha: int = 15,
) -> np.ndarray:
    """getDIndexMatchAll (src/pmpfinder.cpp:1856-1913): sample the read every
    thd_alpha positions, dedup consecutive equal XValues, probe the table,
    keep entries whose YValue differs from the probe's in at most one 2-bit
    group ((y1^y2)>>ctz < 4), and emit anchors.

    Returns uint64 anchors in the reference's emission order.
    """
    span, weight = index.span, index.weight
    read_len = len(read)
    sh = H.read_stream_hashes(read, read_str, read_end, span)
    if len(sh.j) == 0 or not H.patch_n_neighborhoods(read, sh, span, "read"):
        return np.zeros(0, U64)
    # dt counter: XValue evaluated at every thd_alpha-th call
    sample_idx = np.arange(thd_alpha - 1, len(sh.j), thd_alpha)
    if len(sample_idx) == 0:
        return np.zeros(0, U64)
    j = sh.j[sample_idx]
    xv, yv, st = H.minimizer_xy(
        read, j, sh.h[sample_idx], sh.crh[sample_idx], sh.x[sample_idx], span, weight
    )
    process = H.dedup_mask_query(xv)
    j, xv, yv, st = j[process], xv[process], yv[process], st[process]
    anchors = []
    for k, x, y, s in zip(j.tolist(), xv.tolist(), yv.tolist(), st.tolist()):
        lo, hi = index.dir[x], index.dir[x + 1]
        if hi <= lo:
            continue
        ent = index.hs[lo:hi]
        hs_y = (ent & C.MASK_Y).astype(np.int64)
        val = hs_y ^ y
        nz = val != 0
        ctz = np.zeros(len(val), dtype=np.int64)
        v = val.copy()
        v[~nz] = 1
        # count trailing zeros
        ctz = (v & -v).astype(np.uint64)
        ctz = np.log2(ctz.astype(np.float64)).astype(np.int64)
        ok = ~nz | ((val >> ctz) < 4)
        sel = ent[ok]
        if len(sel) == 0:
            continue
        ent_strand = C.cord_strand(sel)
        same = ent_strand == s
        cordy = np.where(same, k, read_len - 1 - k).astype(np.uint64)
        ent_y = C.cord_y(sel)
        # val2Anchor (src/index_util.cpp:1509): slide y out of the x field
        anc = (sel - (cordy << U64(20)) + cordy - ent_y)
        anc = np.where(same, anc & ~C.FLAG_STRAND, anc | C.FLAG_STRAND)
        anchors.append(anc)
    if not anchors:
        return np.zeros(0, U64)
    return np.concatenate(anchors)
