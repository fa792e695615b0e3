"""DIndex: direct-addressed counting-sort k-mer table (the default index).

Counterpart of linear_tpu.index.dindex (createDIndex,
src/index_util.cpp:1628-1803):

  dir : int32[4^weight + 1]  exclusive-prefix-sum bucket offsets
  hs  : uint64[sum]          cords (id[10] | x+2^20 [30] | YValue [20] | strand@61)
                             per bucket sorted ascending by the full u64 value

On the host the port builds it with the native builder (lt_engine's
le_build_index); linear_tpu keeps the numpy builder and the query oracle.
For N-free genomes ops.devbuild builds the same tables on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

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


def thread_blocks(seq_len: int, span: int, threads: int) -> List[tuple]:
    """The reference's per-genome OpenMP block decomposition
    (src/index_util.cpp:1650-1659): bounds[t] = len // threads * t for
    t < threads, bounds[threads] = len - span; block t scans
    [bounds[t] + span, bounds[t + 1] - span)."""
    bounds = [seq_len // threads * t for t in range(threads)]
    bounds.append(seq_len - span)
    return [(bounds[t] + span, bounds[t + 1] - span) for t in range(threads)]


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
