"""Index serialization (--save-index / --load-index); counterpart of
linear_tpu.index.serial, with its file format and fingerprint, so each
package loads the other's files.

The reference rebuilds its index every run (no serialization exists,
SURVEY §5 "Checkpoint/resume"); this is a framework feature on top. The
DIndex's dense dir table (4^13+1 int32 = 268 MB) is stored SPARSELY —
non-empty bucket ids + counts (a few MB for bacterial genomes) — and
reconstructed with one prefix sum at load, so files stay small and load
time is dominated by a single cumsum pass instead of 268 MB of IO.

Format: numpy .npz with a `kind` field ("dindex" | "hindex" | "sindex"),
the shape parameters, and a genome fingerprint (sequence count + lengths)
so a stale or wrong-genome index fails loudly instead of silently
yielding plausible-looking but wrong mappings.
"""
from __future__ import annotations

import numpy as np

from .dindex import DIndex
from .hindex import HIndex
from .sindex import SIndex

KIND_TO_INDEX_TYPE = {"dindex": 1, "hindex": 2, "sindex": 3}


def _fingerprint(genome_lens) -> np.ndarray:
    return np.asarray(list(genome_lens or []), dtype=np.int64)


def save_index(path: str, index, genome_lens=None) -> None:
    """genome_lens: sequence lengths of the genomes the index was built
    from; stored as the identity fingerprint checked by load_index."""
    fp = _fingerprint(genome_lens)
    if not path.endswith(".npz"):
        path = path + ".npz"
    if isinstance(index, DIndex):
        counts = np.diff(index.dir).astype(np.int32)
        nz = np.flatnonzero(counts)
        np.savez(path, kind="dindex", span=index.span, weight=index.weight,
                 n_dir=np.int64(index.dir.shape[0]),
                 nz_x=nz.astype(np.int64), nz_cnt=counts[nz],
                 hs=index.hs, genome_lens=fp)
        return
    if isinstance(index, HIndex):
        np.savez(path, kind="hindex", span=index.span, weight=index.weight,
                 ysa=index.ysa, xs_val1=index.xs_val1, xs_val2=index.xs_val2,
                 xs_mask=np.int64(index.xs_mask),
                 empty_dir=np.int64(index.empty_dir), genome_lens=fp)
        return
    if isinstance(index, SIndex):
        counts = np.diff(index.dir).astype(np.int32)
        nz = np.flatnonzero(counts)
        np.savez(path, kind="sindex", span=index.span, weight=index.weight,
                 n_dir=np.int64(index.dir.shape[0]),
                 nz_x=nz.astype(np.int64), nz_cnt=counts[nz],
                 hs=index.hs, genome_lens=fp)
        return
    raise TypeError(f"unsupported index type {type(index)!r}")


def load_index(path: str, expect_index_type: int | None = None,
               genome_lens=None):
    """expect_index_type: the run's -i value; a saved index of a different
    kind is rejected (its query path would misuse the arrays). genome_lens:
    the run's genome lengths, checked against the stored fingerprint."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    if expect_index_type is not None:
        got = KIND_TO_INDEX_TYPE.get(kind)
        if got != expect_index_type:
            raise ValueError(
                f"E[12]: saved index {path} is kind {kind!r} (-i {got}) but "
                f"the run requested -i {expect_index_type}")
    if genome_lens is not None and "genome_lens" in z.files:
        fp = _fingerprint(genome_lens)
        stored = z["genome_lens"]
        if len(stored) and not np.array_equal(fp, stored):
            raise ValueError(
                f"E[13]: saved index {path} was built from a different "
                f"genome set ({len(stored)} seqs, lens {stored[:4]}...) than "
                f"this run's ({len(fp)} seqs)")
    if kind in ("dindex", "sindex"):
        n_dir = int(z["n_dir"])
        counts = np.zeros(n_dir, dtype=np.int64)
        counts[z["nz_x"] + 1] = z["nz_cnt"]
        dirp = np.cumsum(counts).astype(np.int32)
        cls = DIndex if kind == "dindex" else SIndex
        return cls(span=int(z["span"]), weight=int(z["weight"]),
                   dir=dirp, hs=z["hs"])
    if kind == "hindex":
        return HIndex(span=int(z["span"]), weight=int(z["weight"]),
                      ysa=z["ysa"], xs_val1=z["xs_val1"], xs_val2=z["xs_val2"],
                      xs_mask=int(z["xs_mask"]), empty_dir=int(z["empty_dir"]))
    raise ValueError(f"unknown index kind {kind!r} in {path}")
