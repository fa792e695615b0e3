"""ctypes binding of the native per-read mapping engine (lt_engine).

Counterpart of linear_tpu.map.nengine. The engine runs the exact per-read
pipeline — chaining DP, dense window extension, gap/SV resolution, cords ->
CIGAR/SAM — either seeding the read itself or taking anchors from the
device seeding (ops.seeding). For the -b 0 device path it also splits a
read around the extension: apx_hits runs the first pass up to the
pre-filter hits, the device extends them (ops.extend_dev), and apx_finish
takes the cords from there. The library is native/src/lt_engine.cpp,
compiled by linear_tpu_torch.native. LINEAR_TPU_ENGINE=py turns the engine
off (enabled()): the Python engine (map.pmpfinder) maps the reads instead.
"""
from __future__ import annotations

import ctypes as C
import os
import threading
from typing import List, Optional

import numpy as np

from ..native import load

_LIB = None
_LIB_LOCK = threading.Lock()


def engine_lib():
    """The configured lt_engine library (built on first use; raises if the
    build fails)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("lt_engine")
            lib.le_create2.restype = C.c_void_p
            lib.le_create2.argtypes = [
                C.c_int64,                      # n_genomes
                C.POINTER(C.c_void_p),          # genome_ptrs
                C.POINTER(C.c_int64),           # genome_lens
                C.POINTER(C.c_void_p),          # gfeat_ptrs
                C.POINTER(C.c_int64),           # gfeat_rows
                C.c_void_p, C.c_void_p,         # dir (int32*), hs (u64*)
                C.c_void_p,                     # nz bitmap (u64*)
                C.c_int, C.c_int,               # span, weight
                C.c_int64, C.c_int64,           # thd_DI, thd_X
                C.c_int64,                      # gap_len_min
                C.c_int, C.c_int, C.c_int, C.c_int,  # f_dup f_chain ss rccs
                C.c_double,                     # cah_stop_ratio (preset)
                C.POINTER(C.c_char_p),          # genome ids
            ]
            lib.le_set_hindex.restype = None
            lib.le_set_hindex.argtypes = [
                C.c_void_p,
                C.c_void_p, C.c_int64,          # ysa, n_ysa
                C.c_void_p, C.c_void_p,         # xs_val1, xs_val2
                C.c_int64, C.c_int64,           # xs_mask, empty_dir
                C.c_int, C.c_int,               # span, weight
            ]
            lib.le_build_hindex.restype = C.c_void_p
            lib.le_build_hindex.argtypes = [
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
                C.c_int, C.c_int64, C.c_int64, C.c_double, C.c_int64]
            lib.le_hindex_sizes.restype = None
            lib.le_hindex_sizes.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
            lib.le_hindex_ptrs.restype = None
            lib.le_hindex_ptrs.argtypes = [C.c_void_p, C.POINTER(C.c_void_p),
                                           C.c_void_p]
            lib.le_hindex_build_free.restype = None
            lib.le_hindex_build_free.argtypes = [C.c_void_p]
            lib.le_reset.restype = None
            lib.le_reset.argtypes = [C.c_void_p]
            lib.le_destroy.restype = None
            lib.le_destroy.argtypes = [C.c_void_p]
            lib.le_map_block.restype = C.c_int
            lib.le_map_block.argtypes = [
                C.c_void_p, C.POINTER(C.c_void_p), C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_void_p),
                C.POINTER(C.c_int64), C.c_int64, C.c_int,
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64)]
            lib.le_map_read.restype = C.c_int
            lib.le_map_read.argtypes = [
                C.c_void_p,
                C.c_void_p, C.c_int64,          # read, len
                C.c_char_p,                     # rid
                C.c_void_p, C.c_int64,          # seeds, n_seeds
                C.c_int, C.c_int,               # tid, do_output
                C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),  # out cs/ce
                C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
            ]
            lib.le_apx_hits.restype = C.c_int
            lib.le_apx_hits.argtypes = [
                C.c_void_p, C.c_void_p, C.c_int64,   # engine, read, len
                C.c_void_p, C.c_int64,               # seeds, n_seeds
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64),  # out hits
            ]
            lib.le_apx_finish.restype = C.c_int
            lib.le_apx_finish.argtypes = [
                C.c_void_p, C.c_void_p, C.c_int64, C.c_char_p,
                C.c_void_p, C.c_int64,               # cords, n_cords
                C.c_int, C.c_int,                    # tid, do_output
                C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),  # out cs/ce
                C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
            ]
            lib.le_feature_rows.restype = C.c_int64
            lib.le_feature_rows.argtypes = [C.c_int64, C.c_int64]
            lib.le_build_features.restype = None
            lib.le_build_features.argtypes = [C.c_void_p, C.c_int64, C.c_int64,
                                              C.c_void_p]
            lib.le_build_index.restype = C.c_void_p
            lib.le_build_index.argtypes = [
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
                C.c_int, C.c_int, C.c_int64, C.c_int64, C.c_int64, C.c_int64,
                C.c_void_p,
            ]
            lib.le_index_hs_len.restype = C.c_int64
            lib.le_index_hs_len.argtypes = [C.c_void_p]
            lib.le_index_fetch_hs.restype = None
            lib.le_index_fetch_hs.argtypes = [C.c_void_p, C.c_void_p]
            lib.le_index_nz_len.restype = C.c_int64
            lib.le_index_nz_len.argtypes = [C.c_void_p]
            lib.le_index_fetch_nz.restype = None
            lib.le_index_fetch_nz.argtypes = [C.c_void_p, C.c_void_p]
            lib.le_index_free.restype = None
            lib.le_index_free.argtypes = [C.c_void_p]
            lib.le_stage_ns.restype = None
            lib.le_stage_ns.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
            lib.le_apx_stage_ns.restype = None
            lib.le_apx_stage_ns.argtypes = [C.POINTER(C.c_int64)]
            lib.le_pack_superchunk.restype = None
            lib.le_pack_superchunk.argtypes = [
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
                C.c_int64, C.c_int64, C.c_void_p, C.c_void_p]
            _LIB = lib
        return _LIB


def enabled() -> bool:
    """Whether the native engine maps reads: LINEAR_TPU_ENGINE=py (the
    variable linear_tpu.map.nengine reads) selects the Python engine. The
    native genome feature and DIndex builds run either way; the native
    HIndex build only with the engine on, as in linear_tpu."""
    return os.environ.get("LINEAR_TPU_ENGINE", "native") != "py"


def build_features_native(seq: np.ndarray, threads: int) -> np.ndarray:
    """Genome 2_48 feature scripts via the native builder (identical to
    linear_tpu.ops.features.create_features_genome)."""
    lib = engine_lib()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = lib.le_feature_rows(len(seq), threads)
    out = np.empty((n, 3), dtype=np.int32)
    lib.le_build_features(seq.ctypes.data, len(seq), threads, out.ctypes.data)
    return out


def build_dindex_native(seqs: List[np.ndarray], span: int, weight: int,
                        min_step: int, max_step: int, omit_block: int,
                        threads: int):
    """DIndex tables via the native builder: returns numpy copies of
    (dir int32, hs uint64, nz uint64 bitmap)."""
    lib = engine_lib()
    pinned = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
    n = len(pinned)
    gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in pinned])
    glens = (C.c_int64 * n)(*[len(g) for g in pinned])
    full = (1 << (2 * weight)) + 1
    dirp = np.zeros(full, dtype=np.int32)  # filled in place by the builder
    h = lib.le_build_index(gptrs, glens, n, span, weight, min_step, max_step,
                           omit_block, threads, dirp.ctypes.data)
    try:
        hs = np.empty(lib.le_index_hs_len(h), dtype=np.uint64)
        lib.le_index_fetch_hs(h, hs.ctypes.data)
        nz = np.empty(lib.le_index_nz_len(h), dtype=np.uint64)
        lib.le_index_fetch_nz(h, nz.ctypes.data)
    finally:
        lib.le_index_free(h)
    return dirp, hs, nz


class _BuildHandle:
    """Owns a native HIndex build's buffers and frees them when the last
    array viewing them dies."""

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h

    def __del__(self):
        self._lib.le_hindex_build_free(self._h)


def build_hindex_native(seqs: List[np.ndarray], span: int, step: int,
                        blocklimit: int, alpha: float, threads: int):
    """HIndex (-i 2) tables via the native build (le_hibuild.hpp): an
    index.hindex.HIndex, bit-identical to index.hindex.build_hindex. Its
    arrays are numpy views over the build's own buffers (no copy); each
    array's base holds the handle that frees them, so an array stays valid
    however long it is kept."""
    from ..index.hindex import HIndex

    lib = engine_lib()
    pinned = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
    n = len(pinned)
    gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in pinned])
    glens = (C.c_int64 * n)(*[len(g) for g in pinned])
    handle = _BuildHandle(lib, lib.le_build_hindex(
        gptrs, glens, n, span, step, blocklimit, alpha, threads))
    sizes = (C.c_int64 * 3)()
    lib.le_hindex_sizes(handle._h, sizes)
    ptrs = (C.c_void_p * 3)()
    mask = np.zeros(1, dtype=np.uint64)
    lib.le_hindex_ptrs(handle._h, ptrs, mask.ctypes.data)

    def view(ptr, count, dtype):
        if count == 0:
            return np.zeros(0, dtype=dtype)
        buf = (C.c_char * (count * 8)).from_address(ptr)
        buf._keepalive = handle  # the array's base is a view of buf
        return np.frombuffer(buf, dtype=dtype)

    return HIndex(span=span, weight=span - 8,
                  ysa=view(ptrs[0], sizes[0], np.uint64),
                  xs_val1=view(ptrs[1], sizes[1], np.uint64),
                  xs_val2=view(ptrs[2], sizes[1], np.int64),
                  xs_mask=int(mask[0]), empty_dir=int(sizes[2]))


def pack_superchunk_native(reads: list, pad_len: int, rows: int):
    """le_pack_superchunk (lt_engine.cpp): (rows, pad/4 + 8) uint8 wire of
    2-bit LSB-first bases plus 8 little-endian length bytes per row, and the
    per-row N mask (rows of reads with N are zero on the wire)."""
    lib = engine_lib()
    n = len(reads)
    if n > rows:
        raise ValueError(f"{n} reads do not fit a {rows}-row superchunk")
    if pad_len % 4:
        raise ValueError(f"pad {pad_len} is not a multiple of 4")
    pinned = [np.ascontiguousarray(r, dtype=np.uint8) for r in reads]
    ptrs = (C.c_void_p * max(n, 1))(*[r.ctypes.data for r in pinned])
    lens = (C.c_int64 * max(n, 1))(*[len(r) for r in pinned])
    wire = np.empty((rows, pad_len // 4 + 8), dtype=np.uint8)
    n_mask = np.empty((rows,), dtype=np.uint8)
    lib.le_pack_superchunk(ptrs, lens, n, rows, pad_len, wire.ctypes.data,
                           n_mask.ctypes.data)
    return wire, n_mask.astype(bool)


def _u64_copy(ptr: C.c_void_p, n: int) -> np.ndarray:
    """numpy copy of n uint64 at an engine-owned pointer."""
    if not n:
        return np.zeros(0, dtype=np.uint64)
    return np.ctypeslib.as_array(C.cast(ptr, C.POINTER(C.c_uint64)),
                                 shape=(n,)).copy()


class _ReadOut:
    """The out-parameters of le_map_read / le_apx_finish (engine-owned
    buffers, valid until the next call on the engine)."""

    def __init__(self):
        self.cs, self.ce, self.n = C.c_void_p(), C.c_void_p(), C.c_int64()
        self.sam, self.sam_n = C.c_char_p(), C.c_int64()

    def refs(self):
        return (C.byref(self.cs), C.byref(self.ce), C.byref(self.n),
                C.byref(self.sam), C.byref(self.sam_n))

    def result(self):
        """(cords_str, cords_end) uint64 copies and the SAM text."""
        sam = (C.string_at(self.sam, self.sam_n.value).decode()
               if self.sam_n.value else "")
        return (_u64_copy(self.cs, self.n.value),
                _u64_copy(self.ce, self.n.value), sam)


class NativeEngine:
    """One engine instance per process; keeps the backing numpy arrays
    alive for the engine's lifetime (the engine stores raw pointers)."""

    def __init__(self, genomes: List[np.ndarray], gfeats: List[np.ndarray],
                 index, genome_ids: List[str], thd_DI: int, thd_X: int,
                 gap_len_min: int, f_dup: int, f_chain: int,
                 sequence_sam: int, reform_ccs: int,
                 cah_stop_ratio: float = 0.0):
        lib = engine_lib()
        self._lib = lib
        self._genomes = [np.ascontiguousarray(g, dtype=np.uint8) for g in genomes]
        self._gfeats = [np.ascontiguousarray(f, dtype=np.int32) for f in gfeats]
        self._hindex = index if hasattr(index, "ysa") else None
        if self._hindex is not None:  # -i 2: the engine seeds via le_hindex
            self._dir = np.zeros(2, dtype=np.int32)
            self._hs = np.zeros(0, dtype=np.uint64)
            nz_ptr = None
        else:
            self._dir = np.ascontiguousarray(index.dir, dtype=np.int32)
            self._hs = np.ascontiguousarray(index.hs, dtype=np.uint64)
            self._nz = np.ascontiguousarray(index.ensure_nz(),
                                            dtype=np.uint64)
            nz_ptr = self._nz.ctypes.data
        n = len(self._genomes)
        gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in self._genomes])
        glens = (C.c_int64 * n)(*[len(g) for g in self._genomes])
        fptrs = (C.c_void_p * n)(*[f.ctypes.data for f in self._gfeats])
        frows = (C.c_int64 * n)(*[f.shape[0] for f in self._gfeats])
        gids = (C.c_char_p * n)(*[s.encode() for s in genome_ids])
        self._h = lib.le_create2(
            n, gptrs, glens, fptrs, frows,
            self._dir.ctypes.data, self._hs.ctypes.data, nz_ptr,
            index.span, index.weight,
            thd_DI, thd_X, gap_len_min, f_dup, f_chain,
            sequence_sam, reform_ccs, cah_stop_ratio, gids)
        if self._hindex is not None:
            hi = self._hindex
            self._hi_ysa = np.ascontiguousarray(hi.ysa, dtype=np.uint64)
            self._hi_v1 = np.ascontiguousarray(hi.xs_val1, dtype=np.uint64)
            self._hi_v2 = np.ascontiguousarray(hi.xs_val2, dtype=np.int64)
            lib.le_set_hindex(self._h, self._hi_ysa.ctypes.data,
                              len(self._hi_ysa), self._hi_v1.ctypes.data,
                              self._hi_v2.ctypes.data, hi.xs_mask,
                              hi.empty_dir, hi.span, hi.weight)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.le_destroy(h)

    def reset(self) -> None:
        """Fresh per-task GapParms (reference: per-compute-task state)."""
        self._lib.le_reset(self._h)

    def stage_ns(self) -> List[int]:
        """Wall ns the engine spent in its features, apx, gap and output
        phases since the last call (the counters restart at 0)."""
        buf = (C.c_int64 * 4)()
        self._lib.le_stage_ns(self._h, buf)
        return list(buf)

    def apx_stage_ns(self) -> List[int]:
        """Wall ns of the apx phase's host seeding (query_anchors), chain
        and extension since the last call, summed over every engine of the
        process (the counters restart at 0)."""
        buf = (C.c_int64 * 3)()
        self._lib.le_apx_stage_ns(buf)
        return list(buf)

    def map_read(self, read: np.ndarray, rid: str,
                 seeds: Optional[np.ndarray] = None, tid: int = 0):
        """Returns (cords_str u64 ndarray copy, cords_end, sam str). seeds:
        device anchors in emission order, or None to seed on the host."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        if seeds is None:
            seeds_ptr, n_seeds = None, -1
        else:
            seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
            seeds_ptr, n_seeds = seeds.ctypes.data, len(seeds)
        out = _ReadOut()
        self._lib.le_map_read(
            self._h, read.ctypes.data, len(read), rid.encode(),
            seeds_ptr, n_seeds, tid, 1, *out.refs())
        return out.result()

    def apx_hits(self, read: np.ndarray,
                 seeds: Optional[np.ndarray] = None) -> np.ndarray:
        """The first apx pass up to the PRE-filter hits (uint64 copy, slot 0
        the FLAG_END header; empty for reads of 200 bases or fewer): what
        the device's _filterHits + path_dst_2 start from. seeds as in
        map_read."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        if seeds is None:
            seeds_ptr, n_seeds = None, -1
        else:
            seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
            seeds_ptr, n_seeds = seeds.ctypes.data, len(seeds)
        h_p = C.c_void_p()
        n_out = C.c_int64()
        self._lib.le_apx_hits(self._h, read.ctypes.data, len(read), seeds_ptr,
                              n_seeds, C.byref(h_p), C.byref(n_out))
        return _u64_copy(h_p, n_out.value)

    def apx_finish(self, read: np.ndarray, rid: str, cords: np.ndarray,
                   tid: int = 0):
        """Finish a read from the device's path_dst_2 cords: the apx tail,
        the gap phase on thread `tid`'s GapParms, and the SAM text. Returns
        (cords_str, cords_end, sam) as map_read, or None when the read needs
        the full host re-map (the re-apx path: the y-gaps cover >= 0.7 of
        the read)."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        cords = np.ascontiguousarray(cords, dtype=np.uint64)
        out = _ReadOut()
        rc = self._lib.le_apx_finish(
            self._h, read.ctypes.data, len(read), rid.encode(),
            cords.ctypes.data if len(cords) else None, len(cords), tid, 1,
            *out.refs())
        return None if rc else out.result()

    def map_block(self, reads, rids, seeds_list=None, tid: int = 0) -> str:
        """Map a chunk of reads with ONE ctypes crossing; returns the
        concatenated SAM text (identical to per-read map_read calls in
        order). For callers that need neither cords nor BAM lines."""
        n = len(reads)
        pinned = [np.ascontiguousarray(r, dtype=np.uint8) for r in reads]
        rptrs = (C.c_void_p * n)(*[r.ctypes.data for r in pinned])
        rlens = (C.c_int64 * n)(*[len(r) for r in pinned])
        ridp = (C.c_char_p * n)(*[r.encode() for r in rids])
        seeds_pinned = []
        sptrs = (C.c_void_p * n)()
        scnts = (C.c_int64 * n)()
        for i in range(n):
            sd = seeds_list[i] if seeds_list is not None else None
            if sd is None:
                sptrs[i], scnts[i] = None, -1
            else:
                sd = np.ascontiguousarray(sd, dtype=np.uint64)
                seeds_pinned.append(sd)
                sptrs[i], scnts[i] = sd.ctypes.data, len(sd)
        sam_p = C.c_char_p()
        sam_n = C.c_int64()
        self._lib.le_map_block(self._h, rptrs, rlens, ridp, sptrs, scnts,
                               n, tid, C.byref(sam_p), C.byref(sam_n))
        return C.string_at(sam_p, sam_n.value).decode() if sam_n.value else ""
