"""Build and bind the port's CUDA kernels.

The sources in ops/csrc/ are compiled with nvcc for sm_90a, one nvcc per
source, all started together, and linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), under
linear_tpu_torch/_build/, at first use. ctypes binds it; pointers come from
Tensor.data_ptr() and the stream from PyTorch's current stream. The
wrappers check device, dtype, shape and contiguity, raise on a refused
launch, and never synchronise. Nothing here runs when the module is
imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libltcuda.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
# seconds the nvcc build took in this process (0.0: the library in BUILD_DIR
# was up to date), and what ptxas said about registers and shared memory
build_seconds = None
ptxas_info = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return path


def build() -> str:
    """Path of the up-to-date kernel library, compiled first if missing or
    older than its sources. Raises with nvcc's output if the build fails."""
    global build_seconds, ptxas_info
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    so = os.path.join(BUILD_DIR, LIB_NAME)
    info = os.path.join(BUILD_DIR, LIB_NAME + ".ptxas.txt")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, LIB_NAME + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(so) and os.path.getmtime(so)
                >= max(os.path.getmtime(d) for d in deps)):
            build_seconds = 0.0
            if os.path.exists(info):
                with open(info) as fh:
                    ptxas_info = fh.read()
            return so
        tmpdir = tempfile.mkdtemp(prefix=LIB_NAME + ".", dir=BUILD_DIR)
        t0 = time.time()
        try:
            nvcc = _nvcc()
            objs = [os.path.join(tmpdir, os.path.basename(s) + ".o")
                    for s in srcs]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for s, o in zip(srcs, objs)]
            outs = [p.communicate() for p in procs]
            failed = [(s, out) for s, p, out in zip(srcs, procs, outs)
                      if p.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed to build the CUDA kernels:\n"
                                   + "\n".join(f"{s}:\n{o[0][-3000:]}{o[1][-3000:]}"
                                               for s, o in failed))
            tmp = os.path.join(tmpdir, LIB_NAME)
            res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed to link the CUDA kernels:\n"
                                   + res.stdout[-4000:] + res.stderr[-4000:])
            os.replace(tmp, so)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        build_seconds = time.time() - t0
        ptxas_info = "".join(err for _, err in outs)
        with open(info, "w") as fh:
            fh.write(ptxas_info)
    return so


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            dll = ctypes.CDLL(build())
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            dll.lt_seed_superchunk.restype = ctypes.c_int
            dll.lt_seed_superchunk_scratch_slots.restype = i64
            dll.lt_seed_superchunk_scratch_slots.argtypes = [ctypes.c_int]
            dll.lt_seed_superchunk_row_words.restype = i64
            dll.lt_seed_superchunk_row_words.argtypes = [i64]
            dll.lt_seed_superchunk.argtypes = [
                p, i64, i64, p, i64, p, i64, ctypes.c_int, ctypes.c_int, p, p,
                p, p, p]
            dll.lt_filter_extend.restype = ctypes.c_int
            dll.lt_filter_extend.argtypes = [
                p, i64, i64, p, p, i64, p, p, p, p, i64, i64, i64,
                i64, i64, i64, p, p, p, p, p, p]
            dll.lt_sample_states.restype = ctypes.c_int
            dll.lt_sample_states.argtypes = [p, i64, p, i64, p, p, p, p]
            dll.lt_devbuild_scratch_words.restype = i64
            dll.lt_devbuild_scratch_words.argtypes = [i64, i64]
            dll.lt_devbuild.restype = ctypes.c_int
            dll.lt_devbuild.argtypes = [
                p, p, p, p, p, p, i64, i64, i64, i64, p, p, p, p, p]
            dll.lt_chain_dp_windowed.restype = ctypes.c_int
            dll.lt_chain_dp_windowed_scratch.restype = i64
            dll.lt_chain_dp_windowed_scratch.argtypes = [i64, ctypes.c_int]
            dll.lt_chain_dp_windowed.argtypes = [
                p, p, i64, i64, ctypes.c_int, i64, i64, ctypes.c_int,
                p, p, p, p, p, p]
            dll.lt_seed_anchors.restype = ctypes.c_int
            dll.lt_seed_anchors.argtypes = [
                p, i64, i64, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i64,
                p, i64, p, i64, ctypes.c_int, i64, i64, p, p, p, p]
            dll.lt_compact_anchors.restype = ctypes.c_int
            dll.lt_compact_anchors_scratch_words.restype = i64
            dll.lt_compact_anchors_scratch_words.argtypes = [i64, i64]
            dll.lt_compact_anchors.argtypes = [
                p, p, i64, i64, ctypes.c_int, p, p, p, p]
            dll.lt_sort_anchors.restype = ctypes.c_int
            dll.lt_sort_anchors_scratch_bytes.restype = i64
            dll.lt_sort_anchors_scratch_bytes.argtypes = [i64, i64]
            dll.lt_sort_anchors.argtypes = [
                p, p, i64, i64, ctypes.c_int, ctypes.c_int, p, p, p, p]
            dll.lt_chain_dp_full.restype = ctypes.c_int
            dll.lt_chain_dp_full_scratch.restype = i64
            dll.lt_chain_dp_full_scratch.argtypes = [i64]
            dll.lt_chain_dp_full.argtypes = [
                p, p, i64, i64, i64, i64, ctypes.c_int, p, p, p, p, p]
            dll.lt_banded_align.restype = ctypes.c_int
            dll.lt_banded_align_scratch.restype = i64
            dll.lt_banded_align_scratch.argtypes = [i64, i64, ctypes.c_int]
            dll.lt_banded_align.argtypes = [
                p, p, p, i64, i64, ctypes.c_int, p, p, p]
            dll.lt_gap_anchors.restype = ctypes.c_int
            dll.lt_gap_anchors_scratch_words.restype = i64
            dll.lt_gap_anchors_scratch_words.argtypes = [
                i64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            dll.lt_gap_anchors.argtypes = [
                p, i64, p, p, p, i64, p, p, p, p, p, i64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p, p]
            dll.lt_cuda_error_string.restype = ctypes.c_char_p
            dll.lt_cuda_error_string.argtypes = [ctypes.c_int]
            _LIB = dll
        return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def seed_superchunk(wire: torch.Tensor, dir_start: torch.Tensor,
                    hs: torch.Tensor, cap: int, m_out: int) -> torch.Tensor:
    """Launch csrc/seed_superchunk.cu on PyTorch's current stream:
    wire (rows, pad/4 + 8) uint8 -> (rows, m_out + 1) int64. Does not
    synchronise; raises if the launch is refused. Any m_out >= 1: slots
    past the kernel's 4,096 in shared memory go to a device scratch, as do
    the staged bases of rows past 131,072 bases."""
    dev = wire.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA seeding kernel needs CUDA tensors, got {dev}")
    _check(wire, "wire", torch.uint8, 2, dev)
    _check(dir_start, "dir_start", torch.int32, 1, dev)
    _check(hs, "hs", torch.int64, 1, dev)
    rows, row_bytes = wire.shape
    if row_bytes <= 8:
        raise ValueError(f"wire rows of {row_bytes} bytes hold no bases")
    if not 0 < m_out < 1 << 31:
        raise ValueError(f"m_out {m_out} outside 1..2^31 - 1")
    if dir_start.numel() < 2 or hs.numel() < 1:
        raise ValueError("empty index tables")
    out = torch.empty((rows, m_out + 1), dtype=torch.int64, device=dev)
    dll = lib()
    extra = rows * dll.lt_seed_superchunk_scratch_slots(int(m_out))
    g_anc = (torch.empty((extra,), dtype=torch.int64, device=dev)
             if extra else None)
    g_keep = (torch.empty((extra,), dtype=torch.uint8, device=dev)
              if extra else None)
    words = rows * dll.lt_seed_superchunk_row_words(row_bytes)
    g_words = (torch.empty((words,), dtype=torch.int64, device=dev)
               if words else None)
    _launch("seed_superchunk", dev, dll.lt_seed_superchunk,
            wire.data_ptr(), rows, row_bytes, dir_start.data_ptr(),
            dir_start.numel(), hs.data_ptr(), hs.numel(), int(cap), int(m_out),
            g_words.data_ptr() if words else None,
            g_anc.data_ptr() if extra else None,
            g_keep.data_ptr() if extra else None, out.data_ptr())
    return out


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call a launcher of the library on dev's current stream (its last
    argument); raise if it reports a refused launch."""
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           + lib().lt_cuda_error_string(rc).decode())


def _cuda_device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA {what} kernel needs CUDA tensors, got "
                         f"{t.device}")
    return t.device


# the extension kernel's shared memory a warp (a read): the feature rows of
# up to EXT_SMEM_ROWS a strand (24 KB), the hits when H <= EXT_SMEM_HITS
# (8 KB) and the cords when C <= EXT_SMEM_CORDS (16 KB); four warps a block
# then take at most 192 KB of the SM's 227. Reads with more rows, and hits or
# cords that do not fit, use device memory through the same code.
EXT_SMEM_ROWS, EXT_SMEM_HITS, EXT_SMEM_CORDS = 1024, 1024, 2048


def filter_extend(packed: torch.Tensor, lens: torch.Tensor,
                  hits: torch.Tensor, n_hits: torch.Tensor,
                  gf_cat: torch.Tensor, gf_off: torch.Tensor,
                  gf_rows: torch.Tensor, C: int, R: int):
    """Launch csrc/filter_extend.cu: packed (B, pad/4) uint8, lens (B,)
    int64, hits (B, H) int64, n_hits (B,) int32, genome features (rows + 8,
    3) int32 with off / rows (G,) int32 -> (cords (B, C) int64, ncords (B,)
    int32, ovf (B,) bool). R must cover the pad's feature rows."""
    dev = _cuda_device(packed, "extension")
    _check(packed, "packed", torch.uint8, 2, dev)
    _check(lens, "lens", torch.int64, 1, dev)
    _check(hits, "hits", torch.int64, 2, dev)
    _check(n_hits, "n_hits", torch.int32, 1, dev)
    _check(gf_cat, "gf_cat", torch.int32, 2, dev)
    _check(gf_off, "gf_off", torch.int32, 1, dev)
    _check(gf_rows, "gf_rows", torch.int32, 1, dev)
    B, row_bytes = packed.shape
    H = hits.shape[1]
    if lens.shape[0] != B or hits.shape[0] != B or n_hits.shape[0] != B:
        raise ValueError("packed, lens, hits and n_hits differ in rows")
    if gf_cat.shape[1] != 3 or gf_off.shape != gf_rows.shape \
            or gf_off.numel() < 1:
        raise ValueError("malformed genome feature tables")
    if H < 1 or C < 1 or R < ((row_bytes * 4 - 48) >> 4) + 1:
        raise ValueError(f"H {H}, C {C}, R {R} do not fit pad "
                         f"{row_bytes * 4}")
    hs_smem = H if H <= EXT_SMEM_HITS else 0
    cs_smem = C if C <= EXT_SMEM_CORDS else 0
    rs_smem = min(R, EXT_SMEM_ROWS)
    rows = torch.empty((B, 2, R, 3) if R > rs_smem else (1,),
                       dtype=torch.int32, device=dev)
    work = torch.empty((B, H) if not hs_smem else (1,), dtype=torch.int64,
                       device=dev)
    cords = torch.empty((B, C), dtype=torch.int64, device=dev)
    ncords = torch.empty((B,), dtype=torch.int32, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    _launch("filter_extend", dev, lib().lt_filter_extend,
            packed.data_ptr(), B, row_bytes, lens.data_ptr(), hits.data_ptr(),
            H, n_hits.data_ptr(), gf_cat.data_ptr(), gf_off.data_ptr(),
            gf_rows.data_ptr(), gf_off.numel(), int(C), int(R), hs_smem,
            cs_smem, rs_smem, rows.data_ptr(), work.data_ptr(),
            cords.data_ptr(), ncords.data_ptr(), ovf.data_ptr())
    return cords, ncords, ovf


def sample_states(genome: torch.Tensor, j: torch.Tensor):
    """Launch the sample-states kernel of csrc/devbuild.cu: genome (L,)
    uint8, j (P,) int64 -> (xval, yval, strand), each (P,) int64."""
    dev = _cuda_device(genome, "devbuild")
    _check(genome, "genome", torch.uint8, 1, dev)
    _check(j, "j", torch.int64, 1, dev)
    out = [torch.empty_like(j) for _ in range(3)]
    _launch("sample_states", dev, lib().lt_sample_states, genome.data_ptr(),
            genome.numel(), j.data_ptr(), j.numel(),
            *(t.data_ptr() for t in out))
    return tuple(out)


def devbuild(xv, yv, st, jj, gid, block_start: torch.Tensor, q: int,
             omit_block: int, n_buckets: int):
    """Emission, stable radix sort, omission and compaction of
    csrc/devbuild.cu: the samples' (xv, yv, st, jj, gid) (N,) int64 and
    block starts (N,) uint8 -> (dir (n_buckets + 1,) int32, hs (max(N, 1),)
    int64 whose first stats[0] entries are the table, stats (2,) int64: kept
    samples, largest kept bucket). Nothing is read back; the scratch is freed
    on return (stream-ordered)."""
    dev = _cuda_device(xv, "devbuild")
    for t, name in ((xv, "xv"), (yv, "yv"), (st, "st"), (jj, "jj"),
                    (gid, "gid")):
        _check(t, name, torch.int64, 1, dev)
        if t.numel() != xv.numel():
            raise ValueError(f"{name} differs in length from xv")
    _check(block_start, "block_start", torch.uint8, 1, dev)
    n = xv.numel()
    if block_start.numel() != n:
        raise ValueError("xv and block_start differ in length")
    if n >= 1 << 31 or not 0 < n_buckets < 1 << 31 or q < 1 or omit_block < 0:
        raise ValueError(f"{n} samples, {n_buckets} buckets, q {q} or "
                         f"omit_block {omit_block} out of range")
    dll = lib()
    scratch = torch.empty((dll.lt_devbuild_scratch_words(n, n_buckets),),
                          dtype=torch.int64, device=dev)
    dirp = torch.empty((n_buckets + 1,), dtype=torch.int32, device=dev)
    hs = torch.empty((max(n, 1),), dtype=torch.int64, device=dev)
    stats = torch.empty((2,), dtype=torch.int64, device=dev)
    _launch("devbuild", dev, dll.lt_devbuild, xv.data_ptr(), yv.data_ptr(),
            st.data_ptr(), jj.data_ptr(), gid.data_ptr(),
            block_start.data_ptr(), n, int(q), int(omit_block), n_buckets,
            scratch.data_ptr(), dirp.data_ptr(), hs.data_ptr(),
            stats.data_ptr())
    return dirp, hs, stats


def chain_dp_windowed(anchors: torch.Tensor, n_anchors: torch.Tensor, W: int,
                      depth: int, dx_depth: int, score_type: int):
    """Launch csrc/chain_dp.cu: anchors (B, N) int64 sorted descending by
    anchor-x, n_anchors (B,) int32 -> (p2, score, length (B, N) int32,
    overflow (B,) bool). Any W >= 1: what of a read's ring, row table and
    edge tiles passes the kernel's shared-memory budgets goes to a device
    scratch (none at the Mapper's W 64 and N <= 8192)."""
    dev = _cuda_device(anchors, "chain DP")
    _check(anchors, "anchors", torch.int64, 2, dev)
    _check(n_anchors, "n_anchors", torch.int32, 1, dev)
    B, N = anchors.shape
    if n_anchors.shape[0] != B:
        raise ValueError("anchors and n_anchors differ in rows")
    if not (1 <= W < 1 << 31 and 1 <= N < 1 << 31):
        raise ValueError(f"W {W} or N {N} outside 1..2^31 - 1")
    if score_type not in (0, 1):
        raise ValueError(f"score_type {score_type}: use 0 or 1")
    p2, score, length = (torch.empty((B, N), dtype=torch.int32, device=dev)
                         for _ in range(3))
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    dll = lib()
    words = -(-dll.lt_chain_dp_windowed_scratch(N, int(W)) // 8)
    scratch = (torch.empty((B * words,), dtype=torch.int64, device=dev)
               if words else None)
    _launch("chain_dp_windowed", dev, dll.lt_chain_dp_windowed,
            anchors.data_ptr(), n_anchors.data_ptr(), B, N, int(W), int(depth),
            int(dx_depth), int(score_type),
            scratch.data_ptr() if words else None, p2.data_ptr(),
            score.data_ptr(), length.data_ptr(), overflow.data_ptr())
    return p2, score, length, overflow


def chain_dp_full(anchors: torch.Tensor, n_anchors: torch.Tensor,
                  depth: int, dx_depth: int, score_type: int):
    """Launch the full DP of csrc/chain_dp.cu: anchors (B, N) int64,
    n_anchors (B,) int32 -> (p2, score, length), each (B, N) int32. Rows
    wider than 18,944 anchors (anchor-x, y and score, 12 bytes each, beside
    the tiles in the 227 KB of shared memory a block may take) keep those
    tables in a device scratch."""
    dev = _cuda_device(anchors, "chain DP")
    _check(anchors, "anchors", torch.int64, 2, dev)
    _check(n_anchors, "n_anchors", torch.int32, 1, dev)
    B, N = anchors.shape
    if n_anchors.shape[0] != B:
        raise ValueError("anchors and n_anchors differ in rows")
    if not 1 <= N < 1 << 31:
        raise ValueError(f"N {N} outside 1..2^31 - 1")
    if score_type not in (0, 1):
        raise ValueError(f"score_type {score_type}: use 0 or 1")
    p2, score, length = (torch.empty((B, N), dtype=torch.int32, device=dev)
                         for _ in range(3))
    dll = lib()
    words = dll.lt_chain_dp_full_scratch(N) // 8
    scratch = (torch.empty((B * words,), dtype=torch.int64, device=dev)
               if words else None)
    _launch("chain_dp_full", dev, dll.lt_chain_dp_full, anchors.data_ptr(),
            n_anchors.data_ptr(), B, N, int(depth), int(dx_depth),
            int(score_type), scratch.data_ptr() if words else None,
            p2.data_ptr(), score.data_ptr(), length.data_ptr())
    return p2, score, length


def banded_align(a: torch.Tensor, bpad: torch.Tensor, nm: torch.Tensor,
                 W: int) -> torch.Tensor:
    """Launch csrc/banded_align.cu: a (B, L) and bpad (B, L + 2W) uint8,
    nm (B, 2) int32 -> scores (B,) int32, any 1 <= W < 2^30 and L >= 1. Up
    to BANDED_MAX_W (16,384) with L below BANDED_MAX_L (2^25) the band lives
    in the registers of at most 32 warps a pair; past either the wide kernel
    takes every pair, each row only on its diagonals inside the matrix, in a
    ring of min(2W, L + W + 1) + 1 ints a pair in shared memory or, past its
    budget, in a device scratch freed on return (stream-ordered)."""
    from .align_pallas import BANDED_WIDE_MAX_W

    dev = _cuda_device(a, "banded alignment")
    _check(a, "a", torch.uint8, 2, dev)
    _check(bpad, "bpad", torch.uint8, 2, dev)
    _check(nm, "nm", torch.int32, 2, dev)
    B, L = a.shape
    if not 1 <= W <= BANDED_WIDE_MAX_W or L < 1:
        raise ValueError(f"W {W} outside 1..{BANDED_WIDE_MAX_W}, or L {L} "
                         "< 1")
    if bpad.shape != (B, L + 2 * W) or nm.shape != (B, 2):
        raise ValueError(f"bpad {tuple(bpad.shape)} or nm {tuple(nm.shape)} "
                         f"do not fit a {tuple(a.shape)} at W {W}")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    dll = lib()
    ints = dll.lt_banded_align_scratch(B, L, int(W))
    scratch = (torch.empty((ints,), dtype=torch.int32, device=dev)
               if ints else None)
    _launch("banded_align", dev, dll.lt_banded_align, a.data_ptr(),
            bpad.data_ptr(), nm.data_ptr(), B, L, int(W),
            scratch.data_ptr() if ints else None, out.data_ptr())
    return out


def gap_anchors(gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp, a_lo, a_hi,
                g_max: int, r_max: int, cap: int, m_out: int):
    """Launch csrc/gap_anchors.cu: genome windows gseq (B, GW) and read
    windows rseq (B, RW) uint8, the (B,) int64 item scalars -> (anchors,
    keys (B, m_out) int64, count (B,) int32, overflow (B,) bool). Past the
    block-scan kernel's shared tables (g_max > 1024, r_max > 4096) the keyed
    kernel takes every item, its blocks each with a part of a device
    scratch; within them no scratch is needed."""
    from .gap_dev import SHAPE_LEN

    dev = _cuda_device(gseq, "gap anchor")
    _check(gseq, "gseq", torch.uint8, 2, dev)
    _check(rseq, "rseq", torch.uint8, 2, dev)
    B, GW = gseq.shape
    scalars = dict(g_n=g_n, gpos0=gpos0, r_n=r_n, rpos0=rpos0, rvcp=rvcp,
                   a_lo=a_lo, a_hi=a_hi)
    for name, t in scalars.items():
        _check(t, name, torch.int64, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} rows, gseq {B}")
    if rseq.shape[0] != B:
        raise ValueError("gseq and rseq differ in rows")
    RW = rseq.shape[1]
    if not (1 <= g_max < 1 << 28 and 1 <= r_max and 1 <= cap
            and r_max * cap < 1 << 31 and 1 <= m_out < 1 << 31):
        raise ValueError(f"g_max {g_max}, r_max {r_max}, cap {cap} or m_out "
                         f"{m_out} out of range")
    if GW < SHAPE_LEN or RW < SHAPE_LEN:
        raise ValueError(f"windows of {GW} and {RW} bases hold no 9-mer")
    out_a = torch.empty((B, m_out), dtype=torch.int64, device=dev)
    out_k = torch.empty((B, m_out), dtype=torch.int64, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    dll = lib()
    words = dll.lt_gap_anchors_scratch_words(B, int(g_max), int(r_max),
                                             int(cap))
    scratch = (torch.empty((words,), dtype=torch.int64, device=dev)
               if words else None)
    _launch("gap_anchors", dev, dll.lt_gap_anchors, gseq.data_ptr(), GW,
            g_n.data_ptr(), gpos0.data_ptr(), rseq.data_ptr(), RW,
            r_n.data_ptr(), rpos0.data_ptr(), rvcp.data_ptr(),
            a_lo.data_ptr(), a_hi.data_ptr(), B, int(g_max), int(r_max),
            int(cap), int(m_out), scratch.data_ptr() if words else None,
            out_a.data_ptr(),
            out_k.data_ptr(), count.data_ptr(), overflow.data_ptr())
    return out_a, out_k, count, overflow


def seed_anchors(seqs: torch.Tensor, lens: torch.Tensor,
                 dir_start: torch.Tensor, hs: torch.Tensor, cap: int,
                 thd_alpha: int, scan: bool, x_base: int = 0,
                 x_hi: int = (1 << 63) - 1):
    """Launch K1 (scan=True) or K2 of csrc/seed_anchors.cu: seqs (B, L)
    uint8, lens (B,) int64, dir_start int32, hs int64 -> (anchors (B, P,
    cap) int64, keep (B, P, cap) bool). K2 probes the xval shard
    [x_base, x_hi) that dir_start and hs hold."""
    from .seeding import SPAN, n_positions

    dev = _cuda_device(seqs, "seeding")
    _check(seqs, "seqs", torch.uint8, 2, dev)
    _check(lens, "lens", torch.int64, 1, dev)
    _check(dir_start, "dir_start", torch.int32, 1, dev)
    _check(hs, "hs", torch.int64, 1, dev)
    B, L = seqs.shape
    if lens.shape[0] != B:
        raise ValueError("seqs and lens differ in rows")
    if B > 65535:
        raise ValueError(f"{B} rows: at most 65535 a launch")
    if dir_start.numel() < 2 or hs.numel() < 1:
        raise ValueError("empty index tables")
    if not 1 <= cap <= 1 << 20 or thd_alpha < 1:
        raise ValueError(f"cap {cap} or thd_alpha {thd_alpha} out of range")
    P = n_positions(L, thd_alpha)
    anc = torch.empty((B, P, cap), dtype=torch.int64, device=dev)
    keep = torch.empty((B, P, cap), dtype=torch.bool, device=dev)
    # K1's pre-pass: k0, the init window's crh share and the x bias a read
    pre = torch.empty((3, B) if scan else (1,), dtype=torch.int64, device=dev)
    _launch("seed_anchors", dev, lib().lt_seed_anchors, seqs.data_ptr(), B,
            L, lens.data_ptr(), int(scan), SPAN + thd_alpha - 1, thd_alpha, P,
            dir_start.data_ptr(), dir_start.numel(), hs.data_ptr(),
            hs.numel(), int(cap), int(x_base), int(x_hi), pre.data_ptr(),
            anc.data_ptr(), keep.data_ptr())
    return anc, keep


def compact_anchors(anc: torch.Tensor, keep: torch.Tensor, m_out: int):
    """Launch K3 of csrc/seed_anchors.cu: anc (B, ...) int64 and keep of
    the same shape -> (out (B, m_out) int64, count (B,) int32). The scratch
    (a status word a chunk of 16,384 flags, and the ticket) is freed on
    return (stream-ordered)."""
    dev = _cuda_device(anc, "compaction")
    if anc.dim() < 1 or keep.shape != anc.shape:
        raise ValueError(f"anchors {tuple(anc.shape)} and keep "
                         f"{tuple(keep.shape)} differ")
    af = anc.reshape(anc.shape[0], -1)
    kf = keep.reshape(keep.shape[0], -1)
    _check(af, "anc", torch.int64, 2, dev)
    _check(kf, "keep", torch.bool, 2, dev)
    if not 0 < m_out < 1 << 31:
        raise ValueError(f"m_out {m_out} out of range")
    B, n = af.shape
    dll = lib()
    scratch = torch.empty((dll.lt_compact_anchors_scratch_words(B, n),),
                          dtype=torch.int64, device=dev)
    out = torch.empty((B, m_out), dtype=torch.int64, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch("compact_anchors", dev, dll.lt_compact_anchors, af.data_ptr(),
            kf.data_ptr(), B, n, int(m_out), scratch.data_ptr(),
            out.data_ptr(), count.data_ptr())
    return out, count


def sort_anchors(anc: torch.Tensor, keep: torch.Tensor, n_max: int):
    """Launch csrc/sort_anchors.cu: anc (B, ...) int64 and keep of the same
    shape -> (out (B, min(n_max, n)) int64, count (B,) int32), n the slots
    of a row. The scratch (the kept items, at most n a row, and the chunk
    counts: lt_sort_anchors_scratch_bytes) is freed on return
    (stream-ordered)."""
    dev = _cuda_device(anc, "anchor sort")
    if anc.dim() < 1 or keep.shape != anc.shape:
        raise ValueError(f"anchors {tuple(anc.shape)} and keep "
                         f"{tuple(keep.shape)} differ")
    af = anc.reshape(anc.shape[0], -1)
    kf = keep.reshape(keep.shape[0], -1)
    _check(af, "anc", torch.int64, 2, dev)
    _check(kf, "keep", torch.bool, 2, dev)
    B, n = af.shape
    if not 0 < n_max < 1 << 31 or not n < 1 << 31:
        raise ValueError(f"n_max {n_max} or a row of {n} slots out of range")
    n_out = min(int(n_max), n)
    dll = lib()
    scratch = torch.empty((-(-dll.lt_sort_anchors_scratch_bytes(B, n) // 8),),
                          dtype=torch.int64, device=dev)
    out = torch.empty((B, n_out), dtype=torch.int64, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch("sort_anchors", dev, dll.lt_sort_anchors, af.data_ptr(),
            kf.data_ptr(), B, n, n_out, int(n_max), scratch.data_ptr(),
            out.data_ptr(), count.data_ptr())
    return out, count
