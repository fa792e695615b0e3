"""DIndex build on the device, for genomes without N.

Counterpart of linear_tpu.ops.devbuild (`_sample_states`,
`_emit_count_sort`, `build_dindex_device`; reference createDIndex,
src/index_util.cpp:1628-1803). The tables equal the host build's
(index.dindex.build_dindex) bit for bit; genomes with N bases raise,
because the reference's N-skip re-init is scan-order dependent, and the
caller uploads the host build instead.

  samples       per genome and per `thread_blocks` block of -t, positions
                j = t_str + 8, then every 9; the minimizer state of the pure
                21-base window at j (ops.seeding.minimizer_xy_at)
  emission      a run starts where xval changes or at a block start; sample
                i is emitted where (i - start of its run) % q == 0, q = 2
  counting sort buckets of more than omit_block (400) emitted samples are
                dropped; dir = exclusive prefix sum of the kept counts
                (4^13 + 1 int32); hs = the kept samples' cords, ordered by
                (xval, cord), which is the order of a stable sort of the
                kept samples by 2 * xval + strand (samples come in (gid, j)
                order and j is unique within a genome; the CUDA build sorts
                so)

`sample_states` and `emit_count_sort` launch the hand-written CUDA kernels
(csrc/devbuild.cu) for CUDA tensors and run the plain PyTorch versions,
`ops.seeding.minimizer_xy_at` and `emit_count_sort_reference`, for CPU
tensors.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..index.dindex import (DEFAULT_MAX_STEP, DEFAULT_MIN_STEP,
                            DEFAULT_OMIT_BLOCK, DEFAULT_SPAN, DEFAULT_WEIGHT,
                            DIndex, thread_blocks)
from . import seeding as SD

CONST_ANCHOR_ZERO = 1 << 20
N_BUCKETS = 1 << (2 * DEFAULT_WEIGHT)
STRIDE = DEFAULT_MIN_STEP + 1
Q = DEFAULT_MAX_STEP // STRIDE + 1

# launches of the CUDA build kernels (sample_states, emit_count_sort) in
# this process
launches = 0


def emit_count_sort_reference(xv, yv, st, jj, gid, block_start,
                              omit_block: int = DEFAULT_OMIT_BLOCK):
    """Plain version of the emission + counting sort: (dir (4^13 + 1,)
    int32, hs (n_kept,) int64, largest kept bucket)."""
    n = xv.shape[0]
    idx = torch.arange(n, device=xv.device)
    prev = torch.nn.functional.pad(xv[:-1], (1, 0), value=-1)
    run_start = (xv != prev) | block_start.bool()
    start = torch.cummax(torch.where(run_start, idx, 0), dim=0).values
    emit = (idx - start) % Q == 0
    counts = torch.bincount(xv[emit], minlength=N_BUCKETS)
    omitted = counts > omit_block
    kept_counts = torch.where(omitted, 0, counts)
    dirp = torch.nn.functional.pad(torch.cumsum(kept_counts, 0), (1, 0))
    cord = (((gid << 30) + (jj + CONST_ANCHOR_ZERO)) << 20) + yv + (st << 61)
    kept = emit & ~omitted[xv]
    # (xval, cord) order: a stable sort by xval of the cords sorted by value
    xk, ck = xv[kept], cord[kept]
    ck, o = torch.sort(ck)
    order = torch.sort(xk[o], stable=True).indices
    return (dirp.to(torch.int32), ck[order],
            int(kept_counts.max()) if n else 0)


def sample_states(genome: torch.Tensor, j: torch.Tensor):
    """(xval, yval, strand) at positions j of a device genome. CUDA
    tensors launch the kernel (and count the launch), CPU tensors run the
    plain version."""
    global launches
    if genome.device != j.device:
        raise ValueError(f"genome on {genome.device}, j on {j.device}")
    if genome.device.type == "cuda":
        from . import _cuda

        out = _cuda.sample_states(genome, j)
        launches += 1
        return out
    if genome.device.type == "cpu":
        return SD.minimizer_xy_at(genome, j)
    raise ValueError(f"no devbuild kernel for device {genome.device}")


def emit_count_sort(xv, yv, st, jj, gid, block_start,
                    omit_block: int = DEFAULT_OMIT_BLOCK):
    """(dir, hs, largest kept bucket) of the samples; see the module
    docstring. CUDA tensors launch the kernels (one count), CPU tensors
    run the plain version. Reads two scalars back once, after every launch
    (kept samples and the largest bucket), never the tables."""
    global launches
    dev = xv.device
    if dev.type == "cuda":
        from . import _cuda

        dirp, hs, stats = _cuda.devbuild(xv, yv, st, jj, gid,
                                         block_start.to(torch.uint8), Q,
                                         omit_block, N_BUCKETS)
        launches += 1
        n_kept, largest = stats.tolist()
        return dirp, hs[:n_kept], largest
    if dev.type == "cpu":
        return emit_count_sort_reference(xv, yv, st, jj, gid, block_start,
                                         omit_block)
    raise ValueError(f"no devbuild kernel for device {dev}")


def _samples(seq_len: int, threads: int):
    """Sample positions of one genome and the first sample of each block."""
    js, starts = [], []
    for t_str, t_end in thread_blocks(seq_len, DEFAULT_SPAN, threads):
        j = np.arange(t_str + DEFAULT_MIN_STEP, t_end, STRIDE, dtype=np.int64)
        if len(j):
            s = np.zeros(len(j), dtype=np.uint8)
            s[0] = 1
            js.append(j)
            starts.append(s)
    if not js:
        return np.zeros(0, np.int64), np.zeros(0, np.uint8)
    return np.concatenate(js), np.concatenate(starts)


def build_dindex_device(seqs: List[np.ndarray], device, threads_emul: int):
    """The DIndex of `seqs` built on `device` as -t threads_emul samples
    it: (dir (4^13 + 1,) int32, hs (n,) int64, largest bucket), all but the
    last on the device. Raises ValueError, before any device work, when a
    genome has N."""
    for seq in seqs:
        if (np.asarray(seq) == 4).any():
            raise ValueError("the device DIndex build needs genomes "
                             "without N")
    device = torch.device(device)
    parts = []
    for gid, seq in enumerate(seqs):
        j, bs = _samples(len(seq), threads_emul)
        if not len(j):
            continue
        g = torch.from_numpy(np.ascontiguousarray(seq, dtype=np.uint8))
        j_t = torch.from_numpy(j).to(device)
        xv, yv, st = sample_states(g.to(device), j_t)
        parts.append((xv, yv, st, j_t, torch.full_like(j_t, gid),
                      torch.from_numpy(bs).to(device)))
    if not parts:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        parts = [(z, z, z, z, z, z.to(torch.uint8))]
    cols = [torch.cat(c) for c in zip(*parts)]
    return emit_count_sort(*cols)


def device_build_to_index(dirp: torch.Tensor, hs: torch.Tensor,
                          largest: int) -> SD.DeviceIndex:
    """The built tables as the seeding's DeviceIndex, without a host round
    trip: cap = bucket_cap(largest bucket)."""
    return SD.DeviceIndex(dir_start=dirp, hs=hs if len(hs) else
                          torch.zeros(1, dtype=torch.int64, device=hs.device),
                          cap=SD.bucket_cap(max(largest, 1)))


def build_dindex_device_host(seqs: List[np.ndarray], device,
                             threads_emul: int) -> DIndex:
    """The device build fetched back as a host DIndex (for the tests)."""
    dirp, hs, _ = build_dindex_device(seqs, device, threads_emul)
    return DIndex(span=DEFAULT_SPAN, weight=DEFAULT_WEIGHT,
                  dir=dirp.cpu().numpy(),
                  hs=hs.cpu().numpy().view(np.uint64))
