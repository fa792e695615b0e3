"""Multi-process mapping over torch.distributed (counterpart of
linear_tpu.parallel.mesh).

One process (rank) a device. A Mesh lays the ranks of the default process
group out as a grid with named dims, ("dp",), ("ix",) or ("dp", "ix"), rank
r at coordinates unravel(r, shape) (row-major, as JAX's grid mesh reshapes
its device list), with one process group for every line of the grid along
each dim:
  dp  the read batch is cut into contiguous row blocks, one a dp index;
  ix  the DIndex is cut by xval range (shard_index_by_xval), one shard an ix
      index. A rank probes its shard only, and a sum over its ix group
      (JAX's psum, mesh.py:137-138) merges the shards: every (position,
      slot) belongs to one shard, and the others hold anchor 0 and keep 0
      there (ops.seeding's padded kernels zero the slots they do not keep).
Every rank holds the global batch, as JAX's gput serves each device its
slice of the full numpy array; a step moves the rank's rows to its device
and returns the rank's rows. gather() assembles the global rows on the
host. A Mesh of one rank runs every step without a collective.

The seeding runs ops.seeding's kernels (K1 scan, K2 closed form with the
shard mask), the sort ops.chain_dp.sort_anchors, the chain DP
ops.chain_dp.chain_dp_windowed (W = 64) and the
extension ops.extend_dev.filter_extend: their CUDA kernels on CUDA tensors,
their plain versions on CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import chain_dp as CD
from ..ops import extend_dev as ED
from ..ops import seeding as SD


class Mesh:
    """This rank's place in a grid of the default process group's ranks,
    with the process group of its line along each dim of size > 1."""

    def __init__(self, shape: Sequence[int], names: Sequence[str], device):
        import torch.distributed as dist

        if len(shape) != len(names):
            raise ValueError(f"shape {shape} and names {names} differ")
        up = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if up else 1
        rank = dist.get_rank() if up else 0
        if int(np.prod(shape)) != world:
            raise ValueError(f"a {tuple(shape)} mesh needs {int(np.prod(shape))}"
                             f" ranks, the process group has {world}")
        self.shape: Dict[str, int] = dict(zip(names, map(int, shape)))
        self.device = torch.device(device)
        self.rank = rank
        self.coords = dict(zip(names, map(int, np.unravel_index(rank, shape))))
        self.groups: Dict[str, object] = {}
        grid = np.arange(world).reshape(tuple(shape))
        for axis, name in enumerate(names):
            if self.shape[name] == 1:
                continue
            # every rank creates every group, in the same order
            for line in np.moveaxis(grid, axis, -1).reshape(-1, shape[axis]):
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    self.groups[name] = g

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def coord(self, name: str) -> int:
        return self.coords.get(name, 0)


def make_dp_mesh(device, axis: str = "dp") -> Mesh:
    """All ranks along one dim (reads data-parallel by default)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh((world,), (axis,), device)


def make_grid_mesh(n_dp: int, n_ix: int, device) -> Mesh:
    """The (dp, ix) grid: reads over dp, the DIndex's xval shards over
    ix; n_dp * n_ix must be the world size."""
    return Mesh((n_dp, n_ix), ("dp", "ix"), device)


def _backend(group) -> str:
    import torch.distributed as dist

    return dist.get_backend(group)


def _psum(t: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """all_reduce(SUM) of t over the rank's group along `name`. gloo
    reduces host memory, so a CUDA tensor goes to the host for it and
    back, explicitly."""
    import torch.distributed as dist

    if mesh.size(name) == 1:
        return t
    g = mesh.groups[name]
    if t.is_cuda and _backend(g) == "gloo":
        h = t.cpu()
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=g)
        return h.to(t.device)
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def gather(mesh: Mesh, t: torch.Tensor, name: str = "dp") -> torch.Tensor:
    """The global rows of a step's output: all_gather of every rank's rows
    over its group along `name`, concatenated in coordinate order, on the
    host. gloo gathers host tensors, so a CUDA tensor goes to the host
    first."""
    import torch.distributed as dist

    if mesh.size(name) == 1:
        return t.cpu()
    g = mesh.groups[name]
    is_bool = t.dtype == torch.bool
    src = (t.to(torch.uint8) if is_bool else t).contiguous()
    if _backend(g) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size(name))]
    dist.all_gather(parts, src, group=g)
    out = torch.cat(parts).cpu()
    return out.bool() if is_bool else out


def local_rows(mesh: Mesh, arr) -> torch.Tensor:
    """The rank's contiguous block of rows of a global batch (numpy or
    torch), on the rank's device. The row count must divide by the dp
    size."""
    t = torch.as_tensor(arr)
    n_dp = mesh.size("dp")
    if t.shape[0] % n_dp:
        raise ValueError(f"{t.shape[0]} rows do not split over dp {n_dp}")
    bs = t.shape[0] // n_dp
    d = mesh.coord("dp")
    return t[d * bs: (d + 1) * bs].contiguous().to(mesh.device)


def _on(mesh: Mesh, arr) -> torch.Tensor:
    return torch.as_tensor(arr).contiguous().to(mesh.device)


# ------------------------------------------------------------- single device


def sort_chain(anc: torch.Tensor, keep: torch.Tensor, n_max: int):
    """The anchor sort (ops.chain_dp.sort_anchors: descending anchor-x, the
    first n_max), then the windowed chain DP (W = 64): (sorted anchors,
    n_anchors, p2, score, length, overflow)."""
    sorted_anc, n_anchors = CD.sort_anchors(anc, keep, n_max)
    p2, score, length, overflow = CD.chain_dp_windowed(sorted_anc, n_anchors,
                                                        W=64)
    return sorted_anc, n_anchors, p2, score, length, overflow


def mapping_step(seqs, lens, dir_start, hs, cap: int = 8, n_max: int = 256,
                 thd_alpha: int = SD.THD_ALPHA, fast: bool = False):
    """The device mapping step of one batch (seqs (B, L) uint8, lens (B,)
    int64, on the index's device): seed (K1 scan, or K2 closed form with
    fast=True, exact for N-free reads), sort descending by anchor-x, chain.
    Returns (anchors_sorted, n_anchors, p2, score, length, overflow)."""
    seeder = SD.batch_seed_anchors_fast if fast else SD.batch_seed_anchors
    anc, keep = seeder(seqs, lens, dir_start, hs, cap, thd_alpha)
    return sort_chain(anc, keep, n_max)


# ------------------------------------------------------------- across ranks


def shard_index_by_xval(index, n_shards: int):
    """Split a host DIndex (its `dir` and `hs`) into n_shards contiguous
    xval ranges: shard s holds dir[x_lo .. x_hi] rebased to 0 and the hs
    slice it points into, padded to a common size. Returns (dir_sh
    (n_shards, .) int64, hs_sh (n_shards, .) uint64, x_base (n_shards, 2)
    int64 of (x_lo, x_hi), cap), as linear_tpu's with hs unsplit."""
    n_x = index.dir.shape[0] - 1
    bounds = [n_x * s // n_shards for s in range(n_shards + 1)]
    dir_len = max(bounds[s + 1] - bounds[s] for s in range(n_shards)) + 1
    hs_len = max(1, max(int(index.dir[bounds[s + 1]] - index.dir[bounds[s]])
                        for s in range(n_shards)))
    dir_sh = np.zeros((n_shards, dir_len), dtype=np.int64)
    hs_sh = np.zeros((n_shards, hs_len), dtype=np.uint64)
    x_base = np.zeros((n_shards, 2), dtype=np.int64)
    for s in range(n_shards):
        b0, b1 = bounds[s], bounds[s + 1]
        d = index.dir[b0: b1 + 1].astype(np.int64) - int(index.dir[b0])
        dir_sh[s, : len(d)] = d
        dir_sh[s, len(d):] = d[-1]
        sl = index.hs[index.dir[b0]: index.dir[b1]]
        hs_sh[s, : len(sl)] = sl
        x_base[s] = (b0, b1)
    counts = np.diff(index.dir)
    cap = SD.bucket_cap(int(counts.max()) if len(index.hs) else 1)
    return dir_sh, hs_sh, x_base, cap


@dataclass(frozen=True)
class IndexShard:
    """One xval shard of the DIndex on a rank's device."""

    dir_start: torch.Tensor  # int32: bucket offsets of [x_base, x_hi), rebased
    hs: torch.Tensor         # int64 bit patterns of the shard's cords
    x_base: int
    x_hi: int
    cap: int


def local_index_shard(mesh: Mesh, shards) -> IndexShard:
    """The rank's shard (its ix coordinate) of shard_index_by_xval's
    output, on its device; dir goes to int32 (the kernels' type) once
    here."""
    dir_sh, hs_sh, x_base, cap = shards
    s = mesh.coord("ix")
    d = dir_sh[s]
    if int(d.max()) >= 1 << 31:
        raise ValueError("an index shard of 2^31 or more entries")
    return IndexShard(
        dir_start=_on(mesh, np.ascontiguousarray(d, dtype=np.int32)),
        hs=_on(mesh, np.ascontiguousarray(hs_sh[s]).view(np.int64)),
        x_base=int(x_base[s, 0]), x_hi=int(x_base[s, 1]), cap=int(cap))


def _merge_ix(mesh: Mesh, anc: torch.Tensor, keep: torch.Tensor):
    """The psum merge of the per-shard grids (linear_tpu/parallel/
    mesh.py:137-138); anchors are already 0 where keep is False."""
    anc = _psum(anc, mesh, "ix")
    keep = _psum(keep.to(torch.int32), mesh, "ix") > 0
    return anc, keep


def index_sharded_seed_step(mesh: Mesh, seqs, lens, shard: IndexShard,
                            thd_alpha: int = SD.THD_ALPHA):
    """Closed-form seeding with the batch replicated and the index sharded
    over the mesh's "ix" dim: each rank probes its xval range, one sum over
    ix merges them, bit for bit the unsharded kernel's output. Returns
    (anchors, keep) of the whole batch, (B, P, cap)."""
    anc, keep = SD.batch_seed_anchors_fast(
        _on(mesh, seqs), _on(mesh, lens), shard.dir_start, shard.hs,
        shard.cap, thd_alpha, shard.x_base, shard.x_hi)
    return _merge_ix(mesh, anc, keep)


def sharded_mapping_step(mesh: Mesh, seqs, lens, dir_start, hs,
                         cap: int = 8, n_max: int = 256):
    """mapping_step (scan seeding) on the rank's dp rows with the whole
    index on every rank; no collective. Returns the rank's rows."""
    return mapping_step(local_rows(mesh, seqs), local_rows(mesh, lens),
                        _on(mesh, dir_start), _on(mesh, hs), cap=cap,
                        n_max=n_max)


def grid_seed_anchors(mesh: Mesh, seqs, lens, shard: IndexShard,
                      thd_alpha: int = SD.THD_ALPHA):
    """The seed and merge phase of grid_mapping_step: the rank's dp rows,
    probed in its ix shard, summed over ix. Returns (anchors, keep) of the
    rank's rows, (B / n_dp, P, cap), in emission-slot order: a read's
    host seeds are anc[b][keep[b]]."""
    anc, keep = SD.batch_seed_anchors_fast(
        local_rows(mesh, seqs), local_rows(mesh, lens), shard.dir_start,
        shard.hs, shard.cap, thd_alpha, shard.x_base, shard.x_hi)
    return _merge_ix(mesh, anc, keep)


def grid_mapping_step(mesh: Mesh, seqs, lens, shard: IndexShard,
                      n_max: int = 256, thd_alpha: int = SD.THD_ALPHA):
    """The mapping step on a (dp, ix) grid: grid_seed_anchors, then the
    descending anchor-x sort and the chain DP of the rank's rows. Equal to
    mapping_step(fast=True) of those rows on one device."""
    return sort_chain(*grid_seed_anchors(mesh, seqs, lens, shard, thd_alpha),
                      n_max)


def sharded_extend_step(mesh: Mesh, packed, lens, hits, n_hits,
                        gf: ED.GenomeFeats, C: int):
    """_filterHits + path_dst_2 (ops.extend_dev) on the rank's dp rows,
    with the genome features (on the rank's device) whole on every rank.
    Returns the rank's (cords, ncords, ovf)."""
    return ED.filter_extend(local_rows(mesh, packed), local_rows(mesh, lens),
                            local_rows(mesh, hits), local_rows(mesh, n_hits),
                            gf, C)
