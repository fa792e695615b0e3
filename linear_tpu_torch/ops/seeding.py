"""Device seeding of the default filter path: one fused kernel per superchunk.

Counterpart of linear_tpu.ops.seeding's block path (`_seed_superchunk_fused`
-> `batch_seed_anchors_compact`, with `_minimizer_xy_strided`,
`_probe_compact` and the mixed first column of `_closed_form_states`).

Per wire row (one read) and call position k = 35 + 15p (getDIndexMatchAll,
src/pmpfinder.cpp:1856; hashNextX, src/shape_extend.cpp:341):
  - GC-skew strand: x = 2*sum(b[k..k+21)) - 63 + bias, with the per-read
    bias 2*(sum b[0..20) - sum b[21..41)); x > 0 selects the forward pack;
  - minimizer: the smallest of 9 13-mer packs (MSB-first, strict `<`, so
    the lowest candidate wins ties) of the 21-base hash window, or of its
    reverse complement. The window is b[k..k+21), except at p = 0: there
    the rolling hash still holds the tail of its init window, b[14..20)
    followed by b[41..56);
  - YValue: the 4 bases after the chosen forward window, or the complements
    of the 4 before the reverse one (a forward base past the row reads 0);
  - dedup: positions whose xval equals the previous position's (0 before
    p = 0) are not probed; nor are positions with k >= len - 21;
  - probe: bucket [dir[x], dir[x+1]) clipped to cap entries; the entries
    of all positions, in order, take output slots 0, 1, ...; `probed`
    counts them before the y-check;
  - y-check `val == 0 || val < 4*(val & -val)` on val = y(entry) ^ yval,
    then val2Anchor (src/index_util.cpp:1509) with u64 wraparound and bit
    61 set or cleared;
  - in-order compaction of the kept slots below m_out.
Output row: anchors[:count], then the tail column count | probed << 32.
Only those are defined; probed > m_out means the row overflowed.

`seed_superchunk` launches the hand-written CUDA kernel
(csrc/seed_superchunk.cu) for CUDA tensors and runs
`seed_superchunk_reference`, the plain PyTorch version, for CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cordscalar import FLAG_STRAND, MASK_Y

SPAN = 21
WEIGHT = 13
THD_ALPHA = 15
FIRST = SPAN + THD_ALPHA - 1          # 35: the first call position
N_OFF = SPAN - WEIGHT + 1             # 9 minimizer candidates
# the p = 0 call's hash window keeps N_MIX bases of the init window
# b[SPAN-1-N_MIX .. SPAN-1) before the bases appended from 2*SPAN-1 on
N_MIX = 2 * SPAN - 1 - FIRST          # 6
MASK_W = (1 << (2 * WEIGHT)) - 1
MAX_M_OUT = 4096                      # the kernel keeps m_out slots in shared memory

# launches of the CUDA kernel by seed_superchunk in this process
launches = 0


@dataclass(frozen=True)
class DeviceIndex:
    """The DIndex tables on one torch device."""

    dir_start: torch.Tensor  # int32[4^weight + 1] exclusive-prefix bucket offsets
    hs: torch.Tensor         # int64[n]: bit patterns of the uint64 cords
    cap: int                 # max entries probed per bucket

    @property
    def device(self) -> torch.device:
        return self.dir_start.device


def bucket_cap(cap: int) -> int:
    """Round a per-bucket entry cap up to a multiple of 32 (>= 32), as
    linear_tpu.ops.seeding.bucket_cap does; extra slots are masked by the
    per-bucket count."""
    return max(-(-cap // 32) * 32, 32)


def upload_index(dir_np: np.ndarray, hs_np: np.ndarray, device) -> DeviceIndex:
    """Host DIndex numpy arrays -> device tensors. cap = the largest bucket
    (buckets above thd_omit_block were dropped at build), rounded by
    bucket_cap. On the CPU the tensors share the numpy buffers."""
    device = torch.device(device)
    counts = np.diff(dir_np)
    cap = bucket_cap(int(counts.max()) if len(hs_np) else 1)
    dir_t = torch.from_numpy(np.ascontiguousarray(dir_np, dtype=np.int32))
    # an empty table still needs one (never read) entry for the clamps
    hs64 = np.ascontiguousarray(hs_np, dtype=np.uint64).view(np.int64)
    hs_t = torch.from_numpy(hs64 if len(hs64) else np.zeros(1, np.int64))
    return DeviceIndex(dir_start=dir_t.to(device), hs=hs_t.to(device), cap=cap)


def pack_superchunk(reads: list, pad_len: int, rows: int):
    """Wire of <= rows reads: (rows, pad/4 + 8) uint8, 2-bit LSB-first bases
    plus 8 little-endian length bytes per row (the native packer). Rows of
    reads with N are zero on the wire and flagged in the returned n_mask:
    their device result is discarded and the worker seeds them on the host.
    Returns (wire, n_mask)."""
    from ..map import nengine as NE

    return NE.pack_superchunk_native(reads, pad_len, rows)


def _unpack_wire(wire: torch.Tensor):
    """(rows, pad/4 + 8) uint8 wire -> (bases (rows, pad) int64, lens
    (rows,) int64)."""
    rows = wire.shape[0]
    pk = wire[:, :-8].to(torch.int64)
    seqs = torch.stack([(pk >> (2 * i)) & 3 for i in range(4)],
                       dim=-1).reshape(rows, -1)
    shift = torch.arange(8, dtype=torch.int64, device=wire.device) * 8
    lens = (wire[:, -8:].to(torch.int64) << shift).sum(dim=1)
    return seqs, lens


def _minimizer(v: torch.Tensor):
    """The first minimum (strict <) of the nine 13-mer packs, MSB-first,
    of 42-bit window packs v: (xval, index of the chosen candidate)."""
    xval = torch.full_like(v, 1 << (2 * WEIGHT))
    tsel = torch.zeros_like(v)
    for idx in range(N_OFF):
        cand = (v >> (2 * (N_OFF - 1 - idx))) & MASK_W
        better = cand < xval
        xval = torch.where(better, cand, xval)
        tsel = torch.where(better, idx, tsel)
    return xval, tsel


def minimizer_xy_at(genome: torch.Tensor, j: torch.Tensor):
    """Minimizer state of the pure 21-base windows genome[j .. j + 21) of
    a device genome (L,) of codes 0..3, as the DIndex build samples them
    (linear_tpu.ops.devbuild._sample_states through _minimizer_xy_batch):
    strand = (2 * sum(window) - 63 <= 0), xval the first minimum of the nine
    13-mer packs of the window (or of its reverse complement), yval the 4
    bases after the chosen forward pack, or the complements of the 4 before
    the reverse one (a base outside the genome reads 0). Returns (xval,
    yval, strand), each (P,) int64."""
    g = genome.to(torch.int64)
    L = g.shape[0]
    win = g[(j[:, None] + torch.arange(SPAN, device=g.device)).clamp(0, L - 1)]
    h = torch.zeros_like(j)
    crh = torch.zeros_like(j)
    for t in range(SPAN):
        h = (h << 2) | win[:, t]
        crh = crh | ((3 - win[:, t]) << (2 * t))
    fwd = 2 * win.sum(dim=1) - 3 * SPAN > 0
    xval, tsel = _minimizer(torch.where(fwd, h, crh))

    def base(p):
        return torch.where((p >= 0) & (p < L), g[p.clamp(0, L - 1)], 0)

    yval = torch.zeros_like(j)
    for i in range(4):
        vf = base(j + tsel + WEIGHT + i)
        vr = 3 - base(j + SPAN - WEIGHT - 1 - tsel - i)
        yval = (yval << 2) + torch.where(fwd, vf, vr)
    return xval, yval, (~fwd).to(torch.int64)


def seed_superchunk_reference(wire: torch.Tensor, dir_start: torch.Tensor,
                              hs: torch.Tensor, cap: int,
                              m_out: int) -> torch.Tensor:
    """Plain PyTorch version of the fused superchunk seeding (see the module
    docstring): wire (rows, pad/4 + 8) uint8 -> (rows, m_out + 1) int64.
    Runs on any device; uint64 values are int64 bit patterns, and every
    right shift of a value that may have bit 63 set is masked."""
    dev = wire.device
    seqs, lens = _unpack_wire(wire)
    rows, L = seqs.shape
    # zero right padding so every strided base column is a plain slice
    seqs_p = torch.nn.functional.pad(seqs, (0, SPAN + 8))
    ks = torch.arange(FIRST, L, THD_ALPHA, dtype=torch.int64, device=dev)
    P = ks.shape[0]
    last = FIRST + THD_ALPHA * (P - 1) + 1
    # cols[j][r, p] = b[r, k_p + j]
    cols = [seqs_p[:, FIRST + j: last + j: THD_ALPHA] for j in range(SPAN)]
    head = seqs_p[:, : 2 * SPAN - 1]
    bias = 2 * (head[:, : SPAN - 1].sum(1) - head[:, SPAN:].sum(1))
    x = 2 * torch.stack(cols).sum(0) - 3 * SPAN + bias[:, None]
    fwd = x > 0
    # hash windows: the p = 0 column holds the mixed init-tail window
    h = torch.zeros((rows, P), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(h)
    for t in range(SPAN):
        w = cols[t]
        if t < N_MIX:
            w = w.clone()
            w[:, 0] = seqs_p[:, SPAN - 1 - N_MIX + t]
        h = (h << 2) | w
        rc = rc | ((3 - w) << (2 * t))
    xval, tsel = _minimizer(torch.where(fwd, h, rc))
    kmat = ks[None, :].expand(rows, P)
    yval = torch.zeros_like(xval)
    for i in range(4):
        vf = torch.gather(seqs_p, 1, kmat + tsel + WEIGHT + i)
        vr = 3 - torch.gather(seqs_p, 1, kmat + SPAN - WEIGHT - 1 - tsel - i)
        yval = (yval << 2) + torch.where(fwd, vf, vr)
    strand = (~fwd).to(torch.int64)

    # compact probe: entries of the processed positions take slots in order
    prev = torch.nn.functional.pad(xval[:, :-1], (1, 0))
    process = (xval != prev) & (kmat < (lens[:, None] - SPAN))
    xc = xval.clamp(0, dir_start.shape[0] - 2)
    lo = dir_start[xc].to(torch.int64)
    hi = dir_start[xc + 1].to(torch.int64)
    cnt = torch.where(process, torch.clamp(hi - lo, max=cap),
                      torch.zeros_like(lo))
    off = torch.cumsum(cnt, dim=1)
    probed = off[:, -1]
    off_excl = off - cnt
    slots = torch.arange(m_out, dtype=torch.int64, device=dev)
    slots_b = slots[None, :].expand(rows, m_out).contiguous()
    pos = torch.searchsorted(off, slots_b, right=True).clamp(0, P - 1)

    def take(a):
        return torch.gather(a, 1, pos)

    ent_idx = (take(lo) + slots[None, :] - take(off_excl)).clamp(
        0, hs.shape[0] - 1)
    ent = hs[ent_idx]
    ent_y = ent & MASK_Y
    val = ent_y ^ take(yval)
    y_ok = (val == 0) | (val < ((val & -val) << 2))
    keep = (slots[None, :] < probed[:, None]) & y_ok
    k_s = take(kmat)
    same = ((ent >> 61) & 1) == take(strand)
    cordy = torch.where(same, k_s, lens[:, None] - 1 - k_s)
    anc = ent - (cordy << 20) + cordy - ent_y
    anc = torch.where(same, anc & ~FLAG_STRAND, anc | FLAG_STRAND)
    # stable in-order compaction of the kept slots
    keys = torch.where(keep, slots_b, torch.full_like(slots_b, m_out))
    order = torch.sort(keys, dim=1, stable=True).indices
    svals = torch.gather(anc, 1, order)
    count = keep.sum(dim=1)
    tail = count | (probed << 32)
    return torch.cat([svals, tail[:, None]], dim=1)


def seed_superchunk(wire: torch.Tensor, index: DeviceIndex,
                    m_out: int) -> torch.Tensor:
    """One superchunk: wire (rows, pad/4 + 8) uint8 -> (rows, m_out + 1)
    int64 (anchors | count | probed << 32). CUDA tensors launch the
    hand-written kernel (and count the launch); CPU tensors run the plain
    PyTorch version. Anything else raises."""
    global launches
    if wire.device != index.device:
        raise ValueError(f"wire on {wire.device}, index on {index.device}")
    if wire.device.type == "cuda":
        from . import _cuda

        out = _cuda.seed_superchunk(wire, index.dir_start, index.hs,
                                    index.cap, m_out)
        launches += 1
        return out
    if wire.device.type == "cpu":
        return seed_superchunk_reference(wire, index.dir_start, index.hs,
                                         index.cap, m_out)
    raise ValueError(f"no seeding kernel for device {wire.device}")


@dataclass
class WireHandle:
    """One dispatched superchunk: the (rows, m_out + 1) result in host
    memory, valid once `done` (a CUDA event, None on the CPU) has fired.
    `wire` keeps the pinned input alive until the copy has run."""

    out: torch.Tensor
    done: "torch.cuda.Event | None"
    wire: torch.Tensor


def dispatch_wire(wire: np.ndarray, index: DeviceIndex,
                  m_out: int) -> WireHandle:
    """Enqueue one packed superchunk (from pack_superchunk): on CUDA one
    pinned non_blocking h2d, the kernel, one non_blocking d2h into pinned
    memory and an event, with no sync; on the CPU the plain version runs
    now."""
    host = torch.from_numpy(wire)
    if index.device.type == "cpu":
        return WireHandle(seed_superchunk(host, index, m_out), None, host)
    host = host.pin_memory()
    fused = seed_superchunk(host.to(index.device, non_blocking=True), index,
                            m_out)
    out = torch.empty(fused.shape, dtype=fused.dtype, pin_memory=True)
    out.copy_(fused, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return WireHandle(out, done, host)


def collect_wire(handle: WireHandle, n_valid: int, n_mask: np.ndarray,
                 m_out: int):
    """Wait for one dispatch_wire handle. Returns (anchors, overflow):
    anchors is a length-n_valid list of uint64 arrays, None for reads with
    N AND for overflowed ones; overflow marks the reads whose probe
    exceeded m_out, so callers can redispatch them at a larger m_out tier
    instead of seeding them on the host."""
    if handle.done is not None:
        handle.done.synchronize()
    arr = handle.out.numpy()
    anc = arr[:, :-1].view(np.uint64)
    count = (arr[:, -1] & 0xFFFFFFFF).astype(np.int64)
    probed = (arr[:, -1] >> 32).astype(np.int64)
    res: list = []
    overflow = np.zeros(n_valid, dtype=bool)
    for i in range(n_valid):
        if n_mask[i]:
            res.append(None)
        elif probed[i] > m_out:
            res.append(None)
            overflow[i] = True
        else:
            res.append(anc[i, : count[i]].copy())
    return res, overflow
