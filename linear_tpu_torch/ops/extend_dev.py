"""Device dense-window extension of the -b 0 path: _filterHits + path_dst_2.

Counterpart of linear_tpu.ops.extend_dev (`batch_filter_extend_packed`,
with `_revcomp_batch`, `_read_feats`, `_serial_rows`, `_sdist`,
`_filter_hits_batch` and the `_path_dst_2_batch` interpreter). The spec is
the C++ in native/src/le_pmp.hpp: filter_hits (:249), path_dst_2
(:180) and extend_window / previous_window / next_window (:36-118), with
the read features of create_features_read (le_feats.hpp:69).

Per read of a batch (packed bases, length, pre-filter hits from the native
first pass, NativeEngine.apx_hits):
  - features: the 2_48 scripts of the read and of its reverse complement,
    one row per 16 bases over a 48-base window; the read's last 2-mer
    reads base A past its end. Only the serial count n1 = 1 + max(0,
    (len - 50) >> 4) of rows is valid (0 below 48 bases);
  - filter_hits: hits whose bounds-checked window distance is >= 50 are
    dropped in place; a dropped hit's end flag lands on the slot before it
    (possibly the header);
  - path_dst_2 on the filtered hits, when the read had >= 2 hits before
    the filter and > 2 after it: per outer hit a scan to the next gap or
    block end, one pushed cord (the hit, or the shifted hit before the
    break), a previous_window sweep whose new cords are then reversed in
    place, a next_window sweep, and the end flag at a block end. The
    previous sweep compares cy(new) with cordy_str as uint64, and
    cordy_str is the whole hit value when f_sp_l (the :1366 quirk).
Output per read: cords (B, C) int64 (uint64 bit patterns, zero past
ncords), ncords (B,) int32, and ovf (B,) bool where a push would have
passed slot C; an overflowing read stops there, and the caller maps it on
the host.

`filter_extend` launches the hand-written CUDA kernel
(csrc/filter_extend.cu) for CUDA tensors and runs `filter_extend_reference`,
the plain PyTorch version, for CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cordscalar import FLAG_END, MASK_Y

# ApxMapParm2_48 (src/pmpfinder.cpp:211)
WINDOW = 96
CELL_BIT = 4
SUP = 6
MED = 5
INF = 3
WTHR = 36
WTHR_REJ = 50
ABORT_SCORE = 1000
MXU31 = (31 << 24) + (31 << 18) + (31 << 12) + (31 << 6) + 31

# units table (src/pmpfinder.cpp:541): 2-mer ord (5a + b) -> (lane << 8) |
# bit; N*, *N and TT -> bit 31, which adds nothing
_INF31 = 31
_UNITS = [
    0, 6, 12, 18, _INF31,
    24, (1 << 8) + 0, (1 << 8) + 6, (1 << 8) + 12, _INF31,
    (1 << 8) + 18, (1 << 8) + 24, (2 << 8) + 0, (2 << 8) + 6, _INF31,
    (2 << 8) + 12, (2 << 8) + 18, (2 << 8) + 24, _INF31, _INF31,
    _INF31, _INF31, _INF31, _INF31, _INF31,
]
UNIT_LANE = np.array([u >> 8 for u in _UNITS], dtype=np.int64)
UNIT_ADD = ((1 << np.array([u & 255 for u in _UNITS], dtype=np.int64))
            & ((1 << 31) - 1)).astype(np.int64)

_MASK32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)
# phases of the plain version's per-read state machine
_OUTER, _SCAN, _DECIDE, _PREV, _NEXT, _EPI, _DONE = range(7)

# launches of the CUDA kernel by filter_extend in this process
launches = 0


@dataclass(frozen=True)
class GenomeFeats:
    """The genomes' 2_48 feature scripts on one torch device."""

    cat: torch.Tensor   # (rows + 8, 3) int32: uint32 bit patterns, zero tail
    off: torch.Tensor   # (G,) int32 first row of each genome
    rows: torch.Tensor  # (G,) int32 row count of each genome

    @property
    def device(self) -> torch.device:
        return self.cat.device


def upload_genome_feats(f2_arrays, device) -> GenomeFeats:
    """Per-genome (n, 3) int32 feature arrays (of Mapper.f2) -> one
    concatenated table on `device` with 8 zero rows at the end, as
    linear_tpu.ops.extend_dev.upload_genome_feats lays it out."""
    offs = np.cumsum([0] + [len(a) for a in f2_arrays])
    cat = np.zeros((int(offs[-1]) + 8, 3), dtype=np.int32)
    for a, o in zip(f2_arrays, offs):
        cat[o: o + len(a)] = a
    device = torch.device(device)
    return GenomeFeats(
        cat=torch.from_numpy(cat).to(device),
        off=torch.from_numpy(offs[:-1].astype(np.int32)).to(device),
        rows=torch.from_numpy(np.diff(offs).astype(np.int32)).to(device))


def pack_rows(reads: list, pad: int):
    """Reads (uint8 codes 0..3) -> (packed (B, pad/4) uint8 of 2-bit
    LSB-first bases, zero past each read; lens (B,) int64), through the
    native superchunk packer."""
    from ..map import nengine as NE

    wire, n_mask = NE.pack_superchunk_native(reads, pad, len(reads))
    if n_mask.any():
        raise ValueError("reads with N cannot be extended on the device")
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    return np.ascontiguousarray(wire[:, :-8]), lens


# ------------------------------------------------------------ the plain version


def _unpack(packed: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, pad/4) uint8 -> (B, pad) int64 bases, 0 past each read's end."""
    pk = packed.to(torch.int64)
    seqs = torch.stack([(pk >> (2 * i)) & 3 for i in range(4)],
                       dim=-1).reshape(pk.shape[0], -1)
    pos = torch.arange(seqs.shape[1], device=seqs.device)
    return torch.where(pos[None, :] < lens[:, None], seqs, 0)


def _revcomp(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement, zero past each read's end."""
    L = seqs.shape[1]
    j = lens[:, None] - 1 - torch.arange(L, device=seqs.device)[None, :]
    v = torch.gather(seqs, 1, j.clamp(0, L - 1))
    return torch.where(j >= 0, 3 - v, 0)


def _read_feats(seqs: torch.Tensor, R: int) -> torch.Tensor:
    """create_features_n rows 0..R-1 of a (B, L) batch -> (B, R, 3) int64
    holding uint32 values: row r sums the 2-mer addends of positions
    [16r, 16r + 48), lane by lane, mod 2^32."""
    B, L = seqs.shape
    dev = seqs.device
    nxt = torch.nn.functional.pad(seqs[:, 1:], (0, 1))
    ord2 = seqs * 5 + nxt
    lane = torch.from_numpy(UNIT_LANE).to(dev)[ord2]
    add = torch.from_numpy(UNIT_ADD).to(dev)[ord2]
    starts = torch.arange(R, device=dev) * 16
    out = []
    for t in range(3):
        csum = torch.nn.functional.pad(
            torch.cumsum(torch.where(lane == t, add, 0), dim=1), (1, 0))
        out.append(csum[:, starts + 48] - csum[:, starts])
    return torch.stack(out, dim=-1) & _MASK32


def _serial_rows(lens: torch.Tensor) -> torch.Tensor:
    """n_scripts_serial: 1 + max(0, (len - 50) >> 4); 0 below 48 bases."""
    n = 1 + torch.clamp((lens - 50) >> 4, min=0)
    return torch.where(lens < 48, 0, n)


def _sdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """_scriptDist63_31 over (..., 3) uint32 values held in int64."""
    d = (a + MXU31 - b) & _MASK32
    shifts = torch.tensor([24, 18, 12, 6, 0], device=a.device)
    lanes = (d[..., None] >> shifts) & 63
    return (lanes - 31).abs().sum(dim=(-1, -2))


def _cy(c):
    return c & MASK_Y


def _cx(c):
    return (c >> 20) & ((1 << 30) - 1)


def _cid(c):
    return (c >> 50) & ((1 << 10) - 1)


def _strand(c):
    return (c >> 61) & 1


def _is_end(c):
    return ((c >> 60) & 1) == 1


def _make_cord(gid, x, y, std):
    """create_cord (src/cords.cpp:195); no field carries here."""
    return (((gid << 30) + x) << 20) + y + (std << 61)


def _ult(a, b):
    """a < b as uint64 on int64 bit patterns."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


class _Reads:
    """Per-row read and genome feature lookups of one batch."""

    def __init__(self, feats, n1, gf: GenomeFeats):
        self.feats = feats                      # (B, 2, R, 3) int64
        self.n1 = n1                            # (B,) valid read rows
        self.cat = gf.cat.to(torch.int64) & _MASK32
        self.off = gf.off.to(torch.int64)
        self.grows = gf.rows.to(torch.int64)
        self.rows = torch.arange(feats.shape[0], device=feats.device)

    def genome(self, gid):
        """(first row, row count) of genome gid (clamped to the table)."""
        g = gid.clamp(0, self.off.shape[0] - 1)
        return self.off[g], self.grows[g]

    def read_rows(self, std, y):
        """Read feature rows y (..., clamped) of strand std, per batch row."""
        R = self.feats.shape[2]
        rows = self.rows.view(-1, *([1] * (y.dim() - 1)))
        return self.feats[rows, std, y.clamp(0, R - 1)]

    def genome_rows(self, goff, x):
        return self.cat[(goff + x).clamp(0, self.cat.shape[0] - 1)]

    def dist(self, std, gid, y, x):
        """The two-script window distance at read row y, genome row x,
        without bounds checks (callers mask out-of-range windows)."""
        goff, _ = self.genome(gid)
        if y.dim() > goff.dim():
            goff = goff[:, None]
        return (_sdist(self.read_rows(std, y), self.genome_rows(goff, x))
                + _sdist(self.read_rows(std, y + 3),
                         self.genome_rows(goff, x + 3)))


class _Work:
    """What the data makes the extension do, counted by the plain version
    when asked (chip_smoke.py's bound of the kernel; the main path never
    asks): the window evaluations (each 30 six-bit lane distances), the
    genome feature rows they read (absolute rows of GenomeFeats.cat), the
    read feature rows and the distinct 16-base chunks they sum (row r is
    chunks r, r + 1 and r + 2), and per read the serial window steps
    (previous_window / next_window calls, each waiting on the last)."""

    def __init__(self, B: int, device):
        self.evals = 0
        self.grows = []
        self.steps = torch.zeros(B, dtype=torch.int64, device=device)

    def window(self, ok, goff, x):
        """Evaluations where ok; each reads genome rows goff + x, + x + 3."""
        self.evals += int(ok.sum())
        g = torch.broadcast_to(goff, x.shape)[ok] + x[ok]
        self.grows += [g, g + 3]

    def summary(self, read_rows: int, read_chunks: int) -> dict:
        rows = torch.cat(self.grows) if self.grows else torch.zeros(0)
        return {"window_evals": self.evals, "lane_distances": 30 * self.evals,
                "genome_rows": int(torch.unique(rows).numel()),
                "read_rows": read_rows, "read_chunks": read_chunks,
                "max_steps": int(self.steps.max())
                if self.steps.numel() else 0,
                "steps": int(self.steps.sum())}


def _filter_hits(hits, n, rd: _Reads, work: _Work = None):
    """filter_hits (le_pmp.hpp:249) on (B, H) hits with n (B,) in use.
    Returns (filtered hits, new n)."""
    B, H = hits.shape
    pos = torch.arange(H, device=hits.device)[None, :]
    in_use = (pos < n[:, None]) & (pos >= 1)
    y = _cy(hits) >> CELL_BIT
    x = _cx(hits) >> CELL_BIT
    gid = _cid(hits)
    goff, n2 = rd.genome(gid)
    dist = rd.dist(_strand(hits), gid, y, x)
    # window_dist_c: bounds-checked with d = 4
    in_range = (y + 4 < rd.n1[:, None]) & (x + 4 < n2)
    dist = torch.where(in_range, dist, ABORT_SCORE)
    if work is not None:
        work.window(in_use & in_range & (n[:, None] >= 2), goff, x)
    keep = (in_use & (dist < WTHR_REJ)) | (pos == 0)
    slot = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out = torch.zeros((B, H + 1), dtype=hits.dtype, device=hits.device)
    out.scatter_(1, torch.where(keep, slot, H), hits)
    # a hit's end flag lands on the last kept slot at or before it
    endf = (in_use & _is_end(hits)).to(torch.int64)
    flags = torch.zeros((B, H + 1), dtype=torch.int64, device=hits.device)
    flags.scatter_reduce_(1, torch.where(in_use, slot, H), endf, "amax")
    out = torch.where(flags == 1, out | FLAG_END, out)[:, :H]
    new_n = torch.where(n == 0, 0, (keep & (pos < n[:, None])).sum(dim=1))
    return out, new_n


def _window(rd: _Reads, cur, seg_s, seg_g, prev: bool, work: _Work = None,
            m=None):
    """previous_window / next_window (le_pmp.hpp:36, :63) from cord cur,
    on read strand seg_s and genome seg_g; 0 where it fails. With work, the
    calls of the rows in mask m are counted."""
    gid, std = _cid(cur), _strand(cur)
    xs, ys = _cx(cur) >> CELL_BIT, _cy(cur) >> CELL_BIT
    goff, n2 = rd.genome(seg_g)
    if prev:
        ok = (ys >= MED) & (xs >= SUP)
        y, x0 = ys - MED, xs - SUP
    else:
        ok = (ys + 2 * SUP <= rd.n1) & (xs + 2 * SUP <= n2)
        y, x0 = ys + MED, xs + INF
    xk = x0[:, None] + torch.arange(SUP - INF, device=cur.device)[None, :]
    yk = y[:, None].expand_as(xk)
    d = rd.dist(seg_s[:, None].expand_as(xk), seg_g, yk, xk)
    # window_dist_u: out of range -> 2^30
    in_range = ((yk >= 0) & (yk + 3 < rd.n1[:, None]) & (xk >= 0)
                & (xk + 3 < n2[:, None]))
    d = torch.where(in_range, d, 1 << 30)
    if work is not None:
        work.steps += m.to(torch.int64)
        work.window((m & ok)[:, None] & in_range, goff[:, None], xk)
    dmin = torch.full_like(xs, (1 << 32) - 1)
    xmin = torch.zeros_like(xs)
    for k in range(SUP - INF):  # the first minimum (strict <)
        better = d[:, k] < dmin
        dmin = torch.where(better, d[:, k], dmin)
        xmin = torch.where(better, xk[:, k], xmin)
    ok = ok & (dmin <= WTHR)
    if prev:
        far = (xs - xmin) > MED
        nc_far = _make_cord(gid, (xs - MED) << CELL_BIT,
                            (xs - xmin - MED + y) << CELL_BIT, std)
    else:
        far = (xmin - xs) > MED
        nc_far = _make_cord(gid, (xs + MED) << CELL_BIT,
                            (xs + MED - xmin + y) << CELL_BIT, std)
    nc = torch.where(far, nc_far,
                     _make_cord(gid, xmin << CELL_BIT, y << CELL_BIT, std))
    return torch.where(ok, nc, 0)


def _path_dst_2(hits, n, rd: _Reads, lens, C: int, work: _Work = None):
    """path_dst_2 (le_pmp.hpp:180) for every row at once: a per-row phase
    register steps each read through the C++ control flow, one scan step
    or one window sweep per phase and iteration, in program order. Returns
    (cords, ncords, ovf)."""
    B = hits.shape[0]
    dev = hits.device
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    f = torch.zeros(B, dtype=torch.bool, device=dev)
    start = n > 2
    phase = torch.where(start, _OUTER, _DONE)
    cords = torch.zeros((B, C), dtype=torch.int64, device=dev)
    cords[:, 0] = torch.where(start, FLAG_END, 0)
    ncords = start.to(torch.int64)
    itt, itt_next, itt_first = z + 1, z + 2, z + 1
    fsl, fsr, fbe, ovf = f, f, f, f
    cys, cye, rdy_end, p_str, seg_s, seg_g = z, z, z, z, z, z
    jc = torch.arange(C, device=dev)[None, :]
    H = hits.shape[1]

    def hit(i):
        return torch.gather(hits, 1, i.clamp(0, H - 1)[:, None])[:, 0]

    def back():
        return torch.gather(cords, 1, (ncords - 1).clamp(0, C - 1)[:, None])[:, 0]

    def push(val, mask):
        nonlocal cords, ncords, ovf
        can = mask & (ncords < C)
        ovf = ovf | (mask & (ncords >= C))
        slot = ncords.clamp(max=C - 1)[:, None]
        old = torch.gather(cords, 1, slot)[:, 0]
        cords = cords.scatter(1, slot, torch.where(can, val, old)[:, None])
        ncords = ncords + can.to(torch.int64)

    while bool((phase != _DONE).any()):
        # per outer hit: f_sp_l and ready_end
        m = phase == _OUTER
        fin = m & (itt >= n)
        go = m & ~fin
        h_itt, h_prv = hit(itt), hit(itt - 1)
        da_l = ((_cx(h_itt) - _cx(h_prv)) - (_cy(h_itt) - _cy(h_prv))).abs()
        da_l = torch.where(_is_end(h_prv), 0, da_l)
        fsl = torch.where(go, (da_l > 80) | (_strand(h_itt ^ h_prv) != 0), fsl)
        rdy_end = torch.where(go, lens + _strand(h_itt), rdy_end)
        fsr, fbe = fsr & ~go, fbe & ~go
        phase = torch.where(fin, _DONE, torch.where(go, _SCAN, phase))

        # one step of the itt_next scan
        m = phase == _SCAN
        h_in, h_in1 = hit(itt_next), hit(itt_next - 1)
        end1 = (itt_next >= n) | _is_end(h_in1)
        da_r = ((_cx(h_in) - _cx(h_in1)) - (_cy(h_in) - _cy(h_in1))).abs()
        f_sp_r = (da_r > 80) | (_strand(h_in ^ h_in1) != 0)
        brk = (((_cy(h_itt) + WINDOW < _cy(h_in))
                & (_cx(h_itt) + WINDOW < _cx(h_in))) | f_sp_r)
        c_end = m & end1
        fbe = fbe | c_end
        itt_first = torch.where(c_end, itt_next, itt_first)
        fsr = torch.where(m & ~end1, f_sp_r, fsr)
        itt_next = torch.where(m & ~end1 & ~brk, itt_next + 1, itt_next)
        phase = torch.where(c_end | (m & ~end1 & brk), _DECIDE, phase)

        # the pushed cord and the sweep bounds
        m = phase == _DECIDE
        h_itt, h_prv = hit(itt), hit(itt - 1)
        h_in, h_in1 = hit(itt_next), hit(itt_next - 1)
        norm = m & ~fsr & ~fbe
        nc_sp = h_in1 - (WINDOW << 20) - WINDOW
        sp = (m & ~norm & ~fsl & (_cy(h_in1) >= WINDOW)
              & (_cx(h_in1) >= WINDOW))
        cys_n = torch.where(fsl, h_itt,
                            torch.where(_is_end(h_prv), 0, _cy(back())))
        cys_s = torch.where(_is_end(h_prv), 0, _cy(nc_sp))
        cys = torch.where(norm, cys_n, torch.where(sp, cys_s, cys))
        cye = torch.where(norm, _cy(h_in), torch.where(sp, _cy(h_in1), cye))
        append = norm | sp
        push(torch.where(norm, h_itt, nc_sp) & ~FLAG_END, append)
        p_str = torch.where(append, ncords - 1, p_str)
        blk = m & (_is_end(h_itt) | fbe)
        fbe = fbe | blk
        cye = torch.where(blk, rdy_end, cye)
        seg_s = torch.where(append, _strand(h_itt), seg_s)
        seg_g = torch.where(append, _cid(h_itt), seg_g)
        phase = torch.where(m, torch.where(append, _PREV, _EPI), phase)
        phase = torch.where(ovf, _DONE, phase)

        # one previous_window step; at its stop the segment is reversed
        m = phase == _PREV
        nc = _window(rd, back(), seg_s, seg_g, True, work, m)
        stop = m & ((nc == 0) | _ult(_cy(nc), cys))
        push(nc, m & ~stop)
        inseg = stop[:, None] & (jc >= p_str[:, None]) & (jc < ncords[:, None])
        src = torch.where(inseg, (p_str + ncords - 1)[:, None] - jc, jc)
        cords = torch.gather(cords, 1, src)
        phase = torch.where(stop, _NEXT, phase)
        phase = torch.where(ovf, _DONE, phase)

        # one next_window step
        m = phase == _NEXT
        nc = _window(rd, back(), seg_s, seg_g, False, work, m)
        stop = m & ((nc == 0) | ~_ult(_cy(nc) + WINDOW, cye))
        push(nc, m & ~stop)
        phase = torch.where(stop, _EPI, phase)
        phase = torch.where(ovf, _DONE, phase)

        # end of the outer hit
        m = phase == _EPI
        slot = (ncords - 1).clamp(0, C - 1)[:, None]
        last = torch.gather(cords, 1, slot)[:, 0]
        cords = cords.scatter(
            1, slot, torch.where(m & fbe, last | FLAG_END, last)[:, None])
        itt_next = torch.where(m & fbe, itt_first, itt_next)
        itt = torch.where(m, itt_next, itt)
        itt_next = torch.where(m, itt_next + 1, itt_next)
        phase = torch.where(m, _OUTER, phase)
    return cords, ncords.to(torch.int32), ovf


def filter_extend_reference(packed: torch.Tensor, lens: torch.Tensor,
                            hits: torch.Tensor, n_hits: torch.Tensor,
                            gf: GenomeFeats, C: int, R: int,
                            count_work: bool = False):
    """Plain PyTorch version of the extension (see the module docstring):
    packed (B, pad/4) uint8, lens (B,) int64, hits (B, H) int64 (slot 0
    the FLAG_END header), n_hits (B,) int32 -> (cords (B, C) int64, ncords
    (B,) int32, ovf (B,) bool). R is the feature row count of the pad,
    ((pad - 48) >> 4) + 1. Runs on any device. With count_work, a fourth
    item counts the work these inputs need (_Work.summary; the read rows
    and chunks are both strands' of the reads with 2 or more hits)."""
    lens = lens.to(torch.int64)
    seqs = _unpack(packed, lens)
    feats = torch.stack([_read_feats(seqs, R),
                         _read_feats(_revcomp(seqs, lens), R)], dim=1)
    rd = _Reads(feats, _serial_rows(lens), gf)
    n = n_hits.to(torch.int64)
    work = _Work(n.shape[0], n.device) if count_work else None
    fh, fn = _filter_hits(hits, n, rd, work)
    fn = torch.where(n < 2, 0, fn)  # path_dst: `hits.size() < 2` before the filter
    out = _path_dst_2(fh, fn, rd, lens, C, work)
    if work is None:
        return out
    n1 = rd.n1.clamp(max=R) * (n >= 2)
    return (*out, work.summary(int(2 * n1.sum()),
                               int(2 * ((n1 + 2) * (n1 > 0)).sum())))


def feature_rows(pad: int) -> int:
    """R: the feature rows of a pad-base row, ((pad - 48) >> 4) + 1."""
    return ((pad - 48) >> 4) + 1


def filter_extend(packed: torch.Tensor, lens: torch.Tensor,
                  hits: torch.Tensor, n_hits: torch.Tensor, gf: GenomeFeats,
                  C: int):
    """One batch: (cords (B, C) int64, ncords (B,) int32, ovf (B,) bool).
    CUDA tensors launch the hand-written kernel (and count the launch);
    CPU tensors run the plain PyTorch version. Anything else raises."""
    global launches
    dev = packed.device
    if gf.device != dev:
        raise ValueError(f"reads on {dev}, genome features on {gf.device}")
    R = feature_rows(packed.shape[1] * 4)
    if dev.type == "cuda":
        from . import _cuda

        out = _cuda.filter_extend(packed, lens, hits, n_hits, gf.cat, gf.off,
                                  gf.rows, C, R)
        launches += 1
        return out
    if dev.type == "cpu":
        return filter_extend_reference(packed, lens, hits, n_hits, gf, C, R)
    raise ValueError(f"no extension kernel for device {dev}")
