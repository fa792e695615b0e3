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
`superchunk_states_from_words` states the kernel's word arithmetic (funnel
shifts, 2-bit reversal, popcounts) plainly for the tests. dispatch_wire /
collect_wire move one superchunk (the streaming path of
Mapper._device_seed_stream2, which tells an overflow apart for its second
tier); seed_block_dispatch / seed_block_collect a whole block, every wire
dispatched before the first wait (Mapper._device_seed_block, warmup).

The padded seeding kernels of the multi-process path (the second half of
this module) keep every probed bucket slot: (B, P, cap) anchors and a keep
mask, P = len(range(35, L, 15)), in emission order (position-major, bucket-
entry order); a read's host seeds are anc[b][keep[b]]. Slots with keep
False hold 0 (JAX's kernels leave val2Anchor's arithmetic there), so a sum
over xval shards is the unsharded result on every slot.
  batch_seed_anchors       the exact rolling-hash scan (N bases flow through
                           it), csrc/seed_anchors.cu K1, which computes each
                           call's states in closed form
                           (_scan_states_closed) instead of rolling;
  batch_seed_anchors_fast  closed-form hash states, exact for N-free reads,
                           optionally probing one xval shard [x_base, x_hi)
                           of the index, csrc/seed_anchors.cu K2;
  compact_anchors          the kept anchors of each row, in order, into
                           (B, m_out) with the kept count (count > m_out:
                           overflow), csrc/seed_anchors.cu K3.
Each launches its kernel for CUDA tensors and runs its `_reference` plain
version for CPU tensors.
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

# launches of the CUDA kernel by seed_superchunk in this process
launches = 0
# launches of the kernels of csrc/seed_anchors.cu by batch_seed_anchors,
# batch_seed_anchors_fast and compact_anchors in this process
scan_launches = 0
fast_launches = 0
compact_launches = 0


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


def _superchunk_states(seqs: torch.Tensor):
    """xval, yval, strand and k of every call position k = 35 + 15p of
    unpacked rows seqs (rows, pad) int64 (see the module docstring): each
    (rows, P), P = len(range(35, pad, 15))."""
    dev = seqs.device
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
    return xval, yval, strand, kmat


def superchunk_states_reference(wire: torch.Tensor):
    """(xval, yval, strand), each (rows, P) int64, of every call position
    of a wire (rows, pad/4 + 8) uint8, as seed_superchunk_reference
    computes them."""
    return _superchunk_states(_unpack_wire(wire)[0])[:3]


_LO2 = np.uint64(0x5555555555555555)
_HI2 = np.uint64(0xAAAAAAAAAAAAAAAA)


def _rev2(x: np.ndarray) -> np.ndarray:
    """The 32 2-bit groups of each uint64 in reverse order."""
    x = ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)) \
        | ((x & np.uint64(0x3333333333333333)) << np.uint64(2))
    x = ((x >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F)) \
        | ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4))
    return x.byteswap()


def _base_sum(x: np.ndarray, nb: int) -> np.ndarray:
    """Sum of the bases in the low nb 2-bit groups (nb < 32)."""
    x = x & np.uint64((1 << (2 * nb)) - 1)
    return (2 * np.bitwise_count(x & _HI2).astype(np.int64)
            + np.bitwise_count(x & _LO2).astype(np.int64))


def superchunk_states_from_words(wire: np.ndarray):
    """csrc/seed_superchunk.cu's word arithmetic, stated plainly for the
    tests: (xval, yval, strand), each (rows, P) int64, of every call position
    k = 35 + 15p < pad of a wire (rows, pad/4 + 8) uint8, from its bases as
    little-endian 64-bit words (base i at bits 2 (i mod 32) of word i / 32;
    words past the row read 0). The 21-base window is a funnel shift of two
    words; its reverse complement the complement, its MSB-first hash the
    2-bit groups reversed, its base sum two popcounts; at p = 0 the hash
    window takes b[14..20) in its first six groups. YValue: the four bases
    after the forward window reversed, or the complement of the four
    before the reverse one as they lie."""
    wire = np.ascontiguousarray(wire, dtype=np.uint8)
    rows, row_bytes = wire.shape
    pad_bytes = row_bytes - 8
    nw = -(-pad_bytes // 8)
    buf = np.zeros((rows, 8 * (nw + 1)), np.uint8)
    buf[:, :pad_bytes] = wire[:, :pad_bytes]
    words = buf.view("<u8")  # (rows, nw + 1): the last word reads 0

    def bases_at(i):  # (rows, n) uint64: 32 bases from base i (n or rows, n)
        i = np.broadcast_to(np.asarray(i, dtype=np.int64),
                            (rows, np.shape(i)[-1]))
        q = np.minimum(i >> 5, nw)
        lo = np.take_along_axis(words, q, axis=1)
        hi = np.take_along_axis(words, np.minimum(q + 1, nw), axis=1)
        sh = (2 * (i & 31)).astype(np.uint64)
        wide = (lo >> sh) | (hi << (np.uint64(64) - sh))
        return np.where(sh == 0, lo, wide)

    ks = np.arange(FIRST, 4 * pad_bytes, THD_ALPHA, dtype=np.int64)
    win = bases_at(ks) & np.uint64((1 << (2 * SPAN)) - 1)
    wsum = _base_sum(win, SPAN)
    bias = 2 * (_base_sum(bases_at([0]), SPAN - 1)
                - _base_sum(bases_at([SPAN]), SPAN - 1))
    mix_mask = np.uint64((1 << (2 * N_MIX)) - 1)
    wh = win.copy()
    wh[:, 0] = (win[:, 0] & ~mix_mask) \
        | (bases_at([SPAN - 1 - N_MIX])[:, 0] & mix_mask)
    fwd = 2 * wsum - 3 * SPAN + bias > 0
    h = _rev2(wh) >> np.uint64(64 - 2 * SPAN)
    rc = ~wh & np.uint64((1 << (2 * SPAN)) - 1)
    xv, tsel = _minimizer(torch.from_numpy(
        np.where(fwd, h, rc).astype(np.int64)))
    tsel = tsel.numpy()
    yf = _rev2(bases_at(ks + tsel + WEIGHT)) >> np.uint64(56)
    yr = ~bases_at(ks + SPAN - WEIGHT - 4 - tsel) & np.uint64(0xFF)
    yval = np.where(fwd, yf, yr).astype(np.int64)
    return xv.numpy(), yval, (~fwd).astype(np.int64)


def seed_superchunk_reference(wire: torch.Tensor, dir_start: torch.Tensor,
                              hs: torch.Tensor, cap: int,
                              m_out: int) -> torch.Tensor:
    """Plain PyTorch version of the fused superchunk seeding (see the module
    docstring): wire (rows, pad/4 + 8) uint8 -> (rows, m_out + 1) int64.
    Runs on any device; uint64 values are int64 bit patterns, and every
    right shift of a value that may have bit 63 set is masked."""
    dev = wire.device
    seqs, lens = _unpack_wire(wire)
    xval, yval, strand, kmat = _superchunk_states(seqs)
    rows, P = xval.shape

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


def _landed(handle: WireHandle):
    """Wait for one dispatch_wire handle: (anchors (rows, m_out) uint64,
    count, probed) in host memory."""
    if handle.done is not None:
        handle.done.synchronize()
    arr = handle.out.numpy()
    return (arr[:, :-1].view(np.uint64),
            (arr[:, -1] & 0xFFFFFFFF).astype(np.int64),
            (arr[:, -1] >> 32).astype(np.int64))


def collect_wire(handle: WireHandle, n_valid: int, n_mask: np.ndarray,
                 m_out: int):
    """Wait for one dispatch_wire handle. Returns (anchors, overflow):
    anchors is a length-n_valid list of uint64 arrays, None for reads with
    N AND for overflowed ones; overflow marks the reads whose probe
    exceeded m_out, so callers can redispatch them at a larger m_out tier
    instead of seeding them on the host."""
    anc, count, probed = _landed(handle)
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


def seed_block_dispatch(reads: list, index: DeviceIndex, pad_len: int,
                        thd_alpha: int = THD_ALPHA, m_out: int = 128,
                        superchunk: int = 1024) -> list:
    """Block seeding (linear_tpu.ops.seeding.seed_block_dispatch): every
    `superchunk` reads are packed into one wire, then each wire is
    dispatched (dispatch_wire), all before any result is waited for.
    Reads with N ride the wire zeroed and come back None. Collect with
    seed_block_collect. The kernel samples every THD_ALPHA bases, so
    another thd_alpha raises."""
    if thd_alpha != THD_ALPHA:
        raise ValueError(f"thd_alpha {thd_alpha}: the seed kernel samples "
                         f"every {THD_ALPHA} bases")
    wires = [(min(superchunk, len(reads) - c0),
              *pack_superchunk(reads[c0: c0 + superchunk], pad_len,
                               superchunk))
             for c0 in range(0, len(reads), superchunk)]
    return [(n_valid, dispatch_wire(w, index, m_out), n_mask)
            for n_valid, w, n_mask in wires]


def seed_block_collect(dispatched: list, m_out: int = 128) -> list:
    """The anchors of seed_block_dispatch's reads, one entry a read in
    order: uint64 arrays in emission order, None for a read with N and for
    a read whose probe exceeded m_out (the caller seeds those on the host;
    unlike collect_wire, the overflow is not told apart)."""
    res: list = []
    for n_valid, handle, n_mask in dispatched:
        anc, count, probed = _landed(handle)
        for i in range(n_valid):
            res.append(None if n_mask[i] or probed[i] > m_out
                       else anc[i, : count[i]].copy())
    return res


# ------------------------------------ padded seeding of the multi-process path

# rows of one seed_anchors_dispatch launch are cut so that the (rows, P, cap)
# grid holds at most this many slots (9 bytes each: anchor and keep flag)
GRID_SLOTS = 1 << 26
_I64_MAX = (1 << 63) - 1


def n_positions(L: int, thd_alpha: int = THD_ALPHA) -> int:
    """P: the call positions k = 35, 35 + thd_alpha, ... below L."""
    first = SPAN + thd_alpha - 1
    return len(range(first, L, thd_alpha))


def _hash_scan_batch(seqs: torch.Tensor):
    """Exact LShape state streams of a (B, L) batch of codes 0..4
    (linear_tpu.ops.seeding._hash_scan_batch): (h, crh, x), each (B, L - 21),
    the state after the hashNexth call at k = 21 + column. hashInit runs at
    k0, the first N-free 21-window (0 if none), but the roll starts at
    k = 21 whatever k0 is; an N enters h as the value 4 and x as v - left,
    never skipped. uint64 values are int64 bit patterns."""
    s = seqs.to(torch.int64)
    B, L = s.shape
    dev = s.device
    n_win = min(SPAN, L)
    csum = torch.nn.functional.pad(torch.cumsum((s == 4).to(torch.int64), 1),
                                   (1, 0))
    ok = (csum[:, n_win:] - csum[:, :-n_win]) == 0
    k0 = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), 0)
    init = torch.gather(s, 1, (k0[:, None] + torch.arange(
        SPAN - 1, device=dev)).clamp(max=L - 1))
    h = torch.zeros(B, dtype=torch.int64, device=dev)
    crh = torch.zeros_like(h)
    for t in range(SPAN - 1):
        h = (h << 2) + init[:, t]
        crh = crh + ((3 - init[:, t]) << (2 * (t + 1)))
    x = 2 * init.sum(1) - 3 * (SPAN - 1) - 3
    left = torch.zeros_like(h)
    mask = (1 << (2 * SPAN - 2)) - 1
    hs, crhs, xs = [], [], []
    for k in range(SPAN, L):
        v2 = s[:, min(k + SPAN - 1, L - 1)]
        h = ((h & mask) << 2) + v2
        crh = ((crh >> 2) & mask) + ((3 - v2) << (2 * SPAN - 2))
        x = x + ((v2 - left) << 1)
        left = s[:, k]
        hs.append(h)
        crhs.append(crh)
        xs.append(x)
    if not hs:
        empty = torch.zeros((B, 0), dtype=torch.int64, device=dev)
        return empty, empty, empty
    return torch.stack(hs, 1), torch.stack(crhs, 1), torch.stack(xs, 1)


def _scan_init(s: torch.Tensor):
    """The per-read state of the scan that no call position can rebuild from
    its own window (what kernel K1's pre-pass writes): k0, the first N-free
    21-window (0 if none); T, bits 2..41 of hashInit's crh, the init
    window's share of crh for the calls k < 41; and the x bias
    2 * sum(init) - 63 - 2 * sum(b[21 .. 41)). s is (B, L) int64."""
    B, L = s.shape
    dev = s.device
    n_win = min(SPAN, L)
    csum = torch.nn.functional.pad(torch.cumsum((s == 4).to(torch.int64), 1),
                                   (1, 0))
    ok = (csum[:, n_win:] - csum[:, :-n_win]) == 0
    k0 = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), 0)
    init = torch.gather(s, 1, (k0[:, None] + torch.arange(
        SPAN - 1, device=dev)).clamp(max=L - 1))
    crh0 = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(SPAN - 1):
        crh0 = crh0 + ((3 - init[:, t]) << (2 * (t + 1)))
    T = (crh0 >> 2) & ((1 << (2 * SPAN - 2)) - 1)
    mid = s[:, torch.arange(SPAN, 2 * SPAN - 1, device=dev).clamp(max=L - 1)]
    bias = 2 * init.sum(1) - 3 * (SPAN - 1) - 3 - 2 * mid.sum(1)
    return k0, T, bias


def _scan_states_closed(seqs: torch.Tensor, kmat: torch.Tensor):
    """The scan's states (h, crh, x) after the hashNexth call at each
    position k of kmat (B, P), 21 <= k < L, without the roll: equal to
    _hash_scan_batch's column k - 21 on any codes 0..4. This is what kernel
    K1 computes per call position. With u_m the value the roll appends at
    step m (b[m + 20], clamped into the row) and u_m = b[k0 + m - 1] for
    m <= 20 (the init window, whose last value the first step sees as the
    one appended before it):
      h   = u_k + (sum_{t=1..20} 4^t u_{k-t} mod 2^42)  (the mask drops
            everything older, an N's 4 carries inside those bits);
      crh = (3 - u_k) << 40 + sum over the appended u_{k-t}, t = 1..20,
            of ((3 - u_{k-t}) & 3) << (40 - 2t), + T >> 2(k - 21) while the
            init window is not shifted out (k < 41);
      x   = bias + 2 * sum(b[k .. k+21)), indices clamped into the row."""
    s = seqs.to(torch.int64)
    B, L = s.shape
    dev = s.device
    k0, T, bias = _scan_init(s)
    t = torch.arange(SPAN, device=dev)
    m = kmat[..., None] - (SPAN - 1) + t          # u_m, weight 4^(20 - t)
    idx = torch.where(m <= SPAN - 1, k0[:, None, None] + m - 1, m + SPAN - 1)

    def gather(p):
        return torch.gather(s, 1, p.clamp(0, L - 1).reshape(B, -1)).reshape(
            p.shape)

    u = gather(idx)
    h = torch.zeros_like(kmat)
    crh = (3 - u[..., SPAN - 1]) << (2 * SPAN - 2)
    for j in range(SPAN - 1):
        h = h + (u[..., j] << (2 * (SPAN - 1 - j)))
        crh = crh + (torch.where(m[..., j] >= SPAN, (3 - u[..., j]) & 3,
                                 0) << (2 * j))
    h = u[..., SPAN - 1] + (h & ((1 << (2 * SPAN)) - 1))
    sh = (2 * (kmat - SPAN)).clamp(0, 63)
    crh = crh + torch.where(kmat < 2 * SPAN - 1, T[:, None] >> sh, 0)
    x = bias[:, None] + 2 * gather(kmat[..., None] + t).sum(-1)
    return h, crh, x


def _minimizer_xy_batch(seqs: torch.Tensor, kmat: torch.Tensor,
                        h: torch.Tensor, crh: torch.Tensor, x: torch.Tensor):
    """hashNextX (src/shape_extend.cpp:341) at the call positions kmat of a
    (B, L) batch, from their hash states (linear_tpu.ops.seeding.
    _minimizer_xy_batch): (xval, yval, strand), each (B, P) int64. A YValue
    base past the row reads 0 (one before it reads the row's last base, as
    JAX clamps), and an N base adds 0."""
    s = seqs.to(torch.int64)
    L = s.shape[1]
    fwd = x > 0
    xval, tsel = _minimizer(torch.where(fwd, h, crh))
    fwd_base = kmat + tsel + WEIGHT
    rev_base = kmat + SPAN - tsel - WEIGHT - 1
    yval = torch.zeros_like(xval)
    for i in range(4):
        pf, pr = fwd_base + i, rev_base - i
        vf = torch.where(pf < L, torch.gather(s, 1, pf.clamp(0, L - 1)), 0)
        vr = 3 - torch.where(pr >= 0, torch.gather(s, 1, pr.clamp(0, L - 1)), 0)
        val = torch.where(fwd, vf, vr)
        yval = (yval << 2) + torch.where((val >= 0) & (val <= 3), val, 0)
    return xval, yval, (~fwd).to(torch.int64)


def _probe_and_anchor(kmat, lens, xval, yval, strand, dir_start, hs, cap: int,
                      in_range, x_base=None, x_hi=None):
    """The index probe and val2Anchor of the padded kernels
    (getDIndexMatchAll src/pmpfinder.cpp:1882-1911, val2Anchor
    src/index_util.cpp:1509; linear_tpu.ops.seeding._probe_and_anchor):
    (anchors (B, P, cap) int64, keep (B, P, cap) bool), anchors 0 where keep
    is False. A position is probed when in range and its xval differs from
    the previous position's (0 before the first), in range or not; with
    (x_base, x_hi) the tables hold only that xval shard, so positions
    outside it are not probed and the bucket index is rebased."""
    prev = torch.nn.functional.pad(xval[:, :-1], (1, 0))
    process = (xval != prev) & in_range
    xl = xval
    if x_base is not None:
        process = process & (xval >= x_base) & (xval < x_hi)
        xl = xval - x_base
    xc = xl.clamp(0, dir_start.shape[0] - 2)
    lo = dir_start[xc].to(torch.int64)
    cnt = torch.clamp(dir_start[xc + 1].to(torch.int64) - lo, max=cap)
    e = torch.arange(cap, device=kmat.device)
    valid = (e < cnt[..., None]) & process[..., None]
    ent = hs[(lo[..., None] + e).clamp(0, hs.shape[0] - 1)]
    ent_y = ent & MASK_Y
    val = ent_y ^ yval[..., None]
    keep = valid & ((val == 0) | (val < ((val & -val) << 2)))
    same = ((ent >> 61) & 1) == strand[..., None]
    k = kmat[..., None]
    cordy = torch.where(same, k, lens.to(torch.int64)[:, None, None] - 1 - k)
    anc = ent - (cordy << 20) + cordy - ent_y
    anc = torch.where(same, anc & ~FLAG_STRAND, anc | FLAG_STRAND)
    return torch.where(keep, anc, 0), keep


def _kmat(B: int, L: int, thd_alpha: int, device) -> torch.Tensor:
    first = SPAN + thd_alpha - 1
    ks = torch.arange(first, L, thd_alpha, dtype=torch.int64, device=device)
    return ks[None, :].expand(B, ks.shape[0])


def batch_seed_anchors_reference(seqs, lens, dir_start, hs, cap: int,
                                 thd_alpha: int = THD_ALPHA):
    """Plain PyTorch version of the scan seeding (linear_tpu.ops.seeding.
    batch_seed_anchors): seqs (B, L) uint8 codes 0..4, lens (B,) int64 ->
    (anchors, keep), each (B, P, cap). Runs on any device."""
    B, L = seqs.shape
    h, crh, x = _hash_scan_batch(seqs)
    kmat = _kmat(B, L, thd_alpha, seqs.device)
    # the streams start at k = 21; every call position k >= 35 is in them
    h, crh, x = (torch.gather(t, 1, kmat - SPAN) for t in (h, crh, x))
    xval, yval, strand = _minimizer_xy_batch(seqs, kmat, h, crh, x)
    in_range = kmat < (lens.to(torch.int64)[:, None] - SPAN)
    return _probe_and_anchor(kmat, lens, xval, yval, strand, dir_start, hs,
                             cap, in_range)


def _closed_form_states(seqs: torch.Tensor, kmat: torch.Tensor):
    """Hash states at the call positions without the scan, exact for N-free
    reads (linear_tpu.ops.seeding._closed_form_states): the window is
    b[k .. k+21), except for the calls k < 41 that still hold the init
    window's tail b[20-n_init .. 20) followed by b[41 .. 41+n_app),
    n_app = min(k - 20, 21); x = 2 * sum(b[k .. k+21)) - 63 + the init bias
    2 * (sum b[0..20) - sum b[21..41)). Indices are clamped into the row,
    and the packs add (an N adds 4, as in JAX)."""
    s = seqs.to(torch.int64)
    B, L = s.shape
    t = torch.arange(SPAN, device=s.device)
    idx = kmat[..., None] + t
    n_app = (kmat - SPAN + 1).clamp(max=SPAN)[..., None]
    n_init = SPAN - n_app
    mixed = torch.where(t < n_init, SPAN - 1 - n_init + t,
                        2 * SPAN - 1 + t - n_init)
    pos = torch.where((kmat < 2 * SPAN - 1)[..., None], mixed, idx)

    def gather(p):
        return torch.gather(s, 1, p.clamp(0, L - 1).reshape(B, -1)).reshape(
            p.shape)

    w = gather(pos)
    h = torch.zeros_like(kmat)
    crh = torch.zeros_like(kmat)
    for j in range(SPAN):
        h = (h << 2) + w[..., j]
        crh = crh + ((3 - w[..., j]) << (2 * j))
    head = s[:, : 2 * SPAN - 1]
    bias = 2 * (head[:, : SPAN - 1].sum(1) - head[:, SPAN:].sum(1))
    x = 2 * gather(idx).sum(-1) - 3 * SPAN + bias[:, None]
    return h, crh, x


def batch_seed_anchors_fast_reference(seqs, lens, dir_start, hs, cap: int,
                                      thd_alpha: int = THD_ALPHA,
                                      x_base=None, x_hi=None):
    """Plain PyTorch version of the closed-form seeding (linear_tpu.ops.
    seeding.batch_seed_anchors_fast, and with (x_base, x_hi) the probe of
    one xval shard as in the shard_map bodies of linear_tpu/parallel/
    mesh.py): (anchors, keep), each (B, P, cap). Runs on any device."""
    B, L = seqs.shape
    kmat = _kmat(B, L, thd_alpha, seqs.device)
    h, crh, x = _closed_form_states(seqs, kmat)
    xval, yval, strand = _minimizer_xy_batch(seqs, kmat, h, crh, x)
    in_range = kmat < (lens.to(torch.int64)[:, None] - SPAN)
    return _probe_and_anchor(kmat, lens, xval, yval, strand, dir_start, hs,
                             cap, in_range, x_base, x_hi)


def compact_anchors_reference(anc: torch.Tensor, keep: torch.Tensor,
                              m_out: int):
    """Plain PyTorch version of the stable compaction (linear_tpu.ops.
    seeding._compact_anchors): the kept anchors of each row in flat
    (position, slot) order into (B, m_out) int64, zero past them, and the
    kept count (B,) int32, which may pass m_out (overflow)."""
    B = anc.shape[0]
    af = anc.reshape(B, -1)
    kf = keep.reshape(B, -1)
    dst = torch.cumsum(kf, 1) - 1
    sel = kf & (dst < m_out)
    out = torch.zeros((B, m_out), dtype=torch.int64, device=anc.device)
    rows = torch.arange(B, device=anc.device)[:, None].expand_as(kf)
    out[rows[sel], dst[sel]] = af[sel]
    return out, kf.sum(1).to(torch.int32)


COMPACT_CHUNK = 16384  # flags a K3 block


def compact_anchors_chunked(anc: torch.Tensor, keep: torch.Tensor,
                            m_out: int, chunk: int = COMPACT_CHUNK):
    """K3's decomposition (csrc/seed_anchors.cu), stated plainly for the
    tests (the same outputs as compact_anchors_reference): each chunk of
    `chunk` flags of a row counts its kept slots; its kept anchors go to
    the row at the sum of the counts of the chunks before it (the
    look-back), those at or past m_out dropped; the row's count is the
    last chunk's inclusive sum, and stripe c of ceil(m_out / n_chunks)
    slots is zeroed from the row's count on by chunk block c."""
    B = anc.shape[0]
    af = anc.reshape(B, -1)
    kf = keep.reshape(B, -1)
    n = af.shape[1]
    n_chunks = max(1, -(-n // chunk))
    out = torch.full((B, m_out), -1, dtype=torch.int64, device=anc.device)
    count = torch.zeros((B,), dtype=torch.int32, device=anc.device)
    stripe = -(-m_out // n_chunks)
    for b in range(B):
        counts = [int(kf[b, c * chunk: (c + 1) * chunk].sum())
                  for c in range(n_chunks)]
        for c in range(n_chunks):
            excl = sum(counts[:c])
            if counts[c] and excl < m_out:
                sl = slice(c * chunk, (c + 1) * chunk)
                kept = af[b, sl][kf[b, sl]][: m_out - excl]
                out[b, excl: excl + len(kept)] = kept
        total = sum(counts)
        count[b] = total
        for c in range(n_chunks):
            z0, z1 = max(total, c * stripe), min((c + 1) * stripe, m_out)
            if z0 < z1:
                out[b, z0:z1] = 0
    return out, count


def _seed_device(seqs: torch.Tensor, dir_start: torch.Tensor,
                hs: torch.Tensor, lens: torch.Tensor) -> torch.device:
    dev = seqs.device
    for t, name in ((dir_start, "dir_start"), (hs, "hs"), (lens, "lens")):
        if t.device != dev:
            raise ValueError(f"seqs on {dev}, {name} on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no seeding kernel for device {dev}")
    return dev


def batch_seed_anchors(seqs, lens, dir_start, hs, cap: int,
                       thd_alpha: int = THD_ALPHA):
    """The scan seeding: seqs (B, L) uint8, lens (B,) int64 -> (anchors,
    keep), each (B, P, cap). CUDA tensors launch kernel K1 of
    csrc/seed_anchors.cu (and count the launch); CPU tensors run the plain
    version. Anything else raises."""
    global scan_launches
    if _seed_device(seqs, dir_start, hs, lens).type == "cuda":
        from . import _cuda

        out = _cuda.seed_anchors(seqs, lens, dir_start, hs, cap, thd_alpha,
                                 scan=True)
        scan_launches += 1
        return out
    return batch_seed_anchors_reference(seqs, lens, dir_start, hs, cap,
                                        thd_alpha)


def batch_seed_anchors_fast(seqs, lens, dir_start, hs, cap: int,
                            thd_alpha: int = THD_ALPHA, x_base=None,
                            x_hi=None):
    """The closed-form seeding (N-free reads), of the whole index or, with
    (x_base, x_hi), of the xval shard that dir_start and hs hold: (anchors,
    keep), each (B, P, cap). CUDA tensors launch kernel K2 of
    csrc/seed_anchors.cu (and count the launch); CPU tensors run the plain
    version. Anything else raises."""
    global fast_launches
    if _seed_device(seqs, dir_start, hs, lens).type == "cuda":
        from . import _cuda

        lo = 0 if x_base is None else int(x_base)
        hi = _I64_MAX if x_hi is None else int(x_hi)
        out = _cuda.seed_anchors(seqs, lens, dir_start, hs, cap, thd_alpha,
                                 scan=False, x_base=lo, x_hi=hi)
        fast_launches += 1
        return out
    return batch_seed_anchors_fast_reference(seqs, lens, dir_start, hs, cap,
                                             thd_alpha, x_base, x_hi)


def compact_anchors(anc: torch.Tensor, keep: torch.Tensor, m_out: int):
    """The kept anchors of each row into (B, m_out) and the kept count (B,)
    int32 (count > m_out: overflow). CUDA tensors launch kernel K3 of
    csrc/seed_anchors.cu (and count the launch); CPU tensors run the plain
    version. Anything else raises."""
    global compact_launches
    if keep.device != anc.device:
        raise ValueError(f"anchors on {anc.device}, keep on {keep.device}")
    if anc.device.type == "cuda":
        from . import _cuda

        out = _cuda.compact_anchors(anc, keep, m_out)
        compact_launches += 1
        return out
    if anc.device.type == "cpu":
        return compact_anchors_reference(anc, keep, m_out)
    raise ValueError(f"no compaction kernel for device {anc.device}")


def pad_reads(reads: list, pad_len: int):
    """Reads (codes 0..4) -> (seqs (B, pad_len) uint8, zero past each read;
    lens (B,) int64), each read cut to pad_len."""
    seqs = np.zeros((len(reads), pad_len), dtype=np.uint8)
    lens = np.zeros((len(reads),), dtype=np.int64)
    for i, r in enumerate(reads):
        n = min(len(r), pad_len)
        seqs[i, :n] = r[:n]
        lens[i] = n
    return seqs, lens


def seed_anchors_dispatch(reads: list, index: DeviceIndex, pad_len: int,
                          thd_alpha: int = THD_ALPHA, m_out: int = 1024):
    """Enqueue the padded seeding of a list of reads (cut to pad_len) and
    the compaction of each row, without synchronising: returns (comp
    (B, m_out), count (B,), m_out) on the index's device. A batch without N
    takes the closed form (K2), one with N the scan (K1); both then K3. The
    batch goes out in launches of at most GRID_SLOTS grid slots."""
    seqs, lens = pad_reads(reads, pad_len)
    seeder = (batch_seed_anchors_fast if not (seqs == 4).any()
              else batch_seed_anchors)
    rows = max(1, GRID_SLOTS // max(1, n_positions(pad_len, thd_alpha)
                                    * index.cap))
    comps, counts = [], []
    for r0 in range(0, len(reads), rows):
        s = torch.from_numpy(seqs[r0: r0 + rows]).to(index.device)
        ln = torch.from_numpy(lens[r0: r0 + rows]).to(index.device)
        anc, keep = seeder(s, ln, index.dir_start, index.hs, index.cap,
                           thd_alpha)
        comp, count = compact_anchors(anc, keep, m_out)
        del anc, keep
        comps.append(comp)
        counts.append(count)
    if not comps:
        empty = torch.zeros((0, m_out), dtype=torch.int64, device=index.device)
        return empty, torch.zeros((0,), dtype=torch.int32,
                                  device=index.device), m_out
    return torch.cat(comps), torch.cat(counts), m_out


def seed_anchors_collect(dispatched, n_reads: int) -> list:
    """Wait for seed_anchors_dispatch: per-read anchor lists (ints) in the
    emission order; None for reads whose kept anchors overflow m_out."""
    comp, count, m_out = dispatched
    comp = comp.cpu().numpy().view(np.uint64)
    count = count.cpu().numpy()
    return [None if count[i] > m_out else comp[i, : count[i]].tolist()
            for i in range(n_reads)]


def seed_anchors_batch(reads: list, index: DeviceIndex, pad_len: int,
                       thd_alpha: int = THD_ALPHA, m_out: int = 8192) -> list:
    """Per-read anchor lists of a list of reads, as the host's
    getDIndexMatchAll gives them, or None where m_out overflows."""
    return seed_anchors_collect(
        seed_anchors_dispatch(reads, index, pad_len, thd_alpha, m_out),
        len(reads))
