"""Gap-interval anchors: the 9-mer seeding stage of mapInterval/mapGeneric
as a batched kernel (linear_tpu.ops.gap_dev).

Reference: g_mapHs_kmer_ (src/gap_util.cpp:632, double-strand canonical
9-mer stream, genome step 5 / read step 1), g_create_anchors_ (:1596, sort
+ xval-group cross product) with direction-0 bounds (g_mapHs_setAnchors_
:669). One call computes the anchor sets of many gap items, each equal to
the host stream's (map.gap g_map_hs_kmer + g_create_anchors). No path of
the system runs it (the JAX package leaves it unwired: its items appear in
the middle of the gap phase).

  batch_gap_anchors     the JAX package's entry point: item dicts in; per
                        item its anchors as uint64 in host order, or None on
                        overflow (the caller's host fallback).
  gap_anchors           the tensor-level call. CUDA tensors launch the
                        hand-written kernel csrc/gap_anchors.cu (and count
                        the launch in `launches`); CPU tensors run
                        gap_anchors_reference.
  gap_anchors_reference the plain PyTorch version, a straight translation
                        of linear_tpu's _gap_anchors_kernel: sort,
                        searchsorted, a capped gather of cap genome entries
                        per read 9-mer, and a stable argsort of a 46-bit
                        emission key (val, g_std, g_rel, r_std, r_rel) that
                        puts the kept anchors in host order.
  gap_anchors_filtered  the kernel's formulation stated plainly (for the
                        tests): read 9-mers whose val no genome group can
                        have (a hashed bitmap of the groups' vals) go before
                        the sort, vmax counting them first; the pairs come
                        in (genome entry, read key) order, which is the
                        emission key's order on windows within 0 ..
                        2^30 - 5 g_max; other windows sort them by key.

An item overflows (None) when a read 9-mer matches more than cap genome
entries, more than m_out anchors are kept, or a window is longer than
g_max samples (5 g_max + 4 hash positions) or r_max read positions.
Windows with N must be filtered by the caller; the arithmetic on the codes
it is given is JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

SHAPE_LEN = 9
GA_MASK1 = (1 << 20) - 1
GA_MASK3 = (1 << 30) - 1
GA_MASK5 = (1 << 31) - 1
GA_ZERO = 1 << 20
LLMIN = -(1 << 62)
LLMAX = 1 << 62
INVALID = 1 << 62       # the sort key of an unused slot

# launches of the CUDA kernel by gap_anchors in this process
launches = 0


def stream_vals(seq: torch.Tensor, span: int = SHAPE_LEN):
    """Canonical 9-mer stream values and strands for every window start of
    (B, L) uint8 sequences: val = x < 0 ? crh : h (g_mapHs_kmer_)."""
    B, L = seq.shape
    n_pos = L - span + 1
    s64 = seq.to(torch.int64)
    h = torch.zeros((B, n_pos), dtype=torch.int64, device=seq.device)
    crh = torch.zeros_like(h)
    ws = torch.zeros_like(h)
    for o in range(span):
        col = s64[:, o: o + n_pos]
        h = h + (col << (2 * (span - 1 - o)))
        crh = crh + ((3 - col) << (2 * o))
        ws = ws + col
    x = 2 * ws - 3 * span
    std = (x < 0).to(torch.int64)
    val = torch.where(std == 1, crh, h) & ((1 << (2 * span)) - 1)
    return val, std


def gap_anchors_reference(gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp, a_lo,
                          a_hi, g_max: int, r_max: int, cap: int, m_out: int):
    """Plain version of gap_anchors: (anchors, keys) (B, m_out) int64,
    count (B,) int32, overflow (B,) bool. Slots past min(count, m_out) hold
    what JAX's argsort puts there (unkept pairs, key 1 << 62)."""
    B = gseq.shape[0]
    dev = gseq.device
    gval, gstd = stream_vals(gseq)
    rval, rstd = stream_vals(rseq)
    # genome samples at rel 4, 9, 14, ... (step 5); read samples at every
    # rel position (step 1)
    g_rel = 4 + 5 * torch.arange(g_max, dtype=torch.int64, device=dev)
    g_ok = g_rel[None, :] < g_n[:, None]
    g_relc = torch.minimum(g_rel[None, :], (g_n[:, None] - 1).clamp(min=0))
    gv = gval.gather(1, g_relc)
    gs = gstd.gather(1, g_relc)
    r_rel = torch.arange(r_max, dtype=torch.int64, device=dev)
    r_ok = r_rel[None, :] < r_n[:, None]
    r_relc = torch.minimum(r_rel[None, :], (r_n[:, None] - 1).clamp(min=0))
    rv = rval.gather(1, r_relc)
    rs = rstd.gather(1, r_relc)
    # g_hs composites (g_hs_make: val<<33 | typ<<31 | std<<30 | abs_pos)
    g_ent = (gv << 33) + (gs << 30) + (gpos0[:, None] + g_relc)
    r_ent = (rv << 33) + (1 << 31) + (rs << 30) + (rpos0[:, None] + r_relc)
    g_sorted = torch.sort(torch.where(g_ok, g_ent, INVALID), dim=1).values
    # per read 9-mer: the genome entries with the same val
    lo = torch.searchsorted(g_sorted, rv << 33)
    hi = torch.searchsorted(g_sorted, (rv + 1) << 33)
    n_match = torch.where(r_ok, hi - lo, 0)
    # the first cap of them
    cs = torch.arange(cap, dtype=torch.int64, device=dev)
    idx = lo[:, :, None] + cs[None, None, :]
    pair_ok = cs[None, None, :] < n_match[:, :, None]
    idxc = idx.clamp(max=g_max - 1)
    hs1 = g_sorted.gather(1, idxc.reshape(B, -1)).reshape(B, r_max, cap)
    hs2 = r_ent[:, :, None]
    # g_hs_set_anchor (src/gap_util.cpp:548)
    std_ = ((hs1 ^ hs2) >> 30) & 1
    nsg = 2 * std_ - 1
    xx = rvcp[:, None, None] * std_ - nsg * (hs2 & GA_MASK3)
    anchor = (((hs1 + GA_ZERO - xx) & GA_MASK3) << 20) + xx + (std_ << 50)
    # direction-0 bound: anchor_lower <= str_anchor < anchor_upper
    tmp = ((anchor >> 20) & GA_MASK5) - GA_ZERO
    keep = pair_ok & (tmp >= a_lo[:, None, None]) & (tmp < a_hi[:, None, None])
    # the host's group walk never emits the trailing group, which holds the
    # largest val present in either stream
    neg1 = torch.full_like(gv, -1)
    vmax = torch.maximum(torch.where(g_ok, gv, neg1).amax(1),
                         torch.where(r_ok, rv, torch.full_like(rv, -1)).amax(1))
    keep = keep & (rv[:, :, None] < vmax[:, None, None])
    # emission key: (val, g_std, g_rel, r_std, r_rel)
    g_rel_of = (hs1 & GA_MASK3) - gpos0[:, None, None]
    key = ((rv[:, :, None] << 28) | (((hs1 >> 30) & 1) << 27)
           | (g_rel_of << 14) | (rs[:, :, None] << 13) | r_relc[:, :, None])
    flat_a = anchor.reshape(B, -1)
    flat_k = torch.where(keep, key, INVALID).reshape(B, -1)
    count = keep.reshape(B, -1).sum(1).to(torch.int32)
    overflow = ((n_match.amax(1) > cap) | (count > m_out)
                | (g_n > 5 * g_max + 4) | (r_n > r_max))
    order = torch.sort(flat_k, dim=1, stable=True).indices[:, :m_out]
    out_a = flat_a.gather(1, order)
    out_k = flat_k.gather(1, order)
    if out_a.shape[1] < m_out:  # fewer pairs than m_out slots
        pad = m_out - out_a.shape[1]
        out_a = torch.nn.functional.pad(out_a, (0, pad))
        out_k = torch.nn.functional.pad(out_k, (0, pad), value=INVALID)
    return out_a, out_k, count, overflow


# csrc/gap_anchors.cu: the bits of the hashed bitmap of the genome vals
GAP_BITS = 1 << 15


def gap_anchors_filtered(gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp, a_lo,
                         a_hi, g_max: int, r_max: int, cap: int, m_out: int):
    """The block-scan kernel's formulation, item by item (the same anchors,
    keys, count and overflow as gap_anchors_reference on
    [:min(count, m_out)]; slots past them hold anchor 0 and key 1 << 62).
    vmax is the largest val of every valid sample and read 9-mer; a read
    9-mer survives when the bit (val & (GAP_BITS - 1)) of some genome
    entry's group is set, the group's val being the entry's key >> 33 (a
    window start below 0 borrows from it; an entry below 0 is in no group;
    a read 9-mer of another val finds an empty group); the
    genome entries and the survivors' keys val << 14 | std << 13 | rel are
    sorted; genome entry gi (not below 0) pairs with the survivors of its
    val when it is among the first cap of its val group, and an item
    overflows when a group of more than cap meets a survivor; the pairs in
    (gi, read key) order are JAX's emission order when 0 <= gpos0 <= 2^30 -
    5 g_max, and are sorted by the emission key otherwise. Also returns
    each item's survivor count."""
    B = gseq.shape[0]
    GW, RW = gseq.shape[1], rseq.shape[1]
    dev = gseq.device
    gval, gstd = stream_vals(gseq)
    rval, rstd = stream_vals(rseq)
    out_a = torch.zeros((B, m_out), dtype=torch.int64, device=dev)
    out_k = torch.full((B, m_out), INVALID, dtype=torch.int64, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    survivors = torch.zeros((B,), dtype=torch.int64, device=dev)
    for b in range(B):
        ng = min(g_max, max(int(g_n[b]), 0) // 5)
        nr = min(r_max, max(int(r_n[b]), 0))
        t = torch.arange(ng, device=dev)
        p = (4 + 5 * t).clamp(max=GW - SHAPE_LEN)
        gv, gs = gval[b, p], gstd[b, p]
        g_ent = (gv << 33) + (gs << 30) + (int(gpos0[b]) + p)
        r = torch.arange(nr, device=dev)
        rp = r.clamp(max=RW - SHAPE_LEN)
        rv, rs = rval[b, rp], rstd[b, rp]
        vmax = max([-1] + [int(x.max()) for x in (gv, rv) if x.numel()])
        # the val of each entry's group, as the signed searchsorted sees
        # it (a window start below 0 borrows from the val)
        bitset = torch.zeros(GAP_BITS, dtype=torch.bool, device=dev)
        bitset[(g_ent[g_ent >= 0] >> 33) & (GAP_BITS - 1)] = True
        live = bitset[rv & (GAP_BITS - 1)]
        survivors[b] = int(live.sum())
        rk = torch.sort((rv[live] << 14) | (rs[live] << 13) | r[live]).values
        gk = torch.sort(g_ent).values
        val = gk >> 33
        glo = torch.searchsorted(gk, val << 33)
        ghi = torch.searchsorted(gk, (val + 1) << 33)
        rl = torch.searchsorted(rk, val << 14)
        rh = torch.searchsorted(rk, (val + 1) << 14)
        ok = gk >= 0
        ovf = bool((ok & (ghi - glo > cap) & (rh > rl)).any())
        npair = torch.where(ok & (t - glo < cap), rh - rl, 0)
        gi = torch.repeat_interleave(t, npair)
        first = torch.repeat_interleave(torch.cumsum(npair, 0) - npair, npair)
        key_r = rk[rl[gi] + torch.arange(gi.numel(), device=dev) - first]
        hs1 = gk[gi]
        rvv, r_std, rrel = key_r >> 14, (key_r >> 13) & 1, key_r & 0x1FFF
        hs2 = (rvv << 33) + (1 << 31) + (r_std << 30) + (int(rpos0[b]) + rrel)
        # g_hs_set_anchor (src/gap_util.cpp:548)
        std_ = ((hs1 ^ hs2) >> 30) & 1
        xx = int(rvcp[b]) * std_ - (2 * std_ - 1) * (hs2 & GA_MASK3)
        anchor = (((hs1 + GA_ZERO - xx) & GA_MASK3) << 20) + xx + (std_ << 50)
        tmp = ((anchor >> 20) & GA_MASK5) - GA_ZERO
        keep = (tmp >= int(a_lo[b])) & (tmp < int(a_hi[b])) & (rvv < vmax)
        key = ((rvv << 28) | (((hs1 >> 30) & 1) << 27)
               | (((hs1 & GA_MASK3) - int(gpos0[b])) << 14) | (r_std << 13)
               | rrel)
        anchor, key = anchor[keep], key[keep]
        if not 0 <= int(gpos0[b]) <= (1 << 30) - 5 * g_max:
            order = torch.sort(key, stable=True).indices
            anchor, key = anchor[order], key[order]
        k = min(anchor.numel(), m_out)
        out_a[b, :k], out_k[b, :k] = anchor[:k], key[:k]
        count[b] = anchor.numel()
        overflow[b] = (ovf or anchor.numel() > m_out
                       or int(g_n[b]) > 5 * g_max + 4 or int(r_n[b]) > r_max)
    return out_a, out_k, count, overflow, survivors


def gap_anchors(gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp, a_lo, a_hi,
                g_max: int = 1024, r_max: int = 4096, cap: int = 16,
                m_out: int = 2048):
    """One launch over a batch of items: genome windows gseq (B, >= 5 g_max
    + 12) and read windows rseq (B, >= r_max + 8) uint8, their hash
    positions g_n <= GW - 8 and r_n <= RW - 8, and the int64 (B,) scalars
    of batch_gap_anchors. Returns (anchors, keys (B, m_out) int64, count
    (B,) int32, overflow (B,) bool); anchors[:min(count, m_out)] are in
    host order. CUDA tensors launch the hand-written kernel (and count the
    launch); CPU tensors run the plain version. Anything else raises."""
    global launches
    args = (gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp, a_lo, a_hi)
    dev = gseq.device
    if any(t.device != dev for t in args):
        raise ValueError("the item tensors lie on different devices: "
                         + ", ".join(str(t.device) for t in args))
    if dev.type == "cuda":
        from . import _cuda

        out = _cuda.gap_anchors(*args, g_max, r_max, cap, m_out)
        launches += 1
        return out
    if dev.type == "cpu":
        return gap_anchors_reference(*args, g_max, r_max, cap, m_out)
    raise ValueError(f"no gap anchor kernel for device {dev}")


def pack_items(items, g_max: int = 1024, r_max: int = 4096):
    """linear_tpu's item packing: (gseq, g_n, gpos0, rseq, r_n, rpos0,
    rvcp, a_lo, a_hi) numpy arrays, windows cut to 5 g_max + 12 and r_max
    + 8 bases, bounds clipped to +-2^40."""
    B = len(items)
    GW = 5 * g_max + 4 + SHAPE_LEN - 1
    RW = r_max + SHAPE_LEN - 1
    gseq = np.zeros((B, GW), dtype=np.uint8)
    rseq = np.zeros((B, RW), dtype=np.uint8)
    sc = {k: np.zeros(B, dtype=np.int64) for k in
          ("g_n", "gpos0", "r_n", "rpos0", "rvcp", "a_lo", "a_hi")}
    for i, it in enumerate(items):
        gw = it["gwin"][:GW]
        rw = it["rwin"][:RW]
        gseq[i, : len(gw)] = gw
        rseq[i, : len(rw)] = rw
        sc["g_n"][i] = min(it["g_n"], GW - SHAPE_LEN + 1)
        sc["r_n"][i] = min(it["r_n"], RW - SHAPE_LEN + 1)
        sc["gpos0"][i] = it["gpos0"]
        sc["rpos0"][i] = it["rpos0"]
        sc["rvcp"][i] = it["rvcp"]
        sc["a_lo"][i] = max(it.get("a_lo", LLMIN), -(1 << 40))
        sc["a_hi"][i] = min(it.get("a_hi", LLMAX), 1 << 40)
    return (gseq, sc["g_n"], sc["gpos0"], rseq, sc["r_n"], sc["rpos0"],
            sc["rvcp"], sc["a_lo"], sc["a_hi"])


def batch_gap_anchors(items, g_max: int = 1024, r_max: int = 4096,
                      cap: int = 16, m_out: int = 2048, device: str = "cuda"):
    """items: list of dicts with keys
        gwin  (np.uint8 genome window covering hash positions
               [gs, gs + g_n) plus span-1 tail bases)
        g_n   number of genome hash positions (stop - gs)
        gpos0 absolute genome coordinate of gwin[0]
        rwin / r_n / rpos0   same for the read window (step 1)
        rvcp  read_len - 1
        a_lo, a_hi  direction-0 anchor bounds (LLMIN/LLMAX for mapGeneric)
    Returns per item its anchors in host order (uint64), or None on
    overflow. One call of gap_anchors on `device` covers the batch."""
    if not items:
        return []
    packed = pack_items(items, g_max, r_max)
    out_a, _, count, overflow = gap_anchors(
        *(torch.from_numpy(x).to(device) for x in packed),
        g_max=g_max, r_max=r_max, cap=cap, m_out=m_out)
    out_a = out_a.cpu().numpy().view(np.uint64)
    count = count.cpu().numpy()
    overflow = overflow.cpu().numpy()
    res = []
    for i, it in enumerate(items):
        if overflow[i] or it["g_n"] > 5 * g_max + 4 or it["r_n"] > r_max:
            res.append(None)
        else:
            res.append(out_a[i, : count[i]].copy())
    return res
