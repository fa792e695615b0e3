"""HIndex (`-i 2`): sorted Hs array + open-addressing XString directory.

Re-derivation of the reference's hash index (src/index_util.cpp):

  ysa : uint64[]  blocks of [Head, Body...] nodes sorted by xval
        Head: bit63=0 | ptr[23]@40 | xval[40]          (HsBase, :129-156)
        Body: bit63=1 | yval[20]@41 | strand@40 | sa[40], sa = id[10]|pos[30]
  xstr: open-addressing table of XNode{val1: u64, val2: u32}
        val1 = (key << 2) + type   (type 1 = xval head, 3 = virtual head)
        sized next-pow2 > count * alpha(1.6)            (XString::_fullSize :217)

Build (createHIndex, :1447-1476; config :2560-2575 — span 17, step 8,
blocklimit 1024, alpha 1.6):

  1. __createHsArray (:719-818): per genome, per OpenMP thread chunk, the
     FULL double-strand minimizer hash (hashNext, src/shape_extend.cpp:132)
     is evaluated at every position; positions with k % 8 == 0 whose XValue
     differs from the previously EMITTED one append [Head(ptr=2), Body].
     Two sequential quirks are load-bearing and reproduced exactly:
       - each block's Head is written one emission late, so the LAST head of
         every thread chunk takes the XValue of the chunk's final position
         (the flush at :794 uses tshape.XValue, not preX);
       - the Body YValue is hashNext's remainder encoding
         (hashNextXY, :272-281), NOT the 4-adjacent-bases YValue the query
         computes (hashNextXY2) — so sub-block y lookups effectively never
         match (big blocks act omitted; see query notes below).
  2. _hsSortX_1 (:432-561): stable LSD radix on the low 2*weight bits of the
     head xval, moving whole blocks — equivalent to a stable block sort.
  3. _createYSA (:1294-1447): merge consecutive equal-xval blocks (if the
     total number of merged heads is <= 2 the LAST block is aborted,
     :1336-1350), sort each block's bodies DESCENDING by the full u64,
     then fill the XString: blocks with ptr < blocklimit zero their bodies'
     y-field and get one entry xval -> first-body index; bigger blocks get a
     virtual head plus one entry (yval<<40)+xval -> body index per y-change.

Query (getHIndexMatchAll, src/pmpfinder.cpp:1918-1978): hashInit at 0, roll
hashNexth from read_str, every thd_alpha-th call evaluates hashNextX and, if
the XValue differs from the last processed one, getXDir (:1071-1093) probes
the XString; candidates with head ptr >= thd_delta(64) are skipped, then
bodies are walked while their y equals the query YValue or 0 and anchors are
emitted for sa positions inside [getCordX(map_str), getCordX(map_end)).
The walk deliberately runs into the two zero tail nodes after the last block
(they read as y==0 bodies with sa 0 — reference behavior, reproduced).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import hashing as H
from ..utils.cordscalar import cxid, make_anchor

U64 = np.uint64
M64 = (1 << 64) - 1

DEFAULT_SPAN = 17  # src/index_util.cpp:2566 (17/2*2+1)
DEFAULT_STEP = 8
DEFAULT_BLOCKLIMIT = 1024
DEFAULT_ALPHA = 1.6

MASK18 = (1 << 18) - 1
MASK20 = (1 << 20) - 1
MASK23 = (1 << 23) - 1
MASK30 = (1 << 30) - 1
MASK40 = (1 << 40) - 1
BIT63 = 1 << 63
STRAND_FLAG = 1 << 40  # HsBase.bodyCodeFlag
Y_FIELD = MASK20 << 41


def make_hs_head(ptr: int, xval: int) -> int:
    """Hs::makeHsHead (src/index_util.cpp:244): bit 63 cleared."""
    return ((ptr << 40) + xval) & (BIT63 - 1)


def make_hs_body(yval: int, gid: int, pos: int, strand: int) -> int:
    """Hs::makeHsBody (:277) + setHsBodyReverseStrand (:295). yval is NOT
    masked — build YValues can exceed 20 bits and spill into bits 61-62."""
    v = (((yval << 41) | BIT63) + (gid << 30) + pos) & M64
    return v | STRAND_FLAG if strand else v


def head_ptr(v: int) -> int:
    return (v >> 40) & MASK23


def head_x(v: int) -> int:
    return v & MASK40


def body_y(v: int) -> int:
    return (v >> 41) & MASK20


def wang_hash(val: int) -> int:
    """XNodeFunc::hash (src/index_util.cpp:971-982): Wang 64-bit mix."""
    key = (~val) & M64
    key = (key + (val << 21)) & M64
    key ^= key >> 24
    key = (key + (key << 3) + (key << 8)) & M64
    key ^= key >> 14
    key = (key + (key << 2) + (key << 4)) & M64
    key ^= key >> 28
    key = (key + (key << 31)) & M64
    return key


@dataclass
class HIndex:
    span: int
    weight: int
    ysa: np.ndarray          # uint64
    xs_val1: np.ndarray      # uint64 (pow2-sized)
    xs_val2: np.ndarray      # int64 (C++ uint32; values fit)
    xs_mask: int
    empty_dir: int


# --------------------------------------------------------------------- build

def _thread_chunks(total: int, threads: int) -> list[tuple[int, int]]:
    """__createHsArray chunking (src/index_util.cpp:740-760): total =
    len - span + 1 positions; first (total % threads) chunks one longer."""
    size2 = total // threads
    rem = total - size2 * threads
    out = []
    for t in range(threads):
        if t < rem:
            out.append(((size2 + 1) * t, size2 + 1))
        else:
            out.append((total - size2 * (threads - t), size2))
    return out


def _chunk_blocks_scalar(seq: np.ndarray, start: int, csize: int, span: int,
                         weight: int, step: int, gid: int) -> list[int]:
    """Exact scalar emulation of one thread chunk of __createHsArray
    (src/index_util.cpp:761-794), used when the chunk neighborhood contains
    N bases (the N-skip changes which positions are visited)."""
    st = H.HashStream(span, weight)
    if st.init(seq, start) < 0:
        return []
    out: list[int] = []
    pre_x = -1  # preX = ~0: differs from any real XValue
    last_xval = 0
    k = start
    end = start + csize
    while k < end:
        if k + span - 1 < len(seq) and int(seq[k + span - 1]) == 4:
            skip = st.init(seq, k)
            if skip < 0:
                break
            k += skip
            if k > csize - span + 1 + start:
                # the C++ jumps k past the chunk end to a step multiple and
                # STILL executes the iteration body there (:775-780) — one
                # extra hash+emission lands at the jump position
                k = csize - (csize + start) % step + step + start
        if k + span - 1 >= len(seq):
            break  # the C++ would read past the buffer here (UB)
        st.next_full(seq, k)
        last_xval = st.xval
        if k % step == 0 and st.xval != pre_x:
            if out:
                out[-2] = make_hs_head(2, pre_x)
            out.append(make_hs_head(2, pre_x if pre_x >= 0 else 0))
            out.append(make_hs_body(st.yval, gid, k, st.strand))
            pre_x = st.xval
        k += 1
    if out:
        out[-2] = make_hs_head(2, last_xval)
    return out


def _chunk_blocks(seq: np.ndarray, start: int, csize: int, span: int,
                  weight: int, step: int, gid: int, polys) -> list[np.ndarray]:
    """One thread chunk of __createHsArray -> interleaved [head, body, ...]
    uint64 nodes (vectorized; N-free fast path)."""
    if csize <= 0:
        return []
    if np.any(seq[start : start + csize + span - 1] == 4):
        vals = _chunk_blocks_scalar(seq, start, csize, span, weight, step, gid)
        return [np.array(vals, dtype=U64)] if vals else []
    sh = H.genome_stream_hashes(seq, start, start + csize, span, polys=polys)
    xv, yv, stc = H.minimizer_x_yfull(sh.h, sh.crh, sh.x, span, weight)
    samp = np.flatnonzero((sh.j % step) == 0)
    if len(samp) == 0:
        return []
    sx = xv[samp]
    emit = np.ones(len(sx), dtype=bool)
    emit[1:] = sx[1:] != sx[:-1]
    e = samp[emit]
    m = len(e)
    # heads: emission i's head is written at emission i+1 with preX; the
    # final flush (:794) stamps the chunk's LAST computed XValue
    heads_x = np.concatenate([sx[emit][: m - 1], [xv[-1]]]).astype(np.int64)
    heads = ((np.uint64(2) << U64(40)) + heads_x.astype(U64))
    bodies = (
        ((yv[e].astype(U64) << U64(41)) | U64(BIT63))
        + (U64(gid) << U64(30))
        + sh.j[e].astype(U64)
    ) | (stc[e].astype(U64) << U64(40))
    inter = np.empty(2 * m, dtype=U64)
    inter[0::2] = heads
    inter[1::2] = bodies
    return [inter]


def build_hindex(
    seqs: list[np.ndarray],
    span: int = DEFAULT_SPAN,
    step: int = DEFAULT_STEP,
    blocklimit: int = DEFAULT_BLOCKLIMIT,
    alpha: float = DEFAULT_ALPHA,
    threads_emul: int = 16,
) -> HIndex:
    weight = span - 8
    parts: list[np.ndarray] = []
    for gid, seq in enumerate(seqs):
        total = len(seq) - span + 1
        if total <= 0:
            continue
        polys = H.window_polys(seq, span)
        for start, csize in _thread_chunks(total, threads_emul):
            parts.extend(_chunk_blocks(seq, start, csize, span, weight,
                                       step, gid, polys))
    hs = np.concatenate(parts) if parts else np.zeros(0, U64)
    return _finalize(hs, span, weight, blocklimit, alpha)


def _finalize(hs: np.ndarray, span: int, weight: int, blocklimit: int,
              alpha: float) -> HIndex:
    """_hsSortX_1 + _createYSA (src/index_util.cpp:432-561, 1294-1447)."""
    heads = hs[0::2]
    bodies = hs[1::2]
    # stable block sort on the low 2*weight bits of xval (the radix digits)
    key = (heads & U64((1 << (2 * weight)) - 1)).astype(np.int64)
    order = np.argsort(key, kind="stable")
    hx = (heads[order] & U64(MASK40)).astype(np.int64)
    bodies = bodies[order]
    n = len(hx)
    if n == 0:
        ysa = np.zeros(2, dtype=U64)
        v1 = np.zeros(2, dtype=U64)
        return HIndex(span, weight, ysa, v1, np.zeros(2, np.int64), 1, 0)
    # ---- dedup heads: group consecutive equal xvals (:1302-1334)
    new_grp = np.ones(n, dtype=bool)
    new_grp[1:] = hx[1:] != hx[:-1]
    gidx = np.cumsum(new_grp) - 1
    n_grp = int(gidx[-1]) + 1
    count_move = n - n_grp
    grp_sizes = np.bincount(gidx, minlength=n_grp)  # bodies per group
    grp_x = hx[new_grp]
    # countMove <= 2 aborts the LAST block (:1336-1350): its head + first
    # body are zeroed, empty_dir points at its head, and its bodies stay
    # un-y-sorted / un-inserted (they sit past empty_dir's tail zeros)
    abort_last = count_move <= 2
    # ---- per-group descending body sort (std::greater, :1370-1380)
    starts = np.zeros(n_grp + 1, dtype=np.int64)
    np.cumsum(grp_sizes, out=starts[1:])
    total_nodes = n_grp + n  # one head per group + all bodies
    ysa = np.zeros(total_nodes + 2, dtype=U64)
    pos = 0
    grp_head_pos = np.zeros(n_grp, dtype=np.int64)
    for g in range(n_grp):
        sz = int(grp_sizes[g])
        grp_head_pos[g] = pos
        ysa[pos] = U64(make_hs_head(sz + 1, int(grp_x[g])))
        blk = bodies[starts[g] : starts[g + 1]]
        if not (abort_last and g == n_grp - 1):
            blk = np.sort(blk)[::-1]
        ysa[pos + 1 : pos + 1 + sz] = blk
        pos += sz + 1
    if abort_last and n_grp >= 1:
        empty_dir = int(grp_head_pos[n_grp - 1])
        ysa[empty_dir] = U64(0)
        ysa[empty_dir + 1] = U64(0)
        fill_grps = n_grp - 1
    else:
        empty_dir = pos
        fill_grps = n_grp
        # tail zeros already in place (array zero-initialized)
    # ---- XString sizing (:1398-1420) and fill (:1424-1460)
    count = 0
    for g in range(fill_grps):
        sz = int(grp_sizes[g])
        if sz + 1 < blocklimit:
            count += 1
        else:
            p = grp_head_pos[g]
            prev = int(ysa[p])
            for j in range(p + 1, p + 1 + sz):
                cur = int(ysa[j])
                if body_y(cur ^ prev):
                    count += 1
                prev = cur
            count += 1
    size = 1
    while size < count * alpha:
        size <<= 1
    mask = size - 1
    v1 = np.zeros(size, dtype=U64)
    v2 = np.zeros(size, dtype=np.int64)

    def insert(key: int, val2: int, node_type: int) -> None:
        h1 = wang_hash(key) & mask
        delta = 0
        while int(v1[h1]):
            h1 = (h1 + delta + 1) & mask
            delta += 1
        v1[h1] = U64(((key << 2) + node_type) & M64)
        v2[h1] = val2

    for g in range(fill_grps):
        sz = int(grp_sizes[g])
        p = int(grp_head_pos[g])
        xval = int(grp_x[g])
        if sz + 1 < blocklimit:
            # zero the bodies' y-field (bits 41-60 only; overflow bits stay)
            ysa[p + 1 : p + 1 + sz] &= U64(~Y_FIELD & M64)
            insert(xval, p + 1, 1)
        else:
            insert(xval, (~1) & 0xFFFFFFFF, 3)  # virtual head, val2 = ~1 (u32)
            prev = int(ysa[p])
            for j in range(p + 1, p + 1 + sz):
                cur = int(ysa[j])
                if body_y(cur ^ prev):
                    insert(xval + ((cur & Y_FIELD) >> 1), j, 1)
                prev = cur
    return HIndex(span, weight, ysa, v1, v2, mask, empty_dir)


# --------------------------------------------------------------------- query

def get_x_dir(index: HIndex, xval: int, yval: int) -> int:
    """getXDir (src/index_util.cpp:1071-1093)."""
    mask = index.xs_mask
    v1 = index.xs_val1
    h1 = wang_hash(xval) & mask
    val = (xval << 2) + 1
    delta = 0
    while int(v1[h1]):
        c = (int(v1[h1]) ^ val) & ((1 << 62) - 1)
        if c == 0:
            return int(index.xs_val2[h1])
        if c == 2:  # virtual head: re-key on (yval<<40)+xval
            val = ((yval << 42) + (xval << 2) + 1) & M64
            h1 = wang_hash(((yval << 40) + xval) & M64) & mask
            delta = 0
            continue
        h1 = (h1 + delta + 1) & mask
        delta += 1
    return index.empty_dir


def _query_stream(read: np.ndarray, read_str: int, read_end: int, span: int):
    """Hash states for getHIndexMatchAll's stream: hashInit at 0, calls at
    k in [read_str, read_end - span). Pure windows when read_str == 0; the
    re-apx case (read_str > 0) carries the init bias / mixed first calls."""
    first = read_str
    last = read_end - span
    j = np.arange(first, last, dtype=np.int64)
    if len(j) <= 0:
        return H.StreamHashes(j, np.zeros(0, U64), np.zeros(0, U64),
                              np.zeros(0, np.int64))
    h_all, crh_all, ws = H.window_polys(read, span)
    jc = np.minimum(j, len(h_all) - 1)
    h = h_all[jc].copy()
    crh = crh_all[jc].copy()
    x = 2 * ws[jc] - 3 * span
    if first > 0:
        st = H.HashStream(span)
        k0 = st.init(read, 0)
        if k0 < 0:
            return H.StreamHashes(j[:0], h[:0], crh[:0], x[:0])
        x += 2 * (
            int(read[k0 : k0 + span - 1].astype(np.int64).sum())
            - int(read[first : first + span - 1].astype(np.int64).sum())
        )
        n_mixed = min(span - 1, len(j))
        for c in range(n_mixed):
            st.nexth(read, int(j[c]))
            h[c] = st.h
            crh[c] = st.crh
            x[c] = st.x
    return H.StreamHashes(j, h, crh, x)


def _query_samples_scalar(read, read_str, read_end, span, weight, thd_alpha):
    """Exact scalar sampling loop for reads containing N. Unlike the build
    stream, getHIndexMatchAll (src/pmpfinder.cpp:1925-1933) has NO N-skip:
    it rolls hashNexth straight through N bases (their code-4 carries
    pollute the hash exactly as in the C++, which HashStream reproduces)."""
    st = H.HashStream(span, weight)
    if st.init(read, 0) < 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    out = []
    dt = 0
    for k in range(read_str, read_end - span):
        st.nexth(read, k)
        dt += 1
        if dt == thd_alpha:
            dt = 0
            st.nextx(read, k)
            out.append((k, st.xval, st.yval, st.strand))
    if not out:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    a = np.array(out, dtype=np.int64)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


def query_anchors(
    index: HIndex,
    read: np.ndarray,
    map_str: int,
    map_end: int,
    thd_alpha: int = 15,
    thd_delta: int = 64,
) -> np.ndarray:
    """getHIndexMatchAll (src/pmpfinder.cpp:1918-1978) -> uint64 anchors in
    the reference's emission order."""
    from ..utils.cordscalar import cy

    read_str = cy(map_str)
    read_end = cy(map_end)
    idx_str = cxid(map_str)
    idx_end = cxid(map_end)
    span, weight = index.span, index.weight
    read_len = len(read)
    if read_end - span <= read_str:
        return np.zeros(0, U64)
    if np.any(read[: read_end] == 4):
        j, xv, yv, stc = _query_samples_scalar(
            read, read_str, read_end, span, weight, thd_alpha)
    else:
        sh = _query_stream(read, read_str, read_end, span)
        if len(sh.j) == 0:
            return np.zeros(0, U64)
        si = np.arange(thd_alpha - 1, len(sh.j), thd_alpha)
        if len(si) == 0:
            return np.zeros(0, U64)
        j = sh.j[si]
        xv, yv, stc = H.minimizer_xy(
            read, j, sh.h[si], sh.crh[si], sh.x[si], span, weight)
    if len(j) == 0:
        return np.zeros(0, U64)
    keep = H.dedup_mask_query(xv)
    j, xv, yv, stc = j[keep], xv[keep], yv[keep], stc[keep]
    ysa = index.ysa
    n_ysa = len(ysa)
    anchors: list[int] = []
    for k, x, y, s in zip(j.tolist(), xv.tolist(), yv.tolist(), stc.tolist()):
        pos = get_x_dir(index, x, y)
        if pos == index.empty_dir:
            continue
        if head_ptr(int(ysa[pos - 1])) >= thd_delta:
            continue
        while True:
            body = int(ysa[pos])
            by = body_y(body)
            if by != y and by != 0:
                break
            idx = body & MASK40
            if idx_str <= idx < idx_end:
                gid = idx >> 30
                gx = idx & MASK30
                if ((body >> 40) & 1) ^ s:
                    anchors.append(make_anchor(gid, gx, read_len - 1 - k, 1))
                else:
                    anchors.append(make_anchor(gid, gx, k, 0))
            pos += 1
            if pos > n_ysa - 1:
                break
    return np.array(anchors, dtype=U64) if anchors else np.zeros(0, U64)
