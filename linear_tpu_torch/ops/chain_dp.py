"""Device chaining DP: batched getBestChains over sorted anchors.

Counterpart of linear_tpu.ops.chain_dp. The spec is getBestChains
(cluster_util.cpp:53) with getApxChainScore (:387, score_type 0) or
getApxChainScore0 (:337, score_type 1), over (B, N) int64 anchors sorted
descending by anchor-x in the first n_anchors[b] columns of each row:

  score[i] = max over eligible j < i with edge(j, i) > 0 of
             edge(j, i) + score[j] (the smallest j on ties), when > 0;
  p2[i] = that j (else -1), length[i] = length[j] + 1 (else 1).

j is eligible for i while j >= i - thd_chain_depth or
anchor_x[j] - anchor_x[i] < thd_chain_dx_depth; the anchors are sorted, so
that is the C++ loop's first break. The edge score is cast to int32 before
the add; every division truncates like C.

  chain_dp_windowed            the Mapper's DP: looks back at most W anchors
                               and flags rows where a dx-depth lookback could
                               reach past W (`overflow`: the caller runs the
                               exact host DP for them). CUDA tensors launch
                               the hand-written kernel csrc/chain_dp.cu (and
                               count the launch in `launches`); CPU tensors
                               run chain_dp_windowed_reference.
  chain_dp_windowed_reference  the plain PyTorch version, a straight
                               translation of linear_tpu's
                               batch_chain_dp_windowed: banded (B, N, W) edge
                               scores, then a scan with a (B, W) ring.
  key_max, key_bits            the kernel's step in plain PyTorch: one max
                               over key = total << bits | (d - 1) picks
                               JAX's argmax (the tests hold it to JAX's).
  chain_dp                     the full DP (linear_tpu's batch_chain_dp):
                               JAX's mask over every j < i, any row order,
                               every column computed. CUDA tensors launch
                               the second kernel of csrc/chain_dp.cu (and
                               count the launch in `full_launches`); CPU
                               tensors run chain_dp_reference.
  chain_dp_reference           its plain PyTorch version: column i's edge
                               scores and eligibility inside the loop over
                               i, in O(B N) memory.
  chain_dp_split               the kernel's decomposition stated plainly
                               (for the tests): column i's max split into
                               a near part (the last D columns, key_max)
                               and a far part (j < i - D), the far part
                               winning a tie; padded columns equal to the
                               one before them copy it; lengths from p2.

  sort_anchors                 the sort that feeds the DP on the mesh path
                               (the sort lines of linear_tpu.parallel.mesh's
                               mapping_step and sort_chain): each row's kept
                               anchors of the seeding grid in descending
                               anchor-x order, the first n_max. CUDA tensors
                               launch csrc/sort_anchors.cu (and count the
                               launch in `sort_launches`); CPU tensors run
                               sort_anchors_reference.
  sort_anchors_reference       its plain PyTorch version: a stable sort of
                               the keys and a gather.
  sort_anchors_chunked         the kernel's decomposition stated plainly
                               (for the tests): chunk counts and regions,
                               the composite items' sorting network, the
                               unkept fill by the chunks' unkept counts.

ChainsRecords (with root_ptr and f_leaf) are rebuilt on the host from the
tables by map.chaining.chain_records_from_dp.
"""
from __future__ import annotations

import torch

from ..map.chaining import chain_records_from_dp  # noqa: F401  (re-export)

MASK_Y = (1 << 20) - 1
MASK_X30 = (1 << 30) - 1
VALUE_MASK_DSTR = ((1 << 60) - 1) | (1 << 61)
NEG32 = -(2 ** 31) + 1  # the full DP's sentinel (JAX's NEG)
NEG40 = -(1 << 40)      # the windowed ring's sentinel

# launches of the CUDA kernels by chain_dp_windowed, chain_dp and
# sort_anchors in this process
launches = 0
full_launches = 0
sort_launches = 0


def _anchor_x(a: torch.Tensor) -> torch.Tensor:
    """getAnchorX (src/cords.cpp:463) on int64 anchors; the add may pass
    bit 63 and wraps, and the mask clears the high bits before the shift."""
    new = (a + ((a & MASK_Y) << 20) - (1 << 40)) & VALUE_MASK_DSTR
    return (new >> 20) & MASK_X30


def _tdiv(a: torch.Tensor, b) -> torch.Tensor:
    """C truncating division."""
    return torch.div(a, b, rounding_mode="trunc")


def _apx_chain_score(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """getApxChainScore (cluster_util.cpp:387); int32 result."""
    dy = (a1 & MASK_Y) - (a2 & MASK_Y)
    dx = _anchor_x(a1) - _anchor_x(a2)
    da = (dx - dy).abs()
    denom = torch.clamp(torch.maximum(dy.abs(), dx.abs()), min=50)
    derr = _tdiv(100 * da, denom)
    # derr * derr is only selected when derr < 100: clamping first gives
    # the same values without an int64 overflow in the discarded lanes
    dc = derr.clamp(max=100)
    score_derr = torch.where(dc < 5, 4 * dc,
                             torch.where(dc < 10, 6 * dc - 10, dc * dc - 5 * dc))
    dy15 = _tdiv(dy, 15)
    score_dy = torch.where(
        dy15 < 150, _tdiv(dy15, 5),
        torch.where(dy15 < 10000, _tdiv(dy15 * dy15, 200) + 20,
                    torch.full_like(dy15, 10000)))
    score = torch.where(da < 10, 100 - score_dy, 100 - score_dy - score_derr)
    score = torch.where(derr >= 100, torch.full_like(score, -1000), score)
    score = torch.where(dy < 10, torch.full_like(score, -10000), score)
    return score.to(torch.int32)


def _apx_chain_score0(a1: torch.Tensor, a2: torch.Tensor) -> torch.Tensor:
    """getApxChainScore0 (cluster_util.cpp:337), the toggle(1) variant."""
    dy = (a1 & MASK_Y) - (a2 & MASK_Y)
    dx = _anchor_x(a1) - _anchor_x(a2)
    da = (dx - dy).abs()
    denom = torch.clamp(torch.maximum(dy.abs(), dx.abs()), min=50)
    derr = _tdiv(100 * da, denom)
    score = torch.where(da < 30, 100 - dy, 100 - dy - da)
    score = torch.where(derr >= 100, torch.full_like(score, -1000), score)
    score = torch.where(dy < 5, torch.full_like(score, -10000), score)
    return score.to(torch.int32)


def _score_fn(score_type: int):
    return _apx_chain_score if score_type == 0 else _apx_chain_score0


def chain_dp_reference(anchors: torch.Tensor, n_anchors: torch.Tensor,
                       thd_chain_depth: int = 20, thd_chain_dx_depth: int = 300,
                       score_type: int = 0):
    """The full DP (linear_tpu.ops.chain_dp.batch_chain_dp): anchors (B, N)
    int64, n_anchors (B,) -> (p2, score, length), each (B, N) int32. Step i
    scores the edges (j, i) of every j at once: (B, N) tensors, never the
    (B, N, N) matrix."""
    B, N = anchors.shape
    dev = anchors.device
    n_anchors = n_anchors.to(device=dev, dtype=torch.int64)
    score_fn = _score_fn(score_type)
    ax = _anchor_x(anchors)
    jj = torch.arange(N, device=dev)
    valid = jj[None, :] < n_anchors[:, None]
    neg = torch.full((B, N), NEG32, dtype=torch.int64, device=dev)
    score = torch.zeros((B, N), dtype=torch.int32, device=dev)
    p2 = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    length = torch.ones((B, N), dtype=torch.int32, device=dev)
    for i in range(N):
        row = score_fn(anchors, anchors[:, i: i + 1]).to(torch.int64)
        ok = valid & (jj < i)[None, :] & (
            (jj >= i - thd_chain_depth)[None, :]
            | ((ax - ax[:, i: i + 1]) < thd_chain_dx_depth))
        tot = torch.where(ok & (row > 0), row + score.to(torch.int64), neg)
        max_j = torch.argmax(tot, dim=1)  # the first (smallest j) on ties
        new_max = tot.gather(1, max_j[:, None])[:, 0]
        found = new_max > 0
        score[:, i] = torch.where(found, new_max, 0).to(torch.int32)
        p2[:, i] = torch.where(found, max_j, -1).to(torch.int32)
        length[:, i] = torch.where(
            found, length.gather(1, max_j[:, None])[:, 0] + 1, 1)
    return p2, score, length


# csrc/chain_dp.cu's full DP: the lookbacks of the chain warp's near part
NEAR_D = 64


def far_edge_may_score(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The full DP kernel's test before it scores a far edge (far_column):
    dy = y[j] - y[i] and dx = anchor_x[j] - anchor_x[i] of an edge whose
    score of either type is positive satisfy it. getApxChainScore needs
    dy >= 10 and score_dy < 100 (dy / 15 < 150), getApxChainScore0 dy >= 5
    and 100 - dy > 0; dx <= -45 makes da >= denom (-1000); and past dx =
    100 dy / 87 (at most 2,585) derr >= 13 costs score_derr >= 104."""
    return (dy >= 5) & (dy < 2250) & (dx > -50) & (dx < 2599)


def chain_dp_split(anchors: torch.Tensor, n_anchors: torch.Tensor,
                   D: int = NEAR_D, thd_chain_depth: int = 20,
                   thd_chain_dx_depth: int = 300, score_type: int = 0):
    """The full DP kernel's decomposition, stated plainly for the tests (the
    same (p2, score, length) as chain_dp_reference). Real column i (i < n)
    takes the near part over d = 1 .. D (j = i - d >= 0, JAX's mask, a
    positive edge): one max of the packed key total << bits | (d - 1)
    (key_max), the largest total and then the smallest j; and the far part
    over j < i - D: the largest total, the smallest j on a tie. The far
    part wins a tie (its j is smaller); no positive total gives p2 -1 and
    score 0. A padded column (i >= n) takes a far part over every j < n,
    except that one past n + depth whose anchor-x and y equal column
    i - 1's copies column i - 1. Then length[i] = length[p2[i]] + 1 (1 at a
    root), p2[i] < i."""
    B, N = anchors.shape
    dev = anchors.device
    n = n_anchors.to(device=dev, dtype=torch.int64).clamp(0, N)
    score_fn = _score_fn(score_type)
    ax = _anchor_x(anchors)
    ay = anchors & MASK_Y
    jj = torch.arange(N, device=dev)
    d = torch.arange(1, D + 1, device=dev)
    bits = key_bits(D)
    depth, dxd = thd_chain_depth, thd_chain_dx_depth
    copy_from = n + min(max(depth, 0), N)
    score = torch.zeros((B, N), dtype=torch.int64, device=dev)
    p2 = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros((B, N), dtype=torch.int64, device=dev)
    for i in range(N):
        real = i < n
        ai, axi = anchors[:, i: i + 1], ax[:, i: i + 1]
        # near: the chain warp's step
        j = i - d
        jc = j.clamp(min=0)
        e = score_fn(anchors[:, jc], ai).to(torch.int64)
        elig = (j >= 0)[None] & real[:, None] & (
            (d <= depth)[None] | (ax[:, jc] - axi < dxd))
        tot = torch.where(elig & (e > 0), e + score[:, jc], 0)
        near, dn = key_max(tot, bits)
        # far: what the helper warps put in the tile's slot
        hi = torch.where(real, i - D, n)
        ok = (jj[None] < hi[:, None]) & (
            (jj >= i - depth)[None] | (ax - axi < dxd))
        e = score_fn(anchors, ai).to(torch.int64)
        ft = torch.where(ok & (e > 0), e + score, zero)
        far = ft.amax(1)
        fj = torch.where(far > 0, torch.argmax(ft, dim=1), -1)
        far_wins = far >= near
        p2[:, i] = torch.where(far_wins, fj, i - dn)
        score[:, i] = torch.maximum(far, near)
        if i > 0:
            copy = (i - 1 >= copy_from) & (axi[:, 0] == ax[:, i - 1]) & (
                ay[:, i] == ay[:, i - 1])
            p2[:, i] = torch.where(copy, p2[:, i - 1], p2[:, i])
            score[:, i] = torch.where(copy, score[:, i - 1], score[:, i])
    length = torch.ones((B, N), dtype=torch.int64, device=dev)
    for i in range(N):
        prev = length.gather(1, p2[:, i: i + 1].clamp(min=0))[:, 0]
        length[:, i] = torch.where(p2[:, i] >= 0, prev + 1, 1)
    return (p2.to(torch.int32), score.to(torch.int32),
            length.to(torch.int32))


def chain_dp(anchors: torch.Tensor, n_anchors: torch.Tensor,
             thd_chain_depth: int = 20, thd_chain_dx_depth: int = 300,
             score_type: int = 0):
    """One launch of the full DP: (p2, score, length), each (B, N) int32.
    CUDA tensors launch the hand-written kernel (and count the launch); CPU
    tensors run the plain PyTorch version. Anything else raises."""
    global full_launches
    dev = anchors.device
    if n_anchors.device != dev:
        raise ValueError(f"anchors on {dev}, counts on {n_anchors.device}")
    if dev.type == "cuda":
        from . import _cuda

        out = _cuda.chain_dp_full(anchors, n_anchors, thd_chain_depth,
                                  thd_chain_dx_depth, score_type)
        full_launches += 1
        return out
    if dev.type == "cpu":
        return chain_dp_reference(anchors, n_anchors, thd_chain_depth,
                                  thd_chain_dx_depth, score_type)
    raise ValueError(f"no chain DP kernel for device {dev}")


def chain_dp_windowed_reference(anchors: torch.Tensor, n_anchors: torch.Tensor,
                                W: int = 64, thd_chain_depth: int = 20,
                                thd_chain_dx_depth: int = 300,
                                score_type: int = 0):
    """Plain PyTorch version of the windowed DP (the module docstring):
    anchors (B, N) int64, n_anchors (B,) -> (p2, score, length) (B, N)
    int32 and overflow (B,) bool. Runs on any device."""
    B, N = anchors.shape
    dev = anchors.device
    n_anchors = n_anchors.to(device=dev, dtype=torch.int64)
    ax = _anchor_x(anchors)
    jj = torch.arange(N, device=dev)
    valid = jj[None, :] < n_anchors[:, None]
    # banded edges: edge[b, i, w] = score(a[b, i - (W - w)], a[b, i])
    d = W - torch.arange(W, device=dev)
    j_idx = jj[:, None] - d[None, :]                      # (N, W)
    j_clip = j_idx.clamp(0, N - 1)
    a_j = anchors[:, j_clip]                              # (B, N, W)
    ax_j = ax[:, j_clip]
    edge = _score_fn(score_type)(a_j, anchors[:, :, None])
    elig = (j_idx >= 0)[None] & valid[:, :, None] & (
        (j_idx >= jj[:, None] - thd_chain_depth)[None]
        | ((ax_j - ax[:, :, None]) < thd_chain_dx_depth))
    ring_s = torch.zeros((B, W), dtype=torch.int64, device=dev)
    ring_l = torch.ones((B, W), dtype=torch.int64, device=dev)
    neg = torch.full((B, W), NEG40, dtype=torch.int64, device=dev)
    scores, lens, p2_rel = [], [], []
    for i in range(N):
        e_i, ok_i = edge[:, i, :], elig[:, i, :]
        tot = torch.where(ok_i & (e_i > 0), e_i.to(torch.int64) + ring_s, neg)
        arg = torch.argmax(tot, dim=1)  # smallest w (= smallest j) on ties
        new_max = tot.gather(1, arg[:, None])[:, 0]
        found = new_max > 0
        s_i = torch.where(found, new_max, 0)
        l_i = torch.where(found, ring_l.gather(1, arg[:, None])[:, 0] + 1, 1)
        ring_s = torch.cat([ring_s[:, 1:], s_i[:, None]], dim=1)
        ring_l = torch.cat([ring_l[:, 1:], l_i[:, None]], dim=1)
        scores.append(s_i)
        lens.append(l_i)
        p2_rel.append(torch.where(found, arg, -1))
    scores = torch.stack(scores, dim=1).to(torch.int32)
    lens = torch.stack(lens, dim=1).to(torch.int32)
    p2_rel = torch.stack(p2_rel, dim=1)
    # p2 absolute: j = i - (W - w)
    p2 = torch.where(p2_rel >= 0, jj[None, :] - (W - p2_rel), -1).to(torch.int32)
    # overflow: some j < i - W could satisfy the dx-depth condition
    ax_far = torch.nn.functional.pad(ax, (W + 1, 0), value=1 << 40)[:, :N]
    overflow = (((ax_far - ax) < thd_chain_dx_depth) & valid
                & (jj[None, :] > W)).any(dim=1)
    return p2, scores, lens, overflow


def key_bits(w: int) -> int:
    """Bits of the index field d - 1 of the windowed kernel's key for a row
    whose widest lookback is w."""
    return max(w - 1, 0).bit_length()


def key_max(tot: torch.Tensor, bits: int):
    """The windowed kernel's step (csrc/chain_dp.cu): tot (B, w) int64,
    column d - 1 the total of lookback d (0: no eligible edge with a
    positive score) -> (best
    total, its d), one max of key = total << bits | (d - 1): the largest
    total, then the largest d, which is the smallest j = i - d, as JAX's
    argmax picks. d is 1 where no lookback counts (total 0)."""
    d = torch.arange(tot.shape[1], device=tot.device)
    key = torch.where(tot > 0, (tot << bits) | d, 0).amax(1)
    return key >> bits, (key & ((1 << bits) - 1)) + 1


def chain_dp_windowed(anchors: torch.Tensor, n_anchors: torch.Tensor,
                      W: int = 64, thd_chain_depth: int = 20,
                      thd_chain_dx_depth: int = 300, score_type: int = 0):
    """One launch of the windowed DP: (p2, score, length) (B, N) int32 and
    overflow (B,) bool. CUDA tensors launch the hand-written kernel (and
    count the launch); CPU tensors run the plain PyTorch version. Anything
    else raises."""
    global launches
    dev = anchors.device
    if n_anchors.device != dev:
        raise ValueError(f"anchors on {dev}, counts on {n_anchors.device}")
    if dev.type == "cuda":
        from . import _cuda

        out = _cuda.chain_dp_windowed(anchors, n_anchors, W, thd_chain_depth,
                                      thd_chain_dx_depth, score_type)
        launches += 1
        return out
    if dev.type == "cpu":
        return chain_dp_windowed_reference(anchors, n_anchors, W,
                                           thd_chain_depth, thd_chain_dx_depth,
                                           score_type)
    raise ValueError(f"no chain DP kernel for device {dev}")


def sort_anchors_reference(anc: torch.Tensor, keep: torch.Tensor, n_max: int):
    """Plain PyTorch version of the anchor sort: a stable ascending sort of
    key = keep ? -anchor_x : 1 << 62 over each row's flattened slots, the
    first n_max columns gathered, and the count min(kept, n_max)."""
    B = anc.shape[0]
    flat = anc.reshape(B, -1)
    kflat = keep.reshape(B, -1)
    n_anchors = kflat.sum(1).clamp(max=n_max).to(torch.int32)
    key = torch.where(kflat, -_anchor_x(flat), 1 << 62)
    order = torch.sort(key, dim=1, stable=True).indices[:, :n_max]
    return torch.gather(flat, 1, order), n_anchors


# csrc/sort_anchors.cu: flags a block of its flag pass, the items a row
# sorts in registers (more go in place in the row's scratch), and the items
# of a shared-memory tile there
SORT_CHUNK = 16384
SORT_REG_ITEMS = 1024
SORT_TILE = 8192


def sorting_network(items: torch.Tensor) -> torch.Tensor:
    """The kernel's bitonic network on one row's K int64 items, ascending:
    for each merge size 2 .. N (N the power of two >= K) a stage pairing
    mirrored indices of each block, then half-cleaners of halving span;
    every comparator puts the smaller item at the lower index, and one whose
    upper index is >= K is skipped (+inf there, which nothing passes). The
    kernel runs it in registers up to SORT_REG_ITEMS items, and past them
    the stages of span <= SORT_TILE tile by tile: those touch disjoint
    tiles, so the order is the same network."""
    a = items.clone()
    K = a.shape[0]
    N = 1 << max(K - 1, 0).bit_length()
    size = 2
    while size <= N:
        half, flip = size // 2, True
        while half >= 1:
            t = torch.arange(-(-K // (2 * half)) * half, device=a.device)
            start = (t // half) * 2 * half
            lo = start + t % half
            hi = start + 2 * half - 1 - t % half if flip else lo + half
            m = hi < K
            lo, hi = lo[m], hi[m]
            x, y = a[lo], a[hi]
            a[lo], a[hi] = torch.minimum(x, y), torch.maximum(x, y)
            half, flip = (size // 4 if flip else half // 2), False
        size *= 2
    return a


def sort_anchors_chunked(anc: torch.Tensor, keep: torch.Tensor, n_max: int,
                         chunk: int = SORT_CHUNK):
    """csrc/sort_anchors.cu's decomposition of the anchor sort, stated
    plainly for the tests (the same outputs as sort_anchors_reference):
    each chunk of `chunk` flags of a row counts its kept slots and lists
    their items (MASK_X30 - anchor_x) << 32 | flat index (here in flat
    order; the kernel's order within a chunk is any, the items being
    distinct); the
    row's items, gathered by the counts, go through sorting_network (their
    ascending order is the stable argsort of the keys); the first min(K,
    n_out) give the anchors; when K < n_out the chunks in order fill the
    rest with their unkept slots. Returns (out, count, chunk counts (B,
    chunks) int32, in_registers (B,) bool: K <= SORT_REG_ITEMS, the branch
    the kernel takes)."""
    B = anc.shape[0]
    flat = anc.reshape(B, -1)
    kflat = keep.reshape(B, -1)
    n = flat.shape[1]
    n_out = min(n_max, n)
    n_chunks = -(-n // chunk)
    out = torch.empty((B, n_out), dtype=torch.int64, device=flat.device)
    chunk_kept = torch.zeros((B, n_chunks), dtype=torch.int32)
    in_registers = torch.zeros(B, dtype=torch.bool)
    ax = _anchor_x(flat)
    for b in range(B):
        regions = []
        for c in range(n_chunks):
            f = torch.nonzero(kflat[b, c * chunk: (c + 1) * chunk])[:, 0] \
                + c * chunk
            chunk_kept[b, c] = f.numel()
            regions.append(((MASK_X30 - ax[b, f]) << 32) | f)
        items = sorting_network(torch.cat(regions))
        K = items.numel()
        in_registers[b] = K <= SORT_REG_ITEMS
        nk = min(K, n_out)
        out[b, :nk] = flat[b, items[:nk] & 0xFFFFFFFF]
        col = nk
        for c in range(n_chunks):
            if col >= n_out:
                break
            s, e = c * chunk, min((c + 1) * chunk, n)
            if e - s == int(chunk_kept[b, c]):
                continue
            u = torch.nonzero(~kflat[b, s:e])[:, 0][: n_out - col] + s
            out[b, col: col + u.numel()] = flat[b, u]
            col += u.numel()
    count = kflat.sum(1).clamp(max=n_max).to(torch.int32)
    return out, count, chunk_kept, in_registers


def sort_anchors(anc: torch.Tensor, keep: torch.Tensor, n_max: int):
    """The first n_max kept anchors of each row of the seeding grid (anc
    (B, ...) int64, keep of the same shape) in descending anchor-x order
    (ties keep the lower flat index, as jnp.argsort's stable sort) and
    their count min(kept, n_max) (B,) int32. Columns past the count hold
    the row's first unkept slots. CUDA tensors launch csrc/sort_anchors.cu
    (and count the launch); CPU tensors run the plain version. Anything
    else raises."""
    global sort_launches
    if keep.device != anc.device:
        raise ValueError(f"anchors on {anc.device}, keep on {keep.device}")
    if anc.device.type == "cuda":
        from . import _cuda

        out = _cuda.sort_anchors(anc, keep, n_max)
        sort_launches += 1
        return out
    if anc.device.type == "cpu":
        return sort_anchors_reference(anc, keep, n_max)
    raise ValueError(f"no anchor sort kernel for device {anc.device}")
