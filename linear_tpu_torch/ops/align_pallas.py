"""Banded semi-global alignment scores (linear_tpu.ops.align_pallas).

The -a path's score: match +3, mismatch -2, linear gap -1
(src/align_interface.cpp:178-189), free end gaps in both sequences
(overlap alignment), restricted to the band j - i in [-W, W) of KW = 2W
diagonals; the score is the best cell of row n and column m, at least 0.

  banded_align_scores   the JAX package's numpy-in, numpy-out entry point:
                        lists of uint8 code arrays in, int32 (B,) out; packs
                        the batch and makes one call of banded_align.
  banded_align          the tensor-level call: query codes a (B, L) uint8,
                        reference codes bpad (B, L + 2W) uint8 with the
                        reference at column W, true lengths nm (B, 2) int32.
                        CUDA tensors launch the hand-written kernel
                        csrc/banded_align.cu (and count the launch in
                        `launches`); CPU tensors run banded_align_reference.
  banded_align_reference  the plain PyTorch version: linear_tpu's _ba_kernel
                        row update on one (B, KW) band row at a time, the
                        log-step decayed prefix max included.
  banded_align_lanes    the kernel's decomposition of a row, stated plainly
                        for the tests: c diagonals a lane (banded_shape),
                        the in-lane running max, the scan across lanes and
                        warps, the second pass.
  banded_align_oracle, banded_align_cigar  the host oracles (copies).

Lane k of row i holds H[i][j] with j = i + k - W. Codes are compared as
bytes, so N (4) matches N; the pads (7 in the query, 9 in the reference)
never match and never reach a cell that counts.
"""
from __future__ import annotations

import numpy as np
import torch

S_MATCH = 3      # src/align_interface.cpp:178
S_MISMATCH = -2  # :179
S_GAP = -1       # :180-181 (open == extend -> linear)
NEG = -(1 << 28)
Q_PAD, R_PAD = 7, 9

# launches of the CUDA kernel by banded_align in this process
launches = 0
# where the kernel's branches start: up to BANDED_MAX_W (32 warps of 32
# lanes of 32 diagonals) on rows below BANDED_MAX_L (cells left of the
# matrix, which it does not mask, stay below every cell inside) the band
# lives in registers (banded_shape); past either the wide branch takes the
# pairs, masking every row as JAX does, up to W of BANDED_WIDE_MAX_W (2W fits
# an int32). csrc/banded_align.cu (wide_branch) routes the launches.
BANDED_MAX_W = 16384
BANDED_MAX_L = 1 << 25
BANDED_WIDE_MAX_W = (1 << 30) - 1
_NEG_INF = -(1 << 30)  # below every candidate + diagonal


def banded_shape(W: int) -> tuple:
    """The register branch's launch shape at W (csrc/banded_align.cu
    lt_banded_align_shape): (warps a pair, diagonals a lane). One warp up
    to KW = 256; ceil(KW / 256) warps up to 8,192, ceil(KW / 512) warps of
    16 diagonals up to 16,384, then 32 warps of 32 (the padded layout)."""
    KW = 2 * W
    if not 1 <= W <= BANDED_MAX_W:
        raise ValueError(f"W {W} outside 1..{BANDED_MAX_W}")
    if KW > 64 * 256:
        return 32, 32
    nw = 1 if KW <= 256 else -(-KW // 256) if KW <= 32 * 256 \
        else -(-KW // 512)
    return nw, -(-KW // (32 * nw))


def banded_lanes(W: int):
    """(k0, vl) of each lane of a pair, int64 (P,) tensors: lane g owns the
    vl diagonals from k0. The exact layout gives the first KW - P (c - 1)
    lanes c diagonals and the rest c - 1; the padded one (c 1 and 32) gives
    lane g the diagonals from g c that lie in the band."""
    KW = 2 * W
    nw, c = banded_shape(W)
    P = 32 * nw
    g = torch.arange(P)
    if c in (1, 32):
        k0 = g * c
        return k0, (KW - k0).clamp(0, c)
    r = KW - P * (c - 1)
    return (torch.where(g < r, g * c, r * c + (g - r) * (c - 1)),
            torch.where(g < r, c, c - 1))


def _decayed_prefix_max(m: torch.Tensor, width: int) -> torch.Tensor:
    """r[k] = max over t <= k of (m[t] - (k - t)), by log-shift steps."""
    r = m
    s = 1
    while s < width:
        shifted = torch.nn.functional.pad(r[:, :-s], (s, 0), value=NEG)
        r = torch.maximum(r, shifted - s)
        s <<= 1
    return r


def banded_align_reference(a: torch.Tensor, bpad: torch.Tensor,
                           nm: torch.Tensor, W: int) -> torch.Tensor:
    """Plain version of banded_align (the module docstring): int32 (B,)."""
    B, L = a.shape
    KW = 2 * W
    dev = a.device
    n = nm[:, 0:1].to(torch.int64)
    m = nm[:, 1:2].to(torch.int64)
    ks = torch.arange(KW, device=dev)[None, :]
    neg = torch.full((B, KW), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(neg)
    j0 = ks - W
    prev = torch.where((j0 >= 0) & (j0 <= m), zero, neg)
    best = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    a = a.to(torch.int32)
    bpad = bpad.to(torch.int32)
    rows = min(L, int(n.max())) if B else 0
    for i in range(rows):  # rows past every n change nothing
        ii = i + 1
        j = ii + ks - W
        sub = torch.where(bpad[:, i: i + KW] == a[:, i: i + 1],
                          S_MATCH, S_MISMATCH).to(torch.int32)
        up = torch.nn.functional.pad(prev[:, 1:], (0, 1), value=NEG)
        mcand = torch.maximum(prev + sub, up + S_GAP)
        mcand = torch.where(j == 0, zero, mcand)
        out = (j < 0) | (j > m)
        mcand = torch.where(out, neg, mcand)
        row = torch.where(out, neg, _decayed_prefix_max(mcand, KW))
        colm = torch.where((j == m) & (ii <= n), row, neg).amax(1, keepdim=True)
        rown = torch.where(ii == n, row, neg).amax(1, keepdim=True)
        best = torch.maximum(best, torch.maximum(colm, rown))
        prev = torch.where(ii <= n, row, prev)
    return best[:, 0]


def banded_align_lanes(a: torch.Tensor, bpad: torch.Tensor,
                       nm: torch.Tensor, W: int) -> torch.Tensor:
    """csrc/banded_align.cu's decomposition, for the tests (the same scores
    as banded_align_reference). Lane g (warp g // 32) owns vl diagonals
    from k0 (banded_lanes) in c register slots; slots past vl are pad. A
    row: the move from above of a lane's last diagonal is the next lane's
    first cell (NEG at the band's end); pass 1 makes each candidate
    max(diag + sub, up - 1), 0 at j = 0, NEG in a pad slot, and the lane's
    running max of v + t; the lanes' maxima (+ k0) are scanned inside each
    warp and the warps' totals across warps, giving each lane the max of
    v + k over the diagonals before it; pass 2 makes each cell max(carry -
    k0, running max) - t. Cells outside 0 <= j <= m are not masked; the
    best takes column m's cell each row and row n's cells inside the band
    and the matrix."""
    B, L = a.shape
    KW = 2 * W
    nw, c = banded_shape(W)
    P = 32 * nw
    dev = a.device
    k0, vl = (x.to(dev)[:, None] for x in banded_lanes(W))   # (P, 1)
    t = torch.arange(c, device=dev)                          # (c,)
    pad = t >= vl                                            # (P, c)
    k = k0 + t
    band_end = (k0[:, 0] + vl[:, 0] >= KW)[None, :]          # (1, P)
    m = nm[:, 1].to(torch.int64).clamp(max=L + W)
    n = torch.where(m < 0, 0, nm[:, 0].to(torch.int64).clamp(max=L))
    m = m[:, None, None]
    cell = torch.where(~pad & (k - W >= 0) & (k - W <= m), 0,
                       NEG).to(torch.int64)                  # (B, P, c)
    # the reference bytes past the pair's L + KW read as 0, as the kernel's
    # guarded loads do (only pad slots reach them)
    rpad = torch.nn.functional.pad(bpad.to(torch.int64), (0, KW + P * c))
    q = a.to(torch.int64)
    bidx = torch.arange(B, device=dev)[:, None, None]
    best = torch.zeros((B,), dtype=torch.int64, device=dev)
    for i in range(1, (int(n.max()) if B else 0) + 1):
        live = (i <= n)[:, None, None]
        tlo = (W - i - k0)[None]                             # (1, P, 1)
        tm = tlo + m
        tm = torch.where(tm < vl, tm, -1)
        up_last = torch.nn.functional.pad(cell[:, 1:, 0], (0, 1), value=NEG)
        up_last = torch.where(band_end, NEG, up_last)        # (B, P)
        nxt = torch.cat([cell[:, :, 1:], up_last[:, :, None]], dim=2)
        up = torch.where(t + 1 == vl, up_last[:, :, None], nxt)
        rb = rpad[bidx, i - 1 + k]
        sub = torch.where(rb == q[:, i - 1, None, None], S_MATCH, S_MISMATCH)
        v = torch.maximum(cell + sub, up + S_GAP)
        v = torch.where(t == tlo, 0, v)
        v = torch.where(pad, NEG, v)
        run = torch.cummax(v + t, dim=2).values              # pass 1
        inc = (run[:, :, -1] + k0[:, 0]).reshape(B, nw, 32)
        inc = torch.cummax(inc, dim=2).values                # in the warp
        carry = torch.nn.functional.pad(inc[:, :, :-1], (1, 0),
                                        value=_NEG_INF)
        tot = torch.nn.functional.pad(inc[:, :-1, -1], (1, 0),
                                      value=_NEG_INF)
        wc = torch.cummax(tot, dim=1).values                 # across warps
        carry = torch.maximum(carry, wc[:, :, None]).reshape(B, P, 1)
        h = torch.maximum(carry - k0, run) - t               # pass 2
        colm = torch.where(t == tm, h, NEG).amax(dim=(1, 2))
        best = torch.where(live[:, 0, 0], torch.maximum(best, colm), best)
        cell = torch.where(live, h, cell)
    j = n[:, None, None] + k - W
    inside = ~pad & (j >= 0) & (j <= m)
    best = torch.maximum(best, torch.where(inside, cell, NEG).amax(dim=(1, 2)))
    return best.to(torch.int32)


def banded_align_ring(a: torch.Tensor, bpad: torch.Tensor,
                      nm: torch.Tensor, W: int) -> torch.Tensor:
    """csrc/banded_align.cu's wide kernel, for the tests (the same scores
    as banded_align_reference). Row i computes only its diagonals inside
    the matrix, [lo, hi] = [max(0, W - i), min(2W - 1, W - i + m)], and
    reads row i - 1 from a ring of S = min(2W, m + 1) + 1 cells (m taken
    at most L + W), diagonal k at k mod S: its own cell (the move along the
    diagonal) and k + 1's (the move from above, NEG past the band); row i
    - 1 wrote every one of them but lo's when lo is column 0, whose
    candidate is 0. The cells are the prefix max of v + k less k, written
    back into the ring; a band that has left the matrix ends the pair.
    Row 0's window is 0; the best takes column m's cell each row and row
    n's cells."""
    B, L = a.shape
    KW = 2 * W
    q, r = a.to(torch.int64).cpu(), bpad.to(torch.int64).cpu()
    out = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        n, m = min(int(nm[b, 0]), L), int(nm[b, 1])
        S = min(KW, max(0, min(m, L + W)) + 1) + 1
        ring = torch.full((S,), NEG, dtype=torch.int64)
        ring[(W + torch.arange(max(0, min(W, m + 1)))) % S] = 0
        best = 0
        for i in range(1, n + 1):
            lo, hi = max(0, W - i), min(KW - 1, W - i + m)
            if hi < lo:
                break
            k = torch.arange(lo, hi + 1)
            up = torch.where(k + 1 < KW, ring[(k + 1) % S], NEG)
            sub = torch.where(r[b, i - 1 + k] == q[b, i - 1], S_MATCH,
                              S_MISMATCH)
            v = torch.maximum(ring[k % S] + sub, up + S_GAP)
            v = torch.where(i + k == W, 0, v)
            cell = torch.cummax(v + k, dim=0).values - k
            ring[k % S] = cell
            if i == n:
                best = max(best, int(cell.max()))
            if W - i + m <= hi:  # column m is inside the window
                best = max(best, int(cell[W - i + m - lo]))
        out[b] = best
    return out


def banded_align(a: torch.Tensor, bpad: torch.Tensor, nm: torch.Tensor,
                 W: int) -> torch.Tensor:
    """Scores (B,) int32 of the pairs (the module docstring). CUDA tensors
    launch the hand-written kernel (and count the launch); CPU tensors run
    the plain version. Anything else raises."""
    global launches
    dev = a.device
    if bpad.device != dev or nm.device != dev:
        raise ValueError(f"a on {dev}, bpad on {bpad.device}, nm on "
                         f"{nm.device}")
    if a.dim() != 2 or bpad.shape != (a.shape[0], a.shape[1] + 2 * W) \
            or nm.shape != (a.shape[0], 2):
        raise ValueError(f"a {tuple(a.shape)}, bpad {tuple(bpad.shape)}, nm "
                         f"{tuple(nm.shape)} do not fit W {W}")
    if dev.type == "cuda":
        from . import _cuda

        out = _cuda.banded_align(a, bpad, nm, W)
        launches += 1
        return out
    if dev.type == "cpu":
        return banded_align_reference(a, bpad, nm, W)
    raise ValueError(f"no banded alignment kernel for device {dev}")


def pack_pairs(qry: list, ref: list, W: int, L: int | None = None):
    """linear_tpu's packing: (a, bpad, nm) numpy arrays, L the next
    multiple of 128 over the longest sequence unless given."""
    B = len(qry)
    maxlen = max([1] + [max(len(q), len(r)) for q, r in zip(qry, ref)])
    if L is None:
        L = -(-maxlen // 128) * 128
    if maxlen > L:
        raise ValueError(f"a sequence of {maxlen} does not fit L {L}")
    a = np.full((B, L), Q_PAD, dtype=np.uint8)
    bpad = np.full((B, L + 2 * W), R_PAD, dtype=np.uint8)
    nm = np.zeros((B, 2), dtype=np.int32)
    for i, (q, r) in enumerate(zip(qry, ref)):
        a[i, : len(q)] = q
        bpad[i, W: W + len(r)] = r
        nm[i] = len(q), len(r)
    return a, bpad, nm


def banded_align_scores(qry: list, ref: list, W: int = 128,
                        L: int | None = None,
                        device: str = "cuda") -> np.ndarray:
    """Batch of banded overlap alignments: int32 scores (B,).

    qry/ref: lists of uint8 code arrays (pairs aligned elementwise).
    W: band half-width (KW = 2W diagonals, j - i in [-W, W)).
    L: pad length (defaults to the next multiple of 128).
    The whole batch goes to the device in one call."""
    if len(qry) != len(ref):
        raise ValueError(f"{len(qry)} queries, {len(ref)} references")
    if not qry:
        return np.zeros(0, dtype=np.int32)
    a, bpad, nm = pack_pairs(qry, ref, W, L)
    out = banded_align(*(torch.from_numpy(x).to(device)
                         for x in (a, bpad, nm)), W)
    return out.cpu().numpy()


def banded_align_oracle(q: np.ndarray, r: np.ndarray, W: int = 128) -> int:
    """Reference oracle: dense semi-global banded DP (numpy, O(n*m))."""
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return 0
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    H[0, : m + 1] = 0
    H[: n + 1, 0] = 0
    for i in range(1, n + 1):
        lo = max(1, i - W)
        hi = min(m, i + W - 1)
        for j in range(lo, hi + 1):
            s = S_MATCH if q[i - 1] == r[j - 1] else S_MISMATCH
            H[i, j] = max(H[i - 1, j - 1] + s, H[i - 1, j] + S_GAP,
                          H[i, j - 1] + S_GAP)
    return int(max(H[n, : m + 1].max(), H[: n + 1, m].max()))


def banded_align_cigar(q: np.ndarray, r: np.ndarray, W: int = 128):
    """Host traceback companion of the score kernel: the full banded DP
    with traceback. Returns (score, cigar, q_span, r_span) with cigar in
    SAM =/X/I/D ops ('I' consumes query); end gaps are NOT emitted
    (free-end overlap semantics)."""
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return 0, "", (0, 0), (0, 0)
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    H[0, : m + 1] = 0
    H[: n + 1, 0] = 0
    for i in range(1, n + 1):
        lo = max(1, i - W)
        hi = min(m, i + W - 1)
        if lo > hi:
            continue
        js = np.arange(lo, hi + 1)
        sub = np.where(q[i - 1] == r[lo - 1: hi], S_MATCH, S_MISMATCH)
        diag = H[i - 1, lo - 1: hi] + sub
        up = H[i - 1, lo: hi + 1] + S_GAP
        cand = np.maximum(diag, up)
        # serial left dependency
        row = H[i]
        prev = row[lo - 1]
        for k, j in enumerate(js):
            v = cand[k]
            if prev + S_GAP > v:
                v = prev + S_GAP
            row[j] = v
            prev = v
    # best end cell over last row / last column
    endr = int(np.argmax(H[n, : m + 1]))
    endc = int(np.argmax(H[: n + 1, m]))
    if H[n, endr] >= H[endc, m]:
        i, j = n, endr
    else:
        i, j = endc, m
    score = int(H[i, j])
    qe, re_ = i, j
    ops = []
    while i > 0 and j > 0:
        s_ = S_MATCH if q[i - 1] == r[j - 1] else S_MISMATCH
        if H[i, j] == H[i - 1, j - 1] + s_:
            ops.append("=" if s_ == S_MATCH else "X")
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j] + S_GAP:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    # compress run-length
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1][0] += 1
        else:
            cigar.append([1, op])
    return (score, "".join(f"{c}{o}" for c, o in cigar), (i, qe), (j, re_))
