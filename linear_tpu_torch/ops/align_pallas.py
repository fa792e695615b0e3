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
