// Banded semi-global alignment scores for Hopper (sm_90a).
//
// Replaces linear_tpu/ops/align_pallas.py:142, the JAX package's only
// pl.pallas_call (_ba_kernel, :62): a grid of (pairs / 8, L) programs whose
// second, sequential axis walks the DP rows, with the band row and the
// running best kept in VMEM scratch across it, fed by a (B, L, KW)
// substitution tensor that XLA builds beforehand (L * KW * 4 bytes a pair,
// which is why JAX calls it 64 pairs at a time). The plain PyTorch version
// beside it is linear_tpu_torch/ops/align_pallas.py:banded_align_reference,
// and banded_align_lanes there states this kernel's decomposition. The
// score: +3 / -2 / linear gap -1, band j - i in [-W, W), free end gaps in
// both sequences, best over row n and column m, at least 0.
//
// What bounds it on the card: the chain of dependent steps a row. Row i
// needs row i - 1, and inside a row the gap chain H[i][j - 1] -> H[i][j] is
// a prefix operation across the band; a pair of n query bases is n such
// rows, and a few hundred pairs give each SM only a few pairs. The bytes
// (each pair's codes, 4 bytes out) and the operations are small.
//
// Design: the band lives in registers, and a row is as short a chain as a
// warp can make it. Diagonal k of row i holds H[i][j] with j = i + k - W.
//   Up to KW = 256 a pair is one warp (a block of 32 threads). The lanes
//   own consecutive diagonals, c = ceil(KW / 32) or c - 1 of them (the
//   first KW - 32 (c - 1) lanes c, the rest c - 1: a short lane's last
//   register slot is pad), c a template parameter (1..8) so that the cells
//   stay in registers. A row:
//     - the move from above of the lane's last diagonal is one
//       __shfl_down_sync of the next lane's first cell (NEG at the band's
//       end);
//     - pass 1, in the lane: each diagonal's candidate max(diag + sub,
//       up - 1) (0 at j = 0) by one DPX __viaddmax_s32, the substitution
//       from a __vcmpeq4 of four window bytes at once, and the running max
//       of candidate + t (the in-lane prefix), another __viaddmax_s32;
//     - a 5-step shuffle scan of the lanes' running maxima (+ their first
//       diagonal) gives each lane the max of v + k over the diagonals
//       before it: the gap chain r[k] = max over t <= k of (v[t] - (k - t))
//       is (prefix max of v[t] + t) - k;
//     - pass 2, in the lane: each cell max(carry, its prefix) - k, no
//       chain between diagonals; column m's cell from a select tree on
//       the bits of its lane-relative diagonal, built during the scan.
//     No shared memory and no barrier. Cells outside 0 <= j <= m are not
//     masked a row: those left of the matrix stay near NEG (L < 2^25 rows
//     keep them below every cell inside), those right of it feed no cell
//     inside (a cell reads only its own column and the one before), and the
//     score reads only column m and row n's cells inside. The query byte of
//     row i and the reference byte that enters the last lane's window come
//     from 32-row chunks that each lane loads one chunk ahead (a
//     __shfl_sync a row picks the row's byte); the lane's reference window
//     (c bytes, packed four a register) shifts by one byte a row, the new
//     byte coming from the next lane's window by one more shuffle. No load
//     sits on a row's chain.
//   Wider bands take several warps a pair (lt_banded_align_shape: c 5..8 up
//   to KW 8,192, c 16 up to 16,384, then 32 warps of c 32 with whole pad
//   lanes past the band), one barrier a row: each warp publishes its
//   running max and its first diagonal's candidate (double-buffered by row
//   parity), and after the barrier takes the max of the warps before it
//   (its carry; a read a lane and one __reduce_max_sync) and computes the
//   next warp's first cell itself, which is the move from above of its
//   last lane in the next row. KW <= 32,768 (W <= 16,384). (c 1 also
//   takes the padded layout: lanes past KW < 32 own no diagonal.)
// Rows past n are not run (in JAX they do not evolve). The prefix max
// differs from JAX's log-step form only among cells near NEG (its shifts
// bring in NEG pads), which never reach the returned score.
//
// Past the register design (W > 16,384, or L >= 2^25, where the unmasked
// cells left of the matrix could climb to the cells inside) every pair takes
// the wide kernel at the end of the namespace: one block of up to 1,024
// threads a pair, each row computed only on its diagonals inside the matrix
// (at most min(KW, m + 1)), the others NEG as in JAX, so no cell drifts
// whatever L; the previous row in a ring of min(KW, m + 1) + 1 ints, in
// shared memory or, past 200 KB, in the pair's part of a device scratch that
// the wrapper allocates; a block scan of the threads' running maxima a row
// (two barriers). Any W < 2^30 (KW fits an int) and any L.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kNegInf = -(1 << 30);  // below every candidate + diagonal
constexpr int kMatch = 3;
constexpr int kMismatch = -2;
constexpr int kGap = -1;
constexpr int kOneWarpKW = 256;  // bands a single warp takes
constexpr int kMaxKW = 32768;    // 32 warps of 32 lanes of 32 diagonals
constexpr int kMaxL = 1 << 25;   // rows: NEG + 3 L stays below -2 L
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The lanes of a pair (P = 32 nw of them): lane g owns vl diagonals from
// k0. kPadded: k0 = g C and vl = clamp(KW - k0, 0, C) (lanes past the band
// hold pad diagonals; c 1 and c 32); else the exact layout C = ceil(KW /
// P), the first KW - P (C - 1) lanes C diagonals and the rest C - 1, so
// that only a short lane's last slot is pad.
struct Lanes {
  int k0, vl;
};

template <int C, bool kPadded>
__device__ __forceinline__ Lanes lane_layout(int g, int P, int KW) {
  if (kPadded) {
    const int k0 = g * C;
    return {k0, max(0, min(C, KW - k0))};
  }
  const int r = KW - P * (C - 1);
  return g < r ? Lanes{g * C, C} : Lanes{r * C + (g - r) * (C - 1), C - 1};
}

// kMulti: a block of nw warps a pair, one barrier a row; else one warp.
template <int C, bool kMulti, bool kPadded>
__global__ void __launch_bounds__(kMulti ? 1024 : 32)
    banded_align_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ bpad,
                        const int32_t* __restrict__ nm, int L, int W,
                        int32_t* __restrict__ out) {
  constexpr int kWords = (C + 3) / 4;
  __shared__ int sh_tot[2][32], sh_first[2][32], sh_best[32];
  const int KW = 2 * W;
  const int RL = L + KW;
  const int lane = threadIdx.x & 31;
  const int wl = kMulti ? (int)(threadIdx.x >> 5) : 0;
  const int nw = kMulti ? (int)(blockDim.x >> 5) : 1;
  const int64_t b = blockIdx.x;
  const Lanes me = lane_layout<C, kPadded>(wl * 32 + lane, 32 * nw, KW);
  const int k0 = me.k0, vl = me.vl;
  // the next lane's first diagonal is k0 + vl: the band ends in this lane
  // when that is KW (its last diagonal's move from above is then NEG)
  const bool band_end = k0 + vl >= KW;
  // the byte that enters the window, r[i + k0 + C - 1] after row i, is the
  // next lane's window byte C - vl (exact layout) or 0
  const int next_shift = kPadded ? 0 : 8 * (C - vl);
  // the next warp's first diagonal, and the reference offset of the bytes
  // that enter its last lane's window
  const int kend = kMulti ? lane_layout<C, kPadded>(wl * 32 + 32, 32 * nw,
                                                    KW).k0
                          : KW;
  const int koff = __shfl_sync(kFull, k0, 31) + C;
  const uint8_t* q = a + b * L;
  const uint8_t* r = bpad + b * (int64_t)RL;
  // j never passes L + W - 1, so a larger m compares the same; with m < 0
  // no cell is in the matrix and the score is 0
  const int m = min(nm[2 * b + 1], L + W);
  const int n = m < 0 ? 0 : min(nm[2 * b], L);
  // row 0: H[0][j] = 0 for 0 <= j <= m; the window R[t] = r[i - 1 + k0 + t]
  // of row i = 1, four bytes a word, bytes past C zero
  int cell[C];
  uint32_t rw[kWords];
#pragma unroll
  for (int x = 0; x < kWords; ++x) rw[x] = 0;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int k = k0 + t;
    cell[t] = (t < vl && k - W >= 0 && k - W <= m) ? 0 : kNeg;
    if (k < RL) rw[t >> 2] |= (uint32_t)r[k] << (8 * (t & 3));
  }
  // the last lane's move from above: the next warp's first cell (row 0)
  int upx = (kend < KW && kend - W >= 0 && kend - W <= m) ? 0 : kNeg;
  int best = 0;
  // rows i0 + 1 .. i0 + 32: lane l holds q[i0 + l] and r[i0 + l + koff],
  // the byte that enters the last lane's window after row i0 + l + 1
  auto load_chunk = [&](int i0, uint32_t& qc, uint32_t& rc) {
    qc = i0 + lane < L ? q[i0 + lane] : 0u;
    rc = i0 + lane + koff < RL ? r[i0 + lane + koff] : 0u;
  };
  uint32_t qc, rc;
  load_chunk(0, qc, rc);
  for (int i0 = 0; i0 < n; i0 += 32) {
    uint32_t qn, rn;
    load_chunk(i0 + 32, qn, rn);
    const int rows = min(32, n - i0);
    for (int s = 0; s < rows; ++s) {
      const int i = i0 + s + 1;
      const uint32_t q4 = __shfl_sync(kFull, qc, s) * 0x01010101u;
      const uint32_t rlast = __shfl_sync(kFull, rc, s);
      const uint32_t rnext =
          (__shfl_down_sync(kFull, rw[0], 1) >> next_shift) & 0xffu;
      // the lane's diagonals t (k = k0 + t) with j == 0 (tlo) and j == m
      // (tm; none in a pad slot)
      const int tlo = W - i - k0;
      int tm = tlo + m;
      tm = tm < vl ? tm : -1;
      int up_last = __shfl_down_sync(kFull, cell[0], 1);
      if (lane == 31) up_last = upx;
      if (band_end) up_last = kNeg;
      // the byte compares, 5 where the window matches q[i - 1], else 0
      uint32_t eq[kWords];
#pragma unroll
      for (int x = 0; x < kWords; ++x)
        eq[x] = __vcmpeq4(rw[x], q4) & 0x05050505u;
      // pass 1: each candidate v and, in its place, the lane's running max
      // of v + t (the in-lane prefix, a chain that runs while the shuffle
      // of up_last is in flight; only the last diagonal waits for it).
      // Cells outside 0 <= j <= m are not masked: those left of the matrix
      // hold values near NEG and those right of it feed no cell inside (a
      // cell reads its own column and the one before); the score reads
      // only cells inside
      int run = kNegInf;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        int up = t + 1 < C ? cell[t + 1] : up_last;
        if (kPadded) {
          if (t + 1 == vl) up = up_last;
        } else if (t == C - 2 && vl < C) {
          up = up_last;
        }
        // cell + (+3 on a match, -2 else), then the move from above
        const int dg = cell[t] + kMismatch
                       + (int)__byte_perm(eq[t >> 2], 0, 0x4440 + (t & 3));
        int v = __viaddmax_s32(up, kGap, dg);
        v = t == tlo ? 0 : v;
        if (kPadded ? t >= vl : t == C - 1 && vl < C) v = kNeg;  // pad
        run = __viaddmax_s32(v, t, run);
        cell[t] = run;
      }
      // column m's prefix: the running max at t = tm, picked by a select
      // tree on the bits of tm while the scan below is in flight
      int ptm;
      {
        int sel[C];
#pragma unroll
        for (int t = 0; t < C; ++t) sel[t] = cell[t];
#pragma unroll
        for (int bit = 1; bit < C; bit <<= 1)
#pragma unroll
          for (int t = 0; t + bit < C; t += 2 * bit)
            sel[t] = (tm & bit) ? sel[t + bit] : sel[t];
        ptm = sel[0];
      }
      // the max of v + k over the diagonals of the lanes before this one
      // (a shuffle from below the first lane returns the lane's own value,
      // which the max absorbs)
      int inc = run + k0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        inc = max(inc, __shfl_up_sync(kFull, inc, off));
      int carry = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) carry = kNegInf;
      if (kMulti) {
        const int par = i & 1;
        if (lane == 31) sh_tot[par][wl] = inc;  // the warp's total
        if (lane == 0) sh_first[par][wl] = cell[0] + k0;
        __syncthreads();
        // the warps before this one: one read a lane, one warp reduction
        const int wc = __reduce_max_sync(
            kFull, lane < wl ? sh_tot[par][lane] : kNegInf);
        carry = max(carry, wc);
        // the next warp's first cell of row i: the move from above of this
        // warp's last diagonal in row i + 1
        if (lane == 31 && wl + 1 < nw)
          upx = max(max(wc, inc), sh_first[par][wl + 1]) - kend;
      }
      // pass 2: the cells of row i, each from the carry and its own prefix
      // (no chain), and column m's
      const int cr = carry - k0;
#pragma unroll
      for (int t = 0; t < C; ++t) cell[t] = max(cr, cell[t]) - t;
      if ((unsigned)tm < (unsigned)C) best = max(best, max(cr, ptm) - tm);
      // the window of row i + 1: one byte in, from the next lane's window
      // or, in the last lane, from the chunk
#pragma unroll
      for (int x = 0; x + 1 < kWords; ++x)
        rw[x] = __funnelshift_r(rw[x], rw[x + 1], 8);
      rw[kWords - 1] = (rw[kWords - 1] >> 8)
                       | ((lane == 31 ? rlast : rnext) << (8 * ((C - 1) & 3)));
    }
    qc = qn;
    rc = rn;
  }
  // row n: its cells inside the band and the matrix (row 0's when n = 0,
  // none above 0)
  const int t0 = W - n - k0;
#pragma unroll
  for (int t = 0; t < C; ++t)
    if (t < vl && t >= t0 && t <= t0 + m) best = max(best, cell[t]);
  best = warp_max(best);
  if (!kMulti) {
    if (lane == 0) out[b] = best;
    return;
  }
  if (lane == 0) sh_best[wl] = best;
  __syncthreads();
  if (wl == 0) {
    best = warp_max(lane < nw ? sh_best[lane] : 0);
    if (lane == 0) out[b] = best;
  }
}

template <int C, bool kMulti, bool kPadded = false>
cudaError_t launch(const uint8_t* a, const uint8_t* bpad, const int32_t* nm,
                   int64_t B, int L, int W, int nw, int32_t* out,
                   cudaStream_t st) {
  banded_align_kernel<C, kMulti, kPadded><<<(unsigned)B, 32 * nw, 0, st>>>(
      a, bpad, nm, L, W, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide kernel (W > 16,384 or L >= 2^25). Row i's cells inside the
// matrix are the diagonals [lo, hi] = [W - i, W - i + m] within the band
// [0, KW): only those are computed, c = ceil((S - 1) / threads) a thread
// from lo, and every other cell is NEG (JAX masks them), so no cell drifts
// whatever L. Diagonal k reads its own cell of row i - 1 (the move along
// the diagonal) and diagonal k + 1's (the move from above; NEG past the
// band). Row i reads row i - 1 only on [lo, hi + 1], each cell of which
// row i - 1 wrote, but lo when it is column 0 (whose candidate is 0); so a
// ring of S = min(KW, m + 1) + 1 ints holds the row, diagonal k at k mod S
// (m taken at most L + W, past which the band ends every row first): in
// shared memory while S_max = min(KW, L + W + 1) + 1 ints fit kWideSmem,
// else in the pair's part of a device scratch. The gap chain is the
// inclusive prefix max of v + k less k: pass 1 takes a thread's running
// max of v + k, a five-step shuffle scan in the warp and the warps' maxima
// through shared memory give the max before it, and pass 2 computes each
// candidate again (from the old row: the cell after the thread's last was
// kept in pass 1) and writes the cells in place.
constexpr int kWideThreads = 1024;
constexpr int64_t kWideSmem = 200 * 1024;  // the ring in shared memory

// the ring's ints a pair at most (S_max)
__host__ __device__ inline int64_t wide_ints(int64_t L, int W) {
  return (2 * (int64_t)W < L + W + 1 ? 2 * (int64_t)W : L + W + 1) + 1;
}

__global__ void __launch_bounds__(kWideThreads)
    banded_align_wide_kernel(const uint8_t* __restrict__ a,
                             const uint8_t* __restrict__ bpad,
                             const int32_t* __restrict__ nm, int64_t L, int W,
                             int* scratch, int32_t* __restrict__ out) {
  extern __shared__ int band_sh[];
  __shared__ int warp_sh[32];
  const int KW = 2 * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  int* row = scratch ? scratch + b * wide_ints(L, W) : band_sh;
  const uint8_t* q = a + b * L;
  const uint8_t* r = bpad + b * (L + KW);
  const int64_t n = min((int64_t)nm[2 * b], L);
  const int64_t m = nm[2 * b + 1];
  const int S = (int)min((int64_t)KW, max((int64_t)0, min(m, L + W)) + 1) + 1;
  const int c = (S - 1 + blockDim.x - 1) / blockDim.x;
  // row 0: H[0][j] = 0 for 0 <= j <= m, diagonals [W, W + min(W, m + 1))
  const int64_t w0 = min((int64_t)W, m + 1);
  for (int s = tid; s < S; s += blockDim.x)
    row[s] = ((s - W) % S + S) % S < w0 ? 0 : kNeg;
  int best = 0;
  for (int64_t i = 1; i <= n; ++i) {
    const int lo = (int)max((int64_t)0, W - i);
    const int64_t hi64 = min((int64_t)KW - 1, W - i + m);
    if (hi64 < lo) break;  // the band has left the matrix: rows stay NEG
    const int hi = (int)hi64;
    const int k0 = (int)min((int64_t)hi + 1, lo + (int64_t)tid * c);
    const int k1 = min(k0 + c, hi + 1);
    __syncthreads();  // row i - 1 is in row
    const int qi = q[i - 1];
    // diagonal k's candidate from its own cell of row i - 1 and the next
    auto cand = [&](int k, int diag, int up) {
      if (i + k == W) return 0;  // column 0
      const int sub = qi == r[i - 1 + k] ? kMatch : kMismatch;
      return max(diag + sub, up + kGap);
    };
    int run = kNeg - 1;  // below every v + k
    int s0 = k0 % S;
    int nb = kNeg;  // diagonal k1's cell of row i - 1
    {
      int s = s0, up = row[s];
      for (int k = k0; k < k1; ++k) {
        const int diag = up;
        s = s + 1 == S ? 0 : s + 1;
        up = k + 1 < KW ? row[s] : kNeg;
        run = max(run, cand(k, diag, up) + k);
      }
      nb = up;
    }
    // the max of run over the threads before this one
    int sc = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, sc, off);
      if (lane >= off) sc = max(sc, o);
    }
    int carry = __shfl_up_sync(kFull, sc, 1);
    if (lane == 0) carry = kNeg - 1;
    if (lane == 31) warp_sh[warp] = sc;
    __syncthreads();  // every thread has read row; the warp maxima are in
    if (nwarps > 1)
      carry = max(carry, warp_max(lane < warp ? warp_sh[lane] : kNeg - 1));
    int s = s0, diag = row[s];
    for (int k = k0; k < k1; ++k) {
      const int sn = s + 1 == S ? 0 : s + 1;
      const int up = k + 1 < k1 ? row[sn] : nb;
      carry = max(carry, cand(k, diag, up) + k);
      diag = up;
      const int cell = carry - k;
      if (i + k - W == m || i == n) best = max(best, cell);
      row[s] = cell;
      s = sn;
    }
  }
  best = warp_max(best);
  __syncthreads();
  if (lane == 0) warp_sh[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_max(lane < nwarps ? warp_sh[lane] : 0);
    if (lane == 0) out[b] = v;
  }
}

bool wide_branch(int64_t L, int W) {
  return 2 * (int64_t)W > kMaxKW || L >= kMaxL;
}

}  // namespace

extern "C" {

// The launch shape at W: *nw warps a pair, *c diagonals a lane. Returns 0,
// or -1 when KW = 2W passes kMaxKW. One warp up to KW 256 (c 1..8); then
// ceil(KW / 256) warps (c 5..8) up to 8,192, ceil(KW / 512) warps of c 16
// up to 16,384 (all exact layouts), and 32 warps of c 32 (padded) past it.
int lt_banded_align_shape(int W, int* nw, int* c) {
  const int64_t KW = 2 * (int64_t)W;
  if (W < 1 || KW > kMaxKW) return -1;
  if (KW <= kOneWarpKW) {
    *nw = 1;
  } else if (KW <= 32 * kOneWarpKW) {
    *nw = (int)((KW + kOneWarpKW - 1) / kOneWarpKW);
  } else if (KW <= 64 * kOneWarpKW) {
    *nw = (int)((KW + 2 * kOneWarpKW - 1) / (2 * kOneWarpKW));
  } else {
    *nw = 32;
    *c = 32;
    return 0;
  }
  *c = (int)((KW + 32 * *nw - 1) / (32 * *nw));
  return 0;
}

// Scratch ints a launch of B pairs at (L, W) needs: 0 on the register
// design (W <= 16,384 and L < 2^25) and while the wide kernel's ring of
// min(2W, L + W + 1) + 1 ints fits its shared-memory budget (W <= 25,599
// or L <= 51,197 - W), else B times that.
int64_t lt_banded_align_scratch(int64_t B, int64_t L, int W) {
  if (B <= 0 || W < 1 || L < 1 || !wide_branch(L, W)) return 0;
  return wide_ints(L, W) * 4 > kWideSmem ? B * wide_ints(L, W) : 0;
}

// Launches a kernel on `stream`: a (B, L) and bpad (B, L + 2W) uint8 codes
// (the reference at column W), nm (B, 2) int32 true lengths; 1 <= W < 2^30,
// L >= 1; scratch holds lt_banded_align_scratch(B, L, W) ints (null when
// that is 0); out (B,) int32. W <= 16,384 with L < 2^25 takes the register
// design (cells left of the matrix, unmasked, stay far below every cell
// inside), anything else the wide kernel. Returns the cudaError_t of the
// launch.
int lt_banded_align(const uint8_t* a, const uint8_t* bpad, const int32_t* nm,
                    int64_t B, int64_t L, int W, int* scratch, int32_t* out,
                    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || W >= (1 << 30) || L < 1 || B > 0x7fffffff ||
      (lt_banded_align_scratch(B, L, W) > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide_branch(L, W)) {
    const size_t smem = scratch ? 0 : (size_t)wide_ints(L, W) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          banded_align_wide_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    const int64_t band = (wide_ints(L, W) - 1 + 31) / 32 * 32;
    const int threads = band < kWideThreads ? (int)band : kWideThreads;
    banded_align_wide_kernel<<<(unsigned)B, threads, smem, st>>>(
        a, bpad, nm, L, W, scratch, out);
    return (int)cudaGetLastError();
  }
  int nw = 0, c = 0;
  lt_banded_align_shape(W, &nw, &c);
  const int Li = (int)L;
  if (nw == 1) {
    switch (c) {
      // c 1: lanes past KW < 32 own no diagonal; the padded layout keeps
      // their windows (which feed the band's last lane) at k0 = lane
      case 1:
        return (int)launch<1, false, true>(a, bpad, nm, B, Li, W, 1, out, st);
      case 2: return (int)launch<2, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 3: return (int)launch<3, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 4: return (int)launch<4, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 5: return (int)launch<5, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 6: return (int)launch<6, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 7: return (int)launch<7, false>(a, bpad, nm, B, Li, W, 1, out, st);
      case 8: return (int)launch<8, false>(a, bpad, nm, B, Li, W, 1, out, st);
    }
  } else {
    switch (c) {
      case 5: return (int)launch<5, true>(a, bpad, nm, B, Li, W, nw, out, st);
      case 6: return (int)launch<6, true>(a, bpad, nm, B, Li, W, nw, out, st);
      case 7: return (int)launch<7, true>(a, bpad, nm, B, Li, W, nw, out, st);
      case 8: return (int)launch<8, true>(a, bpad, nm, B, Li, W, nw, out, st);
      case 16:
        return (int)launch<16, true>(a, bpad, nm, B, Li, W, nw, out, st);
      case 32:
        return (int)launch<32, true, true>(a, bpad, nm, B, Li, W, nw, out,
                                           st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
