// Padded seeding and anchor compaction of the multi-process path, for
// Hopper (sm_90a).
//
// Replaces three jitted XLA kernels of linear_tpu/ops/seeding.py:
//   K1  batch_seed_anchors (:210; _hash_scan_batch :74, _minimizer_xy_batch
//       :129, _probe_and_anchor :165): the exact rolling-hash scan;
//   K2  batch_seed_anchors_fast (:772; _closed_form_states :672), and the
//       same computation with an xval-shard mask in the shard_map bodies of
//       linear_tpu/parallel/mesh.py;
//   K3  _compact_anchors (:420): stable compaction of the kept anchors.
// The plain PyTorch versions beside them are linear_tpu_torch/ops/
// seeding.py: batch_seed_anchors_reference, batch_seed_anchors_fast_
// reference and compact_anchors_reference; the module docstring there
// states what is computed. Outputs are identical on every element: the
// (B, P, cap) anchors hold 0 where keep is 0, and K3's rows hold 0 past
// their kept anchors.
//
// What bounds them on the card: bytes. The (B, P, cap) grid is written
// once (9 bytes a slot; 256 rows of pad 8192 at cap 416 are 521 MB), and K3
// reads it back; the probe gathers two dir words per probed position from a
// 268 MB table and one 8-byte hs entry per bucket slot, far apart. The
// arithmetic per position (a 21-base window, nine 13-mer candidates, four
// YValue bases) is small.
//
// Design:
//   K1 has no serial roll (rolled by a thread a read, it reached 9 % of
//      its bound). The roll's state after any step depends on the last 21
//      appended bases only: the mask drops older bits of h, crh shifts
//      them off, and x telescopes to a window sum plus a per-read bias.
//      What no window holds is per read: k0 (hashInit's first N-free
//      window), the init window's share of crh while k < 41, and the x
//      bias. A pre-pass, one warp a read, finds k0 by ballot and writes
//      those three to a (3, B) scratch; every call position then has a
//      closed form over a few dozen bases, exact with N bases
//      (seeding.py:_scan_states_closed, held against JAX's scan).
//   K1 and K2: one block per (read, tile of kTile positions). The
//      first kTile + 1 threads each compute one position (the tile's
//      positions and the one before them, for the dedup): xval, yval and
//      strand from the pre-pass and the closed form (K1) or from K2's
//      closed form (exact for N-free reads), then the bucket bounds.
//      Then all threads walk the tile's kTile * cap slots in flat order,
//      so that the big (B, P, cap) writes are coalesced, and each probes
//      one hs entry.
//   K3: one block per row. A block-wide exclusive scan of the keep flags,
//      kItems consecutive flags a thread, carried across tiles, gives each
//      kept anchor its output slot; the rest of the row is zeroed. Stable
//      by construction.
// All uint64 arithmetic wraps as in the JAX kernels; right shifts are on
// unsigned values.
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 21;
constexpr int kWeight = 13;
constexpr int kNOff = kSpan - kWeight + 1;  // 9 minimizer candidates
constexpr uint32_t kMaskW = (1u << (2 * kWeight)) - 1;
constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kFlagStrand = 1ull << 61;
constexpr uint64_t kMaskH = (1ull << (2 * kSpan - 2)) - 1;

constexpr int kInitThreads = 128;  // four reads a pre-pass block
constexpr int kThreads = 256;
constexpr int kTile = 64;  // call positions a probe block
constexpr int kCThreads = 256;
constexpr int kItems = 8;  // keep flags a thread per K3 tile

// row[i] with i clamped into the row, as JAX's clipped gathers read it
__device__ __forceinline__ uint64_t clamped(const uint8_t* __restrict__ row,
                                            int64_t L, int64_t i) {
  i = i < 0 ? 0 : (i > L - 1 ? L - 1 : i);
  return row[i];
}

// K1's pre-pass: one warp a read finds k0, the first N-free 21-window (0
// if none), 32 positions a round by ballot, and lane 0 writes the per-read
// state that no call position rebuilds from its own window: k0, T (bits
// 2..41 of hashInit's crh, the init window's share of crh while k < 41)
// and the x bias 2 * sum(init) - 63 - 2 * sum(b[21 .. 41)).
__global__ void __launch_bounds__(kInitThreads)
scan_init_kernel(const uint8_t* __restrict__ seqs, int64_t B, int64_t L,
                 int64_t* __restrict__ pre) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * (kInitThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves
  const uint8_t* row = seqs + b * L;
  // 32 positions a round: the N-free run ending at each (positions past
  // the row count as N), from the ballot of N positions and the run
  // carried from the round before; a window [j, j + n_win) is N-free when
  // the run ending at its last base reaches n_win
  const int n_win = L < kSpan ? (int)L : kSpan;
  int64_t k0 = 0;
  int carry = 0;
  for (int64_t base = 0; base < L; base += 32) {
    const int64_t p = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, p >= L || row[p] == 4);
    const unsigned below = m & (0xffffffffu >> (31 - lane));
    const int run = below ? lane - (31 - __clz((int)below)) : lane + 1 + carry;
    const unsigned ok = __ballot_sync(0xffffffffu, run >= n_win);
    if (ok) {
      k0 = base + (__ffs((int)ok) - 1) - (n_win - 1);
      break;
    }
    carry = __shfl_sync(0xffffffffu, run, 31);
  }
  if (lane == 0) {
    uint64_t crh0 = 0;
    int64_t sum = 0;
    for (int t = 0; t < kSpan - 1; t++) {
      const uint64_t v = clamped(row, L, k0 + t);
      crh0 += (3ull - v) << (2 * (t + 1));
      sum += 2 * (int64_t)v - 2 * (int64_t)clamped(row, L, kSpan + t);
    }
    pre[b] = k0;
    pre[B + b] = (int64_t)((crh0 >> 2) & kMaskH);
    pre[2 * B + b] = sum - 3 * (kSpan - 1) - 3;
  }
}

// K1's states at call k >= kSpan from the pre-pass, equal to the serial
// roll's (seeding.py:_scan_states_closed states the closed form). u_m is
// the value the roll appends at step m, b[m + 20], and b[k0 + m - 1] for
// m <= 20 (the init window).
__device__ __forceinline__ void scan_closed_form(
    const uint8_t* __restrict__ row, int64_t L, int64_t k, int64_t k0,
    uint64_t T, int64_t bias, uint64_t& h, uint64_t& crh, int64_t& x) {
  uint64_t hs = 0, cs = 0;
  int64_t wsum = 0;
  uint64_t uk;
  if (k >= 2 * kSpan - 1) {
    // the init window is shifted out: u_{k-20+t} = b[k+t], the x window
    for (int t = 0; t < kSpan - 1; t++) {
      const uint64_t u = clamped(row, L, k + t);
      wsum += (int64_t)u;
      hs += u << (2 * (kSpan - 1 - t));
      cs += ((3ull - u) & 3ull) << (2 * t);
    }
    uk = clamped(row, L, k + kSpan - 1);
    wsum += (int64_t)uk;
  } else {
    for (int t = 0; t < kSpan - 1; t++) {  // u_{k-20+t}, weight 4^(20-t)
      const int64_t m = k - (kSpan - 1) + t;
      const uint64_t u = m <= kSpan - 1 ? clamped(row, L, k0 + m - 1)
                                        : clamped(row, L, m + kSpan - 1);
      hs += u << (2 * (kSpan - 1 - t));
      if (m >= kSpan) cs += ((3ull - u) & 3ull) << (2 * t);
    }
    uk = clamped(row, L, k + kSpan - 1);
    for (int t = 0; t < kSpan; t++) wsum += (int64_t)clamped(row, L, k + t);
    cs += T >> (2 * (k - kSpan));
  }
  h = uk + (hs & ((1ull << (2 * kSpan)) - 1));
  crh = ((3ull - uk) << (2 * kSpan - 2)) + cs;
  x = bias + 2 * wsum;
}

// hashNextX at call k from its states: xval, yval and strand (1: reverse)
__device__ __forceinline__ void minimizer_xy(const uint8_t* __restrict__ row,
                                             int64_t L, int64_t k, uint64_t h,
                                             uint64_t crh, int64_t x,
                                             int& xval, int& yval,
                                             int& strand) {
  const bool fwd = x > 0;
  const uint64_t v = fwd ? h : crh;
  uint32_t best = kMaskW + 1;
  int tsel = 0;
  for (int idx = 0; idx < kNOff; idx++) {
    const uint32_t c = (uint32_t)(v >> (2 * (kNOff - 1 - idx))) & kMaskW;
    if (c < best) {
      best = c;
      tsel = idx;
    }
  }
  int y = 0;
  for (int i = 0; i < 4; i++) {
    int64_t val;
    if (fwd) {
      const int64_t pf = k + tsel + kWeight + i;
      val = pf < L ? (int64_t)clamped(row, L, pf) : 0;
    } else {
      const int64_t pr = k + kSpan - tsel - kWeight - 1 - i;
      val = 3 - (pr >= 0 ? (int64_t)clamped(row, L, pr) : 0);
    }
    y = (y << 2) + (val >= 0 && val <= 3 ? (int)val : 0);
  }
  xval = (int)best;
  yval = y;
  strand = fwd ? 0 : 1;
}

// the closed-form states of call k (exact for N-free reads): the window
// b[k .. k+21), or for k < 2*kSpan-1 the init window's tail then the
// bases appended from 2*kSpan-1; x from the plain window and the bias
__device__ __forceinline__ void closed_form(const uint8_t* __restrict__ row,
                                            int64_t L, int64_t k, int bias,
                                            uint64_t& h, uint64_t& crh,
                                            int64_t& x) {
  h = 0;
  crh = 0;
  int64_t wsum = 0;
  const bool mixed = k < 2 * kSpan - 1;
  int64_t n_app = k - kSpan + 1;
  n_app = n_app < kSpan ? n_app : kSpan;
  const int64_t n_init = kSpan - n_app;
  for (int t = 0; t < kSpan; t++) {
    const uint64_t b = clamped(row, L, k + t);
    wsum += (int64_t)b;
    const uint64_t w =
        !mixed ? b
               : clamped(row, L, t < n_init ? kSpan - 1 - n_init + t
                                            : 2 * kSpan - 1 + t - n_init);
    h = (h << 2) + w;
    crh += (3ull - w) << (2 * t);
  }
  x = 2 * wsum - 3 * kSpan + bias;
}

// K1 (kScan, states from the pre-pass and the closed form above) and K2
// (closed_form): the tile's positions, then its slots
template <bool kScan>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint8_t* __restrict__ seqs, int64_t L,
             const int64_t* __restrict__ lens,
             const int64_t* __restrict__ pre, int first, int alpha,
             int64_t P, const int32_t* __restrict__ dir, int64_t n_dir,
             const int64_t* __restrict__ hs, int64_t n_hs, int cap,
             int64_t x_base, int64_t x_hi, int64_t* __restrict__ anc,
             uint8_t* __restrict__ keep) {
  __shared__ int s_x[kTile + 1];
  __shared__ int s_y[kTile];
  __shared__ int s_strand[kTile];
  __shared__ int s_cnt[kTile];  // probed slots, 0 when not processed
  __shared__ int64_t s_lo[kTile];
  __shared__ int s_bias;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const uint8_t* row = seqs + b * L;
  const int64_t ln = lens[b];
  const int64_t lim = ln - kSpan;

  if (!kScan && tid == 0) {
    // 2 * (sum b[0 .. kSpan-1) - sum b[kSpan .. 2*kSpan-1)), bases past
    // the row count 0
    int s = 0;
    for (int i = 0; i < kSpan - 1 && i < L; i++) s += row[i];
    for (int i = kSpan; i < 2 * kSpan - 1 && i < L; i++) s -= row[i];
    s_bias = 2 * s;
  }
  if (!kScan) __syncthreads();

  if (tid <= kTile) {
    // thread t: position p0 - 1 + t (t = 0: the dedup's previous position)
    const int64_t p = p0 - 1 + tid;
    const int64_t k = first + (int64_t)alpha * p;
    int xval = 0, yval = 0, strand = 0;
    // a position out of range is never probed, and the one before an
    // in-range position is in range itself (or p = -1: xval 0)
    const bool in_range = p >= 0 && p < P && k < lim;
    if (in_range) {
      uint64_t h, crh;
      int64_t x;
      if (kScan) {
        const int64_t nb = gridDim.y;
        scan_closed_form(row, L, k, pre[b], (uint64_t)pre[nb + b],
                         pre[2 * nb + b], h, crh, x);
      } else {
        closed_form(row, L, k, s_bias, h, crh, x);
      }
      minimizer_xy(row, L, k, h, crh, x, xval, yval, strand);
    }
    s_x[tid] = xval;
    if (tid > 0) {
      const int j = tid - 1;
      s_y[j] = yval;
      s_strand[j] = strand;
      s_cnt[j] = 0;
      s_lo[j] = 0;
      if (in_range) {
        // mark for the bucket probe below, after every s_x is written
        s_cnt[j] = -1;
      }
    }
  }
  __syncthreads();
  if (tid >= 1 && tid <= kTile && s_cnt[tid - 1] < 0) {
    const int j = tid - 1;
    const int64_t xv = s_x[tid];
    int cnt = 0;
    if (xv != s_x[tid - 1] && xv >= x_base && xv < x_hi) {
      int64_t xc = xv - x_base;
      xc = xc < 0 ? 0 : (xc > n_dir - 2 ? n_dir - 2 : xc);
      const int64_t lo = dir[xc];
      const int64_t d = (int64_t)dir[xc + 1] - lo;
      cnt = (int)(d < cap ? d : cap);
      s_lo[j] = lo;
    }
    s_cnt[j] = cnt;
  }
  __syncthreads();

  int64_t n_slots = P - p0 < kTile ? (P - p0) : kTile;
  n_slots *= cap;
  const int64_t base = (b * P + p0) * cap;
  for (int64_t s = tid; s < n_slots; s += kThreads) {
    const int j = (int)(s / cap);
    const int e = (int)(s - (int64_t)j * cap);
    bool kp = false;
    uint64_t a = 0;
    if (e < s_cnt[j]) {
      int64_t ei = s_lo[j] + e;
      ei = ei < 0 ? 0 : (ei > n_hs - 1 ? n_hs - 1 : ei);
      const uint64_t ent = (uint64_t)hs[ei];
      const uint64_t ent_y = ent & kMaskY;
      const uint64_t val = ent_y ^ (uint64_t)s_y[j];
      kp = val == 0 || val < ((val & (~val + 1)) << 2);
      if (kp) {
        const int64_t k = first + (int64_t)alpha * (p0 + j);
        const bool same = (int)((ent >> 61) & 1) == s_strand[j];
        const uint64_t cordy = (uint64_t)(same ? k : ln - 1 - k);
        a = ent - (cordy << 20) + cordy - ent_y;
        a = same ? (a & ~kFlagStrand) : (a | kFlagStrand);
      }
    }
    anc[base + s] = (int64_t)a;
    keep[base + s] = kp ? 1 : 0;
  }
}

// K3: row b's kept anchors in flat order into out[b, :m_out], zeros after
// them, and the kept count
__global__ void __launch_bounds__(kCThreads)
compact_kernel(const int64_t* __restrict__ anc,
               const uint8_t* __restrict__ keep, int64_t n, int m_out,
               int64_t* __restrict__ out, int32_t* __restrict__ count) {
  using BlockScan = cub::BlockScan<int, kCThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const uint8_t* kr = keep + b * n;
  const int64_t* ar = anc + b * n;
  int64_t* orow = out + b * (int64_t)m_out;
  int64_t carry = 0;  // block-uniform: kept flags of earlier tiles
  for (int64_t t0 = 0; t0 < n; t0 += (int64_t)kCThreads * kItems) {
    const int64_t i0 = t0 + (int64_t)tid * kItems;
    int flag[kItems], dst[kItems];
    for (int i = 0; i < kItems; i++)
      flag[i] = i0 + i < n ? (kr[i0 + i] != 0) : 0;
    int total;
    BlockScan(scan_tmp).ExclusiveSum(flag, dst, total);
    for (int i = 0; i < kItems; i++) {
      const int64_t d = carry + dst[i];
      if (flag[i] && d < m_out) orow[d] = ar[i0 + i];
    }
    carry += total;
    __syncthreads();  // scan_tmp is reused by the next tile
  }
  for (int64_t s = carry + tid; s < m_out; s += kCThreads) orow[s] = 0;
  if (tid == 0) count[b] = (int32_t)carry;
}

}  // namespace

extern "C" {

// K1 (scan = 1) or K2 (scan = 0) on `stream`: seqs (B, L) uint8 codes 0..4,
// lens (B,) int64, dir (n_dir,) int32, hs (n_hs,) int64 -> anc (B, P, cap)
// int64 and keep (B, P, cap) uint8. K1 needs the (3, B) int64 scratch pre
// for its pre-pass; K2 probes the xval range [x_base, x_hi) with dir
// rebased to x_base. Returns the cudaError_t of the launches (0: launched).
int lt_seed_anchors(const uint8_t* seqs, int64_t B, int64_t L,
                    const int64_t* lens, int scan, int first, int alpha,
                    int64_t P, const int32_t* dir, int64_t n_dir,
                    const int64_t* hs, int64_t n_hs, int cap, int64_t x_base,
                    int64_t x_hi, int64_t* pre, int64_t* anc, uint8_t* keep,
                    void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((P + kTile - 1) / kTile), (unsigned)B);
  if (scan) {
    constexpr int kReads = kInitThreads / 32;
    scan_init_kernel<<<(unsigned)((B + kReads - 1) / kReads), kInitThreads, 0,
                       st>>>(seqs, B, L, pre);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    probe_kernel<true><<<grid, kThreads, 0, st>>>(
        seqs, L, lens, pre, first, alpha, P, dir, n_dir, hs, n_hs, cap,
        x_base, x_hi, anc, keep);
  } else {
    probe_kernel<false><<<grid, kThreads, 0, st>>>(
        seqs, L, lens, nullptr, first, alpha, P, dir, n_dir, hs, n_hs, cap,
        x_base, x_hi, anc, keep);
  }
  return (int)cudaGetLastError();
}

// K3 on `stream`: anc (B, n) int64, keep (B, n) uint8 -> out (B, m_out)
// int64, count (B,) int32.
int lt_compact_anchors(const int64_t* anc, const uint8_t* keep, int64_t B,
                       int64_t n, int m_out, int64_t* out, int32_t* count,
                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  compact_kernel<<<(unsigned)B, kCThreads, 0, (cudaStream_t)stream>>>(
      anc, keep, n, m_out, out, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
