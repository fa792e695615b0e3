// Chaining DP (getBestChains) for Hopper (sm_90a): the windowed DP, and
// below it the full DP, which shares its score helpers.
//
// The windowed kernel replaces
// linear_tpu/ops/chain_dp.py:batch_chain_dp_windowed, which the JAX package
// runs as one jitted XLA program: a (B, N, W) gather of banded edge
// scores, then a lax.scan over the N anchors with a (B, W) ring of the last
// W DP scores. The plain PyTorch version beside it is
// linear_tpu_torch/ops/chain_dp.py:chain_dp_windowed_reference, a straight
// translation of the JAX function. The spec is getBestChains
// (cluster_util.cpp:53) with getApxChainScore (:387, score_type 0) or
// getApxChainScore0 (:337, score_type 1) over anchors sorted descending by
// anchor-x, looking back at most W anchors.
//
// What bounds it on the card: the DP is serial in the anchor index. Step i
// needs the scores of the W anchors before it, so a read's n steps run one
// after another; the edge scores (integer arithmetic with truncating
// divisions) do not depend on the DP. The bytes are small: n anchors a
// read, three int32 tables out.
//
// Design (a warp a read that computes both edge scores of each lane, 64-bit
// divisions included, inside every serial step and reduces three values,
// two of them 64-bit, with 25 shuffles, measured five times slower). A
// block a read, eight warps:
//   - the row's anchor-x and y go once into a table (int32);
//   - the edges leave the dependence chain: for a tile of 64 steps, every
//     (i, d) edge is scored in branch-free 32-bit arithmetic and stored as
//     a byte (0 when not eligible or not positive; a positive
//     getApxChainScore is 100 - score_dy - score_derr with both terms >= 0,
//     at most 100, and getApxChainScore0 at most 95). Warps 1-7 score tile
//     t + 1 while warp 0 scans tile t, four independent entries a thread
//     at a time, and skip the scores of 128 entries that are all
//     ineligible;
//   - a serial step forms key = total << bits | (d - 1) for its lookbacks
//     and takes one __reduce_max_sync: the largest total and, on a tie,
//     the largest d, which is the smallest j, as JAX's argmax picks it. The
//     key holds 32 bits while 100 n < 2^(32 - bits);
//   - for W <= 128 the ring of scores lives in registers (scan_tile_reg),
//     the lookbacks are unrolled and predicated, the next step's edge
//     bytes load before the reduction, and nothing else rides on the
//     chain: the chain lengths come after the scan from p2, by pointer
//     jumping over the whole block (lengths_pass). The scan is one warp's
//     dependent instruction stream, so its instruction count is its time:
//     a runtime lookback loop with branches and the ring in shared memory
//     measured several times slower on the H100.
// Any W >= 1, and rows whose key passes 32 bits: scan_tile_any loops over a
// lane's ceil(W / 32) lookbacks with the ring (int64) in shared memory,
// takes the largest total over 64 bits, then the largest d of its lanes;
// every lane writes the step's ring slot, so no lane reads another's write
// and no barrier is needed. The ring is the power of two above min(W, N);
// ring, table and tiles fall back to a device scratch past their
// shared-memory budgets (win_layout). The overflow flag (a dx-depth
// lookback could reach past W) is an independent pass. Padded columns
// j >= n get p2 = -1, score 0, length 1, as in the JAX function.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kMaskX30 = (1ull << 30) - 1;
constexpr uint64_t kValueMaskDstr = ((1ull << 60) - 1) | (1ull << 61);
constexpr int64_t kNeg32 = -(1ll << 31) + 1;  // the full DP's sentinel
constexpr int64_t kMaxFullSmem = 232448;  // shared memory a block may take

// getAnchorX (src/cords.cpp:463): the 64-bit add may pass bit 63; it wraps
// as uint64 and the mask clears the high bits
__device__ __forceinline__ int64_t anchor_x(uint64_t a) {
  const uint64_t v = (a + ((a & kMaskY) << 20) - (1ull << 40)) & kValueMaskDstr;
  return (int64_t)((v >> 20) & kMaskX30);
}
__device__ __forceinline__ int64_t anchor_y(uint64_t a) {
  return (int64_t)(a & kMaskY);
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// getApxChainScore (cluster_util.cpp:387, score type 0) or getApxChainScore0
// (:337, the toggle(1) variant) of edge (anchor j = (y1, ax1), anchor i =
// (y2, ax2)), in 32 bits and without branches: every term is computed and
// the C++ branches are selects. Anchor-x has 30 bits and y 20, so dy, dx
// and da fit an int32. derr >= 100 is da >= denom; below that the
// truncating derr = 100 da / denom < 100 comes from a float estimate
// (relative error ~2^-22, so off by at most one) corrected by the exact
// 64-bit remainder.
__device__ __forceinline__ int32_t edge_score32(int kScoreType, int32_t y1,
                                                int32_t ax1, int32_t y2,
                                                int32_t ax2) {
  const int32_t dy = y1 - y2;
  const int32_t dx = ax1 - ax2;
  const int32_t da = abs(dx - dy);
  const int32_t denom = max(max(abs(dy), abs(dx)), 50);
  const bool over = da >= denom;  // 100 * da / denom >= 100
  int32_t res;
  if (kScoreType == 1) {
    res = da < 30 ? 100 - dy : 100 - dy - da;
  } else {
    const int64_t num = 100ll * (over ? 0 : da);
    int32_t derr = (int32_t)((float)num * __frcp_rn((float)denom));
    const int64_t r = num - (int64_t)derr * denom;
    derr += (r >= denom) - (r < 0);
    const int32_t dy15 = dy / 15;
    const int32_t dsq = min(max(dy15, 0), 9999);
    const int32_t score_dy =
        dy15 < 150 ? dy15 / 5 : (dy15 < 10000 ? dsq * dsq / 200 + 20 : 10000);
    const int32_t score_derr =
        derr < 5 ? 4 * derr
                 : (derr < 10 ? 6 * derr - 10 : derr * derr - 5 * derr);
    res = da < 10 ? 100 - score_dy : 100 - score_dy - score_derr;
  }
  res = over ? -1000 : res;
  return dy < (kScoreType == 0 ? 10 : 5) ? -10000 : res;
}

// Where the windowed kernel keeps a read's ring, row table and edge tiles:
// in shared memory within these budgets, else in the device scratch that
// the wrapper allocates (scratch bytes a read, through the same pointers).
constexpr int kDpThreads = 256;  // a block a read: warp 0 scans, 1-7 edges
constexpr int64_t kDpRingSmem = 49152;
constexpr int64_t kDpRowSmem = 65536;
constexpr int64_t kDpEdgeSmem = 32768;

struct WinLayout {
  int we;   // lookbacks the launch needs: min(W, N)
  int ring; // ring slots: the power of two above we (a step's slot is
            // never one it reads)
  int ts;   // steps an edge tile (two tiles: one scored, one scanned)
  bool ring_g, row_g, edge_g;  // in the scratch
  int64_t smem, scratch;       // bytes a block
};

inline int64_t align8(int64_t v) { return (v + 7) & ~(int64_t)7; }

inline WinLayout win_layout(int64_t N, int W) {
  WinLayout L;
  L.we = (int)((int64_t)W < N ? W : N);
  L.ring = 2;
  while (L.ring < L.we + 1) L.ring <<= 1;
  L.ts = 16384 / L.we;
  L.ts = L.ts < 1 ? 1 : (L.ts > 64 ? 64 : L.ts);
  const int64_t ring_b = 8 * (int64_t)L.ring;
  const int64_t row_b = 8 * N;
  const int64_t edge_b = align8(2 * (int64_t)L.ts * L.we);
  L.ring_g = ring_b > kDpRingSmem;
  L.row_g = row_b > kDpRowSmem;
  L.edge_g = edge_b > kDpEdgeSmem;
  L.smem = (L.ring_g ? 0 : ring_b) + (L.row_g ? 0 : row_b) +
           (L.edge_g ? 0 : edge_b);
  L.scratch = (L.ring_g ? ring_b : 0) + (L.row_g ? row_b : 0) +
              (L.edge_g ? edge_b : 0);
  return L;
}

// one edge tile: the uint8 scores of steps i0 .. i0 + steps - 1 against
// lookbacks d = 1 .. wr, row-major, 0 where the edge is not eligible or its
// score is not positive (a positive score is at most 100). Thread `start`
// of `stride` (both multiples of 32 away from lane 0 of their warp) takes
// the flat entries start, start + stride, ..., kEdgeIlp at a time: their
// loads first, then their scores, then the stores, so that independent
// entries overlap. A warp whose kEdgeIlp * 32 entries are all ineligible
// (lookbacks past depth and dx_depth, most of them on sorted rows) skips
// the scores. Eligibility in int32: j >= i - depth is d <= depth, and
// anchor-x differences lie within +-2^30 (depth and dx_depth clamped by
// the caller).
constexpr int kEdgeIlp = 4;

template <int kScoreType>
__device__ __forceinline__ void edge_tile(const int32_t* __restrict__ ax,
                                          const int32_t* __restrict__ ay,
                                          int i0, int steps, int wr,
                                          int depth, int dxd,
                                          uint8_t* __restrict__ eb, int start,
                                          int stride, int lane) {
  const int total = steps * wr;
  const int step = kEdgeIlp * stride;
  const int ds = step / wr, dd = step - ds * wr;
  int s[kEdgeIlp], d[kEdgeIlp];
#pragma unroll
  for (int u = 0; u < kEdgeIlp; ++u) {
    const int f = start + u * stride;
    s[u] = f / wr;
    d[u] = f - s[u] * wr + 1;
  }
  // a warp-uniform loop: lane 0's entry decides the trip count
  for (int fb = start - lane; fb < total; fb += step) {
    const int f0 = fb + lane;
    int32_t axi[kEdgeIlp], ayi[kEdgeIlp], axj[kEdgeIlp], ayj[kEdgeIlp];
    bool elig[kEdgeIlp];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kEdgeIlp; ++u) {
      const bool live = f0 + u * stride < total;
      const int i = i0 + (live ? s[u] : 0);
      const int j = i - d[u];
      const int jc = j < 0 ? 0 : j;
      axi[u] = ax[i];
      ayi[u] = ay[i];
      axj[u] = ax[jc];
      ayj[u] = ay[jc];
      elig[u] = live && j >= 0 && (d[u] <= depth || axj[u] - axi[u] < dxd);
      any |= elig[u];
    }
    uint8_t e[kEdgeIlp];
    if (__any_sync(0xffffffffu, any)) {
#pragma unroll
      for (int u = 0; u < kEdgeIlp; ++u) {
        const int32_t sc =
            edge_score32(kScoreType, ayj[u], axj[u], ayi[u], axi[u]);
        e[u] = (uint8_t)(elig[u] && sc > 0 ? sc : 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kEdgeIlp; ++u) e[u] = 0;
    }
#pragma unroll
    for (int u = 0; u < kEdgeIlp; ++u) {
      if (f0 + u * stride < total) eb[f0 + u * stride] = e[u];
      s[u] += ds;
      d[u] += dd;
      if (d[u] > wr) {
        d[u] -= wr;
        ++s[u];
      }
    }
  }
}

// A tile's serial steps with the ring in registers (rows whose key fits 32
// bits, lookbacks wr <= 32 K): lane l holds in rs[h] the score of j = i - d,
// d = l + 1 + 32 h. The lookbacks are predicated, not branched, the next
// step's edge bytes are loaded before this step's reduction, and after a
// step every lane shifts its ring by one lookback (shuffles that wait only
// for lane 0's new slot). The chain lengths are not carried: lengths_pass
// derives them from p2 afterwards. The scan is one warp's dependent
// instruction stream, so its length in instructions is its time.
template <int K>
__device__ __forceinline__ void scan_tile_reg(const uint8_t* eb, int i0,
                                              int steps, int wr, int bits,
                                              uint32_t (&rs)[K], int lane,
                                              int32_t* p2r, int32_t* scr) {
  const uint32_t dmask = (1u << bits) - 1;
  uint32_t e[K];
#pragma unroll
  for (int h = 0; h < K; ++h) {
    const int d = lane + 1 + 32 * h;
    e[h] = d <= wr ? eb[d - 1] : 0u;
  }
  for (int s = 0; s < steps; ++s) {
    uint32_t key = 0;
#pragma unroll
    for (int h = 0; h < K; ++h) {
      const int d = lane + 1 + 32 * h;
      const uint32_t k =
          e[h] ? (((e[h] + rs[h]) << bits) | (uint32_t)(d - 1)) : 0u;
      key = k > key ? k : key;
    }
    if (s + 1 < steps) {
      const uint8_t* en = eb + (s + 1) * wr;
#pragma unroll
      for (int h = 0; h < K; ++h) {
        const int d = lane + 1 + 32 * h;
        e[h] = d <= wr ? en[d - 1] : 0u;
      }
    }
    key = __reduce_max_sync(0xffffffffu, key);
    const uint32_t tot = key >> bits;  // 0: no eligible edge
#pragma unroll
    for (int h = K - 1; h >= 0; --h) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, rs[h], 1);
      const uint32_t in =
          h ? __shfl_sync(0xffffffffu, rs[h ? h - 1 : 0], 31) : tot;
      rs[h] = lane ? up : in;
    }
    if (lane == (s & 31)) {  // the lanes take the output stores in turn
      const int i = i0 + s;
      p2r[i] = key ? i - (int)(key & dmask) - 1 : -1;
      scr[i] = (int32_t)tot;
    }
  }
}

// A tile's serial steps for any row: a lane loops over its lookbacks, the
// ring (int64 scores) in shared memory or the scratch; a 32-bit key where
// it fits, else the largest total over 64 bits, then the largest d of its
// lanes. Every lane writes the step's ring slot (the result is
// warp-uniform), so no lane reads another's write and no barrier is needed.
__device__ __forceinline__ void scan_tile_any(const uint8_t* eb, int i0,
                                              int steps, int wr, int bits,
                                              bool narrow, int64_t* ring_s,
                                              int ring, int lane,
                                              int32_t* p2r, int32_t* scr) {
  for (int s = 0; s < steps; ++s) {
    const int i = i0 + s;
    const uint8_t* er = eb + (int64_t)s * wr;
    int64_t tot;
    int bd;
    if (narrow) {
      uint32_t key = 0;
      for (int d = lane + 1; d <= wr; d += 32) {
        const uint32_t e = er[d - 1];
        const uint32_t k =
            e ? (((e + (uint32_t)ring_s[(i - d) & (ring - 1)]) << bits) |
                 (uint32_t)(d - 1))
              : 0u;
        key = k > key ? k : key;
      }
      key = __reduce_max_sync(0xffffffffu, key);
      tot = key >> bits;
      bd = (int)(key & ((1u << bits) - 1)) + 1;
    } else {
      int64_t best = 0;
      int bl = 0;
      for (int d = lane + 1; d <= wr; d += 32) {
        const int e = er[d - 1];
        const int64_t v = e ? e + ring_s[(i - d) & (ring - 1)] : 0;
        if (v > 0 && v >= best) {
          best = v;
          bl = d;
        }
      }
      tot = best;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tot = imax(tot, __shfl_xor_sync(0xffffffffu, tot, off));
      bd = (int)__reduce_max_sync(0xffffffffu,
                                  (unsigned)(best == tot ? bl : 0));
    }
    ring_s[i & (ring - 1)] = tot;  // 0 when no edge
    if (lane == (s & 31)) {
      p2r[i] = tot > 0 ? i - bd : -1;
      scr[i] = (int32_t)tot;
    }
  }
}

// The chain lengths from p2 (length[i] = length[p2[i]] + 1, 1 at a root)
// by pointer jumping over the whole block: a word per column packs the
// hops counted so far and the column they lead to, updated in place with
// one 64-bit load and store, so a reader always sees a consistent pair;
// rounds r = 1, 2, 4, ... up to the first r >= n (ceil(log2 n) + 1 of them)
// reach every root, for any n below 2^31. `link` holds n words.
__device__ __forceinline__ void lengths_pass(const int32_t* p2r, int n,
                                             uint64_t* link, int32_t* lnr) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = p2r[i];
    link[i] = p < 0 ? 0xffffffffull : ((uint64_t)1 << 32) | (uint32_t)p;
  }
  __syncthreads();
  for (unsigned r = 1;; r <<= 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint64_t w = link[i];
      const uint32_t to = (uint32_t)w;
      if (to != 0xffffffffu) {
        const uint64_t v = link[to];
        link[i] = ((w >> 32) + (v >> 32)) << 32 | (uint32_t)v;
      }
    }
    __syncthreads();
    if (r >= (unsigned)n) break;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    lnr[i] = (int32_t)(link[i] >> 32) + 1;
}

// K: the register ring's lookbacks a lane (1, 2 or 4: W <= 32, 64, 128), or
// 0 for the launches that take scan_tile_any on every row
template <int kScoreType, int K>
__global__ void __launch_bounds__(kDpThreads)
    chain_dp_kernel(const uint64_t* __restrict__ anchors,
                    const int32_t* __restrict__ n_anchors, int64_t N, int W,
                    int we, int ring, int ts, int ring_g, int row_g,
                    int edge_g, int64_t scratch_b, int64_t depth,
                    int64_t dx_depth, uint8_t* scratch, int32_t* p2,
                    int32_t* score, int32_t* length, uint8_t* overflow) {
  extern __shared__ int64_t dp_smem[];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the ring, the row table and the edge tiles, each in shared memory or
  // in this read's part of the scratch (win_layout)
  uint8_t* sp = reinterpret_cast<uint8_t*>(dp_smem);
  uint8_t* gp = scratch + b * scratch_b;
  int64_t* ring_s = reinterpret_cast<int64_t*>(ring_g ? gp : sp);
  (ring_g ? gp : sp) += 8 * (int64_t)ring;
  int32_t* ax = reinterpret_cast<int32_t*>(row_g ? gp : sp);
  int32_t* ay = ax + N;
  (row_g ? gp : sp) += 8 * N;
  uint8_t* ebuf = edge_g ? gp : sp;

  const uint64_t* a = anchors + b * N;
  int64_t n = n_anchors[b];
  n = n < 0 ? 0 : (n > N ? N : n);
  int32_t* p2r = p2 + b * N;
  int32_t* scr = score + b * N;
  int32_t* lnr = length + b * N;
  for (int64_t k = tid; k < n; k += kDpThreads) {
    const uint64_t v = a[k];
    ax[k] = (int32_t)anchor_x(v);
    ay[k] = (int32_t)anchor_y(v);
  }
  for (int64_t i = n + tid; i < N; i += kDpThreads) {
    p2r[i] = -1;
    scr[i] = 0;
    lnr[i] = 1;
  }
  __syncthreads();
  // overflow: some anchor W + 1 places back is still within dx_depth
  int ov = 0;
  for (int64_t i = (int64_t)W + 1 + tid; i < n; i += kDpThreads)
    ov |= (int64_t)(ax[i - W - 1] - ax[i]) < dx_depth;
  ov = __syncthreads_or(ov);
  if (tid == 0) overflow[b] = ov ? 1 : 0;
  if (n == 0) return;  // block-uniform

  const int wr = (int)(we < n ? we : n);  // this row's widest lookback
  const int bits = wr > 1 ? 32 - __clz(wr - 1) : 0;
  // the packed 32-bit key (total << bits | d - 1) holds while every total,
  // at most 100 n, stays below 2^(32 - bits)
  const bool narrow = 100 * n < (1ll << (32 - bits));
  const bool in_regs = K > 0 && narrow;
  const int tiles = (int)((n + ts - 1) / ts);
  const int64_t tile_b = (int64_t)ts * wr;
  // eligibility in int32 (edge_tile): d <= depth, anchor-x gap < dx_depth
  const int depth32 = (int)(depth < 0 ? 0 : (depth > 0x7fffffff ? 0x7fffffff
                                                                 : depth));
  const int dxd = (int)(dx_depth < -0x7fffffffll ? -0x7fffffff
                        : (dx_depth > 0x7fffffff ? 0x7fffffff : dx_depth));
  constexpr int KR = K > 0 ? K : 1;
  uint32_t rs[KR];
#pragma unroll
  for (int h = 0; h < KR; ++h) rs[h] = 0;
  edge_tile<kScoreType>(ax, ay, 0, (int)(n < ts ? n : ts), wr, depth32, dxd,
                        ebuf, tid, kDpThreads, lane);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int i0 = t * ts;
    if (warp == 0) {
      const uint8_t* eb = ebuf + (t & 1) * tile_b;
      const int steps = (int)(n - i0 < ts ? n - i0 : ts);
      if (in_regs)
        scan_tile_reg<KR>(eb, i0, steps, wr, bits, rs, lane, p2r, scr);
      else
        scan_tile_any(eb, i0, steps, wr, bits, narrow, ring_s, ring, lane,
                      p2r, scr);
    } else if (t + 1 < tiles) {
      const int i1 = i0 + ts;
      edge_tile<kScoreType>(ax, ay, i1, (int)(n - i1 < ts ? n - i1 : ts), wr,
                            depth32, dxd, ebuf + ((t + 1) & 1) * tile_b,
                            tid - 32, kDpThreads - 32, lane);
    }
    __syncthreads();  // tile t + 1 is scored; tile t's buffer is free
  }
  // the row table is free: its 8 N bytes take the lengths' links
  lengths_pass(p2r, (int)n, reinterpret_cast<uint64_t*>(ax), lnr);
}

// ---------------------------------------------------------------------------
// The full DP: linear_tpu/ops/chain_dp.py:86 batch_chain_dp, which builds the
// whole (B, N, N) edge-score matrix and eligibility mask in XLA and then runs
// a fori_loop over i with a masked max over every j < i. The plain PyTorch
// version beside it is linear_tpu_torch/ops/chain_dp.py:chain_dp_reference.
//
// What bounds it on the card: the same serial dependence as the windowed
// DP, now with no limit on the lookback, and JAX's mask rather than the C++
// loop's break: j is eligible for i when j < i, j < n and (j >= i - depth
// or anchor_x[j] - anchor_x[i] < dx_depth), whether or not the row is
// sorted. Padded columns i >= n are computed too (from the real columns
// only), as in JAX.
//
// Design: one block a read; the row's anchors, anchor-x, scores and chain
// lengths sit in dynamic shared memory (20 bytes an anchor: N <= 11,622 in
// the 227 KB a block may take); wider rows keep them in a device scratch
// that the wrapper allocates, through the same pointers. The block first
// checks whether the row's real anchors are sorted descending by
// anchor-x. If they are, the eligible
// j of column i form one run [min(i - depth, j0), i), where j0, the first
// j within dx_depth, comes from a binary search; if not, the column scans
// every j < i. Warp 0 runs the real columns in order: its lanes take j,
// compute edge and total, and a five-round xor butterfly
// picks the maximum with the smallest j on ties. The padded columns depend
// only on the real ones, so after a barrier all warps take one each.
template <int kScoreType>
__device__ __forceinline__ void full_column(
    int64_t i, int64_t n, bool sorted, const uint64_t* a_sh,
    const int32_t* ax_sh, const int32_t* sc_sh, const int32_t* ln_sh,
    int64_t depth, int64_t dx_depth, int lane, int64_t* best_out,
    int64_t* bj_out, int32_t* bl_out) {
  const uint64_t ai = a_sh[i];
  const int64_t axi = ax_sh[i];
  const int64_t hi = i < n ? i : n;
  int64_t lo = 0;
  if (sorted) {
    int64_t l = 0, h = n;  // the first j with anchor_x[j] - axi < dx_depth
    while (l < h) {
      const int64_t mid = (l + h) >> 1;
      if ((int64_t)ax_sh[mid] - axi < dx_depth) h = mid;
      else l = mid + 1;
    }
    lo = i - depth < l ? i - depth : l;
    lo = lo < 0 ? 0 : lo;
  }
  int64_t best = kNeg32;
  int64_t best_j = INT64_MAX;
  int32_t best_l = 1;
  for (int64_t j = lo + lane; j < hi; j += 32) {
    const int64_t axj = ax_sh[j];
    if (j >= i - depth || axj - axi < dx_depth) {
      const uint64_t aj = a_sh[j];
      const int32_t e =
          edge_score32(kScoreType, (int32_t)anchor_y(aj), (int32_t)axj,
                       (int32_t)anchor_y(ai), (int32_t)axi);
      if (e > 0) {
        const int64_t t = (int64_t)e + sc_sh[j];
        if (t > best) {  // j rises in a lane: a tie keeps the smaller j
          best = t;
          best_j = j;
          best_l = ln_sh[j];
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t ot = __shfl_xor_sync(0xffffffffu, best, off);
    const int64_t oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    const int32_t ol = __shfl_xor_sync(0xffffffffu, best_l, off);
    if (ot > best || (ot == best && oj < best_j)) {
      best = ot;
      best_j = oj;
      best_l = ol;
    }
  }
  *best_out = best;
  *bj_out = best_j;
  *bl_out = best_l;
}

constexpr int kFullThreads = 256;

template <int kScoreType>
__global__ void __launch_bounds__(kFullThreads)
    chain_dp_full_kernel(const uint64_t* __restrict__ anchors,
                         const int32_t* __restrict__ n_anchors, int64_t N,
                         int64_t depth, int64_t dx_depth, uint64_t* scratch,
                         int32_t* p2, int32_t* score, int32_t* length) {
  extern __shared__ uint64_t smem[];
  // the row in shared memory, or past its budget in this read's 20 N bytes
  // of the device scratch
  uint64_t* a_sh =
      scratch ? scratch + (int64_t)blockIdx.x * ((N * 20 + 7) / 8) : smem;
  int32_t* ax_sh = reinterpret_cast<int32_t*>(a_sh + N);
  int32_t* sc_sh = ax_sh + N;
  int32_t* ln_sh = sc_sh + N;
  const int64_t b = blockIdx.x;
  const uint64_t* a = anchors + b * N;
  int64_t n = n_anchors[b];
  n = n < 0 ? 0 : (n > N ? N : n);
  for (int64_t k = threadIdx.x; k < N; k += blockDim.x) {
    const uint64_t v = a[k];
    a_sh[k] = v;
    ax_sh[k] = (int32_t)anchor_x(v);
  }
  __syncthreads();
  int ok = 1;
  for (int64_t k = threadIdx.x; k + 1 < n; k += blockDim.x)
    ok &= ax_sh[k] >= ax_sh[k + 1];
  const bool sorted = __syncthreads_and(ok);
  int32_t* p2r = p2 + b * N;
  int32_t* scr = score + b * N;
  int32_t* lnr = length + b * N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int64_t best, bj;
  int32_t bl;
  if (warp == 0) {
    for (int64_t i = 0; i < n; ++i) {
      full_column<kScoreType>(i, n, sorted, a_sh, ax_sh, sc_sh, ln_sh, depth,
                              dx_depth, lane, &best, &bj, &bl);
      const bool found = best > 0;
      if (lane == 0) {
        sc_sh[i] = found ? (int32_t)best : 0;
        ln_sh[i] = found ? bl + 1 : 1;
        p2r[i] = found ? (int32_t)bj : -1;
        scr[i] = sc_sh[i];
        lnr[i] = ln_sh[i];
      }
      __syncwarp();  // column i is visible to column i + 1
    }
  }
  __syncthreads();
  for (int64_t i = n + warp; i < N; i += kFullThreads / 32) {
    full_column<kScoreType>(i, n, sorted, a_sh, ax_sh, sc_sh, ln_sh, depth,
                            dx_depth, lane, &best, &bj, &bl);
    const bool found = best > 0;
    if (lane == 0) {
      p2r[i] = found ? (int32_t)bj : -1;
      scr[i] = found ? (int32_t)best : 0;
      lnr[i] = found ? bl + 1 : 1;
    }
  }
}

template <int kScoreType>
int launch_full(const uint64_t* anchors, const int32_t* n_anchors, int64_t B,
                int64_t N, int64_t depth, int64_t dx_depth, uint64_t* scratch,
                int32_t* p2, int32_t* score, int32_t* length,
                cudaStream_t stream) {
  const size_t smem = scratch ? 0 : (size_t)N * 20;
  cudaError_t rc = cudaFuncSetAttribute(
      chain_dp_full_kernel<kScoreType>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  chain_dp_full_kernel<kScoreType><<<(unsigned)B, kFullThreads, smem, stream>>>(
      anchors, n_anchors, N, depth, dx_depth, scratch, p2, score, length);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Device scratch bytes a read of the full DP at width N: 0 while its 20 N
// bytes fit the shared memory a block may take (N <= 11,622), else 20 N
// rounded up to whole int64 words.
int64_t lt_chain_dp_full_scratch(int64_t N) {
  return N * 20 > kMaxFullSmem ? (N * 20 + 7) / 8 * 8 : 0;
}

// Launches the full DP on `stream`: anchors (B, N) uint64, n_anchors (B,)
// int32, N >= 1; scratch: B * lt_chain_dp_full_scratch(N) bytes (null when
// that is 0). Outputs p2, score, length (B, N) int32. Returns the
// cudaError_t of the launch.
int lt_chain_dp_full(const uint64_t* anchors, const int32_t* n_anchors,
                     int64_t B, int64_t N, int64_t depth, int64_t dx_depth,
                     int score_type, uint64_t* scratch, int32_t* p2,
                     int32_t* score, int32_t* length, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 1 || N > 0x7fffffff || B > 0x7fffffff ||
      (lt_chain_dp_full_scratch(N) > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (score_type == 0)
    return launch_full<0>(anchors, n_anchors, B, N, depth, dx_depth, scratch,
                          p2, score, length, (cudaStream_t)stream);
  return launch_full<1>(anchors, n_anchors, B, N, depth, dx_depth, scratch,
                        p2, score, length, (cudaStream_t)stream);
}


// Device scratch bytes that lt_chain_dp_windowed needs a read at (N, W):
// the ring, row table and edge tiles that exceed their shared-memory
// budgets (0 for the Mapper's launches).
int64_t lt_chain_dp_windowed_scratch(int64_t N, int W) {
  if (N < 1 || W < 1) return 0;
  return win_layout(N, W).scratch;
}

// Launches the kernel on `stream`. anchors (B, N) uint64 sorted descending
// by anchor-x in each row's first n_anchors[b] columns; n_anchors (B,)
// int32; W >= 1; scratch: B * lt_chain_dp_windowed_scratch(N, W) bytes
// (null when that is 0).
// Outputs p2, score, length (B, N) int32 and overflow (B,) uint8. Returns
// the cudaError_t of the launch (0: launched).
int lt_chain_dp_windowed(const uint64_t* anchors, const int32_t* n_anchors,
                         int64_t B, int64_t N, int W, int64_t depth,
                         int64_t dx_depth, int score_type, uint8_t* scratch,
                         int32_t* p2, int32_t* score, int32_t* length,
                         uint8_t* overflow, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || N < 1 || N > 0x7fffffff || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const WinLayout L = win_layout(N, W);
  if ((L.scratch > 0) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  // the register ring's lookbacks a lane for W <= 128, else 0
  const int k = L.we <= 32 ? 1 : (L.we <= 64 ? 2 : (L.we <= 128 ? 4 : 0));
  void (*const kernels[2][4])(const uint64_t*, const int32_t*, int64_t, int,
                              int, int, int, int, int, int, int64_t, int64_t,
                              int64_t, uint8_t*, int32_t*, int32_t*, int32_t*,
                              uint8_t*) = {
      {chain_dp_kernel<0, 0>, chain_dp_kernel<0, 1>, chain_dp_kernel<0, 2>,
       chain_dp_kernel<0, 4>},
      {chain_dp_kernel<1, 0>, chain_dp_kernel<1, 1>, chain_dp_kernel<1, 2>,
       chain_dp_kernel<1, 4>}};
  auto kernel = kernels[score_type == 0 ? 0 : 1][k == 4 ? 3 : k];
  if (L.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(unsigned)B, kDpThreads, (size_t)L.smem, (cudaStream_t)stream>>>(
      anchors, n_anchors, N, W, L.we, L.ring, L.ts, L.ring_g, L.row_g,
      L.edge_g, L.scratch, depth, dx_depth, scratch, p2, score, length,
      overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
