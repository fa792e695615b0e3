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

__host__ __device__ inline int64_t align8(int64_t v) {
  return (v + 7) & ~(int64_t)7;
}

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
// rounds r = 1, 2, 4, ... up to the first r >= max_len, the most columns a
// chain can hold (ceil(log2 max_len) + 1 rounds), reach every root, for any
// n below 2^31. `link` holds n words.
__device__ __forceinline__ void lengths_pass(const int32_t* p2r, int n,
                                             int max_len, uint64_t* link,
                                             int32_t* lnr) {
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
    if (r >= (unsigned)max_len) break;
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
  lengths_pass(p2r, (int)n, (int)n, reinterpret_cast<uint64_t*>(ax), lnr);
}

// ---------------------------------------------------------------------------
// The full DP: linear_tpu/ops/chain_dp.py:86 batch_chain_dp, which builds the
// whole (B, N, N) edge-score matrix and eligibility mask in XLA and then runs
// a fori_loop over i with a masked max over every j < i. The plain PyTorch
// version beside it is linear_tpu_torch/ops/chain_dp.py:chain_dp_reference,
// and chain_dp_split there states this kernel's decomposition.
//
// What bounds it on the card: the same serial dependence as the windowed
// DP, now with no limit on the lookback, and JAX's mask rather than the C++
// loop's break: j is eligible for i when j < i, j < n and (j >= i - depth
// or anchor_x[j] - anchor_x[i] < dx_depth), whether or not the row is
// sorted. Padded columns i >= n are computed too (from the real columns
// only), as in JAX.
//
// Design (a block a read, warp 0 running every column with a binary search,
// the edge scores of every eligible j and a 64-bit butterfly inside each
// serial step, measured 10 ms at (256, 8192) and 60 ms at (4, 12288) with
// the row in global memory). Column i's max splits in two:
//   - near, j in [i - kNearD, i): the chain warp's step, as in the windowed
//     kernel: the edge bytes of the step come from a tile that helper warps
//     scored off the chain, the scores of the last kNearD columns ride in a
//     register ring, and one __reduce_max_sync of the
//     packed key (total << bits | d - 1) picks the largest total and on a
//     tie the smallest j; the far slot takes part as field wr, above every
//     d - 1, since its j is smaller than every near j;
//   - far, j < i - kNearD: only scores that are final when the chain starts
//     the tile before column i's. While warp 0 scans tile t (kTileT
//     columns), warps 1-7 prepare tile t + 1: a lane a column, one binary
//     search on sorted rows gives each column's first j within dx_depth,
//     j0, and so its eligible lookbacks (d <= max(depth, i - j0)) and its
//     far range [min(j0, i - depth), i - kNearD); then a warp a column
//     scores the near edge bytes that can be eligible (0 for the rest) and
//     runs the far part (far_range) into a (total, j) slot. On other rows
//     every d and every j is tried under JAX's mask. kTileT <= (kNearD +
//     1) / 2 keeps every j they read in tiles <= t - 1.
// Step s's outputs stay in lane s until the tile's end (one store a lane,
// no branch on the chain); the lengths come after the scan from p2, by
// pointer jumping (lengths_pass). Padded columns i >= n then go a warp
// a column over j < n; one whose anchor-x and y equal column i - 1's, with
// i - 1 >= n + depth (the depth term then admits no j < n for either), has
// column i - 1's result, so a block scan hands each such run its first
// column's.
// (A design that scored all kNearD lookbacks of a tile in the helpers' ILP
// loop and ran each column's binary search in its own warp measured slower:
// the helpers, not the chain, set its time.)
// The block keeps anchor-x, y and the scores, 12 bytes a column, in shared
// memory (N <= 18,944 with the tiles: two blocks an SM at N 8,192), past
// that in a device scratch; the chain needs only its ring and the tiles.
// Totals are JAX's sums of the edge and score; every one stays below 2^25
// (scan_tile_split), so the chain's key fits 32 bits on any row.
constexpr int kFullThreads = 256;
constexpr int kNearD = 64;   // the chain's lookbacks: two a lane
constexpr int kTileT = 32;   // columns a tile
constexpr int64_t kFullTiles =
    2 * kTileT * kNearD + 2 * kTileT * 8 + 2 * kTileT * 4;  // edges, far slots
static_assert(2 * kTileT - 1 <= kNearD, "far slots read only final scores");

// A column's anchor-x and y side by side (one 8-byte load).
struct __align__(8) XY {
  int32_t x, y;
};

// On a row sorted descending by anchor-x: the first j in [0, n) whose
// anchor-x is within dx_depth of axi (anchor_x[j] - axi < dx_depth holds
// from there on). Column i's eligible j are then [min(j0, i - depth), i)
// (the far part's start) and its eligible lookbacks d <= max(depth, i - j0).
__device__ __forceinline__ int64_t first_within(int64_t axi, int64_t n,
                                                const XY* xy,
                                                int64_t dx_depth) {
  int64_t l = 0, h = n;
  while (l < h) {
    const int64_t mid = (l + h) >> 1;
    if ((int64_t)xy[mid].x - axi < dx_depth) h = mid;
    else l = mid + 1;
  }
  return l;
}

// The far part of column i over j in [lo, hi): the largest int64 total
// e(j, i) + score[j] of an eligible j with a positive edge, the smallest j
// on a tie. One warp, four j a lane at a time; every lane returns it, (0,
// -1) when there is none (a total that is not positive never counts: JAX's
// found). A positive edge of either score type has 5 <= dy < 2250 and
// -50 < dx < 2599 (ops/chain_dp.py far_edge_may_score), so the other j,
// most of a shuffled row's and all of a padded column's past the row, are
// passed over without a score.
template <int kScoreType>
__device__ __forceinline__ int64_t far_range(int64_t i, int64_t lo,
                                             int64_t hi, const XY* xy,
                                             const int32_t* sc, int64_t depth,
                                             int64_t dx_depth, int lane,
                                             int* bj_out) {
  constexpr int kU = 4;
  const XY xi = xy[i];
  int64_t best = 0;
  int bj = -1;
  for (int64_t jb = lo + lane; jb < hi; jb += 32 * kU) {
    XY v[kU];
    bool f[kU];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t j = jb + 32 * u;
      v[u] = j < hi ? xy[j] : xi;
      const int32_t dy = v[u].y - xi.y, dx = v[u].x - xi.x;
      f[u] = j < hi && (unsigned)(dy - 5) < 2245u &&
             (unsigned)(dx + 49) < 2648u &&
             (j >= i - depth || (int64_t)dx < dx_depth);
      any |= f[u];
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!f[u]) continue;
        const int32_t e = edge_score32(kScoreType, v[u].y, v[u].x, xi.y, xi.x);
        const int64_t j = jb + 32 * u;
        const int64_t t = (int64_t)e + sc[j];
        if (e > 0 && t > best) {  // j rises in a lane: a tie keeps the smaller
          best = t;
          bj = (int)j;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t ot = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (ot > best || (ot == best && oj < bj)) {
      best = ot;
      bj = oj;
    }
  }
  *bj_out = bj;
  return best;
}

// A tile's serial steps of the full DP (the chain warp, kTileT = 32 steps,
// step s's outputs kept by lane s and stored after the tile): the near part
// from the edge bytes and the register ring (lane l holds in rs[h] the score
// of j = i - d, d = l + 1 + 32 h), merged with the far slot in one
// __reduce_max_sync of the packed key total << bits | field, field d - 1
// for a lookback and wr for the far slot, so the far part wins a tie inside
// the reduction. The key fits 32 bits for any row: a positive edge is at
// most 100 and needs y[j] - y[i] >= 5, so along a chain y falls by 5 a link
// within its 20 bits, and a total stays below 100 * 2^20 / 5 + 100 < 2^25
// (bits <= 7, wr <= 64).
__device__ __forceinline__ void scan_tile_split(
    const uint8_t* eb, int i0, int steps, int wr, int bits,
    const int64_t* ftot, const int32_t* fj, uint32_t (&rs)[2], int lane,
    int32_t* p2r, int32_t* scr, int32_t* sc) {
  static_assert(kTileT == 32, "lane s keeps step s's outputs");
  const uint32_t dmask = (1u << bits) - 1;
  // lane s's far slot, as a key
  const int64_t ft_l = lane < steps ? ftot[lane] : 0;
  const int32_t fj_l = lane < steps ? fj[lane] : -1;
  const uint32_t fk_l = ft_l > 0 ? ((uint32_t)ft_l << bits) | (uint32_t)wr : 0u;
  int32_t my_p2 = -1, my_sc = 0;
  uint32_t e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = lane + 1 + 32 * h;
    e[h] = d <= wr ? eb[d - 1] : 0u;
  }
  for (int s = 0; s < steps; ++s) {
    uint32_t key = __shfl_sync(0xffffffffu, fk_l, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = lane + 1 + 32 * h;
      const uint32_t k =
          e[h] ? (((e[h] + rs[h]) << bits) | (uint32_t)(d - 1)) : 0u;
      key = k > key ? k : key;
    }
    if (s + 1 < steps) {
      const uint8_t* en = eb + (s + 1) * wr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = lane + 1 + 32 * h;
        e[h] = d <= wr ? en[d - 1] : 0u;
      }
    }
    key = __reduce_max_sync(0xffffffffu, key);
    const uint32_t best = key >> bits;  // 0: no eligible edge
    const int field = (int)(key & dmask);
    const int i = i0 + s;
    const int32_t p2i = key == 0 ? -1 : (field == wr ? fj_l : i - field - 1);
#pragma unroll
    for (int h = 1; h >= 0; --h) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, rs[h], 1);
      const uint32_t in = h ? __shfl_sync(0xffffffffu, rs[0], 31) : best;
      rs[h] = lane ? up : in;
    }
    my_p2 = lane == s ? p2i : my_p2;
    my_sc = lane == s ? (int32_t)best : my_sc;
  }
  if (lane < steps) {
    p2r[i0 + lane] = my_p2;
    scr[i0 + lane] = my_sc;
    sc[i0 + lane] = my_sc;
  }
}

// the exclusive max of v over the block's threads in thread order (-1 for
// thread 0); tmp holds a word a warp; ends with a barrier
__device__ __forceinline__ int block_excl_max(int v, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s = max(s, o);
  }
  int ex = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) ex = -1;
  if (lane == 31) tmp[warp] = s;
  __syncthreads();
  for (int w = 0; w < warp; ++w) ex = max(ex, tmp[w]);
  __syncthreads();
  return ex;
}

// the device scratch bytes a read of the full DP needs at width N: 0 while
// its tables (12 N bytes) fit the shared memory beside the tiles
__host__ __device__ inline int64_t full_table_bytes(int64_t N) {
  return align8(12 * N);
}
inline bool full_tables_in_smem(int64_t N) {
  return full_table_bytes(N) + kFullTiles <= kMaxFullSmem - 256;
}

template <int kScoreType>
__global__ void __launch_bounds__(kFullThreads)
    chain_dp_full_kernel(const uint64_t* __restrict__ anchors,
                         const int32_t* __restrict__ n_anchors, int64_t N,
                         int64_t depth, int64_t dx_depth, uint8_t* scratch,
                         int32_t* p2, int32_t* score, int32_t* length) {
  extern __shared__ int64_t full_smem[];
  __shared__ int scan_tmp[kFullThreads / 32];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the tiles, then the tables (here or in this read's part of the scratch)
  uint8_t* sp = reinterpret_cast<uint8_t*>(full_smem);
  int64_t* ftot_b = reinterpret_cast<int64_t*>(sp);    // 2 x kTileT
  int32_t* fj_b = reinterpret_cast<int32_t*>(sp + 16 * kTileT);
  uint8_t* ebuf = sp + 24 * kTileT;                   // 2 x kTileT x kNearD
  uint8_t* tp = scratch ? scratch + b * full_table_bytes(N) : sp + kFullTiles;
  XY* xy = reinterpret_cast<XY*>(tp);
  int32_t* sc = reinterpret_cast<int32_t*>(xy + N);

  const uint64_t* a = anchors + b * N;
  int64_t n = n_anchors[b];
  n = n < 0 ? 0 : (n > N ? N : n);
  int32_t* p2r = p2 + b * N;
  int32_t* scr = score + b * N;
  int32_t* lnr = length + b * N;
  for (int64_t k = tid; k < N; k += kFullThreads) {
    const uint64_t v = a[k];
    xy[k] = XY{(int32_t)anchor_x(v), (int32_t)anchor_y(v)};
  }
  __syncthreads();
  int ok = 1;
  for (int64_t k = tid; k + 1 < n; k += kFullThreads)
    ok &= xy[k].x >= xy[k + 1].x;
  const bool sorted = __syncthreads_and(ok);

  if (n > 0) {
    const int wr = (int)(kNearD < n ? kNearD : n);  // the near lookbacks
    // the key's field holds d - 1 < wr, or wr for the far slot
    const int bits = 32 - __clz(wr);
    const int tiles = (int)((n + kTileT - 1) / kTileT);
    const int tile_b = kTileT * wr;
    // tile t's edge bytes and far slots by `warps` warps from `w0`: each
    // warp first finds, a lane a column, the far part's start and the
    // eligible lookbacks of the tile's columns (on sorted rows by a binary
    // search; on others every j and every d), then takes columns
    // warp - w0, + warps, ...: its lanes score the near lookbacks d =
    // lane + 1 (+ 32) that can be eligible, writing 0 for the rest, and it
    // runs the far part over [lo, i - kNearD)
    auto prepare = [&](int t, int w0, int warps) {
      const int i0 = t * kTileT;
      const int steps = (int)(n - i0 < kTileT ? n - i0 : kTileT);
      int64_t lo_c = 0;
      int dm_c = 0;
      if (lane < steps) {
        const int64_t ic = i0 + lane;
        const int64_t dall = ic < wr ? ic : wr;  // j = i - d >= 0
        if (sorted) {
          const int64_t j0 = first_within(xy[ic].x, n, xy, dx_depth);
          const int64_t lo = ic - depth < j0 ? ic - depth : j0;
          lo_c = lo < 0 ? 0 : lo;
          const int64_t dm = depth > ic - j0 ? depth : ic - j0;
          dm_c = (int)(dm < 0 ? 0 : (dm > dall ? dall : dm));
        } else {
          dm_c = (int)dall;
        }
      }
      uint8_t* eb = ebuf + (t & 1) * tile_b;
      for (int c = warp - w0; c < steps; c += warps) {
        const int64_t i = i0 + c;
        const int dm = __shfl_sync(0xffffffffu, dm_c, c);
        const int64_t lo = __shfl_sync(0xffffffffu, lo_c, c);
        const XY xi = xy[i];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = lane + 1 + 32 * h;
          uint32_t e = 0;
          if (d <= dm) {
            const XY xj = xy[i - d];
            const bool elig =
                sorted || d <= depth || (int64_t)(xj.x - xi.x) < dx_depth;
            const int32_t v =
                edge_score32(kScoreType, xj.y, xj.x, xi.y, xi.x);
            e = elig && v > 0 ? (uint32_t)v : 0u;
          }
          if (d <= wr) eb[c * wr + d - 1] = (uint8_t)e;
        }
        int bj = -1;
        int64_t ft = 0;
        if (i - kNearD > lo)  // warp-uniform
          ft = far_range<kScoreType>(i, lo, i - kNearD, xy, sc, depth,
                                     dx_depth, lane, &bj);
        if (lane == 0) {
          ftot_b[(t & 1) * kTileT + c] = ft;
          fj_b[(t & 1) * kTileT + c] = bj;
        }
      }
    };
    uint32_t rs[2] = {0u, 0u};
    prepare(0, 0, kFullThreads / 32);
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      if (warp == 0) {
        const int i0 = t * kTileT;
        const int steps = (int)(n - i0 < kTileT ? n - i0 : kTileT);
        const uint8_t* eb = ebuf + (t & 1) * tile_b;
        const int64_t* ft = ftot_b + (t & 1) * kTileT;
        const int32_t* fj = fj_b + (t & 1) * kTileT;
        scan_tile_split(eb, i0, steps, wr, bits, ft, fj, rs, lane, p2r, scr,
                        sc);
      } else if (t + 1 < tiles) {
        prepare(t + 1, 1, kFullThreads / 32 - 1);
      }
      __syncthreads();  // tile t + 1 is prepared; tile t's slots are free
    }
  }
  // padded columns: from the real ones only. A column whose anchor-x and y
  // (all its result depends on) equal column i - 1's, both past n + depth,
  // copies it; the others go a warp a column, the k-th of them (in column
  // order, counted by ballots that every warp takes alike) to warp k mod 8
  const int64_t copy_from = n + (depth < 0 ? 0 : (depth > N ? N : depth));
  const int64_t* xy64 = reinterpret_cast<const int64_t*>(xy);
  auto is_copy = [&](int64_t i) {
    return i - 1 >= copy_from && xy64[i] == xy64[i - 1];
  };
  int rank = 0;  // the computed columns before this group of 32
  for (int64_t base = n; base < N; base += 32) {
    const int64_t i = base + lane;
    unsigned todo = __ballot_sync(0xffffffffu, i < N && !is_copy(i));
    const int count = __popc(todo);
    for (int k = 0; todo; ++k, todo &= todo - 1) {
      if ((rank + k) % (kFullThreads / 32) != warp) continue;  // warp-uniform
      const int64_t c = base + __ffs(todo) - 1;
      int64_t lo = 0;
      if (sorted) {
        const int64_t j0 = first_within(xy[c].x, n, xy, dx_depth);
        lo = c - depth < j0 ? c - depth : j0;
        lo = lo < 0 ? 0 : lo;
      }
      int bj = -1;
      int64_t t = 0;
      if (n > lo)
        t = far_range<kScoreType>(c, lo, n, xy, sc, depth, dx_depth, lane,
                                  &bj);
      if (lane == 0) {
        p2r[c] = bj;
        scr[c] = (int32_t)t;
      }
    }
    rank += count;
  }
  __syncthreads();
  if (copy_from + 1 < N) {  // block-uniform
    // each thread a run of columns; the last computed column before each
    const int64_t span = N - n;
    const int64_t per = (span + kFullThreads - 1) / kFullThreads;
    const int64_t c0 = n + tid * per;
    const int64_t c1 = c0 + per < N ? c0 + per : N;
    int last = -1;
    for (int64_t i = c0; i < c1; ++i)
      if (!is_copy(i)) last = (int)i;
    int src = block_excl_max(last, scan_tmp);
    for (int64_t i = c0; i < c1; ++i) {
      if (!is_copy(i)) {
        src = (int)i;
      } else {
        p2r[i] = p2r[src];
        scr[i] = scr[src];
      }
    }
    __syncthreads();
  }
  // the tables are free: their 12 N bytes take the lengths' links; a chain
  // holds at most n + 1 columns (a padded one and n real ones)
  lengths_pass(p2r, (int)N, (int)n + 1, reinterpret_cast<uint64_t*>(tp), lnr);
}

template <int kScoreType>
int launch_full(const uint64_t* anchors, const int32_t* n_anchors, int64_t B,
                int64_t N, int64_t depth, int64_t dx_depth, uint8_t* scratch,
                int32_t* p2, int32_t* score, int32_t* length,
                cudaStream_t stream) {
  const size_t smem =
      (size_t)(kFullTiles + (scratch ? 0 : full_table_bytes(N)));
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

// Device scratch bytes a read of the full DP at width N: 0 while its tables
// (anchor-x, y and score, 12 N bytes) fit the shared memory beside the
// tiles (N <= 18,944), else 12 N rounded up to whole int64 words.
int64_t lt_chain_dp_full_scratch(int64_t N) {
  return full_tables_in_smem(N) ? 0 : full_table_bytes(N);
}

// Launches the full DP on `stream`: anchors (B, N) uint64, n_anchors (B,)
// int32, N >= 1; scratch: B * lt_chain_dp_full_scratch(N) bytes (null when
// that is 0). Outputs p2, score, length (B, N) int32. Returns the
// cudaError_t of the launch.
int lt_chain_dp_full(const uint64_t* anchors, const int32_t* n_anchors,
                     int64_t B, int64_t N, int64_t depth, int64_t dx_depth,
                     int score_type, uint8_t* scratch, int32_t* p2,
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
