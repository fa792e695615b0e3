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
// needs the scores of the W anchors before it, so a read's N steps run one
// after another; each step is W edge scores (int64 integer arithmetic with
// two or three truncating divisions each) and an argmax. The bytes are
// small: N anchors a read, read W times each, mostly from L1.
//
// Design: one warp per read, four reads a block. Lane k owns lookbacks
// d = k + 1 and d = k + 33 (anchor j = i - d), computes their edge scores
// and totals, and keeps the better one, the smaller j on ties; a five-round
// xor butterfly then gives every lane the read's maximum and its smallest j.
// The last 64 DP scores (int64) and chain lengths sit in a shared-memory
// ring indexed by j mod 64. Lane 0 writes step i's result into the ring and
// the outputs; __syncwarp orders the ring's reads before that write and the
// write before the next step's reads. The overflow flag (a dx-depth
// lookback could reach past W) is an independent pass of the same warp,
// reduced with __any_sync. Padded columns j >= n get p2 = -1, score 0,
// length 1, as in the JAX function.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kMaskX30 = (1ull << 30) - 1;
constexpr uint64_t kValueMaskDstr = ((1ull << 60) - 1) | (1ull << 61);
constexpr int64_t kNeg = -(1ll << 40);  // the ring's sentinel, as in JAX
constexpr int kMaxW = 64;
constexpr int kWarps = 4;  // reads (warps) per block
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
__device__ __forceinline__ int64_t iabs(int64_t v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// getApxChainScore (cluster_util.cpp:387) of edge (a1 = anchor j, a2 =
// anchor i). C++ `/` truncates toward zero, as JAX's _tdiv. The JAX
// function evaluates every branch and selects; here only the selected
// branch is evaluated, which gives the same value and keeps derr * derr
// (derr < 100 there) from overflowing.
__device__ __forceinline__ int32_t apx_chain_score(uint64_t a1, int64_t ax1,
                                                   uint64_t a2, int64_t ax2) {
  const int64_t dy = anchor_y(a1) - anchor_y(a2);
  if (dy < 10) return -10000;
  const int64_t dx = ax1 - ax2;
  const int64_t da = iabs(dx - dy);
  const int64_t denom = imax(imax(iabs(dy), iabs(dx)), 50);
  const int64_t derr = 100 * da / denom;
  if (derr >= 100) return -1000;
  const int64_t dy15 = dy / 15;
  const int64_t score_dy =
      dy15 < 150 ? dy15 / 5 : (dy15 < 10000 ? dy15 * dy15 / 200 + 20 : 10000);
  if (da < 10) return (int32_t)(100 - score_dy);
  const int64_t score_derr =
      derr < 5 ? 4 * derr : (derr < 10 ? 6 * derr - 10 : derr * derr - 5 * derr);
  return (int32_t)(100 - score_dy - score_derr);
}

// getApxChainScore0 (cluster_util.cpp:337), the toggle(1) variant
__device__ __forceinline__ int32_t apx_chain_score0(uint64_t a1, int64_t ax1,
                                                    uint64_t a2, int64_t ax2) {
  const int64_t dy = anchor_y(a1) - anchor_y(a2);
  if (dy < 5) return -10000;
  const int64_t dx = ax1 - ax2;
  const int64_t da = iabs(dx - dy);
  const int64_t denom = imax(imax(iabs(dy), iabs(dx)), 50);
  if (100 * da / denom >= 100) return -1000;
  return (int32_t)(da < 30 ? 100 - dy : 100 - dy - da);
}

template <int kScoreType>
__global__ void __launch_bounds__(kWarps * 32)
    chain_dp_kernel(const uint64_t* __restrict__ anchors,
                    const int32_t* __restrict__ n_anchors, int64_t B, int64_t N,
                    int W, int64_t depth, int64_t dx_depth, int32_t* p2,
                    int32_t* score, int32_t* length, uint8_t* overflow) {
  __shared__ int64_t ring_s[kWarps][kMaxW];
  __shared__ int32_t ring_l[kWarps][kMaxW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves; no block-wide barrier follows
  const uint64_t* a = anchors + b * N;
  int64_t n = n_anchors[b];
  n = n < 0 ? 0 : (n > N ? N : n);
  int64_t* rs = ring_s[warp];
  int32_t* rl = ring_l[warp];
  for (int k = lane; k < kMaxW; k += 32) {
    rs[k] = 0;
    rl[k] = 1;
  }
  __syncwarp();
  int32_t* p2r = p2 + b * N;
  int32_t* scr = score + b * N;
  int32_t* lnr = length + b * N;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t ai = a[i];
    const int64_t axi = anchor_x(ai);
    int64_t best = kNeg;
    int64_t best_j = INT64_MAX;
    int32_t best_l = 1;
    // the farther lookback first: a strict > then keeps the smaller j
#pragma unroll
    for (int h = 1; h >= 0; --h) {
      const int d = lane + 1 + 32 * h;
      const int64_t j = i - d;
      if (d <= W && j >= 0) {
        const uint64_t aj = a[j];
        const int64_t axj = anchor_x(aj);
        if (j >= i - depth || axj - axi < dx_depth) {
          const int32_t e = kScoreType == 0 ? apx_chain_score(aj, axj, ai, axi)
                                            : apx_chain_score0(aj, axj, ai, axi);
          if (e > 0) {
            const int64_t t = (int64_t)e + rs[j & (kMaxW - 1)];
            if (t > best) {
              best = t;
              best_j = j;
              best_l = rl[j & (kMaxW - 1)];
            }
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
    const bool found = best > 0;
    const int64_t s = found ? best : 0;
    const int32_t l = found ? best_l + 1 : 1;
    __syncwarp();  // every lane has read the ring for step i
    if (lane == 0) {
      rs[i & (kMaxW - 1)] = s;
      rl[i & (kMaxW - 1)] = l;
      p2r[i] = found ? (int32_t)best_j : -1;
      scr[i] = (int32_t)s;
      lnr[i] = l;
    }
    __syncwarp();  // step i's ring slot is visible to step i + 1
  }
  for (int64_t i = n + lane; i < N; i += 32) {
    p2r[i] = -1;
    scr[i] = 0;
    lnr[i] = 1;
  }
  // overflow: some anchor W + 1 places back is still within dx_depth
  bool ov = false;
  for (int64_t i = W + 1 + lane; i < n; i += 32) {
    ov |= anchor_x(a[i - W - 1]) - anchor_x(a[i]) < dx_depth;
  }
  ov = __any_sync(0xffffffffu, ov);
  if (lane == 0) overflow[b] = ov ? 1 : 0;
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
// the 227 KB a block may take). The block first checks whether the row's
// real anchors are sorted descending by anchor-x. If they are, the eligible
// j of column i form one run [min(i - depth, j0), i), where j0, the first
// j within dx_depth, comes from a binary search; if not, the column scans
// every j < i. Warp 0 runs the real columns in order: its lanes take j,
// compute edge and total, and the xor butterfly of the windowed kernel
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
      const int32_t e = kScoreType == 0 ? apx_chain_score(aj, axj, ai, axi)
                                        : apx_chain_score0(aj, axj, ai, axi);
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
                         int64_t depth, int64_t dx_depth, int32_t* p2,
                         int32_t* score, int32_t* length) {
  extern __shared__ uint64_t smem[];
  uint64_t* a_sh = smem;
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
                int64_t N, int64_t depth, int64_t dx_depth, int32_t* p2,
                int32_t* score, int32_t* length, cudaStream_t stream) {
  const size_t smem = (size_t)N * 20;
  cudaError_t rc = cudaFuncSetAttribute(
      chain_dp_full_kernel<kScoreType>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  chain_dp_full_kernel<kScoreType><<<(unsigned)B, kFullThreads, smem, stream>>>(
      anchors, n_anchors, N, depth, dx_depth, p2, score, length);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the full DP on `stream`: anchors (B, N) uint64, n_anchors (B,)
// int32; 1 <= N <= 11,622 (20 N bytes of shared memory). Outputs p2, score,
// length (B, N) int32. Returns the cudaError_t of the launch.
int lt_chain_dp_full(const uint64_t* anchors, const int32_t* n_anchors,
                     int64_t B, int64_t N, int64_t depth, int64_t dx_depth,
                     int score_type, int32_t* p2, int32_t* score,
                     int32_t* length, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (N < 1 || N * 20 > kMaxFullSmem || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (score_type == 0)
    return launch_full<0>(anchors, n_anchors, B, N, depth, dx_depth, p2,
                          score, length, (cudaStream_t)stream);
  return launch_full<1>(anchors, n_anchors, B, N, depth, dx_depth, p2, score,
                        length, (cudaStream_t)stream);
}


// Launches the kernel on `stream`. anchors (B, N) uint64 sorted descending
// by anchor-x in each row's first n_anchors[b] columns; n_anchors (B,)
// int32; 1 <= W <= 64. Outputs p2, score, length (B, N) int32 and overflow
// (B,) uint8. Returns the cudaError_t of the launch (0: launched).
int lt_chain_dp_windowed(const uint64_t* anchors, const int32_t* n_anchors,
                         int64_t B, int64_t N, int W, int64_t depth,
                         int64_t dx_depth, int score_type, int32_t* p2,
                         int32_t* score, int32_t* length, uint8_t* overflow,
                         void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || W > kMaxW || N < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  if (score_type == 0) {
    chain_dp_kernel<0><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        anchors, n_anchors, B, N, W, depth, dx_depth, p2, score, length,
        overflow);
  } else {
    chain_dp_kernel<1><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        anchors, n_anchors, B, N, W, depth, dx_depth, p2, score, length,
        overflow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
