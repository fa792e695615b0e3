// The anchor sort of the mesh mapping step, for Hopper (sm_90a).
//
// Replaces the sort lines of two jitted XLA bodies of
// linear_tpu/parallel/mesh.py: mapping_step (:44-52) and sort_chain (:285)
// inside grid_mapping_step: key = keep ? -anchor_x : 1 << 62, a stable
// argsort of each row of the flattened (B, P * cap) seeding grid, the first
// n_max columns, take_along_axis. The plain PyTorch version beside it is
// linear_tpu_torch/ops/chain_dp.py: sort_anchors_reference. Outputs are
// identical on every element: out (B, min(n_max, n)) holds each row's kept
// anchors in descending anchor-x order, ties by the lower flat index, then,
// where fewer than n_max are kept, the row's first unkept slots in flat
// order with whatever they hold; count is min(kept, n_max).
//
// What bounds it on the card: bytes. The keep flags are read once (a byte a
// slot; 49 MB at (256, 191,488)), the kept anchors once, the output written
// once. The sort itself touches only the kept anchors.
//
// Design: one block a row, three phases.
//   1  A block-wide exclusive scan of the keep flags, kItems consecutive
//      flags a thread, carried across tiles (as K3 of seed_anchors.cu),
//      gives every kept slot its rank r among the kept and so every unkept
//      slot its rank i - r among the unkept: the unkept keys all tie and a
//      stable sort leaves them in flat order behind the kept, so the
//      trailing columns need no sort. Kept slot i goes to the row's scratch
//      as (kMaskX30 - anchor_x) << 32 | i; the first n_max unkept indices go
//      to a second scratch. The digit histograms of all passes are counted
//      here, in shared memory.
//   2  A stable least-significant-digit radix sort of the kept items by
//      their 30-bit key, six passes of 5 bits between two global buffers.
//      Per tile of kThreads * kItems items each thread counts its items by
//      digit in its own column of a (32, kThreads) counter table; a warp a
//      group of four digits scans each digit's row across the threads
//      (shuffles); an item lands at digit base + items of its digit in
//      earlier tiles and threads + its rank in the thread. A pass in which
//      one digit holds every item is the identity and is skipped (the high
//      digits of a small genome's anchors).
//   3  The first n_max items' flat indices gather the anchors; the unkept
//      indices fill the columns past the kept count.
// Exact for any kept count up to the whole row; n < 2^31 (the wrapper
// checks it).
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kMaskX30 = (1ull << 30) - 1;
constexpr uint64_t kValueMaskDstr = ((1ull << 60) - 1) | (1ull << 61);

constexpr int kThreads = 256;
constexpr int kItems = 8;  // slots a thread per tile
constexpr int kRadixBits = 5;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPasses = 6;  // 6 * 5 bits: the 30-bit key
constexpr int kDigitsPerWarp = kRadix / (kThreads / 32);
constexpr unsigned kFull = 0xffffffffu;

// getAnchorX (src/cords.cpp:463): the 64-bit add may pass bit 63; it wraps
// as uint64 and the mask clears the high bits
__device__ __forceinline__ uint64_t anchor_x(uint64_t a) {
  const uint64_t v = (a + ((a & kMaskY) << 20) - (1ull << 40)) & kValueMaskDstr;
  return (v >> 20) & kMaskX30;
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
sort_anchors_kernel(const int64_t* __restrict__ anc,
                    const uint8_t* __restrict__ keep, int64_t n, int n_out,
                    int n_max, uint64_t* buf_a, uint64_t* buf_b, int32_t* unk,
                    int64_t* __restrict__ out, int32_t* __restrict__ count) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ uint32_t s_cnt[kRadix * kThreads];
  __shared__ uint32_t s_hist[kPasses * kRadix];
  __shared__ uint32_t s_base[kRadix];
  __shared__ uint32_t s_total[kRadix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const uint8_t* kr = keep + b * n;
  const int64_t* ar = anc + b * n;
  uint64_t* src = buf_a + b * n;
  uint64_t* dst = buf_b + b * n;
  int32_t* ur = unk + b * (int64_t)n_out;
  int64_t* orow = out + b * (int64_t)n_out;

  for (int i = tid; i < kPasses * kRadix; i += kThreads) s_hist[i] = 0;
  __syncthreads();

  // phase 1: ranks of the kept and the unkept slots, keys, histograms
  int64_t carry = 0;  // block-uniform: kept flags of earlier tiles
  for (int64_t t0 = 0; t0 < n; t0 += (int64_t)kThreads * kItems) {
    const int64_t i0 = t0 + (int64_t)tid * kItems;
    int flag[kItems], pre[kItems];
    for (int i = 0; i < kItems; i++)
      flag[i] = i0 + i < n ? (kr[i0 + i] != 0) : 0;
    int total;
    BlockScan(scan_tmp).ExclusiveSum(flag, pre, total);
    for (int i = 0; i < kItems; i++) {
      const int64_t s = i0 + i;
      if (s >= n) break;
      const int64_t r = carry + pre[i];
      if (flag[i]) {
        const uint64_t key = kMaskX30 - anchor_x((uint64_t)ar[s]);
        src[r] = (key << 32) | (uint64_t)s;
        for (int p = 0; p < kPasses; p++)
          atomicAdd(&s_hist[p * kRadix
                            + (int)((key >> (p * kRadixBits)) & (kRadix - 1))],
                    1u);
      } else if (s - r < n_out) {
        ur[s - r] = (int32_t)s;
      }
    }
    carry += total;
    __syncthreads();  // scan_tmp is reused by the next tile
  }
  const uint32_t K = (uint32_t)carry;

  // phase 2: stable radix passes over src[0 .. K)
  for (int p = 0; p < kPasses; p++) {
    const uint32_t* h = s_hist + p * kRadix;
    bool one = false;  // one digit holds every item: the pass is the identity
    for (int d = 0; d < kRadix; d++) one |= h[d] == K;
    if (one) continue;  // block-uniform
    if (warp == 0) {
      const uint32_t v = h[lane];
      s_base[lane] = warp_inclusive_sum(v, lane) - v;
    }
    __syncthreads();
    const int shift = 32 + p * kRadixBits;
    for (uint32_t t0 = 0; t0 < K; t0 += kThreads * kItems) {
      for (int d = 0; d < kRadix; d++) s_cnt[d * kThreads + tid] = 0;
      uint64_t item[kItems];
      uint32_t lr[kItems];
      int dg[kItems];
      for (int i = 0; i < kItems; i++) {
        const uint32_t k = t0 + (uint32_t)tid * kItems + i;
        dg[i] = -1;
        if (k < K) {
          item[i] = src[k];
          dg[i] = (int)((item[i] >> shift) & (kRadix - 1));
          lr[i] = s_cnt[dg[i] * kThreads + tid]++;  // the thread's own column
        }
      }
      __syncthreads();
      // each digit's counts -> exclusive prefix across the threads
      for (int d = warp * kDigitsPerWarp; d < (warp + 1) * kDigitsPerWarp;
           d++) {
        uint32_t run = 0;
        for (int c = 0; c < kThreads; c += 32) {
          const uint32_t v = s_cnt[d * kThreads + c + lane];
          const uint32_t inc = warp_inclusive_sum(v, lane);
          s_cnt[d * kThreads + c + lane] = run + inc - v;
          run += __shfl_sync(kFull, inc, 31);
        }
        if (lane == 0) s_total[d] = run;
      }
      __syncthreads();
      for (int i = 0; i < kItems; i++)
        if (dg[i] >= 0)
          dst[s_base[dg[i]] + s_cnt[dg[i] * kThreads + tid] + lr[i]] = item[i];
      __syncthreads();
      if (tid < kRadix) s_base[tid] += s_total[tid];
      // the next tile's barrier after its counts orders this update before
      // its scatter
    }
    __syncthreads();  // the pass's global writes, before they are read
    uint64_t* t = src;
    src = dst;
    dst = t;
  }

  // phase 3: gather
  const int64_t nk = K < (uint32_t)n_out ? (int64_t)K : (int64_t)n_out;
  for (int64_t c = tid; c < nk; c += kThreads)
    orow[c] = ar[(uint32_t)(src[c] & 0xffffffffull)];
  for (int64_t c = nk + tid; c < n_out; c += kThreads) orow[c] = ar[ur[c - nk]];
  if (tid == 0) count[b] = (int32_t)(K < (uint32_t)n_max ? K : (uint32_t)n_max);
}

}  // namespace

extern "C" {

// The anchor sort on `stream`: anc (B, n) int64, keep (B, n) uint8 -> out
// (B, n_out) int64 with n_out = min(n_max, n), count (B,) int32. Scratch:
// buf_a, buf_b (B, n) uint64 and unk (B, n_out) int32. Returns the
// cudaError_t of the launch (0: launched).
int lt_sort_anchors(const int64_t* anc, const uint8_t* keep, int64_t B,
                    int64_t n, int n_out, int n_max, uint64_t* buf_a,
                    uint64_t* buf_b, int32_t* unk, int64_t* out,
                    int32_t* count, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  sort_anchors_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      anc, keep, n, n_out, n_max, buf_a, buf_b, unk, out, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
