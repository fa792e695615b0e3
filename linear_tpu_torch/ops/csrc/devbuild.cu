// DIndex build on the card for N-free genomes, for Hopper (sm_90a).
//
// Replaces linear_tpu/ops/devbuild.py:_sample_states and :_emit_count_sort,
// which the JAX package runs as two jitted XLA kernels (a gather + vectorised
// minimizer, then an associative max-scan, a scatter-add histogram, a cumsum
// and one lax.sort by (xval, cord)). The plain PyTorch versions beside them
// are linear_tpu_torch/ops/seeding.py:minimizer_xy_at and
// linear_tpu_torch/ops/devbuild.py:emit_count_sort_reference; the module
// docstring of the latter states the rules.
//
// What bounds it on the card: the 4^13-bucket tables. The histogram, the
// scan to `dir` and the per-bucket sort each stream the 268 MB int32 table
// about once (about 0.1 ms a pass at 3.35 TB/s); the samples (a ninth of the
// genome's positions) cost less. No step makes more than two passes.
//
// Design:
//   lt_sample_states    one thread per sampled position: the 21-base
//                       window, the GC-skew strand, the first minimum of
//                       nine 13-mer packs and the 4-base YValue.
//   lt_devbuild_count   (1) per tile of 1024 samples the largest run-start
//                       index; (2) one block scans the tile maxima, which
//                       carries the max-scan across tiles; (3) each tile's
//                       own max-scan plus its carry gives every sample its
//                       run start, and the emitted samples ((i - start) % q
//                       == 0) add one to their bucket with an atomic;
//                       (4) per tile of 4096 buckets the kept counts (0
//                       over omit_block) are summed and their maximum taken;
//                       (5) one block scans the tile sums; (6) each tile
//                       writes its exclusive scan one slot to the right, so
//                       that cur[x + 1] is bucket x's first entry; (7) each
//                       emitted sample's flag is cleared where its bucket is
//                       omitted. The histogram is free after this call.
//   lt_devbuild_scatter each kept sample claims slot atomicAdd(&cur[x + 1],
//                       1) of its bucket. Afterwards cur[x + 1] is the end
//                       of bucket x, i.e. the shifted cursor table is `dir`.
//                       Then one thread per bucket sorts its entries by cord
//                       value (insertion sort; a bucket holds at most
//                       omit_block entries).
// Every scan is written here with warp shuffles; nothing calls a library
// scan or sort.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 21;
constexpr int kWeight = 13;
constexpr int kNOff = kSpan - kWeight + 1;  // 9 minimizer candidates
constexpr uint64_t kMaskW = (1ull << (2 * kWeight)) - 1;
constexpr int kThreads = 1024;
constexpr int kPerThread = 4;  // buckets per thread in the bucket passes
constexpr int64_t kBucketTile = (int64_t)kThreads * kPerThread;
constexpr uint64_t kAnchorZero = 1ull << 20;

struct MaxOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int64_t operator()(int64_t a, int64_t b) const { return a + b; }
};

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32). Returns thread t's op over the values of threads < t
// (identity for t = 0); *total gets the whole block's. smem: 32 values.
template <typename Op>
__device__ int64_t block_exclusive_scan(int64_t v, Op op, int64_t identity,
                                        int64_t* smem, int64_t* total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int64_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl = op(u, incl);
  }
  int64_t ex = __shfl_up_sync(full, incl, 1);
  if (lane == 0) ex = identity;
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < n_warps ? smem[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t u = __shfl_up_sync(full, w, o);
      if (lane >= o) w = op(u, w);
    }
    smem[lane] = w;
  }
  __syncthreads();
  if (warp > 0) ex = op(smem[warp - 1], ex);
  *total = smem[n_warps - 1];
  __syncthreads();  // smem is reused by the caller's next scan
  return ex;
}

__global__ void __launch_bounds__(256)
sample_states_kernel(const uint8_t* __restrict__ genome, int64_t L,
                     const int64_t* __restrict__ j, int64_t P,
                     int64_t* __restrict__ xv, int64_t* __restrict__ yv,
                     int64_t* __restrict__ st) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int64_t k = j[i];
  auto base = [&](int64_t p) -> int { return p < 0 || p >= L ? 0 : genome[p]; };
  uint64_t h = 0, crh = 0;
  int sum = 0;
  for (int t = 0; t < kSpan; t++) {
    const int b = base(k + t);
    sum += b;
    h = (h << 2) | (uint64_t)b;
    crh |= (uint64_t)(3 - b) << (2 * t);
  }
  const bool fwd = 2 * sum - 3 * kSpan > 0;
  const uint64_t v = fwd ? h : crh;
  uint64_t best = kMaskW + 1;
  int tsel = 0;
  for (int idx = 0; idx < kNOff; idx++) {
    const uint64_t c = (v >> (2 * (kNOff - 1 - idx))) & kMaskW;
    if (c < best) {  // strict: the first minimum wins ties
      best = c;
      tsel = idx;
    }
  }
  int64_t y = 0;
  for (int t = 0; t < 4; t++) {
    const int b = fwd ? base(k + tsel + kWeight + t)
                      : 3 - base(k + kSpan - kWeight - 1 - tsel - t);
    y = (y << 2) + b;
  }
  xv[i] = (int64_t)best;
  yv[i] = y;
  st[i] = fwd ? 0 : 1;
}

// i where a run starts at sample i (a new xval or a block start), else 0
__device__ __forceinline__ int64_t run_start(const int64_t* __restrict__ xv,
                                             const uint8_t* __restrict__ bs,
                                             int64_t i) {
  return (i == 0 || bs[i] || xv[i] != xv[i - 1]) ? i : 0;
}

__global__ void __launch_bounds__(kThreads)
tile_max_kernel(const int64_t* __restrict__ xv, const uint8_t* __restrict__ bs,
                int64_t n, int64_t* __restrict__ tile_max) {
  __shared__ int64_t smem[32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t total;
  block_exclusive_scan(i < n ? run_start(xv, bs, i) : 0, MaxOp(), 0, smem,
                       &total);
  if (threadIdx.x == 0) tile_max[blockIdx.x] = total;
}

// One block: exclusive scan of vals[0..n) in place, 1024 at a time with a
// running carry; *total (when not null) gets the whole reduction.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(int64_t* __restrict__ vals, int64_t n, Op op,
                  int64_t identity, int64_t* __restrict__ total) {
  __shared__ int64_t smem[32];
  int64_t carry = identity;
  for (int64_t t0 = 0; t0 < n; t0 += kThreads) {
    const int64_t i = t0 + threadIdx.x;
    int64_t chunk;
    const int64_t ex = block_exclusive_scan(i < n ? vals[i] : identity, op,
                                            identity, smem, &chunk);
    if (i < n) vals[i] = op(carry, ex);
    carry = op(carry, chunk);
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const int64_t* __restrict__ xv, const uint8_t* __restrict__ bs,
            int64_t n, int64_t q, const int64_t* __restrict__ tile_carry,
            int64_t n_buckets, int32_t* __restrict__ counts,
            uint8_t* __restrict__ flag) {
  __shared__ int64_t smem[32];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t rs = i < n ? run_start(xv, bs, i) : 0;
  int64_t total;
  const int64_t ex = block_exclusive_scan(rs, MaxOp(), 0, smem, &total);
  if (i >= n) return;
  int64_t start = ex > rs ? ex : rs;
  const int64_t carry = tile_carry[blockIdx.x];
  start = start > carry ? start : carry;
  const int64_t x = xv[i];
  const bool emit = (i - start) % q == 0 && x >= 0 && x < n_buckets;
  flag[i] = emit ? 1 : 0;
  if (emit) atomicAdd(&counts[x], 1);
}

// the kept counts of the thread's kPerThread buckets (0 over omit_block)
__device__ __forceinline__ void kept_counts(const int32_t* __restrict__ counts,
                                            int64_t n_buckets, int64_t omit,
                                            int64_t x0, int64_t* kept) {
  for (int k = 0; k < kPerThread; k++) {
    const int64_t x = x0 + k;
    const int64_t c = x < n_buckets ? counts[x] : 0;
    kept[k] = c > omit ? 0 : c;
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_sum_kernel(const int32_t* __restrict__ counts, int64_t n_buckets,
                  int64_t omit, int64_t* __restrict__ tile_sum,
                  unsigned long long* __restrict__ max_kept) {
  __shared__ int64_t smem[32];
  const int64_t x0 = (int64_t)blockIdx.x * kBucketTile + threadIdx.x * kPerThread;
  int64_t kept[kPerThread], s = 0, mx = 0;
  kept_counts(counts, n_buckets, omit, x0, kept);
  for (int k = 0; k < kPerThread; k++) {
    s += kept[k];
    mx = kept[k] > mx ? kept[k] : mx;
  }
  int64_t total;
  block_exclusive_scan(s, SumOp(), 0, smem, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
  if (mx > 0) atomicMax(max_kept, (unsigned long long)mx);
}

__global__ void __launch_bounds__(kThreads)
bucket_offsets_kernel(const int32_t* __restrict__ counts, int64_t n_buckets,
                      int64_t omit, const int64_t* __restrict__ tile_off,
                      int32_t* __restrict__ cur) {
  __shared__ int64_t smem[32];
  const int64_t x0 = (int64_t)blockIdx.x * kBucketTile + threadIdx.x * kPerThread;
  int64_t kept[kPerThread], s = 0;
  kept_counts(counts, n_buckets, omit, x0, kept);
  for (int k = 0; k < kPerThread; k++) s += kept[k];
  int64_t total;
  int64_t off = tile_off[blockIdx.x] +
                block_exclusive_scan(s, SumOp(), 0, smem, &total);
  if (x0 == 0) cur[0] = 0;
  for (int k = 0; k < kPerThread && x0 + k < n_buckets; k++) {
    cur[x0 + k + 1] = (int32_t)off;
    off += kept[k];
  }
}

__global__ void __launch_bounds__(256)
drop_omitted_kernel(const int64_t* __restrict__ xv, int64_t n,
                    const int32_t* __restrict__ counts, int64_t omit,
                    uint8_t* __restrict__ flag) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && flag[i] && counts[xv[i]] > omit) flag[i] = 0;
}

__global__ void __launch_bounds__(256)
scatter_kernel(const int64_t* __restrict__ xv, const int64_t* __restrict__ yv,
               const int64_t* __restrict__ st, const int64_t* __restrict__ jj,
               const int64_t* __restrict__ gid, const uint8_t* __restrict__ flag,
               int64_t n, int32_t* __restrict__ cur,
               uint64_t* __restrict__ cords) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !flag[i]) return;
  const int slot = atomicAdd(&cur[xv[i] + 1], 1);
  cords[slot] = ((((uint64_t)gid[i] << 30) + ((uint64_t)jj[i] + kAnchorZero)) << 20) +
                (uint64_t)yv[i] + ((uint64_t)st[i] << 61);
}

__global__ void __launch_bounds__(256)
bucket_sort_kernel(const int32_t* __restrict__ dir, int64_t n_buckets,
                   uint64_t* __restrict__ cords) {
  const int64_t x = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_buckets) return;
  const int64_t lo = dir[x], hi = dir[x + 1];
  for (int64_t a = lo + 1; a < hi; a++) {
    const uint64_t v = cords[a];
    int64_t b = a - 1;
    while (b >= lo && cords[b] > v) {
      cords[b + 1] = cords[b];
      b--;
    }
    cords[b + 1] = v;
  }
}

unsigned blocks(int64_t n, int64_t per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

extern "C" {

// xv, yv, st (P,) int64 of the windows genome[j[i] .. j[i] + 21), genome
// (L,) uint8 codes 0..3. Returns the cudaError_t of the launch.
int lt_sample_states(const uint8_t* genome, int64_t L, const int64_t* j,
                     int64_t P, int64_t* xv, int64_t* yv, int64_t* st,
                     void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  sample_states_kernel<<<blocks(P, 256), 256, 0, (cudaStream_t)stream>>>(
      genome, L, j, P, xv, yv, st);
  return (int)cudaGetLastError();
}

// Emission, histogram and `dir` of n samples (xv (n,) int64, block starts
// bs (n,) uint8) over n_buckets buckets. counts (n_buckets,) int32 and
// stats (2,) int64 must be zero; tile_a (ceil(n / 1024),) and tile_b
// (ceil(n_buckets / 4096),) int64 are scratch. Writes flag (n,) uint8 (the
// sample is kept), cur (n_buckets + 1,) int32 (cur[x + 1] = first entry of
// bucket x), stats[0] = kept samples, stats[1] = largest kept bucket.
int lt_devbuild_count(const int64_t* xv, const uint8_t* bs, int64_t n,
                      int64_t q, int64_t omit, int32_t* counts,
                      int64_t n_buckets, int64_t* tile_a, int64_t* tile_b,
                      uint8_t* flag, int32_t* cur, int64_t* stats,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define LT_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const unsigned n_tiles = blocks(n, kThreads);
  const unsigned b_tiles = blocks(n_buckets, kBucketTile);
  if (n > 0) {
    tile_max_kernel<<<n_tiles, kThreads, 0, s>>>(xv, bs, n, tile_a);
    LT_CHECK();
    scan_tiles_kernel<<<1, kThreads, 0, s>>>(tile_a, (int64_t)n_tiles, MaxOp(),
                                            (int64_t)0, (int64_t*)nullptr);
    LT_CHECK();
    emit_kernel<<<n_tiles, kThreads, 0, s>>>(xv, bs, n, q, tile_a, n_buckets,
                                            counts, flag);
    LT_CHECK();
  }
  bucket_sum_kernel<<<b_tiles, kThreads, 0, s>>>(
      counts, n_buckets, omit, tile_b, (unsigned long long*)(stats + 1));
  LT_CHECK();
  scan_tiles_kernel<<<1, kThreads, 0, s>>>(tile_b, (int64_t)b_tiles, SumOp(),
                                          (int64_t)0, stats);
  LT_CHECK();
  bucket_offsets_kernel<<<b_tiles, kThreads, 0, s>>>(counts, n_buckets, omit,
                                                    tile_b, cur);
  LT_CHECK();
  if (n > 0) {
    drop_omitted_kernel<<<blocks(n, 256), 256, 0, s>>>(xv, n, counts, omit, flag);
    LT_CHECK();
  }
#undef LT_CHECK
  return (int)cudaSuccess;
}

// Counting-sort scatter of the kept samples into cords (stats[0],) uint64
// (cord = (gid << 30 | j + 2^20) << 20 | yval | strand << 61), turning cur
// into `dir`, then the sort of each bucket by cord value.
int lt_devbuild_scatter(const int64_t* xv, const int64_t* yv, const int64_t* st,
                        const int64_t* jj, const int64_t* gid,
                        const uint8_t* flag, int64_t n, int32_t* cur,
                        int64_t n_buckets, uint64_t* cords, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    scatter_kernel<<<blocks(n, 256), 256, 0, s>>>(xv, yv, st, jj, gid, flag, n,
                                                  cur, cords);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bucket_sort_kernel<<<blocks(n_buckets, 256), 256, 0, s>>>(cur, n_buckets,
                                                           cords);
  return (int)cudaGetLastError();
}

}  // extern "C"
