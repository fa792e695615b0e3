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
// What bounds it on the card: the one write of `dir`, 4^13 + 1 int32 (268 MB,
// about 80 us at 3.35 TB/s). The samples are few (a ninth of the genome's
// positions, ~0.5 M for 4.6 Mb), so no other pass may touch a 4^13-sized
// table: a histogram of the buckets costs a zeroing, a read and a scan of
// 268 MB each, and sorting each bucket in place costs one thread up to
// omit_block^2 / 4 dependent moves.
//
// Design: the order of hs is a stable sort of the emitted samples, in sample
// order, by the 27-bit key 2 * xval + strand. A cord is
// (gid << 30 | j + 2^20) << 20 | yval | strand << 61, the samples come in
// (gid, j) order and j is unique within a genome, so sample order within one
// (xval, strand) is cord order and yval never decides it.
//   lt_sample_states   one thread per sampled position: the 21-base window,
//                      the GC-skew strand, the first minimum of nine 13-mer
//                      packs and the 4-base YValue.
//   lt_devbuild        (1) emission, one block a tile of 1024 samples: the
//                      carry into the tile is the last run start before it
//                      (each tile's largest run start, then one block's
//                      exclusive max-scan of those), the tile's max-scan of
//                      run starts gives every sample its run start, and a
//                      sample is emitted where (i - start) % q == 0. The
//                      same kernel writes every sample's cord.
//                      (2) three stable LSD radix passes of 9 bits over the
//                      emitted samples' (key << 32 | sample index) words, in
//                      tiles of 2048: one warp a digit scans the tiles' digit
//                      counts, and the scatter ranks each word among the
//                      equal digits before it in its tile (__match_any_sync
//                      per 32 words, in index order), so ties keep sample
//                      order. The first pass reads the samples and drops the
//                      unemitted ones; each scatter counts the next pass's
//                      digits by the tile it writes into.
//                      (3) a bucket's count is the run length of its xval in
//                      the sorted words; a run over omit_block is dropped. A
//                      word finds its run's bounds by two binary searches
//                      within omit_block + 1 places of it, which tell a run
//                      longer than omit_block without reading all of it.
//                      (4) the kept words are compacted stably (a block scan
//                      a tile) into hs (the cords gathered by sample index)
//                      and their xvals; the kept runs give the largest bucket.
//                      (5) dir: per tile of 4096 buckets, the first kept
//                      entry at or past it comes from one pass over the kept
//                      xvals; a thread then fills four slots at a time from
//                      a binary search within its tile (int4 stores).
// No atomic decides an order (the digit counts and the largest-bucket
// maximum use atomics, whose result does not depend on their order), every
// scan is written here with warp shuffles, and nothing calls a library sort
// or scan. The host reads two scalars once, after every launch.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 21;
constexpr int kWeight = 13;
constexpr int kNOff = kSpan - kWeight + 1;  // 9 minimizer candidates
constexpr uint64_t kMaskW = (1ull << (2 * kWeight)) - 1;
constexpr int kThreads = 1024;              // emission and compaction tiles
constexpr uint64_t kAnchorZero = 1ull << 20;
// the radix sort: 27 key bits in three 9-bit digits, tiles of 2048 words
constexpr int kDigitBits = 9;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kPasses = 3;
constexpr int kSortThreads = 512;         // one thread a digit in the scans
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRounds = 4;                  // 32-item rounds a warp
constexpr int64_t kTile = (int64_t)kSortThreads * kRounds;
// dir: tiles of 4096 buckets, four slots a thread a round
constexpr int kDirTileBits = 12;
constexpr int kDirThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int64_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = op(u, incl);
  }
  int64_t ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) ex = identity;
  if (lane == 31) smem[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < n_warps ? smem[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t u = __shfl_up_sync(kFull, w, o);
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

// ------------------------------------------------------------- (1) emission

// i where a run starts at sample i (a new xval or a block start), else 0
__device__ __forceinline__ int64_t run_start(const int64_t* __restrict__ xv,
                                             const uint8_t* __restrict__ bs,
                                             int64_t i) {
  return (i == 0 || bs[i] || xv[i] != xv[i - 1]) ? i : 0;
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

// tile_max[b]: the largest run start in tile b of kThreads samples
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

// Emission of a tile of samples: tile_carry[b] is the last run start before
// tile b (the exclusive max-scan of tile_max; sample 0 starts a run), the
// tile's own max-scan of run starts does the rest. Also writes every
// sample's cord, which the compaction gathers.
__global__ void __launch_bounds__(kThreads)
emit_kernel(const int64_t* __restrict__ xv, const int64_t* __restrict__ yv,
            const int64_t* __restrict__ st, const int64_t* __restrict__ jj,
            const int64_t* __restrict__ gid, const uint8_t* __restrict__ bs,
            int64_t n, int64_t q, const int64_t* __restrict__ tile_carry,
            int64_t n_buckets, uint8_t* __restrict__ flag,
            uint64_t* __restrict__ cord) {
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
  flag[i] = ((i - start) % q == 0 && x >= 0 && x < n_buckets) ? 1 : 0;
  cord[i] = ((((uint64_t)gid[i] << 30) + ((uint64_t)jj[i] + kAnchorZero)) << 20) +
            (uint64_t)yv[i] + ((uint64_t)st[i] << 61);
}

// ----------------------------------------------------------- (2) radix sort

// The items of a pass: the samples (pass 0: an emitted sample i is the word
// (2 xval + strand) << 32 | i) or the previous pass's words (*m of them).
struct PassIn {
  const uint64_t* items;  // null in pass 0
  const int64_t* xv;
  const int64_t* st;
  const uint8_t* flag;
  int64_t n;              // samples
  const int64_t* m;       // words of passes 1, 2
};

__device__ __forceinline__ bool fetch(const PassIn& in, int64_t t,
                                      uint64_t* item) {
  if (in.items == nullptr) {
    if (t >= in.n || !in.flag[t]) return false;
    *item = ((uint64_t)(2 * in.xv[t] + in.st[t]) << 32) | (uint64_t)t;
    return true;
  }
  if (t >= *in.m) return false;
  *item = in.items[t];
  return true;
}

__device__ __forceinline__ int digit_of(uint64_t item, int pass) {
  return (int)((item >> (32 + kDigitBits * pass)) & (kDigits - 1));
}

// Pass 0's counts, hist[d * nb + b]: items of tile b with digit d. (The
// scatter of pass k counts pass k + 1's as it places the words.)
__global__ void __launch_bounds__(kSortThreads)
radix_count_kernel(PassIn in, int64_t nb, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kDigits];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t t0 = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; r++) {
    uint64_t it;
    if (fetch(in, t0 + r * kSortThreads + threadIdx.x, &it))
      atomicAdd(&h[digit_of(it, 0)], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * nb + blockIdx.x] = h[threadIdx.x];
}

// One warp a digit: hist[d * nb + b] becomes the items of digit d in tiles
// < b; totals[d] the digit's items. Zeroes the next pass's counts (next,
// when not null), which the scatter adds to.
__global__ void __launch_bounds__(256)
radix_scan_kernel(int32_t* __restrict__ hist, int64_t nb,
                  int32_t* __restrict__ totals, int32_t* __restrict__ next) {
  const int64_t d = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (d >= kDigits) return;
  int32_t* row = hist + d * nb;
  int32_t carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += 32) {
    const int64_t b = b0 + lane;
    const int32_t v = b < nb ? row[b] : 0;
    int32_t incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (b < nb) {
      row[b] = carry + incl - v;
      if (next != nullptr) next[d * nb + b] = 0;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) totals[d] = carry;
}

// Stable scatter of one pass. Warp w ranks the 128 items [t0 + 128 w,
// t0 + 128 (w + 1)) of the tile in index order, 32 at a time: an item's rank
// is the warp's count of its digit so far plus its equal-digit lanes below
// it. Its slot is the digit's base, the tile's prefix of that digit, the
// earlier warps' counts and its rank. Block 0 writes the item count to *m;
// each placed word adds one to next[its next digit][its slot's tile].
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(PassIn in, int pass, int64_t nb,
                     const int32_t* __restrict__ hist,
                     const int32_t* __restrict__ totals,
                     uint64_t* __restrict__ out, int64_t* __restrict__ m,
                     int32_t* __restrict__ next) {
  __shared__ int64_t smem[32];
  __shared__ int32_t base[kDigits];
  __shared__ int32_t wh[kSortWarps][kDigits + 1];  // bin kDigits: no item
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // the digits' bases: an exclusive scan of the totals, one a thread
  const int32_t tot = totals[tid];
  int64_t all;
  const int64_t ex = block_exclusive_scan(tot, SumOp(), 0, smem, &all);
  base[tid] = (int32_t)ex + hist[(int64_t)tid * nb + blockIdx.x];
  if (blockIdx.x == 0 && tid == 0 && m != nullptr) *m = all;
  for (int i = tid; i < kSortWarps * (kDigits + 1); i += kSortThreads)
    (&wh[0][0])[i] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  const int64_t t0 = (int64_t)blockIdx.x * kTile + (int64_t)w * 32 * kRounds;
  uint64_t item[kRounds];
  int dg[kRounds], rank[kRounds];
  for (int r = 0; r < kRounds; r++) {
    dg[r] = fetch(in, t0 + r * 32 + lane, &item[r]) ? digit_of(item[r], pass)
                                                     : kDigits;
    const unsigned peers = __match_any_sync(kFull, dg[r]);
    const int before = __popc(peers & lt);
    const int cur = wh[w][dg[r]];
    rank[r] = cur + before;
    __syncwarp();
    if (before == 0) wh[w][dg[r]] = cur + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {
    int32_t s = 0;
    for (int k = 0; k < kSortWarps; k++) {
      const int32_t v = wh[k][tid];
      wh[k][tid] = s;
      s += v;
    }
  }
  __syncthreads();
  for (int r = 0; r < kRounds; r++) {
    if (dg[r] == kDigits) continue;
    const int64_t slot = base[dg[r]] + wh[w][dg[r]] + rank[r];
    out[slot] = item[r];
    if (next != nullptr)
      atomicAdd(&next[(int64_t)digit_of(item[r], pass + 1) * nb + slot / kTile], 1);
  }
}

// -------------------------------------------- (3) bucket counts and omission

__device__ __forceinline__ int64_t xval_of(uint64_t item) {
  return (int64_t)(item >> 33);
}

// keep[t]: word t's bucket holds at most omit entries; the tile's kept count
// to tile_sum, the largest kept bucket to *largest.
__global__ void __launch_bounds__(kThreads)
omit_kernel(const uint64_t* __restrict__ items, const int64_t* __restrict__ m_p,
            int64_t omit, uint8_t* __restrict__ keep,
            int64_t* __restrict__ tile_sum,
            unsigned long long* __restrict__ largest) {
  __shared__ int64_t smem[32];
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t m = *m_p;
  int64_t k = 0, run = 0;
  if (t < m) {
    const int64_t x = xval_of(items[t]);
    // the run's bounds within [t - omit, t + omit + 1): exact for a run of
    // at most omit words, more than omit apart for a longer one
    int64_t lo = t - omit > 0 ? t - omit : 0, hi = t;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (xval_of(items[mid]) < x) lo = mid + 1;
      else hi = mid;
    }
    const int64_t first = lo;
    lo = t + 1;
    hi = t + omit + 1 < m ? t + omit + 1 : m;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (xval_of(items[mid]) <= x) lo = mid + 1;
      else hi = mid;
    }
    const int64_t len = lo - first;
    k = len <= omit ? 1 : 0;
    if (k && first == t) run = len;
    keep[t] = (uint8_t)k;
  }
  int64_t total;
  block_exclusive_scan(k, SumOp(), 0, smem, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
  block_exclusive_scan(run, MaxOp(), 0, smem, &total);
  if (threadIdx.x == 0 && total > 0)
    atomicMax(largest, (unsigned long long)total);
}

// ------------------------------------------------------- (4) the compaction

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint64_t* __restrict__ items, const int64_t* __restrict__ m_p,
               const uint8_t* __restrict__ keep,
               const int64_t* __restrict__ tile_off,
               const uint64_t* __restrict__ cord, uint64_t* __restrict__ hs,
               int32_t* __restrict__ kx) {
  __shared__ int64_t smem[32];
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool k = t < *m_p && keep[t];
  int64_t total;
  const int64_t slot = tile_off[blockIdx.x] +
                       block_exclusive_scan(k ? 1 : 0, SumOp(), 0, smem, &total);
  if (!k) return;
  const uint64_t item = items[t];
  hs[slot] = cord[item & 0xffffffffu];
  kx[slot] = (int32_t)xval_of(item);
}

// ---------------------------------------------------------------- (5) dir

// lo[b] = the kept entries with xval below tile b's first bucket, for b in
// [0, n_tiles]: entry k assigns the tiles after entry k - 1's up to its own.
__global__ void __launch_bounds__(256)
tile_lo_kernel(const int32_t* __restrict__ kx, const int64_t* __restrict__ stats,
               int64_t n_tiles, int32_t* __restrict__ lo) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t m = stats[0];
  if (k > m) return;
  const int64_t prev = k == 0 ? -1 : (int64_t)(kx[k - 1] >> kDirTileBits);
  const int64_t cur = k == m ? n_tiles : (int64_t)(kx[k] >> kDirTileBits);
  for (int64_t b = prev + 1; b <= cur; b++) lo[b] = (int32_t)k;
}

// dir[x] = kept entries with xval < x, for x in [0, n_slots)
__global__ void __launch_bounds__(kDirThreads)
dir_kernel(const int32_t* __restrict__ kx, const int32_t* __restrict__ lo,
           int64_t n_slots, int32_t* __restrict__ dir) {
  const int64_t x0 = (int64_t)blockIdx.x << kDirTileBits;
  const int32_t l = lo[blockIdx.x], h = lo[blockIdx.x + 1];
  for (int r = 0; r < (1 << kDirTileBits) / (4 * kDirThreads); r++) {
    const int64_t x = x0 + 4 * (r * kDirThreads + threadIdx.x);
    if (x >= n_slots) return;
    int32_t a = l, c = h;
    while (a < c) {
      const int32_t mid = (a + c) >> 1;
      if (kx[mid] < x) a = mid + 1;
      else c = mid;
    }
    int32_t v[4];
    v[0] = a;
    for (int i = 1; i < 4; i++) {
      while (a < h && kx[a] < x + i) a++;
      v[i] = a;
    }
    if (x + 3 < n_slots) {
      *reinterpret_cast<int4*>(dir + x) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < 4 && x + i < n_slots; i++) dir[x + i] = v[i];
    }
  }
}

unsigned blocks(int64_t n, int64_t per) { return (unsigned)((n + per - 1) / per); }

// The scratch of lt_devbuild for n samples and n_buckets buckets, carved from
// the address base in 8-byte-aligned buffers; words is its size in 8-byte
// words (base 0 gives the size alone).
struct Scratch {
  int64_t n_tiles, nb, dir_tiles;   // emission tiles, sort tiles, dir tiles
  uint64_t *buf_a, *buf_b, *cord;   // the sort's two word buffers, cords
  int64_t *tile_sum, *count;        // per emission tile; the emitted words
  uint8_t *flag, *keep;             // emitted, kept (a sample, a word)
  int32_t *kx, *hist[2], *totals;   // kept xvals; digit counts and totals
  int32_t* lo;                      // first kept entry of each dir tile
  int64_t words;
};

Scratch carve(uintptr_t base, int64_t n, int64_t n_buckets) {
  Scratch c;
  c.n_tiles = (n + kThreads - 1) / kThreads;
  c.nb = (n + kTile - 1) / kTile;
  c.dir_tiles = (n_buckets + 1 + (1 << kDirTileBits) - 1) >> kDirTileBits;
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    const uintptr_t p = base + (uintptr_t)off;
    off += (bytes + 7) / 8 * 8;
    return p;
  };
  c.buf_a = (uint64_t*)take(8 * n);
  c.buf_b = (uint64_t*)take(8 * n);
  c.cord = (uint64_t*)take(8 * n);
  c.tile_sum = (int64_t*)take(8 * c.n_tiles);
  c.count = (int64_t*)take(8);
  c.flag = (uint8_t*)take(n);
  c.keep = (uint8_t*)take(n);
  c.kx = (int32_t*)take(4 * n);
  c.hist[0] = (int32_t*)take(4 * (int64_t)kDigits * c.nb);
  c.hist[1] = (int32_t*)take(4 * (int64_t)kDigits * c.nb);
  c.totals = (int32_t*)take(4 * kDigits);
  c.lo = (int32_t*)take(4 * (c.dir_tiles + 1));
  c.words = off / 8;
  return c;
}

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

// Words of scratch (in 8-byte units) that lt_devbuild needs for n samples
// and n_buckets buckets.
int64_t lt_devbuild_scratch_words(int64_t n, int64_t n_buckets) {
  return carve(0, n, n_buckets).words;
}

// The emission, stable radix sort, omission and compaction of n samples
// (xv, yv, st, jj, gid (n,) int64, block starts bs (n,) uint8) into
// dir (n_buckets + 1,) int32, hs (at least n,) uint64 (its first stats[0]
// entries are the table) and stats (2,) int64: stats[0] = kept samples,
// stats[1] = largest kept bucket. scratch holds
// lt_devbuild_scratch_words(n, n_buckets) words. Returns the cudaError_t of
// the first refused launch (0: all launched).
int lt_devbuild(const int64_t* xv, const int64_t* yv, const int64_t* st,
                const int64_t* jj, const int64_t* gid, const uint8_t* bs,
                int64_t n, int64_t q, int64_t omit, int64_t n_buckets,
                uint64_t* scratch, int32_t* dir, uint64_t* hs, int64_t* stats,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define LT_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  const Scratch c = carve((uintptr_t)scratch, n, n_buckets);
  const int64_t n_tiles = c.n_tiles, nb = c.nb;
  if ((err = cudaMemsetAsync(stats, 0, 2 * sizeof(int64_t), s)) != cudaSuccess)
    return (int)err;
  if (n > 0) {
    tile_max_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(xv, bs, n,
                                                          c.tile_sum);
    LT_CHECK();
    scan_tiles_kernel<<<1, kThreads, 0, s>>>(c.tile_sum, n_tiles, MaxOp(),
                                            (int64_t)0, (int64_t*)nullptr);
    LT_CHECK();
    emit_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        xv, yv, st, jj, gid, bs, n, q, c.tile_sum, n_buckets, c.flag, c.cord);
    LT_CHECK();
    uint64_t* bufs[2] = {c.buf_a, c.buf_b};
    int32_t* const* hist = c.hist;
    const PassIn in0{nullptr, xv, st, c.flag, n, c.count};
    radix_count_kernel<<<(unsigned)nb, kSortThreads, 0, s>>>(in0, nb, hist[0]);
    LT_CHECK();
    for (int pass = 0; pass < kPasses; pass++) {
      const PassIn in = pass == 0 ? in0
                                  : PassIn{bufs[(pass + 1) & 1], xv, st,
                                           c.flag, n, c.count};
      int32_t* next = pass + 1 < kPasses ? hist[(pass + 1) & 1] : nullptr;
      radix_scan_kernel<<<kDigits * 32 / 256, 256, 0, s>>>(hist[pass & 1], nb,
                                                          c.totals, next);
      LT_CHECK();
      radix_scatter_kernel<<<(unsigned)nb, kSortThreads, 0, s>>>(
          in, pass, nb, hist[pass & 1], c.totals, bufs[pass & 1],
          pass == 0 ? c.count : nullptr, next);
      LT_CHECK();
    }
    const uint64_t* sorted = bufs[(kPasses - 1) & 1];
    omit_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        sorted, c.count, omit, c.keep, c.tile_sum,
        (unsigned long long*)(stats + 1));
    LT_CHECK();
    scan_tiles_kernel<<<1, kThreads, 0, s>>>(c.tile_sum, n_tiles, SumOp(),
                                            (int64_t)0, stats);
    LT_CHECK();
    compact_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        sorted, c.count, c.keep, c.tile_sum, c.cord, hs, c.kx);
    LT_CHECK();
  }
  tile_lo_kernel<<<blocks(n + 1, 256), 256, 0, s>>>(c.kx, stats, c.dir_tiles,
                                                    c.lo);
  LT_CHECK();
  dir_kernel<<<(unsigned)c.dir_tiles, kDirThreads, 0, s>>>(c.kx, c.lo,
                                                          n_buckets + 1, dir);
  LT_CHECK();
#undef LT_CHECK
  return (int)cudaSuccess;
}

}  // extern "C"
