// The anchor sort of the mesh mapping step, for Hopper (sm_90a).
//
// Replaces the sort lines of two jitted XLA bodies of
// linear_tpu/parallel/mesh.py: mapping_step (:44-52) and sort_chain (:285)
// inside grid_mapping_step: key = keep ? -anchor_x : 1 << 62, a stable
// argsort of each row of the flattened (B, P * cap) seeding grid, the first
// n_max columns, take_along_axis. The plain PyTorch version beside it is
// linear_tpu_torch/ops/chain_dp.py: sort_anchors_reference, and
// sort_anchors_chunked there states this kernel's decomposition. Outputs
// are identical on every element: out (B, min(n_max, n)) holds each row's
// kept anchors in descending anchor-x order, ties by the lower flat index,
// then, where fewer than n_max are kept, the row's first unkept slots in
// flat order with whatever they hold; count is min(kept, n_max).
//
// What bounds it on the card: bytes. The keep flags are read once (a byte a
// slot; 49 MB at (256, 191,488)), the kept anchors once, the output written
// once. Kept slots are ~0.1 % of the corpus grid, so the flags are the work.
//
// Design: two launches.
//   1  The flag pass: a block of 256 threads for each chunk of kChunk
//      (16,384) flags of a row, B * ceil(n / kChunk) blocks (3,072 at
//      (256, 191,488): several waves over the 132 SMs). A thread loads
//      four 16-flag windows, a warp's 512 contiguous bytes at a time, all
//      issued before any is used; the windows are aligned to 16 bytes in
//      memory, so a row whose base is not aligned (a `keep` view, or n not
//      a multiple of 16) loads only its ragged head and tail byte by byte
//      (the first thread takes a fifth window). A chunk with nothing kept
//      stops at a __syncthreads_or; otherwise one block scan of the
//      threads' kept counts gives every kept slot its place in the chunk's
//      region of the scratch, as the distinct 62-bit composite (kMaskX30 -
//      anchor_x) << 32 | flat index. The chunk's kept count goes beside it.
//   2  The row's sort: a block of 256 threads a row. It scans the chunk
//      counts and gathers the row's K items by them, spread flat over the
//      threads (a binary search of the chunk offsets). Ascending order of
//      the composites is exactly JAX's stable argsort of the keys. A
//      bitonic network in which every comparator puts the smaller item at
//      the lower index (the first stage of each merge compares mirrored
//      pairs) sorts them, its length padded to a power of two with
//      implicit +inf: a comparator whose upper index is >= K never moves
//      anything, so it is skipped and nothing past K is stored.
//      K <= kRegItems (1,024; a corpus row keeps at most ~600) items run
//      the network in registers, four a thread: pairs inside a thread swap
//      there, pairs inside a warp meet by shuffles, and only the stages of
//      half >= 128 pass through shared memory (on an H100 the shared-memory
//      network's 55 stages at 1,024 took 15 of this kernel's 22 µs).
//      Larger rows (up to the hand-built all-kept row, 191,488 items)
//      compact their items in place at the start of the row's scratch and
//      run the same network there: stages whose pairs lie inside one kTile
//      (8,192) tile run tile by tile in 64 KB of dynamic shared memory, the
//      wider ones in place in global memory (which the L2 holds: 1.5 MB a
//      row). The first min(K, n_out) items' flat indices gather the
//      anchors; when K < n_out the unkept fill walks the chunks in order by
//      their unkept counts
//      (length less kept), re-reads the flags of only the chunks it needs,
//      lists each round's unkept slots in shared memory by a block scan
//      and writes their anchors out coalesced.
//   Two launches rather than the last chunk block of a row taking over the
//   sort: the sort block's 64 KB of shared memory would be reserved by
//   every flag block too, and hold the flag pass to three blocks an SM.
// Scratch (the wrapper allocates it, lt_sort_anchors_scratch_bytes):
// B * n * 8 bytes of items (each chunk's region as long as the chunk; rows
// past kRegItems need the whole row in place) plus B * ceil(n / kChunk) * 4
// bytes of chunk counts: 392,167,424 + 12,288 bytes at (256, 191,488).
// n < 2^31 (the wrapper checks it).
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kMaskX30 = (1ull << 30) - 1;
constexpr uint64_t kValueMaskDstr = ((1ull << 60) - 1) | (1ull << 61);

constexpr int kThreads = 256;
constexpr int kWin = 4;                        // 16-byte windows a thread
constexpr int kChunk = kThreads * kWin * 16;   // 16,384 flags a flag block
constexpr int kRound = kThreads * 16;          // flags a fill round
constexpr int kTile = 8192;                    // items sorted in shared memory
constexpr int kTileBytes = kTile * 8;          // 64 KB, dynamic
constexpr int kChunkTile = kThreads;           // chunk counts scanned a time
constexpr int kRegItems = kThreads * 4;        // rows sorted in registers
constexpr unsigned kFull = 0xffffffffu;

// getAnchorX (src/cords.cpp:463): the 64-bit add may pass bit 63; it wraps
// as uint64 and the mask clears the high bits
__device__ __forceinline__ uint64_t anchor_x(uint64_t a) {
  const uint64_t v = (a + ((a & kMaskY) << 20) - (1ull << 40)) & kValueMaskDstr;
  return (v >> 20) & kMaskX30;
}

// high bit of each non-zero byte of x
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// 16 flags of a row from the 16-byte window at `p` (16-aligned): one load
// when the window lies inside [lo, hi), else byte loads of its part inside
__device__ __forceinline__ uint4 load_window(uintptr_t p, uintptr_t lo,
                                             uintptr_t hi) {
  if (p >= lo && p + 16 <= hi) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0, 0, 0, 0};
  for (int i = 0; i < 16; i++) {
    const uintptr_t q = p + i;
    if (q >= lo && q < hi)
      w[i >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(q)
                   << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kThreads)
sort_flags_kernel(const int64_t* __restrict__ anc,
                  const uint8_t* __restrict__ keep, int64_t n,
                  int64_t n_chunks, uint64_t* __restrict__ items,
                  int32_t* __restrict__ chunk_kept) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  const int tid = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x / n_chunks;
  const int64_t c = (int64_t)blockIdx.x % n_chunks;
  const int64_t s = c * kChunk;
  const int64_t e = s + kChunk < n ? s + kChunk : n;
  const uint8_t* kr = keep + b * n;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(kr + s);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(kr + e);
  const uintptr_t a0 = lo & ~(uintptr_t)15;
  const int n_win = (int)((hi - a0 + 15) >> 4);
  // the thread's windows j = r * kThreads + tid, r < kWin (coalesced), and
  // for the first thread also the one past kChunk / 16 that a misaligned
  // chunk has. The kept items of a chunk go to its region in any order:
  // the composites are distinct, so the sort needs no order among them.
  uint32_t m[kWin + 1][4];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r <= kWin; r++) {
    const int j = r < kWin ? r * kThreads + tid
                           : (tid ? n_win : kWin * kThreads);
    const uint4 w = j < n_win
                        ? load_window(a0 + 16 * (uintptr_t)j, lo, hi)
                        : make_uint4(0, 0, 0, 0);
    m[r][0] = nonzero_bytes(w.x);
    m[r][1] = nonzero_bytes(w.y);
    m[r][2] = nonzero_bytes(w.z);
    m[r][3] = nonzero_bytes(w.w);
    cnt += __popc(m[r][0]) + __popc(m[r][1]) + __popc(m[r][2])
           + __popc(m[r][3]);
  }
  int off = 0, total = 0;
  if (__syncthreads_or(cnt))  // block-uniform: most chunks keep something
    BlockScan(scan_tmp).ExclusiveSum(cnt, off, total);
  if (cnt) {
    const int64_t* ar = anc + b * n;
    uint64_t* reg = items + b * n + s;
    // flat index within the row of the first byte of window 0
    const int64_t f_a0 = (int64_t)a0 - (int64_t)reinterpret_cast<uintptr_t>(kr);
#pragma unroll
    for (int r = 0; r <= kWin; r++) {
      const int j = r < kWin ? r * kThreads + tid : kWin * kThreads;
#pragma unroll
      for (int q = 0; q < 4; q++) {
        uint32_t mq = m[r][q];
        while (mq) {
          const int bit = __ffs(mq) - 1;
          mq &= mq - 1;
          const int64_t f = f_a0 + 16 * (int64_t)j + 4 * q + (bit >> 3);
          const uint64_t key = kMaskX30 - anchor_x((uint64_t)ar[f]);
          reg[off++] = (key << 32) | (uint64_t)f;
        }
      }
    }
  }
  if (tid == 0) chunk_kept[b * n_chunks + c] = total;
}

// one comparator: the smaller of a[lo], a[hi] to a[lo]
__device__ __forceinline__ void cmp_swap(uint64_t* a, int64_t lo, int64_t hi) {
  const uint64_t x = a[lo], y = a[hi];
  if (x > y) {
    a[lo] = y;
    a[hi] = x;
  }
}

// One stage of the network over items [base, base + K) of `a` (shared or
// global memory): pairs of span 2 * half; `flip` pairs mirrored indices
// (the merge's first stage), else lo with lo + half. Pairs whose upper
// index reaches K are skipped (+inf there). No barrier.
__device__ __forceinline__ void network_stage(uint64_t* a, int64_t K,
                                              int64_t half, bool flip,
                                              int tid) {
  // half is a power of two; only blocks that start below K hold pairs
  const int lg = __ffsll(half) - 1;
  const int64_t n_pairs = ((K + 2 * half - 1) >> (lg + 1)) << lg;
  for (int64_t t = tid; t < n_pairs; t += kThreads) {
    const int64_t start = (t >> lg) << (lg + 1), o = t & (half - 1);
    const int64_t lo = start + o;
    const int64_t hi = flip ? start + 2 * half - 1 - o : lo + half;
    if (hi < K) cmp_swap(a, lo, hi);
  }
}

// After a stage: a stage of half <= 32 pairs t of a warp (32 consecutive t
// a turn of the thread loop) only with elements [64 w, 64 w + 64) of each
// 512, the same for every such stage, so between two of them a warp
// barrier is enough; next to a wider stage the block waits.
__device__ __forceinline__ void stage_sync(int64_t half, int64_t next_half) {
  if (half > 32 || next_half > 32) __syncthreads();
  else __syncwarp();
}

// the whole network for N (a power of two >= K) on s[0 .. K) in shared
// memory: every merge size 2 .. N, its mirrored stage, then its
// half-cleaners; the block waits at the end
__device__ void tile_sort(uint64_t* s, int64_t K, int64_t N, int tid) {
  for (int64_t size = 2; size <= N; size <<= 1) {
    network_stage(s, K, size >> 1, true, tid);
    stage_sync(size >> 1, size >= 4 ? size >> 2 : size);
    for (int64_t half = size >> 2; half >= 1; half >>= 1) {
      network_stage(s, K, half, false, tid);
      stage_sync(half, half > 1 ? half >> 1 : size);
    }
  }
  __syncthreads();
}

// the half-cleaners of spans 2 * top_half .. 2 on s[0 .. K): the rest of a
// merge whose wider stages ran in global memory; the block waits at the end
__device__ void tile_cleaners(uint64_t* s, int64_t K, int64_t top_half,
                              int tid) {
  for (int64_t half = top_half; half >= 1; half >>= 1) {
    network_stage(s, K, half, false, tid);
    stage_sync(half, half >> 1);
  }
  __syncthreads();
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(kFull, (uint32_t)v, mask);
  const uint32_t hi = __shfl_xor_sync(kFull, (uint32_t)(v >> 32), mask);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ void cmp_swap_reg(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// The same network for rows of K <= kRegItems items, each thread holding
// positions 4 tid .. 4 tid + 3 in registers (+inf past K): a comparator of
// a stage pairs position p with p ^ pm, pm = 2 half - 1 for the mirrored
// stage, half for a half-cleaner, p being the lower when p & half is 0.
// Partners in the same thread swap in registers, in the same warp by
// shuffles, farther ones through shared memory (s, kRegItems items).
__device__ void register_sort(uint64_t (&x)[4], int64_t N, uint64_t* s,
                              int tid) {
  for (int64_t size = 2; size <= N; size <<= 1) {
    for (int64_t half = size >> 1; half >= 1; half >>= 1) {
      const bool flip = half == size >> 1;
      const int64_t pm = flip ? 2 * half - 1 : half;
      const int64_t tm = pm >> 2;
      if (tm == 0) {  // half 1 or 2: inside the thread
        if (pm == 1) {
          cmp_swap_reg(x[0], x[1]);
          cmp_swap_reg(x[2], x[3]);
        } else if (pm == 2) {
          cmp_swap_reg(x[0], x[2]);
          cmp_swap_reg(x[1], x[3]);
        } else {  // pm 3
          cmp_swap_reg(x[0], x[3]);
          cmp_swap_reg(x[1], x[2]);
        }
        continue;
      }
      const bool lower = ((4 * (int64_t)tid) & half) == 0;
      uint64_t y[4];
      if (tm < 32) {  // a warp: register i meets the partner's i ^ (pm & 3)
        if (flip) {
#pragma unroll
          for (int i = 0; i < 4; i++) y[i] = shfl_xor64(x[3 - i], (int)tm);
        } else {
#pragma unroll
          for (int i = 0; i < 4; i++) y[i] = shfl_xor64(x[i], (int)tm);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; i++) s[4 * tid + i] = x[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; i++) y[i] = s[(4 * tid + i) ^ pm];
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; i++)
        x[i] = lower ? (x[i] < y[i] ? x[i] : y[i])
                     : (x[i] < y[i] ? y[i] : x[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sort_rows_kernel(const int64_t* __restrict__ anc,
                 const uint8_t* __restrict__ keep, int64_t n,
                 int64_t n_chunks, int n_out, int n_max, uint64_t* items,
                 const int32_t* __restrict__ chunk_kept,
                 int64_t* __restrict__ out, int32_t* __restrict__ count) {
  using BlockScan = cub::BlockScan<int64_t, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int64_t s_off[kChunkTile];
  extern __shared__ uint64_t s_items[];  // kTile items
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t* ar = anc + b * n;
  const uint8_t* kr = keep + b * n;
  uint64_t* row = items + b * n;
  const int32_t* ck = chunk_kept + b * n_chunks;
  int64_t* orow = out + b * (int64_t)n_out;

  // the fill's first two rounds of flags (chunk 0), loaded ahead: the fill
  // mostly needs no more
  const bool fill_ahead = (reinterpret_cast<uintptr_t>(kr) & 15) == 0;
  uint4 ahead[2];
#pragma unroll
  for (int r = 0; r < 2; r++) {
    const int64_t f0 = (int64_t)r * kRound + 16 * (int64_t)tid;
    ahead[r] = fill_ahead && f0 + 16 <= (n < kChunk ? n : kChunk)
                   ? *reinterpret_cast<const uint4*>(kr + f0)
                   : make_uint4(0, 0, 0, 0);
  }
  // K: the row's kept items; the first tile of chunk counts is scanned once
  // for K and the gather's offsets
  int64_t K = 0, tot0 = 0;
  {
    int64_t v = tid < n_chunks ? ck[tid] : 0, pre;
    BlockScan(scan_tmp).ExclusiveSum(v, pre, tot0);
    s_off[tid] = pre;
    K = tot0;
    __syncthreads();
  }
  for (int64_t c0 = kChunkTile; c0 < n_chunks; c0 += kChunkTile) {
    const int64_t c = c0 + tid;
    int64_t v = c < n_chunks ? ck[c] : 0, pre, tot;
    BlockScan(scan_tmp).ExclusiveSum(v, pre, tot);
    K += tot;
    __syncthreads();
  }
  const bool in_regs = K <= kRegItems;
  // gather the items by the chunk counts, in chunk order: into shared memory,
  // or in place to the start of the row (every item moves to a lower or the
  // same index, and a round reads all of its items before it writes any)
  int64_t base = 0;  // block-uniform: items of earlier chunk tiles
  for (int64_t c0 = 0; c0 < n_chunks; c0 += kChunkTile) {
    int64_t tot = tot0;
    if (c0) {
      const int64_t c = c0 + tid;
      int64_t v = c < n_chunks ? ck[c] : 0, pre;
      BlockScan(scan_tmp).ExclusiveSum(v, pre, tot);
      s_off[tid] = pre;
      __syncthreads();
    }
    const int n_c = (int)(n_chunks - c0 < kChunkTile ? n_chunks - c0
                                                     : kChunkTile);
    for (int64_t i0 = 0; i0 < tot; i0 += kThreads) {
      const int64_t i = i0 + tid;
      uint64_t v_item = 0;
      if (i < tot) {
        int lo = 0, hi = n_c;  // the last chunk j with s_off[j] <= i
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_off[mid] <= i) lo = mid;
          else hi = mid;
        }
        v_item = row[(c0 + lo) * kChunk + (i - s_off[lo])];
      }
      if (in_regs) {
        if (i < tot) s_items[base + i] = v_item;
      } else {
        __syncthreads();
        if (i < tot) row[base + i] = v_item;
      }
    }
    base += tot;
    __syncthreads();
  }

  int64_t N = 1;
  while (N < K) N <<= 1;
  const int64_t nk = K < n_out ? K : n_out;
  if (in_regs) {
    uint64_t x[4];
#pragma unroll
    for (int i = 0; i < 4; i++)
      x[i] = 4 * tid + i < K ? s_items[4 * tid + i] : ~0ull;
    __syncthreads();  // s_items is the wide stages' exchange from here
    register_sort(x, N, s_items, tid);
#pragma unroll
    for (int i = 0; i < 4; i++)
      if (4 * tid + i < nk)
        orow[4 * tid + i] = ar[(uint32_t)(x[i] & 0xffffffffull)];
  } else {
    // tiles of kTile sorted in shared memory, then each wider merge: its
    // stages of span > kTile in place in global memory, the rest tile by tile
    for (int64_t t0 = 0; t0 < K; t0 += kTile) {
      const int64_t kt = K - t0 < kTile ? K - t0 : kTile;
      for (int64_t i = tid; i < kt; i += kThreads) s_items[i] = row[t0 + i];
      __syncthreads();
      tile_sort(s_items, kt, N < kTile ? N : kTile, tid);
      for (int64_t i = tid; i < kt; i += kThreads) row[t0 + i] = s_items[i];
      __syncthreads();
    }
    for (int64_t size = 2 * kTile; size <= N; size <<= 1) {
      network_stage(row, K, size >> 1, true, tid);
      __syncthreads();
      for (int64_t half = size >> 2; half >= kTile; half >>= 1) {
        network_stage(row, K, half, false, tid);
        __syncthreads();
      }
      for (int64_t t0 = 0; t0 < K; t0 += kTile) {
        const int64_t kt = K - t0 < kTile ? K - t0 : kTile;
        for (int64_t i = tid; i < kt; i += kThreads) s_items[i] = row[t0 + i];
        __syncthreads();
        tile_cleaners(s_items, kt, kTile >> 1, tid);
        for (int64_t i = tid; i < kt; i += kThreads) row[t0 + i] = s_items[i];
        __syncthreads();
      }
    }
    for (int64_t c = tid; c < nk; c += kThreads)
      orow[c] = ar[(uint32_t)(row[c] & 0xffffffffull)];
  }
  if (tid == 0) count[b] = (int32_t)(K < n_max ? K : n_max);
  if (K >= n_out) return;

  // the unkept fill: columns K .. n_out take the row's unkept slots in flat
  // order; chunks by their unkept counts, flags re-read only where needed.
  // A round's unkept flat indices go in order to shared memory (a block
  // scan), then the block writes their anchors out, coalesced.
  int32_t* s_unk = reinterpret_cast<int32_t*>(s_items);  // kRound of them
  __syncthreads();  // the wide stages' reads of s_items are done
  const int64_t need = n_out - K;
  int64_t filled = 0;  // block-uniform
  for (int64_t c = 0; c < n_chunks && filled < need; c++) {
    const int64_t s = c * kChunk;
    const int64_t e = s + kChunk < n ? s + kChunk : n;
    if (e - s == ck[c]) continue;  // nothing unkept here
    for (int64_t r0 = s; r0 < e && filled < need; r0 += kRound) {
      const int64_t f0 = r0 + 16 * (int64_t)tid;
      uint32_t um = 0;  // bit i: flag f0 + i is an unkept slot
      if (f0 + 16 <= e
          && (reinterpret_cast<uintptr_t>(kr + f0) & 15) == 0) {
        const uint4 v = c == 0 && r0 < 2 * kRound
                            ? (r0 == 0 ? ahead[0] : ahead[1])
                        : *reinterpret_cast<const uint4*>(kr + f0);
        const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 16; i++)
          if (!((q[i >> 2] >> (8 * (i & 3))) & 0xff)) um |= 1u << i;
      } else {
        for (int i = 0; i < 16; i++)
          if (f0 + i < e && !kr[f0 + i]) um |= 1u << i;
      }
      int64_t off, total;
      BlockScan(scan_tmp).ExclusiveSum((int64_t)__popc(um), off, total);
      int o = (int)off;
      while (um) {
        const int i = __ffs(um) - 1;
        um &= um - 1;
        s_unk[o++] = (int32_t)(f0 + i);
      }
      __syncthreads();
      const int64_t take = need - filled < total ? need - filled : total;
      for (int64_t j = tid; j < take; j += kThreads)
        orow[K + filled + j] = ar[s_unk[j]];
      filled += total;
      __syncthreads();  // s_unk and scan_tmp are reused by the next round
    }
  }
}

}  // namespace

extern "C" {

// Scratch bytes of a launch at (B, n): the items, then the chunk counts.
int64_t lt_sort_anchors_scratch_bytes(int64_t B, int64_t n) {
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  return B * n * 8 + B * n_chunks * 4;
}

// The anchor sort on `stream`: anc (B, n) int64, keep (B, n) uint8 -> out
// (B, n_out) int64 with n_out = min(n_max, n), count (B,) int32; scratch of
// lt_sort_anchors_scratch_bytes(B, n), 8-byte aligned. Returns the
// cudaError_t of the launches (0: launched).
int lt_sort_anchors(const int64_t* anc, const uint8_t* keep, int64_t B,
                    int64_t n, int n_out, int n_max, void* scratch,
                    int64_t* out, int32_t* count, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  if (n < 0 || B * n_chunks > 0x7fffffff || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // the sort block's 64 KB of dynamic shared memory, once a device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64 || !attr_set[dev]) {
    rc = cudaFuncSetAttribute(sort_rows_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTileBytes);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) attr_set[dev] = true;
  }
  uint64_t* items = static_cast<uint64_t*>(scratch);
  int32_t* chunk_kept = reinterpret_cast<int32_t*>(items + B * n);
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_chunks) {
    sort_flags_kernel<<<(unsigned)(B * n_chunks), kThreads, 0, st>>>(
        anc, keep, n, n_chunks, items, chunk_kept);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  sort_rows_kernel<<<(unsigned)B, kThreads, kTileBytes, st>>>(
      anc, keep, n, n_chunks, n_out, n_max, items, chunk_kept, out, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
