// Gap-interval anchors (the 9-mer seeding stage of the gap module) for
// Hopper (sm_90a).
//
// Replaces linear_tpu/ops/gap_dev.py:76 _gap_anchors_kernel (with
// _stream_vals, :56), which the JAX package runs through
// batch_gap_anchors (:144) as one jitted XLA program: canonical 9-mer
// streams of a genome window (every fifth position from rel 4) and a read
// window (every position), a sort of the genome entries, a searchsorted
// cross product that keeps the first `cap` genome entries of each read
// 9-mer's val group, g_hs_set_anchor with the direction-0 bounds, and an
// argsort of a 46-bit emission key (val, g_std, g_rel, r_std, r_rel) over
// all r_max * cap slots to put the kept anchors in host order. The plain
// PyTorch version beside it is
// linear_tpu_torch/ops/gap_dev.py:gap_anchors_reference, and
// gap_anchors_filtered there states this kernel's filtered formulation.
//
// What bounds it on the card: per item, two small sorts and a scan over the
// candidate pairs, each a few barriers deep; the bytes (the windows in,
// 16 bytes a kept anchor out) are small. Items are independent, and 512
// items fill the card's 132 SMs in one wave, so an item's own instructions
// and barriers are the time.
//
// Design (one block an item that bitonic-sorted all 1,024 genome slots and
// all 4,096 read slots in shared memory, a barrier a stage, measured 0.1655
// ms for 512 items): one block an item, its tables in shared memory (~39 KB):
//   1. the genome entries val<<33 | std<<30 | pos of the samples (g_max <=
//      1024), four consecutive ones a thread in registers, each setting the
//      bit of its group's val (key >> 33: a window start below 0 borrows
//      from the val, as JAX's signed searchsorted sees it) in a 2^15-bit
//      hashed bitmap;
//   2. every valid read 9-mer (r_max <= 4096) counts for vmax (JAX's
//      trailing-group quirk takes the largest val of both streams); only
//      those whose bit is set, about a fifth on homologous windows, go on as
//      keys val<<14 | std<<13 | rel (a read 9-mer of a val no sample has
//      pairs with nothing and overflows nothing);
//   3. both key sets are sorted by bitonic networks over the powers of two
//      above their counts, in registers (stages within a thread by selects,
//      within a warp by shuffles, and only those across warps through shared
//      memory, their barriers shared by the two networks); past 1,024
//      survivors the reads take a shared-memory network;
//   4. for each genome entry gi, binary searches give its val group among
//      the genome entries and the run of read keys of the same val; gi pairs
//      with that whole run when it is among the first cap of its group
//      (JAX's capped gather pairs each read 9-mer with the first cap entries
//      of its group, so the pair set is the same);
//   5. the pairs are numbered in (gi, read key) order by an exclusive scan
//      of the per-gi pair counts. The genome order is (val, g_std, g_rel)
//      and the read order within a val is (r_std, r_rel), so this order IS
//      the emission key's order, and no 65,536-slot argsort is needed: the
//      threads walk the pairs in that order, 256 at a time, compute anchor
//      and keep flag, and a block scan of the flags places each kept anchor.
// The order argument needs 0 <= gpos0 <= 2^30 - 5 g_max (no carry into
// the std bit of a genome entry). On other items the walk ranks the kept
// pairs by JAX's emission key itself: each round of 256 pairs is merged by
// key into the item's output row, which keeps the first m_out. Within the
// tables the key's low 27 bits are (g_rel mod 2^13 = the sample's offset,
// r_std, r_rel), so no two kept pairs share a key and the order needs no
// tie-break. When g_max > 1024 or r_max > 4096 (past the shared tables)
// every item takes the keyed kernel at the end of this file. Slots past the
// kept anchors hold anchor 0 and key 1 << 62.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 1024;
constexpr int kRMax = 4096;
constexpr int kSpan = 9;
constexpr int64_t kMask3 = (1ll << 30) - 1;
constexpr int64_t kMask5 = (1ll << 31) - 1;
constexpr int64_t kZero = 1ll << 20;
constexpr int64_t kInvalid = 1ll << 62;
constexpr uint32_t kNoRead = 0xffffffffu;

// g_mapHs_kmer_'s canonical 9-mer at p: val = x < 0 ? crh : h, masked to
// 18 bits, on whatever codes the window holds (int64, as in JAX; the
// products stand for JAX's shifts of possibly negative values)
__device__ __forceinline__ void kmer(const uint8_t* s, int64_t p,
                                     int64_t* val, int64_t* std) {
  int64_t h = 0, crh = 0, ws = 0;
#pragma unroll
  for (int o = 0; o < kSpan; ++o) {
    const int64_t c = s[p + o];
    h += c * (1ll << (2 * (kSpan - 1 - o)));
    crh += (3 - c) * (1ll << (2 * o));
    ws += c;
  }
  const int64_t st = 2 * ws - 3 * kSpan < 0 ? 1 : 0;
  *std = st;
  *val = (st ? crh : h) & ((1ll << (2 * kSpan)) - 1);
}

template <typename T>
__device__ void bitonic_sort(T* x, int n) {  // ascending; n a power of two
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const T a = x[i], b = x[ixj];
          if ((a > b) == ((i & k) == 0)) {
            x[i] = b;
            x[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// exclusive prefix sum of one int a thread over the block; *total gets the
// sum. Ends with a barrier, so `tmp` may be reused at once.
__device__ __forceinline__ int block_excl_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  if (lane == 31) tmp[warp] = s;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = tmp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  *total = all;
  return before + s - v;
}

// the first index in [0, n) whose x is >= v (x ascending)
template <typename T>
__device__ __forceinline__ int lower_bound(const T* x, int n, uint64_t v) {
  int l = 0, h = n;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if ((uint64_t)x[mid] < v) l = mid + 1;
    else h = mid;
  }
  return l;
}

// the number of x[0..n) below v, or at most v (x ascending as signed keys)
__device__ __forceinline__ int count_below(const int64_t* x, int n, int64_t v,
                                           bool or_equal) {
  int l = 0, h = n;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (x[mid] < v || (or_equal && x[mid] == v)) l = mid + 1;
    else h = mid;
  }
  return l;
}

// an item whose genome entries may carry into the std bit (a window start
// below 0 or past 2^30 - 5 g_max): the block-scan order is not the
// emission key's there, so its kept pairs are merged by key
__device__ __forceinline__ bool keyed_item(int64_t gpos0, int g_max) {
  return gpos0 < 0 || gpos0 > (1ll << 30) - 5ll * g_max;
}

// Merges a round's kept pairs (keep, its place pos among the round's n_kept)
// into the first `cur` entries of an output row sorted by key, keeping the
// first m_out. ck holds kThreads int64 of shared memory. A pair's place is
// its rank in the round plus the row's keys up to it; the row's entries
// move up by the round's keys below them, from the top down a block of them
// at a time, so no entry is overwritten before it is read. (Kept keys are
// distinct where the output counts; equal ones, which only an overflowing
// item can hold, still take distinct places: the row's first, then the
// round's in round order.)
// (Not inlined: the walk of the usual items stays as lean as without it.)
__device__ __noinline__ void merge_round(bool keep, int pos, int n_kept,
                                         int64_t anchor, int64_t key, int cur,
                                         int m_out, int64_t* oa, int64_t* ok,
                                         int64_t* ck) {
  if (keep) ck[pos] = key;
  __syncthreads();
  int dst = 0;
  if (keep) {
    int rank = 0;
    for (int t = 0; t < n_kept; ++t)
      rank += ck[t] < key || (ck[t] == key && t < pos) ? 1 : 0;
    dst = rank + count_below(ok, cur, key, true);
    pos = rank;
  }
  __syncthreads();
  if (keep) ck[pos] = key;  // the round in key order
  __syncthreads();
  for (int top = cur; top > 0; top -= kThreads) {
    const int j = top - kThreads + (int)threadIdx.x;
    int64_t a = 0, k = 0;
    int to = m_out;
    if (j >= 0) {
      a = oa[j];
      k = ok[j];
      to = j + count_below(ck, n_kept, k, false);
    }
    __syncthreads();
    if (to < m_out) {
      oa[to] = a;
      ok[to] = k;
    }
    __syncthreads();
  }
  if (keep && dst < m_out) {
    oa[dst] = anchor;
    ok[dst] = key;
  }
  __syncthreads();
}

// The genome groups' hashed bitmap: bit (val & (kBits - 1)) of the val of
// each genome entry's group (key >> 33). A read 9-mer whose bit is clear
// meets an empty group, so it pairs with nothing and can go before the
// sort; one whose bit is set by another val survives and finds an empty
// group (no pair, no overflow).
constexpr int kBits = 1 << 15;
constexpr int kBitWords = kBits / 32;
constexpr int kPerThread = kGMax / kThreads;  // register sort: 4 a thread

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

// Partner compare of one position of an ascending bitonic network: position
// i keeps the smaller of its pair (partner i ^ j) when (i & k) == 0 and it
// is the lower index, or neither
template <typename T>
__device__ __forceinline__ T bitonic_keep(T mine, T other, int i, int k,
                                          bool lower) {
  return (((i & k) == 0) == lower) ? tmin(mine, other) : tmax(mine, other);
}

// Stage (k, j) of two ascending bitonic networks at once over positions
// tid * E + e, the thread's E elements in x and y (each network only when
// its flag is set, block-uniform): partners in the thread by selects, in
// the warp by a shuffle, across warps through xs and ys, whose two barriers
// the networks share. Every thread of the block calls it.
template <typename T, typename U, int E>
__device__ __forceinline__ void bitonic_stage2(T (&x)[E], bool dx, U (&y)[E],
                                               bool dy, int k, int j, T* xs,
                                               U* ys) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (j >= 32 * E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (dx) xs[tid * E + e] = x[e];
      if (dy) ys[tid * E + e] = y[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid * E + e;
      const bool lower = (i & j) == 0;
      if (dx) x[e] = bitonic_keep(x[e], xs[i ^ j], i, k, lower);
      if (dy) y[e] = bitonic_keep(y[e], ys[i ^ j], i, k, lower);
    }
    __syncthreads();
  } else if (j >= E) {
    const int lm = j / E;
    const bool lower = (lane & lm) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid * E + e;
      if (dx)
        x[e] = bitonic_keep(x[e], __shfl_xor_sync(0xffffffffu, x[e], lm), i,
                            k, lower);
      if (dy)
        y[e] = bitonic_keep(y[e], __shfl_xor_sync(0xffffffffu, y[e], lm), i,
                            k, lower);
    }
  } else {
#pragma unroll
    for (int jj = E / 2; jj >= 1; jj >>= 1) {
      if (j != jj) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & jj) continue;
        const bool up = ((tid * E + e) & k) == 0;
        if (dx) {
          const T a = x[e], c = x[e | jj];
          x[e] = up ? tmin(a, c) : tmax(a, c);
          x[e | jj] = up ? tmax(a, c) : tmin(a, c);
        }
        if (dy) {
          const U a = y[e], c = y[e | jj];
          y[e] = up ? tmin(a, c) : tmax(a, c);
          y[e | jj] = up ? tmax(a, c) : tmin(a, c);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gap_anchors_kernel(const uint8_t* __restrict__ gseq, int64_t GW,
                       const int64_t* __restrict__ g_n_,
                       const int64_t* __restrict__ gpos0_,
                       const uint8_t* __restrict__ rseq, int64_t RW,
                       const int64_t* __restrict__ r_n_,
                       const int64_t* __restrict__ rpos0_,
                       const int64_t* __restrict__ rvcp_,
                       const int64_t* __restrict__ a_lo_,
                       const int64_t* __restrict__ a_hi_, int g_max,
                       int r_max, int cap, int m_out, int64_t* out_a,
                       int64_t* out_k, int32_t* count_out,
                       bool* overflow_out) {
  __shared__ int64_t g_key[kGMax];
  __shared__ uint32_t r_key[kRMax];
  __shared__ uint32_t bits[kBitWords];
  __shared__ int pstart[kGMax];
  __shared__ int rlo[kGMax];
  __shared__ int64_t round_k[kThreads];
  __shared__ int tmp[kWarps];
  __shared__ int vmax_sh, ovf_sh, ns_sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t b = blockIdx.x;
  const uint8_t* gs = gseq + b * GW;
  const uint8_t* rs = rseq + b * RW;
  const int64_t g_n = g_n_[b], gpos0 = gpos0_[b];
  const bool keyed = keyed_item(gpos0, g_max);  // block-uniform
  const int64_t r_n = r_n_[b], rpos0 = rpos0_[b], rvcp = rvcp_[b];
  const int64_t a_lo = a_lo_[b], a_hi = a_hi_[b];
  const int64_t gpos_last = GW - kSpan, rpos_last = RW - kSpan;
  // the valid samples: t < g_max with 4 + 5t < g_n; reads r < min(r_n, r_max)
  const int ng = (int)min((int64_t)g_max, (g_n < 0 ? 0 : g_n) / 5);
  const int nr = (int)min((int64_t)r_max, r_n < 0 ? 0 : r_n);
  for (int w = tid; w < kBitWords; w += kThreads) bits[w] = 0;
  if (tid == 0) {
    vmax_sh = -1;
    ovf_sh = 0;
    ns_sh = 0;
  }
  __syncthreads();
  // the genome entries, thread t holding samples 4t .. 4t + 3, and their
  // vals' bits
  int vmax = -1;
  int64_t gv[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int t = tid * kPerThread + e;
    gv[e] = kInvalid;
    if (t < ng) {
      const int64_t p = min((int64_t)(4 + 5 * t), gpos_last);
      int64_t v, st;
      kmer(gs, p, &v, &st);
      gv[e] = (v << 33) + (st << 30) + (gpos0 + p);
      vmax = max(vmax, (int)v);
      // the val whose group JAX's signed searchsorted puts the entry in:
      // key >> 33, one below v when a window start below 0 borrows from
      // it; an entry below 0 is in no group
      if (gv[e] >= 0) {
        const int64_t gval = gv[e] >> 33;
        atomicOr(&bits[(gval & (kBits - 1)) >> 5], 1u << (gval & 31));
      }
    }
  }
  __syncthreads();
  // every valid read 9-mer counts for vmax (JAX's trailing group); those
  // whose bit is set survive, appended a warp at a time
  for (int r0 = 0; r0 < nr; r0 += kThreads) {
    const int r = r0 + tid;
    uint32_t k = 0;
    bool keep = false;
    if (r < nr) {
      int64_t v, st;
      kmer(rs, min((int64_t)r, rpos_last), &v, &st);
      vmax = max(vmax, (int)v);
      k = ((uint32_t)v << 14) | ((uint32_t)st << 13) | (uint32_t)r;
      keep = (bits[(v & (kBits - 1)) >> 5] >> (v & 31)) & 1;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&ns_sh, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (keep) r_key[at + __popc(m & ((1u << lane) - 1))] = k;
  }
  atomicMax(&vmax_sh, vmax);
  __syncthreads();
  vmax = vmax_sh;
  const int ns = ns_sh;
  int Sg = 1, Sr = 1;  // the networks' sizes: powers of two
  while (Sg < ng) Sg <<= 1;
  while (Sr < ns) Sr <<= 1;
  // both sorts in registers, their stages side by side (the barriers of
  // the stages across warps shared); past 1,024 survivors the reads take
  // the shared-memory network
  const bool reg_reads = ns <= kGMax;  // block-uniform
  uint32_t rk4[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int t = tid * kPerThread + e;
    rk4[e] = reg_reads && t < ns ? r_key[t] : kNoRead;
  }
  __syncthreads();  // the survivors are read before the network writes
  const int S = reg_reads && Sr > Sg ? Sr : Sg;
  for (int k = 2; k <= S; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1)
      bitonic_stage2(gv, k <= Sg, rk4, reg_reads && k <= Sr, k, j, g_key,
                     r_key);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    g_key[tid * kPerThread + e] = gv[e];
    if (reg_reads) r_key[tid * kPerThread + e] = rk4[e];
  }
  __syncthreads();
  if (!reg_reads) {
    for (int t = ns + tid; t < Sr; t += kThreads) r_key[t] = kNoRead;
    __syncthreads();
    bitonic_sort(r_key, Sr);
  }
  // per genome entry: its group, its run of read keys, its pair count
  for (int gi = tid; gi < kGMax; gi += kThreads) {
    int np = 0;
    // (an entry below 0, a window start below 0 borrowing from val 0,
    // is in no read's val range: JAX's signed searchsorted)
    if (gi < ng && g_key[gi] >= 0) {
      const int64_t val = g_key[gi] >> 33;
      const int glo = count_below(g_key, ng, val << 33, false);
      const int ghi = count_below(g_key, ng, (val + 1) << 33, false);
      const int rl = lower_bound(r_key, ns, (uint64_t)val << 14);
      const int rh = lower_bound(r_key, ns, (uint64_t)(val + 1) << 14);
      if (ghi - glo > cap && rh > rl) ovf_sh = 1;
      np = gi - glo < cap ? rh - rl : 0;
      rlo[gi] = rl;
    }
    pstart[gi] = np;
  }
  __syncthreads();
  // exclusive scan of the pair counts, four consecutive entries a thread
  constexpr int kPer = kGMax / kThreads;
  int loc[kPer];
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    loc[u] = pstart[threadIdx.x * kPer + u];
    sum += loc[u];
  }
  int n_pairs;
  int run = block_excl_scan(sum, tmp, &n_pairs);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    pstart[threadIdx.x * kPer + u] = run;
    run += loc[u];
  }
  __syncthreads();
  // walk the pairs in emission order (keyed: merge each round by key)
  int kept = 0;
  for (int base = 0; base < n_pairs; base += kThreads) {
    const int p = base + threadIdx.x;
    bool keep = false;
    int64_t anchor = 0, key = 0;
    if (p < n_pairs) {
      int l = 0, h = ng;  // the last gi with pstart[gi] <= p
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (pstart[mid] <= p) l = mid + 1;
        else h = mid;
      }
      const int gi = l - 1;
      const uint32_t rk = r_key[rlo[gi] + (p - pstart[gi])];
      const int64_t rv = rk >> 14, rstd = (rk >> 13) & 1, rrel = rk & 0x1fff;
      const int64_t hs1 = g_key[gi];
      const int64_t hs2 = (rv << 33) + (1ll << 31) + (rstd << 30) + (rpos0 + rrel);
      // g_hs_set_anchor (src/gap_util.cpp:548)
      const int64_t std_ = ((hs1 ^ hs2) >> 30) & 1;
      const int64_t nsg = 2 * std_ - 1;
      const int64_t xx = rvcp * std_ - nsg * (hs2 & kMask3);
      anchor = (((hs1 + kZero - xx) & kMask3) << 20) + xx + (std_ << 50);
      const int64_t t = ((anchor >> 20) & kMask5) - kZero;
      keep = t >= a_lo && t < a_hi && rv < vmax;
      key = (rv << 28) | (((hs1 >> 30) & 1) << 27)
            | (((hs1 & kMask3) - gpos0) << 14) | (rstd << 13) | rrel;
    }
    int n_kept;
    const int pos = block_excl_scan(keep ? 1 : 0, tmp, &n_kept);
    if (keyed) {
      merge_round(keep, pos, n_kept, anchor, key, min(kept, m_out), m_out,
                  out_a + b * m_out, out_k + b * m_out, round_k);
    } else if (keep && kept + pos < m_out) {
      out_a[b * m_out + kept + pos] = anchor;
      out_k[b * m_out + kept + pos] = key;
    }
    kept += n_kept;
  }
  for (int s = min(kept, m_out) + threadIdx.x; s < m_out; s += kThreads) {
    out_a[b * m_out + s] = 0;
    out_k[b * m_out + s] = kInvalid;
  }
  if (threadIdx.x == 0) {
    count_out[b] = kept;
    overflow_out[b] = ovf_sh || kept > m_out || g_n > 5ll * g_max + 4 ||
                      r_n > r_max;
  }
}

// Past the shared-memory tables (g_max > 1024 or r_max > 4096) every item
// takes this kernel. It follows JAX's steps: the sorted genome entries, a
// searchsorted per read 9-mer, the first cap entries of its val group,
// g_hs_set_anchor, and JAX's 46-bit emission key of each kept pair, in its
// int64 arithmetic (its fields may overlap there, as in JAX). The kept
// pairs go to the scratch in any order and a bitonic sort by (key, flat
// pair index r * cap + c), the stable argsort's order, ranks them. A block
// walks items b, b + gridDim.x, ... with its own part of the scratch:
// G + 2 P int64 and P int32, G and P the powers of two over g_max and
// r_max * cap.
__device__ __forceinline__ bool pair_less(int64_t ka, int fa, int64_t kb,
                                          int fb) {
  return ka < kb || (ka == kb && fa < fb);
}

__global__ void __launch_bounds__(kThreads)
    gap_anchors_keyed_kernel(const uint8_t* __restrict__ gseq, int64_t GW,
                             const int64_t* __restrict__ g_n_,
                             const int64_t* __restrict__ gpos0_,
                             const uint8_t* __restrict__ rseq, int64_t RW,
                             const int64_t* __restrict__ r_n_,
                             const int64_t* __restrict__ rpos0_,
                             const int64_t* __restrict__ rvcp_,
                             const int64_t* __restrict__ a_lo_,
                             const int64_t* __restrict__ a_hi_, int64_t B,
                             int g_max, int r_max, int cap, int m_out,
                             int64_t G, int64_t P,
                             int64_t* scratch, int64_t* out_a,
                             int64_t* out_k, int32_t* count_out,
                             bool* overflow_out) {
  __shared__ int vmax_sh, ovf_sh, kept_sh;
  int64_t* gsort = scratch + (int64_t)blockIdx.x * (G + 2 * P + P / 2 + 1);
  int64_t* keys = gsort + G;
  int64_t* anc = keys + P;
  int* flat = reinterpret_cast<int*>(anc + P);
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const int64_t g_n = g_n_[b], gpos0 = gpos0_[b];
    const uint8_t* gs = gseq + b * GW;
    const uint8_t* rs = rseq + b * RW;
    const int64_t r_n = r_n_[b], rpos0 = rpos0_[b], rvcp = rvcp_[b];
    const int64_t a_lo = a_lo_[b], a_hi = a_hi_[b];
    const int ng = (int)min((int64_t)g_max, (g_n < 0 ? 0 : g_n) / 5);
    const int nr = (int)min((int64_t)r_max, r_n < 0 ? 0 : r_n);
    if (threadIdx.x == 0) {
      vmax_sh = -1;
      ovf_sh = 0;
      kept_sh = 0;
    }
    __syncthreads();
    int vmax = -1;
    for (int64_t t = threadIdx.x; t < G; t += kThreads) {
      int64_t e = kInvalid;
      if (t < ng) {
        const int64_t p = 4 + 5 * t;
        int64_t v, st;
        kmer(gs, min(p, GW - kSpan), &v, &st);
        e = (v << 33) + (st << 30) + (gpos0 + p);
        vmax = max(vmax, (int)v);
      }
      gsort[t] = e;
    }
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      int64_t v, st;
      kmer(rs, min((int64_t)r, RW - kSpan), &v, &st);
      vmax = max(vmax, (int)v);
    }
    atomicMax(&vmax_sh, vmax);
    __syncthreads();
    bitonic_sort(gsort, (int)G);
    vmax = vmax_sh;
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      int64_t rv, rstd;
      kmer(rs, min((int64_t)r, RW - kSpan), &rv, &rstd);
      const int lo = count_below(gsort, ng, rv << 33, false);
      const int hi = count_below(gsort, ng, (rv + 1) << 33, false);
      if (hi - lo > cap) ovf_sh = 1;
      const int64_t hs2 = (rv << 33) + (1ll << 31) + (rstd << 30) + (rpos0 + r);
      for (int c = 0; c < hi - lo && c < cap; ++c) {
        const int64_t hs1 = gsort[lo + c];
        // g_hs_set_anchor (src/gap_util.cpp:548)
        const int64_t std_ = ((hs1 ^ hs2) >> 30) & 1;
        const int64_t nsg = 2 * std_ - 1;
        const int64_t xx = rvcp * std_ - nsg * (hs2 & kMask3);
        const int64_t anchor =
            (((hs1 + kZero - xx) & kMask3) << 20) + xx + (std_ << 50);
        const int64_t t = ((anchor >> 20) & kMask5) - kZero;
        if (t >= a_lo && t < a_hi && rv < vmax) {
          const int slot = atomicAdd(&kept_sh, 1);
          keys[slot] = (rv << 28) | (((hs1 >> 30) & 1) << 27) |
                       (((hs1 & kMask3) - gpos0) << 14) | (rstd << 13) | r;
          anc[slot] = anchor;
          flat[slot] = r * cap + c;
        }
      }
    }
    __syncthreads();
    const int kept = kept_sh;
    int n2 = 1;
    while (n2 < kept) n2 <<= 1;
    for (int s = kept + threadIdx.x; s < n2; s += kThreads) {
      keys[s] = INT64_MAX;
      flat[s] = 0x7fffffff;
      anc[s] = 0;
    }
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1) {  // ascending by (key, flat)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < n2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i &&
              pair_less(keys[ixj], flat[ixj], keys[i], flat[i]) ==
                  ((i & k) == 0)) {
            const int64_t tk = keys[i], ta = anc[i];
            const int tf = flat[i];
            keys[i] = keys[ixj];
            anc[i] = anc[ixj];
            flat[i] = flat[ixj];
            keys[ixj] = tk;
            anc[ixj] = ta;
            flat[ixj] = tf;
          }
        }
        __syncthreads();
      }
    }
    for (int s = threadIdx.x; s < m_out; s += kThreads) {
      out_a[b * m_out + s] = s < kept ? anc[s] : 0;
      out_k[b * m_out + s] = s < kept ? keys[s] : kInvalid;
    }
    if (threadIdx.x == 0) {
      count_out[b] = kept;
      overflow_out[b] = ovf_sh || kept > m_out || g_n > 5ll * g_max + 4 ||
                        r_n > r_max;
    }
    __syncthreads();  // the shared flags and the scratch serve the next item
  }
}

}  // namespace

extern "C" {

// The keyed kernel's blocks: at most kKeyedBlocks, each with its part of the
// scratch, G + 2 P + P / 2 + 1 int64 words (G, P the powers of two over g_max
// and r_max * cap).
constexpr int64_t kKeyedBlocks = 32;

static bool past_tables(int g_max, int r_max) {
  return g_max > kGMax || r_max > kRMax;
}

// Scratch words a launch of B items needs: 0 within the shared tables,
// else the keyed kernel's blocks' parts.
int64_t lt_gap_anchors_scratch_words(int64_t B, int g_max, int r_max,
                                     int cap) {
  if (!past_tables(g_max, r_max) || B <= 0) return 0;
  int64_t G = 1, P = 1;
  while (G < g_max) G <<= 1;
  while (P < (int64_t)r_max * cap) P <<= 1;
  return (B < kKeyedBlocks ? B : kKeyedBlocks) * (G + 2 * P + P / 2 + 1);
}

// Launches a kernel on `stream`: genome windows gseq (B, GW) and read
// windows rseq (B, RW) uint8, the (B,) int64 item scalars; g_max, r_max,
// cap, m_out >= 1, r_max * cap < 2^31; scratch holds
// lt_gap_anchors_scratch_words(B, g_max, r_max, cap) int64 (null when that
// is 0). Within the shared-memory tables (g_max <= 1024, r_max <= 4096) the
// block-scan kernel takes every item; past them the keyed kernel does.
// Outputs anchors and keys (B, m_out) int64, count (B,) int32, overflow
// (B,) bool. Returns the cudaError_t of the launch.
int lt_gap_anchors(const uint8_t* gseq, int64_t GW, const int64_t* g_n,
                   const int64_t* gpos0, const uint8_t* rseq, int64_t RW,
                   const int64_t* r_n, const int64_t* rpos0,
                   const int64_t* rvcp, const int64_t* a_lo,
                   const int64_t* a_hi, int64_t B, int g_max, int r_max,
                   int cap, int m_out, int64_t* scratch, int64_t* out_a,
                   int64_t* out_k, int32_t* count, bool* overflow,
                   void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (g_max < 1 || r_max < 1 || cap < 1 || (int64_t)r_max * cap >= (1ll << 31)
      || m_out < 1 || GW < kSpan || RW < kSpan || B > 0x7fffffff ||
      (lt_gap_anchors_scratch_words(B, g_max, r_max, cap) > 0) !=
          (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!past_tables(g_max, r_max)) {
    gap_anchors_kernel<<<(unsigned)B, kThreads, 0, st>>>(
        gseq, GW, g_n, gpos0, rseq, RW, r_n, rpos0, rvcp, a_lo, a_hi, g_max,
        r_max, cap, m_out, out_a, out_k, count, overflow);
    return (int)cudaGetLastError();
  }
  int64_t G = 1, P = 1;
  while (G < g_max) G <<= 1;
  while (P < (int64_t)r_max * cap) P <<= 1;
  gap_anchors_keyed_kernel<<<(unsigned)(B < kKeyedBlocks ? B : kKeyedBlocks),
                             kThreads, 0, st>>>(
      gseq, GW, g_n, gpos0, rseq, RW, r_n, rpos0, rvcp, a_lo, a_hi, B, g_max,
      r_max, cap, m_out, G, P, scratch, out_a, out_k, count, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
