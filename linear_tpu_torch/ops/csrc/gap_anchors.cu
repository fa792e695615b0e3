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
// linear_tpu_torch/ops/gap_dev.py:gap_anchors_reference.
//
// What bounds it on the card: per item, two small sorts and a scan over the
// candidate pairs, each a few barriers deep; the bytes (the windows in,
// 16 bytes a kept anchor out) are small. Items are independent.
//
// Design: one block an item, its tables in shared memory (~33 KB):
//   1. the genome entries val<<33 | std<<30 | pos of the samples
//      (g_max <= 1024) and the read keys val<<14 | std<<13 | rel of the
//      read positions (r_max <= 4096) are computed and bitonic-sorted;
//   2. for each genome entry gi, binary searches give its val group among
//      the genome entries and the run of read keys of the same val; gi pairs
//      with that whole run when it is among the first cap of its group
//      (JAX's capped gather pairs each read 9-mer with the first cap entries
//      of its group, so the pair set is the same);
//   3. the pairs are numbered in (gi, read key) order by an exclusive scan
//      of the per-gi pair counts. The genome order is (val, g_std, g_rel)
//      and the read order within a val is (r_std, r_rel), so this order IS
//      the emission key's order, and no 65,536-slot argsort is needed: the
//      threads walk the pairs in that order, 256 at a time, compute anchor
//      and keep flag, and a block scan of the flags places each kept anchor.
// The order argument needs gpos0 + 5 g_max <= 2^30 (no carry into the std
// bit of a genome entry); the wrapper checks it. Slots past the kept
// anchors hold anchor 0 and key 1 << 62.
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
  __shared__ int pstart[kGMax];
  __shared__ int rlo[kGMax];
  __shared__ int tmp[kWarps];
  __shared__ int vmax_sh, ovf_sh;
  const int64_t b = blockIdx.x;
  const uint8_t* gs = gseq + b * GW;
  const uint8_t* rs = rseq + b * RW;
  const int64_t g_n = g_n_[b], gpos0 = gpos0_[b];
  const int64_t r_n = r_n_[b], rpos0 = rpos0_[b], rvcp = rvcp_[b];
  const int64_t a_lo = a_lo_[b], a_hi = a_hi_[b];
  const int64_t gpos_last = GW - kSpan, rpos_last = RW - kSpan;
  int G = 1, R = 1;
  while (G < g_max) G <<= 1;
  while (R < r_max) R <<= 1;
  // the valid samples: t < g_max with 4 + 5t < g_n; reads r < min(r_n, r_max)
  const int ng = (int)min((int64_t)g_max, (g_n < 0 ? 0 : g_n) / 5);
  const int nr = (int)min((int64_t)r_max, r_n < 0 ? 0 : r_n);
  if (threadIdx.x == 0) {
    vmax_sh = -1;
    ovf_sh = 0;
  }
  __syncthreads();
  int vmax = -1;
  for (int t = threadIdx.x; t < G; t += kThreads) {
    int64_t e = kInvalid;
    if (t < ng) {
      const int64_t p = min((int64_t)(4 + 5 * t), gpos_last);
      int64_t v, st;
      kmer(gs, p, &v, &st);
      e = (v << 33) + (st << 30) + (gpos0 + p);
      vmax = max(vmax, (int)v);
    }
    g_key[t] = e;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    uint32_t k = kNoRead;
    if (r < nr) {
      int64_t v, st;
      kmer(rs, min((int64_t)r, rpos_last), &v, &st);
      k = ((uint32_t)v << 14) | ((uint32_t)st << 13) | (uint32_t)r;
      vmax = max(vmax, (int)v);
    }
    r_key[r] = k;
  }
  atomicMax(&vmax_sh, vmax);
  __syncthreads();
  bitonic_sort(g_key, G);
  bitonic_sort(r_key, R);
  vmax = vmax_sh;
  // per genome entry: its group, its run of read keys, its pair count
  for (int gi = threadIdx.x; gi < kGMax; gi += kThreads) {
    int np = 0;
    if (gi < ng) {
      const uint64_t val = (uint64_t)g_key[gi] >> 33;
      const int glo = lower_bound(g_key, ng, val << 33);
      const int ghi = lower_bound(g_key, ng, (val + 1) << 33);
      const int rl = lower_bound(r_key, nr, val << 14);
      const int rh = lower_bound(r_key, nr, (val + 1) << 14);
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
  // walk the pairs in emission order
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
    const int pos = kept + block_excl_scan(keep ? 1 : 0, tmp, &n_kept);
    if (keep && pos < m_out) {
      out_a[b * m_out + pos] = anchor;
      out_k[b * m_out + pos] = key;
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

}  // namespace

extern "C" {

// Launches the kernel on `stream`: genome windows gseq (B, GW) and read
// windows rseq (B, RW) uint8, the (B,) int64 item scalars; 1 <= g_max <=
// 1024, 1 <= r_max <= 4096. Outputs anchors and keys (B, m_out) int64,
// count (B,) int32, overflow (B,) bool. Returns the cudaError_t of the
// launch.
int lt_gap_anchors(const uint8_t* gseq, int64_t GW, const int64_t* g_n,
                   const int64_t* gpos0, const uint8_t* rseq, int64_t RW,
                   const int64_t* r_n, const int64_t* rpos0,
                   const int64_t* rvcp, const int64_t* a_lo,
                   const int64_t* a_hi, int64_t B, int g_max, int r_max,
                   int cap, int m_out, int64_t* out_a, int64_t* out_k,
                   int32_t* count, bool* overflow, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (g_max < 1 || g_max > kGMax || r_max < 1 || r_max > kRMax || cap < 1 ||
      m_out < 1 || GW < kSpan || RW < kSpan || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  gap_anchors_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      gseq, GW, g_n, gpos0, rseq, RW, r_n, rpos0, rvcp, a_lo, a_hi, g_max,
      r_max, cap, m_out, out_a, out_k, count, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
