// Fused superchunk seeding of the default filter path, for Hopper (sm_90a).
//
// Replaces linear_tpu/ops/seeding.py:_seed_superchunk_fused (and the
// batch_seed_anchors_compact it calls), which the JAX package runs as one
// jitted XLA kernel per superchunk. The plain PyTorch version beside it is
// linear_tpu_torch/ops/seeding.py:seed_superchunk_reference; the module
// docstring there states what is computed. Output rows are identical on
// their defined part: anchors[:count] and the tail count | probed << 32.
//
// What bounds it on the card: random 4-byte gathers into the dense DIndex
// bucket table `dir` (4^13 + 1 int32 = 268 MB, far larger than the 50 MB
// L2), two adjacent words per probed read position, plus the 8-byte gathers
// of the probed `hs` entries. The per-position arithmetic (a 21-base window,
// nine 13-mer candidates, four YValue bases) is small.
//
// Design, one thread block per wire row (read):
//   1. The threads walk the row's in-range call positions in tiles of
//      kThreads: each computes xval, yval and strand of its position from
//      the packed bases, reads the previous position's xval from shared
//      memory (carried across tiles) for the dedup, and probes the bucket.
//   2. A block-wide exclusive scan of the clipped bucket counts, carried
//      across tiles (a row of pad 131072 has up to 8,737 positions), gives
//      each position its first output slot. Positions past the row's
//      length are never visited.
//   3. Each position writes its entries below m_out into shared memory:
//      the anchor (val2Anchor) and a keep flag (the y-check). All tiles keep
//      scanning to the end, so `probed` is exact even past m_out. Slots
//      past kSmemSlots (36 KB; JAX's default m_out is 8,192) go to the
//      row's part of a device scratch that the wrapper allocates.
//   4. A second block scan over the keep flags compacts the kept slots in
//      order into the output row; the unused slots are zeroed.
// The latency of the dir gathers is hidden by the many resident blocks (one
// per read), not inside a block.
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemSlots = 4096;  // slots a row keeps in shared memory
constexpr int kSpan = 21;
constexpr int kWeight = 13;
constexpr int kAlpha = 15;
constexpr int kFirst = kSpan + kAlpha - 1;  // 35: the first call position
constexpr int kNOff = kSpan - kWeight + 1;  // 9 minimizer candidates
// the p = 0 call's hash window keeps kNMix bases of the init window,
// b[kSpan-1-kNMix .. kSpan-1), before b[kFirst+kNMix ..)
constexpr int kNMix = 2 * kSpan - 1 - kFirst;  // 6
constexpr uint32_t kMaskW = (1u << (2 * kWeight)) - 1;
constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kFlagStrand = 1ull << 61;

// base i of a row: 2-bit LSB-first codes, 0 past the packed bases
__device__ __forceinline__ int base_at(const uint8_t* __restrict__ pk,
                                       int64_t pad, int64_t i) {
  if (i < 0 || i >= pad) return 0;
  return (pk[i >> 2] >> (2 * (i & 3))) & 3;
}

__global__ void __launch_bounds__(kThreads)
seed_superchunk_kernel(const uint8_t* __restrict__ wire, int64_t row_bytes,
                       const int32_t* __restrict__ dir, int64_t n_dir,
                       const int64_t* __restrict__ hs, int64_t n_hs, int cap,
                       int m_out, int64_t* __restrict__ g_anc,
                       uint8_t* __restrict__ g_keep,
                       int64_t* __restrict__ out) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int s_xval[kThreads];
  __shared__ int s_prev_x;  // xval of the previous tile's last position
  __shared__ int s_bias;
  // the first n_sm slots' anchors, then their keep flags; slots from n_sm
  // on in the scratch, m_out - n_sm a row
  extern __shared__ int64_t s_anc[];
  const int n_sm = m_out < kSmemSlots ? m_out : kSmemSlots;
  uint8_t* s_keep = reinterpret_cast<uint8_t*>(s_anc + n_sm);
  const int64_t g_row = (int64_t)blockIdx.x * (m_out - n_sm);

  const int tid = threadIdx.x;
  const uint8_t* pk = wire + (int64_t)blockIdx.x * row_bytes;
  const int64_t pad = (row_bytes - 8) * 4;
  uint64_t ln_u = 0;
  for (int b = 0; b < 8; b++) ln_u |= (uint64_t)pk[pad / 4 + b] << (8 * b);
  const int64_t ln = (int64_t)ln_u;
  // positions p with k = kFirst + kAlpha*p < ln - kSpan
  const int64_t n_pos = ln > kFirst + kSpan
                            ? (ln - kFirst - kSpan + kAlpha - 1) / kAlpha
                            : 0;

  if (tid == 0) {
    // GC-skew init bias: 2*(sum b[0..span-1) - sum b[span..2*span-1))
    int s = 0;
    for (int i = 0; i < kSpan - 1; i++) s += base_at(pk, pad, i);
    for (int i = kSpan; i < 2 * kSpan - 1; i++) s -= base_at(pk, pad, i);
    s_bias = 2 * s;
    s_prev_x = 0;
  }
  __syncthreads();
  const int bias = s_bias;

  int probed = 0;  // block-uniform: entries of all earlier tiles
  for (int64_t t0 = 0; t0 < n_pos; t0 += kThreads) {
    const int64_t p = t0 + tid;
    const bool live = p < n_pos;
    const int64_t k = kFirst + (int64_t)kAlpha * p;
    int xval = 0, yval = 0;
    bool fwd = true;
    if (live) {
      uint64_t h = 0, rc = 0;
      int wsum = 0;
      for (int t = 0; t < kSpan; t++) {
        const int b = base_at(pk, pad, k + t);
        wsum += b;
        const int w = (p == 0 && t < kNMix)
                          ? base_at(pk, pad, kSpan - 1 - kNMix + t)
                          : b;
        h = (h << 2) | (uint64_t)w;
        rc |= (uint64_t)(3 - w) << (2 * t);
      }
      fwd = 2 * wsum - 3 * kSpan + bias > 0;
      const uint64_t v = fwd ? h : rc;
      uint32_t best = kMaskW + 1;
      int tsel = 0;
      for (int idx = 0; idx < kNOff; idx++) {
        const uint32_t c = (uint32_t)(v >> (2 * (kNOff - 1 - idx))) & kMaskW;
        if (c < best) {
          best = c;
          tsel = idx;
        }
      }
      xval = (int)best;
      for (int i = 0; i < 4; i++) {
        const int b = fwd ? base_at(pk, pad, k + tsel + kWeight + i)
                          : 3 - base_at(pk, pad,
                                        k + kSpan - kWeight - 1 - tsel - i);
        yval = (yval << 2) + b;
      }
    }
    s_xval[tid] = xval;
    __syncthreads();
    const int prev = tid ? s_xval[tid - 1] : s_prev_x;
    int lo = 0, cnt = 0;
    if (live && xval != prev) {
      const int64_t xc = xval < n_dir - 2 ? xval : n_dir - 2;
      lo = dir[xc];
      const int hi = dir[xc + 1];
      cnt = hi - lo < cap ? hi - lo : cap;
    }
    int first, tile_total;
    BlockScan(scan_tmp).ExclusiveSum(cnt, first, tile_total);
    first += probed;
    const int strand = fwd ? 0 : 1;
    for (int e = 0; e < cnt && first + e < m_out; e++) {
      int64_t ei = (int64_t)lo + e;
      ei = ei < 0 ? 0 : (ei > n_hs - 1 ? n_hs - 1 : ei);
      const uint64_t ent = (uint64_t)hs[ei];
      const uint64_t ent_y = ent & kMaskY;
      const uint64_t val = ent_y ^ (uint64_t)yval;
      const bool y_ok = val == 0 || val < ((val & (~val + 1)) << 2);
      const bool same = (int)((ent >> 61) & 1) == strand;
      const uint64_t cordy = (uint64_t)(same ? k : ln - 1 - k);
      uint64_t anc = ent - (cordy << 20) + cordy - ent_y;
      anc = same ? (anc & ~kFlagStrand) : (anc | kFlagStrand);
      const int slot = first + e;
      if (slot < n_sm) {
        s_anc[slot] = (int64_t)anc;
        s_keep[slot] = y_ok ? 1 : 0;
      } else {
        g_anc[g_row + slot - n_sm] = (int64_t)anc;
        g_keep[g_row + slot - n_sm] = y_ok ? 1 : 0;
      }
    }
    probed += tile_total;
    // all reads of s_prev_x and scan_tmp of this tile happen before here
    __syncthreads();
    if (tid == kThreads - 1) s_prev_x = s_xval[kThreads - 1];
  }
  __syncthreads();

  int64_t* orow = out + (int64_t)blockIdx.x * (m_out + 1);
  const int n_slots = probed < m_out ? probed : m_out;
  int count = 0;  // block-uniform: kept slots of earlier tiles
  for (int s0 = 0; s0 < n_slots; s0 += kThreads) {
    const int s = s0 + tid;
    const int keep = s >= n_slots ? 0
                     : (s < n_sm ? s_keep[s] : g_keep[g_row + s - n_sm]);
    int dst, tile_kept;
    BlockScan(scan_tmp).ExclusiveSum(keep, dst, tile_kept);
    if (keep)
      orow[count + dst] = s < n_sm ? s_anc[s] : g_anc[g_row + s - n_sm];
    count += tile_kept;
    __syncthreads();
  }
  for (int s = count + tid; s < m_out; s += kThreads) orow[s] = 0;
  if (tid == 0) orow[m_out] = (int64_t)((uint64_t)count | ((uint64_t)probed << 32));
}

}  // namespace

extern "C" {

// Slots a row keeps in the device scratch at m_out: the wrapper allocates
// rows times that many anchors (int64) and keep flags (uint8).
int64_t lt_seed_superchunk_scratch_slots(int m_out) {
  return m_out > kSmemSlots ? m_out - kSmemSlots : 0;
}

// Launches the kernel on `stream` for `rows` wire rows of `row_bytes` bytes
// (pad/4 bases + 8 length bytes); m_out >= 1. out is (rows, m_out + 1)
// int64; g_anc and g_keep hold rows * lt_seed_superchunk_scratch_slots
// slots (both null when that is 0). Returns the cudaError_t of the launch
// (0: launched).
int lt_seed_superchunk(const uint8_t* wire, int64_t rows, int64_t row_bytes,
                       const int32_t* dir, int64_t n_dir, const int64_t* hs,
                       int64_t n_hs, int cap, int m_out, int64_t* g_anc,
                       uint8_t* g_keep, int64_t* out, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (m_out < 1 || rows > 0x7fffffff ||
      (lt_seed_superchunk_scratch_slots(m_out) > 0) != (g_anc != nullptr) ||
      (g_anc != nullptr) != (g_keep != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_sm = m_out < kSmemSlots ? m_out : kSmemSlots;
  const size_t smem = (size_t)n_sm * (sizeof(int64_t) + 1);
  seed_superchunk_kernel<<<(unsigned)rows, kThreads, smem,
                           (cudaStream_t)stream>>>(
      wire, row_bytes, dir, n_dir, hs, n_hs, cap, m_out, g_anc, g_keep, out);
  return (int)cudaGetLastError();
}

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
