// Fused superchunk seeding of the default filter path, for Hopper (sm_90a).
//
// Replaces linear_tpu/ops/seeding.py:_seed_superchunk_fused (and the
// batch_seed_anchors_compact it calls), which the JAX package runs as one
// jitted XLA kernel per superchunk. The plain PyTorch version beside it is
// linear_tpu_torch/ops/seeding.py:seed_superchunk_reference; the module
// docstring there states what is computed, and superchunk_states_from_words
// there states this kernel's word arithmetic. Output rows are identical on
// their defined part: anchors[:count] and the tail count | probed << 32.
//
// What bounds it on the card: random 4-byte gathers into the dense DIndex
// bucket table `dir` (4^13 + 1 int32 = 268 MB, far larger than the 50 MB
// L2), two adjacent words per probed read position, plus the 8-byte gathers
// of the probed `hs` entries. The per-position arithmetic is small. Each
// block is one read, and 1,024 reads fit one wave of the card, so the
// kernel's time is the length of a block's chain of dependent steps.
//
// Design, one thread block per wire row (read), three trips to device
// memory on the chain of a row that fits one tile:
//   1. The row's packed bases are staged once into shared memory as 64-bit
//      words (8-byte loads where the row is 8-byte aligned; rows of pad
//      past 131,072 bases stage into a device scratch instead).
//   2. Each thread takes kJ consecutive call positions (a tile of 640 or
//      768; a pad-8192 row has at most 544). A position's 21-base window is a
//      funnel shift of two staged words: the reverse complement is its
//      complement, the MSB-first hash its 2-bit groups reversed
//      (__brevll and a swap of each pair of bits), the window's base sum two
//      popcounts; the p = 0 hash window splices in the init window's bases
//      b[14..20). The nine 13-mer candidates and the four YValue bases come
//      from the same words. The dedup against the previous position's xval
//      crosses thread boundaries through shared memory, carried across
//      tiles. Every one of a thread's `dir` gathers is issued before any is
//      used; one block scan of the clipped bucket counts gives every
//      position its first slot.
//   3. A flat emission loop over the tile's slots below m_out: each thread
//      finds its slot's position by a binary search of the scanned offsets
//      in shared memory, so the `hs` gathers are independent and spread
//      evenly across the block, not serialised by bucket size. Slots keep
//      their anchor (val2Anchor) and y-check flag in shared memory; slots
//      past kSmemSlots (JAX's default m_out is 8,192) go to the row's part
//      of a device scratch. Tiles go on to the row's end, so `probed` is
//      exact past m_out.
//   4. A block scan over the keep flags compacts the kept slots in order
//      into the output row; the unused slots are zeroed.
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

// Two shapes of block: 128 threads of 5 call positions each (a tile of 640)
// and at most 64 registers, eight blocks an SM, so that the 1,024 reads of
// a superchunk run in one wave; and for launches of at most kSmallGrid rows
// (the 256-row tier), 256 threads of 3 positions (768), which halves each
// thread's share of the emission and the compaction.
constexpr int kSmallGrid = 132 * 6;
constexpr int kSmemSlots = 4096;        // slots a row keeps in shared memory
constexpr int kRowSmemWords = 4096;     // staged words: pad up to 131,072
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
constexpr uint64_t kMaskWin = (1ull << (2 * kSpan)) - 1;   // 42 bits
constexpr uint64_t kMaskMix = (1ull << (2 * kNMix)) - 1;   // 12 bits
constexpr uint64_t kLo = 0x5555555555555555ull;            // low code bits
constexpr uint64_t kHi = 0xAAAAAAAAAAAAAAAAull;            // high code bits

// 32 bases of a row from base i on, LSB-first 2-bit codes: a funnel shift
// of two staged words (words past the row's nw read 0)
__device__ __forceinline__ uint64_t bases_at(const uint64_t* w, int64_t nw,
                                             int64_t i) {
  const int64_t q = i >> 5;
  const uint64_t lo = q < nw ? w[q] : 0;
  const uint64_t hi = q + 1 < nw ? w[q + 1] : 0;
  const int sh = 2 * (int)(i & 31);
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
}

// the 32 2-bit groups of x in reverse order
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & kLo) | ((x & kLo) << 1);
}

// the sum of the bases in the low nb 2-bit groups of x (nb < 32)
__device__ __forceinline__ int base_sum(uint64_t x, int nb) {
  x &= (1ull << (2 * nb)) - 1;
  return 2 * __popcll(x & kHi) + __popcll(x & kLo);
}

template <int kThreads, int kJ>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
seed_superchunk_kernel(const uint8_t* __restrict__ wire, int64_t row_bytes,
                       const int32_t* __restrict__ dir, int64_t n_dir,
                       const int64_t* __restrict__ hs, int64_t n_hs, int cap,
                       int m_out, uint64_t* __restrict__ g_words,
                       int64_t* __restrict__ g_anc,
                       uint8_t* __restrict__ g_keep,
                       int64_t* __restrict__ out) {
  constexpr int kTileP = kThreads * kJ;
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int s_first[kTileP];  // a tile's positions: first slot,
  __shared__ int s_lo[kTileP];     // bucket start,
  __shared__ int s_yk[kTileP];     // yval | strand << 8
  __shared__ int s_last[kThreads];  // each thread's last xval
  __shared__ int s_prev_x;          // xval of the previous tile's last position
  __shared__ int64_t s_ln;
  // the staged row (when it fits), the first n_sm slots' anchors, then their
  // keep flags; slots from n_sm on in the scratch, m_out - n_sm a row
  extern __shared__ uint64_t s_dyn[];
  const int64_t pad_bytes = row_bytes - 8;
  const int64_t nw = (pad_bytes + 7) >> 3;
  const bool row_smem = nw <= kRowSmemWords;
  const int n_sm = m_out < kSmemSlots ? m_out : kSmemSlots;
  uint64_t* words = row_smem ? s_dyn : g_words + (int64_t)blockIdx.x * nw;
  int64_t* s_anc = reinterpret_cast<int64_t*>(s_dyn + (row_smem ? nw : 0));
  uint8_t* s_keep = reinterpret_cast<uint8_t*>(s_anc + n_sm);
  const int64_t g_row = (int64_t)blockIdx.x * (m_out - n_sm);

  const int tid = threadIdx.x;
  const uint8_t* pk = wire + (int64_t)blockIdx.x * row_bytes;
  const bool aligned = (reinterpret_cast<uintptr_t>(pk) & 7) == 0;
  for (int64_t i = tid; i < nw; i += kThreads) {
    uint64_t v = 0;
    if (aligned && 8 * i + 8 <= pad_bytes) {
      v = reinterpret_cast<const uint64_t*>(pk)[i];
    } else {
      for (int b = 0; b < 8 && 8 * i + b < pad_bytes; b++)
        v |= (uint64_t)pk[8 * i + b] << (8 * b);
    }
    words[i] = v;
  }
  if (tid == 0) {
    uint64_t ln_u = 0;
    for (int b = 0; b < 8; b++) ln_u |= (uint64_t)pk[pad_bytes + b] << (8 * b);
    s_ln = (int64_t)ln_u;
    s_prev_x = 0;
  }
  __syncthreads();
  const int64_t ln = s_ln;
  // positions p with k = kFirst + kAlpha*p < ln - kSpan
  const int64_t n_pos = ln > kFirst + kSpan
                            ? (ln - kFirst - kSpan + kAlpha - 1) / kAlpha
                            : 0;
  // GC-skew init bias: 2*(sum b[0..span-1) - sum b[span..2*span-1))
  const int bias = 2 * (base_sum(bases_at(words, nw, 0), kSpan - 1)
                        - base_sum(bases_at(words, nw, kSpan), kSpan - 1));
  const uint64_t mix = bases_at(words, nw, kSpan - 1 - kNMix) & kMaskMix;

  int probed = 0;  // block-uniform: entries of all earlier tiles
  for (int64_t t0 = 0; t0 < n_pos; t0 += kTileP) {
    int xv[kJ], yk[kJ];
#pragma unroll
    for (int j = 0; j < kJ; j++) {
      const int64_t p = t0 + tid * kJ + j;
      xv[j] = 0;
      yk[j] = 0;
      if (p < n_pos) {
        const int64_t k = kFirst + (int64_t)kAlpha * p;
        const uint64_t win = bases_at(words, nw, k) & kMaskWin;
        const int wsum = 2 * __popcll(win & kHi) + __popcll(win & kLo);
        const uint64_t wh = p == 0 ? (win & ~kMaskMix) | mix : win;
        const bool fwd = 2 * wsum - 3 * kSpan + bias > 0;
        const uint64_t v = fwd ? rev2(wh) >> (64 - 2 * kSpan)
                               : ~wh & kMaskWin;
        uint32_t best = kMaskW + 1;
        int tsel = 0;
#pragma unroll
        for (int idx = 0; idx < kNOff; idx++) {
          const uint32_t c = (uint32_t)(v >> (2 * (kNOff - 1 - idx))) & kMaskW;
          if (c < best) {
            best = c;
            tsel = idx;
          }
        }
        const uint64_t y =
            fwd ? rev2(bases_at(words, nw, k + tsel + kWeight)) >> 56
                : ~bases_at(words, nw, k + kSpan - kWeight - 4 - tsel) & 0xff;
        xv[j] = (int)best;
        yk[j] = (int)y | (fwd ? 0 : 1 << 8);
      }
    }
    s_last[tid] = xv[kJ - 1];
    __syncthreads();
    // every dir gather of the thread in flight before any is used
    int lo[kJ], hi[kJ];
    bool probe[kJ];
#pragma unroll
    for (int j = 0; j < kJ; j++) {
      const int prev = j ? xv[j - 1] : (tid ? s_last[tid - 1] : s_prev_x);
      probe[j] = t0 + tid * kJ + j < n_pos && xv[j] != prev;
      const int64_t xc = xv[j] < n_dir - 2 ? xv[j] : n_dir - 2;
      lo[j] = probe[j] ? dir[xc] : 0;
      hi[j] = probe[j] ? dir[xc + 1] : 0;
    }
    int cnt[kJ], first[kJ], tile_total;
#pragma unroll
    for (int j = 0; j < kJ; j++)
      cnt[j] = hi[j] - lo[j] < cap ? hi[j] - lo[j] : cap;
    BlockScan(scan_tmp).ExclusiveSum(cnt, first, tile_total);
#pragma unroll
    for (int j = 0; j < kJ; j++) {
      s_first[tid * kJ + j] = first[j];
      s_lo[tid * kJ + j] = lo[j];
      s_yk[tid * kJ + j] = yk[j];
    }
    __syncthreads();
    // the flat emission loop over the tile's slots below m_out
    const int n_emit = m_out - probed < tile_total ? m_out - probed
                                                   : tile_total;
    for (int e = tid; e < n_emit; e += kThreads) {
      int a = 0, b = kTileP;  // the last position whose first slot is <= e
      while (b - a > 1) {
        const int mid = (a + b) >> 1;
        if (s_first[mid] <= e) a = mid;
        else b = mid;
      }
      const int64_t k = kFirst + (int64_t)kAlpha * (t0 + a);
      const int yv = s_yk[a] & 0xff;
      const int strand = s_yk[a] >> 8;
      int64_t ei = (int64_t)s_lo[a] + (e - s_first[a]);
      ei = ei < 0 ? 0 : (ei > n_hs - 1 ? n_hs - 1 : ei);
      const uint64_t ent = (uint64_t)hs[ei];
      const uint64_t ent_y = ent & kMaskY;
      const uint64_t val = ent_y ^ (uint64_t)yv;
      const bool y_ok = val == 0 || val < ((val & (~val + 1)) << 2);
      const bool same = (int)((ent >> 61) & 1) == strand;
      const uint64_t cordy = (uint64_t)(same ? k : ln - 1 - k);
      uint64_t anc = ent - (cordy << 20) + cordy - ent_y;
      anc = same ? (anc & ~kFlagStrand) : (anc | kFlagStrand);
      const int slot = probed + e;
      if (slot < n_sm) {
        s_anc[slot] = (int64_t)anc;
        s_keep[slot] = y_ok ? 1 : 0;
      } else {
        g_anc[g_row + slot - n_sm] = (int64_t)anc;
        g_keep[g_row + slot - n_sm] = y_ok ? 1 : 0;
      }
    }
    probed += tile_total;
    if (tid == kThreads - 1) s_prev_x = xv[kJ - 1];
    // the tile's tables and scan_tmp are rewritten by the next tile
    __syncthreads();
  }

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

// Words of its staged bases a row keeps in the device scratch (rows of
// more than 131,072 bases): the wrapper allocates rows times that many.
int64_t lt_seed_superchunk_row_words(int64_t row_bytes) {
  const int64_t nw = (row_bytes - 8 + 7) >> 3;
  return nw > kRowSmemWords ? nw : 0;
}

// Launches the kernel on `stream` for `rows` wire rows of `row_bytes` bytes
// (pad/4 bases + 8 length bytes); m_out >= 1. out is (rows, m_out + 1)
// int64; g_anc and g_keep hold rows * lt_seed_superchunk_scratch_slots
// slots and g_words rows * lt_seed_superchunk_row_words words (each null
// when that is 0). Returns the cudaError_t of the launch (0: launched).
int lt_seed_superchunk(const uint8_t* wire, int64_t rows, int64_t row_bytes,
                       const int32_t* dir, int64_t n_dir, const int64_t* hs,
                       int64_t n_hs, int cap, int m_out, uint64_t* g_words,
                       int64_t* g_anc, uint8_t* g_keep, int64_t* out,
                       void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (m_out < 1 || rows > 0x7fffffff || row_bytes <= 8 ||
      (lt_seed_superchunk_scratch_slots(m_out) > 0) != (g_anc != nullptr) ||
      (g_anc != nullptr) != (g_keep != nullptr) ||
      (lt_seed_superchunk_row_words(row_bytes) > 0) != (g_words != nullptr))
    return (int)cudaErrorInvalidValue;
  // past 48 KB of dynamic shared memory (a staged row of 131,072 bases and
  // 4,096 slots take 68 KB): the attribute, once a device
  const bool small = rows <= kSmallGrid;
  const auto kernel = small ? seed_superchunk_kernel<256, 3>
                            : seed_superchunk_kernel<128, 5>;
  static bool attr_set[2][64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64 || !attr_set[small][dev]) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRowSmemWords * 8 + kSmemSlots * 9);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) attr_set[small][dev] = true;
  }
  const int n_sm = m_out < kSmemSlots ? m_out : kSmemSlots;
  const int64_t nw = (row_bytes - 8 + 7) >> 3;
  const size_t smem = (size_t)(nw <= kRowSmemWords ? nw * 8 : 0)
                      + (size_t)n_sm * (sizeof(int64_t) + 1);
  kernel<<<(unsigned)rows, small ? 256 : 128, smem, (cudaStream_t)stream>>>(
      wire, row_bytes, dir, n_dir, hs, n_hs, cap, m_out, g_words, g_anc,
      g_keep, out);
  return (int)cudaGetLastError();
}

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
