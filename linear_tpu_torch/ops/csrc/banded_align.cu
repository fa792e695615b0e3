// Banded semi-global alignment scores for Hopper (sm_90a).
//
// Replaces linear_tpu/ops/align_pallas.py:142, the JAX package's only
// pl.pallas_call (_ba_kernel, :62): a grid of (pairs / 8, L) programs whose
// second, sequential axis walks the DP rows, with the band row and the
// running best kept in VMEM scratch across it, fed by a (B, L, KW)
// substitution tensor that XLA builds beforehand (L * KW * 4 bytes a pair,
// which is why JAX calls it 64 pairs at a time). The plain PyTorch version
// beside it is linear_tpu_torch/ops/align_pallas.py:banded_align_reference.
// The score: +3 / -2 / linear gap -1, band j - i in [-W, W), free end gaps
// in both sequences, best over row n and column m, at least 0.
//
// What bounds it on the card: the rows are serial. Row i needs row i - 1,
// and inside a row the gap chain H[i][j - 1] -> H[i][j] is a prefix
// operation across the band, so each row costs a block-wide scan and two
// barriers; a pair of n query bases takes n such steps. The bytes are small
// (each pair's codes are read once a row from L1, 4 bytes out).
//
// Design: one block a pair, all pairs in one launch and no substitution
// tensor: a thread compares the query base of row i with the reference base
// at j - 1 straight from the code arrays. The block has min(KW, 1024)
// threads, rounded up to whole warps, and each owns c = ceil(KW / threads)
// consecutive diagonals (c = 1 up to KW = 1024). The row's gap chain r[k] =
// max over t <= k of (M[t] - (k - t)) is written as (inclusive prefix max of
// M[t] + t) - k: a thread takes the running max of v + k over its
// diagonals, a five-step shuffle scan in each warp and the warps' maxima
// through shared memory give the max of the diagonals before it, and a
// second pass over its diagonals writes max(carry, running max) - k. The
// previous row (KW + 1 ints, a sentinel at KW) sits in dynamic shared
// memory, or past its budget in the pair's part of a device scratch;
// diagonal k reads its own cell (the diagonal move) and its right
// neighbour's (the move from above). At c = 1 (a specialisation of the
// kernel) the row is always in shared memory and a thread keeps its own
// cell and candidate in registers; above, the row's candidates (KW ints)
// follow the row. Cells outside 0 <= j <= m are NEG = -2^28 before and
// after the scan, as in JAX; the two formulations of the prefix max differ
// only among cells near NEG, which never reach the returned score. Rows
// past n are not run (in JAX they do not evolve).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kMatch = 3;
constexpr int kMismatch = -2;
constexpr int kGap = -1;
constexpr int kMaxThreads = 1024;
constexpr int64_t kSmemBudget = 200 * 1024;  // the rows in shared memory

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// kOne: KW <= 1024, one diagonal a thread (c = 1), the row always in shared
// memory and the thread's own cell and candidate in registers; else c from
// the block size, the rows in shared memory or the scratch.
template <bool kOne>
__global__ void __launch_bounds__(kMaxThreads)
    banded_align_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ bpad,
                        const int32_t* __restrict__ nm, int64_t L, int W,
                        int* scratch, int32_t* __restrict__ out) {
  extern __shared__ int band_sh[];
  __shared__ int warp_sh[32];
  const int KW = 2 * W;
  const int c = kOne ? 1 : (KW + blockDim.x - 1) / blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  // the pair's rows (band_ints): the row, and past it at c > 1 the row's
  // candidates
  int* row = kOne || !scratch ? band_sh : scratch + b * (2 * (int64_t)KW + 1);
  int* vb = row + KW + 1;  // c > 1 only
  const uint8_t* q = a + b * L;
  const uint8_t* r = bpad + b * (L + KW);
  const int64_t n = min((int64_t)nm[2 * b], L);
  const int64_t m = nm[2 * b + 1];
  const int k0 = tid * c;
  const int k1 = min(k0 + c, KW);
  for (int k = k0; k < k1; ++k) {  // row 0: H[0][j] = 0 for 0 <= j <= m
    const int64_t j = (int64_t)k - W;
    row[k] = (j >= 0 && j <= m) ? 0 : kNeg;
  }
  if (tid == 0) row[KW] = kNeg;  // the lane right of the band
  int best = 0;
  int prev = kOne && k0 < KW ? row[k0] : kNeg;  // c = 1: its cell of row i - 1
  for (int64_t i = 1; i <= n; ++i) {
    __syncthreads();  // row i - 1 is in row
    // the candidate of diagonal k (kNeg outside the band) from its own cell
    // of row i - 1
    auto cand = [&](int k, int diag) {
      const int64_t j = i + k - W;
      if (k >= KW || j < 0 || j > m) return kNeg;
      if (j == 0) return 0;
      const int sub = q[i - 1] == r[i - 1 + k] ? kMatch : kMismatch;
      return max(diag + sub, row[k + 1] + kGap);
    };
    // diagonal k's cell from the prefix max of v + t through it
    auto put = [&](int k, int through) {
      const int64_t j = i + k - W;
      const int cell = (k >= KW || j < 0 || j > m) ? kNeg : through - k;
      if (j == m || i == n) best = max(best, cell);
      if (k < KW) row[k] = cell;
      return cell;
    };
    // c = 1 runs straight-line code: a loop over the one diagonal measured
    // 1.7 times slower on the H100 (kernel_times.py, W 100)
    int run;
    if (kOne) {
      run = cand(k0, prev) + k0;
    } else {
      run = kNeg - 1;  // below every v + k
      for (int k = k0; k < k1; ++k) {
        vb[k] = cand(k, row[k]);
        run = max(run, vb[k] + k);
      }
    }
    // the max of run over the threads before this one
    int s = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = max(s, o);
    }
    int carry = s;  // c = 1: s already holds this thread's diagonal
    if (!kOne) {
      carry = __shfl_up_sync(0xffffffffu, s, 1);
      if (lane == 0) carry = kNeg - 1;
    }
    if (lane == 31) warp_sh[warp] = s;
    __syncthreads();  // every thread has read row; warp maxima are in
    if (nwarps > 1)
      carry = max(carry, warp_max(lane < warp ? warp_sh[lane] : kNeg - 1));
    if (kOne) {
      prev = put(k0, carry);
    } else {
      for (int k = k0; k < k1; ++k) {
        carry = max(carry, vb[k] + k);
        put(k, carry);
      }
    }
  }
  // the pair's best over the block
  best = warp_max(best);
  __syncthreads();
  if (lane == 0) warp_sh[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_max(lane < nwarps ? warp_sh[lane] : 0);
    if (lane == 0) out[b] = v;
  }
}

// Ints a pair's rows take: KW + 1 (the row) at KW = 2W <= 1024, where a
// thread holds its one diagonal's candidate in a register, else 2 KW + 1.
int64_t band_ints(int W) {
  const int64_t KW = 2 * (int64_t)W;
  return KW <= kMaxThreads ? KW + 1 : 2 * KW + 1;
}

}  // namespace

extern "C" {

// Scratch ints a pair needs at W: 0 while its rows fit the shared memory a
// block may take, else band_ints(W).
int64_t lt_banded_align_scratch(int W) {
  return band_ints(W) * 4 > kSmemBudget ? band_ints(W) : 0;
}

// Launches the kernel on `stream`: a (B, L) and bpad (B, L + 2W) uint8
// codes (the reference at column W), nm (B, 2) int32 true lengths; W >= 1;
// scratch B * lt_banded_align_scratch(W) ints (null when that is 0); out
// (B,) int32. Returns the cudaError_t of the launch.
int lt_banded_align(const uint8_t* a, const uint8_t* bpad, const int32_t* nm,
                    int64_t B, int64_t L, int W, int* scratch, int32_t* out,
                    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || W > (1 << 29) || L < 1 || B > 0x7fffffff ||
      (lt_banded_align_scratch(W) > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = scratch ? 0 : (size_t)band_ints(W) * sizeof(int);
  if (2 * W <= kMaxThreads) {
    banded_align_kernel<true><<<(unsigned)B, (2 * W + 31) / 32 * 32, smem,
                                st>>>(a, bpad, nm, L, W, nullptr, out);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        banded_align_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  banded_align_kernel<false><<<(unsigned)B, kMaxThreads, smem, st>>>(
      a, bpad, nm, L, W, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
