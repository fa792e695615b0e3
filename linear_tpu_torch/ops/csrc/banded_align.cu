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
// Design: one block a pair, one thread a diagonal k (KW = 2W threads,
// rounded up to whole warps; KW <= 1024), all pairs in one launch and no
// substitution tensor: thread k compares the query base of row i with the
// reference base at j - 1 straight from the code arrays. The row's gap
// chain r[k] = max over t <= k of (M[t] - (k - t)) is written as
// (inclusive prefix max of M[t] + t) - k: a five-step shuffle scan in each
// warp, then the warps' maxima through shared memory. Thread k keeps its
// own cell of the previous row in a register (the diagonal move) and reads
// its right neighbour's from shared memory (the move from above). Cells
// outside 0 <= j <= m are NEG = -2^28 before and after the scan, as in JAX;
// the two formulations of the prefix max differ only among cells near NEG,
// which never reach the returned score. Rows past n are not run (in JAX
// they do not evolve).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kMatch = 3;
constexpr int kMismatch = -2;
constexpr int kGap = -1;
constexpr int kMaxKW = 1024;

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kMaxKW)
    banded_align_kernel(const uint8_t* __restrict__ a,
                        const uint8_t* __restrict__ bpad,
                        const int32_t* __restrict__ nm, int64_t L, int W,
                        int32_t* __restrict__ out) {
  __shared__ int row_sh[kMaxKW + 1];
  __shared__ int warp_sh[32];
  const int KW = 2 * W;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  const uint8_t* q = a + b * L;
  const uint8_t* r = bpad + b * (L + KW);
  const int64_t n = min((int64_t)nm[2 * b], L);
  const int64_t m = nm[2 * b + 1];
  const bool lane_ok = k < KW;
  // row 0: H[0][j] = 0 for 0 <= j <= m
  int64_t j = (int64_t)k - W;
  int prev = (lane_ok && j >= 0 && j <= m) ? 0 : kNeg;
  row_sh[k] = prev;
  if (k == 0) row_sh[KW] = kNeg;  // the lane right of the band
  int best = 0;
  for (int64_t i = 1; i <= n; ++i) {
    __syncthreads();  // row i - 1 is in row_sh
    j = i + k - W;
    const bool out_of_band = !lane_ok || j < 0 || j > m;
    int v = kNeg;
    if (!out_of_band) {
      if (j == 0) {
        v = 0;
      } else {
        const int up = row_sh[k + 1];
        const int sub = q[i - 1] == r[i - 1 + k] ? kMatch : kMismatch;
        v = max(prev + sub, up + kGap);
      }
    }
    // inclusive prefix max of v + k over the band
    int s = v + k;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = max(s, o);
    }
    if (lane == 31) warp_sh[warp] = s;
    __syncthreads();  // every thread has read row_sh; warp maxima are in
    int carry = lane < warp ? warp_sh[lane] : kNeg;
    if (nwarps > 1) carry = warp_max(carry);
    const int cell = out_of_band ? kNeg : max(s, carry) - k;
    if (j == m || i == n) best = max(best, cell);
    prev = cell;
    row_sh[k] = cell;
  }
  // the pair's best over the block
  best = warp_max(best);
  __syncthreads();
  if (lane == 0) warp_sh[warp] = best;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_sh[lane] : 0;
    v = warp_max(v);
    if (lane == 0) out[b] = v;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: a (B, L) and bpad (B, L + 2W) uint8
// codes (the reference at column W), nm (B, 2) int32 true lengths; out (B,)
// int32. 1 <= 2W <= 1024. Returns the cudaError_t of the launch.
int lt_banded_align(const uint8_t* a, const uint8_t* bpad, const int32_t* nm,
                    int64_t B, int64_t L, int W, int32_t* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W < 1 || 2 * W > kMaxKW || L < 1 || B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int threads = (2 * W + 31) / 32 * 32;
  banded_align_kernel<<<(unsigned)B, threads, 0, (cudaStream_t)stream>>>(
      a, bpad, nm, L, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
