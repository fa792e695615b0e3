// Padded seeding and anchor compaction of the multi-process path, for
// Hopper (sm_90a).
//
// Replaces three jitted XLA kernels of linear_tpu/ops/seeding.py:
//   K1  batch_seed_anchors (:210; _hash_scan_batch :74, _minimizer_xy_batch
//       :129, _probe_and_anchor :165): the exact rolling-hash scan;
//   K2  batch_seed_anchors_fast (:772; _closed_form_states :672), and the
//       same computation with an xval-shard mask in the shard_map bodies of
//       linear_tpu/parallel/mesh.py;
//   K3  _compact_anchors (:420): stable compaction of the kept anchors.
// The plain PyTorch versions beside them are linear_tpu_torch/ops/
// seeding.py: batch_seed_anchors_reference, batch_seed_anchors_fast_
// reference and compact_anchors_reference; the module docstring there
// states what is computed. Outputs are identical on every element: the
// (B, P, cap) anchors hold 0 where keep is 0, and K3's rows hold 0 past
// their kept anchors.
//
// What bounds them on the card: bytes. The (B, P, cap) grid is written
// once (9 bytes a slot; 256 rows of pad 8192 at cap 416 are 521 MB), and K3
// reads it back; the probe gathers two dir words per probed position from a
// 268 MB table and one 8-byte hs entry per bucket slot, far apart. The
// arithmetic per position (a 21-base window, nine 13-mer candidates, four
// YValue bases) is small.
//
// Design:
//   K1 has no serial roll (rolled by a thread a read, it reached 9 % of
//      its bound). The roll's state after any step depends on the last 21
//      appended bases only: the mask drops older bits of h, crh shifts
//      them off, and x telescopes to a window sum plus a per-read bias.
//      What no window holds is per read: k0 (hashInit's first N-free
//      window), the init window's share of crh while k < 41, and the x
//      bias. A pre-pass, one warp a read, finds k0 by ballot and writes
//      those three to a (3, B) scratch; every call position then has a
//      closed form over a few dozen bases, exact with N bases
//      (seeding.py:_scan_states_closed, held against JAX's scan).
//   K1 and K2: one block per (read, tile of kTile positions). The
//      first kTile + 1 threads each compute one position (the tile's
//      positions and the one before them, for the dedup): xval, yval and
//      strand from the pre-pass and the closed form (K1) or from K2's
//      closed form (exact for N-free reads), then the bucket bounds.
//      Then all threads walk the tile's kTile * cap slots in flat order,
//      so that the big (B, P, cap) writes are coalesced, and each probes
//      one hs entry.
//   K3: a stream of the flags over many blocks a row, one pass. A block
//      takes a chunk of kCChunk (16,384) flags of a row: B * ceil(n /
//      kCChunk) blocks (3,072 at (256, 191,488), several waves over the
//      132 SMs), each thread four 16-byte windows, a warp's 512
//      contiguous bytes a load, all loads issued before any is used; a row
//      whose base is not 16-aligned loads its ragged head and tail byte by
//      byte. A chunk with nothing kept stops at a __syncthreads_or;
//      otherwise one block scan of the four rounds' kept counts, packed 16
//      bits apart in one 64-bit word, gives each kept anchor its place in
//      the chunk in flat order. The chunk's place in its row is the sum of
//      the kept counts of the chunks before it, found by a decoupled
//      look-back: blocks take chunks in the order of an atomic ticket (so a
//      block waits only on chunks that have started; it loads the flags of
//      chunk blockIdx.x while the ticket is in flight, and again only if
//      the ticket names another), publish their count at once and their
//      inclusive prefix once known, and one warp reads 32 predecessors at a
//      time back to the nearest published prefix. The threads keep only
//      their counts through the scan and the look-back, and read their
//      windows again (from L1) to write the kept anchors, so that more
//      blocks fit an SM. The kept anchors go out in flat order, so the
//      result is stable by construction. The slots of a row past its count
//      are zeroed in n_chunks stripes, by the next row's chunk blocks (and
//      n_chunks more blocks for the last row), each once the row's last
//      chunk has published the row's count: no block waits on a later
//      ticket, and no one block zeroes a whole row. The scratch is a
//      status word a chunk and the ticket (24 KB at (256, 191,488)),
//      zeroed before each launch.
// All uint64 arithmetic wraps as in the JAX kernels; right shifts are on
// unsigned values.
#include <cstdint>

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 21;
constexpr int kWeight = 13;
constexpr int kNOff = kSpan - kWeight + 1;  // 9 minimizer candidates
constexpr uint32_t kMaskW = (1u << (2 * kWeight)) - 1;
constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kFlagStrand = 1ull << 61;
constexpr uint64_t kMaskH = (1ull << (2 * kSpan - 2)) - 1;

constexpr int kInitThreads = 128;  // four reads a pre-pass block
constexpr int kThreads = 256;
constexpr int kTile = 64;  // call positions a probe block
constexpr int kCThreads = 256;
constexpr int kCWin = 4;                         // 16-byte windows a thread
constexpr int64_t kCChunk = kCThreads * kCWin * 16;  // 16,384 flags a block
// K3's chunk status words: 0 while unpublished, else a flag over the count
constexpr uint64_t kAggregate = 1ull << 62;  // the chunk's own count
constexpr uint64_t kPrefix = 1ull << 63;     // the row's count through it
constexpr uint64_t kFlags = kAggregate | kPrefix;
constexpr uint64_t kValue = kAggregate - 1;

// row[i] with i clamped into the row, as JAX's clipped gathers read it
__device__ __forceinline__ uint64_t clamped(const uint8_t* __restrict__ row,
                                            int64_t L, int64_t i) {
  i = i < 0 ? 0 : (i > L - 1 ? L - 1 : i);
  return row[i];
}

// K1's pre-pass: one warp a read finds k0, the first N-free 21-window (0
// if none), 32 positions a round by ballot, and lane 0 writes the per-read
// state that no call position rebuilds from its own window: k0, T (bits
// 2..41 of hashInit's crh, the init window's share of crh while k < 41)
// and the x bias 2 * sum(init) - 63 - 2 * sum(b[21 .. 41)).
__global__ void __launch_bounds__(kInitThreads)
scan_init_kernel(const uint8_t* __restrict__ seqs, int64_t B, int64_t L,
                 int64_t* __restrict__ pre) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      (int64_t)blockIdx.x * (kInitThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves
  const uint8_t* row = seqs + b * L;
  // 32 positions a round: the N-free run ending at each (positions past
  // the row count as N), from the ballot of N positions and the run
  // carried from the round before; a window [j, j + n_win) is N-free when
  // the run ending at its last base reaches n_win
  const int n_win = L < kSpan ? (int)L : kSpan;
  int64_t k0 = 0;
  int carry = 0;
  for (int64_t base = 0; base < L; base += 32) {
    const int64_t p = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, p >= L || row[p] == 4);
    const unsigned below = m & (0xffffffffu >> (31 - lane));
    const int run = below ? lane - (31 - __clz((int)below)) : lane + 1 + carry;
    const unsigned ok = __ballot_sync(0xffffffffu, run >= n_win);
    if (ok) {
      k0 = base + (__ffs((int)ok) - 1) - (n_win - 1);
      break;
    }
    carry = __shfl_sync(0xffffffffu, run, 31);
  }
  if (lane == 0) {
    uint64_t crh0 = 0;
    int64_t sum = 0;
    for (int t = 0; t < kSpan - 1; t++) {
      const uint64_t v = clamped(row, L, k0 + t);
      crh0 += (3ull - v) << (2 * (t + 1));
      sum += 2 * (int64_t)v - 2 * (int64_t)clamped(row, L, kSpan + t);
    }
    pre[b] = k0;
    pre[B + b] = (int64_t)((crh0 >> 2) & kMaskH);
    pre[2 * B + b] = sum - 3 * (kSpan - 1) - 3;
  }
}

// K1's states at call k >= kSpan from the pre-pass, equal to the serial
// roll's (seeding.py:_scan_states_closed states the closed form). u_m is
// the value the roll appends at step m, b[m + 20], and b[k0 + m - 1] for
// m <= 20 (the init window).
__device__ __forceinline__ void scan_closed_form(
    const uint8_t* __restrict__ row, int64_t L, int64_t k, int64_t k0,
    uint64_t T, int64_t bias, uint64_t& h, uint64_t& crh, int64_t& x) {
  uint64_t hs = 0, cs = 0;
  int64_t wsum = 0;
  uint64_t uk;
  if (k >= 2 * kSpan - 1) {
    // the init window is shifted out: u_{k-20+t} = b[k+t], the x window
    for (int t = 0; t < kSpan - 1; t++) {
      const uint64_t u = clamped(row, L, k + t);
      wsum += (int64_t)u;
      hs += u << (2 * (kSpan - 1 - t));
      cs += ((3ull - u) & 3ull) << (2 * t);
    }
    uk = clamped(row, L, k + kSpan - 1);
    wsum += (int64_t)uk;
  } else {
    for (int t = 0; t < kSpan - 1; t++) {  // u_{k-20+t}, weight 4^(20-t)
      const int64_t m = k - (kSpan - 1) + t;
      const uint64_t u = m <= kSpan - 1 ? clamped(row, L, k0 + m - 1)
                                        : clamped(row, L, m + kSpan - 1);
      hs += u << (2 * (kSpan - 1 - t));
      if (m >= kSpan) cs += ((3ull - u) & 3ull) << (2 * t);
    }
    uk = clamped(row, L, k + kSpan - 1);
    for (int t = 0; t < kSpan; t++) wsum += (int64_t)clamped(row, L, k + t);
    cs += T >> (2 * (k - kSpan));
  }
  h = uk + (hs & ((1ull << (2 * kSpan)) - 1));
  crh = ((3ull - uk) << (2 * kSpan - 2)) + cs;
  x = bias + 2 * wsum;
}

// hashNextX at call k from its states: xval, yval and strand (1: reverse)
__device__ __forceinline__ void minimizer_xy(const uint8_t* __restrict__ row,
                                             int64_t L, int64_t k, uint64_t h,
                                             uint64_t crh, int64_t x,
                                             int& xval, int& yval,
                                             int& strand) {
  const bool fwd = x > 0;
  const uint64_t v = fwd ? h : crh;
  uint32_t best = kMaskW + 1;
  int tsel = 0;
  for (int idx = 0; idx < kNOff; idx++) {
    const uint32_t c = (uint32_t)(v >> (2 * (kNOff - 1 - idx))) & kMaskW;
    if (c < best) {
      best = c;
      tsel = idx;
    }
  }
  int y = 0;
  for (int i = 0; i < 4; i++) {
    int64_t val;
    if (fwd) {
      const int64_t pf = k + tsel + kWeight + i;
      val = pf < L ? (int64_t)clamped(row, L, pf) : 0;
    } else {
      const int64_t pr = k + kSpan - tsel - kWeight - 1 - i;
      val = 3 - (pr >= 0 ? (int64_t)clamped(row, L, pr) : 0);
    }
    y = (y << 2) + (val >= 0 && val <= 3 ? (int)val : 0);
  }
  xval = (int)best;
  yval = y;
  strand = fwd ? 0 : 1;
}

// the closed-form states of call k (exact for N-free reads): the window
// b[k .. k+21), or for k < 2*kSpan-1 the init window's tail then the
// bases appended from 2*kSpan-1; x from the plain window and the bias
__device__ __forceinline__ void closed_form(const uint8_t* __restrict__ row,
                                            int64_t L, int64_t k, int bias,
                                            uint64_t& h, uint64_t& crh,
                                            int64_t& x) {
  h = 0;
  crh = 0;
  int64_t wsum = 0;
  const bool mixed = k < 2 * kSpan - 1;
  int64_t n_app = k - kSpan + 1;
  n_app = n_app < kSpan ? n_app : kSpan;
  const int64_t n_init = kSpan - n_app;
  for (int t = 0; t < kSpan; t++) {
    const uint64_t b = clamped(row, L, k + t);
    wsum += (int64_t)b;
    const uint64_t w =
        !mixed ? b
               : clamped(row, L, t < n_init ? kSpan - 1 - n_init + t
                                            : 2 * kSpan - 1 + t - n_init);
    h = (h << 2) + w;
    crh += (3ull - w) << (2 * t);
  }
  x = 2 * wsum - 3 * kSpan + bias;
}

// K1 (kScan, states from the pre-pass and the closed form above) and K2
// (closed_form): the tile's positions, then its slots
template <bool kScan>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint8_t* __restrict__ seqs, int64_t L,
             const int64_t* __restrict__ lens,
             const int64_t* __restrict__ pre, int first, int alpha,
             int64_t P, const int32_t* __restrict__ dir, int64_t n_dir,
             const int64_t* __restrict__ hs, int64_t n_hs, int cap,
             int64_t x_base, int64_t x_hi, int64_t* __restrict__ anc,
             uint8_t* __restrict__ keep) {
  __shared__ int s_x[kTile + 1];
  __shared__ int s_y[kTile];
  __shared__ int s_strand[kTile];
  __shared__ int s_cnt[kTile];  // probed slots, 0 when not processed
  __shared__ int64_t s_lo[kTile];
  __shared__ int s_bias;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const uint8_t* row = seqs + b * L;
  const int64_t ln = lens[b];
  const int64_t lim = ln - kSpan;

  if (!kScan && tid == 0) {
    // 2 * (sum b[0 .. kSpan-1) - sum b[kSpan .. 2*kSpan-1)), bases past
    // the row count 0
    int s = 0;
    for (int i = 0; i < kSpan - 1 && i < L; i++) s += row[i];
    for (int i = kSpan; i < 2 * kSpan - 1 && i < L; i++) s -= row[i];
    s_bias = 2 * s;
  }
  if (!kScan) __syncthreads();

  if (tid <= kTile) {
    // thread t: position p0 - 1 + t (t = 0: the dedup's previous position)
    const int64_t p = p0 - 1 + tid;
    const int64_t k = first + (int64_t)alpha * p;
    int xval = 0, yval = 0, strand = 0;
    // a position out of range is never probed, and the one before an
    // in-range position is in range itself (or p = -1: xval 0)
    const bool in_range = p >= 0 && p < P && k < lim;
    if (in_range) {
      uint64_t h, crh;
      int64_t x;
      if (kScan) {
        const int64_t nb = gridDim.y;
        scan_closed_form(row, L, k, pre[b], (uint64_t)pre[nb + b],
                         pre[2 * nb + b], h, crh, x);
      } else {
        closed_form(row, L, k, s_bias, h, crh, x);
      }
      minimizer_xy(row, L, k, h, crh, x, xval, yval, strand);
    }
    s_x[tid] = xval;
    if (tid > 0) {
      const int j = tid - 1;
      s_y[j] = yval;
      s_strand[j] = strand;
      s_cnt[j] = 0;
      s_lo[j] = 0;
      if (in_range) {
        // mark for the bucket probe below, after every s_x is written
        s_cnt[j] = -1;
      }
    }
  }
  __syncthreads();
  if (tid >= 1 && tid <= kTile && s_cnt[tid - 1] < 0) {
    const int j = tid - 1;
    const int64_t xv = s_x[tid];
    int cnt = 0;
    if (xv != s_x[tid - 1] && xv >= x_base && xv < x_hi) {
      int64_t xc = xv - x_base;
      xc = xc < 0 ? 0 : (xc > n_dir - 2 ? n_dir - 2 : xc);
      const int64_t lo = dir[xc];
      const int64_t d = (int64_t)dir[xc + 1] - lo;
      cnt = (int)(d < cap ? d : cap);
      s_lo[j] = lo;
    }
    s_cnt[j] = cnt;
  }
  __syncthreads();

  int64_t n_slots = P - p0 < kTile ? (P - p0) : kTile;
  n_slots *= cap;
  const int64_t base = (b * P + p0) * cap;
  for (int64_t s = tid; s < n_slots; s += kThreads) {
    const int j = (int)(s / cap);
    const int e = (int)(s - (int64_t)j * cap);
    bool kp = false;
    uint64_t a = 0;
    if (e < s_cnt[j]) {
      int64_t ei = s_lo[j] + e;
      ei = ei < 0 ? 0 : (ei > n_hs - 1 ? n_hs - 1 : ei);
      const uint64_t ent = (uint64_t)hs[ei];
      const uint64_t ent_y = ent & kMaskY;
      const uint64_t val = ent_y ^ (uint64_t)s_y[j];
      kp = val == 0 || val < ((val & (~val + 1)) << 2);
      if (kp) {
        const int64_t k = first + (int64_t)alpha * (p0 + j);
        const bool same = (int)((ent >> 61) & 1) == s_strand[j];
        const uint64_t cordy = (uint64_t)(same ? k : ln - 1 - k);
        a = ent - (cordy << 20) + cordy - ent_y;
        a = same ? (a & ~kFlagStrand) : (a | kFlagStrand);
      }
    }
    anc[base + s] = (int64_t)a;
    keep[base + s] = kp ? 1 : 0;
  }
}

// one 16-byte window of flags at `p` (16-aligned): one load when it lies
// inside [lo, hi), else byte loads of its part inside
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

// high bit of each non-zero byte of x
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

__device__ __forceinline__ uint64_t status_load(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void status_store(uint64_t* p, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(p) = v;
}

// K3's view of chunk c of row b: its flags [s, e) in the row, and the
// 16-aligned windows [a0, a0 + 16 n_win) that cover them
struct Chunk {
  const uint8_t* kr;  // the row's flags
  uintptr_t lo, hi, a0;
  int n_win;
};

__device__ __forceinline__ Chunk chunk_of(const uint8_t* keep, int64_t n,
                                          int64_t b, int64_t c) {
  const int64_t s = c * kCChunk;
  const int64_t e = s + kCChunk < n ? s + kCChunk : n;
  Chunk k;
  k.kr = keep + b * n;
  k.lo = reinterpret_cast<uintptr_t>(k.kr + s);
  k.hi = reinterpret_cast<uintptr_t>(k.kr + (e > s ? e : s));
  k.a0 = k.lo & ~(uintptr_t)15;
  k.n_win = (int)((k.hi - k.a0 + 15) >> 4);
  return k;
}

// window r of a thread: j = r * kCThreads + tid for r < kCWin (coalesced,
// a warp's 512 contiguous bytes a load); the last thread's window kCWin is
// the one past kCChunk / 16 that a chunk whose start is not 16-aligned
// has, the last in flat order
__device__ __forceinline__ int window_of(int r, int tid) {
  return r < kCWin ? r * kCThreads + tid
                   : (tid == kCThreads - 1 ? kCWin * kCThreads : 1 << 30);
}

__device__ __forceinline__ uint4 chunk_window(const Chunk& k, int j) {
  return j < k.n_win ? load_window(k.a0 + 16 * (uintptr_t)j, k.lo, k.hi)
                     : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int kept_in(uint4 w) {
  return __popc(nonzero_bytes(w.x)) + __popc(nonzero_bytes(w.y))
         + __popc(nonzero_bytes(w.z)) + __popc(nonzero_bytes(w.w));
}

// K3: the blocks take tickets t in order; t < B * n_chunks is chunk
// c = t % n_chunks of row b = t / n_chunks. Each also zeroes stripe c of
// row b - 1's tail (the last n_chunks tickets that of row B - 1), once that
// row's last chunk has published the row's count. A block waits only on
// lower tickets, which have all started. The flags of chunk blockIdx.x are
// loaded while the ticket is in flight (blocks start in about that order);
// a block whose ticket differs loads its ticket's chunk again.
__global__ void __launch_bounds__(kCThreads)
compact_kernel(const int64_t* __restrict__ anc,
               const uint8_t* __restrict__ keep, int64_t B, int64_t n,
               int64_t n_chunks, int m_out, uint64_t* status,
               unsigned long long* ticket, int64_t* __restrict__ out,
               int32_t* __restrict__ count) {
  using BlockScan = cub::BlockScan<unsigned long long, kCThreads>;
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ int64_t s_ticket, s_excl, s_count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t n_flag_blocks = B * n_chunks;
  if (tid == 0) s_ticket = (int64_t)atomicAdd(ticket, 1ull);
  // each round's kept count, the extra window's in the last
  int cnt[kCWin];
  auto count_chunk = [&](int64_t t) {
    const Chunk k = chunk_of(keep, n, t / n_chunks, t % n_chunks);
    uint4 w[kCWin + 1];
#pragma unroll
    for (int r = 0; r <= kCWin; r++)
      w[r] = chunk_window(k, window_of(r, tid));
#pragma unroll
    for (int r = 0; r < kCWin; r++) cnt[r] = kept_in(w[r]);
    cnt[kCWin - 1] += kept_in(w[kCWin]);
  };
  if (blockIdx.x < n_flag_blocks) count_chunk(blockIdx.x);
  __syncthreads();
  const int64_t t = s_ticket;
  const int64_t b = t / n_chunks;
  const int64_t c = t - b * n_chunks;
  if (b < B) {
    if (t != (int64_t)blockIdx.x) count_chunk(t);  // block-uniform
    // flat order is window order, r-major: one scan of the rounds' counts
    // packed 16 bits apart (a round keeps at most 4,096 + 16) gives each
    // round's total and each thread's place in each round
    unsigned long long pk = 0;
#pragma unroll
    for (int r = 0; r < kCWin; r++)
      pk |= (unsigned long long)cnt[r] << (16 * r);
    unsigned long long off = 0, agg = 0;
    // block-uniform: a chunk with nothing kept skips its scan and writes
    const bool any = __syncthreads_or(pk != 0) != 0;
    if (any) BlockScan(scan_tmp).ExclusiveSum(pk, off, agg);
    int total = 0;
#pragma unroll
    for (int r = 0; r < kCWin; r++) total += (int)((agg >> (16 * r)) & 0xffff);
    uint64_t* st = status + b * n_chunks;
    if (tid < 32) {
      // publish the chunk's count, then look back over its predecessors,
      // 32 at a time, nearest first: sum their counts up to the nearest
      // inclusive prefix (chunk 0 publishes its prefix at once)
      if (lane == 0)
        status_store(st + c, (c ? kAggregate : kPrefix) | (uint64_t)total);
      int64_t excl = 0;
      for (int64_t p = c - 1; p >= 0; p -= 32) {
        const int64_t q = p - lane;
        uint64_t v = kPrefix;  // before chunk 0: a prefix of 0
        if (q >= 0)
          do v = status_load(st + q); while (!(v & kFlags));
        __syncwarp();
        const unsigned pre = __ballot_sync(0xffffffffu, (v & kPrefix) != 0);
        const int last = pre ? __ffs(pre) - 1 : 31;
        int64_t add = lane <= last ? (int64_t)(v & kValue) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          add += __shfl_xor_sync(0xffffffffu, add, o);
        excl += add;
        if (pre) break;
      }
      if (lane == 0) {
        if (c) status_store(st + c, kPrefix | (uint64_t)(excl + total));
        if (c == n_chunks - 1) count[b] = (int32_t)(excl + total);
        s_excl = excl;
      }
    }
    __syncthreads();
    const int64_t excl = s_excl;
    if (pk && excl < m_out) {
      // the kept anchors in flat order; the windows again (from L1)
      const Chunk k = chunk_of(keep, n, b, c);
      const int64_t* ar = anc + b * n;
      int64_t* orow = out + b * (int64_t)m_out;
      // flat index within the row of the first byte of window 0
      const int64_t f_a0 =
          (int64_t)k.a0 - (int64_t)reinterpret_cast<uintptr_t>(k.kr);
      int64_t base = excl, d = 0;
#pragma unroll
      for (int r = 0; r <= kCWin; r++) {
        if (r < kCWin) {  // the round's place; the extra window goes on
          d = base + (int64_t)((off >> (16 * r)) & 0xffff);
          base += (int64_t)((agg >> (16 * r)) & 0xffff);
        }
        const int j = window_of(r, tid);
        const uint4 w = chunk_window(k, j);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; q++) {
          uint32_t mq = nonzero_bytes(words[q]);
          while (mq && d < m_out) {
            const int bit = __ffs(mq) - 1;
            mq &= mq - 1;
            orow[d++] = ar[f_a0 + 16 * (int64_t)j + 4 * q + (bit >> 3)];
          }
        }
      }
    }
  }
  // the zeros: stripe c of [0, m_out) of row b - 1, past its count
  if (b >= 1) {
    const int64_t zb = b - 1;
    const int64_t stripe = (m_out + n_chunks - 1) / n_chunks;
    const int64_t z1 = (c + 1) * stripe < m_out ? (c + 1) * stripe : m_out;
    int64_t z0 = c * stripe;
    if (z0 < z1) {
      if (tid == 0) {
        const uint64_t* last = status + zb * n_chunks + n_chunks - 1;
        uint64_t v;
        do v = status_load(last); while (!(v & kPrefix));
        s_count = (int64_t)(v & kValue);
      }
      __syncthreads();
      z0 = s_count > z0 ? s_count : z0;
      int64_t* orow = out + zb * (int64_t)m_out;
      for (int64_t k = z0 + tid; k < z1; k += kCThreads) orow[k] = 0;
    }
  }
}

}  // namespace

extern "C" {

// K1 (scan = 1) or K2 (scan = 0) on `stream`: seqs (B, L) uint8 codes 0..4,
// lens (B,) int64, dir (n_dir,) int32, hs (n_hs,) int64 -> anc (B, P, cap)
// int64 and keep (B, P, cap) uint8. K1 needs the (3, B) int64 scratch pre
// for its pre-pass; K2 probes the xval range [x_base, x_hi) with dir
// rebased to x_base. Returns the cudaError_t of the launches (0: launched).
int lt_seed_anchors(const uint8_t* seqs, int64_t B, int64_t L,
                    const int64_t* lens, int scan, int first, int alpha,
                    int64_t P, const int32_t* dir, int64_t n_dir,
                    const int64_t* hs, int64_t n_hs, int cap, int64_t x_base,
                    int64_t x_hi, int64_t* pre, int64_t* anc, uint8_t* keep,
                    void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((P + kTile - 1) / kTile), (unsigned)B);
  if (scan) {
    constexpr int kReads = kInitThreads / 32;
    scan_init_kernel<<<(unsigned)((B + kReads - 1) / kReads), kInitThreads, 0,
                       st>>>(seqs, B, L, pre);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    probe_kernel<true><<<grid, kThreads, 0, st>>>(
        seqs, L, lens, pre, first, alpha, P, dir, n_dir, hs, n_hs, cap,
        x_base, x_hi, anc, keep);
  } else {
    probe_kernel<false><<<grid, kThreads, 0, st>>>(
        seqs, L, lens, nullptr, first, alpha, P, dir, n_dir, hs, n_hs, cap,
        x_base, x_hi, anc, keep);
  }
  return (int)cudaGetLastError();
}

// Scratch words of K3 at (B, n): a status word a chunk, then the ticket.
int64_t lt_compact_anchors_scratch_words(int64_t B, int64_t n) {
  const int64_t n_chunks = n > 0 ? (n + kCChunk - 1) / kCChunk : 1;
  return B * n_chunks + 1;
}

// K3 on `stream`: anc (B, n) int64, keep (B, n) uint8 -> out (B, m_out)
// int64, count (B,) int32; scratch of lt_compact_anchors_scratch_words(B,
// n) 8-byte words, zeroed here before the launch.
int lt_compact_anchors(const int64_t* anc, const uint8_t* keep, int64_t B,
                       int64_t n, int m_out, void* scratch, int64_t* out,
                       int32_t* count, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int64_t n_chunks = n > 0 ? (n + kCChunk - 1) / kCChunk : 1;
  const int64_t words = lt_compact_anchors_scratch_words(B, n);
  if (n < 0 || m_out < 1 || (B + 1) * n_chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint64_t* status = static_cast<uint64_t*>(scratch);
  cudaError_t rc = cudaMemsetAsync(status, 0, (size_t)words * 8, st);
  if (rc != cudaSuccess) return (int)rc;
  compact_kernel<<<(unsigned)((B + 1) * n_chunks), kCThreads, 0, st>>>(
      anc, keep, B, n, n_chunks, m_out, status,
      reinterpret_cast<unsigned long long*>(status + B * n_chunks), out,
      count);
  return (int)cudaGetLastError();
}

}  // extern "C"
