// Dense-window extension of the -b 0 path, for Hopper (sm_90a):
// _filterHits + path_dst_2 over a batch of reads.
//
// Replaces linear_tpu/ops/extend_dev.py:batch_filter_extend_packed (with
// _read_feats, _filter_hits_batch and the _path_dst_2_batch interpreter),
// which the JAX package runs as one jitted XLA while_loop advancing every
// read one step per iteration. The plain PyTorch version beside it is
// linear_tpu_torch/ops/extend_dev.py:filter_extend_reference; the module
// docstring there states what is computed. The spec both follow is the C++
// in linear_tpu_torch/native/src/le_pmp.hpp (filter_hits :249, path_dst_2 :180,
// extend_window / previous_window / next_window :36-118).
//
// What bounds it on the card: latency, not bytes or operations. Each read
// is a serial chain of window steps (a previous_window or next_window call:
// three candidate windows of two read and two genome feature rows, 12 bytes
// each, and 30 six-bit lane distances a window), each step depending on the
// cord the last one gave. The genome rows are random over a table of
// genome_len / 16 rows (3.5 MB for 4.6 Mb, in L2). So a launch takes at
// least the longest read's steps times one L2 round trip, and the bytes and
// operations of the whole batch are far below that.
//
// Design: one warp a read, four reads a block, so a batch of 1024 reads is
// 1024 warps on the 132 SMs.
//   - The warp computes its read's 2_48 feature rows for both strands into
//     shared memory: a lane sums the 2-mer addends of one 16-base chunk, and
//     row r is chunks r, r + 1, r + 2 (two shuffles), 30 rows a round.
//     Reads with more rows than the per-warp budget (rs_smem rows a strand)
//     keep them in a device scratch instead: a pointer chosen per read, the
//     same code.
//   - filter_hits takes 32 hits at a time, one window distance a lane; a
//     ballot and a popcount give each kept hit its slot (stable), and a
//     dropped hit's end flag goes to the last kept slot before it (or the
//     header), as `hits[i - ii_move] |= FLAG_END` does in the C++.
//   - path_dst_2's control flow runs in every lane on warp-uniform values;
//     lane 0 writes the cords. A window step spreads its 3 candidates x 2
//     row pairs x 3 words over 18 lanes (lane 8k + 3p + w); the six genome
//     rows of a step are neighbours and load together, shuffles sum each
//     candidate and the first minimum wins (strict <). The previous_window
//     segment is reversed across the lanes.
//   - Hits and cords live in shared memory when they fit (hs_smem, cs_smem),
//     else in the device scratch and the output row; the cords go out
//     coalesced, zero past ncords. A push past slot C sets the read's
//     overflow flag and ends the read.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCellBit = 4;
constexpr int64_t kWindow = 96;
constexpr int64_t kSup = 6;
constexpr int64_t kMed = 5;
constexpr int64_t kInf = 3;
constexpr int64_t kWthr = 36;
constexpr int64_t kWthrRej = 50;
constexpr int64_t kAbortScore = 1000;
constexpr uint32_t kMxu31 = (31u << 24) + (31u << 18) + (31u << 12) +
                            (31u << 6) + 31u;
constexpr uint64_t kMaskY = (1ull << 20) - 1;
constexpr uint64_t kFlagEnd = 1ull << 60;
constexpr int kWarps = 4;  // reads a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t cy(uint64_t c) { return (int64_t)(c & kMaskY); }
__device__ __forceinline__ int64_t cx(uint64_t c) {
  return (int64_t)((c >> 20) & ((1ull << 30) - 1));
}
__device__ __forceinline__ int64_t cid(uint64_t c) {
  return (int64_t)((c >> 50) & ((1ull << 10) - 1));
}
__device__ __forceinline__ int cstrand(uint64_t c) { return (int)((c >> 61) & 1); }
__device__ __forceinline__ bool is_end(uint64_t c) { return (c & kFlagEnd) != 0; }
__device__ __forceinline__ int64_t iabs(int64_t v) { return v < 0 ? -v : v; }

// create_cord (src/cords.cpp:195), uint64 wrap
__device__ __forceinline__ uint64_t make_cord(int64_t gid, int64_t x, int64_t y,
                                              int std_) {
  return ((((uint64_t)gid << 30) + (uint64_t)x) << 20) + (uint64_t)y +
         ((uint64_t)std_ << 61);
}

// n_scripts_serial (le_feats.hpp:50)
__device__ __forceinline__ int64_t serial_rows(int64_t len) {
  if (len < 48) return 0;
  const int64_t v = (len - 50) >> kCellBit;
  return 1 + (v > 0 ? v : 0);
}

// base p of a read (forward, or its reverse complement), 0 past the end
__device__ __forceinline__ int read_base(const uint8_t* __restrict__ pk,
                                         int64_t len, int64_t p, int rc) {
  if (p < 0 || p >= len) return 0;
  const int64_t q = rc ? len - 1 - p : p;
  const int b = (pk[q >> 2] >> (2 * (q & 3))) & 3;
  return rc ? 3 - b : b;
}

// Rows [0, n1) of one strand into out (3 words a row). The units table
// (src/pmpfinder.cpp:541) on bases a, b < 4: k = 4a + b adds 1 << 6 (k % 5)
// to word k / 5, and TT (k = 15) adds nothing.
__device__ void strand_rows(const uint8_t* __restrict__ pk, int64_t len, int rc,
                            int64_t n1, uint32_t* out, int lane) {
  for (int64_t c0 = 0; c0 < n1; c0 += 30) {
    const int64_t c = c0 + lane;
    uint32_t w0 = 0, w1 = 0, w2 = 0;
    if (c < n1 + 2) {
      int cur = read_base(pk, len, 16 * c, rc);
      for (int p = 1; p <= 16; p++) {
        const int nxt = read_base(pk, len, 16 * c + p, rc);
        const int k = 4 * cur + nxt;
        const uint32_t add = 1u << (6 * (k % 5));
        w0 += k < 5 ? add : 0u;
        w1 += k >= 5 && k < 10 ? add : 0u;
        w2 += k >= 10 && k < 15 ? add : 0u;
        cur = nxt;
      }
    }
    w0 += __shfl_down_sync(kFull, w0, 1) + __shfl_down_sync(kFull, w0, 2);
    w1 += __shfl_down_sync(kFull, w1, 1) + __shfl_down_sync(kFull, w1, 2);
    w2 += __shfl_down_sync(kFull, w2, 1) + __shfl_down_sync(kFull, w2, 2);
    if (lane < 30 && c < n1) {
      out[3 * c] = w0;
      out[3 * c + 1] = w1;
      out[3 * c + 2] = w2;
    }
  }
}

// the five six-bit lane distances of one word pair (_scriptDist63_31,
// le_feats.hpp:130, with the uint32 wrap)
__device__ __forceinline__ int word_dist(uint32_t a, uint32_t b) {
  const uint32_t d = a + kMxu31 - b;
  int t = 0;
  for (int s = 24; s >= 0; s -= 6) t += abs((int)((d >> s) & 63) - 31);
  return t;
}

// One read strand's rows and one genome's rows.
struct Win {
  const uint32_t* f1;
  int64_t n1;
  const uint32_t* f2;
  int64_t n2;
};

struct Genomes {
  const uint32_t* cat;
  const int32_t* off;
  const int32_t* rows;
  int64_t n;
};

// the tables of hit or cord h's strand and genome (gid clamped to the table)
__device__ __forceinline__ Win win_of(const uint32_t* rows, int64_t strand_words,
                                      int64_t n1, const Genomes& g, uint64_t h) {
  int64_t gid = cid(h);
  gid = gid < g.n ? gid : g.n - 1;
  return Win{rows + cstrand(h) * strand_words, n1,
             g.cat + (int64_t)g.off[gid] * 3, (int64_t)g.rows[gid]};
}

// window_dist_c (le_feats.hpp:152) in one lane: bounds-checked, out of
// range -> 1000
__device__ int64_t window_dist_c(const Win& f, int64_t a, int64_t b) {
  if (!(a + 4 < f.n1 && b + 4 < f.n2)) return kAbortScore;
  int64_t t = 0;
  for (int p = 0; p < 2; p++)
    for (int w = 0; w < 3; w++)
      t += word_dist(f.f1[(a + 3 * p) * 3 + w], f.f2[(b + 3 * p) * 3 + w]);
  return t;
}

// The three candidates of a sweep step at read row y and genome rows x0,
// x0 + 1, x0 + 2, each with window_dist_u (le_feats.hpp:145; out of range
// -> 2^30); the first minimum to *dmin, its row to *xmin. Warp-wide.
__device__ void step_min(const Win& f, int64_t y, int64_t x0, int lane,
                         int64_t* dmin, int64_t* xmin) {
  const int k = lane >> 3, j = lane & 7;
  const int p = j / 3, w = j - 3 * p;
  const int64_t x = x0 + k;
  int t = 0;
  if (k < 3 && j < 6 && y >= 0 && y + 3 < f.n1 && x >= 0 && x + 3 < f.n2)
    t = word_dist(f.f1[(y + 3 * p) * 3 + w], f.f2[(x + 3 * p) * 3 + w]);
  t += __shfl_xor_sync(kFull, t, 1);
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 4);
  int64_t best = (1ll << 32) - 1, bx = 0;
  for (int kk = 0; kk < 3; kk++) {
    const int s = __shfl_sync(kFull, t, 8 * kk);
    const int64_t xk = x0 + kk;
    const bool in = y >= 0 && y + 3 < f.n1 && xk >= 0 && xk + 3 < f.n2;
    const int64_t d = in ? (int64_t)s : (1ll << 30);
    if (d < best) {
      best = d;
      bx = xk;
    }
  }
  *dmin = best;
  *xmin = bx;
}

// previous_window (le_pmp.hpp:36); 0 on failure. Warp-wide.
__device__ uint64_t previous_window(const Win& f, uint64_t cord, int lane) {
  const int64_t gid = cid(cord);
  const int std_ = cstrand(cord);
  const int64_t xs = cx(cord) >> kCellBit;
  const int64_t ys = cy(cord) >> kCellBit;
  if (ys < kMed || xs < kSup) return 0;
  const int64_t y = ys - kMed;
  int64_t dmin, xmin;
  step_min(f, y, xs - kSup, lane, &dmin, &xmin);
  if (dmin > kWthr) return 0;
  if (xs - xmin > kMed)
    return make_cord(gid, (xs - kMed) << kCellBit,
                     (xs - xmin - kMed + y) << kCellBit, std_);
  return make_cord(gid, xmin << kCellBit, y << kCellBit, std_);
}

// next_window (le_pmp.hpp:63); 0 on failure. Warp-wide.
__device__ uint64_t next_window(const Win& f, uint64_t cord, int lane) {
  const int64_t gid = cid(cord);
  const int std_ = cstrand(cord);
  const int64_t xs = cx(cord) >> kCellBit;
  const int64_t ys = cy(cord) >> kCellBit;
  if (ys + kSup * 2 > f.n1 || xs + kSup * 2 > f.n2) return 0;
  const int64_t y = ys + kMed;
  int64_t dmin, xmin;
  step_min(f, y, xs + kInf, lane, &dmin, &xmin);
  if (dmin > kWthr) return 0;
  if (xmin - xs > kMed)
    return make_cord(gid, (xs + kMed) << kCellBit,
                     (xs + kMed - xmin + y) << kCellBit, std_);
  return make_cord(gid, xmin << kCellBit, y << kCellBit, std_);
}

// A read's cords: every lane holds n, ovf and the last cord; lane 0 writes.
struct Cords {
  uint64_t* c;
  int64_t n;
  int64_t cap;
  bool ovf;
  uint64_t back;
  int lane;
  __device__ bool push(uint64_t v) {
    if (n >= cap) {
      ovf = true;
      return false;
    }
    if (lane == 0) c[n] = v;
    n++;
    back = v;
    return true;
  }
};

// extend_window (le_pmp.hpp:91); false when the cords overflowed. Warp-wide.
__device__ bool extend_window(const Win& f, Cords& cords, uint64_t cordy_str,
                              uint64_t cordy_end, int lane) {
  const int64_t p_str = cords.n - 1;
  for (;;) {
    const uint64_t nc = previous_window(f, cords.back, lane);
    if (nc == 0 || (uint64_t)cy(nc) < cordy_str) break;
    if (!cords.push(nc)) return false;
  }
  __syncwarp();
  const int64_t seg = cords.n - p_str;
  for (int64_t t = lane; t < seg / 2; t += 32) {
    const uint64_t a = cords.c[p_str + t];
    cords.c[p_str + t] = cords.c[cords.n - 1 - t];
    cords.c[cords.n - 1 - t] = a;
  }
  __syncwarp();
  cords.back = cords.c[cords.n - 1];
  for (;;) {
    const uint64_t nc = next_window(f, cords.back, lane);
    if (nc == 0 || (uint64_t)(cy(nc) + kWindow) >= cordy_end) break;
    if (!cords.push(nc)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kWarps * 32)
filter_extend_kernel(const uint8_t* __restrict__ packed, int64_t row_bytes,
                     const int64_t* __restrict__ lens,
                     const int64_t* __restrict__ hits_in,
                     const int32_t* __restrict__ n_hits, Genomes g, int64_t B,
                     int64_t H, int64_t C, int64_t R, int64_t hs_smem,
                     int64_t cs_smem, int64_t rs_smem,
                     uint32_t* __restrict__ rows_scratch,
                     uint64_t* __restrict__ work, uint64_t* __restrict__ cords_out,
                     int32_t* __restrict__ ncords_out,
                     uint8_t* __restrict__ ovf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarps + wib;
  if (b >= B) return;  // the whole warp; nothing below syncs the block
  uint64_t* wsm = (uint64_t*)(smem + (size_t)wib *
                              (8 * (hs_smem + cs_smem) + 24 * rs_smem));
  uint64_t* hits = hs_smem ? wsm : work + b * H;
  uint64_t* out = cords_out + b * C;
  Cords cords{cs_smem ? wsm + hs_smem : out, 0, C, false, 0, lane};
  const int64_t pad = row_bytes * 4;
  int64_t len = lens[b];
  len = len < pad ? len : pad;
  int64_t n1 = serial_rows(len);
  n1 = n1 < R ? n1 : R;
  const bool rows_smem = n1 <= rs_smem;
  uint32_t* rows = rows_smem ? (uint32_t*)(wsm + hs_smem + cs_smem)
                             : rows_scratch + b * 2 * R * 3;
  const int64_t strand_words = (rows_smem ? rs_smem : R) * 3;
  int64_t n = n_hits[b];
  n = n < H ? n : H;

  if (n >= 2) {
    for (int64_t i = lane; i < n; i += 32) hits[i] = (uint64_t)hits_in[b * H + i];
    const uint8_t* pk = packed + b * row_bytes;
    strand_rows(pk, len, 0, n1, rows, lane);
    strand_rows(pk, len, 1, n1, rows + strand_words, lane);
    __syncwarp();
    // filter_hits (le_pmp.hpp:249), 32 hits at a time
    const unsigned lt = (1u << lane) - 1;
    int64_t kept = 1;  // slot 0, the header, stays
    for (int64_t i0 = 1; i0 < n; i0 += 32) {
      const int64_t i = i0 + lane;
      const uint64_t h = i < n ? hits[i] : 0;
      bool keep = false;
      if (i < n) {
        const Win f = win_of(rows, strand_words, n1, g, h);
        keep = window_dist_c(f, cy(h) >> kCellBit, cx(h) >> kCellBit) < kWthrRej;
      }
      const unsigned km = __ballot_sync(kFull, keep);
      const int64_t slot = kept + __popc(km & lt);
      __syncwarp();
      if (keep) hits[slot] = h;
      __syncwarp();
      if (i < n && !keep && is_end(h))
        atomicOr((unsigned long long*)&hits[slot - 1],
                 (unsigned long long)kFlagEnd);
      __syncwarp();
      kept += __popc(km);
    }
    n = kept;
  } else {
    n = 0;
  }

  // path_dst_2 (le_pmp.hpp:180), read_str 0 and read_end len
  if (n > 2) {
    cords.push(kFlagEnd);
    int64_t itt = 1, itt_next = 2, itt_first = 1;
    while (itt < n) {
      const uint64_t h_itt = hits[itt];
      const uint64_t h_prv = hits[itt - 1];
      const int64_t ready_end = cstrand(h_itt) ? len + 1 : len;
      const int64_t da_l =
          is_end(h_prv) ? 0 : iabs((cx(h_itt) - cx(h_prv)) - (cy(h_itt) - cy(h_prv)));
      const bool f_sp_l = da_l > 80 || cstrand(h_itt ^ h_prv) != 0;
      bool f_sp_r = false, f_block_end = false;
      for (;;) {
        if (itt_next >= n || is_end(hits[itt_next - 1])) {
          f_block_end = true;
          itt_first = itt_next;
          break;
        }
        const uint64_t a = hits[itt_next], p = hits[itt_next - 1];
        const int64_t da_r = iabs((cx(a) - cx(p)) - (cy(a) - cy(p)));
        f_sp_r = da_r > 80 || cstrand(a ^ p) != 0;
        if ((cy(h_itt) + kWindow < cy(a) && cx(h_itt) + kWindow < cx(a)) || f_sp_r)
          break;
        itt_next++;
      }
      bool f_append = false;
      uint64_t cordy_str = 0, cordy_end = 0;
      if (!f_sp_r && !f_block_end) {
        // the :1366 quirk: the whole hit value when f_sp_l
        if (f_sp_l) cordy_str = h_itt;
        else if (is_end(h_prv)) cordy_str = 0;
        else cordy_str = (uint64_t)cy(cords.back);
        cordy_end = (uint64_t)cy(hits[itt_next]);
        if (!cords.push(h_itt & ~kFlagEnd)) break;
        f_append = true;
      } else {
        const uint64_t p = hits[itt_next - 1];
        if (!f_sp_l && cy(p) >= kWindow && cx(p) >= kWindow) {
          const uint64_t nc = p - ((uint64_t)kWindow << 20) - (uint64_t)kWindow;
          cordy_str = is_end(h_prv) ? 0 : (uint64_t)cy(nc);
          cordy_end = (uint64_t)cy(p);
          if (!cords.push(nc & ~kFlagEnd)) break;
          f_append = true;
        }
      }
      if (is_end(h_itt) || f_block_end) {
        f_block_end = true;
        cordy_end = (uint64_t)ready_end;
      }
      if (f_append &&
          !extend_window(win_of(rows, strand_words, n1, g, h_itt), cords,
                         cordy_str, cordy_end, lane))
        break;
      if (f_block_end) {
        cords.back |= kFlagEnd;
        if (lane == 0) cords.c[cords.n - 1] = cords.back;
      }
      itt_next = f_block_end ? itt_first : itt_next;
      itt = itt_next;
      itt_next++;
    }
  }
  __syncwarp();
  for (int64_t k = lane; k < C; k += 32) {
    if (k >= cords.n) out[k] = 0;
    else if (cords.c != out) out[k] = cords.c[k];
  }
  if (lane == 0) {
    ncords_out[b] = (int32_t)cords.n;
    ovf_out[b] = cords.ovf ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. packed (B, row_bytes) uint8 with
// row_bytes = pad / 4; lens (B,) int64; hits (B, H) int64; n_hits (B,)
// int32; genome features cat (rows + 8, 3) uint32, off and rows (G,) int32.
// Per warp (read) the shared memory holds the hits when hs_smem = H (else 0:
// they go to work (B, H) uint64), the cords when cs_smem = C (else 0: they
// are built in the output row), and rs_smem feature rows a strand; a read
// with more rows keeps them in rows_scratch (B, 2, R, 3) uint32 (needed only
// when R > rs_smem). Outputs: cords (B, C) uint64, ncords (B,) int32, ovf
// (B,) uint8. Returns the cudaError_t of the launch (0: launched).
int lt_filter_extend(const uint8_t* packed, int64_t B, int64_t row_bytes,
                     const int64_t* lens, const int64_t* hits, int64_t H,
                     const int32_t* n_hits, const uint32_t* gf_cat,
                     const int32_t* gf_off, const int32_t* gf_rows,
                     int64_t n_genomes, int64_t C, int64_t R, int64_t hs_smem,
                     int64_t cs_smem, int64_t rs_smem, uint32_t* rows_scratch,
                     uint64_t* work, uint64_t* cords, int32_t* ncords,
                     uint8_t* ovf, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t bytes =
      (size_t)kWarps * (size_t)(8 * (hs_smem + cs_smem) + 24 * rs_smem);
  cudaError_t err = cudaFuncSetAttribute(
      filter_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Genomes g{gf_cat, gf_off, gf_rows, n_genomes};
  filter_extend_kernel<<<(unsigned)((B + kWarps - 1) / kWarps), kWarps * 32,
                         bytes, (cudaStream_t)stream>>>(
      packed, row_bytes, lens, hits, n_hits, g, B, H, C, R, hs_smem, cs_smem,
      rs_smem, rows_scratch, work, cords, ncords, ovf);
  return (int)cudaGetLastError();
}

}  // extern "C"
