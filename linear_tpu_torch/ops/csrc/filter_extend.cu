// Dense-window extension of the -b 0 path, for Hopper (sm_90a):
// _filterHits + path_dst_2 over a batch of reads.
//
// Replaces linear_tpu/ops/extend_dev.py:batch_filter_extend_packed (with
// _read_feats, _filter_hits_batch and the _path_dst_2_batch interpreter),
// which the JAX package runs as one jitted XLA while_loop advancing every
// read one step per iteration. The plain PyTorch version beside it is
// linear_tpu_torch/ops/extend_dev.py:filter_extend_reference; the module
// docstring there states what is computed. The spec both follow is the C++
// in linear_tpu/native/le_pmp.hpp (filter_hits :249, path_dst_2 :180,
// extend_window / previous_window / next_window :36-118).
//
// What bounds it on the card: the serial control flow of path_dst_2 per
// read. Each window sweep step gathers two read feature rows and six genome
// feature rows (12 bytes each, the genome rows random over a table of
// genome_len / 16 rows) and does 30 six-bit lane distances; a read takes a
// few hundred such steps, one after another. The arithmetic is small.
//
// Design, two kernels on one stream:
//   1. read_feats_kernel: one block per (read, strand), threads over the
//      feature rows. Row r sums the 2-mer addends of bases [16r, 16r + 48)
//      of the read or of its reverse complement (base A past the end) into
//      three uint32 lanes; only the n1 valid rows are written, into a
//      (B, 2, R, 3) scratch.
//   2. filter_extend_kernel: one thread per read runs filter_hits in place
//      on its copy of the hits, then path_dst_2, exactly in the order the
//      C++ does: the previous_window segment is reversed in place before
//      the next_window sweep. Cords go straight to the (B, C) output; a push
//      past slot C sets the read's overflow flag and ends the read. The
//      latency of the feature gathers is hidden by the many reads in
//      flight, not inside a read.
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
constexpr int kFeatThreads = 128;
constexpr int kExtThreads = 64;

// units table (src/pmpfinder.cpp:541): 2-mer ord 5a + b -> lane and addend;
// N*, *N and TT add 0
__constant__ int kUnitLane[25] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 2,
                                  2, 0, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0};
__constant__ uint32_t kUnitAdd[25] = {
    1u << 0,  1u << 6,  1u << 12, 1u << 18, 0, 1u << 24, 1u << 0,
    1u << 6,  1u << 12, 0,        1u << 18, 1u << 24, 1u << 0, 1u << 6,
    0,        1u << 12, 1u << 18, 1u << 24, 0,        0,       0,
    0,        0,        0,        0};

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

__global__ void __launch_bounds__(kFeatThreads)
read_feats_kernel(const uint8_t* __restrict__ packed, int64_t row_bytes,
                  const int64_t* __restrict__ lens, int64_t R,
                  uint32_t* __restrict__ feats) {
  const int64_t b = blockIdx.x;
  const int rc = blockIdx.y;
  const uint8_t* pk = packed + b * row_bytes;
  const int64_t pad = row_bytes * 4;
  int64_t len = lens[b];
  len = len < pad ? len : pad;
  int64_t n1 = serial_rows(len);
  n1 = n1 < R ? n1 : R;
  uint32_t* out = feats + (b * 2 + rc) * R * 3;
  for (int64_t r = threadIdx.x; r < n1; r += blockDim.x) {
    uint32_t acc[3] = {0u, 0u, 0u};
    int cur = read_base(pk, len, r * 16, rc);
    for (int64_t p = r * 16; p < r * 16 + 48; p++) {
      const int nxt = read_base(pk, len, p + 1, rc);
      const int o = cur * 5 + nxt;
      acc[kUnitLane[o]] += kUnitAdd[o];
      cur = nxt;
    }
    out[r * 3 + 0] = acc[0];
    out[r * 3 + 1] = acc[1];
    out[r * 3 + 2] = acc[2];
  }
}

// _scriptDist63_31 (le_feats.hpp:130) with the uint32 wrap
__device__ __forceinline__ int64_t sdist(const uint32_t* __restrict__ a,
                                         const uint32_t* __restrict__ b) {
  int64_t t = 0;
  for (int i = 0; i < 3; i++) {
    const uint32_t d = a[i] + kMxu31 - b[i];
    for (int s = 24; s >= 0; s -= 6) t += iabs((int64_t)((d >> s) & 63) - 31);
  }
  return t;
}

// One read's feature tables: its strand's rows and one genome's rows.
struct Feats {
  const uint32_t* f1;  // read rows, 3 words each
  int64_t n1;
  const uint32_t* f2;  // genome rows
  int64_t n2;
};

// window_dist_u (le_feats.hpp:145): unchecked form, out of range -> 2^30
__device__ __forceinline__ int64_t window_dist_u(const Feats& f, int64_t a,
                                                 int64_t b) {
  if (a + 3 >= f.n1 || b + 3 >= f.n2 || a < 0 || b < 0) return 1ll << 30;
  return sdist(f.f1 + a * 3, f.f2 + b * 3) +
         sdist(f.f1 + (a + 3) * 3, f.f2 + (b + 3) * 3);
}

// window_dist_c (le_feats.hpp:152): bounds-checked, out of range -> 1000
__device__ __forceinline__ int64_t window_dist_c(const Feats& f, int64_t a,
                                                 int64_t b) {
  if (a + 4 < f.n1 && b + 4 < f.n2)
    return sdist(f.f1 + a * 3, f.f2 + b * 3) +
           sdist(f.f1 + (a + 3) * 3, f.f2 + (b + 3) * 3);
  return kAbortScore;
}

// previous_window (le_pmp.hpp:36); 0 on failure
__device__ uint64_t previous_window(const Feats& f, uint64_t cord) {
  const int64_t gid = cid(cord);
  const int std_ = cstrand(cord);
  const int64_t xs = cx(cord) >> kCellBit;
  const int64_t ys = cy(cord) >> kCellBit;
  if (ys < kMed || xs < kSup) return 0;
  const int64_t y = ys - kMed;
  int64_t dmin = (1ll << 32) - 1, xmin = 0;
  for (int64_t k = 0; k < kSup - kInf; k++) {
    const int64_t d = window_dist_u(f, y, xs - kSup + k);
    if (d < dmin) {
      dmin = d;
      xmin = xs - kSup + k;
    }
  }
  if (dmin > kWthr) return 0;
  if (xs - xmin > kMed)
    return make_cord(gid, (xs - kMed) << kCellBit,
                     (xs - xmin - kMed + y) << kCellBit, std_);
  return make_cord(gid, xmin << kCellBit, y << kCellBit, std_);
}

// next_window (le_pmp.hpp:63); 0 on failure
__device__ uint64_t next_window(const Feats& f, uint64_t cord) {
  const int64_t gid = cid(cord);
  const int std_ = cstrand(cord);
  const int64_t xs = cx(cord) >> kCellBit;
  const int64_t ys = cy(cord) >> kCellBit;
  if (ys + kSup * 2 > f.n1 || xs + kSup * 2 > f.n2) return 0;
  const int64_t y = ys + kMed;
  int64_t dmin = (1ll << 32) - 1, xmin = 0;
  for (int64_t k = 0; k < kSup - kInf; k++) {
    const int64_t d = window_dist_u(f, y, xs + kInf + k);
    if (d < dmin) {
      dmin = d;
      xmin = xs + kInf + k;
    }
  }
  if (dmin > kWthr) return 0;
  if (xmin - xs > kMed)
    return make_cord(gid, (xs + kMed) << kCellBit,
                     (xs + kMed - xmin + y) << kCellBit, std_);
  return make_cord(gid, xmin << kCellBit, y << kCellBit, std_);
}

// A read's cords row: pushes stop the read once slot C would be passed.
struct Cords {
  uint64_t* c;
  int64_t n;
  int64_t cap;
  bool ovf;
  __device__ bool push(uint64_t v) {
    if (n >= cap) {
      ovf = true;
      return false;
    }
    c[n++] = v;
    return true;
  }
};

// extend_window (le_pmp.hpp:91); false when the cords overflowed
__device__ bool extend_window(const Feats& f, Cords& cords, uint64_t cordy_str,
                              uint64_t cordy_end) {
  const int64_t p_str = cords.n - 1;
  for (;;) {
    const uint64_t nc = previous_window(f, cords.c[cords.n - 1]);
    if (nc == 0 || (uint64_t)cy(nc) < cordy_str) break;
    if (!cords.push(nc)) return false;
  }
  for (int64_t lo = p_str, hi = cords.n - 1; lo < hi; lo++, hi--) {
    const uint64_t t = cords.c[lo];
    cords.c[lo] = cords.c[hi];
    cords.c[hi] = t;
  }
  for (;;) {
    const uint64_t nc = next_window(f, cords.c[cords.n - 1]);
    if (nc == 0 || (uint64_t)(cy(nc) + kWindow) >= cordy_end) break;
    if (!cords.push(nc)) return false;
  }
  return true;
}

struct Genomes {
  const uint32_t* cat;
  const int32_t* off;
  const int32_t* rows;
  int64_t n;
};

__device__ __forceinline__ Feats feats_of(const uint32_t* read_feats, int64_t R,
                                          int64_t n1, const Genomes& g,
                                          uint64_t h) {
  int64_t gid = cid(h);
  gid = gid < g.n ? gid : g.n - 1;
  return Feats{read_feats + (int64_t)cstrand(h) * R * 3, n1,
               g.cat + (int64_t)g.off[gid] * 3, (int64_t)g.rows[gid]};
}

__global__ void __launch_bounds__(kExtThreads)
filter_extend_kernel(const int64_t* __restrict__ hits_in,
                     const int32_t* __restrict__ n_hits,
                     const int64_t* __restrict__ lens, int64_t pad,
                     const uint32_t* __restrict__ feats, Genomes g, int64_t B,
                     int64_t H, int64_t C, int64_t R,
                     uint64_t* __restrict__ work, uint64_t* __restrict__ cords_out,
                     int32_t* __restrict__ ncords_out,
                     uint8_t* __restrict__ ovf_out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int64_t len = lens[b];
  len = len < pad ? len : pad;
  int64_t n1 = serial_rows(len);
  n1 = n1 < R ? n1 : R;
  const uint32_t* rf = feats + b * 2 * R * 3;
  uint64_t* hits = work + b * H;
  Cords cords{cords_out + b * C, 0, C, false};
  int64_t n = n_hits[b];
  n = n < H ? n : H;
  for (int64_t i = 0; i < n; i++) hits[i] = (uint64_t)hits_in[b * H + i];

  if (n >= 2) {
    // filter_hits (le_pmp.hpp:249)
    int64_t ii_move = 0;
    for (int64_t i = 1; i < n; i++) {
      const uint64_t h = hits[i];
      const Feats f = feats_of(rf, R, n1, g, h);
      if (window_dist_c(f, cy(h) >> kCellBit, cx(h) >> kCellBit) < kWthrRej)
        hits[i - ii_move] = h;
      else
        ii_move++;
      if (is_end(h)) hits[i - ii_move] |= kFlagEnd;
    }
    n -= ii_move;
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
        else cordy_str = (uint64_t)cy(cords.c[cords.n - 1]);
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
          !extend_window(feats_of(rf, R, n1, g, h_itt), cords, cordy_str, cordy_end))
        break;
      if (f_block_end) cords.c[cords.n - 1] |= kFlagEnd;
      itt_next = f_block_end ? itt_first : itt_next;
      itt = itt_next;
      itt_next++;
    }
  }
  for (int64_t k = cords.n; k < C; k++) cords.c[k] = 0;
  ncords_out[b] = (int32_t)cords.n;
  ovf_out[b] = cords.ovf ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`. packed (B, row_bytes) uint8 with
// row_bytes = pad / 4; lens (B,) int64; hits (B, H) int64; n_hits (B,)
// int32; genome features cat (rows + 8, 3) uint32, off and rows (G,) int32.
// Scratch: feats (B, 2, R, 3) uint32 and work (B, H) uint64. Outputs: cords
// (B, C) uint64, ncords (B,) int32, ovf (B,) uint8. Returns the cudaError_t
// of the launches (0: launched).
int lt_filter_extend(const uint8_t* packed, int64_t B, int64_t row_bytes,
                     const int64_t* lens, const int64_t* hits, int64_t H,
                     const int32_t* n_hits, const uint32_t* gf_cat,
                     const int32_t* gf_off, const int32_t* gf_rows,
                     int64_t n_genomes, int64_t C, int64_t R, uint32_t* feats,
                     uint64_t* work, uint64_t* cords, int32_t* ncords,
                     uint8_t* ovf, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  read_feats_kernel<<<dim3((unsigned)B, 2), kFeatThreads, 0, s>>>(
      packed, row_bytes, lens, R, feats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Genomes g{gf_cat, gf_off, gf_rows, n_genomes};
  filter_extend_kernel<<<(unsigned)((B + kExtThreads - 1) / kExtThreads),
                         kExtThreads, 0, s>>>(hits, n_hits, lens, row_bytes * 4,
                                              feats, g, B, H, C, R, work, cords,
                                              ncords, ovf);
  return (int)cudaGetLastError();
}

}  // extern "C"
