// lt_engine: the native per-read mapping runtime.
//
// The TPU device kernels (linear_tpu/ops) cover the batched hot stages
// (seeding, chain DP); this engine is the host runtime that consumes those
// results and runs the irregular per-read control flow at C++ speed:
// anchors -> chaining -> dense extension -> gap/SV resolution -> CIGAR/SAM.
// It is validated bit-identical against the Python host oracle
// (linear_tpu/map/*), which in turn is differentially validated against the
// reference binary (tests/difftest.py).
//
// ctypes API (see linear_tpu/native/__init__.py engine_lib):
//   le_create   register genomes/features/index + output config
//   le_reset    fresh per-task GapParms (reference: per-compute-task state)
//   le_map_read map one read -> cords + SAM text (buffers live until next call)
//   le_destroy
#include "le_common.hpp"
#include "le_feats.hpp"
#include "le_hash.hpp"
#include "le_chain.hpp"
#include "le_pmp.hpp"
#include "le_gap.hpp"
#include "le_gap2.hpp"
#include "le_gap3.hpp"
#include "le_out.hpp"
#include "le_hibuild.hpp"

#include <map>
#include <omp.h>
#include <parallel/algorithm>
#include <sys/mman.h>
#include <memory>

using namespace le;

namespace le { i64 g_apx_ns[3] = {0, 0, 0}; }

namespace {

const i64 THD_MIN_READ_LEN = 200;  // src/mapper.cpp:430

struct Engine {
    // genome data (pointers owned by the Python side)
    std::vector<const u8*> genomes;
    std::vector<i64> genome_lens;
    std::vector<Feats> gfeats;
    std::vector<const Feats*> gfeat_ptrs;
    std::vector<std::string> genome_ids;
    DIndexView index;
    HIndexView hindex;
    bool has_hindex = false;
    // output config
    i64 thd_DI = INF60, thd_X = INF60;
    i64 gap_len_min = 50;  // 0 = gaps off
    int f_dup = 0;
    int f_chain = 1;
    int sequence_sam = 0;
    int reform_ccs = 0;
    // preset: ChainAnchorsHitsParms.thd_stop_chain_len_ratio (0.7 preset 0,
    // 0 presets 1/2; src/mapper.cpp:174-197)
    double cah_stop_ratio = 0.0;
    // per-task gap parms (reference: per-thread GapParms persist across reads)
    std::map<int, GapParms> parms;
    // per-task PMPParms (reference quirk: per-thread, persists across reads;
    // the re-apx/retry paths leave it in toggle(0) state — visible only to
    // the alg-1 gdl_* fields, src/pmpfinder.cpp:2806-2811, :2287-2301)
    std::map<int, PMPParms> pmp_parms_map;
    // per-call result buffers
    std::vector<u64> out_cs, out_ce;
    std::string out_sam;
    std::vector<u8> rc_buf;
    Feats f1_buf[2];
    std::vector<BamLinkRecord> records;
    std::vector<i64> heads;
    std::vector<std::string> head_gids;
    std::string block_sam;

    // per-phase wall accumulators (ns), reported by le_stage_ns: cheap
    // always-on observability (4 clock reads per mapped read)
    i64 ph_ns[4] = {0, 0, 0, 0};  // features+apx-pre, apx, gap, output

    GapParms& gap_parms(int tid) {
        auto it = parms.find(tid);
        if (it == parms.end()) {
            GapParms gp;
            gp.thd_gap_len_min = gap_len_min;
            gp.f_dup = f_dup;
            it = parms.emplace(tid, gp).first;
        }
        return it->second;
    }

    PMPParms& pmp_parms(int tid) {
        auto it = pmp_parms_map.find(tid);
        if (it == pmp_parms_map.end()) it = pmp_parms_map.emplace(tid, PMPParms()).first;
        return it->second;
    }
};

}  // namespace

extern "C" {

void* le_create2(i64, const u8**, const i64*, const i32**, const i64*,
                 const i32*, const u64*, const u64*, int, int, i64, i64, i64,
                 int, int, int, int, double, const char**);

void* le_create(i64 n_genomes, const u8** genome_ptrs, const i64* genome_lens,
                const i32** gfeat_ptrs, const i64* gfeat_rows, const i32* dir,
                const u64* hs, int span, int weight, i64 thd_DI, i64 thd_X,
                i64 gap_len_min, int f_dup, int f_chain, int sequence_sam,
                int reform_ccs, double cah_stop_ratio,
                const char** genome_id_strs) {
    return le_create2(n_genomes, genome_ptrs, genome_lens, gfeat_ptrs,
                      gfeat_rows, dir, hs, nullptr, span, weight, thd_DI,
                      thd_X, gap_len_min, f_dup, f_chain, sequence_sam,
                      reform_ccs, cah_stop_ratio, genome_id_strs);
}

// le_create + optional non-empty-bucket bitmap (see DIndexView.nz)
void* le_create2(i64 n_genomes, const u8** genome_ptrs, const i64* genome_lens,
                 const i32** gfeat_ptrs, const i64* gfeat_rows, const i32* dir,
                 const u64* hs, const u64* nz_bitmap, int span, int weight,
                 i64 thd_DI, i64 thd_X,
                 i64 gap_len_min, int f_dup, int f_chain, int sequence_sam,
                 int reform_ccs, double cah_stop_ratio,
                 const char** genome_id_strs) {
    Engine* e = new Engine();
    e->genomes.assign(genome_ptrs, genome_ptrs + n_genomes);
    e->genome_lens.assign(genome_lens, genome_lens + n_genomes);
    e->gfeats.resize(n_genomes);
    for (i64 g = 0; g < n_genomes; g++)
        e->gfeats[g].set_external(gfeat_ptrs[g], gfeat_rows[g]);
    for (i64 g = 0; g < n_genomes; g++) e->gfeat_ptrs.push_back(&e->gfeats[g]);
    for (i64 g = 0; g < n_genomes; g++) e->genome_ids.push_back(genome_id_strs[g]);
    e->index.dir = dir;
    e->index.hs = hs;
    e->index.nz = nz_bitmap;
    e->index.span = span;
    e->index.weight = weight;
    e->thd_DI = thd_DI;
    e->thd_X = thd_X;
    e->gap_len_min = gap_len_min;
    e->f_dup = f_dup;
    e->f_chain = f_chain;
    e->sequence_sam = sequence_sam;
    e->reform_ccs = reform_ccs;
    e->cah_stop_ratio = cah_stop_ratio;
    return e;
}

void le_reset(void* ep) {
    Engine* e = (Engine*)ep;
    e->parms.clear();
    e->pmp_parms_map.clear();
}

void le_destroy(void* ep) { delete (Engine*)ep; }

// Per-read pipeline body shared by le_map_read and le_map_block; results
// land in the engine buffers (out_cs/out_ce/out_sam).
static void map_one(Engine* e, const u8* read, i64 read_len, const char* rid,
                    const u64* seeds, i64 n_seeds, int tid, int do_output) {
    double tp = omp_get_wtime();
    auto phase = [&](int k) {
        double t = omp_get_wtime();
        e->ph_ns[k] += (i64)((t - tp) * 1e9);
        tp = t;
    };
    e->out_cs.clear();
    e->out_ce.clear();
    e->out_sam.clear();
    if (read_len > THD_MIN_READ_LEN) {
        // revcomp (src/base.cpp:325 _compltRvseStr)
        e->rc_buf.resize(read_len);
        static const u8 comp[5] = {3, 2, 1, 0, 4};
        for (i64 i = 0; i < read_len; i++)
            e->rc_buf[i] = comp[read[read_len - 1 - i]];
        // read features fwd/rc (createFeatures serial, src/mapper.cpp:445)
        create_features_read(read, read_len, e->f1_buf[0]);
        create_features_read(e->rc_buf.data(), read_len, e->f1_buf[1]);
        phase(0);
        // apx phase
        ApxContext acx;
        acx.index = &e->index;
        acx.hindex = e->has_hindex ? &e->hindex : nullptr;
        acx.f1 = e->f1_buf;
        acx.f2 = e->gfeat_ptrs.data();
        acx.read = read;
        acx.read_len = read_len;
        PMPParms& pm = e->pmp_parms(tid);
        pm.cah_stop_ratio = e->cah_stop_ratio;
        pm.seed_anchors = n_seeds >= 0 ? seeds : nullptr;
        pm.n_seed = n_seeds >= 0 ? n_seeds : 0;
        pm.seed_used = false;
        std::vector<PII> apx_gaps;
        std::vector<i64> cords_info;
        apx_map(acx, e->f_chain, pm, e->out_cs, e->out_ce, apx_gaps, cords_info);
        phase(1);
        // gap phase
        if (e->gap_len_min > 0) {
            GapContext gcx;
            gcx.genomes = e->genomes.data();
            gcx.genome_lens = e->genome_lens.data();
            gcx.n_genomes = (i64)e->genomes.size();
            gcx.read = read;
            gcx.comstr = e->rc_buf.data();
            gcx.read_len = read_len;
            gcx.f1 = e->f1_buf;
            gcx.f2 = e->gfeat_ptrs.data();
            map_gaps(gcx, e->out_cs, e->out_ce, e->gap_parms(tid));
            reform_cords(e->out_cs, e->out_ce);
        }
        phase(2);
    }
    // output (print side of p_calRecords, src/mapper.cpp:452-473)
    if (do_output) {
        cords2bamlink(e->out_cs, e->out_ce, read_len, 8000, e->thd_DI, e->thd_X,
                      e->records);
        if (e->reform_ccs) reform_ccs_bams(e->records);
        fill_bam_records(e->records, e->genome_ids, e->heads, e->head_gids);
        if (e->sequence_sam && !e->records.empty())
            synth_seq(e->records, e->heads, e->genomes.data(),
                      e->genome_lens.data(), read, e->rc_buf.data(), read_len);
        sam_lines(e->records, e->heads, e->head_gids, rid, e->out_sam);
        phase(3);
    }
}

// Map one read. seeds: device-precomputed anchors for the first apx pass
// (n_seeds < 0 -> host seeding in C++). Returns 0; out pointers are valid
// until the next le_map_read on this engine.
int le_map_read(void* ep, const u8* read, i64 read_len, const char* rid,
                const u64* seeds, i64 n_seeds, int tid, int do_output,
                const u64** out_cs, const u64** out_ce, i64* out_n,
                const char** out_sam, i64* out_sam_len) {
    Engine* e = (Engine*)ep;
    map_one(e, read, read_len, rid, seeds, n_seeds, tid, do_output);
    *out_cs = e->out_cs.data();
    *out_ce = e->out_ce.data();
    *out_n = (i64)e->out_cs.size();
    *out_sam = e->out_sam.c_str();
    *out_sam_len = (i64)e->out_sam.size();
    return 0;
}

// Map a whole chunk with ONE crossing of the ctypes boundary (the per-read
// Python call + marshalling overhead is ~10-30 us/read on small hosts —
// comparable to whole pipeline stages). SAM for all reads lands
// concatenated in one buffer, bit-identical to per-read calls in order.
int le_map_block(void* ep, const u8** reads, const i64* lens,
                 const char** rids, const u64** seeds, const i64* n_seeds,
                 i64 n_reads, int tid, const char** out_sam,
                 i64* out_sam_len) {
    Engine* e = (Engine*)ep;
    e->block_sam.clear();
    for (i64 r = 0; r < n_reads; r++) {
        map_one(e, reads[r], lens[r], rids[r],
                seeds ? seeds[r] : nullptr, n_seeds ? n_seeds[r] : -1,
                tid, 1);
        e->block_sam += e->out_sam;
    }
    *out_sam = e->block_sam.c_str();
    *out_sam_len = (i64)e->block_sam.size();
    return 0;
}

// ---------------------------------------------- device-pipeline phase split
// Phase B of the TPU pipeline: first-pass apx up to PRE-filter hits
// (apxMap_ src/pmpfinder.cpp:2632 before path_dst). The device then runs
// _filterHits + path_dst_2 (linear_tpu/ops/extend_dev.py) and le_apx_finish
// consumes its cords. Buffers valid until the next call on this engine.
// -i 2: register host-built HIndex tables (index/hindex.py); the engine
// then seeds via getHIndexMatchAll instead of the DIndex probe. Pointers
// are pinned by the Python caller for the engine's lifetime.
void le_set_hindex(void* ep, const u64* ysa, i64 n_ysa, const u64* xs_val1,
                   const i64* xs_val2, i64 xs_mask, i64 empty_dir, int span,
                   int weight) {
    Engine* e = (Engine*)ep;
    e->hindex.ysa = ysa;
    e->hindex.n_ysa = n_ysa;
    e->hindex.xs_val1 = xs_val1;
    e->hindex.xs_val2 = xs_val2;
    e->hindex.xs_mask = (u64)xs_mask;
    e->hindex.empty_dir = empty_dir;
    e->hindex.span = span;
    e->hindex.weight = weight;
    e->has_hindex = true;
}

int le_apx_hits(void* ep, const u8* read, i64 read_len, const u64* seeds,
                i64 n_seeds, const u64** out_hits, i64* out_n) {
    Engine* e = (Engine*)ep;
    e->out_cs.clear();  // reuse as hits buffer
    if (read_len > THD_MIN_READ_LEN) {
        ApxContext acx;
        acx.index = &e->index;
        acx.hindex = e->has_hindex ? &e->hindex : nullptr;
        acx.f1 = e->f1_buf;  // untouched before path_dst
        acx.f2 = e->gfeat_ptrs.data();
        acx.read = read;
        acx.read_len = read_len;
        PMPParms pm;
        pm.cah_stop_ratio = e->cah_stop_ratio;
        pm.seed_anchors = n_seeds >= 0 ? seeds : nullptr;
        pm.n_seed = n_seeds >= 0 ? n_seeds : 0;
        std::vector<u64>& hits = e->out_cs;
        hits.push_back(FLAG_END);
        std::vector<u64> anchors;
        anchors.push_back(0);
        std::vector<i64> hits_score;
        u64 map_str = 0;
        u64 map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, read_len & (i64)MASK_Y, 0);
        mn_map_read_list(acx, anchors, hits, hits_score, map_str, map_end, 2, pm);
    }
    *out_hits = e->out_cs.data();
    *out_n = (i64)e->out_cs.size();
    return 0;
}

// Phase D: consume the device's path_dst_2 cords and finish the read
// (apx tail + gap phase + output). Returns 1 when the read needs a FULL
// host re-map (re-apx path, src/pmpfinder.cpp:2749-2767) — the caller
// then calls le_map_read; returns 0 on success.
int le_apx_finish(void* ep, const u8* read, i64 read_len, const char* rid,
                  const u64* cords_in, i64 n_cords_in, int tid, int do_output,
                  const u64** out_cs, const u64** out_ce, i64* out_n,
                  const char** out_sam, i64* out_sam_len) {
    Engine* e = (Engine*)ep;
    double tp = omp_get_wtime();
    auto phase = [&](int k) {
        double t = omp_get_wtime();
        e->ph_ns[k] += (i64)((t - tp) * 1e9);
        tp = t;
    };
    e->out_cs.assign(cords_in, cords_in + n_cords_in);
    e->out_ce.clear();
    e->out_sam.clear();
    if (read_len > THD_MIN_READ_LEN) {
        std::vector<PII> apx_gaps;
        if (!apx_map_device_tail(read_len, e->out_cs, e->out_ce, apx_gaps))
            return 1;  // re-apx: caller re-runs the full host pipeline
        // revcomp + read features (needed by the gap phase and -ss output)
        e->rc_buf.resize(read_len);
        static const u8 comp[5] = {3, 2, 1, 0, 4};
        for (i64 i = 0; i < read_len; i++)
            e->rc_buf[i] = comp[read[read_len - 1 - i]];
        create_features_read(read, read_len, e->f1_buf[0]);
        create_features_read(e->rc_buf.data(), read_len, e->f1_buf[1]);
        phase(0);
        if (e->gap_len_min > 0) {
            GapContext gcx;
            gcx.genomes = e->genomes.data();
            gcx.genome_lens = e->genome_lens.data();
            gcx.n_genomes = (i64)e->genomes.size();
            gcx.read = read;
            gcx.comstr = e->rc_buf.data();
            gcx.read_len = read_len;
            gcx.f1 = e->f1_buf;
            gcx.f2 = e->gfeat_ptrs.data();
            map_gaps(gcx, e->out_cs, e->out_ce, e->gap_parms(tid));
            reform_cords(e->out_cs, e->out_ce);
        }
        phase(2);
    }
    if (do_output) {
        cords2bamlink(e->out_cs, e->out_ce, read_len, 8000, e->thd_DI, e->thd_X,
                      e->records);
        if (e->reform_ccs) reform_ccs_bams(e->records);
        fill_bam_records(e->records, e->genome_ids, e->heads, e->head_gids);
        if (e->sequence_sam && !e->records.empty())
            synth_seq(e->records, e->heads, e->genomes.data(),
                      e->genome_lens.data(), read, e->rc_buf.data(), read_len);
        sam_lines(e->records, e->heads, e->head_gids, rid, e->out_sam);
        phase(3);
    }
    *out_cs = e->out_cs.data();
    *out_ce = e->out_ce.data();
    *out_n = (i64)e->out_cs.size();
    *out_sam = e->out_sam.c_str();
    *out_sam_len = (i64)e->out_sam.size();
    return 0;
}

// ------------------------------------------------------------ builders
// Native genome feature + DIndex builders (analog of createFeatures2_48
// src/pmpfinder.cpp:589 and createDIndex src/index_util.cpp:1628); validated
// identical to the numpy builders (linear_tpu/ops/features.py,
// linear_tpu/index/dindex.py) by tests.

// Genome features: parallel-builder count unless range < threads
// (src/pmpfinder.cpp:598). out must hold n_rows*3 int32.
i64 le_feature_rows(i64 seq_len, i64 threads) {
    i64 rng = n_scripts_parallel(seq_len);
    return rng < threads ? n_scripts_serial(seq_len) : rng;
}

void le_build_features(const u8* seq, i64 seq_len, i64 threads, i32* out) {
    i64 n = le_feature_rows(seq_len, threads);
    Feats f;
    create_features_n(seq, seq_len, n, f);
    if (n > 0) std::memcpy(out, f.rows, (size_t)n * 3 * sizeof(i32));
}

namespace {
struct IndexBuild {
    std::vector<u64> hs;
    std::vector<u64> nz;  // non-empty-bucket bitmap
};
}  // namespace

// DIndex build: per-genome thread-block scan (the reference's OpenMP
// decomposition makes sampling depend on the thread count), counting sort
// by xval, omit blocks > omit_block. dir_out: caller-allocated (numpy)
// int32[4^weight + 1], filled in place (268 MB for weight 13 — copies of it
// are expensive on slow-memory hosts, so there is exactly one buffer).
// Returns a handle for the hs table; fetch with le_index_fetch_hs, free
// with le_index_free.
void* le_build_index(const u8** genome_ptrs, const i64* genome_lens,
                     i64 n_genomes, int span, int weight, i64 min_step,
                     i64 max_step, i64 omit_block, i64 threads, i32* dir_out) {
    const bool timing = getenv("LE_TIMING") != nullptr;
    double t0 = timing ? omp_get_wtime() : 0.0;
    auto lap = [&](const char* name) {
        if (!timing) return;
        double t = omp_get_wtime();
        fprintf(stderr, "[le_build_index] %-12s %6.1f ms\n", name,
                (t - t0) * 1e3);
        t0 = t;
    };
    IndexBuild* b = new IndexBuild();
    i64 full = (1ll << (2 * weight)) + 1;
    // The (gid, t) thread-blocks are independent scans whose union is
    // canonicalized by the final value sort, so they can run on real
    // hardware threads regardless of the `threads` sampling parameter
    // (which only fixes the reference's omp block BOUNDS,
    // src/index_util.cpp:1650).
    std::vector<std::pair<i64, i64>> blocks;  // (gid, t)
    for (i64 gid = 0; gid < n_genomes; gid++)
        for (i64 t = 0; t < threads; t++) blocks.push_back({gid, t});
    std::vector<std::vector<std::pair<i64, u64>>> parts(blocks.size());
#pragma omp parallel for schedule(dynamic)
    for (size_t bi = 0; bi < blocks.size(); bi++) {
        i64 gid = blocks[bi].first, t = blocks[bi].second;
        const u8* seq = genome_ptrs[gid];
        i64 n = genome_lens[gid];
        // thread_blocks (src/index_util.cpp:1650): bounds[t] = n/threads*t,
        // bounds[threads] = n - span; block t scans [b[t]+span, b[t+1]-span)
        i64 t_str = n / threads * t + span;
        i64 t_end = (t + 1 == threads ? n - span : n / threads * (t + 1)) - span;
        if (t_end <= t_str) continue;
        HashStream st(span, weight);
        if (st.init(seq, n, t_str) < 0) continue;
        auto& samples = parts[bi];
        samples.reserve((t_end - t_str) / (min_step + 1) + 16);
        i64 count = 0;
        u64 last_x = ~0ull;
        i64 last_j = LLMIN / 2;
        bool have_last = false;
        for (i64 j = t_str; j < t_end; j++) {
            st.nexth(seq, j);
            if (++count <= min_step) continue;
            count = 0;
            st.nextx(seq, n, j);
            if (!have_last || st.xval != last_x || j - last_j > max_step) {
                samples.push_back(
                    {(i64)st.xval,
                     make_cord(gid, j + (i64)ANCHOR_ZERO, (i64)st.yval,
                               st.strand)});
                last_x = st.xval;
                last_j = j;
                have_last = true;
            }
        }
    }
    lap("scan");
    size_t total = 0;
    for (auto& p : parts) total += p.size();
    std::vector<std::pair<i64, u64>> samples;
    samples.reserve(total);
    for (auto& p : parts) {
        samples.insert(samples.end(), p.begin(), p.end());
        p.clear();
        p.shrink_to_fit();
    }
    lap("concat");
    // NOTE on the 268 MB table: do NOT madvise(MADV_HUGEPAGE) here — this
    // host runs THP defrag=madvise, where hugepage-marked VMAs pay
    // SYNCHRONOUS compaction on fault (~0.9 s measured for the full table
    // vs ~0.13 s of plain 4 KB first-touch). Parallel first-touch prefault:
    // the kernel's fault-time zeroing spreads over all cores and the later
    // streaming prefix pass hits already-mapped pages.
#pragma omp parallel for schedule(static)
    for (i64 x = 0; x < full; x += 1024) dir_out[x] = 0;
    lap("prefault");
    // counting sort with omit filter, in the caller's buffer
    for (auto& s : samples) dir_out[s.first + 1]++;
    lap("histogram");
    // fused omit + prefix sum over the 4^weight-entry table: chunked
    // two-pass so both cores stream their half (chunk sums first, then
    // rebase) — with hugepage backing the page-fault serialization that
    // made this slower pre-THP is gone
    {
        const int NC = omp_get_max_threads() > 1 ? 2 * omp_get_max_threads() : 1;
        std::vector<i64> csum(NC + 1, 0);
        i64 per = (full - 1 + NC - 1) / NC;
#pragma omp parallel for schedule(static, 1)
        for (int c = 0; c < NC; c++) {
            i64 x0 = 1 + (i64)c * per, x1 = std::min(full, x0 + per);
            i64 acc = 0;
            for (i64 x = x0; x < x1; x++) {
                i32 v = dir_out[x];
                if (v > omit_block) v = 0;
                acc += v;
                dir_out[x] = (i32)acc;  // chunk-local prefix
            }
            csum[c + 1] = acc;
        }
        for (int c = 1; c <= NC; c++) csum[c] += csum[c - 1];
#pragma omp parallel for schedule(static, 1)
        for (int c = 1; c < NC; c++) {
            i64 x0 = 1 + (i64)c * per, x1 = std::min(full, x0 + per);
            i32 base = (i32)csum[c];
            for (i64 x = x0; x < x1; x++) dir_out[x] += base;
        }
    }
    lap("prefix");
    if ((i64)samples.size() < (8 << 20)) {
        // bacterial/chr scale: the global pair sort is cheaper than
        // touching the 268 MB cursor table (pairs are distinct, so the
        // parallel unstable sort reproduces std::sort's order exactly)
#ifdef _OPENMP
        __gnu_parallel::sort(samples.begin(), samples.end());
#else
        std::sort(samples.begin(), samples.end());
#endif
        lap("sort");
        b->hs.reserve(samples.size());
        b->nz.assign((size_t)(((full - 1) + 63) >> 6), 0);
        for (auto& s : samples)
            if (dir_out[s.first + 1] - dir_out[s.first] > 0) {
                b->hs.push_back(s.second);
                b->nz[s.first >> 6] |= 1ull << (s.first & 63);
            }
        lap("hs_fill");
        return b;
    }
    // bucket the samples with the prefix offsets directly, then sort each
    // bucket's values — the global (xval, cord) pair sort above goes
    // superlinear past 1 Gb (375M x 16B pairs through a parallel
    // comparison sort at 3 Gb). Values within a bucket are distinct, so
    // ascending per-bucket std::sort reproduces the pair sort's order.
    i64 n_kept = dir_out[full - 1];
    b->hs.resize((size_t)n_kept);
    b->nz.assign((size_t)(((full - 1) + 63) >> 6), 0);
    {
        // parallel scatter with atomic bucket cursors: any within-bucket
        // order is fine (the per-bucket value sort below canonicalizes),
        // and contention is negligible across 4^13 buckets. nz bit sets
        // are idempotent; the atomic OR keeps cross-thread updates safe.
        std::vector<i32> cur(dir_out, dir_out + full - 1);
        i64 ns = (i64)samples.size();
#pragma omp parallel for schedule(static)
        for (i64 i = 0; i < ns; i++) {
            auto& s = samples[i];
            if (dir_out[s.first + 1] - dir_out[s.first] > 0) {
                i32 slot = __atomic_fetch_add(&cur[s.first], 1, __ATOMIC_RELAXED);
                b->hs[(size_t)slot] = s.second;
                __atomic_fetch_or(&b->nz[s.first >> 6],
                                  1ull << (s.first & 63), __ATOMIC_RELAXED);
            }
        }
    }
    lap("scatter");
#pragma omp parallel for schedule(dynamic, 65536)
    for (i64 x = 0; x < full - 1; x++) {
        i32 d0 = dir_out[x], d1 = dir_out[x + 1];
        if (d1 - d0 > 1)
            std::sort(b->hs.begin() + d0, b->hs.begin() + d1);
    }
    lap("bucketsort");
    return b;
}

// HIndex (-i 2) build: thread-chunked hash emission runs in parallel per
// (gid, chunk); finalize is serial (sort-dominated). Returns a handle;
// fetch sizes/arrays then free.
void* le_build_hindex(const u8** genome_ptrs, const i64* genome_lens,
                      i64 n_genomes, int span, i64 step, i64 blocklimit,
                      double alpha, i64 threads) {
    double t0 = omp_get_wtime();
    const bool timing = getenv("LE_TIMING") != nullptr;
    auto lap = [&](const char* name) {
        if (!timing) return;
        double t = omp_get_wtime();
        fprintf(stderr, "[le_build_hindex] %-10s %7.1f ms\n", name,
                (t - t0) * 1e3);
        t0 = t;
    };
    int weight = span - 8;
    struct Chunk { i64 gid, start, csize; };
    std::vector<Chunk> chunks;
    for (i64 gid = 0; gid < n_genomes; gid++) {
        i64 total = genome_lens[gid] - span + 1;
        if (total <= 0) continue;
        // _thread_chunks (src/index_util.cpp:740-760)
        i64 size2 = total / threads;
        i64 rem = total - size2 * threads;
        for (i64 t = 0; t < threads; t++) {
            if (t < rem)
                chunks.push_back({gid, (size2 + 1) * t, size2 + 1});
            else
                chunks.push_back({gid, total - size2 * (threads - t), size2});
        }
    }
    std::vector<std::vector<u64>> parts(chunks.size());
#pragma omp parallel for schedule(dynamic)
    for (size_t c = 0; c < chunks.size(); c++) {
        const Chunk& ck = chunks[c];
        hb_chunk(genome_ptrs[ck.gid], genome_lens[ck.gid], ck.start,
                 ck.csize, span, weight, step, ck.gid, parts[c]);
    }
    lap("scan");
    std::vector<u64> hs;
    size_t total = 0;
    for (auto& p : parts) total += p.size();
    hs.reserve(total);
    for (auto& p : parts) {
        hs.insert(hs.end(), p.begin(), p.end());
        p.clear();
        p.shrink_to_fit();
    }
    lap("concat");
    HIndexBuild* b = new HIndexBuild();
    hb_finalize(hs, weight, blocklimit, alpha, *b);
    lap("finalize");
    return b;
}

void le_hindex_sizes(void* bp, i64* out3) {
    HIndexBuild* b = (HIndexBuild*)bp;
    out3[0] = (i64)b->ysa.size();
    out3[1] = b->nv;
    out3[2] = b->empty_dir;
}

void le_hindex_fetch(void* bp, u64* ysa_out, u64* v1_out, i64* v2_out,
                     u64* mask_out) {
    HIndexBuild* b = (HIndexBuild*)bp;
    std::memcpy(ysa_out, b->ysa.data(), b->ysa.size() * sizeof(u64));
    std::memcpy(v1_out, b->v1, b->nv * sizeof(u64));
    std::memcpy(v2_out, b->v2, b->nv * sizeof(i64));
    *mask_out = b->mask;
}

// zero-copy variant: the caller wraps these pointers in numpy views and
// keeps the build handle alive for the index's lifetime (at 1 Gb the
// fetch memcpy + fresh-page faults cost ~35 s on this host)
void le_hindex_ptrs(void* bp, void** out3, u64* mask_out) {
    HIndexBuild* b = (HIndexBuild*)bp;
    out3[0] = (void*)b->ysa.data();
    out3[1] = (void*)b->v1;
    out3[2] = (void*)b->v2;
    *mask_out = b->mask;
}

void le_hindex_build_free(void* bp) { delete (HIndexBuild*)bp; }

// Wire pack for the device seed path (ops/seeding.pack_superchunk):
// 2-bit LSB-first bases (4/byte) + 8 little-endian length bytes per row;
// N-containing reads ride zeroed with n_mask set (the numpy per-read
// loop costs ~34 us/read of dispatch overhead in the feeder thread).
void le_pack_superchunk(const u8** reads, const i64* lens, i64 n_reads,
                        i64 rows, i64 pad, u8* wire, u8* n_mask) {
    i64 rowbytes = pad / 4 + 8;
    std::memset(wire, 0, (size_t)(rows * rowbytes));
    std::memset(n_mask, 0, (size_t)rows);
    for (i64 i = 0; i < n_reads; i++) {
        const u8* r = reads[i];
        i64 m = lens[i] < pad ? lens[i] : pad;
        u8* w = wire + i * rowbytes;
        bool has_n = false;
        for (i64 k = 0; k < m; k++)
            if (r[k] == 4) { has_n = true; break; }
        if (has_n) {
            n_mask[i] = 1;  // wire stays zero
        } else {
            i64 k = 0;
            for (; k + 4 <= m; k += 4)
                w[k >> 2] = (u8)(r[k] | (r[k + 1] << 2) | (r[k + 2] << 4) |
                                 (r[k + 3] << 6));
            u8 b = 0;
            for (i64 j = 0; k + j < m; j++) b |= (u8)(r[k + j] << (2 * j));
            if (k < m) w[k >> 2] = b;
        }
        u64 ml = (u64)m;
        std::memcpy(w + pad / 4, &ml, 8);
    }
}

void le_stage_ns(void* ep, i64* out4) {
    Engine* e = (Engine*)ep;
    for (int k = 0; k < 4; k++) { out4[k] = e->ph_ns[k]; e->ph_ns[k] = 0; }
}

void le_apx_stage_ns(i64* out3) {
    for (int k = 0; k < 3; k++) { out3[k] = g_apx_ns[k]; g_apx_ns[k] = 0; }
}

i64 le_index_hs_len(void* bp) { return (i64)((IndexBuild*)bp)->hs.size(); }
void le_index_fetch_hs(void* bp, u64* hs_out) {
    IndexBuild* b = (IndexBuild*)bp;
    if (!b->hs.empty())
        std::memcpy(hs_out, b->hs.data(), b->hs.size() * sizeof(u64));
}
i64 le_index_nz_len(void* bp) { return (i64)((IndexBuild*)bp)->nz.size(); }
void le_index_fetch_nz(void* bp, u64* nz_out) {
    IndexBuild* b = (IndexBuild*)bp;
    if (!b->nz.empty())
        std::memcpy(nz_out, b->nz.data(), b->nz.size() * sizeof(u64));
}
void le_index_free(void* bp) { delete (IndexBuild*)bp; }

}  // extern "C"
