// cords -> CIGAR -> SAM emission — native twin of linear_tpu/out/bamlink.py
// (reference: cords2BamLink/cord2cigar_ src/f_io.cpp:883,758; record-link /
// SA:Z / NM synthesis src/align_util.cpp:301,452,642-808; writeSam
// src/f_io.cpp:313; reformCCSBams src/f_io.cpp:1166).
#pragma once
#include "le_common.hpp"

namespace le {

static const int BAM_FLAG_RVCMP = 16;
static const int BAM_FLAG_SUPPL = 2048;
static const i64 INF60 = (1ll << 60) - 1;

struct Cigar {
    char op;
    i64 count;
};

struct BamScore {
    i64 s1 = 0, s2 = 0, s3 = 0;
};

struct BamLinkRecord {
    i64 rID = -1;
    i64 beginPos = -1;
    int flag = 0;
    int mapQ = 255;
    std::vector<Cigar> cigar;
    i64 next_id = -1;
    bool available = true;
    i64 nm_i = 0;
    bool saz_cached = false;
    Cigar saz_cigar[4];
    BamScore score;
    std::string saz_tag;
    std::string seq;
    bool is_chain_end() const { return next_id < 0; }
};

// appendCigarShrink (src/f_io.cpp:659)
static inline void append_cigar_shrink(std::vector<Cigar>& cigars, char op,
                                       i64 count) {
    if (!cigars.empty() && cigars.back().op == op) cigars.back().count += count;
    else cigars.push_back({op, count});
}

// ifCreateNew_ (src/f_io.cpp:674)
static inline bool if_create_new(u64 c1_str, u64 c1_end, u64 c2_str, u64 c2_end,
                                 i64 thd_large_X) {
    i64 x11 = cx(c1_str), y11 = cy(c1_str);
    i64 x12 = cx(c1_end), y12 = cy(c1_end);
    i64 x21 = cx(c2_str), y21 = cy(c2_str);
    return is_end(c1_str) != 0 || x11 > x21 || y11 > y21 ||
           (x21 - x12 > thd_large_X && y21 - y12 > thd_large_X) ||
           cstrand(c1_str ^ c2_str) != 0;
}

// createRectangleCigarPair (src/f_io.cpp:697); dx/dy in uint64 wrap
static inline void rectangle_pair(u64 cord1, u64 cord2, int f_m, Cigar* c1,
                                  Cigar* c2) {
    u64 dx = (u64)(cx(cord2) - cx(cord1));
    u64 dy = (u64)(cy(cord2) - cy(cord1));
    char op1 = f_m ? 'X' : '=';
    if (dx >= dy) {
        *c1 = {op1, (i64)dy};
        *c2 = {'D', (i64)(dx - dy)};
    } else {
        *c1 = {op1, (i64)dx};
        *c2 = {'I', (i64)(dy - dx)};
    }
}

// socreCigarPair (src/f_io.cpp:723)
static inline void score_pair(const Cigar& c1, const Cigar& c2, BamScore& score,
                              i64 thd_variant_indel_min_len = 100) {
    if ((c1.op == '=' || c1.op == 'X') && (c2.op == 'I' || c2.op == 'D')) {
        if (c1.op == '=') {
            score.s1 += c1.count;
            score.s3 += c1.count;
        } else {
            score.s2 += c1.count;
        }
        score.s2 += c2.count < thd_variant_indel_min_len ? c2.count : 0;
        if (c2.op == 'I') score.s3 += c2.count;
    }
}

// cord2cigar_ (src/f_io.cpp:758). Returns next cigar start cord or 0 w/
// *err=1 on a diagonal mismatch.
static inline u64 cord2cigar(u64 cigar_str, u64 cord1_str, u64 cord1_end,
                             u64 cord2_str, std::vector<Cigar>& cigar,
                             BamScore& score, i64 thd_DI, i64 thd_X, int* err) {
    *err = 0;
    i64 x0 = cx(cigar_str), y0 = cy(cigar_str);
    i64 x11 = cx(cord1_str), y11 = cy(cord1_str);
    i64 x12 = cx(cord1_end), y12 = cy(cord1_end);
    i64 x21 = cx(cord2_str), y21 = cy(cord2_str);
    Cigar c1{'=', 0}, c2{'=', 0};
    if (x0 - y0 != x11 - y11) {
        *err = 1;
        return 0;
    }
    if (x12 >= x21 && y12 >= y21) {
        rectangle_pair(cord1_str, cord2_str, 0, &c1, &c2);
        if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
        if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
    } else if (x12 < x21 && y12 < y21) {
        rectangle_pair(cord1_str, cord1_end, 0, &c1, &c2);
        if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
        if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
        i64 DI = (x21 - x12) - (y21 - y12);
        i64 X = std::min(x21 - x12, y21 - y12);
        if (std::abs(DI) > thd_DI && X > thd_X) {
            i64 split_n = std::min(
                (i64)std::ceil((double)std::abs(DI) / (double)thd_DI), X);
            i64 split_DI = thd_DI;
            i64 split_X = X / split_n;
            u64 split_cord_str = cord1_end;
            rectangle_pair(cord1_end, cord2_str, 1, &c1, &c2);
            for (i64 s = 0; s < split_n - 1; s++) {
                u64 split_cord_end =
                    DI < 0 ? shiftc(split_cord_str, split_X, split_X + split_DI)
                           : shiftc(split_cord_str, split_X + split_DI, split_X);
                rectangle_pair(split_cord_str, split_cord_end, 0, &c1, &c2);
                if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
                if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
                split_cord_str = split_cord_end;
            }
            rectangle_pair(split_cord_str, cord2_str, 1, &c1, &c2);
            if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
            if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
        } else {
            rectangle_pair(cord1_end, cord2_str, 1, &c1, &c2);
            if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
            if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
        }
    } else {
        rectangle_pair(cord1_str, cord2_str, 0, &c1, &c2);
        if (c1.count) append_cigar_shrink(cigar, c1.op, c1.count);
        if (c2.count) append_cigar_shrink(cigar, c2.op, c2.count);
    }
    score_pair(c1, c2, score);
    return cord2_str;
}

// cords2BamLink (src/f_io.cpp:883) for one read
static inline void cords2bamlink(const std::vector<u64>& cords_str,
                                 const std::vector<u64>& cords_end, i64 read_len,
                                 i64 thd_large_X, i64 thd_DI, i64 thd_X,
                                 std::vector<BamLinkRecord>& records) {
    records.clear();
    bool f_new = true;
    int flag = 0;
    u64 cigar_str = 0;
    std::vector<i64> bam_records_ptrs;
    std::vector<i64> cords_block_end_ptrs;
    i64 n = (i64)cords_str.size();
    for (i64 i = 1; i < n; i++) {
        if (f_new) {
            if (i != 1) {
                bam_records_ptrs.push_back((i64)records.size() - 1);
                cords_block_end_ptrs.push_back(i - 1);
            }
            f_new = false;
            BamLinkRecord rec;
            rec.rID = cid(cords_str[i]);
            rec.beginPos = cx(cords_str[i]);
            rec.flag = flag | (cstrand(cords_str[i]) ? BAM_FLAG_RVCMP : 0);
            i64 r_begin = cy(cords_str[i]);
            if (r_begin != 0) rec.cigar.push_back({'S', r_begin});
            records.push_back(std::move(rec));
            cigar_str = cords_str[i];
            flag = 0;
        }
        u64 cord1_str, cord1_end, cord2_str;
        if (i == n - 1 || if_create_new(cords_str[i], cords_end[i],
                                        cords_str[i + 1], cords_end[i + 1],
                                        thd_large_X)) {
            cord1_str = cords_str[i];
            cord1_end = cords_end[i];
            cord2_str = cords_end[i];
            f_new = true;
            flag = BAM_FLAG_SUPPL;
        } else {
            cord1_str = cords_str[i];
            cord1_end = cords_end[i];
            cord2_str = cords_str[i + 1];
        }
        int err;
        cigar_str = cord2cigar(cigar_str, cord1_str, cord1_end, cord2_str,
                               records.back().cigar, records.back().score, thd_DI,
                               thd_X, &err);
        if (err) break;
        if (i == n - 1) {
            bam_records_ptrs.push_back((i64)records.size() - 1);
            cords_block_end_ptrs.push_back(n - 1);
        }
    }
    for (size_t k = 0; k < bam_records_ptrs.size(); k++) {
        i64 ptr = bam_records_ptrs[k];
        i64 cep = cords_block_end_ptrs[k];
        i64 clipped_end_len = read_len - cy(cords_end[cep]);
        if (clipped_end_len > 0) records[ptr].cigar.push_back({'S', clipped_end_len});
    }
}

// updateHeadsTable (src/align_util.cpp:568)
static inline void heads_of(const std::vector<BamLinkRecord>& records,
                            std::vector<i64>& heads) {
    heads.clear();
    std::vector<char> visited(records.size(), 0);
    for (i64 i = 0; i < (i64)records.size(); i++) {
        if (visited[i]) continue;
        i64 it = i;
        bool f_complete = false;
        for (;;) {
            visited[it] = 1;
            if (!records[it].available) break;
            if (records[it].is_chain_end()) {
                f_complete = true;
                break;
            }
            it = records[it].next_id;
        }
        if (f_complete) heads.push_back(i);
    }
}

// createSAZTagCigar (src/align_util.cpp:452), f_remove=0
static inline i64 saz_cigar4(const std::vector<Cigar>& cigar, Cigar out[4]) {
    i64 cm = 0, ci = 0, nm = 0, lead_s = 0;
    for (size_t i = 0; i < cigar.size(); i++) {
        const Cigar& c = cigar[i];
        if (i == 0 && c.op == 'S') lead_s = c.count;
        else if (c.op == '=') cm += c.count;
        else if (c.op == 'X') { cm += c.count; nm += c.count; }
        else if (c.op == 'I') { ci -= c.count; nm += c.count; }
        else if (c.op == 'D') { ci += c.count; nm += c.count; }
    }
    out[0] = {'S', lead_s};
    out[1] = {'M', cm};
    out[2] = ci < 0 ? Cigar{'I', -ci} : Cigar{'D', ci};
    out[3] = {'S', 0};
    return nm;
}

// createSAZTagOneChimeric (src/align_util.cpp:642-712) incl. the cached
// nm_i-reset quirk (nm_i = 0 when every record was already serialized)
static inline void saz_one_chimeric(std::vector<BamLinkRecord>& records, i64 it,
                                    std::string& out, const std::string& genome_id) {
    Cigar merged[4] = {{'S', 0}, {'M', 0}, {'?', 0}, {'S', 0}};
    bool merged_init = false;
    size_t merged_n = 0;
    i64 nm_sum = 0;
    bool any_computed = false;
    BamLinkRecord& head = records[it];
    i64 j = it;
    for (;;) {
        if (!records[j].saz_cached) {
            i64 nm = saz_cigar4(records[j].cigar, records[j].saz_cigar);
            records[j].saz_cached = true;
            nm_sum += nm;
            any_computed = true;
        }
        const Cigar* sc = records[j].saz_cigar;
        for (int k = 0; k < 4; k++) {
            if ((size_t)k >= merged_n) {
                merged[k] = sc[k];
                merged_n = k + 1;
            } else {
                merged[k].count += sc[k].count;
            }
        }
        (void)merged_init;
        if (records[j].is_chain_end()) break;
        j = records[j].next_id;
    }
    head.nm_i = any_computed ? nm_sum : 0;
    char buf[96];
    out += genome_id;
    out += ',';
    snprintf(buf, sizeof buf, "%lld", (long long)(head.beginPos + 1));
    out += buf;
    out += ',';
    out += (head.flag & 16) ? '-' : '+';
    out += ',';
    for (size_t k = 0; k < merged_n; k++) {
        snprintf(buf, sizeof buf, "%lld%c", (long long)merged[k].count,
                 merged[k].op);
        out += buf;
    }
    snprintf(buf, sizeof buf, ",%d,%lld;", head.mapQ, (long long)head.nm_i);
    out += buf;
}

// fillBamRecordLinkRecords (src/align_util.cpp:745), f_print_seq=0
static inline void fill_bam_records(std::vector<BamLinkRecord>& records,
                                    const std::vector<std::string>& genome_ids,
                                    std::vector<i64>& heads,
                                    std::vector<std::string>& head_genome_ids) {
    heads_of(records, heads);
    head_genome_ids.clear();
    for (i64 it : heads) head_genome_ids.push_back(genome_ids[records[it].rID]);
    for (size_t h = 0; h < heads.size(); h++) {
        std::string saz;
        for (size_t g = 0; g < heads.size(); g++) {
            if (g == h) continue;
            saz_one_chimeric(records, heads[g], saz, head_genome_ids[g]);
        }
        records[heads[h]].saz_tag = saz;
    }
}

// reformCCSBams (src/f_io.cpp:1166)
static inline void reform_ccs_bams(std::vector<BamLinkRecord>& records,
                                   i64 thd_rcb_xy = 15) {
    std::vector<char> visited(records.size(), 0);
    for (i64 i = 0; i < (i64)records.size(); i++) {
        if (visited[i]) continue;
        i64 it = i;
        i64 xy = 0;
        for (;;) {
            visited[it] = 1;
            std::vector<Cigar>& cig = records[it].cigar;
            std::vector<Cigar> out;
            for (auto& c : cig) {
                i64 new_count = c.count;
                i64 comp_count = new_count;
                char comp_op = c.op;
                if (c.op == 'I') {
                    if (std::abs(xy + new_count) < thd_rcb_xy) {
                        xy += new_count;
                        comp_op = '=';
                        comp_count = new_count;
                    }
                } else if (c.op == 'D') {
                    if (std::abs(xy - new_count) < thd_rcb_xy) {
                        xy -= new_count;
                        comp_op = '=';
                        comp_count = 0;
                    }
                }
                if (!out.empty() && out.back().op == comp_op)
                    out.back().count += comp_count;
                else if (comp_count != 0)
                    out.push_back({comp_op, comp_count});
            }
            records[it].cigar = out;
            if (records[it].is_chain_end()) break;
            it = records[it].next_id;
        }
    }
}

// cigar2SamSeq (src/align_util.cpp:1434) — SEQ synthesis when sequence_sam.
// Runtime semantics are f_is_align = options.aln_flag = 0
// (src/mapper.cpp:282): '='/'M' emit GENOME bases, 'X' emits the read base
// where it differs else 'N', 'I'/'S' read bases, 'D' advances the genome.
static inline void synth_seq(std::vector<BamLinkRecord>& records,
                             const std::vector<i64>& heads,
                             const u8* const* genomes, const i64* genome_lens,
                             const u8* read, const u8* rc, i64 read_len) {
    static const char* bases = "ACGTN";
    for (i64 it : heads) {
        BamLinkRecord& rec = records[it];
        const u8* genome = genomes[rec.rID];
        i64 glen = genome_lens[rec.rID];
        const u8* src2 = (rec.flag & 16) ? rc : read;
        i64 i1 = rec.beginPos;
        i64 i2 = 0;
        std::string parts;
        i64 j = it;
        for (;;) {
            for (auto& c : records[j].cigar) {
                if (c.op == 'D') {
                    i1 += c.count;
                } else if (c.op == 'I' || c.op == 'S') {
                    for (i64 p = i2; p < i2 + c.count && p < read_len; p++)
                        parts += bases[src2[p]];
                    i2 += c.count;
                } else if (c.op == 'M' || c.op == '=') {
                    for (i64 p = i1; p < i1 + c.count && p < glen; p++)
                        parts += bases[genome[p]];
                    i1 += c.count;
                    i2 += c.count;
                } else if (c.op == 'X') {
                    for (i64 k = 0; k < c.count; k++) {
                        if (i1 + k >= glen || i2 + k >= read_len) break;
                        u8 g = genome[i1 + k];
                        u8 r = src2[i2 + k];
                        parts += (g != r) ? bases[r] : 'N';
                    }
                    i1 += c.count;
                    i2 += c.count;
                } else if (c.op == 'H') {
                    i2 += c.count;
                }
            }
            if (records[j].is_chain_end()) break;
            j = records[j].next_id;
        }
        rec.seq = parts;
    }
}

// writeSam (src/f_io.cpp:313): one line per head
static inline void sam_lines(std::vector<BamLinkRecord>& records,
                             const std::vector<i64>& heads,
                             const std::vector<std::string>& head_genome_ids,
                             const std::string& qname, std::string& out) {
    char buf[64];
    for (size_t h = 0; h < heads.size(); h++) {
        i64 it = heads[h];
        BamLinkRecord& rec = records[it];
        out += qname;
        out += '\t';
        snprintf(buf, sizeof buf, "%d", rec.flag);
        out += buf;
        out += '\t';
        out += head_genome_ids[h];
        out += '\t';
        snprintf(buf, sizeof buf, "%lld", (long long)(rec.beginPos + 1));
        out += buf;
        out += '\t';
        snprintf(buf, sizeof buf, "%d", rec.mapQ);
        out += buf;
        out += '\t';
        size_t cig_start = out.size();
        i64 j = it;
        for (;;) {
            for (auto& c : records[j].cigar) {
                snprintf(buf, sizeof buf, "%lld%c", (long long)c.count, c.op);
                out += buf;
            }
            if (records[j].is_chain_end()) break;
            j = records[j].next_id;
        }
        if (out.size() == cig_start) out += '*';
        out += "\t*\t0\t0\t";
        if (!rec.seq.empty()) out += rec.seq;
        else out += '*';
        out += "\t*";
        if (!rec.saz_tag.empty()) {
            out += "\tSA:Z:";
            out += rec.saz_tag;
        }
        out += '\n';
    }
}

}  // namespace le
