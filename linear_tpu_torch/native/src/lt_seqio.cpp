// Native sequence reader: fasta/fastq(.gz) -> (id, Dna5 codes).
//
// The runtime analog of the reference's SeqAn-backed record loading
// (loadRecords /root/reference/src/base.cpp:131 and the parallel_io fetch
// stage src/parallel_io.cpp:433): C++ owns file IO, gzip inflation, line
// parsing and base encoding; Python receives zero-parse buffers via ctypes.
// Record semantics are byte-identical to linear_tpu.utils.seqio
// (whitespace stripping, full-header ids, Dna5 A0 C1 G2 T3 else 4).
//
// Build: g++ -O3 -shared -fPIC lt_seqio.cpp -lz -o lt_seqio.so
#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
    gzFile f = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;
    int fmt = 0;  // '>' fasta, '@' fastq
    int err = 0;
    std::string header;      // current (stripped) header
    bool have_header = false;
    std::string id;          // last emitted record
    std::vector<uint8_t> seq;
    std::string line;        // scratch
    long limit = -1;         // remaining byte budget (range reads)
    uint8_t code[256];
};

bool fill(Reader* r) {
    if (r->eof) return false;
    size_t want = r->buf.size();
    if (r->limit >= 0 && static_cast<size_t>(r->limit) < want)
        want = static_cast<size_t>(r->limit);
    if (want == 0) { r->eof = true; return false; }
    int n = gzread(r->f, r->buf.data(), static_cast<unsigned>(want));
    if (n < 0) { r->err = 1; r->eof = true; return false; }
    if (n == 0) { r->eof = true; return false; }
    if (r->limit >= 0) r->limit -= n;
    r->pos = 0;
    r->len = static_cast<size_t>(n);
    return true;
}

// Read one line (without the trailing '\n'). Returns false only at pure
// EOF with no bytes consumed — mirrors Python readline() truthiness.
bool read_line(Reader* r, std::string& out) {
    out.clear();
    bool any = false;
    for (;;) {
        if (r->pos >= r->len && !fill(r)) return any;
        char* base = r->buf.data() + r->pos;
        size_t avail = r->len - r->pos;
        char* nl = static_cast<char*>(memchr(base, '\n', avail));
        if (nl) {
            out.append(base, nl - base);
            r->pos += static_cast<size_t>(nl - base) + 1;
            return true;
        }
        out.append(base, avail);
        r->pos = r->len;
        any = true;
    }
}

inline bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' || c == '\f';
}

void strip(const std::string& in, std::string& out) {
    size_t b = 0, e = in.size();
    while (b < e && is_space(in[b])) ++b;
    while (e > b && is_space(in[e - 1])) --e;
    out.assign(in, b, e - b);
}

void encode_append(Reader* r, const std::string& s) {
    size_t b = 0, e = s.size();
    while (b < e && is_space(s[b])) ++b;
    while (e > b && is_space(s[e - 1])) --e;
    size_t off = r->seq.size();
    r->seq.resize(off + (e - b));
    for (size_t i = b; i < e; ++i)
        r->seq[off + i - b] = r->code[static_cast<uint8_t>(s[i])];
}

}  // namespace

extern "C" {

void* lt_open(const char* path) {
    Reader* r = new Reader();
    r->f = gzopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    r->buf.resize(1 << 20);
    memset(r->code, 4, sizeof(r->code));
    const char* b = "ACGTacgt";
    const uint8_t v[] = {0, 1, 2, 3, 0, 1, 2, 3};
    for (int i = 0; i < 8; ++i) r->code[static_cast<uint8_t>(b[i])] = v[i];
    // detect format from the first byte; prime the first header
    std::string first;
    if (!read_line(r, first)) { r->fmt = 0; return r; }  // empty file
    if (!first.empty() && first[0] == '>') {
        r->fmt = '>';
        strip(first.substr(1), r->header);
        r->have_header = true;
    } else if (!first.empty() && first[0] == '@') {
        r->fmt = '@';
        strip(first.substr(1), r->header);
        r->have_header = true;
    } else {
        r->err = 2;  // unrecognized format
    }
    return r;
}

// 1 = record, 0 = EOF, -1 = error (format/parse)
int lt_next(void* h, const char** id, long* id_len,
            const unsigned char** seq, long* seq_len) {
    Reader* r = static_cast<Reader*>(h);
    if (r->err) return -1;
    if (!r->have_header) return 0;
    r->seq.clear();
    if (r->fmt == '>') {
        std::string stripped;
        for (;;) {
            if (!read_line(r, r->line)) {
                // EOF: emit the pending record
                r->id = r->header;
                r->have_header = false;
                break;
            }
            strip(r->line, stripped);
            if (!stripped.empty() && stripped[0] == '>') {
                r->id = r->header;
                // python: header = line.strip()[1:] — no second strip, a
                // leading space after '>' is kept on non-first headers
                r->header = stripped.substr(1);
                break;
            } else if (!stripped.empty()) {
                encode_append(r, stripped);
            }
        }
    } else {  // fastq
        std::string sline, qline, stripped;
        bool ok1 = read_line(r, sline);
        std::string plus;
        read_line(r, plus);
        bool ok3 = read_line(r, qline);
        std::string sseq;
        strip(ok1 ? sline : std::string(), sseq);
        if (!ok3 && sseq.empty()) { r->have_header = false; return 0; }
        encode_append(r, sseq);
        r->id = r->header;
        std::string nxt;
        if (!read_line(r, nxt)) {
            r->have_header = false;
        } else if (nxt.empty() || nxt[0] != '@') {
            r->err = 3;  // malformed fastq
            r->have_header = false;
        } else {
            strip(nxt.substr(1), r->header);
        }
    }
    *id = r->id.data();
    *id_len = static_cast<long>(r->id.size());
    *seq = r->seq.data();
    *seq_len = static_cast<long>(r->seq.size());
    return 1;
}

int lt_err(void* h) { return static_cast<Reader*>(h)->err; }

// Range variant for pipeline workers: parse only records in byte range
// [b0, b1) of an UNCOMPRESSED file (range bounds from record offsets,
// linear_tpu.utils.seqio.scan_record_offsets). Same record semantics as
// lt_open from a record-start offset.
void* lt_open_range(const char* path, long b0, long b1) {
    Reader* r = new Reader();
    r->f = gzopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    if (gzseek(r->f, b0, SEEK_SET) < 0) { gzclose(r->f); delete r; return nullptr; }
    r->limit = b1 - b0;
    r->buf.resize(1 << 20);
    memset(r->code, 4, sizeof(r->code));
    const char* b = "ACGTacgt";
    const uint8_t v[] = {0, 1, 2, 3, 0, 1, 2, 3};
    for (int i = 0; i < 8; ++i) r->code[static_cast<uint8_t>(b[i])] = v[i];
    std::string first;
    if (!read_line(r, first)) { r->fmt = 0; return r; }
    if (!first.empty() && first[0] == '>') {
        r->fmt = '>';
        strip(first.substr(1), r->header);
        r->have_header = true;
    } else if (!first.empty() && first[0] == '@') {
        r->fmt = '@';
        strip(first.substr(1), r->header);
        r->have_header = true;
    } else {
        r->err = 2;
    }
    return r;
}

void lt_close(void* h) {
    Reader* r = static_cast<Reader*>(h);
    if (r->f) gzclose(r->f);
    delete r;
}

}  // extern "C"
