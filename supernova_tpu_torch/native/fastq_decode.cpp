// Native FASTQ record decoder: ASCII buffer -> base codes + phred quals.
//
// TPU-native analogue of the reference's native ingestion front end
// (10X/ParseBarcodedFastqs.cc + lib/tada FASTQ readers): the byte-level
// parse/translate loop is the host-side hot path of ingestion, so it is C++
// (the Python layer handles gzip streaming and orchestration).
//
// Two-pass contract (simple, allocation-free ABI for ctypes):
//   fastq_scan(buf, len, &n_records, &total_bases)  -> 0 on success
//   fastq_decode(buf, len, codes_out, quals_out, offsets_out, n_records)
// Offsets are int64 CSR (n_records+1). Codes: A=0 C=1 G=2 T=3, N/other = 0.
// Quals are phred (ascii - 33).

#include <cstdint>
#include <cstring>

namespace {

inline const char* find_nl(const char* p, const char* end) {
    const void* q = memchr(p, '\n', end - p);
    return q ? static_cast<const char*>(q) : end;
}

// base translation table
struct Tab {
    uint8_t t[256];
    Tab() {
        memset(t, 0, sizeof(t));
        t[(unsigned)'C'] = 1; t[(unsigned)'c'] = 1;
        t[(unsigned)'G'] = 2; t[(unsigned)'g'] = 2;
        t[(unsigned)'T'] = 3; t[(unsigned)'t'] = 3;
    }
};
const Tab kTab;

}  // namespace

extern "C" {

// Pass 1: count records and total sequence bases.
int fastq_scan(const char* buf, int64_t len, int64_t* n_records,
               int64_t* total_bases) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t nr = 0, tb = 0;
    while (p < end) {
        if (*p != '@') return 1;  // malformed header
        const char* nl = find_nl(p, end);
        if (nl >= end) return 2;
        p = nl + 1;  // sequence line
        nl = find_nl(p, end);
        tb += nl - p;
        int64_t seq_len = nl - p;
        p = nl + 1;
        if (p >= end || *p != '+') return 3;
        nl = find_nl(p, end);
        p = nl + 1;  // qual line
        nl = find_nl(p, end);
        if (nl - p != seq_len) return 4;
        p = nl + 1;
        nr++;
    }
    *n_records = nr;
    *total_bases = tb;
    return 0;
}

// Pass 2: fill codes/quals/offsets (sizes from pass 1).
int fastq_decode(const char* buf, int64_t len, uint8_t* codes, uint8_t* quals,
                 int64_t* offsets, int64_t n_records) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t rec = 0, pos = 0;
    offsets[0] = 0;
    while (p < end && rec < n_records) {
        const char* nl = find_nl(p, end);  // header
        p = nl + 1;
        nl = find_nl(p, end);  // sequence
        int64_t seq_len = nl - p;
        for (int64_t i = 0; i < seq_len; i++) {
            codes[pos + i] = kTab.t[(unsigned char)p[i]];
        }
        p = nl + 1;
        nl = find_nl(p, end);  // '+'
        p = nl + 1;
        nl = find_nl(p, end);  // quals
        for (int64_t i = 0; i < seq_len; i++) {
            uint8_t q = (uint8_t)p[i];
            quals[pos + i] = q >= 33 ? q - 33 : 0;
        }
        p = nl + 1;
        pos += seq_len;
        rec++;
        offsets[rec] = pos;
    }
    return rec == n_records ? 0 : 1;
}

}  // extern "C"
