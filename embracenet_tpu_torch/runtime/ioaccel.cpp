// Native IO/codec acceleration for embracenet_tpu_torch: the port's own copy
// of embracenet_tpu/runtime/ioaccel.cpp (host code, no device kernel).
//
// The reference's input path re-encodes every 256-bp window per sample per
// epoch in Python (`BIOINF_tesi/data_pipe/dataprepare.py:370-412`); the port
// encodes once, and this translation unit makes that one pass and the FASTA
// parse native:
//
//   enc_encode_sequences : ASCII bases -> uint8 codes (a=0,c=1,g=2,t=3),
//                          unknown bases filled from a xorshift RNG stream
//   enc_complement       : codes -> 3 - codes (complement strand)
//   enc_parse_fasta      : raw .fa bytes (seq line / header line alternating)
//                          -> packed codes + header offsets
//   enc_knn              : brute-force k-nearest-neighbour indices among
//                          minority-class rows (SMOTE's hot loop)
//
// The xorshift stream and the parse are the JAX package's, byte for byte, so
// both packages encode a FASTA with unknown bases to the same codes.  Built
// with -ffp-contract=off: enc_knn sums squared differences feature by
// feature without fused multiply-adds, the order data/sampling.knn_sorted
// reproduces.  Exposed with C linkage for ctypes; see runtime/__init__.py.

#include <cstdint>
#include <cstring>
#include <cstdio>

extern "C" {

static inline uint64_t xorshift64(uint64_t* s) {
    uint64_t x = *s;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    *s = x;
    return x;
}

// ASCII -> code lookup; 255 = unknown.
static uint8_t LUT[256];
static bool lut_init = false;
static void init_lut() {
    if (lut_init) return;
    memset(LUT, 255, sizeof(LUT));
    LUT[(unsigned)'a'] = 0; LUT[(unsigned)'A'] = 0;
    LUT[(unsigned)'c'] = 1; LUT[(unsigned)'C'] = 1;
    LUT[(unsigned)'g'] = 2; LUT[(unsigned)'G'] = 2;
    LUT[(unsigned)'t'] = 3; LUT[(unsigned)'T'] = 3;
    lut_init = true;
}

// Encode n_bytes of ASCII into out (same length); unknown -> random base.
void enc_encode_sequences(const uint8_t* ascii, int64_t n_bytes,
                          uint8_t* out, uint64_t seed) {
    init_lut();
    uint64_t state = seed | 1ull;
    for (int64_t i = 0; i < n_bytes; ++i) {
        uint8_t c = LUT[ascii[i]];
        if (c == 255) c = (uint8_t)(xorshift64(&state) & 3);
        out[i] = c;
    }
}

void enc_complement(const uint8_t* codes, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = (uint8_t)(3 - codes[i]);
}

// Parse a reference-layout FASTA blob: alternating sequence line (even) and
// ">chrom:start-end" header line (odd).  Writes codes row-major into `out`
// (n_rows x seq_len) and returns the number of rows parsed, or -1 on a
// length mismatch.  `headers_out` receives byte offsets of each header line
// start (for host-side coordinate parsing).
int64_t enc_parse_fasta(const uint8_t* buf, int64_t n_bytes, int64_t seq_len,
                        uint8_t* out, int64_t max_rows,
                        int64_t* header_offsets, uint64_t seed) {
    init_lut();
    uint64_t state = seed | 1ull;
    int64_t row = 0;
    int64_t i = 0;
    int line_idx = 0;
    while (i < n_bytes && row < max_rows) {
        int64_t start = i;
        while (i < n_bytes && buf[i] != '\n') ++i;
        int64_t len = i - start;
        if (len > 0 && buf[start + len - 1] == '\r') --len;
        if (len > 0) {
            if (line_idx % 2 == 0) {   // sequence line
                if (len != seq_len) return -1;
                uint8_t* dst = out + row * seq_len;
                for (int64_t j = 0; j < seq_len; ++j) {
                    uint8_t c = LUT[buf[start + j]];
                    if (c == 255) c = (uint8_t)(xorshift64(&state) & 3);
                    dst[j] = c;
                }
            } else {                   // header line
                header_offsets[row] = start;
                ++row;
            }
            ++line_idx;
        }
        ++i;  // skip newline
    }
    // file may end with an unterminated pair: if the last sequence had no
    // header line, drop it (row counts completed pairs)
    return row;
}

// For each of n_query rows (d floats) pick k nearest among n_ref rows by
// squared euclidean distance (self excluded when query == ref array).
// Writes k indices per query.  O(n_query * n_ref * d) — used for SMOTE.
void enc_knn(const double* ref, int64_t n_ref, const double* query,
             int64_t n_query, int64_t d, int64_t k, int64_t self_exclude,
             int32_t* out_idx) {
    for (int64_t q = 0; q < n_query; ++q) {
        // simple selection of k smallest
        double best_d[64];
        int32_t best_i[64];
        int64_t kk = k > 64 ? 64 : k;
        for (int64_t j = 0; j < kk; ++j) { best_d[j] = 1e300; best_i[j] = -1; }
        const double* qv = query + q * d;
        for (int64_t r = 0; r < n_ref; ++r) {
            if (self_exclude && r == q) continue;
            const double* rv = ref + r * d;
            double dist = 0.0;
            for (int64_t j = 0; j < d; ++j) {
                double diff = qv[j] - rv[j];
                dist += diff * diff;
            }
            // insert into the running top-k
            if (dist < best_d[kk - 1]) {
                int64_t pos = kk - 1;
                while (pos > 0 && best_d[pos - 1] > dist) {
                    best_d[pos] = best_d[pos - 1];
                    best_i[pos] = best_i[pos - 1];
                    --pos;
                }
                best_d[pos] = dist;
                best_i[pos] = (int32_t)r;
            }
        }
        for (int64_t j = 0; j < kk; ++j) out_idx[q * k + j] = best_i[j];
    }
}

}  // extern "C"
