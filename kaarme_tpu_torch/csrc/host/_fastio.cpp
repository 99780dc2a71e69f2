// Native fast path for host-side input encoding.
//
// The reference's input runtime is C++ (chunked readers + worker threads,
// reference: include/text_reader.h, include/parallel_parser.hpp); here the
// native piece is the byte->2-bit-code encoder, the only host-side loop
// that touches every input byte.  Everything downstream is device work.
//
// Built by kaarme_tpu_torch/io/fastio.py at first use (g++ -O3 -shared
// -fPIC) into build/kaarme_tpu_torch/, named by a hash of this source, and
// bound via ctypes there; a NumPy fallback exists.

#include <cstddef>
#include <cstdint>

namespace {

// byte -> code: A/a=0 C/c=1 G/g=2 T/t=3, everything else 4 (reset).
struct Lut {
    uint8_t t[256];
    constexpr Lut() : t() {
        for (int i = 0; i < 256; ++i) t[i] = 4;
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
constexpr Lut kLut;

}  // namespace

extern "C" {

// Plain one-string-per-line input: every byte maps through the LUT, so a
// newline is code 4 (reset).  Output length == n.
void kt_encode_plain(const uint8_t* in, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; ++i) out[i] = kLut.t[in[i]];
}

// FASTA input: '>' anywhere opens a header that is skipped up to the next
// newline and emits one reset code 4; newlines inside sequence are
// dropped; other bytes map through the LUT.  `*in_header` carries the
// broken-header state across chunk boundaries.  Returns #codes written
// (<= n); `out` must have room for n bytes.
size_t kt_encode_fasta(const uint8_t* in, size_t n, uint8_t* out,
                       int* in_header) {
    size_t o = 0;
    int hdr = *in_header;
    for (size_t i = 0; i < n; ++i) {
        const uint8_t b = in[i];
        if (hdr) {
            if (b == '\n') {
                hdr = 0;
                out[o++] = 4;  // header terminates: reset the window
            }
            continue;
        }
        if (b == '>') {
            hdr = 1;
            continue;
        }
        if (b == '\n') continue;  // sequence wraps across lines
        out[o++] = kLut.t[b];
    }
    *in_header = hdr;
    return o;
}

// FASTQ input: 4-part records (@header / sequence / '+' line / quality,
// where sequence and quality may wrap lines and quality bytes can be
// '@' or '+').  Emits sequence codes with one reset (4) at each record
// start; all other parts are skipped.  The reference never implemented
// FASTQ (include/parallel_parser.hpp "Not implemented yet"); this is a
// capability superset.  State carried across chunks:
//   *state: 0=header 1=seq 2=seq-at-newline 3=plus-line 4=quality
//           5=between-records
//   *seq_len / *qual_len: byte counts of the current record.
// Returns #codes written (<= n + 1); out must have room for n + 1.
size_t kt_encode_fastq(const uint8_t* in, size_t n, uint8_t* out,
                       int* state, long long* seq_len, long long* qual_len) {
    size_t o = 0;
    int st = *state;
    long long sl = *seq_len, ql = *qual_len;
    for (size_t i = 0; i < n; ++i) {
        const uint8_t b = in[i];
        switch (st) {
            case 0:  // header line: skip to newline, then reset + sequence
                if (b == '\n') { st = 1; sl = 0; ql = 0; out[o++] = 4; }
                break;
            case 1:  // sequence
                if (b == '\n') { st = 2; }
                else { out[o++] = kLut.t[b]; ++sl; }
                break;
            case 2:  // after a sequence newline: '+' ends the sequence part
                if (b == '+') { st = 3; }
                else if (b == '\n') { /* blank line inside sequence */ }
                else { st = 1; out[o++] = kLut.t[b]; ++sl; }
                break;
            case 3:  // '+' line: skip to newline
                if (b == '\n') { st = 4; }
                break;
            case 4:  // quality: count bytes (may include '@'/'+')
                if (b == '\n') { if (ql >= sl) st = 5; }
                else { ++ql; }
                break;
            case 5:  // between records: next '@' (or any line) is a header
                if (b == '\n') { /* skip blank */ }
                else { st = 0; }
                break;
        }
    }
    *state = st;
    *seq_len = sl;
    *qual_len = ql;
    return o;
}

// Pack a {0..4} code stream for device transfer: 16 bases per uint32
// word (base i at bits 2*(i%16)), plus an invalid bitmap (bit i of mask
// word i/32 set when code >= 4).  Invalid positions contribute 0 bits to
// the packed words.  Caller sizes out_packed to ceil(n/16) words and
// out_mask to ceil(n/32) words; both are fully written (zero padded).
void kt_pack_codes(const uint8_t* in, size_t n, uint32_t* out_packed,
                   uint32_t* out_mask) {
    const size_t np = (n + 15) / 16, nm = (n + 31) / 32;
    for (size_t w = 0; w < np; ++w) out_packed[w] = 0;
    for (size_t w = 0; w < nm; ++w) out_mask[w] = 0;
    size_t i = 0;
    // fast path: full 32-code groups
    for (; i + 32 <= n; i += 32) {
        uint32_t p0 = 0, p1 = 0, m = 0;
        for (int j = 0; j < 16; ++j) {
            const uint8_t c = in[i + j];
            const uint8_t bad = c >> 2;  // 1 iff c >= 4 (codes are 0..4)
            p0 |= static_cast<uint32_t>(bad ? 0 : c) << (2 * j);
            m |= static_cast<uint32_t>(bad) << j;
        }
        for (int j = 0; j < 16; ++j) {
            const uint8_t c = in[i + 16 + j];
            const uint8_t bad = c >> 2;
            p1 |= static_cast<uint32_t>(bad ? 0 : c) << (2 * j);
            m |= static_cast<uint32_t>(bad) << (16 + j);
        }
        out_packed[i / 16] = p0;
        out_packed[i / 16 + 1] = p1;
        out_mask[i / 32] = m;
    }
    for (; i < n; ++i) {
        const uint8_t c = in[i];
        if (c >= 4) {
            out_mask[i / 32] |= 1u << (i % 32);
        } else {
            out_packed[i / 16] |= static_cast<uint32_t>(c) << (2 * (i % 16));
        }
    }
}

}  // extern "C"
