// P1: FASTA or plain-text bytes to the transfer chunk, on the card (CUDA
// C++, sm_90a).
//
// Replaces no Pallas kernel: the JAX package encodes and packs its input
// on the host (kaarme_tpu/io/fastio.py: encode_fasta / encode_plain, then
// pack_stream), as the port's host path still does for FASTQ and the
// sharded counters.  This kernel takes a block of the file's raw bytes and
// appends its codes to the device code stream, packed as the counters'
// supersteps read them: 2-bit words (16 bases a word, base i at bits
// 2 (i % 16) of word i / 16) and the dense separator bitmap (bit i % 32 of
// word i / 32 where position i holds code 4), bit for bit what
// fastio.pack_stream gives for the codes the host encoders would emit.
//
// The FASTA rule of kt_encode_fasta (csrc/host/_fastio.cpp): the header
// state after a byte is 1 on '>' and 0 on '\n' and unchanged otherwise.  In
// state 1 only '\n' emits (code 4, the end of a header); in state 0 every
// byte but '>' and '\n' emits its base code (A/C/G/T in either case 0-3,
// anything else 4).  So what a span of bytes emits depends only on the
// state it is entered in: its transfer is (f, c0, c1), f the state it
// leaves (or "unchanged" where the span holds no '>' and no '\n'), c0 and
// c1 the codes it emits when entered in state 0 and in state 1.  Transfers
// compose associatively (not commutatively), so one chained scan over
// tiles by decoupled look-back (scan.cuh) gives every thread its state and
// its first output position.  Plain text emits every byte.
//
// Output positions are global: code p belongs to superstep p / sb at local
// position p % sb, and when p % sb < k - 1 also to the previous superstep's
// halo (local position sb + p % sb); with k - 1 > sb to every earlier
// superstep whose chunk of span = sb + k - 1 codes holds it.  sb is a
// multiple of 32, so a word of either grid lies in one superstep's own
// range.  The chunks are zeroed before their first code; a tile stages its
// words in shared memory (each thread ORs its at most 16 codes into at most
// two words of each grid), stores the words that lie wholly inside its
// output range and ORs the two edge words, which a neighbouring tile may
// share, with atomics; halo copies are always ORed.  The offset and the
// header state carry from launch to launch in device scalars (st_in ->
// st_out: the host alternates two slots), so no launch waits on the host.
//
// What bounds it on the H100: bytes.  8 MiB of raw text read once, ~1 MiB
// of words and ~0.5 MiB of bitmap written per block: ~3 us at 3.35 TB/s;
// the look-back chain over 2,048 tiles of 4 KiB and the launch itself cost
// more than that.  Registers: see PERF.md (ptxas -v, sm_90a).
#include "scan.cuh"

namespace p1 {

constexpr int THREADS = 256;
constexpr int BPT = 16;                   // bytes a thread
constexpr int TILE = THREADS * BPT;       // bytes a tile
constexpr int SW = TILE / 16 + 3;         // staged 2-bit words, from the tile's 32-aligned base
constexpr int SMW = TILE / 32 + 2;        // staged bitmap words
constexpr long long CMASK = (1LL << 30) - 1;

// A transfer packed in a status value: c0 in bits 0-29, c1 in bits 30-59,
// f in bits 60-61 (0: unchanged, 1: leaves state 0, 2: leaves state 1).
__device__ __forceinline__ long long tpack(long long f, long long c0, long long c1) {
    return (f << 60) | (c1 << 30) | c0;
}

__device__ __forceinline__ int tf(long long x) { return (int)(x >> 60); }

__device__ __forceinline__ long long tc(long long x, int h) {
    return (x >> (h ? 30 : 0)) & CMASK;
}

// The state after the span, entered in state h.
__device__ __forceinline__ int tapply(long long x, int h) {
    const int f = tf(x);
    return f ? f - 1 : h;
}

// a, then b.  0 is the identity on both sides.
struct Compose {
    __device__ __forceinline__ long long operator()(long long a, long long b) const {
        const int f = tf(b) ? tf(b) : tf(a);
        return tpack(f, tc(a, 0) + tc(b, tapply(a, 0)), tc(a, 1) + tc(b, tapply(a, 1)));
    }
};

__device__ __forceinline__ int base_code(unsigned b) {
    const unsigned u = b & 0xDFu;          // upper case: only bit 5 differs
    return u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3 : 4;
}

struct Args {
    const uint8_t* raw;        // the block's bytes
    long long nb;
    long long ntiles;
    int fasta;                 // 0: plain text (every byte emits)
    const long long* st_in;    // [code offset, header state] before the block
    long long* st_out;         // the same after it
    long long* err;            // set to 1 where a code's superstep is not in the table
    unsigned long long* status;   // one word a tile, zeroed
    int* ticket;               // zeroed
    const unsigned long long* tab;   // (2-bit words, bitmap) pointers of supersteps base ..
    long long base;
    int nt;
    long long sb;              // windows a superstep, a multiple of 32
    long long span;            // codes a superstep's chunk holds: sb + k - 1
};

// Word g of the 2-bit grid (bitmap = false: 16 codes a word) or of the
// bitmap (32 a word), value v, into every chunk that holds its positions.
// ``whole``: no other tile writes to this word of the stream.
__device__ void put(const Args& a, bool bitmap, long long g, uint32_t v, bool whole) {
    if (!v) return;                        // the chunks are zeroed
    const int per = bitmap ? 32 : 16;
    const long long p = g * per;
    for (long long s = p / a.sb; s >= 0; --s) {
        const long long lp = p - s * a.sb;           // local position of the word's first code
        if (lp >= a.span) break;
        uint32_t w = v;
        const long long room = a.span - lp;
        if (room < per) w &= bitmap ? (1u << room) - 1u : (1u << (2 * room)) - 1u;
        if (!w) continue;
        const long long i = s - a.base;
        if (i < 0 || i >= a.nt) {
            *a.err = 1;
            continue;
        }
        uint32_t* dst = reinterpret_cast<uint32_t*>(a.tab[2 * i + (bitmap ? 1 : 0)]) + lp / per;
        if (whole && lp < a.sb)
            *dst = w;
        else
            atomicOr(dst, w);
    }
}

__global__ void __launch_bounds__(THREADS) parse_pack_kernel(const Args a) {
    __shared__ long long s_tile, s_pre;
    __shared__ uint32_t s_w[SW], s_m[SMW];
    const int t = threadIdx.x;
    if (t == 0) s_tile = atomicAdd(a.ticket, 1);
    for (int i = t; i < SW; i += THREADS) s_w[i] = 0u;
    for (int i = t; i < SMW; i += THREADS) s_m[i] = 0u;
    __syncthreads();
    const long long tile = s_tile;

    // this thread's 16 bytes
    const long long b0 = tile * TILE + (long long)t * BPT;
    const long long left = a.nb - b0;
    const int nv = left <= 0 ? 0 : (left >= BPT ? BPT : (int)left);
    uint32_t by[4] = {0u, 0u, 0u, 0u};
    if (nv == BPT && ((reinterpret_cast<uintptr_t>(a.raw + b0) & 15u) == 0)) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.raw + b0));
        by[0] = q.x;
        by[1] = q.y;
        by[2] = q.z;
        by[3] = q.w;
    } else {
        for (int i = 0; i < nv; ++i) by[i >> 2] |= (uint32_t)__ldg(a.raw + b0 + i) << (8 * (i & 3));
    }
#define P1_BYTE(i) ((by[(i) >> 2] >> (8 * ((i) & 3))) & 0xffu)

    // its transfer
    int f = 0;
    long long c0 = nv, c1 = nv;
    if (a.fasta) {
        c0 = c1 = 0;
        for (int i = 0; i < nv; ++i) {
            const unsigned b = P1_BYTE(i);
            const bool nl = b == '\n', gt = b == '>';
            const int s0 = f ? f - 1 : 0, s1 = f ? f - 1 : 1;
            c0 += s0 ? nl : !(nl || gt);
            c1 += s1 ? nl : !(nl || gt);
            f = gt ? 2 : nl ? 1 : f;
        }
    }
    long long total;
    const long long excl = kt::block_excl_scan<long long>(tpack(f, c0, c1), 0LL, Compose(),
                                                          total);
    if (t < 32) {
        if (t == 0) kt::publish(a.status, tile, total, 0);
        __syncwarp();
        const long long pre = kt::resolve<true>(a.status, tile, total, Compose(), 0LL, 0LL);
        if (t == 0) s_pre = pre;
    }
    __syncthreads();
    const long long pre = s_pre;
    const long long off = a.st_in[0];
    const int hin = (int)a.st_in[1];
    const long long incl = Compose()(pre, total);
    const long long P0 = off + tc(pre, hin), P1 = off + tc(incl, hin);
    if (tile == a.ntiles - 1 && t == 0) {
        a.st_out[0] = P1;
        a.st_out[1] = tapply(incl, hin);
    }

    // this thread's codes, ORed into at most two staged words of each grid
    const long long mine = Compose()(pre, excl);
    int h = tapply(mine, hin);
    const long long A = P0 & ~31LL;
    const long long r0 = off + tc(mine, hin) - A;
    long long r = r0;
    uint32_t w0 = 0u, w1 = 0u, m0 = 0u, m1 = 0u;
    for (int i = 0; i < nv; ++i) {
        const unsigned b = P1_BYTE(i);
        bool emit = true;
        int code = base_code(b);
        if (a.fasta) {
            const bool nl = b == '\n', gt = b == '>';
            emit = h ? nl : !(nl || gt);
            if (h) code = 4;
            h = gt ? 1 : nl ? 0 : h;
        }
        if (emit) {
            if (code < 4) {
                const uint32_t x = (uint32_t)code << (2 * (r & 15));
                if ((r >> 4) != (r0 >> 4)) w1 |= x; else w0 |= x;
            } else {
                const uint32_t y = 1u << (r & 31);
                if ((r >> 5) != (r0 >> 5)) m1 |= y; else m0 |= y;
            }
            ++r;
        }
    }
#undef P1_BYTE
    if (r > r0) {
        const int j = (int)(r0 >> 4), jm = (int)(r0 >> 5);
        if (w0) atomicOr(&s_w[j], w0);
        if (w1) atomicOr(&s_w[j + 1], w1);
        if (m0) atomicOr(&s_m[jm], m0);
        if (m1) atomicOr(&s_m[jm + 1], m1);
    }
    __syncthreads();
    if (P1 > P0) {
        const long long g0 = A >> 4, g1 = (P1 - 1) >> 4;
        for (long long g = g0 + t; g <= g1; g += THREADS)
            put(a, false, g, s_w[g - g0], g * 16 >= P0 && g * 16 + 16 <= P1);
        const long long q0 = A >> 5, q1 = (P1 - 1) >> 5;
        for (long long g = q0 + t; g <= q1; g += THREADS)
            put(a, true, g, s_m[g - q0], g * 32 >= P0 && g * 32 + 32 <= P1);
    }
}

inline long long tiles(long long nb) { return (nb + TILE - 1) / TILE; }

}  // namespace p1

// Bytes of P1's scratch for a block of nb bytes: one status word a tile and
// the tile ticket.
extern "C" long long kt_parse_pack_scratch(long long nb) {
    return (p1::tiles(nb) + 1) * 8;
}

// P1.  raw: nb bytes (nb < 2^30); fasta: 1 for FASTA, 0 for plain text;
// st_in / st_out: 2 int64 each ([code offset, header state]); err: an int64
// set to 1 should a code's superstep lie outside the table; scratch:
// kt_parse_pack_scratch(nb) bytes (zeroed here); tab: 2 nt device pointers,
// (2-bit words, bitmap) of supersteps base .. base + nt - 1, each a zeroed
// (so far) chunk of span codes; sb a multiple of 32, span >= sb.  Returns a
// cudaError_t.
extern "C" int kt_parse_pack(const void* raw, long long nb, int fasta, const void* st_in,
                             void* st_out, void* err, void* scratch, const void* tab,
                             long long base, int nt, long long sb, long long span,
                             void* stream) {
    if (nb < 0 || nb >= (1LL << 30) || sb <= 0 || sb % 32 || span < sb || nt <= 0 || base < 0)
        return (int)cudaErrorInvalidValue;
    if (nb == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    p1::Args a;
    a.raw = static_cast<const uint8_t*>(raw);
    a.nb = nb;
    a.ntiles = p1::tiles(nb);
    a.fasta = fasta;
    a.st_in = static_cast<const long long*>(st_in);
    a.st_out = static_cast<long long*>(st_out);
    a.err = static_cast<long long*>(err);
    a.status = static_cast<unsigned long long*>(scratch);
    a.ticket = reinterpret_cast<int*>(a.status + a.ntiles);
    a.tab = static_cast<const unsigned long long*>(tab);
    a.base = base;
    a.nt = nt;
    a.sb = sb;
    a.span = span;
    cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)kt_parse_pack_scratch(nb), s);
    if (e != cudaSuccess) return (int)e;
    p1::parse_pack_kernel<<<(unsigned)a.ntiles, p1::THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}
