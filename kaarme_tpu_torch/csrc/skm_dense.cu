// K1: dense super-k-mer run segmentation from the transfer chunk (CUDA
// C++, sm_90a), in one pass over the stream.
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas (kernel
// body _skm_dense_kernel, front half _seg_rows_block), together with the
// unpack in front of it (ops/sortcount.py::codes_from_chunk).  Input: the
// chunk the host ships, 2-bit bases (base i at bits 2*(i%16) of word
// i/16) and the invalid positions as a bitmap (bit i%32 of word i/32; a
// separator list is scattered into one first, sep_bitmap below).  For
// every window of the n-window stream: the 16-base big-endian m-words,
// validity (no invalid base in [x, x+k)), the minimizer (min of the k-15
// m-words), the run starts (a minimizer or validity change, an LMAX = 16
// cap anchored at the last TRUE start, and every window at or past n)
// and, at each live (valid) start, the row of Wc span-masked content
// words plus the meta word (ell-1) << 26 | 1, front-packed in stream
// order.  Positions at or past L = n + k - 1 are invalid whatever the
// chunk holds.  A base at an invalid position never reaches a row (a
// live run's span and minimizer windows hold valid positions only), so
// the bases are read as the chunk holds them.
//
// What bounds it on the H100: bytes.  It reads n/4 bytes of packed bases
// plus the separators (~19 MB at n = 2^26) and writes every row of the
// Wc+1 columns (201 MB at cap = 2^23), so the card could do it in ~0.07
// ms; the work per window is a few dozen integer operations.  The design
// keeps every step O(1) per window, whatever k (any k >= 16 whose tile
// fits in 227 KB of shared memory: k <= 16,721):
// - m-word at position i: one funnel shift of the packed pair
//   (i/16, i/16 + 1) and a 2-bit-field reversal (__brev + a bit swap);
// - validity: prefix popcounts of the tile's bitmap words, so a window's
//   invalid count is a difference of two ranks;
// - minimizer: the van Herk / Gil-Werman sliding minimum, prefix and
//   suffix minima in blocks of w = k - 15 (one thread per block and
//   direction), then min(S[v], P[v + w - 1]) per window;
// - run length: the distance to the next start in a bitmap of starts.
// The TPU grid carried the last TRUE start and the row cursor from block
// to block in SMEM.  Here both are chained scans across tiles with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back"): a tile takes its index from an atomic
// ticket (so every tile it waits on is already running), publishes its
// local last TRUE start at once, looks back for the one before it, marks
// its starts, publishes its live-row count, lists its live rows, and only
// then looks back for its row offset.  Each status word holds a flag (2
// bits) and the value, written by one 64-bit store.  The live rows are
// listed in shared memory in rank order and written column by column,
// each column one contiguous run.  Nothing is written at or past
// ``cap``; rows_used > cap tells the caller to replay with a larger
// capacity.  The sentinel fill past rows_used is a grid-stride kernel
// after it.
#include "scan.cuh"

namespace k1 {

using namespace kt;

constexpr int M = 16;
constexpr int LMAX = 16;
constexpr int EBITS = 26;
// Tile shape and occupancy: 2048-window tiles of 256 threads, 8 blocks
// per SM (32 registers), the fastest of the shapes timed on the card
// (PERF.md, section 6).
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int MIN_BLOCKS = 8;
constexpr int TILE = THREADS * ITEMS;     // windows per tile
constexpr int NV = TILE + 1 + LMAX;       // windows T0-1 .. T0+TILE+LMAX-1

enum : uint8_t { F_VALID = 1, F_TRUE = 2, F_START = 4 };

// status word: flag in bits 62-63, value in bits 0-61
constexpr unsigned long long ST_AGG = 1ull << 62;     // the tile's own value
constexpr unsigned long long ST_INC = 2ull << 62;     // inclusive of every tile before
constexpr unsigned long long ST_VAL = (1ull << 62) - 1;

struct Geo {
    int k, Wc, w;
    int NR;     // m-words staged (window index v reads raw[v + 16 c] and raw[v .. v+w-1])
    int NRS;    // m-words the sliding minimum scans: NV + w - 1
    int NPW;    // packed words staged
    int NBW;    // bitmap words staged
    long long L, n;
};

__host__ inline Geo make_geo(int k, long long L, long long n) {
    Geo g;
    g.k = k;
    g.Wc = (LMAX + k - 1 + 15) / 16;
    g.w = k - M + 1;
    g.NR = NV + (g.w > 16 * g.Wc ? g.w : 16 * g.Wc);
    g.NRS = NV + g.w - 1;
    g.NPW = g.NR / 16 + 3;
    g.NBW = (NV + k + 62) / 32;
    g.L = L;
    g.n = n;
    return g;
}

constexpr int NSB = NV / 32 + 2;          // start-bitmap words

__host__ inline size_t smem_bytes(const Geo& g) {
    // raw[NR] | P[NRS] | S[NRS] | bm[NBW] | pre[NBW] | sb[NSB] (u32) | flags[NV] (u8);
    // the packed words (NPW < NRS) live in S until the m-words are built,
    // the live-start list (TILE < NRS) in P once the minimizers are read
    return 4 * ((size_t)g.NR + 2 * (size_t)g.NRS + 2 * (size_t)g.NBW + NSB) + NV;
}

// Reverse the sixteen 2-bit fields: little-endian transfer packing ->
// big-endian m-word (sortcount._pairrev32).
__device__ __forceinline__ uint32_t pairrev(uint32_t x) {
    x = __brev(x);
    return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}

// van Herk / Gil-Werman: P[i] = min(x[b0 .. i]) and S[i] = min(x[i .. b1])
// within the block [b0, b1] of w elements that holds i (the last block
// ends at N-1), so that min(x[v .. v+w-1]) = min(S[v], P[v+w-1]).  One
// thread runs each block's prefix and another its suffix, about w steps
// each: ~2 operations per element whatever w is.  All threads must call
// it; the caller synchronises before reading P and S.
__device__ void block_prefix_suffix_min(const uint32_t* __restrict__ x, uint32_t* __restrict__ P,
                                        uint32_t* __restrict__ S, int N, int w) {
    const int nb = (N + w - 1) / w;
    for (int t = threadIdx.x; t < 2 * nb; t += THREADS) {
        const int b0 = (t < nb ? t : t - nb) * w, b1 = min(b0 + w, N) - 1;
        uint32_t m = 0xffffffffu;
        if (t < nb) {
#pragma unroll 4
            for (int i = b0; i <= b1; ++i) {
                m = min(m, x[i]);
                P[i] = m;
            }
        } else {
#pragma unroll 4
            for (int i = b1; i >= b0; --i) {
                m = min(m, x[i]);
                S[i] = m;
            }
        }
    }
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Decoupled look-back by one warp: op over the values of tiles 0 ..
// tile-1, read from their status words (value + bias encoded).  Lane j
// reads tile (tile - 1 - j) of each round of 32, waits until it is
// published, and the round ends at the nearest inclusive one.  Every
// lane returns the result.
template <typename Op>
__device__ long long warp_lookback(const unsigned long long* st, long long tile, Op op,
                                   long long id, long long bias) {
    const int lane = threadIdx.x & 31;
    long long acc = id;
    for (long long j = tile - 1 - lane;; j -= 32) {
        unsigned long long s = ST_INC | (unsigned long long)(id + bias);
        if (j >= 0) {
            do s = ld_status(st + j);
            while ((s >> 62) == 0);
        }
        const unsigned inc = __ballot_sync(FULL_MASK, (s >> 62) == 2);
        long long v = (long long)(s & ST_VAL) - bias;
        if (inc && lane > __ffs(inc) - 1) v = id;
        for (int d = 16; d; d >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, d));
        acc = op(acc, v);
        if (inc) return acc;
    }
}

// A tile's part of a chained scan: publish its own value at once (tile 0:
// its inclusive value), ...
__device__ __forceinline__ void publish(unsigned long long* st, long long tile, long long agg,
                                        long long bias) {
    st_status(st + tile, (tile == 0 ? ST_INC : ST_AGG) | (unsigned long long)(agg + bias));
}

// ... then (warp 0, after publish) look back for the exclusive prefix and
// publish the inclusive value.  Every lane returns the exclusive prefix.
template <typename Op>
__device__ long long resolve(unsigned long long* st, long long tile, long long agg, Op op,
                             long long id, long long bias) {
    if (tile == 0) return id;
    const long long pre = warp_lookback(st, tile, op, id, bias);
    if ((threadIdx.x & 31) == 0)
        st_status(st + tile, ST_INC | (unsigned long long)(op(pre, agg) + bias));
    return pre;
}

struct Smem {
    uint32_t *raw, *P, *S, *pw, *bm, *pre, *sb, *lst;
    uint8_t* flags;
};

__device__ inline Smem carve(const Geo& g) {
    extern __shared__ __align__(16) unsigned char smem[];
    Smem s;
    s.raw = reinterpret_cast<uint32_t*>(smem);
    s.P = s.raw + g.NR;
    s.S = s.P + g.NRS;
    s.pw = s.S;
    s.lst = s.P;
    s.bm = s.S + g.NRS;
    s.pre = s.bm + g.NBW;
    s.sb = s.pre + g.NBW;
    s.flags = reinterpret_cast<uint8_t*>(s.sb + NSB);
    return s;
}

// Validity and minimizer of window v (tile-local): q0 is the bit offset of
// window 0's first position in the staged bitmap.
__device__ __forceinline__ uint32_t window_minv(const Geo& g, const Smem& s, int v, int q0,
                                                bool& valid) {
    auto rank = [&](int q) {
        return s.pre[q >> 5] + __popc(s.bm[q >> 5] & ((1u << (q & 31)) - 1u));
    };
    valid = rank(q0 + v + g.k) == rank(q0 + v);
    if (!valid) return 0xffffffffu;
    return min(s.S[v], s.P[v + g.w - 1]);
}

__device__ __forceinline__ void mark_start(const Smem& s, int v, uint8_t f) {
    s.flags[v] = f | F_START;
    atomicOr(s.sb + (v >> 5), 1u << (v & 31));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
skm_rows_kernel(const uint32_t* __restrict__ packed, long long npk,
                const uint32_t* __restrict__ bitmap, long long nbm, Geo g,
                unsigned long long* st_lts, unsigned long long* st_cnt,
                unsigned int* ticket, long long* total, long long nt,
                uint32_t* __restrict__ out, long long cap, long long ld) {
    __shared__ long long s_tile, s_lts_in, s_off;
    const Smem s = carve(g);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = s_tile;
    const long long T0 = tile * TILE;
    const long long base = T0 - 1;              // position (and window) of index 0
    const long long wa = base >> 4, ba = base >> 5;

    // 1. stage the packed words and the bitmap words, positions outside
    //    [0, L) marked invalid
    for (int j = tid; j < g.NPW; j += THREADS) {
        const long long gw = wa + j;
        s.pw[j] = (gw >= 0 && gw < npk) ? packed[gw] : 0u;
    }
    for (int j = tid; j < g.NBW; j += THREADS) {
        const long long gw = ba + j, lo = 32 * gw;
        uint32_t m = (gw >= 0 && gw < nbm) ? bitmap[gw] : 0u;
        if (lo < 0 || lo >= g.L) m = 0xffffffffu;
        else if (lo + 32 > g.L) m |= 0xffffffffu << (int)(g.L - lo);
        s.bm[j] = m;
    }
    for (int j = tid; j < NSB; j += THREADS) s.sb[j] = 0u;
    __syncthreads();

    // 2. m-words; bitmap prefix popcounts (warp 0)
    const int sh0 = (int)(base & 15);
    for (int i = tid; i < g.NR; i += THREADS) {
        const int p = sh0 + i;                  // position - 16 * wa
        const unsigned long long pair =
            s.pw[p >> 4] | ((unsigned long long)s.pw[(p >> 4) + 1] << 32);
        s.raw[i] = pairrev((uint32_t)(pair >> (2 * (p & 15))));
    }
    if (tid < 32) {
        uint32_t carry = 0;
        for (int j0 = 0; j0 < g.NBW; j0 += 32) {
            const int j = j0 + lane;
            const uint32_t c = j < g.NBW ? (uint32_t)__popc(s.bm[j]) : 0u;
            uint32_t inc = c;
            for (int d = 1; d < 32; d <<= 1) {
                const uint32_t y = __shfl_up_sync(FULL_MASK, inc, d);
                if (lane >= d) inc += y;
            }
            if (j < g.NBW) s.pre[j] = carry + inc - c;
            carry += __shfl_sync(FULL_MASK, inc, 31);
        }
    }
    __syncthreads();

    // 3. van Herk / Gil-Werman: prefix and suffix minima in blocks of w
    block_prefix_suffix_min(s.raw, s.P, s.S, g.NRS, g.w);
    __syncthreads();

    // 4. validity and TRUE starts: this thread's ITEMS windows, and (warp
    //    0) the LMAX windows past the tile; the last TRUE start below n
    const int q0 = (int)(base - 32 * ba);
    const int v0 = 1 + tid * ITEMS;
    bool pv;
    uint32_t pm = window_minv(g, s, v0 - 1, q0, pv);
    long long loc = -1;
    for (int j = 0; j < ITEMS; ++j) {
        const int v = v0 + j;
        const long long x = base + v;
        bool val;
        const uint32_t mv = window_minv(g, s, v, q0, val);
        const bool tb = x == 0 || mv != pm || val != pv;
        s.flags[v] = (val ? F_VALID : 0) | (tb ? F_TRUE : 0);
        if (tb && x < g.n) loc = x;
        pm = mv;
        pv = val;
    }
    if (tid < LMAX) {
        const int v = TILE + 1 + tid;
        bool val, val0;
        const uint32_t mv = window_minv(g, s, v, q0, val);
        const uint32_t m0 = window_minv(g, s, v - 1, q0, val0);
        s.flags[v] = (val ? F_VALID : 0) | ((mv != m0 || val != val0) ? F_TRUE : 0);
    }
    long long lts_tot;
    const long long lts_pre = block_excl_scan(loc, -1LL, MaxOp(), lts_tot);

    // 5. the last TRUE start before the tile (chained max-scan)
    if (tid < 32) {
        if (tid == 0) publish(st_lts, tile, lts_tot, 1LL);
        const long long in = resolve(st_lts, tile, lts_tot, MaxOp(), -1LL, 1LL);
        if (tid == 0) s_lts_in = in;
    }
    __syncthreads();
    const long long lts_in = s_lts_in;

    // 6. run starts (the LMAX cap anchored at the last TRUE start); live
    //    starts are valid and below n
    long long cur = lts_pre > lts_in ? lts_pre : lts_in;
    long long live = 0;
    for (int j = 0; j < ITEMS; ++j) {
        const int v = v0 + j;
        const long long x = base + v;
        const uint8_t f = s.flags[v];
        if (f & F_TRUE) cur = x;
        const long long p1 = x - cur;
        const bool b = (f & F_TRUE) || ((f & F_VALID) && p1 > 0 && (p1 & (LMAX - 1)) == 0) ||
                       x >= g.n;
        if (b) {
            mark_start(s, v, f);
            if ((f & F_VALID) && x < g.n) ++live;
        }
    }
    if (tid < 32) {
        const int v = TILE + 1 + lane;
        const long long x = base + v;
        const uint8_t f = lane < LMAX ? s.flags[v] : 0;
        long long t = (f & F_TRUE) ? x : -1;
        for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(FULL_MASK, t, d);
            if (lane >= d) t = y > t ? y : t;
        }
        long long c = lts_tot > lts_in ? lts_tot : lts_in;
        c = t > c ? t : c;
        const long long p1 = x - c;
        const bool b = (f & F_TRUE) || ((f & F_VALID) && p1 > 0 && (p1 & (LMAX - 1)) == 0) ||
                       x >= g.n;
        if (lane < LMAX && b) mark_start(s, v, f);
    }
    long long n_live;
    long long rank = block_excl_scan(live, 0LL, SumOp(), n_live);
    if (tid == 0) publish(st_cnt, tile, n_live, 0LL);

    // 7. list the live starts in rank order (tile-local window | ell << 16);
    //    ell is the distance to the next start, from the start bitmap
    for (int j = 0; j < ITEMS; ++j) {
        const int v = v0 + j;
        const long long x = base + v;
        const uint8_t f = s.flags[v];
        if (!((f & F_START) && (f & F_VALID) && x < g.n)) continue;
        const int q = v + 1;
        const uint32_t next = __funnelshift_r(s.sb[q >> 5], s.sb[(q >> 5) + 1], q & 31);
        const int ell = next ? min(__ffs(next), LMAX) : LMAX;
        s.lst[rank++] = (uint32_t)v | ((uint32_t)ell << 16);
    }

    // 8. the tile's first row (chained sum-scan); the last tile has the total
    if (tid < 32) {
        const long long off = resolve(st_cnt, tile, n_live, SumOp(), 0LL, 0LL);
        if (tid == 0) {
            s_off = off;
            if (tile == nt - 1) *total = off + n_live;
        }
    }
    __syncthreads();

    // 9. write the rows column by column, each column one contiguous run
    const long long off = s_off;
    const long long nw = n_live < cap - off ? n_live : (cap > off ? cap - off : 0);
    for (int c = 0; c <= g.Wc; ++c) {
        uint32_t* col = out + (long long)c * ld + off;
        for (int r = tid; r < nw; r += THREADS) {
            const uint32_t e = s.lst[r];
            const int v = (int)(e & 0xffffu), ell = (int)(e >> 16);
            uint32_t val;
            if (c < g.Wc) {
                // keep the top 2*nb bits, nb = bases of the span in word c
                // (a 64-bit shift: nb == 0 shifts by 32)
                const int nb = min(max(ell + g.k - 1 - 16 * c, 0), 16);
                val = s.raw[v + 16 * c] & (uint32_t)(0xffffffffull << (32 - 2 * nb));
            } else {
                val = ((uint32_t)(ell - 1) << EBITS) | 1u;
            }
            col[r] = val;
        }
    }
}

// Separator list -> invalid bitmap (the bitmap is zeroed before); indices
// at or past L are dropped.
__global__ void sep_bitmap(const uint32_t* __restrict__ sep, long long nsep, long long L,
                           uint32_t* bm) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nsep;
         i += (long long)gridDim.x * blockDim.x) {
        const uint32_t p = sep[i];
        if (p < L) atomicOr(bm + (p >> 5), 1u << (p & 31));
    }
}

}  // namespace k1

using namespace k1;

// Scratch (int64 words) the wrapper allocates: ticket, total, two status
// words per tile, then, for a separator list, the bitmap it scatters into.
extern "C" long long kt_skm_dense_scratch(long long n, long long L, int dense) {
    const long long nt = (n + TILE - 1) / TILE;
    return 2 + 2 * nt + (dense ? 0 : ((L + 31) / 32 + 1) / 2);
}

// packed: u32 [npk] 2-bit bases, npk >= ceil(L / 16) with L = n + k - 1.
// sep: the invalid positions, a u32 bitmap of nsep >= ceil(L / 32) words
// (dense) or a u32 index list of nsep entries (indices >= L dropped).
// out: Wc+1 u32 columns of stride ld >= cap; rows [0, cap) are written,
// sentinels from rows_used on.  scratch: kt_skm_dense_scratch int64s.
// rows: int32 [2] = [rows_exact, rows_used].  Returns a cudaError_t.
extern "C" int kt_skm_dense(const void* packed, long long npk, const void* sep, long long nsep,
                            int dense, long long n, int k, void* out, long long cap,
                            long long ld, void* scratch, void* rows, void* stream) {
    const long long L = n + k - 1;
    if (k < M || n < 1 || npk * 16 < L || (dense && nsep * 32 < L) || nsep < 0 || cap < 0 ||
        ld < cap)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Geo g = make_geo(k, L, n);
    const size_t sm = smem_bytes(g);
    if (sm > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (sm > 48 * 1024 &&
        (e = cudaFuncSetAttribute((const void*)skm_rows_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm)) != cudaSuccess)
        return (int)e;
    const long long nt = (n + TILE - 1) / TILE;
    long long* sc = static_cast<long long*>(scratch);
    unsigned int* ticket = reinterpret_cast<unsigned int*>(sc);
    long long* total = sc + 1;
    unsigned long long* st_lts = reinterpret_cast<unsigned long long*>(sc + 2);
    unsigned long long* st_cnt = st_lts + nt;
    const size_t zero = 8 * (size_t)kt_skm_dense_scratch(n, L, dense);
    if ((e = cudaMemsetAsync(scratch, 0, zero, s)) != cudaSuccess) return (int)e;
    const uint32_t* bm = static_cast<const uint32_t*>(sep);
    long long nbm = nsep;
    if (!dense) {
        uint32_t* built = reinterpret_cast<uint32_t*>(st_cnt + nt);
        if (nsep > 0) {
            sep_bitmap<<<fill_blocks(nsep, 256), 256, 0, s>>>(static_cast<const uint32_t*>(sep),
                                                              nsep, L, built);
            if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        }
        bm = built;
        nbm = (L + 31) / 32;
    }
    uint32_t* o = static_cast<uint32_t*>(out);
    skm_rows_kernel<<<(unsigned)nt, THREADS, sm, s>>>(static_cast<const uint32_t*>(packed), npk,
                                                     bm, nbm, g, st_lts, st_cnt, ticket, total,
                                                     nt, o, cap, ld);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fill_tail_kernel<<<fill_blocks(cap, 256), 256, 0, s>>>(o, g.Wc + 1, ld, cap, total, -1,
                                                          static_cast<int*>(rows));
    return (int)cudaGetLastError();
}
