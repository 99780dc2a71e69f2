// Super-k-mer run segmentation from the transfer chunk, in one pass: the
// front half that K1 (skm_dense.cu) and K5 (skm_slotted.cu) share.
//
// Replaces the front half that the TPU kernels share,
// kaarme_tpu/ops/pallas_skm.py::_seg_rows_block (in
// run_rows_dense_pallas and run_rows_slotted_pallas), together with the
// unpack in front of them (ops/sortcount.py::codes_from_chunk).  Input:
// the chunk the host ships, 2-bit bases (base i at bits 2*(i%16) of word
// i/16) and the invalid positions as a bitmap (bit i%32 of word i/32).
// For every window of the n-window stream: the 16-base big-endian m-words,
// validity (no invalid base in [x, x+k)), the minimizer (min of the k-15
// m-words), and the run starts (a minimizer or validity change, an LMAX
// = 16 cap anchored at the last TRUE start, and every window at or past
// n).  Positions at or past L = n + k - 1 are invalid whatever the chunk
// holds.  A base at an invalid position never reaches a row (a live
// run's span and minimizer windows hold valid positions only), so the
// bases are read as the chunk holds them.
//
// What bounds it on the H100: bytes.  It reads n/4 bytes of packed bases
// plus n/8 bytes of bitmap (~25 MB at n = 2^26); the rows the kernels write
// after it are their own.  The work per window is a few dozen integer
// operations.  The design keeps every step O(1) per window, whatever k
// (any k >= 16 whose tile fits in 227 KB of shared memory: k <= 16,721):
// - m-word at position i: one funnel shift of the packed pair
//   (i/16, i/16 + 1) and a 2-bit-field reversal (__brev + a bit swap);
// - validity: prefix popcounts of the tile's bitmap words, so a window's
//   invalid count is a difference of two ranks;
// - minimizer: the van Herk / Gil-Werman sliding minimum, prefix and
//   suffix minima in blocks of w = k - 15 (one thread per block and
//   direction), then min(S[v], P[v + w - 1]) per window;
// - run length: the distance to the next start in a bitmap of starts
//   (ell_at below).
// The TPU grid carried the last TRUE start from block to block in SMEM;
// here it is a chained max-scan across tiles by decoupled look-back
// (scan.cuh): a tile publishes its local last TRUE start at once and
// looks back for the one before it.  Each tile also flags the LMAX
// windows past its end (warp 0), so a run's length never waits for the
// next tile.  Tile: 2048 windows, 256 threads of 8 windows, 8 blocks per
// SM: the kernels that include it run at 32 registers per thread
// (__launch_bounds__(THREADS, MIN_BLOCKS); ptxas -v for sm_90a: K1 with a
// 24-byte stack frame of spills, K5 with none).
//
// Every function here is inline or static, so that each kernel source
// may include the header without a duplicate symbol at link time.
#pragma once

#include "scan.cuh"

namespace kseg {

using namespace kt;

constexpr int M = 16;
constexpr int LMAX = 16;
constexpr int EBITS = 26;
// Tile shape and occupancy: 2048-window tiles of 256 threads, 8 blocks
// per SM (32 registers), the fastest of the shapes timed for K1 on the
// card (PERF.md, section 6).
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int MIN_BLOCKS = 8;
constexpr int TILE = THREADS * ITEMS;     // windows per tile
constexpr int NV = TILE + 1 + LMAX;       // windows T0-1 .. T0+TILE+LMAX-1

enum : uint8_t { F_VALID = 1, F_TRUE = 2, F_START = 4 };

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
    // the kernels' row list (at most TILE < NRS entries) in P once the
    // minimizers are read
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
static __device__ void block_prefix_suffix_min(const uint32_t* __restrict__ x,
                                               uint32_t* __restrict__ P,
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

// The run length at start v: the distance to the next start, at most
// LMAX (reads the start bitmap; after the barrier that follows
// segment_chunk_tile).
__device__ __forceinline__ int ell_at(const Smem& s, int v) {
    const int q = v + 1;
    const uint32_t next = __funnelshift_r(s.sb[q >> 5], s.sb[(q >> 5) + 1], q & 31);
    return next ? min(__ffs(next), LMAX) : LMAX;
}

// Row word c (c < Wc: span-masked content; c == Wc: the meta word) of
// the live start v with run length ell.
__device__ __forceinline__ uint32_t row_word(const Geo& g, const Smem& s, int c, int v, int ell) {
    if (c < g.Wc) {
        // keep the top 2*nb bits, nb = bases of the span in word c
        // (a 64-bit shift: nb == 0 shifts by 32)
        const int nb = min(max(ell + g.k - 1 - 16 * c, 0), 16);
        return s.raw[v + 16 * c] & (uint32_t)(0xffffffffull << (32 - 2 * nb));
    }
    return ((uint32_t)(ell - 1) << EBITS) | 1u;
}

// Segment tile ``tile`` (windows T0 = tile * TILE ..): stage the chunk,
// build m-words, validity and minimizers, find the TRUE starts, chain
// the last TRUE start across tiles through st_lts, and mark every run
// start in s.flags (F_START) and the start bitmap s.sb, for the tile's
// windows (index v = window - (T0 - 1), v = 1 .. TILE) and the LMAX
// windows past it.  Returns through ``live`` this thread's count of live
// starts (valid, below n) among its ITEMS windows v0 = 1 + tid * ITEMS
// .., and through ``starts`` its count of every start below n.  The
// flags of other threads are read only after the caller's next barrier.
__device__ __forceinline__ void segment_chunk_tile(const uint32_t* __restrict__ packed,
                                                   long long npk,
                                                   const uint32_t* __restrict__ bitmap,
                                                   long long nbm, const Geo& g, const Smem& s,
                                                   long long tile, unsigned long long* st_lts,
                                                   long long& live, long long& starts) {
    __shared__ long long s_lts_in;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
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
    live = 0;
    starts = 0;
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
            if (x < g.n) {
                ++starts;
                if (f & F_VALID) ++live;
            }
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
}

// Host side, both kernels: let ``kern`` take the tile's shared memory.
// Returns a cudaError_t.
__host__ inline int set_smem(const void* kern, const Geo& g) {
    const size_t sm = smem_bytes(g);
    if (sm > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (sm > 48 * 1024)
        return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sm);
    return 0;
}

}  // namespace kseg
