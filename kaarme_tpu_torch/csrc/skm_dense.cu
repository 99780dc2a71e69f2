// K1: dense super-k-mer run segmentation (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas (kernel
// body _skm_dense_kernel, front half _seg_rows_block).  Per window
// position i of an n-window stream it computes the 16-base big-endian
// m-word, the window's validity (no invalid base in [i, i+k)), its
// minimizer (min of the k-15 m-words), the run starts (minimizer or
// validity change, or an LMAX = 16 cap anchored at the last TRUE start),
// the run length ell <= 16, and for every live (valid) start the Wc
// span-masked content words plus the meta word (ell-1) << 26 | 1.  Live
// start rows are written densely, in stream order, to Wc+1 u32 columns.
//
// What bounds it on the H100: the input is one u32 code per position
// (256 MB at n = 2^26) and the output ~n/12 rows of Wc+1 words, so the
// kernel moves little memory; the work is the per-window minimizer and
// validity windows (~k-15 and k reads each), done from shared memory.
// Design: each block owns a tile of TILE windows, stages the codes of
// the tile plus its halo (k + 16*Wc + 18 positions) in shared memory as
// bytes, builds the m-words once per position there, and reads the
// sliding windows from them.  The TPU grid carried [prev_minv,
// prev_valid, last_true_start, row_cursor] in SMEM from block to block;
// here the previous window is recomputed from the halo, last_true_start
// becomes an exclusive max-scan over tiles and the row cursor an
// exclusive sum-scan over tiles (passes 1-4 below, then the emit pass).
// The TPU's 128-lane residual staging is not carried over; rows_used ==
// rows_exact.  Nothing is written at or past ``cap``; rows_used > cap
// tells the caller to replay with a larger capacity.
#include "scan.cuh"

namespace k1 {

using namespace kt;

constexpr int M = 16;
constexpr int LMAX = 16;
constexpr int EBITS = 26;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;      // windows per block
constexpr int NV = TILE + LMAX + 2;        // windows T0-1 .. T0+TILE+LMAX

enum : uint8_t { F_VALID = 1, F_TRUE = 2, F_START = 4 };

struct Geo {
    int k, Wc, w;       // k, content words, minimizer window (k - 15)
    int NR, NC;         // staged m-words and codes per block
    long long L, n;
};

__host__ __device__ inline Geo make_geo(int k, long long L, long long n) {
    Geo g;
    g.k = k;
    g.Wc = (LMAX + k - 1 + 15) / 16;
    g.w = k - M + 1;
    int reach = g.w > 16 * g.Wc ? g.w : 16 * g.Wc;
    g.NR = NV + reach;
    g.NC = (g.NR + 15 > NV + k) ? g.NR + 15 : NV + k;
    g.L = L;
    g.n = n;
    return g;
}

__host__ inline size_t smem_bytes(const Geo& g) {
    // raw[NR] u32 | minv[NV] u32 | codes8[NC] u8 | flags[NV] u8
    return (size_t)g.NR * 4 + (size_t)NV * 4 + (size_t)g.NC + (size_t)NV;
}

struct Tile {
    uint32_t* raw;
    uint32_t* minv;
    uint8_t* codes8;
    uint8_t* flags;
};

__device__ Tile carve(const Geo& g) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tile t;
    t.raw = reinterpret_cast<uint32_t*>(smem);
    t.minv = t.raw + g.NR;
    t.codes8 = reinterpret_cast<uint8_t*>(t.minv + NV);
    t.flags = t.codes8 + g.NC;
    return t;
}

// Stage the block's codes, m-words, minimizers, validity and TRUE starts
// for windows T0-1 .. T0+TILE+LMAX (index v = window - (T0 - 1)).
// Positions outside [0, L) read as code 4: invalid, base bits 0.
__device__ void segment_tile(const uint32_t* __restrict__ codes, const Geo& g,
                             long long T0, const Tile& t) {
    const long long base = T0 - 1;
    for (int i = threadIdx.x; i < g.NC; i += blockDim.x) {
        long long pos = base + i;
        t.codes8[i] = (pos >= 0 && pos < g.L) ? (uint8_t)(codes[pos] & 7u) : (uint8_t)4;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < g.NR; i += blockDim.x) {
        uint32_t r = 0;
        for (int j = 0; j < M; ++j) r = (r << 2) | (t.codes8[i + j] & 3u);
        t.raw[i] = r;
    }
    __syncthreads();
    for (int v = threadIdx.x; v < NV; v += blockDim.x) {
        bool valid = true;
        for (int j = 0; j < g.k; ++j) {
            if (t.codes8[v + j] & 4u) {
                valid = false;
                break;
            }
        }
        uint32_t mn = 0xffffffffu;
        if (valid) {
            for (int j = 0; j < g.w; ++j) {
                uint32_t r = t.raw[v + j];
                mn = r < mn ? r : mn;
            }
        }
        t.minv[v] = mn;
        t.flags[v] = valid ? F_VALID : 0;
    }
    __syncthreads();
    for (int v = 1 + threadIdx.x; v < NV; v += blockDim.x) {
        long long x = base + v;
        bool tb = (x == 0) || t.minv[v] != t.minv[v - 1] ||
                  ((t.flags[v] ^ t.flags[v - 1]) & F_VALID);
        if (tb) t.flags[v] |= F_TRUE;
    }
    __syncthreads();
}

// Mark run starts (F_START) for windows T0 .. T0+TILE+LMAX given the
// last TRUE start before the tile (lts_in, -1 if none).  Windows at or
// past n count as starts (the stream end closes every run).  Returns
// this thread's count of live starts among its ITEMS windows.
__device__ int mark_starts(const Geo& g, long long T0, long long lts_in,
                           const Tile& t) {
    const int t0 = threadIdx.x * ITEMS;
    long long loc = -1;
    for (int j = 0; j < ITEMS; ++j) {
        int v = t0 + j + 1;
        if (t.flags[v] & F_TRUE) loc = T0 + t0 + j;
    }
    long long tot;
    long long pre = block_excl_scan(loc, -1LL, MaxOp(), tot);
    long long cur = pre > lts_in ? pre : lts_in;
    int live = 0;
    for (int j = 0; j < ITEMS; ++j) {
        int v = t0 + j + 1;
        long long x = T0 + t0 + j;
        uint8_t f = t.flags[v];
        if (f & F_TRUE) cur = x;
        long long p1 = x - cur;
        bool b = (f & F_TRUE) || ((f & F_VALID) && p1 > 0 && (p1 & (LMAX - 1)) == 0);
        if (x >= g.n) b = true;
        if (b) {
            t.flags[v] = f | F_START;
            if ((f & F_VALID) && x < g.n) ++live;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long c = tot > lts_in ? tot : lts_in;
        for (int v = TILE + 1; v < NV; ++v) {
            long long x = T0 + v - 1;
            uint8_t f = t.flags[v];
            if (f & F_TRUE) c = x;
            long long p1 = x - c;
            bool b = (f & F_TRUE) || ((f & F_VALID) && p1 > 0 && (p1 & (LMAX - 1)) == 0);
            if (x >= g.n) b = true;
            if (b) t.flags[v] = f | F_START;
        }
    }
    __syncthreads();
    return live;
}

// Pass 1: the last TRUE start inside each tile (-1 if none).
__global__ void __launch_bounds__(THREADS)
tile_true_starts(const uint32_t* __restrict__ codes, Geo g, long long* tile_lts) {
    Tile t = carve(g);
    const long long T0 = (long long)blockIdx.x * TILE;
    segment_tile(codes, g, T0, t);
    long long loc = -1;
    for (int j = 0; j < ITEMS; ++j) {
        int v = threadIdx.x * ITEMS + j + 1;
        long long x = T0 + v - 1;
        if (x < g.n && (t.flags[v] & F_TRUE)) loc = x;
    }
    long long tot;
    block_excl_scan(loc, -1LL, MaxOp(), tot);
    if (threadIdx.x == 0) tile_lts[blockIdx.x] = tot;
}

// Pass 3: live starts per tile.
__global__ void __launch_bounds__(THREADS)
tile_live_counts(const uint32_t* __restrict__ codes, Geo g,
                 const long long* lts_in, long long* tile_cnt) {
    Tile t = carve(g);
    const long long T0 = (long long)blockIdx.x * TILE;
    segment_tile(codes, g, T0, t);
    long long live = mark_starts(g, T0, lts_in[blockIdx.x], t);
    long long tot;
    block_excl_scan(live, 0LL, SumOp(), tot);
    if (threadIdx.x == 0) tile_cnt[blockIdx.x] = tot;
}

// Pass 5: write the live start rows at the tile's cursor, in stream order.
__global__ void __launch_bounds__(THREADS)
emit_rows(const uint32_t* __restrict__ codes, Geo g, const long long* lts_in,
          const long long* tile_off, uint32_t* __restrict__ out, long long cap,
          long long ld) {
    Tile t = carve(g);
    const long long T0 = (long long)blockIdx.x * TILE;
    segment_tile(codes, g, T0, t);
    long long live = mark_starts(g, T0, lts_in[blockIdx.x], t);
    long long tot;
    long long rank = tile_off[blockIdx.x] + block_excl_scan(live, 0LL, SumOp(), tot);
    const int t0 = threadIdx.x * ITEMS;
    for (int j = 0; j < ITEMS; ++j) {
        const int v = t0 + j + 1;
        const long long x = T0 + t0 + j;
        const uint8_t f = t.flags[v];
        if (!((f & F_START) && (f & F_VALID) && x < g.n)) continue;
        const long long pos = rank++;
        if (pos >= cap) continue;
        int ell = LMAX;
        for (int d = 1; d <= LMAX; ++d) {
            if (x + d >= g.n || (t.flags[v + d] & F_START)) {
                ell = d;
                break;
            }
        }
        const int span = ell + g.k - 1;
        for (int c = 0; c < g.Wc; ++c) {
            // keep the top 2*nb bits, nb = bases of the span in word c;
            // the shift is done in 64 bits because nb == 0 shifts by 32,
            // which is undefined for a 32-bit operand
            const int nb = min(max(span - 16 * c, 0), 16);
            const uint32_t mask = (uint32_t)(0xffffffffull << (32 - 2 * nb));
            out[(long long)c * ld + pos] = t.raw[v + 16 * c] & mask;
        }
        out[(long long)g.Wc * ld + pos] = ((uint32_t)(ell - 1) << EBITS) | 1u;
    }
}

}  // namespace k1

using namespace k1;

// codes: u32 [L] (bits 0-1 base, bit 2 invalid), L >= n + k - 1.
// out: Wc+1 u32 columns of stride ld >= cap.  scratch: int64 [2 * nt]
// with nt = ceil(n / 1024), plus one int64 for the row total.
// rows: int32 [2] = [rows_exact, rows_used].  Returns a cudaError_t.
extern "C" int kt_skm_dense(const void* codes, long long L, long long n, int k,
                            void* out, long long cap, long long ld,
                            void* scratch, void* rows, void* stream) {
    if (k < M || n < 1 || L < n + k - 1 || ld < cap || cap < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    Geo g = make_geo(k, L, n);
    size_t sm = smem_bytes(g);
    if (sm > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (sm > 48 * 1024) {
        const void* ks[3] = {(const void*)tile_true_starts, (const void*)tile_live_counts,
                             (const void*)emit_rows};
        for (const void* kf : ks) {
            e = cudaFuncSetAttribute(kf, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
            if (e != cudaSuccess) return (int)e;
        }
    }
    const long long nt = (n + TILE - 1) / TILE;
    long long* lts = static_cast<long long*>(scratch);
    long long* cnt = lts + nt;
    long long* total = cnt + nt;
    const uint32_t* c = static_cast<const uint32_t*>(codes);
    uint32_t* o = static_cast<uint32_t*>(out);

    tile_true_starts<<<(unsigned)nt, THREADS, sm, s>>>(c, g, lts);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scan_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(lts, nt, -1LL, MaxOp(), (long long*)nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    tile_live_counts<<<(unsigned)nt, THREADS, sm, s>>>(c, g, lts, cnt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scan_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(cnt, nt, 0LL, SumOp(), total);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    emit_rows<<<(unsigned)nt, THREADS, sm, s>>>(c, g, lts, cnt, o, cap, ld);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fill_tail_kernel<<<fill_blocks(cap, 256), 256, 0, s>>>(o, g.Wc + 1, ld, cap, total, -1,
                                                          static_cast<int*>(rows));
    return (int)cudaGetLastError();
}
