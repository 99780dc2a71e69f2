// W1: the count file's `KMER COUNT` lines, assembled on the card (CUDA
// C++, sm_90a).
//
// Replaces the host writers, which are numpy and not Pallas kernels:
// kaarme_tpu/models/sort_counter.py::SortKmerCounter.write_output (:495)
// and its copies in kaarme_tpu/models/counter.py (:181) and
// kaarme_tpu/parallel/sharded_sort.py (:409).  Input is one part of a
// dump exactly as it lies on the device: N rows of W = ceil(k/16) u32 key
// words (word w of row i at keys[w * lw + i * li], so a store's column
// views and a table's (C, W) slot rows are read in place) and a count
// column, int32 or int64.  Per row, in row order:
// - live when its raw count c > 0 (a dead row writes nothing);
// - its count clipped: c & 0xFFFF (mode 0, the uint16 wrap), else
//   min(c, 16383) (the 14-bit saturation);
// - kept when the clipped count >= min_abundance (so with -m 0 -a 0 a
//   count of 65,536 writes "... 0");
// - a kept row writes its k bases (base i = (word[i / 16] >> (30 - 2 *
//   (i % 16))) & 3 through "ACGT"; the trailing word is left-aligned),
//   one space, the clipped count in decimal without padding (1-5 digits),
//   and '\n'.
// Outputs: the text, densely from byte 0, and res = int64 [bytes, lines].
// The caller sizes the text buffer at N * (k + 7) bytes.
//
// What bounds it on the H100: bytes.  It reads 4W + 4 (or 8) bytes a row
// and writes about k + 4 (k + 2 + the digits); a few integer operations
// per byte.  Design: one kernel over tiles of 1024 rows, whose index
// comes from an atomic ticket.  Each thread takes 4 consecutive rows:
// their line lengths (0 for a row that writes nothing), a block scan of
// the thread sums, and the tile's byte offset by the decoupled look-back
// of scan.cuh (offsets are 64-bit; the caller also bounds each call's
// text by its chunk budget).  The tile's text is one contiguous run of
// the output.  It is built in shared memory, one 16 KB window at a time
// (windows aligned to 16 bytes of the output): each thread writes the
// bytes of its lines that fall in the window, then the block stores the
// window with 16-byte vector stores, neighbouring threads on neighbouring
// vectors; the partial vectors at the tile's two ends, which it shares
// with its neighbour tiles, go byte by byte.  A line longer than a window
// spans windows, so any k runs.  (The first version stored each thread's
// lines straight to device memory, byte by byte: each warp store then
// touched 32 sectors ~4 lines apart, and it took 41x its bound at k=51,
// against 7x for this one; PERF.md.)
#include "scan.cuh"

namespace w1 {

using namespace kt;

constexpr int THREADS = 256;
constexpr int RPT = 4;                   // consecutive rows per thread
constexpr int TILE = THREADS * RPT;      // rows per tile
constexpr int WINDOW = 16384;            // bytes of text staged at a time
constexpr uint32_t ACGT = 0x54474341u;   // byte b holds the letter of base b

__constant__ uint32_t P10[5] = {1u, 10u, 100u, 1000u, 10000u};

struct Part {
    const uint32_t* keys;   // word w of row i at keys[w * lw + i * li]
    long long lw, li;
    const void* cnt;        // int32 or int64 count column
    long long N;
    int k, W, mode;
    long long min_abu;
};

// The clipped count of raw count c into v; whether the row is kept.
template <typename C>
__device__ __forceinline__ bool keep_row(C c, int mode, long long min_abu, uint32_t& v) {
    if (c <= 0) return false;
    v = mode == 0 ? (uint32_t)((long long)c & 0xFFFFLL) : (c > 16383 ? 16383u : (uint32_t)c);
    return (long long)v >= min_abu;
}

__device__ __forceinline__ int digits(uint32_t v) {
    int d = 1;
    while (v >= 10u) {
        v /= 10u;
        ++d;
    }
    return d;
}

// Bytes [lo, hi) of row r's line (k bases, a space, the d digits of v,
// '\n') to win[at + lo .. at + hi).
__device__ __forceinline__ void stage_line(const Part& p, long long r, uint32_t v, int d, int lo,
                                           int hi, unsigned char* win, int at) {
    int q = lo;
    const int qb = min(hi, p.k);
    if (q < qb) {
        const uint32_t* key = p.keys + r * p.li;
        uint32_t x = key[(long long)(q >> 4) * p.lw];
        for (; q < qb; ++q) {
            if ((q & 15) == 0) x = key[(long long)(q >> 4) * p.lw];
            win[at + q] = (unsigned char)(ACGT >> (8 * ((x >> (30 - 2 * (q & 15))) & 3u)));
        }
    }
    for (; q < hi; ++q) {
        const int t = q - p.k;          // 0: the space, 1 .. d: the digits, d + 1: '\n'
        win[at + q] = t == 0 ? ' ' : t <= d ? (unsigned char)('0' + v / P10[d - t] % 10u) : '\n';
    }
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
format_kernel(Part p, unsigned long long* st, unsigned int* ticket, long long nt,
              unsigned char* out, long long* res) {
    __shared__ unsigned int s_tile;
    __shared__ long long s_off;
    const int tid = threadIdx.x;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = s_tile;
    const long long r0 = tile * TILE + (long long)RPT * tid;
    const C* cnt = static_cast<const C*>(p.cnt);

    // 1. line lengths of this thread's rows
    uint32_t v[RPT];
    int d[RPT];
    long long mine = 0;
    int kept = 0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const long long r = r0 + j;
        d[j] = 0;
        v[j] = 0u;
        if (r < p.N && keep_row(cnt[r], p.mode, p.min_abu, v[j])) {
            d[j] = digits(v[j]);
            mine += p.k + 2 + d[j];
            ++kept;
        }
    }

    // 2. byte offsets: block scan, then the tile's offset by look-back;
    //    the lines kept, summed over the grid
    long long tot;
    const long long ex = block_excl_scan(mine, 0LL, SumOp(), tot);
    unsigned long long lines = 0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) lines += (unsigned long long)__syncthreads_count(kept > j);
    if (tid == 0) {
        publish(st, tile, tot, 0LL);
        if (lines) atomicAdd(reinterpret_cast<unsigned long long*>(res + 1), lines);
    }
    if (tid < 32) {
        const long long off = resolve(st, tile, tot, SumOp(), 0LL, 0LL);
        if (tid == 0) {
            s_off = off;
            if (tile == nt - 1) res[0] = off + tot;
        }
    }
    __syncthreads();

    // 3. the lines: the tile's text [t0, t1) through shared memory, one
    //    window [g, g + WINDOW) at a time (g a multiple of 16)
    __shared__ __align__(16) unsigned char s_text[WINDOW];
    const long long t0 = s_off, t1 = s_off + tot;
    const long long mine0 = t0 + ex;
    for (long long g = t0 & ~15LL; g < t1; g += WINDOW) {
        const long long g1 = g + WINDOW;
        if (mine0 < g1 && mine0 + mine > g) {
            long long o = mine0;
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                if (!d[j]) continue;
                const int len = p.k + 2 + d[j];
                if (o < g1 && o + len > g)
                    stage_line(p, r0 + j, v[j], d[j], (int)(o < g ? g - o : 0),
                               (int)(o + len > g1 ? g1 - o : len), s_text, (int)(o - g));
                o += len;
            }
        }
        __syncthreads();
        const long long end = g1 < t1 ? g1 : t1;
        for (long long a = g + 16LL * tid; a < end; a += 16LL * THREADS) {
            if (a >= t0 && a + 16 <= t1) {
                *reinterpret_cast<uint4*>(out + a) =
                    *reinterpret_cast<const uint4*>(s_text + (a - g));
            } else {
                for (long long b = a; b < a + 16; ++b)
                    if (b >= t0 && b < t1) out[b] = s_text[b - g];
            }
        }
        __syncthreads();
    }
}

// Scratch int64 words for N rows: the ticket and one status word per tile.
inline long long scratch_words(long long N) {
    return 1 + (N + TILE - 1) / TILE;
}

}  // namespace w1

extern "C" long long kt_format_lines_scratch(long long N) {
    return w1::scratch_words(N);
}

// keys: word w of row i at keys[w * lw + i * li] (u32).  cnt: N counts,
// int64 when cnt64, else int32.  out: >= N * (k + 7) bytes, 16-byte
// aligned.  scratch: kt_format_lines_scratch(N) int64s.  res: int64 [2]
// = [bytes, lines].
// Returns a cudaError_t.
extern "C" int kt_format_lines(const void* keys, long long lw, long long li, const void* cnt,
                               int cnt64, long long N, int k, int mode, long long min_abu,
                               void* out, void* scratch, void* res, void* stream) {
    if (k < 1 || N < 0 || li < 0 || lw < 0 || (N + w1::TILE - 1) / w1::TILE > 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    if ((e = cudaMemsetAsync(res, 0, 2 * sizeof(long long), s)) != cudaSuccess) return (int)e;
    if (N == 0) return (int)cudaSuccess;
    if ((e = cudaMemsetAsync(scratch, 0, 8 * (size_t)w1::scratch_words(N), s)) != cudaSuccess)
        return (int)e;
    w1::Part p;
    p.keys = static_cast<const uint32_t*>(keys);
    p.lw = lw;
    p.li = li;
    p.cnt = cnt;
    p.N = N;
    p.k = k;
    p.W = (k + 15) / 16;
    p.mode = mode;
    p.min_abu = min_abu;
    const long long nt = (N + w1::TILE - 1) / w1::TILE;
    long long* sc = static_cast<long long*>(scratch);
    auto* ticket = reinterpret_cast<unsigned int*>(sc);
    auto* st = reinterpret_cast<unsigned long long*>(sc + 1);
    auto* o = static_cast<unsigned char*>(out);
    auto* r = static_cast<long long*>(res);
    if (cnt64)
        w1::format_kernel<long long><<<(unsigned)nt, w1::THREADS, 0, s>>>(p, st, ticket, nt, o, r);
    else
        w1::format_kernel<int32_t><<<(unsigned)nt, w1::THREADS, 0, s>>>(p, st, ticket, nt, o, r);
    return (int)cudaGetLastError();
}
