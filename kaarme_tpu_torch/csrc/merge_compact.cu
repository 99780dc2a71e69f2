// K4: linear merge of two sorted runs + segment sum and dense compaction
// (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_merge.py::merge_compact_dense (kernel
// bodies _merge_kernel and _bitonic_merge).  A (the store's dense sorted
// prefix, trailing sentinel rows allowed) and B (the superstep's sorted
// window keys) are both ASCENDING runs of W u32 words.  Two layouts:
//   - embedded: the count sits in the low ``ebits`` of A's last word and
//     B rows carry |1; the merge compares whole words, count bits
//     included, so a key's non-unit row ends its segment as a sort
//     would leave it, and K2's embedded mode (c_last + len - 1) applies;
//   - separate count: A has a count column, B rows count 1 (written by
//     this kernel, never shipped); K2's full_sum mode sums them.
// The merged rows equal a stable sort of A ++ B, so the output equals
// ``lexsort(A ++ B)`` followed by K2, the plain version.
//
// What bounds it on the H100: the merge reads and writes every row once
// (4W B each way, plus the count) and K2 then streams the merged rows,
// so the pair is memory-bound, ~3 passes over (Na + Nb) rows of W+1
// words.  Design: merge path.  One thread per tile boundary binary-
// searches its output diagonal across A and B under the W-word
// lexicographic order (ties: A first).  Each block then stages its two
// sub-runs in shared memory and places every element by rank: an A
// element counts the B elements strictly less than it, a B element the
// A elements <= it, so every output slot is filled exactly once.  The
// merged rows go to a scratch buffer and the existing K2 code
// (kt_segsum_compact, csrc/segsum_compact.cu) makes the dense store;
// nothing is written at or past ``out_len``.  The TPU design's bitonic
// network, tag plane and descending B (a VMEM-friendly merge) are gone;
// fusing the merge with the compaction into one pass is later work.
#include <cstdint>
#include <cuda_runtime.h>

extern "C" int kt_segsum_compact(const void* keys, const void* cnt, long long N, int W,
                                 int ebits, int full_sum, void* out, long long ld,
                                 long long out_len, void* scratch, void* nd, void* stream);

namespace k4 {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 48 * 1024;   // staged bytes per block: tile * W * 4

struct Runs {
    const uint32_t* a;      // W key columns (stride lda)
    const int32_t* acnt;    // A's count column (separate-count layout) or nullptr
    long long lda, na;
    const uint32_t* b;      // W key columns (stride ldb)
    long long ldb, nb;
    int W;
};

// Lexicographic compare of rows x[i] and y[j] (W words, stride ldx/ldy).
__device__ __forceinline__ int cmp_rows(const uint32_t* x, long long ldx, long long i,
                                        const uint32_t* y, long long ldy, long long j, int W) {
    for (int w = 0; w < W; ++w) {
        const uint32_t p = x[(long long)w * ldx + i], q = y[(long long)w * ldy + j];
        if (p != q) return p < q ? -1 : 1;
    }
    return 0;
}

// The number of A rows among the first d merged rows (ties: A first).
__device__ long long split_a(const Runs& r, long long d) {
    long long lo = d > r.nb ? d - r.nb : 0, hi = d < r.na ? d : r.na;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (cmp_rows(r.a, r.lda, mid, r.b, r.ldb, d - 1 - mid, r.W) <= 0) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Pass 1: the A split at every tile boundary d = t * tile, t = 0..ntiles.
__global__ void split_kernel(Runs r, long long ntiles, int tile, long long* split) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t > ntiles) return;
    const long long tot = r.na + r.nb;
    const long long d = t * tile < tot ? t * tile : tot;
    split[t] = split_a(r, d);
}

// Pass 2: merge each tile's two sub-runs by rank into the scratch rows.
__global__ void __launch_bounds__(THREADS)
merge_kernel(Runs r, int tile, const long long* split, uint32_t* __restrict__ out,
             long long ldo, int with_cnt) {
    extern __shared__ uint32_t sm[];   // W columns of ``tile`` rows: A part, then B part
    const int W = r.W;
    const long long d0 = (long long)blockIdx.x * tile;
    const long long tot = r.na + r.nb;
    const long long a0 = split[blockIdx.x];
    const int la = (int)(split[blockIdx.x + 1] - a0);
    const int len = (int)((d0 + tile < tot ? d0 + tile : tot) - d0);
    const int lb = len - la;
    const long long b0 = d0 - a0;
    for (int w = 0; w < W; ++w) {
        uint32_t* col = sm + (long long)w * tile;
        for (int i = threadIdx.x; i < la; i += THREADS)
            col[i] = r.a[(long long)w * r.lda + a0 + i];
        for (int j = threadIdx.x; j < lb; j += THREADS)
            col[la + j] = r.b[(long long)w * r.ldb + b0 + j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += THREADS) {
        int lo, hi, rank;
        if (e < la) {          // B rows strictly less than A[e]
            lo = 0;
            hi = lb;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (cmp_rows(sm, tile, la + mid, sm, tile, e, W) < 0) lo = mid + 1;
                else hi = mid;
            }
            rank = e + lo;
        } else {               // A rows <= B[e - la]
            lo = 0;
            hi = la;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (cmp_rows(sm, tile, mid, sm, tile, e, W) <= 0) lo = mid + 1;
                else hi = mid;
            }
            rank = (e - la) + lo;
        }
        const long long o = d0 + rank;
        for (int w = 0; w < W; ++w) out[(long long)w * ldo + o] = sm[(long long)w * tile + e];
        if (with_cnt) out[(long long)W * ldo + o] = e < la ? (uint32_t)r.acnt[a0 + e] : 1u;
    }
}

}  // namespace k4

using namespace k4;

// a: W u32 key columns of stride lda (embedded: the count in the last
// word's low ``ebits``; separate count, ebits == 0: acnt is A's int32
// count column).  b: W u32 columns of stride ldb.  Both sorted
// ascending.  merged: scratch of W+1 columns of stride na + nb (the
// count column is used in the separate layout only).  split: int64
// [ntiles + 1] with ntiles = ceil((na + nb) / tile), tile * W * 4 <=
// 48 KB.  k2_scratch: kt_segsum_compact's scratch for N = na + nb.  out:
// W + 1 u32 columns of stride ld >= out_len.  nd: int32 [2] =
// [nd_exact, nd_used].  Returns a cudaError_t.
extern "C" int kt_merge_compact(const void* a, long long lda, long long na, const void* acnt,
                                const void* b, long long ldb, long long nb, int W, int ebits,
                                int tile, void* merged, void* split, void* k2_scratch,
                                void* out, long long ld, long long out_len, void* nd,
                                void* stream) {
    const bool sep = ebits == 0;
    if (W < 1 || na < 0 || nb < 0 || lda < na || ldb < nb || ebits < 0 || ebits > 31 ||
        tile < 1 || (long long)tile * W * 4 > SMEM_MAX || (sep && !acnt && na > 0))
        return (int)cudaErrorInvalidValue;
    Runs r;
    r.a = static_cast<const uint32_t*>(a);
    r.acnt = static_cast<const int32_t*>(acnt);
    r.lda = lda;
    r.na = na;
    r.b = static_cast<const uint32_t*>(b);
    r.ldb = ldb;
    r.nb = nb;
    r.W = W;
    const long long N = na + nb;
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* m = static_cast<uint32_t*>(merged);
    if (N > 0) {
        const long long ntiles = (N + tile - 1) / tile;
        long long* sp = static_cast<long long*>(split);
        split_kernel<<<(unsigned)((ntiles + 1 + THREADS - 1) / THREADS), THREADS, 0, s>>>(
            r, ntiles, tile, sp);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        merge_kernel<<<(unsigned)ntiles, THREADS, (size_t)tile * W * 4, s>>>(
            r, tile, sp, m, N, sep ? 1 : 0);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    return kt_segsum_compact(m, sep ? (const void*)(m + (long long)W * N) : nullptr, N, W,
                             ebits, sep ? 1 : 0, out, ld, out_len, k2_scratch, nd, stream);
}
