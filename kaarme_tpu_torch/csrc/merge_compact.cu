// K4: linear merge of two sorted runs fused with the segment sum and
// dense compaction (CUDA C++, sm_90a), in one pass.
//
// Replaces kaarme_tpu/ops/pallas_merge.py::merge_compact_dense (kernel
// bodies _merge_kernel and _bitonic_merge).  A (the store's dense sorted
// prefix, trailing sentinel rows allowed) and B (the superstep's sorted
// window keys) are both ASCENDING runs of W u32 words.  Two layouts:
//   - embedded: the count sits in the low ``ebits`` of A's last word and
//     B rows carry |1; the merge compares whole words, count bits
//     included, so a key's non-unit row ends its segment as a sort
//     would leave it, and K2's embedded total (c_last + len - 1) applies;
//   - separate count: A has a count column, B rows count 1 (implicit,
//     never shipped); the total is K2's clamped full sum.
// The merged order is a stable sort of A ++ B (ties: A first), so the
// output equals ``lexsort(A ++ B)`` followed by K2, the plain version:
// one record per live key in key order, the count clamped, sentinel keys
// with count 0 up to ``out_len``; nothing is written at or past
// ``out_len`` and nd > out_len signals an overflow.
//
// What bounds it on the H100: bytes, at best.  Each row of A and B is
// read once (4W B, plus A's count) and each record written once; the
// merged rows never reach device memory (the kernel it replaces wrote
// them to a scratch of (W+1) x (na+nb) words and compacted that).
// Design: one kernel whose blocks take an index from an atomic ticket,
// as K2's (segsum_compact.cu):
// - Split jobs.  The first tickets are not tiles: each thread of such a
//   block finds the merge path at one tile boundary (the A rows among
//   the first d merged rows) and publishes it in the scratch.  The block
//   first brackets its 256 boundaries (its first and last one, rounds of
//   128 probes each; the path rises by at most one row per diagonal), so
//   that each thread binary-searches a short range (A[m] <= B[d-1-m]: the
//   first key word alone, the others only where it ties).  A tile reads
//   its two boundaries there, and waits only while its job runs (its
//   ticket came first, so the job is running: no deadlock).  A search per
//   tile on its own critical path, by the tile's threads, moved more
//   bytes than the tile's rows and was the slowest phase.
// - Stage.  The tile's R merged rows are the sub-runs A[a0, a1) and
//   B[b0, b1): W columns and the counts, by asynchronous copies
//   (cp.async), plus four halo rows: A[a0-1] and B[b0-1], whose larger is
//   the merged row before the tile, and A[a1] and B[b1], whose smaller is
//   the row after it.  Row j sits at word j + j/32 of its column.
// - Merge.  Each thread takes I consecutive merged rows: a binary search
//   of its diagonal in shared memory, a sequential merge that lists their
//   staged indices, then, row by row with no dependence between rows, each
//   row's "differs from the row before" bit (the last word masked with
//   ~cmask when embedded), its sentinel bit and its count.  I is odd and
//   the columns padded so that the lanes of a warp fall on different
//   banks.  The per-word loops are unrolled for W = 1-4 (a template
//   parameter; any other W reads it at run time).
// - Then K2's core: the block scan of the segmented values and the live
//   count, the two look-backs of scan.cuh (the ordered one for the
//   segmented carry, a segment may span many tiles; the plain one for the
//   record offset) by warps 0 and 1 while the other warps list the live
//   rows, and the records written column by column from the staged rows.
// Each tile is a chain of latencies (split read, staging, merge, scan,
// look-back), so the tile is as large as fits: R = 256 I for the largest
// odd I <= 15 whose staged rows fit SMEM_TARGET with a count column (I =
// 15 at W = 1, 9 at W = 4, 3 at W = 13 to 20, 1 up to W = 65, fewer rows
// than threads beyond, k > 1,040); above 48 KB the kernel opts in with
// cudaFuncSetAttribute.  At k=51 (W = 4, embedded) a block takes 56.5 KB,
// 4 blocks per SM.  Launches per call: the scratch memset, this kernel,
// the sentinel fill.
#include <cuda_pipeline_primitives.h>

#include "scan.cuh"

namespace k4 {

using namespace kt;

constexpr int THREADS = 256;             // also the tile boundaries per split job
constexpr int MAX_ITEMS = 15;            // merged rows per thread (odd; bits of the row masks)
constexpr int HALO = 4;                  // staged rows A[a0-1], B[b0-1], A[a1], B[b1]
constexpr size_t SMEM_TARGET = 72 * 1024; // the tile is sized to this many staged bytes
constexpr size_t SMEM_MAX = 225 * 1024;  // dynamic shared memory a block may take

struct Runs {
    const uint32_t* a;      // W key columns (stride lda)
    const uint32_t* acnt;   // A's count column (separate-count layout) or nullptr
    long long lda, na;
    const uint32_t* b;      // W key columns (stride ldb)
    long long ldb, nb;
    int W;
    uint32_t cmask;         // count bits of the last key word (embedded), else 0
};

// Staged row j sits at word at(j) of its column: one spare word after
// every 32, so that lanes reading rows 8 or 16 apart (the B rows of
// neighbouring threads' merges, ~8 apart at k=51) hit different banks.
__host__ __device__ __forceinline__ int at(int j) { return j + (j >> 5); }

// Words per staged column of a tile of R rows: R + HALO rows, padded.
__host__ __device__ inline int col_words(int R) { return at(R + HALO - 1) + 1; }

// Dynamic shared memory of a tile of R rows: the run values of the
// listed rows (u32), W key columns and, with a count column, the counts
// of R + HALO staged rows (u32), the merged order and the live list (u16).
__host__ inline size_t smem_bytes(int W, int R, bool full) {
    return 4 * ((size_t)W + (full ? 1 : 0)) * (size_t)col_words(R) + 8 * (size_t)R;
}

// Merged rows per tile for W key words: THREADS * I for the largest odd
// I <= MAX_ITEMS whose staged rows fit SMEM_TARGET with a count column,
// so one tiling serves both layouts; else fewer rows than threads.
__host__ inline int tile_rows(int W) {
    for (int I = MAX_ITEMS; I >= 1; I -= 2)
        if (smem_bytes(W, THREADS * I, true) <= SMEM_TARGET) return THREADS * I;
    int R = THREADS / 2;
    while (R > 1 && smem_bytes(W, R, true) > SMEM_TARGET) R /= 2;
    return R;
}

// Split jobs ahead of the nt tiles: one thread per tile boundary.
__host__ __device__ inline long long split_jobs(long long nt) {
    return (nt + THREADS) / THREADS;
}

// Scratch int64 words: the ticket, the total, two status words per tile
// and the merge path at each of the nt + 1 tile boundaries.
__host__ inline long long scratch_words(long long N, int R) {
    return 3 + 3 * ((N + R - 1) / R);
}

// A[i] <= B[j] over the W key words (ties: A first), in device memory:
// the first word alone, then, only where it ties, the others four at a
// time, loaded before they are compared.
__device__ __forceinline__ bool a_le_b(const Runs& r, long long i, long long j) {
    const uint32_t x = r.a[i], y = r.b[j];
    if (x != y) return x < y;
    for (int w0 = 1; w0 < r.W; w0 += 4) {
        uint32_t p[4], q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const long long w = w0 + u < r.W ? w0 + u : r.W - 1;
            p[u] = r.a[w * r.lda + i];
            q[u] = r.b[w * r.ldb + j];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (w0 + u < r.W && p[u] != q[u]) return p[u] < q[u];
    }
    return true;
}

// The merge path at diagonal d (the A rows among the first d merged
// rows) known to lie in [lo, hi], inside [max(0, d - nb), min(d, na)]:
// the first m in [lo, hi) where A[m] <= B[d-1-m] fails, else hi.
__device__ long long merge_path(const Runs& r, long long d, long long lo, long long hi) {
    while (lo < hi) {
        const long long m = (lo + hi) >> 1;
        if (a_le_b(r, m, d - 1 - m)) lo = m + 1;
        else hi = m;
    }
    return lo;
}

// Probe g of G evenly spaced points of [lo, hi).
__device__ __forceinline__ long long probe_at(long long lo, long long hi, int g, int G) {
    return lo + (long long)(g + 1) * (hi - lo) / (G + 1);
}

// One round of a G-probe search of [lo, hi): c of the probes held.
__device__ __forceinline__ void narrow(long long& lo, long long& hi, int c, int G) {
    if (lo >= hi) return;
    const long long nlo = c > 0 ? probe_at(lo, hi, c - 1, G) + 1 : lo;
    if (c < G) hi = probe_at(lo, hi, c, G);
    lo = nlo;
}

// Split job `job`: the merge path at tile boundaries job * THREADS + tid
// (diagonal b * R, the last one N), published as path + 1.  The block
// first finds the path at its first and last boundary together (half of
// the threads on each, rounds of 128 probes); since the path rises by at
// most one row per diagonal, that brackets every boundary between them,
// and each thread binary-searches its own bracket, a few steps shorter
// than the whole run.  The searches' random reads bound a job.
__device__ void split_job(const Runs& r, long long job, int R, long long nt,
                          unsigned long long* split) {
    constexpr int G = THREADS / 2;
    const int tid = threadIdx.x, half = tid / G;
    const long long N = r.na + r.nb;
    const long long bf = job * THREADS, bl = bf + THREADS - 1 < nt ? bf + THREADS - 1 : nt;
    const long long df = bf * R, dl = bl < nt ? bl * R : N;
    const long long de = half ? dl : df;
    long long lo0 = df > r.nb ? df - r.nb : 0, hi0 = df < r.na ? df : r.na;
    long long lo1 = dl > r.nb ? dl - r.nb : 0, hi1 = dl < r.na ? dl : r.na;
    while (lo0 < hi0 || lo1 < hi1) {
        const long long lo = half ? lo1 : lo0, hi = half ? hi1 : hi0;
        bool p = false;
        if (lo < hi) {
            const long long m = probe_at(lo, hi, tid % G, G);
            p = a_le_b(r, m, de - 1 - m);
        }
        const int c0 = __syncthreads_count(half == 0 && p);
        const int c1 = __syncthreads_count(half == 1 && p);
        narrow(lo0, hi0, c0, G);
        narrow(lo1, hi1, c1, G);
    }
    const long long b = bf + tid;
    if (b > bl) return;
    const long long d = b < nt ? b * R : N;
    const long long lo = lo0 > lo1 - (dl - d) ? lo0 : lo1 - (dl - d);
    const long long hi = lo1 < lo0 + (d - df) ? lo1 : lo0 + (d - df);
    st_status(split + b, (unsigned long long)merge_path(r, d, lo, hi) + 1);
}

// The same on staged rows (columns of S rows in shared memory).
__device__ __forceinline__ int cmp_staged(const uint32_t* k, int S, int i, int j, int W) {
    for (int w = 0; w < W; ++w) {
        const uint32_t p = k[w * S + at(i)], q = k[w * S + at(j)];
        if (p != q) return p < q ? -1 : 1;
    }
    return 0;
}

// The block scan's element: a segmented value and a live count.
struct SegN {
    Seg s;
    uint32_t n;
};

__device__ __forceinline__ SegN shfl_up(SegN x, int d) {
    SegN r;
    r.s = kt::shfl_up(x.s, d);
    r.n = __shfl_up_sync(FULL_MASK, x.n, d);
    return r;
}

template <bool FULL>
struct SegNOp {
    __device__ __forceinline__ SegN operator()(SegN x, SegN y) const {
        SegN r;
        r.s = SegOp<FULL>()(x.s, y.s);
        r.n = x.n + y.n;
        return r;
    }
};

// WC: W as a compile-time constant (1-4, so that the per-word loops
// unroll), or 0 to read it from r.W.
template <bool FULL, int WC>
__global__ void __launch_bounds__(THREADS)
merge_compact_kernel(Runs r, int R, unsigned long long* st_seg, unsigned long long* st_cnt,
                     unsigned long long* split, unsigned int* ticket, long long* total,
                     long long nt,
                     uint32_t* __restrict__ out, long long ld, long long out_len) {
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ long long s_tile, s_off, s_carry, s_split[2];
    __shared__ uint8_t s_first[THREADS];    // "starts a segment" bit of each thread's first row
    const int W = WC ? WC : r.W;
    const int S = col_words(R);             // words per staged column
    uint32_t* s_val = smem;                 // [R] listed rows: run value in the tile | flag << 31
    uint32_t* keys = s_val + R;             // W columns of S staged rows
    uint32_t* cnt = keys + W * S;           // [S] counts (FULL)
    uint16_t* perm = reinterpret_cast<uint16_t*>(cnt + (FULL ? S : 0));   // [R] merged -> staged
    uint16_t* s_idx = perm + R;             // [R] live rows in rank order (staged index)
    const SegOp<FULL> op;
    const int tid = threadIdx.x;
    const int I = R > THREADS ? R / THREADS : 1;    // merged rows per thread

    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long N = r.na + r.nb;
    const long long nsplit = split_jobs(nt);
    if (s_tile < nsplit) {
        split_job(r, s_tile, R, nt, split);
        return;
    }
    const long long tile = s_tile - nsplit;
    const long long d0 = tile * R;
    const int len = (int)(N - d0 < R ? N - d0 : R);
    const long long d1 = d0 + len;

    // 1. the merge path at both boundaries, from the split jobs
    if (tid < 2) {
        unsigned long long v;
        do v = ld_status(split + tile + tid);
        while (v == 0);
        s_split[tid] = (long long)v - 1;
    }
    __syncthreads();
    const long long a0 = s_split[0], a1 = s_split[1], b0 = d0 - a0, b1 = d1 - a1;
    const int la = (int)(a1 - a0), lb = len - la;

    // 2. stage A[a0, a1) then B[b0, b1), their counts, and the halo rows
    for (int w = 0; w < W; ++w) {
        uint32_t* col = keys + w * S;
        const uint32_t* ga = r.a + (long long)w * r.lda + a0;
        const uint32_t* gb = r.b + (long long)w * r.ldb + b0;
        for (int i = tid; i < la; i += THREADS) __pipeline_memcpy_async(col + at(i), ga + i, 4);
        for (int i = tid; i < lb; i += THREADS) __pipeline_memcpy_async(col + at(la + i), gb + i, 4);
    }
    if (FULL) {
        for (int i = tid; i < la; i += THREADS) __pipeline_memcpy_async(cnt + at(i), r.acnt + a0 + i, 4);
        for (int i = tid; i < lb; i += THREADS) cnt[at(la + i)] = 1u;
    }
    __pipeline_commit();
    for (int i = tid; i < HALO * W; i += THREADS) {
        const int h = i / W, w = i % W;
        const bool in_a = (h & 1) == 0;
        const long long x = h == 0 ? a0 - 1 : h == 1 ? b0 - 1 : h == 2 ? a1 : b1;
        uint32_t v = 0u;
        if (x >= 0 && x < (in_a ? r.na : r.nb))
            v = in_a ? r.a[(long long)w * r.lda + x] : r.b[(long long)w * r.ldb + x];
        keys[w * S + at(R + h)] = v;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // the merged row before the tile (the later of A[a0-1], B[b0-1]) and
    // after it (the earlier of A[a1], B[b1]), as staged rows; -1: none
    int pred = -1, succ = -1;
    if (d0 > 0)
        pred = a0 == 0 ? R + 1 : b0 == 0 ? R : cmp_staged(keys, S, R, R + 1, W) <= 0 ? R + 1 : R;
    if (d1 < N)
        succ = a1 == r.na ? R + 3 : b1 == r.nb ? R + 2
             : cmp_staged(keys, S, R + 2, R + 3, W) <= 0 ? R + 2 : R + 3;

    // 3. this thread's rows t0 .. t0+I-1: its diagonal's split, then a
    //    sequential merge that lists their staged indices in perm
    const int t0 = tid * I < len ? tid * I : len;
    const int nq = len - t0 < I ? len - t0 : I;    // of them inside the tile
    int ia, ib;
    {
        int lo = t0 > lb ? t0 - lb : 0, hi = t0 < la ? t0 : la;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (cmp_staged(keys, S, mid, la + t0 - 1 - mid, W) <= 0) lo = mid + 1;
            else hi = mid;
        }
        ia = lo;
        ib = t0 - lo;
    }
    int prev = t0 == 0 ? pred
             : ia == 0 ? la + ib - 1
             : ib == 0 ? ia - 1
             : cmp_staged(keys, S, ia - 1, la + ib - 1, W) <= 0 ? la + ib - 1 : ia - 1;
    for (int q = 0; q < nq; ++q)
        perm[tid * I + q] = (uint16_t)(
            (ib >= lb || (ia < la && cmp_staged(keys, S, ia, la + ib, W) <= 0)) ? ia++ : la + ib++);

    //    Then, row by row with no dependence between rows (so their loads
    //    overlap): its "differs from the row before" bit (dm) and its
    //    sentinel bit (snt); rows past the tile are starts, never live.
    const uint32_t valid = (1u << nq) - 1u;
    uint32_t dm = ((1u << I) - 1u) & ~valid, snt = 0;
    Seg agg = {0u, 0u};
    for (int q = 0; q < nq; ++q) {
        const int cur = perm[tid * I + q];
        uint32_t diff = prev < 0 ? 1u : 0u, ones = 1u;
        for (int w = 0; w < W; ++w) {
            const uint32_t m = w == W - 1 ? ~r.cmask : 0xffffffffu;
            const uint32_t x = keys[w * S + at(cur)];
            if (prev >= 0) diff |= (x ^ keys[w * S + at(prev)]) & m;
            ones &= (x | ~m) == 0xffffffffu ? 1u : 0u;
        }
        const uint32_t f = diff ? 1u : 0u;
        dm |= f << q;
        snt |= ones << q;
        agg = op(agg, Seg{f, FULL ? clamp_count(cnt[at(cur)]) : 1u});
        prev = cur;
    }
    // the tile's last row ends its segment unless the row after the tile
    // continues it
    uint32_t dnext = 1u;
    if (succ >= 0 && tid == (R - 1) / I) {
        uint32_t diff = 0;
        for (int w = 0; w < W; ++w)
            diff |= (keys[w * S + at(succ)] ^ keys[w * S + at(prev)]) & (w == W - 1 ? ~r.cmask : ~0u);
        dnext = diff ? 1u : 0u;
    }
    s_first[tid] = (uint8_t)(dm & 1u);
    __syncthreads();

    // 4. live rows (the last of a segment, not a sentinel); the block scan
    uint32_t last = 0;
    for (int q = 0; q < I; ++q) {
        const int row = tid * I + q;
        const uint32_t nx = row + 1 == R ? dnext
                          : q + 1 < I ? (dm >> (q + 1)) & 1u
                          : tid + 1 < THREADS ? s_first[tid + 1] : 1u;
        last |= nx << q;
    }
    const uint32_t live = last & ~snt & valid;
    SegN tot;
    const SegN id = {{0u, 0u}, 0u};
    const SegN ex = block_excl_scan(SegN{agg, (uint32_t)__popc(live)}, id, SegNOp<FULL>(), tot);
    if (tid == 0) {
        publish(st_seg, tile, seg_pack(tot.s), 0LL);
        publish(st_cnt, tile, (long long)tot.n, 0LL);
    }

    // 5. the carry into the tile (warp 0, in tile order) and its first
    //    record (warp 1) by look-back, while the other warps list their
    //    live rows; the last tile has the total
    if (tid < 32) {
        const long long c = resolve<true>(st_seg, tile, seg_pack(tot.s), PackedSegOp<FULL>(),
                                          0LL, 0LL);
        if (tid == 0) s_carry = c;
    } else if (tid < 64) {
        const long long off = resolve(st_cnt, tile, (long long)tot.n, SumOp(), 0LL, 0LL);
        if (tid == 32) {
            s_off = off;
            if (tile == nt - 1) *total = off + tot.n;
        }
    }

    // 6. list the live rows in rank order with their run value in the tile
    Seg run = ex.s;
    uint32_t rank = ex.n;
    for (int q = 0; q < I; ++q) {
        if (!((valid >> q) & 1u)) break;
        const int cur = perm[tid * I + q];
        run = op(run, Seg{(dm >> q) & 1u, FULL ? clamp_count(cnt[at(cur)]) : 1u});
        if ((live >> q) & 1u) {
            s_idx[rank] = (uint16_t)cur;
            s_val[rank] = run.v | (run.f ? 0x80000000u : 0u);
            ++rank;
        }
    }
    __syncthreads();

    // 7. write the records column by column from the staged rows
    const long long off = s_off;
    const long long n_live = tot.n;
    const long long nw = n_live < out_len - off ? n_live : (out_len > off ? out_len - off : 0);
    for (int w = 0; w < W; ++w) {
        const uint32_t* col = keys + w * S;
        const uint32_t m = w == W - 1 ? ~r.cmask : 0xffffffffu;
        uint32_t* o = out + (long long)w * ld + off;
        for (int i = tid; i < nw; i += THREADS) o[i] = col[at(s_idx[i])] & m;
    }
    const Seg carry = seg_unpack(s_carry);
    const uint32_t* clast = keys + (W - 1) * S;
    uint32_t* o = out + (long long)W * ld + off;
    for (int i = tid; i < nw; i += THREADS) {
        const uint32_t e = s_val[i];
        const Seg loc = {e >> 31, e & 0x7fffffffu};
        const uint32_t sum = op(carry, loc).v;
        o[i] = FULL ? clamp_count(sum) : clamp_count((clast[at(s_idx[i])] & r.cmask) + (sum - 1u));
    }
}

template <bool FULL, int WC>
cudaError_t launch(const Runs& r, int R, size_t sm, unsigned long long* st_seg,
                   unsigned long long* st_cnt, unsigned long long* split, unsigned int* ticket,
                   long long* total, long long nt, uint32_t* out, long long ld,
                   long long out_len, cudaStream_t s) {
    cudaError_t e;
    if (sm > 48 * 1024 &&
        (e = cudaFuncSetAttribute((const void*)merge_compact_kernel<FULL, WC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm)) !=
            cudaSuccess)
        return e;
    merge_compact_kernel<FULL, WC><<<(unsigned)(split_jobs(nt) + nt), THREADS, sm, s>>>(
        r, R, st_seg, st_cnt, split, ticket, total, nt, out, ld, out_len);
    return cudaGetLastError();
}

template <bool FULL>
int run(const Runs& r, uint32_t* out, long long ld, long long out_len, void* scratch, int* nd,
        cudaStream_t s) {
    const int R = tile_rows(r.W);
    const long long N = r.na + r.nb;
    const long long nt = (N + R - 1) / R;
    long long* sc = static_cast<long long*>(scratch);
    unsigned int* ticket = reinterpret_cast<unsigned int*>(sc);
    long long* total = sc + 1;
    unsigned long long* st_seg = reinterpret_cast<unsigned long long*>(sc + 2);
    unsigned long long* st_cnt = st_seg + nt;
    unsigned long long* split = st_cnt + nt;
    const size_t sm = smem_bytes(r.W, R, FULL);
    if (sm > SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if ((e = cudaMemsetAsync(scratch, 0, 8 * (size_t)scratch_words(N, R), s)) != cudaSuccess)
        return (int)e;
    if (nt > 0) {
        auto go = r.W == 1 ? launch<FULL, 1> : r.W == 2 ? launch<FULL, 2>
                : r.W == 3 ? launch<FULL, 3> : r.W == 4 ? launch<FULL, 4> : launch<FULL, 0>;
        if ((e = go(r, R, sm, st_seg, st_cnt, split, ticket, total, nt, out, ld, out_len, s)) !=
            cudaSuccess)
            return (int)e;
    }
    fill_tail_kernel<<<fill_blocks(out_len, 256), 256, 0, s>>>(out, r.W + 1, ld, out_len, total,
                                                              r.W, nd);
    return (int)cudaGetLastError();
}

}  // namespace k4

using namespace k4;

// Scratch (int64 words) the wrapper allocates for runs of na and nb rows
// of W key words (either layout).
extern "C" long long kt_merge_compact_scratch(long long na, long long nb, int W) {
    return scratch_words(na + nb, tile_rows(W < 1 ? 1 : W));
}

// a: W u32 key columns of stride lda (embedded: the count in the last
// word's low ``ebits``; separate count, ebits == 0: acnt is A's int32
// count column).  b: W u32 columns of stride ldb.  Both sorted
// ascending.  out: W + 1 u32 columns of stride ld >= out_len (keys, then
// the count).  scratch: kt_merge_compact_scratch(na, nb, W) int64s.  nd:
// int32 [2] = [nd_exact, nd_used].  Returns a cudaError_t.
extern "C" int kt_merge_compact(const void* a, long long lda, long long na, const void* acnt,
                                const void* b, long long ldb, long long nb, int W, int ebits,
                                void* out, long long ld, long long out_len, void* scratch,
                                void* nd, void* stream) {
    const bool sep = ebits == 0;
    if (W < 1 || na < 0 || nb < 0 || lda < na || ldb < nb || ebits < 0 || ebits > 31 ||
        out_len < 0 || ld < out_len || (sep && !acnt && na > 0))
        return (int)cudaErrorInvalidValue;
    Runs r;
    r.a = static_cast<const uint32_t*>(a);
    r.acnt = static_cast<const uint32_t*>(acnt);
    r.lda = lda;
    r.na = na;
    r.b = static_cast<const uint32_t*>(b);
    r.ldb = ldb;
    r.nb = nb;
    r.W = W;
    r.cmask = sep ? 0u : ((1u << ebits) - 1u);
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* o = static_cast<uint32_t*>(out);
    int* ndp = static_cast<int*>(nd);
    return sep ? run<true>(r, o, ld, out_len, scratch, ndp, s)
               : run<false>(r, o, ld, out_len, scratch, ndp, s);
}
