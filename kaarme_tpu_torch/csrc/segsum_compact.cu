// K2: fused segment-sum + compaction over sorted rows (CUDA C++, sm_90a),
// in one pass.
//
// Replaces kaarme_tpu/ops/pallas_compact.py::segsum_compact (kernel body
// _compact_kernel, core segsum_rows, staging dense_stage) in the two
// modes the super-k-mer main path runs:
//   - embedded (the run-store merge): the count sits in the low ``ebits``
//     of the last key word; a segment's total is c_last + (len - 1),
//     clamped (sortcount._compact_embedded);
//   - full_sum (the finalize): a separate count column; the total is the
//     clamped segmented sum of every row's count, exact for any segment
//     mass (sortcount.compact(clamped=True)).
// One record per live (non-sentinel) segment is written densely in key
// order; rows [nd, out_len) are sentinel keys with count 0, and
// nd_used == nd_exact.  Nothing is written at or past ``out_len``.
//
// What bounds it on the H100: bytes.  It streams N rows of W key words
// (plus a count) once and writes the nd records and the sentinel tail,
// a few hundred MB at the merge's shape; the work per row is one
// compare per word and a segmented add.  Design: one kernel over tiles
// of 2048 rows, whose index comes from an atomic ticket.
// - Flags from a single read.  A tile reads its rows one column at a
//   time, each thread one 16-byte vector in each half of the tile (rows
//   4t .. 4t+3 and 1024+4t .. 1024+4t+3, so neighbouring threads read
//   neighbouring rows; scalar loads where the column is not 16-byte
//   aligned), plus the halo: the predecessor of each warp's first row
//   and the tile's successor row.  From that one read it keeps, per row,
//   "differs from its predecessor" (the last word masked with ~cmask in
//   embedded mode) and "all-ones so far" (the sentinel test) as bits of
//   two registers.  Shared memory does not grow with W, so any W >= 1
//   runs: the columns stream through registers.  Row i is the last of
//   its segment exactly when row i+1 is the first of one.
// - Inside the tile: the segmented scan (SegOp) and the live count, one
//   block scan of both halves' pairs.
// - Across tiles: decoupled look-back (scan.cuh).  No tile's flags depend
//   on another tile, so a tile publishes both aggregates at once; warp 0
//   then looks back for the segmented carry in tile order (SegOp does not
//   commute: the ordered look-back) and warp 1 for the record offset.
//   A tile's first segment may start tiles back (a poly-A k-mer, a mass
//   that crosses the clamp): it takes its carry only from the look-back.
// - Writes.  Before the look-back, the tile lists its live rows in rank
//   order in shared memory (row index, and the run value relative to the
//   tile with its "a start precedes it in this tile" flag); after it,
//   the records are written column by column, each column one contiguous
//   run.  The key words are re-read from device memory at the listed
//   rows rather than kept in shared memory: W has no bound, and the
//   tile's rows were read moments before, so the re-read is served from
//   L2 (50 MB), not HBM.
// Launches per call: the scratch memset, this kernel, the sentinel fill.
// Registers per thread (ptxas -v, sm_90a): 40 embedded, 60 full_sum, no
// spills, 13,336 B of static shared memory: 6 and 4 blocks of 256
// threads per SM, bound by registers.  Minimum-blocks bounds of 6 and 8
// spill; in one tuning call they gained at most ~10% at two of the three
// timed shapes and nothing at the finalize (PERF.md section 6).
#include "scan.cuh"

namespace k2 {

using namespace kt;

constexpr int THREADS = 256;
constexpr int HALF = 4 * THREADS;       // rows of a half tile: one 16-byte vector per thread
constexpr int TILE = 2 * HALF;          // rows per tile

struct Rows {
    const uint32_t* keys;   // W columns, stride N
    const int32_t* cnt;     // full_sum count column (nullptr when embedded)
    long long N;
    int W;
    uint32_t cmask;         // count bits of the last key word (embedded)
};

// The block scan's element: both halves' segmented values and live
// counts, combined component-wise.
struct Pair {
    Seg a, b;
    uint32_t la, lb;
};

__device__ __forceinline__ Pair shfl_up(Pair x, int d) {
    Pair r;
    r.a = kt::shfl_up(x.a, d);
    r.b = kt::shfl_up(x.b, d);
    r.la = __shfl_up_sync(FULL_MASK, x.la, d);
    r.lb = __shfl_up_sync(FULL_MASK, x.lb, d);
    return r;
}

template <bool FULL>
struct PairOp {
    __device__ __forceinline__ Pair operator()(Pair x, Pair y) const {
        const SegOp<FULL> op;
        Pair r;
        r.a = op(x.a, y.a);
        r.b = op(x.b, y.b);
        r.la = x.la + y.la;
        r.lb = x.lb + y.lb;
        return r;
    }
};

// Rows i .. i+3 of a column (0 past N); one 16-byte load when aligned.
__device__ __forceinline__ uint4 load4(const uint32_t* col, long long i, long long N, bool al) {
    if (al && i + 3 < N) return *reinterpret_cast<const uint4*>(col + i);
    uint4 r;
    r.x = i < N ? col[i] : 0u;
    r.y = i + 1 < N ? col[i + 1] : 0u;
    r.z = i + 2 < N ? col[i + 2] : 0u;
    r.w = i + 3 < N ? col[i + 3] : 0u;
    return r;
}

// Bits 0-3: row j of x differs from its predecessor (p for row 0) under m.
__device__ __forceinline__ uint32_t diff4(uint32_t p, uint4 x, uint32_t m) {
    return (((x.x ^ p) & m) ? 1u : 0u) | (((x.y ^ x.x) & m) ? 2u : 0u) |
           (((x.z ^ x.y) & m) ? 4u : 0u) | (((x.w ^ x.z) & m) ? 8u : 0u);
}

// Bits 0-3: row j of x is all-ones once the bits ``o`` are set.
__device__ __forceinline__ uint32_t ones4(uint4 x, uint32_t o) {
    return ((x.x | o) == 0xffffffffu ? 1u : 0u) | ((x.y | o) == 0xffffffffu ? 2u : 0u) |
           ((x.z | o) == 0xffffffffu ? 4u : 0u) | ((x.w | o) == 0xffffffffu ? 8u : 0u);
}

template <bool FULL>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(Rows r, unsigned long long* st_seg, unsigned long long* st_cnt,
              unsigned int* ticket, long long* total, long long nt,
              uint32_t* __restrict__ out, long long ld, long long out_len) {
    __shared__ long long s_tile, s_off, s_carry;
    __shared__ uint8_t s_first[THREADS];    // diff bits of each thread's first row per half
    __shared__ uint16_t s_idx[TILE];        // live rows in rank order (tile-local index)
    __shared__ uint32_t s_val[TILE];        // their run value in the tile | flag << 31
    const SegOp<FULL> op;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = s_tile;
    const long long T0 = tile * TILE;
    const long long N = r.N;
    const long long iA = T0 + 4 * tid, iB = iA + HALF;   // first rows of this thread's halves

    // 1. one read of every column: per-row "differs from its predecessor"
    //    (bits 0-3: half A, 4-7: half B) and "all-ones" bits; thread 255
    //    also compares the tile's successor row with the tile's last
    uint32_t dm = 0, sm = 0xffu, dnext = 0;
    for (int w = 0; w < r.W; ++w) {
        const uint32_t* col = r.keys + (long long)w * N;
        const uint32_t m = w == r.W - 1 ? ~r.cmask : 0xffffffffu;
        const bool al = (reinterpret_cast<uintptr_t>(col) & 15) == 0;
        const uint4 a = load4(col, iA, N, al), b = load4(col, iB, N, al);
        uint32_t pa = __shfl_up_sync(FULL_MASK, a.w, 1), pb = __shfl_up_sync(FULL_MASK, b.w, 1);
        if (lane == 0) {
            pa = iA > 0 && iA <= N ? col[iA - 1] : 0u;
            pb = iB <= N ? col[iB - 1] : 0u;
        }
        dm |= diff4(pa, a, m) | (diff4(pb, b, m) << 4);
        sm &= ones4(a, ~m) | (ones4(b, ~m) << 4);
        if (tid == THREADS - 1 && iB + 4 < N) dnext |= ((col[iB + 4] ^ b.w) & m) ? 1u : 0u;
    }
    // the stream's first row starts a segment; rows at or past N do too,
    // so row N-1 is the last of its segment
    if (iA == 0) dm |= 1u;
    for (int j = 0; j < 4; ++j) {
        if (iA + j >= N) dm |= 1u << j;
        if (iB + j >= N) dm |= 16u << j;
    }
    if (T0 + TILE >= N) dnext = 1u;
    s_first[tid] = (uint8_t)((dm & 1u) | ((dm >> 3) & 2u));
    __syncthreads();

    // 2. last-of-segment bits: row i is last when row i+1 starts one
    const uint32_t nxt = tid + 1 < THREADS ? s_first[tid + 1] : 0u;
    const uint32_t succA = tid + 1 < THREADS ? (nxt & 1u) : ((s_first[0] >> 1) & 1u);
    const uint32_t succB = tid + 1 < THREADS ? ((nxt >> 1) & 1u) : dnext;
    const uint32_t last = ((dm >> 1) & 0x77u) | (succA << 3) | (succB << 7);
    uint32_t live = last & ~sm;
    for (int j = 0; j < 4; ++j) {
        if (iA + j >= N) live &= ~(1u << j);
        if (iB + j >= N) live &= ~(16u << j);
    }

    // 3. per-row segmented values; the thread's aggregate per half
    uint4 ca = make_uint4(1u, 1u, 1u, 1u), cb = ca;
    if (FULL) {
        const uint32_t* cc = reinterpret_cast<const uint32_t*>(r.cnt);
        const bool al = (reinterpret_cast<uintptr_t>(cc) & 15) == 0;
        ca = load4(cc, iA, N, al);
        cb = load4(cc, iB, N, al);
    }
    uint32_t v[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    Pair mine = {{0u, 0u}, {0u, 0u}, (uint32_t)__popc(live & 0xfu), (uint32_t)__popc(live >> 4)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (FULL) v[j] = clamp_count(v[j]);
        const Seg e = {(dm >> j) & 1u, v[j]};
        if (j < 4) mine.a = op(mine.a, e);
        else mine.b = op(mine.b, e);
    }
    Pair tot;
    const Pair id = {{0u, 0u}, {0u, 0u}, 0u, 0u};
    const Pair ex = block_excl_scan(mine, id, PairOp<FULL>(), tot);
    const Seg agg = op(tot.a, tot.b);
    const long long n_live = (long long)tot.la + tot.lb;
    if (tid == 0) {
        publish(st_seg, tile, seg_pack(agg), 0LL);
        publish(st_cnt, tile, n_live, 0LL);
    }

    // 4. list the live rows in rank order with their run value in the tile
    Seg run = ex.a;
    uint32_t rank = ex.la;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (j == 4) {
            run = op(tot.a, ex.b);
            rank = tot.la + ex.lb;
        }
        run = op(run, Seg{(dm >> j) & 1u, v[j]});
        if ((live >> j) & 1u) {
            s_idx[rank] = (uint16_t)((j < 4 ? 0 : HALF) + 4 * tid + (j & 3));
            s_val[rank] = run.v | (run.f ? 0x80000000u : 0u);
            ++rank;
        }
    }

    // 5. the carry into the tile (warp 0, in tile order) and its first
    //    record (warp 1); the last tile has the total
    if (tid < 32) {
        const long long c = resolve<true>(st_seg, tile, seg_pack(agg), PackedSegOp<FULL>(), 0LL,
                                          0LL);
        if (tid == 0) s_carry = c;
    } else if (tid < 64) {
        const long long off = resolve(st_cnt, tile, n_live, SumOp(), 0LL, 0LL);
        if (tid == 32) {
            s_off = off;
            if (tile == nt - 1) *total = off + n_live;
        }
    }
    __syncthreads();

    // 6. write the records column by column, each column one contiguous run
    const long long off = s_off;
    const long long nw = n_live < out_len - off ? n_live : (out_len > off ? out_len - off : 0);
    for (int w = 0; w < r.W; ++w) {
        const uint32_t* col = r.keys + (long long)w * N + T0;
        const uint32_t m = w == r.W - 1 ? ~r.cmask : 0xffffffffu;
        uint32_t* o = out + (long long)w * ld + off;
        for (int i = tid; i < nw; i += THREADS) o[i] = col[s_idx[i]] & m;
    }
    const Seg carry = seg_unpack(s_carry);
    const uint32_t* clast = r.keys + (long long)(r.W - 1) * N + T0;
    uint32_t* o = out + (long long)r.W * ld + off;
    for (int i = tid; i < nw; i += THREADS) {
        const uint32_t e = s_val[i];
        const Seg loc = {e >> 31, e & 0x7fffffffu};
        const uint32_t len = op(carry, loc).v;
        o[i] = FULL ? clamp_count(len) : clamp_count((clast[s_idx[i]] & r.cmask) + (len - 1u));
    }
}

// Scratch int64 words for N rows: the ticket, the total, and two status
// words per tile.
inline long long scratch_words(long long N) {
    return 2 + 2 * ((N + TILE - 1) / TILE);
}

template <bool FULL>
int run(const Rows& r, uint32_t* out, long long ld, long long out_len, void* scratch, int* nd,
        cudaStream_t s) {
    const long long nt = (r.N + TILE - 1) / TILE;
    long long* sc = static_cast<long long*>(scratch);
    unsigned int* ticket = reinterpret_cast<unsigned int*>(sc);
    long long* total = sc + 1;
    unsigned long long* st_seg = reinterpret_cast<unsigned long long*>(sc + 2);
    unsigned long long* st_cnt = st_seg + nt;
    cudaError_t e;
    if ((e = cudaMemsetAsync(scratch, 0, 8 * (size_t)scratch_words(r.N), s)) != cudaSuccess)
        return (int)e;
    if (nt > 0) {
        segsum_kernel<FULL><<<(unsigned)nt, THREADS, 0, s>>>(r, st_seg, st_cnt, ticket, total, nt,
                                                            out, ld, out_len);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    fill_tail_kernel<<<fill_blocks(out_len, 256), 256, 0, s>>>(out, r.W + 1, ld, out_len,
                                                              total, r.W, nd);
    return (int)cudaGetLastError();
}

}  // namespace k2

using namespace k2;

// Scratch (int64 words) the wrapper allocates for N rows.
extern "C" long long kt_segsum_compact_scratch(long long N) {
    return scratch_words(N);
}

// keys: W u32 columns of stride N, sorted lexicographically.  Embedded
// mode (full_sum == 0): the count is the last word's low ``ebits``.
// full_sum mode: cnt is the int32 count column and ebits == 0.  out: W+1
// u32 columns of stride ld >= out_len (keys, then the count).  scratch:
// kt_segsum_compact_scratch(N) int64s.  nd: int32 [2] = [nd_exact,
// nd_used].  Returns a cudaError_t.
extern "C" int kt_segsum_compact(const void* keys, const void* cnt, long long N, int W,
                                 int ebits, int full_sum, void* out, long long ld, long long out_len,
                                 void* scratch, void* nd, void* stream) {
    if (W < 1 || N < 0 || ld < out_len || out_len < 0 || ebits < 0 || ebits > 31 ||
        (full_sum ? ebits != 0 : ebits == 0))
        return (int)cudaErrorInvalidValue;
    Rows r;
    r.keys = static_cast<const uint32_t*>(keys);
    r.cnt = static_cast<const int32_t*>(cnt);
    r.N = N;
    r.W = W;
    r.cmask = full_sum ? 0u : ((1u << ebits) - 1u);
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* o = static_cast<uint32_t*>(out);
    int* ndp = static_cast<int*>(nd);
    return full_sum ? run<true>(r, o, ld, out_len, scratch, ndp, s)
                    : run<false>(r, o, ld, out_len, scratch, ndp, s);
}
