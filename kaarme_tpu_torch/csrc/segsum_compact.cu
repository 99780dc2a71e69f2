// K2: fused segment-sum + compaction over sorted rows (CUDA C++, sm_90a).
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
// nd_used == nd_exact.
//
// What bounds it on the H100: it is a streaming pass over N rows of W
// key words (plus a count), reading each word a few times and writing
// ~nd rows, so it is memory-bound; at the merge's shape it moves a few
// hundred MB.  Design: three passes over tiles of 2048 rows.  Each row
// compares itself with its successor to decide "last of segment", so
// the TPU's lagged decision and its required trailing sentinel row are
// gone.  The per-segment length (embedded) and the clamped running sum
// (full_sum) are one segmented scan whose combine restarts at a segment
// start; the clamped add is associative, so a tree scan across threads
// and tiles gives the reference's numbers.  The output cursor is an
// exclusive sum-scan of live segments per tile.
#include "scan.cuh"

namespace k2 {

using namespace kt;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;   // rows per block

struct Rows {
    const uint32_t* keys;   // W columns, stride N
    const int32_t* cnt;     // full_sum count column (nullptr when embedded)
    long long N;
    int W;
    uint32_t cmask;         // count bits of the last key word (embedded)
};

__device__ __forceinline__ uint32_t key_word(const Rows& r, int w, long long i) {
    uint32_t x = r.keys[(long long)w * r.N + i];
    return w == r.W - 1 ? (x & ~r.cmask) : x;
}

__device__ __forceinline__ bool same_key(const Rows& r, long long i, long long j) {
    for (int w = 0; w < r.W; ++w)
        if (key_word(r, w, i) != key_word(r, w, j)) return false;
    return true;
}

__device__ __forceinline__ bool is_sentinel(const Rows& r, long long i) {
    uint32_t acc = r.keys[(long long)(r.W - 1) * r.N + i] | r.cmask;
    for (int w = 0; w < r.W - 1; ++w) acc &= r.keys[(long long)w * r.N + i];
    return acc == 0xffffffffu;
}

template <bool FULL>
__device__ __forceinline__ Seg row_seg(const Rows& r, long long i) {
    Seg s;
    s.f = (i == 0 || !same_key(r, i, i - 1)) ? 1u : 0u;
    s.v = FULL ? clamp_count((uint32_t)r.cnt[i]) : 1u;
    return s;
}

__device__ __forceinline__ bool row_alive(const Rows& r, long long i) {
    bool last = (i == r.N - 1) || !same_key(r, i, i + 1);
    return last && !is_sentinel(r, i);
}

// Pass 1: per tile, the segmented-scan aggregate and the live count.
template <bool FULL>
__global__ void __launch_bounds__(THREADS)
tile_aggregates(Rows r, Seg* tile_seg, long long* tile_live) {
    const SegOp<FULL> op;
    const Seg id = {0u, 0u};
    const long long s0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
    Seg agg = id;
    long long live = 0;
    for (int j = 0; j < ITEMS; ++j) {
        long long i = s0 + j;
        if (i >= r.N) break;
        agg = op(agg, row_seg<FULL>(r, i));
        live += row_alive(r, i) ? 1 : 0;
    }
    Seg stot;
    block_excl_scan(agg, id, op, stot);
    long long ltot;
    block_excl_scan(live, 0LL, SumOp(), ltot);
    if (threadIdx.x == 0) {
        tile_seg[blockIdx.x] = stot;
        tile_live[blockIdx.x] = ltot;
    }
}

// Pass 3: write one record per live segment at its compacted position.
template <bool FULL>
__global__ void __launch_bounds__(THREADS)
emit_records(Rows r, const Seg* seg_in, const long long* live_off,
             uint32_t* __restrict__ out, long long ld, long long out_len) {
    const SegOp<FULL> op;
    const Seg id = {0u, 0u};
    const long long s0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
    Seg agg = id;
    long long live = 0;
    for (int j = 0; j < ITEMS; ++j) {
        long long i = s0 + j;
        if (i >= r.N) break;
        agg = op(agg, row_seg<FULL>(r, i));
        live += row_alive(r, i) ? 1 : 0;
    }
    Seg stot;
    Seg run = op(seg_in[blockIdx.x], block_excl_scan(agg, id, op, stot));
    long long ltot;
    long long pos = live_off[blockIdx.x] + block_excl_scan(live, 0LL, SumOp(), ltot);
    for (int j = 0; j < ITEMS; ++j) {
        long long i = s0 + j;
        if (i >= r.N) break;
        run = op(run, row_seg<FULL>(r, i));
        if (!row_alive(r, i)) continue;
        if (pos < out_len) {
            uint32_t total;
            if (FULL) {
                total = clamp_count(run.v);
            } else {
                uint32_t c_last = r.keys[(long long)(r.W - 1) * r.N + i] & r.cmask;
                total = clamp_count(c_last + (run.v - 1u));
            }
            for (int w = 0; w < r.W; ++w) out[(long long)w * ld + pos] = key_word(r, w, i);
            out[(long long)r.W * ld + pos] = total;
        }
        ++pos;
    }
}

template <bool FULL>
int run(Rows r, uint32_t* out, long long ld, long long out_len, void* scratch, int* nd,
        cudaStream_t s) {
    const long long nt = (r.N + TILE - 1) / TILE;
    Seg* seg = static_cast<Seg*>(scratch);                       // nt x 8 bytes
    long long* live = reinterpret_cast<long long*>(seg + nt);   // nt
    long long* total = live + nt;                                // 1
    const Seg id = {0u, 0u};
    cudaError_t e;
    if (nt > 0) {
        tile_aggregates<FULL><<<(unsigned)nt, THREADS, 0, s>>>(r, seg, live);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    scan_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(seg, nt, id, SegOp<FULL>(), (Seg*)nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scan_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(live, nt, 0LL, SumOp(), total);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (nt > 0) {
        emit_records<FULL><<<(unsigned)nt, THREADS, 0, s>>>(r, seg, live, out, ld, out_len);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    fill_tail_kernel<<<fill_blocks(out_len, 256), 256, 0, s>>>(out, r.W + 1, ld, out_len,
                                                              total, r.W, nd);
    return (int)cudaGetLastError();
}

}  // namespace k2

using namespace k2;

// keys: W u32 columns of stride N, sorted lexicographically.  Embedded
// mode (full_sum == 0): the count is the last word's low ``ebits``.
// full_sum mode: cnt is the int32 count column and ebits == 0.  out: W+1 u32 columns of
// stride ld >= out_len (keys, then the count).  scratch: 16 * nt + 8
// bytes with nt = ceil(N / 2048).  nd: int32 [2] = [nd_exact, nd_used].
// Returns a cudaError_t.
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
