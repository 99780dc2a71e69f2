// K1: dense super-k-mer run segmentation (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas (kernel
// body _skm_dense_kernel, front half _seg_rows_block).  The segmentation
// (skm_seg.cuh, shared with K5) gives every window's run starts; every
// live (valid) start's row of Wc content words plus the meta word is
// written densely, in stream order, to Wc+1 u32 columns.
//
// What bounds it on the H100: the input is one u32 code per position
// (256 MB at n = 2^26) and the output ~n/12 rows of Wc+1 words, so the
// kernel moves little memory; the work is the per-window minimizer and
// validity windows (~k-15 and k reads each), done from shared memory.
// The TPU grid carried the row cursor in SMEM from block to block; here
// it is an exclusive sum-scan over tiles (passes 1-4 below, then the
// emit pass).  The TPU's 128-lane residual staging is not carried over;
// rows_used == rows_exact.  Nothing is written at or past ``cap``;
// rows_used > cap tells the caller to replay with a larger capacity.
#include "skm_seg.cuh"

namespace k1 {

using namespace kseg;

// (Pass 1, tile_true_starts, is in skm_seg.cuh.)

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
        write_live_row(g, t, v, x, out, ld, pos);
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
    const void* ks[3] = {(const void*)tile_true_starts, (const void*)tile_live_counts,
                         (const void*)emit_rows};
    int err = set_smem(ks, 3, sm);
    if (err) return err;
    cudaError_t e;
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
