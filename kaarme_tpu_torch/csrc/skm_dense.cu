// K1: dense super-k-mer run segmentation from the transfer chunk (CUDA
// C++, sm_90a), in one pass over the stream.
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas (kernel
// body _skm_dense_kernel, front half _seg_rows_block), together with the
// unpack in front of it (ops/sortcount.py::codes_from_chunk).  The
// segmentation (m-words, validity, minimizers, run starts, the chained
// last TRUE start) is the one-pass front half in skm_seg.cuh, which K5
// shares.  K1's own part: at each live (valid, below n) start, the row
// of Wc span-masked content words plus the meta word (ell-1) << 26 | 1,
// front-packed in stream order.
//
// What bounds it on the H100: bytes.  It reads n/4 bytes of packed bases
// plus the separators (~19 MB at n = 2^26) and writes every row of the
// Wc+1 columns (201 MB at cap = 2^23), so the card could do it in ~0.07
// ms; the work per window is a few dozen integer operations.  The TPU
// grid carried the row cursor from block to block in SMEM; here it is a
// second chained scan across tiles by decoupled look-back (scan.cuh): a
// tile publishes its live-row count as soon as its starts are marked,
// lists its live rows in shared memory in rank order, and only then
// looks back for its row offset, so the wait hides behind the listing.
// The rows are written column by column, each column one contiguous run.
// Nothing is written at or past ``cap``; rows_used > cap tells the
// caller to replay with a larger capacity.  The sentinel fill past
// rows_used is a grid-stride kernel after it.  32 registers per thread,
// 8 blocks of 256 threads per SM (ptxas -v, PERF.md section 6).
#include "skm_seg.cuh"

namespace k1 {

using namespace kseg;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
skm_rows_kernel(const uint32_t* __restrict__ packed, long long npk,
                const uint32_t* __restrict__ bitmap, long long nbm, Geo g,
                unsigned long long* st_lts, unsigned long long* st_cnt,
                unsigned int* ticket, long long* total, long long nt,
                uint32_t* __restrict__ out, long long cap, long long ld) {
    __shared__ long long s_tile, s_off;
    const Smem s = carve(g);
    const int tid = threadIdx.x;
    if (tid == 0) s_tile = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = s_tile;
    const long long base = tile * TILE - 1;     // window of index 0
    const int v0 = 1 + tid * ITEMS;

    // 1-6. the segmentation (skm_seg.cuh)
    long long live, starts;
    segment_chunk_tile(packed, npk, bitmap, nbm, g, s, tile, st_lts, live, starts);
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
        s.lst[rank++] = (uint32_t)v | ((uint32_t)ell_at(s, v) << 16);
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
            col[r] = row_word(g, s, c, (int)(e & 0xffffu), (int)(e >> 16));
        }
    }
}

}  // namespace k1

using namespace k1;

// Scratch (int64 words) the wrapper allocates: ticket, total, two status
// words per tile.
extern "C" long long kt_skm_dense_scratch(long long n) {
    const long long nt = (n + TILE - 1) / TILE;
    return 2 + 2 * nt;
}

// packed: u32 [npk] 2-bit bases, npk >= ceil(L / 16) with L = n + k - 1.
// sep: the invalid positions, a u32 bitmap of nsep >= ceil(L / 32) words.
// out: Wc+1 u32 columns of stride ld >= cap; rows [0, cap) are written,
// sentinels from rows_used on.  scratch: kt_skm_dense_scratch int64s.
// rows: int32 [2] = [rows_exact, rows_used].  Returns a cudaError_t.
extern "C" int kt_skm_dense(const void* packed, long long npk, const void* sep, long long nsep,
                            long long n, int k, void* out, long long cap, long long ld,
                            void* scratch, void* rows, void* stream) {
    const long long L = n + k - 1;
    if (k < M || n < 1 || npk * 16 < L || nsep * 32 < L || cap < 0 || ld < cap)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Geo g = make_geo(k, L, n);
    const long long nt = (n + TILE - 1) / TILE;
    long long* sc = static_cast<long long*>(scratch);
    unsigned int* ticket = reinterpret_cast<unsigned int*>(sc);
    long long* total = sc + 1;
    unsigned long long* st_lts = reinterpret_cast<unsigned long long*>(sc + 2);
    unsigned long long* st_cnt = st_lts + nt;
    cudaError_t e;
    const size_t zero = 8 * (size_t)kt_skm_dense_scratch(n);
    if ((e = cudaMemsetAsync(scratch, 0, zero, s)) != cudaSuccess) return (int)e;
    int err = set_smem((const void*)skm_rows_kernel, g);
    if (err) return err;
    uint32_t* o = static_cast<uint32_t*>(out);
    skm_rows_kernel<<<(unsigned)nt, THREADS, smem_bytes(g), s>>>(
        static_cast<const uint32_t*>(packed), npk, static_cast<const uint32_t*>(sep), nsep, g,
        st_lts, st_cnt, ticket, total, nt, o, cap, ld);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fill_tail_kernel<<<fill_blocks(cap, 256), 256, 0, s>>>(o, g.Wc + 1, ld, cap, total, -1,
                                                          static_cast<int*>(rows));
    return (int)cudaGetLastError();
}
