// K5: slotted super-k-mer run segmentation from the transfer chunk (CUDA
// C++, sm_90a), in one pass over the stream.
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_slotted_pallas (kernel
// body _skm_kernel, front half _seg_rows_block), together with the
// unpack in front of it (ops/sortcount.py::codes_from_chunk).  The
// segmentation is K1's one-pass front half (skm_seg.cuh), read from the
// same chunk; what differs is where the rows land.  The stream's windows
// fall into slot tiles of 512, numbered from the first window, and tile
// t owns S output rows t*S .. t*S + S-1.  Slot s of tile t gets the row
// of the (s+1)-th run start in the tile: every start below n counts,
// dead (invalid) ones too, and a dead start's row is all-ones, a
// sentinel.  Slots past the tile's start count are all-ones; starts with
// an ordinal >= S are dropped, and max_tile_runs (the most starts in any
// tile) > S tells the caller to replay with a larger S.  Bit-identical
// to the reference's run_rows + pack_slots where n is a multiple of 512;
// any n >= 1 is taken, the last tile then being partial (windows at or
// past n are starts for the segmentation, but never get a slot).
//
// What bounds it on the H100: bytes.  It reads the chunk (~19 MB at n =
// 2^26) and writes every slot row, (n/512)*S rows of Wc+1 words (302 MB
// at k = 51, S = 96), so the card could do it in ~0.1 ms.  The design is
// K1's: one pass, O(1) work per window, the last TRUE start chained
// across tiles by decoupled look-back.  A 2048-window tile is exactly
// four slot tiles, so the block owns output rows [4*tile*S,
// 4*(tile+1)*S) outright and needs no row look-back: a block scan of its
// threads' start counts gives every start its ordinal in its slot tile
// (64 threads per slot tile), the kept live starts are listed by slot in
// shared memory (at most 4S <= 2048 entries, in K1's list area), and the
// rows are written column by column, each column one contiguous run of
// 4S rows with the empty and dead slots as sentinels.  max_tile_runs is
// an atomicMax per block.  32 registers per thread, 8 blocks of 256
// threads per SM (ptxas -v, PERF.md section 6).
#include "skm_seg.cuh"

namespace k5 {

using namespace kseg;

constexpr int SLOT_TILE = 512;                 // windows per slot tile
constexpr int QUADS = TILE / SLOT_TILE;        // slot tiles per tile
constexpr int TT = SLOT_TILE / ITEMS;          // threads per slot tile
static_assert(TILE == 4 * SLOT_TILE, "a 2048-window tile is exactly four slot tiles");
constexpr uint32_t EMPTY = 0xffffffffu;        // list entry of an empty or dead slot

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
skm_slotted_kernel(const uint32_t* __restrict__ packed, long long npk,
                   const uint32_t* __restrict__ bitmap, long long nbm, Geo g,
                   unsigned long long* st_lts, unsigned int* ticket, int S, long long n_tiles,
                   uint32_t* __restrict__ out, long long ld, int* maxruns) {
    __shared__ long long s_tile;
    __shared__ int s_base[QUADS + 1];
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

    // 7. every start's ordinal in its slot tile; the list starts empty
    //    (the minimizers in P were read before segment_chunk_tile's last barrier)
    long long n_starts;
    const long long pre = block_excl_scan(starts, 0LL, SumOp(), n_starts);
    if (tid % TT == 0) s_base[tid / TT] = (int)pre;
    if (tid == 0) s_base[QUADS] = (int)n_starts;
    for (int r = tid; r < QUADS * S; r += THREADS) s.lst[r] = EMPTY;
    __syncthreads();

    // 8. list the kept live starts by slot (tile-local window | ell << 16)
    const int q = tid / TT;
    int slot = (int)pre - s_base[q];
    for (int j = 0; j < ITEMS; ++j) {
        const int v = v0 + j;
        const uint8_t f = s.flags[v];
        if (!((f & F_START) && base + v < g.n)) continue;
        const int sl = slot++;
        if (sl < S && (f & F_VALID))
            s.lst[q * S + sl] = (uint32_t)v | ((uint32_t)ell_at(s, v) << 16);
    }
    if (tid == 0) {
        int most = 0;
        for (int i = 0; i < QUADS; ++i) most = max(most, s_base[i + 1] - s_base[i]);
        atomicMax(maxruns, most);
    }
    __syncthreads();

    // 9. write the block's slot rows column by column (the last tile's
    //    rows stop at the stream's last slot tile)
    const long long r0 = tile * QUADS * S;
    const long long rows_left = n_tiles * S - r0;
    const int nr = rows_left < QUADS * S ? (int)rows_left : QUADS * S;
    for (int c = 0; c <= g.Wc; ++c) {
        uint32_t* col = out + (long long)c * ld + r0;
        for (int r = tid; r < nr; r += THREADS) {
            const uint32_t e = s.lst[r];
            col[r] = e == EMPTY ? 0xffffffffu
                                : row_word(g, s, c, (int)(e & 0xffffu), (int)(e >> 16));
        }
    }
}

}  // namespace k5

using namespace k5;

// Scratch (int64 words) the wrapper allocates: the ticket, one status
// word per tile.
extern "C" long long kt_skm_slotted_scratch(long long n) {
    const long long nt = (n + TILE - 1) / TILE;
    return 1 + nt;
}

// packed, sep: the transfer chunk, as kt_skm_dense takes it (L =
// n + k - 1).  1 <= S <= 512.  out: Wc+1 u32 columns of stride ld >=
// ceil(n / 512) * S, every row of which is written.  scratch:
// kt_skm_slotted_scratch int64s.  maxruns: int32 [1], the most run
// starts in any slot tile.  Returns a cudaError_t.
extern "C" int kt_skm_slotted(const void* packed, long long npk, const void* sep, long long nsep,
                              long long n, int k, int S, void* out, long long ld, void* scratch,
                              void* maxruns, void* stream) {
    const long long L = n + k - 1;
    const long long n_tiles = (n + SLOT_TILE - 1) / SLOT_TILE;
    if (k < M || n < 1 || npk * 16 < L || nsep * 32 < L || S < 1 || S > SLOT_TILE ||
        ld < n_tiles * S)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Geo g = make_geo(k, L, n);
    const long long nt = (n + TILE - 1) / TILE;
    long long* sc = static_cast<long long*>(scratch);
    unsigned int* ticket = reinterpret_cast<unsigned int*>(sc);
    unsigned long long* st_lts = reinterpret_cast<unsigned long long*>(sc + 1);
    int* mr = static_cast<int*>(maxruns);
    cudaError_t e;
    const size_t zero = 8 * (size_t)kt_skm_slotted_scratch(n);
    if ((e = cudaMemsetAsync(scratch, 0, zero, s)) != cudaSuccess) return (int)e;
    if ((e = cudaMemsetAsync(mr, 0, sizeof(int), s)) != cudaSuccess) return (int)e;
    int err = set_smem((const void*)skm_slotted_kernel, g);
    if (err) return err;
    skm_slotted_kernel<<<(unsigned)nt, THREADS, smem_bytes(g), s>>>(
        static_cast<const uint32_t*>(packed), npk, static_cast<const uint32_t*>(sep), nsep, g,
        st_lts, ticket, S, n_tiles, static_cast<uint32_t*>(out), ld, mr);
    return (int)cudaGetLastError();
}
