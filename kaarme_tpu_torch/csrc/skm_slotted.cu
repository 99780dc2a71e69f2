// K5: slotted super-k-mer run segmentation (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_skm.py::run_rows_slotted_pallas (kernel
// body _skm_kernel, front half _seg_rows_block).  The segmentation is
// K1's (skm_seg.cuh); what differs is where the rows land.  The stream's
// windows fall into slot tiles of 512, numbered from the first window,
// and tile t owns S output rows t*S .. t*S + S-1.  Slot s of tile t gets
// the row of the (s+1)-th run start in the tile: every start counts,
// dead (invalid) ones too, and a dead start's row is all-ones, a
// sentinel.  Slots past the tile's start count are all-ones; starts with
// an ordinal >= S are dropped, and max_tile_runs (the most starts in any
// tile) > S tells the caller to replay with a larger S.  Bit-identical
// to the reference's run_rows + pack_slots where n is a multiple of 512;
// any n >= 1 is taken, the last tile then being partial (no window at or
// past n is a start).
//
// What bounds it on the H100: the segmentation, as in K1 (the codes are
// read once, the sliding windows come from shared memory); the output is
// (n/512)*S rows, ~n/5 at S = 96.  The TPU kernel front-packed each
// tile's start rows with a two-stage log-shift compaction; here one
// block covers two whole slot tiles, so a block-level exclusive scan of
// the start flags gives each start its slot ordinal directly, and the
// block writes every row of its tiles (start rows, then sentinels) with
// no cross-block cursor.  The last true start before a block is K1's
// exclusive max-scan over tiles; max_tile_runs is an atomicMax.
#include "skm_seg.cuh"

namespace k5 {

using namespace kseg;

constexpr int SLOT_TILE = 512;                 // windows per slot tile
constexpr int TILES = TILE / SLOT_TILE;        // slot tiles per block
constexpr int TT = SLOT_TILE / ITEMS;          // threads per slot tile
static_assert(TILE % SLOT_TILE == 0, "a block covers whole slot tiles");

// (Pass 1, tile_true_starts, is in skm_seg.cuh.)

// Pass 2: each block writes all S rows of each of its slot tiles.
__global__ void __launch_bounds__(THREADS)
emit_slotted(const uint32_t* __restrict__ codes, Geo g, const long long* lts_in, int S,
             long long n_tiles, uint32_t* __restrict__ out, long long ld, int* maxruns) {
    __shared__ long long tile_base[TILES + 1];
    Tile t = carve(g);
    const long long T0 = (long long)blockIdx.x * TILE;
    segment_tile(codes, g, T0, t);
    mark_starts(g, T0, lts_in[blockIdx.x], t);
    const int t0 = threadIdx.x * ITEMS;
    long long cnt = 0;
    for (int j = 0; j < ITEMS; ++j) {
        if (T0 + t0 + j < g.n && (t.flags[t0 + j + 1] & F_START)) ++cnt;
    }
    long long tot;
    const long long pre = block_excl_scan(cnt, 0LL, SumOp(), tot);
    if (threadIdx.x % TT == 0) tile_base[threadIdx.x / TT] = pre;
    if (threadIdx.x == 0) tile_base[TILES] = tot;
    __syncthreads();

    const int lt = threadIdx.x / TT;
    const long long tile = T0 / SLOT_TILE + lt;
    long long slot = pre - tile_base[lt];
    const int ncols = g.Wc + 1;
    for (int j = 0; j < ITEMS; ++j) {
        const int v = t0 + j + 1;
        const long long x = T0 + t0 + j;
        const uint8_t f = t.flags[v];
        if (!(x < g.n && (f & F_START))) continue;
        const long long s = slot++;
        if (s >= S) continue;
        const long long pos = tile * S + s;
        if (f & F_VALID) {
            write_live_row(g, t, v, x, out, ld, pos);
        } else {
            for (int c = 0; c < ncols; ++c) out[(long long)c * ld + pos] = 0xffffffffu;
        }
    }

    long long most = 0;
    for (int i = 0; i < TILES; ++i) {
        const long long tl = T0 / SLOT_TILE + i;
        if (tl >= n_tiles) break;
        const long long runs = tile_base[i + 1] - tile_base[i];
        most = runs > most ? runs : most;
        for (long long s = runs + threadIdx.x; s < S; s += blockDim.x)
            for (int c = 0; c < ncols; ++c) out[(long long)c * ld + tl * S + s] = 0xffffffffu;
    }
    if (threadIdx.x == 0) atomicMax(maxruns, (int)most);
}

}  // namespace k5

using namespace k5;

// codes: u32 [L] (bits 0-1 base, bit 2 invalid), L >= n + k - 1; 1 <= S
// <= 512.  out: Wc+1 u32 columns of stride ld >= ceil(n / 512) * S, every
// row of which is written.  scratch: int64 [ceil(n / 1024)].  maxruns:
// int32 [1], the most run starts in any slot tile.  Returns a cudaError_t.
extern "C" int kt_skm_slotted(const void* codes, long long L, long long n, int k, int S,
                              void* out, long long ld, void* scratch, void* maxruns,
                              void* stream) {
    const long long n_tiles = (n + SLOT_TILE - 1) / SLOT_TILE;
    if (k < M || n < 1 || L < n + k - 1 || S < 1 || S > SLOT_TILE || ld < n_tiles * S)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    Geo g = make_geo(k, L, n);
    size_t sm = smem_bytes(g);
    const void* ks[2] = {(const void*)tile_true_starts, (const void*)emit_slotted};
    int err = set_smem(ks, 2, sm);
    if (err) return err;
    cudaError_t e;
    const long long nt = (n + TILE - 1) / TILE;
    long long* lts = static_cast<long long*>(scratch);
    const uint32_t* c = static_cast<const uint32_t*>(codes);
    int* mr = static_cast<int*>(maxruns);

    if ((e = cudaMemsetAsync(mr, 0, sizeof(int), s)) != cudaSuccess) return (int)e;
    tile_true_starts<<<(unsigned)nt, THREADS, sm, s>>>(c, g, lts);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scan_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(lts, nt, -1LL, MaxOp(), (long long*)nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    emit_slotted<<<(unsigned)nt, THREADS, sm, s>>>(c, g, lts, S, n_tiles,
                                                   static_cast<uint32_t*>(out), ld, mr);
    return (int)cudaGetLastError();
}
