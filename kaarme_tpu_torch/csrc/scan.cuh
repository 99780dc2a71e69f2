// Scan helpers shared by the kernels of this package: block scans, the
// clamped segmented sum, and chained scans across tiles by decoupled
// look-back.
//
// Replaces nothing on its own: the TPU kernels it serves
// (kaarme_tpu/ops/pallas_skm.py::_skm_dense_kernel and _skm_kernel,
// kaarme_tpu/ops/pallas_compact.py::_compact_kernel) kept their
// cross-block carries in SMEM across a sequential grid.  On Hopper the
// blocks run in no order, so each carry becomes a chained scan over
// tiles in ONE kernel (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back"): a tile takes its index from an atomic
// ticket, so every tile it waits on is already running; it publishes its
// own aggregate in a status word as soon as it has it, and one warp
// looks back over its predecessors' words, 32 at a time, until it meets
// one that holds an inclusive prefix.  What bounds it on the H100 is the
// latency of that chain (a few hundred cycles per hop), not bytes: a
// tile that publishes early lets its successors stop early.  Each status
// word holds a flag (2 bits) and the value (62 bits), written by one
// 64-bit store, so no reader sees half of it.  The look-back runs in the
// kernel that includes it, so its registers are the kernel's (noted at
// the top of each kernel source); the one kernel of this header, the
// sentinel fill (fill_tail_kernel, a grid-stride store bound by bytes),
// uses 28 registers per thread (ptxas -v, sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kt {

constexpr unsigned FULL_MASK = 0xffffffffu;

// Segmented-scan element: f = "a segment starts inside this span",
// v = running value since the last start.
struct Seg {
    uint32_t f;
    uint32_t v;
};

__device__ __forceinline__ long long shfl_up(long long x, int d) {
    return __shfl_up_sync(FULL_MASK, x, d);
}

__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
    Seg r;
    r.f = __shfl_up_sync(FULL_MASK, x.f, d);
    r.v = __shfl_up_sync(FULL_MASK, x.v, d);
    return r;
}

struct SumOp {
    __device__ __forceinline__ long long operator()(long long a, long long b) const {
        return a + b;
    }
};

struct MaxOp {
    __device__ __forceinline__ long long operator()(long long a, long long b) const {
        return a > b ? a : b;
    }
};

// sortcount._clamp_count: c > 2^20 -> 2^20 + (c mod 2^20).  It keeps
// (c mod 2^20, c >= 2^20), so clamping after every addition gives the
// same result as clamping the exact sum once: the clamped add is
// associative and any scan tree reproduces the reference's numbers.
__device__ __forceinline__ uint32_t clamp_count(uint32_t c) {
    const uint32_t big = 1u << 20;
    return c > big ? big + (c & (big - 1u)) : c;
}

// Segmented sum: (a, b) -> b restarts the value when it holds a start.
// CLAMPED selects the clamped add (full_sum mode) over the plain add.
// Associative, not commutative; {0, 0} is its identity on both sides.
template <bool CLAMPED>
struct SegOp {
    __device__ __forceinline__ Seg operator()(Seg a, Seg b) const {
        Seg r;
        r.f = a.f | b.f;
        uint32_t s = a.v + b.v;
        r.v = b.f ? b.v : (CLAMPED ? clamp_count(s) : s);
        return r;
    }
};

// A Seg in a status word's value: f in bit 32, v in bits 0-31.
__device__ __forceinline__ long long seg_pack(Seg s) {
    return ((long long)(s.f != 0) << 32) | s.v;
}

__device__ __forceinline__ Seg seg_unpack(long long x) {
    Seg s;
    s.f = (uint32_t)(x >> 32);
    s.v = (uint32_t)x;
    return s;
}

// SegOp on packed values, for the look-back.
template <bool CLAMPED>
struct PackedSegOp {
    __device__ __forceinline__ long long operator()(long long a, long long b) const {
        return seg_pack(SegOp<CLAMPED>()(seg_unpack(a), seg_unpack(b)));
    }
};

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32, at most 1024).  op(earlier, later) order is kept, so
// non-commutative operators work.  ``total`` receives the block's
// inclusive total.  All threads of the block must call it.
template <typename T, typename Op>
__device__ T block_excl_scan(T x, T id, Op op, T& total) {
    __shared__ T warp_tot[32];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    T inc = x;
    for (int d = 1; d < 32; d <<= 1) {
        T y = shfl_up(inc, d);
        if (lane >= d) inc = op(y, inc);
    }
    if (lane == 31) warp_tot[wid] = inc;
    __syncthreads();
    if (wid == 0) {
        T w = lane < nw ? warp_tot[lane] : id;
        for (int d = 1; d < 32; d <<= 1) {
            T y = shfl_up(w, d);
            if (lane >= d) w = op(y, w);
        }
        warp_tot[lane] = w;
    }
    __syncthreads();
    T wpre = wid == 0 ? id : warp_tot[wid - 1];
    T ex = shfl_up(inc, 1);
    ex = lane == 0 ? wpre : op(wpre, ex);
    total = warp_tot[nw - 1];
    __syncthreads();
    return ex;
}

// status word: flag in bits 62-63, value in bits 0-61
constexpr unsigned long long ST_AGG = 1ull << 62;     // the tile's own value
constexpr unsigned long long ST_INC = 2ull << 62;     // inclusive of every tile before
constexpr unsigned long long ST_VAL = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Decoupled look-back by one warp: op over the values of tiles 0 ..
// tile-1, read from their status words (value + bias encoded).  Lane j
// reads tile (tile - 1 - j) of each round of 32, waits until it is
// published, and the round ends at the nearest inclusive one.  ORDERED
// combines in tile order (earlier tiles sit on higher lanes, and each
// round covers tiles before the rounds already done), as an operator
// that does not commute needs; otherwise a butterfly over the lanes
// does.  ``id`` must be an identity of op on both sides.  Every lane
// returns the result.
template <bool ORDERED, typename Op>
__device__ long long warp_lookback(const unsigned long long* st, long long tile, Op op,
                                   long long id, long long bias) {
    const int lane = threadIdx.x & 31;
    long long acc = id;
    for (long long j = tile - 1 - lane;; j -= 32) {
        unsigned long long s = ST_INC | (unsigned long long)(id + bias);
        if (j >= 0) {
            do s = ld_status(st + j);
            while ((s >> 62) == 0);
        }
        const unsigned inc = __ballot_sync(FULL_MASK, (s >> 62) == 2);
        long long v = (long long)(s & ST_VAL) - bias;
        if (inc && lane > __ffs(inc) - 1) v = id;
        if (ORDERED) {
            // lane l ends up with op over lanes 31 .. l, in that order
            for (int d = 1; d < 32; d <<= 1) {
                const long long y = __shfl_down_sync(FULL_MASK, v, d);
                if (lane + d < 32) v = op(y, v);
            }
            acc = op(__shfl_sync(FULL_MASK, v, 0), acc);
        } else {
            for (int d = 16; d; d >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, d));
            acc = op(acc, v);
        }
        if (inc) return acc;
    }
}

// A tile's part of a chained scan: publish its own value at once (tile 0:
// its inclusive value), ...
__device__ __forceinline__ void publish(unsigned long long* st, long long tile, long long agg,
                                        long long bias) {
    st_status(st + tile, (tile == 0 ? ST_INC : ST_AGG) | (unsigned long long)(agg + bias));
}

// ... then (one warp, after publish) look back for the exclusive prefix
// and publish the inclusive value.  Every lane returns the exclusive
// prefix.
template <bool ORDERED = false, typename Op>
__device__ long long resolve(unsigned long long* st, long long tile, long long agg, Op op,
                             long long id, long long bias) {
    if (tile == 0) return id;
    const long long pre = warp_lookback<ORDERED>(st, tile, op, id, bias);
    if ((threadIdx.x & 31) == 0)
        st_status(st + tile, ST_INC | (unsigned long long)(op(pre, agg) + bias));
    return pre;
}

// Rows [*used, out_len) of ncols u32 columns (column stride ld) become
// sentinels (all-ones keys), or 0 in the column index zero_col (a count
// column; -1 for none).  Block 0 also publishes the count as int32
// [used, used] in rows_out, the verification pair of the TPU kernels.
// (A template, like every kernel of this header, so that each .cu file
// may instantiate it without a duplicate symbol at link time.)
template <typename U>
__global__ void fill_tail_kernel(U* out, int ncols, long long ld,
                                 long long out_len, const long long* used,
                                 int zero_col, int* rows_out) {
    const long long u = *used;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        rows_out[0] = (int)u;
        rows_out[1] = (int)u;
    }
    const long long start = u < out_len ? u : out_len;
    for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < out_len; i += (long long)gridDim.x * blockDim.x) {
        for (int c = 0; c < ncols; ++c)
            out[c * ld + i] = (c == zero_col) ? U(0) : U(0xffffffffu);
    }
}

inline int fill_blocks(long long rows, int threads) {
    long long b = (rows + threads - 1) / threads;
    if (b < 1) b = 1;
    if (b > 4096) b = 4096;
    return (int)b;
}

}  // namespace kt
