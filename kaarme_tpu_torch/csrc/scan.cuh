// Block-level scan helpers shared by the kernels of this package.
//
// The TPU kernels kept their carries in SMEM across a sequential grid; on
// Hopper the blocks run in no order, so every cross-tile carry becomes a
// scan over tiles.  K2, K4 and K5 are multi-pass: a per-tile pass
// produces one aggregate per tile, ONE block scans the tile aggregates in
// place (scan_tiles_kernel), and a second per-tile pass consumes the
// exclusive prefix.  K1 chains its scans in one pass with decoupled
// look-back (skm_dense.cu).
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

// In-place exclusive scan of nt tile aggregates by ONE block of
// SCAN_THREADS threads; the grand total goes to *total_out when it is
// not null.
constexpr int SCAN_THREADS = 256;

template <typename T, typename Op>
__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles_kernel(T* data, long long nt, T id, Op op, T* total_out) {
    constexpr int IT = 16;
    T carry = id;
    for (long long base = 0; base < nt; base += (long long)blockDim.x * IT) {
        const long long s = base + (long long)threadIdx.x * IT;
        T vals[IT];
        T loc = id;
        for (int j = 0; j < IT; ++j) {
            vals[j] = (s + j < nt) ? data[s + j] : id;
            loc = op(loc, vals[j]);
        }
        T tot;
        T run = op(carry, block_excl_scan(loc, id, op, tot));
        for (int j = 0; j < IT; ++j) {
            if (s + j < nt) data[s + j] = run;
            run = op(run, vals[j]);
        }
        carry = op(carry, tot);
    }
    if (threadIdx.x == 0 && total_out) *total_out = carry;
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
