// K3: canonical window keys (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_winkeys.py::window_keys_pallas (kernel
// body _winkeys_kernel).  Per window t of k positions: the big-endian
// 2-bit forward words, the reverse-complement words, their lexicographic
// min (most significant word first, ties to forward), and all-ones in
// EVERY word when any of the k positions is invalid (the sentinel).  The
// trailing word is left-aligned: its low 2 * (16 - k % 16) bits stay zero
// (the embedded count of the classic merge lives there).
//
// What bounds it on the H100: it reads 4 B per position and writes 4W B
// per window, so its traffic is ~(4 + 4W) B per window; per window it
// also does ~3k shared-memory reads and shifts.  At k=51 (W=4) and 2^26
// windows that is ~1.3 GB of traffic and ~10^10 simple integer ops, so
// the two bounds are of the same order.  Design: each block stages its
// TILE windows' codes plus the k-1 halo in shared memory as ONE byte per
// position (base in bits 0-1, invalid flag in bit 2), so the halo of any
// k up to ~47,000 fits the default 48 KB; longer k read the codes from
// global memory through L1 instead.  Each thread then builds its
// windows' words one at a time, most significant first: while the
// forward and reverse-complement words agree so far, the word written is
// the same either way, so the first differing word decides the
// orientation and no word needs to be held back.  Outputs are W
// coalesced columns.  A rolling shift register per thread (the
// reference's factory) or reading the 2-bit packed words directly would
// cut the per-window work; that is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace k3 {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;        // windows per block
constexpr int SMEM_MAX = 48 * 1024;          // staged bytes without opting in

__device__ __forceinline__ uint32_t norm_code(int32_t c) {
    const uint32_t u = (uint32_t)c;
    return (u & 3u) | ((u >> 2) ? 4u : 0u);
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
winkeys_kernel(const int32_t* __restrict__ codes, long long n, int k, int W,
               uint32_t* __restrict__ out, long long ld) {
    extern __shared__ uint8_t s_codes[];
    const long long t0 = (long long)blockIdx.x * TILE;
    const long long rem = n - t0;
    const int nwin = rem < TILE ? (int)rem : TILE;
    if (SMEM) {
        const int span = nwin + k - 1;
        for (int i = threadIdx.x; i < span; i += THREADS)
            s_codes[i] = (uint8_t)norm_code(codes[t0 + i]);
        __syncthreads();
    }
    for (int it = 0; it < ITEMS; ++it) {
        const int lt = it * THREADS + threadIdx.x;
        if (lt >= nwin) break;
        const long long t = t0 + lt;
        auto code = [&](int i) -> uint32_t {
            return SMEM ? (uint32_t)s_codes[lt + i] : norm_code(codes[t + i]);
        };
        uint32_t inv = 0;
        for (int i = 0; i < k; ++i) inv |= code(i);
        const uint32_t smask = (inv & 4u) ? 0xffffffffu : 0u;
        int state = 0;   // 0: words equal so far, -1: forward, 1: reverse complement
        for (int w = 0; w < W; ++w) {
            uint32_t f = 0, r = 0;
            const int jmax = min(16, k - 16 * w);
            for (int j = 0; j < jmax; ++j) {
                const int sh = 2 * (15 - j);
                f |= (code(16 * w + j) & 3u) << sh;
                r |= ((code(k - 1 - 16 * w - j) & 3u) ^ 3u) << sh;
            }
            if (state == 0) state = f < r ? -1 : (f > r ? 1 : 0);
            out[(long long)w * ld + t] = (state > 0 ? r : f) | smask;
        }
    }
}

}  // namespace k3

using namespace k3;

// codes: int32 [L], bits 0-1 the base, any higher bit = invalid; L >= n + k - 1.
// out: W = ceil(k / 16) u32 columns of stride ld >= n.  Returns a cudaError_t.
extern "C" int kt_window_keys(const void* codes, long long L, long long n, int k,
                              void* out, long long ld, void* stream) {
    if (k < 2 || n < 0 || L < n + k - 1 || ld < n) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const int W = (k + 15) / 16;
    const long long blocks = (n + TILE - 1) / TILE;
    const size_t smem = (size_t)TILE + (size_t)k - 1;
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* c = static_cast<const int32_t*>(codes);
    uint32_t* o = static_cast<uint32_t*>(out);
    if (smem <= (size_t)SMEM_MAX)
        winkeys_kernel<true><<<(unsigned)blocks, THREADS, smem, s>>>(c, n, k, W, o, ld);
    else
        winkeys_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(c, n, k, W, o, ld);
    return (int)cudaGetLastError();
}
