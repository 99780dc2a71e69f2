// K3: canonical window keys straight from the transfer chunk (CUDA C++,
// sm_90a).
//
// Replaces kaarme_tpu/ops/pallas_winkeys.py::window_keys_pallas (kernel
// body _winkeys_kernel), together with the unpack in front of it
// (ops/sortcount.py::codes_from_chunk).  Input: the chunk the host ships,
// 2-bit bases (base i at bits 2*(i%16) of word i/16) and the invalid
// positions as a bitmap (bit i%32 of word i/32).  Positions at or past
// L = n + k - 1 are invalid whatever the chunk holds.  Per window t of k
// positions: the big-endian 2-bit forward words, the reverse-complement
// words, their lexicographic min (most significant word first, ties to
// forward), and all-ones in EVERY word when any of the k positions is
// invalid (the sentinel).  The trailing word is left-aligned: its low
// 2 * (16 - k % 16) bits stay zero (the embedded count of the classic
// merge lives there).
//
// What bounds it on the H100: bytes.  It writes 4W B per window (1.07 GB
// at k=51, n = 2^26) and reads n/4 bytes of packed bases plus n/8 of
// bitmap; the work per window is O(W), a few operations per word.
// Design (the identities of sortcount.window_keys_packed in the JAX
// package): each block stages its TILE windows' packed words plus a
// one-word halo on each side, and their bitmap words with prefix
// popcounts, in shared memory; then per window and word w:
// - forward word: the funnel shift of the packed pair at position
//   t + 16w, its sixteen 2-bit fields reversed (kseg::pairrev);
// - reverse-complement word: the bitwise NOT of the little-endian funnel
//   shift at position t + k - 16(w+1): read from that position up, the
//   bases come out in descending order already, and NOT complements each
//   2-bit field.  For the trailing partial word that position lies before
//   the window (before position 0 too, read as zero words); its bases
//   land only in the masked low bits;
// - validity: a difference of two bitmap ranks, as kseg::window_minv.
// The words are built most significant first: while the forward and
// reverse-complement words agree so far, the word written is the same
// either way, so the first differing word decides the orientation and no
// word is held back.  Outputs are W coalesced columns.  Any k >= 2 whose
// tile fits in 227 KB of shared memory (about (TILE + k) / 2 bytes: k up
// to ~460,000).
#include "skm_seg.cuh"

namespace k3 {

using namespace kt;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;        // windows per block (a multiple of 32)

struct Geo {
    int k, W;
    int NPW;            // packed words staged: from word T0/16 - 1
    int NBW;            // bitmap words staged: from word T0/32
    uint32_t tmask;     // kept bits of the trailing word
    long long L, n;
};

__host__ inline Geo make_geo(int k, long long n) {
    Geo g;
    g.k = k;
    g.W = (k + 15) / 16;
    g.NPW = (TILE + k + 14) / 16 + 4;
    g.NBW = (TILE + k + 31) / 32 + 1;
    const int r = k % 16;
    g.tmask = r ? ~0u << (32 - 2 * r) : ~0u;
    g.L = n + k - 1;
    g.n = n;
    return g;
}

__host__ inline size_t smem_bytes(const Geo& g) {
    return 4 * ((size_t)g.NPW + 2 * (size_t)g.NBW);   // packed | bitmap | prefix ranks
}

__global__ void __launch_bounds__(THREADS)
winkeys_kernel(const uint32_t* __restrict__ packed, long long npk,
               const uint32_t* __restrict__ bitmap, long long nbm, Geo g,
               uint32_t* __restrict__ out, long long ld) {
    extern __shared__ __align__(16) uint32_t sm[];
    uint32_t* pw = sm;
    uint32_t* bm = pw + g.NPW;
    uint32_t* pre = bm + g.NBW;
    const int tid = threadIdx.x;
    const long long T0 = (long long)blockIdx.x * TILE;
    const long long wa = T0 / 16 - 1, ba = T0 / 32;

    // 1. stage the packed words (0 outside the chunk) and the bitmap words
    //    (positions outside [0, L) invalid)
    for (int j = tid; j < g.NPW; j += THREADS) {
        const long long gw = wa + j;
        pw[j] = (gw >= 0 && gw < npk) ? packed[gw] : 0u;
    }
    for (int j = tid; j < g.NBW; j += THREADS) {
        const long long gw = ba + j, lo = 32 * gw;
        uint32_t m = gw < nbm ? bitmap[gw] : 0u;
        if (lo >= g.L) m = 0xffffffffu;
        else if (lo + 32 > g.L) m |= 0xffffffffu << (int)(g.L - lo);
        bm[j] = m;
    }
    __syncthreads();

    // 2. bitmap prefix popcounts (warp 0)
    if (tid < 32) {
        uint32_t carry = 0;
        for (int j0 = 0; j0 < g.NBW; j0 += 32) {
            const int j = j0 + tid;
            const uint32_t c = j < g.NBW ? (uint32_t)__popc(bm[j]) : 0u;
            uint32_t inc = c;
            for (int d = 1; d < 32; d <<= 1) {
                const uint32_t y = __shfl_up_sync(FULL_MASK, inc, d);
                if (tid >= d) inc += y;
            }
            if (j < g.NBW) pre[j] = carry + inc - c;
            carry += __shfl_sync(FULL_MASK, inc, 31);
        }
    }
    __syncthreads();

    // 3. the keys; window lt's position t = T0 + lt is staged position
    //    lt + 16 of pw and bit lt of bm
    auto rank = [&](int q) {
        return pre[q >> 5] + __popc(bm[q >> 5] & ((1u << (q & 31)) - 1u));
    };
    auto word_at = [&](int p) {     // little-endian: bits 2j.. hold the base at p + j
        return __funnelshift_r(pw[p >> 4], pw[(p >> 4) + 1], 2 * (p & 15));
    };
    const long long rem = g.n - T0;
    const int nwin = rem < TILE ? (int)rem : TILE;
    for (int it = 0; it < ITEMS; ++it) {
        const int lt = it * THREADS + tid;
        if (lt >= nwin) break;
        const uint32_t smask = rank(lt + g.k) == rank(lt) ? 0u : 0xffffffffu;
        uint32_t* o = out + T0 + lt;
        int state = 0;   // 0: words equal so far, -1: forward, 1: reverse complement
        for (int w = 0; w < g.W; ++w) {
            const uint32_t m = w == g.W - 1 ? g.tmask : 0xffffffffu;
            const uint32_t f = kseg::pairrev(word_at(lt + 16 + 16 * w)) & m;
            const uint32_t r = ~word_at(lt + 16 + g.k - 16 * (w + 1)) & m;
            if (state == 0) state = f < r ? -1 : (f > r ? 1 : 0);
            o[(long long)w * ld] = (state > 0 ? r : f) | smask;
        }
    }
}

}  // namespace k3

using namespace k3;

// packed: u32 [npk] 2-bit bases, npk >= ceil(L / 16) with L = n + k - 1.
// sep: the invalid positions, a u32 bitmap of nsep >= ceil(L / 32) words.
// out: W = ceil(k / 16) u32 columns of stride ld >= n.  Returns a
// cudaError_t.
extern "C" int kt_window_keys(const void* packed, long long npk, const void* sep, long long nsep,
                              long long n, int k, void* out, long long ld, void* stream) {
    const long long L = n + k - 1;
    if (k < 2 || n < 0 || npk * 16 < L || nsep * 32 < L || ld < n)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const Geo g = make_geo(k, n);
    const size_t sm = smem_bytes(g);
    if (sm > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    if (sm > 48 * 1024 &&
        (e = cudaFuncSetAttribute((const void*)winkeys_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm)) !=
            cudaSuccess)
        return (int)e;
    winkeys_kernel<<<(unsigned)((n + TILE - 1) / TILE), THREADS, sm, s>>>(
        static_cast<const uint32_t*>(packed), npk, static_cast<const uint32_t*>(sep), nsep, g,
        static_cast<uint32_t*>(out), ld);
    return (int)cudaGetLastError();
}
