// E1: the skm finalize's expansion of distinct run rows into canonical
// k-mer keys, in one pass (CUDA C++, sm_90a).
//
// Replaces no Pallas kernel: the JAX package's expansion,
// kaarme_tpu/ops/skm.py::expand_chunk (its _expand_keys, the dead-run mask
// and the count column, in front of the Bloom gate), is jnp that XLA fuses
// into one loop.  Its eager PyTorch version (ops/skm.py::_expand_keys and
// expand_runs_plain) is a chain of ~2,400 int64 element-wise launches per
// call at k=51.
//
// Input: R run rows of Wc = ceil((LMAX + k - 1) / 16) content words (the
// run's span of bases, big-endian 2-bit, 16 a word), the meta word (ell - 1
// in bits 26-29) and the int32 count.  Output: LMAX rows a run, row
// r * LMAX + e holding window e of run r: W = ceil(k / 16) key words and
// the count.  Forward word wi is the 16 bases at span offset e + 16 wi; the
// reverse-complement word wi is the complement of the 16 bases at offset
// e + k - 16 (wi + 1), in reverse order; the key is their lexicographic min
// (most significant word first, ties to forward), the trailing word masked
// to its k - 16 (W - 1) bases.  Bases outside the span read as 0 and land
// only in masked bits.  A row with e >= ell, or of a run whose count is
// <= 0, is all-ones with count 0; a live row carries its run's count (0
// should its key be all-ones, which no canonical key is).
//
// What bounds it on the H100: the bytes it writes, 4 (W + 1) a row, LMAX
// rows a run: 335 MB at k=51 and 2^20 runs, against 4 (Wc + 2) B read a
// run (29 MB); a few dozen integer operations a word.  Design:
// - one thread a row, so a warp writes 32 consecutive rows (two runs'
//   slots) of every column as 128 B, with streaming stores (the sort reads
//   the rows next, from HBM);
// - the run's words are read-only loads that 16 lanes share (a broadcast,
//   then L1 hits): the word at span offset o is the funnel shift by
//   2 (o & 15) of the pair of span words o >> 4, (o >> 4) + 1, the span
//   padded with a zero word on each side;
// - the orientation is decided word by word from the most significant one,
//   then the chosen words are built again and stored.
// One kernel serves every W (the skm route takes k up to 16,721): building
// the words twice from L1 instead of keeping them in registers costs 0.35
// against 0.17 ms at 2^20 runs and k=51 on an H100 (a form templated on
// W), which no finalize shows end to end.  40 registers, no spill (ptxas
// -v, sm_90a).
#include "skm_seg.cuh"

namespace e1 {

using kseg::EBITS;
using kseg::LMAX;
using kseg::pairrev;

constexpr int THREADS = 256;
constexpr uint32_t ONES = 0xffffffffu;

struct Args {
    const uint32_t* cols;   // column c of run r at cols[c * lc + r * li]
    long long lc, li;
    uint32_t* out;          // column w of row t at out[w * lo + t]; w = W: the count
    long long lo;
    long long rows;         // R * LMAX
    int W, Wc;
    int rp;                 // k - 16 (W - 1), in [1, 16]
    uint32_t topmask;       // the trailing word's bases
};

// The 16 bases at 2-bit offset s / 2 into the word pair (a0, a1), a0 first.
__device__ __forceinline__ uint32_t word_of(uint32_t a0, uint32_t a1, int s) {
    return __funnelshift_l(a1, a0, s);
}

// Word w of row t (w = W: the count), evict-first.
__device__ __forceinline__ void store(const Args& a, long long t, int w, uint32_t x) {
    __stcs(a.out + w * a.lo + t, x);
}

// Word j of the padded span (0 outside it), from global memory.
__device__ __forceinline__ uint32_t ext_at(const Args& a, const uint32_t* run, int j) {
    return (j >= 1 && j <= a.Wc) ? __ldg(run + (j - 1) * a.lc) : 0u;
}

// Forward word wi of window e: span offset e + 16 wi.
__device__ __forceinline__ uint32_t fwd_at(const Args& a, const uint32_t* run, int e, int wi) {
    const uint32_t f = word_of(ext_at(a, run, wi + 1), ext_at(a, run, wi + 2), 2 * e);
    return wi == a.W - 1 ? f & a.topmask : f;
}

// Reverse-complement word wi of the window at d = e + k - 16 (W - 1): the
// complement of the 16 bases at span offset 16 (W - 2 - wi) + d, reversed.
__device__ __forceinline__ uint32_t rev_at(const Args& a, const uint32_t* run, int d, int wi) {
    const int j = a.W - 1 - wi + (d >> 4);
    const uint32_t g = pairrev(~word_of(ext_at(a, run, j), ext_at(a, run, j + 1), 2 * (d & 15)));
    return wi == a.W - 1 ? g & a.topmask : g;
}

__global__ void __launch_bounds__(THREADS) expand_kernel(const Args a) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= a.rows) return;
    const long long r = t / LMAX;
    const int e = (int)(t % LMAX);
    const uint32_t* run = a.cols + r * a.li;
    const uint32_t meta = __ldg(run + a.Wc * a.lc);
    const int cnt = (int)__ldg(run + (a.Wc + 1) * a.lc);
    const int ell = (int)((meta >> EBITS) & 15u) + 1;
    if (e >= ell || cnt <= 0) {
        for (int w = 0; w < a.W; ++w) store(a, t, w, ONES);
        store(a, t, a.W, 0u);
        return;
    }
    const int d = e + a.rp;
    bool rc = false;
    for (int wi = 0; wi < a.W; ++wi) {
        const uint32_t f = fwd_at(a, run, e, wi), g = rev_at(a, run, d, wi);
        if (f != g) {
            rc = f > g;
            break;
        }
    }
    uint32_t all = ONES;
    for (int wi = 0; wi < a.W; ++wi) {
        const uint32_t x = rc ? rev_at(a, run, d, wi) : fwd_at(a, run, e, wi);
        all &= x;
        store(a, t, wi, x);
    }
    store(a, t, a.W, all == ONES ? 0u : (uint32_t)cnt);
}

inline unsigned blocks(long long rows) {
    return (unsigned)((rows + THREADS - 1) / THREADS);
}

}  // namespace e1

// E1.  cols: the Wc + 2 u32 columns of R run rows, column c of run r at
// cols[c * lc + r * li] (a run store's columns: lc = its column stride,
// li = 1); Wc = (LMAX + k - 1 + 15) / 16, k >= 16.  out: the W key
// columns and the count column of R * LMAX rows, column w of row t at
// out[w * lo + t], lo >= R * LMAX.  Returns a cudaError_t.
extern "C" int kt_expand_runs(const void* cols, long long lc, long long li, int k, long long R,
                              void* out, long long lo, void* stream) {
    using e1::LMAX;
    if (k < 16 || R < 0 || R > (1LL << 40) || li < 1 || lc < 0 || lo < R * LMAX ||
        (R * LMAX + e1::THREADS - 1) / e1::THREADS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (R == 0) return (int)cudaSuccess;
    e1::Args a;
    a.cols = static_cast<const uint32_t*>(cols);
    a.lc = lc;
    a.li = li;
    a.out = static_cast<uint32_t*>(out);
    a.lo = lo;
    a.rows = R * LMAX;
    a.W = (k + 15) / 16;
    a.Wc = (LMAX + k - 1 + 15) / 16;
    a.rp = k - 16 * (a.W - 1);
    a.topmask = a.rp == 16 ? e1::ONES : ((1u << (2 * a.rp)) - 1u) << (32 - 2 * a.rp);
    cudaStream_t s = (cudaStream_t)stream;
    e1::expand_kernel<<<e1::blocks(a.rows), e1::THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}
