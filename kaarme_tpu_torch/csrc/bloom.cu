// B1 and B2: the two-stage blocked Bloom prefilter of the two-pass -b mode,
// straight from K3's key columns (CUDA C++, sm_90a).
//
// Neither replaces a Pallas kernel: the JAX package runs the filter as XLA
// ops.  B1, the pass-1 insert, replaces kaarme_tpu/ops/bloom.py::insert_batch
// (a sort of the batch's roots, an in-segment ordinal, and set_bits' sort
// and segmented OR scan) with ops/hashing.py::hash_words64 and the validity
// mask in front of it (ops/sortcount.py::bloom_pass1_superstep).  B2, the
// pass-2 gate, replaces ops/sortcount.py::_bloom_miss_mask applied as
// `keys | miss`.  The PyTorch versions they replace (ops/cuda_bloom.py's
// plain versions) build a bool plane of one byte per filter bit per stage
// and batch, synchronise with the host three times per batch, and hash in
// ~20 int64 launches per key word and seed.
//
// Layout (ops/bloom.py): all hfn bits of a key live in ONE 32-bit word of
// a stage, word r1 & (nwords - 1), bits (b0 + j * stride) & 31, j < hfn,
// with b0 = r2 & 31 and the odd stride ((r2 >> 5) | 1) & 31, where (r1, r2)
// is the key's 64-bit root: murmur3 of its W words under two seeds
// (murmur3.cuh).  A key is valid unless every word is all-ones (K3's
// invalid key).  Word indices are u32 (a stage holds up to 2^32 words).
//
// B1's semantics, per batch, are the JAX package's bit for bit.  Keys are
// the ROOTS of the valid windows: "first" and "second" occurrence are
// ordinals among the batch's windows with that root.  in1 and in2 are read
// from the filters as they stood BEFORE the batch; set1 = first & !in1,
// set2 = !in2 & ((first & in1) | (second & !in1)); the counters add the
// number of set1 and set2 windows, and the filters receive the OR of their
// masks.  A kernel that ORed as it went would let a key see bits that
// another key of the same batch set, so B1 decides first and sets after,
// in two launches whose stream order is the snapshot (no filter copy: a
// stage is 2^31 words at -u 10^9):
//
// B1a, decide: per window, the root and validity in registers; the warp's
//   valid lanes with one root (__match_any_sync on r1 and on r2,
//   intersected) form a group whose lowest lane, the leader, adds the
//   group's size g to the root's slot in a scratch open-addressing set and
//   gets back the occurrences before the group, o.  The group holds the
//   batch's first occurrence when o == 0 and its second when o <= 1 < o + g;
//   only then does the leader read in1 and in2 (one word of each stage) and
//   write the key's decision (bit 0: set1, bit 1: set2) into its window's
//   byte; every other byte is 0.  A poly-A batch costs one atomic per warp.
// B1b, apply: per window with a decision byte, the root again from the key
//   words (a few instructions, instead of 8 B of scratch per window), one
//   atomicOr into each stage it sets; the counters add __syncthreads_count
//   per block, one 64-bit atomicAdd per block and counter.
//
// The scratch set: `slots` (a power of two >= 2n, so at most half full and
// every probe chain ends) slots of three u32 words, [count, r1, r2],
// cleared with a memset on the stream before each batch (12 B per slot:
// 24 MiB for a table batch of 2^20 windows, 1.5 GiB for a sort superstep
// of 2^26), probed linearly from a Fibonacci hash of the root.  Any 64-bit
// value is a root, so the count word is the slot's state, T1's protocol
// (table_insert.cu): 0 empty, BUSY while its claimer writes the root,
// else the published occurrence count.  A claimer (atomicCAS 0 -> BUSY)
// writes r1 and r2 and publishes g with st.release; a prober loads the
// count relaxed, waits out BUSY, then fence.acq_rel (an acquire pattern:
// the root it reads next is the claimer's) and compares the root: equal ->
// atomicAdd(count, g), whose old value is o.  Nothing waits between a claim
// and its publish, so no lane waits on itself.
//
// B2, the gate: per key, its root and validity in registers; a valid key
// whose hfn bits are not all set in BF2 has all W words overwritten with
// all-ones, in place (every caller gates a fresh buffer: K3's output, the
// skm finalize's expansion); an all-ones key stays all-ones (the JAX gate
// ORs its miss mask into it), so B2 skips it.
//
// What bounds them on the H100: bytes.  B1 reads each window's 4W key bytes
// (coalesced columns), one random word of each stage per new key (a 32 B
// sector: the filters are 32 MiB a stage at -u 5000000, partly in L2), and
// ORs one word per stage for each key it sets; its scratch set (24 MiB at a
// table batch) stays in the 50 MB L2, and the decision bytes add 2 B per
// window.  B2 reads 4W bytes and one BF2 sector per key and writes only
// the missed keys' words.  Both read the key columns where they lie, with
// T1's strides: word w of window i at keys[w * lw + i * li].
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace bloom {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t BUSY = 0xffffffffu;   // occurrence counts stay below 2^32 - 1

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void fence_acq_rel() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The key's hfn-bit mask in its word (ops/bloom.py::_word_mask).
__device__ __forceinline__ uint32_t mask_of(uint32_t r2, int hfn) {
    const uint32_t b0 = r2 & 31u, stride = ((r2 >> 5) | 1u) & 31u;
    uint32_t m = 0;
    for (int j = 0; j < hfn; ++j) m |= 1u << ((b0 + (uint32_t)j * stride) & 31u);
    return m;
}

// Add g occurrences of the root (r1, r2) to the scratch set; returns the
// occurrences counted before them (0: this call claimed the slot).
__device__ __forceinline__ uint32_t count_root(uint32_t* set, uint32_t smask, uint32_t r1,
                                               uint32_t r2, uint32_t g) {
    const unsigned long long root = (unsigned long long)r1 << 32 | r2;
    uint32_t s = (uint32_t)((root * 0x9E3779B97F4A7C15ull) >> 32) & smask;
    for (;; s = (s + 1u) & smask) {
        uint32_t* c = set + 3 * (size_t)s;
        uint32_t v = ld_relaxed(c);
        if (v == 0) {
            v = atomicCAS(c, 0u, BUSY);
            if (v == 0) {
                c[1] = r1;
                c[2] = r2;
                st_release(c, g);
                return 0;
            }
        }
        if (v == BUSY) {
            unsigned ns = 32;
            while ((v = ld_relaxed(c)) == BUSY) {
                __nanosleep(ns);
                ns = ns < 1024 ? 2 * ns : ns;
            }
        }
        fence_acq_rel();   // acquire: the root was written before the count was published
        if (__ldcg(c + 1) == r1 && __ldcg(c + 2) == r2) return atomicAdd(c, g);
    }
}

__global__ void __launch_bounds__(THREADS)
    decide_kernel(const uint32_t* keys, long long lw, long long li, int W, long long n,
                  const uint32_t* bf1, const uint32_t* bf2, uint32_t wmask, int hfn,
                  uint32_t* set, uint32_t smask, uint8_t* dec) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool in = i < n;
    murmur3::Root r{0, 0, true};
    if (in) r = murmur3::root_of(keys + i * li, lw, W);
    const bool valid = in && !r.all_ones;
    const unsigned live = __ballot_sync(FULL, valid);
    uint8_t d = 0;
    if (valid) {
        const unsigned grp = live & __match_any_sync(live, r.r1) & __match_any_sync(live, r.r2);
        if (lane == __ffs(grp) - 1) {
            const uint32_t g = (uint32_t)__popc(grp);
            const uint32_t o = count_root(set, smask, r.r1, r.r2, g);
            const bool first = o == 0, second = o <= 1 && o + g >= 2;
            if (first || second) {
                const size_t w = r.r1 & wmask;
                const uint32_t m = mask_of(r.r2, hfn);
                const bool in1 = (bf1[w] & m) == m, in2 = (bf2[w] & m) == m;
                const bool set1 = first && !in1;
                const bool set2 = !in2 && ((first && in1) || (second && !in1));
                d = (uint8_t)(set1 | set2 << 1);
            }
        }
    }
    if (in) dec[i] = d;
}

__global__ void __launch_bounds__(THREADS)
    apply_kernel(const uint32_t* keys, long long lw, long long li, int W, long long n,
                 uint32_t* bf1, uint32_t* bf2, uint32_t wmask, int hfn, const uint8_t* dec,
                 unsigned long long* counters) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int d = i < n ? dec[i] : 0;
    if (d) {
        const murmur3::Root r = murmur3::root_of(keys + i * li, lw, W);
        const size_t w = r.r1 & wmask;
        const uint32_t m = mask_of(r.r2, hfn);
        if (d & 1) atomicOr(bf1 + w, m);
        if (d & 2) atomicOr(bf2 + w, m);
    }
    // every thread of the block reaches both counts (no early return above)
    const int n1 = __syncthreads_count(d & 1), n2 = __syncthreads_count(d & 2);
    if (threadIdx.x == 0) {
        if (n1) atomicAdd(counters, (unsigned long long)n1);
        if (n2) atomicAdd(counters + 1, (unsigned long long)n2);
    }
}

__global__ void __launch_bounds__(THREADS)
    gate_kernel(uint32_t* keys, long long lw, long long li, int W, long long n,
                const uint32_t* bf2, uint32_t wmask, int hfn) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    uint32_t* col = keys + i * li;
    const murmur3::Root r = murmur3::root_of(col, lw, W);
    if (r.all_ones) return;
    const uint32_t m = mask_of(r.r2, hfn);
    if ((__ldg(bf2 + (r.r1 & wmask)) & m) == m) return;
    for (int w = 0; w < W; ++w) col[w * lw] = 0xffffffffu;
}

inline bool bad_shape(long long nwords, int hfn, long long lw, long long li, int W, long long n) {
    return nwords < 1 || (nwords & (nwords - 1)) || nwords > (1LL << 32) || hfn < 0 || W < 1 ||
           n < 0 || li < 1 || lw < 0 || (n + THREADS - 1) / THREADS > 0x7fffffffLL;
}

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace bloom

// B1.  bf1, bf2: nwords u32 words each (a power of two <= 2^32), updated in
// place.  keys: word w of window i at keys[w * lw + i * li] (K3's columns:
// lw = n, li = 1).  scratch: 12 * slots bytes of set (slots a power of two
// >= 2n) followed by n decision bytes.  counters: two int64, overwritten
// with this batch's new_in_first and new_in_second.  Returns a cudaError_t.
extern "C" int kt_bloom_insert(void* bf1, void* bf2, long long nwords, int hfn, const void* keys,
                               long long lw, long long li, int W, long long n, void* scratch,
                               long long slots, void* counters, void* stream) {
    if (bloom::bad_shape(nwords, hfn, lw, li, W, n) || slots < 2 * n || slots < 1 ||
        (slots & (slots - 1)) || slots > (1LL << 32))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
    if (e != cudaSuccess || n == 0) return (int)e;
    auto* set = static_cast<uint32_t*>(scratch);
    auto* dec = reinterpret_cast<uint8_t*>(set + 3 * slots);
    e = cudaMemsetAsync(set, 0, 12 * (size_t)slots, s);
    if (e != cudaSuccess) return (int)e;
    auto* kp = static_cast<const uint32_t*>(keys);
    auto* b1 = static_cast<uint32_t*>(bf1);
    auto* b2 = static_cast<uint32_t*>(bf2);
    const uint32_t wmask = (uint32_t)(nwords - 1);
    bloom::decide_kernel<<<bloom::blocks(n), bloom::THREADS, 0, s>>>(
        kp, lw, li, W, n, b1, b2, wmask, hfn, set, (uint32_t)(slots - 1), dec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bloom::apply_kernel<<<bloom::blocks(n), bloom::THREADS, 0, s>>>(
        kp, lw, li, W, n, b1, b2, wmask, hfn, dec, static_cast<unsigned long long*>(counters));
    return (int)cudaGetLastError();
}

// B2.  bf2: nwords u32 words; keys as for B1, overwritten in place where a
// valid key misses BF2.  Returns a cudaError_t.
extern "C" int kt_bloom_gate(const void* bf2, long long nwords, int hfn, void* keys,
                             long long lw, long long li, int W, long long n, void* stream) {
    if (bloom::bad_shape(nwords, hfn, lw, li, W, n)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    bloom::gate_kernel<<<bloom::blocks(n), bloom::THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<uint32_t*>(keys), lw, li, W, n, static_cast<const uint32_t*>(bf2),
        (uint32_t)(nwords - 1), hfn);
    return (int)cudaGetLastError();
}
