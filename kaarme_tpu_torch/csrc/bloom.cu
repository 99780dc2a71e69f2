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
// B1a, decide: per window, the root and validity in registers (key words
//   loaded evict-first); the warp's valid lanes with one root
//   (__match_any_sync on r1 and on r2, intersected) form a group of g
//   windows whose lowest lane, the leader, decides for all of them:
//   1. it loads the root's word of BF1 and of BF2, both in flight before
//      either compare, and gets in1, in2;
//   2. in1 && in2: the decision is 0, and the scratch set is not touched;
//   3. otherwise it ranks the root in the scratch set: o, the root's
//      windows counted before the group, with a saturating read path; the
//      group holds the batch's first occurrence when o == 0 and its second
//      when o <= 1 < o + g.  Its decision is set1 and set2; every other
//      window's is 0.  A warp stores its 32 windows' decisions as two
//      ballots, set1 bits then set2 bits (2 bits a window).
// B1b, apply: per window with a decision bit, the root again from the key
//   words (a few instructions, instead of 8 B of scratch per window), one
//   atomicOr into each stage it sets.  A thread takes 4 windows' bits; the
//   counters add a block's sums, one 64-bit atomicAdd per block and
//   counter.
//
// Why the short-cuts keep insert_batch's semantics.  Every window of one
// root has the same key for the filters: one word, one mask, and filters
// that B1a only reads, so all its groups see the same in1 and in2, and the
// counts are per root: leaving one root out of the set changes no other
// root's ordinals.
// - in1 && in2: set1 = first & !in1 = 0 and set2 = !in2 & (...) = 0 for
//   every window of the root, whatever its ordinal, so it needs no count.
// - The count a group needs: with !in1 && !in2, set1 = first and set2 =
//   second, so it must tell o == 0, o == 1 and o >= 2 apart (need = 2).
//   With exactly one of in1, in2 it only needs first: in1 && !in2 gives
//   set1 = 0, set2 = first; in2 && !in1 (a BF2 false positive: BF2 holds
//   the bits of other keys) gives set2 = 0 and set1 = first, so set1 still
//   lands, on the first occurrence (need = 1).
// - Saturation: a root's count in the set only grows within a batch.  A
//   leader that finds its root's slot published with a count >= need knows
//   o >= need, so its group holds no occurrence it could act on (o >= 2:
//   neither first nor second; o >= 1 with need 1: not first), and it
//   writes 0 without an atomic.  Its windows are then missing from the
//   count, but only once the count has reached need, so every group that
//   still counts gets o >= need as well: the groups that see o < need are
//   exactly those whose atomic came before the count reached need, with
//   their exact o.  A count of 0 (the claim) or below need takes the
//   atomicCAS or atomicAdd.  With need 1 a published slot always shows
//   g >= 1: a root in one filter costs one claim and no adds.
//
// The scratch set, no memset per batch: `slots` (a power of two >= 2n)
// slots of 16 B, 16 B-aligned, so a probe touches ONE 32 B sector:
// [state, count, r1, r2].  state is 0 (never used) or epoch << 1 | p, p = 0
// while its claimer writes the slot (BUSY), 1 once published; each batch
// takes the next epoch in 1 .. 2^31 - 1 (the wrapper counts them; the set
// is zeroed when the scratch is allocated, once per pass, and again when
// the epoch wraps to 1).  A slot whose state carries another epoch is
// empty in this batch.  Probing is linear from a Fibonacci hash of the
// root; every root the batch ranks claims at most one slot, so at most n
// of the >= 2n slots are live in an epoch and every probe chain ends.  The
// count-as-state protocol of T1 (table_insert.cu), with the epoch in it:
// - every read of a state word is ld.acquire; the words of a slot are read
//   only after an acquire read of its state showed it published in this
//   epoch (the release by its claimer), so the root compared and the count
//   read are this epoch's, never a stale slot's.  (T1 reads the state
//   relaxed and then fences with fence.acq_rel: the same acquire pattern
//   in the PTX memory model; the load-acquire spares a fence per probe.)
// - claim: the prober read v of another epoch; it CASes v -> epoch << 1
//   (BUSY), from the exact value read.  Success: the slot is its own; it
//   writes count = g and the root with plain stores, publishes with
//   st.release (epoch << 1 | 1), and o = 0.  Failure: another prober won;
//   within a batch only this epoch's claims and publishes write a state
//   word (earlier batches' writes are ordered before this launch), so
//   the state now holds this epoch's BUSY or published, never another
//   stale value, and the prober reads it again: two probers of one stale
//   slot cannot both claim it.
// - a slot of this epoch: BUSY is waited out (nanosleep), then the 16 B
//   slot is read.  Equal root: count >= need -> saturated, else
//   atomicAdd(count, g), whose old value is o.  Nothing waits between a
//   claim and its publish, so no lane waits on itself.
//
// B2, the gate: per key, its root and validity in registers; a valid key
// whose hfn bits are not all set in BF2 has all W words overwritten with
// all-ones, in place (every caller gates a fresh buffer: K3's output, the
// skm finalize's expansion); an all-ones key stays all-ones (the JAX gate
// ORs its miss mask into it), so B2 skips it.  Each thread gates 2 keys,
// 256 apart (coalesced), their words loaded evict-first: every key's word
// loads are issued, then every root is formed and every BF2 load issued,
// before any compare or store, so two dependent load chains are in
// flight per thread instead of one.  (Of the forms timed on the H100 --
// 1, 2, 4 or 8 keys a thread, plain or evict-first key loads, an L2
// persisting window over BF2 -- the evict-first loads carried the gain
// and 2 keys were best; PERF.md §6.)
//
// What bounds them on the H100: bytes.  B1 reads each window's 4W key bytes
// (coalesced columns), two random words (two 32 B sectors: the filters are
// 32 MiB a stage at -u 5000000, partly in L2) per group leader, a slot
// sector per leader of a root not in both stages, and ORs one word per
// stage for each key it sets; the decisions add 4 bits per window.  B2
// reads 4W bytes and one BF2 sector per key and writes only the missed
// keys' words.  Both read the key columns where they lie, with T1's
// strides: word w of window i at keys[w * lw + i * li].
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace bloom {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long EPOCH_MAX = 0x7fffffffLL;   // epoch << 1 | 1 fits a u32
constexpr uint32_t SATURATED = 0xffffffffu;     // rank_root: the count had reached need

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ uint4 ld_relaxed_v4(const uint32_t* p) {
    uint4 v;
    asm volatile("ld.relaxed.gpu.global.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p)
                 : "memory");
    return v;
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

// Rank a group of g windows of the root (r1, r2) in this epoch's set: the
// root's windows counted before the group (0: this call claimed the slot),
// or SATURATED where the slot already showed a count >= need (then nothing
// is added).  The protocol and why it is exact: the header.
__device__ __forceinline__ uint32_t rank_root(uint32_t* set, uint32_t smask, uint32_t epoch,
                                              uint32_t r1, uint32_t r2, uint32_t g,
                                              uint32_t need) {
    const uint32_t busy = epoch << 1, pub = busy | 1u;
    const unsigned long long root = (unsigned long long)r1 << 32 | r2;
    uint32_t s = (uint32_t)((root * 0x9E3779B97F4A7C15ull) >> 32) & smask;
    for (;; s = (s + 1u) & smask) {
        uint32_t* c = set + 4 * (size_t)s;
        uint32_t v = ld_acquire(c);
        while ((v | 1u) != pub) {   // another epoch's slot: empty; claim it from v
            if (atomicCAS(c, v, busy) == v) {
                c[1] = g;
                *reinterpret_cast<uint2*>(c + 2) = make_uint2(r1, r2);
                st_release(c, pub);
                return 0;
            }
            v = ld_acquire(c);   // this epoch's BUSY or published: see the header
        }
        for (unsigned ns = 32; v == busy; ns = ns < 1024 ? 2 * ns : ns) {
            __nanosleep(ns);
            v = ld_acquire(c);
        }
        // v was published, read by an acquire: the slot's words are this epoch's
        const uint4 q = ld_relaxed_v4(c);
        if (q.z == r1 && q.w == r2) return q.y >= need ? SATURATED : atomicAdd(c + 1, g);
    }
}

__global__ void __launch_bounds__(THREADS)
    decide_kernel(const uint32_t* keys, long long lw, long long li, int W, long long n,
                  const uint32_t* __restrict__ bf1, const uint32_t* __restrict__ bf2,
                  uint32_t wmask, int hfn, uint32_t* set, uint32_t smask, uint32_t epoch,
                  uint2* dec) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool in = i < n;
    murmur3::Root r{0, 0, true};
    if (in) r = murmur3::root_of<true>(keys + i * li, lw, W);
    const bool valid = in && !r.all_ones;
    const unsigned live = __ballot_sync(FULL, valid);
    uint8_t d = 0;
    if (valid) {
        const unsigned grp = live & __match_any_sync(live, r.r1) & __match_any_sync(live, r.r2);
        if (lane == __ffs(grp) - 1) {
            const size_t w = r.r1 & wmask;
            const uint32_t f1 = __ldg(bf1 + w), f2 = __ldg(bf2 + w);
            const uint32_t m = mask_of(r.r2, hfn);
            const bool in1 = (f1 & m) == m, in2 = (f2 & m) == m;
            if (!(in1 && in2)) {
                const uint32_t g = (uint32_t)__popc(grp);
                const uint32_t o =
                    rank_root(set, smask, epoch, r.r1, r.r2, g, in1 || in2 ? 1u : 2u);
                const bool first = o == 0, second = o <= 1u && o + g >= 2u;
                const bool set1 = first && !in1;
                const bool set2 = !in2 && ((first && in1) || (second && !in1));
                d = (uint8_t)(set1 | set2 << 1);
            }
        }
    }
    const unsigned bal1 = __ballot_sync(FULL, d & 1), bal2 = __ballot_sync(FULL, d & 2);
    if (lane == 0 && in)
        asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(dec + (i >> 5)), "r"(bal1),
                     "r"(bal2)
                     : "memory");
}

// Each thread applies the decisions of APPLY consecutive windows, APPLY
// bits of their warp's two ballots (0 past n), and the block adds its
// counts to the counters with one atomic each.
constexpr int APPLY = 4;

__global__ void __launch_bounds__(THREADS)
    apply_kernel(const uint32_t* keys, long long lw, long long li, int W, long long n,
                 uint32_t* bf1, uint32_t* bf2, uint32_t wmask, int hfn, const uint2* dec,
                 unsigned long long* counters) {
    __shared__ unsigned sum1[THREADS / 32], sum2[THREADS / 32];
    const long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * APPLY;
    uint32_t d1 = 0, d2 = 0;
    if (i0 < n) {
        const uint2 b = __ldcs(dec + (i0 >> 5));
        const int sh = (int)(i0 & 31);
        d1 = (b.x >> sh) & ((1u << APPLY) - 1u);
        d2 = (b.y >> sh) & ((1u << APPLY) - 1u);
    }
    for (uint32_t m = d1 | d2; m; m &= m - 1u) {
        const int j = __ffs(m) - 1;
        const murmur3::Root r = murmur3::root_of(keys + (i0 + j) * li, lw, W);
        const size_t w = r.r1 & wmask;
        const uint32_t mk = mask_of(r.r2, hfn);
        if (d1 >> j & 1u) atomicOr(bf1 + w, mk);
        if (d2 >> j & 1u) atomicOr(bf2 + w, mk);
    }
    unsigned n1 = __popc(d1), n2 = __popc(d2);
    n1 = __reduce_add_sync(FULL, n1);
    n2 = __reduce_add_sync(FULL, n2);
    if ((threadIdx.x & 31) == 0) {
        sum1[threadIdx.x / 32] = n1;
        sum2[threadIdx.x / 32] = n2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        n1 = n2 = 0;
        for (int k = 0; k < THREADS / 32; ++k) {
            n1 += sum1[k];
            n2 += sum2[k];
        }
        if (n1) atomicAdd(counters, (unsigned long long)n1);
        if (n2) atomicAdd(counters + 1, (unsigned long long)n2);
    }
}

// GATE_KEYS keys per thread, i0 + j * THREADS for j < GATE_KEYS, key words
// loaded evict-first.  Out-of-range keys read as all-ones and are skipped.
constexpr int GATE_KEYS = 2;

__global__ void __launch_bounds__(THREADS)
    gate_kernel(uint32_t* keys, long long lw, long long li, int W, long long n,
                const uint32_t* __restrict__ bf2, uint32_t wmask, int hfn) {
    constexpr int P = GATE_KEYS;
    const long long i0 = (long long)blockIdx.x * (THREADS * P) + threadIdx.x;
    uint32_t h1[P], h2[P], ones[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        h1[j] = murmur3::SEED_LO;
        h2[j] = murmur3::SEED_HI;
        ones[j] = FULL;
    }
    for (int w = 0; w < W; ++w) {
        uint32_t x[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const long long i = i0 + (long long)j * THREADS;
            x[j] = i < n ? murmur3::load_word<true>(keys + w * lw + i * li) : FULL;
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            ones[j] &= x[j];
            h1[j] = murmur3::mix(h1[j], x[j]);
            h2[j] = murmur3::mix(h2[j], x[j]);
        }
    }
    uint32_t f[P];   // an invalid (or out-of-range) key reads as a hit
#pragma unroll
    for (int j = 0; j < P; ++j)
        f[j] = ones[j] == FULL ? FULL : __ldg(bf2 + (murmur3::finish(h1[j], W) & wmask));
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const uint32_t m = mask_of(murmur3::finish(h2[j], W), hfn);
        if ((f[j] & m) != m) {
            uint32_t* col = keys + (i0 + (long long)j * THREADS) * li;
            for (int w = 0; w < W; ++w) col[w * lw] = FULL;
        }
    }
}

inline bool bad_shape(long long nwords, int hfn, long long lw, long long li, int W, long long n) {
    return nwords < 1 || (nwords & (nwords - 1)) || nwords > (1LL << 32) || hfn < 0 || W < 1 ||
           n < 0 || li < 1 || lw < 0 || (n + THREADS - 1) / THREADS > 0x7fffffffLL;
}

inline unsigned blocks(long long n, int per) {
    return (unsigned)((n + (long long)THREADS * per - 1) / ((long long)THREADS * per));
}

}  // namespace bloom

// B1.  bf1, bf2: nwords u32 words each (a power of two <= 2^32), updated in
// place.  keys: word w of window i at keys[w * lw + i * li] (K3's columns:
// lw = n, li = 1).  set: 16 * slots bytes, 16 B-aligned (slots a power of
// two >= 2n), all slots of epochs other than `epoch` (1 .. 2^31 - 1), or
// zero; with `clear` it is zeroed first (an epoch wrap).  dec: one uint2
// per 32 windows, 8 B-aligned.
// counters: two int64, overwritten with this batch's new_in_first and
// new_in_second.  Returns a cudaError_t.
extern "C" int kt_bloom_insert(void* bf1, void* bf2, long long nwords, int hfn, const void* keys,
                               long long lw, long long li, int W, long long n, void* set,
                               long long slots, long long epoch, int clear, void* dec,
                               void* counters, void* stream) {
    if (bloom::bad_shape(nwords, hfn, lw, li, W, n) || slots < 2 * n || slots < 2 ||
        (slots & (slots - 1)) || slots > (1LL << 32) || epoch < 1 || epoch > bloom::EPOCH_MAX ||
        (reinterpret_cast<uintptr_t>(set) & 15) || (reinterpret_cast<uintptr_t>(dec) & 7))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
    if (e == cudaSuccess && clear) e = cudaMemsetAsync(set, 0, 16 * (size_t)slots, s);
    if (e != cudaSuccess || n == 0) return (int)e;
    auto* kp = static_cast<const uint32_t*>(keys);
    auto* b1 = static_cast<uint32_t*>(bf1);
    auto* b2 = static_cast<uint32_t*>(bf2);
    auto* d = static_cast<uint2*>(dec);
    const uint32_t wmask = (uint32_t)(nwords - 1);
    bloom::decide_kernel<<<bloom::blocks(n, 1), bloom::THREADS, 0, s>>>(
        kp, lw, li, W, n, b1, b2, wmask, hfn, static_cast<uint32_t*>(set),
        (uint32_t)(slots - 1), (uint32_t)epoch, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bloom::apply_kernel<<<bloom::blocks(n, bloom::APPLY), bloom::THREADS, 0, s>>>(
        kp, lw, li, W, n, b1, b2, wmask, hfn, d,
        static_cast<unsigned long long*>(counters));
    return (int)cudaGetLastError();
}

// B2.  bf2: nwords u32 words; keys as for B1, overwritten in place where a
// valid key misses BF2.  Returns a cudaError_t.
extern "C" int kt_bloom_gate(const void* bf2, long long nwords, int hfn, void* keys,
                             long long lw, long long li, int W, long long n, void* stream) {
    if (bloom::bad_shape(nwords, hfn, lw, li, W, n)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    bloom::gate_kernel<<<bloom::blocks(n, bloom::GATE_KEYS), bloom::THREADS, 0,
                         (cudaStream_t)stream>>>(static_cast<uint32_t*>(keys), lw, li, W, n,
                                                 static_cast<const uint32_t*>(bf2),
                                                 (uint32_t)(nwords - 1), hfn);
    return (int)cudaGetLastError();
}
