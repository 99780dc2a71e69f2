// T1: batched insert into the open-addressing k-mer count table, straight
// from K3's key columns (CUDA C++, sm_90a).
//
// Replaces the chain "validity + hash_words + insert" in front of
// kaarme_tpu/ops/table.py::insert, which is XLA ops and not a Pallas
// kernel: TPUs have no atomics, so the JAX package claims slots by batched
// probe rounds ("CAS by write-then-verify"), up to max_probes rounds of
// about ten gathers and scatters plus a host reduction each, fed by a
// validity mask and ops/hashing.hash_words.  Here one launch per batch
// reads the W u32 key columns as K3 writes them and, per window, in
// registers:
// - validity: a window is valid unless every key word is all-ones (K3's
//   invalid key, and what the -b Bloom gate writes into a missed key; no
//   canonical key is all-ones).  A caller may pass its own mask instead
//   (grow-and-retry passes its pending set);
// - the slot hash: murmur3_x86_32 (murmur3.cuh), seed 0x9747B28C, final length 4W, bit
//   for bit ops/hashing.hash_words (a caller may pass it: the sharded
//   table has it from routing);
// - warp aggregation: among the warp's valid lanes, __match_any_sync over
//   each key word in turn, intersected, groups the lanes whose W words are
//   ALL equal (a hash collision never merges two keys).  The group's
//   lowest lane, its leader, carries the group's summed amount (a shuffle
//   sum, or __popc of the group without amounts) down the probe chain
//   (h + i(i+1)/2) & (C - 1), i < max_probes, once; the others take its
//   outcome by __shfl_sync, so a group that found no slot is pending on
//   every lane (its amounts are all still to insert, none landed).  A hot
//   key (poly-A, microsatellites) costs one atomic per warp, not per lane.
//
// The slot protocol.  counts[slot] is the slot's state: 0 empty, BUSY (a
// reserved negative) while a claimer writes the key row, > 0 published.
// It keeps three guarantees: one key lives in one slot; no lane passes a
// slot while it is BUSY (a lane that skipped a slot being claimed by its
// own key would claim a second one further down); nothing waits between a
// claim and its publish, so a spinning lane never waits on itself, and
// Hopper's independent thread scheduling lets it wait on a claimer in its
// own warp (the followers wait at the __shfl_sync after the probe loop,
// holding no slot).  Per probe:
// 1. load the slot's count with a relaxed (strong, L1-bypassing) load;
// 2. count 0: atomicCAS(0 -> BUSY).  The winner writes its W key words and
//    publishes its amount with st.release, which orders the key words
//    before the count.  A loser has the CAS's returned value;
// 3. BUSY: reload (relaxed, with a __nanosleep back-off) until published;
// 4. published: fence.acq_rel, then compare the row with the key: equal ->
//    atomicAdd the amount, done; different -> next probe.
// What the PTX memory model needs for step 4: the key row is written by
// weak stores before the claimer's st.release of the count; our relaxed
// load (or CAS) of the count, followed by fence.acq_rel, is an acquire
// pattern, so when the value read comes from that release (or from an
// atomicAdd after it: RMWs on the count continue its release sequence) the
// claimer's row writes happen before our row loads, which therefore see
// the whole row.  Ordering is needed only where a row is read after its
// count, so the claim and the BUSY wait load relaxed (an earlier design
// used ld.acquire on every count load); the common path (the key
// published long ago, found at the first probe) costs one count load,
// one fence, one row load and one fire-and-forget atomicAdd.  On the
// card this protocol, the acquire load on every probe, and either one
// with the key row prefetched into L2 beside the count load timed alike
// (within the call-to-call spread, time_kernels.py --kernel t1): each
// probe is two dependent random sectors of device memory, and that, not
// the instructions around them, sets its time, so the kernel does not
// prefetch (one slot row holding count and key would halve the sectors:
// a layout change, ROADMAP).  A slot never returns to empty and amounts are positive, so every stored key
// sits on its own probe chain with every earlier slot of that chain
// occupied: the probe-round lookup finds it, and the number of slots with
// a count > 0 is the number of distinct keys.
//
// Output: pending[i] = 1 exactly for the valid windows that found neither
// their key nor an empty slot in max_probes probes, and their number in
// one device int (one ballot and one atomicAdd per warp), so the host
// reads one scalar per batch.
//
// What bounds it on the H100: random sectors of device memory.  Each
// window reads its 4W key bytes once (coalesced columns) and writes its
// pending byte; each probe touches a 32 B sector of the counts and one or
// two of the key rows, scattered over a table far larger than L2 (2^23
// slots x 5 words at k=51), so every probe is a round trip to device
// memory; 256 threads per block keep many windows in flight.  The key words stay in registers
// (up to 16 of them, a template size R in 1, 2, 4, 8, 16 so that small W
// keeps a small register count); words past 16 (k > 256) are read again
// from the columns.
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace t1 {

constexpr int THREADS = 256;
constexpr int BUSY = (int)0x80000000;  // counts are positive once published
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ld_relaxed(const int* p) {
    int v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void fence_acq_rel() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One window's key: its first R words in registers, the rest (W > R) read
// again from the columns (word w of the window at col[w * lw]).
template <int R>
struct Key {
    uint32_t r[R];
    const uint32_t* col;
    long long lw;
    int W;

    __device__ __forceinline__ uint32_t far(int w) const { return __ldg(col + w * lw); }

    // Does the (published) table row hold this key?  All loads issued
    // before any compare: one round trip for the row.
    __device__ __forceinline__ bool in_row(const uint32_t* row) const {
        bool eq = true;
#pragma unroll
        for (int w = 0; w < R; ++w)
            if (w < W) eq &= __ldcg(row + w) == r[w];
        for (int w = R; w < W; ++w) eq &= __ldcg(row + w) == far(w);
        return eq;
    }

    __device__ __forceinline__ void store(uint32_t* row) const {
#pragma unroll
        for (int w = 0; w < R; ++w)
            if (w < W) row[w] = r[w];
        for (int w = R; w < W; ++w) row[w] = far(w);
    }
};

// The published count of a slot seen BUSY: wait for its claimer.
__device__ __forceinline__ int wait_published(const int* p) {
    unsigned ns = 32;
    int c;
    while ((c = ld_relaxed(p)) == BUSY) {
        __nanosleep(ns);
        ns = ns < 1024 ? 2 * ns : ns;
    }
    return c;
}

// One key (a group's leader) down its probe chain; false when it is still
// pending.
template <int R>
__device__ __forceinline__ bool insert_one(uint32_t* tk, int* cn, uint32_t mask, const Key<R>& key, uint32_t h,
                           int amt, int max_probes) {
    const int W = key.W;
    for (int p = 0; p < max_probes; ++p) {
        const uint32_t pu = (uint32_t)p;
        const uint32_t slot = (h + ((pu * (pu + 1u)) >> 1)) & mask;   // wraps as u32
        int* cp = cn + slot;
        uint32_t* row = tk + (size_t)slot * W;
        int c = ld_relaxed(cp);
        if (c == 0) {
            c = atomicCAS(cp, 0, BUSY);
            if (c == 0) {
                key.store(row);
                st_release(cp, amt);
                return true;
            }
        }
        if (c == BUSY) c = wait_published(cp);
        fence_acq_rel();   // acquire: the row was written before the count was published
        if (key.in_row(row)) {
            atomicAdd(cp, amt);
            return true;
        }
    }
    return false;
}

template <int R>
__global__ void __launch_bounds__(THREADS)
    insert_kernel(uint32_t* tk, int* cn, uint32_t mask, int W, const uint32_t* keys, long long lw,
                  long long li, const uint8_t* valid, const uint32_t* hin, const int* amount,
                  long long n, int max_probes, uint8_t* pending, int* npending) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool in = i < n;
    Key<R> key;
    key.col = keys + (in ? i : 0) * li;
    key.lw = lw;
    key.W = W;
    bool act = false;
    uint32_t h = 0;
    int amt = 0;
    if (in) {
        uint32_t hh = murmur3::SEED_LO, ones = 0xffffffffu;
#pragma unroll
        for (int w = 0; w < R; ++w) {
            key.r[w] = 0;
            if (w < W) {
                key.r[w] = __ldg(key.col + w * lw);
                ones &= key.r[w];
                hh = murmur3::mix(hh, key.r[w]);
            }
        }
        for (int w = R; w < W; ++w) {
            const uint32_t x = key.far(w);
            ones &= x;
            hh = murmur3::mix(hh, x);
        }
        act = valid ? valid[i] != 0 : ones != 0xffffffffu;
        h = hin ? hin[i] : murmur3::finish(hh, W);
        amt = amount ? amount[i] : 1;
    }
    const unsigned live = __ballot_sync(FULL, act);
    bool pend = false;
    if (act) {
        // the lanes whose W key words all equal this lane's
        unsigned grp = live;
#pragma unroll
        for (int w = 0; w < R; ++w)
            if (w < W) grp &= __match_any_sync(live, key.r[w]);
        for (int w = R; w < W; ++w) grp &= __match_any_sync(live, key.far(w));
        const int leader = __ffs(grp) - 1;
        int sum = __popc(grp);
        if (amount) {
            sum = amt;
            if (__any_sync(live, grp != (1u << lane))) {
                sum = 0;
                for (unsigned m = live; m; m &= m - 1) {
                    const int src = __ffs(m) - 1;
                    const int a = __shfl_sync(live, amt, src);
                    if (grp >> src & 1u) sum += a;
                }
            }
        }
        bool landed = true;
        if (lane == leader) landed = insert_one<R>(tk, cn, mask, key, h, sum, max_probes);
        pend = !__shfl_sync(live, (int)landed, leader);
    }
    if (in) pending[i] = pend;
    // every lane of the grid reaches this (no early return above)
    const unsigned b = __ballot_sync(FULL, pend);
    if (lane == 0 && b) atomicAdd(npending, __popc(b));
}

template <int R>
void launch(uint32_t* tk, int* cn, long long cap, int W, const uint32_t* keys, long long lw,
            long long li, const uint8_t* valid, const uint32_t* h, const int* amount, long long n,
            int max_probes, uint8_t* pending, int* npending, cudaStream_t s) {
    insert_kernel<R><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        tk, cn, (uint32_t)(cap - 1), W, keys, lw, li, valid, h, amount, n, max_probes, pending,
        npending);
}

}  // namespace t1

// tkeys: (cap, W) u32 rows, row-major; counts: cap int32 (0 = empty),
// cap a power of two <= 2^32.  keys: word w of window i at keys[w * lw +
// i * li] (K3's columns: lw = n, li = 1; a table's rows: lw = 1, li = W).
// valid: n bytes (0/1) or null (derived: not all-ones); h: n u32 slot
// hashes or null (derived: murmur3 of the key words); amount: n int32 > 0
// or null (1 each).  Writes pending (n bytes) and npending (one int32).
// Returns a cudaError_t.
extern "C" int kt_table_insert(void* tkeys, void* counts, long long cap, int W, const void* keys,
                               long long lw, long long li, const void* valid, const void* h,
                               const void* amount, long long n, int max_probes, void* pending,
                               void* npending, void* stream) {
    if (cap < 1 || (cap & (cap - 1)) || cap > (1LL << 32) || W < 1 || n < 0 || li < 1 ||
        max_probes < 0 || (n + t1::THREADS - 1) / t1::THREADS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(npending, 0, sizeof(int), s);
    if (e != cudaSuccess || n == 0) return (int)e;
    auto* tk = static_cast<uint32_t*>(tkeys);
    auto* cn = static_cast<int*>(counts);
    auto* kp = static_cast<const uint32_t*>(keys);
    auto* vp = static_cast<const uint8_t*>(valid);
    auto* hp = static_cast<const uint32_t*>(h);
    auto* ap = static_cast<const int*>(amount);
    auto* pp = static_cast<uint8_t*>(pending);
    auto* np = static_cast<int*>(npending);
    if (W <= 1)
        t1::launch<1>(tk, cn, cap, W, kp, lw, li, vp, hp, ap, n, max_probes, pp, np, s);
    else if (W <= 2)
        t1::launch<2>(tk, cn, cap, W, kp, lw, li, vp, hp, ap, n, max_probes, pp, np, s);
    else if (W <= 4)
        t1::launch<4>(tk, cn, cap, W, kp, lw, li, vp, hp, ap, n, max_probes, pp, np, s);
    else if (W <= 8)
        t1::launch<8>(tk, cn, cap, W, kp, lw, li, vp, hp, ap, n, max_probes, pp, np, s);
    else
        t1::launch<16>(tk, cn, cap, W, kp, lw, li, vp, hp, ap, n, max_probes, pp, np, s);
    return (int)cudaGetLastError();
}
