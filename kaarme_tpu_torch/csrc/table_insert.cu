// T1: batched insert into the open-addressing k-mer count table with
// atomics (CUDA C++, sm_90a).
//
// Replaces kaarme_tpu/ops/table.py::insert, which is XLA ops and not a
// Pallas kernel: TPUs have no atomics, so the JAX package claims slots by
// batched probe rounds ("CAS by write-then-verify": every pending window
// gathers its slot, scatters its key row into it when it was empty,
// gathers it back and keeps the slot when the row is its own), up to
// max_probes rounds of about ten gathers and scatters plus a host
// reduction each.  The card has atomics, so here one thread carries one
// window down its probe chain (h + i(i+1)/2) & (C - 1) alone, with one
// launch per batch.
//
// The slot protocol.  counts[slot] is the slot's state: 0 empty, BUSY (a
// reserved negative) while a claimer writes the key row, > 0 published.
// Per probe: load the count with acquire semantics; if it is 0, try
// atomicCAS(0 -> BUSY): the winner writes its W key words and publishes
// its amount with a release store, which orders the key words before it.
// Anyone else who finds BUSY (or loses the CAS) waits until the count is
// published (acquire loads with a __nanosleep back-off), then compares
// the stored key with its own: equal -> atomicAdd its amount, done;
// different -> next probe.  Waiting, and never moving past a BUSY slot,
// is what keeps a key in ONE slot: a window that skipped a slot being
// claimed by its own key would claim a second one further down.  Nothing
// waits between a claim and its publish, so a spinning lane never waits
// on itself; Hopper's independent thread scheduling lets it wait on a
// claimer in its own warp.  Key words are compared one at a time, so any
// W works (no 64-bit CAS of the key, which covers only W <= 2); table key
// words are read through L2 (ld.cg), which the release/acquire pair
// orders.  A slot never returns to empty and amounts are positive
// (callers mask the rest with `valid`), so every stored key sits on its
// own probe chain with every earlier slot of that chain occupied: the
// probe-round lookup finds it, and the number of slots with a count > 0
// is the number of distinct keys.
//
// Output: pending[i] = 1 exactly for the valid windows that found
// neither their key nor an empty slot in max_probes probes, and the
// number of them in one device int (one ballot and one atomicAdd per
// warp), so the host reads one scalar per batch.
//
// What bounds it on the H100: bytes and latency.  Each window reads its
// key words, validity, hash and amount once, and each probe touches at
// least one 32 B sector of the counts and one of the key row, scattered
// over a table far larger than L2 (2^23 slots x 5 words at k=51), so
// every probe is a dependent round trip to device memory; 256 threads
// per block keep many windows in flight to hide it.  Hot keys (poly-A:
// every lane adds to one address) serialise on that address's atomics:
// slow, not wrong.  Warp aggregation is not done here.
#include <cstdint>
#include <cuda_runtime.h>

namespace t1 {

constexpr int THREADS = 256;
constexpr int BUSY = (int)0x80000000;  // counts are positive once published

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The published count of a slot seen BUSY: wait for its claimer.
__device__ __forceinline__ int wait_published(const int* p) {
    unsigned ns = 32;
    int c;
    while ((c = ld_acquire(p)) == BUSY) {
        __nanosleep(ns);
        ns = ns < 1024 ? 2 * ns : ns;
    }
    return c;
}

// One window down its probe chain; false when it is still pending.
__device__ bool insert_one(uint32_t* tk, int* cn, uint32_t mask, int W, const uint32_t* key,
                           long long ld, uint32_t h, int amt, int max_probes) {
    for (int p = 0; p < max_probes; ++p) {
        const uint32_t pu = (uint32_t)p;
        const uint32_t slot = (h + ((pu * (pu + 1u)) >> 1)) & mask;   // wraps as u32
        int* cp = cn + slot;
        uint32_t* row = tk + (size_t)slot * W;
        int c = ld_acquire(cp);
        if (c == 0) {
            if (atomicCAS(cp, 0, BUSY) == 0) {
                for (int w = 0; w < W; ++w) row[w] = __ldg(key + w * ld);
                st_release(cp, amt);
                return true;
            }
            c = BUSY;   // lost the claim: read the winner's count with acquire below
        }
        if (c == BUSY) c = wait_published(cp);
        bool eq = true;
        for (int w = 0; w < W && eq; ++w) eq = __ldcg(row + w) == __ldg(key + w * ld);
        if (eq) {
            atomicAdd(cp, amt);
            return true;
        }
    }
    return false;
}

__global__ void __launch_bounds__(THREADS)
    insert_kernel(uint32_t* tk, int* cn, uint32_t mask, int W, const uint32_t* keys, long long ld,
                  const uint8_t* valid, const uint32_t* h, const int* amount, long long n,
                  int max_probes, uint8_t* pending, int* npending) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    bool pend = false;
    if (i < n) {
        if (valid[i])
            pend = !insert_one(tk, cn, mask, W, keys + i, ld, h[i], amount ? amount[i] : 1,
                               max_probes);
        pending[i] = pend;
    }
    // every lane of the grid reaches this (no early return above)
    const unsigned b = __ballot_sync(0xffffffffu, pend);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(npending, __popc(b));
}

}  // namespace t1

// tkeys: (cap, W) u32 rows, row-major; counts: cap int32 (0 = empty),
// cap a power of two <= 2^32.  keys: W u32 columns of stride ld >= n;
// valid: n bytes (0/1); h: n u32 slot hashes; amount: n int32 > 0 or
// null (1 each).  Writes pending (n bytes) and npending (one int32).
// Returns a cudaError_t.
extern "C" int kt_table_insert(void* tkeys, void* counts, long long cap, int W, const void* keys,
                               long long ld, const void* valid, const void* h, const void* amount,
                               long long n, int max_probes, void* pending, void* npending,
                               void* stream) {
    if (cap < 1 || (cap & (cap - 1)) || cap > (1LL << 32) || W < 1 || n < 0 || ld < n ||
        max_probes < 0 || (n + t1::THREADS - 1) / t1::THREADS > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(npending, 0, sizeof(int), s);
    if (e != cudaSuccess || n == 0) return (int)e;
    t1::insert_kernel<<<(unsigned)((n + t1::THREADS - 1) / t1::THREADS), t1::THREADS, 0, s>>>(
        static_cast<uint32_t*>(tkeys), static_cast<int*>(counts), (uint32_t)(cap - 1), W,
        static_cast<const uint32_t*>(keys), ld, static_cast<const uint8_t*>(valid),
        static_cast<const uint32_t*>(h), static_cast<const int*>(amount), n, max_probes,
        static_cast<uint8_t*>(pending), static_cast<int*>(npending));
    return (int)cudaGetLastError();
}
