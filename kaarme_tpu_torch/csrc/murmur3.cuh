// murmur3_x86_32 over packed k-mer key words, in registers: the hash of
// ops/hashing.py::hash_words bit for bit (one 32-bit block per key word,
// final length 4W).  T1 (table_insert.cu) takes its slot hash from it with
// the first seed; the Bloom kernels (bloom.cu) take a key's 64-bit root
// (r1, r2) from both seeds, as ops/hashing.py::hash_words64 does.
#pragma once

#include <cstdint>

namespace murmur3 {

constexpr uint32_t SEED_LO = 0x9747B28Cu;   // hash_words' default seed, r1
constexpr uint32_t SEED_HI = 0x5BD1E995u;   // hash_words64's second seed, r2

// One 32-bit block.
__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t x) {
    x *= 0xCC9E2D51u;
    x = (x << 15) | (x >> 17);
    x *= 0x1B873593u;
    h ^= x;
    h = (h << 13) | (h >> 19);
    return h * 5u + 0xE6546B64u;
}

// The finalizer: full avalanche.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// The hash of W key words after their blocks: the length, then fmix32.
__device__ __forceinline__ uint32_t finish(uint32_t h, int W) {
    return fmix32(h ^ (4u * (uint32_t)W));
}

// One key's W words, word w at col[w * lw], read once with coherent loads
// (the -b gate may overwrite them afterwards): its 64-bit root (hash under
// SEED_LO, hash under SEED_HI) and whether every word is all-ones (K3's
// invalid key, and the -b gate's missed key).  STREAM loads them with the
// evict-first hint (ld.global.cs), for a pass that reads each key once and
// wants the cache lines it probes elsewhere to stay in L2.
struct Root {
    uint32_t r1, r2;
    bool all_ones;
};

// One key word: evict-first (STREAM) or a plain load.
template <bool STREAM>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
    if constexpr (STREAM) return __ldcs(p);
    else return *p;
}

template <bool STREAM = false>
__device__ __forceinline__ Root root_of(const uint32_t* col, long long lw, int W) {
    uint32_t h1 = SEED_LO, h2 = SEED_HI, ones = 0xffffffffu;
    for (int w = 0; w < W; ++w) {
        const uint32_t x = load_word<STREAM>(col + w * lw);
        ones &= x;
        h1 = mix(h1, x);
        h2 = mix(h2, x);
    }
    return Root{finish(h1, W), finish(h2, W), ones == 0xffffffffu};
}

}  // namespace murmur3
