// The team of threads that serves one lane, shared by the lane bodies of
// csrc/wirepath.cu (K1, K5, K6), csrc/vote.cu (K2, K7) and csrc/learner.cu
// (K8).
//
// A team is T threads of one warp, T a power of two dividing 32, so a team
// never straddles a warp and its shuffles and `__syncwarp` name only its own
// threads.  Blocks hold whole teams: blockDim.x / T lanes a block.  Thread t
// of a team owns the value chunks t, t + T, ... of its lane: int4 words in
// the vector variant, int32 words in the scalar one (the `Word` template
// argument), PASS chunks in registers at a time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#define PASS 2  // value chunks a team thread holds in registers at once

struct Team {
    int t;          // this thread's rank in its team
    int size;       // T, a power of two dividing 32
    unsigned mask;  // the team's threads in the warp
};

__device__ __forceinline__ Team team_of(int size) {
    const int lane = threadIdx.x & 31;
    Team tm;
    tm.t = lane & (size - 1);
    tm.size = size;
    tm.mask = size == 32 ? 0xffffffffu : ((1u << size) - 1u) << (lane & ~(size - 1));
    return tm;
}

// The lane j this thread's team serves: blocks hold blockDim.x / T teams.
__device__ __forceinline__ int team_lane_index(int size) {
    return blockIdx.x * (blockDim.x / size) + threadIdx.x / size;
}

template <typename Word> __device__ __forceinline__ Word zero_word();
template <> __device__ __forceinline__ int zero_word<int>() { return 0; }
template <> __device__ __forceinline__ int4 zero_word<int4>() { return make_int4(0, 0, 0, 0); }

// The chunks p0 + t + i*T (i < PASS) this thread owns, through the
// non-coherent path (the burst is read-only for the whole launch).
template <typename Word>
__device__ __forceinline__ void load_pass(Word (&w)[PASS], const Word* __restrict__ src,
                                          const Team& tm, int chunks, int p0) {
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
        const int c = p0 + tm.t + i * tm.size;
        w[i] = c < chunks ? __ldg(src + c) : zero_word<Word>();
    }
}

template <typename Word>
__device__ __forceinline__ void store_pass(const Word (&w)[PASS], Word* __restrict__ dst,
                                           const Team& tm, int chunks, int p0) {
#pragma unroll
    for (int i = 0; i < PASS; ++i) {
        const int c = p0 + tm.t + i * tm.size;
        if (c < chunks) dst[c] = w[i];
    }
}

static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The launch shape the wrapper chose: T a power of two dividing 32, blocks
// of whole warps; the vector variant only where V % 4 == 0 and every value
// tensor it names starts on 16 bytes.
static inline bool team_shape_ok(int vec, int team, int threads, int V,
                                 std::initializer_list<const void*> values) {
    if (team < 1 || team > 32 || (team & (team - 1)) || threads < 32 || threads > 1024
        || threads % 32)
        return false;
    if (!vec) return true;
    if (V % 4) return false;
    for (const void* p : values)
        if (!aligned16(p)) return false;
    return true;
}
