// K8: the learner's quorum over the acceptors' vote batches, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `learner_quorum_window` of
// src/repro/kernels/learner.py:56 (body `_learner_kernel`).  For each lane j
// of the A position-aligned vote batches:
//   win[j]     = max over a of (type[a, j] == P2B ? vrnd[a, j] : NO_ROUND)
//   agree[a]   = type[a, j] == P2B && vrnd[a, j] == win[j]
//   deliver[j] = (count of agree >= quorum), int32 0/1
//   value[j]   = value[first agreeing a, j], or 0 where no acceptor agrees.
// The 0 follows the TPU kernel (its one-hot contraction is empty there),
// not `repro.core.batched.learner_quorum`, which returns acceptor 0's value
// on such a lane; votes the system makes carry value 0 on REJECT, so only
// foreign inputs tell the two apart.
//
// The design.  The first K8 ran one thread a lane: it read the lane's A
// types and vrnds twice (the max, then the agreement), and only then
// copied the first agreeing acceptor's V words one int32 at a time, 4*V
// bytes from its neighbour's: two dependent global round trips, then
// scattered 4-byte loads and stores (its times stand in PERF.md).  Now a
// team of T threads serves one lane, the team and its chunks those of
// csrc/team.cuh, in three steps:
//   Load.  Every load first: each thread reads the lane's (type, vrnd) of
//     the first VOTE_CAP acceptors and its own first value chunk of each of
//     them, so the value no longer waits on the decision.  Above the cap
//     the rest of the votes follow in a loop, and a thread reloads its
//     chunk only on a lane whose first agreeing acceptor lies past the cap.
//   Decide.  In registers, in one pass over a: win is the running max, and
//     count and the first agreeing acceptor restart whenever it rises.
//     Every thread of the team reads the same votes and reaches the same
//     answer, so the team needs no shuffle.
//   Store.  Thread 0 stores deliver and win; each thread its chunks of the
//     chosen row (int4 stores in the vector variant), zeros where no
//     acceptor agrees.  A chunk past a thread's first (V over 4*T words in
//     the vector variant, over T in the scalar one; never at the paths' V)
//     is loaded after the decision, PASS at a time.
// Two variants of the body, as K2's: vector (V % 4 == 0 and the vote
// values and the output value start on 16 bytes: int4 chunks, T the power
// of two at or above V/4, 4 at V = 16) and scalar (int32 chunks, T at or
// above V), T at most 32, blocks of `threads` (whole teams): at V=16 and
// 128 threads, 4 blocks at B=128 and 16 at B=512.  The wrapper chooses
// variant, team and block on the host (`kernels.wirepath.lane_geometry`);
// the entry checks them again.
//
// Bound.  Only the bytes the kernel must read and write count, whatever it
// loads speculatively:
//   reads:  type, vrnd 2*A*B*4 + the first agreeing acceptor's value
//           L*V*4 for the L lanes where one agrees
//   writes: deliver, win 2*B*4 + value B*V*4
// At A=3, B=128, V=16 with every lane agreed: 11,264 B read + 9,216 B
// written = 20,480 B, 6.1 ns at the card's 3.35 TB/s -- far below a
// launch's latency, so a launch of this size is bound by launch latency.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

#include "team.cuh"

#define MSG_P2B 4
#define NO_ROUND (-1)
#define VOTE_CAP 8  // acceptors whose votes and value chunk a thread loads before it decides

struct Quorum {
    int win = INT_MIN;  // the running max of (P2B ? vrnd : NO_ROUND)
    int count = 0;      // P2B votes at win so far
    int first = -1;     // the first of them, or -1

    __device__ __forceinline__ void see(int type, int vrnd, int a) {
        const bool vote = type == MSG_P2B;
        const int m = vote ? vrnd : NO_ROUND;
        if (m > win) {
            win = m;
            count = vote;
            first = vote ? a : -1;
        } else if (m == win && vote) {
            ++count;
            if (first < 0) first = a;
        }
    }
};

template <typename Word>
__global__ void learner_quorum_kernel(
    int quorum, int A, int B, int V, int team,
    const int* __restrict__ vtype,  // int32[A, B]
    const int* __restrict__ vvrnd,  // int32[A, B]
    const int* __restrict__ vval,   // int32[A, B, V]
    int* __restrict__ deliver,      // int32[B] out (0/1)
    int* __restrict__ win_out,      // int32[B] out
    int* __restrict__ value)        // int32[B, V] out
{
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int j = team_lane_index(team);
    if (j >= B) return;  // the whole team
    const int chunks = V / W;
    const size_t stride = (size_t)B * chunks;  // words from one acceptor's values to the next's
    const Word* const src = reinterpret_cast<const Word*>(vval) + (size_t)j * chunks;  // a = 0
    const int c0 = tm.t;  // this thread's first chunk

    // load
    int ty[VOTE_CAP], vr[VOTE_CAP];
    Word chunk[VOTE_CAP];
#pragma unroll
    for (int a = 0; a < VOTE_CAP; ++a) {
        ty[a] = a < A ? __ldg(vtype + (size_t)a * B + j) : 0;
        vr[a] = a < A ? __ldg(vvrnd + (size_t)a * B + j) : 0;
        chunk[a] = a < A && c0 < chunks ? __ldg(src + a * stride + c0) : zero_word<Word>();
    }

    // decide
    Quorum qu;
#pragma unroll
    for (int a = 0; a < VOTE_CAP; ++a)
        if (a < A) qu.see(ty[a], vr[a], a);
    for (int a = VOTE_CAP; a < A; ++a)
        qu.see(__ldg(vtype + (size_t)a * B + j), __ldg(vvrnd + (size_t)a * B + j), a);

    // store
    if (tm.t == 0) {
        deliver[j] = qu.count >= quorum;
        win_out[j] = qu.win;
    }
    Word* const dst = reinterpret_cast<Word*>(value) + (size_t)j * chunks;
    if (c0 < chunks) {
        Word w = zero_word<Word>();
#pragma unroll
        for (int a = 0; a < VOTE_CAP; ++a)
            if (a == qu.first) w = chunk[a];
        if (qu.first >= VOTE_CAP) w = __ldg(src + qu.first * stride + c0);
        dst[c0] = w;
    }
    const Word* const row = src + (qu.first > 0 ? qu.first : 0) * stride;
    for (int p0 = tm.size; p0 < chunks; p0 += PASS * tm.size) {
        Word w[PASS];
        if (qu.first >= 0) {
            load_pass(w, row, tm, chunks, p0);
        } else {
#pragma unroll
            for (int i = 0; i < PASS; ++i) w[i] = zero_word<Word>();
        }
        store_pass(w, dst, tm, chunks, p0);
    }
}

extern "C" int learner_quorum(
    int quorum, int A, int B, int V,
    const void* vtype, const void* vvrnd, const void* vval,
    void* deliver, void* win, void* value,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || B < 1 || V < 1 || !team_shape_ok(vec, team, threads, V, {vval, value}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const int blocks = (B + lanes - 1) / lanes;
    auto go = [&](auto word) {
        learner_quorum_kernel<decltype(word)><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            quorum, A, B, V, team, (const int*)vtype, (const int*)vvrnd, (const int*)vval,
            (int*)deliver, (int*)win, (int*)value);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}
