// K8: the learner's quorum over the acceptors' vote batches, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `learner_quorum_window` of
// src/repro/kernels/learner.py (body `_learner_kernel`).  For each lane j of
// the A position-aligned vote batches:
//   win[j]     = max over a of (type[a, j] == P2B ? vrnd[a, j] : NO_ROUND)
//   agree[a]   = type[a, j] == P2B && vrnd[a, j] == win[j]
//   deliver[j] = (count of agree >= quorum), int32 0/1
//   value[j]   = value[first agreeing a, j], or 0 where no acceptor agrees.
// The 0 follows the TPU kernel (its one-hot contraction is empty there),
// not `repro.core.batched.learner_quorum`, which returns acceptor 0's value
// on such a lane; votes the system makes carry value 0 on REJECT, so only
// foreign inputs tell the two apart.
//
// Design.  One thread per lane.  The TPU kernel selects the value with a
// one-hot (cumsum) contraction over all A value rows; here the thread finds
// the first agreeing acceptor in registers (two passes over A) and copies
// only that acceptor's V words, so the other A-1 value rows are never read.
//
// Bound.  Only the bytes the kernel reads and writes count:
//   reads:  type, vrnd 2*A*B*4 + the first agreeing acceptor's value
//           L*V*4 for the L lanes where one agrees
//   writes: deliver, win 2*B*4 + value B*V*4
// At A=3, B=128, V=16 with every lane agreed: 11,264 B read + 9,216 B
// written = 20,480 B, 6.1 ns at the card's 3.35 TB/s -- far below a
// launch's latency, so a launch of this size is bound by launch latency.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

#define MSG_P2B 4
#define NO_ROUND (-1)

__global__ void learner_quorum_kernel(
    int quorum, int A, int B, int V,
    const int* __restrict__ vtype,  // int32[A, B]
    const int* __restrict__ vvrnd,  // int32[A, B]
    const int* __restrict__ vval,   // int32[A, B, V]
    int* __restrict__ deliver,      // int32[B] out (0/1)
    int* __restrict__ win_out,      // int32[B] out
    int* __restrict__ value)        // int32[B, V] out
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= B) return;
    int win = INT_MIN;
    for (int a = 0; a < A; ++a) {
        const size_t o = (size_t)a * B + j;
        const int m = vtype[o] == MSG_P2B ? vvrnd[o] : NO_ROUND;
        win = m > win ? m : win;
    }
    int count = 0, first = -1;
    for (int a = 0; a < A; ++a) {
        const size_t o = (size_t)a * B + j;
        const bool agree = vtype[o] == MSG_P2B && vvrnd[o] == win;
        count += agree;
        if (agree && first < 0) first = a;
    }
    deliver[j] = count >= quorum;
    win_out[j] = win;
    int* dst = value + (size_t)j * V;
    if (first >= 0) {
        const int* src = vval + ((size_t)first * B + j) * V;
        for (int k = 0; k < V; ++k) dst[k] = src[k];
    } else {
        for (int k = 0; k < V; ++k) dst[k] = 0;
    }
}

extern "C" int learner_quorum(
    int quorum, int A, int B, int V,
    const void* vtype, const void* vvrnd, const void* vval,
    void* deliver, void* win, void* value, void* stream)
{
    if (A < 1 || B < 1 || V < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    learner_quorum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        quorum, A, B, V, (const int*)vtype, (const int*)vvrnd, (const int*)vval,
        (int*)deliver, (int*)win, (int*)value);
    return (int)cudaGetLastError();
}
