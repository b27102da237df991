// K3: the CAANS coordinator (monotonic sequencer), for Hopper (sm_90a).
//
// Replaces the TPU kernel `coordinator_sequence_window` of
// src/repro/kernels/coordinator.py: stamp a burst of B proposals with
// msgtype = active ? P2A : NOP, inst = next_inst + j, rnd = crnd and
// vrnd = NO_ROUND, and advance the watermark to next_inst + B.
//
// Design.  One thread per lane j.  Thread 0 writes the advanced watermark
// to a separate scalar, so no lane's read of next_inst races with it and the
// sequencer is one launch.  The kernel also writes the header's swid field
// (0, the hardware coordinator's id), which the reference fills outside its
// kernel: a separate fill would be a second launch.  Instances are int32
// with wraparound, as the reference's int32 arithmetic.  The TPU kernel
// needs B to be a multiple of its block; the guard `j < B` serves any B.
//
// Bound.  Only the bytes the kernel reads and writes count:
//   reads:  active B (bool) + next_inst, crnd 8
//   writes: msgtype, inst, rnd, vrnd, swid 5*B*4 + next_out 4
// At B=128: 136 B read + 2,564 B written = 2,700 B, 0.8 ns at the card's
// 3.35 TB/s -- a launch of this size is bound by launch latency.
#include <cuda_runtime.h>

#define MSG_NOP 0
#define MSG_P2A 3
#define NO_ROUND (-1)

__global__ void coordinator_sequence_kernel(
    const int* __restrict__ next_inst_p,        // int32[]  watermark
    const int* __restrict__ crnd_p,             // int32[]  coordinator round
    const unsigned char* __restrict__ active,   // bool[B]
    int B,
    int* __restrict__ msgtype,   // int32[B] out
    int* __restrict__ inst,      // int32[B] out
    int* __restrict__ rnd,       // int32[B] out
    int* __restrict__ vrnd,      // int32[B] out
    int* __restrict__ swid,      // int32[B] out
    int* __restrict__ next_out)  // int32[]  out: next_inst + B
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= B) return;
    const unsigned base = (unsigned)(*next_inst_p);
    if (j == 0) *next_out = (int)(base + (unsigned)B);
    msgtype[j] = active[j] ? MSG_P2A : MSG_NOP;
    inst[j] = (int)(base + (unsigned)j);
    rnd[j] = *crnd_p;
    vrnd[j] = NO_ROUND;
    swid[j] = 0;
}

extern "C" int coordinator_sequence(
    const void* next_inst, const void* crnd, const void* active, int B,
    void* msgtype, void* inst, void* rnd, void* vrnd, void* swid, void* next_out,
    void* stream)
{
    if (B < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    coordinator_sequence_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)next_inst, (const int*)crnd, (const unsigned char*)active, B,
        (int*)msgtype, (int*)inst, (int*)rnd, (int*)vrnd, (int*)swid, (int*)next_out);
    return (int)cudaGetLastError();
}
