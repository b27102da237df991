// K3: the CAANS coordinator (monotonic sequencer), for Hopper (sm_90a).
//
// Replaces the TPU kernel `coordinator_sequence_window` of
// src/repro/kernels/coordinator.py: stamp a burst of B proposals with
// msgtype = active ? P2A : NOP, inst = next_inst + j, rnd = crnd and
// vrnd = NO_ROUND, and advance the watermark to next_inst + B.  The kernel
// also writes the header's swid field (0, the hardware coordinator's id),
// which the reference fills outside its kernel: a separate fill would be a
// second launch.  Instances are int32 with wraparound, as the reference's
// int32 arithmetic.  The TPU kernel needs B to be a multiple of its block;
// every B is served here.
//
// Design.  One thread a lane.  The five fields are the rows of one (5, B)
// output.  A thread loads first (its `active` byte, the watermark and the
// round), then stores its five words from registers; thread 0 stores the
// advanced watermark last, to a separate scalar, so no lane's read of
// next_inst races with it and the sequencer is one launch.  Blocks are whole
// warps, at most 128 threads (`kernels.coordinator.sequence_geometry`).  A
// variant with a thread for 4 lanes and one 16-byte store a row was no
// faster at the paths' B = 128 and was dropped (PERF.md section 6).
//
// Bound.  Only the bytes the kernel reads and writes count:
//   reads:  active B (bool) + next_inst, crnd 8
//   writes: msgtype, inst, rnd, vrnd, swid 5*B*4 + next_out 4
// At B=128: 136 B read + 2,564 B written = 2,700 B, 0.8 ns at the card's
// 3.35 TB/s -- a launch of this size is bound by launch latency, which
// chip_smoke.py times as an empty kernel on the same grid.
#include <cuda_runtime.h>

#define MSG_NOP 0
#define MSG_P2A 3
#define NO_ROUND (-1)

__global__ void coordinator_sequence_kernel(
    const int* __restrict__ next_inst_p,         // int32[]  watermark
    const int* __restrict__ crnd_p,              // int32[]  coordinator round
    const unsigned char* __restrict__ active,    // bool[B]
    int B,
    int* __restrict__ out,                       // int32[5, B] out
    int* __restrict__ next_out)                  // int32[]  out: next_inst + B
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= B) return;
    const bool act = active[j];
    const unsigned base = (unsigned)(*next_inst_p);
    const int crnd = *crnd_p;
    out[j] = act ? MSG_P2A : MSG_NOP;
    out[B + j] = (int)(base + (unsigned)j);
    out[2 * B + j] = crnd;
    out[3 * B + j] = NO_ROUND;
    out[4 * B + j] = 0;
    if (j == 0) *next_out = (int)(base + (unsigned)B);
}

// `threads` and `blocks` are the host's launch shape (`sequence_geometry`).
extern "C" int coordinator_sequence(
    const void* next_inst, const void* crnd, const void* active, int B,
    void* out, void* next_out, int threads, int blocks, void* stream)
{
    if (B < 1 || threads < 1 || threads > 1024 || blocks < 1 || (long long)threads * blocks < B)
        return (int)cudaErrorInvalidValue;
    coordinator_sequence_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)next_inst, (const int*)crnd, (const unsigned char*)active, B, (int*)out,
        (int*)next_out);
    return (int)cudaGetLastError();
}
