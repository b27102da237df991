// K4: the snapshot seal's digest, for Hopper (sm_90a).
//
// Replaces the TPU kernel `digest` of src/repro/kernels/digest.py: the
// weighted fold sum_i bits(x_i) * (2i + 1) mod 2^32 over the flat 32-bit
// pattern of an int32 or float32 array (floats are bit-cast).
//
// Design.  A grid-stride loop over the flat array with uint32 products; each
// block reduces its partial sum through warp shuffles and shared memory,
// then adds it with one atomicAdd into a uint32 the wrapper has zeroed.
// Addition mod 2^32 does not depend on order, so the result is bit-exact
// whatever order the blocks run in.  The TPU kernel zero-pads to its block;
// the grid-stride loop masks the ragged end instead, which adds nothing.
//
// Bound.  Each element is read once (4 bytes) and costs one multiply-add, so
// the fold is bound by the bytes read: 4n bytes over the card's memory rate.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void digest_kernel(const uint32_t* __restrict__ x, long long n,
                              uint32_t* __restrict__ out)
{
    uint32_t acc = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
        acc += x[i] * (uint32_t)(2 * i + 1);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    __shared__ uint32_t warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0u;
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) atomicAdd(out, acc);
    }
}

extern "C" int digest(const void* x, long long n, void* out, int blocks, void* stream)
{
    if (n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
    digest_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, n, (uint32_t*)out);
    return (int)cudaGetLastError();
}
