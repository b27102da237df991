// K4: the snapshot seal's digest, for Hopper (sm_90a).
//
// Replaces the TPU kernel `digest` of src/repro/kernels/digest.py and its
// leaf loop `tree_digest`: the weighted fold
//     sum_i bits(x_i) * (2i + 1) mod 2^32
// over the flat 32-bit pattern of each int32 or float32 leaf (floats are
// bit-cast), i the flat index within the leaf.  The leaves' digests are
// combined on the host (`kernels.digest.combine`).
//
// Design.  One launch folds every leaf of a seal (at most MAX_LEAVES), and
// writes one digest a leaf.  The leaf table travels by value in the
// kernel's parameters; the host (`kernels.digest.digest_geometry`) splits
// each leaf into a scalar head up to its first 16-byte boundary, a body of
// int4 words and a scalar tail of at most 3 words, and gives each leaf a
// run of blocks, each block one contiguous chunk of the leaf's body.  A
// thread reads its share of the chunk with 16-byte non-coherent loads,
// UNROLL in flight; the leaf's first block also folds the head and tail.
// So a leaf that is a view at any 4-byte offset runs the vector body on its
// interior.  The weights come in uint32 from the 64-bit flat index, so a
// leaf past 2^31 words wraps as the reference's int32 index does.
//
// No memset, no scratch and no fence.  Each leaf has its own 64-bit word
// of the stream's ticket: a block adds its partial sum and a count of 1 at
// bit 48 in one atomicAdd, so the partial travels with the ticket and no
// store, fence or second read has to precede or follow it.  The block whose
// add returns a count of the leaf's blocks less one is the leaf's last: it
// writes the leaf's digest, the low 32 bits of the returned sum plus its
// own, and sets the word back to 0, so the next launch (or the replay of a
// CUDA graph) finds it zeroed.  The words are zeroed once when the wrapper
// first allocates them, a row of MAX_LEAVES for each stream and one for
// each launch captured in a CUDA graph, so two digests in flight never
// share one (`kernels.digest._ticket_row`).  The sum of a leaf's partials
// stays below 2^48 while it has fewer than 2^16 blocks (checked on the
// host), and addition mod 2^32 commutes, so the result is bit-exact
// whatever order the blocks run in.  An empty leaf has no block: block 0
// writes its 0.
//
// The first design was a grid-stride loop of scalar loads over one leaf
// with a fixed grid of 8 blocks an SM and one atomicAdd a block into a word
// the wrapper zero-filled (a fill launch before it): a launch and a fill a
// leaf.  Its times stand in PERF.md.
//
// Bound.  Each word is read once (4 bytes) and costs one multiply-add, so
// the fold is bound by the bytes read: 4n bytes over the card's memory
// rate.  At a seal of 1 MB that is 0.3 us, under a launch; from tens of
// MB on the sweep in chip_smoke.py reads it against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEAVES 8
#define THREADS 256  // threads a block: one int4 each per unit of a chunk
#define UNROLL 4     // int4 loads in flight per thread

struct Leaf {
    const uint32_t* x;  // the leaf's first word
    long long head;     // scalar words before the first 16-byte boundary
    long long body;     // int4 words after them
    long long tail;     // scalar words after the body
    long long chunk;    // int4 words a block
    int first;          // the leaf's first block
    int blocks;         // its blocks (0 for an empty leaf)
};

struct LeafTable {
    Leaf leaf[MAX_LEAVES];
    int count;
};

// The sum of `v` over the block, in thread 0.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warp_sums)
{
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < THREADS / 32; ++w) v += warp_sums[w];
    return v;
}

#define COUNT_SHIFT 48  // a leaf's word: the count of its blocks done above, their sum below

__global__ void __launch_bounds__(THREADS) tree_digest_kernel(
    const LeafTable t, uint32_t* __restrict__ out, unsigned long long* __restrict__ ticket)
{
    __shared__ uint32_t warp_sums[THREADS / 32];
    const int b = blockIdx.x;

    // this block's leaf and chunk, read from the table with constant indices
    const uint32_t* x = nullptr;
    long long head = 0, body = 0, tail = 0, chunk = 0, c = 0;
    int leaf = 0, blocks = 1;
#pragma unroll
    for (int l = 0; l < MAX_LEAVES; ++l) {
        if (l < t.count && b >= t.leaf[l].first && b < t.leaf[l].first + t.leaf[l].blocks) {
            x = t.leaf[l].x;
            head = t.leaf[l].head;
            body = t.leaf[l].body;
            tail = t.leaf[l].tail;
            chunk = t.leaf[l].chunk;
            c = b - t.leaf[l].first;
            leaf = l;
            blocks = t.leaf[l].blocks;
        }
    }

    uint32_t acc = 0;
    const long long start = c * chunk;
    const long long end = min(start + chunk, body);
    const uint4* v4 = reinterpret_cast<const uint4*>(x + head);
    for (long long q = start + threadIdx.x; q < end; q += (long long)THREADS * UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long qq = q + (long long)u * THREADS;
            v[u] = qq < end ? __ldg(v4 + qq) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const uint32_t w = (uint32_t)(2 * (head + 4 * (q + (long long)u * THREADS)) + 1);
            acc += v[u].x * w + v[u].y * (w + 2u) + v[u].z * (w + 4u) + v[u].w * (w + 6u);
        }
    }
    // the leaf's first block folds its head and its tail (at most 3 + 3 words)
    if (c == 0 && threadIdx.x < head + tail) {
        const long long i = threadIdx.x < head ? threadIdx.x : 4 * body + threadIdx.x;
        acc += __ldg(x + i) * (uint32_t)(2 * i + 1);
    }

    acc = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) {
        const unsigned long long old =
            atomicAdd(ticket + leaf, (1ull << COUNT_SHIFT) | (unsigned long long)acc);
        if ((old >> COUNT_SHIFT) == (unsigned long long)(blocks - 1)) {  // the leaf's last block
            out[leaf] = (uint32_t)old + acc;
            ticket[leaf] = 0ull;  // zeroed for the next launch
        }
        if (b == 0) {
#pragma unroll
            for (int l = 0; l < MAX_LEAVES; ++l)
                if (l < t.count && !t.leaf[l].blocks) out[l] = 0u;
        }
    }
}

// `table` holds `count` Leaf records as the host laid them out; `blocks`
// is the sum of their blocks, at least 1, each leaf fewer than 2^16.
// `out` holds `count` words; `ticket` MAX_LEAVES zeroed words that no
// other launch in flight uses.
extern "C" int tree_digest(const void* table, int count, void* out, void* ticket, int blocks,
                           void* stream)
{
    if (count < 1 || count > MAX_LEAVES || blocks < 1) return (int)cudaErrorInvalidValue;
    LeafTable t = {};
    const Leaf* leaves = (const Leaf*)table;
    long long total = 0;
    for (int l = 0; l < count; ++l) {
        const Leaf& f = leaves[l];
        if (f.head < 0 || f.head > 3 || f.tail < 0 || f.tail > 3 || f.body < 0 || f.blocks < 0
            || f.blocks >= (1 << (64 - COUNT_SHIFT)) || f.first != total
            || (f.blocks && (f.chunk < 1 || f.chunk * f.blocks < f.body))
            || (!f.blocks && f.head + f.body + f.tail)
            || (((uintptr_t)(f.x + f.head) & 15) && f.body))
            return (int)cudaErrorInvalidValue;
        t.leaf[l] = f;
        total += f.blocks;
    }
    if (total != blocks) return (int)cudaErrorInvalidValue;
    t.count = count;
    tree_digest_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        t, (uint32_t*)out, (unsigned long long*)ticket);
    return (int)cudaGetLastError();
}

// The size of one Leaf record, which the host checks against its layout.
extern "C" int tree_digest_leaf_bytes() { return (int)sizeof(Leaf); }
