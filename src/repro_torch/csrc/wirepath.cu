// K1: one fused Phase-2 round of a single Paxos group, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cohort_wirepath_round` of
// src/repro/kernels/wirepath.py (its G=1 slice `wirepath_round`), whose body
// is `_phase2_block`: coordinator sequencing, the Phase-2 vote of all A
// acceptors, the learner quorum and the learner ring dedup, in one launch,
// with the six state tensors updated in place.
//
// Design.  One thread per lane j of the B-lane window; lane j addresses ring
// slot (next_inst + j) mod N and writes its instance; thread 0 writes the
// advanced watermark next_inst + B to a separate scalar, so no lane's read
// of next_inst races with it.  The A-axis vote, max, agree count and first
// agreeing acceptor stay in registers (A <= MAX_A).  Per-lane addressing
// needs no block alignment of the window, so any window base is served and
// there is no fallback path.  B <= N keeps the B slots distinct, so the
// in-place writes of different lanes never touch the same registers.
//
// Bound.  Only the bytes the kernel reads and writes count; vrnd, the
// acceptors' values and the learner's values are written, never read.
//   reads:  rnd A*B*4 + ldel, linst 2*B*4 + burst B*V*4 + alive A
//           + next_inst, crnd 8
//   writes: rnd, vrnd, val A*B*(2+V)*4 + ldel, linst, lval B*(2+V)*4
//           + next_out 4 + inst, win 2*B*4 + fresh B + value B*V*4
// (the acceptor and learner writes are the most a launch makes: every lane
// accepted by all A acceptors and fresh, as on the main path with every
// acceptor alive).  At A=3, B=128, V=16: 10,763 B read + 46,212 B written =
// 56,975 B, 17.0 ns at the card's 3.35 TB/s -- far below a launch's
// latency, so a launch of this size is bound by launch latency, not by
// device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_A 8

__global__ void wirepath_round_kernel(
    const int* __restrict__ next_inst_p,  // int32[]  window base (any value)
    const int* __restrict__ crnd_p,       // int32[]  coordinator round
    const unsigned char* __restrict__ alive,  // bool[A]
    int quorum, int limit, int A, int N, int V, int B,
    int* __restrict__ st_rnd,    // int32[A, N]      in place
    int* __restrict__ st_vrnd,   // int32[A, N]      in place
    int* __restrict__ st_val,    // int32[A, N, V]   in place
    int* __restrict__ ldel,      // int32[N]         in place
    int* __restrict__ linst,     // int32[N]         in place
    int* __restrict__ lval,      // int32[N, V]      in place
    const int* __restrict__ values,  // int32[B, V]  burst
    int* __restrict__ next_out,  // int32[]   out: next_inst + B
    int* __restrict__ inst_out,  // int32[B]  out: the lanes' instances
    bool* __restrict__ fresh,    // bool[B]   out
    int* __restrict__ win_out,   // int32[B]  out
    int* __restrict__ value_out) // int32[B, V]  out
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= B) return;
    const int crnd = *crnd_p;
    // int32 wraparound, as the reference's int32 arithmetic
    const int inst = (int)((unsigned)(*next_inst_p) + (unsigned)j);
    if (j == 0) *next_out = (int)((unsigned)(*next_inst_p) + (unsigned)B);
    inst_out[j] = inst;
    int slot = inst % N;
    if (slot < 0) slot += N;  // the non-negative modulo of jnp's `%`
    const bool permit = inst < limit;

    bool accept[MAX_A];
    int win = -1;  // max over acceptors of (accept ? crnd : NO_ROUND)
    for (int a = 0; a < A; ++a) {
        accept[a] = alive[a] != 0 && crnd >= st_rnd[(size_t)a * N + slot] && permit;
        const int vote = accept[a] ? crnd : -1;
        win = vote > win ? vote : win;
    }
    int count = 0;
    bool any_agree = false;
    for (int a = 0; a < A; ++a) {
        const bool agree = accept[a] && crnd == win;
        count += agree;
        any_agree |= agree;
    }
    const bool deliver = count >= quorum;

    const int* mval = values + (size_t)j * V;
    for (int a = 0; a < A; ++a) {
        if (!accept[a]) continue;
        const size_t r = (size_t)a * N + slot;
        st_rnd[r] = crnd;
        st_vrnd[r] = crnd;
        int* dst = st_val + r * V;
        for (int k = 0; k < V; ++k) dst[k] = mval[k];
    }

    // the decided value is the first agreeing acceptor's vote: the burst
    // value if any acceptor agrees, else 0 -- also where deliver is false
    int* vout = value_out + (size_t)j * V;
    for (int k = 0; k < V; ++k) vout[k] = any_agree ? mval[k] : 0;
    win_out[j] = win;

    const bool dup = ldel[slot] != 0 && linst[slot] == inst;
    const bool is_fresh = deliver && !dup;
    fresh[j] = is_fresh;
    ldel[slot] |= (int)deliver;
    if (is_fresh) {
        linst[slot] = inst;
        int* ldst = lval + (size_t)slot * V;
        for (int k = 0; k < V; ++k) ldst[k] = vout[k];
    }
}

extern "C" int wirepath_round(
    const void* next_inst, const void* crnd, const void* alive,
    int quorum, int limit, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* next_out, void* inst, void* fresh, void* win, void* value,
    void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    wirepath_round_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)next_inst, (const int*)crnd, (const unsigned char*)alive,
        quorum, limit, A, N, V, B,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)ldel, (int*)linst, (int*)lval,
        (const int*)values, (int*)next_out, (int*)inst, (bool*)fresh, (int*)win, (int*)value);
    return (int)cudaGetLastError();
}
