// K2 and K7: the Phase-2 vote of the acceptor array, and of one acceptor,
// for Hopper (sm_90a).
//
// K2 (`acceptor_vote_all`) replaces the TPU kernel `acceptor_vote_all_window`
// of src/repro/kernels/wirepath.py (body `_vote_all_kernel`): the staged
// vote of all A acceptors on one batch of Phase-2 headers, the stacked rings
// updated in place, one (A, B) vote batch per field.  K7
// (`acceptor_phase2`) replaces `acceptor_phase2_window` of
// src/repro/kernels/acceptor.py: the same vote by one acceptor on its own
// register file, with swid = aid and no alive mask.  Both run one lane body,
// `vote_lane`.
//
// Semantics (bit for bit the TPU kernels' and the plain engine's): acceptor
// a accepts lane j iff alive[a] && msgtype[j] in {P2A, NOP} && rnd[j] >=
// st_rnd[a, slot]; then (st_rnd, st_vrnd, st_val)[a, slot] := (rnd, rnd,
// value).  The vote row is (P2B, inst, rnd, rnd, swid, value) where
// accepted and (REJECT, inst, st_rnd, st_vrnd, swid, 0) where not, so a
// dead acceptor's row is exactly a rejecter's.  st_val is never read.
//
// Design.  One thread per (acceptor, lane); blockIdx.y is the acceptor.
// The TPU kernels walk BB-aligned ring blocks from one window base, so the
// reference sends them only sequenced, aligned batches.  Here lane j reads
// its own inst[j] and addresses slot inst[j] mod N (the floored modulo of
// jnp's and torch's `%`), so one kernel serves every Phase-2 batch the
// dataplane votes: sequenced bursts, the software coordinator's batches,
// the recovery window and the takeover scan, at any window base.
// Precondition, as the plain engine's: the batch's slots inst[j] mod N are
// pairwise distinct (so B <= N), so no two threads of one acceptor write the
// same registers.  The wrapper checks B <= N; distinctness is the caller's.
//
// Bound.  Only the bytes the kernel reads and writes count, at the state
// where every lane is accepted by every acceptor (st_vrnd is then not read):
//   K2 reads:  msgtype, inst, rnd 3*B*4 + value B*V*4 + alive A
//              + st_rnd A*B*4
//   K2 writes: st_rnd, st_vrnd 2*A*B*4 + st_val A*B*V*4
//              + vote type, inst, rnd, vrnd, swid 5*A*B*4 + vote value A*B*V*4
// At A=3, B=128, V=16: 11,267 B read + 59,904 B written = 71,171 B, 21.2 ns
// at the card's 3.35 TB/s.  K7 is the same at A=1 without alive: 10,240 B
// read + 19,968 B written = 30,208 B, 9.0 ns.  Far below a launch's
// latency, so launches of these sizes are bound by launch latency.
#include <cuda_runtime.h>
#include <stddef.h>

#define MSG_NOP 0
#define MSG_P2A 3
#define MSG_P2B 4
#define MSG_REJECT 7

// One acceptor's vote on lane j.  The register pointers are that acceptor's
// (N,), (N,), (N, V) file; the vote pointers its (B,), (B, V) row.
__device__ __forceinline__ void vote_lane(
    bool alive, int swid, int j, int N, int V,
    const int* __restrict__ msgtype, const int* __restrict__ minst,
    const int* __restrict__ mrnd, const int* __restrict__ mval,
    int* __restrict__ st_rnd, int* __restrict__ st_vrnd, int* __restrict__ st_val,
    int* __restrict__ vt, int* __restrict__ vi, int* __restrict__ vr,
    int* __restrict__ vv, int* __restrict__ vs, int* __restrict__ vval)
{
    const int inst = minst[j];
    int slot = inst % N;
    if (slot < 0) slot += N;
    const int mt = msgtype[j];
    const int r = mrnd[j];
    const int cur_rnd = st_rnd[slot];
    const bool accept = alive && (mt == MSG_P2A || mt == MSG_NOP) && r >= cur_rnd;
    const int* src = mval + (size_t)j * V;
    int* vdst = vval + (size_t)j * V;
    vt[j] = accept ? MSG_P2B : MSG_REJECT;
    vi[j] = inst;
    vs[j] = swid;
    if (accept) {
        st_rnd[slot] = r;
        st_vrnd[slot] = r;
        int* sdst = st_val + (size_t)slot * V;
        for (int k = 0; k < V; ++k) {
            const int w = src[k];
            sdst[k] = w;
            vdst[k] = w;
        }
        vr[j] = r;
        vv[j] = r;
    } else {
        vr[j] = cur_rnd;
        vv[j] = st_vrnd[slot];
        for (int k = 0; k < V; ++k) vdst[k] = 0;
    }
}

__global__ void acceptor_vote_all_kernel(
    const unsigned char* __restrict__ alive,  // bool[A]
    int N, int V, int B,
    const int* __restrict__ msgtype,  // int32[B]
    const int* __restrict__ minst,    // int32[B]
    const int* __restrict__ mrnd,     // int32[B]
    const int* __restrict__ mval,     // int32[B, V]
    int* __restrict__ st_rnd,         // int32[A, N]     in place
    int* __restrict__ st_vrnd,        // int32[A, N]     in place
    int* __restrict__ st_val,         // int32[A, N, V]  in place
    int* __restrict__ vt, int* __restrict__ vi, int* __restrict__ vr,
    int* __restrict__ vv, int* __restrict__ vs,  // int32[A, B] out
    int* __restrict__ vval)                      // int32[A, B, V] out
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int a = blockIdx.y;
    if (j >= B) return;
    const size_t row = (size_t)a * B;
    vote_lane(alive[a] != 0, a, j, N, V, msgtype, minst, mrnd, mval,
              st_rnd + (size_t)a * N, st_vrnd + (size_t)a * N, st_val + (size_t)a * N * V,
              vt + row, vi + row, vr + row, vv + row, vs + row, vval + row * V);
}

__global__ void acceptor_phase2_kernel(
    int aid, int N, int V, int B,
    const int* __restrict__ msgtype, const int* __restrict__ minst,
    const int* __restrict__ mrnd, const int* __restrict__ mval,
    int* __restrict__ st_rnd,   // int32[N]     in place
    int* __restrict__ st_vrnd,  // int32[N]     in place
    int* __restrict__ st_val,   // int32[N, V]  in place
    int* __restrict__ vt, int* __restrict__ vi, int* __restrict__ vr,
    int* __restrict__ vv, int* __restrict__ vs,  // int32[B] out
    int* __restrict__ vval)                      // int32[B, V] out
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= B) return;
    vote_lane(true, aid, j, N, V, msgtype, minst, mrnd, mval,
              st_rnd, st_vrnd, st_val, vt, vi, vr, vv, vs, vval);
}

static const int THREADS = 128;

extern "C" int acceptor_vote_all(
    const void* alive, int A, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    void* stream)
{
    if (A < 1 || A > 65535 || B < 1 || B > N || V < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + THREADS - 1) / THREADS, A);
    acceptor_vote_all_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)alive, N, V, B,
        (const int*)msgtype, (const int*)inst, (const int*)rnd, (const int*)value,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)vt, (int*)vi, (int*)vr, (int*)vv, (int*)vs, (int*)vval);
    return (int)cudaGetLastError();
}

extern "C" int acceptor_phase2(
    int aid, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    void* stream)
{
    if (B < 1 || B > N || V < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + THREADS - 1) / THREADS;
    acceptor_phase2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        aid, N, V, B,
        (const int*)msgtype, (const int*)inst, (const int*)rnd, (const int*)value,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)vt, (int*)vi, (int*)vr, (int*)vv, (int*)vs, (int*)vval);
    return (int)cudaGetLastError();
}
