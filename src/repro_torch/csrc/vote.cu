// K2 and K7: the Phase-2 vote of the acceptor array, and of one acceptor,
// for Hopper (sm_90a).
//
// K2 (`acceptor_vote_all`) replaces the TPU kernel `acceptor_vote_all_window`
// of src/repro/kernels/wirepath.py:1034 (body `_vote_all_kernel`): the
// staged vote of all A acceptors on one batch of Phase-2 headers, the
// stacked rings updated in place, one (A, B) vote batch per field.  K7
// (`acceptor_phase2`) replaces `acceptor_phase2_window` of
// src/repro/kernels/acceptor.py:92: the same vote by one acceptor on its own
// register file, with swid = aid and no alive mask.  Both run one kernel,
// a team of threads per (acceptor, lane): K7 is its A = 1 launch with
// swid = aid + a and a null alive mask (every acceptor alive).  The first
// design's one thread per lane, `vote_lane`, stays only as the witness the
// card checks hold the team body against (`acceptor_phase2_witness`); no
// path launches it.
//
// Semantics (bit for bit the TPU kernels' and the plain engine's): acceptor
// a accepts lane j iff alive[a] && msgtype[j] in {P2A, NOP} && rnd[j] >=
// st_rnd[a, slot]; then (st_rnd, st_vrnd, st_val)[a, slot] := (rnd, rnd,
// value).  The vote row is (P2B, inst, rnd, rnd, swid, value) where
// accepted and (REJECT, inst, st_rnd, st_vrnd, swid, 0) where not, so a
// dead acceptor's row is exactly a rejecter's.  st_val is never read.
//
// Slots.  The TPU kernels walk BB-aligned ring blocks from one window base,
// so the reference sends them only sequenced, aligned batches.  Here lane j
// reads its own inst[j] and addresses slot inst[j] mod N (the floored
// modulo of jnp's and torch's `%`), so one kernel serves every Phase-2
// batch the dataplane votes: sequenced bursts, the software coordinator's
// batches, the recovery window and the takeover scan, at any window base.
// Precondition, as the plain engine's: the batch's slots inst[j] mod N are
// pairwise distinct (so B <= N), so no two teams of one acceptor write the
// same registers.  The wrapper checks B <= N; distinctness is the caller's.
//
// The design.  The first K2 and K7 were one thread per (acceptor, lane) on
// blocks of 128 threads, 3 blocks at A=3, B=128 and 1 for K7; each thread
// stored its V value words one int32 at a time into st_val and into the
// vote value, neighbouring threads 4*V bytes apart, and loaded st_vrnd only
// after those stores: the three faults K1's first form had
// (csrc/wirepath.cu's header).  Now a team of T threads serves one
// (acceptor, lane), the team and its chunk loads and stores those of
// csrc/team.cuh, in three steps:
//   Load.  Every load first: the lane's burst words the thread owns (their
//     address depends on j alone), msgtype, inst and rnd of the lane and
//     alive[a] (read-only, through the non-coherent path), then
//     st_rnd[a, slot] and st_vrnd[a, slot].
//   Decide.  accept = alive && msgtype in {P2A, NOP} && rnd >= st_rnd, the
//     same in every thread of the team; a `__syncwarp` over the team then
//     separates its reads of st_rnd from thread 0's write.
//   Store.  From registers: each thread its chunks of st_val[a, slot] (where
//     accepted) and of the vote value row (the value, or zeros on reject);
//     thread 0 the five scalar vote fields and st_rnd, st_vrnd.
// Two variants of the body, as K1's: vector (V % 4 == 0 and the burst,
// st_val and the vote values all start on 16 bytes: int4 chunks, T the
// power of two at or above V/4, 4 at V = 16) and scalar (int32 chunks, T at
// or above V), T at most 32.  The grid is (lane blocks, A), blocks of
// `threads` (whole teams): at V=16 and 128 threads, 32 lanes a block, so
// K2 at A=3, B=128 takes 12 blocks, K7 at B=128 4 and at B=512 16.  The
// wrapper chooses variant, team and block on the host
// (`kernels.wirepath.lane_geometry`); the entry checks them again.
//
// Bound.  Only the bytes the kernel must read and write count, at the state
// where every lane is accepted by every acceptor (st_vrnd is then not
// needed):
//   K2 reads:  msgtype, inst, rnd 3*B*4 + value B*V*4 + alive A
//              + st_rnd A*B*4
//   K2 writes: st_rnd, st_vrnd 2*A*B*4 + st_val A*B*V*4
//              + vote type, inst, rnd, vrnd, swid 5*A*B*4 + vote value A*B*V*4
// At A=3, B=128, V=16: 11,267 B read + 59,904 B written = 71,171 B, 21.2 ns
// at the card's 3.35 TB/s.  K7 is the same at A=1 without alive: 10,240 B
// read + 19,968 B written = 30,208 B, 9.0 ns.  Far below a launch's
// latency, so launches of these sizes are bound by launch latency and the
// chain of dependent loads (inst, then the registers at its slot).
#include <cuda_runtime.h>
#include <stddef.h>

#include "team.cuh"

#define MSG_NOP 0
#define MSG_P2A 3
#define MSG_P2B 4
#define MSG_REJECT 7

// The first design's lane body, one acceptor's vote on lane j by one
// thread: the witness of the team body (`acceptor_phase2_witness`).  The
// register pointers are that acceptor's (N,), (N,), (N, V) file; the vote
// pointers its (B,), (B, V) row.
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

// K2's and K7's body: acceptor a's vote on lane j, served by a team (the
// header's three steps).  blockIdx.y is a; its vote carries swid
// aid_base + a; a null alive means every acceptor is alive.
template <typename Word>
__global__ void acceptor_vote_all_kernel(
    const unsigned char* __restrict__ alive,  // bool[A], or null
    int aid_base, int N, int V, int B, int team,
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
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int j = team_lane_index(team);
    const int a = blockIdx.y;
    if (j >= B) return;  // the whole team
    const int chunks = V / W;

    // load
    const Word* src = reinterpret_cast<const Word*>(mval + (size_t)j * V);
    Word val[PASS];
    load_pass(val, src, tm, chunks, 0);
    const int inst = __ldg(minst + j), mt = __ldg(msgtype + j), r = __ldg(mrnd + j);
    const bool live = alive == nullptr || __ldg(alive + a) != 0;
    int slot = inst % N;
    if (slot < 0) slot += N;  // the non-negative modulo of jnp's `%`
    const size_t reg = (size_t)a * N + slot;
    const int cur_rnd = st_rnd[reg], cur_vrnd = st_vrnd[reg];

    // decide
    const bool accept = live && (mt == MSG_P2A || mt == MSG_NOP) && r >= cur_rnd;
    __syncwarp(tm.mask);  // every read of the team before any write

    // store
    const size_t row = (size_t)a * B + j;
    if (tm.t == 0) {
        vt[row] = accept ? MSG_P2B : MSG_REJECT;
        vi[row] = inst;
        vr[row] = accept ? r : cur_rnd;
        vv[row] = accept ? r : cur_vrnd;
        vs[row] = aid_base + a;
        if (accept) {
            st_rnd[reg] = r;
            st_vrnd[reg] = r;
        }
    }
    Word* const sdst = reinterpret_cast<Word*>(st_val + reg * V);
    Word* const vdst = reinterpret_cast<Word*>(vval + row * V);
    for (int p0 = 0;;) {
        if (accept) store_pass(val, sdst, tm, chunks, p0);
        Word out[PASS];
#pragma unroll
        for (int i = 0; i < PASS; ++i) out[i] = accept ? val[i] : zero_word<Word>();
        store_pass(out, vdst, tm, chunks, p0);
        p0 += PASS * tm.size;
        if (p0 >= chunks) break;
        load_pass(val, src, tm, chunks, p0);
    }
}

static const int WITNESS_THREADS = 128;  // the witness: one thread a lane

__global__ void acceptor_phase2_witness_kernel(
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

// The team kernel on A register files of N slots (one for K7), the votes of
// acceptor a carrying swid aid_base + a.
static int launch_votes(
    const void* alive, int aid_base, int A, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || A > 65535 || B < 1 || B > N || V < 1
        || !team_shape_ok(vec, team, threads, V, {value, st_val, vval}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const dim3 grid((B + lanes - 1) / lanes, A);
    auto go = [&](auto word) {
        acceptor_vote_all_kernel<decltype(word)><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const unsigned char*)alive, aid_base, N, V, B, team,
            (const int*)msgtype, (const int*)inst, (const int*)rnd, (const int*)value,
            (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
            (int*)vt, (int*)vi, (int*)vr, (int*)vv, (int*)vs, (int*)vval);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}

extern "C" int acceptor_vote_all(
    const void* alive, int A, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    int vec, int team, int threads, void* stream)
{
    if (alive == nullptr) return (int)cudaErrorInvalidValue;
    return launch_votes(alive, 0, A, N, V, B, msgtype, inst, rnd, value, st_rnd, st_vrnd, st_val,
                        vt, vi, vr, vv, vs, vval, vec, team, threads, stream);
}

extern "C" int acceptor_phase2(
    int aid, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    int vec, int team, int threads, void* stream)
{
    return launch_votes(nullptr, aid, 1, N, V, B, msgtype, inst, rnd, value, st_rnd, st_vrnd,
                        st_val, vt, vi, vr, vv, vs, vval, vec, team, threads, stream);
}

extern "C" int acceptor_phase2_witness(
    int aid, int N, int V, int B,
    const void* msgtype, const void* inst, const void* rnd, const void* value,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* vt, void* vi, void* vr, void* vv, void* vs, void* vval,
    void* stream)
{
    if (B < 1 || B > N || V < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (B + WITNESS_THREADS - 1) / WITNESS_THREADS;
    acceptor_phase2_witness_kernel<<<blocks, WITNESS_THREADS, 0, (cudaStream_t)stream>>>(
        aid, N, V, B,
        (const int*)msgtype, (const int*)inst, (const int*)rnd, (const int*)value,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)vt, (int*)vi, (int*)vr, (int*)vv, (int*)vs, (int*)vval);
    return (int)cudaGetLastError();
}
