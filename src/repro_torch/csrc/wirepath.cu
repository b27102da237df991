// K1 and K6: one fused Phase-2 round of Paxos groups, for Hopper (sm_90a),
// and K5, K rounds of it in one launch.
//
// K1 replaces the TPU kernel `cohort_wirepath_round` of
// src/repro/kernels/wirepath.py:228, whose body is `_phase2_block`
// (:97-156): coordinator sequencing, the Phase-2 vote of all A acceptors,
// the learner quorum and the learner ring dedup, in one launch, with the six
// state tensors updated in place.  Its entries:
//   wirepath_round         the single-group slice (`wirepath_round` there);
//   cohort_wirepath_round  the cohort form over (G, ...) slabs, and through
//                          it `multigroup_wirepath_round` (every block) and
//                          the shard slice `shard_slab_round` (the wrapper
//                          runs it on one shard's (Gl, ...) slab view).
// K6, `packed_shard_round`, replaces the TPU kernel of that name (:780):
// one round over a shard's packed lane table.  K5,
// `persistent_wirepath_round`, replaces the TPU kernel of that name (:524):
// K rounds of the cohort form in one launch, on the same team body with the
// rounds spread over the grid (its section below).  `launch_floor` launches
// an empty kernel on a given grid: the floor under which no launch of that
// grid can go.
//
// What the TPU kernel's block shape does not carry over.  `_phase2_block`
// votes whole (GB, A, BB) ring blocks already in VMEM.  Here a round moves
// about 57 KB and takes a few microseconds, so what bounds it is latency:
// the launch, the chain of dependent loads, and how many SMs and load/store
// units share the stores.  The first form of this kernel (one thread a lane)
// lost on four counts: one block of 128 threads at G=1, so 1 SM of 132;
// each thread storing its lane's V words one int32 at a time, neighbours
// 4*V bytes apart, so a warp's store touched 32 sectors and a warp issued
// (A + 2)*V of them; the learner's value copied out of the value output it
// had just written (a read-back of global memory); and the learner's
// delivered flag and instance loaded only after the acceptor stores.
//
// Design: a team of T threads a lane, in three steps.
//   Load.  Every load of a lane is issued before any store of its team:
//     the window base, crnd, limit, enabled and alive (read-only inputs,
//     through the non-coherent path, as is the burst), rnd[a, slot] of
//     the team's acceptors, the learner's ldel[slot] and linst[slot], and
//     the burst words the thread owns.
//   Decide.  The acceptor axis is spread over the team: thread t votes
//     for acceptors t, t + T, ... (A <= MAX_A), and the team ORs its
//     accept bits by warp shuffles.  From that mask every thread has win,
//     the agree count, deliver and the dedup test: an acceptor votes crnd
//     or NO_ROUND, so win = max(NO_ROUND, crnd) if any accepts, and the
//     agreeing acceptors are the accepting ones where crnd == win.  A
//     `__syncwarp` over the team then separates its reads from its writes.
//   Store.  Thread t stores the words it owns: rnd and vrnd of its
//     acceptors, and its chunks of each accepting acceptor's value, of the
//     value output and, where fresh, of the learner's value, all from
//     registers.  Thread 0 stores fresh, win, ldel and linst.
// Two variants of the same body, both hand-written and run on the card:
//   vector  (V % 4 == 0 and st_val, lval, the burst and the value output
//           all start on 16 bytes): thread t owns the int4 words 4t..4t+3
//           of the lane, T the power of two at or above V/4 (4 at V = 16);
//           a lane's V words are contiguous in each of those tensors and
//           neighbouring lanes hold neighbouring slots (but where the window
//           wraps the ring), so a warp's 128-bit store covers contiguous
//           bytes;
//   scalar  (any other V or alignment): thread t owns int32 words t,
//           t + T, ..., T the power of two at or above V.
// T is capped at 32, so it divides 32 and a team never straddles a warp.  A
// thread holds PASS chunks at a time; a lane of more than PASS*T chunks
// (V > 256 vector, V > 64 scalar) is stored in passes, whose later burst
// loads follow earlier stores (no store touches the burst).
// Blocks hold whole teams (`threads`, a multiple of 32; the wrapper's
// default is chosen on the card), so G=1's 128 lanes at V = 16 span
// 128*4/threads blocks, and the cohort form, K5 and K6 as many per row.  The
// wrapper chooses variant, team and block on the host; the entry checks
// them again and refuses what the kernel cannot take.  The team, its chunk
// loads and stores and the shape check are in csrc/team.cuh, shared with
// K2 (csrc/vote.cu).
//
// Semantics, as `_phase2_block`'s: lane j of group g takes
// instance next_inst[g] + j in int32 wraparound and ring slot (that) mod
// N, the non-negative modulo, so any window base is served and there is no
// alignment precondition and no fallback; permit = inst < limit (the
// cohort form's per-group limit is an int32 device vector, so a limit that
// wrapped past int32 max stays wrapped and refuses every lane, as the
// reference's does); deliver = agree count >= quorum; the decided value is
// the burst value where any acceptor agrees, else 0; fresh = deliver and
// not (ldel[slot] != 0 and linst[slot] == inst).  An inert lane (a cohort
// member that is not enabled, a K6 pad) reads and stores no state and gives
// fresh 0, win NO_ROUND (-1), value 0.
//
// Why no two threads meet on a slot.  B <= N, so a group's B lanes address
// B distinct slots; distinct rows are distinct groups (cohort: gsel
// distinct, checked by the wrapper; K6: enabled lanes name distinct rows,
// checked on the host); within a team each thread stores only words it
// owns, and the words every thread of the team reads (ldel, linst) are
// stored by thread 0 after the team's `__syncwarp`.  Single group: thread 0
// of lane 0 writes the advanced watermark next_inst + B to a separate
// scalar, so no lane's read of next_inst races with it.
//
// Bound.  Only the bytes the kernel must read and write count; vrnd, the
// acceptors' values and the learner's values are written, never read.
// Per group (single-group entry):
//   reads:  rnd A*B*4 + ldel, linst 2*B*4 + burst B*V*4 + alive A
//           + next_inst, crnd 8
//   writes: rnd, vrnd, val A*B*(2+V)*4 + ldel, linst, lval B*(2+V)*4
//           + next_out 4 + inst, win 2*B*4 + fresh B + value B*V*4
// (the acceptor and learner writes at their most: every lane accepted by
// all A acceptors and fresh).  At A=3, B=128, V=16: 10,763 B read +
// 46,212 B written = 56,975 B, 17.0 ns at the card's 3.35 TB/s.  The cohort
// entry moves the same per selected group, less next_out and inst, plus
// limit and enabled (8) and its gsel word (56,467 B); K6 per enabled lane
// 56,480 B (alive as A int32 words, plus its seg word); a pad 8,836 B.  All
// far below a launch: `launch_floor` measures that floor.
#include <cuda_runtime.h>
#include <stdint.h>

#include "team.cuh"

#define MAX_A 8
#define MAX_GRID_YZ 65535  // gridDim.y and gridDim.z at most

// ---------------------------------------------------------------------------
// The team lane body of K1, K5 and K6
// ---------------------------------------------------------------------------
// An inert lane: fresh 0, win NO_ROUND, value 0, no state.
template <typename Word>
__device__ __forceinline__ void inert_lane(const Team& tm, int V, bool* __restrict__ fresh,
                                           int* __restrict__ win_out, int* __restrict__ vout) {
    constexpr int W = sizeof(Word) / sizeof(int);
    Word* dst = reinterpret_cast<Word*>(vout);
    for (int c = tm.t; c < V / W; c += tm.size) dst[c] = zero_word<Word>();
    if (tm.t == 0) {
        *fresh = false;
        *win_out = -1;
    }
}

// One lane of one group's window, served by a team.  `burst` holds the
// first pass of the lane's burst words, loaded by the caller before its
// own loads; the pointers are the group's rings and the lane's outputs.
template <typename Word, typename Alive>
__device__ __forceinline__ void team_lane(
    const Team& tm, Word (&burst)[PASS], const Word* __restrict__ src,
    int inst, int crnd, int limit, const Alive* __restrict__ alive,
    int quorum, int A, int N, int V,
    int* __restrict__ st_rnd,    // int32[A, N]      in place
    int* __restrict__ st_vrnd,   // int32[A, N]      in place
    int* __restrict__ st_val,    // int32[A, N, V]   in place
    int* __restrict__ ldel,      // int32[N]         in place
    int* __restrict__ linst,     // int32[N]         in place
    int* __restrict__ lval,      // int32[N, V]      in place
    bool* __restrict__ fresh, int* __restrict__ win_out,
    int* __restrict__ vout)      // int32[V]
{
    constexpr int W = sizeof(Word) / sizeof(int);
    const int chunks = V / W;
    int slot = inst % N;
    if (slot < 0) slot += N;  // the non-negative modulo of jnp's `%`
    const bool permit = inst < limit;

    // load: this thread's acceptors' promises and liveness, the learner's slot
    int rnd[MAX_A];
    bool al[MAX_A];
#pragma unroll
    for (int k = 0; k < MAX_A; ++k) {
        const int a = tm.t + k * tm.size;
        rnd[k] = a < A ? st_rnd[(size_t)a * N + slot] : 0;
        al[k] = a < A && __ldg(alive + a) != 0;
    }
    const int del = ldel[slot];
    const int seen = linst[slot];

    // decide: the team's accept mask, then what follows from it
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < MAX_A; ++k) {
        const int a = tm.t + k * tm.size;
        if (al[k] && permit && crnd >= rnd[k]) acc |= 1u << a;
    }
    for (int off = tm.size >> 1; off > 0; off >>= 1)
        acc |= __shfl_xor_sync(tm.mask, acc, off, tm.size);
    const int win = acc ? max(crnd, -1) : -1;  // max over acceptors of crnd or NO_ROUND
    const int count = crnd == win ? __popc(acc) : 0;
    const bool any_agree = count > 0;
    const bool deliver = count >= quorum;
    const bool is_fresh = deliver && !(del != 0 && seen == inst);
    __syncwarp(tm.mask);  // every read of the team before any write

    // store
#pragma unroll
    for (int k = 0; k < MAX_A; ++k) {
        const int a = tm.t + k * tm.size;
        if (a < A && (acc >> a & 1u)) {
            st_rnd[(size_t)a * N + slot] = crnd;
            st_vrnd[(size_t)a * N + slot] = crnd;
        }
    }
    if (tm.t == 0) {
        *fresh = is_fresh;
        *win_out = win;
        if (deliver) ldel[slot] = del | 1;
        if (is_fresh) linst[slot] = inst;
    }
    Word* const vdst = reinterpret_cast<Word*>(vout);
    Word* const ldst = reinterpret_cast<Word*>(lval + (size_t)slot * V);
    for (int p0 = 0;;) {
        for (int a = 0; a < A; ++a) {
            if (acc >> a & 1u)
                store_pass(burst, reinterpret_cast<Word*>(st_val + ((size_t)a * N + slot) * V),
                           tm, chunks, p0);
        }
        Word dec[PASS];
#pragma unroll
        for (int i = 0; i < PASS; ++i) dec[i] = any_agree ? burst[i] : zero_word<Word>();
        store_pass(dec, vdst, tm, chunks, p0);
        if (is_fresh) store_pass(dec, ldst, tm, chunks, p0);
        p0 += PASS * tm.size;
        if (p0 >= chunks) break;
        load_pass(burst, src, tm, chunks, p0);
    }
}

template <typename Word>
__global__ void wirepath_round_kernel(
    const int* __restrict__ next_inst_p,  // int32[]  window base (any value)
    const int* __restrict__ crnd_p,       // int32[]  coordinator round
    const unsigned char* __restrict__ alive,  // bool[A]
    int quorum, int limit, int A, int N, int V, int B, int team,
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
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int j = team_lane_index(team);
    if (j >= B) return;  // the whole team
    const Word* src = reinterpret_cast<const Word*>(values + (size_t)j * V);
    Word burst[PASS];
    load_pass(burst, src, tm, V / W, 0);
    const int base = __ldg(next_inst_p);
    // int32 wraparound, as the reference's int32 arithmetic
    const int inst = (int)((unsigned)base + (unsigned)j);
    team_lane(tm, burst, src, inst, __ldg(crnd_p), limit, alive, quorum, A, N, V,
              st_rnd, st_vrnd, st_val, ldel, linst, lval,
              fresh + j, win_out + j, value_out + (size_t)j * V);
    if (tm.t == 0) {
        inst_out[j] = inst;
        if (j == 0) *next_out = (int)((unsigned)base + (unsigned)B);
    }
}

template <typename Word>
__global__ void cohort_wirepath_round_kernel(
    const int* __restrict__ gsel,       // int32[NB]  selected group blocks
    int gb,                             // groups per block (GB)
    const int* __restrict__ next_inst,  // int32[G]  window bases (any value)
    const int* __restrict__ crnd,       // int32[G]
    const int* __restrict__ limit,      // int32[G]  first refused instance
    const unsigned char* __restrict__ alive,  // bool[G, A]
    const int* __restrict__ enabled,    // int32[G]  0 = inert
    int quorum, int A, int N, int V, int B, int team,
    int* __restrict__ st_rnd,    // int32[G, A, N]      in place
    int* __restrict__ st_vrnd,   // int32[G, A, N]      in place
    int* __restrict__ st_val,    // int32[G, A, N, V]   in place
    int* __restrict__ ldel,      // int32[G, N]         in place
    int* __restrict__ linst,     // int32[G, N]         in place
    int* __restrict__ lval,      // int32[G, N, V]      in place
    const int* __restrict__ values,  // int32[C, B, V]  compact burst
    bool* __restrict__ fresh,    // bool[C, B]   out, compact
    int* __restrict__ win_out,   // int32[C, B]  out, compact
    int* __restrict__ value_out) // int32[C, B, V]  out, compact
{
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int j = team_lane_index(team);
    const int r = blockIdx.y;  // compact row: group gsel[r / GB] * GB + r % GB
    if (j >= B) return;
    const size_t lane = (size_t)r * B + j;
    const Word* src = reinterpret_cast<const Word*>(values + lane * V);
    Word burst[PASS];
    load_pass(burst, src, tm, V / W, 0);
    const int g = __ldg(gsel + r / gb) * gb + r % gb;
    const int base = __ldg(next_inst + g), cr = __ldg(crnd + g), lim = __ldg(limit + g);
    int* vout = value_out + lane * V;
    if (!__ldg(enabled + g)) {
        inert_lane<Word>(tm, V, fresh + lane, win_out + lane, vout);
        return;
    }
    const int inst = (int)((unsigned)base + (unsigned)j);  // int32 wrap
    const size_t an = (size_t)A * N;
    team_lane(tm, burst, src, inst, cr, lim, alive + (size_t)g * A, quorum, A, N, V,
              st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
              ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
              fresh + lane, win_out + lane, vout);
}

extern "C" int wirepath_round(
    const void* next_inst, const void* crnd, const void* alive,
    int quorum, int limit, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* next_out, void* inst, void* fresh, void* win, void* value,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1
        || !team_shape_ok(vec, team, threads, V, {st_val, lval, values, value}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const int blocks = (B + lanes - 1) / lanes;
    auto go = [&](auto word) {
        wirepath_round_kernel<decltype(word)><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int*)next_inst, (const int*)crnd, (const unsigned char*)alive,
            quorum, limit, A, N, V, B, team,
            (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
            (int*)ldel, (int*)linst, (int*)lval,
            (const int*)values, (int*)next_out, (int*)inst, (bool*)fresh, (int*)win,
            (int*)value);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}

extern "C" int cohort_wirepath_round(
    const void* gsel, int nb, int gb,
    const void* next_inst, const void* crnd, const void* limit,
    const void* alive, const void* enabled,
    int quorum, int G, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1 || gb < 1 || nb < 1
        || G % gb != 0 || nb * gb > G
        || !team_shape_ok(vec, team, threads, V, {st_val, lval, values, value}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const dim3 grid((B + lanes - 1) / lanes, nb * gb);
    auto go = [&](auto word) {
        cohort_wirepath_round_kernel<decltype(word)><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int*)gsel, gb, (const int*)next_inst, (const int*)crnd, (const int*)limit,
            (const unsigned char*)alive, (const int*)enabled, quorum, A, N, V, B, team,
            (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
            (int*)ldel, (int*)linst, (int*)lval,
            (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}

// K5: K Phase-2 rounds of the cohort form in one launch.
//
// Replaces the TPU kernel `persistent_wirepath_round` of
// src/repro/kernels/wirepath.py:524 (body `_persistent_wirepath_kernel`).  A
// wave descriptor drives it: wni[k, g] is group g's window base in round k
// and wen[k, g] whether g takes part in round k.  Row r of the compact
// layout serves group gsel[r / GB] * GB + r % GB, as in the cohort entry.
//
// Mapping.  The rounds are spread over the grid: one team (K1's `team_lane`)
// serves one (round k, compact row r, lane j), the grid is (lane blocks,
// rows, K) and nothing loops over the rounds, so a wave of K rounds costs
// about one round.  Only where K exceeds gridDim.z's 65,535 (K * B <= N
// admits K = N at B = 1) does a block serve rounds z, z + gridDim.z, ...
// in turn.  The team's instance in round k is wni[k, g] + j (int32 wrap),
// its slot the non-negative modulo; each group is served at its own
// wni[k, g], so a folded block needs no substituted base.  Where
// wen[k, g] == 0 (a round the group sits out, or an inert member of a
// folded block, whose wen is 0 in every round) the team runs `inert_lane`:
// it reads and stores no state and writes fresh 0, win -1, value 0 for that
// round.  Loads in K1's order: the burst first (its address depends on
// (k, r, j) alone), then gsel, then the round's wni, wen and the group's
// crnd, limit (read-only, through the non-coherent path), then the state.
//
// Why the rounds need no order and no grid-wide sync (the reference's
// argument at wirepath.py:571-575, carried from grid steps to teams):
//   * a group's enabled windows advance by B from round to round
//     (wni[k+1] = wni[k] + B * wen[k]; the wrapper checks this walk on the
//     host for every group of the selected blocks before it launches);
//   * K * B <= N, so the instances wni[k] + j of one group's enabled
//     rounds are K * B consecutive numbers at most, and no two (round,
//     lane) pairs of one group that touch state meet on a slot;
//   * inert rounds touch no state.
// So no two teams touch one slot (distinct rows are distinct groups: gsel
// distinct, checked by the wrapper), no round reads what another writes,
// and the K rounds in parallel give what K rounds in order give.
//
// Bound.  K times the cohort entry's bytes per selected group (the
// acceptor and learner writes at their most: every lane accepted by all A
// acceptors and fresh), plus the (K, G) descriptor words wni and wen.  At
// A=3, B=128, V=16, K=8, G=8: 8 * 8 * 56,467 B + 512 B = 3.6 MB, about
// 1.1 us at 3.35 TB/s; at one group 452 KB, 0.14 us.  A wave at GB=8 is
// 4 * 8 * 8 blocks of 128 threads: below a launch of that grid plus one
// round's chain of dependent loads the kernel cannot go (`launch_floor`).
template <typename Word>
__global__ void persistent_wirepath_round_kernel(
    const int* __restrict__ gsel,       // int32[NB]  selected group blocks
    int gb,                             // groups per block (GB)
    const int* __restrict__ wni,        // int32[K, G]  window bases per round
    const int* __restrict__ wen,        // int32[K, G]  0 = the round is inert
    const int* __restrict__ crnd,       // int32[G]
    const int* __restrict__ limit,      // int32[G]  first refused instance
    const unsigned char* __restrict__ alive,  // bool[G, A]
    int quorum, int K, int G, int A, int N, int V, int B, int team,
    int* __restrict__ st_rnd,    // int32[G, A, N]      in place
    int* __restrict__ st_vrnd,   // int32[G, A, N]      in place
    int* __restrict__ st_val,    // int32[G, A, N, V]   in place
    int* __restrict__ ldel,      // int32[G, N]         in place
    int* __restrict__ linst,     // int32[G, N]         in place
    int* __restrict__ lval,      // int32[G, N, V]      in place
    const int* __restrict__ values,  // int32[K, C, B, V]  compact wave
    bool* __restrict__ fresh,    // bool[K, C, B]   out, compact
    int* __restrict__ win_out,   // int32[K, C, B]  out, compact
    int* __restrict__ value_out) // int32[K, C, B, V]  out, compact
{
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int j = team_lane_index(team);
    const int r = blockIdx.y;  // compact row
    if (j >= B) return;  // the whole team
    const size_t c = gridDim.y, an = (size_t)A * N;
    for (int k = blockIdx.z; k < K; k += gridDim.z) {  // one pass unless K > 65,535
        const size_t lane = ((size_t)k * c + r) * B + j;
        const Word* src = reinterpret_cast<const Word*>(values + lane * V);
        Word burst[PASS];
        load_pass(burst, src, tm, V / W, 0);
        const int g = __ldg(gsel + r / gb) * gb + r % gb;
        const size_t kg = (size_t)k * G + g;
        const int base = __ldg(wni + kg), on = __ldg(wen + kg);
        const int cr = __ldg(crnd + g), lim = __ldg(limit + g);
        int* vout = value_out + lane * V;
        if (!on) {
            inert_lane<Word>(tm, V, fresh + lane, win_out + lane, vout);
            continue;
        }
        const int inst = (int)((unsigned)base + (unsigned)j);  // int32 wrap
        team_lane(tm, burst, src, inst, cr, lim, alive + (size_t)g * A, quorum, A, N, V,
                  st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
                  ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
                  fresh + lane, win_out + lane, vout);
    }
}

extern "C" int persistent_wirepath_round(
    const void* gsel, int nb, int gb,
    const void* wni, const void* wen, const void* crnd, const void* limit,
    const void* alive,
    int quorum, int K, int G, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || V < 1 || K < 1 || (long long)K * B > N
        || gb < 1 || nb < 1 || G % gb != 0 || nb * gb > G || nb * gb > MAX_GRID_YZ
        || !team_shape_ok(vec, team, threads, V, {st_val, lval, values, value}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const dim3 grid((B + lanes - 1) / lanes, nb * gb, K < MAX_GRID_YZ ? K : MAX_GRID_YZ);
    auto go = [&](auto word) {
        persistent_wirepath_round_kernel<decltype(word)>
            <<<grid, threads, 0, (cudaStream_t)stream>>>(
                (const int*)gsel, gb, (const int*)wni, (const int*)wen, (const int*)crnd,
                (const int*)limit, (const unsigned char*)alive, quorum, K, G, A, N, V, B, team,
                (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
                (int*)ldel, (int*)linst, (int*)lval,
                (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}

// K6: one Phase-2 round over a shard's packed lane table.
//
// Replaces the TPU kernel `packed_shard_round` of
// src/repro/kernels/wirepath.py:770-942 (body `_packed_shard_kernel`, which
// is the multi-group round body with a scalar-prefetch segment table).  The
// groups-sharded dataplane packs a cohort's resident members of one shard
// into C uniform lanes; packed lane j serves slab row seg[j] of the shard's
// (Gl, ...) slab with its own next_inst[j], crnd[j], limit[j] and alive row
// alive[j, :], all per-lane device vectors packed by the caller.
//
// Mapping.  K1's team body: blockIdx.y is the packed lane j, and the teams
// of the blockIdx.x blocks its B burst positions p, at instance
// next_inst[j] + p (int32 wrap).  Every per-lane word (seg, next_inst,
// crnd, limit, enabled, alive) depends on j alone, so it is one round trip
// before the state loads.
//
// Pads.  A lane with enabled[j] == 0 is a pad: it reads and stores no slab
// state and writes fresh 0, win NO_ROUND (-1), value 0 to its packed row,
// what the reference gives a pad at NO_ROUND.  The TPU kernel redirects
// every pad to one unused row and writes that row back unchanged; on the
// card several pads naming one row would be concurrent stores, so K6 makes
// none; a pad's seg[j] is loaded with the other per-lane words but never
// used.
//
// Why no two threads meet on a slot: enabled lanes name pairwise-distinct
// rows in [0, Gl) (checked on the host before the launch), so two lanes
// never share a row, and within a lane the header's argument holds.
template <typename Word>
__global__ void packed_shard_round_kernel(
    const int* __restrict__ seg,        // int32[C]  slab row per lane
    const int* __restrict__ next_inst,  // int32[C]  window base per lane
    const int* __restrict__ crnd,       // int32[C]
    const int* __restrict__ limit,      // int32[C]  first refused instance
    const int* __restrict__ alive,      // int32[C, A]  0/1
    const int* __restrict__ enabled,    // int32[C]  0 = pad
    int quorum, int A, int N, int V, int B, int team,
    int* __restrict__ st_rnd,    // int32[Gl, A, N]      in place
    int* __restrict__ st_vrnd,   // int32[Gl, A, N]      in place
    int* __restrict__ st_val,    // int32[Gl, A, N, V]   in place
    int* __restrict__ ldel,      // int32[Gl, N]         in place
    int* __restrict__ linst,     // int32[Gl, N]         in place
    int* __restrict__ lval,      // int32[Gl, N, V]      in place
    const int* __restrict__ values,  // int32[C, B, V]  packed burst
    bool* __restrict__ fresh,    // bool[C, B]   out, packed
    int* __restrict__ win_out,   // int32[C, B]  out, packed
    int* __restrict__ value_out) // int32[C, B, V]  out, packed
{
    constexpr int W = sizeof(Word) / sizeof(int);
    const Team tm = team_of(team);
    const int p = team_lane_index(team);
    const int j = blockIdx.y;  // packed lane
    if (p >= B) return;
    const size_t lane = (size_t)j * B + p;
    const Word* src = reinterpret_cast<const Word*>(values + lane * V);
    Word burst[PASS];
    load_pass(burst, src, tm, V / W, 0);
    const int g = __ldg(seg + j), base = __ldg(next_inst + j);
    const int cr = __ldg(crnd + j), lim = __ldg(limit + j);
    int* vout = value_out + lane * V;
    if (!__ldg(enabled + j)) {
        inert_lane<Word>(tm, V, fresh + lane, win_out + lane, vout);
        return;
    }
    const int inst = (int)((unsigned)base + (unsigned)p);  // int32 wrap
    const size_t an = (size_t)A * N;
    team_lane(tm, burst, src, inst, cr, lim, alive + (size_t)j * A, quorum, A, N, V,
              st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
              ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
              fresh + lane, win_out + lane, vout);
}

extern "C" int packed_shard_round(
    const void* seg, const void* next_inst, const void* crnd, const void* limit,
    const void* alive, const void* enabled,
    int quorum, int C, int Gl, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    int vec, int team, int threads, void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1 || C < 1 || C > Gl
        || !team_shape_ok(vec, team, threads, V, {st_val, lval, values, value}))
        return (int)cudaErrorInvalidValue;
    const int lanes = threads / team;
    const dim3 grid((B + lanes - 1) / lanes, C);
    auto go = [&](auto word) {
        packed_shard_round_kernel<decltype(word)><<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const int*)seg, (const int*)next_inst, (const int*)crnd, (const int*)limit,
            (const int*)alive, (const int*)enabled, quorum, A, N, V, B, team,
            (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
            (int*)ldel, (int*)linst, (int*)lval,
            (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    };
    if (vec) go(int4{}); else go(int{});
    return (int)cudaGetLastError();
}

// The launch floor: an empty kernel on a (gx, gy, gz) grid of
// `threads`-thread blocks, what a launch of that shape costs before it does
// any work.
__global__ void empty_kernel() {}

extern "C" int launch_floor(int gx, int gy, int gz, int threads, void* stream)
{
    if (gx < 1 || gy < 1 || gz < 1 || gy > MAX_GRID_YZ || gz > MAX_GRID_YZ || threads < 1
        || threads > 1024)
        return (int)cudaErrorInvalidValue;
    empty_kernel<<<dim3(gx, gy, gz), threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
