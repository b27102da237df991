// K1: one fused Phase-2 round of Paxos groups, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cohort_wirepath_round` of
// src/repro/kernels/wirepath.py, whose body is `_phase2_block`:
// coordinator sequencing, the Phase-2 vote of all A acceptors, the learner
// quorum and the learner ring dedup, in one launch, with the six state
// tensors updated in place.  Four entries share one lane body
// (`phase2_lane`):
//   wirepath_round         the single-group slice (`wirepath_round` there);
//   cohort_wirepath_round  the cohort form over (G, ...) slabs, and through
//                          it the full-width `multigroup_wirepath_round`;
//   persistent_wirepath_round  K5: K rounds of the cohort form in one
//                          launch, replacing the TPU kernel
//                          `persistent_wirepath_round` (see below);
//   packed_shard_round     K6: one round over a shard's packed lane
//                          table, replacing the TPU kernel
//                          `packed_shard_round` (see below).
// The cohort entry also serves K1's shard slice (`shard_slab_round` there):
// the wrapper runs it on one shard's (Gl, ...) slab view.
//
// Design.  One thread per lane j of a B-lane window; lane j of group g
// addresses ring slot (next_inst[g] + j) mod N, the non-negative modulo,
// so any window base is served, a wrapped (negative) instance included, and
// there is no block-alignment precondition and no fallback path.  The
// A-axis vote, max, agree count and first agreeing acceptor stay in
// registers (A <= MAX_A).  B <= N keeps a group's B slots distinct, so the
// in-place writes of different lanes never touch the same registers.
//
// Single group: thread 0 writes the advanced watermark next_inst + B to a
// separate scalar, so no lane's read of next_inst races with it.
//
// Cohort form: one block per (compact row, 128 lanes).  Row r serves group
// gsel[r / GB] * GB + r % GB and writes its fresh/win/value outputs at row
// r; the selected blocks are distinct (the wrapper checks), so no two rows
// touch one group.  Per-group next_inst, crnd and limit come as int32[G]
// device vectors, so a reclaim limit that wrapped past int32 max stays
// wrapped and refuses every lane of its group, as the reference's does.  A
// member of a selected block that is not enabled is inert: it touches no
// state and gives fresh 0, win NO_ROUND (-1), value 0 -- what the
// reference's kernel gives it at NO_ROUND on a substituted window, and
// state-exact, since that window is written back unchanged.  Each row uses
// its own group's window base, so GB (the TPU's group fold) changes no
// result here.
//
// Bound.  Only the bytes the kernel reads and writes count; vrnd, the
// acceptors' values and the learner's values are written, never read.
// Per group (single-group entry):
//   reads:  rnd A*B*4 + ldel, linst 2*B*4 + burst B*V*4 + alive A
//           + next_inst, crnd 8
//   writes: rnd, vrnd, val A*B*(2+V)*4 + ldel, linst, lval B*(2+V)*4
//           + next_out 4 + inst, win 2*B*4 + fresh B + value B*V*4
// (the acceptor and learner writes are the most a launch makes: every lane
// accepted by all A acceptors and fresh).  At A=3, B=128, V=16: 10,763 B
// read + 46,212 B written = 56,975 B, 17.0 ns at the card's 3.35 TB/s.  The
// cohort entry moves the same per selected group, less next_out and inst,
// plus limit and enabled (8) and its gsel word.  Both are far below a
// launch's latency, so a launch of this size is bound by launch latency,
// not by device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_A 8

// One lane of one group's window: the vote of the A acceptors, the quorum
// and the ring dedup.  The pointers are the group's own rings and the
// lane's own burst words and outputs.
__device__ __forceinline__ void phase2_lane(
    int inst, int crnd, const unsigned char* __restrict__ alive,
    int quorum, int limit, int A, int N, int V,
    int* __restrict__ st_rnd,    // int32[A, N]      in place
    int* __restrict__ st_vrnd,   // int32[A, N]      in place
    int* __restrict__ st_val,    // int32[A, N, V]   in place
    int* __restrict__ ldel,      // int32[N]         in place
    int* __restrict__ linst,     // int32[N]         in place
    int* __restrict__ lval,      // int32[N, V]      in place
    const int* __restrict__ mval,  // int32[V]  the lane's burst value
    bool* __restrict__ fresh,      // the lane's outputs
    int* __restrict__ win_out,
    int* __restrict__ vout)        // int32[V]
{
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
    for (int k = 0; k < V; ++k) vout[k] = any_agree ? mval[k] : 0;
    *win_out = win;

    const bool dup = ldel[slot] != 0 && linst[slot] == inst;
    const bool is_fresh = deliver && !dup;
    *fresh = is_fresh;
    ldel[slot] |= (int)deliver;
    if (is_fresh) {
        linst[slot] = inst;
        int* ldst = lval + (size_t)slot * V;
        for (int k = 0; k < V; ++k) ldst[k] = vout[k];
    }
}

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
    // int32 wraparound, as the reference's int32 arithmetic
    const int inst = (int)((unsigned)(*next_inst_p) + (unsigned)j);
    if (j == 0) *next_out = (int)((unsigned)(*next_inst_p) + (unsigned)B);
    inst_out[j] = inst;
    phase2_lane(inst, *crnd_p, alive, quorum, limit, A, N, V,
                st_rnd, st_vrnd, st_val, ldel, linst, lval,
                values + (size_t)j * V, fresh + j, win_out + j, value_out + (size_t)j * V);
}

__global__ void cohort_wirepath_round_kernel(
    const int* __restrict__ gsel,       // int32[NB]  selected group blocks
    int gb,                             // groups per block (GB)
    const int* __restrict__ next_inst,  // int32[G]  window bases (any value)
    const int* __restrict__ crnd,       // int32[G]
    const int* __restrict__ limit,      // int32[G]  first refused instance
    const unsigned char* __restrict__ alive,  // bool[G, A]
    const int* __restrict__ enabled,    // int32[G]  0 = inert
    int quorum, int A, int N, int V, int B,
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
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y;  // compact row
    if (j >= B) return;
    const int g = gsel[r / gb] * gb + r % gb;
    const size_t lane = (size_t)r * B + j;
    int* vout = value_out + lane * V;
    if (!enabled[g]) {
        fresh[lane] = false;
        win_out[lane] = -1;
        for (int k = 0; k < V; ++k) vout[k] = 0;
        return;
    }
    const int inst = (int)((unsigned)next_inst[g] + (unsigned)j);  // int32 wrap
    const size_t an = (size_t)A * N;
    phase2_lane(inst, crnd[g], alive + (size_t)g * A, quorum, limit[g], A, N, V,
                st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
                ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
                values + lane * V, fresh + lane, win_out + lane, vout);
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

extern "C" int cohort_wirepath_round(
    const void* gsel, int nb, int gb,
    const void* next_inst, const void* crnd, const void* limit,
    const void* alive, const void* enabled,
    int quorum, int G, int A, int N, int V, int B,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1 || gb < 1 || nb < 1
        || G % gb != 0 || nb * gb > G)
        return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const dim3 grid((B + threads - 1) / threads, nb * gb);
    cohort_wirepath_round_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int*)gsel, gb, (const int*)next_inst, (const int*)crnd, (const int*)limit,
        (const unsigned char*)alive, (const int*)enabled, quorum, A, N, V, B,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)ldel, (int*)linst, (int*)lval,
        (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    return (int)cudaGetLastError();
}

// K5: K Phase-2 rounds of the cohort form in one launch.
//
// Replaces the TPU kernel `persistent_wirepath_round` of
// src/repro/kernels/wirepath.py (body `_persistent_wirepath_kernel`).  A
// wave descriptor drives it: wni[k, g] is group g's window base in round k
// and wen[k, g] whether g takes part in round k.  Row r of the compact
// layout serves group gsel[r / GB] * GB + r % GB, as in the cohort entry.
//
// Mapping.  One thread owns one (compact row, lane) for the whole wave and
// loops over k = 0 .. K-1 in order.  Its instance in round k is
// wni[k, g] + lane (int32 wrap), its slot the non-negative modulo, as in
// `phase2_lane`; each group is served at its own wni[k, g], so a folded
// block needs no substituted base.  Where wen[k, g] == 0 (a round the group
// sits out, or an inert member of a folded block, whose wen is 0 in every
// round) the round runs at NO_ROUND: the lane reads and stores no state
// and writes fresh 0, win -1, value 0 for that round.
//
// Why no grid-wide sync is needed (the reference's argument at
// wirepath.py:571-575, carried from grid steps to threads):
//   * a group's enabled windows advance by B from round to round
//     (wni[k+1] = wni[k] + B * wen[k]; the wrapper checks this walk on the
//     host for every group of the selected blocks before it launches);
//   * K * B <= N, so the instances wni[k] + lane of one group's enabled
//     rounds are K * B consecutive numbers at most, and no two (lane,
//     round) pairs of one group that touch state meet on a slot;
//   * inert rounds touch no state.
// So no two threads touch one slot, distinct rows are distinct groups
// (gsel distinct, checked by the wrapper), and each thread sees its own
// earlier rounds in program order.
//
// Bound.  K times the cohort entry's bytes per selected group (the
// acceptor and learner writes at their most: every lane accepted by all A
// acceptors and fresh), plus the (K, G) descriptor words wni and wen.  At
// A=3, B=128, V=16, K=8, G=8: 8 * 8 * 56,467 B + 512 B = 3.6 MB, about
// 1.1 us at 3.35 TB/s.  `block_b` is the launch's threads per block and
// changes no result.
__global__ void persistent_wirepath_round_kernel(
    const int* __restrict__ gsel,       // int32[NB]  selected group blocks
    int gb,                             // groups per block (GB)
    const int* __restrict__ wni,        // int32[K, G]  window bases per round
    const int* __restrict__ wen,        // int32[K, G]  0 = the round is inert
    const int* __restrict__ crnd,       // int32[G]
    const int* __restrict__ limit,      // int32[G]  first refused instance
    const unsigned char* __restrict__ alive,  // bool[G, A]
    int quorum, int K, int G, int A, int N, int V, int B,
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
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y;  // compact row
    if (j >= B) return;
    const int c = gridDim.y;
    const int g = gsel[r / gb] * gb + r % gb;
    const size_t an = (size_t)A * N;
    for (int k = 0; k < K; ++k) {
        const size_t lane = ((size_t)k * c + r) * B + j;
        int* vout = value_out + lane * V;
        const size_t kg = (size_t)k * G + g;
        if (!wen[kg]) {
            fresh[lane] = false;
            win_out[lane] = -1;
            for (int w = 0; w < V; ++w) vout[w] = 0;
            continue;
        }
        const int inst = (int)((unsigned)wni[kg] + (unsigned)j);  // int32 wrap
        phase2_lane(inst, crnd[g], alive + (size_t)g * A, quorum, limit[g], A, N, V,
                    st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
                    ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
                    values + lane * V, fresh + lane, win_out + lane, vout);
    }
}

extern "C" int persistent_wirepath_round(
    const void* gsel, int nb, int gb,
    const void* wni, const void* wen, const void* crnd, const void* limit,
    const void* alive,
    int quorum, int K, int G, int A, int N, int V, int B, int block_b,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || V < 1 || K < 1 || (long long)K * B > N
        || gb < 1 || nb < 1 || G % gb != 0 || nb * gb > G
        || block_b < 1 || block_b > 1024)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((B + block_b - 1) / block_b, nb * gb);
    persistent_wirepath_round_kernel<<<grid, block_b, 0, (cudaStream_t)stream>>>(
        (const int*)gsel, gb, (const int*)wni, (const int*)wen, (const int*)crnd,
        (const int*)limit, (const unsigned char*)alive, quorum, K, G, A, N, V, B,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)ldel, (int*)linst, (int*)lval,
        (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    return (int)cudaGetLastError();
}

// K6: one Phase-2 round over a shard's packed lane table.
//
// Replaces the TPU kernel `packed_shard_round` of
// src/repro/kernels/wirepath.py:770-942 (body `_packed_shard_kernel`, which
// is the multi-group round body with a scalar-prefetch segment table).  The
// groups-sharded dataplane packs a cohort's resident members of one shard
// into C uniform lanes; lane j serves slab row seg[j] of the shard's
// (Gl, ...) slab with its own next_inst[j], crnd[j], limit[j] and alive row
// alive[j, :], all per-lane device vectors packed by the caller.
//
// Mapping.  One thread per (lane, burst position): blockIdx.y is the lane
// j, blockIdx.x * blockDim.x + threadIdx.x the position p.  The thread runs
// `phase2_lane` on row seg[j] at instance next_inst[j] + p (int32 wrap),
// its slot the non-negative modulo, as in K1, and writes fresh, win and
// value to packed row j.
//
// Pads.  A lane with enabled[j] == 0 is a pad: it reads and stores no slab
// state and writes fresh 0, win NO_ROUND (-1), value 0 to its packed row,
// what the reference gives a pad at NO_ROUND.  The TPU kernel redirects
// every pad to one unused row and writes that row back unchanged; on the
// card several pads naming one row would be concurrent stores, so K6 makes
// none, and a pad's seg[j] is never read.
//
// Why no two threads meet on a slot.  Enabled lanes name pairwise-distinct
// rows in [0, Gl) (the wrapper checks this on the host before it launches),
// so two lanes never share a row; within a lane the B positions are B
// consecutive instances and B <= N, so they are B distinct slots of the
// row.  No thread reads a slot another thread writes.
//
// Bound.  Per enabled lane, K1-cohort's bytes per selected group (the
// acceptor and learner writes at their most: every lane accepted by all A
// acceptors and fresh; its next_inst, crnd, limit and enabled words are
// here per lane), with alive as A int32 words instead of A bytes, plus the
// lane's seg word: at A=3, B=128, V=16, 56,467 + 9 + 4 = 56,480 B, 16.9 ns
// at 3.35 TB/s.  A pad reads its enabled word and writes its outputs:
// 4 + B + 4 * B + 4 * B * V = 8,836 B.  Both are far below a launch's
// latency, as for K1.
__global__ void packed_shard_round_kernel(
    const int* __restrict__ seg,        // int32[C]  slab row per lane
    const int* __restrict__ next_inst,  // int32[C]  window base per lane
    const int* __restrict__ crnd,       // int32[C]
    const int* __restrict__ limit,      // int32[C]  first refused instance
    const int* __restrict__ alive,      // int32[C, A]  0/1
    const int* __restrict__ enabled,    // int32[C]  0 = pad
    int quorum, int A, int N, int V, int B,
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
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y;  // packed lane
    if (p >= B) return;
    const size_t lane = (size_t)j * B + p;
    int* vout = value_out + lane * V;
    if (!enabled[j]) {
        fresh[lane] = false;
        win_out[lane] = -1;
        for (int k = 0; k < V; ++k) vout[k] = 0;
        return;
    }
    unsigned char al[MAX_A];
    for (int a = 0; a < A; ++a) al[a] = alive[(size_t)j * A + a] != 0;
    const int g = seg[j];
    const int inst = (int)((unsigned)next_inst[j] + (unsigned)p);  // int32 wrap
    const size_t an = (size_t)A * N;
    phase2_lane(inst, crnd[j], al, quorum, limit[j], A, N, V,
                st_rnd + g * an, st_vrnd + g * an, st_val + g * an * V,
                ldel + (size_t)g * N, linst + (size_t)g * N, lval + (size_t)g * N * V,
                values + lane * V, fresh + lane, win_out + lane, vout);
}

extern "C" int packed_shard_round(
    const void* seg, const void* next_inst, const void* crnd, const void* limit,
    const void* alive, const void* enabled,
    int quorum, int C, int Gl, int A, int N, int V, int B, int block_b,
    void* st_rnd, void* st_vrnd, void* st_val,
    void* ldel, void* linst, void* lval,
    const void* values, void* fresh, void* win, void* value,
    void* stream)
{
    if (A < 1 || A > MAX_A || B < 1 || B > N || V < 1 || C < 1 || C > Gl
        || block_b < 1 || block_b > 1024)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((B + block_b - 1) / block_b, C);
    packed_shard_round_kernel<<<grid, block_b, 0, (cudaStream_t)stream>>>(
        (const int*)seg, (const int*)next_inst, (const int*)crnd, (const int*)limit,
        (const int*)alive, (const int*)enabled, quorum, A, N, V, B,
        (int*)st_rnd, (int*)st_vrnd, (int*)st_val,
        (int*)ldel, (int*)linst, (int*)lval,
        (const int*)values, (bool*)fresh, (int*)win, (int*)value);
    return (int)cudaGetLastError();
}
