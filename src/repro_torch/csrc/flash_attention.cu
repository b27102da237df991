// K9: online-softmax GQA attention (causal / sliding window), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_flash_kernel`); its oracle is
// `repro.kernels.ref.flash_attention`.  For q (B, H, Sq, D) and k, v
// (B, KVH, Sk, D), head bh of the flattened B*H reads kv head
// (bh % H) / G + (bh / H) * KVH with G = H / KVH, and
//   s[i, j] = (q_i . k_j) * scale                     (float32)
//   masked where j > i (causal) or j <= i - window (window > 0): s = -1e30
//   out_i   = sum_j bf(p_ij) v_j / max(l_i, 1e-30),   p = exp(s - m), online
// with m starting at -1e30, so a row that sees no key averages V over all
// Sk keys, as the oracle's softmax of a constant row does.  Keys past Sk are
// absent (their p is exactly 0).  bf() casts p to V's dtype before the PV
// product; every sum is float32; the output is cast to q's dtype.
//
// Layout.  q, k, v and o are read and written through their strides: the
// last dim contiguous, the others multiples of 8 elements (16-byte rows for
// bf16), so a (B, H, S, D) view of the model's (B, S, H, D) tensors is read
// in place.
//
// Bound.  4*D operations for each unmasked (query, key) pair and every
// input byte read once, every output byte written once.  At the LM path's
// shape (B=2, H=32, KVH=16, S=2048, D=128, bf16) that is 68.7 GFLOP causal,
// 51.6 GFLOP at window 1024, against 100.7 MB: 0.070 and 0.052 ms at the
// card's 989 TFLOP/s bf16 dense rate, 0.030 ms at 3.35 TB/s -- bound by the
// tensor cores' operations.
//
// Design.  The TPU walks the k tiles as a sequential third grid axis and
// carries (acc, m, l) in VMEM scratch; here a work item is one
// (head, 128-row q tile), the longest rows first, whose k tiles are a loop
// with (acc, m, l) in registers.
//  * bf16 (flash_wgmma_kernel): persistent, one block an SM walking the
//    items in a snake, with three warpgroups.  A producer warpgroup
//    (registers given up with setmaxnreg) TMA-loads each item's Q tile and
//    its K and V tiles into a ring of STAGES stages in shared memory, each
//    with a full and an empty mbarrier; the ring runs on across items, and
//    the next item's Q loads while this one's last tiles and epilogue run.
//    Two consumer warpgroups (registers taken with setmaxnreg), 64 q rows
//    each, compute S = Q K^T with wgmma from shared memory (both operands
//    K-major, 128-byte swizzle), the online softmax in registers (exp2 with
//    scale * log2(e) folded in, one MUFU.EX2 an element), then
//    O += bf16(P) V with wgmma, P as the register A operand and V's
//    (key, d) tile as the shared B operand read with the transpose bit, so
//    V is never transposed.  The two consumers take turns on the tensor
//    cores (named barriers): one issues its PV and next QK while the other
//    runs its softmax.  A 128-byte swizzled TMA box is 64 bf16 wide, so a
//    tile of DT head dims arrives as DT / 64 panels of 64 columns; the
//    descriptors step through them.  Key tiles of 128 for DT <= 128 and 64
//    for DT = 256, so that S, P and O fit the consumers' registers.  TMA
//    zero-fills rows past Sq, Sk and columns past D; keys past Sk still get
//    -inf by index.  The output goes back through shared memory (a buffer
//    of its own for DT <= 128, the consumer's Q rows for DT = 256) and a TMA
//    store, which clips rows past Sq and columns past D.
//    Not done: the intra-warpgroup overlap of a tile's softmax with the
//    last tile's PV.  It needs S, P and O live at once with two products
//    in flight, and ptxas then spilled and serialised the wgmmas.
//  * f32 (flash_f32_kernel): scalar FMA in full float32, 32 query rows and
//    32 keys a tile, 256 threads; the same order of operations per tile.
//    wgmma's only float32 input is TF32, which K9 never uses.
// A q tile (an item in bf16, a block in float32) visits only the k tiles
// that hold an unmasked key of one of its rows, unless one of its rows has
// none: then it visits every tile, so that row still averages V over all
// Sk keys.  Skipping is exact for the
// other rows: a fully masked tile adds p = 1 terms that the first unmasked
// tile scales by alpha = exp(-1e30 - m) = 0, or p = exp(-1e30 - m) = 0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define NEG_BIG (-1e30f)

struct Params {
    int B, H, KVH, Sq, Sk, D, window, causal;
    float scale;
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long qs[3], ks[3], vs[3], os[3];  // strides in elements of dims b, h, s
};

// The k columns [k_begin, k_end) that the q rows [q0, q1) must visit.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1, int& k_begin,
                                          int& k_end) {
    const int q_last = q1 - 1;
    // the last row sees the fewest keys under a window; if it sees one, all do
    const bool all_see = p.window <= 0 || q_last - p.window + 1 <= p.Sk - 1;
    k_begin = 0;
    k_end = p.Sk;
    if (all_see) {
        if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
        if (p.causal) k_end = min(p.Sk, q_last + 1);
    }
}

// Branch-free: selects, no jumps, in the unrolled loops over a tile.
__device__ __forceinline__ float mask_score(float s, int qpos, int kpos, const Params& p) {
    const bool hidden = (p.causal & (kpos > qpos)) | ((p.window > 0) & (kpos <= qpos - p.window));
    return kpos >= p.Sk ? -INFINITY : (hidden ? NEG_BIG : s);  // absent: exp gives exactly 0
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma, warp-specialised
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.  A wait
// of more than about ten seconds traps, so a fault in the ring's protocol
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - start > 20000000000LL) asm volatile("trap;");
}

// One 4-d box (64 columns, rows, 1, 1) of the tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
            "l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across the wgmma's issue or its wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// A shared-memory matrix descriptor in the 128-byte swizzle mode; byte
// offsets in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x in one MUFU.EX2, flushing results below 2^-126 to 0 (exp2f adds a
// rescale around it for those); exact at 0 and 0 at -inf
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
}

// The accumulator operands of a wgmma, 8 at a time
#define F8(i)                                                                               \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
        "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, float32) (+)= A (64 x 16, shared) . B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128, float32) (+)= A (64 x 16, shared) . B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
          F8(48), F8(56)
        : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, float32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 128, float32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
          F8(48), F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 256, float32) += A (64 x 16, registers) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40),
          F8(48), F8(56), F8(64), F8(72), F8(80), F8(88),
          F8(96), F8(104), F8(112), F8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef F8

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

constexpr int WG = 128;                           // threads of a warpgroup
constexpr int NT = 3 * WG;                        // a producer and two consumer warpgroups
constexpr int BQ = 128;                           // q rows an item: 64 a consumer
constexpr int PANEL = 64;                         // bf16 columns of one 128-byte swizzled TMA box
constexpr int ROW_BYTES = 128;                    // a panel's row
constexpr int Q_PANEL_BYTES = 64 * ROW_BYTES;     // a consumer's 64 rows of one panel
constexpr int SMEM_MAX = 232448;                  // shared memory a block may opt in to
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65536
// named barriers: 1 + c, one consumer's epilogue; 3 + c, consumer c's turn
constexpr int BAR_EPILOGUE = 1, BAR_TURN = 3;

template <int DT>  // DT: the head dims the registers hold, D <= DT
struct Tile {
    static constexpr int BN = DT <= 128 ? 128 : 64;  // keys a tile
    // two stages: with a third, DT = 128's own O buffer no longer fits (and
    // it measured slower)
    static constexpr int STAGES = 2;  // K/V ring depth
    static constexpr int NP = DT / PANEL;            // 64-column panels a row
    static constexpr int QW_BYTES = 64 * DT * 2;     // one consumer's Q (or O) rows
    static constexpr int KV_BYTES = BN * DT * 2;     // one K or V tile
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + 2 * QW_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
    static constexpr int END = V_OFF + STAGES * KV_BYTES;
    // q_full, q_empty, then k_full, v_full, k_empty, v_empty a stage each
    static constexpr int BAR_BYTES = 8 * (2 + 4 * STAGES);
    // O has a buffer of its own where it fits (DT <= 128), so that the next
    // item's Q loads under this item's epilogue; else it reuses Q's
    static constexpr bool OWN_O = END + 2 * QW_BYTES + BAR_BYTES + 1024 <= SMEM_MAX;
    static constexpr int O_OFF = OWN_O ? END : Q_OFF;
    static constexpr int BAR_OFF = OWN_O ? END + 2 * QW_BYTES : END;
    // + slack to align the base to the 1024 bytes the swizzle needs
    static constexpr int SMEM = BAR_OFF + BAR_BYTES + 1024;
};

// Issue S = Q K^T for a consumer's 64 rows and a tile of BN keys: both
// operands K-major, 16 head dims a step, 4 steps a 64-column panel.
template <int DT, int BN>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_smem, uint32_t k_smem) {
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 within a 128-byte row
        const uint64_t da = gmma_desc(q_smem + (kk / 4) * Q_PANEL_BYTES + off, 16, 1024);
        const uint64_t db = gmma_desc(k_smem + (kk / 4) * BN * ROW_BYTES + off, 16, 1024);
        if constexpr (BN == 128)
            wgmma_ss_n128(sc, da, db, kk > 0);
        else
            wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
}

// Issue O += P V: P in registers, 4 a 16-key step; V's (key, d) tile the
// MN-major B operand, LBO stepping its 64-column panels, SBO its 8-key groups.
template <int DT, int BN>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* pk, uint32_t v_smem) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = gmma_desc(v_smem + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 1024);
        if constexpr (DT == 64)
            wgmma_rs_n64(o, pk + 4 * kk, db);
        else if constexpr (DT == 128)
            wgmma_rs_n128(o, pk + 4 * kk, db);
        else
            wgmma_rs_n256(o, pk + 4 * kk, db);
    }
    wgmma_commit();
}

// The online softmax of one tile of raw scores q.k, in place: sc ends as
// the unrounded P.  Score accumulator i holds row (i & 2 ? b : a) of the
// thread and column col0 + (i / 4) * 8 + (i & 1); a row's scores live in a
// quad.  Updates (m, l) of both rows in log2 units (scale * log2(e) folded
// in) and returns the factors alpha that rescale O.
template <int BN>
__device__ __forceinline__ void softmax_tile(float* sc, float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& al_a, float& al_b, bool masked,
                                             float sl2, int row_a, int row_b, int col0,
                                             const Params& p) {
    float mul = sl2;
    if (masked) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
            sc[i] = mask_score(sc[i] * sl2, (i & 2) ? row_b : row_a, col0 + (i / 4) * 8 + (i & 1),
                               p);
        mul = 1.f;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
        if (i & 2)
            mx_b = fmaxf(mx_b, sc[i]);
        else
            mx_a = fmaxf(mx_a, sc[i]);
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a * mul), mn_b = fmaxf(m_b, mx_b * mul);
    al_a = ex2(m_a - mn_a);
    al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
        if (i & 2) {
            sc[i] = ex2(fmaf(sc[i], mul, -m_b));
            sum_b += sc[i];
        } else {
            sc[i] = ex2(fmaf(sc[i], mul, -m_a));
            sum_a += sc[i];
        }
    }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
}

// bf16(P) in the A operand's layout, which is the accumulator's: 4
// registers a 16-key step.
template <int BN>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pk) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        pk[2 * j] = pack_floats(sc[4 * j], sc[4 * j + 1]);
        pk[2 * j + 1] = pack_floats(sc[4 * j + 2], sc[4 * j + 3]);
    }
}

// The work items, (head bh, 128-row q tile), longest rows first.  A block
// walks them in a snake over the grid: item r * grid + i on even rounds r,
// r * grid + grid - 1 - i on odd ones, which evens out the causal lengths.
struct Items {
    int bhs, nq, total;
    __device__ Items(const Params& p) : bhs(p.B * p.H), nq((p.Sq + BQ - 1) / BQ) {
        total = bhs * nq;
    }
    __device__ bool get(int r, int& bh, int& q0) const {
        const int g = gridDim.x, i = blockIdx.x;
        const long long j = (long long)r * g + ((r & 1) ? g - 1 - i : i);
        if (j >= total) return false;
        bh = (int)(j % bhs);
        q0 = (nq - 1 - (int)(j / bhs)) * BQ;
        return true;
    }
};

// The k tiles of the item at q0: the first tile's key and the count.
template <int BN>
__device__ __forceinline__ int item_tiles(const Params& p, int q0, int& kt0) {
    int k_begin, k_end;
    key_range(p, q0, min(q0 + BQ, p.Sq), k_begin, k_end);
    kt0 = (k_begin / BN) * BN;
    return (k_end - kt0 + BN - 1) / BN;
}

template <int DT>
__global__ void __launch_bounds__(NT, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, const Params p) {
    using T = Tile<DT>;
    constexpr int BN = T::BN, NP = T::NP, STAGES = T::STAGES;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const smem = smem_raw + (base - raw);
    const uint32_t q_full = base + T::BAR_OFF, q_empty = q_full + 8;
    auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
    auto v_full = [&](int s) { return q_full + 8u * (2 + STAGES + s); };
    auto k_empty = [&](int s) { return q_full + 8u * (2 + 2 * STAGES + s); };
    auto v_empty = [&](int s) { return q_full + 8u * (2 + 3 * STAGES + s); };
    auto k_smem = [&](int s) { return base + T::K_OFF + s * T::KV_BYTES; };
    auto v_smem = [&](int s) { return base + T::V_OFF + s * T::KV_BYTES; };
    const Items items(p);
    const int G = p.H / p.KVH;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        // the consumers' warps release Q after their last QK, or, where O
        // reuses Q's buffer, each consumer once its TMA store has read it
        mbar_init(q_empty, T::OWN_O ? 8 : 2);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(k_empty(s), 8);  // lane 0 of each of the 8 consumer warps
            mbar_init(v_empty(s), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < WG) {
        // producer: one thread issues every TMA load, K before V a tile
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            int ring = 0;  // K/V tiles issued so far, over every item
            int bh, q0;
            for (int r = 0; items.get(r, bh, q0); ++r) {
                const int b = bh / p.H, h = bh % p.H, kvh = h / G;
                int kt0;
                const int n = item_tiles<BN>(p, q0, kt0);
                if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
                mbar_expect_tx(q_full, 2 * T::QW_BYTES);
                for (int c = 0; c < 2; ++c)
                    for (int pn = 0; pn < NP; ++pn)
                        tma_load(base + T::Q_OFF + c * T::QW_BYTES + pn * Q_PANEL_BYTES, &tq,
                                 q_full, pn * PANEL, q0 + 64 * c, h, b);
                for (int it = 0; it < n; ++it, ++ring) {
                    const int s = ring % STAGES;
                    const uint32_t ph = (ring / STAGES) & 1;
                    const int k0 = kt0 + it * BN;
                    mbar_wait(k_empty(s), ph ^ 1);
                    mbar_expect_tx(k_full(s), T::KV_BYTES);
                    for (int pn = 0; pn < NP; ++pn)
                        tma_load(k_smem(s) + pn * BN * ROW_BYTES, &tk, k_full(s), pn * PANEL, k0,
                                 kvh, b);
                    mbar_wait(v_empty(s), ph ^ 1);
                    mbar_expect_tx(v_full(s), T::KV_BYTES);
                    for (int pn = 0; pn < NP; ++pn)
                        tma_load(v_smem(s) + pn * BN * ROW_BYTES, &tv, v_full(s), pn * PANEL, k0,
                                 kvh, b);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int c = threadIdx.x / WG - 1;  // consumer 0 or 1
        const int tw = threadIdx.x % WG, warp = tw / 32, lane = tw % 32;
        const int g = lane >> 2, t = lane & 3;
        const uint32_t q_smem = base + T::Q_OFF + c * T::QW_BYTES;
        const uint32_t o_smem = base + T::O_OFF + c * T::QW_BYTES;
        const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
        // The consumers take turns to issue their products, so one's
        // softmax runs beside the other's products: consumer c waits on
        // barrier BAR_TURN + c, then hands the turn over.  Consumer 0 goes
        // first.
        auto take_turn = [&]() { named_sync(BAR_TURN + c, 2 * WG); };
        auto pass_turn = [&]() { named_arrive(BAR_TURN + 1 - c, 2 * WG); };
        if (c == 1) pass_turn();

        int ring = 0;
        int bh, q0;
        for (int r = 0; items.get(r, bh, q0); ++r) {
            int next_bh, next_q0;
            const bool last_item = !items.get(r + 1, next_bh, next_q0);
            const int b = bh / p.H, h = bh % p.H;
            int kt0;
            const int n = item_tiles<BN>(p, q0, kt0);
            const int r_lo = q0 + 64 * c;  // this consumer's first row
            const int row_a = r_lo + 16 * warp + g, row_b = row_a + 8;
            // a tile needs masking where one of its keys is past Sk, or past a
            // row (causal), or at or below a row's window
            auto masked = [&](int k0) {
                return k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > r_lo) ||
                       (p.window > 0 && k0 <= r_lo + 63 - p.window);
            };
            auto release_q = [&](int it) {  // after tile it's scores: the last reads Q
                if (T::OWN_O && it == n - 1 && lane == 0) mbar_arrive(q_empty);
            };

            float o[DT / 2];
#pragma unroll
            for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
            float m_a = NEG_BIG, m_b = NEG_BIG, l_a = 0.f, l_b = 0.f, al_a, al_b;
            float sc[BN / 2];
            uint32_t pk[BN / 4];

            // the first tile's scores and softmax; O is still 0
            mbar_wait(q_full, r & 1);
            {
                const int s = ring % STAGES;
                mbar_wait(k_full(s), (ring / STAGES) & 1);
                take_turn();
                wgmma_fence();
                issue_qk<DT, BN>(sc, q_smem, k_smem(s));
                pass_turn();
                wgmma_wait<0>();
                fence_regs<BN / 2>(sc);
                if (lane == 0) mbar_arrive(k_empty(s));
                release_q(0);
                softmax_tile<BN>(sc, m_a, m_b, l_a, l_b, al_a, al_b, masked(kt0), sl2, row_a,
                                 row_b, kt0 + 2 * t, p);
                pack_p<BN>(sc, pk);
            }
            // then, a tile at a time, the last tile's PV and this tile's scores
            // in one turn, and this tile's softmax outside it
            for (int it = 1; it < n; ++it) {
                const int s = (ring + it) % STAGES, sp = (ring + it - 1) % STAGES;
                const int k0 = kt0 + it * BN;
                mbar_wait(v_full(sp), ((ring + it - 1) / STAGES) & 1);
                mbar_wait(k_full(s), ((ring + it) / STAGES) & 1);
                take_turn();
                fence_regs<DT / 2>(o);
                fence_regs<BN / 4>(pk);
                wgmma_fence();
                issue_pv<DT, BN>(o, pk, v_smem(sp));
                wgmma_wait<0>();
                fence_regs<DT / 2>(o);
                fence_regs<BN / 4>(pk);
                if (lane == 0) mbar_arrive(v_empty(sp));
                wgmma_fence();
                issue_qk<DT, BN>(sc, q_smem, k_smem(s));
                pass_turn();
                wgmma_wait<0>();
                fence_regs<BN / 2>(sc);
                if (lane == 0) mbar_arrive(k_empty(s));
                release_q(it);
                softmax_tile<BN>(sc, m_a, m_b, l_a, l_b, al_a, al_b, masked(k0), sl2, row_a,
                                 row_b, k0 + 2 * t, p);
                pack_p<BN>(sc, pk);
#pragma unroll
                for (int i = 0; i < DT / 2; ++i) o[i] *= (i & 2) ? al_b : al_a;
            }
            // the last tile's PV; consumer 1 hands no turn over after its last
            {
                const int sl = (ring + n - 1) % STAGES;
                mbar_wait(v_full(sl), ((ring + n - 1) / STAGES) & 1);
                take_turn();
                fence_regs<DT / 2>(o);
                fence_regs<BN / 4>(pk);
                wgmma_fence();
                issue_pv<DT, BN>(o, pk, v_smem(sl));
                if (c == 0 || !last_item) pass_turn();
                wgmma_wait<0>();
                fence_regs<DT / 2>(o);
                fence_regs<BN / 4>(pk);
                if (lane == 0) mbar_arrive(v_empty(sl));
            }
            ring += n;

            // O / l in bf16 into this consumer's O rows (128-byte swizzle, as
            // TMA reads them) once the last item's store has read them, then
            // one TMA store a panel
            if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            named_sync(BAR_EPILOGUE + c, WG);
            const float la = 1.f / fmaxf(l_a, 1e-30f), lb = 1.f / fmaxf(l_b, 1e-30f);
            uint8_t* const os = smem + T::O_OFF + c * T::QW_BYTES;
            const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
            for (int j = 0; j < DT / 8; ++j) {  // columns 8 j + 2 t, + 1
                uint8_t* const pnl = os + (j / 8) * Q_PANEL_BYTES + t * 4;
                *(uint32_t*)(pnl + ra * ROW_BYTES + (((j % 8) ^ (ra & 7)) * 16)) =
                    pack_floats(o[4 * j] * la, o[4 * j + 1] * la);
                *(uint32_t*)(pnl + rb * ROW_BYTES + (((j % 8) ^ (rb & 7)) * 16)) =
                    pack_floats(o[4 * j + 2] * lb, o[4 * j + 3] * lb);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            named_sync(BAR_EPILOGUE + c, WG);
            if (tw == 0) {
                if (r_lo < p.Sq)
                    for (int pn = 0; pn < NP; ++pn)
                        tma_store(&to, o_smem + pn * Q_PANEL_BYTES, pn * PANEL, r_lo, h, b);
                asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
                if (!T::OWN_O) {  // the next Q loads into these rows
                    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
                    mbar_arrive(q_empty);
                }
            }
        }
        if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA
// ---------------------------------------------------------------------------
constexpr int SQ = 32;   // query rows per block
constexpr int SK = 32;   // keys per tile: one per lane in the softmax
constexpr int ST = 256;  // threads
constexpr int SPER = SQ * 256 / ST;  // output elements a thread holds, D <= 256

__global__ void __launch_bounds__(ST) flash_f32_kernel(Params p) {
    extern __shared__ float smem32[];
    const int D = p.D;
    float* Qs = smem32;              // [SQ][D]
    float* Ks = Qs + SQ * D;         // [SK][D + 1]: conflict-free column reads
    float* Vs = Ks + SK * (D + 1);   // [SK][D]
    float* Ps = Vs + SK * D;         // [SQ][SK + 1]
    float* row_m = Ps + SQ * (SK + 1);
    float* row_l = row_m + SQ;
    float* row_alpha = row_l + SQ;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * SQ;
    const int q1 = min(q0 + SQ, p.Sq);
    const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KVH);
    // row r of each operand's (b, head) plane
    const float* q = (const float*)p.q + b * p.qs[0] + h * p.qs[1];
    const float* k = (const float*)p.k + b * p.ks[0] + kvh * p.ks[1];
    const float* v = (const float*)p.v + b * p.vs[0] + kvh * p.vs[1];
    float* o = (float*)p.o + b * p.os[0] + h * p.os[1];

    for (int e = tid; e < SQ * D; e += ST) {
        const int r = e / D, c = e % D;
        Qs[e] = q0 + r < p.Sq ? q[(q0 + r) * p.qs[2] + c] : 0.f;
    }
    if (tid < SQ) {
        row_m[tid] = NEG_BIG;
        row_l[tid] = 0.f;
    }
    float acc[SPER];
#pragma unroll
    for (int i = 0; i < SPER; ++i) acc[i] = 0.f;

    int k_begin, k_end;
    key_range(p, q0, q1, k_begin, k_end);
    for (int k0 = (k_begin / SK) * SK; k0 < k_end; k0 += SK) {
        __syncthreads();
        for (int e = tid; e < SK * D; e += ST) {
            const int r = e / D, c = e % D;
            const bool in = k0 + r < p.Sk;
            Ks[r * (D + 1) + c] = in ? k[(k0 + r) * p.ks[2] + c] : 0.f;
            Vs[e] = in ? v[(k0 + r) * p.vs[2] + c] : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < SQ * SK; e += ST) {
            const int r = e / SK, c = e % SK;
            const float* qr = Qs + r * D;
            const float* kr = Ks + c * (D + 1);
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
            Ps[r * (SK + 1) + c] = mask_score(dot * p.scale, q0 + r, k0 + c, p);
        }
        __syncthreads();
        for (int r = warp; r < SQ; r += ST / 32) {
            const float sc = Ps[r * (SK + 1) + lane];
            float mx = sc;
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_prev = row_m[r];
            const float m_new = fmaxf(m_prev, mx);
            const float pr = expf(sc - m_new);
            float sum = pr;
            for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            Ps[r * (SK + 1) + lane] = pr;
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                row_alpha[r] = alpha;
                row_l[r] = row_l[r] * alpha + sum;
                row_m[r] = m_new;
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < SPER; ++i) {
            const int e = tid + ST * i;
            if (e < SQ * D) {
                const int r = e / D, c = e % D;
                const float* pr = Ps + r * (SK + 1);
                float pv = 0.f;
                for (int j = 0; j < SK; ++j) pv = fmaf(pr[j], Vs[j * D + c], pv);
                acc[i] = acc[i] * row_alpha[r] + pv;
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SPER; ++i) {
        const int e = tid + ST * i;
        if (e < SQ * D) {
            const int r = e / D, c = e % D;
            if (q0 + r < p.Sq) o[(q0 + r) * p.os[2] + c] = acc[i] / fmaxf(row_l[r], 1e-30f);
        }
    }
}

// ---------------------------------------------------------------------------
// entry
// ---------------------------------------------------------------------------
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
    if (done || bytes <= 48 * 1024) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    done = e == cudaSuccess;
    return e;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                               12000, cudaEnableDefault, &got);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &got);
#endif
        if (e == cudaSuccess && got == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
    }
    return fn;
}

// Codes above this are a CUresult of the tensor map's encoding.
constexpr int TENSOR_MAP_ERROR = 10000;

// A bf16 (B, heads, S, D) operand at strides st (elements of b, head, s) as
// boxes of (64 head dims, rows) in the 128-byte swizzle.
static int tensor_map(CUtensorMap* map, const void* ptr, const long long* st, int d, int s,
                      int heads, int b, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r =
        encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

template <int DT>
static int launch_wgmma(const Params& p, cudaStream_t stream) {
    static bool ready = false;  // opted in to the shared memory once, outside any graph capture
    const cudaError_t e = allow_smem(flash_wgmma_kernel<DT>, Tile<DT>::SMEM, ready);
    if (e != cudaSuccess) return (int)e;
    // built on the host for each call; a graph captures them by value
    CUtensorMap tq, tk, tv, to;
    int rc = tensor_map(&tq, p.q, p.qs, p.D, p.Sq, p.H, p.B, 64);
    if (rc == 0) rc = tensor_map(&tk, p.k, p.ks, p.D, p.Sk, p.KVH, p.B, Tile<DT>::BN);
    if (rc == 0) rc = tensor_map(&tv, p.v, p.vs, p.D, p.Sk, p.KVH, p.B, Tile<DT>::BN);
    if (rc == 0) rc = tensor_map(&to, p.o, p.os, p.D, p.Sq, p.H, p.B, 64);
    if (rc != 0) return rc;
    // persistent: one block an SM (the shared memory allows no second), or
    // one an item where there are fewer
    static int sms_of[64] = {};  // SM count by device, asked once
    int device = 0;
    cudaError_t ge = cudaGetDevice(&device);
    if (ge == cudaSuccess && (device < 0 || device >= 64)) ge = cudaErrorInvalidDevice;
    if (ge == cudaSuccess && sms_of[device] == 0)
        ge = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (ge != cudaSuccess) return (int)ge;
    const int sms = sms_of[device];
    const long long items = (long long)p.B * p.H * ((p.Sq + BQ - 1) / BQ);
    const int grid = (int)(items < sms ? items : sms);
    flash_wgmma_kernel<DT><<<grid, NT, Tile<DT>::SMEM, stream>>>(tq, tk, tv, to, p);
    return (int)cudaGetLastError();
}

static int launch_f32(const Params& p, cudaStream_t stream) {
    static bool ready = false;
    const size_t smem = (size_t)(SQ * p.D + SK * (p.D + 1) + SK * p.D + SQ * (SK + 1) + 3 * SQ) *
                        sizeof(float);
    const size_t most = (size_t)(SQ * 256 + SK * 257 + SK * 256 + SQ * (SK + 1) + 3 * SQ) *
                        sizeof(float);  // D = 256
    const cudaError_t e = allow_smem(flash_f32_kernel, most, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(p.B * p.H, (p.Sq + SQ - 1) / SQ);
    flash_f32_kernel<<<grid, ST, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, head, s)
// of q, k, v and o in turn; the last dims contiguous, every stride a
// multiple of 8 elements, every base 16-byte aligned.
extern "C" int flash_attention(int dtype, int B, int H, int KVH, int Sq, int Sk, int D,
                               int window, int causal, float scale, const void* q,
                               const void* k, const void* v, void* o, const long long* strides,
                               void* stream) {
    if (B < 1 || H < 1 || KVH < 1 || H % KVH || Sq < 1 || Sk < 1 || D < 16 || D > 256 ||
        D % 16 || (long long)B * H * ((Sq + SQ - 1) / SQ) > 0x7fffffffLL ||
        (Sq + SQ - 1) / SQ > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{B, H, KVH, Sq, Sk, D, window, causal, scale, q, k, v, o};
    for (int i = 0; i < 3; ++i) {
        p.qs[i] = strides[i];
        p.ks[i] = strides[3 + i];
        p.vs[i] = strides[6 + i];
        p.os[i] = strides[9 + i];
    }
    const cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_f32(p, s);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D <= 64) return launch_wgmma<64>(p, s);
    if (D <= 128) return launch_wgmma<128>(p, s);
    return launch_wgmma<256>(p, s);
}
