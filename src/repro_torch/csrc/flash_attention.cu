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
// Bound.  4*D operations for each unmasked (query, key) pair and every
// input byte read once, every output byte written once.  At the LM path's
// shape (B=2, H=32, KVH=16, S=2048, D=128, bf16) that is 68.7 GFLOP causal,
// 51.6 GFLOP at window 1024, against 100.7 MB: 0.070 and 0.052 ms at the
// card's 989 TFLOP/s bf16 dense rate, 0.030 ms at 3.35 TB/s -- bound by the
// tensor cores' operations.
//
// Design.  The TPU walks the k tiles as a sequential third grid axis and
// carries (acc, m, l) in VMEM scratch; here one block owns one
// (head, q tile) and loops over the k tiles itself, with K and V tiles
// staged in shared memory and (acc, m, l) in registers.
//  * bf16: 4 warps, 16 query rows each (64 per block), 64 keys a tile;
//    both products are mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//    score accumulators repacked in registers as the A operand of PV.
//  * f32: scalar FMA in full float32 (no TF32), 32 query rows and 32 keys a
//    tile, 256 threads; the same order of operations per tile.
// A block visits only the k tiles that hold an unmasked key of one of its
// rows, unless one of its rows has none: then it visits every tile, so
// that row still averages V over all Sk keys.  Skipping is exact for the
// other rows: a fully masked tile adds p = 1 terms that the first unmasked
// tile scales by alpha = exp(-1e30 - m) = 0, or p = exp(-1e30 - m) = 0.
// Plain loads and stores; no TMA, wgmma or warp specialisation yet.
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
};

__device__ __forceinline__ int kv_head(int bh, int H, int KVH) {
    const int G = H / KVH;
    return (bh % H) / G + (bh / H) * KVH;
}

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

__device__ __forceinline__ float mask_score(float s, int qpos, int kpos, const Params& p) {
    if (kpos >= p.Sk) return -INFINITY;  // absent: exp gives exactly 0
    if (p.causal && kpos > qpos) return NEG_BIG;
    if (p.window > 0 && kpos <= qpos - p.window) return NEG_BIG;
    return s;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int MQ = 64;   // query rows per block (16 per warp)
constexpr int MK = 64;   // keys per tile
constexpr int MT = 128;  // threads

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return (uint32_t)__bfloat16_as_ushort(h.x) | ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
}

__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
    return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int DT>  // DT: the head dims the registers hold, D <= DT
__global__ void __launch_bounds__(MT) flash_mma_kernel(Params p) {
    extern __shared__ __align__(16) uint16_t smem16[];
    constexpr int LD = DT + 8;  // row stride in elements: conflict-free fragment reads
    uint16_t* Qs = smem16;      // [MQ][LD]
    uint16_t* Ks = Qs + MQ * LD;  // [MK][LD]
    uint16_t* Vs = Ks + MK * LD;  // [MK][LD]
    const int D = p.D;
    const int chunks = D / 8;  // 16-byte chunks per row
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // the longest rows first
    const int q1 = min(q0 + MQ, p.Sq);
    const int kvh = kv_head(bh, p.H, p.KVH);
    const uint16_t* q = (const uint16_t*)p.q + (size_t)bh * p.Sq * D;
    const uint16_t* k = (const uint16_t*)p.k + (size_t)kvh * p.Sk * D;
    const uint16_t* v = (const uint16_t*)p.v + (size_t)kvh * p.Sk * D;
    __nv_bfloat16* o = (__nv_bfloat16*)p.o + (size_t)bh * p.Sq * D;

    for (int e = tid; e < MQ * chunks; e += MT) {
        const int r = e / chunks, c = e % chunks;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (q0 + r < p.Sq) val = *(const uint4*)(q + (size_t)(q0 + r) * D + c * 8);
        *(uint4*)(Qs + r * LD + c * 8) = val;
    }

    float acc[DT / 8][4];
#pragma unroll
    for (int dn = 0; dn < DT / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    float m_row[2] = {NEG_BIG, NEG_BIG}, l_row[2] = {0.f, 0.f};
    const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

    int k_begin, k_end;
    key_range(p, q0, q1, k_begin, k_end);
    for (int k0 = (k_begin / MK) * MK; k0 < k_end; k0 += MK) {
        __syncthreads();  // the last tile's readers are done
        for (int e = tid; e < MK * chunks; e += MT) {
            const int r = e / chunks, c = e % chunks;
            uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (k0 + r < p.Sk) {
                kk = *(const uint4*)(k + (size_t)(k0 + r) * D + c * 8);
                vv = *(const uint4*)(v + (size_t)(k0 + r) * D + c * 8);
            }
            *(uint4*)(Ks + r * LD + c * 8) = kk;
            *(uint4*)(Vs + r * LD + c * 8) = vv;
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows and the tile's 64 keys
        float s[MK / 8][4];
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < DT / 16; ++kc) {
            if (kc * 16 < D) {
                const uint16_t* qa = Qs + (warp * 16 + g) * LD + kc * 16 + t * 2;
                const uint32_t a0 = *(const uint32_t*)qa;
                const uint32_t a1 = *(const uint32_t*)(qa + 8 * LD);
                const uint32_t a2 = *(const uint32_t*)(qa + 8);
                const uint32_t a3 = *(const uint32_t*)(qa + 8 * LD + 8);
#pragma unroll
                for (int n = 0; n < MK / 8; ++n) {
                    const uint16_t* kb = Ks + (n * 8 + g) * LD + kc * 16 + t * 2;
                    mma_bf16(s[n], a0, a1, a2, a3, *(const uint32_t*)kb,
                             *(const uint32_t*)(kb + 8));
                }
            }
        }

        // online softmax; a row's 64 scores live in the 4 threads of a quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int col = k0 + n * 8 + t * 2 + j;
                s[n][j] = mask_score(s[n][j] * p.scale, row_a, col, p);
                s[n][2 + j] = mask_score(s[n][2 + j] * p.scale, row_b, col, p);
                mx[0] = fmaxf(mx[0], s[n][j]);
                mx[1] = fmaxf(mx[1], s[n][2 + j]);
            }
        }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_row[r], mx[r]);
            alpha[r] = expf(m_row[r] - m_new);
            m_row[r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                s[n][j] = expf(s[n][j] - m_row[0]);
                s[n][2 + j] = expf(s[n][2 + j] - m_row[1]);
                sum[0] += s[n][j];
                sum[1] += s[n][2 + j];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
            l_row[r] = l_row[r] * alpha[r] + sum[r];
        }
#pragma unroll
        for (int dn = 0; dn < DT / 8; ++dn) {
            acc[dn][0] *= alpha[0];
            acc[dn][1] *= alpha[0];
            acc[dn][2] *= alpha[1];
            acc[dn][3] *= alpha[1];
        }

        // acc += bf16(P) V: two score tiles of 8 keys make one A fragment
#pragma unroll
        for (int j = 0; j < MK / 16; ++j) {
            const uint32_t a0 = pack_floats(s[2 * j][0], s[2 * j][1]);
            const uint32_t a1 = pack_floats(s[2 * j][2], s[2 * j][3]);
            const uint32_t a2 = pack_floats(s[2 * j + 1][0], s[2 * j + 1][1]);
            const uint32_t a3 = pack_floats(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int dn = 0; dn < DT / 8; ++dn) {
                if (dn * 8 < D) {
                    const uint16_t* vb = Vs + (j * 16 + t * 2) * LD + dn * 8 + g;
                    mma_bf16(acc[dn], a0, a1, a2, a3, pack_bits(vb[0], vb[LD]),
                             pack_bits(vb[8 * LD], vb[9 * LD]));
                }
            }
        }
    }

    const float la = fmaxf(l_row[0], 1e-30f), lb = fmaxf(l_row[1], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < DT / 8; ++dn) {
        if (dn * 8 < D) {
            const int col = dn * 8 + t * 2;
            if (row_a < p.Sq)
                *(__nv_bfloat162*)(o + (size_t)row_a * D + col) =
                    __floats2bfloat162_rn(acc[dn][0] / la, acc[dn][1] / la);
            if (row_b < p.Sq)
                *(__nv_bfloat162*)(o + (size_t)row_b * D + col) =
                    __floats2bfloat162_rn(acc[dn][2] / lb, acc[dn][3] / lb);
        }
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
    const int kvh = kv_head(bh, p.H, p.KVH);
    const float* q = (const float*)p.q + (size_t)bh * p.Sq * D;
    const float* k = (const float*)p.k + (size_t)kvh * p.Sk * D;
    const float* v = (const float*)p.v + (size_t)kvh * p.Sk * D;
    float* o = (float*)p.o + (size_t)bh * p.Sq * D;

    for (int e = tid; e < SQ * D; e += ST) {
        const int r = e / D;
        Qs[e] = q0 + r < p.Sq ? q[(size_t)q0 * D + e] : 0.f;
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
            Ks[r * (D + 1) + c] = in ? k[(size_t)k0 * D + e] : 0.f;
            Vs[e] = in ? v[(size_t)k0 * D + e] : 0.f;
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
            const int r = e / D;
            if (q0 + r < p.Sq) o[(size_t)q0 * D + e] = acc[i] / fmaxf(row_l[r], 1e-30f);
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

template <int DT>
static int launch_mma(const Params& p, cudaStream_t stream) {
    static bool ready = false;  // opted in to the shared memory once, outside any graph capture
    const size_t smem = 3 * MQ * (DT + 8) * sizeof(uint16_t);
    const cudaError_t e = allow_smem(flash_mma_kernel<DT>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(p.B * p.H, (p.Sq + MQ - 1) / MQ);
    flash_mma_kernel<DT><<<grid, MT, smem, stream>>>(p);
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

// dtype: 0 float32, 1 bfloat16.  q, k, v, o contiguous and 16-byte aligned.
extern "C" int flash_attention(int dtype, int B, int H, int KVH, int Sq, int Sk, int D,
                               int window, int causal, float scale, const void* q,
                               const void* k, const void* v, void* o, void* stream) {
    if (B < 1 || H < 1 || KVH < 1 || H % KVH || Sq < 1 || Sk < 1 || D < 16 || D > 256 ||
        D % 16 || (long long)B * H > 0x7fffffffLL || (Sq + SQ - 1) / SQ > 65535)
        return (int)cudaErrorInvalidValue;
    const Params p{B, H, KVH, Sq, Sk, D, window, causal, scale, q, k, v, o};
    const cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return launch_f32(p, s);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (D <= 64) return launch_mma<64>(p, s);
    if (D <= 128) return launch_mma<128>(p, s);
    return launch_mma<256>(p, s);
}
