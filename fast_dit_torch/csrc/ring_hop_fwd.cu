// One ring-attention hop, forward, for Hopper (sm_90a), fp32 and bf16.
//
// Replaces `fast_dit_tpu/ops/ring_attention.py::_hop_fwd_kernel` (:77-108,
// launched through `pl.pallas_call` by `_hop_forward`, :162-189).
//
// Computes, for every batch row b, head h and query row i of the local
// query shard q (B, Sq, D) against the resident key/value block k, v
// (B, Sk, D), D = H * hd,
//     s[i, j] = (q_h[i] . k_h[j]) * scale
//     p_u     = exp(min(s, 50))
//     o_u[b, i, h*hd:(h+1)*hd] = sum_j p_u[i, j] v_h[j]     fp32 (B, Sq, D)
//     l[b, i, h]               = sum_j p_u[i, j]            fp32 (B, Sq, H)
// There is no running max and no normalisation: the clamp keeps every p_u
// at most exp(50) ~ 5e21, far inside fp32 (and bf16's exponent range), so
// the partials of the hops of a ring add with no rescaling, and the ring
// divides once at the end. q, k and v may be column views of the packed
// (B, S, 3D) projection: each comes with its own batch and row stride
// (elements); o_u and l are contiguous.
//
// What bounds it on the H100. At the sequence-parallel DiT-XL/2 512² shape
// (B = 4 shards x batch 4 = 16, Sq = Sk = 256, H = 16, hd = 72, D = 1152)
// one call does 4*B*Sq*Sk*D = 4.83 GFLOP and must read q, k, v (9.4 MB each
// in bf16) and write o_u (18.9 MB fp32) and l: 47.5 MB. Against the data
// sheet (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s fp32 without
// them) the bf16 call is bound by bytes at ~14 us (its products alone take
// 4.9 us) and the fp32 call by operations at ~72 us.
//
// bf16 (dtype 1, every call of the sequence-parallel path): tensor cores,
// kernel 1's design (`flash_attention_fwd.cu`) without its online softmax,
// with the tile code of `attn_mma_bf16.cuh`.
//  - One 128-thread block (4 warps x 16 query rows) per (64-query tile,
//    head, batch row). The Q tile is read once through q's own strides;
//    64-key K and V tiles stream through a two-stage ring filled with
//    16-byte cp.async (rows >= Sk zero-filled), so the next tile loads while
//    the current one multiplies. Tiles are bf16 with hd padded to a multiple
//    of 16 by zero columns in shared memory only (72 -> 80), pitch 88.
//  - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with fp32
//    accumulation (V through ldmatrix.trans). p_u = exp(min(s, 50)) is
//    formed in registers: s = u * scale in fp32 is clamped in the natural
//    domain, as the plain version does (at the integer clamp-crossing inputs
//    s lands exactly on 50), and only then exp2f(min(s, 50) * log2(e)).
//    Keys >= Sk give p_u = 0.
//  - p_u is rounded to bf16 once, and that value goes both into the A
//    fragment of P V and into the row sum l: the TPU kernel does the same
//    (`pc = p_u.astype(dtype)` feeds both its product with v and its
//    ones-matmul, :99-102), so o_u and l are built from the same values.
//    Each thread sums its share of a row; the quad adds up once at the end.
//  - o_u is fp32 and the largest stream (18.9 of the 47.5 MB). It is
//    written straight from the accumulator fragments as float2s: each quad
//    writes 32 contiguous bytes of a row, whole sectors. Staging each warp's
//    16 x hd tile in shared memory (the K/V ring, free after the last tile)
//    for 16-byte stores was measured against it on the H100: slower at the
//    512² shape, level at 4096-token shards. Query rows >= Sq are never
//    stored.
//  Why mma.sync and not wgmma + TMA: the bound is bytes (14 us against 4.9
//  us of products), mma.sync's rate puts the products at a few us, and a
//  144-byte head row does not fit the 128-byte swizzle atom of a single TMA
//  box and of wgmma's shared-memory descriptors.
//
// fp32 (dtype 0): the fp32-core body below (`ring_hop_fwd_kernel<float>`),
// which holds the 1e-5 limit against the plain version.
//  - One 128-thread block per (64-query tile, head, batch row); the Q tile
//    (64 x hd) is staged once in shared memory, K and V tiles of 64 keys in
//    turn, all fp32; Q and K transposed ([d][row]) so the score loop reads
//    float4s without bank conflicts.
//  - Each thread owns a 4-row x 8-key micro-tile of the scores and, in the
//    P.V product, the same 4 rows x hd/8 output columns (column cg + 8j).
//    The row sums are three xor-shuffles over the 8 neighbouring lanes that
//    share a row group. exp is `expf` of the clamped fp32 logit; p_u stays
//    fp32. Keys >= Sk give p_u = 0, query rows >= Sq are never stored.
// dtype 2 runs bf16 inputs through that fp32-core body: the bf16 body of
// earlier versions, which no wrapper passes; it is kept as the yardstick of
// the tensor-core body (`chip_smoke.py`, `tests/test_torch_cuda.py`).
//
// The TPU kernel's grid over batch rows, with an unrolled head loop and a
// sequential q-chunk loop, becomes independent blocks in both bodies;
// nothing carries between them. The bf16 body rounds p_u as the TPU kernel
// does; the fp32 body and the plain version keep p_u in fp32 (a no-op
// difference for fp32 inputs).
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma_bf16.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int RPT = 4;         // rows per thread
constexpr int KPT = 8;         // keys per thread in the score micro-tile
constexpr int CG = 8;          // column groups (threads sharing a row group)
constexpr float CLAMP = 50.f;

struct Strides {  // (batch, row) strides of q, k and v, in elements
    int64_t qb, qr, kb, kr, vb, vr;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Copy rows [row0, row0 + 64) of one head's HD columns (from column `col`
// of a (B, S, D) tensor whose batch row starts at `src`) into shared memory
// as fp32, 16 bytes per global load. Rows >= S are zero. TRANSPOSED stores
// dst[d * 64 + r], else dst[r * HD + d].
template <typename T, int HD, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int row0,
                                          int S, int64_t row_stride, int col) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int NVEC = HD / VEC;
    for (int c = threadIdx.x; c < BQ * NVEC; c += THREADS) {
        // transposed: neighbouring threads take neighbouring rows, so the
        // [d][r] stores hit distinct banks; else they walk along the row
        const int r = TRANSPOSED ? c % BQ : c / NVEC;
        const int v = TRANSPOSED ? c / BQ : c % NVEC;
        const int row = row0 + r;
        float vals[VEC];
        if (row < S) {
            const T* p = src + (int64_t)row * row_stride + col + v * VEC;
            uint4 raw = *reinterpret_cast<const uint4*>(p);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < VEC; ++i) vals[i] = to_f32(e[i]);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            const int d = v * VEC + i;
            if (TRANSPOSED) dst[d * BQ + r] = vals[i];
            else dst[r * HD + d] = vals[i];
        }
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
ring_hop_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ o, float* __restrict__ l, Strides st, int Sq, int Sk,
                    int H, float scale) {
    constexpr int NDG = HD / CG;  // output columns per thread
    extern __shared__ float smem[];
    float* qt = smem;              // [HD][BQ]
    float* kt = qt + HD * BQ;      // [HD][BK]
    float* vs = kt + HD * BK;      // [BK][HD]
    float* pt = vs + BK * HD;      // [BK][BQ]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int col = h * HD;
    const T* qb = q + (int64_t)b * st.qb;
    const T* kb = k + (int64_t)b * st.kb;
    const T* vb = v + (int64_t)b * st.vb;

    const int tid = threadIdx.x;
    const int rg = tid / CG;   // row group: rows rg*4 .. rg*4+3
    const int cg = tid % CG;   // column group

    load_tile<T, HD, true>(qb, qt, q0, Sq, st.qr, col);

    float lsum[RPT], acc[RPT][NDG];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        lsum[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NDG; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < Sk; k0 += BK) {
        __syncthreads();  // the previous tile's readers are done
        load_tile<T, HD, true>(kb, kt, k0, Sk, st.kr, col);
        load_tile<T, HD, false>(vb, vs, k0, Sk, st.vr, col);
        __syncthreads();

        // scores: u[i][j] = q[rg*4+i] . k[cg*8+j]
        float s[RPT][KPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            const float4 q4 = *reinterpret_cast<const float4*>(&qt[d * BQ + rg * RPT]);
            const float4 ka = *reinterpret_cast<const float4*>(&kt[d * BK + cg * KPT]);
            const float4 kc = *reinterpret_cast<const float4*>(&kt[d * BK + cg * KPT + 4]);
            const float qv[RPT] = {q4.x, q4.y, q4.z, q4.w};
            const float kv[KPT] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // p_u = exp(min(u * scale, 50)), 0 past the last key; row sums
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KPT; ++j) {
                const int key = k0 + cg * KPT + j;
                s[i][j] = key < Sk ? expf(fminf(s[i][j] * scale, CLAMP)) : 0.f;
                sum += s[i][j];
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            lsum[i] += sum;
        }
#pragma unroll
        for (int j = 0; j < KPT; ++j)
            *reinterpret_cast<float4*>(&pt[(cg * KPT + j) * BQ + rg * RPT]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncthreads();

        // acc[i][j] += sum_key p_u[rg*4+i][key] * v[key][cg + 8j]
        const int kmax = min(BK, Sk - k0);
#pragma unroll 2
        for (int key = 0; key < kmax; ++key) {
            const float4 p4 = *reinterpret_cast<const float4*>(&pt[key * BQ + rg * RPT]);
            const float pv[RPT] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int j = 0; j < NDG; ++j) {
                const float vv = vs[key * HD + cg + CG * j];
#pragma unroll
                for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + rg * RPT + i;
        if (row >= Sq) continue;
        float* dst = o + ((int64_t)b * Sq + row) * D + col + cg;
#pragma unroll
        for (int j = 0; j < NDG; ++j) dst[CG * j] = acc[i][j];
        if (cg == 0) l[((int64_t)b * Sq + row) * H + h] = lsum[i];
    }
}

constexpr size_t smem_bytes(int hd) {
    return sizeof(float) * (size_t)(3 * BQ * hd + BK * BQ);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, float* o, float* l,
                   const Strides& st, int B, int Sq, int Sk, int H, float scale,
                   cudaStream_t stream) {
    constexpr size_t smem = smem_bytes(HD);
    // above 48 KB a block's shared memory must be asked for; the attribute is
    // per device, so it is set on every call (a host-side store, no sync)
    cudaError_t err = cudaFuncSetAttribute(
        ring_hop_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    ring_hop_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, l, st,
        Sq, Sk, H, scale);
    return cudaGetLastError();
}

// ---- bf16: tensor cores ----------------------------------------------------

using attn_mma::bf16;

constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
ring_hop_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ l, Strides st, int Sq, int Sk, int H, float scale) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int NT = HD / 8;  // n8 tiles of the output
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // Q tile
    bf16* kv = qs + T;                                // two stages of (K tile, V tile)

    const int q0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int col = h * HD;
    const bf16* qb = q + (int64_t)b * st.qb;
    const bf16* kb = k + (int64_t)b * st.kb;
    const bf16* vb = v + (int64_t)b * st.vb;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // this thread's rows g, g + 8; columns 2t, 2t + 1

    zero_padding<HD>(qs, 5);
    load_tile_async<HD>(qs, qb, q0, Sq, st.qr, col);
    load_tile_async<HD>(kv, kb, 0, Sk, st.kr, col);
    load_tile_async<HD>(kv + T, vb, 0, Sk, st.vr, col);
    cp_async_commit();

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of rows g and g + 8

    const int ntiles = (Sk + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* kt = kv + (it % 2) * 2 * T;
        const bf16* vt = kt + T;
        if (it + 1 < ntiles) {
            // the other stage's readers finished before the last barrier
            bf16* nk = kv + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nk, kb, (it + 1) * ROWS, Sk, st.kr, col);
            load_tile_async<HD>(nk + T, vb, (it + 1) * ROWS, Sk, st.vr, col);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float p[8][4];
        mma_abt<HD>(p, qs + warp * 16 * pitch(HD), kt);
        // p_u = exp(min(s, 50)), clamped in the natural domain, rounded to
        // bf16 once: the row sums add the values that P V multiplies
        const int k0 = it * ROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool valid = k0 + 8 * j + 2 * t + (e % 2) < Sk;
                const float pu = exp2f(fminf(p[j][e] * scale, CLAMP) * LOG2E);
                p[j][e] = valid ? __bfloat162float(__float2bfloat16(pu)) : 0.f;
            }
            l0 += p[j][0] + p[j][1];
            l1 += p[j][2] + p[j][3];
        }
        mma_ab<HD>(acc, p, vt);
        __syncthreads();  // this stage is refilled next
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16;
    if (t == 0) {
        float* lb = l + (int64_t)b * Sq * H + h;
        if (r0 + g < Sq) lb[(int64_t)(r0 + g) * H] = l0;
        if (r0 + g + 8 < Sq) lb[(int64_t)(r0 + g + 8) * H] = l1;
    }
    // o_u straight from the fragments: each quad writes 32 contiguous bytes
    // of a row, whole sectors (hd * 4 bytes is a multiple of 32)
    float* ob = o + ((int64_t)b * Sq + r0) * D + col;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        if (r0 + g < Sq)
            *reinterpret_cast<float2*>(ob + (int64_t)g * D + 8 * j + 2 * t) =
                make_float2(acc[j][0], acc[j][1]);
        if (r0 + g + 8 < Sq)
            *reinterpret_cast<float2*>(ob + (int64_t)(g + 8) * D + 8 * j + 2 * t) =
                make_float2(acc[j][2], acc[j][3]);
    }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, float* o, float* l,
                        const Strides& st, int B, int Sq, int Sk, int H, float scale,
                        cudaStream_t stream) {
    // the Q tile and two stages of K and V tiles
    constexpr size_t smem = 5 * (size_t)attn_mma::tile_elems(HD) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(ring_hop_fwd_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + attn_mma::ROWS - 1) / attn_mma::ROWS, H, B);
    ring_hop_fwd_bf16_kernel<HD><<<grid, attn_mma::THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        o, l, st, Sq, Sk, H, scale);
    return cudaGetLastError();
}

// dtype 0: the fp32-core body on fp32; 1: the tensor-core body on bf16; 2:
// the fp32-core body on bf16
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, float* o, float* l,
                        const Strides& st, int B, int Sq, int Sk, int H, int hd, float scale,
                        int dtype, cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                                       \
    case N:                                                                                  \
        return dtype == 0   ? launch<float, N>(q, k, v, o, l, st, B, Sq, Sk, H, scale, stream) \
               : dtype == 1 ? launch_bf16<N>(q, k, v, o, l, st, B, Sq, Sk, H, scale, stream)   \
                            : launch<__nv_bfloat16, N>(q, k, v, o, l, st, B, Sq, Sk, H, scale, \
                                                       stream);
        FDT_HD_CASE(8) FDT_HD_CASE(16) FDT_HD_CASE(24) FDT_HD_CASE(32)
        FDT_HD_CASE(40) FDT_HD_CASE(48) FDT_HD_CASE(56) FDT_HD_CASE(64)
        FDT_HD_CASE(72) FDT_HD_CASE(80) FDT_HD_CASE(88) FDT_HD_CASE(96)
        FDT_HD_CASE(104) FDT_HD_CASE(112) FDT_HD_CASE(120) FDT_HD_CASE(128)
#undef FDT_HD_CASE
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (tensor cores), 2 = bfloat16 through the
// fp32-core body (a yardstick; the wrappers never pass it). q (B, Sq, H*hd)
// and k, v (B, Sk, H*hd) of that dtype, each with unit column stride and its
// own batch and row strides (elements), 16-byte aligned rows; o (B, Sq, H*hd)
// and l (B, Sq, H) are contiguous fp32. hd is a multiple of 8, at most 128.
int fdt_ring_hop_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                     long long q_bstride, long long q_rstride, long long k_bstride,
                     long long k_rstride, long long v_bstride, long long v_rstride, int B,
                     int Sq, int Sk, int H, int hd, float scale, int dtype, void* stream) {
    if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    const Strides st{(int64_t)q_bstride, (int64_t)q_rstride, (int64_t)k_bstride,
                     (int64_t)k_rstride, (int64_t)v_bstride, (int64_t)v_rstride};
    return (int)dispatch_hd(q, k, v, static_cast<float*>(o), static_cast<float*>(l), st, B, Sq,
                            Sk, H, hd, scale, dtype, static_cast<cudaStream_t>(stream));
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
