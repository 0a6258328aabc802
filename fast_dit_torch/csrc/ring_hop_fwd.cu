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
// at most exp(50) ~ 5e21, far inside fp32, so the partials of the hops of a
// ring add with no rescaling, and the ring divides once at the end. q, k and
// v may be column views of the packed (B, S, 3D) projection: each comes with
// its own batch and row stride (elements); o_u and l are contiguous.
//
// What bounds it on the H100. At the sequence-parallel DiT-XL/2 512² shape
// (B = 4 shards x batch 4 = 16, Sq = Sk = 256, H = 16, hd = 72, D = 1152)
// one call does 4*B*Sq*Sk*D = 4.83 GFLOP and must read q, k, v (9.4 MB each
// in bf16) and write o_u (18.9 MB fp32) and l: 47.3 MB. Against the data
// sheet (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s fp32 without
// them) the bf16 call is bound by bytes at ~14 us and the fp32 call by
// operations at ~72 us. This kernel computes on the fp32 CUDA cores (no mma),
// so in bf16 it sits far above its bound: tensor cores are later work.
//
// Design: the block structure of `flash_attention_fwd.cu` without its online
// softmax.
//  - One 128-thread block per (64-query tile, head, batch row). The TPU
//    kernel's grid over batch rows with an unrolled head loop and a
//    sequential q-chunk loop becomes independent blocks; nothing carries
//    between them.
//  - The Q tile (64 x hd) is staged once in shared memory, K and V tiles of
//    64 keys in turn, all converted to fp32; Q and K transposed ([d][row])
//    so the score loop reads float4s without bank conflicts.
//  - Each thread owns a 4-row x 8-key micro-tile of the scores and, in the
//    P.V product, the same 4 rows x hd/8 output columns (column cg + 8j).
//    The row sums are three xor-shuffles over the 8 neighbouring lanes that
//    share a row group.
//  - exp is `expf` of the clamped fp32 logit, as the plain version computes
//    it; p_u stays fp32 into the product with v.
//  - The ragged edges are masked: keys >= Sk give p_u = 0, query rows >= Sq
//    are loaded as zeros and never stored.
//
// Documented deviation from the TPU kernel: it casts p_u to the input dtype
// before the products with v and with the ones matrix that forms l
// (:99-102); this kernel keeps p_u in fp32.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, float* o, float* l,
                        const Strides& st, int B, int Sq, int Sk, int H, int hd, float scale,
                        cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N) \
    case N: return launch<T, N>(q, k, v, o, l, st, B, Sq, Sk, H, scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16. q (B, Sq, H*hd) and k, v (B, Sk, H*hd)
// of that dtype, each with unit column stride and its own batch and row
// strides (elements), 16-byte aligned rows; o (B, Sq, H*hd) and l (B, Sq, H)
// are contiguous fp32. hd is a multiple of 8, at most 128.
int fdt_ring_hop_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                     long long q_bstride, long long q_rstride, long long k_bstride,
                     long long k_rstride, long long v_bstride, long long v_rstride, int B,
                     int Sq, int Sk, int H, int hd, float scale, int dtype, void* stream) {
    if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    const Strides st{(int64_t)q_bstride, (int64_t)q_rstride, (int64_t)k_bstride,
                     (int64_t)k_rstride, (int64_t)v_bstride, (int64_t)v_rstride};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* of = static_cast<float*>(o);
    float* lf = static_cast<float*>(l);
    if (dtype == 0)
        return (int)dispatch_hd<float>(q, k, v, of, lf, st, B, Sq, Sk, H, hd, scale, s);
    if (dtype == 1)
        return (int)dispatch_hd<__nv_bfloat16>(q, k, v, of, lf, st, B, Sq, Sk, H, hd, scale, s);
    return (int)cudaErrorInvalidValue;
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
