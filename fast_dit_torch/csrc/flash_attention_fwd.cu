// Packed-qkv attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces `fast_dit_tpu/ops/flash_attention.py::_fwd_kernel` (:119-153,
// launched through `pl.pallas_call` by `_forward`, :156-177).
//
// Computes, for every batch row b and head h,
//     o[b, s, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h
// reading the packed (B, S, 3D) projection output in place: q at column
// h*hd, k at D + h*hd, v at 2D + h*hd, row stride 3D. Writes (B, S, D) in
// the input dtype. Softmax and accumulation are fp32 for both input dtypes.
//
// What bounds it on the H100. At the DiT-XL/2 sampling shape (B=16, S=256,
// H=16, hd=72, D=1152) one call does 4*B*S^2*D = 4.83 GFLOP and must move
// 4*B*S*D elements (read 3D, write D per token): 37.7 MB in bf16, 75.5 MB in
// fp32. Against the data sheet (3.35 TB/s, 989 TFLOP/s bf16 tensor cores,
// 67 TFLOP/s fp32 without them) the bf16 call is bound by bytes at 11.3 us
// (its products alone take 4.9 us) and the fp32 call by operations at 72 us.
// At the training shape (B=32) both double.
//
// bf16 (dtype 1, every call of the main paths): tensor cores.
//  - One 128-thread block (4 warps) per (64-query tile, head, batch row);
//    each warp owns 16 query rows. The block streams 64-key tiles of K and
//    V through a two-stage ring in shared memory, filled with 16-byte
//    cp.async (rows >= S zero-filled), so the next tile loads while the
//    current one multiplies. Tiles stay bf16, hd padded with zero columns to
//    a multiple of 16 (72 -> 80) in shared memory only, row pitch 88
//    elements (no ldmatrix bank conflicts); see `attn_mma_bf16.cuh`.
//  - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with fp32
//    accumulation, operands through ldmatrix (V through ldmatrix.trans).
//  - FlashAttention-2's online softmax in registers, log2 domain: each
//    thread holds two rows of the 16 x 64 score tile; the row max takes two
//    xor-shuffles across the four threads of a quad, the row sum is kept per
//    thread and reduced once at the end. p is rounded to bf16 into the A
//    fragment of P V in registers, as the TPU kernel's exact path rounds it
//    (`p.astype(v.dtype)`, :141); it never goes through shared memory.
//    l sums the fp32 p, and the output is divided by l once, in fp32.
//  - Keys >= S score -inf; query rows >= S are never stored. The output
//    goes through shared memory to 16-byte stores.
//  Why mma.sync and not wgmma + TMA: at these shapes the bound is bytes,
//  not the tensor-core rate (11.3 us of bytes against 4.9 us of products at
//  B=16), and mma.sync's rate on Hopper puts the products at a few us per
//  call. A 144-byte head row does not fit the 128-byte swizzle atom that a
//  single TMA box and wgmma's shared-memory descriptors want; wgmma with a
//  32-byte swizzle over hd padded to 80 is later work.
//
// fp32 (dtype 0): the fp32-core body below (`attention_fwd_kernel<float>`),
// which holds the 1e-5 limit against the plain version (TF32 or bf16
// products would not).
//  - One thread block of 128 threads per (64-query tile, head, batch row).
//    The TPU kernel's sequential grid over heads and 256-row q chunks inside
//    one batch row becomes independent blocks; nothing carries between them.
//  - The block's Q tile (64 x hd) is staged once in shared memory; K and V
//    tiles of 64 keys are staged in turn. Q and K are stored transposed
//    ([d][row]) so the score loop reads float4s without bank conflicts.
//  - Each thread owns a 4-row x 8-key micro-tile of the scores and, in the
//    P.V product, the same 4 rows x hd/8 output columns (column cg + 8j).
//    The 8 threads sharing a row group are neighbouring lanes, so row max
//    and row sum are three xor-shuffles.
//  - Exact online softmax: running max m and running sum l per row, in the
//    log2 domain (scores pre-multiplied by scale*log2(e), exp2f). The
//    probabilities never leave shared memory.
//  - The ragged S edge is masked: keys >= S score -inf, query rows >= S are
//    loaded as zeros and never stored.
//
// Documented deviation from the TPU kernel: its bf16 path clamps logits at
// 50 and skips the row max (`_CLAMP`, `_unnormalized_softmax`, :102-111) to
// avoid cross-lane VPU reductions. That trick is not ported: both bodies
// compute the exact softmax, with the row max; the bf16 one rounds p as the
// TPU's exact path does.
//
// For training, the kernel also writes each row's log-sum-exp in the log2
// domain (lse2 = m + log2(l), with the scores already in scale*log2(e)
// units), fp32 (B, H, S), when given a pointer for it. The backward kernel
// (`flash_attention_bwd.cu`) rebuilds p = exp2(s * scale_log2 - lse2) from
// it; sampling passes a null pointer and writes nothing more.
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

// the fp32-core body below is instantiated for float only
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Copy rows [row0, row0 + 64) of one head's hd columns (starting at column
// `col` of the packed tensor) into shared memory as fp32, 16 bytes per
// global load. Rows >= S are zero. TRANSPOSED stores dst[d * 64 + r], else
// dst[r * HD + d].
template <typename T, int HD, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(const T* __restrict__ qkv, float* dst,
                                          int64_t batch_base, int row0, int S,
                                          int64_t row_stride, int col) {
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
            const T* src = qkv + batch_base + (int64_t)row * row_stride + col + v * VEC;
            uint4 raw = *reinterpret_cast<const uint4*>(src);
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
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale_log2) {
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
    const int64_t row_stride = 3 * (int64_t)D;
    const int64_t batch_base = (int64_t)b * S * row_stride;

    const int tid = threadIdx.x;
    const int rg = tid / CG;   // row group: rows rg*4 .. rg*4+3
    const int cg = tid % CG;   // column group

    load_tile<T, HD, true>(qkv, qt, batch_base, q0, S, row_stride, h * HD);

    float m[RPT], l[RPT], acc[RPT][NDG];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NDG; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < S; k0 += BK) {
        __syncthreads();  // the previous tile's readers are done
        load_tile<T, HD, true>(qkv, kt, batch_base, k0, S, row_stride, D + h * HD);
        load_tile<T, HD, false>(qkv, vs, batch_base, k0, S, row_stride, 2 * D + h * HD);
        __syncthreads();

        // scores: s[i][j] = q[rg*4+i] . k[cg*8+j]
        float s[RPT][KPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            const float4 q4 = *reinterpret_cast<const float4*>(&qt[d * BQ + rg * RPT]);
            const float4 ka = *reinterpret_cast<const float4*>(&kt[d * BK + cg * KPT]);
            const float4 kb = *reinterpret_cast<const float4*>(&kt[d * BK + cg * KPT + 4]);
            const float qv[RPT] = {q4.x, q4.y, q4.z, q4.w};
            const float kv[KPT] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // online softmax over this tile, in the log2 domain
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < KPT; ++j) {
                const int key = k0 + cg * KPT + j;
                s[i][j] = key < S ? s[i][j] * scale_log2 : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            // every tile holds at least one valid key, so m_new is finite
            const float m_new = fmaxf(m[i], mx);
            const float alpha = exp2f(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KPT; ++j) {
                s[i][j] = exp2f(s[i][j] - m_new);
                sum += s[i][j];
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NDG; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < KPT; ++j)
            *reinterpret_cast<float4*>(&pt[(cg * KPT + j) * BQ + rg * RPT]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncthreads();

        // acc[i][j] += sum_key p[rg*4+i][key] * v[key][cg + 8j]
        const int kmax = min(BK, S - k0);
#pragma unroll 2
        for (int key = 0; key < kmax; ++key) {
            const float4 p4 = *reinterpret_cast<const float4*>(&pt[key * BQ + rg * RPT]);
            const float pv[RPT] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int j = 0; j < NDG; ++j) {
                const float v = vs[key * HD + cg + CG * j];
#pragma unroll
                for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], v, acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + rg * RPT + i;
        if (row >= S) continue;
        const float inv = 1.f / l[i];
        T* dst = out + ((int64_t)b * S + row) * D + h * HD + cg;
#pragma unroll
        for (int j = 0; j < NDG; ++j) dst[CG * j] = from_f32<T>(acc[i][j] * inv);
        if (lse != nullptr && cg == 0) lse[((int64_t)b * H + h) * S + row] = m[i] + log2f(l[i]);
    }
}

constexpr size_t smem_bytes(int hd) {
    return sizeof(float) * (size_t)(3 * BQ * hd + BK * BQ);
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, void* out, float* lse, int B, int S, int H,
                   float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes(HD);
    // above 48 KB a block's shared memory must be asked for; the attribute is
    // per device, so it is set on every call (a host-side store, no sync)
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    const float scale_log2 = scale * 1.4426950408889634f;
    attention_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), lse, S, H, scale_log2);
    return cudaGetLastError();
}

// ---- bf16: tensor cores ----------------------------------------------------

using attn_mma::bf16;

template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
attention_fwd_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                          float* __restrict__ lse, int S, int H, float scale_log2) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int NT = HD / 8;  // n8 tiles of the output
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // Q tile, then the output tile
    bf16* kv = qs + T;                                // two stages of (K tile, V tile)

    const int q0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int64_t rs = 3 * (int64_t)D;
    const bf16* base = qkv + (int64_t)b * S * rs;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // this thread's rows g, g + 8; columns 2t, 2t + 1

    zero_padding<HD>(qs, 5);
    load_tile_async<HD>(qs, base, q0, S, rs, h * HD);
    load_tile_async<HD>(kv, base, 0, S, rs, D + h * HD);
    load_tile_async<HD>(kv + T, base, 0, S, rs, 2 * D + h * HD);
    cp_async_commit();

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    const int ntiles = (S + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* kt = kv + (it % 2) * 2 * T;
        const bf16* vt = kt + T;
        if (it + 1 < ntiles) {
            // the other stage's readers finished before the last barrier
            bf16* nk = kv + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nk, base, (it + 1) * ROWS, S, rs, D + h * HD);
            load_tile_async<HD>(nk + T, base, (it + 1) * ROWS, S, rs, 2 * D + h * HD);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float s[8][4];
        mma_abt<HD>(s, qs + warp * 16 * pitch(HD), kt);

        // online softmax over this tile, log2 domain; every tile holds a key < S,
        // so the running max is finite after the first
        const int k0 = it * ROWS;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool valid = k0 + 8 * j + 2 * t + e < S;
                s[j][e] = valid ? s[j][e] * scale_log2 : -INFINITY;
                s[j][2 + e] = valid ? s[j][2 + e] * scale_log2 : -INFINITY;
                mx0 = fmaxf(mx0, s[j][e]);
                mx1 = fmaxf(mx1, s[j][2 + e]);
            }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
        m0 = n0;
        m1 = n1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                s[j][e] = exp2f(s[j][e] - n0);
                s[j][2 + e] = exp2f(s[j][2 + e] - n1);
                sum0 += s[j][e];
                sum1 += s[j][2 + e];
            }
        }
        // l is this thread's share of the row sum; the quad adds up at the end
        l0 = l0 * a0 + sum0;
        l1 = l1 * a1 + sum1;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            acc[j][0] *= a0;
            acc[j][1] *= a0;
            acc[j][2] *= a1;
            acc[j][3] *= a1;
        }
        mma_ab<HD>(acc, s, vt);
        __syncthreads();  // this stage is refilled next
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // the warp's own rows of the Q tile were read by this warp only
    acc_to_tile<HD>(acc, qs, warp * 16, 1.f / l0, 1.f / l1);
    if (lse != nullptr && t == 0) {
        const int row = q0 + warp * 16 + g;
        float* dst = lse + ((int64_t)b * H + h) * S;
        if (row < S) dst[row] = m0 + log2f(l0);
        if (row + 8 < S) dst[row + 8] = m1 + log2f(l1);
    }
    __syncthreads();
    store_tile<HD>(qs, out + (int64_t)b * S * D, q0, S, D, h * HD);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, float* lse, int B, int S, int H,
                        float scale, cudaStream_t stream) {
    // the Q tile and two stages of K and V tiles
    constexpr size_t smem = 5 * (size_t)attn_mma::tile_elems(HD) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + attn_mma::ROWS - 1) / attn_mma::ROWS, H, B);
    attention_fwd_bf16_kernel<HD><<<grid, attn_mma::THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), lse, S, H,
        scale * 1.4426950408889634f);
    return cudaGetLastError();
}

// dtype 0: the fp32-core body; dtype 1: the tensor-core body
cudaError_t dispatch_hd(const void* qkv, void* out, float* lse, int B, int S, int H, int hd,
                        float scale, int dtype, cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                           \
    case N:                                                                      \
        return dtype == 0 ? launch<float, N>(qkv, out, lse, B, S, H, scale, stream) \
                          : launch_bf16<N>(qkv, out, lse, B, S, H, scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16. qkv (B, S, 3*H*hd) and out (B, S, H*hd)
// are contiguous and 16-byte aligned; hd is a multiple of 8, at most 128.
// lse is null, or fp32 (B, H, S).
int fdt_attention_fwd(const void* qkv, void* out, void* lse, int B, int S, int H, int hd,
                      float scale, int dtype, void* stream) {
    if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_hd(qkv, out, l, B, S, H, hd, scale, dtype, st);
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
