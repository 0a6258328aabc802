// Packed-qkv attention backward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces `fast_dit_tpu/ops/flash_attention.py::_bwd_kernel` (:185-252,
// launched through `pl.pallas_call` by `_backward`, :255-283).
//
// Computes, for every batch row b and head h, the exact gradients of
//     o = softmax(q k^T * scale) v
// with respect to q, k and v, given dO:
//     p = softmax(q k^T * scale)        (rebuilt from the forward's LSE)
//     dv = p^T dO,  dp = dO v^T,  delta = rowsum(dO * o) = rowsum(p * dp)
//     ds = p * (dp - delta) * scale,  dq = ds k,  dk = ds^T q
// reading the packed (B, S, 3D) qkv in place (q at column h*hd, k at D + h*hd,
// v at 2D + h*hd, row stride 3D) and writing dq, dk and dv straight into the
// same columns of one packed (B, S, 3D) dqkv, in the input dtype. Every
// product and sum is fp32 for both input dtypes.
//
// What bounds it on the H100. At the DiT-XL/2 training shape (B=32, S=256,
// H=16, hd=72, D=1152) one call does the five products, 10*B*S^2*D = 24.2
// GFLOP, and must move 8*B*S*D elements (read qkv, O and dO, write dqkv):
// 151 MB in bf16. Against the data sheet (3.35 TB/s, 989 TFLOP/s bf16 tensor
// cores, 67 TFLOP/s fp32 without them) the bf16 call is bound by bytes at
// ~45 us (its products alone take ~24 us) and the fp32 call by operations at
// ~361 us. This kernel computes on the fp32
// CUDA cores and recomputes the scores and dp in both of its passes (14
// products' worth of work, not 10), so it sits far above its bound in bf16:
// tensor cores (mma.sync, then wgmma with TMA) are later work.
//
// Design: two passes, no atomics, so the result is deterministic.
//  - The TPU kernel walks the query chunks of one batch row in order and
//    carries dk/dv in VMEM scratch. Hopper blocks run in no order, so the
//    sums are split by what they reduce over:
//    (1) the dq pass, one block per (64-query tile, head, batch row), loops
//        over the key tiles; it first forms delta = rowsum(dO * o) for its
//        rows from the saved forward output and writes it out;
//    (2) the dk/dv pass, one block per (64-key tile, head, batch row),
//        loops over the query tiles and reads the deltas of pass (1).
//    Both passes are one templated body: a fixed 64-row tile (A, C) held in
//    shared memory and 64-row tiles (B, E) of the other side streamed in turn:
//        dq pass:   A = q, C = dO, B = k, E = v;  x = A B^T = s, y = C E^T = dp
//        dk/dv:     A = k, C = v, B = q, E = dO;  x = s^T,      y = dp^T
//    and in both, ds = p * (y - delta) * scale and acc_B += ds B; the dk/dv
//    pass also sums acc_E += p E (dv = p^T dO).
//  - 256 threads. For the 64 x 64 score tiles each thread owns a 4 x 4
//    micro-tile; for the (64, hd) accumulators it owns 2 rows x hd/8 columns
//    (column cg + 8j), so the hd-wide sums stay in registers.
//  - Tiles sit in shared memory as fp32, transposed ([d][row]) with a row
//    pitch of 68 floats: the score loop reads float4s along rows, and the
//    accumulation loop reads a column d = cg + 8j from 8 banks apart.
//  - The ragged S edge: rows >= S load as zeros, p is forced to 0 for
//    streamed rows >= S (their LSE is not defined), and rows >= S of the
//    fixed tile are never stored.
//
// Documented deviation from the TPU kernel: its exact path casts p and ds to
// the input dtype before the products (`:217,221`); this kernel keeps them in
// fp32. Its bf16 path clamps the logits at 50 and folds 1/rowsum into dO and
// q (`:226-242`), a VPU workaround that is not ported: this kernel is the
// exact gradient of the exact softmax that `flash_attention_fwd.cu` computes.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// both passes on the given stream, allocates nothing (delta is scratch the
// caller passes), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;         // rows per tile, fixed and streamed
constexpr int PITCH = BR + 4;  // shared-memory row pitch of a transposed tile
constexpr int THREADS = 256;
constexpr int CG = 8;          // column groups of the (64, hd) accumulators

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Copy rows [row0, row0 + 64) of one head's HD columns, starting at column
// `col` of a row-major tensor with `row_stride` elements per row, into
// shared memory as fp32, transposed: dst[d * PITCH + r]. 16 bytes per global
// load; rows >= S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile_t(const T* __restrict__ src, float* dst,
                                            int64_t batch_base, int row0, int S,
                                            int64_t row_stride, int col) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int NVEC = HD / VEC;
    for (int c = threadIdx.x; c < BR * NVEC; c += THREADS) {
        const int r = c % BR;  // neighbouring threads take neighbouring rows
        const int v = c / BR;
        const int row = row0 + r;
        float vals[VEC];
        if (row < S) {
            const T* p = src + batch_base + (int64_t)row * row_stride + col + v * VEC;
            uint4 raw = *reinterpret_cast<const uint4*>(p);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < VEC; ++i) vals[i] = to_f32(e[i]);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[(v * VEC + i) * PITCH + r] = vals[i];
    }
}

// acc[i][j] = sum_d a[d][f0 + i] * b[d][l0 + j] over HD: a 4 x 4 micro-tile
// of a (64 x 64) product of two transposed tiles
template <int HD>
__device__ __forceinline__ void micro_tile(const float* a, const float* b, int f0, int l0,
                                           float acc[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
        const float4 a4 = *reinterpret_cast<const float4*>(&a[d * PITCH + f0]);
        const float4 b4 = *reinterpret_cast<const float4*>(&b[d * PITCH + l0]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// KV = false: the dq pass (fixed query tile, streamed key tiles);
// KV = true: the dk/dv pass (fixed key tile, streamed query tiles).
template <typename T, int HD, bool KV>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, T* __restrict__ dqkv, int S, int H,
                     float scale, float scale_log2) {
    constexpr int NDG = HD / CG;  // accumulator columns per thread
    extern __shared__ float smem[];
    float* at = smem;                 // fixed tile A, [HD][PITCH]
    float* ct = at + HD * PITCH;      // fixed tile C
    float* bt = ct + HD * PITCH;      // streamed tile B
    float* et = bt + HD * PITCH;      // streamed tile E
    float* ps = et + HD * PITCH;      // p,  [streamed row][fixed row]
    float* dss = ps + BR * PITCH;     // ds, [streamed row][fixed row]
    float* lse_s = dss + BR * PITCH;  // per query row of the tile that has them
    float* delta_s = lse_s + BR;

    const int f_row0 = blockIdx.x * BR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int64_t qkv_stride = 3 * (int64_t)D;
    const int64_t qkv_base = (int64_t)b * S * qkv_stride;
    const int64_t o_base = (int64_t)b * S * D;
    const int64_t stat_base = ((int64_t)b * H + h) * S;
    const int q_col = h * HD, k_col = D + h * HD, v_col = 2 * D + h * HD;

    const int tid = threadIdx.x;
    const int tf = tid / 16, tl = tid % 16;  // score micro-tile: rows tf*4.., tl*4..
    const int rg = tid / CG, cg = tid % CG;  // accumulator: rows rg*2.., cols cg + 8j

    if (KV) {
        load_tile_t<T, HD>(qkv, at, qkv_base, f_row0, S, qkv_stride, k_col);
        load_tile_t<T, HD>(qkv, ct, qkv_base, f_row0, S, qkv_stride, v_col);
    } else {
        load_tile_t<T, HD>(qkv, at, qkv_base, f_row0, S, qkv_stride, q_col);
        load_tile_t<T, HD>(dout, ct, o_base, f_row0, S, D, h * HD);
        // delta = rowsum(dO * o) for this tile's query rows, o staged in bt
        load_tile_t<T, HD>(out, bt, o_base, f_row0, S, D, h * HD);
        __syncthreads();
        if (tid < BR) {
            const int row = f_row0 + tid;
            float sum = 0.f;
            for (int d = 0; d < HD; ++d) sum = fmaf(ct[d * PITCH + tid], bt[d * PITCH + tid], sum);
            delta_s[tid] = row < S ? sum : 0.f;
            lse_s[tid] = row < S ? lse[stat_base + row] : 0.f;
            if (row < S) delta[stat_base + row] = sum;
        }
    }

    float acc_b[2][NDG], acc_e[2][NDG];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NDG; ++j) acc_b[i][j] = acc_e[i][j] = 0.f;

    for (int l_row0 = 0; l_row0 < S; l_row0 += BR) {
        __syncthreads();  // the previous tile's readers are done
        if (KV) {
            load_tile_t<T, HD>(qkv, bt, qkv_base, l_row0, S, qkv_stride, q_col);
            load_tile_t<T, HD>(dout, et, o_base, l_row0, S, D, h * HD);
            if (tid < BR) {
                const int row = l_row0 + tid;
                lse_s[tid] = row < S ? lse[stat_base + row] : 0.f;
                delta_s[tid] = row < S ? delta[stat_base + row] : 0.f;
            }
        } else {
            load_tile_t<T, HD>(qkv, bt, qkv_base, l_row0, S, qkv_stride, k_col);
            load_tile_t<T, HD>(qkv, et, qkv_base, l_row0, S, qkv_stride, v_col);
        }
        __syncthreads();

        // x = A B^T (scores), y = C E^T (dp), 4 x 4 per thread
        float x[4][4], y[4][4];
        micro_tile<HD>(at, bt, tf * 4, tl * 4, x);
        micro_tile<HD>(ct, et, tf * 4, tl * 4, y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int fi = tf * 4 + i, lj = tl * 4 + j;
                const int q = KV ? lj : fi;  // the query row of this entry
                const bool valid = l_row0 + lj < S;
                const float p = valid ? exp2f(x[i][j] * scale_log2 - lse_s[q]) : 0.f;
                x[i][j] = p;
                y[i][j] = p * (y[i][j] - delta_s[q]) * scale;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int lj = tl * 4 + j;
            *reinterpret_cast<float4*>(&ps[lj * PITCH + tf * 4]) =
                make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
            *reinterpret_cast<float4*>(&dss[lj * PITCH + tf * 4]) =
                make_float4(y[0][j], y[1][j], y[2][j], y[3][j]);
        }
        __syncthreads();

        // acc_b[f][c] += sum_l ds[f][l] B[l][c];  KV: acc_e[f][c] += sum_l p[f][l] E[l][c]
        const int lmax = min(BR, S - l_row0);
#pragma unroll 2
        for (int l = 0; l < lmax; ++l) {
            const float2 ds2 = *reinterpret_cast<const float2*>(&dss[l * PITCH + rg * 2]);
#pragma unroll
            for (int j = 0; j < NDG; ++j) {
                const float bv = bt[(cg + CG * j) * PITCH + l];
                acc_b[0][j] = fmaf(ds2.x, bv, acc_b[0][j]);
                acc_b[1][j] = fmaf(ds2.y, bv, acc_b[1][j]);
            }
            if (KV) {
                const float2 p2 = *reinterpret_cast<const float2*>(&ps[l * PITCH + rg * 2]);
#pragma unroll
                for (int j = 0; j < NDG; ++j) {
                    const float ev = et[(cg + CG * j) * PITCH + l];
                    acc_e[0][j] = fmaf(p2.x, ev, acc_e[0][j]);
                    acc_e[1][j] = fmaf(p2.y, ev, acc_e[1][j]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = f_row0 + rg * 2 + i;
        if (row >= S) continue;
        T* dst = dqkv + qkv_base + (int64_t)row * qkv_stride + cg;
#pragma unroll
        for (int j = 0; j < NDG; ++j) {
            if (KV) {
                dst[k_col + CG * j] = from_f32<T>(acc_b[i][j]);
                dst[v_col + CG * j] = from_f32<T>(acc_e[i][j]);
            } else {
                dst[q_col + CG * j] = from_f32<T>(acc_b[i][j]);
            }
        }
    }
}

constexpr size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)4 * hd * PITCH + 2 * BR * PITCH + 2 * BR);
}

template <typename T, int HD, bool KV>
cudaError_t launch_pass(const void* qkv, const void* out, const void* dout, const float* lse,
                        float* delta, void* dqkv, int B, int S, int H, float scale,
                        cudaStream_t stream) {
    constexpr size_t smem = smem_bytes(HD);
    // above 48 KB a block's shared memory must be asked for; the attribute is
    // per device, so it is set on every call (a host-side store, no sync)
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, HD, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BR - 1) / BR, H, B);
    attention_bwd_kernel<T, HD, KV><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(out), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dqkv), S, H, scale, scale * 1.4426950408889634f);
    return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* out, const void* dout, const float* lse,
                   float* delta, void* dqkv, int B, int S, int H, float scale,
                   cudaStream_t stream) {
    // the dq pass writes the deltas the dk/dv pass reads: same stream, in order
    cudaError_t err = launch_pass<T, HD, false>(qkv, out, dout, lse, delta, dqkv, B, S, H,
                                                scale, stream);
    if (err != cudaSuccess) return err;
    return launch_pass<T, HD, true>(qkv, out, dout, lse, delta, dqkv, B, S, H, scale, stream);
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const void* out, const void* dout, const float* lse,
                        float* delta, void* dqkv, int B, int S, int H, int hd, float scale,
                        cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N) \
    case N: return launch<T, N>(qkv, out, dout, lse, delta, dqkv, B, S, H, scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16. qkv and dqkv (B, S, 3*H*hd), out and
// dout (B, S, H*hd) are contiguous, 16-byte aligned, of that dtype; lse (the
// forward's log2-domain log-sum-exp) and delta (scratch) are fp32 (B, H, S).
// hd is a multiple of 8, at most 128. Every element of dqkv is written.
int fdt_attention_bwd(const void* qkv, const void* out, const void* dout, const void* lse,
                      void* delta, void* dqkv, int B, int S, int H, int hd, float scale,
                      int dtype, void* stream) {
    if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    float* dl = static_cast<float*>(delta);
    if (dtype == 0)
        return (int)dispatch_hd<float>(qkv, out, dout, l, dl, dqkv, B, S, H, hd, scale, st);
    if (dtype == 1)
        return (int)dispatch_hd<__nv_bfloat16>(qkv, out, dout, l, dl, dqkv, B, S, H, hd, scale,
                                               st);
    return (int)cudaErrorInvalidValue;
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
