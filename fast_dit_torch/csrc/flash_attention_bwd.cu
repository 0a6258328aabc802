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
// same columns of one packed (B, S, 3D) dqkv, in the input dtype.
//
// What bounds it on the H100. At the DiT-XL/2 training shape (B=32, S=256,
// H=16, hd=72, D=1152) one call does the five products, 10*B*S^2*D = 24.2
// GFLOP, and must move 8*B*S*D elements (read qkv, O and dO, write dqkv):
// 151 MB in bf16. Against the data sheet (3.35 TB/s, 989 TFLOP/s bf16 tensor
// cores, 67 TFLOP/s fp32 without them) the bf16 call is bound by bytes at
// 45 us (its products alone take 24 us) and the fp32 call by operations at
// 361 us.
//
// Two passes, no atomics, so the result is deterministic. The TPU kernel
// walks the query chunks of one batch row in order and carries dk/dv in VMEM
// scratch; Hopper blocks run in no order, so the sums are split by what they
// reduce over:
//  (1) the dq pass, one block per (64-query tile, head, batch row), loops
//      over the key tiles; it first forms delta = rowsum(dO * o) in fp32 for
//      its rows from the saved forward output and writes it out;
//  (2) the dk/dv pass, one block per (64-key tile, head, batch row), loops
//      over the query tiles and reads the deltas of pass (1).
// Both recompute the scores and dp (14 products' worth of work, not 10).
//
// bf16 (dtype 1, every call of the main path): tensor cores, with the tile
// code of `attn_mma_bf16.cuh` (bf16 tiles in shared memory, hd padded with
// zero columns to a multiple of 16 in shared memory only, a bank-conflict-
// free pitch, 16-byte cp.async copies with rows >= S zero-filled, ldmatrix,
// mma.sync m16n8k16 with fp32 accumulation). 128 threads; each warp owns 16
// rows of the fixed tile, whose accumulators (hd/8 n8 tiles each) stay in
// registers; the streamed tiles go through a two-stage ring, so the next
// tile loads while the current one multiplies.
//  - dq pass: S = Q K^T and dP = dO V^T (16 x 64 per warp), p = exp2(s *
//    scale*log2(e) - lse2), ds = p (dp - delta) scale, rounded to bf16 into
//    the A fragment of dQ += dS K (K through ldmatrix.trans).
//  - dk/dv pass: the transposed tiles S^T = K Q^T and dP^T = V dO^T, so that
//    P^T and dS^T are already, in registers, the A operands of dV += P^T dO
//    and dK += dS^T Q (dO and Q through ldmatrix.trans). The streamed rows'
//    LSE and delta go through shared memory beside their tiles.
//  - p and ds are rounded to bf16 before their products, as the TPU
//    kernel's exact path does (`:217,221`); every sum is fp32.
//  Why mma.sync and not wgmma + TMA: the bound is bytes (45 us against 24 us
//  of products at B=32), mma.sync's rate puts the products at a few us, and
//  a 144-byte head row does not fit the 128-byte swizzle atom of a single
//  TMA box and wgmma's shared-memory descriptors.
//
// fp32 (dtype 0): the fp32-core body below (`attention_bwd_kernel<float>`),
// which holds the 1e-5 limit against the plain version. Both passes are one
// templated body: a fixed 64-row tile (A, C) held in shared memory and
// 64-row tiles (B, E) of the other side streamed in turn:
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
//
// The ragged S edge, in both bodies: rows >= S load as zeros, p is forced to
// 0 for streamed rows >= S (their LSE is not defined), and rows >= S of the
// fixed tile are never stored.
//
// Documented deviation from the TPU kernel: the fp32 body keeps p and ds in
// fp32 (the TPU's exact path casts them to the input dtype, a no-op in
// fp32). The TPU's bf16 path clamps the logits at 50 and folds 1/rowsum into
// dO and q (`:226-242`), a VPU workaround that is not ported: both bodies
// are the exact gradient of the exact softmax that `flash_attention_fwd.cu`
// computes.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// both passes on the given stream, allocates nothing (delta is scratch the
// caller passes), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma_bf16.cuh"

namespace {

constexpr int BR = 64;         // rows per tile, fixed and streamed
constexpr int PITCH = BR + 4;  // shared-memory row pitch of a transposed tile
constexpr int THREADS = 256;
constexpr int CG = 8;          // column groups of the (64, hd) accumulators

// the fp32-core body below is instantiated for float only
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---- bf16: tensor cores ----------------------------------------------------

using attn_mma::bf16;

// The dq pass: one block per (64-query tile, head, batch row).
template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dqkv, int S, int H,
                             float scale, float scale_log2) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int P = pitch(HD);
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // Q tile, then the dq tile
    bf16* dos = qs + T;                               // dO tile
    bf16* kv = dos + T;                               // two stages of (K tile, V tile)
    float* lse_s = reinterpret_cast<float*>(kv + 4 * T);
    float* delta_s = lse_s + ROWS;

    const int q0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int64_t rs = 3 * (int64_t)D;
    const bf16* base = qkv + (int64_t)b * S * rs;
    const int64_t o_base = (int64_t)b * S * D;
    const int64_t stat_base = ((int64_t)b * H + h) * S;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;

    zero_padding<HD>(qs, 6);
    load_tile_async<HD>(qs, base, q0, S, rs, h * HD);
    load_tile_async<HD>(dos, dout + o_base, q0, S, D, h * HD);
    load_tile_async<HD>(kv, base, 0, S, rs, D + h * HD);
    load_tile_async<HD>(kv + T, base, 0, S, rs, 2 * D + h * HD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // delta = rowsum(dO * o) in fp32 for this tile's rows, two threads per row
    {
        const int r = threadIdx.x / 2, half = threadIdx.x % 2;
        const int row = q0 + r;
        float sum = 0.f;
        if (row < S) {
            const bf16* o_row = out + o_base + (int64_t)row * D + h * HD;
            for (int ch = half; ch < HD / 8; ch += 2) {
                const uint4 ov = *reinterpret_cast<const uint4*>(o_row + ch * 8);
                const uint4 dv = *reinterpret_cast<const uint4*>(dos + r * P + ch * 8);
                const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
                const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
                    sum = fmaf(of.x, df.x, sum);
                    sum = fmaf(of.y, df.y, sum);
                }
            }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (half == 0) {
            delta_s[r] = sum;
            lse_s[r] = row < S ? lse[stat_base + row] : 0.f;
            if (row < S) delta[stat_base + row] = sum;
        }
    }
    __syncthreads();
    const int r0 = warp * 16 + g;
    const float lse0 = lse_s[r0], lse1 = lse_s[r0 + 8];
    const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];

    float dq[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

    const int ntiles = (S + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* kt = kv + (it % 2) * 2 * T;
        const bf16* vt = kt + T;
        if (it + 1 < ntiles) {
            bf16* nk = kv + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nk, base, (it + 1) * ROWS, S, rs, D + h * HD);
            load_tile_async<HD>(nk + T, base, (it + 1) * ROWS, S, rs, 2 * D + h * HD);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float s[8][4], dp[8][4];
        mma_abt<HD>(s, qs + warp * 16 * P, kt);
        mma_abt<HD>(dp, dos + warp * 16 * P, vt);
        const int k0 = it * ROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool valid = k0 + 8 * j + 2 * t + e < S;
                const float p0 = valid ? exp2f(s[j][e] * scale_log2 - lse0) : 0.f;
                const float p1 = valid ? exp2f(s[j][2 + e] * scale_log2 - lse1) : 0.f;
                dp[j][e] = p0 * (dp[j][e] - dl0) * scale;
                dp[j][2 + e] = p1 * (dp[j][2 + e] - dl1) * scale;
            }
        }
        mma_ab<HD>(dq, dp, kt);  // dq += ds k, ds rounded to bf16
        __syncthreads();         // this stage is refilled next
    }

    // the warp's own rows of the Q tile were read by this warp only
    acc_to_tile<HD>(dq, qs, warp * 16, 1.f, 1.f);
    __syncthreads();
    store_tile<HD>(qs, dqkv + (int64_t)b * S * rs, q0, S, rs, h * HD);
}

// The dk/dv pass: one block per (64-key tile, head, batch row).
template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dqkv, int S, int H, float scale,
                              float scale_log2) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int P = pitch(HD);
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* ks = reinterpret_cast<bf16*>(smem_bf16);  // K tile, then the dk tile
    bf16* vs = ks + T;                                // V tile, then the dv tile
    bf16* qd = vs + T;                                // two stages of (Q tile, dO tile)
    float* stats = reinterpret_cast<float*>(qd + 4 * T);  // two stages of (lse, delta)

    const int k0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int64_t rs = 3 * (int64_t)D;
    const bf16* base = qkv + (int64_t)b * S * rs;
    const bf16* do_base = dout + (int64_t)b * S * D;
    const int64_t stat_base = ((int64_t)b * H + h) * S;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;

    // the streamed query rows' LSE and delta, 0 past S (their p is forced to 0)
    auto load_stats = [&](float* dst, int row0) {
        const int i = threadIdx.x % ROWS, row = row0 + i;
        const float* src = threadIdx.x < ROWS ? lse : delta;
        dst[threadIdx.x] = row < S ? src[stat_base + row] : 0.f;
    };

    zero_padding<HD>(ks, 6);
    load_tile_async<HD>(ks, base, k0, S, rs, D + h * HD);
    load_tile_async<HD>(vs, base, k0, S, rs, 2 * D + h * HD);
    load_tile_async<HD>(qd, base, 0, S, rs, h * HD);
    load_tile_async<HD>(qd + T, do_base, 0, S, D, h * HD);
    cp_async_commit();
    load_stats(stats, 0);

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
        dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

    const int ntiles = (S + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* qt = qd + (it % 2) * 2 * T;
        const bf16* dot = qt + T;
        const float* lse_t = stats + (it % 2) * 2 * ROWS;
        const float* delta_t = lse_t + ROWS;
        if (it + 1 < ntiles) {
            bf16* nq = qd + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nq, base, (it + 1) * ROWS, S, rs, h * HD);
            load_tile_async<HD>(nq + T, do_base, (it + 1) * ROWS, S, D, h * HD);
            cp_async_commit();
            load_stats(stats + ((it + 1) % 2) * 2 * ROWS, (it + 1) * ROWS);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // p^T (16 keys x 64 queries per warp) from S^T = K Q^T
        float p[8][4];
        mma_abt<HD>(p, ks + warp * 16 * P, qt);
        const int q0 = it * ROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int qi = 8 * j + 2 * t + e;
                const bool valid = q0 + qi < S;
                const float l = lse_t[qi];
                p[j][e] = valid ? exp2f(p[j][e] * scale_log2 - l) : 0.f;
                p[j][2 + e] = valid ? exp2f(p[j][2 + e] * scale_log2 - l) : 0.f;
            }
        }
        mma_ab<HD>(dv, p, dot);  // dv += p^T dO, p rounded to bf16

        // ds^T from dP^T = V dO^T
        float ds[8][4];
        mma_abt<HD>(ds, vs + warp * 16 * P, dot);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float dl = delta_t[8 * j + 2 * t + e];
                ds[j][e] = p[j][e] * (ds[j][e] - dl) * scale;
                ds[j][2 + e] = p[j][2 + e] * (ds[j][2 + e] - dl) * scale;
            }
        }
        mma_ab<HD>(dk, ds, qt);  // dk += ds^T q, ds rounded to bf16
        __syncthreads();         // this stage is refilled next
    }

    // the warp's own rows of the K and V tiles were read by this warp only
    acc_to_tile<HD>(dk, ks, warp * 16, 1.f, 1.f);
    acc_to_tile<HD>(dv, vs, warp * 16, 1.f, 1.f);
    __syncthreads();
    bf16* dst = dqkv + (int64_t)b * S * rs;
    store_tile<HD>(ks, dst, k0, S, rs, D + h * HD);
    store_tile<HD>(vs, dst, k0, S, rs, 2 * D + h * HD);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, const void* out, const void* dout, const float* lse,
                        float* delta, void* dqkv, int B, int S, int H, float scale,
                        cudaStream_t stream) {
    // each pass: two fixed tiles, two stages of two streamed tiles, 128 floats of stats
    constexpr size_t smem = 6 * (size_t)attn_mma::tile_elems(HD) * sizeof(bf16) +
                            2 * attn_mma::ROWS * 2 * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkv_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + attn_mma::ROWS - 1) / attn_mma::ROWS, H, B);
    const float scale_log2 = scale * 1.4426950408889634f;
    const bf16* x = static_cast<const bf16*>(qkv);
    const bf16* d = static_cast<const bf16*>(dout);
    bf16* dx = static_cast<bf16*>(dqkv);
    // the dq pass writes the deltas the dk/dv pass reads: same stream, in order
    attention_bwd_dq_bf16_kernel<HD><<<grid, attn_mma::THREADS, smem, stream>>>(
        x, static_cast<const bf16*>(out), d, lse, delta, dx, S, H, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_bwd_dkv_bf16_kernel<HD><<<grid, attn_mma::THREADS, smem, stream>>>(
        x, d, lse, delta, dx, S, H, scale, scale_log2);
    return cudaGetLastError();
}

// dtype 0: the fp32-core body; dtype 1: the tensor-core bodies
cudaError_t dispatch_hd(const void* qkv, const void* out, const void* dout, const float* lse,
                        float* delta, void* dqkv, int B, int S, int H, int hd, float scale,
                        int dtype, cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                                   \
    case N:                                                                              \
        return dtype == 0                                                                \
                   ? launch<float, N>(qkv, out, dout, lse, delta, dqkv, B, S, H, scale, stream) \
                   : launch_bf16<N>(qkv, out, dout, lse, delta, dqkv, B, S, H, scale, stream);
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
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)dispatch_hd(qkv, out, dout, l, dl, dqkv, B, S, H, hd, scale, dtype, st);
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
