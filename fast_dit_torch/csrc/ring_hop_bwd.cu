// One ring-attention hop, backward, for Hopper (sm_90a), fp32 and bf16.
//
// Replaces `fast_dit_tpu/ops/ring_attention.py::_hop_bwd_kernel` (:111-159,
// launched through `pl.pallas_call` by `_hop_backward`, :192-231).
//
// Computes the gradients of one hop's unnormalised partials (o_u, l) (see
// `ring_hop_fwd.cu`) with respect to q (B, Sq, D), k and v (B, Sk, D),
// given their fp32 cotangents do (B, Sq, D) and dl (B, Sq, H). Per batch row
// and head, with u = q k^T, s = u * scale and p_u = exp(min(s, 50)):
//     dv = p_u^T do
//     dp = do v^T + dl                       (dl broadcast along the keys)
//     du = p_u * [s < 50] * dp * scale       (the clamp's gradient mask)
//     dq = du k,   dk = du^T q
// There is no delta and no log-sum-exp: p_u is rebuilt from s alone. q, k
// and v come with their own batch and row strides (column views of the
// packed projection are read in place); dq, dk and dv are contiguous, in
// the input dtype.
//
// What bounds it on the H100. At the sequence-parallel DiT-XL/2 512²
// gradient shape (B = 4 shards x batch 2 = 8, Sq = Sk = 256, H = 16, hd = 72)
// one call does the five products, 10*B*Sq*Sk*D = 6.04 GFLOP, and must read
// q, k, v (bf16), do (fp32) and dl and write dq, dk, dv (bf16): 37.9 MB. On
// the data sheet (3.35 TB/s; 989 TFLOP/s bf16; 67 TFLOP/s fp32 cores) the
// bf16 call is bound by bytes at ~11 us (its products alone take 6.1 us),
// the fp32 call by operations at ~90 us.
//
// Two passes, no atomics, so the result is deterministic. The TPU kernel
// walks the query chunks of one batch row in order and carries dk/dv per
// head in VMEM scratch; Hopper blocks run in no order, so the sums are split
// by what they reduce over:
//  (1) the dq pass, one block per (64-query tile, head, batch row), loops
//      over the key tiles;
//  (2) the dk/dv pass, one block per (64-key tile, head, batch row), loops
//      over the query tiles.
// Both recompute the scores and do v^T (14 products' worth of work, not
// 10). Sq and Sk differ in general: the fixed side has Sq rows in the dq
// pass and Sk in the dk/dv pass, the streamed side the other. Streamed rows
// past the end give p_u = du = 0; fixed rows past the end are never stored.
//
// bf16 (dtype 1, every call of the sequence-parallel path): tensor cores,
// kernel 2's design (`flash_attention_bwd.cu`) without its delta and LSE,
// with the tile code of `attn_mma_bf16.cuh` (bf16 tiles in shared memory, hd
// padded with zero columns to a multiple of 16 there only, a bank-conflict-
// free pitch, 16-byte cp.async copies with rows past the end zero-filled,
// ldmatrix, mma.sync m16n8k16 with fp32 accumulation). 128 threads; each
// warp owns 16 rows of the fixed tile, whose hd-wide accumulators stay in
// registers; the streamed tiles go through a two-stage ring, so the next
// tile loads while the current one multiplies.
//  - dq pass: the fixed tiles are Q and dO, the streamed K and V. S = Q K^T
//    and dP = dO V^T (16 x 64 per warp); du = p_u [s < 50] (dp + dl) scale
//    with dl indexed by the row, rounded to bf16 into the A fragment of
//    dQ += dU K (K through ldmatrix.trans).
//  - dk/dv pass: the fixed tiles are K and V, the streamed Q and dO. The
//    transposed tiles S^T = K Q^T and dP^T = V dO^T make P^T and dU^T, in
//    registers, the A operands of dV += P^T dO and dK += dU^T Q (dO and Q
//    through ldmatrix.trans). dl is broadcast along the columns here: each
//    streamed query tile's 64 values (stride H) go through shared memory.
//    As in kernel 2, P^T is formed and dV summed before dP^T is formed; the
//    clamp mask of P^T's 32 entries per thread rides along as the bits of
//    one register, so at most two 16 x 64 tiles are live beside dK and dV.
//  - s = u * scale is clamped, and compared with 50, in the natural domain
//    in both passes, from the same fp32 s, as the plain version and the
//    forward do; then exp2f(s * log2(e)).
//  - do arrives as fp32 and cp.async cannot convert: the dq pass rounds its
//    fixed dO tile to bf16 once, with 16-byte loads, while the Q, K and V
//    copies are in flight; the dk/dv pass copies the next streamed dO tile
//    as fp32 with cp.async while the current one multiplies, and rounds it
//    into the bf16 dO tile after the products. No cast launch is added in
//    the wrapper.
//  - p_u, do and du are rounded to bf16 before their products, as the TPU
//    kernel does (`pc`, `doc`, `duc`, :143-148); du is formed from the fp32
//    p_u and dp, as there; every sum is fp32.
//  Why mma.sync and not wgmma + TMA: the bound is bytes (11 us against 6.1
//  us of products), mma.sync's rate puts the products at a few us, and a
//  144-byte head row does not fit the 128-byte swizzle atom of a single TMA
//  box and of wgmma's shared-memory descriptors.
//
// fp32 (dtype 0): the fp32-core body below (`ring_hop_bwd_kernel<float>`),
// which holds the 1e-5 limit against the plain version. Both passes are one
// templated body: a fixed 64-row tile (A, C) held in shared memory and
// 64-row tiles (B, E) of the other side streamed in turn:
//        dq pass:   A = q, C = do, B = k, E = v;  x = A B^T = u,  y = C E^T
//        dk/dv:     A = k, C = v, B = q, E = do;  x = u^T,        y = (do v^T)^T
//    and in both du = p_u [s < 50] (y + dl) scale and acc_B += du B; the
//    dk/dv pass also sums acc_E += p_u E (dv = p_u^T do).
//  - 256 threads. For the 64 x 64 score tiles each thread owns a 4 x 4
//    micro-tile; for the (64, hd) accumulators it owns 2 rows x hd/8 columns
//    (column cg + 8j), so the hd-wide sums stay in registers.
//  - Tiles sit in shared memory as fp32, transposed ([d][row]) with a row
//    pitch of 68 floats: the score loop reads float4s along rows, and the
//    accumulation loop reads a column d = cg + 8j from 8 banks apart.
//  - p_u, do and du stay fp32 (a no-op difference for fp32 inputs).
// dtype 2 runs bf16 inputs through that fp32-core body: the bf16 body of
// earlier versions, which no wrapper passes; it is kept as the yardstick of
// the tensor-core body (`chip_smoke.py`, `tests/test_torch_cuda.py`).
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// both passes on the given stream, allocates nothing, and returns
// cudaGetLastError().

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
constexpr float CLAMP = 50.f;

struct Strides {  // (batch, row) strides of q, k and v, in elements
    int64_t qb, qr, kb, kr, vb, vr;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Copy rows [row0, row0 + 64) of one head's HD columns, starting at column
// `col` of a tensor whose batch row starts at `src` with `row_stride`
// elements per row, into shared memory as fp32, transposed:
// dst[d * PITCH + r]. 16 bytes per global load; rows >= S are zero.
template <typename TS, int HD>
__device__ __forceinline__ void load_tile_t(const TS* __restrict__ src, float* dst, int row0,
                                            int S, int64_t row_stride, int col) {
    constexpr int VEC = 16 / sizeof(TS);
    constexpr int NVEC = HD / VEC;
    for (int c = threadIdx.x; c < BR * NVEC; c += THREADS) {
        const int r = c % BR;  // neighbouring threads take neighbouring rows
        const int v = c / BR;
        const int row = row0 + r;
        float vals[VEC];
        if (row < S) {
            const TS* p = src + (int64_t)row * row_stride + col + v * VEC;
            uint4 raw = *reinterpret_cast<const uint4*>(p);
            const TS* e = reinterpret_cast<const TS*>(&raw);
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
ring_hop_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ dl,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Strides st,
                    int Sq, int Sk, int H, float scale) {
    constexpr int NDG = HD / CG;  // accumulator columns per thread
    extern __shared__ float smem[];
    float* at = smem;                 // fixed tile A, [HD][PITCH]
    float* ct = at + HD * PITCH;      // fixed tile C
    float* bt = ct + HD * PITCH;      // streamed tile B
    float* et = bt + HD * PITCH;      // streamed tile E
    float* ps = et + HD * PITCH;      // p_u, [streamed row][fixed row]
    float* dus = ps + BR * PITCH;     // du,  [streamed row][fixed row]
    float* dl_s = dus + BR * PITCH;   // dl of the tile that holds the query rows

    const int S_fixed = KV ? Sk : Sq;
    const int S_stream = KV ? Sq : Sk;
    const int f_row0 = blockIdx.x * BR;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int col = h * HD;
    const T* qb = q + (int64_t)b * st.qb;
    const T* kb = k + (int64_t)b * st.kb;
    const T* vb = v + (int64_t)b * st.vb;
    const float* dob = dout + (int64_t)b * Sq * D;
    const float* dlb = dl + (int64_t)b * Sq * H;

    const int tid = threadIdx.x;
    const int tf = tid / 16, tl = tid % 16;  // score micro-tile: rows tf*4.., tl*4..
    const int rg = tid / CG, cg = tid % CG;  // accumulator: rows rg*2.., cols cg + 8j

    if (KV) {
        load_tile_t<T, HD>(kb, at, f_row0, Sk, st.kr, col);
        load_tile_t<T, HD>(vb, ct, f_row0, Sk, st.vr, col);
    } else {
        load_tile_t<T, HD>(qb, at, f_row0, Sq, st.qr, col);
        load_tile_t<float, HD>(dob, ct, f_row0, Sq, D, col);
        if (tid < BR) {
            const int row = f_row0 + tid;
            dl_s[tid] = row < Sq ? dlb[(int64_t)row * H + h] : 0.f;
        }
    }

    float acc_b[2][NDG], acc_e[2][NDG];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NDG; ++j) acc_b[i][j] = acc_e[i][j] = 0.f;

    for (int l_row0 = 0; l_row0 < S_stream; l_row0 += BR) {
        __syncthreads();  // the previous tile's readers are done
        if (KV) {
            load_tile_t<T, HD>(qb, bt, l_row0, Sq, st.qr, col);
            load_tile_t<float, HD>(dob, et, l_row0, Sq, D, col);
            if (tid < BR) {
                const int row = l_row0 + tid;
                dl_s[tid] = row < Sq ? dlb[(int64_t)row * H + h] : 0.f;
            }
        } else {
            load_tile_t<T, HD>(kb, bt, l_row0, Sk, st.kr, col);
            load_tile_t<T, HD>(vb, et, l_row0, Sk, st.vr, col);
        }
        __syncthreads();

        // x = A B^T (u), y = C E^T (do v^T), 4 x 4 per thread
        float x[4][4], y[4][4];
        micro_tile<HD>(at, bt, tf * 4, tl * 4, x);
        micro_tile<HD>(ct, et, tf * 4, tl * 4, y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int fi = tf * 4 + i, lj = tl * 4 + j;
                const int qrow = KV ? lj : fi;  // the query row of this entry, in its tile
                const bool valid = l_row0 + lj < S_stream;
                const float s = x[i][j] * scale;
                const float p = valid ? expf(fminf(s, CLAMP)) : 0.f;
                const float dp = y[i][j] + dl_s[qrow];
                x[i][j] = p;
                y[i][j] = (valid && s < CLAMP) ? p * dp * scale : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int lj = tl * 4 + j;
            *reinterpret_cast<float4*>(&ps[lj * PITCH + tf * 4]) =
                make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
            *reinterpret_cast<float4*>(&dus[lj * PITCH + tf * 4]) =
                make_float4(y[0][j], y[1][j], y[2][j], y[3][j]);
        }
        __syncthreads();

        // acc_b[f][c] += sum_l du[f][l] B[l][c];  KV: acc_e[f][c] += sum_l p_u[f][l] E[l][c]
        const int lmax = min(BR, S_stream - l_row0);
#pragma unroll 2
        for (int l = 0; l < lmax; ++l) {
            const float2 du2 = *reinterpret_cast<const float2*>(&dus[l * PITCH + rg * 2]);
#pragma unroll
            for (int j = 0; j < NDG; ++j) {
                const float bv = bt[(cg + CG * j) * PITCH + l];
                acc_b[0][j] = fmaf(du2.x, bv, acc_b[0][j]);
                acc_b[1][j] = fmaf(du2.y, bv, acc_b[1][j]);
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
        if (row >= S_fixed) continue;
        const int64_t off = ((int64_t)b * S_fixed + row) * D + col + cg;
#pragma unroll
        for (int j = 0; j < NDG; ++j) {
            if (KV) {
                dk[off + CG * j] = from_f32<T>(acc_b[i][j]);
                dv[off + CG * j] = from_f32<T>(acc_e[i][j]);
            } else {
                dq[off + CG * j] = from_f32<T>(acc_b[i][j]);
            }
        }
    }
}

constexpr size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)4 * hd * PITCH + 2 * BR * PITCH + BR);
}

template <typename T, int HD, bool KV>
cudaError_t launch_pass(const void* q, const void* k, const void* v, const float* dout,
                        const float* dl, void* dq, void* dk, void* dv, const Strides& st,
                        int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes(HD);
    // above 48 KB a block's shared memory must be asked for; the attribute is
    // per device, so it is set on every call (a host-side store, no sync)
    cudaError_t err = cudaFuncSetAttribute(ring_hop_bwd_kernel<T, HD, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(((KV ? Sk : Sq) + BR - 1) / BR, H, B);
    ring_hop_bwd_kernel<T, HD, KV><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), dout, dl,
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), st, Sq, Sk, H, scale);
    return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* dout,
                   const float* dl, void* dq, void* dk, void* dv, const Strides& st, int B,
                   int Sq, int Sk, int H, float scale, cudaStream_t stream) {
    // the passes write disjoint outputs and read only inputs
    cudaError_t err = launch_pass<T, HD, false>(q, k, v, dout, dl, dq, dk, dv, st, B, Sq, Sk,
                                                H, scale, stream);
    if (err != cudaSuccess) return err;
    return launch_pass<T, HD, true>(q, k, v, dout, dl, dq, dk, dv, st, B, Sq, Sk, H, scale,
                                    stream);
}

// ---- bf16: tensor cores ----------------------------------------------------

using attn_mma::bf16;

constexpr float LOG2E = 1.4426950408889634f;

// The dq pass: one block per (64-query tile, head, batch row).
template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
ring_hop_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ dl, bf16* __restrict__ dq, Strides st,
                            int Sq, int Sk, int H, float scale) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int P = pitch(HD);
    constexpr int NT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* qs = reinterpret_cast<bf16*>(smem_bf16);  // Q tile, then the dq tile
    bf16* dos = qs + T;                               // dO tile, rounded to bf16
    bf16* kv = dos + T;                               // two stages of (K tile, V tile)

    const int q0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int col = h * HD;
    const bf16* kb = k + (int64_t)b * st.kb;
    const bf16* vb = v + (int64_t)b * st.vb;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;

    zero_padding<HD>(qs, 6);
    load_tile_async<HD>(qs, q + (int64_t)b * st.qb, q0, Sq, st.qr, col);
    load_tile_async<HD>(kv, kb, 0, Sk, st.kr, col);
    load_tile_async<HD>(kv + T, vb, 0, Sk, st.vr, col);
    cp_async_commit();
    // while those copies are in flight
    f32_to_tile<HD>(dos, dout + (int64_t)b * Sq * D, q0, Sq, D, col);
    const int r0 = q0 + warp * 16 + g;
    const float* dlb = dl + (int64_t)b * Sq * H + h;
    const float dl0 = r0 < Sq ? dlb[(int64_t)r0 * H] : 0.f;
    const float dl1 = r0 + 8 < Sq ? dlb[(int64_t)(r0 + 8) * H] : 0.f;

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int ntiles = (Sk + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* kt = kv + (it % 2) * 2 * T;
        const bf16* vt = kt + T;
        if (it + 1 < ntiles) {
            bf16* nk = kv + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nk, kb, (it + 1) * ROWS, Sk, st.kr, col);
            load_tile_async<HD>(nk + T, vb, (it + 1) * ROWS, Sk, st.vr, col);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // (the first one also publishes the dO tile)

        float s[8][4], du[8][4];
        mma_abt<HD>(s, qs + warp * 16 * P, kt);
        mma_abt<HD>(du, dos + warp * 16 * P, vt);
        const int k0 = it * ROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // below the clamp, min(s, 50) = s
                const float sn = s[j][e] * scale;
                const bool live = k0 + 8 * j + 2 * t + (e % 2) < Sk && sn < CLAMP;
                const float dp = du[j][e] + (e < 2 ? dl0 : dl1);
                du[j][e] = live ? exp2f(sn * LOG2E) * dp * scale : 0.f;
            }
        }
        mma_ab<HD>(acc, du, kt);  // dq += du k, du rounded to bf16
        __syncthreads();          // this stage is refilled next
    }

    // the warp's own rows of the Q tile were read by this warp only
    acc_to_tile<HD>(acc, qs, warp * 16, 1.f, 1.f);
    __syncthreads();
    store_tile<HD>(qs, dq + (int64_t)b * Sq * D, q0, Sq, D, col);
}

// The dk/dv pass: one block per (64-key tile, head, batch row).
template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
ring_hop_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ dl, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, Strides st, int Sq, int Sk, int H,
                             float scale) {
    using namespace attn_mma;
    constexpr int T = tile_elems(HD);
    constexpr int P = pitch(HD);
    constexpr int NT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    bf16* ks = reinterpret_cast<bf16*>(smem_bf16);  // K tile, then the dk tile
    bf16* vs = ks + T;                                // V tile, then the dv tile
    bf16* qr = vs + T;                                // two stages of the Q tile
    bf16* dos = qr + 2 * T;                           // the current dO tile, bf16
    float* dof = reinterpret_cast<float*>(dos + T);   // the next dO tile, fp32
    float* dls = dof + ROWS * HD;                     // two stages of the tile's 64 dl

    const int k0 = blockIdx.x * ROWS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int D = H * HD;
    const int col = h * HD;
    const bf16* qb = q + (int64_t)b * st.qb;
    const float* dob = dout + (int64_t)b * Sq * D;
    const float* dlb = dl + (int64_t)b * Sq * H + h;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;

    // the streamed query rows' dl, 0 past Sq (their p_u is forced to 0)
    auto load_dl = [&](float* dst, int row0) {
        if (threadIdx.x < ROWS) {
            const int row = row0 + threadIdx.x;
            dst[threadIdx.x] = row < Sq ? dlb[(int64_t)row * H] : 0.f;
        }
    };

    zero_padding<HD>(ks, 5);
    load_tile_async<HD>(ks, k + (int64_t)b * st.kb, k0, Sk, st.kr, col);
    load_tile_async<HD>(vs, v + (int64_t)b * st.vb, k0, Sk, st.vr, col);
    load_tile_async<HD>(qr, qb, 0, Sq, st.qr, col);
    load_tile_f32_async<HD>(dof, dob, 0, Sq, D, col);
    cp_async_commit();
    load_dl(dls, 0);
    cp_async_wait<0>();
    __syncthreads();
    f32_to_tile<HD>(dos, dof, 0, ROWS, HD, 0);

    float dka[NT][4], dva[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
        dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = dva[j][0] = dva[j][1] = dva[j][2] =
            dva[j][3] = 0.f;

    const int ntiles = (Sq + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        // tile it's Q, dO and dl are in place, and every reader of the
        // buffers refilled below is done
        __syncthreads();
        const bf16* qt = qr + (it % 2) * T;
        const float* dlt = dls + (it % 2) * ROWS;
        if (it + 1 < ntiles) {
            const int n = (it + 1) % 2;
            load_tile_async<HD>(qr + n * T, qb, (it + 1) * ROWS, Sq, st.qr, col);
            load_tile_f32_async<HD>(dof, dob, (it + 1) * ROWS, Sq, D, col);
            cp_async_commit();
            load_dl(dls + n * ROWS, (it + 1) * ROWS);
        }

        // p^T (16 keys x 64 queries per warp) from S^T = K Q^T; the clamp
        // mask [s < 50] of this thread's 32 entries is kept as bits
        float p[8][4];
        mma_abt<HD>(p, ks + warp * 16 * P, qt);
        const int q0 = it * ROWS;
        uint32_t live = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float sn = p[j][e] * scale;
                const bool valid = q0 + 8 * j + 2 * t + (e % 2) < Sq;
                p[j][e] = valid ? exp2f(fminf(sn, CLAMP) * LOG2E) : 0.f;
                live |= (uint32_t)(valid && sn < CLAMP) << (4 * j + e);
            }
        }
        mma_ab<HD>(dva, p, dos);  // dv += p^T do, p rounded to bf16

        // du^T from dP^T = V dO^T; dl belongs to the column (query)
        float du[8][4];
        mma_abt<HD>(du, vs + warp * 16 * P, dos);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float dp = du[j][e] + dlt[8 * j + 2 * t + (e % 2)];
                du[j][e] = (live >> (4 * j + e)) & 1u ? p[j][e] * dp * scale : 0.f;
            }
        }
        mma_ab<HD>(dka, du, qt);  // dk += du^T q, du rounded to bf16

        if (it + 1 < ntiles) {
            cp_async_wait<0>();
            __syncthreads();  // every warp is done with this dO tile
            f32_to_tile<HD>(dos, dof, 0, ROWS, HD, 0);
        }
    }

    // the warp's own rows of the K and V tiles were read by this warp only
    acc_to_tile<HD>(dka, ks, warp * 16, 1.f, 1.f);
    acc_to_tile<HD>(dva, vs, warp * 16, 1.f, 1.f);
    __syncthreads();
    store_tile<HD>(ks, dk + (int64_t)b * Sk * D, k0, Sk, D, col);
    store_tile<HD>(vs, dv + (int64_t)b * Sk * D, k0, Sk, D, col);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* dout,
                        const float* dl, void* dq, void* dk, void* dv, const Strides& st,
                        int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
    using attn_mma::ROWS;
    constexpr size_t tile = (size_t)attn_mma::tile_elems(HD) * sizeof(bf16);
    // dq: Q, dO and two stages of (K, V); dk/dv: K, V, two stages of Q, the
    // bf16 dO tile, the next dO tile in fp32 and two stages of the 64 dl
    constexpr size_t smem_dq = 6 * tile;
    constexpr size_t smem_dkv = 5 * tile + (size_t)ROWS * (HD + 2) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ring_hop_bwd_dq_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_dq);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ring_hop_bwd_dkv_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
    if (err != cudaSuccess) return err;
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    // the passes write disjoint outputs and read only inputs
    ring_hop_bwd_dq_bf16_kernel<HD><<<dim3((Sq + ROWS - 1) / ROWS, H, B), attn_mma::THREADS,
                                      smem_dq, stream>>>(
        qp, kp, vp, dout, dl, static_cast<bf16*>(dq), st, Sq, Sk, H, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ring_hop_bwd_dkv_bf16_kernel<HD><<<dim3((Sk + ROWS - 1) / ROWS, H, B), attn_mma::THREADS,
                                       smem_dkv, stream>>>(
        qp, kp, vp, dout, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, Sq, Sk, H,
        scale);
    return cudaGetLastError();
}

// dtype 0: the fp32-core body on fp32; 1: the tensor-core bodies on bf16; 2:
// the fp32-core body on bf16
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const float* dout,
                        const float* dl, void* dq, void* dk, void* dv, const Strides& st,
                        int B, int Sq, int Sk, int H, int hd, float scale, int dtype,
                        cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                                      \
    case N:                                                                                 \
        return dtype == 0   ? launch<float, N>(q, k, v, dout, dl, dq, dk, dv, st, B, Sq, Sk, \
                                               H, scale, stream)                            \
               : dtype == 1 ? launch_bf16<N>(q, k, v, dout, dl, dq, dk, dv, st, B, Sq, Sk, H, \
                                             scale, stream)                                 \
                            : launch<__nv_bfloat16, N>(q, k, v, dout, dl, dq, dk, dv, st, B,  \
                                                       Sq, Sk, H, scale, stream);
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
// own batch and row strides (elements), 16-byte aligned rows; do (B, Sq,
// H*hd) and dl (B, Sq, H) contiguous fp32; dq (B, Sq, H*hd), dk and dv (B,
// Sk, H*hd) contiguous, of the input dtype. hd is a multiple of 8, at most
// 128. Every element of dq, dk and dv is written.
int fdt_ring_hop_bwd(const void* q, const void* k, const void* v, const void* dout,
                     const void* dl, void* dq, void* dk, void* dv, long long q_bstride,
                     long long q_rstride, long long k_bstride, long long k_rstride,
                     long long v_bstride, long long v_rstride, int B, int Sq, int Sk, int H,
                     int hd, float scale, int dtype, void* stream) {
    if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || B > 65535 || H > 65535 || dtype < 0 || dtype > 2)
        return (int)cudaErrorInvalidValue;
    const Strides st{(int64_t)q_bstride, (int64_t)q_rstride, (int64_t)k_bstride,
                     (int64_t)k_rstride, (int64_t)v_bstride, (int64_t)v_rstride};
    return (int)dispatch_hd(q, k, v, static_cast<const float*>(dout),
                            static_cast<const float*>(dl), dq, dk, dv, st, B, Sq, Sk, H, hd,
                            scale, dtype, static_cast<cudaStream_t>(stream));
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
