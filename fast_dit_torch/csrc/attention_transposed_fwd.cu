// Clamped packed-qkv attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces `benchmarks/attn_layout_bench.py::_transposed_kernel` (:59-78,
// launched through `pl.pallas_call` by `transposed_forward`, :81-96).
//
// Computes, for every batch row b and head h of the packed (B, S, 3D)
// projection output (q at column h*hd, k at D + h*hd, v at 2D + h*hd, row
// stride 3D, D = H * hd), read in place,
//     s[i, j] = (q_h[i] . k_h[j]) * scale            fp32 sums
//     p_u     = exp(min(s, 50))                      no row max
//     pc      = p_u rounded to the input dtype       once
//     l[i]    = sum_j pc[i, j]                       fp32
//     o[b, i, h*hd:(h+1)*hd] = (sum_j pc[i, j] v_h[j]) * (1 / max(l[i], 1e-30))
// and writes o (B, S, D) in the input dtype. The same rounded pc feeds the
// row sum and the product with v, as the TPU kernel's ones-matmul and its
// P V product both take `p_u.astype(dtype)` (:73, :76). Below the clamp this
// is softmax attention; a row whose logits pass 50 flattens toward a uniform
// mix of its clamped keys, which is what the TPU kernel computes and what
// this kernel keeps (kernel 1, `flash_attention_fwd.cu`, is exact).
//
// What bounds it on the H100. At the TPU bench's shape (B = 16, S = 256,
// H = 16, hd = 72, D = 1152) one call does 4*B*S^2*D = 4.83 GFLOP and must
// read 3D and write D per token: 37.7 MB in bf16. Against the data sheet
// (3.35 TB/s; 989 TFLOP/s bf16 tensor cores; 67 TFLOP/s fp32 without them)
// the bf16 call is bound by bytes at 11.3 us (its products alone take 4.9
// us) and the fp32 call by operations at 72 us. At hd 128 the bf16 call
// moves 67.1 MB: 20.0 us.
//
// Why not the TPU's layout. The TPU kernel moves hd to the sublane axis so
// that hd 72 pads to the bf16 sublane tile (80) and not to the 128 lanes.
// On the card nothing pads to 128: the k step of mma.m16n8k16 pads hd only
// to a multiple of 16 (72 -> 80) and only in Q K^T, in shared memory, and
// P V's n step of 8 takes 72 whole (`attn_mma_bf16.cuh`). So the tiles are
// laid out as the tensor cores want them, row-major [token][hd], and there
// is no transpose.
//
// bf16 (dtype 1): tensor cores, the inner loop of kernel 4's bf16 body
// (`ring_hop_fwd.cu`) at Sq = Sk = S over one packed qkv, with p_u rounded
// as below, plus kernel 1's epilogue, in one launch.
//  - One 128-thread block (4 warps x 16 query rows) per (64-query tile,
//    head, batch row). The Q tile is read once; 64-key K and V tiles stream
//    through a two-stage ring filled with 16-byte cp.async (rows >= S
//    zero-filled), so the next tile loads while the current one multiplies.
//    Tiles are bf16, hd padded to a multiple of 16 by zero columns in shared
//    memory only, pitch padded_hd + 8.
//  - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with fp32
//    accumulation (V through ldmatrix.trans). s = u * scale is clamped in
//    the natural domain, then exp2f(min(s, 50) * log2(e)); keys >= S give
//    p_u = 0. p_u is rounded to bf16 once, two neighbours at a time
//    (cvt.rn.bf16x2.f32) straight into the A fragments of P V, and the row
//    sum l adds the packed values back (a shift or a mask each). Rounding
//    each value on its own and widening it again, as kernel 4's bf16 body
//    does, compiles to 32 single F2F conversions a tile, which run on the
//    SM's slow conversion pipe: that form was measured on the H100 about a
//    third slower at the bench shape and a half slower at hd 128, with
//    equal outputs (`PERF.md`, kernel 6).
//  - Epilogue: each warp scales its 16 rows by 1 / max(l, 1e-30) in fp32,
//    rounds them to bf16 into its own rows of the Q tile, and the block
//    stores the tile with 16-byte stores into o's columns; query rows >= S
//    are never stored. o is 9.4 MB of bf16, where kernel 4 writes 18.9 MB
//    of fp32 o_u and leaves the division to its caller.
//  Why mma.sync and not wgmma + TMA: as for kernels 1 and 4, the bound is
//  bytes (11.3 us against 4.9 us of products), and a 144-byte head row does
//  not fit the 128-byte swizzle atom of a single TMA box.
//
// fp32 (dtype 0): an fp32-core body, kernel 4's `ring_hop_fwd_kernel<float>`
// at Sq = Sk = S with the same epilogue, which holds the 1e-5 limit against
// the plain version (TF32 or bf16 products would not).
//  - One 128-thread block per (64-query tile, head, batch row); the Q tile
//    (64 x hd) is staged once in shared memory, K and V tiles of 64 keys in
//    turn, all fp32; Q and K transposed ([d][row]) so the score loop reads
//    float4s without bank conflicts.
//  - Each thread owns a 4-row x 8-key micro-tile of the scores and, in the
//    P V product, the same 4 rows x hd/8 output columns (column cg + 8j).
//    The row sums are three xor-shuffles over the 8 neighbouring lanes that
//    share a row group. exp is `expf` of the clamped fp32 logit; p_u stays
//    fp32 (its rounding to fp32 is the identity).
//
// The TPU kernel's grid over batch rows, with an unrolled head loop, becomes
// independent blocks in both bodies; nothing carries between them.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma_bf16.cuh"

namespace {

constexpr float CLAMP = 50.f;
constexpr float L_FLOOR = 1e-30f;  // the TPU kernel's floor of the row sum (:74)
constexpr float LOG2E = 1.4426950408889634f;

// ---- fp32: fp32 cores ------------------------------------------------------

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per shared-memory tile
constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int RPT = 4;         // rows per thread
constexpr int KPT = 8;         // keys per thread in the score micro-tile
constexpr int CG = 8;          // column groups (threads sharing a row group)

// Copy rows [row0, row0 + 64) of one head's HD fp32 columns (from column
// `col` of a row-major tensor whose row r begins at src + r * row_stride)
// into shared memory, 16 bytes per global load. Rows >= S are zero.
// TRANSPOSED stores dst[d * 64 + r], else dst[r * HD + d].
template <int HD, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* dst, int row0,
                                          int S, int64_t row_stride, int col) {
    constexpr int NVEC = HD / 4;
    for (int c = threadIdx.x; c < BQ * NVEC; c += THREADS) {
        // transposed: neighbouring threads take neighbouring rows, so the
        // [d][r] stores hit distinct banks; else they walk along the row
        const int r = TRANSPOSED ? c % BQ : c / NVEC;
        const int v = TRANSPOSED ? c / BQ : c % NVEC;
        const int row = row0 + r;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < S)
            x = *reinterpret_cast<const float4*>(src + (int64_t)row * row_stride + col + v * 4);
        const float vals[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int d = v * 4 + i;
            if (TRANSPOSED) dst[d * BQ + r] = vals[i];
            else dst[r * HD + d] = vals[i];
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_transposed_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S,
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
    const int64_t rs = 3 * (int64_t)D;
    const float* base = qkv + (int64_t)b * S * rs;

    const int tid = threadIdx.x;
    const int rg = tid / CG;   // row group: rows rg*4 .. rg*4+3
    const int cg = tid % CG;   // column group

    load_tile<HD, true>(base, qt, q0, S, rs, h * HD);

    float lsum[RPT], acc[RPT][NDG];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        lsum[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NDG; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < S; k0 += BK) {
        __syncthreads();  // the previous tile's readers are done
        load_tile<HD, true>(base, kt, k0, S, rs, D + h * HD);
        load_tile<HD, false>(base, vs, k0, S, rs, 2 * D + h * HD);
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
                s[i][j] = key < S ? expf(fminf(s[i][j] * scale, CLAMP)) : 0.f;
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
        const int kmax = min(BK, S - k0);
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

    // o = acc / max(l, 1e-30); each of the 8 lanes of a row group holds the
    // whole row sum after the shuffles
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + rg * RPT + i;
        if (row >= S) continue;
        const float inv = 1.f / fmaxf(lsum[i], L_FLOOR);
        float* dst = out + ((int64_t)b * S + row) * D + h * HD + cg;
#pragma unroll
        for (int j = 0; j < NDG; ++j) dst[CG * j] = acc[i][j] * inv;
    }
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int S, int H, float scale,
                   cudaStream_t stream) {
    constexpr size_t smem = sizeof(float) * (size_t)(3 * BQ * HD + BK * BQ);
    // above 48 KB a block's shared memory must be asked for; the attribute is
    // per device, so it is set on every call (a host-side store, no sync)
    cudaError_t err = cudaFuncSetAttribute(attention_transposed_fwd_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    attention_transposed_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), S, H, scale);
    return cudaGetLastError();
}

// ---- bf16: tensor cores ----------------------------------------------------

using attn_mma::bf16;

// acc (16 x HD, HD / 8 n8 tiles) += A B, A given as its bf16 fragments
// pa[kk] for the k steps kk = 0..3 over the 64 keys (the layout of
// `attn_mma::acc_to_a`), B the 64 rows `b` of a tile ([k][d]); otherwise
// `attn_mma::mma_ab`.
template <int HD>
__device__ __forceinline__ void mma_ab_packed(float acc[HD / 8][4], const uint32_t pa[4][4],
                                              const bf16* b) {
    using namespace attn_mma;
    constexpr int P = pitch(HD);
    constexpr int NT = HD / 8;
    const int lane = threadIdx.x % 32;
    // B^T through ldmatrix.trans: rows (lane % 8) + 8 ((lane / 8) % 2), column 8 (lane / 16)
    const bf16* b_lane = b + ((lane % 8) + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const bf16* bk = b_lane + kk * 16 * P;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, bk + jp * 16);
            mma16816(acc[2 * jp], pa[kk], bf[0], bf[1]);
            mma16816(acc[2 * jp + 1], pa[kk], bf[2], bf[3]);
        }
        if (NT % 2) {
            // the odd n8 tile: lanes 16-31 repeat the addresses of 0-15
            uint32_t bf[2];
            ldmatrix_x2_trans(bf, bk - (lane / 16) * 8 + (NT - 1) * 8);
            mma16816(acc[NT - 1], pa[kk], bf[0], bf[1]);
        }
    }
}

// the two bf16 values of a packed pair, widened exactly to fp32
__device__ __forceinline__ float low_bf16(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float high_bf16(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

template <int HD>
__global__ void __launch_bounds__(attn_mma::THREADS)
attention_transposed_fwd_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                     int S, int H, float scale) {
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
    const int kcol = D + h * HD, vcol = 2 * D + h * HD;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane % 4;  // this thread's columns 2t, 2t + 1 of each n8 tile

    zero_padding<HD>(qs, 5);
    load_tile_async<HD>(qs, base, q0, S, rs, h * HD);
    load_tile_async<HD>(kv, base, 0, S, rs, kcol);
    load_tile_async<HD>(kv + T, base, 0, S, rs, vcol);
    cp_async_commit();

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of rows g and g + 8

    const int ntiles = (S + ROWS - 1) / ROWS;
    for (int it = 0; it < ntiles; ++it) {
        const bf16* kt = kv + (it % 2) * 2 * T;
        const bf16* vt = kt + T;
        if (it + 1 < ntiles) {
            // the other stage's readers finished before the last barrier
            bf16* nk = kv + ((it + 1) % 2) * 2 * T;
            load_tile_async<HD>(nk, base, (it + 1) * ROWS, S, rs, kcol);
            load_tile_async<HD>(nk + T, base, (it + 1) * ROWS, S, rs, vcol);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        float s[8][4];
        mma_abt<HD>(s, qs + warp * 16 * pitch(HD), kt);
        // p_u = exp(min(s, 50)), clamped in the natural domain, rounded to
        // bf16 once into the A fragments: n8 tile j is half of k step j / 2
        // (elements 0, 1 of row g, then 2, 3 of row g + 8); the row sums add
        // the rounded values that P V multiplies
        const int k0 = it * ROWS;
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float pu[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // exp2f for every key, then a select: put inside the
                // condition, it compiles to branches that cost a quarter
                const bool valid = k0 + 8 * j + 2 * t + (e % 2) < S;
                const float x = exp2f(fminf(s[j][e] * scale, CLAMP) * LOG2E);
                pu[e] = valid ? x : 0.f;
            }
            const uint32_t r0 = pack_bf16x2(pu[0], pu[1]), r1 = pack_bf16x2(pu[2], pu[3]);
            pa[j / 2][(j % 2) * 2] = r0;
            pa[j / 2][(j % 2) * 2 + 1] = r1;
            l0 += low_bf16(r0) + high_bf16(r0);
            l1 += low_bf16(r1) + high_bf16(r1);
        }
        mma_ab_packed<HD>(acc, pa, vt);
        __syncthreads();  // this stage is refilled next
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // the warp's own rows of the Q tile were read by this warp only, and the
    // loop's last barrier is behind every read
    acc_to_tile<HD>(acc, qs, warp * 16, 1.f / fmaxf(l0, L_FLOOR), 1.f / fmaxf(l1, L_FLOOR));
    __syncthreads();
    store_tile<HD>(qs, out + (int64_t)b * S * D, q0, S, D, h * HD);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int S, int H, float scale,
                        cudaStream_t stream) {
    // the Q tile and two stages of K and V tiles
    constexpr size_t smem = 5 * (size_t)attn_mma::tile_elems(HD) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(attention_transposed_fwd_bf16_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + attn_mma::ROWS - 1) / attn_mma::ROWS, H, B);
    attention_transposed_fwd_bf16_kernel<HD><<<grid, attn_mma::THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, H, scale);
    return cudaGetLastError();
}

// dtype 0: the fp32-core body; dtype 1: the tensor-core body
cudaError_t dispatch_hd(const void* qkv, void* out, int B, int S, int H, int hd, float scale,
                        int dtype, cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                            \
    case N:                                                                       \
        return dtype == 0 ? launch<N>(qkv, out, B, S, H, scale, stream)           \
                          : launch_bf16<N>(qkv, out, B, S, H, scale, stream);
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
// of that dtype are contiguous and 16-byte aligned; hd is a multiple of 8,
// at most 128.
int fdt_attention_transposed_fwd(const void* qkv, void* out, int B, int S, int H, int hd,
                                 float scale, int dtype, void* stream) {
    if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    return (int)dispatch_hd(qkv, out, B, S, H, hd, scale, dtype,
                            static_cast<cudaStream_t>(stream));
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
