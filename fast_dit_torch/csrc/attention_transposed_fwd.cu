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
// moves 67.1 MB: 20.0 us. Measured past the bound (PERF.md, kernel 6): the
// copies alone, products and exponentials left out, took 19 of the 26 us
// of a non-persistent version of this body, and a second TMA box per row (a
// 144-byte head row is 128 + 16 bytes) nearly doubled them, so what costs
// is moving rows between L2 and the SMs and the latency that a block waits
// on its first tiles, more than the arithmetic (the 16.8 M exponentials of
// the bench shape take about 4 us on the special-function units).
//
// Why not the TPU's layout. The TPU kernel moves hd to the sublane axis so
// that hd 72 pads to the bf16 sublane tile (80) and not to the 128 lanes.
// On the card nothing pads to 128: wgmma's k step pads hd only to a
// multiple of 16 (72 -> 80), and the padding columns are written as zeros
// in shared memory without being read. The tiles stay [token][hd].
//
// bf16 (dtype 1): TMA loads, mbarriers and wgmma (`hopper_async.cuh`).
//  - Tensor maps, encoded on the host from the plan that
//    `ops/attn_layout.py::_tma_plan` computes: the packed qkv as a rank-5
//    tensor (hd, H, 3, S, B), the output as (hd, H, S, B). A box is 64 rows
//    of a 64-column chunk of one head (128-byte swizzle), and the bounds
//    supply the padding: rows >= S of a batch row and columns >= hd arrive
//    as zeros (not as the next batch row or head), and the store drops what
//    lies past hd or S. A head's columns are cut into chunks as wide as a
//    swizzle span, each a wgmma operand with its own descriptor: 64 + 16 at
//    hd 72, 64 + 64 at hd 128, 16 at hd 8 (one 16-column box, 32-byte
//    swizzle). So a 144-byte head row needs no 128-byte atom of its own.
//    Against the bytes: one copy per box, no address arithmetic in the SMs.
//  - The remainder chunk (hd mod 64: 16 columns at hd 72) moves as 16-byte
//    cp.async pieces by the producer warpgroup, into the layout a box of
//    its width would write, each thread's pieces counted on the stage's
//    mbarrier (cp.async.mbarrier.arrive.noinc); the consumers store it with
//    16-byte stores. Against the rows: TMA costs about as much per row of a
//    16-column box as of a 64-column one.
//  - Warp specialisation: a producer warpgroup (its registers handed to the
//    consumers with setmaxnreg) and four consumer warpgroups of 64 query
//    rows (two at hd > 96). K and V stream in 64-key tiles through a ring of
//    STAGES stages, each with a full and an empty mbarrier; a stage is freed
//    when every consumer warp has run both products on it. Against the
//    bytes: each K/V tile serves 256 query rows, so at S = 256 a head's K
//    and V cross from L2 once (blocks of 64 query rows read them four times).
//  - Persistent blocks, one per SM, walk over (query tile, head, batch row)
//    items; Q has two buffers and the ring runs on across items. Against
//    the latency: the next item's Q and first tiles load while the current
//    item computes and stores, and no block starts cold after the first.
//  - S = Q K^T is wgmma m64n64k16, A (Q) and B (K) K-major from shared
//    memory, HDP / 16 k steps. In registers: s = u * scale clamped in the
//    natural domain, 2^x on the special-function unit, keys >= S set to 0
//    in the last tile (TMA's zero rows would give p_u = 1). p_u is rounded to
//    bf16 once, two neighbours at a time (cvt.rn.bf16x2.f32), straight into
//    the register A fragments of P V, whose layout is the accumulator's; the
//    row sums add the packed values back. O += P V is wgmma with A from
//    registers and V as an MN-major B from shared memory, N split as the
//    chunks are. Against the arithmetic: the card's full tensor-core rate,
//    and no shared-memory traffic for P.
//  - Epilogue: each warpgroup scales its rows by 1 / max(l, 1e-30), rounds
//    them to bf16 into its own rows of its Q buffer in the swizzled layout,
//    and stores the TMA chunks through the output map (one thread) and the
//    remainder with 16-byte stores (rows < S, columns < hd).
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
// independent blocks (fp32) or independent items of persistent blocks (bf16);
// nothing carries between them.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the given stream, allocates nothing, and returns cudaGetLastError().
// The bf16 body reaches cuTensorMapEncodeTiled through the runtime's
// entry-point query, so the library links against nothing more.

#include <cuda.h>  // CUtensorMap and its enums only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

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

// ---- bf16: TMA, mbarriers and wgmma -----------------------------------------

namespace tma {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int KEYS = 64;                        // keys per stage, rows of a box
constexpr int WG_ROWS = 64;                     // query rows per consumer warpgroup
constexpr int PLAN_FIELDS = 16;                 // per map of the plan, see `encode`

// The head dim padded to HDP (a multiple of 16, wgmma's k step) and cut into
// chunks of columns: N64 of 64, then one of 32 and/or one of 16, each as wide
// as a swizzle span. A tile of R rows lies in shared memory chunk after
// chunk, chunk c as [R][width(c)] at byte R * 2 col(c), swizzled as a TMA box
// of that width writes it. The 64-column chunks (or the only chunk) move by
// TMA; a narrower remainder by the producer warpgroup's 16-byte cp.async and
// the consumers' 16-byte stores.
template <int HD>
struct Geo {
    static constexpr int HDP = (HD + 15) / 16 * 16;
    static constexpr int N64 = HDP / 64;
    static constexpr bool W32 = HDP % 64 >= 32;
    static constexpr bool W16 = HDP % 32 != 0;
    static constexpr int CHUNKS = N64 + W32 + W16;
    static constexpr int N_TMA = N64 > 0 ? N64 : 1;  // chunks 0 .. N_TMA-1 move by TMA
    static constexpr bool REST = CHUNKS > N_TMA;     // the others by threads
    static constexpr int STAGES = HDP <= 96 ? 3 : 2;
    // consumer warpgroups, one block to an SM, and the registers a thread of
    // each role keeps after the producers hand their surplus to the
    // consumers: 128 x 24 + 512 x 112 of the 640 x 96 a block of four has;
    // at hd > 96, whose P V accumulator alone takes 64, 128 x 40 + 256 x 232
    // of 384 x 168 for two
    static constexpr int CONSUMERS = HDP <= 96 ? 4 : 2;
    static constexpr int BLOCK_ROWS = CONSUMERS * WG_ROWS;
    static constexpr int PRODUCER_WARP = CONSUMERS * 4;  // the first of the producer warpgroup
    static constexpr int THREADS = (CONSUMERS + 1) * 128;
    static constexpr int PRODUCER_REGS = CONSUMERS == 4 ? 24 : 40;
    static constexpr int CONSUMER_REGS = CONSUMERS == 4 ? 112 : 232;
    static constexpr int Q_BYTES = BLOCK_ROWS * HDP * 2;
    static constexpr int KV_BYTES = KEYS * HDP * 2;  // one K or V tile
    // two Q buffers, the stages (stage s's K at 2 s KV_BYTES past the first,
    // V after it), then the mbarriers: q_full[2], q_empty[2], full[STAGES],
    // empty[STAGES]; and 1024 bytes to align the base
    static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (4 + 2 * STAGES);
    __host__ __device__ static constexpr int width(int c) {
        return c < N64 ? 64 : c == N64 && W32 ? 32 : 16;
    }
    __host__ __device__ static constexpr int col(int c) { return c <= N64 ? 64 * c : 64 * N64 + 32; }
};

struct Maps {
    CUtensorMap qkv;  // rank 5, (hd, H, 3, S, B); a box: 64 rows of a TMA chunk
    CUtensorMap out;  // rank 4, (hd, H, S, B)
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// the two bf16 values of a packed pair, widened exactly to fp32
__device__ __forceinline__ float low_bf16(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float high_bf16(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// Chunks N_TMA .. of R rows of one head (rows row0 .., tensor `part` of the
// packed qkv) into the tile at `tile`, 16 bytes per cp.async, split over the
// 128 producer threads (pt). Columns >= HD and rows >= S are zero-filled.
template <int HD, int R, int C = Geo<HD>::N_TMA>
__device__ __forceinline__ void copy_rest(uint32_t tile, const bf16* qkv, int64_t row_stride,
                                          int64_t head_col, int row0, int S, int pt) {
    if constexpr (C < Geo<HD>::CHUNKS) {
        constexpr int w = Geo<HD>::width(C), col = Geo<HD>::col(C), U = w / 8;
        for (int i = pt; i < R * U; i += 128) {
            const int r = i / U, u = i % U;
            const bool valid = row0 + r < S && col + 8 * u < HD;
            const bf16* src = qkv + (valid ? (row0 + r) * row_stride + head_col + col + 8 * u : 0);
            cp_async16(tile + R * 2 * col + swizzle(r * 2 * w + 16 * u, w), src, valid);
        }
        copy_rest<HD, R, C + 1>(tile, qkv, row_stride, head_col, row0, S, pt);
    }
}

// O (chunks C ..) += A V over the 16 keys of k step kk: one product per
// chunk of the V tile at v_s, each N as wide as its chunk
template <int HD, int C = 0>
__device__ __forceinline__ void pv_step(float* o, const uint32_t a[4], uint32_t v_s, int kk) {
    if constexpr (C < Geo<HD>::CHUNKS) {
        constexpr int w = Geo<HD>::width(C);
        const uint64_t vb = wgmma_desc(v_s + KEYS * 2 * Geo<HD>::col(C) + kk * 16 * 2 * w, w, true);
        float* oc = o + Geo<HD>::col(C) / 2;
        if constexpr (w == 64) wgmma_rs_n64(oc, a, vb);
        else if constexpr (w == 32) wgmma_rs_n32(oc, a, vb);
        else wgmma_rs_n16(oc, a, vb);
        pv_step<HD, C + 1>(o, a, v_s, kk);
    }
}

// 2^x in one instruction of the special-function unit; exp2f adds three
// more to keep results below 2^-126 (logits below -87). Flushed to 0 here,
// they move an output by at most S x 2^-126 / 1e-30 (the row sum's floor),
// about S x 1.2e-8, of max |v|.
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// p_u of one 64-key tile from the scores sc (the m64n64 accumulator): the
// bf16 A fragments pa of P V and the row sums l0, l1 (rows `row`, row + 8).
// MASK: keys >= S, in the last tile only, give 0.
template <bool MASK>
__device__ __forceinline__ void p_tile(const float sc[32], uint32_t pa[4][4], float& l0, float& l1,
                                       int k0, int S, int t, float scale) {
    // n8 block j is half of k step j / 2 (elements 0, 1 of row `row`, then
    // 2, 3 of row + 8); the row sums add the rounded values that P V
    // multiplies
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        float pu[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            // the exponential for every key, then a select: put inside the
            // condition, it compiles to branches
            const float x = exp2_ftz(fminf(sc[4 * j + e] * scale, CLAMP) * LOG2E);
            pu[e] = !MASK || k0 + 8 * j + 2 * t + (e % 2) < S ? x : 0.f;
        }
        const uint32_t r0 = pack_bf16x2(pu[0], pu[1]), r1 = pack_bf16x2(pu[2], pu[3]);
        pa[j / 2][(j % 2) * 2] = r0;
        pa[j / 2][(j % 2) * 2 + 1] = r1;
        l0 += low_bf16(r0) + high_bf16(r0);
        l1 += low_bf16(r1) + high_bf16(r1);
    }
}

// One block per SM walks over items (a BLOCK_ROWS query tile of one head
// and batch row), item blockIdx.x + k gridDim.x in turn. Q alternates
// between two buffers, and the ring of K/V stages runs on across items, so
// the producer loads the next item's Q and first tiles while the consumers
// finish the current one.
template <int HD>
__global__ void __launch_bounds__(Geo<HD>::THREADS, 1)
attention_transposed_fwd_bf16_tma_kernel(const __grid_constant__ Maps maps,
                                         const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                         int S, int H, int B, float scale) {
    using G = Geo<HD>;
    constexpr int CONSUMERS = G::CONSUMERS, BLOCK_ROWS = G::BLOCK_ROWS;
    constexpr int PRODUCER_WARP = G::PRODUCER_WARP, W0 = G::width(0);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // two Q buffers
    const uint32_t kv_s = q_s + 2 * G::Q_BYTES;
    const uint32_t q_full = kv_s + G::STAGES * 2 * G::KV_BYTES;   // [2], then q_empty [2]
    const uint32_t q_empty = q_full + 16;
    const uint32_t full = q_empty + 16, empty = full + 8 * G::STAGES;  // + 8 s for stage s

    const int D = H * HD;
    const int64_t row_stride = 3 * (int64_t)D;  // of the packed qkv
    const int ntiles = (S + KEYS - 1) / KEYS;
    const int nq = (S + BLOCK_ROWS - 1) / BLOCK_ROWS;
    const int items = nq * H * B;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // the producer's TMA transaction and, with a remainder chunk, one
    // cp.async arrival of each producer thread complete a load
    constexpr int LOAD_ARRIVALS = 1 + (G::REST ? 128 : 0);

    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(q_full + 8 * i, LOAD_ARRIVALS);
            mbar_init(q_empty + 8 * i, CONSUMERS);  // each warpgroup's stores have read it
        }
        for (int s = 0; s < G::STAGES; ++s) {
            mbar_init(full + 8 * s, LOAD_ARRIVALS);
            mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (warp >= PRODUCER_WARP) {
        setmaxnreg_dec<G::PRODUCER_REGS>();
        const int pt = threadIdx.x - PRODUCER_WARP * 32;
        int kt = 0;  // K/V tiles loaded so far, over all items
        for (int item = blockIdx.x, k = 0; item < items; item += gridDim.x, ++k) {
            const int q0 = (item % nq) * BLOCK_ROWS, h = (item / nq) % H, b = item / (nq * H);
            const bf16* head = qkv + (int64_t)b * S * row_stride;
            const int qb = k & 1;
            const uint32_t qbuf = q_s + qb * G::Q_BYTES;
            if (k >= 2) mbar_wait(q_empty + 8 * qb, ((k >> 1) - 1) & 1);  // item k - 2 stored
            if (pt == 0) {
                mbar_expect_tx(q_full + 8 * qb, BLOCK_ROWS * 2 * W0 * G::N_TMA);
#pragma unroll
                for (int c = 0; c < G::N_TMA; ++c)
#pragma unroll
                    for (int r = 0; r < CONSUMERS; ++r)
                        tma_load_5d(qbuf + BLOCK_ROWS * 2 * G::col(c) + r * WG_ROWS * 2 * W0,
                                    &maps.qkv, q_full + 8 * qb, G::col(c), h, 0, q0 + r * WG_ROWS,
                                    b);
            }
            if (G::REST) {
                copy_rest<HD, BLOCK_ROWS>(qbuf, head, row_stride, h * HD, q0, S, pt);
                cp_async_mbar_arrive(q_full + 8 * qb);
            }
            for (int it = 0; it < ntiles; ++it, ++kt) {
                const int s = kt % G::STAGES, n = kt / G::STAGES;
                if (n > 0) mbar_wait(empty + 8 * s, (n - 1) & 1);  // every consumer warp is done
                const uint32_t k_s = kv_s + 2 * s * G::KV_BYTES;
                if (pt == 0) {
                    mbar_expect_tx(full + 8 * s, 2 * KEYS * 2 * W0 * G::N_TMA);
#pragma unroll
                    for (int c = 0; c < G::N_TMA; ++c) {
                        const uint32_t off = KEYS * 2 * G::col(c);
                        tma_load_5d(k_s + off, &maps.qkv, full + 8 * s, G::col(c), h, 1,
                                    it * KEYS, b);
                        tma_load_5d(k_s + G::KV_BYTES + off, &maps.qkv, full + 8 * s, G::col(c),
                                    h, 2, it * KEYS, b);
                    }
                }
                if (G::REST) {
                    copy_rest<HD, KEYS>(k_s, head, row_stride, D + h * HD, it * KEYS, S, pt);
                    copy_rest<HD, KEYS>(k_s + G::KV_BYTES, head, row_stride, 2 * D + h * HD,
                                        it * KEYS, S, pt);
                    cp_async_mbar_arrive(full + 8 * s);
                }
            }
        }
        return;
    }

    setmaxnreg_inc<G::CONSUMER_REGS>();
    const int wg = warp / 4;
    const int t = lane % 4;                      // columns 2t, 2t + 1 of each n8 block
    const int row = (warp % 4) * 16 + lane / 4;  // and row + 8, of the warpgroup's 64
    int kt = 0;
    for (int item = blockIdx.x, k = 0; item < items; item += gridDim.x, ++k) {
        const int q0 = (item % nq) * BLOCK_ROWS, h = (item / nq) % H, b = item / (nq * H);
        const int qb = k & 1;
        const uint32_t qbuf = q_s + qb * G::Q_BYTES;
        float o[G::HDP / 2];  // the m64nHDP accumulator, chunk by chunk
#pragma unroll
        for (int i = 0; i < G::HDP / 2; ++i) o[i] = 0.f;
        float l0 = 0.f, l1 = 0.f;  // this thread's share of rows row, row + 8

        mbar_wait(q_full + 8 * qb, (k >> 1) & 1);
        for (int it = 0; it < ntiles; ++it, ++kt) {
            const int s = kt % G::STAGES;
            mbar_wait(full + 8 * s, (kt / G::STAGES) & 1);
            // what the threads copied (the remainder of Q and of this stage)
            // to the products' asynchronous view of shared memory
            if (G::REST) fence_proxy_async();
            const uint32_t k_s = kv_s + 2 * s * G::KV_BYTES, v_s = k_s + G::KV_BYTES;

            // S = Q K^T over the HDP / 16 k steps, chunk by chunk
            float sc[32];
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < G::CHUNKS; ++c) {
                const uint32_t qa =
                    qbuf + BLOCK_ROWS * 2 * G::col(c) + wg * WG_ROWS * 2 * G::width(c);
                const uint32_t kb = k_s + KEYS * 2 * G::col(c);
#pragma unroll
                for (int kk = 0; kk < G::width(c) / 16; ++kk)
                    wgmma_ss_n64(sc, wgmma_desc(qa + 32 * kk, G::width(c), false),
                                 wgmma_desc(kb + 32 * kk, G::width(c), false), c + kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<32>(sc);

            // p_u = exp(min(s, 50)), clamped in the natural domain, rounded to
            // bf16 once straight into the A fragments of P V
            const int k0 = it * KEYS;
            uint32_t pa[4][4];
            if (k0 + KEYS > S) p_tile<true>(sc, pa, l0, l1, k0, S, t, scale);
            else p_tile<false>(sc, pa, l0, l1, k0, S, t, scale);

            // O += P V: per k step of 16 keys, one product per chunk of V
            wgmma_fence();
            fence_regs<G::HDP / 2>(o);
#pragma unroll
            for (int kk = 0; kk < KEYS / 16; ++kk) pv_step<HD>(o, pa[kk], v_s, kk);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<G::HDP / 2>(o);
            if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp has read the stage
        }

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = 1.f / fmaxf(l0, L_FLOOR), inv1 = 1.f / fmaxf(l1, L_FLOOR);

        // the output over the warpgroup's own rows of its Q buffer, which only
        // its products read (and they are done), in the chunks' swizzled layout
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c) {
            const int w = G::width(c);
            const uint32_t base = qbuf + BLOCK_ROWS * 2 * G::col(c) + wg * WG_ROWS * 2 * w;
#pragma unroll
            for (int j = 0; j < w / 8; ++j) {
                const float* oj = o + G::col(c) / 2 + 4 * j;
                const uint32_t x = 2 * (8 * j + 2 * t);
                st_shared_u32(base + swizzle(row * 2 * w + x, w),
                              pack_bf16x2(oj[0] * inv0, oj[1] * inv0));
                st_shared_u32(base + swizzle((row + 8) * 2 * w + x, w),
                              pack_bf16x2(oj[2] * inv1, oj[3] * inv1));
            }
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        const int r0 = q0 + wg * WG_ROWS;
        if (threadIdx.x % 128 == 0) {  // through the output map, which clips at hd and S
#pragma unroll
            for (int c = 0; c < G::N_TMA; ++c)
                tma_store_4d(&maps.out, qbuf + BLOCK_ROWS * 2 * G::col(c) + wg * WG_ROWS * 2 * W0,
                             G::col(c), h, r0, b);
            tma_store_commit();
        }
        if (G::REST) {  // the remainder, 16 bytes a thread, rows < S and columns < hd
#pragma unroll
            for (int c = G::N_TMA; c < G::CHUNKS; ++c) {
                const int w = G::width(c), U = w / 8;
                const uint32_t base = qbuf + BLOCK_ROWS * 2 * G::col(c) + wg * WG_ROWS * 2 * w;
                for (int i = threadIdx.x % 128; i < WG_ROWS * U; i += 128) {
                    const int r = i / U, u = i % U;
                    if (r0 + r < S && G::col(c) + 8 * u < HD)
                        *reinterpret_cast<uint4*>(out + ((int64_t)b * S + r0 + r) * D + h * HD +
                                                  G::col(c) + 8 * u) =
                            ld_shared_v4(base + swizzle(r * 2 * w + 16 * u, w));
                }
            }
            named_barrier(1 + wg, 128);  // every thread's reads of the buffer are done
        }
        if (threadIdx.x % 128 == 0) {
            tma_store_wait_read();
            mbar_arrive(q_empty + 8 * qb);  // the buffer may take the next Q
        }
    }
}

// cuTensorMapEncodeTiled, reached through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
    static EncodeTiled cached = nullptr;
    if (cached == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
        cached = reinterpret_cast<EncodeTiled>(p);
    }
    *fn = cached;
    return cudaSuccess;
}

// One map of the plan, PLAN_FIELDS values: [0] rank, [1, 6) dims innermost
// first, [6, 10) byte strides of dims 1 .., [10, 15) box, [15] swizzle span
// in bytes. It must be the map the kernel reads: these dims, a box of
// `width` columns (the TMA chunks') and 64 rows (dim `row_dim`), the swizzle
// of that width. The box sets the bytes each mbarrier waits for.
bool plan_matches(const long long* f, int rank, const long long* dims, int width, int row_dim) {
    if (f[0] != rank || f[15] != 2 * width) return false;
    for (int i = 0; i < rank; ++i)
        if (f[1 + i] != dims[i] || f[10 + i] != (i == 0 ? width : i == row_dim ? KEYS : 1))
            return false;
    return true;
}

cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const long long* f, void* ptr) {
    const int rank = (int)f[0];
    cuuint64_t dims[5], strides[4];
    cuuint32_t box[5], unit[5] = {1, 1, 1, 1, 1};
    for (int i = 0; i < rank; ++i) {
        dims[i] = (cuuint64_t)f[1 + i];
        box[i] = (cuuint32_t)f[10 + i];
    }
    for (int i = 0; i + 1 < rank; ++i) strides[i] = (cuuint64_t)f[6 + i];
    const CUtensorMapSwizzle swizzle = f[15] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : f[15] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, ptr, dims, strides, box,
                          unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int S, int H, float scale,
                        const long long* plan, cudaStream_t stream) {
    using G = Geo<HD>;
    if (plan == nullptr) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
        return cudaErrorMisalignedAddress;  // TMA refuses it
    const long long qkv_dims[5] = {HD, H, 3, S, B}, out_dims[4] = {HD, H, S, B};
    if (!plan_matches(plan, 5, qkv_dims, G::width(0), 3) ||
        !plan_matches(plan + PLAN_FIELDS, 4, out_dims, G::width(0), 2))
        return cudaErrorInvalidValue;
    EncodeTiled fn;
    Maps maps;
    cudaError_t err;
    if ((err = encoder(&fn)) != cudaSuccess ||
        (err = encode(fn, &maps.qkv, plan, const_cast<void*>(qkv))) != cudaSuccess ||
        (err = encode(fn, &maps.out, plan + PLAN_FIELDS, out)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(attention_transposed_fwd_bf16_tma_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM)) !=
            cudaSuccess)
        return err;
    // one block per SM, each walking over (query tile, head, batch row) items
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    const long long items = (long long)((S + G::BLOCK_ROWS - 1) / G::BLOCK_ROWS) * H * B;
    if (items > INT32_MAX) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(items < sms ? items : sms));
    attention_transposed_fwd_bf16_tma_kernel<HD><<<grid, G::THREADS, G::SMEM, stream>>>(
        maps, static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, H, B, scale);
    return cudaGetLastError();
}

}  // namespace tma

// dtype 0: the fp32-core body; dtype 1: the TMA + wgmma body
cudaError_t dispatch_hd(const void* qkv, void* out, int B, int S, int H, int hd, float scale,
                        int dtype, const long long* plan, cudaStream_t stream) {
    switch (hd) {
#define FDT_HD_CASE(N)                                                                    \
    case N:                                                                               \
        return dtype == 0 ? launch<N>(qkv, out, B, S, H, scale, stream)                   \
                          : tma::launch_bf16<N>(qkv, out, B, S, H, scale, plan, stream);
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
// at most 128. plan: for bf16, the 2 x 16 values of
// `ops/attn_layout.py::_tma_plan` (the map of qkv, then of out); unread for
// fp32.
int fdt_attention_transposed_fwd(const void* qkv, void* out, int B, int S, int H, int hd,
                                 float scale, int dtype, const long long* plan, void* stream) {
    if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    return (int)dispatch_hd(qkv, out, B, S, H, hd, scale, dtype, plan,
                            static_cast<cudaStream_t>(stream));
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
