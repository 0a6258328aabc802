// Tile code shared by the bf16 attention kernels for Hopper (sm_90a):
// `flash_attention_fwd.cu`, `flash_attention_bwd.cu` and the ring hops
// `ring_hop_fwd.cu` and `ring_hop_bwd.cu`.
//
// - Tiles of 64 rows of one head's hd columns sit in shared memory as bf16,
//   row-major, with hd padded to HDP (the next multiple of 16, the k step of
//   mma.m16n8k16) and a row pitch of HDP + 8 elements. The pitch is an odd
//   number of 16-byte chunks (11 for hd 72: 176 bytes), so the eight row
//   addresses of one 8x8 ldmatrix fall in eight different bank groups: no
//   bank conflicts. Columns hd .. HDP-1 are zero and are never written by a
//   copy, so the padding costs no device-memory traffic.
// - Rows are copied from device memory with 16-byte `cp.async.cg` (a head's
//   hd columns start at a multiple of 8 elements, so every chunk is
//   aligned); rows >= S are zero-filled through the source-size operand.
// - Fragments come from shared memory through `ldmatrix` (A operands and B
//   operands stored [n][k]) and `ldmatrix.trans` (B operands stored [k][n]),
//   and the products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
//   with fp32 accumulation. A 16 x 64 fp32 accumulator (8 n8 tiles) turns
//   into the bf16 A fragments of a product that contracts over its 64
//   columns in registers (`acc_to_a`), as in FlashAttention-2.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds k rows 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g; C holds rows g and g + 8, columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;    // rows of a tile, fixed or streamed
constexpr int WARPS = 4;    // each warp owns 16 rows of the fixed tile
constexpr int THREADS = 32 * WARPS;

__host__ __device__ constexpr int padded_hd(int hd) { return (hd + 15) / 16 * 16; }
__host__ __device__ constexpr int pitch(int hd) { return padded_hd(hd) + 8; }
__host__ __device__ constexpr int tile_elems(int hd) { return ROWS * pitch(hd); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    // src-size 0 writes 16 zero bytes and reads nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + 64) of HD columns, from column `col` of a
// row-major tensor whose row r begins at base + r * row_stride, into `dst`
// (pitch(HD)). Rows >= S are zero-filled. All threads of the block call it.
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ base,
                                                int row0, int S, int64_t row_stride, int col) {
    constexpr int CHUNKS = HD / 8;
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, ch = c % CHUNKS;
        const int row = row0 + r;
        const bool valid = row < S;
        // a zero-filled chunk still names a valid address: row 0 of the tensor
        const bf16* src = base + (valid ? (int64_t)row * row_stride : 0) + col + ch * 8;
        cp_async16(dst + r * pitch(HD) + ch * 8, src, valid);
    }
}

// Zero columns HD .. padded_hd(HD) - 1 of `n` consecutive tiles, so that a
// product contracting over the padded hd adds nothing. Copies never write
// them, so this is done once per block.
template <int HD>
__device__ __forceinline__ void zero_padding(bf16* tiles, int n) {
    constexpr int PAD_CHUNKS = (padded_hd(HD) - HD) / 8;
    if constexpr (PAD_CHUNKS > 0) {
        for (int c = threadIdx.x; c < n * ROWS * PAD_CHUNKS; c += THREADS) {
            const int r = c / PAD_CHUNKS, ch = c % PAD_CHUNKS;
            *reinterpret_cast<uint4*>(tiles + r * pitch(HD) + HD + ch * 8) =
                make_uint4(0, 0, 0, 0);
        }
    }
}

// Start copying rows [row0, row0 + 64) of HD fp32 columns, from column
// `col` of a row-major fp32 tensor, into a dense fp32 tile dst[r * HD + d].
// Rows >= S are zero-filled. All threads of the block call it.
template <int HD>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* __restrict__ base,
                                                    int row0, int S, int64_t row_stride,
                                                    int col) {
    constexpr int CHUNKS = HD / 4;
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, ch = c % CHUNKS;
        const int row = row0 + r;
        const bool valid = row < S;
        const float* src = base + (valid ? (int64_t)row * row_stride : 0) + col + ch * 4;
        cp_async16(dst + c * 4, src, valid);
    }
}

// Round rows [row0, row0 + 64) of HD fp32 columns, from column `col` of a
// row-major fp32 array in device or shared memory, to bf16 into the tile
// `dst` (pitch(HD)); rows >= S are zero. 16-byte loads; all threads of the
// block call it.
template <int HD>
__device__ __forceinline__ void f32_to_tile(bf16* dst, const float* src, int row0, int S,
                                            int64_t row_stride, int col) {
    constexpr int CHUNKS = HD / 4;
#pragma unroll
    for (int i = 0; i < (ROWS * CHUNKS + THREADS - 1) / THREADS; ++i) {
        const int c = threadIdx.x + i * THREADS;
        if (c < ROWS * CHUNKS) {
            const int r = c / CHUNKS, ch = c % CHUNKS;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (row0 + r < S)
                x = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * row_stride +
                                                     col + ch * 4);
            __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
            __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
            *reinterpret_cast<uint2*>(dst + r * pitch(HD) + ch * 4) =
                make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
        }
    }
}

// Write rows [row0, row0 + 64) of a bf16 tile in shared memory to HD columns
// from column `col` of a row-major tensor, 16 bytes per store; rows >= S
// are not stored. All threads of the block call it.
template <int HD>
__device__ __forceinline__ void store_tile(const bf16* src, bf16* __restrict__ base, int row0,
                                           int S, int64_t row_stride, int col) {
    constexpr int CHUNKS = HD / 8;
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, ch = c % CHUNKS;
        if (row0 + r < S)
            *reinterpret_cast<uint4*>(base + (int64_t)(row0 + r) * row_stride + col + ch * 8) =
                *reinterpret_cast<const uint4*>(src + r * pitch(HD) + ch * 8);
    }
}

// ---- fragments ---------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragment of k step kk (columns 16kk .. 16kk + 15) of a 16 x 64
// fp32 accumulator: each value is rounded to bf16 once.
__device__ __forceinline__ void acc_to_a(const float acc[8][4], int kk, uint32_t a[4]) {
    a[0] = pack_bf16x2(acc[2 * kk][0], acc[2 * kk][1]);
    a[1] = pack_bf16x2(acc[2 * kk][2], acc[2 * kk][3]);
    a[2] = pack_bf16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[3] = pack_bf16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// ---- warp products -------------------------------------------------------------

// acc (16 x 64, 8 n8 tiles) = A B^T over the padded hd, for the warp's 16
// rows `a` of one tile and the 64 rows `b` of another (both [row][d]).
template <int HD>
__device__ __forceinline__ void mma_abt(float acc[8][4], const bf16* a, const bf16* b) {
    constexpr int P = pitch(HD);
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // A: lanes 0-15 name rows 0-15 at column 0, lanes 16-31 rows 0-15 at 8
    const bf16* a_lane = a + (lane % 16) * P + (lane / 16) * 8;
    // B, two n8 tiles per x4: rows (lane % 8) + 8 (lane / 16), column 8 ((lane / 8) % 2)
    const bf16* b_lane = b + ((lane % 8) + (lane / 16) * 8) * P + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < padded_hd(HD) / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, a_lane + kk * 16);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
            uint32_t bf[4];
            ldmatrix_x4(bf, b_lane + jp * 16 * P + kk * 16);
            mma16816(acc[2 * jp], af, bf[0], bf[1]);
            mma16816(acc[2 * jp + 1], af, bf[2], bf[3]);
        }
    }
}

// acc (16 x HD, HD / 8 n8 tiles) += A B, A the bf16 fragments of a 16 x 64
// fp32 accumulator `x` (rounded here), B the 64 rows `b` of a tile ([k][d]).
template <int HD>
__device__ __forceinline__ void mma_ab(float acc[HD / 8][4], const float x[8][4],
                                       const bf16* b) {
    constexpr int P = pitch(HD);
    constexpr int NT = HD / 8;
    const int lane = threadIdx.x % 32;
    // B^T through ldmatrix.trans: rows (lane % 8) + 8 ((lane / 8) % 2), column 8 (lane / 16)
    const bf16* b_lane = b + ((lane % 8) + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        acc_to_a(x, kk, af);
        const bf16* bk = b_lane + kk * 16 * P;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, bk + jp * 16);
            mma16816(acc[2 * jp], af, bf[0], bf[1]);
            mma16816(acc[2 * jp + 1], af, bf[2], bf[3]);
        }
        if (NT % 2) {
            // the odd n8 tile: lanes 16-31 repeat the addresses of 0-15
            uint32_t bf[2];
            ldmatrix_x2_trans(bf, bk - (lane / 16) * 8 + (NT - 1) * 8);
            mma16816(acc[NT - 1], af, bf[0], bf[1]);
        }
    }
}

// Round the warp's 16 x HD accumulator to bf16 into rows [16w, 16w + 16) of
// a tile in shared memory.
template <int HD>
__device__ __forceinline__ void acc_to_tile(const float acc[HD / 8][4], bf16* tile, int row0,
                                            float mul0, float mul1) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    bf16* r0 = tile + (row0 + g) * pitch(HD) + 2 * t;
    bf16* r1 = r0 + 8 * pitch(HD);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(r0 + 8 * j) = pack_bf16x2(acc[j][0] * mul0, acc[j][1] * mul0);
        *reinterpret_cast<uint32_t*>(r1 + 8 * j) = pack_bf16x2(acc[j][2] * mul1, acc[j][3] * mul1);
    }
}

}  // namespace attn_mma
