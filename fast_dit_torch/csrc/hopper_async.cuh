// Hopper's asynchronous building blocks (sm_90a), written as inline PTX:
// mbarriers, TMA tile copies through tensor maps, and warpgroup matrix
// products (wgmma) with their shared-memory descriptors. Used by the bf16
// body of `attention_transposed_fwd.cu`; nothing here depends on a kernel.
//
// Shared-memory tiles are what a TMA box of B columns writes: rows of
// 2 B bytes, dense, with the swizzle whose span is the row (B = 64: 128-byte
// swizzle, B = 32: 64-byte, B = 16: 32-byte), from a base aligned to 1024
// bytes. Byte offset x of the unswizzled tile sits at
//     x ^ (((x >> 7) & m) << 4),  m = 7, 3, 1:
// bits 4.. (the 16-byte unit within the span) XORed with bits 7.. (which
// 128 bytes of the tile), so 8 consecutive rows' same column spread over
// the banks.
// Such a tile is the canonical wgmma layout of the same swizzle, K-major
// when the columns are the contraction (A and B of Q K^T) and MN-major when
// the rows are (B of P V): in both, groups of 8 rows lie 16 B bytes apart.

#pragma once

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to the
// TMA unit; a __syncthreads() follows
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed. A wait of 2^34
// clocks (about 9 s) traps: a transaction that never completes then ends the
// kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long start = 0;
    for (int i = 0;; ++i) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (i == 0) start = clock64();
        else if (clock64() - start > (1ll << 34)) __trap();
    }
}

// ---- TMA ----------------------------------------------------------------------------

// a box of a rank-5 map at coordinates c0..c4 (innermost first) into shared
// memory at `dst`; its bytes complete a transaction on `bar`. Out-of-bounds
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3, int c4) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
        "r"(c4)
        : "memory");
}

// a box of shared memory at `src` to a rank-4 map at c0..c3; elements out of
// the map's bounds are not written
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
            "l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores' reads of shared memory are done (the block may then exit)
__device__ __forceinline__ void tma_store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// shared-memory writes of this thread become visible to the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- copies by threads --------------------------------------------------------------

// 16 bytes from global memory to shared memory at `dst`; `valid` false
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far have landed
// (the barrier counts it among its expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr)
                 : "memory");
    return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// a barrier over `threads` threads (a multiple of 32) of the block; id 0 is
// __syncthreads()'s
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// byte offset x of a tile whose rows are `width` bf16 columns, swizzled as a
// TMA box of that width lays it out
__device__ __forceinline__ uint32_t swizzle(uint32_t x, int width) {
    const uint32_t m = width == 64 ? 7u : width == 32 ? 3u : 1u;
    return x ^ (((x >> 7) & m) << 4);
}

// ---- wgmma --------------------------------------------------------------------------

// The descriptor of a tile of `width` bf16 columns at shared address `addr`
// (swizzle span 2 width bytes; 8-row groups 16 width bytes apart). K-major
// (the contraction along the row): the leading offset is unused and set to
// 1; MN-major (the contraction down the rows): the leading offset would be
// the next swizzle atom along N, which a product of N <= width never reaches,
// and is set to the 8-row stride as well.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int width, bool mn_major) {
    const uint64_t sbo = (16u * width) >> 4;
    const uint64_t lbo = mn_major ? sbo : 1u;
    const uint64_t mode = width == 64 ? 1u : width == 32 ? 2u : 3u;  // 128-, 64-, 32-byte
    return ((addr & 0x3FFFFu) >> 4) | (lbo << 16) | (sbo << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A warpgroup's registers per thread, raised from or lowered to N (a
// multiple of 8, 24 .. 256); every warp of the warpgroup executes it.
// Lowering returns registers to the block's pool, raising waits for them.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the points where this is placed
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Products of one warpgroup, bf16 inputs, fp32 accumulators. The
// accumulator of m64nN holds, in thread 4 g + t of warp w, rows 16 w + g
// and 16 w + g + 8 of columns 8 j + 2 t, 8 j + 2 t + 1 of each n8 block j:
// d[4 j + 0, 1] and d[4 j + 2, 3]. A register A fragment (m64k16) has the
// layout of mma.m16n8k16's per warp: a[0] row g, columns 2 t, 2 t + 1; a[1]
// row g + 8; a[2], a[3] the same at columns + 8.

// d (64 x 64, fp32) = A B^T (+ d if accumulate), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A B, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A B, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t a[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16, fp32) += A B, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t a[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace hopper
