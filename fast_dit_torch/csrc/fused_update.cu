// Fused AdamW + fp32 master + EMA update for Hopper (sm_90a), in place.
//
// Replaces `fast_dit_tpu/ops/fused_update.py::_leaf_kernel` (:138-147,
// launched through `pl.pallas_call` by `_fused_leaf`, :150-181), whose math
// is `_update_math` (:103-116). One elementwise pass over one parameter leaf:
//     m  <- round_M(b1 m + (1-b1) g)               mu stored in M (fp32 or bf16)
//     v32 = b2 v + (1-b2) g g;  v <- round_V(v32)  nu stored in V (fp32 or bf16)
//     w  <- w - lr (m bc1 / (sqrt(v32 bc2) + eps) + wd w)   fp32 master
//     e  <- d e + (1-d) w                          fp32 EMA
//     p  <- round_P(w)                             the model's parameter
// with bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t) computed once per step by the
// caller in fp32. The order of rounding is `_update_math`'s: m is rounded to
// M before mhat is formed from it; vhat is formed from the unrounded v32 and
// only the stored v is rounded to V. Every operation is an explicitly
// rounded fp32 intrinsic (no fused multiply-add), so the kernel computes
// what the plain PyTorch version computes, op by op.
//
// What bounds it on the H100: bytes. Per element it reads g, m, v, w, e and
// writes p, m, v, w, e: 2*sizeof(P) + 2*sizeof(M) + 2*sizeof(V) + 16 bytes,
// which with bf16 params and mu is 32 bytes (fp32 nu) or 28 (bf16 nu) for
// some 15 flops. At DiT-XL/2's 675 M parameters that is 21.6 or 18.9 GB per
// step, 6.4 or 5.6 ms at 3.35 TB/s. The design is the plain one for that: a
// grid-stride loop, neighbouring threads on neighbouring elements, every
// state read once and written once, in place (the TPU kernel's input/output
// aliases, :174).
//
// One launch per leaf (the caller walks the parameter list); P x M x V
// covers {fp32, bf16}^3. The TPU's `size % 128 == 0 and size >= 1024` lane
// rule is not carried over: every leaf of any size goes through this kernel.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM, grid-stride beyond

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

struct Hyper {
    float bc1, bc2, lr, b1, omb1, b2, omb2, eps, wd, decay, omdecay;
};

template <typename P, typename M, typename V>
__global__ void __launch_bounds__(THREADS)
fused_adamw_ema_kernel(const P* __restrict__ g, P* __restrict__ p, M* __restrict__ m,
                       V* __restrict__ v, float* __restrict__ w, float* __restrict__ e,
                       int64_t n, Hyper hp) {
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
        const float g32 = to_f32(g[i]);
        const M m_new = from_f32<M>(__fadd_rn(__fmul_rn(hp.b1, to_f32(m[i])),
                                              __fmul_rn(hp.omb1, g32)));
        const float v32 = __fadd_rn(__fmul_rn(hp.b2, to_f32(v[i])),
                                    __fmul_rn(__fmul_rn(hp.omb2, g32), g32));
        const float mhat = __fmul_rn(to_f32(m_new), hp.bc1);
        const float vhat = __fmul_rn(v32, hp.bc2);
        const float w32 = w[i];
        const float upd = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hp.eps)),
                                    __fmul_rn(hp.wd, w32));
        const float w_new = __fsub_rn(w32, __fmul_rn(hp.lr, upd));
        e[i] = __fadd_rn(__fmul_rn(hp.decay, e[i]), __fmul_rn(hp.omdecay, w_new));
        m[i] = m_new;
        v[i] = from_f32<V>(v32);
        w[i] = w_new;
        p[i] = from_f32<P>(w_new);
    }
}

template <typename P, typename M, typename V>
cudaError_t launch(const void* g, void* p, void* m, void* v, float* w, float* e, int64_t n,
                   const Hyper& hp, cudaStream_t stream) {
    const int64_t want = (n + THREADS - 1) / THREADS;
    const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
    fused_adamw_ema_kernel<P, M, V><<<blocks, THREADS, 0, stream>>>(
        static_cast<const P*>(g), static_cast<P*>(p), static_cast<M*>(m), static_cast<V*>(v),
        w, e, n, hp);
    return cudaGetLastError();
}

// dtype codes 0 = float32, 1 = bfloat16, resolved one template argument at a time
template <typename... T> struct Types {};

template <typename... Chosen>
cudaError_t dispatch(Types<Chosen...>, const void* g, void* p, void* m, void* v, float* w,
                     float* e, int64_t n, const Hyper& hp, cudaStream_t st) {
    return launch<Chosen...>(g, p, m, v, w, e, n, hp, st);
}

template <typename... Chosen, typename... Codes>
cudaError_t dispatch(Types<Chosen...>, const void* g, void* p, void* m, void* v, float* w,
                     float* e, int64_t n, const Hyper& hp, cudaStream_t st, int code,
                     Codes... rest) {
    if (code == 0)
        return dispatch(Types<Chosen..., float>{}, g, p, m, v, w, e, n, hp, st, rest...);
    if (code == 1)
        return dispatch(Types<Chosen..., __nv_bfloat16>{}, g, p, m, v, w, e, n, hp, st,
                        rest...);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// p_dtype (of the param and its grad), mu_dtype and nu_dtype: 0 = float32,
// 1 = bfloat16. g, p, m, v, w, e hold n contiguous elements each; w and e are
// fp32. The scalars are fp32: omb1 = 1-b1, omb2 = 1-b2 and omdecay = 1-decay
// rounded once from double, as the plain version's Python floats are.
int fdt_fused_adamw_ema(const void* g, void* p, void* m, void* v, void* w, void* e,
                        int64_t n, int p_dtype, int mu_dtype, int nu_dtype, float bc1,
                        float bc2, float lr, float b1, float omb1, float b2, float omb2,
                        float eps, float wd, float decay, float omdecay, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const Hyper hp{bc1, bc2, lr, b1, omb1, b2, omb2, eps, wd, decay, omdecay};
    return (int)dispatch(Types<>{}, g, p, m, v, static_cast<float*>(w),
                         static_cast<float*>(e), n, hp, static_cast<cudaStream_t>(stream),
                         p_dtype, mu_dtype, nu_dtype);
}

const char* fdt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
