// Shared helpers for the hand-written Hopper kernels of mosstts_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mosstts {

// Same constant as the JAX package (ops/attention.py NEG_INF): a finite
// floor, so a query row with no unmasked key gives a uniform average, as the
// reference does, instead of NaN.
constexpr float kNegInf = -1e30f;

// dtype codes passed by the Python wrappers
constexpr int kBF16 = 0;
constexpr int kF32 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with pred false, 16 zero bytes
// (src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
// 16 bytes global -> shared, asynchronously, unconditionally
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raises `kern`'s dynamic shared memory limit to `bytes` (a launch over
// 48 KB needs it) once per device; `done` is the caller's record, one per
// kernel instantiation, of the devices already set.
template <typename Kernel>
inline cudaError_t set_smem_limit_once(Kernel kern, int bytes, unsigned& done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 32 && ((done >> dev) & 1u)) return cudaSuccess;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 32) done |= 1u << dev;
    return err;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

}  // namespace mosstts
