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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

}  // namespace mosstts
