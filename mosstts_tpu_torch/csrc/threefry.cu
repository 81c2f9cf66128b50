// JAX's threefry2x32 random bits on the card: a row-wise key split and a
// fused Gumbel-max categorical draw, bit for bit as jax.random computes them
// (jax_threefry_partitionable, JAX's default: element j of a draw hashes the
// counter pair (0, j) under the row's key).
//
// Replaces no Pallas kernel. The JAX package keeps its sampling keys in the
// decode state and splits them inside each step (mosstts_tpu/models/delay.py
// split_keys, jax.random.categorical), which XLA compiles; the port had drawn
// from one torch.Generator per row, whose Philox offset the host advances at
// each graph replay, so a loop that the card repeats inside one graph launch
// (engine/step_graph.py DeviceLoop) could not draw fresh noise. Keys in the
// state need these two kernels; the fused draw also replaces B torch.rand
// launches plus the clamp, log, log, subtract and argmax of the plain path.
//
// Bound on the H100: launch latency. A split reads 16 bytes a row and writes
// 16 n; a draw reads each logit once (B x 32 x 25 audio scores, B x 50 text
// scores at the servers' top-k) and hashes it with 20 rounds of 32-bit adds,
// rotates and xors. Design: one thread per output key; one block per row of
// the draw, each thread hashing, noising and reducing its strided share, a
// warp-shuffle then shared-memory argmax keeping the first maximal index
// (torch.argmax's and JAX's tie-break).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTiny = 1.17549435e-38f;  // float32 tiny, JAX's uniform minval

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 of the counter (x0, x1) under the key (k0, k1), 20 rounds
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i & 1][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
}

__global__ void split_kernel(const int64_t* __restrict__ keys, int64_t key_stride,
                             int64_t* __restrict__ out, int B, int n) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * n) return;
    const int b = t / n, i = t % n;
    uint32_t x0 = 0, x1 = static_cast<uint32_t>(i);
    threefry(static_cast<uint32_t>(keys[b * key_stride]),
             static_cast<uint32_t>(keys[b * key_stride + 1]), x0, x1);
    out[2 * t] = x0;
    out[2 * t + 1] = x1;
}

constexpr int kThreads = 128;

// one block per (row b, sub-row m) of logits (B, M, V): the noise of element
// (m, v) hashes the counter m * V + v under keys[b]
__global__ void categorical_kernel(const int64_t* __restrict__ keys, int64_t key_stride,
                                   const float* __restrict__ logits, int64_t* __restrict__ out,
                                   int M, int V) {
    const int row = blockIdx.x, b = row / M, m = row % M;
    const uint32_t k0 = static_cast<uint32_t>(keys[b * key_stride]);
    const uint32_t k1 = static_cast<uint32_t>(keys[b * key_stride + 1]);
    const float* x = logits + static_cast<int64_t>(row) * V;
    float best = -INFINITY;
    int arg = 0x7fffffff;
    for (int v = threadIdx.x; v < V; v += kThreads) {
        uint32_t x0 = 0, x1 = static_cast<uint32_t>(m) * static_cast<uint32_t>(V) + v;
        threefry(k0, k1, x0, x1);
        const uint32_t bits = x0 ^ x1;
        const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
        const float u = fmaxf(kTiny, f + kTiny);  // f * (1 - tiny) + tiny; 1 - tiny == 1
        const float s = -logf(-logf(u)) + x[v];
        if (s > best) {  // v ascends: the first maximal index stays
            best = s;
            arg = v;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
        }
    }
    __shared__ float sb[kThreads / 32];
    __shared__ int sa[kThreads / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        sb[warp] = best;
        sa[warp] = arg;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kThreads / 32; ++w) {
            if (sb[w] > best || (sb[w] == best && sa[w] < arg)) {
                best = sb[w];
                arg = sa[w];
            }
        }
        out[row] = arg == 0x7fffffff ? 0 : arg;
    }
}

}  // namespace

// C entry points, bound with ctypes (ops/kernels/threefry.py). keys (B, 2)
// int64 rows of JAX's uint32 key words, row stride key_stride (elements).
extern "C" int mosstts_threefry_split(const int64_t* keys, int64_t key_stride, int64_t* out,
                                      int B, int n, void* stream) {
    const int total = B * n;
    if (total == 0) return 0;
    split_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, out, B, n);
    return static_cast<int>(cudaGetLastError());
}

// logits (B, M, V) contiguous float32 -> out (B, M) int64
extern "C" int mosstts_threefry_categorical(const int64_t* keys, int64_t key_stride,
                                            const float* logits, int64_t* out, int B, int M,
                                            int V, void* stream) {
    if (B * M == 0) return 0;
    categorical_kernel<<<B * M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        keys, key_stride, logits, out, M, V);
    return static_cast<int>(cudaGetLastError());
}
