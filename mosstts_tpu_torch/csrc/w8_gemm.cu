// Int8-weight GEMMs on the tensor cores, three modes over one tile loop:
//
//   W8A16  out[m, h*N + n] = (sum_k x[m, k] * q[h, k, n]) * w_scale[h, n]
//          x bf16, q int8 (converted to bf16 exactly, |q| <= 127), f32
//          accumulation (mma.sync m16n8k16 bf16), output bf16 or f32. One
//          launch covers `count` stacked weights (the Delay audio heads) with
//          a shared x; count = 1 is a dense layer, read at a layer's offset of
//          the (L, K, N) stack.
//   W8A8   x is first quantized per row (absmax / 127, floored at 1e-8,
//          round half to even, clip +-127) by quant_rows_kernel; then an
//          int32-accumulated int8 x int8 product (mma.sync m16n8k32 s8),
//          out = f32(acc) * x_scale[m] * w_scale[n].
//   INT4   q packed two 4-bit two's-complement values per byte, (K, N) with
//          K = D/2: the low nibble is W[k], the high nibble W[k + D/2];
//          out = x[:, :D/2] @ lo + x[:, D/2:] @ hi in f32, no scale.
//
// Replaces: tools/tune_mm8.py::mm8 (_kernel_dmajor) and ::mm8_omajor
// (_kernel_omajor), which compute the W8A16 function over layer-stacked
// (L, D, O) weights, and ::mm8_w8a8 (_kernel_w8a8); tools/probe_int4.py::
// mm8_pallas (_mm8_kernel, W8A16 with no scale) and ::mm4_pallas
// (_mm4_kernel). The serving path's int8 dense layers and heads
// (mosstts_tpu/ops/basic.py::dense, models/delay.py::_audio_head_logits on a
// QuantWeight) compute the W8A16 function; XLA left them to its int8 dot.
//
// What bounds it on the H100: at decode (M = 1-16 rows) the weight bytes,
// ~1 flop per byte read, far under the card's ~295 flops/byte balance; at
// prefill (M = B*T in the hundreds) the tensor-core rate. Design:
// - A block owns BN = 128 output columns (4 warps x 32) and BM = 16 rows
//   (MT = 1, decode) or 64 (MT = 4, prefill; the B fragments built once
//   serve all four 16-row tiles). M is padded to the tile with zero rows.
// - The weight tile (BK = 64 rows x 128 bytes) is read with 16-byte loads
//   along N where N % 16 == 0 (every backbone and text-head weight), else
//   byte loads (the 1025-wide audio heads), staged in registers one tile
//   ahead of the math and stored to a double-buffered shared tile whose
//   rows are padded by 16 bytes, so the fragment reads of rows 2 apart fall
//   in different banks. int8 -> bf16 happens while the B fragments are
//   built, so the weights are read from device memory once, as int8.
// - Small M: K is split across blockIdx.y so enough blocks stream the
//   weights on 132 SMs. Each split writes its partial tile (f32, or int32
//   for W8A8) and reduce_kernel sums the splits in a fixed order, so a
//   greedy decode is the same from run to run (no atomics). With one split
//   the scale epilogue runs in the main kernel.
// - The per-column scale (and W8A8's per-row scale) is applied to the f32
//   sum, and the output rounded once.
// The TPU kernels' (td, to) VMEM tiles and their sequential-grid f32
// accumulator are MXU/VMEM choices and are not carried over.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mosstts {
namespace w8 {

constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // weight rows per k tile
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int W_LD = BN + 16;    // bytes per shared weight row
constexpr int XB_LD = BK + 8;    // bf16 per shared activation row
constexpr int X8_LD = BK + 16;   // bytes per shared int8 activation row

enum Mode { W8A16 = 0, W8A8 = 1, INT4 = 2 };

// Launch arguments, filled by ops/kernels/w8_gemm.py (GemmArgs) field for
// field. Strides in elements.
struct Args {
    const void* x;          // (M, >= K) rows: bf16 (W8A16, INT4) or int8 (W8A8)
    const int8_t* w;        // (count, K, N) int8, rows of N, weights w_sh apart
    const float* w_scale;   // (count, N) f32, or null (INT4)
    const float* x_scale;   // (M,) f32 (W8A8), else null
    void* out;              // (M, count * N) rows ldo apart, bf16 or f32
    void* part;             // split-K partials: splits x M x count*N, f32 (int32 for W8A8)
    int M, K, N, count;
    int x_hi;               // INT4: column of x where its second half starts; else 0
    int splits, k_per_split;  // K rows per split: a multiple of BK
    int out_f32;            // 1: f32 output; 0: bf16
    long long ldx, w_sh, ldo;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float nib_lo(int8_t p) {  // sign-extended low nibble
    return static_cast<float>(((p & 15) ^ 8) - 8);
}

__device__ __forceinline__ float nib_hi(int8_t p) {  // sign-extended high nibble
    return static_cast<float>((((p >> 4) & 15) ^ 8) - 8);
}

__device__ __forceinline__ uint32_t pack_s8(int8_t b0, int8_t b1, int8_t b2, int8_t b3) {
    return static_cast<uint32_t>(static_cast<uint8_t>(b0))
           | (static_cast<uint32_t>(static_cast<uint8_t>(b1)) << 8)
           | (static_cast<uint32_t>(static_cast<uint8_t>(b2)) << 16)
           | (static_cast<uint32_t>(static_cast<uint8_t>(b3)) << 24);
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE, int MT>
struct Tile {
    static constexpr int BM = 16 * MT;
    static constexpr bool A8 = MODE == W8A8;
    static constexpr int NX = MODE == INT4 ? 2 : 1;  // activation tiles per k tile
    static constexpr int X_BYTES = A8 ? BM * X8_LD : BM * XB_LD * 2;
    static constexpr int W_BYTES = BK * W_LD;
    static constexpr int STAGE = W_BYTES + NX * X_BYTES;
    static constexpr int SMEM = 2 * STAGE;
    // 16-byte activation chunks per tile and per thread
    static constexpr int X_CHUNKS = A8 ? BM * BK / 16 : BM * BK / 8;
    static constexpr int X_PER_THREAD = (X_CHUNKS + THREADS - 1) / THREADS;
    static constexpr int X_ROW_CHUNKS = A8 ? BK / 16 : BK / 8;
};

__device__ __forceinline__ float finish(float v, const Args& a, int row, long long c) {
    if (a.x_scale) v *= a.x_scale[row];
    if (a.w_scale) v *= a.w_scale[c];
    return v;
}

__device__ __forceinline__ void store_out(const Args& a, int row, long long c, float v) {
    const long long o = row * a.ldo + c;
    if (a.out_f32)
        static_cast<float*>(a.out)[o] = v;
    else
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
}

template <int MODE, int MT, int VEC>
__global__ void __launch_bounds__(THREADS) gemm_kernel(const Args a) {
    using T = Tile<MODE, MT>;
    using Acc = std::conditional_t<T::A8, int, float>;
    extern __shared__ __align__(16) unsigned char smem[];

    const int nblk = (a.N + BN - 1) / BN;
    const int head = blockIdx.x / nblk;
    const int n0 = (blockIdx.x % nblk) * BN;
    const int split = blockIdx.y;
    const int m0 = blockIdx.z * T::BM;
    const int k_begin = split * a.k_per_split;
    const int k_end = min(a.K, k_begin + a.k_per_split);
    const int n_tiles = (k_end - k_begin + BK - 1) / BK;
    const int8_t* w = a.w + head * a.w_sh;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int group = lane >> 2, tig = lane & 3;

    // registers holding the next tile on its way to shared memory
    uint4 wreg[4];        // VEC == 16: 4 chunks of 16 bytes
    uint32_t wbyte[16];   // VEC == 1: 16 words of 4 bytes
    uint4 xreg[T::NX][T::X_PER_THREAD];

    auto load_tile = [&](int k0) {
        if constexpr (VEC == 16) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = tid + THREADS * j, r = i >> 3, c = (i & 7) * 16;
                wreg[j] = make_uint4(0, 0, 0, 0);
                if (k0 + r < k_end && n0 + c < a.N)
                    wreg[j] = *reinterpret_cast<const uint4*>(
                        w + (long long)(k0 + r) * a.N + n0 + c);
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int i = tid + THREADS * j, r = i >> 5, c = (i & 31) * 4;
                int8_t b[4] = {0, 0, 0, 0};
                if (k0 + r < k_end) {
                    const int8_t* src = w + (long long)(k0 + r) * a.N + n0 + c;
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (n0 + c + e < a.N) b[e] = src[e];
                }
                wbyte[j] = pack_s8(b[0], b[1], b[2], b[3]);
            }
        }
#pragma unroll
        for (int h = 0; h < T::NX; ++h)
#pragma unroll
            for (int j = 0; j < T::X_PER_THREAD; ++j) {
                const int i = tid + THREADS * j;
                const int r = i / T::X_ROW_CHUNKS, cc = i % T::X_ROW_CHUNKS;
                xreg[h][j] = make_uint4(0, 0, 0, 0);
                if (i < T::X_CHUNKS && m0 + r < a.M) {
                    if constexpr (T::A8) {
                        const int k = k0 + cc * 16;
                        if (k < k_end)
                            xreg[h][j] = *reinterpret_cast<const uint4*>(
                                static_cast<const int8_t*>(a.x) + (m0 + r) * a.ldx + k);
                    } else {
                        const int k = k0 + cc * 8;
                        if (k < k_end)
                            xreg[h][j] = *reinterpret_cast<const uint4*>(
                                static_cast<const __nv_bfloat16*>(a.x) + (m0 + r) * a.ldx +
                                (h ? a.x_hi : 0) + k);
                    }
                }
            }
    };

    auto store_tile = [&](unsigned char* st) {
        if constexpr (VEC == 16) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = tid + THREADS * j, r = i >> 3, c = (i & 7) * 16;
                *reinterpret_cast<uint4*>(st + r * W_LD + c) = wreg[j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int i = tid + THREADS * j, r = i >> 5, c = (i & 31) * 4;
                *reinterpret_cast<uint32_t*>(st + r * W_LD + c) = wbyte[j];
            }
        }
#pragma unroll
        for (int h = 0; h < T::NX; ++h) {
            unsigned char* sx = st + T::W_BYTES + h * T::X_BYTES;
#pragma unroll
            for (int j = 0; j < T::X_PER_THREAD; ++j) {
                const int i = tid + THREADS * j;
                if (i >= T::X_CHUNKS) continue;
                const int r = i / T::X_ROW_CHUNKS, cc = i % T::X_ROW_CHUNKS;
                if constexpr (T::A8)
                    *reinterpret_cast<uint4*>(sx + r * X8_LD + cc * 16) = xreg[h][j];
                else
                    *reinterpret_cast<uint4*>(sx + (r * XB_LD + cc * 8) * 2) = xreg[h][j];
            }
        }
    };

    Acc acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

    if (n_tiles > 0) load_tile(k_begin);
    for (int t = 0; t < n_tiles; ++t) {
        unsigned char* st = smem + (t & 1) * T::STAGE;
        store_tile(st);
        __syncthreads();
        if (t + 1 < n_tiles) load_tile(k_begin + (t + 1) * BK);

        const int8_t* sw = reinterpret_cast<const int8_t*>(st);
        if constexpr (T::A8) {
            const unsigned char* sx = st + T::W_BYTES;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 32) {
                uint32_t af[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const unsigned char* p = sx + (mt * 16 + group) * X8_LD + kk + tig * 4;
                    af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
                    af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * X8_LD);
                    af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                    af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * X8_LD + 16);
                }
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int8_t* p = sw + (kk + tig * 4) * W_LD + warp * 32 + nt * 8 + group;
                    const uint32_t b0 = pack_s8(p[0], p[W_LD], p[2 * W_LD], p[3 * W_LD]);
                    const uint32_t b1 =
                        pack_s8(p[16 * W_LD], p[17 * W_LD], p[18 * W_LD], p[19 * W_LD]);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
                }
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                uint32_t af[T::NX][MT][4];
#pragma unroll
                for (int h = 0; h < T::NX; ++h)
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        const __nv_bfloat16* p =
                            reinterpret_cast<const __nv_bfloat16*>(st + T::W_BYTES +
                                                                   h * T::X_BYTES) +
                            (mt * 16 + group) * XB_LD + kk + tig * 2;
                        af[h][mt][0] = *reinterpret_cast<const uint32_t*>(p);
                        af[h][mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * XB_LD);
                        af[h][mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
                        af[h][mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * XB_LD + 8);
                    }
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int8_t* p = sw + (kk + tig * 2) * W_LD + warp * 32 + nt * 8 + group;
                    const int8_t w0 = p[0], w1 = p[W_LD], w2 = p[8 * W_LD], w3 = p[9 * W_LD];
                    if constexpr (MODE == INT4) {
                        const uint32_t l0 = pack_bf16(nib_lo(w0), nib_lo(w1));
                        const uint32_t l1 = pack_bf16(nib_lo(w2), nib_lo(w3));
                        const uint32_t h0 = pack_bf16(nib_hi(w0), nib_hi(w1));
                        const uint32_t h1 = pack_bf16(nib_hi(w2), nib_hi(w3));
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) {
                            mma_bf16(acc[mt][nt], af[0][mt], l0, l1);
                            mma_bf16(acc[mt][nt], af[1][mt], h0, h1);
                        }
                    } else {
                        const uint32_t b0 = pack_bf16(static_cast<float>(w0), static_cast<float>(w1));
                        const uint32_t b1 = pack_bf16(static_cast<float>(w2), static_cast<float>(w3));
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[0][mt], b0, b1);
                    }
                }
            }
        }
    }

    // C fragment: rows group and group + 8, columns tig * 2 and + 1
    const long long NC = (long long)a.count * a.N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = m0 + mt * 16 + group + (r >= 2 ? 8 : 0);
                const int col = n0 + warp * 32 + nt * 8 + tig * 2 + (r & 1);
                if (row >= a.M || col >= a.N) continue;
                const long long c = (long long)head * a.N + col;
                if (a.splits == 1) {
                    store_out(a, row, c, finish(static_cast<float>(acc[mt][nt][r]), a, row, c));
                } else {
                    const long long o = ((long long)split * a.M + row) * NC + c;
                    static_cast<Acc*>(a.part)[o] = acc[mt][nt][r];
                }
            }
}

// Sum of the splits' partials, in split order, then the scale epilogue.
template <bool I32>
__global__ void __launch_bounds__(256) reduce_kernel(const Args a) {
    const long long NC = (long long)a.count * a.N;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= a.M * NC) return;
    const int row = static_cast<int>(idx / NC);
    const long long c = idx % NC;
    float v;
    if constexpr (I32) {
        int s = 0;
        for (int sp = 0; sp < a.splits; ++sp)
            s += static_cast<const int*>(a.part)[((long long)sp * a.M + row) * NC + c];
        v = static_cast<float>(s);
    } else {
        float s = 0.f;
        for (int sp = 0; sp < a.splits; ++sp)
            s += static_cast<const float*>(a.part)[((long long)sp * a.M + row) * NC + c];
        v = s;
    }
    store_out(a, row, c, finish(v, a, row, c));
}

// W8A8's activation pass: one block per row.
__global__ void __launch_bounds__(256) quant_rows_kernel(const __nv_bfloat16* x, long long ldx,
                                                         int K, int8_t* x8, float* xs) {
    __shared__ float s_max[8];
    const int row = blockIdx.x;
    const __nv_bfloat16* xr = x + row * ldx;
    float m = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(__bfloat162float(xr[k])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, s_max[w]);
    const float s = fmaxf(m, 1e-8f) / 127.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const float v = rintf(__bfloat162float(xr[k]) / s);  // half to even
        x8[(long long)row * K + k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
    }
    if (threadIdx.x == 0) xs[row] = s;
}

template <int MODE, int MT, int VEC>
int launch_mt(const Args& a, cudaStream_t st) {
    using T = Tile<MODE, MT>;
    auto kern = gemm_kernel<MODE, MT, VEC>;
    if constexpr (T::SMEM > 48 * 1024) {
        static bool attr_set = false;  // once per instantiation
        if (!attr_set) {
            cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 T::SMEM);
            if (e != cudaSuccess) return (int)e;
            attr_set = true;
        }
    }
    const int nblk = (a.N + BN - 1) / BN;
    const dim3 grid(a.count * nblk, a.splits, (a.M + T::BM - 1) / T::BM);
    kern<<<grid, THREADS, T::SMEM, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return (int)err;
    const long long total = (long long)a.M * a.count * a.N;
    reduce_kernel<MODE == W8A8><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// Host checks the Python wrapper also makes; a call that breaks them is
// refused rather than read out of bounds.
template <int MODE>
int run(const Args* a, void* stream) {
    if (a->M <= 0 || a->K <= 0 || a->N <= 0 || a->count <= 0 || a->splits <= 0 ||
        a->k_per_split % BK != 0 || (long long)a->splits * a->k_per_split < a->K ||
        a->K % (MODE == W8A8 ? 16 : 8) != 0 || a->ldx % (MODE == W8A8 ? 16 : 8) != 0 ||
        reinterpret_cast<uintptr_t>(a->x) % 16 != 0 || (a->splits > 1 && a->part == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec16 = a->N % 16 == 0 && a->w_sh % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a->w) % 16 == 0;
    if (a->M > 16)
        return vec16 ? launch_mt<MODE, 4, 16>(*a, st) : launch_mt<MODE, 4, 1>(*a, st);
    return vec16 ? launch_mt<MODE, 1, 16>(*a, st) : launch_mt<MODE, 1, 1>(*a, st);
}

}  // namespace w8
}  // namespace mosstts

// C entry points, bound with ctypes (ops/kernels/w8_gemm.py). Each returns
// the cudaGetLastError() after its launches.
extern "C" int mosstts_w8a16_gemm(const mosstts::w8::Args* args, void* stream) {
    return mosstts::w8::run<mosstts::w8::W8A16>(args, stream);
}

extern "C" int mosstts_int4_gemm(const mosstts::w8::Args* args, void* stream) {
    return mosstts::w8::run<mosstts::w8::INT4>(args, stream);
}

// W8A8: ``x_bf16`` (M, K) rows ldx_bf16 apart are quantized into args->x
// (int8 (M, K), contiguous) and args->x_scale (M,), then multiplied.
extern "C" int mosstts_w8a8_gemm(const mosstts::w8::Args* args, const void* x_bf16,
                                 long long ldx_bf16, void* stream) {
    if (args->M <= 0 || args->K <= 0 || args->ldx != args->K || args->x_scale == nullptr)
        return (int)cudaErrorInvalidValue;
    mosstts::w8::quant_rows_kernel<<<args->M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x_bf16), ldx_bf16, args->K,
        static_cast<int8_t*>(const_cast<void*>(args->x)), const_cast<float*>(args->x_scale));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return mosstts::w8::run<mosstts::w8::W8A8>(args, stream);
}
