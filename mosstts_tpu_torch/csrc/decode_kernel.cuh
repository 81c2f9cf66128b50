// Split-KV single-token decode attention, shared by the five decode kernels
// of mosstts_tpu_torch: one template over the query type (bf16 or f32), the
// cache's value type (the query type, or int8 with one scale per slot and KV
// head, the scales f32 or, for decode_attention_q8t, bf16) and the cache's
// addressing (the layer-stacked linear cache
// (L, B, KV, S, hd), or a page pool (L, NP, KV, P, hd) read through a (B, MP)
// int32 page table). decode_attn.cu instantiates the linear forms,
// paged_attn.cu the paged ones; each has its own C entry point.
//
// What bounds it on the H100: bytes streamed from the cache. Each step reads
// attend_len * hd K and V values per (row, KV head) and does ~2 flops per
// value read, far below the card's ~295 flops/byte balance point. The walk
// over the slots is split across blocks so enough loads are in flight.
//
// Design (two passes):
// 1. partial_kernel: one block per (KV head, batch row, chunk of CHUNK
//    logical slots) takes the G query heads that share that KV head, so each
//    cache row is read once for all G of them. The layer is addressed as
//    base + layer * stride0: no slice and no cast of the cache. Each of the
//    NW warps takes SPW consecutive slots and issues all their loads before
//    any math, then computes all its SPW x G scores (independent warp-shuffle
//    sums) before one max and one exp per score, so no slot waits on the
//    previous slot's softmax rescale. Lane i holds the EPL = hd/32 consecutive elements
//    [i*EPL, (i+1)*EPL) of a row, loaded as one vector (16 bytes at most), so
//    a slot is one coalesced row read (128 B for an int8 row at hd=128) and a
//    score is a warp-shuffle sum. A paged slot s of row b is read at pool page
//    table[b, s / P], in-page offset s % P: the table is read here from
//    device memory, with no gather into a linear buffer. For an int8 cache
//    the K scale multiplies the score and the V scale the probability before
//    the P.V accumulation, so the values are never dequantized in memory.
//    Warps merge their (max, denominator, accumulator) per query head
//    through shared memory; the block writes one such record per head.
// 2. merge_kernel: one block per (KV head, batch row), one thread per output
//    element, rescales the chunks' records to a common max and writes the
//    normalised output.
// Causality rides kv_valid alone, over logical slots, as in the JAX kernels;
// an invalid slot scores -1e30, so a row with no valid slot averages its
// slots as the plain versions do. Slots at or past attend_len are skipped.
// Everything is f32 inside (the TPU kernels round q and p to bf16 for the
// MXU; this one does not). The TPU kernels' block-diagonal all-heads dot and
// their 256-slot tiles were MXU choices and are not carried over.
#pragma once

#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace mosstts {
namespace decode {

constexpr int NW = 4;             // warps per block
constexpr int SPW = 8;            // slots per warp
constexpr int CHUNK = NW * SPW;   // slots per block
// Query heads per KV head the kernels take. Every config of the repo has
// G <= 4 (8B: 32/8; 1.7B: 16/8; codec 12/4); raise it when one needs more.
constexpr int MAX_GROUP = 4;

// Launch arguments, filled by the Python wrappers through a ctypes Structure
// of the same layout (ops/kernels/decode_attn.py DecodeArgs). Strides are in
// elements. For a paged cache the "row" strides step over pool pages and
// the slot strides over in-page offsets.
struct Args {
    const void* q;          // (B, H, hd)
    const void* k;          // values: (L, B, KV, S, hd) or (L, NP, KV, P, hd)
    const void* v;
    const void* k_scale;    // int8 caches: (L, B|NP, KV, S|P) f32 or bf16; else null
    const void* v_scale;
    const uint8_t* valid;   // (B, >= attend_len) bool, logical slots
    const int32_t* table;   // paged: (B, MP) int32; else null
    float* part;            // scratch: B * KV * chunks * G * (hd + 2) f32
    void* out;              // (B, H, hd), the query type
    int layer, H, KV, attend_len, page_size;
    long long q_sb, q_sh;
    long long c_sl, c_sb, c_sh, c_ss;
    long long s_sl, s_sb, s_sh, s_ss;
    long long valid_sb, table_sb, o_sb, o_sh;
    float scale;
};

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// N consecutive values at p (aligned to their total size, or to 16 bytes
// past that) into f32 registers, in vector loads of up to 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[N]) {
    constexpr int BYTES = N * static_cast<int>(sizeof(T));
    constexpr int VB = BYTES < 16 ? BYTES : 16;
    constexpr int NV = BYTES / VB;
    using V = typename VecOf<VB>::type;
    V raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) raw[i] = reinterpret_cast<const V*>(p)[i];
    T t[N];
    memcpy(t, raw, BYTES);  // a register move once compiled
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = to_f(t[e]);
}

template <typename TQ, typename TC, typename TS, int HD, bool PAGED>
__global__ void __launch_bounds__(NW * 32) partial_kernel(const Args a) {
    constexpr int EPL = HD / 32;  // head-dim elements per lane
    constexpr bool SCALED = std::is_same<TC, int8_t>::value;
    __shared__ float s_m[NW][MAX_GROUP];
    __shared__ float s_l[NW][MAX_GROUP];
    __shared__ float s_acc[NW][MAX_GROUP][HD];

    const int kvh = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
    const int KV = gridDim.x, NS = gridDim.z;
    const int G = a.H / KV;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const TQ* q = static_cast<const TQ*>(a.q);
    const TC* kc = static_cast<const TC*>(a.k);
    const TC* vc = static_cast<const TC*>(a.v);

    float qr[MAX_GROUP][EPL];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
            qr[g][e] = g < G ? to_f(q[b * a.q_sb + (kvh * G + g) * a.q_sh + lane * EPL + e]) *
                                   a.scale
                             : 0.f;

    const uint8_t* vrow = a.valid + b * a.valid_sb;
    const int s0 = chunk * CHUNK + warp * SPW;

    // all loads of the warp's slots first (slot 0 stands in past the end)
    float kx[SPW][EPL], vx[SPW][EPL], ksc[SPW], vsc[SPW];
    bool ok[SPW];
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
        const int s = s0 + j < a.attend_len ? s0 + j : 0;
        ok[j] = vrow[s] != 0;
        long long row, srow;  // element offsets of the slot's K/V row and scale
        if constexpr (PAGED) {
            const long long pg = a.table[b * a.table_sb + s / a.page_size];
            const int off = s % a.page_size;
            row = a.layer * a.c_sl + pg * a.c_sb + kvh * a.c_sh + off * a.c_ss;
            srow = a.layer * a.s_sl + pg * a.s_sb + kvh * a.s_sh + off * a.s_ss;
        } else {
            row = a.layer * a.c_sl + b * a.c_sb + kvh * a.c_sh + s * a.c_ss;
            srow = a.layer * a.s_sl + b * a.s_sb + kvh * a.s_sh + s * a.s_ss;
        }
        load_row<TC, EPL>(kc + row + lane * EPL, kx[j]);
        load_row<TC, EPL>(vc + row + lane * EPL, vx[j]);
        if constexpr (SCALED) {
            ksc[j] = to_f(static_cast<const TS*>(a.k_scale)[srow]);
            vsc[j] = to_f(static_cast<const TS*>(a.v_scale)[srow]);
        } else {
            ksc[j] = 1.f;
            vsc[j] = 1.f;
        }
    }

    // all SPW x G scores first (independent warp sums), then one max per
    // query head over the warp's slots: no running rescale per slot
    float sc[SPW][MAX_GROUP];
#pragma unroll
    for (int j = 0; j < SPW; ++j)
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kx[j][e];
            dot = warp_sum(dot);
            sc[j][g] = ok[j] && s0 + j < a.attend_len ? dot * ksc[j] : kNegInf;
        }
    const int n_live = min(SPW, a.attend_len - s0);  // slots of this warp inside attend_len
    float m[MAX_GROUP], l[MAX_GROUP], acc[MAX_GROUP][EPL];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
        m[g] = kNegInf;
#pragma unroll
        for (int j = 0; j < SPW; ++j)
            if (j < n_live) m[g] = fmaxf(m[g], sc[j][g]);
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
#pragma unroll
        for (int j = 0; j < SPW; ++j) {
            if (j < n_live) {
                const float p = expf(sc[j][g] - m[g]);
                const float pv = p * vsc[j];
                l[g] += p;
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[g][e] += pv * vx[j][e];
            }
        }
    }

#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
        if (g < G) {
            if (lane == 0) {
                s_m[warp][g] = m[g];
                s_l[warp][g] = l[g];
            }
#pragma unroll
            for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
        }
    }
    __syncthreads();

    // partial record per query head: [max, denominator, acc[HD]]
    float* out = a.part + (((long long)b * KV + kvh) * NS + chunk) * G * (HD + 2);
    for (int i = threadIdx.x; i < G * HD; i += NW * 32) {
        const int g = i / HD, d = i % HD;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float c = expf(s_m[w][g] - mx);
            den += s_l[w][g] * c;
            num += s_acc[w][g][d] * c;
        }
        out[g * (HD + 2) + 2 + d] = num;
        if (d == 0) {
            out[g * (HD + 2)] = mx;
            out[g * (HD + 2) + 1] = den;
        }
    }
}

// One thread per output element (G * HD <= 1024 threads): each walks the
// chunks' partials of its query head and head-dim element.
template <typename TQ, int HD>
__global__ void __launch_bounds__(MAX_GROUP * HD) merge_kernel(const Args a, int NS) {
    const int kvh = blockIdx.x, b = blockIdx.y, KV = gridDim.x;
    const int G = a.H / KV;
    const int g = threadIdx.x / HD, d = threadIdx.x % HD;
    if (g >= G) return;
    const float* p = a.part + ((long long)b * KV + kvh) * NS * G * (HD + 2);
    float mx = kNegInf;
    for (int c = 0; c < NS; ++c) mx = fmaxf(mx, p[(c * G + g) * (HD + 2)]);
    float den = 0.f, num = 0.f;
    for (int c = 0; c < NS; ++c) {
        const float* r = p + (c * G + g) * (HD + 2);
        const float w = expf(r[0] - mx);
        den += r[1] * w;
        num += r[2 + d] * w;
    }
    TQ* out = static_cast<TQ*>(a.out);
    out[b * a.o_sb + (kvh * G + g) * a.o_sh + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
}

template <typename TQ, typename TC, typename TS, int HD, bool PAGED>
int launch(const Args& a, int B, cudaStream_t stream) {
    const int NS = (a.attend_len + CHUNK - 1) / CHUNK;
    partial_kernel<TQ, TC, TS, HD, PAGED><<<dim3(a.KV, B, NS), NW * 32, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    merge_kernel<TQ, HD><<<dim3(a.KV, B), (a.H / a.KV) * HD, 0, stream>>>(a, NS);
    return (int)cudaGetLastError();
}

// Dispatch on the head dim; the query type TQ, the cache's value type TC
// (TQ itself, or int8_t) and the scale type TS are fixed by the caller.
template <typename TQ, typename TC, typename TS, bool PAGED>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
    if (a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > MAX_GROUP) return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 64: return launch<TQ, TC, TS, 64, PAGED>(a, B, stream);
        case 128: return launch<TQ, TC, TS, 128, PAGED>(a, B, stream);
        case 256: return launch<TQ, TC, TS, 256, PAGED>(a, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// q_dtype is kBF16 or kF32. With QUANT the cache holds int8 values and
// scales of type TS (f32, or bf16 for decode_attention_q8t); otherwise
// values of the query type.
template <bool QUANT, bool PAGED, typename TS = float>
int dispatch(const Args* a, int B, int hd, int q_dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (q_dtype == kBF16)
        return dispatch_hd<__nv_bfloat16, std::conditional_t<QUANT, int8_t, __nv_bfloat16>, TS,
                           PAGED>(*a, B, hd, st);
    if (q_dtype == kF32)
        return dispatch_hd<float, std::conditional_t<QUANT, int8_t, float>, TS, PAGED>(*a, B, hd,
                                                                                       st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace mosstts
