// Split-KV single-token decode attention, shared by the five decode kernels
// of mosstts_tpu_torch: one template over the query type (bf16 or f32), the
// cache's value type (the query type, or int8 with one scale per slot and KV
// head, the scales f32 or, for decode_attention_q8t, bf16) and the cache's
// addressing (the layer-stacked linear cache (L, B, KV, S, hd), or a page
// pool (L, NP, KV, P, hd) read through a (B, MP) int32 page table).
// decode_attn.cu instantiates the linear forms, paged_attn.cu the paged
// ones; each has its own C entry point.
//
// What bounds it on the H100: bytes streamed from the cache. Each step reads
// attend_len * hd K and V values per (row, KV head) and does ~2 flops per
// value read, far below the card's ~295 flops/byte balance point. The walk
// over the slots is split across blocks so enough loads are in flight.
//
// Design: one launch, no scratch in device memory.
// - The blocks of one (KV head, batch row) form a thread-block cluster of
//   `cluster` <= 8 blocks (cudaLaunchKernelEx with a cluster-dimension
//   attribute; grid (cluster, KV, B)). Block rank r walks the contiguous
//   logical slots [r * chunk, min((r + 1) * chunk, attend_len)). The
//   wrapper picks cluster and chunk (ops/kernels/decode_attn.py
//   decode_plan): chunk a whole number of tiles, the cluster as large as
//   fills the card, and no rank without a slot. A rank with none would
//   still reach both cluster barriers.
// - Each block takes the G query heads that share its KV head, so each cache
//   row is read once for all G of them. The layer is addressed as
//   base + layer * stride0: no slice and no cast of the cache.
// - The block's slots stream through a shared-memory ring of STAGES = 2
//   tiles, each STAGE_BYTES of K rows and as many of V (32 KB of dynamic
//   shared memory): 16-byte cp.async copies, tile t + 1 in flight while
//   tile t computes. Each tile's validity bytes and int8 scales go to
//   registers as it is issued and to shared memory when its turn comes, so
//   no thread waits on them. (A four-tile ring measured slower: 64 KB a
//   block leaves fewer blocks, and so fewer warps, on an SM; PERF.md §6.)
// - The math reads the tile from shared memory: a slot's row of hd values
//   is split over LPS lanes of 8 values each (16 lanes at hd=128, so a
//   warp step covers 2 slots). Each warp takes U steps of consecutive slots
//   of the tile. The MAX_GROUP = 4 partial dots of a lane are summed over
//   the slot's lanes by a butterfly that halves the heads each lane carries
//   at its first two steps (5 shuffles at hd=128, not 16), which leaves
//   each lane one head's score: the lane keeps that head's running max and
//   denominator, takes exp2 once per slot, and fetches the other heads'
//   probabilities by shuffle for its accumulators. The kernel is bound by
//   instruction issue, not bytes, at the main path's shapes (PERF.md §6),
//   so the math is cut to the fewest instructions per slot. Scores are in
//   log2 units (scale * log2(e) folded into the query scale).
// - A paged slot s of row b is read at pool page table[b, s / P], in-page
//   offset s % P: the table is read here from device memory, with no gather
//   into a linear buffer. For an int8 cache the K scale multiplies the score
//   and the V scale the probability before the P.V accumulation, so the
//   values are never dequantized in memory.
// - Merge: the warps of a block merge their records through shared memory
//   into one block record (max, denominator, acc[G][hd]) in the block's own
//   shared memory. After cluster.sync() every rank reads all ranks' records
//   through distributed shared memory (cluster.map_shared_rank) in rank
//   order 0, 1, ... and writes its share of the G * hd normalised outputs;
//   a second cluster.sync() keeps each block's shared memory alive until its
//   peers have read it. The order is fixed, so a call repeats bit for bit,
//   and nothing outlives the launch, so CUDA-graph replays are safe.
// Causality rides kv_valid alone, over logical slots, as in the JAX kernels;
// an invalid slot scores -1e30, so a row with no valid slot averages its
// slots as the plain versions do. Slots at or past attend_len are skipped
// (score -inf, weight 0). Everything is f32 inside (the TPU kernels round q
// and p to bf16 for the MXU; this one does not). The TPU kernels'
// block-diagonal all-heads dot and their 256-slot tiles were MXU choices and
// are not carried over.
#pragma once

#include <cooperative_groups.h>

#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace mosstts {
namespace decode {

namespace cg = cooperative_groups;

constexpr int NW = 4;             // warps per block
constexpr int STAGE_BYTES = 8192;  // K (and as many V) bytes of one tile of the ring
constexpr int STAGES = 2;          // tiles of the ring
// dynamic shared memory; with the static arrays under the 48 KB a launch
// gets without raising its limit
constexpr int RING_BYTES = STAGES * 2 * STAGE_BYTES;
constexpr int MAX_CLUSTER = 8;  // blocks per (row, KV head): the portable cluster size
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
    void* out;              // (B, H, hd), the query type
    int layer, H, KV, attend_len, page_size;
    int chunk;              // logical slots per block, a multiple of Tiling::TS
    int cluster;            // blocks per (row, KV head); chunk * cluster >= attend_len
    long long q_sb, q_sh;
    long long c_sl, c_sb, c_sh, c_ss;
    long long s_sl, s_sb, s_sh, s_ss;
    long long valid_sb, table_sb, o_sb, o_sh;
    float scale;
};

// A tile is TS slots whose K rows fill STAGE_BYTES; each row is CPR 16-byte
// copies. In the math a lane holds EPL = 8 values of a row, LPS lanes a
// slot, SPI slots a warp step; a warp takes U steps of a tile.
template <typename TC, int HD> struct Tiling {
    static constexpr int ROW_BYTES = HD * static_cast<int>(sizeof(TC));
    static constexpr int TS = STAGE_BYTES / ROW_BYTES;
    static constexpr int CPR = ROW_BYTES / 16;
    static constexpr int EPL = 8;
    static constexpr int LPS = HD / EPL < 32 ? HD / EPL : 32;
    static constexpr int SPI = 32 / LPS;
    static constexpr int U = TS / (NW * SPI);
    static_assert(U >= 1 && HD / EPL <= 32, "tile too small for the warps");
    static_assert(TS <= NW * 32, "one thread per slot of a tile loads its validity");
};

template <int BYTES> struct VecOf;
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<32> { using type = uint4; };

// 8 values of type T at shared address p (aligned to their size) as f32
template <typename T>
__device__ __forceinline__ void load8(const unsigned char* p, float (&out)[8]) {
    constexpr int BYTES = 8 * static_cast<int>(sizeof(T));
    using V = typename VecOf<BYTES>::type;
    constexpr int NV = BYTES / static_cast<int>(sizeof(V));
    V raw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) raw[i] = reinterpret_cast<const V*>(p)[i];
    T t[8];
    memcpy(t, raw, BYTES);  // a register move once compiled
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = to_f(t[e]);
}

template <typename TQ, typename TC, typename TS, int HD, bool PAGED>
__global__ void __launch_bounds__(NW * 32) decode_kernel(const Args a) {
    using TL = Tiling<TC, HD>;
    constexpr int TSL = TL::TS, CPR = TL::CPR, ROW = TL::ROW_BYTES, EPL = TL::EPL,
                  LPS = TL::LPS, SPI = TL::SPI, U = TL::U;
    constexpr bool SCALED = std::is_same<TC, int8_t>::value;
    // score of a slot past the block's range: exp(kSkip - m) == 0 for any finite m
    const float kSkip = __int_as_float(0xff800000);
    extern __shared__ __align__(16) unsigned char ring[];  // [STAGES][K, V][STAGE_BYTES]
    __shared__ float s_ks[STAGES][TSL], s_vs[STAGES][TSL];
    __shared__ uint8_t s_ok[STAGES][TSL];
    __shared__ float s_m[NW][MAX_GROUP], s_l[NW][MAX_GROUP];
    __shared__ float rec_m[MAX_GROUP], rec_l[MAX_GROUP];  // the block record its peers read
    __shared__ float rec_acc[MAX_GROUP][HD];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int G = a.H / a.KV;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane / LPS;  // which of the SPI slots of a warp step
    const int sub = lane % LPS;  // which EPL values of the row
    const TC* kc = static_cast<const TC*>(a.k);
    const TC* vc = static_cast<const TC*>(a.v);
    const uint8_t* vrow = a.valid + b * a.valid_sb;
    const int c0 = rank * a.chunk;
    const int c1 = min(a.attend_len, c0 + a.chunk);
    const int n_tiles = c1 > c0 ? (c1 - c0 + TSL - 1) / TSL : 0;

    // the queries first: their loads fly while the tiles are issued
    const TQ* q = static_cast<const TQ*>(a.q);
    float qr[MAX_GROUP][EPL];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
            qr[g][e] = g < G ? to_f(q[b * a.q_sb + (kvh * G + g) * a.q_sh + sub * EPL + e])
                             : 0.f;

    // element offsets of logical slot s's K/V row and of its scale
    auto row_of = [&](int s, long long& row, long long& srow) {
        if constexpr (PAGED) {
            const long long pg = a.table[b * a.table_sb + s / a.page_size];
            const int off = s % a.page_size;
            row = a.layer * a.c_sl + pg * a.c_sb + kvh * a.c_sh + off * a.c_ss;
            srow = a.layer * a.s_sl + pg * a.s_sb + kvh * a.s_sh + off * a.s_ss;
        } else {
            row = a.layer * a.c_sl + b * a.c_sb + kvh * a.c_sh + s * a.c_ss;
            srow = a.layer * a.s_sl + b * a.s_sb + kvh * a.s_sh + s * a.s_ss;
        }
    };
    // Tile t of the block's slots into ring stage k: K/V rows by cp.async;
    // thread j < TS loads slot j's validity and scales into its registers
    // (pending[k]), published to shared memory when the tile's turn comes,
    // STAGES - 1 tiles later, so no thread waits on them here.
    uint8_t pend_ok[STAGES];
    float pend_ks[STAGES], pend_vs[STAGES];
    auto issue = [&](int t, int k) {
        const int s0 = c0 + t * TSL;
        unsigned char* stage = ring + k * 2 * STAGE_BYTES;
        for (int i = tid; i < TSL * CPR; i += NW * 32) {
            const int j = i / CPR, c = i % CPR, s = s0 + j;
            const bool in = s < c1;
            long long row, srow;
            row_of(in ? s : c0, row, srow);
            cp_async16(smem_u32(stage + j * ROW + c * 16),
                       reinterpret_cast<const unsigned char*>(kc + row) + c * 16, in);
            cp_async16(smem_u32(stage + STAGE_BYTES + j * ROW + c * 16),
                       reinterpret_cast<const unsigned char*>(vc + row) + c * 16, in);
        }
        if (tid < TSL) {
            const int s = s0 + tid;
            const bool in = s < c1;
            pend_ok[k] = in ? vrow[s] : 0;
            if constexpr (SCALED) {
                long long row, srow;
                row_of(in ? s : c0, row, srow);
                pend_ks[k] = to_f(static_cast<const TS*>(a.k_scale)[srow]);
                pend_vs[k] = to_f(static_cast<const TS*>(a.v_scale)[srow]);
            }
        }
    };

#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
        if (k < n_tiles) issue(k, k);
        cp_async_commit();
    }

    // This lane's head: the butterfly below leaves head 2 * hA + hB's score
    // in the lanes whose bits LPS/2 and LPS/4 of `sub` are hA and hB. The
    // lane keeps that head's running max and denominator, and the
    // accumulators of all heads for its EPL values.
    const bool hA = sub & (LPS / 2), hB = sub & (LPS / 4);
    const int my_head = 2 * hA + hB;
    const int head_base = lane & ~(LPS / 2 | LPS / 4);  // lane of head 0, same slot
    float m = kNegInf, l = 0.f, acc[MAX_GROUP][EPL];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    // the value x of head g's lane of this slot
    auto from_head = [&](float x, int g) {
        return __shfl_sync(0xffffffffu, x, head_base | (g >> 1) * (LPS / 2) | (g & 1) * (LPS / 4));
    };
    const float qscale = a.scale * 1.4426950408889634f;  // scores in log2 units

    // tile t lives in stage t % STAGES; the walk is unrolled by STAGES so
    // that every stage (and pending register) index is a constant
    for (int t0 = 0; t0 < n_tiles; t0 += STAGES) {
#pragma unroll
        for (int k = 0; k < STAGES; ++k) {
            const int t = t0 + k;
            if (t >= n_tiles) break;
            if (tid < TSL) {
                s_ok[k][tid] = pend_ok[k];
                if constexpr (SCALED) {
                    s_ks[k][tid] = pend_ks[k];
                    s_vs[k][tid] = pend_vs[k];
                }
            }
            if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1, (k + STAGES - 1) % STAGES);
            cp_async_commit();
            cp_async_wait<STAGES - 1>();  // tile t has landed
            __syncthreads();
            const unsigned char* tk = ring + k * 2 * STAGE_BYTES;
            const unsigned char* tv = tk + STAGE_BYTES;
            const int s0 = c0 + t * TSL;
            // the warp's U * SPI consecutive slots of the tile: each lane's
            // MAX_GROUP partial dots are summed over the slot's LPS lanes by
            // a butterfly that halves the heads a lane carries at the first
            // two steps (2 + 1 + log2(LPS / 4) shuffles for all heads, not
            // MAX_GROUP * log2(LPS))
            float sc[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = (warp * U + u) * SPI + grp;
                float kx[EPL];
                load8<TC>(tk + j * ROW + sub * EPL * static_cast<int>(sizeof(TC)), kx);
                float d[MAX_GROUP];
#pragma unroll
                for (int g = 0; g < MAX_GROUP; ++g) {
                    float d0 = 0.f, d1 = 0.f;
#pragma unroll
                    for (int e = 0; e < EPL; e += 2) {
                        d0 += qr[g][e] * kx[e];
                        d1 += qr[g][e + 1] * kx[e + 1];
                    }
                    d[g] = d0 + d1;
                }
                float k0 = hA ? d[2] : d[0], k1 = hA ? d[3] : d[1];
                k0 += __shfl_xor_sync(0xffffffffu, hA ? d[0] : d[2], LPS / 2);
                k1 += __shfl_xor_sync(0xffffffffu, hA ? d[1] : d[3], LPS / 2);
                float x = (hB ? k1 : k0) + __shfl_xor_sync(0xffffffffu, hB ? k0 : k1, LPS / 4);
#pragma unroll
                for (int o = LPS / 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
                const float ksc = (SCALED ? s_ks[k][j] : 1.f) * qscale;
                sc[u] = s0 + j >= c1 ? kSkip : s_ok[k][j] ? x * ksc : kNegInf;
            }
            // one max for the lane's head over the warp's slots, one rescale
            float mx = m;
#pragma unroll
            for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u]);
#pragma unroll
            for (int o = LPS; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float alpha = exp2f(m - mx);
            m = mx;
            l *= alpha;
#pragma unroll
            for (int g = 0; g < MAX_GROUP; ++g) {
                const float ag = from_head(alpha, g);
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[g][e] *= ag;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = (warp * U + u) * SPI + grp;
                float vx[EPL];
                load8<TC>(tv + j * ROW + sub * EPL * static_cast<int>(sizeof(TC)), vx);
                const float p = exp2f(sc[u] - m);
                l += p;
                const float pv = p * (SCALED ? s_vs[k][j] : 1.f);
#pragma unroll
                for (int g = 0; g < MAX_GROUP; ++g) {
                    const float pg = from_head(pv, g);
#pragma unroll
                    for (int e = 0; e < EPL; ++e) acc[g][e] += pg * vx[e];
                }
            }
            __syncthreads();  // the stage is free for tile t + STAGES
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the warp's lane groups share m; sum their denominators and accumulators
    // into the warps' records, which reuse the ring
    float(*s_acc)[MAX_GROUP][HD] = reinterpret_cast<float(*)[MAX_GROUP][HD]>(ring);
    static_assert(sizeof(float) * NW * MAX_GROUP * HD <= RING_BYTES, "records exceed the ring");
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (grp == 0) {
        if (sub % (LPS / 4) == 0 && my_head < G) {
            s_m[warp][my_head] = m;
            s_l[warp][my_head] = l;
        }
#pragma unroll
        for (int g = 0; g < MAX_GROUP; ++g)
            if (g < G)
#pragma unroll
                for (int e = 0; e < EPL; ++e) s_acc[warp][g][sub * EPL + e] = acc[g][e];
    }
    __syncthreads();

    // the block record per query head: [max, denominator, acc[HD]]
    for (int i = tid; i < G * HD; i += NW * 32) {
        const int g = i / HD, d = i % HD;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float c = exp2f(s_m[w][g] - mx);
            den += s_l[w][g] * c;
            num += s_acc[w][g][d] * c;
        }
        rec_acc[g][d] = num;
        if (d == 0) {
            rec_m[g] = mx;
            rec_l[g] = den;
        }
    }
    cluster.sync();  // every record written and visible cluster-wide

    // rank r writes outputs r * NW * 32 + tid, stepping over the cluster
    const int n_ranks = a.cluster;
    TQ* out = static_cast<TQ*>(a.out);
    for (int i = rank * NW * 32 + tid; i < G * HD; i += n_ranks * NW * 32) {
        const int g = i / HD, d = i % HD;
        // all remote reads first, so their latencies overlap
        float rm[MAX_CLUSTER], rl[MAX_CLUSTER], ra[MAX_CLUSTER];
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r) {
            if (r < n_ranks) {
                rm[r] = cluster.map_shared_rank(rec_m, r)[g];
                rl[r] = cluster.map_shared_rank(rec_l, r)[g];
                ra[r] = cluster.map_shared_rank(&rec_acc[0][0], r)[g * HD + d];
            }
        }
        float mx = kNegInf;
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
            if (r < n_ranks) mx = fmaxf(mx, rm[r]);
        float den = 0.f, num = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r) {
            if (r < n_ranks) {
                const float w = exp2f(rm[r] - mx);
                den += rl[r] * w;
                num += ra[r] * w;
            }
        }
        out[b * a.o_sb + (kvh * G + g) * a.o_sh + d] = from_f<TQ>(num / fmaxf(den, 1e-30f));
    }
    cluster.sync();  // peers may still be reading this block's record
}

template <typename TQ, typename TC, typename TS, int HD, bool PAGED>
int launch(const Args& a, int B, cudaStream_t stream) {
    // the wrapper's plan (decode_plan) copies STAGE_BYTES; a chunk that is
    // not a whole number of tiles means the two copies drifted
    if (a.cluster < 1 || a.cluster > MAX_CLUSTER || a.chunk < 1 ||
        a.chunk % Tiling<TC, HD>::TS != 0 ||
        static_cast<long long>(a.chunk) * a.cluster < a.attend_len)
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.cluster, a.KV, B);
    cfg.blockDim = dim3(NW * 32);
    cfg.dynamicSmemBytes = RING_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<TQ, TC, TS, HD, PAGED>, a);
    if (err != cudaSuccess) return (int)err;
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
