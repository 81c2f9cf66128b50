// Int8-weight GEMMs on the tensor cores:
//
//   W8A16  out[m, h*N + n] = (sum_k x[m, k] * q[h, k, n]) * w_scale[h, n]
//          x bf16, q int8 (converted to bf16 exactly, |q| <= 127), f32
//          accumulation (mma.sync m16n8k16 bf16), output bf16 or f32. One
//          launch covers `count` stacked weights (the Delay audio heads) with
//          a shared x; count = 1 is a dense layer, read at a layer's offset of
//          the (L, K, N) stack. Rows of a weight lie `ldw` bytes apart
//          (>= N; ops/quant.py keeps a stack whose N is not a multiple of 16
//          at the next multiple, so its rows take 16-byte loads too).
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
// What bounds W8A16 on the H100: at decode (M = 1-16 rows, 254 launches per
// 8B step) the weight bytes, ~1 flop per byte read against the card's ~295
// flops/byte balance; at prefill (M in the hundreds) the tensor cores. But
// turning int8 into bf16 fragments costs instructions on every weight byte,
// so a block that streams alone is bound by its warps' latency, not by
// memory (tools/w8a16_plans.py and PERF.md §6 have the measurements). Its
// design (a16_kernel below):
// - Warp-specialized: one producer warp streams the weight tiles (8 KB:
//   BK rows x BN = 64 or 128 bytes) and the x tile (BM rows x BK, bf16) of
//   each stage global -> shared with 16-byte cp.async copies into a ring of
//   STAGES (3-6) slots; each slot's "full" mbarrier completes when its copies
//   land (cp.async.mbarrier.arrive), its "empty" mbarrier when every
//   consumer warp is done with it. Eight consumer warps do only math, with
//   no block-wide barrier in the loop, so one warp's waits overlap the
//   others' work and up to STAGES - 1 tiles of a block are in flight. Rows
//   are padded by 16 bytes so the fragment reads below hit distinct banks.
// - B fragments from word loads: a tile's columns may be permuted if the
//   epilogue maps them back, so each thread reads 4 adjacent columns of each
//   of the 4 rows its fragments take (k 2t, 2t+1, 2t+8, 2t+9) with four
//   32-bit shared loads and uses the 4 columns as its column in 4 n8 tiles;
//   x comes in with ldmatrix. int8 -> bf16 takes a byte permute, two LOP3s
//   and one bf16x2 subtraction per pair of values: q = (128 + (b & 0x7f)) -
//   (128 + (b & 0x80)), exact, no I2F.
// - The split-K sum inside the launch: the `splits` (<= 8) blocks of one
//   column tile form a thread-block cluster (cudaLaunchKernelEx, grid
//   (splits, column blocks, row tiles)); each block leaves its f32 tile in
//   its own shared memory and, after cluster.sync(), rank r reads every
//   rank's tile through distributed shared memory in rank order for its
//   share of the outputs, scales and rounds once. No second launch, no
//   scratch, no atomics: a call repeats bit for bit and replays in a graph.
// - M <= 128 is one row tile (16 * MT rows, MT = 1, 2, 4 or 8), so a
//   prefill of up to 128 rows streams the weights once. The consumer warps
//   split a stage's k steps (their partials summed in warp order at the end)
//   and its column groups, and at MT = 8 its row tiles.
// - A stack whose N leaves a remainder of 1-16 columns after its full
//   column tiles (the 1025-wide audio heads) packs the remainders of CH
//   heads into one extra block (one 16-byte chunk per head and row), so no
//   block carries a single column through the whole K loop.
// - Rows that are not 16-byte aligned (an unpadded N % 16 != 0 stack, as
//   the JAX layout passes it) take the same kernel with the producer's byte
//   loads (vec = 0): right, not fast.
// The launch plan (variant, splits) is chosen in Python
// for each shape (ops/kernels/w8_gemm.py w8a16_plan) and checked here.
//
// W8A8 and INT4 (tools only, no serving path) keep the first design's tile
// loop below (tile_kernel, split_reduce_kernel): 16-byte weight loads staged
// in registers one tile ahead, a double-buffered padded tile, split K
// summed by a second launch over a scratch buffer.
// The TPU kernels' (td, to) VMEM tiles and their sequential-grid f32
// accumulator are MXU/VMEM choices and are not carried over.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mosstts {
namespace w8 {

enum Mode { W8A16 = 0, W8A8 = 1, INT4 = 2 };

// Launch arguments, filled by ops/kernels/w8_gemm.py (GemmArgs) field for
// field. Strides in elements.
struct Args {
    const void* x;          // (M, >= K) rows: bf16 (W8A16, INT4) or int8 (W8A8)
    const int8_t* w;        // (count, K, N) int8, rows ldw (W8A16) or N apart, weights w_sh apart
    const float* w_scale;   // (count, N) f32, or null (INT4)
    const float* x_scale;   // (M,) f32 (W8A8), else null
    void* out;              // (M, count * N) rows ldo apart, bf16 or f32
    void* part;             // W8A8/INT4 split-K partials: splits x M x count*N, f32 or int32
    int M, K, N, count;
    int x_hi;               // INT4: column of x where its second half starts; else 0
    int splits, k_per_split;  // W8A8/INT4: K rows per split, a multiple of the k tile
    int out_f32;            // 1: f32 output; 0: bf16
    long long ldx, w_sh, ldo;
    long long ldw;          // W8A16: bytes between weight rows (>= N)
    int variant;            // W8A16: the a16 instantiation (w8a16_plan)
    int vec;                // W8A16: 1 16-byte weight loads, 0 byte loads
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

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ============================== W8A16 ==============================
namespace a16 {

namespace cg = cooperative_groups;

constexpr int STAGE_W = 8192;  // weight bytes per ring stage
constexpr int MAX_SPLITS = 8;  // blocks per cluster: the portable cluster size

// One instantiation: MT 16-row tiles, BN columns, STAGES ring tiles, NP
// producer warps and WM x WN x WK consumer warps: WM across the row tiles,
// WN across the 32-column groups, WK across the k16 steps of a stage (their
// partial sums added in warp order at the end); MINB blocks an SM at least
// (the register budget).
template <int MT_, int BN_, int WM_, int WN_, int WK_, int STAGES_, int NP_, int MINB_>
struct Cfg {
    static constexpr int MT = MT_, BM = 16 * MT_, BN = BN_, STAGES = STAGES_;
    static constexpr int WM = WM_, WN = WN_, WK = WK_, NC = WM_ * WN_ * WK_, NP = NP_;
    static constexpr int MINB = MINB_;
    static constexpr int THREADS = 32 * (NC + NP_);  // the consumers, then the producers
    static constexpr int BK = STAGE_W / BN_;    // weight rows per stage
    static constexpr int CH = BN_ / 16;         // 16-byte chunks per weight row
    static constexpr int ROWP = BN_ + 16;       // shared bytes per weight row (conflict-free reads)
    static constexpr int MTW = MT_ / WM_;       // row tiles per consumer warp
    static constexpr int CGW = BN_ / 32 / WN_;  // column groups per consumer warp
    static constexpr int KSW = BK / 16 / WK_;   // k16 steps per consumer warp per stage
    static constexpr int XP = BK + 8;           // bf16 per shared x row (conflict-free ldmatrix)
    static constexpr int XCR = BK / 8;          // 16-byte x chunks per row and stage
    static constexpr int W_BYTES = BK * ROWP;
    static constexpr int STAGE = W_BYTES + BM * XP * 2;
    static constexpr int RING = STAGES * STAGE;
    static constexpr int PP = BN + 1;           // floats per shared partial row
    static constexpr int PART = WK * BM * PP * 4;
    static constexpr int SMEM = RING > PART ? RING : PART;
    static constexpr int PR = 32 * NP_ / CH;    // weight rows one producer pass covers
    static constexpr int PJ = BK / PR;          // weight chunks per producer lane and stage
    static_assert(MT_ % WM_ == 0 && (BN_ / 32) % WN_ == 0 && (BK / 16) % WK_ == 0 &&
                  STAGE % 16 == 0, "tile");
};

// The instantiations, indexed by Args::variant (ops/kernels/w8_gemm.py
// A16_VARIANTS mirrors them).
using V0 = Cfg<1, 64, 1, 1, 8, 5, 2, 3>;   // decode, narrow N: more column blocks
using V1 = Cfg<1, 128, 1, 2, 4, 6, 2, 3>;  // decode
using V2 = Cfg<2, 128, 1, 4, 2, 4, 2, 2>;  // M <= 32
using V3 = Cfg<4, 128, 1, 4, 2, 4, 2, 2>;  // M <= 64
using V4 = Cfg<8, 128, 2, 4, 1, 3, 2, 2>;  // M > 96: 128-row tiles
using V5 = Cfg<6, 128, 2, 4, 1, 3, 2, 2>;  // M <= 96 (the server's admission prefill)

// bf16x2 of byte j of u (low half) and byte j of v (high half), exact: a
// byte b = q (two's complement) gives the bf16 128 + (b & 0x7f) and the
// bf16 128 + (b & 0x80) (128 or 256), whose difference is q
__device__ __forceinline__ uint32_t bf16_pair(uint32_t u, uint32_t v, int j) {
    const uint32_t p = __byte_perm(u, v, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
    uint32_t lo = (p & 0x007f007fu) | 0x43004300u, hi = (p & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&lo),
                                     *reinterpret_cast<__nv_bfloat162*>(&hi));
    return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// mbarriers of the ring (shared::cta): a stage's "full" barrier completes
// when the producer's copies of it have landed, its "empty" barrier when
// every consumer warp is done reading it
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MINB) a16_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(8) uint64_t bars[2 * C::STAGES];  // full[s], then empty[s]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int split = blockIdx.x, splits = gridDim.x;
    const int m0 = blockIdx.z * C::BM;
    const int rows = min(C::BM, a.M - m0);  // real rows of the row tile

    // The block's columns: tile blockIdx.y % tiles of head blockIdx.y /
    // tiles, or, past count * tiles, the packed remainders (rem columns
    // from n0 = tiles * BN) of heads h0 .. h0 + CH - 1, 16 tile columns each.
    const int rem = a.N % C::BN;
    const bool packs = rem != 0 && rem <= 16;
    const int tiles = packs ? a.N / C::BN : (a.N + C::BN - 1) / C::BN;
    const bool tail = blockIdx.y >= a.count * tiles;
    int head = 0, h0 = 0, n0, width;
    if (tail) {
        h0 = (blockIdx.y - a.count * tiles) * C::CH;
        n0 = tiles * C::BN;
        width = min(a.count - h0, C::CH) * 16;
    } else {
        head = blockIdx.y / tiles;
        n0 = (blockIdx.y % tiles) * C::BN;
        width = min(C::BN, a.N - n0);
    }
    // split r takes k tiles [r * k_tiles / splits, (r + 1) * k_tiles / splits)
    const int k_tiles = (a.K + C::BK - 1) / C::BK;
    const int k_begin = split * k_tiles / splits * C::BK;
    const int k_end = min(a.K, (split + 1) * k_tiles / splits * C::BK);
    const int n_tiles = (k_end - k_begin + C::BK - 1) / C::BK;

    const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[C::STAGES]);
    if (tid == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(full0 + 8 * s, 32 * C::NP);  // every producer lane
            mbar_init(empty0 + 8 * s, C::NC);  // one arrival per consumer warp
        }
    }
    __syncthreads();

    if (warp >= C::NC) {
        // Producers: lane pl copies chunk cc of weight rows r0 + PR * j and
        // x chunks pl, pl + 32 NP, ... of each stage; wlim of the chunk's 16
        // bytes are real columns (0: none, not loaded). Only x's real rows
        // are copied: the rows past M keep whatever the slot held, and an
        // mma output row depends on its own A row alone, so they reach only
        // output rows past M, which are never stored. Columns past k_end
        // read as zeros (their weights are finite int8, never NaN).
        const int pl = tid - 32 * C::NC, cc = pl % C::CH, r0 = pl / C::CH;
        const int8_t* wsrc;
        int wlim;
        if (tail) {
            const int h = min(h0 + cc, a.count - 1);
            wsrc = a.w + h * a.w_sh + n0;
            wlim = h0 + cc < a.count ? rem : 0;
        } else {
            wsrc = a.w + head * a.w_sh + n0 + cc * 16;
            wlim = max(0, min(16, width - cc * 16));
        }
        const long long rstep = C::PR * a.ldw;
        const int8_t* wrow = wsrc + (k_begin + r0) * a.ldw;
        const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) + m0 * a.ldx;
        for (int t = 0; t < n_tiles; ++t) {
            const int slot = t % C::STAGES, k0 = k_begin + t * C::BK, left = k_end - k0;
            if (t >= C::STAGES) mbar_wait(empty0 + 8 * slot, (t / C::STAGES - 1) & 1);
            unsigned char* sw = smem + slot * C::STAGE;
            const uint32_t dst = smem_u32(sw + r0 * C::ROWP + cc * 16);
            const int8_t* src = wrow;
            if (VEC && left >= C::BK) {  // the whole stage lies in the split: no predicates
                if (wlim > 0) {
#pragma unroll
                    for (int j = 0; j < C::PJ; ++j, src += rstep)
                        cp_async16(dst + j * C::PR * C::ROWP, src);
                }
            } else {
#pragma unroll
                for (int j = 0; j < C::PJ; ++j, src += rstep) {
                    const bool in = r0 + j * C::PR < left;
                    if constexpr (VEC) {
                        if (wlim > 0) cp_async16(dst + j * C::PR * C::ROWP, in ? src : wsrc, in);
                    } else {
                        uint32_t word[4] = {0u, 0u, 0u, 0u};
                        if (in) {
#pragma unroll
                            for (int b = 0; b < 16; ++b)
                                if (b < wlim)
                                    word[b >> 2] |=
                                        static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                                        << (8 * (b & 3));
                        }
                        *reinterpret_cast<uint4*>(sw + (r0 + j * C::PR) * C::ROWP + cc * 16) =
                            make_uint4(word[0], word[1], word[2], word[3]);
                    }
                }
            }
            wrow += C::BK * a.ldw;
            __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(sw + C::W_BYTES);
            for (int i = pl; i < rows * C::XCR; i += 32 * C::NP) {
                const int r = i / C::XCR, c8 = i % C::XCR;
                const bool in = c8 * 8 < left;
                const __nv_bfloat16* xs = xg + r * a.ldx + k0 + c8 * 8;
                if constexpr (VEC) {
                    cp_async16(smem_u32(sx + r * C::XP + c8 * 8), in ? xs : xg, in);
                } else {
                    *reinterpret_cast<uint4*>(sx + r * C::XP + c8 * 8) =
                        in ? *reinterpret_cast<const uint4*>(xs) : make_uint4(0u, 0u, 0u, 0u);
                }
            }
            if constexpr (VEC)
                mbar_arrive_cp_async(full0 + 8 * slot);
            else
                mbar_arrive(full0 + 8 * slot);
        }
    }

    // Consumers: warp (wm, wn, wk) takes row tiles wm * MTW .., column
    // groups wn, wn + WN, .. and k16 steps wk * KSW .. of every stage.
    const int group = lane >> 2, tig = lane & 3;
    const int wm = warp % C::WM, wn = (warp / C::WM) % C::WN, wk = warp / (C::WM * C::WN);
    const int ncg = (width + 31) / 32;  // column groups holding a real column
    float acc[C::MTW][C::CGW][4][4];
#pragma unroll
    for (int mt = 0; mt < C::MTW; ++mt)
#pragma unroll
        for (int gi = 0; gi < C::CGW; ++gi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][gi][j][e] = 0.f;
    if (warp < C::NC) {
        for (int t = 0; t < n_tiles; ++t) {
            const int slot = t % C::STAGES;
            mbar_wait(full0 + 8 * slot, (t / C::STAGES) & 1);
            const unsigned char* sw = smem + slot * C::STAGE;
            const uint32_t sx = smem_u32(sw + C::W_BYTES);
#pragma unroll
            for (int ks = 0; ks < C::KSW; ++ks) {
                const int s = wk * C::KSW + ks;  // k16 step of the stage
                // A: rows mt * 16 + (lane & 15), k 8 * (lane >> 4) .. + 7 of the step
                uint32_t af[C::MTW][4];
#pragma unroll
                for (int mt = 0; mt < C::MTW; ++mt)
                    ldmatrix_x4(af[mt], sx + (((wm * C::MTW + mt) * 16 + (lane & 15)) * C::XP +
                                              s * 16 + (lane >> 4) * 8) * 2);
                // B: this thread's 4 columns (one word) of the 4 rows its
                // fragments take: k 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
                const unsigned char* wrow = sw + (s * 16 + 2 * tig) * C::ROWP + group * 4;
#pragma unroll
                for (int gi = 0; gi < C::CGW; ++gi) {
                    const int g = wn + gi * C::WN;
                    if (g < ncg) {
                        const unsigned char* p = wrow + g * 32;
                        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
                        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + C::ROWP);
                        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * C::ROWP);
                        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 9 * C::ROWP);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const uint32_t b0 = bf16_pair(w0, w1, j), b1 = bf16_pair(w2, w3, j);
#pragma unroll
                            for (int mt = 0; mt < C::MTW; ++mt)
                                mma_bf16(acc[mt][gi][j], af[mt], b0, b1);
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done with the slot
        }
    }
    __syncthreads();  // every stage consumed: the ring is free

    // The block's f32 tile into shared memory: consumer warp (wm, wn, wk)'s
    // partial at part[wk]. n8 tile j takes the thread's column 4 group + j
    // of its 32-column group as its column `group`, so C fragment row group
    // (+8), column 2 tig (+1) of tile j is tile column 32 g + 4 (2 tig (+1)) + j.
    float* part = reinterpret_cast<float*>(smem);
    if (warp < C::NC) {
#pragma unroll
        for (int mt = 0; mt < C::MTW; ++mt)
#pragma unroll
            for (int gi = 0; gi < C::CGW; ++gi) {
                const int g = wn + gi * C::WN;
                if (g >= ncg) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = (wm * C::MTW + mt) * 16 + group + (e >> 1) * 8;
                        const int col = g * 32 + 8 * tig + 4 * (e & 1) + j;
                        part[(wk * C::BM + row) * C::PP + col] = acc[mt][gi][j][e];
                    }
            }
    }
    if constexpr (C::WK > 1) {  // the k-split warps' partials, summed in warp order
        __syncthreads();
        for (int i = tid; i < rows * width; i += C::THREADS) {
            const int o = (i / width) * C::PP + i % width;
            float v = part[o];
#pragma unroll
            for (int w = 1; w < C::WK; ++w) v += part[w * C::BM * C::PP + o];
            part[o] = v;
        }
    }
    // a launch with one split has no cluster
    if (splits > 1)
        cg::this_cluster().sync();  // every rank's tile written and visible cluster-wide
    else
        __syncthreads();

    // rank `split` takes outputs split * THREADS + tid, stepping over the
    // cluster: the ranks' tiles summed in rank order, scaled, rounded once
    for (int i = split * C::THREADS + tid; i < rows * width; i += splits * C::THREADS) {
        const int row = i / width, t = i % width;
        long long c;
        if (tail) {
            if ((t & 15) >= rem) continue;
            c = (long long)(h0 + (t >> 4)) * a.N + n0 + (t & 15);
        } else {
            c = (long long)head * a.N + n0 + t;
        }
        float v = part[row * C::PP + t];
        if (splits > 1) {
            // every rank's value requested before the first is added (the
            // remote loads overlap), then summed in rank order
            cg::cluster_group cluster = cg::this_cluster();
            float rv[MAX_SPLITS];
#pragma unroll
            for (int r = 0; r < MAX_SPLITS; ++r)
                rv[r] = r < splits ? cluster.map_shared_rank(part, r)[row * C::PP + t] : 0.f;
            v = 0.f;
#pragma unroll
            for (int r = 0; r < MAX_SPLITS; ++r)
                if (r < splits) v += rv[r];
        }
        store_out(a, m0 + row, c, v * a.w_scale[c]);
    }
    if (splits > 1) cg::this_cluster().sync();  // peers may still be reading this block's tile
}


// Column blocks of a launch: count * tiles, plus the packed remainders
template <class C> long long column_blocks(const Args& a) {
    const int rem = a.N % C::BN;
    if (rem != 0 && rem <= 16)
        return (long long)a.count * (a.N / C::BN) + (a.count + C::CH - 1) / C::CH;
    return (long long)a.count * ((a.N + C::BN - 1) / C::BN);
}

template <class C, bool VEC>
int launch(const Args& a, cudaStream_t st) {
    // no split without a k tile: a drift between this file and w8a16_plan
    // is refused, not run
    if (a.splits < 1 || a.splits > MAX_SPLITS || a.splits > (a.K + C::BK - 1) / C::BK)
        return (int)cudaErrorInvalidValue;
    const long long ny = column_blocks<C>(a), nz = (a.M + C::BM - 1) / C::BM;
    if (ny > 65535 || nz > 65535) return (int)cudaErrorInvalidValue;
    auto kern = a16_kernel<C, VEC>;
    static unsigned smem_set = 0;  // devices whose limit this instantiation raised
    cudaError_t err = set_smem_limit_once(kern, C::SMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.splits, static_cast<unsigned>(ny), static_cast<unsigned>(nz));
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = a.splits > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <class C> int launch_vec(const Args& a, cudaStream_t st) {
    return a.vec ? launch<C, true>(a, st) : launch<C, false>(a, st);
}

int run(const Args* a, void* stream) {
    if (a->M <= 0 || a->K <= 0 || a->N <= 0 || a->count <= 0 || a->K % 8 != 0 ||
        a->ldx % 8 != 0 || reinterpret_cast<uintptr_t>(a->x) % 16 != 0 || a->ldw < a->N ||
        a->w_scale == nullptr || a->x_scale != nullptr ||
        (a->vec && (a->ldw % 16 != 0 || a->w_sh % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(a->w) % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (a->variant) {
        case 0: return launch_vec<V0>(*a, st);
        case 1: return launch_vec<V1>(*a, st);
        case 2: return launch_vec<V2>(*a, st);
        case 3: return launch_vec<V3>(*a, st);
        case 4: return launch_vec<V4>(*a, st);
        case 5: return launch_vec<V5>(*a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace a16

// ======================= W8A8 and INT4: the first tile loop =======================
constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // weight rows per k tile
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr int W_LD = BN + 16;    // bytes per shared weight row
constexpr int XB_LD = BK + 8;    // bf16 per shared activation row
constexpr int X8_LD = BK + 16;   // bytes per shared int8 activation row

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

template <int MODE, int MT, int VEC>
__global__ void __launch_bounds__(THREADS) tile_kernel(const Args a) {
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
                    const uint32_t l0 = pack_bf16(nib_lo(w0), nib_lo(w1));
                    const uint32_t l1 = pack_bf16(nib_lo(w2), nib_lo(w3));
                    const uint32_t h0 = pack_bf16(nib_hi(w0), nib_hi(w1));
                    const uint32_t h1 = pack_bf16(nib_hi(w2), nib_hi(w3));
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma_bf16(acc[mt][nt], af[0][mt], l0, l1);
                        mma_bf16(acc[mt][nt], af[1][mt], h0, h1);
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
__global__ void __launch_bounds__(256) split_reduce_kernel(const Args a) {
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
    auto kern = tile_kernel<MODE, MT, VEC>;
    if constexpr (T::SMEM > 48 * 1024) {
        static unsigned smem_set = 0;  // devices whose limit this instantiation raised
        cudaError_t e = set_smem_limit_once(kern, T::SMEM, smem_set);
        if (e != cudaSuccess) return (int)e;
    }
    const int nblk = (a.N + BN - 1) / BN;
    const dim3 grid(a.count * nblk, a.splits, (a.M + T::BM - 1) / T::BM);
    kern<<<grid, THREADS, T::SMEM, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.splits == 1) return (int)err;
    const long long total = (long long)a.M * a.count * a.N;
    split_reduce_kernel<MODE == W8A8><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a);
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
    return mosstts::w8::a16::run(args, stream);
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
