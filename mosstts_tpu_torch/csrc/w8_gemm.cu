// Int8-weight GEMMs on the tensor cores, four modes of one kernel:
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
//   F32X3  W8A16's function with float32 x and f32 output (the int8 codec's
//          encoder; the JAX package's ``dense`` with f32 activations,
//          mosstts_tpu/ops/basic.py:28-30): x is split into three bf16
//          terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
//          (round to nearest; the differences are exact in f32, and hi +
//          mid + lo == x wherever lo stays normal, |x| >= 2^-110), and each
//          B fragment (int8 -> bf16, exact) is multiplied by the three in
//          one f32 accumulator, lo first: the f32 product to f32 rounding
//          at the bf16 tensor-core rate, three passes of ~989 TFLOP/s
//          against one of the 67 TFLOP/s f32 cores. The terms come from
//          split3_kernel, a prologue launch that writes them once as
//          (M, 3 Kp) bf16 rows [hi | mid | lo] (Kp = K rounded up to 8,
//          zeros past K), copied as three x tiles a stage. Its bound at
//          the codec's shapes is the weight bytes up to M ~ 50, the three
//          bf16 products past that; the kernel takes several times it
//          (PERF.md §6).
//
// Replaces: tools/tune_mm8.py::mm8 (_kernel_dmajor) and ::mm8_omajor
// (_kernel_omajor), which compute the W8A16 function over layer-stacked
// (L, D, O) weights, and ::mm8_w8a8 (_kernel_w8a8); tools/probe_int4.py::
// mm8_pallas (_mm8_kernel, W8A16 with no scale) and ::mm4_pallas
// (_mm4_kernel). The serving path's int8 dense layers and heads
// (mosstts_tpu/ops/basic.py::dense, models/delay.py::_audio_head_logits on a
// QuantWeight) compute the W8A16 function, and the int8 codec's encoder it
// with f32 activations (F32X3); XLA left them to its int8 dot.
//
// What bounds them on the H100: at decode (M = 1-16 rows, 254 W8A16
// launches per 8B step) the weight bytes, ~1 flop per byte read against the
// card's ~295 flops/byte balance; at prefill (M in the hundreds) the tensor
// cores. W8A8 at the tool's B=128 reads its 50 MB of weights at ~256 int8
// ops a byte, under the card's ~590 int8 ops/byte, so bytes bound it; int4
// at B=64 does 256 bf16 flops per packed byte, near the bf16 balance. But
// turning weights into fragments costs instructions on every weight byte,
// so a block that streams alone is bound by its warps' latency, not by
// memory; W8A8 and INT4 at the tools' shapes take as long with their
// weights warm in L2 as cold, bound by the consumers' work per stage and
// the output epilogue (tools/w8a16_plans.py and PERF.md §6 have the
// measurements). The design (ring_kernel below):
// - Warp-specialized: producer warps stream the weight tiles (8 KB:
//   BK rows x BN = 64 or 128 bytes) and the x tile (BM rows x BK: bf16,
//   int8, INT4's two bf16 tiles, columns k and x_hi + k, or F32X3's three,
//   columns k, x_hi + k and 2 x_hi + k of the prologue's rows) of each stage
//   global -> shared into a ring of STAGES (3-12) slots; each slot's "full"
//   mbarrier completes when its copies land, its "empty" mbarrier when
//   every consumer warp is done with it. Eight consumer warps do only math,
//   with no block-wide barrier in the loop, so one warp's waits overlap the
//   others' work and up to STAGES - 1 tiles of a block are in flight.
//   W8A16 and F32X3 copy with 16-byte cp.async (cp.async.mbarrier.arrive)
//   into rows padded by 16 bytes, so the fragment reads below hit distinct
//   banks.
//   W8A8 and INT4 copy a whole tile with one tensor copy (the tensor memory
//   accelerator, cp.async.bulk.tensor, on the full barrier's transaction
//   bytes; tensor maps made per launch, make_maps) into dense rows under
//   the 128B/64B swizzle (swz), which keeps the same reads conflict-free,
//   instead of the 1024-1536 16-byte copies two warps issue a stage
//   (measured faster, PERF.md §6). Their partial stages (K's tail),
//   packed remainder blocks and byte-loaded rows keep cp.async, into the
//   same swizzled layout.
// - B fragments from word loads: a tile's columns may be permuted if the
//   epilogue maps them back (logical column n of n8 tile j is tile column
//   4n + j of its 32-column group), so each thread reads 4 adjacent columns
//   of each k row its fragments take with one 32-bit shared load and uses
//   them as its column in 4 n8 tiles; x comes in with ldmatrix (for int8 x
//   the b16 ldmatrix without .trans gives exactly m16n8k32's row-major s8
//   A layout).
//   * W8A16 (k 2t, 2t+1, 2t+8, 2t+9): int8 -> bf16 takes a byte permute,
//     two LOP3s and one bf16x2 subtraction per pair of values: q = (128 +
//     (b & 0x7f)) - (128 + (b & 0x80)), exact, no I2F. F32X3 builds the
//     same fragments once and multiplies each row tile's three terms by
//     them (three mma a fragment, lo, mid, hi into one accumulator).
//   * W8A8 (k 4t .. 4t+3 and 16 + 4t .. 16 + 4t+3): the 4x4 byte block of
//     4 words is transposed into the four n8 tiles' s8 registers with 8
//     byte permutes, no conversion at all. Rows 4t lie 4 rows apart, which
//     would put t and t + 2 on the same banks, so weight row k is stored at
//     a8_row(k) (the 5-D tensor map lays it there): a thread's rows become
//     W8A16's (2t, 2t+1, 2t+8, 2t+9), conflict-free.
//   * INT4 (as W8A16; each packed row feeds the lo and the hi k16 product):
//     a byte permute places byte j of two rows in a bf16x2's low bytes; a
//     LOP3 puts each nibble, XOR 8, in the mantissa of a bf16 128 (0x4300 |
//     (n ^ 8)), and one bf16x2 subtraction of 136 gives the signed value
//     exactly (the high nibble after a shift). No I2F, no F2F.
//   Why not wgmma: int8 wgmma takes both operands K-major, and the (K, N)
//   weights are N-major; the JAX tools' layout stays the public layout, so
//   a K-major repack is not done.
// - The split-K sum inside the launch: the `splits` (<= 8) blocks of one
//   column tile form a thread-block cluster (cudaLaunchKernelEx, grid
//   (splits, column blocks, row tiles)); each block leaves its tile (f32, or
//   int32 for W8A8) in its own shared memory and, after cluster.sync(),
//   rank r reads every rank's tile through distributed shared memory in
//   rank order for its share of the outputs, scales and rounds once (W8A8
//   and INT4 4 adjacent outputs a thread: 16-byte reads and stores). No
//   second launch, no scratch, no atomics: a call repeats bit for bit and
//   replays in a graph (W8A8's int32 sum is exact in any order).
// - M <= 128 is one row tile (16 * MT rows, MT = 1, 2, 4, 6 or 8), so a
//   prefill of up to 128 rows streams the weights once. The consumer warps
//   split a stage's k steps (their partials summed in warp order at the end)
//   and its column groups, and W8A16's and W8A8's at MT >= 4 its row tiles.
// - A stack whose N leaves a remainder of 1-16 columns after its full
//   column tiles (the 1025-wide audio heads) packs the remainders of CH
//   heads into one extra block (one 16-byte chunk per head and row), so no
//   block carries a single column through the whole K loop.
// - Rows that are not 16-byte aligned (an unpadded N % 16 != 0 stack, as
//   the JAX layout passes it) take the same kernel with the producer's byte
//   loads (vec = 0): right, not fast.
// The launch plan (variant, splits) is chosen in Python for each mode and
// shape (ops/kernels/w8_gemm.py gemm_plan) and checked here. W8A8's row
// quantization stays a launch of its own before the product: every block
// needs the whole row's absmax before its first k tile. F32X3's split of x
// is one too: the producers splitting every stage's f32 tile in every
// column block measured ~30% slower at M = 50 (30.9 against 24.0 µs at the
// codec's 1536 x 6144) and no faster at M = 1 (PERF.md §6).
// The TPU kernels' (td, to) VMEM tiles and their sequential-grid f32
// accumulator are MXU/VMEM choices and are not carried over.
#include <algorithm>
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace mosstts {
namespace w8 {

enum Mode { W8A16 = 0, W8A8 = 1, INT4 = 2, F32X3 = 3 };

// Launch arguments, filled by ops/kernels/w8_gemm.py (GemmArgs) field for
// field. Strides in elements.
struct Args {
    const void* x;          // (M, >= K) rows: bf16 (W8A16, INT4, F32X3's terms) or int8 (W8A8)
    const int8_t* w;        // (count, K, N) int8, rows ldw bytes apart, weights w_sh apart
    const float* w_scale;   // (count, N) f32, or null (INT4)
    const float* x_scale;   // (M,) f32 (W8A8), else null
    void* out;              // (M, count * N) rows ldo apart, bf16 or f32
    int M, K, N, count;
    int x_hi;               // INT4: column of x where its second half starts; F32X3:
                            // of its second term (Kp; the third at 2 Kp); else 0
    int splits;             // blocks per cluster: the split of K
    int out_f32;            // 1: f32 output; 0: bf16
    long long ldx, w_sh, ldo;
    long long ldw;          // bytes between weight rows (>= N)
    int variant;            // the mode's instantiation (gemm_plan)
    int vec;                // 1 16-byte weight loads, 0 byte loads
};

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

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ============================== the ring kernel ==============================
namespace ring {

namespace cg = cooperative_groups;

constexpr int STAGE_W = 8192;  // weight bytes per ring stage
constexpr int MAX_SPLITS = 8;  // blocks per cluster: the portable cluster size

// One instantiation: its MODE, MT 16-row tiles, BN columns, STAGES ring
// tiles, NP producer warps and WM x WN x WK consumer warps: WM across the
// row tiles, WN across the 32-column groups, WK across the mma k steps of a
// stage (their partial sums added in warp order at the end); MINB blocks an
// SM at least (the register budget).
template <int MODE_, int MT_, int BN_, int WM_, int WN_, int WK_, int STAGES_, int NP_,
          int MINB_>
struct Cfg {
    static constexpr int MODE = MODE_;
    static constexpr int MT = MT_, BM = 16 * MT_, BN = BN_, STAGES = STAGES_;
    static constexpr int WM = WM_, WN = WN_, WK = WK_, NC = WM_ * WN_ * WK_, NP = NP_;
    static constexpr int MINB = MINB_;
    static constexpr int THREADS = 32 * (NC + NP_);  // the consumers, then the producers
    static constexpr int BK = STAGE_W / BN_;    // weight rows per stage
    static constexpr int CH = BN_ / 16;         // 16-byte chunks per weight row
    // W8A8, INT4: whole tiles by the tensor memory accelerator into dense,
    // swizzled rows (swz); W8A16, F32X3: cp.async into rows padded by 16 bytes
    static constexpr bool TMA = MODE_ == W8A8 || MODE_ == INT4;
    static constexpr int ROWP = TMA ? BN_ : BN_ + 16;  // shared bytes per weight row
    static constexpr int MTW = MT_ / WM_;       // row tiles per consumer warp
    static constexpr int CGW = BN_ / 32 / WN_;  // column groups per consumer warp
    static constexpr int KS = MODE_ == W8A8 ? 32 : 16;  // k rows per mma step
    static constexpr int KSW = BK / KS / WK_;   // mma steps per consumer warp per stage
    // x tiles per stage (INT4: lo, hi; F32X3: its terms hi, mid, lo)
    static constexpr int NX = MODE_ == INT4 ? 2 : MODE_ == F32X3 ? 3 : 1;
    static constexpr int XE = MODE_ == W8A8 ? 1 : 2;    // bytes per x element
    static constexpr int XP = TMA ? BK : BK + 16 / XE;  // x elements per shared row
    static constexpr int XRB = XP * XE;         // bytes per shared x row
    static constexpr int XCE = 16 / XE;         // x elements per 16-byte chunk
    static constexpr int XCR = BK / XCE;        // 16-byte x chunks per row and stage
    static constexpr int X_BYTES = BM * XP * XE;
    static constexpr int W_BYTES = BK * ROWP;
    static constexpr int STAGE = W_BYTES + NX * X_BYTES;
    static constexpr int RING = STAGES * STAGE;
    // words per shared partial row: W8A8 and INT4 read 4 at once (16-byte aligned)
    static constexpr int PP = TMA ? BN + 4 : BN + 1;
    static constexpr int PART = WK * BM * PP * 4;
    // TMA's swizzled tiles start at 1 KB boundaries: room to align the base
    static constexpr int SMEM = (RING > PART ? RING : PART) + (TMA ? 1024 : 0);
    static constexpr int PR = 32 * NP_ / CH;    // weight rows one producer pass covers
    static constexpr int PJ = BK / PR;          // weight chunks per producer lane and stage
    static_assert(MT_ % WM_ == 0 && (BN_ / 32) % WN_ == 0 && (BK / KS) % WK_ == 0 &&
                  STAGE % 16 == 0, "tile");
    static_assert(!TMA || (BN_ == 128 && (XRB == 64 || XRB == 128) && STAGE % 1024 == 0 &&
                           X_BYTES % 1024 == 0), "tma");
};

// The instantiations of each mode, indexed by Args::variant
// (ops/kernels/w8_gemm.py VARIANTS mirrors them).
// W8A16
using V0 = Cfg<W8A16, 1, 64, 1, 1, 8, 5, 2, 3>;   // decode, narrow N: more column blocks
using V1 = Cfg<W8A16, 1, 128, 1, 2, 4, 6, 2, 3>;  // decode
using V2 = Cfg<W8A16, 2, 128, 1, 4, 2, 4, 2, 2>;  // M <= 32
using V3 = Cfg<W8A16, 4, 128, 1, 4, 2, 4, 2, 2>;  // M <= 64
using V4 = Cfg<W8A16, 8, 128, 2, 4, 1, 3, 2, 2>;  // M > 96: 128-row tiles
using V5 = Cfg<W8A16, 6, 128, 2, 4, 1, 3, 2, 2>;  // M <= 96 (the server's admission prefill)
// W8A8: an int8 x tile, two k32 steps a stage. INT4: two bf16 x tiles, four
// packed k16 rows a stage, each two products. Their prefill tiles at the
// tools' shapes (W8A8 B=128, INT4 B=64) are one block an SM with a deep ring
// (12 and 8 stages, MINB 1, the split of K 1): faster there than two
// blocks an SM or any split (tools/w8a16_plans.py --mode, PERF.md §6).
// INT4's 64-row tile gives each warp all four row tiles, so a B fragment
// is converted once for 4 row tiles, not twice for 2.
using Q0 = Cfg<W8A8, 1, 128, 1, 4, 2, 6, 2, 3>;    // decode
using Q1 = Cfg<W8A8, 2, 128, 1, 4, 2, 5, 2, 2>;    // M <= 32
using Q2 = Cfg<W8A8, 4, 128, 2, 4, 1, 5, 2, 2>;    // M <= 64
using Q3 = Cfg<W8A8, 8, 128, 2, 4, 1, 12, 2, 1>;   // M <= 128 (the tool's B=128) and beyond
using I0 = Cfg<INT4, 1, 128, 1, 4, 2, 5, 2, 3>;    // decode
using I1 = Cfg<INT4, 2, 128, 1, 4, 2, 4, 2, 2>;    // M <= 32
using I2 = Cfg<INT4, 4, 128, 1, 4, 2, 8, 2, 1>;    // M <= 64 (the tool's B=64)
using I3 = Cfg<INT4, 8, 128, 2, 4, 1, 5, 2, 1>;    // M <= 128 and beyond
// F32X3: W8A16's tiles with three bf16 x tiles a stage (hi, mid, lo), so
// fewer ring stages fit. Of the 16-row tiles of 64 and 128 columns and the
// 32-, 64-, 96- and 128-row ones, these three were the fastest or within a
// few % of it at the codec's shapes and M = 1-200 (PERF.md §6).
using F0 = Cfg<F32X3, 1, 64, 1, 1, 8, 4, 2, 2>;   // M <= 16
using F1 = Cfg<F32X3, 2, 128, 1, 4, 2, 4, 4, 1>;  // 32-row tiles: more blocks
using F2 = Cfg<F32X3, 8, 128, 2, 4, 1, 3, 2, 1>;  // 128-row tiles: the weights read fewer times

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

// F32X3's split of x into bf16 terms, each rounded to nearest: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid). Both differences
// are exact in f32, and hi + mid + lo == x wherever lo stays a normal bf16
// (|x| >= 2^-110); below, the remainder is at most 2^-134 (half of bf16's
// smallest subnormal step). A finite x that rounds past bf16's largest
// value keeps its truncation as hi; inf and NaN are hi alone (mid = lo =
// 0), so the product sees inf and NaN as the f32 product does.
// (ops/kernels/w8_gemm.py split3_bf16 is the plain version.)
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(x);
    float h = __bfloat162float(hi);
    if (fabsf(h) > 3.402823466e38f) {  // inf: x is, or rounded past the largest bf16
        hi = __float2bfloat16_rz(x);
        h = __bfloat162float(hi);
    }
    const float r = fabsf(x) <= 3.402823466e38f ? x - h : 0.f;
    mid = __float2bfloat16_rn(r);
    lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// The three terms of 8 consecutive values as 16-byte rows: t[0] hi, t[1]
// mid, t[2] lo (bf16x2 words, element 2e in the low half of word e)
__device__ __forceinline__ void split3_8(const float (&v)[8], uint4 (&t)[3]) {
    uint32_t w[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        __nv_bfloat16 h0, m0, l0, h1, m1, l1;
        split3(v[2 * e], h0, m0, l0);
        split3(v[2 * e + 1], h1, m1, l1);
        const __nv_bfloat162 h = __halves2bfloat162(h0, h1), m = __halves2bfloat162(m0, m1),
                             l = __halves2bfloat162(l0, l1);
        w[0][e] = *reinterpret_cast<const uint32_t*>(&h);
        w[1][e] = *reinterpret_cast<const uint32_t*>(&m);
        w[2][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) t[h] = make_uint4(w[h][0], w[h][1], w[h][2], w[h][3]);
}

// 8 f32 values from p, those from column `lim` on as 0; 16-byte loads
// where p is 16-byte aligned (`vec`) and all 8 are real
__device__ __forceinline__ void load8(float (&v)[8], const float* p, int lim, bool vec) {
    if (vec && lim >= 8) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
        v[7] = b.w;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = e < lim ? p[e] : 0.f;
    }
}

// The signed nibbles (low: lo, high: hi) of byte j of u and byte j of v as
// bf16x2 pairs, exact: nibble n XOR 8 in the mantissa of the bf16 128
// (0x4300 | (n ^ 8) = 128 + (n ^ 8)), minus 136, is n's two's-complement value
__device__ __forceinline__ void nibble_pairs(uint32_t u, uint32_t v, int j, uint32_t& lo,
                                             uint32_t& hi) {
    const uint32_t p = __byte_perm(u, v, j | ((4 + j) << 8));  // byte j of u, of v at 0, 16
    uint32_t l = (p & 0x000f000fu) ^ 0x43084308u, h = ((p >> 4) & 0x000f000fu) ^ 0x43084308u;
    const uint32_t m = 0x43084308u;  // bf16x2 (136, 136)
    const __nv_bfloat162 dl = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&l),
                                      *reinterpret_cast<const __nv_bfloat162*>(&m));
    const __nv_bfloat162 dh = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&h),
                                      *reinterpret_cast<const __nv_bfloat162*>(&m));
    lo = *reinterpret_cast<const uint32_t*>(&dl);
    hi = *reinterpret_cast<const uint32_t*>(&dh);
}

// The 4x4 byte transpose: w[r] holds byte c = row r, column c; afterwards
// w[c] holds byte r = row r, column c (8 byte permutes)
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
    const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
    w[0] = __byte_perm(a, b, 0x5410);
    w[1] = __byte_perm(a, b, 0x7632);
    w[2] = __byte_perm(c, d, 0x5410);
    w[3] = __byte_perm(c, d, 0x7632);
}

// W8A8's shared row of weight row k of a stage: within each 16 rows, k =
// 4 t + r lies at row 2 t + (r & 1) + 8 (r >> 1), so the four rows a thread
// reads for its s8 fragment (k 4 t .. 4 t + 3) are W8A16's 2 t, 2 t + 1,
// 2 t + 8, 2 t + 9, on distinct banks across t
__device__ __forceinline__ int a8_row(int k) {
    return (k & ~15) | (((k >> 2) & 3) << 1) | (k & 1) | (((k >> 1) & 1) << 3);
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
// arrive, raising the phase's expected transaction bytes by `bytes`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

// The W8A8 and INT4 tensor maps: the weights' and x's (ring::make_maps)
struct alignas(64) Maps {
    CUtensorMap w, x;
};

// One tile global -> shared by the tensor memory accelerator, completing
// on bar's transaction bytes; columns and rows past the tensor read as 0
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}
// the same through W8A8's 5-D weight map, at (c0, 0, 0, 0, c4)
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, int c0, int c4,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %3, %3, %4}], [%5];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(0), "r"(c4), "r"(bar)
        : "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` of a tile of RB-byte
// rows as the tensor memory accelerator's 128B (RB = 128) or 64B (RB = 64)
// swizzle lays it out: the chunk index XOR bits 7.. of the row's offset.
// The fragment reads below then hit distinct banks, as the padded rows do.
template <int RB> __device__ __forceinline__ int swz(int row, int chunk) {
    return row * RB + ((chunk ^ ((row * RB >> 7) & (RB / 16 - 1))) << 4);
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
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    ring_kernel(const Args a, const __grid_constant__ Maps maps) {
    using Acc = std::conditional_t<C::MODE == W8A8, int, float>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw;
    if constexpr (C::TMA) smem += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
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
        // the tensor copies complete on these barriers: make their
        // initialization visible to the async proxy
        if constexpr (C::TMA) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= C::NC) {
        // Producers: lane pl copies chunk cc of weight rows r0 + PR * j and
        // x chunks pl, pl + 32 NP, ... of each stage; wlim of the chunk's 16
        // bytes are real columns (0: none, not loaded). Only x's real rows
        // are copied: the rows past M keep whatever the slot held, and an
        // mma output row depends on its own A row alone, so they reach only
        // output rows past M, which are never stored. Columns past k_end
        // read as zeros (their weights are finite, never NaN).
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
        // shared offset of chunk cc of producer row j from that of row r0:
        // W8A8 permutes the rows (a8_row), W8A8 and INT4 swizzle the chunks
        // as the tensor memory accelerator does (swz)
        auto woff = [&](int j) -> int {
            const int row = r0 + j * C::PR;
            if constexpr (C::TMA)
                return swz<C::ROWP>(C::MODE == W8A8 ? a8_row(row) : row, cc) -
                       (r0 * C::ROWP + cc * 16);
            else
                return j * C::PR * C::ROWP;
        };
        const long long rstep = C::PR * a.ldw;
        const int8_t* wrow = wsrc + (k_begin + r0) * a.ldw;
        const __nv_bfloat16* xgb = static_cast<const __nv_bfloat16*>(a.x) + m0 * a.ldx;
        const unsigned char* xg =
            static_cast<const unsigned char*>(a.x) + m0 * a.ldx * C::XE;
        for (int t = 0; t < n_tiles; ++t) {
            const int slot = t % C::STAGES, k0 = k_begin + t * C::BK, left = k_end - k0;
            if (t >= C::STAGES) mbar_wait(empty0 + 8 * slot, (t / C::STAGES - 1) & 1);
            unsigned char* sw = smem + slot * C::STAGE;
            if constexpr (C::TMA && VEC) {
                if (!tail && left >= C::BK) {
                    // a whole stage of a full column tile: one tensor copy of
                    // the weights (W8A8's 5-D map lays row k at a8_row(k)),
                    // one of each x tile, on the full barrier's transaction
                    // bytes; the other producer lanes arrive plainly
                    const uint32_t full = full0 + 8 * slot, dw = smem_u32(sw);
                    if (pl == 0) {
                        mbar_arrive_expect_tx(full, C::STAGE);
                        if constexpr (C::MODE == W8A8)
                            tma_load_5d(dw, &maps.w, n0, (head * a.K + k0) >> 4, full);
                        else
                            tma_load_2d(dw, &maps.w, n0, head * a.K + k0, full);
#pragma unroll
                        for (int h = 0; h < C::NX; ++h)
                            tma_load_2d(dw + C::W_BYTES + h * C::X_BYTES, &maps.x,
                                        k0 + h * a.x_hi, m0, full);
                    } else {
                        mbar_arrive(full);
                    }
                    wrow += C::BK * a.ldw;
                    continue;
                }
            }
            unsigned char* wdst = sw + r0 * C::ROWP + cc * 16;
            const uint32_t dst = smem_u32(wdst);
            const int8_t* src = wrow;
            if (VEC && left >= C::BK) {  // the whole stage lies in the split: no predicates
                if (wlim > 0) {
#pragma unroll
                    for (int j = 0; j < C::PJ; ++j, src += rstep) cp_async16(dst + woff(j), src);
                }
            } else {
#pragma unroll
                for (int j = 0; j < C::PJ; ++j, src += rstep) {
                    const bool in = r0 + j * C::PR < left;
                    if constexpr (VEC) {
                        if (wlim > 0) cp_async16(dst + woff(j), in ? src : wsrc, in);
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
                        *reinterpret_cast<uint4*>(
                            C::TMA ? wdst + woff(j) : sw + (r0 + j * C::PR) * C::ROWP + cc * 16) =
                            make_uint4(word[0], word[1], word[2], word[3]);
                    }
                }
            }
            wrow += C::BK * a.ldw;
            if constexpr (C::MODE == W8A16 || C::MODE == F32X3) {
                // bf16 x: W8A16's tile, or F32X3's three terms (columns k,
                // x_hi + k and 2 x_hi + k of the prologue's rows)
                __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(sw + C::W_BYTES);
                for (int i = pl; i < rows * C::XCR; i += 32 * C::NP) {
                    const int r = i / C::XCR, c8 = i % C::XCR;
                    const bool in = c8 * 8 < left;
                    const __nv_bfloat16* xs = xgb + r * a.ldx + k0 + c8 * 8;
#pragma unroll
                    for (int h = 0; h < C::NX; ++h) {
                        __nv_bfloat16* d = sx + h * (C::X_BYTES / 2) + r * C::XP + c8 * 8;
                        const __nv_bfloat16* hs = xs + h * a.x_hi;
                        if constexpr (VEC) {
                            cp_async16(smem_u32(d), in ? hs : xgb, in);
                        } else {
                            *reinterpret_cast<uint4*>(d) = in ? *reinterpret_cast<const uint4*>(hs)
                                                              : make_uint4(0u, 0u, 0u, 0u);
                        }
                    }
                }
            } else {  // W8A8 (int8 x), INT4 (columns k and x_hi + k), swizzled
                unsigned char* sx = sw + C::W_BYTES;
                for (int i = pl; i < rows * C::XCR; i += 32 * C::NP) {
                    const int r = i / C::XCR, c = i % C::XCR;
                    const bool in = c * C::XCE < left;
                    const unsigned char* xs = xg + (r * a.ldx + k0 + c * C::XCE) * C::XE;
#pragma unroll
                    for (int h = 0; h < C::NX; ++h) {
                        const unsigned char* hs = xs + h * a.x_hi * C::XE;
                        unsigned char* hd = sx + h * C::X_BYTES + swz<C::XRB>(r, c);
                        if constexpr (VEC) {
                            cp_async16(smem_u32(hd), in ? hs : xg, in);
                        } else {
                            *reinterpret_cast<uint4*>(hd) = in ? *reinterpret_cast<const uint4*>(hs)
                                                               : make_uint4(0u, 0u, 0u, 0u);
                        }
                    }
                }
            }
            if constexpr (VEC)
                mbar_arrive_cp_async(full0 + 8 * slot);
            else
                mbar_arrive(full0 + 8 * slot);
        }
    }

    // Consumers: warp (wm, wn, wk) takes row tiles wm * MTW .., column
    // groups wn, wn + WN, .. and mma k steps wk * KSW .. of every stage.
    const int group = lane >> 2, tig = lane & 3;
    const int wm = warp % C::WM, wn = (warp / C::WM) % C::WN, wk = warp / (C::WM * C::WN);
    const int ncg = (width + 31) / 32;  // column groups holding a real column
    Acc acc[C::MTW][C::CGW][4][4];
#pragma unroll
    for (int mt = 0; mt < C::MTW; ++mt)
#pragma unroll
        for (int gi = 0; gi < C::CGW; ++gi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][gi][j][e] = 0;
    if (warp < C::NC) {
        for (int t = 0; t < n_tiles; ++t) {
            const int slot = t % C::STAGES;
            mbar_wait(full0 + 8 * slot, (t / C::STAGES) & 1);
            const unsigned char* sw = smem + slot * C::STAGE;
            const uint32_t sx = smem_u32(sw + C::W_BYTES);
#pragma unroll
            for (int ks = 0; ks < C::KSW; ++ks) {
                const int s = wk * C::KSW + ks;  // mma k step of the stage
                // A: rows mt * 16 + (lane & 15), the 16 bytes from byte 16 *
                // (lane >> 4) of the step's k (bf16 k 8 (lane >> 4) .. + 7;
                // int8 k 16 (lane >> 4) .. + 15)
                auto load_a = [&](uint32_t(&r)[4], int h, int mt) {
                    const int row = (wm * C::MTW + mt) * 16 + (lane & 15);
                    if constexpr (C::TMA)  // a k step is 32 bytes: chunks 2 s, 2 s + 1
                        ldmatrix_x4(r, sx + h * C::X_BYTES + swz<C::XRB>(row, 2 * s + (lane >> 4)));
                    else
                        ldmatrix_x4(r, sx + h * C::X_BYTES +
                                           (row * C::XP + s * C::KS + (lane >> 4) * (16 / C::XE)) *
                                               C::XE);
                };
                // W8A16, W8A8: every row tile's A first (INT4 and F32X3
                // load their two or three x tiles per row tile below, after
                // their B fragments)
                constexpr bool A_FIRST = C::MODE == W8A16 || C::MODE == W8A8;
                uint32_t af[A_FIRST ? C::MTW : 1][4];
                if constexpr (A_FIRST) {
#pragma unroll
                    for (int mt = 0; mt < C::MTW; ++mt) load_a(af[mt], 0, mt);
                }
                if constexpr (C::MODE == W8A8) {
                    // B: this thread's 4 columns (one word) of k 4 tig .. + 3
                    // and 16 + 4 tig .. + 3, at shared rows a8_row(k)
                    const unsigned char* wb = sw + (group & 3) * 4;
#pragma unroll
                    for (int gi = 0; gi < C::CGW; ++gi) {
                        const int g = wn + gi * C::WN;
                        if (g < ncg) {
                            const int chunk = 2 * g + (group >> 2);
                            uint32_t b0[4], b1[4];
#pragma unroll
                            for (int r = 0; r < 4; ++r) {
                                const int row = s * 32 + 2 * tig + (r & 1) + 8 * (r >> 1);
                                b0[r] = *reinterpret_cast<const uint32_t*>(
                                    wb + swz<C::ROWP>(row, chunk));
                                b1[r] = *reinterpret_cast<const uint32_t*>(
                                    wb + swz<C::ROWP>(row + 16, chunk));
                            }
                            transpose4(b0);
                            transpose4(b1);
#pragma unroll
                            for (int j = 0; j < 4; ++j)
#pragma unroll
                                for (int mt = 0; mt < C::MTW; ++mt)
                                    mma_s8(acc[mt][gi][j], af[mt], b0[j], b1[j]);
                        }
                    }
                } else {
                    // B: this thread's 4 columns (one word) of the 4 rows its
                    // fragments take: k 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
                    const unsigned char* wrow = sw + (s * 16 + 2 * tig) * C::ROWP + group * 4;
#pragma unroll
                    for (int gi = 0; gi < C::CGW; ++gi) {
                        const int g = wn + gi * C::WN;
                        if (g < ncg) {
                            uint32_t w0, w1, w2, w3;
                            if constexpr (C::TMA) {  // INT4
                                const unsigned char* wb = sw + (group & 3) * 4;
                                const int row = s * 16 + 2 * tig, chunk = 2 * g + (group >> 2);
                                w0 = *reinterpret_cast<const uint32_t*>(wb + swz<C::ROWP>(row, chunk));
                                w1 = *reinterpret_cast<const uint32_t*>(
                                    wb + swz<C::ROWP>(row + 1, chunk));
                                w2 = *reinterpret_cast<const uint32_t*>(
                                    wb + swz<C::ROWP>(row + 8, chunk));
                                w3 = *reinterpret_cast<const uint32_t*>(
                                    wb + swz<C::ROWP>(row + 9, chunk));
                            } else {
                                const unsigned char* p = wrow + g * 32;
                                w0 = *reinterpret_cast<const uint32_t*>(p);
                                w1 = *reinterpret_cast<const uint32_t*>(p + C::ROWP);
                                w2 = *reinterpret_cast<const uint32_t*>(p + 8 * C::ROWP);
                                w3 = *reinterpret_cast<const uint32_t*>(p + 9 * C::ROWP);
                            }
                            if constexpr (C::MODE == W8A16) {
#pragma unroll
                                for (int j = 0; j < 4; ++j) {
                                    const uint32_t b0 = bf16_pair(w0, w1, j),
                                                   b1 = bf16_pair(w2, w3, j);
#pragma unroll
                                    for (int mt = 0; mt < C::MTW; ++mt)
                                        mma_bf16(acc[mt][gi][j], af[mt], b0, b1);
                                }
                            } else if constexpr (C::MODE == F32X3) {
                                // the four n8 tiles' fragments converted
                                // once, then per row tile its three terms,
                                // the smallest first, into one accumulator
                                uint32_t b[4][2];
#pragma unroll
                                for (int j = 0; j < 4; ++j) {
                                    b[j][0] = bf16_pair(w0, w1, j);
                                    b[j][1] = bf16_pair(w2, w3, j);
                                }
#pragma unroll
                                for (int mt = 0; mt < C::MTW; ++mt) {
                                    uint32_t xa[3][4];
#pragma unroll
                                    for (int h = 0; h < 3; ++h) load_a(xa[h], h, mt);
#pragma unroll
                                    for (int h = 2; h >= 0; --h)
#pragma unroll
                                        for (int j = 0; j < 4; ++j)
                                            mma_bf16(acc[mt][gi][j], xa[h], b[j][0], b[j][1]);
                                }
                            } else {
                                // INT4: the four n8 tiles' fragments converted
                                // once, then per row tile its x halves: the
                                // low nibbles times x's first half, the high
                                // ones times its second
                                uint32_t bl[4][2], bh[4][2];
#pragma unroll
                                for (int j = 0; j < 4; ++j) {
                                    nibble_pairs(w0, w1, j, bl[j][0], bh[j][0]);
                                    nibble_pairs(w2, w3, j, bl[j][1], bh[j][1]);
                                }
#pragma unroll
                                for (int mt = 0; mt < C::MTW; ++mt) {
                                    uint32_t lo[4], hi[4];
                                    load_a(lo, 0, mt);
                                    load_a(hi, 1, mt);
#pragma unroll
                                    for (int j = 0; j < 4; ++j) {
                                        mma_bf16(acc[mt][gi][j], lo, bl[j][0], bl[j][1]);
                                        mma_bf16(acc[mt][gi][j], hi, bh[j][0], bh[j][1]);
                                    }
                                }
                            }
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done with the slot
        }
    }
    __syncthreads();  // every stage consumed: the ring is free

    // The block's tile into shared memory: consumer warp (wm, wn, wk)'s
    // partial at part[wk]. n8 tile j takes the thread's column 4 group + j
    // of its 32-column group as its column `group`, so C fragment row group
    // (+8), column 2 tig (+1) of tile j is tile column 32 g + 4 (2 tig (+1)) + j.
    Acc* part = reinterpret_cast<Acc*>(smem);
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
            Acc v = part[o];
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

    // W8A8, INT4 (f32 out): rank `split` takes quads of 4 adjacent outputs
    // split * THREADS + tid, stepping over the cluster, with 16-byte reads of
    // each rank's tile and of the scales and 16-byte stores (where the quads
    // are aligned: N % 4 == 0, no packed remainders)
    if constexpr (C::TMA) {
        if (!tail && a.N % 4 == 0 && a.ldo % 4 == 0) {
            using V = std::conditional_t<C::MODE == W8A8, int4, float4>;
            const int wq = (width + 3) / 4;  // quads per row (a last partial quad: N % 4 == 0)
            for (int i = split * C::THREADS + tid; i < rows * wq; i += splits * C::THREADS) {
                const int row = i / wq, t = 4 * (i % wq);
                const long long c = (long long)head * a.N + n0 + t;
                V v = *reinterpret_cast<const V*>(part + row * C::PP + t);
                if (splits > 1) {
                    cg::cluster_group cluster = cg::this_cluster();
                    V rv[MAX_SPLITS];
#pragma unroll
                    for (int r = 0; r < MAX_SPLITS; ++r)
                        if (r < splits)
                            rv[r] = *reinterpret_cast<const V*>(
                                cluster.map_shared_rank(part, r) + row * C::PP + t);
                    v = rv[0];  // ranks summed in rank order (the f32 sum from 0, as W8A16's)
                    if constexpr (C::MODE == INT4) v = make_float4(0.f + v.x, 0.f + v.y, 0.f + v.z,
                                                                   0.f + v.w);
#pragma unroll
                    for (int r = 1; r < MAX_SPLITS; ++r)
                        if (r < splits) {
                            v.x += rv[r].x;
                            v.y += rv[r].y;
                            v.z += rv[r].z;
                            v.w += rv[r].w;
                        }
                }
                float4 o;
                if constexpr (C::MODE == W8A8) {
                    const float xs = a.x_scale[m0 + row];
                    const float4 ws = *reinterpret_cast<const float4*>(a.w_scale + c);
                    o = make_float4(static_cast<float>(v.x) * xs * ws.x,
                                    static_cast<float>(v.y) * xs * ws.y,
                                    static_cast<float>(v.z) * xs * ws.z,
                                    static_cast<float>(v.w) * xs * ws.w);
                } else {
                    o = v;
                }
                *reinterpret_cast<float4*>(static_cast<float*>(a.out) + (m0 + row) * a.ldo + c) = o;
            }
            if (splits > 1) cg::this_cluster().sync();  // peers may still be reading this tile
            return;
        }
    }
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
        Acc v = part[row * C::PP + t];
        if (splits > 1) {
            // every rank's value requested before the first is added (the
            // remote loads overlap), then summed in rank order
            cg::cluster_group cluster = cg::this_cluster();
            Acc rv[MAX_SPLITS];
#pragma unroll
            for (int r = 0; r < MAX_SPLITS; ++r)
                rv[r] = r < splits ? cluster.map_shared_rank(part, r)[row * C::PP + t] : Acc(0);
            v = 0;
#pragma unroll
            for (int r = 0; r < MAX_SPLITS; ++r)
                if (r < splits) v += rv[r];
        }
        if constexpr (C::MODE == W8A16 || C::MODE == F32X3)
            store_out(a, m0 + row, c, v * a.w_scale[c]);
        else if constexpr (C::MODE == W8A8)
            store_out(a, m0 + row, c, static_cast<float>(v) * a.x_scale[m0 + row] * a.w_scale[c]);
        else
            store_out(a, m0 + row, c, v);
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

// cuTensorMapEncodeTiled, reached through the runtime (no link to the driver
// library), or null where the driver lacks it
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return fn;
}

// The tensor maps of a W8A8 or INT4 launch whose weights take 16-byte loads:
// - the weights: a stack of `count` (K, N) int8 weights is count * K rows of
//   N bytes, ldw apart; a box is one stage, BK rows x 128 columns, swizzled
//   128B. W8A8 reads them as 5-D, (N, r0, t, r1, b) for row k = 16 b + 4 t +
//   2 r1 + r0, strides (ldw, 4 ldw, 2 ldw, 16 ldw), so the box lays row k at
//   shared row 16 b + 8 r1 + 2 t + r0 = a8_row(k).
// - x: M rows of K int8 (W8A8, swizzled 64B) or of x_hi + K bf16 (INT4,
//   swizzled 128B), ldx elements apart; a box is BM rows x BK columns.
template <class C> cudaError_t make_maps(const Args& a, Maps& m) {
    PFN_cuTensorMapEncodeTiled_v12000 enc = encode_fn();
    if (enc == nullptr) return cudaErrorNotSupported;
    const cuuint64_t rows = (cuuint64_t)a.count * a.K, ldw = a.ldw;
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
    CUresult r;
    if constexpr (C::MODE == W8A8) {
        const cuuint64_t dims[5] = {(cuuint64_t)a.N, 2, 4, 2, rows / 16};
        const cuuint64_t strides[4] = {ldw, 4 * ldw, 2 * ldw, 16 * ldw};
        const cuuint32_t box[5] = {(cuuint32_t)C::BN, 2, 4, 2, (cuuint32_t)C::BK / 16};
        r = enc(&m.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<int8_t*>(a.w), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    } else {
        const cuuint64_t dims[2] = {(cuuint64_t)a.N, rows};
        const cuuint64_t strides[1] = {ldw};
        const cuuint32_t box[2] = {(cuuint32_t)C::BN, (cuuint32_t)C::BK};
        r = enc(&m.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(a.w), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    }
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    const cuuint64_t xdims[2] = {(cuuint64_t)(a.x_hi + a.K), (cuuint64_t)a.M};
    const cuuint64_t xstrides[1] = {(cuuint64_t)a.ldx * C::XE};
    const cuuint32_t xbox[2] = {(cuuint32_t)C::BK, (cuuint32_t)C::BM};
    r = enc(&m.x, C::MODE == W8A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(a.x), xdims, xstrides, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::XRB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class C, bool VEC>
int launch(const Args& a, cudaStream_t st) {
    // no split without a k tile: a drift between this file and gemm_plan
    // is refused, not run
    if (a.splits < 1 || a.splits > MAX_SPLITS || a.splits > (a.K + C::BK - 1) / C::BK)
        return (int)cudaErrorInvalidValue;
    const long long ny = column_blocks<C>(a), nz = (a.M + C::BM - 1) / C::BM;
    if (ny > 65535 || nz > 65535) return (int)cudaErrorInvalidValue;
    auto kern = ring_kernel<C, VEC>;
    static unsigned smem_set = 0;  // devices whose limit this instantiation raised
    cudaError_t err = set_smem_limit_once(kern, C::SMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    Maps maps = {};
    if constexpr (C::TMA && VEC) {
        err = make_maps<C>(a, maps);
        if (err != cudaSuccess) return (int)err;
    }
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
    err = cudaLaunchKernelEx(&cfg, kern, a, maps);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <class C> int launch_vec(const Args& a, cudaStream_t st) {
    return a.vec ? launch<C, true>(a, st) : launch<C, false>(a, st);
}

// Host checks the Python wrapper also makes; a call that breaks them is
// refused rather than read out of bounds. (F32X3's x is the prologue's
// terms: rows of 3 x_hi bf16, x_hi >= K a multiple of 8.)
template <int MODE> bool args_ok(const Args* a) {
    const int xe = MODE == W8A8 ? 1 : 2;  // bytes per x element
    return a->M > 0 && a->K > 0 && a->N > 0 && a->count > 0 &&
           (MODE == F32X3 || (a->K * xe) % 16 == 0) && (a->ldx * xe) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(a->x) % 16 == 0 &&
           a->ldw >= a->N && (a->w_scale != nullptr) == (MODE != INT4) &&
           (a->x_scale != nullptr) == (MODE == W8A8) &&
           (MODE == INT4 || MODE == F32X3 ? a->x_hi >= a->K && a->x_hi % 8 == 0 : a->x_hi == 0) &&
           (MODE != F32X3 || a->ldx == 3LL * a->x_hi) &&
           (MODE != F32X3 || a->count == 1) &&
           // W8A8, INT4: a stack's weights are count * K contiguous rows
           (MODE == W8A16 || a->count == 1 || a->w_sh == (long long)a->K * a->ldw) &&
           (!a->vec || (a->ldw % 16 == 0 && a->w_sh % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a->w) % 16 == 0));
}

int run_w8a16(const Args* a, void* stream) {
    if (!args_ok<W8A16>(a)) return (int)cudaErrorInvalidValue;
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

int run_w8a8(const Args* a, void* stream) {
    if (!args_ok<W8A8>(a)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (a->variant) {
        case 0: return launch_vec<Q0>(*a, st);
        case 1: return launch_vec<Q1>(*a, st);
        case 2: return launch_vec<Q2>(*a, st);
        case 3: return launch_vec<Q3>(*a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

int run_int4(const Args* a, void* stream) {
    if (!args_ok<INT4>(a)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (a->variant) {
        case 0: return launch_vec<I0>(*a, st);
        case 1: return launch_vec<I1>(*a, st);
        case 2: return launch_vec<I2>(*a, st);
        case 3: return launch_vec<I3>(*a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace ring

// F32X3's prologue: x (M, K) f32, rows ldx apart, into its three bf16
// terms, t (M, 3 Kp) rows [hi | mid | lo] (ring::split3), zeros from
// column K to Kp (a multiple of 8). A thread takes 8 columns of a row:
// 16-byte loads where x allows, three 16-byte stores.
__global__ void __launch_bounds__(256) split3_kernel(const float* __restrict__ x, long long ldx,
                                                     int M, int K, int Kp,
                                                     __nv_bfloat16* __restrict__ t) {
    const int chunks = Kp / 8;
    const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (ldx & 3) == 0;
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < (long long)M * chunks;
         i += gridDim.x * 256LL) {
        const long long row = i / chunks;
        const int k = 8 * static_cast<int>(i % chunks);
        float v[8];
        ring::load8(v, x + row * ldx + k, K - k, vec);
        uint4 w[3];
        ring::split3_8(v, w);
        __nv_bfloat16* d = t + row * 3 * Kp + k;
#pragma unroll
        for (int h = 0; h < 3; ++h) *reinterpret_cast<uint4*>(d + h * Kp) = w[h];
    }
}

namespace ring {

// F32X3 with instantiation C: the prologue writes x's terms into a.x, then
// the product. x (M, K) f32, rows ldx apart, is the caller's activation.
template <class C> int launch_f32(const Args& a, const float* x, long long ldx, cudaStream_t st) {
    if (x == nullptr || ldx < a.K) return (int)cudaErrorInvalidValue;
    const long long chunks = (long long)a.M * (a.x_hi / 8);
    const int blocks = static_cast<int>(std::min<long long>((chunks + 255) / 256, 4096));
    split3_kernel<<<blocks, 256, 0, st>>>(x, ldx, a.M, a.K, a.x_hi,
                                          static_cast<__nv_bfloat16*>(const_cast<void*>(a.x)));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_vec<C>(a, st);
}

int run_f32x3(const Args* a, const float* x, long long ldx, void* stream) {
    if (!args_ok<F32X3>(a)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (a->variant) {
        case 0: return launch_f32<F0>(*a, x, ldx, st);
        case 1: return launch_f32<F1>(*a, x, ldx, st);
        case 2: return launch_f32<F2>(*a, x, ldx, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace ring

// W8A8's activation pass: one block per row, 16-byte loads (8 bf16) a
// thread, 8-byte stores of the int8 row
__global__ void __launch_bounds__(256) quant_rows_kernel(const __nv_bfloat16* x, long long ldx,
                                                         int K, int8_t* x8, float* xs) {
    __shared__ float s_max[8];
    const int row = blockIdx.x, n8 = K / 8;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
    float m = 0.f;
    for (int c = threadIdx.x; c < n8; c += blockDim.x) {
        const uint4 u = xr[c];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, s_max[w]);
    const float s = fmaxf(m, 1e-8f) / 127.0f;
    uint2* out = reinterpret_cast<uint2*>(x8 + (long long)row * K);
    for (int c = threadIdx.x; c < n8; c += blockDim.x) {
        const uint4 u = xr[c];
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            // true divisions, rounded half to even, clipped
            const int q0 = static_cast<int>(fminf(fmaxf(rintf(f.x / s), -127.f), 127.f));
            const int q1 = static_cast<int>(fminf(fmaxf(rintf(f.y / s), -127.f), 127.f));
            w[e >> 1] |= ((static_cast<uint32_t>(q0) & 0xffu) |
                          ((static_cast<uint32_t>(q1) & 0xffu) << 8)) << (16 * (e & 1));
        }
        out[c] = make_uint2(w[0], w[1]);
    }
    if (threadIdx.x == 0) xs[row] = s;
}

}  // namespace w8
}  // namespace mosstts

// C entry points, bound with ctypes (ops/kernels/w8_gemm.py). Each returns
// the cudaGetLastError() after its launches.
extern "C" int mosstts_w8a16_gemm(const mosstts::w8::Args* args, void* stream) {
    return mosstts::w8::ring::run_w8a16(args, stream);
}

extern "C" int mosstts_int4_gemm(const mosstts::w8::Args* args, void* stream) {
    return mosstts::w8::ring::run_int4(args, stream);
}

// W8A8: ``x_bf16`` (M, K) rows ldx_bf16 apart (16-byte aligned) are
// quantized into args->x (int8 (M, K), contiguous) and args->x_scale (M,),
// then multiplied: two launches.
extern "C" int mosstts_w8a8_gemm(const mosstts::w8::Args* args, const void* x_bf16,
                                 long long ldx_bf16, void* stream) {
    if (args->M <= 0 || args->K <= 0 || args->K % 16 != 0 || args->ldx != args->K ||
        args->x_scale == nullptr || ldx_bf16 % 8 != 0 ||
        reinterpret_cast<uintptr_t>(x_bf16) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    mosstts::w8::quant_rows_kernel<<<args->M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x_bf16), ldx_bf16, args->K,
        static_cast<int8_t*>(const_cast<void*>(args->x)), const_cast<float*>(args->x_scale));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return mosstts::w8::ring::run_w8a8(args, stream);
}

// F32X3: ``x`` (M, K) f32 rows ``ldx`` floats apart; args->x is the
// (M, 3 Kp) bf16 buffer the prologue fills (args->x_hi = Kp): two launches.
extern "C" int mosstts_w8f32_gemm(const mosstts::w8::Args* args, const float* x, long long ldx,
                                  void* stream) {
    return mosstts::w8::ring::run_f32x3(args, x, ldx, stream);
}
