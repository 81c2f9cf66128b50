// Prefill flash attention for the Qwen3 backbone (causal GQA, left-pad mask,
// optional sliding window), bf16 or f32 in and out, f32 inside.
//
// Replaces: mosstts_tpu/ops/pallas/flash.py::flash_attention (_flash_kernel).
//
// What bounds it on the H100: bytes, at the main path's shapes. At B=4,
// T=160, H=32, KV=8, hd=128 the causal products are ~0.75 us of bf16
// tensor-core work against ~3.7 us of K/V/Q/out bytes; at the server's
// admission prefill (B=1, T=64-96) the grid is 32-48 blocks and each is
// latency bound. So the design keeps every K/V byte read once per block,
// in flight while the previous tile computes, and the arithmetic on the
// tensor cores so that it never becomes the limit.
//
// bf16 body (flash_tc_kernel, every head dim 64/128/256; what the main path
// runs):
// - GQA inside the block: one block per (tile of BM = 64 (query, head) rows,
//   KV head, batch row). Row r of a KV head's rows is query t = r / G, head
//   g = r % G, so the G heads that share the KV head share every K/V tile
//   the block loads; K/V are read once per (b, kvh, tile), not G times.
// - Tensor cores for both products: mma.sync.m16n8k16 bf16 -> f32, fragments
//   from ldmatrix (K non-transposed for S = Q.K^T, V with ldmatrix.trans for
//   O += P.V, since V is slot-major), the FlashAttention-2 register layout:
//   each of the 4 warps owns 16 rows, and the S accumulator of one tile
//   becomes the A operand of P.V without touching shared memory. mma.sync,
//   not wgmma: the products are ~5x under the byte time here, and the
//   16-row warp tile keeps the grid 4x finer than a 64-row warpgroup tile
//   would at the small admission prefills.
// - P is split in two bf16 terms, p_hi = bf16(p), p_lo = bf16(p - p_hi),
//   and P.V is the two MMAs P_hi.V + P_lo.V into one f32 accumulator: p
//   keeps ~16 bits, as the JAX kernel's f32 p does. A single bf16 P misses
//   the 2^-6 relative tolerance against the f32 plain version
//   (tests/test_torch_kernel_numerics.py pins both). The denominator sums
//   the unrounded f32 p.
// - Online softmax in registers: per query row an f32 running max,
//   denominator and accumulator (the thread's share of the row), exp2 of
//   scores pre-scaled by scale * log2(e); no score tile in shared memory.
// - K/V stay bf16 in shared memory, in a two-stage ring filled by 16-byte
//   cp.async copies (zero-filled past S): tile i+1 loads while tile i
//   computes. The tile's kv_valid bytes go to registers when it is issued
//   and to shared memory when its turn comes, so no warp stalls on them
//   (a blocking load there put one memory latency on every tile). Rows are
//   padded by 16 bytes (a stride of hd + 8 elements), so the 8 rows an
//   ldmatrix reads fall in 8 different bank groups. Blocks take their query
//   tiles last first: the last tiles walk the most K/V tiles.
// - Masking as the plain version: causal from q_start (a device int or a
//   host int), the kv_valid left pad, the optional window; the walk stops at
//   the tile's causal end and, with a window, starts at the first tile any
//   row of the block can see. Rows with no valid key are garbage by design.
// - cudaFuncSetAttribute (dynamic shared memory over 48 KB) runs once per
//   instantiation and device, not per launch.
//
// f32 body (flash_f32_kernel, the first version, kept for f32 inputs): the
// small f32 reference model and the card tests hold the kernel against
// plain f32 at f32 precision, which bf16 or TF32 products would not meet.
// It runs on the CUDA cores: one block per (32 query rows, query head,
// batch row), K/V staged as f32 in padded shared rows, 4 threads per query
// row splitting the tile's columns and the head dim.
//
// K/V arrive as (pointer, strides), so the kv-major cache layer k[li] of an
// (L, B, KV, S, hd) cache is read in place, never copied.
#include "common.cuh"

namespace mosstts {
namespace {

// ------------------------------- bf16 body ---------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // (query, head) rows per block, 16 per warp

template <int HD> struct Tile {
    static constexpr int BN = HD > 128 ? 32 : 64;  // key slots per tile
    static constexpr int LD = HD + 8;               // shared row stride (elements)
    static constexpr int CH = HD / 8;               // 16-byte chunks per row
    static constexpr size_t SMEM =
        sizeof(bf16) * (size_t)(BM * LD + 4 * BN * LD) + 2 * BN;  // Q, 2x(K, V), 2x valid
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x0, x1) -> hi = bf16 pair, lo = bf16 pair of the remainders
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
    hi = pack_bf16(h0, h1);
    lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                   __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ kv_valid, bf16* __restrict__ out,
    const int* __restrict__ q_start_ptr, int q_start_val,
    int T_len, int G, int S,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long valid_sb,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int window) {
    using TL = Tile<HD>;
    constexpr int BN = TL::BN, LD = TL::LD, CH = TL::CH;
    constexpr int NT = BN / 8;  // score n-tiles of 8 slots
    constexpr int DT = HD / 8;  // output n-tiles of 8 head-dim columns
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + BM * LD;      // [2][BN][LD]
    bf16* sV = sK + 2 * BN * LD;  // [2][BN][LD]
    uint8_t* sValid = reinterpret_cast<uint8_t*>(sV + 2 * BN * LD);  // [2][BN]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    // the last query tiles walk the most K/V tiles: they go first
    const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
    const int kvh = blockIdx.y, b = blockIdx.z;
    const int rows = T_len * G;
    const int q_start = q_start_ptr ? *q_start_ptr : q_start_val;

    // Q tile: row r is query t = (r0 + r) / G, head kvh * G + (r0 + r) % G
    const bf16* qb = q + b * q_sb + (long long)kvh * G * q_sh;
    for (int i = tid; i < BM * CH; i += THREADS) {
        const int r = i / CH, c = i % CH, rr = r0 + r;
        const bool in = rr < rows;
        const int t = in ? rr / G : 0, g = in ? rr % G : 0;
        cp_async16(smem_u32(sQ + r * LD + c * 8), qb + t * q_st + g * q_sh + c * 8, in);
    }

    const int last_row = min(r0 + BM, rows) - 1;
    const int n_end = min(S, q_start + last_row / G + 1);  // causal stop
    int n_begin = 0;
    if (window > 0) n_begin = max(0, q_start + r0 / G - window + 1) / BN * BN;
    const int n_tiles = n_end > n_begin ? (n_end - n_begin + BN - 1) / BN : 0;

    const bf16* kb = k + b * k_sb + kvh * k_sh;
    const bf16* vb = v + b * v_sb + kvh * v_sh;
    const uint8_t* valb = kv_valid + b * valid_sb;
    // tile `tile` into ring stage `stage` by cp.async; thread j < BN loads
    // slot j's validity byte into a register (pend_ok), stored to shared
    // memory when the tile's turn comes, so no warp waits on it here
    uint8_t pend_ok = 0;
    auto issue = [&](int tile, int stage) {
        const int n0 = n_begin + tile * BN;
        for (int i = tid; i < BN * CH; i += THREADS) {
            const int nn = i / CH, c = i % CH, s = n0 + nn;
            const bool in = s < S;
            const long long sc = in ? s : 0;
            cp_async16(smem_u32(sK + (stage * BN + nn) * LD + c * 8), kb + sc * k_ss + c * 8, in);
            cp_async16(smem_u32(sV + (stage * BN + nn) * LD + c * 8), vb + sc * v_ss + c * 8, in);
        }
        if (tid < BN) pend_ok = n0 + tid < S ? valb[n0 + tid] : 0;
    };

    if (n_tiles > 0) issue(0, 0);
    cp_async_commit();  // group 0: Q and tile 0

    // this thread's two rows of its warp's 16: gid and gid + 8
    int pos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int rr = r0 + warp * 16 + gid + 8 * i;
        pos[i] = q_start + (rr < rows ? rr / G : 0);
    }
    const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        if (tid < BN) sValid[st * BN + tid] = pend_ok;  // loaded one tile ago
        if (it + 1 < n_tiles) {
            issue(it + 1, st ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* tK = sK + st * BN * LD;
        const bf16* tV = sV + st * BN * LD;

        // S = Q K^T: 16 rows x BN slots per warp
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, smem_u32(sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                    (lane >> 4) * 8));
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t bk[4];
                ldmatrix_x4(bk, smem_u32(tK + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                         kk * 16 + ((lane >> 3) & 1) * 8));
                mma16816(s[j], a, bk[0], bk[1]);
                mma16816(s[j + 1], a, bk[2], bk[3]);
            }
        }

        // mask, then the online softmax of the thread's two rows
        const int n0 = n_begin + it * BN;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = j * 8 + tig * 2 + (e & 1);
                const int rel = pos[e >> 1] - (n0 + col);
                // slots past S stand for the plain version's zero padding: masked
                const bool ok = rel >= 0 && sValid[st * BN + col] != 0 &&
                                (window <= 0 || rel < window);
                s[j][e] = ok ? s[j][e] * sl2 : kNegInf;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            alpha[i] = exp2f(m[i] - mx[i]);
            m[i] = mx[i];
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[j][e] - m[e >> 1]);
                s[j][e] = p;
                l[e >> 1] += p;  // the thread's columns; the row's 4 threads sum at the end
            }
#pragma unroll
        for (int d = 0; d < DT; ++d) {
            o[d][0] *= alpha[0];
            o[d][1] *= alpha[0];
            o[d][2] *= alpha[1];
            o[d][3] *= alpha[1];
        }

        // O += P_hi V + P_lo V, 16 slots per step
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t ph[4], pl[4];
            split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
            split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
            split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
            split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
            for (int d = 0; d < DT; d += 2) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, smem_u32(tV + (kk * 16 + (lane & 7) +
                                                     ((lane >> 3) & 1) * 8) * LD +
                                               d * 8 + (lane >> 4) * 8));
                mma16816(o[d], ph, bv[0], bv[1]);
                mma16816(o[d], pl, bv[0], bv[1]);
                mma16816(o[d + 1], ph, bv[2], bv[3]);
                mma16816(o[d + 1], pl, bv[2], bv[3]);
            }
        }
        __syncthreads();  // the stage is free for tile it + 2
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int rr = r0 + warp * 16 + gid + 8 * i;
        if (rr < rows) {
            const float inv = 1.f / fmaxf(l[i], 1e-30f);
            bf16* ob = out + b * o_sb + (long long)(rr / G) * o_st +
                       (long long)(kvh * G + rr % G) * o_sh + tig * 2;
#pragma unroll
            for (int d = 0; d < DT; ++d)
                *reinterpret_cast<__nv_bfloat162*>(ob + d * 8) =
                    __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
        }
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           const int* q_start_ptr, int q_start_val, int B, int T_len, int H, int KV, int S,
           long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss,
           long long valid_sb, long long o_sb, long long o_st, long long o_sh,
           float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = Tile<HD>::SMEM;
    static unsigned attr_done = 0;
    auto kern = flash_tc_kernel<HD>;
    cudaError_t err = set_smem_limit_once(kern, (int)smem, attr_done);
    if (err != cudaSuccess) return (int)err;
    const int G = H / KV;
    dim3 grid((T_len * G + BM - 1) / BM, KV, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        valid, static_cast<bf16*>(out), q_start_ptr, q_start_val, T_len, G, S,
        q_sb, q_st, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, valid_sb,
        o_sb, o_st, o_sh, scale, window);
    return (int)cudaGetLastError();
}

}  // namespace tc

// -------------------------------- f32 body ---------------------------------
namespace f32 {

constexpr int BM = 32;        // query rows per block
constexpr int BN = 32;        // key columns per tile
constexpr int THREADS = 128;  // 4 threads per query row
constexpr int CPT = BN / 4;   // score columns per thread

template <int HD>
constexpr size_t smem_bytes() {
    // sQ, sK, sV with rows padded to HD+1 floats (no bank conflicts), plus sP
    return sizeof(float) * ((BM + 2 * BN) * (HD + 1) + BM * (BN + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kv_valid, float* __restrict__ out,
    const int* __restrict__ q_start_ptr, int q_start_val,
    int T_len, int G, int S,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long valid_sb,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int window) {
    constexpr int LD = HD + 1;
    constexpr int LP = BN + 1;
    constexpr int DPT = HD / 4;  // accumulator columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sK = sQ + BM * LD;
    float* sV = sK + BN * LD;
    float* sP = sV + BN * LD;

    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / G;
    const int q_start = q_start_ptr ? *q_start_ptr : q_start_val;
    const int r = tid >> 2;  // query row of this thread within the tile
    const int c4 = tid & 3;  // its place in the row's group of 4 threads

    const float* qb = q + b * q_sb + h * q_sh;
    for (int i = tid; i < BM * HD; i += THREADS) {
        const int rr = i / HD, d = i % HD;
        const int t = m0 + rr;
        sQ[rr * LD + d] = (t < T_len) ? qb[t * q_st + d] * scale : 0.f;
    }

    float m_i = kNegInf, l_i = 0.f;
    float acc[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

    const int row_pos = q_start + m0 + r;
    const int last_row = min(m0 + BM, T_len) - 1;
    const int n_end = min(S, q_start + last_row + 1);  // causal stop
    const float* kb = k + b * k_sb + kvh * k_sh;
    const float* vb = v + b * v_sb + kvh * v_sh;
    const uint8_t* valb = kv_valid + b * valid_sb;

    for (int n0 = 0; n0 < n_end; n0 += BN) {
        __syncthreads();  // Q stored / previous tile fully consumed
        for (int i = tid; i < BN * HD; i += THREADS) {
            const int nn = i / HD, d = i % HD;
            const int s = n0 + nn;
            const bool in = s < S;
            sK[nn * LD + d] = in ? kb[s * k_ss + d] : 0.f;
            sV[nn * LD + d] = in ? vb[s * v_ss + d] : 0.f;
        }
        __syncthreads();

        float sc[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
            const float qd = sQ[r * LD + d];
#pragma unroll
            for (int j = 0; j < CPT; ++j) sc[j] += qd * sK[(c4 + 4 * j) * LD + d];
        }

        float tile_max = kNegInf;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const int s = n0 + c4 + 4 * j;
            const int rel = row_pos - s;
            // columns past S stand for the reference's zero padding: masked
            const bool ok = s < S && rel >= 0 && valb[s] != 0 &&
                            (window <= 0 || rel < window);
            sc[j] = ok ? sc[j] : kNegInf;
            tile_max = fmaxf(tile_max, sc[j]);
        }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(m_i, tile_max);
        const float alpha = expf(m_i - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const float p = expf(sc[j] - m_new);
            psum += p;
            sP[r * LP + c4 + 4 * j] = p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l_i = alpha * l_i + psum;
        m_i = m_new;
        __syncwarp();  // a row's sP entries come from the 4 threads of its warp

#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
#pragma unroll 4
        for (int nn = 0; nn < BN; ++nn) {
            const float p = sP[r * LP + nn];
#pragma unroll
            for (int j = 0; j < DPT; ++j) acc[j] += p * sV[nn * LD + c4 + 4 * j];
        }
    }

    const int t = m0 + r;
    if (t < T_len) {
        const float denom = fmaxf(l_i, 1e-30f);
        float* ob = out + b * o_sb + t * o_st + h * o_sh;
#pragma unroll
        for (int j = 0; j < DPT; ++j) ob[c4 + 4 * j] = acc[j] / denom;
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           const int* q_start_ptr, int q_start_val, int B, int T_len, int H, int KV, int S,
           long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss,
           long long valid_sb, long long o_sb, long long o_st, long long o_sh,
           float scale, int window, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD>();
    static unsigned attr_done = 0;
    auto kern = flash_f32_kernel<HD>;
    cudaError_t err = set_smem_limit_once(kern, (int)smem, attr_done);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T_len + BM - 1) / BM, H, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), valid, static_cast<float*>(out), q_start_ptr,
        q_start_val, T_len, H / KV, S, q_sb, q_st, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        valid_sb, o_sb, o_st, o_sh, scale, window);
    return (int)cudaGetLastError();
}

}  // namespace f32

#define MOSSTTS_FLASH_ARGS                                                                 \
    q, k, v, valid, out, qs, q_start_val, B, T_len, H, KV, S, q_sb, q_st, q_sh, k_sb, k_sh, \
        k_ss, v_sb, v_sh, v_ss, valid_sb, o_sb, o_st, o_sh, scale, window, st

}  // namespace
}  // namespace mosstts

// C entry point, bound with ctypes (ops/kernels/flash.py). Strides are in
// elements; the head dim is contiguous in q, k, v and out. bf16 inputs need
// 16-byte aligned rows (base pointers and the q/k/v row strides; the
// wrapper checks). q_start is read from device memory when q_start_ptr is
// non-null (no host sync), else q_start_val is used. window <= 0 means no
// sliding window. Returns the cudaGetLastError() after the launch.
extern "C" int mosstts_flash_attention(
    const void* q, const void* k, const void* v, const void* kv_valid, void* out,
    const void* q_start_ptr, int q_start_val,
    int B, int T_len, int H, int KV, int S, int hd,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long valid_sb, long long o_sb, long long o_st, long long o_sh,
    float scale, int window, int dtype, void* stream) {
    using namespace mosstts;
    const uint8_t* valid = static_cast<const uint8_t*>(kv_valid);
    const int* qs = static_cast<const int*>(q_start_ptr);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
    if (dtype == kBF16) {
        switch (hd) {
            case 64: return tc::launch<64>(MOSSTTS_FLASH_ARGS);
            case 128: return tc::launch<128>(MOSSTTS_FLASH_ARGS);
            case 256: return tc::launch<256>(MOSSTTS_FLASH_ARGS);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == kF32) {
        switch (hd) {
            case 64: return f32::launch<64>(MOSSTTS_FLASH_ARGS);
            case 128: return f32::launch<128>(MOSSTTS_FLASH_ARGS);
            case 256: return f32::launch<256>(MOSSTTS_FLASH_ARGS);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}
