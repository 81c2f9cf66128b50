"""The bookkeeping of the int8-weight GEMM kernel (``csrc/w8_gemm.cu``
``ring_kernel``, modes W8A16, W8A8 and INT4), pinned on the CPU.

* ``gemm_plan`` covers every k tile of every 8B product
  (``tools/kernel_inputs.py`` ``GEMM_8B``) and of small shapes exactly once, with at most
  ``MAX_CLUSTER`` splits and none empty, and every output column of every
  weight exactly once (full tiles, a narrow last tile, or packed remainders).
* A plain emulation of the kernel's walk (ring tiles of ``bk`` rows, k16
  steps split over the warps, n8 tiles whose logical column n is tile
  column 4n + j (a thread reads 4 adjacent columns as one word), the
  k-split warps' partials summed in warp order, the cluster's ranks in rank
  order, then the scale)
  agrees with ``w8a16_gemm_ref`` and with JAX ``dense`` /
  ``_audio_head_logits`` on a ``QuantWeight`` within 1e-5 in f32.
* W8A8 and INT4: the plan covers every k tile and column once at the
  tools' shapes and the card tests'; the W8A8 fragment build (four word
  loads of a row-permuted tile, a 4x4 byte transpose by byte permutes)
  gives every lane the ``m16n8k32`` B fragment a direct gather gives, from
  conflict-free reads; the INT4 nibble -> bf16 conversion (nibble ^ 8 in
  a bf16 128's mantissa, minus 136) equals ``unpack_int4`` over all 256
  bytes; and the walk's emulation equals ``w8a8_gemm_ref`` exactly and
  the JAX ``tools/tune_mm8.py`` W8A8 walk (interpret mode), and
  ``int4_gemm_ref`` and the numpy transcription of
  ``tools/probe_int4.py::_mm4_kernel`` within 1e-5.
* ``QuantWeight`` keeps a weight whose N is not a multiple of 16 at a
  16-byte row pitch: JAX's audio-head logits within 1e-5, the bridge's
  names and shapes unchanged, ``state_dict`` round-trips, and the pitch
  survives ``.to()``, ``deepcopy`` and pickling.
"""
import copy
import importlib.util
import io
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.models import delay as jd
from mosstts_tpu.ops import basic as jbasic
from mosstts_tpu.ops import quant as jq
from mosstts_tpu_torch.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops import quant as tq
from mosstts_tpu_torch.ops.kernels import w8_gemm
from mosstts_tpu_torch.tools import kernel_inputs, tune_mm8
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_

GEMM_8B = tuple((K, N, count or 1) for _, K, N, count, _ in kernel_inputs.GEMM_8B)
SMALL = ((256, 40, 1), (192, 96, 1), (64, 70, 5), (512, 1025, 3), (8, 16, 1), (4104, 130, 2))
MS = (1, 5, 16, 17, 64, 96, 128, 640)


def _smem(variant: int, mode: int = w8_gemm.W8A16) -> int:
    """Dynamic shared memory of instantiation ``variant`` of ``mode``
    (``csrc/w8_gemm.cu`` ``ring::Cfg::SMEM``): its ring (the weight tile and
    one x tile, two for INT4, int8 for W8A8) or its partial tiles. W8A16's
    rows are padded by 16 bytes; W8A8's and INT4's are dense (the tensor
    memory accelerator's swizzle) with 1 KB to align the ring."""
    mt, bn, _, _, wk, stages = w8_gemm.VARIANTS[mode][variant][:6]
    bk = w8_gemm.STAGE_W // bn
    xe = 1 if mode == w8_gemm.W8A8 else 2
    nx = 2 if mode == w8_gemm.INT4 else 1
    tma = mode != w8_gemm.W8A16
    rowp, xp = (bn, bk) if tma else (bn + 16, bk + 16 // xe)
    ring = stages * (bk * rowp + nx * 16 * mt * xp * xe)
    return max(ring, wk * 16 * mt * (bn + (4 if tma else 1)) * 4) + 1024 * tma


def _columns(plan, N, count):
    """Per column block, its tile columns' (weight, column) or None."""
    bn, blocks = plan.bn, []
    for h in range(count):
        for ti in range(plan.tiles):
            blocks.append([(h, ti * bn + t) if ti * bn + t < N else None for t in range(bn)])
    n0, ch = plan.tiles * bn, bn // 16
    for tb in range(plan.tail_blocks):
        blocks.append([(tb * ch + t // 16, n0 + t % 16)
                       if n0 + t % 16 < N and tb * ch + t // 16 < count else None
                       for t in range(bn)])
    return blocks


def _check_plan(M, K, N, count, sm, mode):
    p = w8_gemm.gemm_plan(M, K, N, count, sm, mode=mode)
    spec = w8_gemm.VARIANTS[mode][p.variant]
    mt, bn = spec[:2]
    assert (p.mt, p.bn, p.bk) == (mt, bn, w8_gemm.STAGE_W // bn)
    assert p.row_tiles == -(-M // (16 * mt))
    assert p.row_tiles == 1 if M <= 128 else mt in (4, 6, 8)  # M <= 128: weights read once
    assert 1 <= p.splits <= w8_gemm.MAX_CLUSTER and p.k_tiles == -(-K // p.bk)
    covered = np.zeros(p.k_tiles, np.int64)
    for s in range(p.splits):  # csrc/w8_gemm.cu ring_kernel's k_begin, k_end
        span = covered[s * p.k_tiles // p.splits:(s + 1) * p.k_tiles // p.splits]
        assert span.size > 0  # no empty split
        span += 1
    assert (covered == 1).all()
    blocks = _columns(p, N, count)
    assert len(blocks) == count * p.tiles + p.tail_blocks <= 65535
    cols = [c for b in blocks for c in b if c is not None]
    assert len(cols) == len(set(cols)) == count * N
    # a power-of-two split (or all k tiles); at decode one giving about
    # one block per SM where K has the k tiles for it
    assert p.splits & (p.splits - 1) == 0 or p.splits == p.k_tiles
    n = len(blocks) * p.row_tiles
    assert p.mt > 1 or n * p.splits >= 0.9 * sm or 2 * p.splits > min(
        w8_gemm.MAX_CLUSTER, p.k_tiles)
    # an H100 block's shared memory, and MINB blocks an SM (each with the
    # 1 KB the card reserves and the ring's mbarriers) in the SM's 228 KB
    smem = _smem(p.variant, mode)
    assert smem <= 232448 and spec[7] * (smem + 1024 + 128) <= 233472
    # the mma k steps of a stage split evenly over the WK warps
    ks = 32 if mode == w8_gemm.W8A8 else 16
    assert (p.bk // ks) % spec[4] == 0 and spec[0] % spec[2] == 0 and (bn // 32) % spec[3] == 0
    return p


@pytest.mark.parametrize("K,N,count", GEMM_8B + SMALL)
def test_w8a16_plan_covers_every_k_tile_and_column_once(K, N, count):
    for sm in (132, 4):
        for M in MS:
            _check_plan(M, K, N, count, sm, w8_gemm.W8A16)


# W8A8 at the tool's (4096, 12288) and the card tests' (K, N, count); INT4
# the same with K packed rows (the tool's (2048, 12288)). W8A8 needs K % 16,
# INT4 K % 8
TOOL_SHAPES = ((4096, 12288, 1), (2048, 12288, 1), (512, 1024, 1), (256, 512, 1), (4096, 1024, 1),
               (1024, 1000, 1), (512, 384, 1), (512, 1000, 3), (256, 512, 4), (32, 384, 1),
               (64, 70, 5), (4112, 130, 2))


@pytest.mark.parametrize("mode", [w8_gemm.W8A8, w8_gemm.INT4])
@pytest.mark.parametrize("K,N,count", TOOL_SHAPES)
def test_w8a8_int4_plan_covers_every_k_tile_and_column_once(mode, K, N, count):
    for sm in (132, 4):
        for M in MS + (200,):
            _check_plan(M, K, N, count, sm, mode)


def tile_walk(x, q, scale, plan, mode=w8_gemm.W8A16, x_scale=None):
    """The kernel's arithmetic in plain PyTorch -> (M, count, N).
    W8A16: x (M, K) f32, q (count, K, N) int8, f32 sums, then the scale.
    W8A8: x (M, K) the int8 rows, their ``x_scale`` (M, 1), int sums (in
    float64: exact), then f32(sum) * x_scale * scale. INT4: x (M, 2K) f32,
    q (count, K, N) packed, f32 sums of the low nibbles (``nibbles``)
    times x's first half and the high ones times its second, no scale."""
    M = x.shape[0]
    count, K, N = q.shape
    spec = w8_gemm.VARIANTS[mode][plan.variant]
    bn, wk = spec[1], spec[4]
    bm, bk = 16 * plan.mt, plan.bk
    ks = 32 if mode == w8_gemm.W8A8 else 16  # k rows per mma step
    ksw = bk // ks // wk
    dt = torch.float64 if mode == w8_gemm.W8A8 else torch.float32
    halves = 2 if mode == w8_gemm.INT4 else 1
    out = torch.zeros(M, count, N)
    for cols in _columns(plan, N, count):
        w = torch.zeros(halves, K, bn, dtype=dt)  # the block's weight columns, tile order
        for t, c in enumerate(cols):
            if c is not None:
                if mode == w8_gemm.INT4:
                    w[:, :, t] = torch.stack(nibbles(q[c[0], :, c[1]])).to(dt)
                else:
                    w[0, :, t] = q[c[0], :, c[1]].to(dt)
        for m0 in range(0, M, bm):
            xr = torch.zeros(halves, bm, K, dtype=dt)  # INT4: columns k and K + k
            for h in range(halves):
                xr[h, :min(bm, M - m0)] = x[m0:m0 + bm, h * K:(h + 1) * K].to(dt)
            total = torch.zeros(bm, bn, dtype=dt)
            for s in range(plan.splits):  # rank s of the cluster
                kb = s * plan.k_tiles // plan.splits * bk
                ke = min(K, (s + 1) * plan.k_tiles // plan.splits * bk)
                warps = torch.zeros(wk, bm, bn, dtype=dt)
                for k0 in range(kb, ke, bk):  # ring tiles
                    for step in range(bk // ks):
                        rows = k0 + step * ks + torch.arange(ks)
                        live = rows < ke
                        a = torch.where(live, xr[:, :, rows.clamp(max=K - 1)], 0.0)
                        b = torch.where(live[:, None], w[:, rows.clamp(max=K - 1)], 0.0)
                        for g in range(bn // 32):
                            for j in range(4):  # n8 tile j: logical n is column 32 g + 4 n + j
                                phys = g * 32 + 4 * torch.arange(8) + j
                                for h in range(halves):
                                    warps[step // ksw][:, phys] += a[h] @ b[h][:, phys]
                part = warps[0]
                for i in range(1, wk):  # the k-split warps, in warp order
                    part = part + warps[i]
                total = total + part  # ranks in rank order
            total = total.float()
            for t, c in enumerate(cols):
                if c is not None:
                    v = total[:, t]
                    if mode == w8_gemm.W8A8:
                        v = v[:M - m0] * x_scale[m0:m0 + bm, 0]
                    if mode != w8_gemm.INT4:
                        v = v * scale[c[0], c[1]]
                    out[m0:m0 + bm, c[0], c[1]] = v[:M - m0]
    return out


@pytest.mark.parametrize("M,K,N,count,sm", [(5, 256, 40, 1, 4), (3, 192, 96, 3, 8),
                                            (20, 128, 70, 5, 2), (40, 256, 64, 1, 1),
                                            (1, 520, 130, 2, 4)])
def test_w8a16_tile_walk_matches_plain_and_jax(M, K, N, count, sm):
    rng = np.random.default_rng(M + K + N)
    x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16).float()
    w = rng.standard_normal((count, K, N)).astype(np.float32) * 0.05
    jw = jq.quantize_weight(jnp.asarray(w if count > 1 else w[0]))
    q = torch.tensor(np.asarray(jw.q)).reshape(count, K, N)
    s = torch.tensor(np.asarray(jw.scale)).reshape(count, N)
    plan = w8_gemm.gemm_plan(M, K, N, count, sm)
    got = tile_walk(x, q, s, plan)
    ref = w8_gemm.w8a16_gemm_ref(x, q, s, torch.float32)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if count > 1:
        want = np.asarray(jd._audio_head_logits(jnp.asarray(x.numpy())[None], jw))[0]
    else:
        want = np.asarray(jbasic.dense(jnp.asarray(x.numpy()), jw))[:, None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm`` for selector nibbles below 8: byte i of the
    result is byte ``sel >> 4 i & 7`` of y:x."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def transpose4(w):
    """``ring::transpose4``: four words, each 4 bytes of one row, to four
    words, each the 4 rows' bytes of one column."""
    a, b = byte_perm(w[0], w[1], 0x5140), byte_perm(w[2], w[3], 0x5140)
    c, d = byte_perm(w[0], w[1], 0x7362), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(a, b, 0x5410), byte_perm(a, b, 0x7632), byte_perm(c, d, 0x5410),
            byte_perm(c, d, 0x7632)]


def _bf16x2(u: int):
    """The two bf16 halves of a word as floats, the low half first."""
    return np.array([(u & 0xFFFF) << 16, (u >> 16) << 16], np.uint32).view(np.float32)


def nibble_pairs(u: int, v: int, j: int):
    """``ring::nibble_pairs``: the signed low and high nibbles of byte j of
    u and of v as bf16x2 pairs, each nibble XOR 8 in a bf16 128's mantissa
    minus 136 (exact: the differences are small integers)."""
    p = byte_perm(u, v, j | (4 + j) << 8)
    lo, hi = (p & 0x000F000F) ^ 0x43084308, ((p >> 4) & 0x000F000F) ^ 0x43084308
    return _bf16x2(lo) - np.float32(136), _bf16x2(hi) - np.float32(136)


def nibbles(packed: torch.Tensor):
    """The same conversion over int8 bytes, elementwise: (lo, hi) f32."""
    b = packed.numpy().astype(np.uint8).astype(np.uint32)
    conv = (lambda n: torch.tensor(((n ^ 0x4308) << 16).view(np.float32) - np.float32(136)))
    return conv(b & 0xF), conv((b >> 4) & 0xF)


def a8_row(k: int) -> int:
    """``ring::a8_row``: W8A8's shared row of weight row k of a stage."""
    return (k & ~15) | (((k >> 2) & 3) << 1) | (k & 1) | (((k >> 1) & 1) << 3)


def swz(row: int, chunk: int, rb: int = 128) -> int:
    """``ring::swz``: the byte offset of 16-byte chunk ``chunk`` of row
    ``row`` of a tile of ``rb``-byte rows under the tensor memory
    accelerator's 128B (rb 128) or 64B (rb 64) swizzle."""
    return row * rb + ((chunk ^ ((row * rb >> 7) & (rb // 16 - 1))) << 4)


def test_w8a8_fragments_from_word_loads_and_a_byte_transpose():
    """The weight tile as the tensor copy lays it (row k at ``a8_row(k)``, a
    permutation of each 16 rows, through the 5-D map; its 16-byte chunks
    swizzled 128B), each lane's four word loads per k16 half and the byte
    transpose give every lane, k32 step, column group and n8 tile j the
    m16n8k32 B fragment (k 4 tig + r, byte r; then 16 + 4 tig + r) of its
    logical column n = group, tile column 32 g + 4 group + j; the 32 lanes
    of each load hit 32 distinct banks; and the x tile's ldmatrix rows
    (64-byte rows, swizzled 64B) too."""
    bn = 128
    bk = w8_gemm.STAGE_W // bn
    assert sorted(a8_row(k) for k in range(bk)) == list(range(bk))
    # the 5-D map's box order: row k = 16 b + 4 t + 2 r1 + r0 at 16 b + 8 r1 + 2 t + r0
    assert all(a8_row(16 * b + 4 * t + 2 * r1 + r0) == 16 * b + 8 * r1 + 2 * t + r0
               for b in range(bk // 16) for t in range(4) for r1 in (0, 1) for r0 in (0, 1))
    tile = np.random.default_rng(0).integers(0, 256, (bk, bn)).astype(np.uint8)
    smem = np.zeros(bk * bn, np.uint8)
    for k in range(bk):
        for c in range(bn // 16):
            o = swz(a8_row(k), c)
            smem[o:o + 16] = tile[k, 16 * c:16 * c + 16]
    for s in range(bk // 32):
        for g in range(bn // 32):
            banks = [set() for _ in range(8)]
            for lane in range(32):
                group, tig = lane >> 2, lane & 3
                offs = [swz(s * 32 + 2 * tig + (r & 1) + 8 * (r >> 1) + 16 * h,
                            2 * g + (group >> 2)) + (group & 3) * 4
                        for h in (0, 1) for r in range(4)]
                for i, o in enumerate(offs):
                    banks[i].add(o // 4 % 32)
                words = [int.from_bytes(smem[o:o + 4].tobytes(), "little") for o in offs]
                b0, b1 = transpose4(words[:4]), transpose4(words[4:])
                for j in range(4):
                    col = g * 32 + 4 * group + j
                    k = s * 32 + 4 * tig + np.arange(4)
                    assert b0[j] == int.from_bytes(tile[k, col].tobytes(), "little")
                    assert b1[j] == int.from_bytes(tile[k + 16, col].tobytes(), "little")
            assert all(len(b) == 32 for b in banks)  # conflict-free
    for rb in (64, 128):  # ldmatrix: 8 lanes give 8 rows' 16 bytes at one chunk
        for r0 in range(0, 128, 8):
            for c in range(rb // 16):
                banks = {(swz(r0 + i, c, rb) // 4 + w) % 32 for i in range(8) for w in range(4)}
                assert len(banks) == 32


def test_int4_nibble_conversion_is_exact_for_every_byte():
    """Over all 256 byte values, in either word of the pair and at every
    byte position j: ``nibble_pairs`` equals ``unpack_int4``'s low and high
    nibbles exactly."""
    vals = np.arange(256, dtype=np.uint32)
    lo, hi = w8_gemm.unpack_int4(torch.tensor(vals.astype(np.uint8).view(np.int8)))
    other = 0x5A
    for j in range(4):
        for b in vals:
            u, v = int(b) << 8 * j | 0x11111111 & ~(0xFF << 8 * j), other << 8 * j
            (l0, l1), (h0, h1) = nibble_pairs(u, v, j)
            assert (l0, h0) == (float(lo[b]), float(hi[b]))
            assert (l1, h1) == (float(lo[other]), float(hi[other]))
            (l0, l1), (h0, h1) = nibble_pairs(v, u, j)
            assert (l1, h1) == (float(lo[b]), float(hi[b]))
    got_lo, got_hi = nibbles(torch.tensor(vals.astype(np.uint8).view(np.int8)))
    assert torch.equal(got_lo, lo.float()) and torch.equal(got_hi, hi.float())


WALK_CASES = [(5, 256, 40, 1, 4), (3, 192, 96, 3, 8), (20, 128, 70, 5, 2), (40, 256, 64, 1, 1),
              (130, 96, 48, 1, 2), (1, 528, 130, 2, 4)]


@pytest.mark.parametrize("M,K,N,count,sm", WALK_CASES)
def test_w8a8_tile_walk_matches_plain(M, K, N, count, sm):
    """The W8A8 walk (int8 rows, k32 steps, int sums in warp then rank
    order, f32(sum) * x_scale * w_scale) equals ``w8a8_gemm_ref`` bit for
    bit: int32 sums are exact in any order."""
    rng = np.random.default_rng(M + K + N)
    x = torch.tensor(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    q = torch.tensor(rng.integers(-127, 128, (count, K, N)).astype(np.int8))
    s = torch.tensor(rng.uniform(1e-3, 2e-2, (count, N)).astype(np.float32))
    plan = w8_gemm.gemm_plan(M, K, N, count, sm, mode=w8_gemm.W8A8)
    x8, xs = w8_gemm.quant_rows(x)
    got = tile_walk(x8, q, s, plan, w8_gemm.W8A8, xs)
    ref = w8_gemm.w8a8_gemm_ref(x, q, s)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _test_module(name: str):
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_w8a8_tile_walk_matches_the_jax_tool():
    """The JAX ``tools/tune_mm8.py`` W8A8 walk in interpret mode (as
    ``tests/test_torch_gemm.py`` runs it) against the port's walk with
    each layer computed by the kernel's emulation: the tolerance of that
    test (a tanh chain through bf16 between layers), and the port walk's
    own result (its plain version) bit for bit."""
    gemm = _test_module("test_torch_gemm")
    tool = gemm._jax_tool("tune_mm8")
    L, D, O, B = 2, 256, 512, 8
    rng = np.random.default_rng(4)
    w8 = rng.integers(-127, 128, (L, D, O)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (L, O)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16)
    jargs = (x, jnp.asarray(w8), jnp.asarray(scale))
    want = np.asarray(tool.mm8_w8a8(*jargs, td=128, to=128, interpret=True)(*jargs))
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    tw, ts = torch.tensor(w8), torch.tensor(scale)
    plan = w8_gemm.gemm_plan(B, D, O, 1, 16, mode=w8_gemm.W8A8)
    assert plan.splits > 1

    def layer(h, li):
        x8, xs = w8_gemm.quant_rows(h)
        return tile_walk(x8, tw[li][None], ts[li][None], plan, w8_gemm.W8A8, xs)[:, 0]

    got = tune_mm8._walk(xt, L, layer)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    torch.testing.assert_close(got, tune_mm8.mm8_w8a8(xt, tw, ts), rtol=0, atol=0)


@pytest.mark.parametrize("M,K,N,count,sm", [(M, K // 2, N, c, sm) for M, K, N, c, sm in WALK_CASES])
def test_int4_tile_walk_matches_plain_and_the_probe_kernel(M, K, N, count, sm):
    """The INT4 walk (two bf16 x tiles, each packed row's low nibbles times
    x's first half and its high ones times the second, f32 sums in warp
    then rank order) against ``int4_gemm_ref`` and the numpy transcription
    of ``tools/probe_int4.py::_mm4_kernel`` within 1e-5."""
    rng = np.random.default_rng(M + K + N)
    x = torch.tensor(rng.standard_normal((M, 2 * K)).astype(np.float32)).to(torch.bfloat16)
    packed = torch.tensor(rng.integers(-128, 128, (count, K, N)).astype(np.int8))
    plan = w8_gemm.gemm_plan(M, K, N, count, sm, mode=w8_gemm.INT4)
    got = tile_walk(x.float(), packed, None, plan, w8_gemm.INT4)
    ref = torch.stack([w8_gemm.int4_gemm_ref(x, p) for p in packed], 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    mm4 = _test_module("test_torch_gemm")._mm4_numpy
    want = np.stack([mm4(x.float().numpy(), p.numpy()) for p in packed], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_w8a16_plan_splits_only_what_leaves_the_card_idle():
    """Decode on the narrow 8B backbone weights splits K (a block for every
    SM); a launch that fills the card does not; prefill up to 128 rows is
    one row tile (the weights streamed once)."""
    plan = w8_gemm.gemm_plan
    assert plan(16, 4096, 1024, 1, 132).splits == w8_gemm.MAX_CLUSTER  # wk / wv
    assert plan(1, 4096, 4096, 1, 132).splits == 2  # wq / wo: 64 column tiles
    # w_gate: 192 column tiles leave 60 SMs a second block and 72 idle; 384
    # fill three rounds
    assert plan(1, 4096, 12288, 1, 132).splits == 2
    assert plan(16, 4096, 151936, 1, 132).splits == 1  # text head
    assert plan(640, 4096, 12288, 1, 132).splits == 1
    assert plan(96, 4096, 12288, 1, 132).row_tiles == plan(128, 4096, 12288, 1, 132).row_tiles == 1
    heads = plan(16, 4096, 1025, 32, 132)  # one tail block per bn / 16 heads
    assert heads.tiles == 1024 // heads.bn and heads.tail_blocks == 32 // (heads.bn // 16)


CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)  # audio heads 1025 wide


def test_padded_quantweight_matches_jax_and_keeps_its_names():
    rng = np.random.default_rng(11)
    heads = rng.standard_normal((4, 64, 41)).astype(np.float32) * 0.05
    h = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(heads)), tq.quantize_weight(torch.tensor(heads))
    assert tw.q.shape == (4, 64, 41) and tw.q.stride() == (64 * 48, 48, 1)
    assert tw.q.stride(-2) % tq.ROW_PITCH == 0 and not tw.q.is_contiguous()
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    want = np.asarray(jd._audio_head_logits(jnp.asarray(h), jw))
    got = td._audio_head_logits(torch.tensor(h), tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the bridge's names and shapes, and a JAX tree loading into the padded buffer
    port = tq.quantize_tree_(td.DelayParams(CFG))
    assert port.audio_heads.q.stride(-2) % tq.ROW_PITCH == 0
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert shapes["audio_heads.q"] == (CFG.n_vq, CFG.language_config.hidden_size,
                                       CFG.audio_emb_vocab)
    assert CFG.audio_emb_vocab % tq.ROW_PITCH
    jtree = jax.device_get(jq.quantize_tree(
        jd.init_delay_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)))
    flat = flatten_tree(jtree)
    assert set(flat) == set(shapes)
    assert all(tuple(np.shape(v)) == shapes[n] for n, v in flat.items())
    load_tree_(port, jtree)
    np.testing.assert_array_equal(port.audio_heads.q.numpy(), np.asarray(flat["audio_heads.q"]))
    assert port.audio_heads.q.stride(-2) % tq.ROW_PITCH == 0


def test_padded_quantweight_round_trips_and_keeps_its_pitch():
    rng = np.random.default_rng(12)
    w = tq.quantize_weight(torch.tensor(rng.standard_normal((3, 32, 25)).astype(np.float32)))
    m = torch.nn.Module()
    m.heads = w
    buf = io.BytesIO()
    torch.save(m.state_dict(), buf)
    buf.seek(0)
    other = torch.nn.Module()
    other.heads = tq.quantize_weight(torch.zeros(3, 32, 25))
    other.load_state_dict(torch.load(buf))
    assert torch.equal(other.heads.q, w.q) and torch.equal(other.heads.scale, w.scale)
    for moved in (m.to("cpu", torch.float32), copy.deepcopy(m), pickle.loads(pickle.dumps(m)),
                  other):
        q = moved.heads.q
        assert q.shape == (3, 32, 25) and q.stride() == (32 * 32, 32, 1)
        assert torch.equal(q, w.q)
        assert torch.equal(moved.heads[1].q, w.q[1])  # the cached per-head view follows
