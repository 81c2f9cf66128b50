"""The bookkeeping of the W8A16 kernel (``csrc/w8_gemm.cu`` a16_kernel),
pinned on the CPU.

* ``w8a16_plan`` covers every k tile of every 8B product
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
* ``QuantWeight`` keeps a weight whose N is not a multiple of 16 at a
  16-byte row pitch: JAX's audio-head logits within 1e-5, the bridge's
  names and shapes unchanged, ``state_dict`` round-trips, and the pitch
  survives ``.to()``, ``deepcopy`` and pickling.
"""
import copy
import io
import pickle

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
from mosstts_tpu_torch.tools import kernel_inputs
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_

GEMM_8B = tuple((K, N, count or 1) for _, K, N, count, _ in kernel_inputs.GEMM_8B)
SMALL = ((256, 40, 1), (192, 96, 1), (64, 70, 5), (512, 1025, 3), (8, 16, 1), (4104, 130, 2))
MS = (1, 5, 16, 17, 64, 96, 128, 640)


def _smem(variant: int) -> int:
    """Dynamic shared memory of W8A16 instantiation ``variant``
    (``csrc/w8_gemm.cu`` ``a16::Cfg::SMEM``): its ring or its partial tiles."""
    mt, bn, _, _, wk, stages = w8_gemm.A16_VARIANTS[variant][:6]
    bk = w8_gemm.A16_STAGE_W // bn
    ring = stages * (bk * (bn + 16) + 16 * mt * (bk + 8) * 2)
    return max(ring, wk * 16 * mt * (bn + 1) * 4)


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


@pytest.mark.parametrize("K,N,count", GEMM_8B + SMALL)
def test_w8a16_plan_covers_every_k_tile_and_column_once(K, N, count):
    for sm in (132, 4):
        for M in MS:
            p = w8_gemm.w8a16_plan(M, K, N, count, sm)
            mt, bn = w8_gemm.A16_VARIANTS[p.variant][:2]
            assert (p.mt, p.bn, p.bk) == (mt, bn, w8_gemm.A16_STAGE_W // bn)
            assert p.row_tiles == -(-M // (16 * mt))
            assert p.row_tiles == 1 if M <= 128 else mt in (4, 6, 8)  # M <= 128: weights read once
            assert 1 <= p.splits <= w8_gemm.MAX_CLUSTER and p.k_tiles == -(-K // p.bk)
            covered = np.zeros(p.k_tiles, np.int64)
            for s in range(p.splits):  # csrc/w8_gemm.cu a16_kernel's k_begin, k_end
                span = covered[s * p.k_tiles // p.splits:(s + 1) * p.k_tiles // p.splits]
                assert span.size > 0  # no empty split
                span += 1
            assert (covered == 1).all()
            blocks = _columns(p, N, count)
            assert len(blocks) == count * p.tiles + p.tail_blocks <= 65535
            cols = [c for b in blocks for c in b if c is not None]
            assert len(cols) == len(set(cols)) == count * N
            # a power-of-two split (or all k tiles); at decode one giving
            # about one block per SM where K has the k tiles for it
            assert p.splits & (p.splits - 1) == 0 or p.splits == p.k_tiles
            n = len(blocks) * p.row_tiles
            assert p.mt > 1 or n * p.splits >= 0.9 * sm or 2 * p.splits > min(
                w8_gemm.MAX_CLUSTER, p.k_tiles)
            assert _smem(p.variant) <= 232448  # an H100 block's shared memory


def a16_tile_walk(x, q, scale, plan):
    """The W8A16 kernel's arithmetic in plain PyTorch, f32: x (M, K) f32,
    q (count, K, N) int8, scale (count, N) -> (M, count, N)."""
    M, K = x.shape
    count, _, N = q.shape
    bn, wk = w8_gemm.A16_VARIANTS[plan.variant][1], w8_gemm.A16_VARIANTS[plan.variant][4]
    bm, bk = 16 * plan.mt, plan.bk
    ksw = bk // 16 // wk
    out = torch.zeros(M, count, N)
    for cols in _columns(plan, N, count):
        w = torch.zeros(K, bn)  # the block's weight columns, tile order
        for t, c in enumerate(cols):
            if c is not None:
                w[:, t] = q[c[0], :, c[1]].float()
        for m0 in range(0, M, bm):
            xr = torch.zeros(bm, K)
            xr[:min(bm, M - m0)] = x[m0:m0 + bm]
            total = torch.zeros(bm, bn)
            for s in range(plan.splits):  # rank s of the cluster
                kb = s * plan.k_tiles // plan.splits * bk
                ke = min(K, (s + 1) * plan.k_tiles // plan.splits * bk)
                warps = torch.zeros(wk, bm, bn)
                for k0 in range(kb, ke, bk):  # ring tiles
                    for step in range(bk // 16):
                        rows = k0 + step * 16 + torch.arange(16)
                        live = rows < ke
                        a = torch.where(live, xr[:, rows.clamp(max=K - 1)], 0.0)
                        b = torch.where(live[:, None], w[rows.clamp(max=K - 1)], 0.0)
                        for g in range(bn // 32):
                            for j in range(4):  # n8 tile j: logical n is column 32 g + 4 n + j
                                phys = g * 32 + 4 * torch.arange(8) + j
                                warps[step // ksw][:, phys] += a @ b[:, phys]
                part = warps[0]
                for i in range(1, wk):  # the k-split warps, in warp order
                    part = part + warps[i]
                total = total + part  # ranks in rank order
            for t, c in enumerate(cols):
                if c is not None:
                    out[m0:m0 + bm, c[0], c[1]] = (total[:, t] * scale[c[0], c[1]])[:M - m0]
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
    plan = w8_gemm.w8a16_plan(M, K, N, count, sm)
    got = a16_tile_walk(x, q, s, plan)
    ref = w8_gemm.w8a16_gemm_ref(x, q, s, torch.float32)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if count > 1:
        want = np.asarray(jd._audio_head_logits(jnp.asarray(x.numpy())[None], jw))[0]
    else:
        want = np.asarray(jbasic.dense(jnp.asarray(x.numpy()), jw))[:, None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_w8a16_plan_splits_only_what_leaves_the_card_idle():
    """Decode on the narrow 8B backbone weights splits K (a block for every
    SM); a launch that fills the card does not; prefill up to 128 rows is
    one row tile (the weights streamed once)."""
    plan = w8_gemm.w8a16_plan
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
