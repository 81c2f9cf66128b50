"""The arithmetic the port's redesigned attention kernels depend on, pinned on
the CPU.

* ``csrc/flash_attn.cu``'s bf16 body multiplies P.V on the tensor cores with
  P split in two bf16 terms (p_hi = bf16(p), p_lo = bf16(p - p_hi)). A plain
  emulation of its tile walk (64-slot K/V tiles, an online softmax in
  log2 units, both products summed in f32 from bf16 operands) agrees with
  ``flash_attention_ref`` within the smoke's tolerance (2^-6 relative +
  1e-5, on bf16 outputs); the same walk with P rounded once to bf16 does
  not, so the split cannot be dropped unnoticed.
* ``csrc/decode_kernel.cuh`` splits the attended slots over a thread-block
  cluster and merges the blocks' (max, denominator, accumulator) records in
  rank order. ``decode_plan`` covers every slot of [0, attend_len) exactly
  once with at most 8 blocks and no empty one, and the emulated merge agrees
  with ``decode_attention_ref`` (bf16, the smoke's tolerance) and with the
  JAX decode kernel in interpret mode (f32, within 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.ops.pallas.decode_attn import decode_attention as jax_decode_attention
from mosstts_tpu_torch.ops.attention import NEG_INF
from mosstts_tpu_torch.ops.kernels import decode_attn, flash

REL_TOL, ABS_TOL = 2.0 ** -6, 1e-5  # chip_smoke.py's kernel-vs-plain tolerance
LOG2E = 1.4426950408889634


def _over_tolerance(out, ref, rows=None):
    err = (out.float() - ref.float()).abs()
    bound = REL_TOL * ref.float().abs() + ABS_TOL
    over = err > bound
    return int(over[rows].sum() if rows is not None else over.sum())


def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def flash_tile_walk(q, k, v, kv_valid, q_start, *, scale, window=None, split=True, bn=64):
    """The bf16 flash kernel's arithmetic in plain PyTorch: q (B, T, H, hd),
    kv-major k/v (B, KV, S, hd), all bf16. Scores are exact bf16 products
    summed in f32, scaled into log2 units; per 64-slot tile the running max
    moves and the accumulator is rescaled; P.V takes P as p_hi + p_lo (or,
    with ``split=False``, p_hi alone) against bf16 V, summed in f32; the
    denominator sums the unrounded p."""
    B, T, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, hd).permute(0, 2, 3, 1, 4)  # (B, KV, G, T, hd)
    pos = q_start + torch.arange(T)
    m = torch.full((B, KV, G, T, 1), NEG_INF)
    l = torch.zeros((B, KV, G, T, 1))
    acc = torch.zeros((B, KV, G, T, hd))
    for n0 in range(0, min(S, q_start + T), bn):
        kt, vt = k[:, :, None, n0:n0 + bn].float(), v[:, :, None, n0:n0 + bn].float()
        s = qf @ kt.transpose(-1, -2) * (scale * LOG2E)  # (B, KV, G, T, bn)
        rel = pos[:, None] - torch.arange(n0, n0 + kt.shape[-2])[None]
        ok = (rel >= 0) & kv_valid[:, None, None, None, n0:n0 + bn]
        if window is not None:
            ok = ok & (rel < window)
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(torch.bfloat16)


def _flash_case(seed, B, T, H, KV, S, hd, q_start, pads):
    rng = np.random.default_rng(seed)
    q, k, v = _bf16(rng, B, T, H, hd), _bf16(rng, B, KV, S, hd), _bf16(rng, B, KV, S, hd)
    valid = torch.zeros((B, S), dtype=torch.bool)
    for b, pad in enumerate(pads):
        valid[b, pad:q_start + T] = True
    return q, k, v, valid, valid[:, q_start:q_start + T]


@pytest.mark.parametrize("B,T,H,KV,S,hd,q_start,pads,window", [
    (2, 160, 8, 2, 160, 128, 0, (0, 0), None),  # the issue's model: 8 heads, T = S = 160
    (4, 160, 8, 2, 512, 128, 0, (0, 17, 40, 95), None),  # the 8B prefill, left-padded
    (1, 96, 8, 2, 1024, 128, 0, (11,), None),  # the server's admission, kv-major
    (2, 70, 12, 4, 300, 64, 111, (3, 60), 50),  # G = 3, q_start > 0, a window
    (1, 33, 4, 2, 100, 256, 40, (0,), None),  # hd 256: 32-slot tiles
])
def test_split_p_flash_walk_matches_plain(B, T, H, KV, S, hd, q_start, pads, window):
    q, k, v, valid, rows = _flash_case(hd + T, B, T, H, KV, S, hd, q_start, pads)
    ref = flash.flash_attention_ref(q, k, v, valid, q_start, scale=hd ** -0.5, window=window,
                                    kv_major=True)
    out = flash_tile_walk(q, k, v, valid, q_start, scale=hd ** -0.5, window=window,
                          bn=32 if hd > 128 else 64)
    assert _over_tolerance(out, ref, rows) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_single_bf16_p_misses_the_tolerance(seed):
    """B*H = 8 heads, T = S = 160 causal, hd = 128, N(0, 1) bf16 inputs: with
    P rounded once to bf16 thousands of outputs leave the tolerance the
    split meets."""
    q, k, v, valid, rows = _flash_case(seed, 2, 160, 4, 1, 160, 128, 0, (0, 0))
    ref = flash.flash_attention_ref(q, k, v, valid, 0, scale=128 ** -0.5, kv_major=True)
    single = flash_tile_walk(q, k, v, valid, 0, scale=128 ** -0.5, split=False)
    split = flash_tile_walk(q, k, v, valid, 0, scale=128 ** -0.5)
    assert _over_tolerance(split, ref, rows) == 0
    assert _over_tolerance(single, ref, rows) > 1000


# ------------------------------ decode -------------------------------------

@pytest.mark.parametrize("value_bytes", [1, 2, 4])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_decode_plan_covers_every_slot_once(value_bytes, head_dim):
    step = decode_attn.tile_slots(head_dim, value_bytes)
    for B in (1, 2, 4, 16, 64):
        for attend in list(range(1, 300)) + [511, 512, 513, 1000, 1024, 4096]:
            cluster, chunk = decode_attn.decode_plan(B, 8, attend, head_dim, value_bytes)
            assert 1 <= cluster <= decode_attn.MAX_CLUSTER
            assert chunk % step == 0
            covered = np.zeros(attend, np.int64)
            for r in range(cluster):
                span = covered[r * chunk:min((r + 1) * chunk, attend)]
                assert span.size > 0  # no rank without a slot
                span += 1
            assert (covered == 1).all()


def cluster_merge(q, k, v, kv_valid, *, scale, attend_len, cluster, chunk):
    """The decode kernel's split and merge in plain PyTorch, f32: rank r's
    record (max, denominator, accumulator) over slots [r * chunk, ...), an
    invalid slot scoring -1e30; records merged in rank order. q (B, H, hd),
    k/v (B, KV, S, hd)."""
    B, H, hd = q.shape
    KV = k.shape[1]
    qf = (q.float() * scale).reshape(B, KV, H // KV, hd)
    recs = []
    for r in range(cluster):
        lo, hi = r * chunk, min((r + 1) * chunk, attend_len)
        s = torch.einsum("bkgh,bksh->bkgs", qf, k[:, :, lo:hi].float())
        s = torch.where(kv_valid[:, None, None, lo:hi], s, torch.tensor(NEG_INF))
        m = s.amax(-1, keepdim=True) if hi > lo else torch.full((B, KV, H // KV, 1), NEG_INF)
        p = torch.exp(s - m)
        recs.append((m, p.sum(-1, keepdim=True), torch.einsum("bkgs,bksh->bkgh", p,
                                                              v[:, :, lo:hi].float())))
    mx = recs[0][0]
    for m, _, _ in recs[1:]:
        mx = torch.maximum(mx, m)
    den, num = torch.zeros_like(mx), torch.zeros((B, KV, H // KV, hd))
    for m, l, acc in recs:
        w = torch.exp(m - mx)
        den = den + l * w
        num = num + acc * w
    return (num / den.clamp_min(1e-30)).reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("attend", [1, 31, 33, 257, 300])
def test_cluster_merge_matches_plain_and_jax(B, attend):
    rng = np.random.default_rng(attend + B)
    L, KV, S, hd, li = 2, 2, 320, 128, 1
    q = rng.normal(size=(B, 8, hd)).astype(np.float32)
    kc = rng.normal(size=(L, B, KV, S, hd)).astype(np.float32)
    vc = rng.normal(size=(L, B, KV, S, hd)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True
    cluster, chunk = decode_attn.decode_plan(B, KV, attend, hd, 2)
    valid_t = torch.tensor(valid)
    for dtype in (torch.bfloat16, torch.float32):
        qt, kt, vt = (torch.tensor(x).to(dtype) for x in (q, kc, vc))
        ref = decode_attn.decode_attention_ref(qt, kt, vt, valid_t, li, scale=hd ** -0.5,
                                               attend_len=attend)
        out = cluster_merge(qt, kt[li], vt[li], valid_t, scale=hd ** -0.5, attend_len=attend,
                            cluster=cluster, chunk=chunk)
        assert _over_tolerance(out, ref) == 0
        if dtype == torch.float32:
            want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(valid), jnp.int32(li), scale=hd ** -0.5,
                                        attend_len=attend, block_s=1024, interpret=True)
            np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cluster_merge_with_no_valid_slot_averages_like_plain():
    """A row with no valid slot: every rank's max is -1e30, every weight 1,
    so the merge averages all attended slots as the plain version does."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 4, 64), (2, 2, 2, 200, 64), (2, 2, 2, 200, 64)))
    valid = torch.zeros((2, 200), dtype=torch.bool)
    valid[1, 5] = True
    cluster, chunk = decode_attn.decode_plan(2, 2, 190, 64, 4)
    assert cluster > 1
    out = cluster_merge(q, k[0], v[0], valid, scale=0.125, attend_len=190, cluster=cluster,
                        chunk=chunk)
    ref = decode_attn.decode_attention_ref(q, k, v, valid, 0, scale=0.125, attend_len=190)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
