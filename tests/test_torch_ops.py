"""The port's ops against the JAX package on CPU: basic ops, the plain
versions of the two CUDA kernels, and the sampling filters. Inputs come from
numpy seeds and go through both packages.

Tolerances: float32 on both sides, so 1e-5 (summation order only); greedy
tokens and filter masks must be equal. The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.ops import attention as jatt
from mosstts_tpu.ops import basic as jb
from mosstts_tpu.ops import sampling as js
from mosstts_tpu.ops.pallas.decode_attn import decode_attention as jax_decode_attention
from mosstts_tpu_torch.ops import basic as tb
from mosstts_tpu_torch.ops import sampling as ts
from mosstts_tpu_torch.ops.kernels import decode_attn, flash

F32 = dict(rtol=1e-5, atol=1e-5)


def T(x):
    return torch.tensor(np.asarray(x))


def N(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------- basic ops ---------------------------------

def test_rms_norm_dense_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64,)) + 1).astype(np.float32)
    np.testing.assert_allclose(N(tb.rms_norm(T(x), T(w), 1e-6)),
                               N(jb.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **F32)
    wg, wu = (rng.normal(size=(2, 64, 96)) * 0.1).astype(np.float32)
    wd = (rng.normal(size=(96, 64)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(N(tb.dense(T(x), T(wg))),
                               N(jb.dense(jnp.asarray(x), jnp.asarray(wg))), **F32)
    np.testing.assert_allclose(
        N(tb.swiglu(T(x), T(wg), T(wu), T(wd))),
        N(jb.swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd))), **F32)


@pytest.mark.parametrize("theta,hd", [(1_000_000.0, 16), (10_000.0, 64)])
def test_rope_matches_jax(theta, hd):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    tc, tsin = tb.rope_cos_sin(T(pos), hd, theta)
    jc, jsin = jb.rope_cos_sin(jnp.asarray(pos), hd, theta)
    np.testing.assert_allclose(N(tc), N(jc), **F32)
    np.testing.assert_allclose(N(tsin), N(jsin), **F32)
    np.testing.assert_allclose(N(tb.apply_rope(T(x), tc, tsin)),
                               N(jb.apply_rope(jnp.asarray(x), jc, jsin)), **F32)


# ----------------------- plain flash vs the JAX oracle ---------------------

def _flash_inputs(seed, B=3, T_=9, H=4, KV=2, hd=64, S=24, q_start=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T_, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    valid = np.zeros((B, S), bool)
    for b, pad in enumerate((0, 2, 5)[:B]):  # left padding
        valid[b, pad:q_start + T_] = True
    return q, k, v, valid


@pytest.mark.parametrize("kv_major", [False, True])
@pytest.mark.parametrize("q_start,window", [(0, None), (6, None), (4, 5)])
def test_flash_ref_matches_jax_gqa(kv_major, q_start, window):
    q, k, v, valid = _flash_inputs(2, q_start=q_start)
    B, T_ = q.shape[:2]
    S = k.shape[1]
    scale = q.shape[-1] ** -0.5
    if kv_major:
        k, v = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
    q_pos = np.broadcast_to(q_start + np.arange(T_, dtype=np.int32), (B, T_))
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    oracle = jatt.gqa_attention_kvmajor if kv_major else jatt.gqa_attention
    ref = oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(q_pos),
                 kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid), scale=scale,
                 window=window)
    launches = flash.LAUNCHES
    out = flash.flash_attention(T(q), T(k), T(v), T(valid), q_start, scale=scale,
                                window=window, kv_major=kv_major)
    assert flash.LAUNCHES == launches  # CPU tensors never reach the kernel
    rows = valid[:, q_start:q_start + T_]  # query rows at real (non-pad) positions
    np.testing.assert_allclose(N(out)[rows], np.asarray(ref)[rows], **F32)


# ------------------ plain decode vs the JAX kernel (interpret) ---------------

@pytest.mark.parametrize("attend,block_s", [(256, 128), (200, 256), (300, 100)])
def test_decode_ref_matches_jax_kernel(attend, block_s):
    L, B, KV, S, hd, G = 3, 4, 2, 320, 128, 2
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, KV * G, hd)).astype(np.float32)
    kc = rng.normal(size=(L, B, KV, S, hd)).astype(np.float32)
    vc = rng.normal(size=(L, B, KV, S, hd)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True
    for li in (0, 2):
        ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(valid), jnp.int32(li), scale=hd ** -0.5,
                                   attend_len=attend, block_s=block_s, interpret=True)
        out = decode_attn.decode_attention(T(q), T(kc), T(vc), T(valid), li,
                                           scale=hd ** -0.5, attend_len=attend)
        np.testing.assert_allclose(N(out), np.asarray(ref), **F32)


# -------------------------------- sampling ---------------------------------

def test_sampling_filters_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 2, 60)) * 3).astype(np.float32)
    p = np.array([0.3, 0.8, 1.0], np.float32)
    np.testing.assert_array_equal(N(ts.apply_top_p(T(logits), T(p))),
                                  np.asarray(js.apply_top_p(jnp.asarray(logits), jnp.asarray(p))))
    seen = rng.random((3, 2, 60)) < 0.3
    np.testing.assert_allclose(
        N(ts.apply_repetition_penalty_seen(T(logits), T(seen), T(np.float32([1.1, 1.3, 2.0])))),
        np.asarray(js.apply_repetition_penalty_seen(jnp.asarray(logits), jnp.asarray(seen),
                                                    jnp.float32([1.1, 1.3, 2.0])[:, None, None])),
        **F32)
    toks = rng.integers(0, 60, size=(3, 2))
    active = rng.random((3, 2)) < 0.5
    np.testing.assert_array_equal(
        N(ts.seen_mask_update(T(seen), T(toks), T(active))),
        np.asarray(js.seen_mask_update(jnp.asarray(seen), jnp.asarray(toks), jnp.asarray(active))))
    ids = rng.integers(0, 5, size=(4, 12))
    np.testing.assert_array_equal(N(ts.find_last_equal(T(ids), 3)),
                                  np.asarray(js.find_last_equal(jnp.asarray(ids), 3)))


@pytest.mark.parametrize("top_k", [5, 25])
def test_topk_topp_filter_and_greedy_match_jax(top_k):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 4, 100)) * 2).astype(np.float32)
    p = np.array([0.5, 0.9, 1.0], np.float32)
    vals, idx = ts.topk_topp_filter(T(logits), top_k, T(p))
    jv, ji = js._topk_desc(jnp.asarray(logits), top_k, True)
    probs = jax.nn.softmax(jv, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    jv = jnp.where((cum - probs) < jnp.asarray(p)[:, None, None], jv, js.NEG_INF)
    np.testing.assert_array_equal(N(vals), np.asarray(jv))
    np.testing.assert_array_equal(N(idx), np.asarray(ji))
    keys = ts.row_keys(0, 3)
    greedy = ts.sample_topk_topp(keys, T(logits), top_k=top_k, top_p=T(p), do_sample=False)
    jgreedy = js.sample_topk_topp(jax.random.split(jax.random.PRNGKey(0), 3), jnp.asarray(logits),
                                  top_k=top_k, top_p=jnp.asarray(p), do_sample=False,
                                  exact_topk=True)
    np.testing.assert_array_equal(N(greedy), np.asarray(jgreedy))


def test_seeded_draws_are_per_row_and_deterministic():
    rng = np.random.default_rng(6)
    logits = T(rng.normal(size=(3, 4, 50)).astype(np.float32))
    kw = dict(top_k=20, top_p=0.9, do_sample=True)
    a = ts.sample_topk_topp(ts.row_keys(7, 3), logits, **kw)
    b = ts.sample_topk_topp(ts.row_keys(7, 3), logits, **kw)
    np.testing.assert_array_equal(N(a), N(b))
    # row 1's draws depend on its own key only, not on its co-tenants
    solo = ts.sample_topk_topp(ts.row_keys(7, 3)[1:2], logits[1:2], **kw)
    np.testing.assert_array_equal(N(a)[1:2], N(solo))
    # a draw lies in the top-p nucleus of the top-k candidates
    vals, idx = ts.topk_topp_filter(logits, 20, 0.9)
    kept = torch.where(vals > ts.NEG_INF, idx, -1)
    assert bool((kept == a[..., None]).any(-1).all())
