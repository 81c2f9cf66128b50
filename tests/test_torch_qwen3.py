"""The port's Qwen3 backbone against the JAX package on CPU, same weights
(JAX ``init_qwen3_params`` -> numpy -> ``utils.convert``): prefill into a
linear cache at offset 0, single-token decode steps at a scalar offset, a
multi-token forward with per-row cursors, and the codec's ring cache with
``kv_positions`` and a sliding window.

Tolerance: float32 on both sides; hidden states and cache entries agree to
atol 1e-4 (summation order only). Query rows at left-pad positions are
garbage by design and are not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec import transformer as jtxf
from mosstts_tpu.core.config import tiny_qwen3
from mosstts_tpu.nn import qwen3 as jq
from mosstts_tpu_torch.codec import transformer as ttxf
from mosstts_tpu_torch.nn import qwen3 as tq
from mosstts_tpu_torch.ops.kernels import decode_attn, flash
from mosstts_tpu_torch.utils.convert import load_tree_

TOL = dict(rtol=1e-4, atol=1e-4)

# Prefill takes the flash dispatch and decode steps the decode dispatch at
# every head dim (on the card a shape a kernel does not take, such as head
# dim 16, raises in its wrapper: no silent plain path). On CPU tensors the
# wrappers run their plain versions.
CONFIGS = {
    "hd16": tiny_qwen3(),
    "hd64": tiny_qwen3(hidden_size=128, intermediate_size=192, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=64),
}


def _params(cfg, with_embed=False):
    jp = jq.init_qwen3_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32,
                              with_embed=with_embed)
    tp = load_tree_(tq.Qwen3Params(cfg, with_embed=with_embed), jax.device_get(jp))
    return jp, tp


@pytest.fixture
def count_plain_calls(monkeypatch):
    calls = {"flash": 0, "decode": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(flash, "flash_attention_ref", "flash")
    wrap(decode_attn, "decode_attention_ref", "decode")
    return calls


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_steps_match_jax(name, count_plain_calls):
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    B, T0, S, D, L = 2, 12, 40, cfg.hidden_size, cfg.num_hidden_layers
    rng = np.random.default_rng(0)
    pad = np.array([0, 3])
    kv_valid = np.zeros((B, S), bool)
    for b in range(B):
        kv_valid[b, pad[b]:T0] = True
    x = rng.normal(size=(B, T0, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T0, dtype=np.int32), (B, T0))

    jcache = jq.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    tcache = tq.init_kv_cache(cfg, B, S, dtype=torch.float32)
    jh, jcache = jq.qwen3_forward(jp, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                  kv_valid=jnp.asarray(kv_valid), cache=jcache, cache_offset=0)
    th, tcache = tq.qwen3_forward(tp, cfg, torch.tensor(x), positions=torch.tensor(pos),
                                  kv_valid=torch.tensor(kv_valid), cache=tcache, cache_offset=0)
    rows = kv_valid[:, :T0]
    np.testing.assert_allclose(th.numpy()[rows], np.asarray(jh)[rows], **TOL)
    for tc, jc in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(tc.numpy().transpose(1, 3, 0, 2, 4)[kv_valid],
                                   np.asarray(jc).transpose(1, 3, 0, 2, 4)[kv_valid], **TOL)

    for i in range(4):  # decode: one token per row at slot T0 + i
        p = T0 + i
        kv_valid[:, p] = True  # the sampler marks the slot before the forward
        xi = rng.normal(size=(B, 1, D)).astype(np.float32)
        posi = np.full((B, 1), p, np.int32)
        attend = 16 if p < 16 else S
        jh, jcache = jq.qwen3_forward(jp, cfg, jnp.asarray(xi), positions=jnp.asarray(posi),
                                      kv_valid=jnp.asarray(kv_valid), cache=jcache,
                                      cache_offset=jnp.int32(p), attend_len=attend)
        th, tcache = tq.qwen3_forward(tp, cfg, torch.tensor(xi), positions=torch.tensor(posi),
                                      kv_valid=torch.tensor(kv_valid), cache=tcache,
                                      cache_offset=torch.tensor(p, dtype=torch.int32),
                                      attend_len=attend)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache.k.numpy()[:, :, :, :T0 + 4][:, 0],
                               np.asarray(jcache.k)[:, :, :, :T0 + 4][:, 0], **TOL)
    assert count_plain_calls == {"flash": L, "decode": 4 * L}


def test_codec_ring_window_chunks_match_jax():
    cfg = tiny_qwen3(vocab_size=1, hidden_size=32, intermediate_size=64, num_attention_heads=2,
                     num_key_value_heads=2, head_dim=16, rope_theta=10_000.0)
    jp, tp = _params(cfg)
    B, W, c = 2, 8, 5
    rng = np.random.default_rng(1)
    js = jtxf.init_stream_state(cfg, B, W)
    ts = ttxf.init_stream_state(cfg, B, W)
    for valid_len in (5, 5, 3):  # the last chunk is right-padded
        x = rng.normal(size=(B, c, cfg.hidden_size)).astype(np.float32)
        jh, js = jtxf.run_chunk(jp, cfg, js, jnp.asarray(x), jnp.int32(valid_len))
        th, ts = ttxf.run_chunk(tp, cfg, ts, torch.tensor(x), valid_len)
        np.testing.assert_allclose(th.numpy()[:, :valid_len], np.asarray(jh)[:, :valid_len],
                                   **TOL)
        assert ts.next_pos == int(js.next_pos)
        np.testing.assert_array_equal(ts.positions.numpy(), np.asarray(js.positions))
        np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
        np.testing.assert_allclose(ts.k.numpy(), np.asarray(js.k), **TOL)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **TOL)


def test_weight_bridge_carries_bf16_exactly():
    cfg = CONFIGS["hd16"]
    jp = jq.init_qwen3_params(jax.random.PRNGKey(1), cfg, dtype=jnp.bfloat16, with_embed=True)
    tp = load_tree_(tq.Qwen3Params(cfg, dtype=torch.bfloat16), jax.device_get(jp))
    for name, p in tp.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(leaf, np.float32), err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_multi_token_forward_with_row_cursors_matches_jax(name, count_plain_calls):
    """A T = 5 forward with (B,) cursors (each row writing its block at its
    own slot, one row's block past the capacity dropped) takes the plain
    attention, as JAX takes its einsum path; on the card it runs the same
    path (no kernel takes one q_start per row)."""
    cfg = CONFIGS[name]
    jp, tp = _params(cfg)
    B, T, S, D = 3, 5, 24, cfg.hidden_size
    rng = np.random.default_rng(2)
    off = np.array([4, 11, 21], np.int32)  # the last row's block runs past slot 23
    kv_valid = np.zeros((B, S), bool)
    for b in range(B):
        kv_valid[b, 1:min(off[b] + T, S)] = True
    pos = off[:, None] + np.arange(T, dtype=np.int32)[None]
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    k0 = rng.normal(size=(cfg.num_hidden_layers, B, cfg.num_key_value_heads, S,
                          cfg.head_dim)).astype(np.float32)
    jcache = jq.KVCache(jnp.asarray(k0), jnp.asarray(k0 * 0.5))
    tcache = tq.KVCache(torch.tensor(k0), torch.tensor(k0 * 0.5))
    jh, jcache = jq.qwen3_forward(jp, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                  kv_valid=jnp.asarray(kv_valid), cache=jcache,
                                  cache_offset=jnp.asarray(off))
    th, tcache = tq.qwen3_forward(tp, cfg, torch.tensor(x), positions=torch.tensor(pos),
                                  kv_valid=torch.tensor(kv_valid), cache=tcache,
                                  cache_offset=torch.tensor(off))
    rows = pos < S  # a query past the capacity has no slot to attend from
    np.testing.assert_allclose(th.numpy()[rows], np.asarray(jh)[rows], **TOL)
    for tc, jc in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert count_plain_calls == {"flash": 0, "decode": 0}
