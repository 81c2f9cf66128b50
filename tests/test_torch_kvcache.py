"""The port's int8 and paged KV caches and per-row cache cursors against the
JAX package on CPU.

* The plain versions of the three new decode kernels against the JAX
  Pallas kernels in interpret mode: the q8 forms within abs 2e-2 (the TPU
  kernels round q and p to bf16 for the MXU; the port stays in f32), the
  bf16/f32 paged form within 1e-5 (f32 on both sides), trash page included.
  ``decode_attention_q8_ref`` also against the JAX package's f32 dequantize
  path (``nn/qwen3.py:476-481``) within 1e-5.
* ``qwen3_forward`` in f32, same weights, for per-row cursors (one row's
  cursor past the capacity, so its writes drop), the int8 cache and the two
  paged caches: hidden states within 1e-5, int8 values, page table and
  untouched slots equal, f32 entries and scales within 1e-5 relative
  (summation order only).
* ``DelayEngine(kv_quant=True)``: greedy grids equal to the JAX engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.nn import qwen3 as jq
from mosstts_tpu.ops.attention import gqa_attention_kvmajor
from mosstts_tpu.ops.pallas import decode_attn as jdecode
from mosstts_tpu.ops.pallas import paged_attn as jpaged
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import DelayParams
from mosstts_tpu_torch.nn import qwen3 as tq
from mosstts_tpu_torch.ops.kernels import decode_attn, paged_attn
from mosstts_tpu_torch.utils.convert import load_tree_

L, B, KV, S, HD, G, P = 2, 3, 2, 512, 128, 2, 128
H = KV * G
MP = S // P
SCALE = HD ** -0.5
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kc = rng.normal(size=(L, B, KV, S, HD)).astype(np.float32)
    vc = rng.normal(size=(L, B, KV, S, HD)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True
    return rng, q, kc, vc, valid


def _quant(x):
    """The JAX package's absmax int8 quantization, on numpy."""
    q, sc = jq._quantize_kv_block(jnp.asarray(x))
    return np.asarray(q), np.asarray(sc)


def _paginate(rng, kc, vc, n_alloc):
    """A pool holding the linear cache under a shuffled page assignment;
    page 0 is the trash page, poisoned with a large finite value, and
    logical pages past ``n_alloc`` stay mapped to it."""
    npages = 1 + B * MP
    k_pool = np.full((L, npages, KV, P, HD), 1e4, np.float32)
    v_pool = np.full((L, npages, KV, P, HD), 1e4, np.float32)
    table = np.zeros((B, MP), np.int32)
    perm = rng.permutation(np.arange(1, npages))
    nxt = 0
    for b in range(B):
        for j in range(n_alloc):
            pg = int(perm[nxt])
            nxt += 1
            table[b, j] = pg
            k_pool[:, pg] = kc[:, b, :, j * P:(j + 1) * P]
            v_pool[:, pg] = vc[:, b, :, j * P:(j + 1) * P]
    return k_pool, v_pool, table


@pytest.mark.parametrize("attend", [256, 512])
def test_decode_q8_plain_matches_jax_interpret_kernel(attend):
    _, q, kc, vc, valid = _inputs(0)
    (kq, ks), (vq, vs) = _quant(kc), _quant(vc)
    for li in (0, L - 1):
        ref = jdecode.decode_attention_q8(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
            jnp.asarray(valid), jnp.int32(li), scale=SCALE, attend_len=attend, interpret=True)
        out = decode_attn.decode_attention_q8(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(valid),
                                              li, scale=SCALE, attend_len=attend)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


def test_decode_q8_plain_matches_jax_dequant_path():
    """The JAX package's non-kernel route for an int8 cache: dequantize the
    attended prefix to f32, then ``gqa_attention_kvmajor``."""
    _, q, kc, vc, valid = _inputs(1)
    (kq, ks), (vq, vs) = _quant(kc), _quant(vc)
    a, li = 300, 1
    k = jnp.asarray(kq[li, :, :, :a], jnp.float32) * jnp.asarray(ks[li, :, :, :a])[..., None]
    v = jnp.asarray(vq[li, :, :, :a], jnp.float32) * jnp.asarray(vs[li, :, :, :a])[..., None]
    ref = gqa_attention_kvmajor(
        jnp.asarray(q)[:, None], k, v, q_positions=jnp.full((B, 1), S, jnp.int32),
        kv_positions=jnp.broadcast_to(jnp.arange(a, dtype=jnp.int32), (B, a)),
        kv_valid=jnp.asarray(valid[:, :a]), scale=SCALE)[:, 0]
    out = decode_attn.decode_attention_q8(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(valid), li,
                                          scale=SCALE, attend_len=a)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("attend,n_alloc", [(256, MP), (512, MP), (512, 2)])
def test_paged_plain_matches_jax_interpret_kernel(attend, n_alloc):
    """``n_alloc=2``: the last two logical pages of every row ride the
    poisoned trash page, masked by ``kv_valid`` alone."""
    rng, q, kc, vc, valid = _inputs(2)
    k_pool, v_pool, table = _paginate(rng, kc, vc, n_alloc)
    valid = valid & (np.arange(S)[None] < n_alloc * P)
    for li in (0, L - 1):
        ref = jpaged.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
            jnp.asarray(valid), jnp.int32(li), scale=SCALE, attend_len=attend, interpret=True)
        out = paged_attn.paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(table),
                                                _t(valid), li, scale=SCALE, attend_len=attend)
        assert np.isfinite(out.numpy()).all()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        # the same as the linear cache: paging moves storage only
        lin = decode_attn.decode_attention(_t(q), _t(kc), _t(vc), _t(valid), li, scale=SCALE,
                                           attend_len=attend)
        np.testing.assert_allclose(out.numpy(), lin.numpy(), **TOL)


def test_scatter_pages_is_the_pool_layout():
    """``scatter_pages`` lays a linear cache into the pool as the JAX tests
    do (trash page and unused pages left at the fill value), and
    ``gather_pages`` reads the allocated prefix back."""
    rng, _, kc, vc, _ = _inputs(4)
    k_pool, _, table = _paginate(rng, kc, vc, 2)
    pool = paged_attn.scatter_pages(_t(kc), _t(table), k_pool.shape[1], 1e4)
    np.testing.assert_array_equal(pool.numpy(), k_pool)
    back = paged_attn.gather_pages(pool[1], _t(table), 2 * P)
    np.testing.assert_array_equal(back.numpy(), kc[1, :, :, :2 * P])


def test_paged_q8_plain_matches_jax_interpret_kernel():
    rng, q, kc, vc, valid = _inputs(3)
    k_pool, v_pool, table = _paginate(rng, kc, vc, MP)
    (kq, ks), (vq, vs) = _quant(k_pool), _quant(v_pool)
    ref = jpaged.paged_decode_attention_q8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(valid), jnp.int32(1), scale=SCALE, attend_len=256,
        interpret=True)
    out = paged_attn.paged_decode_attention_q8(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(table),
                                               _t(valid), 1, scale=SCALE, attend_len=256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-2)


# ---- qwen3_forward with per-row cursors, int8 and paged caches ----------

CFG = tiny_qwen3()
SC, PC, BC, T0 = 32, 8, 3, 12  # capacity, page size, rows, prompt length
CURSORS = np.array([T0, 30, 40])  # row 1 crosses the capacity, row 2 starts past it


@pytest.fixture(scope="module")
def backbone():
    jp = jq.init_qwen3_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32, with_embed=False)
    return jp, load_tree_(tq.Qwen3Params(CFG, with_embed=False), jax.device_get(jp))


def _caches(kind):
    """The same empty cache in both packages. Paged: a shuffled table; row
    0's last logical page is unallocated (trash page 0), which no write of
    this test reaches."""
    if kind == "linear":
        return jq.init_kv_cache(CFG, BC, SC, dtype=jnp.float32), \
            tq.init_kv_cache(CFG, BC, SC, dtype=torch.float32)
    if kind == "int8":
        return jq.init_quant_kv_cache(CFG, BC, SC), tq.init_quant_kv_cache(CFG, BC, SC)
    quant = kind == "paged_int8"
    mp = SC // PC
    npages = 1 + BC * mp
    table = np.zeros((BC, mp), np.int32)
    table.flat[:] = np.random.default_rng(4).permutation(np.arange(1, npages))[:BC * mp]
    table[0, -1] = 0
    jc = jq.init_paged_kv_cache(CFG, BC, SC, npages, page_size=PC, dtype=jnp.float32,
                                quant=quant)
    tc = tq.init_paged_kv_cache(CFG, BC, SC, npages, page_size=PC, dtype=torch.float32,
                                quant=quant)
    tc.table.copy_(_t(table))
    return jc._replace(table=jnp.asarray(table)), tc


def _assert_caches_equal(tc, jc):
    for name in tc._fields:
        t, j = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
        if t.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["linear", "int8", "paged", "paged_int8"])
def test_forward_per_row_cursors_matches_jax(backbone, kind):
    jp, tp = backbone
    jc, tc = _caches(kind)
    rng = np.random.default_rng(5)
    D = CFG.hidden_size
    kv_valid = np.zeros((BC, SC), bool)
    kv_valid[:, 2:T0] = True  # left padding of 2
    x = rng.normal(size=(BC, T0, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T0, dtype=np.int32), (BC, T0))
    jh, jc = jq.qwen3_forward(jp, CFG, jnp.asarray(x), positions=jnp.asarray(pos),
                              kv_valid=jnp.asarray(kv_valid), cache=jc, cache_offset=0)
    th, tc = tq.qwen3_forward(tp, CFG, _t(x), positions=_t(pos), kv_valid=_t(kv_valid),
                              cache=tc, cache_offset=0)
    np.testing.assert_allclose(th.numpy()[:, 2:], np.asarray(jh)[:, 2:], **TOL)
    _assert_caches_equal(tc, jc)

    cur = CURSORS.copy()
    kv_valid[1, T0:30] = kv_valid[2, T0:SC] = True  # rows 1 and 2 resumed later
    for _ in range(3):
        kv_valid[np.arange(BC)[cur < SC], cur[cur < SC]] = True
        xi = rng.normal(size=(BC, 1, D)).astype(np.float32)
        posi = cur[:, None].astype(np.int32)
        jh, jc = jq.qwen3_forward(jp, CFG, jnp.asarray(xi), positions=jnp.asarray(posi),
                                  kv_valid=jnp.asarray(kv_valid), cache=jc,
                                  cache_offset=jnp.asarray(cur, jnp.int32))
        th, tc = tq.qwen3_forward(tp, CFG, _t(xi), positions=_t(posi), kv_valid=_t(kv_valid),
                                  cache=tc, cache_offset=_t(cur.astype(np.int32)))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        _assert_caches_equal(tc, jc)
        cur += 1


@pytest.mark.parametrize("kind", ["linear", "int8", "paged", "paged_int8"])
def test_forward_multi_token_per_row_block_matches_jax(backbone, kind):
    """A 4-token block at per-row cursors after the prefill: row 0 writes all
    four, row 1 straddles the capacity (two kept, two dropped), row 2 drops
    all four. Hidden states and caches equal JAX's."""
    jp, tp = backbone
    jc, tc = _caches(kind)
    rng = np.random.default_rng(8)
    D, T = CFG.hidden_size, 4
    kv_valid = np.zeros((BC, SC), bool)
    kv_valid[:, :T0] = True
    x = rng.normal(size=(BC, T0, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T0, dtype=np.int32), (BC, T0))
    jh, jc = jq.qwen3_forward(jp, CFG, jnp.asarray(x), positions=jnp.asarray(pos),
                              kv_valid=jnp.asarray(kv_valid), cache=jc, cache_offset=0)
    th, tc = tq.qwen3_forward(tp, CFG, _t(x), positions=_t(pos), kv_valid=_t(kv_valid),
                              cache=tc, cache_offset=0)
    cur = np.array([T0, SC - 2, SC + 1], np.int32)
    kv_valid[0, T0:T0 + T] = kv_valid[1, T0:] = kv_valid[2, T0:] = True
    xb = rng.normal(size=(BC, T, D)).astype(np.float32)
    posb = (cur[:, None] + np.arange(T, dtype=np.int32)).astype(np.int32)
    jh, jc = jq.qwen3_forward(jp, CFG, jnp.asarray(xb), positions=jnp.asarray(posb),
                              kv_valid=jnp.asarray(kv_valid), cache=jc,
                              cache_offset=jnp.asarray(cur))
    th, tc = tq.qwen3_forward(tp, CFG, _t(xb), positions=_t(posb), kv_valid=_t(kv_valid),
                              cache=tc, cache_offset=_t(cur))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _assert_caches_equal(tc, jc)


def test_dropped_write_leaves_the_cache_untouched(backbone):
    """A row whose cursor is past the capacity writes nothing, not even its
    last slot (no clamp onto slot S-1)."""
    _, tp = backbone
    cache = tq.init_kv_cache(CFG, 2, SC, dtype=torch.float32)
    cache.k.fill_(7.0)
    cache.v.fill_(7.0)
    before = cache.k.clone()
    x = torch.tensor(np.random.default_rng(6).normal(size=(2, 1, CFG.hidden_size)),
                     dtype=torch.float32)
    cur = torch.tensor([SC - 1, SC], dtype=torch.int32)
    tq.qwen3_forward(tp, CFG, x, positions=cur[:, None], kv_valid=torch.ones((2, SC), dtype=torch.bool),
                     cache=cache, cache_offset=cur)
    assert torch.equal(cache.k[:, 1], before[:, 1])  # row 1: dropped
    assert not torch.equal(cache.k[:, 0, :, SC - 1], before[:, 0, :, SC - 1])  # row 0: written


def test_engine_kv_quant_greedy_matches_jax():
    cfg = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
    je = JaxEngine.random_init(seed=0, config=cfg, dtype=jnp.float32, cache_bucket=64,
                               kv_quant=True)
    te = DelayEngine(load_tree_(DelayParams(cfg), jax.device_get(je.params)), cfg,
                     dtype=torch.float32, cache_bucket=64, kv_quant=True)
    proc = DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=None, config=cfg)
    rng = np.random.default_rng(7)
    convs = [[proc.build_user_message(text=t),
              proc.build_assistant_message([rng.integers(0, 1024, size=(n, cfg.n_vq))])]
             for t, n in (("int8 cache", 6), ("a longer int8 cache prompt", 9))]
    batch = proc(convs, mode="continuation")
    kw = dict(max_new_tokens=20, text_temperature=0.0, audio_temperature=0.0)
    jout = je.generate(batch["input_ids"], batch["attention_mask"], **kw)
    tout = te.generate(batch["input_ids"], batch["attention_mask"], **kw)
    for (jl, jg), (tl, tg) in zip(jout, tout):
        assert tl == jl
        np.testing.assert_array_equal(tg, jg)
