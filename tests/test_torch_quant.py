"""The port's int8-weight serving against the JAX package on CPU: tiny config
(2 layers, n_vq=4), weights from JAX ``init_delay_params`` through
``utils.convert``, the JAX side quantized by ``quantize_tree``.

* ``quantize_weight``: int8 values equal, scales within 1e-7 relative, for
  f32 and bf16 weights; ``quantize_tree_`` gives JAX's names, and a JAX
  ``quantize_tree`` loads through the bridge.
* ``dense`` on a ``QuantWeight``: within 1e-5 in f32, within one bf16 ulp
  with bf16 activations (both round one f32 sum once; only the summation
  order differs).
* ``delay_forward`` on quantized params: logits within 1e-4 in f32 (the
  tolerance of ``test_torch_delay.py``), greedy argmax equal.
* ``DelayEngine.quantize()`` and ``DelayBatchServer`` over quantized params:
  greedy grids equal to the JAX engine's and server's.
* The float audio heads keep the f32 accumulator: bf16 inputs give JAX's f32
  logits within 1e-6 relative (summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.batch_server import DelayBatchServer as JaxServer
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.models import delay as jd
from mosstts_tpu.models.delay import make_sampling as jax_sampling
from mosstts_tpu.ops import basic as jbasic
from mosstts_tpu.ops import quant as jq
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops import basic as tbasic
from mosstts_tpu_torch.ops import quant as tq
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)


def _bf16_np(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.fixture(scope="module")
def params():
    """(JAX f32 params, JAX quantized params, the port's quantized params
    loaded from JAX's quantized tree)."""
    jp = jd.init_delay_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    jqp = jq.quantize_tree(jp)
    tqp = load_tree_(tq.quantize_tree_(td.DelayParams(CFG)), jax.device_get(jqp))
    return jp, jqp, tqp


@pytest.fixture(scope="module")
def proc():
    return DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=None, config=CFG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax(dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 64, 40)).astype(np.float32) * 0.05
    w[1, :, 7] = 0.0  # an all-zero column: the 1e-8 scale floor
    jw = jq.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)))
    tw = tq.quantize_weight(torch.tensor(w).to(getattr(torch, dtype)))
    assert tw.q.dtype == torch.int8 and tw.scale.dtype == torch.float32
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale), rtol=1e-7, atol=0)
    np.testing.assert_allclose(tq.dequantize(tw, torch.float32).numpy(),
                               np.asarray(jq.dequantize(jw, jnp.float32)), rtol=1e-6, atol=0)


def test_quantize_tree_names_match_jax(params):
    jp, jqp, _ = params
    port = tq.quantize_tree_(load_tree_(td.DelayParams(CFG), jax.device_get(jp)))
    names = {n: p for n, p in port.named_parameters()}
    jflat = flatten_tree(jax.device_get(jqp))
    assert sorted(names) == sorted(jflat)
    assert "backbone.layers.wq.q" in names and "backbone.embed" in names
    assert names["backbone.layers.wq.q"].dtype == torch.int8
    assert names["backbone.embed"].dtype == torch.float32  # gathers stay float
    # the port's own quantization of the same weights equals JAX's
    for n, p in names.items():
        want = np.asarray(jflat[n])
        if p.dtype == torch.int8:
            np.testing.assert_array_equal(p.numpy(), want, err_msg=n)
        else:
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-7, atol=0, err_msg=n)


def test_jax_quantized_tree_loads_through_the_bridge(params):
    _, jqp, tqp = params
    heads = tqp.audio_heads
    assert isinstance(heads, tq.QuantWeight) and heads.q.dtype == torch.int8
    np.testing.assert_array_equal(heads.q.numpy(), np.asarray(jqp["audio_heads"].q))
    assert heads.scale.dtype == torch.float32
    assert tqp.text_head.device == torch.device("cpu") and tqp.text_head.dtype == torch.bfloat16
    # a layer view reads the stack in place, q and scale together
    wq = tqp.backbone.layers.wq
    view = wq[1]
    assert view.q.data_ptr() == wq.q[1].data_ptr() and view.scale.data_ptr() == wq.scale[1].data_ptr()
    assert tq.take_weight(wq, 1).q.data_ptr() == view.q.data_ptr()
    with pytest.raises(KeyError):  # a float tree does not fit a quantized module
        load_tree_(tqp, jax.device_get(params[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_on_quantweight_matches_jax(dtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((96, 48)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.tensor(w))
    if dtype == "float32":
        want = np.asarray(jbasic.dense(jnp.asarray(x), jw))
        got = tbasic.dense(torch.tensor(x), tw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        xb = torch.tensor(x).to(torch.bfloat16)
        want = np.asarray(jbasic.dense(_bf16_np(xb), jw).astype(jnp.float32))
        got = tbasic.dense(xb, tw)
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** -7 * np.abs(want)
        assert (np.abs(got.float().numpy() - want) <= ulp + 1e-6).all()


def test_delay_forward_quantized_matches_jax(params):
    _, jqp, tqp = params
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 200, (2, 7, CFG.channels))
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    kv = np.ones((2, 7), bool)
    jt, ja, _ = jd.delay_forward(jqp, CFG, jnp.asarray(ids), positions=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(kv))
    tt, ta, _ = td.delay_forward(tqp, CFG, torch.tensor(ids), positions=torch.tensor(pos),
                                 kv_valid=torch.tensor(kv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt.argmax(-1).numpy(), np.asarray(jt.argmax(-1)))
    np.testing.assert_array_equal(ta[..., :-1].argmax(-1).numpy(),
                                  np.asarray(ja[..., :-1].argmax(-1)))


def test_engine_quantize_greedy_matches_jax(params, proc):
    """``DelayEngine.quantize()`` in place on the float weights (the port
    quantizes them itself) against the JAX engine's ``quantize()``, on a
    left-padded batch."""
    jp = params[0]
    je = JaxEngine(jp, CFG, dtype=jnp.float32, cache_bucket=64).quantize()
    te = DelayEngine(load_tree_(td.DelayParams(CFG), jax.device_get(jp)), CFG,
                     dtype=torch.float32, cache_bucket=64)
    assert te.quantize() is te
    assert isinstance(te.params.backbone.layers.w_gate, tq.QuantWeight)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        te.quantize("int4")
    convs = [[proc.build_user_message(text="hi")],
             [proc.build_user_message(text="a longer prompt for the quantized engine")]]
    batch = proc(convs, mode="generation")
    assert not batch["attention_mask"].all()
    kw = dict(max_new_tokens=20, **GREEDY)
    jout = je.generate(batch["input_ids"], batch["attention_mask"], **kw)
    tout = te.generate(batch["input_ids"], batch["attention_mask"], **kw)
    for (jl, jg), (tl, tg) in zip(jout, tout):
        assert jl == tl
        np.testing.assert_array_equal(tg, jg)


def _grid(proc, text, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1024, (6, CFG.n_vq)).astype(np.int64)
    conv = [proc.build_user_message(text=text), proc.build_assistant_message([codes])]
    return proc([conv], mode="continuation")["input_ids"][0]


@pytest.mark.parametrize("mode", [{}, dict(paged=True, kv_quant=True, page_size=64)],
                         ids=["linear", "paged_int8"])
def test_server_on_quantized_params_matches_jax(params, proc, mode):
    _, jqp, tqp = params
    kw = dict(slots=2, cache_len=256, out_capacity=64, prompt_bucket=32, **mode)
    js = JaxServer(jqp, CFG, dtype=jnp.float32, sampling=jax_sampling(**GREEDY), **kw)
    ts = DelayBatchServer(tqp, CFG, dtype=torch.float32, sampling=td.make_sampling(**GREEDY),
                          **kw)
    grids = [_grid(proc, f"int8 weights {i}", seed=70 + i) for i in range(3)]
    out = []
    for srv in (js, ts):
        rids = [srv.submit(g, max_new_tokens=16) for g in grids]
        done = {c.request_id: c for c in srv.run(max_steps=400)}
        out.append([done[r] for r in rids])
    for j, t in zip(*out):
        assert (j.start_length, j.steps) == (t.start_length, t.steps)
        np.testing.assert_array_equal(t.tokens, j.tokens)


def test_bf16_audio_heads_keep_the_f32_accumulator():
    """JAX's ``_audio_head_logits`` keeps ``preferred_element_type=f32``;
    the port's no longer rounds the product to bf16 first."""
    rng = np.random.default_rng(2)
    h = torch.tensor(rng.standard_normal((2, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    heads = torch.tensor(rng.standard_normal((4, 64, 33)).astype(np.float32) * 0.3)
    heads = heads.to(torch.bfloat16)
    want = np.asarray(jd._audio_head_logits(_bf16_np(h), _bf16_np(heads)))
    got = td._audio_head_logits(h, heads)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 4, 33)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


def test_random_quantized_like_layout():
    gen = torch.Generator().manual_seed(0)
    p = tq.random_quantized_like(td.DelayParams(CFG, device="meta"), generator=gen, device="cpu")
    lay = p.backbone.layers
    lc = CFG.language_config
    assert isinstance(lay.w_gate, tq.QuantWeight)
    assert lay.w_gate.q.shape == (lc.num_hidden_layers, lc.hidden_size, lc.intermediate_size)
    assert lay.w_gate.scale.shape == (lc.num_hidden_layers, lc.intermediate_size)
    assert lay.w_gate.q.dtype == torch.int8 and lay.w_gate.q.device.type == "cpu"
    assert int(lay.w_gate.q.min()) >= -127 and int(lay.w_gate.q.max()) <= 127
    torch.testing.assert_close(p.audio_heads.scale,
                               torch.full((CFG.n_vq, CFG.audio_emb_vocab), 0.02 * 4 / 127))
    assert p.backbone.embed.dtype == torch.bfloat16 and p.backbone.embed.device.type == "cpu"
    assert lay.ln1.dtype == torch.bfloat16
    assert {n for n, _ in p.named_parameters()} == {
        n for n, _ in tq.quantize_tree_(td.DelayParams(CFG)).named_parameters()}
    assert not any(t.is_meta for t in p.parameters())
