"""``hidden_out_layers`` (each head sourced from its own backbone layer) and
``output_hidden_states`` in the port against the JAX package on CPU: a
3-layer tiny config with n_vq=4, float32, the same weights through
``utils.convert``, float and int8 (JAX ``quantize_tree``) heads. Mirrors
``tests/test_hidden_out_layers.py`` and ``tests/test_decode_attn.py:159``.

Tolerances: hidden states and logits within 1e-4 absolute of JAX's in f32
(the tolerance of ``test_torch_delay.py``: both sum the same f32 products in
another order); ``[-1] * C`` reproduces the port's default path within
1e-5 (JAX's own test); greedy token grids equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.models import delay as jd
from mosstts_tpu.nn import qwen3 as jq3
from mosstts_tpu.ops import quant as jq
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.nn import qwen3 as tq3
from mosstts_tpu_torch.ops import quant as tq
from mosstts_tpu_torch.utils.convert import load_tree_
from tests.test_torch_events import numpy_params

CFG = DelayConfig(language_config=tiny_qwen3(num_hidden_layers=3), n_vq=4)
MIX = (1, -1, 0, 2, -2)  # text from layer 1; the audio heads from a mixture
GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tiny eager steps are
    many small ops, which a thread pool only slows when the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["float", "int8"])
def params(request):
    """(JAX params, the port's params with the same values), float or with
    int8 matmul weights and heads."""
    jp = numpy_params(CFG, seed=7)
    if request.param == "int8":
        jp = jq.quantize_tree(jp)
        return jp, load_tree_(tq.quantize_tree_(td.DelayParams(CFG)), jax.device_get(jp))
    return jp, load_tree_(td.DelayParams(CFG), jax.device_get(jp))


def _ids(seed, B, T):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (B, T, CFG.channels))
    ids[..., 1:] = rng.integers(0, 1024, (B, T, CFG.n_vq))
    return ids


def test_output_hidden_states_match_jax(params):
    """The L + 1 hidden states (embeddings, layers 1 .. L-1, the final-normed
    layer L) of a prefill into a cache equal JAX's stacked array."""
    jp, tp = params
    B, T, S = 2, 7, 16
    x = np.random.default_rng(3).normal(size=(B, T, CFG.language_config.hidden_size)) * 0.1
    mask = np.ones((B, S), bool)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    jh, (_, jall) = jq3.qwen3_forward(
        jp["backbone"], CFG.language_config, jnp.asarray(x, jnp.float32),
        positions=jnp.asarray(pos), kv_valid=jnp.asarray(mask),
        cache=jq3.init_kv_cache(CFG.language_config, B, S, dtype=jnp.float32),
        output_hidden_states=True)
    th, (cache, tall) = tq3.qwen3_forward(
        tp.backbone, CFG.language_config, torch.tensor(x, dtype=torch.float32),
        positions=torch.tensor(pos), kv_valid=torch.tensor(mask),
        cache=tq3.init_kv_cache(CFG.language_config, B, S, dtype=torch.float32),
        output_hidden_states=True)
    assert len(tall) == CFG.language_config.num_hidden_layers + 1 and tall[-1] is th
    assert isinstance(cache, tq3.KVCache)
    np.testing.assert_allclose(torch.stack(tall).numpy(), np.asarray(jall), atol=1e-4)


@pytest.mark.parametrize("hol", [(-1,) * CFG.channels, MIX], ids=["last", "mix"])
def test_forward_matches_jax(params, hol):
    """``delay_forward(hidden_out_layers=...)`` without a cache equals JAX's;
    ``[-1] * C`` equals the port's default path."""
    jp, tp = params
    B, T = 2, 6
    ids = _ids(0, B, T)
    mask = np.ones((B, T), bool)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    jt, ja, _ = jd.delay_forward(jp, CFG, jnp.asarray(ids), positions=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(mask), hidden_out_layers=hol)
    kw = dict(positions=torch.tensor(pos), kv_valid=torch.tensor(mask))
    tt, ta, _ = td.delay_forward(tp, CFG, torch.tensor(ids), hidden_out_layers=hol, **kw)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
    if hol == (-1,) * CFG.channels:
        t0, a0, _ = td.delay_forward(tp, CFG, torch.tensor(ids), **kw)
        np.testing.assert_allclose(tt.numpy(), t0.numpy(), atol=1e-5)
        np.testing.assert_allclose(ta.numpy(), a0.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="1 \\+ n_vq"):
        td.delay_forward(tp, CFG, torch.tensor(ids), hidden_out_layers=hol[:-1], **kw)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-kv", "int8-kv"])
def test_cached_decode_matches_uncached(params, kv_quant):
    """A prefill into a cache and three cached single-token steps with a
    layer mixture give the logits of the uncached forward over the whole
    sequence (exact attention in f32; the int8 cache within 0.05, its
    quantization error)."""
    _, tp = params
    B, T0, steps, S = 2, 7, 3, 32
    T = T0 + steps
    ids = torch.tensor(_ids(1, B, T))
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    full_t, full_a, _ = td.delay_forward(tp, CFG, ids, positions=pos,
                                         kv_valid=torch.ones((B, T), dtype=torch.bool),
                                         hidden_out_layers=MIX)
    lc = CFG.language_config
    cache = (tq3.init_quant_kv_cache(lc, B, S) if kv_quant
             else tq3.init_kv_cache(lc, B, S, dtype=torch.float32))
    kv_valid = torch.zeros((B, S), dtype=torch.bool)
    kv_valid[:, :T0] = True
    tol = 0.05 if kv_quant else 1e-4
    t, a, cache = td.delay_forward(tp, CFG, ids[:, :T0], positions=pos[:, :T0],
                                   kv_valid=kv_valid, cache=cache, hidden_out_layers=MIX)
    np.testing.assert_allclose(t.numpy(), full_t[:, :T0].numpy(), atol=1e-4)
    np.testing.assert_allclose(a.numpy(), full_a[:, :T0].numpy(), atol=1e-4)
    for i in range(steps):
        p = T0 + i
        kv_valid[:, p] = True
        t, a, cache = td.delay_forward(tp, CFG, ids[:, p:p + 1], positions=pos[:, p:p + 1],
                                       kv_valid=kv_valid, cache=cache, cache_offset=p,
                                       hidden_out_layers=MIX)
        np.testing.assert_allclose(t[:, 0].numpy(), full_t[:, p].numpy(), atol=tol)
        np.testing.assert_allclose(a[:, 0].numpy(), full_a[:, p].numpy(), atol=tol)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-kv", "int8-kv"])
def test_engine_with_hidden_out_layers_matches_jax(params, kv_quant):
    """``DelayEngine(hidden_out_layers=...)`` gives JAX's greedy grids, with
    the f32 and the int8 KV cache (``tests/test_decode_attn.py:159``), in
    both ``on_device`` modes; its decode and prefill keys carry the layers."""
    jp, tp = params
    B, T = 2, 10
    ids = _ids(4, B, T)
    ids[:, 2, 0] = CFG.im_start_token_id
    ids[:, 4, 0] = CFG.audio_start_token_id
    ids[:, -1, 0] = CFG.audio_assistant_gen_slot_token_id
    mask = np.ones((B, T), bool)
    kw = dict(cache_bucket=64, kv_quant=kv_quant, hidden_out_layers=MIX)
    je = JaxEngine(jp, CFG, dtype=jnp.float32, **kw)
    te = DelayEngine(tp, CFG, dtype=torch.float32, **kw)
    ref = je.generate(ids, mask, max_new_tokens=8, **GREEDY)
    for on_device in (False, True):
        got = te.generate(ids, mask, max_new_tokens=8, on_device=on_device, **GREEDY)
        for (la, ga), (lb, gb) in zip(ref, got):
            assert la == lb
            np.testing.assert_array_equal(gb, ga)
    ((steps, prefills),) = zip(te._steps.values(), te._prefills.values())
    assert all(k[-1] == MIX for k in prefills._prompts)
    assert not steps.keys and not prefills.keys  # the CPU captures nothing
