"""The port's Local (MossTTSLocal) model against the JAX package on the CPU:
the tiny config of ``tests/test_local_model.py`` (4 codebooks, a 2-layer
depth transformer of width 24), float32, the same weights through
``utils.convert``.

The processor's grids are equal; ``local_embed``, the backbone without
rotary embeddings and ``attention_nopos`` agree within 1e-5; the depth
pass's tokens (float and int8 weights, full and cut bitrate, greedy and
with the repetition penalty at top-k 1), a prefill's state (the cache
within 1e-5) and three frames at a scalar and at per-row cursors (one row
frozen) equal JAX's. The JAX side compiles with most XLA optimizations
off (``fast_jax_compiles``). The engine and the server are
``tests/test_torch_local_engine.py`` and ``test_torch_local_server.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import LocalConfig, tiny_qwen3
from mosstts_tpu.models import local as jl
from mosstts_tpu.nn.qwen3 import qwen3_forward as jqwen3_forward
from mosstts_tpu.ops import attention as jattn
from mosstts_tpu.ops import quant as jquant
from mosstts_tpu.processing.local_processor import LocalProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.models import local as tl
from mosstts_tpu_torch.nn.qwen3 import qwen3_forward
from mosstts_tpu_torch.ops import attention as tattn
from mosstts_tpu_torch.ops.quant import quantize_tree_
from mosstts_tpu_torch.ops.sampling import row_keys
from mosstts_tpu_torch.processing.local_processor import LocalProcessor
from mosstts_tpu_torch.utils.convert import load_tree_

NVQ = 4
TINY = dict(n_vq=NVQ, additional_mlp_ffn_hidden_size=32, local_ffn_hidden_size=48,
            local_hidden_size=24, local_num_layers=2)
CFG = LocalConfig(language_config=tiny_qwen3(), **TINY)
TCFG = tconfig.LocalConfig(language_config=tconfig.tiny_qwen3(), **TINY)
GREEDY = dict(do_samples=[False] * CFG.channels)
NORMS = ("norm']", "ln1']", "ln2']", "ln_text']", "ln_audio']")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (its tiny eager steps are
    many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def fast_jax_compiles():
    """Most XLA optimizations off while this module runs: the tiny
    programs compile about twice as fast on one core, and the reference's
    results stay within the tolerances."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()  # the flag is not in JAX's cache keys (test_torch_train.jax_numerics)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def numpy_params(cfg=CFG, seed=0):
    """``jl.init_local_params``' tree for ``cfg`` (norms 1, every other leaf
    normal with std 0.02), drawn with numpy, which is faster than JAX's
    draws on one core."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith(NORMS):
            return jnp.ones(x.shape, x.dtype)
        return jnp.asarray(rng.standard_normal(x.shape, np.float32) * np.float32(0.02))

    shapes = jax.eval_shape(lambda: jl.init_local_params(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_params(jp, quantized=False, cfg=TCFG):
    tp = tl.LocalParams(cfg)
    if quantized:
        quantize_tree_(tp)
    return load_tree_(tp, jax.device_get(jp))


@pytest.fixture(scope="module")
def weights():
    jp = numpy_params()
    return jp, port_params(jp)


def prompt(B=2, T=9, seed=0):
    """A left-padded (B, T, C) grid with an ``audio_start`` row, and its mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, (B, T, CFG.channels))
    ids[..., 1:] = rng.integers(0, 1024, (B, T, NVQ))
    ids[:, 3, 0] = CFG.audio_start_token_id
    mask = np.ones((B, T), bool)
    mask[1, :2] = False
    ids[1, :2, 0] = CFG.pad_token_id
    return ids, mask


def test_processor_grids_equal_jax():
    tok = ByteFallbackTokenizer()
    proc = LocalProcessor(tok, audio_tokenizer=None, config=TCFG)
    jproc = JProcessor(tok, audio_tokenizer=None, config=CFG)
    codes = np.arange(3 * NVQ).reshape(3, NVQ) % CFG.audio_vocab_size
    convs = [[proc.build_user_message(text="hello", reference=[codes])],
             [proc.build_user_message(text="hi"),
              proc.build_assistant_message([codes[:2]]),
              proc.build_user_message(text="again, a longer turn")]]
    got, want = proc(convs, mode="generation"), jproc(convs, mode="generation")
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["input_ids"][0, -1, 0] == CFG.audio_start_token_id
    gen = np.asarray(tok.encode("a<|audio_start|><|audio_gen_slot|><|audio_end|> b"))
    assert proc._parse_text(0, gen) == jproc._parse_text(0, gen)
    with pytest.raises(RuntimeError):
        proc(convs[:1], mode="continuation")


def test_embed_use_rope_false_and_attention_nopos_match_jax(weights):
    jp, tp = weights
    ids, _ = prompt()
    for n in (NVQ, 2, 0):
        want = np.asarray(jl.local_embed(jp, CFG, jnp.asarray(ids), n))
        got = tl.local_embed(tp, TCFG, torch.tensor(ids), n).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    # the depth transformer over a whole block, no cache, no rotary embedding
    lcfg, B, T = CFG.local_transformer_config, 2, CFG.channels
    x = np.random.default_rng(1).standard_normal((B, T, 24)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _ = jqwen3_forward(jp["local"], lcfg, jnp.asarray(x), positions=jnp.asarray(pos),
                             kv_valid=jnp.ones((B, T), bool), use_rope=False)
    got, _ = qwen3_forward(tp.local, TCFG.local_transformer_config, torch.tensor(x),
                           positions=torch.tensor(pos), kv_valid=torch.ones((B, T), dtype=bool),
                           use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    rope, _ = qwen3_forward(tp.local, TCFG.local_transformer_config, torch.tensor(x),
                            positions=torch.tensor(pos), kv_valid=torch.ones((B, T), dtype=bool))
    assert not torch.allclose(rope, got)  # the flag does something

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 5, 2, 16)).astype(np.float32) for _ in range(2))
    want = jattn.attention_nopos(*(jnp.asarray(a) for a in (q, k, v)), scale=0.25)
    got = tattn.attention_nopos(*(torch.tensor(a) for a in (q, k, v)), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# greedy; and sampled at top-k 1 (deterministic) with the repetition penalty on
SAMPLINGS = {
    "greedy": (None, [False] * CFG.channels),
    "penalty_topk1": ([{"top_k": 1, "repetition_penalty": 1.0}]
                      + [{"top_k": 1, "repetition_penalty": 3.0, "temperature": 0.7}] * NVQ,
                      None),
}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_depth_decode_matches_jax(weights, int8, sampling):
    """The depth pass's tokens at the full and a cut bitrate, with and
    without a static depth cache (zeroed before use): equal to JAX's. The
    penalised case marks most of the vocabulary seen, so the penalty moves
    the choices."""
    jp, tp = weights
    if int8:
        jp = jquant.quantize_tree(jp)
        tp = port_params(jp, quantized=True)
    layers, do_samples = SAMPLINGS[sampling]
    rng = np.random.default_rng(3)
    B = 3
    g = rng.standard_normal((B, 64)).astype(np.float32)
    seen = rng.random((B, NVQ, CFG.audio_emb_vocab)) < 0.5
    seen_text = np.zeros((B, CFG.language_config.vocab_size), bool)
    js = jl.make_local_sampling(layers, do_samples, CFG.channels)
    ts = tl.make_local_sampling(layers, do_samples, CFG.channels)
    for n in (NVQ, 2):
        fn = jax.jit(lambda p, g_, st, sa: jl._depth_decode(
            p, CFG, jax.random.PRNGKey(0), g_, js, st, sa, n))
        w0, wa = fn(jp, jnp.asarray(g), jnp.asarray(seen_text), jnp.asarray(seen))
        depth = tl.init_local_state(TCFG, B, 8, 1, row_keys(0, B),
                                    dtype=torch.float32).depth
        for buf in depth:
            buf.fill_(7.0)  # stale values: the pass zeroes its slots first
        for cache in (None, depth):
            t0, ta = tl._depth_decode(tp, TCFG, row_keys(0, B), torch.tensor(g), ts,
                                      torch.tensor(seen_text), torch.tensor(seen), n,
                                      cache=cache)
            np.testing.assert_array_equal(t0.numpy(), np.asarray(w0))
            np.testing.assert_array_equal(ta.numpy(), np.asarray(wa))
        if n < NVQ:
            assert (ta[:, n:] == 0).all()


def _prefill(jp, tp, ids, mask, cache_len=64):
    js = jax.jit(lambda p, i, m: jl.local_prefill_split(
        p, CFG, i, m, max_new_tokens=8, cache_len=cache_len, rng=jax.random.PRNGKey(0),
        n_vq_infer=NVQ, dtype=jnp.float32))(jp, jnp.asarray(ids), jnp.asarray(mask))
    ts = tl.local_prefill_split(tp, TCFG, torch.tensor(ids), torch.tensor(mask),
                                max_new_tokens=8, cache_len=cache_len,
                                rng=row_keys(0, ids.shape[0]), n_vq_infer=NVQ,
                                dtype=torch.float32)
    return js, ts


FIELDS = ("kv_valid", "cur_ids", "pos", "step", "unfinished", "seen_text", "seen_audio", "out")


def _same_state(ts, js):
    for a, b in zip(ts.cache, js.cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_prefill_split_matches_jax(weights):
    jp, tp = weights
    ids, mask = prompt()
    js, ts = _prefill(jp, tp, ids, mask)
    _same_state(ts, js)
    assert ts.seen_text.any() and ts.seen_audio.any()


@pytest.mark.parametrize("per_row,int8", [(False, False), (True, False), (True, True)],
                         ids=["scalar", "per_row", "per_row_int8"])
def test_frame_steps_match_jax(weights, per_row, int8):
    """Three greedy frames after a prefill: every field equal (the cache
    within 1e-5). Per row: the cursors are (B,) and row 1 starts frozen
    (finished), so its cursors and output stay put."""
    jp, tp = weights
    if int8:
        jp = jquant.quantize_tree(jp)
        tp = port_params(jp, quantized=True)
    ids, mask = prompt(seed=4)
    js, ts = _prefill(jp, tp, ids, mask)
    if per_row:
        B = ids.shape[0]
        js = js._replace(pos=jnp.full((B,), js.pos), step=jnp.zeros((B,), jnp.int32),
                         unfinished=jnp.array([True, False]))
        ts = ts._replace(pos=ts.pos.expand(B).clone(), step=torch.zeros(B, dtype=torch.int32),
                         unfinished=torch.tensor([True, False]))
    samp = jl.make_local_sampling(None, GREEDY["do_samples"], CFG.channels)
    step = jax.jit(lambda p, s: jl.local_frame_step(p, CFG, s, samp, n_vq_infer=NVQ,
                                                    eos_token_id=CFG.audio_end_token_id,
                                                    attend_len=32))
    tsamp = tl.make_local_sampling(None, GREEDY["do_samples"], CFG.channels)
    for _ in range(3):
        js = step(jp, js)
        ts = tl.local_frame_step(tp, TCFG, ts, tsamp, n_vq_infer=NVQ,
                                 eos_token_id=CFG.audio_end_token_id, attend_len=32)
    _same_state(ts, js)
    if per_row:
        assert ts.pos.tolist() == [ids.shape[1] + 2, ids.shape[1] - 1]
