"""The port's Realtime model against the JAX package on the CPU: the tiny
config of ``tests/test_realtime.py`` (RVQ 4, head_dim 16), float32, the
same weights through ``utils.convert``.

The processor's grids are equal; ``realtime_embed`` agrees within 1e-5 and
``window_seen_mask`` exactly; the depth loop's greedy frames (scalar and
per-row ``hist_len``, float and int8 weights) and a batch prefill's state
(the cache within 1e-5) equal JAX's. The JAX side compiles with most XLA
optimizations off (``fast_jax_compiles``), which keeps the file near 15 s
on one core. The engine is ``tests/test_torch_realtime_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import RealtimeConfig, RealtimeLocalConfig, tiny_qwen3
from mosstts_tpu.models import realtime as jr
from mosstts_tpu.ops import quant as jquant
from mosstts_tpu.ops import sampling as jsamp
from mosstts_tpu.processing.realtime_processor import RealtimeProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from mosstts_tpu_torch.models import realtime as tr
from mosstts_tpu_torch.ops import sampling as tsamp
from mosstts_tpu_torch.ops.quant import quantize_tree_
from mosstts_tpu_torch.processing.realtime_processor import RealtimeProcessor
from mosstts_tpu_torch.utils.convert import load_tree_

RVQ = 4
TINY = dict(
    language_config=dict(hidden_size=32, num_attention_heads=2, num_key_value_heads=2,
                         head_dim=16, intermediate_size=64),
    local_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=2, head_dim=16, rvq=RVQ,
                      max_position_embeddings=RVQ + 1),
)
CFG = RealtimeConfig(language_config=tiny_qwen3(**TINY["language_config"]),
                     local_config=RealtimeLocalConfig(**TINY["local_config"]), rvq=RVQ)
TCFG = tconfig.RealtimeConfig(
    language_config=tconfig.tiny_qwen3(**TINY["language_config"]),
    local_config=tconfig.RealtimeLocalConfig(**TINY["local_config"]), rvq=RVQ)
GREEDY = dict(do_sample=False, temperature=0.0)


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
    """Most XLA optimizations off while this module runs: a compile of the
    tiny programs then takes ~2 s instead of ~4 s on one core, and the
    reference's results stay within the tolerances."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()  # the flag is not in JAX's cache keys (test_torch_train.jax_numerics)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def numpy_params(cfg=CFG, seed=0):
    """``jr.init_realtime_params``' tree for ``cfg`` (norms 1, every other
    leaf normal with std 0.02), drawn with numpy, which is faster than
    JAX's draws on one core."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith(("norm']", "ln1']", "ln2']")):
            return jnp.ones(x.shape, x.dtype)
        return jnp.asarray(rng.standard_normal(x.shape, np.float32) * np.float32(0.02))

    shapes = jax.eval_shape(lambda: jr.init_realtime_params(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_params(jp, quantized=False):
    tp = tr.RealtimeParams(TCFG)
    if quantized:
        quantize_tree_(tp)
    return load_tree_(tp, jax.device_get(jp))


@pytest.fixture(scope="module")
def weights():
    jp = numpy_params()
    return jp, port_params(jp)


@pytest.fixture(scope="module")
def proc():
    return RealtimeProcessor(ByteFallbackTokenizer(), channels=RVQ)


def _turn(proc, text, seed, frames=4, system=False):
    user_audio = np.random.default_rng(seed).integers(0, 1024, (frames, RVQ))
    grid = proc.make_user_prompt(text, user_audio)
    return np.concatenate([proc.make_ensemble(None), grid], axis=0) if system else grid


def test_processor_grids_equal_jax(proc):
    jproc = JProcessor(ByteFallbackTokenizer(), channels=RVQ)
    tokens = np.arange(RVQ * 5).reshape(5, RVQ) % 1024
    np.testing.assert_array_equal(proc.make_ensemble(tokens), jproc.make_ensemble(tokens))
    np.testing.assert_array_equal(proc.make_ensemble(None), jproc.make_ensemble(None))
    for text in ("hi", "hello world this is a much longer sentence for the test"):
        audio = np.random.default_rng(0).integers(0, 1024, (6, RVQ))
        np.testing.assert_array_equal(proc.make_user_prompt(text, audio),
                                      jproc.make_user_prompt(text, audio))


def test_realtime_embed_and_window_seen_mask(weights):
    jp, tp = weights
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.audio_vocab_size + 3, (3, 7, RVQ + 1))  # some past Va: clipped
    ids[..., 0] = rng.integers(0, 151000, (3, 7))
    want = np.asarray(jr.realtime_embed(jp, CFG, jnp.asarray(ids)))
    got = tr.realtime_embed(tp, TCFG, torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    hist = rng.integers(-2, 1030, (3, RVQ, 50))  # out-of-range tokens mark nothing
    valid = rng.random((3, RVQ, 50)) < 0.7
    for v in (None, valid):
        want = np.asarray(jsamp.window_seen_mask(jnp.asarray(hist), 1027,
                                                 valid=None if v is None else jnp.asarray(v)))
        got = tsamp.window_seen_mask(torch.tensor(hist), 1027,
                                     valid=None if v is None else torch.tensor(v)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_row,int8", [(False, False), (True, False), (True, True)],
                         ids=["scalar", "per_row", "per_row_int8"])
def test_depth_generate_frame_matches_jax(weights, per_row, int8):
    """Greedy frames with and without the windowed penalty, over a history
    whose window is partly and wholly filled (per row: each row at its own
    length); with int8 weights each local head goes through the W8A16
    route's plain version, one head's slice per depth step."""
    jp, tp = weights
    if int8:
        jp = jquant.quantize_tree(jp)
        tp = port_params(jp, quantized=True)
    rng = np.random.default_rng(1)
    B = 3
    hidden = rng.standard_normal((B, 32)).astype(np.float32)
    hist = rng.integers(0, 1024, (B, 70, RVQ)).astype(np.int32)
    hist_len = np.array([3, 55, 70], np.int32) if per_row else np.int32(60)
    frame = jax.jit(lambda p, h, hi, hl, s: jr.depth_generate_frame(
        p, CFG, jax.random.PRNGKey(1), h, hi, hl, s))
    frames = []
    for rp in (1.0, 1.3):
        want = np.asarray(frame(jp, jnp.asarray(hidden), jnp.asarray(hist),
                                jnp.asarray(hist_len), jr.make_rt_sampling(0.0, 0.6, rp, False)))
        got = tr.depth_generate_frame(
            tp, TCFG, tsamp.row_keys(0, B), torch.tensor(hidden),
            torch.tensor(hist), torch.tensor(hist_len),
            tr.make_rt_sampling(0.0, 0.6, rp, False)).numpy()
        np.testing.assert_array_equal(got, want)
        frames.append(got)
    assert not np.array_equal(frames[0], frames[1])  # the penalty changed a choice


def test_prefill_state_matches_jax(weights, proc):
    """A left-padded batch-2 prefill at a scalar cursor: the cache within
    1e-5, the mask, cursors, history and first frame exactly."""
    jp, tp = weights
    rows = [_turn(proc, "one", 0), _turn(proc, "a longer two", 1, frames=7, system=True)]
    T = max(r.shape[0] for r in rows)
    ids = np.full((2, T, RVQ + 1), CFG.audio_pad_token, np.int64)
    ids[..., 0] = 151643
    valid = np.zeros((2, T), bool)
    for i, r in enumerate(rows):
        ids[i, T - r.shape[0]:] = r
        valid[i, T - r.shape[0]:] = True
    js = jr.init_realtime_state(CFG, 2, 512, 40, jax.random.PRNGKey(0), dtype=jnp.float32)
    js, jf = jax.jit(lambda p, st, i, v, s: jr.realtime_prefill_step(
        p, CFG, st, i, v, s, attend_len=384))(jp, js, jnp.asarray(ids), jnp.asarray(valid),
                                              jr.make_rt_sampling(0.0))
    ts = tr.init_realtime_state(TCFG, 2, 512, 40, tsamp.row_keys(0, 2),
                                dtype=torch.float32)
    ts, tf = tr.realtime_prefill_step(tp, TCFG, ts, torch.tensor(ids), torch.tensor(valid),
                                      tr.make_rt_sampling(0.0), attend_len=384)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for a, b in zip(ts.cache, js.cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    for name in ("kv_valid", "cur_len", "last_audio", "is_stopping", "history", "hist_len"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_quantize_keeps_the_conversation(weights, proc):
    """``quantize()`` builds the frames anew over the same state: the
    conversation goes on, and the old decode steps (over the float
    weights) refuse to step."""
    jp, _ = weights
    te = RealtimeEngine(port_params(jp), TCFG, dtype=torch.float32, device="cpu",
                        max_length=32, cache_len=256, prefill_bucket=16)
    te.prefill([_turn(proc, "q", 2)], [proc.tokenizer.encode("abc")], **GREEDY)
    old, st = te._steps, te.state
    te.quantize()
    assert te._steps is not old and te.state is st
    assert te.step(None, **GREEDY).shape == (1, RVQ)
    with pytest.raises(RuntimeError, match="quantize"):
        old.step(attend_len=128, top_k=30)


def test_seeds_reproduce_sampled_frames(weights, proc):
    """Seeds s1, s2, s1: equal, different, equal (the port's own draws)."""
    _, tp = weights
    te = RealtimeEngine(tp, TCFG, dtype=torch.float32, device="cpu", max_length=32,
                        cache_len=256, prefill_bucket=16)
    grid, text = [_turn(proc, "seeded", 4)], [proc.tokenizer.encode("sampled reply text")]
    runs = [te.generate(grid, text, max_length=6, prefill_text_len=4, seed=s,
                        temperature=1.0, top_p=0.95)[0] for s in (1, 2, 1)]
    np.testing.assert_array_equal(runs[0], runs[2])
    assert not np.array_equal(runs[0], runs[1])
