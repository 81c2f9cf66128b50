"""The port's serving layer on the CPU: ``serve/pool.py`` (the port of
``tests/test_serving_pool.py``'s Delay tests), ``serve/text_norm.py`` and
``utils/native.float_to_pcm16`` against the JAX package, and
``engine/metrics.py``.

The pool tests use the JAX tests' tiny config (n_vq=4) in float32 with
weights from the JAX ``init_delay_params`` through the bridge; greedy
requests through the pool must give the solo engine's grids (the port's
engine equals the JAX engine on these weights, ``tests/test_torch_slice.py``
and ``tests/test_torch_batch_server.py``). Every wait has its own timeout.
"""
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.models.delay import init_delay_params
from mosstts_tpu.serve import text_norm as jax_text_norm
from mosstts_tpu.utils import native as jax_native
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.engine.metrics import SynthesisMetrics, trace_span
from mosstts_tpu_torch.models.delay import DelayParams, make_sampling
from mosstts_tpu_torch.serve import text_norm
from mosstts_tpu_torch.serve.pool import DelayServingPool
from mosstts_tpu_torch.utils.convert import load_tree_
from mosstts_tpu_torch.utils.native import float_to_pcm16
from tests.test_text_norm import GOLDEN

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
WAIT = 300  # seconds, for every wait on a thread or a request


def _grid(rng, T):
    g = rng.integers(0, 500, (T, CFG.channels))
    g[1, 0] = CFG.im_start_token_id
    g[-1, 0] = CFG.audio_assistant_gen_slot_token_id
    return g


def _params(seed):
    jp = init_delay_params(jax.random.PRNGKey(seed), CFG, dtype=jnp.float32)
    return load_tree_(DelayParams(CFG), jax.device_get(jp))


def _pool(params, **kw):
    return DelayServingPool(params, CFG, slots=2, cache_len=256, out_capacity=32,
                            prompt_bucket=16, dtype=torch.float32, **kw)


GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)


def test_pool_concurrent_callers_match_solo():
    params = _params(0)
    rng = np.random.default_rng(0)
    grids = [_grid(rng, 8 + i) for i in range(5)]
    pool = _pool(params, sampling=make_sampling(**GREEDY))
    try:
        results, errors = [None] * len(grids), []

        def call(i):
            try:
                ids = grids[i][None]
                results[i] = pool.generate(ids, np.ones((1, ids.shape[1]), bool),
                                           max_new_tokens=12, timeout=WAIT, **GREEDY)
            except Exception as e:  # surfaced in the main thread
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(grids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads) and not errors, errors

        engine = DelayEngine(params, CFG, dtype=torch.float32, cache_bucket=32)
        for i, grid in enumerate(grids):
            solo = engine.generate(grid[None], np.ones((1, grid.shape[0]), bool),
                                   max_new_tokens=12, **GREEDY)[0]
            start, toks = results[i][0]
            assert start == solo[0]
            T = min(len(toks), len(solo[1]))
            np.testing.assert_array_equal(toks[:T], solo[1][:T], err_msg=f"caller {i}")
    finally:
        pool.close()


def test_pool_dead_thread_surfaces_error():
    """If the decode thread dies, pending and later generate() calls raise
    instead of waiting forever."""
    params = _params(1)
    pool = _pool(params)
    try:
        def boom(*a, **kw):
            raise RuntimeError("injected step failure")

        pool.server.step_block = boom  # the method the decode loop drives
        ids = _grid(np.random.default_rng(1), 8)[None]
        with pytest.raises(RuntimeError) as first:
            pool.generate(ids, max_new_tokens=4, timeout=WAIT)
        assert "injected step failure" in str(first.value.__cause__)
        with pytest.raises(RuntimeError):
            pool.generate(ids, max_new_tokens=4, timeout=WAIT)
        pool._thread.join(timeout=WAIT)
        assert not pool._thread.is_alive()
    finally:
        pool.close()


def test_pool_rejects_mismatched_top_k_and_cross_batch_penalty():
    params = _params(2)
    pool = _pool(params)
    try:
        assert pool.supports(text_top_k=50, audio_top_k=25)
        assert not pool.supports(text_top_k=50, audio_top_k=50)
        ids = _grid(np.random.default_rng(3), 8)[None]
        with pytest.raises(ValueError):
            pool.generate(ids, max_new_tokens=4, audio_top_k=50)
        with pytest.raises(ValueError):
            pool.generate(ids, max_new_tokens=4, audio_rp_cross_batch=True)
    finally:
        pool.close()


def test_pool_backend_routes_and_solo_fallback():
    """``_generate_and_decode`` goes through ``backend.pool`` when the
    request's top-k widths are the pool's, and to the solo engine when they
    differ or the exact cross-batch penalty is asked for."""
    from mosstts_tpu_torch.serve.backend import load_codec
    from mosstts_tpu_torch.serve.pipelines import DelayBackend, _generate_and_decode, synthesize
    from mosstts_tpu_torch.processing.delay_processor import DelayProcessor
    from mosstts_tpu_torch.processing.tokenizer import ByteFallbackTokenizer

    codec = load_codec(None, device="cpu")
    cfg = DelayConfig(language_config=tiny_qwen3(hidden_size=128), n_vq=codec.config.n_q)
    engine = DelayEngine.random_init(seed=0, config=cfg, dtype=torch.float32, device="cpu")
    proc = DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=codec, config=cfg)
    pool = DelayServingPool(engine.params, cfg, slots=2, cache_len=512, out_capacity=64,
                            prompt_bucket=16, dtype=torch.float32)
    solo_calls = []
    solo = engine.generate

    def recorded(*a, **kw):
        solo_calls.append(kw)
        return solo(*a, **kw)

    engine.generate = recorded
    try:
        backend = DelayBackend(engine=engine, processor=proc, sample_rate=cfg.sampling_rate,
                               demo=True, pool=pool)
        sr, wav, status = synthesize(backend, "pool parity", mode="Direct",
                                     max_new_tokens=48, duration_tokens=8)
        assert sr == cfg.sampling_rate and wav.size > 0 and np.isfinite(wav).all()
        assert pool.server.total_steps > 0 and not solo_calls  # it went through the pool
        steps = pool.server.total_steps
        conv = [[proc.build_user_message(text="solo")]]
        kw = dict(max_new_tokens=40, temperature=1.0, top_p=0.8, repetition_penalty=1.0)
        _generate_and_decode(backend, conv, "generation", top_k=50, **kw)  # other width
        _generate_and_decode(backend, conv, "generation", top_k=25, rp_exact_mode=True, **kw)
        assert len(solo_calls) == 2 and solo_calls[1]["audio_rp_cross_batch"]
        assert pool.server.total_steps == steps
    finally:
        pool.close()


def test_pool_timeout_cleans_up_and_recovers():
    """A timed-out generate unregisters its events and its late results are
    dropped (no leak); the pool keeps serving."""
    params = _params(4)
    pool = _pool(params, sampling=make_sampling(**GREEDY))
    try:
        ids = _grid(np.random.default_rng(5), 8)[None]
        with pytest.raises(TimeoutError):
            pool.generate(ids, max_new_tokens=24, timeout=1e-6, **GREEDY)
        out = pool.generate(ids, max_new_tokens=8, timeout=WAIT, **GREEDY)
        assert len(out) == 1
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and (pool.server._active or pool.server._queue):
            time.sleep(0.05)
        time.sleep(0.1)  # the loop files the last completion after the step
        with pool._lock:
            assert not pool._events and not pool._results
            assert not pool._abandoned  # consumed when the result arrived
    finally:
        pool.close()


def test_pool_seed_reproducible_across_calls_and_concurrent_admission():
    """A seeded sampled request gives the same grid on every call, alone
    or admitted beside others, whatever its request id and slot."""
    params = _params(6)
    pool = _pool(params)
    try:
        rng = np.random.default_rng(7)
        ids, other = _grid(rng, 8)[None], _grid(rng, 11)[None]
        kw = dict(max_new_tokens=12, text_temperature=1.0, audio_temperature=1.0,
                  timeout=WAIT)
        a = pool.generate(ids, seed=123, **kw)
        b = pool.generate(ids, seed=123, **kw)  # later request ids, same seed
        c = pool.generate(ids, seed=124, **kw)
        np.testing.assert_array_equal(a[0][1], b[0][1])
        assert a[0][1].shape != c[0][1].shape or not np.array_equal(a[0][1], c[0][1])

        out, errors = {}, []

        def call(name, grid, seed):
            try:
                out[name] = pool.generate(grid, seed=seed, **kw)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=call, args=args)
                   for args in (("other", other, 5), ("again", ids, 123))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        np.testing.assert_array_equal(out["again"][0][1], a[0][1])
    finally:
        pool.close()


def test_engine_calls_from_threads_run_one_at_a_time():
    """Concurrent solo ``generate`` calls on one engine (the HTTP handlers'
    solo route) each get their own result: the engine's static decode state
    is taken by one call at a time."""
    params = _params(8)
    engine = DelayEngine(params, CFG, dtype=torch.float32, cache_bucket=32)
    rng = np.random.default_rng(9)
    grids = [_grid(rng, 8 + 3 * i) for i in range(3)]
    want = [engine.generate(g[None], max_new_tokens=10, **GREEDY)[0][1] for g in grids]
    got, errors = {}, []

    def call(i):
        try:
            got[i] = engine.generate(grids[i][None], max_new_tokens=10, **GREEDY)[0][1]
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("raw", [raw for raw, _ in GOLDEN])
def test_normalize_text_matches_jax(raw):
    assert text_norm.normalize_text(raw) == jax_text_norm.normalize_text(raw)


def test_dialogue_helpers_match_jax():
    for fn, args in (
        ("validate_dialogue_text", ("[S1]hi [S2]yo", 2)),
        ("merge_consecutive_speaker_tags", ("[S1]a [S1]b [S2]c",)),
        ("normalize_prompt_text", ("prompt one", 1)),
        ("normalize_prompt_text", ("[S2]already tagged", 2)),
        ("build_prefixed_text", ("[S1]hello", {1: "[S1]prompt one.", 2: "[S2]two."}, [1, 2])),
        ("estimate_duration_tokens", ("hello world",)),
        ("estimate_duration_tokens", ("你好世界",)),
    ):
        assert getattr(text_norm, fn)(*args) == getattr(jax_text_norm, fn)(*args), fn
    for bad in (("", 2), ("no tags", 2), ("[S3]over", 2)):
        with pytest.raises(ValueError):
            text_norm.validate_dialogue_text(*bad)
    assert text_norm.TOKENS_PER_SECOND == jax_text_norm.TOKENS_PER_SECOND


def test_float_to_pcm16_rounds_as_the_c_library():
    """Half-steps round to even, as the JAX package's C library (its numpy
    fallback truncates instead)."""
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's C audio library did not build (no g++)")
    k = np.arange(-40, 40, dtype=np.float32)
    cand = np.concatenate([(k + 0.5) / np.float32(32767), np.float32(k) / 32767])
    half = cand[(cand * np.float32(32767) % 1) == 0.5]
    assert half.size >= 20
    rng = np.random.default_rng(0)
    x = np.concatenate([half, rng.uniform(-1.2, 1.2, 1000).astype(np.float32),
                        np.float32([0.0, 1.0, -1.0, 2.0, -2.0, 1e-9])])
    got = float_to_pcm16(x)
    assert got.dtype == np.dtype("<i2")
    np.testing.assert_array_equal(got, jax_native.float_to_pcm16(x))
    np.testing.assert_array_equal(float_to_pcm16(half), np.rint(half * np.float32(32767)))


@pytest.mark.parametrize("scale", [0.001, 0.05, 0.1, 0.9])
def test_loudness_normalize_matches_the_c_library(scale):
    """Clamped (quiet, loud) and unclamped gains: the same float32 bits as
    the JAX package's C helper."""
    from mosstts_tpu.utils import audio as jax_audio
    from mosstts_tpu_torch.utils import audio

    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's C audio library did not build (no g++)")
    wav = (np.random.default_rng(1).standard_normal(24000) * scale).astype(np.float32)
    got = audio.loudness_normalize(wav)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_audio.loudness_normalize(wav))


def test_synthesis_metrics_report():
    m = SynthesisMetrics(sample_rate=24000)
    assert m.ttfa is None and m.rtf is None and m.frames_per_second is None
    with m.span("prefill"):
        time.sleep(0.01)
    with m.span("prefill"), trace_span("inner"):
        pass
    m.add_audio(0)
    assert m.ttfa is None
    m.add_audio(48000)
    m.add_frames(25)
    r = m.report()
    assert set(r) == {"ttfa_s", "rtf_x", "audio_s", "frames", "frames_per_s", "elapsed_s",
                      "spans"}
    assert r["audio_s"] == 2.0 and r["frames"] == 25 and r["ttfa_s"] >= 0.01
    assert r["rtf_x"] > 0 and r["frames_per_s"] > 0 and r["spans"]["prefill"] >= 0.01
    assert re.fullmatch(r"\{.*\}", m.json())
