"""The whole Delay slice on the port against the JAX package on CPU, tiny
config (n_vq=4) and the tiny codec of tests/test_delay_e2e.py, same
weights: greedy generate -> ``processor.decode`` -> codec waveform.

Tolerance: the token grids must be equal; the waveforms agree to atol 1e-4
(float32 on both sides). ``synthesize`` samples text at temperature 1.5, so
it is checked for a finite waveform and per-seed determinism, not across
frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec.model import MossAudioTokenizer as JaxCodec
from mosstts_tpu.core.config import CodecConfig, DelayConfig, tiny_qwen3
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.codec.model import CodecParams, MossAudioTokenizer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import DelayParams
from mosstts_tpu_torch.serve.pipelines import DelayBackend, demo_backend, synthesize
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
CODEC_CFG = CodecConfig(
    sampling_rate=24000, frame_rate=12.5, n_q=4, codebook_size=1024,
    codebook_dim=8, hidden_size=32, intermediate_size=64,
    num_encoder_layers=1, num_decoder_layers=1, num_attention_heads=2,
    num_key_value_heads=2, head_dim=16, causal_context=8,
)


@pytest.fixture(scope="module")
def stacks():
    jcodec = JaxCodec.random_init(seed=0, config=CODEC_CFG)
    jengine = JaxEngine.random_init(seed=0, config=CFG, dtype=jnp.float32, cache_bucket=64)
    tcodec = MossAudioTokenizer(
        load_tree_(CodecParams(CODEC_CFG), jax.device_get(jcodec.params)), CODEC_CFG)
    tengine = DelayEngine(load_tree_(DelayParams(CFG), jax.device_get(jengine.params)), CFG,
                          dtype=torch.float32, cache_bucket=64)
    tok = ByteFallbackTokenizer()
    jproc = DelayProcessor(tok, audio_tokenizer=jcodec, config=CFG)
    tproc = DelayProcessor(tok, audio_tokenizer=tcodec, config=CFG)
    return (jengine, jproc), (tengine, tproc)


def test_codec_decode_matches_jax(stacks):
    (_, jproc), (_, tproc) = stacks
    codes = np.random.default_rng(0).integers(0, 1024, size=(4, 2, 23))
    mask = np.ones((2, 23), bool)
    mask[1, 17:] = False
    ja = jproc.audio_tokenizer.decode(codes, padding_mask=mask, chunk_duration=1)
    ta = tproc.audio_tokenizer.decode(codes, padding_mask=mask, chunk_duration=1)
    np.testing.assert_array_equal(ta.audio_lengths, ja.audio_lengths)
    np.testing.assert_allclose(ta.audio, ja.audio, rtol=1e-4, atol=1e-4)


def test_greedy_generate_decode_waveform_matches_jax(stacks):
    (jengine, jproc), (tengine, tproc) = stacks
    rng = np.random.default_rng(1)
    convs = [[jproc.build_user_message(text=t),
              jproc.build_assistant_message([rng.integers(0, 1024, size=(n, CFG.n_vq))])]
             for t, n in (("first voice", 6), ("second, longer voice prompt", 11))]
    batch = jproc(convs, mode="continuation")
    kw = dict(max_new_tokens=28, text_temperature=0.0, audio_temperature=0.0)
    jout = jengine.generate(batch["input_ids"], batch["attention_mask"], **kw)
    tout = tengine.generate(batch["input_ids"], batch["attention_mask"], **kw)
    for (jl, jg), (tl, tg) in zip(jout, tout):
        assert tl == jl
        np.testing.assert_array_equal(tg, jg)
    jmsgs, tmsgs = jproc.decode(jout), tproc.decode(tout)
    for jm, tm in zip(jmsgs, tmsgs):
        assert tm.content == jm.content
        assert len(tm.audio_codes_list) == len(jm.audio_codes_list) >= 1
        for tw, jw in zip(tm.audio_codes_list, jm.audio_codes_list):
            assert tw.size > 0 and np.isfinite(tw).all()
            np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-4)


def test_synthesize_is_finite_and_deterministic_per_seed(stacks):
    _, (tengine, tproc) = stacks
    backend = DelayBackend(engine=tengine, processor=tproc, demo=True)
    sr, wav, status = synthesize(backend, "hello there", max_new_tokens=24, seed=3)
    assert sr == 24000 and status.startswith("Done")
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
    _, again, _ = synthesize(backend, "hello there", max_new_tokens=24, seed=3)
    np.testing.assert_array_equal(again, wav)


def test_demo_backend_builds_the_stack_and_synthesizes():
    """``demo_backend`` draws the engine and the codec from one seed: the
    same seed gives the same weights, and the stack synthesizes audio."""
    kw = dict(seed=5, dtype=torch.float32, device="cpu", cache_bucket=64)
    a, b = demo_backend(CFG, CODEC_CFG, **kw), demo_backend(CFG, CODEC_CFG, **kw)
    assert a.demo and a.engine.cache_bucket == 64 and a.processor.audio_tokenizer is not None
    for (name, pa), (_, pb) in zip(a.engine.params.named_parameters(),
                                   b.engine.params.named_parameters()):
        assert torch.equal(pa, pb), name
    sr, wav, _ = synthesize(a, "demo", max_new_tokens=20, seed=1)
    assert sr == 24000 and wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
