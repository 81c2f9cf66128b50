"""The four Delay apps on the port against the JAX package on the CPU:
``synthesize`` (Clone and Continuation from a wave file),
``synthesize_dialogue`` (two speakers cloned from wave files),
``generate_voice`` and ``generate_sound_effect``.

Both stacks hold the same weights: a ``tiny_qwen3(hidden_size=128)``
backbone with n_vq=4 and the tiny 24 kHz codec of
``tests/test_delay_e2e.py``, made by the JAX ``random_init`` functions and
bridged. The reference waves come from a numpy seed through ``write_wav``
and are encoded by each stack's own codec. The pipelines sample the text
channel at temperature 1.5, so each backend's engine is wrapped to decode
greedily (text and audio at temperature 0): JAX's and PyTorch's random
streams then do not matter, and the wrapper records the generated grids.

The same weights, written with the codec and the tokenizer fixture's
``tokenizer.json`` into a checkpoint directory, load through both packages'
``load_delay_backend(dir)``: ``transformers``' tokenizer in JAX, the port's
own reader, and a mixed-script request gives the same greedy grid.

Tolerance: the grids equal; the waveforms within 1e-4 absolute (float32).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec.model import MossAudioTokenizer as JaxCodec
from mosstts_tpu.core.config import CodecConfig, DelayConfig, tiny_qwen3
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.processing.delay_processor import DelayProcessor as JaxProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer as JaxTokenizer
from mosstts_tpu.serve import backend as jbackend
from mosstts_tpu.serve import pipelines as jp
from mosstts_tpu_torch.codec.model import CodecParams, MossAudioTokenizer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import DelayParams
from mosstts_tpu_torch.processing.delay_processor import DelayProcessor
from mosstts_tpu_torch.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.processing.bpe import Qwen2BPETokenizer
from mosstts_tpu_torch.serve import backend as tbackend
from mosstts_tpu_torch.serve import pipelines as tp
from mosstts_tpu_torch.tools.hf_checkpoint import write_hf_checkpoint
from mosstts_tpu_torch.tools.tokenizer_fixture import write_tokenizer_dir
from mosstts_tpu_torch.utils.checkpoints import delay_table
from mosstts_tpu_torch.utils.audio import write_wav
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(hidden_size=128), n_vq=4)
CODEC_CFG = CodecConfig(
    sampling_rate=24000, frame_rate=12.5, n_q=4, codebook_size=1024,
    codebook_dim=8, hidden_size=32, intermediate_size=64,
    num_encoder_layers=1, num_decoder_layers=1, num_attention_heads=2,
    num_key_value_heads=2, head_dim=16, causal_context=8,
)
NEW = 40  # new frames per request


class GreedyEngine:
    """An engine whose ``generate`` decodes text and audio greedily and
    keeps every call's output."""

    def __init__(self, engine):
        self.engine, self.config, self.calls = engine, engine.config, []

    def generate(self, *args, **kw):
        kw.update(text_temperature=0.0, audio_temperature=0.0)
        out = self.engine.generate(*args, **kw)
        self.calls.append(out)
        return out


@pytest.fixture(scope="module")
def backends():
    jcodec = JaxCodec.random_init(seed=0, config=CODEC_CFG)
    jengine = JaxEngine.random_init(seed=0, config=CFG, dtype=jnp.float32, cache_bucket=64)
    tcodec = MossAudioTokenizer(
        load_tree_(CodecParams(CODEC_CFG), jax.device_get(jcodec.params)), CODEC_CFG)
    tengine = DelayEngine(load_tree_(DelayParams(CFG), jax.device_get(jengine.params)), CFG,
                          dtype=torch.float32, cache_bucket=64)
    jb = jp.DelayBackend(engine=GreedyEngine(jengine), demo=True,
                         processor=JaxProcessor(JaxTokenizer(), audio_tokenizer=jcodec,
                                                config=CFG))
    tb = tp.DelayBackend(engine=GreedyEngine(tengine), demo=True,
                         processor=DelayProcessor(ByteFallbackTokenizer(),
                                                  audio_tokenizer=tcodec, config=CFG))
    return jb, tb


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two reference voices at 24 kHz: 1.0 s and 0.7 s of a seeded sine
    sweep plus noise."""
    d = tmp_path_factory.mktemp("refs")
    rng = np.random.default_rng(0)
    paths = []
    for i, secs in enumerate((1.0, 0.7)):
        t = np.arange(int(24000 * secs)) / 24000
        wav = 0.3 * np.sin(2 * np.pi * (180 + 120 * i + 200 * t) * t) \
            + 0.05 * rng.standard_normal(t.size)
        path = d / f"voice{i}.wav"
        write_wav(path, wav.astype(np.float32), 24000)
        paths.append(str(path))
    return paths


def _same(jb, tb, jout, tout):
    (jsr, jwav, jstatus), (tsr, twav, tstatus) = jout, tout
    assert tsr == jsr == 24000
    assert tstatus.startswith("Done")
    assert re.sub(r"elapsed=\S+", "", tstatus) == re.sub(r"elapsed=\S+", "", jstatus)
    jcall, tcall = jb.engine.calls[-1], tb.engine.calls[-1]
    assert len(tcall) == len(jcall) == 1
    assert tcall[0][0] == jcall[0][0]
    np.testing.assert_array_equal(tcall[0][1], jcall[0][1])
    assert twav.ndim == 1 and twav.size > 0 and np.isfinite(twav).all()
    assert twav.shape == jwav.shape
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["Clone", "Continuation"])
def test_synthesize_from_a_wave_file_matches_jax(backends, wavs, mode):
    jb, tb = backends
    kw = dict(mode=mode, reference_audio=wavs[0], max_new_tokens=NEW, seed=1)
    _same(jb, tb, jp.synthesize(jb, "clone this voice", **kw),
          tp.synthesize(tb, "clone this voice", **kw))
    # the reference codes both stacks put into the prompt
    ref = tb.processor.encode_audios_from_path([wavs[0]])[0]
    assert ref.shape == (13, CFG.n_vq) and ref.dtype == np.int64
    np.testing.assert_array_equal(ref, jb.processor.encode_audios_from_path([wavs[0]])[0])


def test_synthesize_dialogue_two_wave_speakers_matches_jax(backends, wavs):
    jb, tb = backends
    speakers = {1: (wavs[0], "[S1]This is the first voice."),
                2: (wavs[1], "[S2]And this is the second.")}
    kw = dict(speakers=speakers, max_new_tokens=NEW, seed=2)
    text = "[S1]Hello there, how are you? [S2]Fine, thanks."
    jout = jp.synthesize_dialogue(jb, text, **kw)
    tout = tp.synthesize_dialogue(tb, text, **kw)
    assert "voice_clone_and_continuation" in tout[2] and "speakers=2" in tout[2]
    _same(jb, tb, jout, tout)


def test_generate_voice_matches_jax(backends):
    jb, tb = backends
    kw = dict(max_new_tokens=NEW, seed=3)
    _same(jb, tb, jp.generate_voice(jb, "hello", "a deep calm voice", **kw),
          tp.generate_voice(tb, "hello", "a deep calm voice", **kw))


def test_generate_sound_effect_matches_jax(backends):
    jb, tb = backends
    jout = jp.generate_sound_effect(jb, "rain on a tin roof", 1.0, seed=4)
    tout = tp.generate_sound_effect(tb, "rain on a tin roof", 1.0, seed=4)
    assert "tokens=12" in tout[2]
    _same(jb, tb, jout, tout)


def test_empty_sound_effect_and_unknown_mode_raise(backends):
    _, tb = backends
    with pytest.raises(ValueError):
        tp.generate_sound_effect(tb, "  ", 1.0)
    with pytest.raises(ValueError):
        tp.synthesize(tb, "x", mode="Clone")  # no reference
    with pytest.raises(ValueError):
        tp.synthesize(tb, "x", mode="Whisper")


def _outcome(fn, *args, **kw):
    """``fn``'s result, or its ``RuntimeError``'s message."""
    try:
        return fn(*args, **kw)
    except RuntimeError as e:
        return str(e)


def test_checkpoint_directory_with_its_tokenizer_serves_like_jax(backends, tmp_path):
    """The module's weights as float32 shards in the reference layout, with
    the fixture's tokenizer files, and its codec: JAX's and the port's
    ``load_delay_backend(dir, codec_dir, "float32")`` read the tokenizer
    (``transformers`` in JAX, ``Qwen2BPETokenizer`` in the port), and a
    mixed-script ``synthesize`` gives the same greedy grid, and the same wave
    or the same error (each loaded backend served as a demo one, whose
    prompt opens the audio block, which random weights may close at once)."""
    pytest.importorskip("transformers")
    _, tb = backends
    model, codec = tmp_path / "model", tmp_path / "codec"
    write_hf_checkpoint(model, tb.engine.engine.params, CFG, delay_table(CFG))
    write_tokenizer_dir(model)
    tb.processor.audio_tokenizer.save_pretrained(codec)
    jl = jbackend.load_delay_backend(str(model), str(codec), "float32")
    tl = tbackend.load_delay_backend(str(model), str(codec), "float32", device="cpu")
    assert type(jl.processor.tokenizer).__name__ == "Qwen2TokenizerFast"
    assert type(tl.processor.tokenizer) is Qwen2BPETokenizer
    assert not (jl.demo or tl.demo)
    jb = jp.DelayBackend(engine=GreedyEngine(jl.engine), processor=jl.processor, demo=True)
    tb = tp.DelayBackend(engine=GreedyEngine(tl.engine), processor=tl.processor, demo=True)
    text = "Hello 世界, it's 12:30 — 天气很好 😀!"
    jout, tout = (_outcome(mod.synthesize, b, text, max_new_tokens=NEW, seed=5)
                  for mod, b in ((jp, jb), (tp, tb)))
    (jstart, jgrid), = jb.engine.calls[-1]
    (tstart, tgrid), = tb.engine.calls[-1]
    assert tstart == jstart
    np.testing.assert_array_equal(tgrid, jgrid)
    assert CFG.audio_start_token_id in tgrid[:, 0]  # the request reached the audio block
    if isinstance(jout, str):  # greedy random weights may close the block at once
        assert tout == jout
    else:
        (jsr, jwav, jstatus), (tsr, twav, tstatus) = jout, tout
        assert re.sub(r"elapsed=\S+", "", tstatus) == re.sub(r"elapsed=\S+", "", jstatus)
        assert tsr == jsr and twav.shape == jwav.shape
        np.testing.assert_allclose(twav, jwav, rtol=0, atol=1e-4)
    ids = tl.processor.tokenizer.encode(text)
    assert ids == jl.processor.tokenizer.encode(text) and len(ids) < len(text.encode())
