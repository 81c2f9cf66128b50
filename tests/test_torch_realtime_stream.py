"""The port's streaming layer (``engine/streaming.py``) against the JAX
package's on the CPU.

``AudioStreamDecoder`` gives JAX's chunks sample for sample on the codec
of JAX's crossfade golden (``tests/test_realtime.py``), with uniform and
early first windows; ``TextDeltaTokenizer``, ``sanitize_audio_tokens``,
``stream_with_prebuffer`` and ``AudioTokenCache`` give JAX's outputs on the
same inputs. Then a whole stream: text deltas through
``RealtimeTextStreamBridge``, ``RealtimeStreamingSession`` and the greedy
engine (the tiny config of ``tests/test_realtime.py``, the same weights)
into the decoder, whose codec records the frames it is given: frames and
chunks equal the JAX stack's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine import streaming as js
from mosstts_tpu.engine.realtime_engine import RealtimeEngine as JEngine
from mosstts_tpu.processing.realtime_processor import RealtimeProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu.utils import native as jax_native
from mosstts_tpu_torch.engine import streaming as ts
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from mosstts_tpu_torch.utils.audio import write_wav
from test_torch_realtime import (CFG, RVQ, TCFG, fast_jax_compiles,  # noqa: F401
                                 numpy_params, one_thread, port_params, proc)


class SeqCodec:
    """The golden's codec: call n returns ``100 n + arange(5 T)``."""

    codebook_size = 1024

    def __init__(self):
        self.calls = 0
        self.seen = []

    def decode(self, tokens, chunk_duration=None, **kw):
        tokens = np.asarray(tokens)
        self.seen.append(tokens.copy())
        self.calls += 1
        return {"audio": [100.0 * self.calls + np.arange(tokens.shape[1] * 5,
                                                         dtype=np.float32)]}


def _c_library():
    """The JAX package's seams come from its C library (its numpy fallback
    rounds differently, by an ulp); the port computes as the library."""
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's C audio library did not build (no g++)")


def _decode(mod, pushes, **kw):
    if kw["overlap_frames"]:
        _c_library()
    codec = SeqCodec()
    dec = mod.AudioStreamDecoder(codec, **kw)
    chunks = []
    for n in pushes:
        dec.push_tokens(np.zeros((n, RVQ), np.int64))
        chunks += list(dec.audio_chunks())
    return chunks, dec.flush()


@pytest.mark.parametrize("kw,pushes", [
    (dict(chunk_frames=4, overlap_frames=2), [5, 6]),  # the golden: 2 chunks + an 18-sample tail
    (dict(chunk_frames=4, overlap_frames=1), [9]),
    (dict(chunk_frames=4, overlap_frames=0, first_chunk_frames=1), [1, 8]),
    (dict(chunk_frames=12, overlap_frames=2, first_chunk_frames=2), [1, 3, 20, 7]),
])
def test_stream_decoder_equals_jax(kw, pushes):
    want, want_tail = _decode(js, pushes, **kw)
    got, got_tail = _decode(ts, pushes, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if want_tail is None:
        assert got_tail is None
    else:
        np.testing.assert_array_equal(got_tail, want_tail)


def test_text_delta_tokenizer_and_sanitize_equal_jax():
    tok = ByteFallbackTokenizer()
    full = "incremental delta emission schedule pin, hello world."
    for hold, step in ((3, 7), (0, 5), (5, 1)):
        a, b = js.TextDeltaTokenizer(tok, hold_back=hold), ts.TextDeltaTokenizer(tok,
                                                                               hold_back=hold)
        for i in range(0, len(full), step):
            assert b.push_delta(full[i:i + step]) == a.push_delta(full[i:i + step])
        assert b.flush() == a.flush() and b.push_delta("") == []
        assert b.token_ids == a.token_ids and b.text == a.text
    for t in ([[1, 2], [1026, 0], [3, 4]], [[1, 2], [3, 2000]], [[1, 2], [3, 4]], [[-1, 2]],
              [5, 6], np.zeros((0, 2), np.int64)):
        (wt, ws), (gt, gs) = (m.sanitize_audio_tokens(np.asarray(t), codebook_size=1024,
                                                      audio_eos_token=1026) for m in (js, ts))
        np.testing.assert_array_equal(gt, wt)
        assert gs == ws


def test_prebuffer_tracker_and_token_cache_equal_jax(tmp_path):
    chunks = [np.full(n, i, np.float32) for i, n in enumerate((100, 2000, 50, 4000, 10))]
    for pre in (0.0, 0.05, 10.0):
        want = list(js.stream_with_prebuffer(iter(chunks), 24000, prebuffer_seconds=pre))
        got = list(ts.stream_with_prebuffer(iter(chunks), 24000, prebuffer_seconds=pre))
        assert len(got) == len(want) == len(chunks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    tracker = ts.BufferedAudioTracker(24000)
    assert tracker.buffered_seconds() == 0.0
    tracker.add(np.zeros(24000, np.float32))
    assert 0.0 < tracker.buffered_seconds() <= 1.0

    path = tmp_path / "v.wav"
    write_wav(path, np.zeros(480, np.float32), 24000)
    caches = js.AudioTokenCache(max_entries=1), ts.AudioTokenCache(max_entries=1)
    for cache in caches:
        for kw in (None, None, {"n": 1}, None):
            cache.get_or_encode(str(path), lambda p: np.arange(4), kw)
    assert [(c.hits, c.misses, len(c._store)) for c in caches] == [(1, 3, 1)] * 2


def _stream(engine, processor):
    codec = SeqCodec()
    session_cls = ts if isinstance(engine, RealtimeEngine) else js
    session = session_cls.RealtimeStreamingSession(
        engine, processor, codec=codec, temperature=0.0, do_sample=False,
        prefill_text_len=6)
    session.reset_turn(user_text="hello there",
                       user_audio_tokens=np.random.default_rng(0).integers(0, 1024, (4, RVQ)))
    decoder = session_cls.AudioStreamDecoder(codec, chunk_frames=4, overlap_frames=1,
                                             first_chunk_frames=1)
    bridge = session_cls.RealtimeTextStreamBridge(session, decoder)
    chunks = []
    for delta in ["this is ", "the reply, ", "streamed in ", "pieces."]:
        chunks += list(bridge.push_text_delta(delta))
    # bridge.finish() drains until EOS, which random weights need not reach:
    # end the text and drain a bounded number of frames instead
    chunks += list(bridge._decode_audio_frames(session.end_text()))
    chunks += list(bridge._decode_audio_frames(session.drain(max_steps=5)))
    chunks.append(decoder.flush())
    return chunks, codec.seen, len(engine.generated_tokens)


def test_bridge_stream_equals_jax(proc):
    """Deltas -> session -> greedy engine -> decoder, both stacks: the same
    frames reach the codec and the same chunks come out."""
    _c_library()
    jp = numpy_params()
    kw = dict(max_length=24, cache_len=512, prefill_bucket=512)
    je = JEngine(jp, CFG, dtype=jnp.float32, **kw)
    te = RealtimeEngine(port_params(jp), TCFG, dtype=torch.float32, device="cpu", **kw)
    want = _stream(je, JProcessor(ByteFallbackTokenizer(), channels=RVQ))
    got = _stream(te, proc)
    assert got[2] == want[2] > 1 and len(got[0]) == len(want[0]) > 1
    for g, w in zip(got[1], want[1], strict=True):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[0], want[0], strict=True):
        np.testing.assert_array_equal(g, w)
