"""The codec's chunk programs against the JAX package on the CPU: the port's
``run_chunk``, ``_encode_chunk`` and ``_decode_chunk`` (a device ``valid_len``
and cursor, the kept window and the carried tail picked on the device) over
four chunks with ``valid_len`` c, 1, c - 1 and c, against JAX's, and the
static-buffer chunk runner (``engine/step_graph.CodecChunks``), which runs
every chunk eagerly on the CPU.

Tiny config: 2 + 2 layers of width 32, 4 levels of 32 entries, a window
(``causal_context``) of 8 frames, chunks of 5 frames; same weights through
the bridge, inputs from numpy seeds. Tolerance: codes equal exactly (both
take the float32 argmin of the same distances); positions, validity and the
cursor equal exactly; hidden states, K/V and tails to 1e-5 and waves to 1e-4
absolute in float32 (the JAX codec tests' and ``test_torch_codec_encode``'s
bounds). An int and a tensor ``valid_len`` give identical results.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec import model as jmodel
from mosstts_tpu.codec import transformer as jtxf
from mosstts_tpu.core.config import CodecConfig
from mosstts_tpu_torch.codec import model as tmodel
from mosstts_tpu_torch.codec import transformer as ttxf
from mosstts_tpu_torch.engine.step_graph import CODEC_GRAPHS
from mosstts_tpu_torch.ops.quant import quantize_tree_
from mosstts_tpu_torch.utils.convert import load_tree_

TINY = CodecConfig(
    sampling_rate=1600, frame_rate=12.5, n_q=4, codebook_size=32, codebook_dim=8,
    hidden_size=32, intermediate_size=64, num_encoder_layers=2, num_decoder_layers=2,
    num_attention_heads=2, num_key_value_heads=2, head_dim=16, causal_context=8,
)
HOP, C, B = TINY.hop, 5, 2
LENS = (C, 1, C - 1, C)  # real frames of each chunk: full, one, c - 1, full
ATOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def codecs():
    jcodec = jmodel.MossAudioTokenizer.random_init(seed=0, config=TINY)
    tparams = load_tree_(tmodel.CodecParams(TINY), jax.device_get(jcodec.params))
    return jcodec, tmodel.MossAudioTokenizer(tparams, TINY)


def _same_state(ts, js, label):
    np.testing.assert_allclose(ts.k.numpy(), np.asarray(js.k), **ATOL, err_msg=label)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **ATOL, err_msg=label)
    np.testing.assert_array_equal(ts.positions.numpy(), np.asarray(js.positions), label)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid), label)
    assert ts.next_pos.dtype == torch.int32 and ts.next_pos.ndim == 0
    assert int(ts.next_pos) == int(js.next_pos), label


def _frames(seed):
    return np.random.default_rng(seed).standard_normal((B, C, HOP)).astype(np.float32) * 0.1


def _codes(seed):
    return np.random.default_rng(seed).integers(0, TINY.codebook_size,
                                                (TINY.n_q, B, C)).astype(np.int64)


def test_run_chunk_matches_jax(codecs):
    jcodec, tcodec = codecs
    tcfg = tmodel._txf_cfg(TINY, TINY.num_encoder_layers)
    jcfg = jmodel._txf_cfg(TINY, TINY.num_encoder_layers)
    js = jtxf.init_stream_state(jcfg, B, TINY.causal_context)
    ts = ttxf.init_stream_state(tcfg, B, TINY.causal_context)
    rng = np.random.default_rng(1)
    for i, n in enumerate(LENS):
        x = rng.standard_normal((B, C, TINY.hidden_size)).astype(np.float32)
        jh, js = jtxf.run_chunk(jcodec.params["encoder"], jcfg, js, jnp.asarray(x), jnp.int32(n))
        th, ts = ttxf.run_chunk(tcodec.params.encoder, tcfg, ts, torch.from_numpy(x),
                                torch.tensor(n, dtype=torch.int32))
        np.testing.assert_allclose(th.numpy()[:, :n], np.asarray(jh)[:, :n], **ATOL)
        _same_state(ts, js, f"chunk {i} ({n} real frames)")


def test_encode_chunk_matches_jax(codecs):
    jcodec, tcodec = codecs
    js = jtxf.init_stream_state(jmodel._txf_cfg(TINY, TINY.num_encoder_layers), B,
                                TINY.causal_context)
    ts = ttxf.init_stream_state(tmodel._txf_cfg(TINY, TINY.num_encoder_layers), B,
                                TINY.causal_context)
    for i, n in enumerate(LENS):
        f = _frames(10 + i)
        f[:, n:] = 0.0  # a short chunk is zero-padded
        jc, js = jmodel._encode_chunk(jcodec.params, TINY, js, jnp.asarray(f), jnp.int32(n), 4)
        tc, ts = tmodel._encode_chunk(tcodec.params, TINY, ts, torch.from_numpy(f),
                                      torch.tensor(n, dtype=torch.int32), 4)
        assert tc.dtype == torch.int32 and tuple(tc.shape) == (4, B, C)
        np.testing.assert_array_equal(tc.numpy()[:, :, :n], np.asarray(jc)[:, :, :n])
        _same_state(ts, js, f"chunk {i} ({n} real frames)")


def test_decode_chunk_matches_jax(codecs):
    jcodec, tcodec = codecs
    js = jcodec._init_decode_state(B)
    ts = tcodec._init_decode_state(B)
    for i, n in enumerate(LENS):
        c = _codes(20 + i)
        c[:, :, n:] = 0  # a short chunk is zero-padded
        jw, js = jmodel._decode_chunk(jcodec.params, TINY, js, jnp.asarray(c), jnp.int32(n))
        tw, ts = tmodel._decode_chunk(tcodec.params, TINY, ts, torch.from_numpy(c),
                                      torch.tensor(n, dtype=torch.int32))
        np.testing.assert_allclose(tw.numpy()[:, :n * HOP], np.asarray(jw)[:, :n * HOP],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), **ATOL)  # the tail
        _same_state(ts[0], js[0], f"chunk {i} ({n} real frames)")


def _chunks(kind, codec, valid_len_of):
    """Four chunks of ``kind`` through the port, ``valid_len_of(n)`` the
    valid_len passed: every output and the final state."""
    p = codec.params
    if kind == "run_chunk":
        cfg = tmodel._txf_cfg(TINY, TINY.num_encoder_layers)
        state = ttxf.init_stream_state(cfg, B, TINY.causal_context)
        xs = np.random.default_rng(2).standard_normal((len(LENS), B, C, TINY.hidden_size))
    elif kind == "encode":
        state = ttxf.init_stream_state(tmodel._txf_cfg(TINY, TINY.num_encoder_layers), B,
                                       TINY.causal_context)
    else:
        state = codec._init_decode_state(B)
    outs = []
    for i, n in enumerate(LENS):
        if kind == "run_chunk":
            out, state = ttxf.run_chunk(p.encoder, cfg, state,
                                        torch.from_numpy(xs[i].astype(np.float32)),
                                        valid_len_of(n))
        elif kind == "encode":
            out, state = tmodel._encode_chunk(p, TINY, state, torch.from_numpy(_frames(i)),
                                              valid_len_of(n), 4)
        else:
            out, state = tmodel._decode_chunk(p, TINY, state, torch.from_numpy(_codes(i)),
                                              valid_len_of(n))
        outs.append(out)
    return outs + [state]


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _flat(part)]


@pytest.mark.parametrize("kind", ["run_chunk", "encode", "decode"])
def test_int_and_tensor_valid_len_agree(codecs, kind):
    _, tcodec = codecs
    got = _flat(_chunks(kind, tcodec, lambda n: n))
    ref = _flat(_chunks(kind, tcodec, lambda n: torch.tensor(n, dtype=torch.int32)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cpu_chunks_run_eagerly_over_static_buffers(codecs):
    """13 frames in chunks of 5 (the last one 3 real frames): one eager chunk
    each, no graph, each chunk's output copied out before the next ran (the
    codes equal one chunk of 13 and JAX's)."""
    jcodec, tcodec = codecs
    codec = tmodel.MossAudioTokenizer(tcodec.params, TINY)
    wav = np.random.default_rng(5).standard_normal(HOP * 13 - 40).astype(np.float32) * 0.1
    got = codec._encode_array(wav[None], 4, chunk_frames=5)
    assert codec.chunks.counts == dict(eager=3, capture=0, replay=0)
    assert not codec.chunks.graphs and codec.chunks.keys == ()
    np.testing.assert_array_equal(got, codec._encode_array(wav[None], 4, chunk_frames=13))
    np.testing.assert_array_equal(got, jcodec._encode_array(wav[None], 4, chunk_frames=5))
    codes = got[:, 0]
    wave = codec.decode(codes, chunk_duration=0.4)["audio"][0]  # chunks of 5
    np.testing.assert_allclose(wave, jcodec.decode(codes, chunk_duration=0.4)["audio"][0],
                               rtol=0, atol=1e-4)


def test_keys_are_bounded_least_recently_used_first(codecs):
    """``decode(chunk_duration=None)`` makes a key per length: at most
    ``CODEC_GRAPHS`` are kept, the least recently used dropped first."""
    _, tcodec = codecs
    codec = tmodel.MossAudioTokenizer(tcodec.params, TINY)
    codes = np.random.default_rng(6).integers(0, TINY.codebook_size, (4, 20)).astype(np.int64)
    lengths = range(1, CODEC_GRAPHS + 4)
    waves = [codec.decode(codes[:, :T], chunk_duration=None)["audio"][0] for T in lengths]
    kept = list(codec.chunks._keys)
    assert len(kept) == CODEC_GRAPHS
    assert [k[2] for k in kept] == list(lengths)[-CODEC_GRAPHS:]  # (kind, B, frames, ...)
    again = codec.decode(codes[:, :1], chunk_duration=None)["audio"][0]  # a dropped key
    np.testing.assert_array_equal(again, waves[0])


def test_replaced_weights_drop_the_keys(codecs):
    """``quantize_tree_(codec.params)`` replaces the weights the keys' programs
    read: the next call drops every key and runs on the int8 weights (equal
    to a codec built on them)."""
    _, tcodec = codecs
    codec = tmodel.MossAudioTokenizer(copy.deepcopy(tcodec.params), TINY)
    wav = np.random.default_rng(7).standard_normal(HOP * 7).astype(np.float32) * 0.1
    codec.encode(wav, num_quantizers=4)
    codec.decode(np.zeros((4, 6), np.int64), chunk_duration=None)
    assert [k[0] for k in codec.chunks._keys] == ["encode", "decode"]
    quantize_tree_(codec.params)
    got = codec.encode(wav, num_quantizers=4).audio_codes
    assert [k[-1] for k in codec.chunks._keys] == ["int8"]  # the float keys were dropped
    fresh = tmodel.MossAudioTokenizer(codec.params, TINY)
    np.testing.assert_array_equal(got, fresh.encode(wav, num_quantizers=4).audio_codes)


def test_warmup_ends_capture_on_use(codecs):
    """A server's ``warmup`` captures its keys (none on the CPU) and turns
    capture on use off; the chunks then run as before."""
    jcodec, tcodec = codecs
    codec = tmodel.MossAudioTokenizer(tcodec.params, TINY)
    codec.warmup(decode_levels=4, stream_levels=4)
    assert codec.chunks.capture_on_use is False and codec.chunks.keys == ()
    codes = np.random.default_rng(8).integers(0, TINY.codebook_size, (4, 9)).astype(np.int64)
    with codec.streaming() as sess:
        parts = [codec.decode(codes[:, s:s + 3], chunk_duration=0.32)["audio"][0]
                 for s in (0, 3, 6)]
        assert isinstance(sess.state[0].next_pos, torch.Tensor)
        assert int(sess.state[0].next_pos) == 9
    np.testing.assert_allclose(np.concatenate(parts),
                               jcodec.decode(codes, chunk_duration=None)["audio"][0],
                               rtol=0, atol=1e-4)


def test_dropping_the_codec_frees_its_chunks_at_once(codecs):
    """The chunk programs refer to their codec weakly: with the cycle
    collector off, ``del codec`` frees its chunks and their keys (a graph
    freed by the collector might go inside another thread's capture)."""
    import gc
    import weakref

    _, tcodec = codecs
    codec = tmodel.MossAudioTokenizer(tcodec.params, TINY)
    codec.decode(np.zeros((4, 6), np.int64), chunk_duration=None)
    chunks = weakref.ref(codec.chunks)
    key = weakref.ref(next(iter(codec.chunks._keys.values())))
    gc.disable()
    try:
        del codec
        assert chunks() is None and key() is None
    finally:
        gc.enable()
