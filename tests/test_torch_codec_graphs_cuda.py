"""The codec's chunk programs as CUDA graphs on the card against the same
chunks run eagerly (``graphs=False``) over the same weights, bit for bit;
skips without a card (CUDA graphs and the kernels have no CPU mode; the CPU
half, against JAX, is ``tests/test_torch_codec_graphs.py``).

A small codec (2 + 2 layers of width 128, 8 levels of 1,024 entries of 32, a
window of 32 frames, 24 kHz), float32 and int8 (``quantize_tree_``: the
encoder's products through ``w8f32_gemm``, the decoder's through W8A16):
- encode at B = 1 and 2 in chunks of 100 and 12 frames, the last chunk
  padded: codes equal eager's, the chunks after a key's first replayed, and
  the int8 kernels counted inside the graphs;
- decode in chunks of 100 and 4 frames, the last padded: waves equal;
- a ``streaming()`` session across calls: equal to an eager session, and to
  a one-shot decode within 1e-4 (another slot order in the attention
  sums);
- two threads streaming through one key at once, each equal to its solo
  result;
- ``quantize_tree_`` on the codec's weights drops its graphs;
- ``warmup`` captures a server's keys (each in a memory pool of its own) and
  then captures nothing on use;
- a capture that fails raises, and the process captures again after it
  (the whole file runs in one process, and before the other card files).

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_codec_graphs_cuda.py -q
"""
import copy
import threading

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.codec.model import MossAudioTokenizer
from mosstts_tpu_torch.core.config import CodecConfig
from mosstts_tpu_torch.engine import step_graph
from mosstts_tpu_torch.ops.kernels import launches
from mosstts_tpu_torch.ops.quant import quantize_tree_

pytestmark = pytest.mark.cuda

CODEC = CodecConfig(n_q=8, codebook_size=1024, codebook_dim=32, hidden_size=128,
                    intermediate_size=256, num_encoder_layers=2, num_decoder_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                    causal_context=32)
HOP = CODEC.hop  # 1920
T = 130  # frames: a 100-frame chunk and a padded 30-frame one


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def params():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    f32 = MossAudioTokenizer.random_init(seed=0, config=CODEC, device="cuda").params
    return {"f32": f32, "int8": quantize_tree_(copy.deepcopy(f32))}


def _pair(params, weights):
    """A codec replaying graphs and an eager one, over the same weights."""
    p = params[weights]
    return MossAudioTokenizer(p, CODEC), MossAudioTokenizer(p, CODEC, graphs=False)


def _wav(B, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T * HOP - 700)).astype(np.float32) * 0.1


def _codes(n, B=1, seed=2):
    return np.random.default_rng(seed).integers(0, CODEC.codebook_size, (CODEC.n_q, B, n))


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("chunk", [100, 12])
def test_encode_graphs_equal_eager(card, params, weights, B, chunk):
    graph, eager = _pair(params, weights)
    wav = _wav(B)
    ref = eager._encode_array(wav, CODEC.n_q, chunk_frames=chunk)
    launches.reset()
    for call in range(3):
        got = graph._encode_array(wav, CODEC.n_q, chunk_frames=chunk)
        np.testing.assert_array_equal(got, ref, err_msg=f"call {call}")
    n = -(-T // chunk)
    # the key's first chunk eager, the second captured (and replayed), every
    # later one replayed
    assert graph.chunks.counts == dict(eager=1, capture=1, replay=3 * n - 2)
    assert len(graph.chunks.keys) == 1
    if weights == "int8":
        assert launches.IN_GRAPHS["w8f32"] > 0 and launches.IN_GRAPHS["w8a16"] == 0


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("chunk", [100, 4])
def test_decode_graphs_equal_eager(card, params, weights, chunk):
    graph, eager = _pair(params, weights)
    n = T if chunk == 100 else 23  # a padded last chunk either way
    codes = _codes(n)
    ref = eager._decode_array(codes, chunk)
    launches.reset()
    for call in range(3):
        np.testing.assert_array_equal(graph._decode_array(codes, chunk), ref,
                                      err_msg=f"call {call}")
    assert graph.chunks.counts["replay"] == 3 * -(-n // chunk) - 2
    if weights == "int8":
        assert launches.IN_GRAPHS["w8a16"] > 0 and launches.IN_GRAPHS["w8f32"] == 0


PIECES = ((0, 5), (5, 7), (12, 1), (13, 10))  # calls of a stream, in frames


def _stream(codec, codes, barrier=None):
    with codec.streaming():
        parts = []
        for s, n in PIECES:
            if barrier is not None:
                barrier.wait()
            parts.append(codec.decode(codes[:, s:s + n], chunk_duration=0.32)["audio"][0])
    return np.concatenate(parts)


def test_streaming_across_calls(card, params):
    graph, eager = _pair(params, "f32")
    codes = _codes(23)[:, 0]
    ref = _stream(eager, codes)
    for _ in range(2):
        np.testing.assert_array_equal(_stream(graph, codes), ref)
    assert graph.chunks.counts["replay"] > 0
    oneshot = eager.decode(codes, chunk_duration=None)["audio"][0]
    np.testing.assert_allclose(ref, oneshot, rtol=0, atol=1e-4)


def test_two_threads_stream_through_one_key(card, params):
    graph, _ = _pair(params, "f32")
    codes = [_codes(23, seed=10 + i)[:, 0] for i in range(2)]
    solo = [_stream(graph, c) for c in codes]
    barrier, out, errors = threading.Barrier(2, timeout=120), {}, []

    def run(i):
        try:
            out[i] = _stream(graph, codes[i], barrier)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(graph.chunks.keys) == 1  # one key served both streams
    for i in range(2):
        np.testing.assert_array_equal(out[i], solo[i], err_msg=f"thread {i}")


def test_replaced_weights_drop_the_graphs(card, params):
    codec = MossAudioTokenizer(copy.deepcopy(params["f32"]), CODEC)
    wav = _wav(1)[:, :50 * HOP]  # one chunk a call
    for _ in range(2):
        codec._encode_array(wav, CODEC.n_q)
    assert [k[-1] for k in codec.chunks.keys] == [torch.float32]
    quantize_tree_(codec.params)
    got = codec._encode_array(wav, CODEC.n_q)
    assert codec.chunks.keys == ()  # the float graph is gone; the int8 key ran eagerly
    got2 = codec._encode_array(wav, CODEC.n_q)  # captured, then replayed
    assert [k[-1] for k in codec.chunks.keys] == ["int8"]
    ref = MossAudioTokenizer(codec.params, CODEC, graphs=False)._encode_array(wav, CODEC.n_q)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got2, ref)


def test_warmup_captures_the_server_keys_only(card, params):
    graph, eager = _pair(params, "f32")
    graph.warmup(decode_levels=CODEC.n_q, stream_levels=4)
    keys = set(graph.chunks.keys)
    assert keys == {("encode", 1, 100, 8, torch.float32), ("decode", 1, 100, 8, torch.float32),
                    ("decode", 1, 4, 4, torch.float32)}
    for key in keys:
        _, pool = graph.chunks.graph_of(key)
        nbytes = step_graph.pool_bytes(pool)
        assert nbytes is None or nbytes > 0
    codes = _codes(23)
    np.testing.assert_array_equal(graph._decode_array(codes, 100), eager._decode_array(codes, 100))
    for _ in range(2):  # a key not warmed: eager at every chunk, never captured
        np.testing.assert_array_equal(graph._decode_array(codes, 12),
                                      eager._decode_array(codes, 12))
    assert graph.chunks.counts == dict(eager=4, capture=0, replay=1)
    assert set(graph.chunks.keys) == keys


def test_failed_capture_raises(card, params, monkeypatch):
    """A chunk program that reads a device value on the host cannot be
    captured: the capture raises, and nothing runs eagerly in its place.
    The process stays usable: with the program mended, the same codec
    captures that key and a fresh one captures its own, both equal to
    eager."""
    graph, eager = _pair(params, "f32")
    real = step_graph._decode_chunk

    def reads_back(*args):
        out = real(*args)
        out[0].sum().item()  # a device-to-host read, forbidden inside a capture
        return out

    monkeypatch.setattr(step_graph, "_decode_chunk", reads_back)
    codes = _codes(8)
    graph._decode_array(codes[:, :, :4], 4)  # the key's first chunk: eager
    with pytest.raises(RuntimeError):
        graph._decode_array(codes, 4)  # its second chunk captures
    assert graph.chunks.keys == ()

    monkeypatch.undo()
    ref = eager._decode_array(codes, 4)
    fresh = MossAudioTokenizer(params["f32"], CODEC)
    for codec in (graph, fresh, graph, fresh):
        np.testing.assert_array_equal(codec._decode_array(codes, 4), ref)
    assert graph.chunks.keys == fresh.chunks.keys == (("decode", 1, 4, 8, torch.float32),)
