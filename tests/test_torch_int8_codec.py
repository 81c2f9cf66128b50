"""The port's int8 codec (``ops.quant.quantize_tree_`` over a
``MossAudioTokenizer``'s params) against the JAX package's
(``quantize_tree(codec.params)``) on the CPU: the JAX codec tests' tiny
config, the same float weights through ``utils.convert``. As in JAX the
encoder runs float32 activations over the int8 weights (``dense``'s
float32-activation mode of W8A16, ``ops/kernels/w8_gemm.w8f32_gemm``, on
the card; its arithmetic is pinned in ``tests/test_torch_w8f32.py``) and the
decoder bf16 ones (``QuantWeight.dtype``).

The counterpart of ``tests/test_codec.py::test_quantized_codec_runs``:
encode, decode and streaming run over ``QuantWeight``s and the decoded
wave stays within a mean relative deviation of 0.5 from the float codec's;
beyond it, the int8 weights equal JAX's bit for bit, the codes (float32
activations) equal JAX's int8 codec's exactly, and its decoded waves (bf16
activations, one-shot and streamed) lie within 4e-3 absolute and 5e-4 on
average of JAX's: bf16 resolution, not 1e-4. The witness: JAX's own int8
decoder, compiled (XLA fuses and rounds bf16 chains its own way) and run
one primitive at a time (``jax.disable_jit``), differs from itself by
more than 1e-4 on the same codes, and the port's gap to the compiled run
is of the same size as that spread
(``test_int8_codec_decode_gap_is_jax_own_bf16_spread``).
"""
import jax
import numpy as np
import pytest

from mosstts_tpu.codec.model import MossAudioTokenizer as JaxCodec
from mosstts_tpu.core.config import CodecConfig
from mosstts_tpu.ops.quant import quantize_tree
from mosstts_tpu_torch.codec.model import CodecParams, MossAudioTokenizer
from mosstts_tpu_torch.ops.quant import QuantWeight, quantize_tree_
from mosstts_tpu_torch.utils.convert import load_tree_

TINY = CodecConfig(
    sampling_rate=1600, frame_rate=12.5, n_q=4, codebook_size=32, codebook_dim=8,
    hidden_size=32, intermediate_size=64, num_encoder_layers=2, num_decoder_layers=2,
    num_attention_heads=2, num_key_value_heads=2, head_dim=16, causal_context=8,
)


@pytest.fixture(scope="module")
def codecs():
    jcodec = JaxCodec.random_init(seed=0, config=TINY)
    jq = JaxCodec(quantize_tree(jcodec.params), TINY)
    tcodec = MossAudioTokenizer(load_tree_(CodecParams(TINY), jax.device_get(jcodec.params)),
                                TINY)
    tq = MossAudioTokenizer(quantize_tree_(
        load_tree_(CodecParams(TINY), jax.device_get(jcodec.params))), TINY)
    return jq, tcodec, tq


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
    assert np.abs(got - want).mean() < 5e-4


def _wav(seed, n=4800):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.1


def test_quantized_codec_runs(codecs):
    _, tcodec, tq = codecs
    assert isinstance(tq.params.enc_in, QuantWeight)
    enc = tq.batch_encode([_wav(5)], num_quantizers=TINY.n_q)
    assert enc.audio_codes.shape[0] == TINY.n_q
    out = np.asarray(tq.decode(enc.audio_codes, chunk_duration=None).audio)
    assert np.isfinite(out).all()
    ref = np.asarray(tcodec.decode(enc.audio_codes, chunk_duration=None).audio)
    # int8 weights perturb but must not destroy the reconstruction
    assert np.abs(out - ref).mean() / (np.abs(ref).mean() + 1e-6) < 0.5
    with tq.streaming(batch_size=1):
        chunk = np.asarray(enc.audio_codes)[:, 0, :6]
        w = tq.decode(chunk, chunk_duration=None)["audio"][0]
    assert np.isfinite(w).all()


def test_int8_codec_weights_equal_jax(codecs):
    jq, _, tq = codecs
    from mosstts_tpu_torch.utils.convert import flatten_tree

    want = flatten_tree(jax.device_get(jq.params))
    got = dict(tq.params.named_parameters())
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("seed", [5, 6])
def test_int8_codec_encode_decode_matches_jax(codecs, seed):
    jq, _, tq = codecs
    wavs = [_wav(seed), _wav(seed + 10, 3000)]
    je, te = jq.batch_encode(wavs), tq.batch_encode(wavs)
    np.testing.assert_array_equal(np.asarray(te.audio_codes), np.asarray(je.audio_codes))
    codes = np.asarray(je.audio_codes)
    _close_bf16(tq.decode(codes, chunk_duration=None).audio,
                jq.decode(codes, chunk_duration=None).audio)


def test_int8_codec_decode_gap_is_jax_own_bf16_spread(codecs):
    """The decoded wave's gap to JAX is bf16 rounding order, not a fault:
    JAX compiled against JAX one primitive at a time already misses 1e-4,
    and the port sits at the same distance from the compiled run (mean
    within 1.5x of JAX's own spread, max within two bf16 ulps of the
    peak)."""
    jq, _, tq = codecs
    wavs = [_wav(5), _wav(15, 3000)]
    codes = np.asarray(jq.batch_encode(wavs).audio_codes)
    jit = np.asarray(jq.decode(codes, chunk_duration=None).audio, np.float32)
    with jax.disable_jit():
        eager = np.asarray(jq.decode(codes, chunk_duration=None).audio, np.float32)
    port = np.asarray(tq.decode(codes, chunk_duration=None).audio, np.float32)
    spread = np.abs(eager - jit)
    gap = np.abs(port - jit)
    assert spread.max() > 1e-4  # 1e-4 is finer than the bf16 decoder resolves
    assert gap.mean() <= 1.5 * spread.mean()
    assert gap.max() <= 2 * 2.0 ** (np.floor(np.log2(np.abs(jit).max())) - 7)


def test_int8_codec_streaming_matches_jax(codecs):
    jq, _, tq = codecs
    codes = np.random.default_rng(3).integers(0, TINY.codebook_size, (4, 17)).astype(np.int64)

    def stream(codec):
        with codec.streaming(batch_size=1):
            parts = [codec.decode(codes[:, s:s + n], chunk_duration=0.24)["audio"][0]
                     for s, n in ((0, 5), (5, 7), (12, 5))]
        return np.concatenate([np.asarray(p, np.float32) for p in parts], axis=-1)

    _close_bf16(stream(tq), stream(jq))
