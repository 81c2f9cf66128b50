"""The port's codec encode and streaming decode against the JAX package on
the CPU, the JAX codec tests' tiny config (hop 128, 4 levels of 32 entries,
2+2 layers), same weights through the bridge, inputs from numpy seeds.

Tolerance: codes equal exactly (both take the float32 argmin of the same
distances; a flip needs two distances to tie within float32 rounding);
quantized latents to 1e-5 (the same codebook rows subtracted in float32);
waves to 1e-4 absolute in float32, as the JAX package's own streaming test.
"""
import jax
import numpy as np
import pytest
import torch

from mosstts_tpu.codec.model import MossAudioTokenizer as JaxCodec
from mosstts_tpu.codec.rvq import init_rvq_params as jax_init_rvq
from mosstts_tpu.codec.rvq import rvq_encode as jax_rvq_encode
from mosstts_tpu.core.config import CodecConfig
from mosstts_tpu_torch.codec.model import CodecParams, MossAudioTokenizer
from mosstts_tpu_torch.codec.rvq import RVQParams, rvq_decode, rvq_encode
from mosstts_tpu_torch.utils.convert import load_tree_

TINY = CodecConfig(
    sampling_rate=1600, frame_rate=12.5, n_q=4, codebook_size=32, codebook_dim=8,
    hidden_size=32, intermediate_size=64, num_encoder_layers=2, num_decoder_layers=2,
    num_attention_heads=2, num_key_value_heads=2, head_dim=16, causal_context=8,
)
HOP = TINY.hop  # 128


@pytest.fixture(scope="module")
def codecs():
    jcodec = JaxCodec.random_init(seed=0, config=TINY)
    tcodec = MossAudioTokenizer(load_tree_(CodecParams(TINY), jax.device_get(jcodec.params)),
                                TINY)
    return jcodec, tcodec


@pytest.mark.parametrize("nq", [1, 4, 8])
def test_rvq_encode_matches_jax(nq):
    jparams = jax_init_rvq(jax.random.PRNGKey(0), 8, 64, 16)
    tparams = load_tree_(RVQParams(8, 64, 16), jax.device_get(jparams))
    lat = np.random.default_rng(nq).standard_normal((2, 9, 16)).astype(np.float32)
    jcodes, jquant = jax_rvq_encode(jparams, lat, nq)
    tcodes, tquant = rvq_encode(tparams, torch.from_numpy(lat), nq)
    assert tcodes.dtype == torch.int32 and tuple(tcodes.shape) == (nq, 2, 9)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(tquant.numpy(), np.asarray(jquant), rtol=0, atol=1e-5)
    # decode(encode) gives back the quantized latents
    np.testing.assert_allclose(rvq_decode(tparams, tcodes).numpy(), tquant.numpy(), atol=1e-5)


def test_rvq_encode_ignores_the_tf32_setting():
    """The dot products are float64 rounded once, so the matmul precision
    setting cannot move them."""
    params = load_tree_(RVQParams(4, 64, 16), jax.device_get(
        jax_init_rvq(jax.random.PRNGKey(3), 4, 64, 16)))
    lat = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 7, 16))
                           .astype(np.float32))
    prev = torch.get_float32_matmul_precision()
    try:
        ref = rvq_encode(params, lat, 4)
        torch.set_float32_matmul_precision("medium")
        got = rvq_encode(params, lat, 4)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_batch_encode_matches_jax_mixed_lengths(codecs):
    jcodec, tcodec = codecs
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (1000, 413, 1792)]
    jenc, tenc = jcodec.batch_encode(wavs, num_quantizers=4), tcodec.batch_encode(wavs, 4)
    assert tenc.audio_codes.dtype == np.int64 and tenc.audio_codes.shape == (4, 3, 14)
    np.testing.assert_array_equal(tenc.audio_codes_lengths, [8, 4, 14])
    np.testing.assert_array_equal(tenc.audio_codes_lengths, jenc.audio_codes_lengths)
    np.testing.assert_array_equal(tenc.audio_codes, jenc.audio_codes)
    # fewer levels: the first levels of the same codes
    np.testing.assert_array_equal(tcodec.batch_encode(wavs, 2)["audio_codes"],
                                  tenc.audio_codes[:2])


@pytest.mark.parametrize("layout", ["b1l", "l", "bl_mask"])
def test_encode_matches_jax(codecs, layout):
    jcodec, tcodec = codecs
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((2, 1, 900)).astype(np.float32) * 0.1
    kw = {}
    if layout == "l":
        wav = wav[0, 0]
    elif layout == "bl_mask":
        wav = wav[:, 0]
        mask = np.ones((2, 900), bool)
        mask[1, 500:] = False
        kw["padding_mask"] = mask
    j = jcodec.encode(wav, num_quantizers=4, **kw)
    t = tcodec.encode(wav, num_quantizers=4, **kw)
    np.testing.assert_array_equal(t.audio_codes, j.audio_codes)
    np.testing.assert_array_equal(t.audio_codes_lengths, j.audio_codes_lengths)
    d = tcodec.encode(wav, num_quantizers=4, return_dict=False, **kw)
    assert set(d) == {"audio_codes", "audio_codes_lengths"}
    np.testing.assert_array_equal(d["audio_codes"], j.audio_codes)


def test_chunked_encode_matches_oneshot_and_jax(codecs):
    """13 frames in chunks of 3 (the last chunk zero-padded, one real frame)
    and of 5 (via ``chunk_duration``) equal one chunk of 64."""
    jcodec, tcodec = codecs
    wav = np.random.default_rng(2).standard_normal(HOP * 13 - 37).astype(np.float32) * 0.1
    one = tcodec._encode_array(wav[None], 4, chunk_frames=64)
    assert one.shape == (4, 1, 13)
    np.testing.assert_array_equal(tcodec._encode_array(wav[None], 4, chunk_frames=3), one)
    np.testing.assert_array_equal(
        tcodec.encode(wav, num_quantizers=4, chunk_duration=0.4).audio_codes, one)
    np.testing.assert_array_equal(jcodec._encode_array(wav[None], 4, chunk_frames=3), one)


def test_streaming_decode_matches_oneshot_and_jax(codecs):
    jcodec, tcodec = codecs
    codes = np.random.default_rng(3).integers(0, TINY.codebook_size, (4, 17)).astype(np.int64)
    full = tcodec.decode(codes, chunk_duration=None)["audio"][0]
    np.testing.assert_allclose(full, jcodec.decode(codes, chunk_duration=None)["audio"][0],
                               rtol=0, atol=1e-4)

    def stream(codec):
        with codec.streaming(batch_size=1) as sess:
            parts = [codec.decode(codes[:, s:s + n], chunk_duration=0.24)["audio"][0]
                     for s, n in ((0, 5), (5, 7), (12, 1), (13, 4))]
            assert sess.state is not None
        assert codec._stream is None
        return np.concatenate(parts, axis=-1)

    got = stream(tcodec)
    assert got.shape == (17 * HOP,)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, stream(jcodec), rtol=0, atol=1e-4)
    # outside streaming() a 2-D call starts afresh
    again = tcodec.decode(codes[:, 5:12], chunk_duration=None)["audio"][0]
    np.testing.assert_allclose(
        again, jcodec.decode(codes[:, 5:12], chunk_duration=None)["audio"][0], atol=1e-4)


def test_streaming_session_is_per_thread(codecs):
    """Two threads in their own ``streaming()`` blocks on one codec do not
    share decoder state."""
    import threading

    _, tcodec = codecs
    codes = np.random.default_rng(4).integers(0, TINY.codebook_size, (4, 10)).astype(np.int64)
    full = tcodec.decode(codes, chunk_duration=None)["audio"][0]
    barrier, out, errors = threading.Barrier(2, timeout=60), {}, []

    def run(i):
        try:
            with tcodec.streaming():
                parts = []
                for s in range(0, 10, 2):
                    barrier.wait()
                    parts.append(tcodec.decode(codes[:, s:s + 2], chunk_duration=None)
                                 ["audio"][0])
            out[i] = np.concatenate(parts)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        np.testing.assert_allclose(out[i], full, rtol=0, atol=1e-4)
