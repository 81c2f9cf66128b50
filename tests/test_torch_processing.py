"""The port's own copy of the Delay processor against the JAX package's, on
the same conversations with the byte-fallback tokenizer: generation,
continuation, a left-padded batch and ``decode``. Host-side numpy on both
sides, so every array must be equal.
"""
from types import SimpleNamespace

import numpy as np

from mosstts_tpu.core.config import DelayConfig as JaxDelayConfig
from mosstts_tpu.core.config import tiny_qwen3 as jax_tiny_qwen3
from mosstts_tpu.processing.delay_processor import DelayProcessor as JaxProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer as JaxTokenizer
from mosstts_tpu_torch.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu_torch.processing.delay_processor import DelayProcessor
from mosstts_tpu_torch.processing.tokenizer import ByteFallbackTokenizer


class _CodesAsWave:
    """A stand-in codec whose waveform is each frame's first code, 4 samples
    a frame: ``decode`` then shows which frames each segment kept."""

    def decode(self, codes, padding_mask, chunk_duration):
        return SimpleNamespace(audio=np.repeat(codes[:1].transpose(1, 0, 2), 4, axis=2)
                               .astype(np.float32),
                               audio_lengths=padding_mask.sum(axis=1) * 4)


def _processors():
    return (JaxProcessor(JaxTokenizer(), _CodesAsWave(),
                         JaxDelayConfig(language_config=jax_tiny_qwen3(), n_vq=4)),
            DelayProcessor(ByteFallbackTokenizer(), _CodesAsWave(),
                           DelayConfig(language_config=tiny_qwen3(), n_vq=4)))


def _conversations(proc, rng):
    codes = [rng.integers(0, 1024, size=(n, 4)) for n in (5, 9)]
    return {
        "generation": [[proc.build_user_message(text="hello there", tokens=40)],
                       [proc.build_user_message(text="a much longer prompt for row two",
                                                reference=[codes[0]])]],
        "continuation": [[proc.build_user_message(text="continue me"),
                          proc.build_assistant_message([codes[1]])],
                         [proc.build_user_message(text="and me, with more text",
                                                  reference=[codes[0]]),
                          proc.build_assistant_message([codes[0]])]],
    }


def test_port_processor_equals_jax_processor():
    jproc, tproc = _processors()
    jconvs = _conversations(jproc, np.random.default_rng(0))
    tconvs = _conversations(tproc, np.random.default_rng(0))
    for mode in ("generation", "continuation"):
        jb, tb = jproc(jconvs[mode], mode=mode), tproc(tconvs[mode], mode=mode)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]), err_msg=key)
    assert not jb["attention_mask"].all()  # the batch really is left-padded

    # decode: the (start_length, grid) contract of generate, codes only
    ids = jb["input_ids"]
    rng = np.random.default_rng(1)
    c = JaxDelayConfig(n_vq=4)
    gen = np.full((12, 5), c.audio_pad_code, np.int64)
    gen[:, 0] = c.audio_assistant_gen_slot_token_id
    gen[:8, 1:] = rng.integers(0, 1024, size=(8, 4))
    gen[8:11, 0] = c.audio_assistant_delay_slot_token_id
    gen[11, 0] = c.audio_end_token_id
    outputs = [(3, np.concatenate([ids[b, -3:], gen])) for b in range(ids.shape[0])]
    jm, tm = jproc.decode(outputs), tproc.decode(outputs)
    assert len(jm) == len(tm) and all(m is not None and m.audio_codes_list for m in tm)
    for a, b in zip(jm, tm):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.content == a.content
            assert len(b.audio_codes_list) == len(a.audio_codes_list)
            for x, y in zip(b.audio_codes_list, a.audio_codes_list):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
