"""The port's ``CodecTrainer`` against the JAX package's on the CPU: the
reconstruction step with AdamW and with Adafactor (a codec of width 128, so
Adafactor factors its matrices), and the adversarial G-then-D step with its
``adv_start`` gate, 4 steps each from the JAX trainer's weights (through
``utils.convert``) on 4 numpy batches: each step's loss and every term
(``d_loss`` included) within rtol 1e-4, the parameters (and the
discriminators') after them within ||d|| / ||p|| 1e-5 (1e-4 for Adafactor,
whose update is linear in the gradient where Adam's first updates are
about its sign: the log-magnitude STFT term's gradient, which
``tests/test_torch_codec_train.py`` holds to 1e-2 per parameter at random
weights, passes into the parameters; 2.8e-5 measured). ``evaluate``'s
metrics on the same weights equal JAX's within rtol 1e-4 (the shift
exactly).
"""
import jax
import numpy as np
import pytest

from mosstts_tpu.codec import train as jtrain
from mosstts_tpu.core import config as jconfig
from mosstts_tpu_torch.codec import train as ttrain
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.utils.convert import load_tree_

from test_torch_train import jax_numerics, one_thread  # noqa: F401
from test_torch_train_loop import rel_gap

SMALL = dict(hidden_size=48, intermediate_size=96, num_encoder_layers=1, num_decoder_layers=1,
             num_attention_heads=2, num_key_value_heads=2, head_dim=24, n_q=4, codebook_dim=24,
             causal_context=16)
WIDE = dict(hidden_size=128, intermediate_size=128, num_encoder_layers=1, num_decoder_layers=1,
            num_attention_heads=2, num_key_value_heads=2, head_dim=64, n_q=4, codebook_dim=128,
            causal_context=16)
OPT = dict(num_quantizers=4, peak_lr=1e-3, warmup_steps=2, total_steps=10)
CASES = {
    "adamw": (SMALL, {}),
    "adafactor": (WIDE, dict(optimizer="adafactor")),
    "adversarial": (SMALL, dict(adversarial=True, disc_channels=8, adv_start=2,
                                lag_tolerance=32)),
}


def trainers(case: str):
    cfg, kw = CASES[case]
    jt = jtrain.CodecTrainer(jconfig.CodecConfig(**cfg), **OPT, **kw)
    tt = ttrain.CodecTrainer(tconfig.CodecConfig(**cfg), device="cpu", **OPT, **kw)
    load_tree_(tt.params, jax.device_get(jt.params))
    if tt.adversarial:
        load_tree_(tt.d_params, jax.device_get(jt.d_params))
    return jt, tt


@pytest.mark.parametrize("case", sorted(CASES))
def test_codec_trainer_matches_jax(case):
    jt, tt = trainers(case)
    rng = np.random.default_rng(5)
    for _ in range(4):
        wav = ttrain.synthetic_audio_batch(rng, 2, 0.2)
        j, t = jt.train_step(wav), tt.train_step(wav)
        assert set(t) == set(j), (sorted(t), sorted(j))
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']} {k}")
    assert rel_gap(tt.params, jt.params) <= (1e-4 if case == "adafactor" else 1e-5)
    if tt.adversarial:
        assert rel_gap(tt.d_params, jt.d_params) <= 1e-5
        assert tt.history[0]["adv"] == pytest.approx(jt.history[0]["adv"], rel=1e-4)


def test_evaluate_matches_jax():
    jt, tt = trainers("adamw")
    wav = ttrain.synthetic_audio_batch(np.random.default_rng(99), 2, 0.3)
    got, want = tt.evaluate(wav), jt.evaluate(wav)
    assert set(got) == set(want)
    assert got["shift_samples"] == want["shift_samples"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_metrics_and_synthetic_audio_match_jax():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    a, b = ttrain.synthetic_audio_batch(rng_a, 2, 0.1), jtrain.synthetic_audio_batch(rng_b, 2, 0.1)
    np.testing.assert_array_equal(a, b)
    est = np.roll(a[0], 17) + 0.05 * a[1]
    assert ttrain.si_snr(est, a[0]) == jtrain.si_snr(est, a[0])
    assert ttrain.si_snr_shifted(est, a[0]) == jtrain.si_snr_shifted(est, a[0])
    np.testing.assert_allclose(ttrain.mel_distance(est, a[0]), jtrain.mel_distance(est, a[0]),
                               rtol=1e-5)
