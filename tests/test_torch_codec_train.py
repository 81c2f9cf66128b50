"""The port's codec training objective and discriminators against the JAX
package on the CPU (float32, the same weights through ``utils.convert``,
numpy inputs, JAX at full matmul precision).

``stft_mag`` (symmetric Hann window, strided frames), ``multiscale_stft_loss``
and ``si_snr_loss`` within rtol 1e-5; ``lag_align`` picks JAX's lag and passes
JAX's gradients; ``codec_loss`` (``tests/test_codec_training.py``'s trainer
codec) and every term of its aux within rtol 1e-5, every parameter's
gradient as ``test_codec_loss_and_gradients_match_jax`` says; the
discriminators' logits and
feature maps (strides (1, 2) on the STFT stacks, (3, 1) on the period
stacks, SAME padding; NCHW here, NHWC in JAX) within 1e-5, the hinge and
feature-matching losses and the discriminator loss's gradients likewise.
``utils.convert`` flattens the JAX tree's lists to ``ModuleList`` names,
and the discriminators round-trip through the port's safetensors files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec import discriminator as jdisc
from mosstts_tpu.codec import losses as jlosses
from mosstts_tpu.codec.model import init_codec_params as jinit_codec
from mosstts_tpu.core import config as jconfig
from mosstts_tpu_torch.codec import discriminator as tdisc
from mosstts_tpu_torch.codec import losses as tlosses
from mosstts_tpu_torch.codec.model import CodecParams
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.tools.hf_checkpoint import same_params
from mosstts_tpu_torch.train.optim import value_and_grad
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_
from mosstts_tpu_torch.utils.hf_loader import load_safetensors_dir, save_safetensors

from test_torch_train import jax_numerics, one_thread  # noqa: F401

CODEC = dict(hidden_size=48, intermediate_size=96, num_encoder_layers=1, num_decoder_layers=1,
             num_attention_heads=2, num_key_value_heads=2, head_dim=24, n_q=4,
             codebook_dim=24, causal_context=16)


def wave(seed: int, B: int = 2, L: int = 6000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 24000.0
    f0 = rng.uniform(100, 300, (B, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, L))).astype(
        np.float32)


def close(got: torch.Tensor, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("frame,hop,L", [(512, 128, 3000), (2048, 512, 1500)])
def test_stft_mag_matches_jax(frame, hop, L):
    x = wave(1, L=L)
    close(tlosses.stft_mag(torch.as_tensor(x), frame, hop), jlosses.stft_mag(jnp.asarray(x),
                                                                             frame, hop))


def test_spectral_and_snr_losses_match_jax():
    x, y = wave(2), wave(3)
    tx, ty, jx, jy = torch.as_tensor(x), torch.as_tensor(y), jnp.asarray(x), jnp.asarray(y)
    close(tlosses.multiscale_stft_loss(tx, ty), jlosses.multiscale_stft_loss(jx, jy))
    close(tlosses.si_snr_loss(tx, ty), jlosses.si_snr_loss(jx, jy))
    # a noisy, delayed copy: SI-SNR is high but finite
    close(tlosses.si_snr_loss(tx + 0.1 * ty, tx), jlosses.si_snr_loss(jx + 0.1 * jy, jx))


def test_lag_align_picks_jax_lag_and_gradients():
    ref = wave(4, L=4000)
    est = np.roll(ref, 24, axis=-1) * 0.8 + 0.2 * wave(5, L=4000)  # ~12 dB after alignment
    te = torch.tensor(est, requires_grad=True)
    a, c = tlosses.lag_align(te, torch.as_tensor(ref), max_shift=48)
    ja, jc = jlosses.lag_align(jnp.asarray(est), jnp.asarray(ref), max_shift=48)
    close(a, ja, rtol=0, atol=0)
    close(c, jc, rtol=0, atol=0)

    def jf(e):
        x, r = jlosses.lag_align(e, jnp.asarray(ref), max_shift=48)
        return jlosses.si_snr_loss(x, r)

    jg = jax.grad(jf)(jnp.asarray(est))
    (g,) = torch.autograd.grad(tlosses.si_snr_loss(a, c), te)
    close(g, jg, rtol=1e-4, atol=1e-6)


def codec_pair(seed: int = 0):
    tree = jinit_codec(jax.random.PRNGKey(seed), jconfig.CodecConfig(**CODEC))
    return tree, load_tree_(CodecParams(tconfig.CodecConfig(**CODEC)), jax.device_get(tree))


def rel_norm(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("lag", [0, 32])
def test_codec_loss_and_gradients_match_jax(lag):
    """The loss and its terms within rtol 1e-5. The gradients of the loss
    without its log-magnitude STFT term within rtol 1e-4 and an atol of
    1e-5 of each parameter's largest gradient (elements that cancel to ~0);
    with that term, within ||d|| / ||g|| 1e-2 per parameter: at random
    weights the decoder's output is ~1e-3 of the target, the term's
    gradient goes as 1 / (|X| + 1e-5) over nearly empty bins, and JAX's own
    jitted and eager gradients of this loss differ by up to 1.4e-3."""
    tree, params = codec_pair()
    wav = wave(6)
    jcfg, tcfg = jconfig.CodecConfig(**CODEC), tconfig.CodecConfig(**CODEC)
    for stft_weight in (0.0, 1.0):
        kw = dict(lag_tolerance=lag, stft_weight=stft_weight)
        (jl, jaux), jg = jax.jit(jax.value_and_grad(
            lambda p: jlosses.codec_loss(p, jcfg, jnp.asarray(wav), 4, **kw),
            has_aux=True))(tree)
        loss, aux, grads = value_and_grad(params, lambda p: tlosses.codec_loss(
            p, tcfg, torch.as_tensor(wav), 4, **kw))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert set(aux) == set(jaux)
        for k, v in jaux.items():
            np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, err_msg=k)
        jflat = flatten_tree(jax.device_get(jg))
        assert set(jflat) == set(grads)
        for name, g in grads.items():
            want = np.asarray(jflat[name])
            if stft_weight == 0.0:
                close(g, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), msg=name)
            else:
                assert rel_norm(g, want) <= 1e-2, (name, rel_norm(g, want))


def disc_pair(channels: int = 8, seed: int = 1):
    tree = jdisc.init_discriminators(jax.random.PRNGKey(seed), channels=channels)
    return tree, load_tree_(tdisc.Discriminators(channels=channels), jax.device_get(tree))


def test_discriminators_match_jax():
    tree, params = disc_pair()
    wav = wave(7)
    jouts = jax.jit(jdisc.disc_forward)(tree, jnp.asarray(wav))
    touts = tdisc.disc_forward(params, torch.as_tensor(wav))
    assert len(touts) == len(jouts) == 4 + 5  # every STFT scale fits 6000 samples
    for (tl, tf), (jl, jf) in zip(touts, jouts):
        close(tl.permute(0, 2, 3, 1), jl)
        assert len(tf) == len(jf)
        for a, b in zip(tf, jf):
            assert tuple(a.permute(0, 2, 3, 1).shape) == b.shape
            close(a.permute(0, 2, 3, 1), b)
    # a wave shorter than the largest frame drops that scale, as in JAX
    short = wave(8, L=1500)
    assert (len(tdisc.disc_forward(params, torch.as_tensor(short)))
            == len(jdisc.disc_forward(tree, jnp.asarray(short))) == 3 + 5)


@pytest.mark.parametrize("n,k,s,d", [(10, 9, 2, 1), (11, 9, 2, 1), (7, 5, 3, 1), (8, 3, 1, 4),
                                     (3, 5, 3, 1)])
def test_same_padding_matches_xla(n, k, s, d):
    """``conv_same`` over one axis against ``lax.conv_general_dilated``'s SAME."""
    x = np.random.default_rng(n).standard_normal((1, n, 1, 1)).astype(np.float32)
    w = np.random.default_rng(k).standard_normal((k, 1, 1, 1)).astype(np.float32)
    want = jax.lax.conv_general_dilated(x, w, (s, 1), "SAME", rhs_dilation=(d, 1),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tdisc.conv_same(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(w), (s, 1),
                          (d, 1))
    close(got.permute(0, 2, 3, 1), want)


def test_gan_losses_and_their_gradients_match_jax():
    tree, params = disc_pair()
    real, fake = wave(9, B=1), wave(10, B=1) * 0.5
    jr, jf = jnp.asarray(real), jnp.asarray(fake)
    tr, tf = torch.as_tensor(real), torch.as_tensor(fake)
    jro, jfo = jax.jit(jdisc.disc_forward)(tree, jr), jax.jit(jdisc.disc_forward)(tree, jf)
    tro, tfo = tdisc.disc_forward(params, tr), tdisc.disc_forward(params, tf)
    close(tdisc.hinge_g_loss(tfo), jdisc.hinge_g_loss(jfo))
    close(tdisc.feature_matching_loss(tro, tfo), jdisc.feature_matching_loss(jro, jfo))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jdisc.hinge_d_loss(
        jdisc.disc_forward(p, jr), jdisc.disc_forward(p, jf))))(tree)
    loss, _, grads = value_and_grad(params, lambda p: (tdisc.hinge_d_loss(
        tdisc.disc_forward(p, tr), tdisc.disc_forward(p, tf)), {}))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jflat = flatten_tree(jax.device_get(jg))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        close(g, jflat[name], rtol=1e-4, atol=1e-6, msg=name)


def test_list_trees_load_into_module_lists_and_round_trip(tmp_path):
    """``flatten_tree`` names a list's entries by index: the JAX
    discriminator tree (``{"subs": [{"mid": [...]}]}``) loads one to one into
    ``ModuleList``/``ParameterList`` modules, and the port's safetensors
    files give the same weights back."""
    tree, params = disc_pair(channels=4, seed=3)
    flat = flatten_tree(jax.device_get(tree))
    assert "msstft.subs.3.mid.2" in flat and "mpd.subs.4.stack.0" in flat
    assert set(flat) == {n for n, _ in params.named_parameters()}
    assert flatten_tree({"a": [1, {"b": [2, 3]}]}) == {"a.0": 1, "a.1.b.0": 2, "a.1.b.1": 3}
    save_safetensors({n: p.detach() for n, p in params.named_parameters()},
                     tmp_path / "model.safetensors")
    back = load_tree_(tdisc.Discriminators(channels=4), dict(load_safetensors_dir(tmp_path)))
    assert same_params(back, params)
    mismatched = jdisc.init_discriminators(jax.random.PRNGKey(0), channels=4, use_mpd=False)
    with pytest.raises(KeyError):
        load_tree_(tdisc.Discriminators(channels=4), jax.device_get(mismatched))
