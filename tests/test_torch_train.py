"""The port's training losses against the JAX package on the CPU: the tiny
configs of ``tests/test_tts_trainer.py``, float32, the same weights through
``utils.convert``, the same numpy batches (``synthetic_tts_batch``), JAX at
``jax_default_matmul_precision="highest"``.

``delay_loss`` (with and without ``channelwise_loss_weight``),
``local_loss`` (at ``n_vq_infer < n_vq``, and with channel weights) and
``realtime_loss``: the loss and its aux within rtol 1e-5, every
parameter's gradient within rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad``
of the JAX loss; ``delay_train_step``'s SGD step likewise. ``remat``
changes neither the loss nor the gradient norm, and saves fewer bytes for
backward (counted with ``torch.autograd.graph.saved_tensors_hooks``) at
T = 256, the CPU counterpart of ``test_remat_reduces_peak_training_memory``.
The helpers here (``jax_config``, ``port_params``) serve the other
``test_torch_train_*.py`` files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core import config as jconfig
from mosstts_tpu.models import delay as jdelay
from mosstts_tpu.models import local as jlocal
from mosstts_tpu.models import realtime as jrt
from mosstts_tpu_torch.models import delay as tdelay
from mosstts_tpu_torch.models import local as tlocal
from mosstts_tpu_torch.models import realtime as trt
from mosstts_tpu_torch.nn.qwen3 import init_kv_cache, qwen3_forward
from mosstts_tpu_torch.train.optim import global_norm, value_and_grad
from mosstts_tpu_torch.train.trainer import TTSTrainer, synthetic_tts_batch, tiny_config
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_

FAMILIES = ("delay", "local", "realtime")
JAX_INIT = {"delay": jdelay.init_delay_params, "local": jlocal.init_local_params,
            "realtime": jrt.init_realtime_params}
PORT_PARAMS = {"delay": tdelay.DelayParams, "local": tlocal.LocalParams,
               "realtime": trt.RealtimeParams}


def jax_config(family: str):
    """``tests/test_tts_trainer.py``'s ``_cfg``: the JAX twin of
    ``train.trainer.tiny_config``."""
    tiny = jconfig.tiny_qwen3()
    if family == "delay":
        return jconfig.DelayConfig(language_config=tiny, n_vq=4)
    if family == "local":
        return jconfig.LocalConfig(language_config=tiny, n_vq=4,
                                   additional_mlp_ffn_hidden_size=32, local_ffn_hidden_size=48,
                                   local_hidden_size=24, local_num_layers=2)
    return jconfig.RealtimeConfig(
        language_config=jconfig.tiny_qwen3(hidden_size=32, num_attention_heads=2,
                                           num_key_value_heads=2, head_dim=16,
                                           intermediate_size=64),
        local_config=jconfig.RealtimeLocalConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, head_dim=16, rvq=4, max_position_embeddings=5),
        rvq=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_numerics():
    """float32 products at full precision, and most XLA optimizations off
    (the tiny programs compile about twice as fast). JAX's caches are
    cleared on the way in and out: ``jax_disable_most_optimizations`` is not
    part of JAX's cache keys, so without that a program an earlier module of
    the same worker compiled with the optimizations on would serve this
    module (the Adafactor codec case's parameter gap then measured 1.27e-4
    against its 2.82e-5, over the 1e-4 bound), and this module's programs
    would serve a later one."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()
    jax.config.update("jax_disable_most_optimizations", True)
    with jax.default_matmul_precision("highest"):
        yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def jax_params(family: str, seed: int = 0):
    return JAX_INIT[family](jax.random.PRNGKey(seed), jax_config(family))


def port_params(family: str, tree):
    """The family's port module on the CPU, filled from a JAX tree."""
    return load_tree_(PORT_PARAMS[family](tiny_config(family)), jax.device_get(tree))


def batch(family: str, seed: int = 0, B: int = 2, T: int = 16):
    b = synthetic_tts_batch(family, tiny_config(family), np.random.default_rng(seed), batch=B,
                            seq=T)
    return b, {k: torch.as_tensor(v) for k, v in b.items()}


JAX_LOSS = {"delay": jdelay.delay_loss, "local": jlocal.local_loss,
            "realtime": jrt.realtime_loss}
PORT_LOSS = {"delay": tdelay.delay_loss, "local": tlocal.local_loss,
             "realtime": trt.realtime_loss}
CASES = [
    ("delay", {}),
    ("delay", {"channelwise_loss_weight": [2.0, 1.0, 0.5, 1.5, 3.0]}),
    ("local", {"n_vq_infer": 2}),
    ("local", {"channel_weights": [1.0, 2.0, 0.5, 1.0, 3.0]}),
    ("realtime", {}),
]


@pytest.mark.parametrize("family,kw", CASES)
def test_loss_and_gradients_match_jax(family, kw):
    tree = jax_params(family)
    params = port_params(family, tree)
    b, tb = batch(family, seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jkw = {k: jnp.asarray(v, jnp.float32) if isinstance(v, list) else v for k, v in kw.items()}
    tkw = {k: torch.tensor(v) if isinstance(v, list) else v for k, v in kw.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: JAX_LOSS[family](p, jax_config(family), jb["input_ids"],
                                   jb["attention_mask"], jb["labels"], **jkw),
        has_aux=True))(tree)
    loss, aux, grads = value_and_grad(params, lambda p: PORT_LOSS[family](
        p, tiny_config(family), tb["input_ids"], tb["attention_mask"], tb["labels"], **tkw))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(v), rtol=1e-5, err_msg=k)
    jflat = flatten_tree(jax.device_get(jg))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert float(global_norm(grads.values())) > 0


def test_delay_train_step_matches_jax():
    tree = jax_params("delay", seed=1)
    params = port_params("delay", tree)
    b, tb = batch("delay", seed=4)
    jnew, jl, _ = jdelay.delay_train_step(tree, jax_config("delay"),
                                          {k: jnp.asarray(v) for k, v in b.items()}, lr=1e-2)
    _, loss, _ = tdelay.delay_train_step(params, tiny_config("delay"), tb, lr=1e-2)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jflat = flatten_tree(jax.device_get(jnew))
    for name, p in params.named_parameters():
        assert not p.requires_grad, name  # value_and_grad restores the frozen parameters
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jflat[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_is_loss_equal(family):
    """``tests/test_tts_trainer.py::test_trainer_remat_loss_equal`` on the
    port: remat changes the backward pass's memory schedule, not the math."""
    b, _ = batch(family, seed=7)
    plain = TTSTrainer(family, tiny_config(family), total_steps=3, device="cpu")
    remat = TTSTrainer(family, tiny_config(family), total_steps=3, remat=True, device="cpu")
    p, r = plain.train_step(b), remat.train_step(b)
    np.testing.assert_allclose(r["loss"], p["loss"], rtol=1e-6)
    np.testing.assert_allclose(r["grad_norm"], p["grad_norm"], rtol=1e-5)


def saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves for backward while ``fn`` runs
    (outside checkpointed regions, whose tensors are recomputed)."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total


def test_remat_saves_fewer_bytes_for_backward():
    """At T = 256 the backbone's pass saves a fraction of the bytes with
    remat (each layer keeps its input only), the whole delay loss fewer
    (its 151,936-wide text logits dominate at this width), and the
    gradients are the same."""
    cfg = tiny_config("delay")
    params = port_params("delay", jax_params("delay")).requires_grad_(True)
    _, tb = batch("delay", seed=1, T=256)
    pos = torch.arange(256, dtype=torch.int32)[None].expand(2, 256)

    def backbone(remat):
        x = tdelay.delay_embed(params, cfg, tb["input_ids"])
        return qwen3_forward(params.backbone, cfg.language_config, x, positions=pos,
                             kv_valid=tb["attention_mask"], remat=remat)[0]

    def loss(remat):
        return tdelay.delay_loss(params, cfg, tb["input_ids"], tb["attention_mask"],
                                 tb["labels"], remat=remat)[0]

    plain, ckpt = saved_bytes(lambda: backbone(False)), saved_bytes(lambda: backbone(True))
    assert ckpt < 0.5 * plain, (ckpt, plain)
    plain, ckpt = saved_bytes(lambda: loss(False)), saved_bytes(lambda: loss(True))
    assert ckpt < plain, (ckpt, plain)
    g_plain = torch.autograd.grad(loss(False), list(params.parameters()))
    g_ckpt = torch.autograd.grad(loss(True), list(params.parameters()))
    for a, b in zip(g_plain, g_ckpt):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_remat_with_a_cache_raises():
    cfg = tiny_config("delay").language_config
    params = port_params("delay", jax_params("delay")).backbone
    x = torch.zeros((1, 4, cfg.hidden_size))
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="remat"):
        qwen3_forward(params, cfg, x, positions=pos, kv_valid=torch.ones((1, 8), dtype=torch.bool),
                      cache=init_kv_cache(cfg, 1, 8, dtype=torch.float32), remat=True)
