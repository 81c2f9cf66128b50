"""The port's GPipe pipeline (``parallel/pipeline.py``) in gloo processes
at world sizes 2 and 4, against the JAX package's plain ``qwen3_forward``
on the CPU. The counterparts of ``tests/test_pipeline.py``: the pipelined
forward equal to the plain one for (stages, microbatches) in {(2, 2),
(4, 1), (2, 4)} within 1e-5, the loss and every gradient through the
schedule equal to the plain backward (rel 1e-6; the gradients within JAX's
own bounds, rtol 2e-4 atol 2e-5), remat on and off equal, the pipeline
with tensor parallelism inside each stage (a ("stage", "model") mesh)
within 1e-5, ``TTSTrainer(pipeline=)``'s steps equal to the plain trainer's
(loss rel 1e-5, gradient norm rel 1e-4) and its ``ValueError`` for the
Local family, and ``split_stages``' errors. Each world size is one spawn
(``torch_parallel_ranks.pipeline_cases``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import tiny_qwen3
from mosstts_tpu.nn.qwen3 import init_qwen3_params, qwen3_forward
from mosstts_tpu_torch.parallel.pipeline import split_stages
from torch_parallel_ranks import QWEN, pipeline_cases
from torch_spawn import run_ranks

FORWARD = [(2, 2), (4, 1), (2, 4)]
WORLDS = (2, 4)
B, T = 8, 12


@pytest.fixture(scope="module", autouse=True)
def jax_numerics():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()  # the flag is not in JAX's cache keys (test_torch_train.jax_numerics)
    jax.config.update("jax_disable_most_optimizations", True)
    with jax.default_matmul_precision("highest"):
        yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def _cfg(n_layers):
    return tiny_qwen3(**QWEN, num_hidden_layers=n_layers)


@pytest.fixture(scope="module")
def ref():
    trees, out = {}, {}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, _cfg(8).hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()
    valid = rng.random((B, T)) > 0.2  # ragged validity: per-microbatch masks
    inp = {"x": x, "pos": pos, "valid": valid}
    for n in (8, 4):
        cfg = _cfg(n)
        params = init_qwen3_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32,
                                   with_embed=False)
        trees[n] = jax.device_get(params)

        def loss(p, cfg=cfg):
            h, _ = qwen3_forward(p, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(valid))
            return jnp.mean(h * h), h

        (l, h), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[n] = (float(l), np.asarray(h), jax.device_get(g))
    return trees, inp, out


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    trees, inp, _ = ref
    return {w: run_ranks(pipeline_cases, w, tmp_path_factory.mktemp(f"pp{w}"), trees, inp,
                         {"forward": FORWARD})
            for w in WORLDS}


def _grads_close(got, tree):
    from mosstts_tpu_torch.utils.convert import flatten_tree

    want = flatten_tree(tree)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[name]), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("stages,n_micro", FORWARD)
def test_pipelined_forward_matches_scan(ref, port, stages, n_micro):
    got = port[stages][("forward", stages, n_micro)]
    np.testing.assert_allclose(got, ref[2][8][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_grad_matches_scan(ref, port, world):
    loss, grads = port[world]["grad"]
    np.testing.assert_allclose(loss, ref[2][8][0], rtol=1e-6)
    _grads_close(grads, ref[2][8][2])


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_remat_matches(port, world):
    (l0, g0), (l1, g1) = port[world]["remat"]
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(g0[name], g1[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_pipeline_composes_with_tensor_parallel(ref, port):
    np.testing.assert_allclose(port[4]["tp"], ref[2][8][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_pipeline_matches_plain(port, world):
    res = port[world]
    for recs in res["trainer"]:  # ("stage",), and ("stage", "model") at 4 ranks
        for got, want in zip(recs, res["trainer_plain"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert res["local_error"] and "delay" in res["local_error"]


def test_split_stages_errors():
    layers = {"w": torch.zeros((6, 3))}
    with pytest.raises(ValueError):
        split_stages(layers, 4)
    assert split_stages(layers, 3)["w"].shape == (3, 2, 3)
