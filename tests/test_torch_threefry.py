"""The port's JAX random bits (``ops/sampling.py``: ``prng_key``,
``split``, ``random_bits``, ``uniform``, ``categorical_plain``; the plain
versions of ``ops/kernels/threefry.py``'s split and fused categorical)
against ``jax.random`` itself on the CPU (threefry2x32 with
``jax_threefry_partitionable``, JAX's default): keys and bits equal exactly,
the uniforms bit for bit, the draws index for index. The kernels are held
against these on the card (``tests/test_torch_graphs_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.ops import sampling as js
from mosstts_tpu_torch.ops import sampling as ts
from mosstts_tpu_torch.ops.kernels import threefry

SEEDS = [0, 1, 42, 12345, 2**31 - 1, 2**32 + 5, -1]
TINY = float(np.finfo(np.float32).tiny)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_threefry_partitionable_is_on():
    """The bits below are JAX's default mode's; the port reproduces that
    mode only."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(ts.prng_key(seed).numpy(), _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_split_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(ts.split(ts.prng_key(seed)[None], n)[0].numpy(),
                                  _u32(jax.random.split(key, n)))
    # a batch of keys splits row by row (JAX's vmap of split, split_keys)
    keys = jax.random.split(key, 3)
    want = jax.vmap(lambda k: jax.random.split(k, n))(keys)
    np.testing.assert_array_equal(threefry.split(torch.from_numpy(_u32(keys)), n).numpy(),
                                  _u32(want))
    got = ts.split_keys(torch.from_numpy(_u32(keys)), n)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), _u32(js.split_keys(keys, n)[i]))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 32, 25)])
def test_random_bits_and_uniform_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(ts.random_bits(ts.prng_key(seed), shape).numpy(),
                                  _u32(jax.random.bits(key, shape, jnp.uint32)))
    want = np.asarray(jax.random.uniform(key, shape, minval=TINY, maxval=1.0))
    got = ts.uniform(ts.prng_key(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", [(4, 25), (3, 4, 25), (2, 50), (2, 1000)])
def test_categorical_matches_jax(seed, shape):
    """JAX's per-row categorical (``vmap`` over per-row keys, as its
    ``sampling._categorical``) and the port's: the same index in every row,
    over the row's whole noise shape."""
    keys = jax.random.split(jax.random.PRNGKey(seed), shape[0])
    logits = np.random.default_rng(seed & 0xFFFF).normal(size=shape).astype(np.float32) * 2
    want = np.asarray(js._categorical(keys, jnp.asarray(logits)))
    got = ts.categorical_plain(torch.from_numpy(_u32(keys)), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        threefry.categorical(torch.from_numpy(_u32(keys)), torch.from_numpy(logits)).numpy(),
        want)


@pytest.mark.parametrize("top_k", [0, 25])
def test_sample_topk_topp_draws_match_jax(top_k):
    """The sampler's draws (top-k, top-p, then the Gumbel-max draw from each
    row's key) equal JAX's ``sample_topk_topp`` with its exact top-k."""
    rng = np.random.default_rng(top_k)
    logits = (rng.normal(size=(3, 4, 60)) * 2).astype(np.float32)
    p = np.array([0.5, 0.9, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    want = js.sample_topk_topp(keys, jnp.asarray(logits), top_k=top_k, top_p=jnp.asarray(p),
                               do_sample=True, exact_topk=True)
    got = ts.sample_topk_topp(torch.from_numpy(_u32(keys)), torch.from_numpy(logits),
                              top_k=top_k, top_p=torch.from_numpy(p), do_sample=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_keys_are_jax_prefill_keys():
    """``row_keys(seed, B)``: the keys JAX's prefill splits from
    ``PRNGKey(seed)``."""
    for seed, B in ((0, 1), (7, 2), (5, 16)):
        np.testing.assert_array_equal(
            ts.row_keys(seed, B).numpy(), _u32(jax.random.split(jax.random.PRNGKey(seed), B)))


def test_kernel_wrappers_reject_bad_keys():
    """The wrappers take (B, 2) int64 keys; on the CPU they are the plain
    versions, which ``categorical`` checks row for row."""
    logits = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="keys"):
        ts._categorical(ts.row_keys(0, 2), logits)
