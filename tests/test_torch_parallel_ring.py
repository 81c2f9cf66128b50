"""The port's ring attention (``parallel/ring_attn.py``) in gloo processes
at world sizes 2 and 4, against the JAX package's single-device
``gqa_attention`` on the CPU. The counterparts of
``tests/test_ring_attention.py`` (all but
``test_ring_under_jit_compiles_collectives``, which reads JAX's compiled
program): the ring equal to full attention on a ("data", "model") mesh,
with left padding and a window, contiguous and zigzag, within 1e-5; the
``ValueError``s (T not divisible, zigzag without ``T % (2n) == 0``, an
unknown layout); ``zigzag_order`` equal to JAX's and balancing the causal
work; fully masked rows returning exactly 0. Each world size is one spawn
(``torch_parallel_ranks.ring_cases``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mosstts_tpu.ops.attention import gqa_attention
from mosstts_tpu.parallel.ring_attn import zigzag_order as jax_zigzag_order
from mosstts_tpu_torch.parallel.ring_attn import zigzag_order
from torch_parallel_ranks import ring_cases
from torch_spawn import run_ranks

WORLDS = (2, 4)


def _case(B=2, T=64, H=4, KV=2, hd=16, seed=0, left_pad=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    valid = np.ones((B, T), bool)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if left_pad:  # left-padded row 0: positions count from its first valid slot
        valid[0, :left_pad] = False
        pos[0] = np.concatenate([np.zeros(left_pad, np.int32),
                                 np.arange(T - left_pad, dtype=np.int32)])
    return dict(q=q, k=k, v=v, pos=pos, valid=valid, scale=hd ** -0.5)


def _cases(world):
    """name -> inputs, mesh shape, layout and window of every ring call."""
    cases = {}

    def add(name, case, mesh=(1, world), layout="contiguous", window=None):
        cases[name] = dict(case, mesh=mesh, layout=layout, window=window)

    add("full", _case())
    if world == 4:
        add("full_data_model", _case(), mesh=(2, 2))
    for window in (None, 16):
        add(f"pad_{window}", _case(left_pad=13, seed=1), window=window)
    for seed, left_pad, window in ((3, 0, None), (4, 13, None), (5, 13, 16)):
        add(f"zigzag_{seed}", _case(T=128, seed=seed, left_pad=left_pad), layout="zigzag",
            window=window)
    add("bad_T", _case(T=62 if world == 4 else 63))
    add("bad_zigzag", _case(T=4 * world + world), layout="zigzag")
    add("bad_layout", _case(), layout="striped")
    masked = _case(seed=3)
    masked["valid"] = masked["valid"].copy()
    masked["valid"][0] = False  # row 0 has no valid key at all
    add("masked", masked)
    return cases


def _oracle(c):
    return np.asarray(gqa_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        q_positions=jnp.asarray(c["pos"]), kv_positions=jnp.asarray(c["pos"]),
        kv_valid=jnp.asarray(c["valid"]), scale=c["scale"], window=c["window"]))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {w: (run_ranks(ring_cases, w, tmp_path_factory.mktemp(f"ring{w}"), _cases(w)),
                _cases(w)) for w in WORLDS}


def _check(port, world, name):
    out, cases = port[world]
    assert not isinstance(out[name], Exception), out[name]
    np.testing.assert_allclose(out[name], _oracle(cases[name]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_full_attention(port, world):
    _check(port, world, "full")
    if world == 4:
        _check(port, world, "full_data_model")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_left_padding_and_window(port, world):
    for window in (None, 16):
        _check(port, world, f"pad_{window}")


@pytest.mark.parametrize("world", WORLDS)
def test_ring_rejects_indivisible_T(port, world):
    assert isinstance(port[world][0]["bad_T"], ValueError)
    assert isinstance(port[world][0]["bad_layout"], ValueError)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_zigzag_layout_matches(port, world):
    for seed in (3, 4, 5):
        _check(port, world, f"zigzag_{seed}")
    assert isinstance(port[world][0]["bad_zigzag"], ValueError)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_order_balances_causal_work(n):
    T = 16 * n
    order = zigzag_order(T, n)
    np.testing.assert_array_equal(order, jax_zigzag_order(T, n))
    assert sorted(order.tolist()) == list(range(T))
    zig = (order.reshape(n, T // n) + 1).sum(axis=1)
    contig = (np.arange(T).reshape(n, T // n) + 1).sum(axis=1)
    assert len(set(zig.tolist())) == 1, zig
    assert (np.diff(contig) > 0).all()
    with pytest.raises(ValueError):
        zigzag_order(T + n, n)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_fully_masked_rows_return_zero(port, world):
    out, cases = port[world]
    got = out["masked"]
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
    np.testing.assert_allclose(got[1], _oracle(cases["masked"])[1], atol=1e-5, rtol=1e-5)
