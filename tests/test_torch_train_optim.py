"""``train/optim.py`` against optax on the CPU: the warmup-cosine schedule
over its warmup and decay, the global-norm clip above and below its
threshold, and AdamW and Adafactor (factored and unfactored leaves) behind
the clip, each over 5 updates of a random tree from the same gradients,
within rtol 1e-6 (optax at its float32 defaults)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mosstts_tpu_torch.train.optim import (AdamW, Adafactor, clip_by_global_norm, factored_dims,
                                           global_norm, warmup_cosine, warmup_cosine_decay)

SHAPES = {  # name -> shape; Adafactor factors the first four
    "square": (128, 128),  # a tie of the two largest dims
    "wide": (130, 256),
    "stack": (300, 4, 150),  # the largest dim leads
    "stack_t": (3, 200, 128),
    "small": (64, 32),  # two dims, the smaller under 128
    "vector": (10,),
}


def tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def optax_schedule(peak=3e-3, warmup=2, total=10):
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=peak * 0.05)


@pytest.mark.parametrize("warmup,total", [(3, 12), (1, 5), (4, 4)])
def test_schedule_matches_optax(warmup, total):
    ours = warmup_cosine(3e-3, warmup, total)
    ref = optax_schedule(3e-3, warmup, total)
    got = [ours(i) for i in range(total + 4)]
    want = [float(ref(i)) for i in range(total + 4)]
    assert got[0] == 0.0  # the first update's learning rate
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert warmup_cosine_decay(2, 0.5, 2.0, 4, 10, 0.1) == pytest.approx(
        float(optax.warmup_cosine_decay_schedule(0.5, 2.0, 4, 10, 0.1)(2)), rel=1e-6)


@pytest.mark.parametrize("max_norm", [1e3, 1.0])  # above the norm, and below it
def test_clip_matches_optax(max_norm):
    g = tree(1)
    norm = float(optax.global_norm(g))
    assert (norm < max_norm) == (max_norm == 1e3)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, optax.EmptyState())
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    np.testing.assert_allclose(float(global_norm(tg.values())), norm, rtol=1e-6)
    got = clip_by_global_norm(tg, max_norm)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    if max_norm == 1e3:
        assert all(torch.equal(got[k], tg[k]) for k in g)


def test_factored_dims_match_optax():
    from optax._src import factorized

    for shape in list(SHAPES.values()) + [(128, 127), (5, 128, 128, 2)]:
        assert factored_dims(shape) == factorized._factored_dims(shape, True, 128), shape


def run_both(make_ours, optax_tx, steps: int = 5, grad_scale: float = 1.0):
    """``steps`` updates of tree(0) from gradients tree(10 + i) through both
    optimizers; returns (ours, optax's) parameters after each step, and the
    norms ours reported."""
    p0 = tree(0)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = make_ours(params)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = optax_tx.init(jp)
    ours, theirs, norms = [], [], []
    for i in range(steps):
        g = tree(10 + i, grad_scale)
        norms.append(float(opt.step({k: torch.as_tensor(v) for k, v in g.items()})))
        updates, state = optax_tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        ours.append({k: v.clone() for k, v in params.items()})
        theirs.append(jax.device_get(jp))
    return ours, theirs, norms


def assert_trees_close(ours, theirs, rtol=1e-6):
    for step, (a, b) in enumerate(zip(ours, theirs)):
        for k in SHAPES:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=rtol, atol=1e-7,
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("grad_scale", [0.001, 1.0])  # every step clipped, and none
def test_adamw_matches_optax(grad_scale):
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax_schedule(), weight_decay=0.01))
    ours, theirs, norms = run_both(
        lambda p: AdamW(p, warmup_cosine(3e-3, 2, 10), weight_decay=0.01, clip_norm=1.0), tx,
        grad_scale=grad_scale)
    assert_trees_close(ours, theirs)
    assert all((n < 1.0) == (grad_scale < 1) for n in norms)
    # the first update's learning rate is 0: decay included, nothing moved
    assert all(torch.equal(ours[0][k], torch.as_tensor(tree(0)[k])) for k in SHAPES)


@pytest.mark.parametrize("grad_scale", [0.001, 1.0])
def test_adafactor_matches_optax(grad_scale):
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adafactor(optax_schedule(), multiply_by_parameter_scale=False,
                                     clipping_threshold=None, momentum=None,
                                     weight_decay_rate=1e-4))
    ours, theirs, _ = run_both(
        lambda p: Adafactor(p, warmup_cosine(3e-3, 2, 10), weight_decay=1e-4, clip_norm=1.0),
        tx, grad_scale=grad_scale)
    opt = Adafactor({k: torch.zeros(s) for k, s in SHAPES.items()}, lambda i: 0.0,
                    weight_decay=0.0)
    assert set(opt.v_row) == {"square", "wide", "stack", "stack_t"}
    assert set(opt.v) == {"small", "vector"}
    assert_trees_close(ours, theirs)


def test_state_dict_round_trip():
    p0 = tree(0)
    a = {k: torch.tensor(v) for k, v in p0.items()}
    b = {k: torch.tensor(v) for k, v in p0.items()}
    oa = AdamW(a, warmup_cosine(3e-3, 1, 10), weight_decay=0.01)
    for i in range(2):
        oa.step({k: torch.as_tensor(v) for k, v in tree(10 + i).items()})
    ob = AdamW(b, warmup_cosine(3e-3, 1, 10), weight_decay=0.01)
    for k in a:
        b[k].copy_(a[k])
    ob.load_state_dict(oa.state_dict())
    g = {k: torch.as_tensor(v) for k, v in tree(20).items()}
    oa.step(g)
    ob.step(g)
    assert ob.count == oa.count == 3
    assert all(torch.equal(a[k], b[k]) for k in a)
