"""The port's ``LocalBatchServer`` against the JAX package's on the CPU: the
tiny config of ``tests/test_torch_local.py``, float32 and int8 weights, the
same weights through ``utils.convert``, greedy.

The cases of JAX ``tests/test_local_server.py:53-143``: a 2-slot server's
grids equal the solo engine's fed the same bucket-padded grid (Local
positions are absolute slots, so the solo engine must see the same
padding); mid-flight admissions and slot reuse through ``step()``; both
``submit`` rejections; the pipelined poll equal to the sequential one; and
``run_events`` equal to ``run`` with budget step counts kept. Each also
equals the JAX server's completions (start length, tokens and steps). The
admissions run one prefill program per prompt bucket into the static
batch-1 state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.local_batch_server import LocalBatchServer as JServer
from mosstts_tpu.ops import quant as jquant
from mosstts_tpu_torch.engine.local_batch_server import LocalBatchServer
from mosstts_tpu_torch.engine.local_engine import LocalEngine
from test_torch_local import (CFG, GREEDY, NVQ, TCFG, fast_jax_compiles,  # noqa: F401
                              numpy_params, one_thread, port_params)

BUCKET = 32
KW = dict(slots=2, out_capacity=32, prompt_bucket=BUCKET, **GREEDY)


@pytest.fixture(scope="module")
def jp():
    return numpy_params(seed=6)


def _grid(rng, T):
    g = rng.integers(0, 500, (T, CFG.channels)).astype(np.int64)
    g[..., 1:] = rng.integers(0, 1024, (T, NVQ))
    g[2, 0] = CFG.audio_start_token_id
    return g


def _pad(grid):
    T = grid.shape[0]
    Tb = ((T + BUCKET - 1) // BUCKET) * BUCKET
    ids = np.full((1, Tb, CFG.channels), CFG.audio_pad_code, np.int64)
    ids[..., 0] = CFG.pad_token_id
    ids[0, Tb - T:] = grid
    mask = np.zeros((1, Tb), bool)
    mask[0, Tb - T:] = True
    return ids, mask


def _servers(jp, cache_len, int8=False, **kw):
    if int8:
        jp = jquant.quantize_tree(jp)
    tp = port_params(jp, quantized=int8)
    return (JServer(jp, CFG, cache_len=cache_len, dtype=jnp.float32, **KW, **kw),
            LocalBatchServer(tp, TCFG, cache_len=cache_len, dtype=torch.float32, **KW, **kw))


def _same(a, b, msg=""):
    assert a.start_length == b.start_length, msg
    np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=msg)
    assert a.steps == b.steps, msg


def _serve(server, grids, budgets, run="run", **kw):
    rids = [server.submit(g, max_new_tokens=n) for g, n in zip(grids, budgets)]
    done = {c.request_id: c for c in getattr(server, run)(**kw)}
    assert sorted(done) == sorted(rids)
    return [done[r] for r in rids]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_server_matches_solo_and_jax(jp, int8):
    rng = np.random.default_rng(0)
    grids = [_grid(rng, 8 + 3 * i) for i in range(4)]
    budgets = [10, 14, 9, 12]
    js, ts = _servers(jp, 256, int8=int8)
    want = _serve(js, grids, budgets, max_steps=400)
    got = _serve(ts, grids, budgets, max_steps=400)
    assert ts.utilization == 0.0
    engine = LocalEngine(ts.params, TCFG, dtype=torch.float32, cache_bucket=64, device="cpu")
    for i, (a, b, grid, n) in enumerate(zip(want, got, grids, budgets)):
        _same(a, b, f"request {i}")
        start, toks = engine.generate(*_pad(grid), max_new_tokens=n, **GREEDY)[0]
        assert b.start_length == start
        # the server ends a request at its first EOS frame (kept), else at
        # its budget; the engine runs on to its next poll
        eos = np.nonzero(toks[start + 1:, 0] == ts.eos_token_id)[0]
        if len(eos):
            toks = toks[: start + 2 + int(eos[0])]
        np.testing.assert_array_equal(b.tokens, toks, err_msg=f"request {i} vs solo")


def test_midflight_admission_and_reuse_match_jax(jp):
    rng = np.random.default_rng(1)
    grids = [_grid(rng, 9 + 2 * i) for i in range(3)]
    outs = []
    for server in _servers(jp, 256):
        r0 = server.submit(grids[0], max_new_tokens=8)
        r1 = server.submit(grids[1], max_new_tokens=12)
        done = []
        for _ in range(5):
            done.extend(server.step())
        r2 = server.submit(grids[2], max_new_tokens=10)  # mid-flight
        for _ in range(300):
            done.extend(server.step())
            if not server._active and not server._queue:
                break
        done = {c.request_id: c for c in done}
        assert set(done) == {r0, r1, r2}
        outs.append([done[r] for r in (r0, r1, r2)])
    for i, (a, b) in enumerate(zip(*outs)):
        _same(a, b, f"request {i}")


def test_submit_validation():
    ts = LocalBatchServer(port_params(numpy_params(seed=2)), TCFG, slots=2, cache_len=128,
                          out_capacity=32, dtype=torch.float32)
    with pytest.raises(ValueError):
        ts.submit(np.zeros((4, 2)))  # wrong channels
    with pytest.raises(ValueError):
        ts.submit(np.zeros((120, CFG.channels), np.int64), max_new_tokens=32)  # exceeds cache


def test_pipelined_poll_matches_sequential_and_jax(jp):
    """Readmitted slots must not inherit stale flags; the JAX server's
    pipelined run gives the same completions."""
    rng = np.random.default_rng(11)
    grids = [_grid(rng, int(rng.integers(8, 24))) for _ in range(5)]
    budgets = [6, 9, 5, 8, 7]
    js, ts = _servers(jp, 128, poll_every=3)
    want = _serve(js, grids, budgets, max_steps=500)
    got = _serve(ts, grids, budgets, max_steps=500)
    _, ts2 = _servers(jp, 128, poll_every=3)
    seq = _serve(ts2, grids, budgets, max_steps=500, pipelined=False)
    for i, (a, b, c) in enumerate(zip(want, got, seq)):
        _same(a, b, f"request {i}")
        n = min(len(b.tokens), len(c.tokens))
        np.testing.assert_array_equal(b.tokens[:n], c.tokens[:n], err_msg=f"request {i}")


def test_event_run_matches_windowed_and_jax(jp):
    """``run_events`` reproduces ``run``'s grids exactly under mixed
    budgets, with the budget step counts kept, as JAX's does."""
    rng = np.random.default_rng(21)
    grids = [_grid(rng, 8 + 3 * i) for i in range(5)]
    budgets = [12, 7, 15, 9, 11]
    js, ts = _servers(jp, 128)
    want = _serve(js, grids, budgets, run="run_events", max_steps=600)
    got = _serve(ts, grids, budgets, run="run_events", max_steps=600)
    _, ts2 = _servers(jp, 128)
    ref = _serve(ts2, grids, budgets, max_steps=600)
    for i, (a, b, r, n) in enumerate(zip(want, got, ref, budgets)):
        _same(a, b, f"request {i}")
        np.testing.assert_array_equal(b.tokens, r.tokens)
        assert b.steps <= n


def test_admissions_run_one_program_per_prompt_bucket(jp):
    """Admissions of prompts in two buckets (32 and 64 rows) prefill into
    the one static batch-1 state through one program per bucket (eager on
    the CPU, keyed by the bucket), spliced into their slots: the grids equal
    JAX's; ``warmup()`` runs the buckets it is given and holds no graph on
    the CPU."""
    js, ts = _servers(jp, cache_len=192)
    rng = np.random.default_rng(7)
    grids = [_grid(rng, T) for T in (20, 40, 25, 50, 31)]
    budgets = [6, 9, 5, 7, 8]
    for w, g in zip(_serve(js, grids, budgets), _serve(ts, grids, budgets)):
        _same(w, g)
    prefills = ts._prefills
    assert sorted(prefills._prompts) == [(32, NVQ), (64, NVQ)] and not prefills.keys
    assert prefills.counts == dict(eager=5, capture=0, replay=0)
    assert prefills.state is ts._small and ts._small.pos.ndim == 0
    ts.warmup(prompt_lens=(32, 96), attend_upto=64)
    assert sorted(prefills._prompts) == [(32, NVQ), (64, NVQ), (96, NVQ)]
    assert not prefills.keys and not ts._active
