"""The server's ``run_events`` (JAX ``_event_fn``/``run_events``) against the
JAX package's and against the port's own ``run()`` on CPU, in the four
cache modes: the tiny float32 config, weights and helpers of
``tests/test_torch_events.py``, the budgets of
``tests/test_batch_server.py:284``. Tokens, steps and dispatches equal
exactly (greedy).
"""
import jax.numpy as jnp
import pytest
import torch

from mosstts_tpu.engine.batch_server import DelayBatchServer as JaxServer
from mosstts_tpu.models import delay as jd
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.models import delay as td
from tests.test_torch_events import (BUDGETS, CFG, GREEDY, KW, _assert_same, _grid, _serve,
                                     one_thread, setup)  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def event_grids(setup):
    return [_grid(setup[2], f"event wave {i}", seed=80 + i) for i in range(5)]


@pytest.fixture(scope="module")
def jax_events(setup, event_grids):
    """JAX's linear ``run_events`` completions and server (greedy). Its own
    test (``tests/test_batch_server.py::test_event_driven_run_matches_windowed``)
    holds its paged ``run_events`` equal to them, so one JAX run serves
    both cache layouts here."""
    js = JaxServer(setup[0], CFG, dtype=jnp.float32, sampling=jd.make_sampling(**GREEDY),
                   cache_len=256, **KW)
    return _serve(js, event_grids, "run_events"), js


@pytest.mark.parametrize("mode", [{}, dict(paged=True, page_size=64), dict(kv_quant=True),
                                  dict(paged=True, page_size=64, kv_quant=True)],
                         ids=["linear", "paged", "linear-q8", "paged-q8"])
def test_run_events_matches_jax_and_run(setup, event_grids, jax_events, mode):
    """``run_events`` gives JAX's ``run_events`` completions (greedy; the
    linear server's steps and dispatches too) and the port's own ``run()``'s
    completions, in every cache mode; each completion within its budget."""
    _, tp, _ = setup
    kw = dict(KW, cache_len=256, **mode)
    ref = _serve(DelayBatchServer(tp, CFG, dtype=torch.float32,
                                  sampling=td.make_sampling(**GREEDY), **kw),
                 event_grids, "run")
    ts_ = DelayBatchServer(tp, CFG, dtype=torch.float32, sampling=td.make_sampling(**GREEDY),
                           **kw)
    got = _serve(ts_, event_grids, "run_events")
    _assert_same(ref, got)
    assert all(c.steps <= n for c, n in zip(got, BUDGETS))
    if mode.get("kv_quant"):
        return  # the JAX half of the int8 cache is test_torch_batch_server's
    ref, js = jax_events
    _assert_same(ref, got)
    if not mode.get("paged"):  # the page pool holds one request at a time: other steps
        assert (ts_.total_steps, ts_.total_dispatches) == (js.total_steps, js.total_dispatches)
