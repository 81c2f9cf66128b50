"""The server's ``run_drain`` (JAX ``_drain_fn``/``run_drain``) against the
port's own ``run()`` with sampling overrides and seeds, and against JAX's
``run_drain`` (greedy), on CPU: the tiny float32 config, weights and
helpers of ``tests/test_torch_events.py``, the load of
``tests/test_batch_server.py:322``. Tokens, steps and dispatches equal
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.batch_server import DelayBatchServer as JaxServer
from mosstts_tpu.models import delay as jd
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.models import delay as td
from tests.test_torch_events import (CFG, GREEDY, KW, _assert_same, _grid, _serve, one_thread,
                                     setup)  # noqa: F401 (fixtures)


DRAIN_OVERRIDES = [None, {"audio_temperature": 0.9, "audio_top_p": 0.8},
                   None, {"text_temperature": 0.7}, None]
DRAIN_SEEDS = [None, 7, None, 11, None]


@pytest.fixture(scope="module")
def drain_grids(setup):
    # two prompt buckets (test_batch_server.py:322)
    return [_grid(setup[2], f"drain wave {i}" + " pad" * (6 * (i % 2)), seed=90 + i)
            for i in range(5)]


def test_run_drain_matches_run_with_overrides_and_seeds(setup, drain_grids):
    """``run_drain`` gives ``run()``'s completions with sampling overrides
    and seeds (sampled rows included), in queue order, one dispatch per
    attend segment; the mirrors are reset as JAX resets them."""
    _, tp, _ = setup
    kw = dict(KW, cache_len=512, dtype=torch.float32, sampling=td.make_sampling(**GREEDY))
    args = (DRAIN_OVERRIDES, DRAIN_SEEDS)
    ref = _serve(DelayBatchServer(tp, CFG, **kw), drain_grids, "run", *args)
    srv = DelayBatchServer(tp, CFG, **kw)
    got = _serve(srv, drain_grids, "run_drain", *args)
    _assert_same(ref, got)
    assert [c.request_id for c in got] == list(range(5))
    assert 1 <= srv.total_dispatches <= 3 and srv.util_sum == 0.0
    assert (srv._step_host == 1 << 30).all()
    np.testing.assert_array_equal(srv._pos_host, srv.state.pos.numpy())
    # the server serves on after a drain: run() gives the same completions
    _assert_same(ref, _serve(srv, drain_grids, "run", *args))


def test_run_drain_matches_jax(setup, drain_grids):
    """Greedy, ``run_drain`` gives JAX's ``run_drain`` completions and step
    count, and the same dispatches."""
    jp, tp, _ = setup
    kw = dict(KW, cache_len=512)
    js = JaxServer(jp, CFG, dtype=jnp.float32, sampling=jd.make_sampling(**GREEDY), **kw)
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, sampling=td.make_sampling(**GREEDY),
                           **kw)
    _assert_same(_serve(js, drain_grids, "run_drain"), _serve(srv, drain_grids, "run_drain"))
    assert (srv.total_steps, srv.total_dispatches) == (js.total_steps, js.total_dispatches)


def test_run_drain_rejects_paged_and_busy(setup, drain_grids):
    _, tp, _ = setup
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, cache_len=256, paged=True,
                           page_size=64, **KW)
    with pytest.raises(ValueError, match="linear"):
        srv.run_drain()
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, cache_len=256, **KW)
    srv.submit(drain_grids[0], max_new_tokens=8)
    srv.step()
    assert srv._active
    srv.submit(drain_grids[1], max_new_tokens=8)
    with pytest.raises(ValueError, match="idle"):
        srv.run_drain()
    assert srv._active and len(srv._queue) == 1  # left as it was
