"""The port's ``RealtimeBatchServer`` against the JAX package's on the CPU:
the tiny config of ``tests/test_realtime.py`` (RVQ 4, head_dim 16),
float32, the same weights through ``utils.convert``.

Two slots serve five conversations with mixed budgets and text feeds, the
later ones admitted mid-flight; the servers' default sampling draws
(temperature 0.8) and the compared conversations override it to greedy,
some with their own repetition penalty. Through ``run()`` their frames and
step counts equal the JAX server's; every stream through ``run_events()``
(after ``warmup()``) equals ``run()``'s, and the greedy ones the port's
solo engine. ``cancel`` frees a queued and an active conversation in both
servers. A sampled conversation rides along (its draws are PyTorch's, so it
is not compared with JAX); its stream is the same in ``run()`` and
``run_events()``, since each slot draws from its own generator seeded from
its request. Every prompt is one prompt bucket and the cache one attend
bucket, so the JAX server compiles three programs (its admissions at k = 1
and 2, its step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.realtime_batch_server import RealtimeBatchServer as JServer
from mosstts_tpu_torch.engine.realtime_batch_server import RealtimeBatchServer
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from test_torch_realtime import (CFG, GREEDY, TCFG, _turn, fast_jax_compiles,  # noqa: F401
                                 numpy_params, one_thread, port_params, proc)

KW = dict(slots=2, cache_len=128, max_frames=48, prompt_bucket=32)
BUDGETS = [12, 20, 9, 15, 11]
OVERRIDES = [dict(temperature=0.0), dict(temperature=0.0, repetition_penalty=1.3),
             dict(temperature=0.0, top_p=0.9), dict(temperature=0.0),
             dict(temperature=0.9)]  # the last one samples


@pytest.fixture(scope="module")
def servers():
    jp = numpy_params()
    tp = port_params(jp)
    return (JServer(jp, CFG, dtype=jnp.float32, **KW),
            RealtimeBatchServer(tp, TCFG, dtype=torch.float32, **KW), tp)


@pytest.fixture(scope="module")
def load(proc):
    """(grid, text) per conversation: text longer and shorter than the
    prefill's 4 tokens plus the budget."""
    texts = ["a", "reply two is long enough to feed", "three", "four four", "five!"]
    return [(_turn(proc, f"q{i}", i), proc.tokenizer.encode(t)) for i, t in enumerate(texts)]


def _serve(server, load, run, cancel_active=False):
    rids = [server.submit(g, t, max_new_tokens=n, prefill_text_len=4, sampling=o)
            for (g, t), n, o in zip(load, BUDGETS, OVERRIDES)]
    if cancel_active:
        queued = server.submit(*load[0], max_new_tokens=5, prefill_text_len=4)
        assert server.cancel(queued) and not server.cancel(queued)
        server.step()
        server.step()
        assert server.cancel(rids[1])  # active: its slot frees at once
        rids = rids[:1] + rids[2:]
    done = {c.request_id: c for c in getattr(server, run)()}
    assert sorted(done) == sorted(rids)
    return [done[r] for r in rids]


def test_greedy_streams_match_jax(servers, load):
    js, ts, _ = servers
    want, got = _serve(js, load, "run"), _serve(ts, load, "run")
    for w, g in zip(want[:-1], got[:-1]):
        assert g.frames.shape[0] > 0 and g.steps == w.steps
        np.testing.assert_array_equal(g.frames, w.frames)
    assert got[-1].frames.shape[1] == 4  # the sampled stream: PyTorch's draws


def test_cancel_matches_jax(servers, load):
    js, ts, _ = servers
    want, got = _serve(js, load, "run", True), _serve(ts, load, "run", True)
    for w, g in zip(want[:-1], got[:-1]):
        np.testing.assert_array_equal(g.frames, w.frames)


def test_streams_equal_the_solo_engine_and_each_other(servers, load):
    """Greedy streams equal ``RealtimeEngine.generate`` at the same padding;
    the sampled stream is the same through ``run()`` and ``run_events()``
    and after ``warmup()``."""
    _, _, tp = servers
    a = _serve(RealtimeBatchServer(tp, TCFG, dtype=torch.float32, **KW), load, "run")
    server = RealtimeBatchServer(tp, TCFG, dtype=torch.float32, **KW)
    server.warmup(prompt_lens=(32,), attend_upto=128)
    b = _serve(server, load, "run_events")
    engine = RealtimeEngine(tp, TCFG, dtype=torch.float32, device="cpu", cache_len=128,
                            max_length=64, prefill_bucket=32)
    for (grid, text), n, o, x, y in zip(load, BUDGETS, OVERRIDES, a, b):
        np.testing.assert_array_equal(x.frames, y.frames)
        if o.get("temperature") == 0.0:
            solo = engine.generate([grid], [text], max_length=n - 1, prefill_text_len=4,
                                   repetition_penalty=o.get("repetition_penalty", 1.1),
                                   top_p=o.get("top_p", 0.6), **GREEDY)[0]
            np.testing.assert_array_equal(x.frames, solo)
    assert not server._active and not server._queue
