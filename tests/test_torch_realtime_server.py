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
and 2, its step). A 4-slot schedule then admits groups of k = 4, 2, 1, 3
and 1 into slots that are not contiguous, through the static admission
state ``warmup()`` keeps for each k bucket (or, for a server not warmed
up, a transient one per admission): greedy streams equal the JAX
server's, and sampled ones equal, at the same request ids, those of the
per-admission prefill that state replaced.
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


# Admission groups of k = 4, 2, 1, 3 and 1 into slots that are not contiguous
# (budgets: frames per conversation, the prefill's included, so one admitted
# at step s with budget b finishes at step s + b - 2; every prompt is one
# bucket): four slots admit four conversations at step 0; slots 1 and 3
# finish at step 3 and admit two together at step 4, slot 0 finishes at step
# 6 and admits one at step 7, slots 0, 1 and 3 finish at step 10 and admit
# three (padded to k = 4) at step 11, slot 2 finishes at step 14 and admits
# the last one at step 15.
GROUP_KW = dict(slots=4, cache_len=128, max_frames=24, prompt_bucket=32)
GROUP_BUDGETS = [8, 5, 16, 5, 8, 8, 5, 6, 6, 6, 5]
GROUPS = [(0, 1, 2, 3), (1, 3), (0,), (0, 1, 3), (2,)]


def _serve_groups(server, load, sampling, warm=True):
    """The schedule above through ``run(pipelined=False)`` (completions at
    their budgets, exactly), after ``warmup()`` of its one prompt bucket if
    ``warm``; returns the streams in submission order and the slots of
    every admission group."""
    if warm:
        server.warmup(prompt_lens=(32,), attend_upto=128)
    groups = []
    prefill_group = server._prefill_group

    def recorded(ids, valid, slots, seeds, samp):
        groups.append(tuple(slots))
        prefill_group(ids, valid, slots, seeds, samp)

    server._prefill_group = recorded
    rids = [server.submit(*load[i % len(load)], max_new_tokens=n, prefill_text_len=4,
                          sampling=sampling) for i, n in enumerate(GROUP_BUDGETS)]
    done = {c.request_id: c for c in server.run(pipelined=False)}
    return [done[r] for r in rids], groups


def _old_prefill_group(self, ids, valid, slots, seeds, sampling):
    """The admission as it was before it became one static-state program:
    a new kb-row state per admission, row i drawing from the key
    ``PRNGKey(seeds[i])``."""
    from mosstts_tpu_torch.engine.realtime_batch_server import _splice_rt_rows_
    from mosstts_tpu_torch.models.realtime import init_realtime_state, realtime_prefill_step
    from mosstts_tpu_torch.ops.sampling import prng_key

    kb, Tb = ids.shape[:2]
    k = len(slots)
    keys = torch.stack([prng_key(seed) for seed in list(seeds) + [0] * (kb - k)])
    small = init_realtime_state(self.config, kb, self.cache_len, self.max_frames, keys,
                                dtype=self.dtype)
    small, _ = realtime_prefill_step(self.params, self.config, small, torch.as_tensor(ids),
                                     torch.as_tensor(valid), sampling, top_k=self.top_k,
                                     attend_len=self._admit_attend(Tb))
    _splice_rt_rows_(self.state, small, torch.as_tensor(slots, dtype=torch.int64))


def test_admission_groups_match_jax(servers, load):
    """Greedy: the groups of ``GROUPS`` (k = 4, 2, 1, 3 and 1, into slots
    0-3, 1 and 3, 0, 0, 1 and 3, 2), admitted after ``warmup()`` through the
    static admission state it kept for each k bucket (reused, returned to a
    new conversation's in the program, its keys handed to the slots),
    give the JAX server's streams and step counts."""
    js = JServer(servers[0].params, CFG, dtype=jnp.float32, **GROUP_KW)
    ts = RealtimeBatchServer(servers[2], TCFG, dtype=torch.float32, **GROUP_KW)
    rids = [js.submit(*load[i % len(load)], max_new_tokens=n, prefill_text_len=4,
                      sampling=dict(temperature=0.0)) for i, n in enumerate(GROUP_BUDGETS)]
    jdone = {c.request_id: c for c in js.run(pipelined=False)}
    want = [jdone[r] for r in rids]
    got, groups = _serve_groups(ts, load, dict(temperature=0.0))
    assert groups == GROUPS
    assert sorted(ts._admissions) == [(1, 128), (2, 128), (4, 128)]
    for w, g in zip(want, got, strict=True):
        assert g.steps == w.steps and g.frames.shape[0] > 0
        np.testing.assert_array_equal(g.frames, w.frames)


@pytest.mark.parametrize("warm", [True, False])
def test_sampled_admission_groups_equal_the_per_admission_prefill(servers, load, warm):
    """Sampled (temperature 0.9): the same schedule gives, at the same
    request ids, the streams of the admission it replaced (a new state per
    admission, drawing from the requests' own keys), through the static
    admission states ``warmup()`` kept, or without a warmup through a
    transient one per admission (none kept)."""
    tp = servers[2]
    new = RealtimeBatchServer(tp, TCFG, dtype=torch.float32, **GROUP_KW)
    old = RealtimeBatchServer(tp, TCFG, dtype=torch.float32, **GROUP_KW)
    old._prefill_group = _old_prefill_group.__get__(old)
    got, groups = _serve_groups(new, load, dict(temperature=0.9), warm=warm)
    want, old_groups = _serve_groups(old, load, dict(temperature=0.9), warm=False)
    assert groups == old_groups == GROUPS
    assert sorted(new._admissions) == ([(1, 128), (2, 128), (4, 128)] if warm else [])
    for w, g in zip(want, got, strict=True):
        assert g.request_id == w.request_id and g.steps == w.steps
        np.testing.assert_array_equal(g.frames, w.frames)
    # the slots' keys end where the old ones did
    np.testing.assert_array_equal(new.state.rng.numpy(), old.state.rng.numpy())
