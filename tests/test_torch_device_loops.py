"""The port's device-resident loops (``engine/step_graph.DeviceLoop`` and
the drain, ``ops/kernels/graph_loop``) against the JAX package's
``lax.while_loop``/``fori_loop`` programs on the CPU, at the tiny float32
configs of the family tests: each loop's state, executed count, flags and
completions equal JAX's function (the Delay ``_event_fn`` and
``_block_fn``, the Local ``_event_fn`` and ``_block_fn``, the Realtime
``_event_fn``, ``delay_generate_on_device`` through the engine, and
``run_drain``). The Delay family's draws are JAX's threefry bits, so its
sampled grids (seeded ``generate`` at B = 1 and 2, and ``run_drain`` with
the JAX drain test's overrides and seeds, ``tests/test_batch_server.py:
322-370``) equal JAX's too. On the CPU the loops run eagerly and evaluate
the condition after every step (its plain version, also pinned here case
by case); the card runs the same loops as conditional-node graphs
(``tests/test_torch_graphs_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.batch_server import DelayBatchServer as JaxServer
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.engine.local_batch_server import LocalBatchServer as JLocalServer
from mosstts_tpu.engine.realtime_batch_server import RealtimeBatchServer as JRealtimeServer
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.engine.local_batch_server import LocalBatchServer
from mosstts_tpu_torch.engine.realtime_batch_server import RealtimeBatchServer
from mosstts_tpu_torch.ops.kernels import graph_loop as gl
from tests.test_torch_drain import DRAIN_OVERRIDES, DRAIN_SEEDS, drain_grids  # noqa: F401
from tests.test_torch_events import (CFG, KW, _assert_same, _serve, fast_jax_compiles,  # noqa: F401
                                     one_thread, setup)

DELAY_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "rng", "is_stopping", "is_audio",
                "audio_lengths", "delayed", "seen", "out", "out_valid")


def _same_fields(tstate, jstate, fields, msg=""):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(tstate, f)).astype(np.int64)
                                      if f == "rng" else getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)).astype(np.int64)
                                      if f == "rng" else np.asarray(getattr(jstate, f)),
                                      err_msg=f"{msg} {f}")


# ---- the condition kernels' plain versions ---------------------------------------------
def _t(x, dt=torch.int32):
    return torch.tensor(x, dtype=dt)


@pytest.mark.parametrize("case", [
    # kind, i, limit, stop flags, step, want
    (gl.GENERATE, 0, 5, [False, False], [1, 1], True),
    (gl.GENERATE, 0, 5, [True, False], [5, 1], True),  # min(step) below the limit
    (gl.GENERATE, 0, 5, [False, False], [5, 6], False),  # every row at its limit
    (gl.GENERATE, 0, 5, [True, True], [1, 1], False),  # every row stopped
    (gl.BLOCK, 3, 4, None, None, True),
    (gl.BLOCK, 4, 4, None, None, False),
], ids=["gen-run", "gen-min", "gen-limit", "gen-stopped", "block-run", "block-end"])
def test_generate_and_block_conditions(case):
    kind, i, limit, flags, step, want = case
    kw = {} if kind == gl.BLOCK else dict(flags=_t(flags, torch.bool), step=_t(step))
    assert gl.loop_cond_plain(kind, i, limit, **kw) is want


@pytest.mark.parametrize("case", [
    # i, limit, flags, invert, watch, budget, want
    (0, 8, [False, False], False, [True, True], [3, 5], True),
    (3, 8, [False, False], False, [True, True], [3, 5], False),  # row 0's budget
    (3, 8, [False, False], False, [False, True], [3, 5], True),  # row 0 unwatched
    (2, 8, [False, True], False, [True, True], [9, 9], False),  # row 1 stopped
    (2, 8, [True, False], True, [True, True], [9, 9], False),  # "unfinished" flags
    (8, 8, [False, False], False, [True, True], [9, 9], False),  # the cap
], ids=["run", "budget", "unwatched", "eos", "inverted", "cap"])
def test_event_conditions(case):
    i, limit, flags, invert, watch, budget, want = case
    got = gl.loop_cond_plain(gl.EVENT, i, limit, flags=_t(flags, torch.bool), invert=invert,
                             watch=_t(watch, torch.bool), budget=_t(budget))
    assert got is want


@pytest.mark.parametrize("case", [
    # i, limit, active, pos, attend, qi, qn, want
    (0, 99, [False, False], [0, 0], 256, 0, 3, True),  # requests queued
    (5, 99, [True, False], [100, 0], 256, 3, 3, True),  # a slot still busy
    (5, 99, [False, False], [100, 0], 256, 3, 3, False),  # all drained
    (5, 99, [True, False], [256, 0], 256, 1, 3, False),  # the attend bucket is full
    (99, 99, [True, False], [100, 0], 256, 1, 3, False),  # the step cap
], ids=["queued", "busy", "drained", "bucket", "cap"])
def test_drain_conditions(case):
    i, limit, active, pos, attend, qi, qn, want = case
    got = gl.loop_cond_plain(gl.DRAIN, i, limit, active=_t(active, torch.bool), pos=_t(pos),
                             attend=attend, qi=qi, qn=qn)
    assert got is want


def test_drain_admit_and_collect():
    """The admission takes the first free slot for the next request (its
    budget, sampling row, key and bookkeeping) and tells its bucket; the
    collect writes a stopped or spent slot's frames into its request's row
    and frees the slot."""
    ctrl = np.zeros(gl.CTRL_WORDS, np.int32)
    ctrl[gl.QN] = 2
    active = _t([True, False, False], torch.bool)
    slot_rid, budget = _t([7, 0, 0]), _t([9, 1 << 30, 1 << 30])
    temp, staged, pre = torch.zeros(3), torch.tensor([0.5, 0.7]), torch.zeros(())
    keys, small_rng = torch.tensor([[1, 2], [3, 4]]), torch.zeros((1, 2), dtype=torch.int64)
    j = gl.drain_admit_plain(ctrl, active, slot_rid, budget, np.array([1, 0], np.int32),
                             _t([5, 6]), keys, small_rng, [(temp, staged, pre)])
    assert j == 1 and (ctrl[gl.SLOT], ctrl[gl.ADM_QI], ctrl[gl.QI]) == (1, 0, 1)
    assert active.tolist() == [True, True, False] and slot_rid[1] == 0 and budget[1] == 5
    assert temp[1] == 0.5 and pre == 0.5 and small_rng.tolist() == [[1, 2]]
    ctrl[gl.QI] = 2  # the queue is empty
    assert gl.drain_admit_plain(ctrl, active, slot_rid, budget, np.zeros(2, np.int32),
                                _t([5, 6]), keys, small_rng, []) == -1
    out = torch.arange(3 * 4 * 2, dtype=torch.int32).reshape(3, 4, 2)
    results, rsteps = torch.zeros((9, 4, 2), dtype=torch.int32), torch.zeros(9, dtype=torch.int32)
    gl.drain_collect_plain(active, _t([False, False, False], torch.bool), _t([9, 2, 0]), budget,
                           slot_rid, out, results, rsteps)
    assert active.tolist() == [False, True, False]  # slot 0 spent its budget of 9
    assert torch.equal(results[7], out[0]) and rsteps[7] == 9 and not results[0].any()


# ---- the Delay loops against JAX's programs ------------------------------------------------
def _delay_servers(setup, grids, **kw):
    jp, tp, _ = setup
    js = JaxServer(jp, CFG, dtype=jnp.float32, **KW, **kw)
    ts = DelayBatchServer(tp, CFG, dtype=torch.float32, **KW, **kw)
    for srv in (js, ts):
        for g, n, s in zip(grids, (30, 12, 20, 9), (3, None, 7, None)):
            srv.submit(g, max_new_tokens=n, seed=s)
    return js, ts


@pytest.mark.parametrize("block", ["event", "block"])
def test_delay_server_loops_match_jax(setup, drain_grids, block):
    """Sampled (the server's default sampling, one seeded request): each
    ``_dispatch_event`` block (JAX ``_event_fn``) or ``_dispatch_block(4)``
    (JAX ``_block_fn``, a ``fori_loop``) leaves JAX's state, keys included,
    and the event blocks JAX's step counts and flags."""
    js, ts = _delay_servers(setup, drain_grids[:4])
    for n in range(3):
        if block == "event":  # run_events' own order: budget collects, a block, a collect
            for srv in (js, ts):
                srv._collect(stopped=np.zeros(srv.slots, bool))
            jdid, jflags = js._dispatch_event(64)
            tdid, tflags = ts._dispatch_event(64)
            assert tdid == jdid and (tdid > 0 or n > 0)
            np.testing.assert_array_equal(tflags, np.asarray(jflags))
            js._collect(stopped=np.asarray(jflags))
            ts._collect(stopped=tflags)
        else:
            assert ts._dispatch_block(4) == js._dispatch_block(4) == 4
        _same_fields(ts.state, js.state, DELAY_FIELDS, f"{block} {n}")


@pytest.mark.parametrize("B", [1, 2])
def test_sampled_generate_matches_jax(setup, B):
    """Seeded sampled ``generate`` (the default temperatures and top-k), both
    ``on_device`` modes: JAX's grids."""
    jp, tp, proc = setup
    texts = ("hi", "a longer prompt")[:B]
    batch = proc([[proc.build_user_message(text=t)] for t in texts], mode="generation")
    ids, mask = batch["input_ids"], batch["attention_mask"]
    je = JaxEngine(jp, CFG, dtype=jnp.float32, cache_bucket=32)
    te = DelayEngine(tp, CFG, dtype=torch.float32, cache_bucket=32)
    for on_device in (True, False):
        want = je.generate(ids, mask, max_new_tokens=40, seed=5, on_device=on_device)
        got = te.generate(ids, mask, max_new_tokens=40, seed=5, on_device=on_device)
        for (ws, wg), (gs, gg) in zip(want, got, strict=True):
            assert gs == ws
            np.testing.assert_array_equal(gg, wg, err_msg=f"on_device={on_device}")


def test_sampled_run_drain_matches_jax(setup, drain_grids):
    """``run_drain`` with the JAX drain test's sampling overrides and seeds,
    on a sampling server: JAX's completions, step count and dispatches."""
    jp, tp, _ = setup
    kw = dict(KW, cache_len=512)
    js = JaxServer(jp, CFG, dtype=jnp.float32, **kw)
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, **kw)
    args = (DRAIN_OVERRIDES, DRAIN_SEEDS)
    _assert_same(_serve(js, drain_grids, "run_drain", *args),
                 _serve(srv, drain_grids, "run_drain", *args))
    assert (srv.total_steps, srv.total_dispatches) == (js.total_steps, js.total_dispatches)


# ---- the Local and Realtime loops ----------------------------------------------------------
LOCAL_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "unfinished", "seen_text", "seen_audio",
                "out")
RT_FIELDS = ("kv_valid", "cur_len", "last_audio", "is_stopping", "history", "hist_len")


@pytest.mark.parametrize("block", ["event", "block"])
def test_local_server_loops_match_jax(block):
    """Greedy Local slots, mid-flight: each event block (JAX ``_event_fn``)
    or block of 3 frames (``_block_fn``) leaves JAX's state, the event
    blocks JAX's frame counts and finished flags."""
    from tests.test_torch_local_server import KW as LKW, _grid as lgrid
    from tests.test_torch_local import CFG as LCFG, TCFG, numpy_params, port_params

    jp = numpy_params(seed=6)
    js = JLocalServer(jp, LCFG, cache_len=128, dtype=jnp.float32, **LKW)
    ts = LocalBatchServer(port_params(jp), TCFG, cache_len=128, dtype=torch.float32, **LKW)
    rng = np.random.default_rng(21)
    grids = [lgrid(rng, 8 + 3 * i) for i in range(3)]
    for srv in (js, ts):
        for g, n in zip(grids, (14, 6, 9)):
            srv.submit(g, max_new_tokens=n)
    for n in range(3):
        if block == "event":
            js._collect(np.zeros(js.slots, bool))
            ts._collect(stopped=np.zeros(ts.slots, bool))
            jdid, jfin = js._dispatch_event(64)
            tdid, tfin = ts._dispatch_event(64)
            assert tdid == jdid and (tdid > 0 or n > 0)
            np.testing.assert_array_equal(tfin, np.asarray(jfin))
            js._collect(np.asarray(jfin))
            ts._collect(stopped=tfin)
        else:
            assert ts._dispatch_block(3) == js._dispatch_block(3) == 3
        _same_fields(ts.state, js.state, LOCAL_FIELDS, f"{block} {n}")


def test_realtime_event_loop_matches_jax():
    """Greedy Realtime slots fed their text per frame from the staged
    columns: each event block (JAX ``_event_fn``) leaves JAX's state, frame
    counts and stop flags, with no frame past a watched slot's stop."""
    from tests.test_torch_realtime import CFG as RCFG, TCFG, _turn, numpy_params, port_params
    from mosstts_tpu.processing.realtime_processor import RealtimeProcessor
    from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer

    kw = dict(slots=2, cache_len=128, max_frames=48, prompt_bucket=32)
    jp = numpy_params()
    js = JRealtimeServer(jp, RCFG, dtype=jnp.float32, **kw)
    ts = RealtimeBatchServer(port_params(jp), TCFG, dtype=torch.float32, **kw)
    proc = RealtimeProcessor(ByteFallbackTokenizer(), channels=RCFG.rvq)
    load = [(_turn(proc, f"q{i}", i), proc.tokenizer.encode(t))
            for i, t in enumerate(["a", "reply two is long enough to feed", "three"])]
    for srv in (js, ts):
        for (grid, text), n in zip(load, (12, 20, 9)):
            srv.submit(grid, text, max_new_tokens=n, prefill_text_len=4,
                       sampling=dict(temperature=0.0))
    for n in range(3):
        for srv in (js, ts):
            srv._collect(stopped=np.zeros(srv.slots, bool))
        jdid, jflags = js._dispatch_event(64)
        tdid, tflags = ts._dispatch_event(64)
        assert tdid == jdid and (tdid > 0 or n > 0)
        np.testing.assert_array_equal(tflags, np.asarray(jflags))
        _same_fields(ts.state, js.state, RT_FIELDS, f"event {n}")
        js._collect(stopped=np.asarray(jflags))
        ts._collect(stopped=tflags)


@pytest.mark.parametrize("owner", ["steps", "server"])
def test_loop_owners_free_without_the_cycle_collector(setup, drain_grids, owner):
    """A step owner that ran a loop, and a server that ran a drain, are
    freed as soon as the last reference goes (no reference cycle): on the
    card their graphs must not be left to the cycle collector, which may
    run inside a later capture, where destroying a graph is not allowed."""
    import gc
    import weakref

    _, tp, _ = setup
    gc.disable()
    try:
        srv = DelayBatchServer(tp, CFG, dtype=torch.float32, **dict(KW, cache_len=512))
        for g in drain_grids[:2]:
            srv.submit(g, max_new_tokens=6)
        if owner == "steps":
            srv.run_events()
            ref = weakref.ref(srv._steps)
        else:
            srv.run_drain()
            ref = weakref.ref(srv)
        assert ref() is not None
        del srv
        assert ref() is None
    finally:
        gc.enable()
