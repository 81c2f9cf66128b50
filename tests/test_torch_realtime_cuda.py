"""The Realtime frames as CUDA graphs against the same frames run eagerly,
on the card; they skip without one (CUDA graphs and the kernels have no
CPU mode; ``tests/test_torch_realtime*.py`` hold the eager frames against
JAX on the CPU).

A small model whose heads the kernels take (backbone and depth transformer
2 layers of width 512, 4 query and 2 KV heads of 128, 8 codebooks) decodes
the same conversations with ``graphs=True`` and ``graphs=False``: the
engine at B = 1 and 8, in bf16 and then on int8 weights, through a
conversation that outgrows its 128-slot cache (the engine then builds its
state and frame graphs anew), and the continuous-batching server through
``run`` and ``run_events``. Frames must be equal bit for bit: a graph
replays the eager frame's kernels on the same inputs and draws from the
same keys. On the float32 model the card's greedy frames equal the CPU's,
and so do the server's ``run_events`` streams and step counts (a loop
graph on the card, the text fed per frame there). The prefills and admissions are graphs too: the engine's
first-turn and later-turn prefills (first use eager, second captured, then
replayed at cursor 0 and at a later cursor) and the server's admissions of
k = 1, 2, 4 and 8 (captured by ``warmup``) leave the whole state equal to
the eager engine's or server's, and a warm one launches flash and W8A16
only inside its graph; an admission of a prompt bucket ``warmup`` did not
name runs eagerly, at its second use too (the server never captures
mid-serve); a prefill that cannot be captured raises.

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_realtime_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.core.config import RealtimeConfig, RealtimeLocalConfig, tiny_qwen3
from mosstts_tpu_torch.engine.realtime_batch_server import RealtimeBatchServer
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from mosstts_tpu_torch.ops.kernels import launches

CFG = RealtimeConfig(
    language_config=tiny_qwen3(hidden_size=512, intermediate_size=1024, num_attention_heads=4,
                               num_key_value_heads=2, head_dim=128),
    local_config=RealtimeLocalConfig(hidden_size=512, intermediate_size=1024,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, head_dim=128, rvq=8,
                                     max_position_embeddings=9),
    rvq=8)
GREEDY = dict(temperature=0.0, do_sample=False)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _load(B, seed=0, rows=6, text=40):
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(B):
        g = np.full((rows, 1 + CFG.rvq), CFG.audio_pad_token, np.int64)
        g[:, 0] = rng.integers(100, 1000, rows)
        g[:, 1:] = rng.integers(0, 1024, (rows, CFG.rvq))
        grids.append(g)
    return grids, [[int(t) for t in rng.integers(100, 1000, text)] for _ in range(B)]


def _conversation(engine, B, sampling):
    """A turn, a second turn on the kept cache, then frames past the
    128-slot cache (``step_async`` steps whatever the frames say)."""
    grids, text = _load(B)
    engine.reset_generation_state(keep_cache=False)
    engine.prefill(grids, [t[:12] for t in text], seed=5, **sampling)
    engine.step_block([[t[12 + i] for t in text] for i in range(10)], **sampling)
    out = list(engine.generated_tokens)
    engine.reset_generation_state(keep_cache=True)
    grids, text = _load(B, seed=1)
    engine.prefill(grids, [t[:12] for t in text], **sampling)
    handles = [engine.step_async(None, **sampling) for _ in range(100)]
    engine.fetch_frames(handles)
    return out + list(engine.generated_tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_engine_frame_graphs_match_eager_bf16_then_int8(B):
    """Greedy and sampled conversations through a cache growth (128 -> 256
    slots): the graph engine's frames equal the eager engine's, before and
    after ``quantize()``; the growth builds new frame graphs over the new
    state; the kernels ran inside replayed graphs."""
    _need_card()
    params = RealtimeEngine.random_init(seed=2, config=CFG, device="cuda").params
    kw = dict(device="cuda", cache_len=128, max_context=1024, max_length=200)
    for weights in ("bf16", "int8"):
        if weights == "int8":
            RealtimeEngine(params, CFG, **kw).quantize()
        for sampling in (GREEDY, dict(temperature=0.8)):
            launches.reset()
            graph = RealtimeEngine(params, CFG, **kw)
            eager = RealtimeEngine(params, CFG, graphs=False, **kw)
            got = _conversation(graph, B, sampling)
            assert graph.cache_len == 256 and graph._steps.state.cache.k.shape[3] == 256
            assert graph._steps.keys and launches.IN_GRAPHS["decode"] > 0
            if weights == "int8":
                assert launches.IN_GRAPHS["w8a16"] > 0
            want = _conversation(eager, B, sampling)
            assert len(got) == len(want) > 100
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_server_frame_graphs_match_eager():
    """Five conversations (greedy and sampled, budgets 9-20, mid-flight
    admissions) through a 2-slot server with graph frames and with eager
        frames: equal streams, through ``run`` and through ``run_events`` (whose
    admissions may group otherwise than ``run``'s, so each is held against
    its own eager run)."""
    _need_card()
    params = RealtimeEngine.random_init(seed=3, config=CFG, device="cuda").params
    grids, text = _load(5, seed=4, rows=5, text=30)
    budgets = [12, 20, 9, 15, 11]
    overrides = [dict(temperature=0.0), dict(temperature=0.9), {}, dict(temperature=0.0),
                 dict(top_p=0.9)]
    for run in ("run", "run_events"):
        streams = []
        for graphs in (True, False):
            server = RealtimeBatchServer(params, CFG, slots=2, cache_len=256, max_frames=48,
                                         prompt_bucket=16, graphs=graphs)
            rids = [server.submit(g, t, max_new_tokens=n, sampling=o)
                    for g, t, n, o in zip(grids, text, budgets, overrides)]
            done = {c.request_id: c.frames for c in getattr(server, run)()}
            streams.append([done[r] for r in rids])
            assert bool(server._steps.keys) == graphs
        for x, y in zip(*streams):
            assert x.shape[0] > 0
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_float32_frames_equal_the_cpu():
    """On the float32 model (no TF32) the card's greedy frames, through
    the kernels and the frame graphs, equal the CPU's plain versions'."""
    _need_card()
    cpu = RealtimeEngine.random_init(seed=6, config=CFG, dtype=torch.float32, device="cpu",
                                     cache_len=256, max_length=64)
    card = RealtimeEngine(copy.deepcopy(cpu.params).to("cuda"), CFG, dtype=torch.float32,
                          device="cuda", cache_len=256, max_length=64)
    grids, text = _load(2, seed=7)
    want = cpu.generate(grids, text, max_length=24, **GREEDY)
    got = card.generate(grids, text, max_length=24, **GREEDY)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_float32_event_loop_equals_the_cpu():
    """The 2-slot server's ``run_events`` on the float32 model: on the card
    each event block is one launch of a loop graph (the frame graph, the
    text column fed from the staged tokens, the condition read after every
    frame); its streams and step counts equal the CPU's eager loop's, so
    no frame runs past a watched slot's stop."""
    _need_card()
    cpu = RealtimeEngine.random_init(seed=6, config=CFG, dtype=torch.float32, device="cpu",
                                     cache_len=256, max_length=64)
    grids, text = _load(5, seed=9, rows=5, text=30)
    out = []
    for params in (cpu.params, copy.deepcopy(cpu.params).to("cuda")):
        server = RealtimeBatchServer(params, CFG, slots=2, cache_len=256, max_frames=48,
                                     prompt_bucket=16, dtype=torch.float32)
        rids = [server.submit(g, t, max_new_tokens=n, sampling=dict(temperature=0.0))
                for g, t, n in zip(grids, text, [12, 20, 9, 15, 11])]
        done = {c.request_id: c for c in server.run_events()}
        out.append([(done[r].steps, done[r].frames) for r in rids])
        if params.text_emb.is_cuda:
            assert server._steps._loop.launches > 0
    for (sa, fa), (sb, fb) in zip(*out):
        assert sa == sb
        np.testing.assert_array_equal(fa, fb)


def _assert_same_state(a, b):
    """Every tensor of two ``RealtimeState``s (their caches and keys too)
    equal bit for bit."""
    ta = list(a.cache) + [t for t in a[1:] if isinstance(t, torch.Tensor)]
    tb = list(b.cache) + [t for t in b[1:] if isinstance(t, torch.Tensor)]
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _only_replayed(*names):
    """Every launch of the counted kernels since ``launches.reset()`` was a
    replay's: no eager launch outside a graph."""
    got = launches.read()
    for name in names:
        assert got[name] == launches.IN_GRAPHS[name] > 0, (name, got, launches.IN_GRAPHS)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_engine_prefill_graphs_match_eager(weights):
    """Two conversations of two turns, sampled (temperature 0.8): every
    prefill is one prompt length and attend bucket, so the first runs
    eagerly, the second (a turn at a later cursor) captures, and the second
    conversation's two replay the graph, at cursor 0 and at a later cursor.
    After each prefill the whole state (cache, masks, frames, cursors,
    keys) equals the eager engine's; the replayed
    prefills launch flash (and W8A16) only inside the graph."""
    _need_card()
    params = RealtimeEngine.random_init(seed=8, config=CFG, device="cuda").params
    kw = dict(device="cuda", cache_len=128, max_length=64)
    if weights == "int8":
        RealtimeEngine(params, CFG, **kw).quantize()
    engines = [RealtimeEngine(params, CFG, graphs=g, **kw) for g in (True, False)]
    sampling = dict(temperature=0.8)
    for conv in range(2):
        for turn in range(2):
            if conv == 1:
                launches.reset()
            frames, cursors = [], []
            for e in engines:
                e.reset_generation_state(keep_cache=turn == 1)
                cursors.append(0 if turn == 0 else int(e.state.cur_len))
                grids, text = _load(2, seed=10 * conv + turn)
                frames.append(e.prefill(grids, [t[:12] for t in text], seed=5 + conv,
                                        **sampling))
                if conv == 1 and e.graphs:
                    _only_replayed("flash", *(("w8a16",) if weights == "int8" else ()))
            np.testing.assert_array_equal(*frames)
            _assert_same_state(engines[0].state, engines[1].state)
            assert cursors[0] == cursors[1] and (cursors[0] > 0) == (turn == 1)
            steps = [e.step_block([[t[12 + i] for t in text] for i in range(6)], **sampling)
                     for e in engines]
            for a, b in zip(*steps, strict=True):
                np.testing.assert_array_equal(a, b)
    prefills = engines[0]._prefills
    assert prefills.counts == dict(eager=1, capture=1, replay=2) and len(prefills.keys) == 1
    assert engines[1]._prefills.counts == dict(eager=4, capture=0, replay=0)


def _server_pair(params):
    return [RealtimeBatchServer(params, CFG, slots=8, cache_len=256, max_frames=48,
                                prompt_bucket=16, graphs=g) for g in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_server_admission_graphs_match_eager(weights):
    """Admissions of k = 1, 2, 4 and 8 sampled conversations (temperature
    0.9) after ``warmup()`` captured their graphs: each is the replay of one
    graph (flash and W8A16 launched only inside graphs) into its k bucket's
    static admission state, and after each the running state (its slots'
    keys too) and the admission state equal the
    eager server's; the streams then equal too. Admissions of two prompt
    buckets ``warmup()`` did not name, each twice, one after the other,
    run eagerly (flash launched outside any graph) and capture nothing:
    bucket 48 into the admission state kept for attend 128, bucket 144 into
    a transient one for attend 256, which is not kept; after each the state
    equals the eager server's."""
    _need_card()
    params = RealtimeEngine.random_init(seed=9, config=CFG, device="cuda").params
    if weights == "int8":
        RealtimeEngine(params, CFG, device="cuda").quantize()
    servers = _server_pair(params)
    for s in servers:
        s.warmup(prompt_lens=(32,), attend_upto=128)
    g = servers[0]
    assert sorted(g._admissions) == [(k, 128) for k in (1, 2, 4, 8)]
    assert all(a.prefills.keys == ((32, 128, g.top_k),) for a in g._admissions.values())
    grids, text = _load(15, seed=11, rows=6, text=30)
    done = [{}, {}]
    start = 0
    for k in (1, 2, 4, 8):
        if k == 8:  # eight free slots: let the first seven conversations end
            for s, d in zip(servers, done):
                d.update({c.request_id: c.frames for c in s.run()})
        rids = [[s.submit(grids[i], text[i], max_new_tokens=12 + i, sampling=dict(
                temperature=0.9)) for i in range(start, start + k)] for s in servers]
        assert rids[0] == rids[1]
        launches.reset()
        for s, d in zip(servers, done):
            for c in s.step():
                d[c.request_id] = c.frames
            if s is g:
                _only_replayed("flash", *(("w8a16",) if weights == "int8" else ()))
        _assert_same_state(g.state, servers[1].state)
        _assert_same_state(g._admissions[k, 128].state, servers[1]._admissions[k, 128].state)
        start += k
    for s, d in zip(servers, done):
        d.update({c.request_id: c.frames for c in s.run()})
    grids, text = _load(2, seed=12, rows=30, text=30)  # prompt bucket 48
    grids2, text2 = _load(2, seed=13, rows=130, text=30)  # prompt bucket 144
    for grid, text in zip(grids + grids2, text + text2):
        launches.reset()
        for s, d in zip(servers, done):
            s.submit(grid, text, max_new_tokens=12, sampling=dict(temperature=0.9))
            for c in s.step():
                d[c.request_id] = c.frames
            if s is g:
                assert launches.read()["flash"] > launches.IN_GRAPHS["flash"]
        _assert_same_state(g.state, servers[1].state)
        for s, d in zip(servers, done):
            d.update({c.request_id: c.frames for c in s.run()})
    assert sorted(done[0]) == sorted(done[1]) == list(range(19))
    for r in done[0]:
        np.testing.assert_array_equal(done[0][r], done[1][r])
    assert sorted(g._admissions) == [(k, 128) for k in (1, 2, 4, 8)]
    assert all(a.prefills.keys == ((32, 128, g.top_k),) for a in g._admissions.values())
    counts = {key: a.prefills.counts for key, a in g._admissions.items()}
    assert counts.pop((1, 128)) == dict(eager=3, capture=0, replay=1)
    assert all(c == dict(eager=1, capture=0, replay=1) for c in counts.values())


@pytest.mark.cuda
def test_failed_prefill_capture_raises(monkeypatch):
    """A prefill that cannot be captured (here one that reads the device
    cursor on the host) raises at its capture; nothing falls back to an
    eager prefill."""
    _need_card()
    from mosstts_tpu_torch.engine import step_graph

    real = step_graph.realtime_prefill_step

    def host_read(params, cfg, state, *a, **k):
        int(state.cur_len)  # a host read: illegal while a stream captures
        return real(params, cfg, state, *a, **k)

    monkeypatch.setattr(step_graph, "realtime_prefill_step", host_read)
    engine = RealtimeEngine.random_init(seed=12, config=CFG, device="cuda", cache_len=128,
                                        max_length=32)
    grids, text = _load(1, seed=13)
    engine.prefill(grids, [t[:12] for t in text], **GREEDY)  # eager: the key's first use
    engine.reset_generation_state(keep_cache=False)
    with pytest.raises(RuntimeError):
        engine.prefill(grids, [t[:12] for t in text], **GREEDY)
    assert engine._prefills.counts["replay"] == 0 and not engine._prefills.keys
    torch.cuda.synchronize()
