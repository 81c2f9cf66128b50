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
same generator states. On the float32 model the card's greedy frames equal
the CPU's.

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
