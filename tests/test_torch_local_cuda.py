"""The Local frames as CUDA graphs against the same frames run eagerly, on
the card; they skip without one (CUDA graphs and the kernels have no CPU
mode; ``tests/test_torch_local*.py`` hold the eager frames against JAX on
the CPU).

A small model whose heads the kernels take (a 2-layer backbone of width
512, a 2-layer depth transformer of width 256, 4 query and 2 KV heads of
128, 8 codebooks) generates the same grids with ``graphs=True`` and
``graphs=False``: the engine at B = 1 and 8, greedy and sampled, in bf16
and then on int8 weights, and the continuous-batching server through
``run`` and ``run_events``. Grids must be equal bit for bit: a graph replays
the eager frame's kernels on the same inputs and draws from the same
keys. The decode kernel is held against its plain version over
the depth transformer's 33-slot cache at MossTTSLocal 1.7B's dims (attend
1, 17 and 33). On the float32 model the card's greedy grids equal the
CPU's, solo and through the server. The engine's prefills and the server's
admissions are graphs too (first use eager, second captured, then
replayed; the server's captured by ``warmup``): the static state after
each equals the eager one's, and a warm one launches flash and W8A16 only
inside its graph.

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_local_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.core.config import LocalConfig, tiny_qwen3
from mosstts_tpu_torch.engine.local_batch_server import LocalBatchServer
from mosstts_tpu_torch.engine.local_engine import LocalEngine
from mosstts_tpu_torch.models.local import init_local_params
from mosstts_tpu_torch.ops.kernels import decode_attn, launches

CFG = LocalConfig(
    language_config=tiny_qwen3(hidden_size=512, intermediate_size=1024, num_attention_heads=4,
                               num_key_value_heads=2, head_dim=128),
    n_vq=8, additional_mlp_ffn_hidden_size=512, local_ffn_hidden_size=512,
    local_hidden_size=256, local_num_layers=2)
GREEDY = dict(do_samples=[False] * CFG.channels)
SAMPLED = dict(layers=[{"temperature": 1.0, "top_p": 0.9}]
               + [{"temperature": 1.0, "top_k": 25, "repetition_penalty": 1.2}] * CFG.n_vq)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _prompts(B, T=20, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(100, 1000, (B, T, CFG.channels))
    ids[..., 1:] = rng.integers(0, 1024, (B, T, CFG.n_vq))
    ids[:, 4, 0] = CFG.audio_start_token_id
    mask = np.ones((B, T), bool)
    for b in range(B):
        mask[b, :b % 5] = False
    return ids, mask


def _runs(engine, B):
    ids, mask = _prompts(B)
    return ([engine.generate(ids, mask, max_new_tokens=20, **GREEDY)]
            + [engine.generate(ids, mask, max_new_tokens=12, seed=s, **SAMPLED)
               for s in (1, 2, 1)]
            + [engine.generate(ids, mask, max_new_tokens=8, n_vq_for_inference=3, **GREEDY)])


def _cut_ok(out, n) -> bool:
    """Frames (B, F, C) of an ``n_vq_for_inference=n`` run: channels past n
    are 0 up to a row's first EOS frame, the pad code after it."""
    eos = out[:, :, 0] == CFG.audio_end_token_id
    after = (np.cumsum(eos, axis=1) - eos) > 0
    tail = out[:, :, 1 + n:]
    return bool(np.where(after[..., None], tail == CFG.audio_pad_code, tail == 0).all())


def _same(a, b) -> bool:
    return all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_engine_frame_graphs_match_eager_bf16_then_int8(B):
    """Greedy, sampled (seeds s1, s2, s1) and cut-bitrate grids: the graph
    engine's equal the eager engine's bit for bit, in bf16 and after
    ``quantize()``; decode and W8A16 ran inside replayed graphs."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_local_params(CFG, generator=gen, dtype=torch.bfloat16, device="cuda")
    graph = LocalEngine(params, CFG, dtype=torch.bfloat16, cache_bucket=64)
    for label in ("bf16", "int8"):
        if label == "int8":
            graph.quantize()
        eager = LocalEngine(params, CFG, dtype=torch.bfloat16, cache_bucket=64, graphs=False)
        launches.reset()
        g = _runs(graph, B)
        counts = launches.read()
        e = _runs(eager, B)
        assert all(_same(x, y) for x, y in zip(g, e)), label
        assert _same(g[1], g[3]) and not _same(g[1], g[2]), label
        assert _cut_ok(graph._steps.state.out[:, :8].cpu().numpy(), 3), label
        assert launches.IN_GRAPHS["decode"] > 0 and counts["decode"] > 0, label
        if label == "int8":
            assert launches.IN_GRAPHS["w8a16"] > 0, counts
        assert graph._steps.keys, label


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("attend", [1, 17, 33])
def test_decode_kernel_over_the_depth_cache(B, attend):
    """The depth transformer's (4, B, 8, 33, 128) cache at 1.7B's 16 query
    heads, slots 0..attend-1 valid (depth step attend-1): the kernel against
    its plain version, within two bf16 ulps."""
    _need_card()
    rng = np.random.default_rng(attend + B)

    def g(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda().bfloat16()

    q, kc, vc = g(B, 16, 128), g(4, B, 8, 33, 128), g(4, B, 8, 33, 128)
    valid = (torch.arange(33, device="cuda") < attend)[None].expand(B, 33)
    for layer in (0, 3):
        out = decode_attn.decode_attention(q, kc, vc, valid, layer, scale=128 ** -0.5,
                                           attend_len=attend)
        ref = decode_attn.decode_attention_ref(q, kc, vc, valid, layer, scale=128 ** -0.5,
                                               attend_len=attend)
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 2 * 2.0 ** -7 * ref.float().abs() + 1e-5).all()), float(err.max())


def _server_runs(params, graphs, dtype):
    rng = np.random.default_rng(3)
    grids = []
    for T in (9, 14, 20, 30, 12):
        g = rng.integers(100, 1000, (T, CFG.channels))
        g[..., 1:] = rng.integers(0, 1024, (T, CFG.n_vq))
        g[2, 0] = CFG.audio_start_token_id
        grids.append(g)
    out = []
    for run in ("run", "run_events"):
        server = LocalBatchServer(params, CFG, slots=2, cache_len=256, out_capacity=32,
                                  prompt_bucket=32, dtype=dtype, graphs=graphs, **GREEDY)
        rids = [server.submit(g, max_new_tokens=n) for g, n in zip(grids, (12, 20, 9, 15, 11))]
        done = {c.request_id: c for c in getattr(server, run)()}
        out.append([(done[r].start_length, done[r].tokens) for r in rids])
    return out


@pytest.mark.cuda
def test_server_graphs_match_eager_and_f32_card_matches_cpu():
    """The 2-slot server through ``run`` and ``run_events``: graph frames
    equal eager frames in bf16; on the float32 model the card's greedy
    grids equal the CPU's, the solo engine's and the server's."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_local_params(CFG, generator=gen, dtype=torch.bfloat16, device="cuda")
    g, e = _server_runs(params, True, torch.bfloat16), _server_runs(params, False, torch.bfloat16)
    for a, b in zip(g, e):
        assert _same(a, b)
    cpu = init_local_params(CFG, generator=torch.Generator().manual_seed(2), dtype=torch.float32,
                            device="cpu")
    card = copy.deepcopy(cpu).cuda()
    ids, mask = _prompts(3, seed=4)
    solo = [LocalEngine(p, CFG, dtype=torch.float32, cache_bucket=64).generate(
        ids, mask, max_new_tokens=16, **GREEDY) for p in (cpu, card)]
    assert _same(*solo)
    served = [_server_runs(p, True, torch.float32) for p in (cpu, card)]
    for a, b in zip(*served):
        assert _same(a, b)


def _assert_same_state(a, b):
    """Every tensor of two ``LocalGenState``s (both caches and the keys too)
    equal bit for bit."""
    ta = list(a.cache) + list(a.depth) + [t for t in a[1:] if isinstance(t, torch.Tensor)]
    tb = list(b.cache) + list(b.depth) + [t for t in b[1:] if isinstance(t, torch.Tensor)]
    for x, y in zip(ta, tb, strict=True):
        assert torch.equal(x, y)


def _only_replayed(*names):
    got = launches.read()
    for name in names:
        assert got[name] == launches.IN_GRAPHS[name] > 0, (name, got, launches.IN_GRAPHS)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_engine_prefill_graphs_match_eager(weights):
    """Prefills (``max_new_tokens=1``: the prefill and one frame) at B = 3,
    sampled with seeds s1, s2, s1: the first use of the key runs eagerly,
    the second captures, the third replays; after each the static state
    equals the eager engine's, and the replay launches flash (and W8A16)
    only inside graphs. Then a whole sampled generation equals eager's."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = init_local_params(CFG, generator=gen, dtype=torch.bfloat16, device="cuda")
    if weights == "int8":
        LocalEngine(params, CFG).quantize()
    engines = [LocalEngine(params, CFG, dtype=torch.bfloat16, cache_bucket=64, graphs=g)
               for g in (True, False)]
    ids, mask = _prompts(3, seed=6)
    for i, seed in enumerate((1, 2, 1)):
        launches.reset()
        outs = []
        for e in engines:
            outs.append(e.generate(ids, mask, max_new_tokens=1, seed=seed, **SAMPLED))
            if i == 2 and e.graphs:
                _only_replayed("flash", *(("w8a16",) if weights == "int8" else ()))
        assert _same(*outs)
        _assert_same_state(engines[0]._steps.state, engines[1]._steps.state)
    assert engines[0]._prefills.counts == dict(eager=1, capture=1, replay=1)
    assert engines[0]._prefills.keys == ((ids.shape[1], CFG.n_vq),)
    runs = [e.generate(ids, mask, max_new_tokens=16, seed=3, **SAMPLED) for e in engines]
    assert _same(*runs)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_server_admission_graphs_match_eager(weights):
    """A 2-slot server warmed up at prompt buckets 32 and 64 (their
    admission graphs captured) admits sampled requests of both buckets: each
    admission replays its bucket's graph (flash and W8A16 launched only in
    graphs) into the static batch-1 state, which equals the eager server's
    after each, as the running state does; the grids then equal too. Two
    requests of bucket 96, which ``warmup()`` did not name, admit eagerly
    (flash launched outside any graph), the second too: nothing is
    captured mid-serve."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = init_local_params(CFG, generator=gen, dtype=torch.bfloat16, device="cuda")
    if weights == "int8":
        LocalEngine(params, CFG).quantize()
    servers = [LocalBatchServer(params, CFG, slots=2, cache_len=256, out_capacity=32,
                                prompt_bucket=32, dtype=torch.bfloat16, graphs=g, **SAMPLED)
               for g in (True, False)]
    for s in servers:
        s.warmup(prompt_lens=(32, 64), attend_upto=128)
    assert sorted(k[0] for k in servers[0]._prefills.keys) == [32, 64]
    rng = np.random.default_rng(8)
    grids = []
    for T in (20, 40, 30, 50, 70, 80):
        g = rng.integers(100, 1000, (T, CFG.channels))
        g[..., 1:] = rng.integers(0, 1024, (T, CFG.n_vq))
        g[2, 0] = CFG.audio_start_token_id
        grids.append(g)
    done = [{}, {}]
    for slot, grid in enumerate(grids):
        launches.reset()
        for s, d in zip(servers, done):
            if slot % 2 == 0 and slot:  # two slots: let the last two requests end
                d.update({c.request_id: c for c in s.run()})
            s.submit(grid, max_new_tokens=10 + slot)
            s._admit(slot % 2, s._queue.pop(0))
            if s is servers[0] and slot < 4:
                _only_replayed("flash", *(("w8a16",) if weights == "int8" else ()))
            elif s is servers[0]:
                assert launches.read()["flash"] > launches.IN_GRAPHS["flash"]
        _assert_same_state(servers[0]._small, servers[1]._small)
        _assert_same_state(servers[0].state, servers[1].state)
    for s, d in zip(servers, done):
        d.update({c.request_id: c for c in s.run()})
    assert sorted(done[0]) == sorted(done[1]) and len(done[0]) == 6
    for r in done[0]:
        a, b = done[0][r], done[1][r]
        assert a.start_length == b.start_length and a.steps == b.steps
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert sorted(k[0] for k in servers[0]._prefills.keys) == [32, 64]
    assert servers[0]._prefills.counts == dict(eager=4, capture=0, replay=4)
