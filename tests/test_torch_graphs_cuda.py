"""The decode steps as CUDA graphs against the same steps run eagerly, on the
card; they skip without one (CUDA graphs have no CPU mode; the CPU half,
``tests/test_torch_graph_step.py``, holds the eager steps against JAX).

A small bf16 model (2 layers, width 256, 4 query and 2 KV heads of 64,
n_vq=4; the kernels take it as they take the 8B model) decodes the same
prompts twice, with ``graphs=True`` and ``graphs=False``: the solo engine in
both ``on_device`` modes, greedy and sampled with the seeds s1, s2, s1, on
bf16 and then int8 weights, and the continuous-batching server in all four
cache modes with seeded sampled requests, mid-flight admissions and (paged)
preemption. Token grids must be equal bit for bit: a graph replays the
eager step's kernels on the same inputs and draws from the same keys. Each graph's captured kernel launches, counted once per replay,
must match ``ops.kernels.launches.IN_GRAPHS``. Weights that stop every
row early hold ``on_device=True``'s device loop (one graph launch a
segment, the condition read on the card after every step) against the
polling ``on_device=False``. A ``device_profile`` session must see
the first kernels launched in it. bf16 ``dense`` must not depend on cuBLAS's
reduced-precision flag. Prefill graphs (the engine's, first use eager,
second captured, then replayed; the server's admissions through the
bucket graphs ``warmup`` captures) leave every field of the static state,
the cache and the keys equal to eager prefills';
``run_events`` and ``run_drain`` serve ``run()``'s completions (a request
stopped at ``<|im_end|>`` up to that frame: the loops see a stop at other
steps). An engine with ``hidden_out_layers`` (float and int8 heads) gives
the eager engine's grids through its graphs, and the CPU port's greedy
grids on a float32 model. A multi-token forward with per-row cursors runs
on the card (the plain attention, as JAX's einsum path) and equals the
CPU, eagerly and inside a graph.

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_graphs_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import make_sampling
from mosstts_tpu_torch.ops.basic import dense
from mosstts_tpu_torch.ops.kernels import launches
from mosstts_tpu_torch.ops.quant import quantize_weight

CFG = DelayConfig(language_config=tiny_qwen3(hidden_size=256, intermediate_size=512,
                                             num_attention_heads=4, num_key_value_heads=2,
                                             head_dim=64), n_vq=4)
L = CFG.language_config.num_hidden_layers
SEEDS = (11, 12, 11)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")


def _grids(n, seed, lo=40, hi=70):
    """Random prompt grids ending in the gen-slot token (audio starts at
    once), as the server's load in ``chip_smoke.py``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = rng.integers(0, 1000, (int(rng.integers(lo, hi)), CFG.channels))
        g[:, 1:] = rng.integers(0, 1024, g[:, 1:].shape)
        g[-1, 0] = CFG.audio_assistant_gen_slot_token_id
        out.append(g)
    return out


def _left_padded(grids):
    T = max(len(g) for g in grids)
    ids = np.full((len(grids), T, CFG.channels), CFG.audio_pad_code, np.int64)
    ids[..., 0] = CFG.pad_token_id
    mask = np.zeros((len(grids), T), bool)
    for b, g in enumerate(grids):
        ids[b, T - len(g):], mask[b, T - len(g):] = g, True
    return ids, mask


@pytest.fixture(scope="module")
def engines():
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = DelayEngine.random_init(seed=0, config=CFG, dtype=torch.bfloat16, device="cuda",
                                    cache_bucket=64)
    eager = DelayEngine(graph.params, CFG, dtype=torch.bfloat16, cache_bucket=64, graphs=False)
    return graph, eager


def _generate_both(graph, eager, batch, **kw):
    a = graph.generate(*batch, **kw)
    b = eager.generate(*batch, **kw)
    for (sa, ga), (sb, gb) in zip(a, b):
        assert sa == sb
        np.testing.assert_array_equal(ga, gb)
    return a


def _solo_cases(graph, eager, kv_quant=False):
    graph.kv_quant = eager.kv_quant = kv_quant
    for B in (1, 4):
        batch = _left_padded(_grids(B, seed=B))
        for on_device in (False, True):
            kw = dict(max_new_tokens=90, on_device=on_device)  # crosses the 64-slot bucket
            _generate_both(graph, eager, batch, text_temperature=0.0, audio_temperature=0.0,
                           **kw)
            runs = [_generate_both(graph, eager, batch, seed=s, text_temperature=1.5,
                                   audio_temperature=1.7, **kw) for s in SEEDS]
            for (_, g1), (_, g3) in zip(runs[0], runs[2]):
                np.testing.assert_array_equal(g1, g3)  # s1 again: the reseed took effect
            assert any(not np.array_equal(g1, g2) for (_, g1), (_, g2) in zip(runs[0], runs[1]))


@pytest.mark.cuda
def test_engine_graphs_match_eager_bf16_then_int8(engines):
    graph, eager = engines
    launches.reset()
    _solo_cases(graph, eager)
    _solo_cases(graph, eager, kv_quant=True)
    counts = dict(launches.IN_GRAPHS)
    assert counts["decode"] > 0 and counts["decode_q8"] > 0, counts
    assert counts["decode"] % L == 0 and counts["decode_q8"] % L == 0
    graph.quantize()
    eager = DelayEngine(graph.params, CFG, dtype=torch.bfloat16, cache_bucket=64, graphs=False)
    launches.reset()
    _solo_cases(graph, eager)
    w8 = launches.IN_GRAPHS["w8a16"]
    assert w8 > 0 and w8 % (7 * L + 2) == 0 and launches.IN_GRAPHS["w8a16_bytes"] == 0


@pytest.mark.cuda
def test_replayed_launches_match_the_captures(engines):
    """Decode steps replayed k times at one attend bucket: each kernel's
    count inside graphs grows by its launches per step times k (one decode
    attention per layer), and its total count by the same."""
    graph, _ = engines
    graph.kv_quant = False
    batch = _left_padded(_grids(2, seed=5))
    graph.generate(*batch, max_new_tokens=8, text_temperature=0.0, audio_temperature=0.0)
    (steps,) = [s for k, s in graph._steps.items() if k[0] == 2 and not k[2]]
    key = steps.keys[0]
    captured = steps._captured[key][1]
    assert captured.get("decode") == L
    before, inside = launches.read(), dict(launches.IN_GRAPHS)
    k = 7
    for _ in range(k):
        steps.step(attend_len=key[0], uniform_slots=key[1], top_k_text=key[2],
                   top_k_audio=key[3])
    torch.cuda.synchronize()
    for name, n in captured.items():
        assert launches.read()[name] - before[name] == k * n
        assert launches.IN_GRAPHS[name] - inside[name] == k * n


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_early_stop_on_device_matches_polling(weights):
    """Weights that make every row emit ``<|im_end|>`` as soon as the state
    machine allows it (as ``stopper`` in ``tests/test_torch_graph_step.py``):
    ``on_device=True``, a loop graph whose condition kernel reads the stop
    flags after every step, returns the frames of the polling
    ``on_device=False`` up to its own count, and that count is the last
    row's ``<|im_end|>`` frame + 1: no step past the stop."""
    _need_card()
    engine = DelayEngine.random_init(seed=3, config=CFG, dtype=torch.bfloat16, device="cuda",
                                     cache_bucket=64)
    p = engine.params
    with torch.no_grad():
        p.backbone.embed[:, 0] = 50.0
        p.audio_emb[..., 0] = 0.0
        p.text_head[0, :] = 0.0
        p.text_head[0, CFG.im_end_token_id] = 200.0
    if weights == "int8":
        engine.quantize()
    batch = _left_padded(_grids(4, seed=21))
    for kw in (dict(text_temperature=0.0, audio_temperature=0.0),
               dict(seed=11, text_temperature=1.5, audio_temperature=1.7)):
        dev = engine.generate(*batch, max_new_tokens=90, on_device=True, **kw)
        host = engine.generate(*batch, max_new_tokens=90, on_device=False, **kw)
        frames = dev[0][1].shape[0] - dev[0][0]
        assert frames < 90  # every row stopped early
        ends = [int(np.nonzero(g[s:, 0] == CFG.im_end_token_id)[0][0]) for s, g in dev]
        assert max(ends) + 1 == frames
        assert host[0][1].shape[0] - host[0][0] >= frames
        for (sa, ga), (sb, gb) in zip(dev, host):
            assert sa == sb
            np.testing.assert_array_equal(ga[:sa + frames], gb[:sb + frames])


@pytest.mark.cuda
def test_device_profile_sees_the_first_kernel():
    """Every ``profile_step.device_profile`` session sees every kernel
    launched in it, the first ones included: a plain ``torch.profiler``
    session that follows much work in the process can lose the records of
    its first kernels (``tools/profiler_sessions.py``)."""
    _need_card()
    from mosstts_tpu_torch.ops.kernels import w8_gemm
    from mosstts_tpu_torch.ops.quant import quantize_weight
    from mosstts_tpu_torch.tools.profile_step import device_profile

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((16, 1024), generator=g, device="cuda").bfloat16()
    w = quantize_weight(torch.randn((1024, 4096), generator=g, device="cuda"))
    w8_gemm.w8a16_gemm(x, w.q, w.scale)
    torch.cuda.synchronize()
    seen = []
    for _ in range(6):
        with device_profile() as prof:
            x.neg()
            for _ in range(3):
                w8_gemm.w8a16_gemm(x, w.q, w.scale)
            torch.cuda.synchronize()
        keys = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        seen.append((sum(c for k, c in keys.items() if "neg_kernel" in k),
                     sum(c for k, c in keys.items() if "ring_kernel" in k)))
    assert seen == [(1, 3)] * 6, seen


SERVER_MODES = [dict(), dict(kv_quant=True), dict(paged=True), dict(paged=True, kv_quant=True)]


def _serve(params, graphs, mode, grids, budgets):
    srv = DelayBatchServer(params, CFG, slots=4, cache_len=512, out_capacity=96,
                           prompt_bucket=32, page_size=64, dtype=torch.bfloat16, graphs=graphs,
                           num_pages=9 if mode.get("paged") else None,
                           sampling=make_sampling(text_temperature=1.5, audio_temperature=1.7,
                                                  audio_top_p=0.8, device="cuda"), **mode)
    srv.warmup(prompt_lens=(64,), attend_upto=256)
    for i, (g, n) in enumerate(zip(grids, budgets)):
        srv.submit(g, max_new_tokens=n, seed=100 + i,
                   sampling=dict(text_temperature=0.0, audio_temperature=0.0) if i % 3 == 0
                   else None)
    done = sorted(srv.run(), key=lambda c: c.request_id)
    return done, srv.total_preemptions


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SERVER_MODES, ids=["linear", "linear-q8", "paged", "paged-q8"])
def test_server_graphs_match_eager(mode):
    """10 requests into 4 slots (6 admitted mid-flight), a third greedy and
    the rest sampled with their own seeds; in paged mode a pool of 8
    pages forces preemptions. Completions equal the eager server's."""
    _need_card()
    params = DelayEngine.random_init(seed=1, config=CFG, dtype=torch.bfloat16,
                                     device="cuda").params
    grids = _grids(10, seed=7)
    budgets = [int(x) for x in np.random.default_rng(8).integers(50, 90, 10)]
    launches.reset()
    got, pre = _serve(params, True, mode, grids, budgets)
    kernel = ("paged" if mode.get("paged") else "decode") + ("_q8" if mode.get("kv_quant") else "")
    assert launches.IN_GRAPHS[kernel] > 0 and launches.IN_GRAPHS[kernel] % L == 0
    ref, pre_ref = _serve(params, False, mode, grids, budgets)
    assert pre == pre_ref and (pre > 0) == bool(mode.get("paged"))
    assert [c.request_id for c in got] == [c.request_id for c in ref]
    for a, b in zip(got, ref):
        assert (a.start_length, a.steps) == (b.start_length, b.steps)
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [SERVER_MODES[0], SERVER_MODES[3]], ids=["linear", "paged-q8"])
def test_server_graphs_match_eager_int8_weights(mode):
    _need_card()
    engine = DelayEngine.random_init(seed=2, config=CFG, dtype=torch.bfloat16, device="cuda")
    engine.quantize()
    grids = _grids(6, seed=9)
    budgets = [60] * 6
    launches.reset()
    got, _ = _serve(engine.params, True, mode, grids, budgets)
    assert launches.IN_GRAPHS["w8a16"] > 0 and launches.IN_GRAPHS["w8a16_bytes"] == 0
    ref, _ = _serve(engine.params, False, mode, grids, budgets)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 48])
@pytest.mark.parametrize("K,N", [(4096, 1024), (12288, 4096), (4096, 12288)])
def test_bf16_dense_ignores_the_reduced_precision_flag(M, K, N):
    """bf16 ``dense`` gives the same bits whatever
    ``allow_bf16_reduced_precision_reduction`` says, and agrees with the
    float32 product of the same bf16 inputs within one rounding to bf16 (two
    ulps at the product's magnitude) plus the worst-case error of a float32
    sum of K terms in another order (K * 2^-24 of the sum of the terms'
    magnitudes)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x = torch.randn((2, M, K), generator=g, device="cuda").bfloat16()
    w = (torch.randn((K, N), generator=g, device="cuda") * 0.02).bfloat16()
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    try:
        outs = []
        for allow in (True, False):
            flags.allow_bf16_reduced_precision_reduction = allow
            outs.append(dense(x, w))
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
    assert outs[0].dtype == torch.bfloat16 and outs[0].shape == (2, M, N)
    assert torch.equal(outs[0], outs[1])
    ref = x.float() @ w.float()
    absref = x.float().abs() @ w.float().abs()
    err = (outs[0].float() - ref).abs()
    assert bool((err <= 2 * 2.0 ** -7 * ref.abs() + K * 2.0 ** -24 * absref).all()), \
        float(err.max())


def _state_on_host(state):
    """Every tensor of a ``DelayGenState`` (the cache's and the keys too) on
    the host."""
    return [t.cpu() for t in state.cache] + [t.cpu() for t in state[1:]
                                             if isinstance(t, torch.Tensor)]


def _assert_same_state(a, b):
    ta, tb = _state_on_host(a), _state_on_host(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-kv", "int8-kv"])
def test_prefill_graphs_match_eager(kv_quant):
    """The engine's prefill at B = 1 and 3, greedy and seeded sampled: the
    first use of a key runs eagerly, the second captures and replays, the
    third replays; each leaves every field of the static state, its cache
    and its keys equal to the eager engine's.
    Flash runs once per layer of each prefill, inside the replayed graph
    from the second on."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = DelayEngine.random_init(seed=6, config=CFG, dtype=torch.bfloat16, device="cuda",
                                    cache_bucket=64, kv_quant=kv_quant)
    eager = DelayEngine(graph.params, CFG, dtype=torch.bfloat16, cache_bucket=64,
                        kv_quant=kv_quant, graphs=False)
    calls = [dict(text_temperature=0.0, audio_temperature=0.0)] + [
        dict(seed=s, text_temperature=1.5, audio_temperature=1.7) for s in SEEDS]
    for B in (1, 3):
        batch = _left_padded(_grids(B, seed=30 + B))
        for i, kw in enumerate(calls):
            launches.reset()
            _generate_both(graph, eager, batch, max_new_tokens=1, **kw)  # the prefill alone
            torch.cuda.synchronize()
            assert launches.IN_GRAPHS["flash"] == (L if i else 0)
            assert launches.read()["flash"] == 2 * L  # the eager engine's too
            (prefills,) = graph._prefills.values()
            assert len(prefills.keys) == (1 if i else 0)
            _assert_same_state(*[next(iter(e._steps.values())).state for e in (graph, eager)])


@pytest.mark.cuda
def test_admission_prefill_graphs_match_eager():
    """The server's admissions through the prefill graph of their bucket
    (captured by ``warmup``) against eager admissions: the static batch-1
    state, its key after the replay, and the slot's row and key after the
    splice are equal; so are the sampled,
    seeded completions after the splice."""
    _need_card()
    params = DelayEngine.random_init(seed=5, config=CFG, dtype=torch.bfloat16,
                                     device="cuda").params
    grids = _grids(3, seed=12, lo=33, hi=64)  # one prompt bucket, 64
    servers = []
    for graphs in (True, False):
        srv = DelayBatchServer(params, CFG, slots=3, cache_len=512, out_capacity=64,
                               prompt_bucket=32, dtype=torch.bfloat16, graphs=graphs,
                               sampling=make_sampling(text_temperature=1.5,
                                                      audio_temperature=1.7, device="cuda"))
        srv.warmup(prompt_lens=(64,), attend_upto=256)
        assert [k[0] for k in srv._prefills.keys] == ([64] if graphs else [])
        servers.append(srv)
    for slot, g in enumerate(grids):
        launches.reset()
        for srv in servers:
            srv.submit(g, max_new_tokens=40, seed=20 + slot)
            assert srv._admit(slot, srv._queue.pop(0))
        torch.cuda.synchronize()
        assert launches.IN_GRAPHS["flash"] == L
        _assert_same_state(servers[0]._small, servers[1]._small)
        _assert_same_state(servers[0].state, servers[1].state)
    done = [sorted(srv.run(), key=lambda c: c.request_id) for srv in servers]
    for a, b in zip(*done):
        assert a.steps == b.steps
        np.testing.assert_array_equal(a.tokens, b.tokens)


ADMIT_MODES = [{}, dict(kv_quant=True), dict(paged=True, page_size=64),
               dict(paged=True, page_size=64, kv_quant=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ADMIT_MODES, ids=["linear", "linear-q8", "paged", "paged-q8"])
def test_warm_admissions_splice_inside_their_graph(mode):
    """A warm admission (its bucket's graph captured by ``warmup``) is one
    replay of the bucket's admission graph, prefill and splice: the row
    copy runs once inside it and never eagerly, slots 2, 0 and 1 replay the
    same graph (no capture), and the running state, pages and table
    included, equals an eager server's after each; so do the completions."""
    _need_card()
    params = DelayEngine.random_init(seed=5, config=CFG, dtype=torch.bfloat16,
                                     device="cuda").params
    grids = _grids(3, seed=12, lo=33, hi=64)  # one prompt bucket, 64
    servers = []
    for graphs in (True, False):
        srv = DelayBatchServer(params, CFG, slots=3, cache_len=512, out_capacity=64,
                               prompt_bucket=32, dtype=torch.bfloat16, graphs=graphs,
                               sampling=make_sampling(text_temperature=1.5,
                                                      audio_temperature=1.7, device="cuda"),
                               **mode)
        srv.warmup(prompt_lens=(64,), attend_upto=256)
        servers.append(srv)
    counts = dict(servers[0]._prefills.counts)
    for slot in (2, 0, 1):
        launches.reset()
        for srv in servers:
            srv.submit(grids[slot], max_new_tokens=40, seed=20 + slot)
            assert srv._admit(slot, srv._queue.pop(0))
        torch.cuda.synchronize()
        # the graph server's splice inside its replay; the eager server's one launch
        assert launches.IN_GRAPHS["row_copy"] == 1 and launches.read()["row_copy"] == 2
        _assert_same_state(servers[0].state, servers[1].state)
    runs = {k: v - counts[k] for k, v in servers[0]._prefills.counts.items()}
    assert runs == dict(eager=0, capture=0, replay=3)
    done = [sorted(srv.run(), key=lambda c: c.request_id) for srv in servers]
    for a, b in zip(*done):
        assert a.steps == b.steps
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
def test_row_copy_kernel_drops_out_of_range_rows():
    """The Realtime splice's row copy (``rt_splice_parts``: kb = 4 rows of a
    128-slot admission state into a 256-slot server state, one padding row
    at index ``slots``) on the card == its plain version on the CPU, bit
    for bit: the padding row is dropped and the other slots keep theirs."""
    _need_card()
    from mosstts_tpu_torch.engine.realtime_batch_server import rt_splice_parts
    from mosstts_tpu_torch.models.realtime import RealtimeState
    from mosstts_tpu_torch.nn.qwen3 import KVCache
    from mosstts_tpu_torch.ops.kernels import graph_loop

    g = torch.Generator().manual_seed(4)

    def state(B, S, scalar):
        r = lambda *shape: torch.randint(0, 1000, shape, generator=g, dtype=torch.int32)
        b = lambda *shape: torch.rand(shape, generator=g) < 0.5
        cur = r(1)[0] if scalar else r(B)
        return RealtimeState(
            cache=KVCache(*[torch.randn((2, B, 2, S, 64), generator=g).bfloat16()
                            for _ in range(2)]),
            kv_valid=b(B, S), cur_len=cur, last_audio=r(B, 4), is_stopping=b(B),
            history=r(B, 8, 4), hist_len=cur + 1, rng=r(B, 2).long())

    big, small = state(5, 256, False), state(4, 128, True)
    rows = torch.tensor([4, 0, 2, 5], dtype=torch.int32)
    card = [RealtimeState(*[type(x)(*[t.cuda() for t in x]) if isinstance(x, tuple) else x.cuda()
                            for x in st]) for st in (big, small)]
    graph_loop.RowCopy(rt_splice_parts(big, small, 4), rows)()
    graph_loop.RowCopy(rt_splice_parts(card[0], card[1], 4), rows.cuda())()
    torch.cuda.synchronize()
    for want, got in zip(list(big.cache) + list(big[1:]), list(card[0].cache) + list(card[0][1:])):
        assert torch.equal(got.cpu(), want)


def _same_completions(got, ref):
    """Equal completions; a request that stopped at ``<|im_end|>`` may hold
    frames past it that differ in number (the loops see a stop at other
    times), so it is held equal up to that frame."""
    assert [c.request_id for c in got] == [c.request_id for c in ref]
    for a, b in zip(got, ref):
        ends = [np.nonzero(c.tokens[c.start_length:, 0] == CFG.im_end_token_id)[0]
                for c in (a, b)]
        if not len(ends[0]) and not len(ends[1]):
            assert a.steps == b.steps
            np.testing.assert_array_equal(a.tokens, b.tokens)
            continue
        assert len(ends[0]) and len(ends[1]) and ends[0][0] == ends[1][0]
        n = a.start_length + ends[0][0] + 1
        np.testing.assert_array_equal(a.tokens[:n], b.tokens[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [SERVER_MODES[0], SERVER_MODES[3]], ids=["linear", "paged-q8"])
def test_events_and_drain_match_run(mode):
    """``run_events`` and (linear) ``run_drain`` against ``run()`` on the
    card, graph replays throughout: 10 requests into 4 slots with mixed
    budgets, a third greedy and the rest sampled with their own seeds and
    overrides; the loops' decode steps run inside replayed graphs."""
    _need_card()
    params = DelayEngine.random_init(seed=1, config=CFG, dtype=torch.bfloat16,
                                     device="cuda").params
    grids = _grids(10, seed=7)
    budgets = [int(x) for x in np.random.default_rng(8).integers(20, 60, 10)]
    runs = ["run", "run_events"] + ([] if mode.get("paged") else ["run_drain"])
    out = {}
    for run in runs:
        srv = DelayBatchServer(params, CFG, slots=4, cache_len=512, out_capacity=96,
                               prompt_bucket=32, page_size=64, dtype=torch.bfloat16,
                               sampling=make_sampling(text_temperature=1.5,
                                                      audio_temperature=1.7, device="cuda"),
                               **mode)
        srv.warmup(prompt_lens=(64,), attend_upto=256)
        srv.total_steps = 0  # the warm-up's own steps are not this loop's
        for i, (g, n) in enumerate(zip(grids, budgets)):
            srv.submit(g, max_new_tokens=n, seed=100 + i,
                       sampling=dict(text_temperature=0.0, audio_temperature=0.0) if i % 3 == 0
                       else dict(audio_top_p=0.7))
        launches.reset()
        out[run] = sorted(getattr(srv, run)(), key=lambda c: c.request_id)
        torch.cuda.synchronize()
        kernel = ("paged" if mode.get("paged") else "decode") + (
            "_q8" if mode.get("kv_quant") else "")
        assert launches.IN_GRAPHS[kernel] >= L * srv.total_steps
        assert not srv._active and not srv._queue
    for run in runs[1:]:
        _same_completions(out[run], out["run"])


HOL = (1, -1, 0, 2, -2)  # hidden_out_layers: the text head from layer 1, the audio heads mixed


@pytest.mark.cuda
@pytest.mark.parametrize("heads", ["float", "int8"])
def test_hidden_out_layers_graphs_match_eager_and_cpu(heads):
    """An engine with ``hidden_out_layers``: on the small bf16 model the graph
    engine's grids equal the eager engine's bit for bit (B = 1 and 4, both
    ``on_device`` modes, greedy and seeds s1, s2, s1), with float heads or
    int8 weights (``quantize()``: the int8 audio heads' per-head product),
    and its decode and prefill graphs are keyed on the layers. On the small
    float32 model the card's greedy grids equal the CPU port's, with float
    audio heads or int8 ones (only the heads quantized: W8A16 takes bf16
    activations, the per-head product any)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = DelayEngine.random_init(seed=4, config=CFG, dtype=torch.bfloat16, device="cuda",
                                    cache_bucket=64, hidden_out_layers=HOL)
    if heads == "int8":
        graph.quantize()
    eager = DelayEngine(graph.params, CFG, dtype=torch.bfloat16, cache_bucket=64,
                        hidden_out_layers=HOL, graphs=False)
    launches.reset()
    _solo_cases(graph, eager)
    ((steps, prefills),) = zip(graph._steps.values(), graph._prefills.values())
    assert steps.keys and all(k[-1] == HOL for k in steps.keys)
    assert prefills.keys and all(k[-1] == HOL for k in prefills.keys)
    assert launches.IN_GRAPHS["decode"] > 0 and launches.IN_GRAPHS["flash"] > 0
    if heads == "int8":
        assert launches.IN_GRAPHS["w8a16"] > 0

    cpu = DelayEngine.random_init(seed=5, config=CFG, dtype=torch.float32, device="cpu",
                                  cache_bucket=64, hidden_out_layers=HOL)
    if heads == "int8":
        w = cpu.params.audio_heads
        delattr(cpu.params, "audio_heads")
        cpu.params.audio_heads = quantize_weight(w)
    card = DelayEngine(copy.deepcopy(cpu.params).to("cuda"), CFG, dtype=torch.float32,
                       device="cuda", cache_bucket=64, hidden_out_layers=HOL)
    batch = _left_padded(_grids(2, seed=44))
    kw = dict(max_new_tokens=24, text_temperature=0.0, audio_temperature=0.0)
    ref = cpu.generate(*batch, **kw)
    for on_device in (False, True):
        got = card.generate(*batch, on_device=on_device, **kw)
        for (la, ga), (lb, gb) in zip(ref, got):
            assert la == lb
            np.testing.assert_array_equal(gb, ga)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_multi_token_forward_with_row_cursors_equals_the_cpu(dtype):
    """A T = 5 forward with (B,) cursors (each row's block at its own slot,
    one row's past the capacity dropped) runs on the card, on the plain
    attention (no kernel takes one q_start per row; JAX takes its einsum
    path), and equals the CPU: float32 within 1e-5 (no TF32), bf16 the
    CPU's bf16 within two bf16 ulps; inside a CUDA graph too."""
    _need_card()
    from mosstts_tpu_torch.nn import qwen3

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = CFG.language_config
    gen = torch.Generator().manual_seed(21)
    params = qwen3.init_qwen3_params(cfg, generator=gen, dtype=torch.float32, with_embed=False)
    B, T, S, D = 3, 5, 64, cfg.hidden_size
    rng = np.random.default_rng(22)
    off = torch.tensor([4, 30, 61], dtype=torch.int32)
    kv_valid = torch.zeros((B, S), dtype=torch.bool)
    for b in range(B):
        kv_valid[b, 1:min(int(off[b]) + T, S)] = True
    pos = off[:, None] + torch.arange(T, dtype=torch.int32)[None]
    x = torch.tensor(rng.normal(size=(B, T, D)).astype(np.float32))
    k0 = torch.tensor(rng.normal(size=(L, B, cfg.num_key_value_heads, S,
                                       cfg.head_dim)).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = copy.deepcopy(params).to(device=dev, dtype=dtype)
        cache = qwen3.KVCache(k0.to(dev, dtype), (0.5 * k0).to(dev, dtype))
        args = dict(positions=pos.to(dev), kv_valid=kv_valid.to(dev), cache=cache,
                    cache_offset=off.to(dev))
        h, _ = qwen3.qwen3_forward(p, cfg, x.to(dev, dtype), **args)
        outs[dev] = (h.float().cpu(), cache.k.float().cpu(), cache.v.float().cpu())
        if dev == "cuda":  # the same forward captured and replayed
            xs = x.to(dev, dtype)
            graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                qwen3.qwen3_forward(p, cfg, xs, **args)
            torch.cuda.current_stream().wait_stream(stream)
            with torch.cuda.graph(graph):
                hg, _ = qwen3.qwen3_forward(p, cfg, xs, **args)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(hg.float().cpu(), outs["cuda"][0])
    rows = pos < S
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a, b = (a[rows], b[rows]) if a.ndim == 3 else (a, b)
        assert bool(((a - b).abs() <= tol * b.abs() + tol).all()), float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 50), (16, 50), (16, 32, 25), (3, 151669)],
                         ids=["text-1", "text-16", "audio-16", "vocab"])
def test_threefry_kernels_match_plain(shape):
    """The key split and the fused categorical equal their plain versions
    (``ops.sampling``) bit for bit at the samplers' shapes, one launch
    each."""
    _need_card()
    from mosstts_tpu_torch.ops import sampling
    from mosstts_tpu_torch.ops.kernels import threefry

    keys = sampling.row_keys(shape[0] + 3, shape[0]).cuda()
    logits = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(4),
                         device="cuda") * 3
    n0, c0 = threefry.LAUNCHES_SPLIT, threefry.LAUNCHES_CATEGORICAL
    assert torch.equal(threefry.split(keys, 3).cpu(), sampling.split(keys.cpu(), 3))
    got = threefry.categorical(keys, logits)
    assert (threefry.LAUNCHES_SPLIT - n0, threefry.LAUNCHES_CATEGORICAL - c0) == (1, 1)
    assert torch.equal(got, sampling.categorical_plain(keys, logits))
    # a view of a split's key rows, as the steps pass them
    ks = threefry.split(keys, 3)
    assert torch.equal(threefry.categorical(ks[:, 1], logits),
                       sampling.categorical_plain(ks[:, 1].contiguous(), logits))


@pytest.mark.cuda
def test_loop_condition_kernel_matches_plain():
    """The condition kernel (in a one-node graph) equals its plain version
    for every loop kind, over cases that hold and cases that end."""
    _need_card()
    from mosstts_tpu_torch.ops.kernels import graph_loop as gl

    def t(x, dt=torch.int32):
        return torch.tensor(x, dtype=dt, device="cuda")

    cases = [
        (gl.GENERATE, 0, 5, dict(flags=t([1, 0], torch.bool), step=t([5, 1]))),
        (gl.GENERATE, 0, 5, dict(flags=t([1, 1], torch.bool), step=t([1, 1]))),
        (gl.GENERATE, 0, 5, dict(flags=t([0, 0], torch.bool), step=t([5, 6]))),
        (gl.EVENT, 3, 8, dict(flags=t([0, 0], torch.bool), watch=t([1, 1]), budget=t([3, 5]))),
        (gl.EVENT, 3, 8, dict(flags=t([0, 0], torch.bool), watch=t([0, 1]), budget=t([3, 5]))),
        (gl.EVENT, 2, 8, dict(flags=t([1, 0], torch.bool), invert=True, watch=t([1, 1]),
                              budget=t([9, 9]))),
        (gl.BLOCK, 3, 4, {}), (gl.BLOCK, 4, 4, {}),
        (gl.DRAIN, 5, 99, dict(active=t([1, 0], torch.bool), pos=t([100, 0]), attend=256)),
        (gl.DRAIN, 5, 99, dict(active=t([1, 0], torch.bool), pos=t([256, 0]), attend=256)),
        (gl.DRAIN, 5, 99, dict(active=t([0, 0], torch.bool), pos=t([100, 0]), attend=256)),
    ]
    for kind, i, limit, kw in cases:
        ctrl = t([i, limit, 0, 3, 3, 0, 0, 0])
        ctrl_plain = dict(qi=3, qn=3) if kind == gl.DRAIN else {}
        want = gl.loop_cond_plain(kind, i, limit, **{
            k: (v.bool() if k == "watch" else v) for k, v in kw.items()}, **ctrl_plain)
        args = gl.cond_args(kind, ctrl, **kw)
        gl.loop_cond(args, False, "cuda")
        assert bool(ctrl[gl.COND]) is want and int(ctrl[gl.I]) == i, (kind, i, kw)


def _f32_pair(seed):
    cpu = DelayEngine.random_init(seed=seed, config=CFG, dtype=torch.float32, device="cpu",
                                  cache_bucket=64)
    card = DelayEngine(copy.deepcopy(cpu.params).cuda(), CFG, dtype=torch.float32,
                       cache_bucket=64)
    return cpu, card


@pytest.mark.cuda
def test_device_loops_equal_the_cpu_f32():
    """On the float32 model (no TF32) the card's loops equal the CPU's eager
    loops: ``generate(on_device=True)`` greedy and seeded (each attend
    segment one loop-graph launch), and the 2-slot server's ``run_events``
    and ``run_drain`` with seeded sampled requests (each event block and
    each drain segment one launch): the same grids, step counts and
    completions, no frame past an EOS."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _f32_pair(9)
    batch = _left_padded(_grids(2, seed=41))
    for kw in (dict(text_temperature=0.0, audio_temperature=0.0), dict(seed=11)):
        want = cpu.generate(*batch, max_new_tokens=80, on_device=True, **kw)
        got = card.generate(*batch, max_new_tokens=80, on_device=True, **kw)
        for (sa, ga), (sb, gb) in zip(got, want):
            assert sa == sb
            np.testing.assert_array_equal(ga, gb)
    (steps,) = card._steps.values()
    assert steps._loop is not None and steps._loop.launches >= 2
    grids = _grids(5, seed=43)
    budgets = [24, 9, 17, 31, 12]
    for run in ("run_events", "run_drain"):
        out = []
        for params in (cpu.params, card.params):
            srv = DelayBatchServer(params, CFG, slots=2, cache_len=256, out_capacity=64,
                                   prompt_bucket=32, dtype=torch.float32)
            rids = [srv.submit(g, max_new_tokens=n, seed=50 + i,
                               sampling=dict(text_temperature=0.0) if i % 2 else None)
                    for i, (g, n) in enumerate(zip(grids, budgets))]
            done = {c.request_id: c for c in getattr(srv, run)()}
            out.append([done[r] for r in rids])
            if params is card.params:
                loops = (srv._steps._loop.launches if run == "run_events"
                         else sum(d.launches for d in srv._drains.values()))
                assert loops == srv.total_dispatches
        for a, b in zip(*out):
            assert (a.start_length, a.steps) == (b.start_length, b.steps)
            np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
def test_run_drain_twice_across_attend_buckets_equals_the_cpu():
    """Two ``run_drain`` calls on one float32 server whose segments cross
    from attend 256 to 512: the second call replays the first's drain
    graphs, the one at 256 after the one at 512 was built (each graph sets
    its own admission handles), and each call's completions equal the CPU's
    server's, frame for frame and step for step."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _f32_pair(10)
    servers = [DelayBatchServer(p, CFG, slots=2, cache_len=512, out_capacity=96,
                                prompt_bucket=32, dtype=torch.float32)
               for p in (cpu.params, card.params)]
    for call in range(2):
        # prompts in the 224 bucket: admitted at 224, so a row that lives
        # 31 steps takes the drain from attend 256 to 512
        grids = _grids(4, seed=60 + call, lo=200, hi=224)
        budgets = [80, 40, 90, 60]
        out = []
        for srv in servers:
            rids = [srv.submit(g, max_new_tokens=n, seed=70 + 10 * call + i,
                               sampling=dict(text_temperature=0.0) if i % 2 else None)
                    for i, (g, n) in enumerate(zip(grids, budgets))]
            done = {c.request_id: c for c in srv.run_drain()}
            out.append([done[r] for r in rids])
        (drain,) = servers[1]._drains.values()
        assert sorted(drain._execs) == [256, 512] and drain.launches >= 2 * (call + 1)
        for a, b in zip(*out):
            assert (a.start_length, a.steps) == (b.start_length, b.steps)
            np.testing.assert_array_equal(a.tokens, b.tokens)
