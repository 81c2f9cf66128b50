"""The port's continuous-batching ``DelayBatchServer`` against the JAX
package's on CPU: tiny config (n_vq=4), f32, the same weights through
``utils.convert``, greedy decoding, so the token grids must be equal.
Mirrors ``tests/test_batch_server.py``: mid-flight admission into 2 slots,
the int8 cache, the paged pool (equal to linear over two waves that recycle
pages), recompute preemption, per-request sampling and seeds, the
pipelined ``run`` and the ``submit`` rejections.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.batch_server import DelayBatchServer as JaxServer
from mosstts_tpu.models.delay import init_delay_params
from mosstts_tpu.models.delay import make_sampling as jax_sampling
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import DelayParams, make_sampling
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
KW = dict(slots=2, cache_len=256, out_capacity=64, prompt_bucket=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tiny eager steps are
    many small ops, which a thread pool only slows when the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jp = init_delay_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    tp = load_tree_(DelayParams(CFG), jax.device_get(jp))
    proc = DelayProcessor(ByteFallbackTokenizer(), None, CFG)
    return jp, tp, proc


def _grid(proc, text, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1024, (6, CFG.n_vq)).astype(np.int64)
    conv = [proc.build_user_message(text=text), proc.build_assistant_message([codes])]
    return proc([conv], mode="continuation")["input_ids"][0]


def _servers(jp, tp, **kw):
    kw = {**KW, **kw}
    js = JaxServer(jp, CFG, dtype=jnp.float32,
                   sampling=jax_sampling(text_temperature=0.0, audio_temperature=0.0), **kw)
    ts = DelayBatchServer(tp, CFG, dtype=torch.float32,
                          sampling=make_sampling(text_temperature=0.0, audio_temperature=0.0),
                          **kw)
    return js, ts


def _serve(server, grids, budgets, **run_kw):
    rids = [server.submit(g, max_new_tokens=n) for g, n in zip(grids, budgets)]
    done = {c.request_id: c for c in server.run(**run_kw)}
    assert sorted(done) == sorted(rids)
    return [done[r] for r in rids]


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert (x.start_length, x.steps) == (y.start_length, y.steps)
        np.testing.assert_array_equal(y.tokens, x.tokens)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_admission_mid_flight_matches_jax_server(setup, kv_quant):
    """4 requests into 2 slots: two are admitted mid-flight. Grids equal
    the JAX server's and, for the bf16/f32 cache, the port's solo engine."""
    jp, tp, proc = setup
    grids = [_grid(proc, f"text number {i}", seed=i) for i in range(4)]
    js, ts = _servers(jp, tp, kv_quant=kv_quant)
    jout = _serve(js, grids, [20] * 4, max_steps=500)
    tout = _serve(ts, grids, [20] * 4, max_steps=500)
    _assert_same(jout, tout)
    assert ts.utilization == 0.0 and ts.total_steps == js.total_steps
    if kv_quant:
        return
    engine = DelayEngine(tp, CFG, dtype=torch.float32, cache_bucket=32)
    for grid, got in zip(grids, tout):
        solo = engine.generate(grid[None], np.ones((1, grid.shape[0]), bool), max_new_tokens=20,
                               text_temperature=0.0, audio_temperature=0.0)[0]
        assert got.start_length == solo[0]
        n = min(len(got.tokens), len(solo[1]))
        np.testing.assert_array_equal(got.tokens[:n], solo[1][:n])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_matches_linear_over_two_waves(setup, kv_quant):
    """The page pool (smaller than the linear footprint) relocates storage
    only; the second wave reuses freed pages."""
    _, tp, proc = setup
    kw = dict(KW, dtype=torch.float32, kv_quant=kv_quant,
              sampling=make_sampling(text_temperature=0.0, audio_temperature=0.0))
    lin = DelayBatchServer(tp, CFG, **kw)
    pgd = DelayBatchServer(tp, CFG, paged=True, page_size=64, **kw)
    assert pgd.num_pages < 1 + 2 * (256 // 64)
    grids = [_grid(proc, f"paged wave {i}", seed=40 + i) for i in range(5)]
    for wave in (grids[:3], grids[3:]):
        _assert_same(_serve(lin, wave, [24] * len(wave), max_steps=500),
                     _serve(pgd, wave, [24] * len(wave), max_steps=500))
    assert len(pgd._free_pages) == pgd.num_pages - 1
    assert not bool(pgd.state.cache.table.any())  # idle rows point at the trash page


def test_paged_preemption_matches_jax(setup):
    """A pool of 14 pages of 32 slots admits both 6-page prompts but cannot
    grow both to 8 pages: one stream is preempted and recomputed. Every
    request completes, with the JAX server's grids and preemption count."""
    jp, tp, proc = setup
    js, ts = _servers(jp, tp, paged=True, page_size=32, num_pages=1 + 14)
    grids = [_grid(proc, f"preempt me {i}", seed=60 + i) for i in range(2)]
    jout = _serve(js, grids, [48, 48], max_steps=2000)
    tout = _serve(ts, grids, [48, 48], max_steps=2000)
    _assert_same(jout, tout)
    assert ts.total_preemptions == js.total_preemptions >= 1
    assert len(ts._free_pages) == ts.num_pages - 1


def test_per_request_sampling_and_seeds(setup):
    """A greedy tenant beside a sampled one equals the solo greedy engine;
    a seeded sampled request gives the same tokens in another slot and in
    another server."""
    _, tp, proc = setup
    g0, g1 = _grid(proc, "greedy tenant", seed=41), _grid(proc, "hot tenant", seed=42)
    hot = dict(audio_temperature=2.0, audio_top_p=0.95, text_temperature=1.5,
               audio_repetition_penalty=1.3)

    def serve(first_is_filler):
        srv = DelayBatchServer(tp, CFG, dtype=torch.float32, **KW,
                               sampling=make_sampling(text_temperature=0.0,
                                                      audio_temperature=0.0))
        reqs = [(g0, None, None), (g1, hot, 7)]
        if first_is_filler:
            reqs = reqs[::-1]  # the seeded request lands in slot 0, not 1
        rids = [srv.submit(g, max_new_tokens=16, sampling=s, seed=sd) for g, s, sd in reqs]
        done = {c.request_id: c for c in srv.run(max_steps=400)}
        by_grid = dict(zip(("greedy", "hot") if not first_is_filler else ("hot", "greedy"),
                           (done[r] for r in rids)))
        return by_grid

    a, b = serve(False), serve(True)
    np.testing.assert_array_equal(a["hot"].tokens, b["hot"].tokens)
    solo = DelayEngine(tp, CFG, dtype=torch.float32, cache_bucket=32).generate(
        g0[None], np.ones((1, g0.shape[0]), bool), max_new_tokens=16, text_temperature=0.0,
        audio_temperature=0.0)[0]
    for got in (a["greedy"], b["greedy"]):
        n = min(len(got.tokens), len(solo[1]))
        np.testing.assert_array_equal(got.tokens[:n], solo[1][:n])


def test_preempted_request_keeps_its_sampling_and_seed(setup):
    """Recompute preemption requeues the request with its own overrides and
    seed, so it resumes as it was submitted, not at the server's defaults."""
    _, tp, proc = setup
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, paged=True, page_size=32, **KW)
    hot = dict(audio_temperature=2.0, text_temperature=1.5)
    rid = srv.submit(_grid(proc, "preempted tenant", seed=43), max_new_tokens=16,
                     sampling=hot, seed=7)
    srv.step_block(2)
    srv._preempt(0)
    req = srv._queue[0]
    assert (req.request_id, req.sampling, req.seed) == (rid, hot, 7)
    assert srv.total_preemptions == 1 and not srv._active
    done = srv.run(max_steps=200)
    assert [c.request_id for c in done] == [rid]


def test_pipelined_run_matches_sequential(setup):
    """``run()`` reads the stop flags one block late; the tokens of every
    request equal ``run(pipelined=False)``'s, and a slot freed and readmitted
    inside the lag does not inherit the old occupant's flag."""
    _, tp, proc = setup
    grids = [_grid(proc, f"pipelined {i}", seed=40 + i) for i in range(5)]
    budgets = [8, 12, 7, 10, 9]

    def serve(pipelined):
        srv = DelayBatchServer(tp, CFG, dtype=torch.float32, poll_every=3, **KW,
                               sampling=make_sampling(text_temperature=0.0,
                                                      audio_temperature=0.0))
        return _serve(srv, grids, budgets, max_steps=500, pipelined=pipelined)

    for a, b in zip(serve(False), serve(True)):
        n = min(len(a.tokens), len(b.tokens))
        np.testing.assert_array_equal(a.tokens[:n], b.tokens[:n])


def test_submit_rejections(setup):
    _, tp, proc = setup
    grid = _grid(proc, "overflow check", seed=99)
    srv = DelayBatchServer(tp, CFG, dtype=torch.float32, **KW)
    with pytest.raises(ValueError, match="unknown sampling"):
        srv.submit(grid, sampling={"temperature": 1.0})
    with pytest.raises(ValueError, match="exceeds cache_len"):
        srv.submit(np.tile(grid, (256 // grid.shape[0] + 1, 1)), max_new_tokens=64)
    paged = DelayBatchServer(tp, CFG, dtype=torch.float32, paged=True, page_size=32,
                             num_pages=1 + 4, **KW)
    with pytest.raises(ValueError, match="pages but the pool has"):
        paged.submit(grid, max_new_tokens=64)
    assert not srv._queue and not paged._queue
