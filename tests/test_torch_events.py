"""The port's event-driven decode (``delay_decode_until_event``) and the
prefill runner (``engine/step_graph.Prefills``) against the JAX package on
CPU: tiny config with n_vq=4, float32, the same weights through
``utils.convert``. Also the fixtures and helpers of the server's loops'
tests (``tests/test_torch_run_events.py``, ``tests/test_torch_drain.py``),
which mirror ``tests/test_batch_server.py:284-370``.

Tokens, states and step counts must be equal exactly: greedy requests equal
JAX's, and the port's seeded sampled requests with overrides equal its own
``run()`` (and JAX's: the draws are JAX's threefry bits,
``tests/test_torch_device_loops.py``). The loops read the stop flags after
every step, as JAX's ``while_loop``: on the CPU the host after each eager
step, on the card a condition kernel inside one graph launch
(``tests/test_torch_graphs_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.models import delay as jd
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.step_graph import DecodeSteps, Prefills, zero_state
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops import sampling as ts
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)
FIELDS = ("kv_valid", "cur_ids", "pos", "step", "is_stopping", "is_audio",
          "audio_lengths", "delayed", "seen", "out", "out_valid")
KW = dict(slots=2, out_capacity=64, prompt_bucket=32)
BUDGETS = [24, 9, 17, 31, 12]  # mixed: staggered budget events (test_batch_server.py:284)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its tiny eager steps are
    many small ops, which a thread pool only slows when the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stopper(params):
    """``params`` changed so that greedy text is ``<|im_end|>`` wherever the
    state machine lets it be sampled (every row stops early)."""
    p = jax.tree.map(lambda x: x, params)
    p["backbone"]["embed"] = p["backbone"]["embed"].at[:, 0].set(50.0)
    p["audio_emb"] = p["audio_emb"].at[..., 0].set(0.0)
    p["text_head"] = p["text_head"].at[0, :].set(0.0).at[0, CFG.im_end_token_id].set(200.0)
    return p


def numpy_params(cfg=CFG, seed=0):
    """``jd.init_delay_params``' tree for ``cfg`` (norms 1, every other leaf
    normal with std 0.02), drawn with numpy: JAX's own draws take ~9 s on
    one core."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith(("norm']", "ln1']", "ln2']")):
            return jnp.ones(x.shape, x.dtype)
        return jnp.asarray(rng.standard_normal(x.shape, np.float32) * np.float32(0.02))

    shapes = jax.eval_shape(lambda: jd.init_delay_params(jax.random.PRNGKey(0), cfg,
                                                         dtype=jnp.float32))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", autouse=True)
def fast_jax_compiles():
    """Most XLA optimizations off while this module runs: its JAX programs
    compile in about half the time on one core, and the reference's
    results stay what the cases compare (exact tokens and states)."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()  # the flag is not in JAX's cache keys (test_torch_train.jax_numerics)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    jp = numpy_params()
    tp = load_tree_(td.DelayParams(CFG), jax.device_get(jp))
    proc = DelayProcessor(ByteFallbackTokenizer(), None, CFG)
    return jp, tp, proc


def _grid(proc, text, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1024, (6, CFG.n_vq)).astype(np.int64)
    conv = [proc.build_user_message(text=text), proc.build_assistant_message([codes])]
    return proc([conv], mode="continuation")["input_ids"][0]


# one compile each for every case below (the weights are arguments)
_JAX_PREFILL = jax.jit(lambda p, ids, mask: jd.delay_prefill(
    p, CFG, ids, mask, max_new_tokens=64, cache_len=256, rng=jax.random.PRNGKey(0),
    sampling=jd.make_sampling(**GREEDY), dtype=jnp.float32))
_JAX_UNTIL_EVENT = jax.jit(lambda p, st, w, b, m: jd.delay_decode_until_event(
    p, CFG, st, jd.make_sampling(**GREEDY), w, b, m, attend_len=256))


# the JAX prefill of each set of weights, computed once for the module's cases
_JAX_PREFILLED = {}


def _prefilled(jp, tp, proc, cache_len=256, max_new=64, key=None):
    batch = proc([[proc.build_user_message(text=t)] for t in ("hi", "a longer prompt")],
                 mode="generation")
    ids, mask = batch["input_ids"], batch["attention_mask"]
    js = _JAX_PREFILLED.get(key)
    if js is None:
        js = _JAX_PREFILL(jp, jnp.asarray(ids), jnp.asarray(mask))
        if key is not None:
            _JAX_PREFILLED[key] = js
    tstate = td.delay_prefill(tp, CFG, torch.tensor(ids), torch.tensor(mask),
                              max_new_tokens=max_new, cache_len=cache_len,
                              rng=ts.row_keys(0, 2),
                              sampling=td.make_sampling(**GREEDY), dtype=torch.float32)
    return js, tstate


def _assert_states_equal(tstate, jstate):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), err_msg=f)


@pytest.mark.parametrize("weights,watch,budget,cap", [
    ("random", (True, True), (5, 9), 20),  # a budget event inside the cap
    ("random", (True, False), (30, 2), 7),  # the cap first; row 1's budget unwatched
    ("random", (False, False), (1, 1), 4),  # nothing watched: the cap
    ("stopper", (True, True), (60, 60), 40),  # an EOS event inside the cap
    ("stopper", (False, True), (60, 60), 40),  # the watched row's EOS only
], ids=["budget", "cap", "unwatched", "eos", "eos-row1"])
def test_decode_until_event_matches_jax(setup, weights, watch, budget, cap):
    jp, _, proc = setup
    if weights == "stopper":
        jp = _stopper(jp)
    tp = load_tree_(td.DelayParams(CFG), jax.device_get(jp))
    js, tstate = _prefilled(jp, tp, proc, key=weights)
    attend = 256
    js, ji = _JAX_UNTIL_EVENT(jp, js, jnp.asarray(watch), jnp.asarray(budget, jnp.int32),
                              jnp.int32(cap))
    steps = DecodeSteps(tp, CFG, tstate, td.make_sampling(**GREEDY))
    tstate, n, flags = td.delay_decode_until_event(steps, np.array(watch), np.array(budget),
                                                   cap, attend_len=attend)
    np.testing.assert_array_equal(flags, tstate.is_stopping.numpy())
    assert tstate is steps.state
    assert n == int(ji)
    _assert_states_equal(tstate, js)
    if weights == "stopper":
        assert 0 < n < cap  # the event came from a stop flag


def _serve(server, grids, run, overrides=None, seeds=None, max_steps=800):
    overrides = overrides or [None] * len(grids)
    seeds = seeds or [None] * len(grids)
    rids = [server.submit(g, max_new_tokens=n, sampling=o, seed=s)
            for g, n, o, s in zip(grids, BUDGETS, overrides, seeds)]
    done = {c.request_id: c for c in getattr(server, run)(max_steps=max_steps)}
    assert sorted(done) == sorted(rids)
    assert not server._active and not server._queue
    return [done[r] for r in rids]


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert (x.start_length, x.steps) == (y.start_length, y.steps)
        np.testing.assert_array_equal(y.tokens, x.tokens)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-kv", "int8-kv"])
def test_prefills_equal_delay_prefill(setup, kv_quant):
    """``Prefills.run`` (eager on the CPU, as with ``graphs=False`` on the
    card) leaves the static state, every field and the cache, equal to
    ``delay_prefill``'s, at its first, second and third use of a key; a
    wider static ``out`` is zero past the first frame; at most
    ``max_graphs`` keys are kept, the least recently used dropped, and
    without it (a server's) every key; ``counts`` tells the runs apart."""
    _, tp, proc = setup
    batch = proc([[proc.build_user_message(text=t)] for t in ("hi", "a longer prompt")],
                 mode="generation")
    ids, mask = torch.tensor(batch["input_ids"]), torch.tensor(batch["attention_mask"])
    samp = td.make_sampling(text_temperature=1.3, audio_temperature=1.1)
    cache_len = 256
    state = zero_state(CFG, 2, cache_len, 40, dtype=torch.float32, kv_quant=kv_quant,
                       device="cpu")
    prefills = Prefills(DecodeSteps(tp, CFG, state, samp), state, samp, max_graphs=2)
    for use in range(3):
        state.rng.copy_(ts.row_keys(use, 2))
        ref = td.delay_prefill(tp, CFG, ids, mask, max_new_tokens=40, cache_len=cache_len,
                               rng=ts.row_keys(use, 2), sampling=samp,
                               dtype=torch.float32, kv_quant=kv_quant)
        got = prefills.run(ids, mask, top_k_text=50, top_k_audio=25)
        assert got is state
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ref, f).numpy(),
                                          err_msg=f)
        for a, b in zip(got.cache, ref.cache):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert not got.out[:, 1:].any()
    for T in (4, 6):
        prefills.run(ids[:, -T:], mask[:, -T:], top_k_text=50, top_k_audio=25)
    assert [k[0] for k in prefills._prompts] == [4, 6] and not prefills.keys
    assert prefills.counts == dict(eager=5, capture=0, replay=0)  # no graphs on the CPU
    every = Prefills(prefills.steps, state, samp)
    for T in (4, 5, 6, 4):
        every.run(ids[:, -T:], mask[:, -T:], top_k_text=50, top_k_audio=25)
    assert [k[0] for k in every._prompts] == [5, 6, 4]
