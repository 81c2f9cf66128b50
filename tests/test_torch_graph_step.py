"""The port's decode programs (``engine/step_graph.py``, the engine's
``on_device`` segments, ``delay_generate_on_device``) against the JAX
package on CPU: tiny config with n_vq=4, float32, the same weights through
``utils.convert``, greedy decoding, so grids and states must be equal.

On the CPU the steps run eagerly over the static buffers (a CUDA graph is
the card's, ``tests/test_torch_graphs_cuda.py``); these tests pin what the
graphs replay: the segment loop and its stop condition, the copy of each
step's fields back into the static buffers, the rows' keys, capturable
sampling controls, and the launch-count arithmetic of a replay.

``stopper`` weights make every row emit ``<|im_end|>`` as soon as the state
machine allows it (one embedding dimension held large and positive, and the
text head reading it only into ``<|im_end|>``), so the early exit of the
loops runs too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.delay_engine import DelayEngine as JaxEngine
from mosstts_tpu.models import delay as jd
from mosstts_tpu.processing.delay_processor import DelayProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine, attend_bucket
from mosstts_tpu_torch.engine.step_graph import DecodeSteps, copy_state_
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops import sampling as ts
from mosstts_tpu_torch.ops.kernels import decode_attn, launches, w8_gemm
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)
FIELDS = ("kv_valid", "cur_ids", "pos", "step", "is_stopping", "is_audio",
          "audio_lengths", "delayed", "seen", "out", "out_valid")
BUCKET = 100  # attend buckets of 100, 200, 400 slots, capped: the runs below cross them


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
    state machine lets it be sampled."""
    p = jax.tree.map(lambda x: x, params)
    d0 = 0
    p["backbone"]["embed"] = p["backbone"]["embed"].at[:, d0].set(50.0)
    p["audio_emb"] = p["audio_emb"].at[..., d0].set(0.0)
    p["text_head"] = p["text_head"].at[d0, :].set(0.0).at[d0, CFG.im_end_token_id].set(200.0)
    return p


@pytest.fixture(scope="module", params=["random", "stopper"])
def engines(request):
    je = JaxEngine.random_init(seed=0, config=CFG, dtype=jnp.float32, cache_bucket=BUCKET)
    if request.param == "stopper":
        je.params = _stopper(je.params)
    te = DelayEngine(load_tree_(td.DelayParams(CFG), jax.device_get(je.params)), CFG,
                     dtype=torch.float32, cache_bucket=BUCKET)
    return request.param, je, te


@pytest.fixture(scope="module")
def proc():
    return DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=None, config=CFG)


def _batch(proc, mode):
    if mode == "generation":
        convs = [[proc.build_user_message(text="hi")],
                 [proc.build_user_message(text="a longer prompt for row two")]]
        batch = proc(convs, mode="generation")
        assert not batch["attention_mask"].all()  # left-padded
        return batch
    return proc([_conv(proc, i, n) for i, n in enumerate((7, 3))], mode="continuation")


def _conv(proc, i, n):
    """A continuation conversation whose assistant turn holds ``n`` frames of
    random audio codes."""
    codes = np.random.default_rng(i).integers(0, CFG.audio_vocab_size, (n, CFG.n_vq))
    return [proc.build_user_message(text=f"say {i}"), proc.build_assistant_message([codes])]


def _assert_grids_equal(a, b, n=None):
    assert len(a) == len(b)
    for (la, ga), (lb, gb) in zip(a, b):
        assert la == lb
        if n is not None:
            ga, gb = ga[:la + n], gb[:lb + n]
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("mode", ["generation", "continuation"])
def test_generate_on_device_matches_jax(engines, proc, mode):
    """``generate(on_device=True)`` equals JAX's, over 40 new frames that
    cross two attend buckets; ``on_device=False`` returns the same frames
    (and, where every row stopped, up to a poll's worth more after the
    stop)."""
    kind, je, te = engines
    batch = _batch(proc, mode)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    T = ids.shape[1]
    kw = dict(max_new_tokens=40, **GREEDY)
    cap = -(-(T + 41) // BUCKET) * BUCKET
    assert attend_bucket(T + 2, BUCKET, cap) < attend_bucket(T + 40, BUCKET, cap)
    jdev = je.generate(ids, mask, on_device=True, **kw)
    tdev = te.generate(ids, mask, on_device=True, **kw)
    _assert_grids_equal(jdev, tdev)
    thost = te.generate(ids, mask, on_device=False, **kw)
    frames = tdev[0][1].shape[0] - tdev[0][0]
    if kind == "stopper":
        assert frames < 40  # every row stopped early
        assert thost[0][1].shape[0] - thost[0][0] >= frames
        _assert_grids_equal(tdev, thost, n=frames)
        ends = [int(np.nonzero(g[s:, 0] == CFG.im_end_token_id)[0][0]) for s, g in tdev]
        assert max(ends) + 1 == frames  # the last row stopped at the last frame
    else:
        assert frames == 40
        _assert_grids_equal(tdev, thost)


def test_device_loop_stops_after_the_first_stop(proc):
    """``delay_generate_on_device`` (the card's graph loop, eager here)
    stops after the very step at which every row had stopped, or at
    ``max_new_tokens``: for every segment length its step count equals a
    host loop that checks JAX's ``while_loop`` condition after each single
    step, so no step runs past the stop."""
    je = JaxEngine.random_init(seed=0, config=CFG, dtype=jnp.float32, cache_bucket=BUCKET)
    params = load_tree_(td.DelayParams(CFG), jax.device_get(_stopper(je.params)))
    batch = _batch(proc, "continuation")
    ids, mask = torch.tensor(batch["input_ids"]), torch.tensor(batch["attention_mask"])
    samp = td.make_sampling(**GREEDY)
    cache_len = -(-(ids.shape[1] + 40) // 64) * 64
    stops = set()
    for max_new in range(2, 16):
        counts = []
        for loop in (True, False):
            state = td.delay_prefill(params, CFG, ids, mask, max_new_tokens=max_new,
                                     cache_len=cache_len, rng=ts.row_keys(0, 2),
                                     sampling=samp, dtype=torch.float32)
            steps = DecodeSteps(params, CFG, state, samp)
            if loop:
                _, n, flags = td.delay_generate_on_device(steps, max_new_tokens=max_new,
                                                          attend_len=cache_len,
                                                          uniform_slots=True)
                np.testing.assert_array_equal(flags, steps.state.is_stopping.numpy())
            else:
                n = 0
                while (int(steps.state.step.min()) < max_new
                       and not bool(steps.state.is_stopping.all())):
                    steps.step(attend_len=cache_len, uniform_slots=True, top_k_text=50,
                               top_k_audio=25)
                    n += 1
            counts.append(n)
        assert counts[0] == counts[1], f"max_new_tokens={max_new}: {counts}"
        stops.add(counts[0] + 1 < max_new)
    assert stops == {False, True}  # segments that end before and after the stop


def _prefilled(je, te, proc, max_new):
    """JAX's and the port's states after a greedy prefill of the
    continuation batch into a cache of the next multiple of 64 slots."""
    batch = _batch(proc, "continuation")
    ids, mask = batch["input_ids"], batch["attention_mask"]
    cache_len = -(-(ids.shape[1] + max_new + 1) // 64) * 64
    js = jd.delay_prefill(je.params, CFG, jnp.asarray(ids), jnp.asarray(mask),
                          max_new_tokens=max_new, cache_len=cache_len,
                          rng=jax.random.PRNGKey(0), sampling=jd.make_sampling(**GREEDY),
                          dtype=jnp.float32)
    tstate = td.delay_prefill(te.params, CFG, torch.tensor(ids), torch.tensor(mask),
                              max_new_tokens=max_new, cache_len=cache_len,
                              rng=ts.row_keys(0, ids.shape[0]),
                              sampling=td.make_sampling(**GREEDY), dtype=torch.float32)
    return js, tstate, cache_len


def _assert_states_equal(tstate, jstate):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)


def test_delay_generate_on_device_matches_jax(engines, proc):
    """On a prefilled state, the port's loop over ``DecodeSteps`` (static
    buffers; the card's graph path, eager here) returns JAX's
    ``lax.while_loop`` state and its step count."""
    kind, je, te = engines
    max_new = 24
    js, tstate, attend = _prefilled(je, te, proc, max_new)
    js = jd.delay_generate_on_device(je.params, CFG, js, jd.make_sampling(**GREEDY),
                                     max_new_tokens=max_new, attend_len=attend,
                                     uniform_slots=True)
    runner = DecodeSteps(te.params, CFG, tstate, td.make_sampling(**GREEDY))
    tstate, did, flags = td.delay_generate_on_device(runner, max_new_tokens=max_new,
                                                     attend_len=attend, uniform_slots=True)
    assert tstate is runner.state
    _assert_states_equal(tstate, js)
    np.testing.assert_array_equal(tstate.rng.numpy(), np.asarray(js.rng).astype(np.int64))
    steps = 1 + did  # the prefill's frame, then one a step
    assert steps == int(np.asarray(js.step).max())
    np.testing.assert_array_equal(flags, np.asarray(js.is_stopping))
    assert (steps < max_new) == (kind == "stopper")


def test_decode_steps_copy_back_keeps_the_buffers(engines, proc):
    """``DecodeSteps.step`` advances the static state in place: the same
    tensors and keys, the same values as rebinding
    ``delay_decode_step``'s result, and a state copied in by
    ``copy_state_`` into a wider ``out`` decodes to the same frames."""
    _, je, te = engines
    _, a, cache_len = _prefilled(je, te, proc, 16)
    _, b, _ = _prefilled(je, te, proc, 16)
    wide = b._replace(out=torch.full((2, 40, CFG.channels), 9, dtype=torch.int32),
                      out_valid=torch.ones((2, 40), dtype=torch.bool))
    copy_state_(wide, b)
    samp = td.make_sampling(**GREEDY)
    runner = DecodeSteps(te.params, CFG, wide, samp, graphs=True)  # CPU: eager
    assert not runner.graphs
    ids = {f: id(getattr(wide, f)) for f in FIELDS}
    for i in range(6):
        attend = cache_len - 64 if i < 3 else cache_len  # two graphs on the card
        a = td.delay_decode_step(te.params, CFG, a, samp, attend_len=attend, uniform_slots=True)
        runner.step(attend_len=attend, uniform_slots=True, top_k_text=50, top_k_audio=25)
    assert ids == {f: id(getattr(wide, f)) for f in FIELDS}
    for f in FIELDS:
        got = getattr(wide, f)
        if f in ("out", "out_valid"):
            assert not got[:, 16:].any()
            got = got[:, :16]
        np.testing.assert_array_equal(got.numpy(), getattr(a, f).numpy(), err_msg=f)


def test_prefill_into_a_used_cache_and_one_engine_state(engines, proc):
    """``delay_prefill(cache=...)`` zeroes and fills the cache it is given
    and returns the fresh prefill's state; the engine prefills into its
    static cache in place (no second cache) and keeps the decode state of
    its last ``(B, cache_len, kv_quant)`` only."""
    _, je, te = engines
    _, fresh, cache_len = _prefilled(je, te, proc, 16)
    used = td.init_kv_cache(CFG.language_config, 2, cache_len, dtype=torch.float32)
    for buf in used:
        buf.fill_(7.0)
    batch = _batch(proc, "continuation")
    args = (te.params, CFG, torch.tensor(batch["input_ids"]), torch.tensor(batch["attention_mask"]))
    kw = dict(max_new_tokens=16, cache_len=cache_len, sampling=td.make_sampling(**GREEDY),
              dtype=torch.float32)
    into = td.delay_prefill(*args, rng=ts.row_keys(0, 2), cache=used, **kw)
    assert into.cache is used
    _assert_states_equal(into, fresh)
    for a, b in zip(into.cache, fresh.cache):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="cache given"):
        td.delay_prefill(*args, rng=ts.row_keys(0, 2), cache=used,
                         **dict(kw, cache_len=cache_len + 64))

    ids, mask = batch["input_ids"], batch["attention_mask"]
    first = te.generate(ids, mask, max_new_tokens=8, **GREEDY)
    ((key, steps),) = te._steps.items()
    cache = steps.state.cache
    again = te.generate(ids, mask, max_new_tokens=8, **GREEDY)  # over the used cache
    assert te._steps == {key: steps} and steps.state.cache is cache
    _assert_grids_equal(first, again)
    te.generate(ids[:1], mask[:1], max_new_tokens=8, **GREEDY)
    assert list(te._steps) == [(1,) + key[1:]]


def test_quantize_drops_the_decode_steps(engines, proc):
    """``quantize()`` drops the static states (their graphs read the float
    weights), and a ``DecodeSteps`` built before it refuses to step."""
    _, je, _ = engines
    te = DelayEngine(load_tree_(td.DelayParams(CFG), jax.device_get(je.params)), CFG,
                     dtype=torch.float32, cache_bucket=BUCKET)
    batch = _batch(proc, "generation")
    te.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=4, **GREEDY)
    (old,) = te._steps.values()
    te.quantize()
    assert not te._steps
    with pytest.raises(RuntimeError, match="parameters were replaced"):
        old.step(attend_len=32, uniform_slots=True, top_k_text=50, top_k_audio=25)
    out = te.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=4, **GREEDY)
    assert out[0][1].shape[0] == out[0][0] + 4


def test_row_keys_are_jax_split_keys():
    """``row_keys(seed, B)`` are JAX's ``split(PRNGKey(seed), B)``, the
    keys JAX's prefill makes from one key; a key written into a row in
    place draws what the same key draws anywhere (a graph reads the
    state's keys where they are)."""
    for seed, B in ((0, 1), (11, 3), (2**31 - 1, 4)):
        np.testing.assert_array_equal(
            ts.row_keys(seed, B).numpy(),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), B)).astype(np.int64))
    logits = torch.tensor(np.random.default_rng(0).normal(size=(3, 40)), dtype=torch.float32)
    keys = ts.row_keys(5, 3)
    keys.copy_(ts.row_keys(2, 3))
    a = ts.sample_topk_topp(keys, logits, top_k=10, top_p=0.9, do_sample=True)
    b = ts.sample_topk_topp(ts.row_keys(2, 3), logits, top_k=10, top_p=0.9, do_sample=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("top_k", [0, 12])
def test_sampling_controls_as_numbers_or_tensors(top_k):
    """A sampling control given as a Python number (a device fill in the
    step) samples as the same control given as a tensor."""
    rng = np.random.default_rng(top_k)
    logits = torch.tensor(rng.normal(size=(4, 3, 64)), dtype=torch.float32)
    seen = torch.tensor(rng.random((4, 3, 64)) < 0.2)
    outs = []
    for p, pen, do in ((0.8, 1.3, True), (torch.tensor(0.8), torch.tensor(1.3),
                                         torch.tensor(True))):
        x = ts.apply_repetition_penalty_seen(logits, seen, pen)
        outs.append(ts.sample_topk_topp(ts.row_keys(1, 4), x, top_k=top_k,
                                        top_p=p, do_sample=do))
        outs.append(ts.apply_top_p(x, p))
    for a, b in zip(outs[:2], outs[2:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_replayed_launches_add_to_the_counts():
    """A capture's launches are taken back and added once per replay, to the
    wrapper's count and to ``IN_GRAPHS``."""
    saved = launches.read()
    try:
        launches.reset()
        decode_attn.LAUNCHES = 3  # an eager launch counted before the capture
        before = launches.read()
        decode_attn.LAUNCHES += 36  # what a capture's wrappers add
        w8_gemm.LAUNCHES_W8A16 += 254
        captured = launches.since(before)
        launches.restore(before)
        assert captured == {"decode": 36, "w8a16": 254}
        assert launches.read()["decode"] == 3 and launches.read()["w8a16"] == 0
        for _ in range(5):
            launches.add_replay(captured)
        assert decode_attn.LAUNCHES == 3 + 5 * 36 and w8_gemm.LAUNCHES_W8A16 == 5 * 254
        assert launches.IN_GRAPHS["decode"] == 180 and launches.IN_GRAPHS["w8a16"] == 1270
        assert launches.IN_GRAPHS["flash"] == 0
    finally:
        launches.restore(saved)


def test_server_keeps_its_static_buffers(engines, proc):
    """The server's state tensors, keys and sampling tensors are the
    same objects after admissions and decode steps (graphs replay over
    them); a seeded request reproduces in another slot."""
    _, je, te = engines
    grids = [proc([_conv(proc, i, 5)], mode="continuation")["input_ids"][0] for i in (0, 1)]
    srv = DelayBatchServer(te.params, CFG, slots=2, cache_len=256, out_capacity=32,
                           prompt_bucket=32, dtype=torch.float32)
    state, samp = srv.state, srv._samp_dev
    ids = [id(t) for t in state if isinstance(t, torch.Tensor)]
    hot = dict(audio_temperature=1.5, text_temperature=1.2)
    a = srv.submit(grids[0], max_new_tokens=12, sampling=hot, seed=5)
    srv.submit(grids[1], max_new_tokens=12)
    done = {c.request_id: c for c in srv.run()}
    assert srv.state is state and srv._samp_dev is samp
    assert ids == [id(t) for t in srv.state if isinstance(t, torch.Tensor)]
    srv.submit(grids[1], max_new_tokens=12)
    b = srv.submit(grids[0], max_new_tokens=12, sampling=hot, seed=5)  # now in slot 1
    again = {c.request_id: c for c in srv.run()}
    np.testing.assert_array_equal(again[b].tokens, done[a].tokens)
