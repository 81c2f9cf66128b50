"""The port's ``LocalEngine`` against the JAX package's on the CPU: the tiny
config of ``tests/test_torch_local.py``, float32 and int8 weights, the same
weights through ``utils.convert``; greedy grids equal exactly.

The cases of JAX ``tests/test_local_model.py``: greedy generation (the
start length, the ``audio_start`` row), variable bitrate
(``n_vq_for_inference=2`` zero-fills channels 3-4) and int8 weights; then
the port's own: a second call reuses the static state and its frames, a
streamer sees every frame's text token, seeds s1, s2, s1 give equal,
different, equal sampled grids, and the prefill programs are kept per
prompt length and bitrate, at most ``PREFILL_GRAPHS`` of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.local_engine import LocalEngine as JEngine
from mosstts_tpu.ops import quant as jquant
from mosstts_tpu.processing.local_processor import LocalProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.engine.local_engine import LocalEngine
from test_torch_local import (CFG, GREEDY, NVQ, TCFG, fast_jax_compiles,  # noqa: F401
                              numpy_params, one_thread, port_params, prompt)


@pytest.fixture(scope="module")
def jp():
    return numpy_params(seed=5)


def _engines(jp, int8=False):
    if int8:
        jp = jquant.quantize_tree(jp)
    return (JEngine(jp, CFG, dtype=jnp.float32, cache_bucket=32),
            LocalEngine(port_params(jp, quantized=int8), TCFG, dtype=torch.float32,
                        device="cpu", cache_bucket=32))


def _same(a, b):
    assert len(a) == len(b)
    for (s1, g1), (s2, g2) in zip(a, b):
        assert s1 == s2
        np.testing.assert_array_equal(g2, g1)


def test_generate_and_variable_bitrate_match_jax(jp):
    je, te = _engines(jp)
    jproc = JProcessor(ByteFallbackTokenizer(), audio_tokenizer=None, config=CFG)
    batch = jproc([[jproc.build_user_message(text="hi")],
                   [jproc.build_user_message(text="a second, longer prompt")]],
                  mode="generation")
    for n in (None, 2):
        want = je.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=10,
                           n_vq_for_inference=n, **GREEDY)
        got = te.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=10,
                          n_vq_for_inference=n, **GREEDY)
        _same(want, got)
        start, ids = got[0]
        assert start == 0 and ids[0, 0] == CFG.audio_start_token_id
        if n == 2:
            assert (ids[1:, 3:] == 0).all()  # reference :425-427
    assert te._steps is not None and te._steps.keys == ()  # the CPU runs no graphs


def test_int8_generate_matches_jax(jp):
    je, te = _engines(jp, int8=True)
    ids, mask = prompt(seed=11)
    kw = dict(max_new_tokens=8, eos_token_id=CFG.audio_end_token_id, **GREEDY)
    _same(je.generate(ids, mask, **kw), te.generate(ids, mask, **kw))
    assert te.params.text_head.q.dtype == torch.int8


class _Streamer:
    def __init__(self):
        self.puts, self.ended = [], False

    def put(self, x):
        self.puts.append(np.asarray(x))

    def end(self):
        self.ended = True


def test_static_state_streamer_and_seeds(jp):
    """The port's own: a second call at the same shape reuses the static
    state; a streamer receives each frame's text tokens; sampled grids
    follow their seed (s1, s2, s1)."""
    _, te = _engines(jp)
    ids, mask = prompt(seed=12)
    st = _Streamer()
    out = te.generate(ids, mask, max_new_tokens=6, streamer=st, **GREEDY)
    steps = te._steps
    assert st.ended and len(st.puts) == 6
    np.testing.assert_array_equal(np.stack(st.puts, 1), np.stack([g[-6:, 0] for _, g in out]))
    layers = [{"temperature": 1.0, "top_p": 0.9}] + [{"temperature": 1.0, "top_k": 20}] * NVQ
    runs = [te.generate(ids, mask, max_new_tokens=6, layers=layers, seed=s) for s in (1, 2, 1)]
    assert te._steps is steps
    _same(runs[0], runs[2])
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(runs[0], runs[1]))


def test_prefill_programs_per_length_and_their_bound(jp, monkeypatch):
    """A prefill program per (prompt length, n_vq_for_inference): prompts
    of 9 and 12 rows, the 9-row one again, give JAX's grids through two
    programs, the second 9-row call through the first's key; lengths are not
    bucketed, so the engine keeps only its ``PREFILL_GRAPHS`` most recent
    keys (here 2), the least recently used dropped first."""
    from mosstts_tpu_torch.engine import local_engine

    monkeypatch.setattr(local_engine, "PREFILL_GRAPHS", 2)
    je, te = _engines(jp)
    kw = dict(max_new_tokens=4, **GREEDY)
    for T, seed in ((9, 13), (12, 14), (9, 13)):
        ids, mask = prompt(T=T, seed=seed)
        _same(je.generate(ids, mask, **kw), te.generate(ids, mask, **kw))
    prefills = te._prefills
    assert list(prefills._prompts) == [(12, NVQ), (9, NVQ)]
    assert prefills.counts == dict(eager=3, capture=0, replay=0)  # no graphs on the CPU
    te.generate(*prompt(T=10, seed=15), n_vq_for_inference=2, **kw)
    assert list(prefills._prompts) == [(9, NVQ), (10, 2)] and te._prefills is prefills
