"""The port's ``RealtimeEngine`` against the JAX package's on the CPU: the
tiny config of ``tests/test_realtime.py`` (RVQ 4, head_dim 16), float32, the
same weights through ``utils.convert``, greedy frames equal exactly.

A ``generate``, then one conversation of two turns on the kept cache that
outgrows ``cache_len`` (128) while it steps: the engine grows the cache
toward ``max_context``, and the port then holds a new state (the old cache
in its head) with new decode steps over it. Every prompt is one prefill
bucket and attend bucket, so the JAX engine compiles three programs in
all (its prefill, its step, and its step over the grown cache). Two turns
of one length then run one prefill program, the second at a nonzero
cursor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine.realtime_engine import RealtimeEngine as JEngine
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine
from test_torch_realtime import (CFG, GREEDY, TCFG, _turn, fast_jax_compiles,  # noqa: F401
                                 numpy_params, one_thread, port_params, proc)

KW = dict(max_length=64, cache_len=128, max_context=512, prefill_bucket=16)


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine over the same weights, shared by the tests
    (the JAX engine keeps its compiled programs)."""
    jp = numpy_params()
    return (JEngine(jp, CFG, dtype=jnp.float32, **KW),
            RealtimeEngine(port_params(jp), TCFG, dtype=torch.float32, device="cpu", **KW))


def test_generate_matches_jax(engines, proc):
    """The non-streaming path: text fed one token per frame, frames trimmed
    at EOS; a second call reuses the port's static state and decode
    steps."""
    je, te = engines
    grid, text = [_turn(proc, "turn one", 1)], [proc.tokenizer.encode("reply one two")]
    want = je.generate(grid, text, max_length=10, prefill_text_len=4, **GREEDY)
    got = te.generate(grid, text, max_length=10, prefill_text_len=4, **GREEDY)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(got[0], want[0])
    steps = te._steps
    np.testing.assert_array_equal(
        te.generate(grid, text, max_length=10, prefill_text_len=4, **GREEDY)[0], want[0])
    assert te._steps is steps


def _conversation(engine, proc, grown: list):
    """Turn one, a second turn on the kept cache, then steps past the
    cache's end; ``grown`` gets the decode steps object before the growth."""
    engine.reset_generation_state(keep_cache=False)
    out = [engine.prefill([_turn(proc, "turn one", 1)],
                          [proc.tokenizer.encode("reply one")[:4]], **GREEDY)]
    out += engine.step_block([[t] for t in proc.tokenizer.encode("ply")], **GREEDY)
    engine.reset_generation_state(keep_cache=True)
    out.append(engine.prefill([_turn(proc, "turn two", 1)],
                              [proc.tokenizer.encode("reply two")[:4]], **GREEDY))
    cur = int(np.asarray(engine.state.cur_len))
    grown.append(getattr(engine, "_steps", None))
    # step_async steps whatever the fetched frames say: the cursor passes 128
    handles = [engine.step_async(None, **GREEDY) for _ in range(130 - cur)]
    out += engine.fetch_frames(handles)
    return out, cur, int(np.asarray(engine.state.cur_len))


def test_second_turn_and_cache_growth_match_jax(engines, proc):
    """The second turn prefills at the cache cursor over the first turn's
    cache and mask (a left-pad hole between the turns); the steps past slot
    128 grow the cache to 256 slots."""
    je, te = engines
    want, want_cur, want_end = _conversation(je, proc, [])
    before = []
    got, got_cur, got_end = _conversation(te, proc, before)
    assert got_cur == want_cur > 2 * 32 - 1 and got_end == want_end == 130
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert je.cache_len == te.cache_len == 256
    assert te._steps is not before[0]  # built anew over the grown state
    assert te.state.cache.k.shape[3] == 256 and te._steps.state is te.state
    assert before[0].state.cache.k.shape[3] == 128
    np.testing.assert_array_equal(te.state.kv_valid[:, 128:130].numpy(), [[True, True]])


def test_second_turn_replays_the_first_turns_prefill_program(engines, proc):
    """Two turns of one prompt length and attend bucket: the second prefill
    starts at a nonzero cursor (a device tensor) through the same program
    key as the first (one key kept, two runs of it: eager on the CPU); the
    frames of both turns equal JAX's, whose engine compiles one prefill
    program for both."""
    je, te = engines
    te.reset_generation_state(keep_cache=False)
    te.prefill([_turn(proc, "turn one", 1)], [proc.tokenizer.encode("reply one")[:4]], **GREEDY)
    prefills = te._prefills
    before = dict(prefills.counts)
    keys = set(je._jit)
    out = {}
    for name, e in (("jax", je), ("port", te)):
        e.reset_generation_state(keep_cache=False)
        frames = [e.prefill([_turn(proc, "turn one", 1)],
                            [proc.tokenizer.encode("reply one")[:4]], **GREEDY)]
        frames += e.step_block([[t] for t in proc.tokenizer.encode("ply")], **GREEDY)
        e.reset_generation_state(keep_cache=True)
        cursor = int(np.asarray(e.state.cur_len))
        frames.append(e.prefill([_turn(proc, "turn one", 1)],
                                [proc.tokenizer.encode("reply two")[:4]], **GREEDY))
        frames += e.step_block([[t] for t in proc.tokenizer.encode("two")], **GREEDY)
        out[name] = (frames, cursor)
    assert out["port"][1] == out["jax"][1] > 0
    for g, w in zip(out["port"][0], out["jax"][0], strict=True):
        np.testing.assert_array_equal(g, w)
    assert te._prefills is prefills and len(prefills._prompts) == 1
    assert prefills.counts == dict(before, eager=before["eager"] + 2)
    assert not prefills.keys  # no graphs on the CPU
    assert sum(k[0] == "prefill" for k in set(je._jit) - keys) <= 1
