"""The port's Delay model and engine against the JAX package on CPU, same
weights (JAX ``init_delay_params`` -> numpy -> ``utils.convert``), tiny
config with n_vq=4.

* ``DelayGenState`` after prefill and after 8 greedy decode steps: integer
  and boolean fields equal; logits and the KV cache within atol 1e-4
  (float32 on both sides, summation order only).
* ``DelayEngine.generate`` greedy grids equal, token for token, for a
  left-padded batch of 2 and for continuation prompts.
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
from mosstts_tpu_torch.engine.delay_engine import DelayEngine, attend_bucket
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops.sampling import row_keys
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
TOL = dict(rtol=1e-4, atol=1e-4)
INT_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "is_stopping", "is_audio",
              "audio_lengths", "delayed", "seen", "out", "out_valid")


@pytest.fixture(scope="module")
def engines():
    je = JaxEngine.random_init(seed=0, config=CFG, dtype=jnp.float32, cache_bucket=64)
    te = DelayEngine(load_tree_(td.DelayParams(CFG), jax.device_get(je.params)), CFG,
                     dtype=torch.float32, cache_bucket=64)
    return je, te


@pytest.fixture(scope="module")
def proc():
    return DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=None, config=CFG)


def _continuation_batch(proc, ref_lens, seed=0):
    """Left-padded continuation prompts whose assistant turn holds random
    audio codes, so the audio channels and the delay flush run."""
    rng = np.random.default_rng(seed)
    convs = []
    for i, n in enumerate(ref_lens):
        codes = rng.integers(0, CFG.audio_vocab_size, size=(n, CFG.n_vq))
        convs.append([proc.build_user_message(text=f"say something {i}"),
                      proc.build_assistant_message([codes])])
    return proc(convs, mode="continuation")


def _assert_state_equal(ts, js):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    valid = np.asarray(js.kv_valid)
    for tc, jc in ((ts.cache.k, js.cache.k), (ts.cache.v, js.cache.v)):
        np.testing.assert_allclose(tc.numpy().transpose(1, 3, 0, 2, 4)[valid],
                                   np.asarray(jc).transpose(1, 3, 0, 2, 4)[valid], **TOL)


def test_gen_state_after_prefill_and_8_steps(engines, proc):
    je, te = engines
    batch = _continuation_batch(proc, (6, 3))
    ids, mask = batch["input_ids"], batch["attention_mask"]
    B, T, _ = ids.shape
    max_new = 16
    cache_len = -(-(T + max_new + 1) // 64) * 64
    greedy = dict(text_temperature=0.0, audio_temperature=0.0)

    # prefill logits of the last position
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jt, ja, _ = jd.delay_forward(je.params, CFG, jnp.asarray(ids), positions=jnp.asarray(pos),
                                 kv_valid=jnp.asarray(mask), logits_len=1)
    tt, ta, _ = td.delay_forward(te.params, CFG, torch.tensor(ids), positions=torch.tensor(pos),
                                 kv_valid=torch.tensor(mask), logits_len=1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)

    js = jax.jit(lambda p, i, m: jd.delay_prefill(
        p, CFG, i, m, max_new_tokens=max_new, cache_len=cache_len,
        rng=jax.random.PRNGKey(0), sampling=jd.make_sampling(**greedy),
        dtype=jnp.float32))(je.params, jnp.asarray(ids), jnp.asarray(mask))
    ts = td.delay_prefill(te.params, CFG, torch.tensor(ids), torch.tensor(mask),
                          max_new_tokens=max_new, cache_len=cache_len,
                          rng=row_keys(0, B), sampling=td.make_sampling(**greedy),
                          dtype=torch.float32)
    _assert_state_equal(ts, js)

    jax_steps = {}
    for i in range(8):
        attend = attend_bucket(T + i + 2, 32, cache_len)
        if attend not in jax_steps:
            jax_steps[attend] = jax.jit(lambda p, st, a=attend: jd.delay_decode_step(
                p, CFG, st, jd.make_sampling(**greedy), attend_len=a, uniform_slots=True))
        js = jax_steps[attend](je.params, js)
        ts = td.delay_decode_step(te.params, CFG, ts, td.make_sampling(**greedy),
                                  attend_len=attend, uniform_slots=True)
    _assert_state_equal(ts, js)

    # next-step logits from the state after 8 steps
    p = int(js.pos[0])
    jt, ja, _ = jd.delay_forward(je.params, CFG, js.cur_ids, positions=js.pos[:, None],
                                 kv_valid=js.kv_valid, cache=js.cache, cache_offset=p)
    tt, ta, _ = td.delay_forward(te.params, CFG, ts.cur_ids, positions=ts.pos[:, None],
                                 kv_valid=ts.kv_valid, cache=ts.cache, cache_offset=p)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


def _generate_both(engines, ids, mask, max_new):
    je, te = engines
    kw = dict(max_new_tokens=max_new, text_temperature=0.0, audio_temperature=0.0)
    return je.generate(ids, mask, **kw), te.generate(ids, mask, **kw)


def _assert_grids_equal(jout, tout):
    assert len(jout) == len(tout)
    for (js_len, jg), (ts_len, tg) in zip(jout, tout):
        assert ts_len == js_len
        np.testing.assert_array_equal(tg, jg)


def test_generate_greedy_left_padded_batch(engines, proc):
    convs = [[proc.build_user_message(text="hello")],
             [proc.build_user_message(text="a much longer prompt for the second row")]]
    batch = proc(convs, mode="generation")
    assert not batch["attention_mask"].all()  # the first row is left-padded
    _assert_grids_equal(*_generate_both(engines, batch["input_ids"],
                                        batch["attention_mask"], 20))


@pytest.mark.parametrize("ref_lens", [(7,), (9, 4)])
def test_generate_greedy_continuation(engines, proc, ref_lens):
    batch = _continuation_batch(proc, ref_lens, seed=len(ref_lens))
    jout, tout = _generate_both(engines, batch["input_ids"], batch["attention_mask"], 24)
    _assert_grids_equal(jout, tout)
    # the delay flush ran: n_vq delay slots, then audio_end
    gen_text = list(map(int, tout[0][1][tout[0][0]:, 0]))
    assert CFG.audio_end_token_id in gen_text
    end = gen_text.index(CFG.audio_end_token_id)
    assert gen_text[:end].count(CFG.audio_assistant_delay_slot_token_id) == CFG.n_vq
