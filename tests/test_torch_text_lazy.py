"""The port's lazy text head (``models.delay._sample_text_lazy``,
``delay_forward(text_lazy=True)``, ``delay_decode_step(text_lazy=True)``)
against its full path and the JAX package's on the CPU. The counterpart of
``tests/test_delay_machine.py::test_lazy_text_sampling_matches_full_path``
(the same config, prompts and steps): with row 2 in free text every step
projects the full head; with every row in an open audio block the
2-column branch runs; the greedy tokens of every step equal the full
path's and JAX's, with int8 weights too; a
decode loop with ``text_lazy`` equals the plain loop; on the card the lazy
step refuses a CUDA-graph capture (``tests/test_torch_parallel_cuda.py``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.models import delay as jd
from mosstts_tpu.ops.basic import dense as jdense
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.ops.kernels import graph_loop
from mosstts_tpu_torch.ops.quant import quantize_tree_
from mosstts_tpu_torch.ops.sampling import row_keys
from mosstts_tpu_torch.utils.convert import load_tree_

CFG = DelayConfig(language_config=tiny_qwen3(), n_vq=4)
TCFG = tconfig.DelayConfig(language_config=tconfig.tiny_qwen3(), n_vq=4)
B, T, STEPS = 3, 12, 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(all_audio=False):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 500, (B, T, CFG.channels))
    ids[:, 2, 0] = CFG.im_start_token_id
    ids[:, 4, 0] = CFG.audio_start_token_id
    # rows 0/1 (or all) in an open audio block, the rest in free text
    ids[:B if all_audio else 2, -1, 0] = CFG.audio_assistant_gen_slot_token_id
    return ids


@pytest.fixture(scope="module")
def setup():
    params = jd.init_delay_params(jax.random.PRNGKey(7), CFG, dtype=jnp.float32)
    tparams = load_tree_(td.DelayParams(TCFG), jax.device_get(params))
    return params, tparams


def _jax_tokens(params, all_audio):
    """JAX's lazy greedy tokens per step (its own test's loop)."""
    sampling = jd.make_sampling(text_temperature=0, audio_temperature=0)
    ids = _prompt(all_audio)
    state = jd.delay_prefill(params, CFG, jnp.asarray(ids), jnp.ones((B, T), bool),
                             max_new_tokens=8, cache_len=64, rng=jax.random.PRNGKey(1),
                             sampling=sampling, dtype=jnp.float32)
    out = []
    for _ in range(STEPS):
        hidden, audio_logits, cache = jd.delay_forward(
            params, CFG, state.cur_ids, positions=state.pos[:, None].astype(jnp.int32),
            kv_valid=state.kv_valid, cache=state.cache, cache_offset=state.pos, attend_len=64,
            text_lazy=True)
        st = state._replace(cache=cache, pos=state.pos + 1)
        state = jd._delay_sample_and_update(st, CFG, sampling, 50, 25, hidden[:, -1],
                                            audio_logits[:, -1], text_head=params["text_head"])
        out.append(np.asarray(state.cur_ids))
    return out


def _clone(state):
    return state._replace(**{k: (copy.deepcopy(v) if k == "rng" else
                                 v.clone() if isinstance(v, torch.Tensor) else
                                 type(v)(*[t.clone() for t in v]))
                             for k, v in state._asdict().items()})


def _port_steps(tparams, all_audio):
    """The port's lazy and full tokens per step from the same states, and
    whether each step took the full branch."""
    sampling = td.make_sampling(text_temperature=0.0, audio_temperature=0.0)
    state = td.delay_prefill(tparams, TCFG, torch.as_tensor(_prompt(all_audio)),
                             torch.ones((B, T), dtype=torch.bool), max_new_tokens=8, cache_len=64,
                             rng=row_keys(1, B), sampling=sampling,
                             dtype=torch.float32)
    lazy, full, branches = [], [], []
    with torch.no_grad():
        for _ in range(STEPS):
            hidden, audio_logits, cache = td.delay_forward(
                tparams, TCFG, state.cur_ids, positions=state.pos[:, None],
                kv_valid=state.kv_valid, cache=state.cache, cache_offset=state.pos,
                attend_len=64, text_lazy=True)
            text_logits = td.dense(hidden, tparams.text_head).float()
            st = state._replace(cache=cache, pos=state.pos + 1)
            preds = td._text_preds(st, TCFG)
            branches.append(bool((preds[3] & ~preds[4]).any()))
            s_full = td._delay_sample_and_update(_clone(st), TCFG, sampling, 50, 25,
                                                 text_logits[:, -1], audio_logits[:, -1])
            state = td._delay_sample_and_update(st, TCFG, sampling, 50, 25, hidden[:, -1],
                                                audio_logits[:, -1], text_head=tparams.text_head)
            lazy.append(state.cur_ids.numpy())
            full.append(s_full.cur_ids.numpy())
    return lazy, full, branches


@pytest.mark.parametrize("all_audio", [False, True])
def test_lazy_text_sampling_matches_full_path(setup, all_audio):
    params, tparams = setup
    lazy, full, branches = _port_steps(tparams, all_audio)
    assert branches == [not all_audio] * STEPS  # the branch each prompt exercises
    for a, b, c in zip(lazy, full, _jax_tokens(params, all_audio)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("all_audio", [False, True])
def test_lazy_text_sampling_int8_matches_full_path(setup, all_audio):
    _, tparams = setup
    q = quantize_tree_(copy.deepcopy(tparams))
    lazy, full, _ = _port_steps(q, all_audio)
    for a, b in zip(lazy, full):
        np.testing.assert_array_equal(a, b)


def test_lazy_decode_loop_matches_plain(setup):
    _, tparams = setup
    sampling = td.make_sampling(text_temperature=0.0, audio_temperature=0.0)
    outs = []
    for lazy in (False, True):
        st = td.delay_prefill(tparams, TCFG, torch.as_tensor(_prompt(all_audio=True)),
                              torch.ones((B, T), dtype=torch.bool), max_new_tokens=8,
                              cache_len=64, rng=row_keys(1, B), sampling=sampling,
                              dtype=torch.float32)
        with torch.no_grad():
            for _ in range(6):
                st = td.delay_decode_step(tparams, TCFG, st, sampling, attend_len=64,
                                          text_lazy=lazy)
        outs.append(st.out.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


@jax.jit
def _jax_lazy_step(params, state):
    """JAX's lazy step (``delay_forward(text_lazy=True)``, then the state
    machine behind its ``lax.cond``), compiled, and the f32 text logits of
    both branches."""
    sampling = jd.make_sampling(text_temperature=0, audio_temperature=0)
    hidden, audio_logits, cache = jd.delay_forward(
        params, CFG, state.cur_ids, positions=state.pos[:, None].astype(jnp.int32),
        kv_valid=state.kv_valid, cache=state.cache, cache_offset=state.pos, attend_len=64,
        text_lazy=True)
    st = state._replace(cache=cache, pos=state.pos + 1)
    new = jd._delay_sample_and_update(st, CFG, sampling, 50, 25, hidden[:, -1],
                                      audio_logits[:, -1], text_head=params["text_head"])
    h = hidden[:, -1]
    ids2 = jnp.asarray(sorted((CFG.audio_assistant_gen_slot_token_id,
                               CFG.audio_assistant_delay_slot_token_id)))
    return (new, jdense(h, params["text_head"]).astype(jnp.float32),
            jnp.dot(h, params["text_head"][:, ids2], preferred_element_type=jnp.float32))


@pytest.mark.parametrize("all_audio", [False, True], ids=["free-text-row", "all-audio"])
def test_lazy_step_as_the_graph_composes_it_equals_jax(setup, all_audio):
    """Each step: the condition's plain version over the rows
    (``graph_loop.lazy_cond_plain``) picks the branch the graph's IF nodes
    run (the full head with a row in free text, else the two columns); the
    branch's tokens at the rows that sample text equal JAX's, where no row
    is in free text the two branches agree there, the logits of both are
    within rtol 1e-5 of JAX's (and 1e-5 of the largest logit, as the two
    frameworks sum the products in other orders and logits near zero
    cancel), and the lazy step's state equals JAX's."""
    params, tparams = setup
    sampling = td.make_sampling(text_temperature=0.0, audio_temperature=0.0)
    ids = _prompt(all_audio)
    jstate = jd.delay_prefill(params, CFG, jnp.asarray(ids), jnp.ones((B, T), bool),
                              max_new_tokens=8, cache_len=64, rng=jax.random.PRNGKey(1),
                              sampling=jd.make_sampling(text_temperature=0, audio_temperature=0),
                              dtype=jnp.float32)
    state = td.delay_prefill(tparams, TCFG, torch.as_tensor(ids), torch.ones((B, T), dtype=bool),
                             max_new_tokens=8, cache_len=64, rng=row_keys(1, B),
                             sampling=sampling, dtype=torch.float32)
    cols = torch.tensor(sorted((CFG.audio_assistant_gen_slot_token_id,
                                CFG.audio_assistant_delay_slot_token_id)))
    with torch.no_grad():
        for step in range(STEPS):
            jstate, jfull, jcols = _jax_lazy_step(params, jstate)
            hidden, _, cache = td.delay_forward(
                tparams, TCFG, state.cur_ids, positions=state.pos[:, None],
                kv_valid=state.kv_valid, cache=state.cache, cache_offset=state.pos,
                attend_len=64, text_lazy=True)
            h = hidden[:, -1]
            st = state._replace(cache=cache, pos=state.pos + 1)
            _, sampling_text, is_audio, first_step, early = [
                td._text_preds(st, TCFG)[i] for i in (0, 3, 4, 5, 6)]
            _, k_text, _ = td.split_keys(st.rng, 3)
            full, cheap = td._lazy_branches(k_text, TCFG, sampling, 50, h, tparams.text_head,
                                            is_audio, first_step, early)
            need = graph_loop.lazy_cond_plain(sampling_text, is_audio)
            assert need is not all_audio
            out = torch.empty(B, dtype=torch.int32)
            out.copy_(full() if need else cheap())  # the IF body that runs writes the tokens
            want = torch.from_numpy(np.array(jstate.cur_ids)[:, 0, 0]).to(torch.int32)
            np.testing.assert_array_equal(out[sampling_text].numpy(), want[sampling_text].numpy())
            if not need:
                np.testing.assert_array_equal(full()[sampling_text].numpy(),
                                              out[sampling_text].numpy())
            for got, ref in ((td.dense(h, tparams.text_head).float(), jfull),
                             (td._text_logits2(h, tparams.text_head, cols), jcols)):
                ref = np.asarray(ref)  # near-zero logits cancel: 1e-5 of the largest too
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                           atol=1e-5 * np.abs(ref).max())
            state = td.delay_decode_step(tparams, TCFG, state, sampling, attend_len=64,
                                         text_lazy=True)
            for name in ("cur_ids", "pos", "step", "is_stopping", "is_audio", "audio_lengths",
                         "delayed", "seen", "out", "out_valid"):
                np.testing.assert_array_equal(getattr(state, name).numpy(),
                                              np.asarray(getattr(jstate, name)),
                                              err_msg=f"step {step} {name}")
