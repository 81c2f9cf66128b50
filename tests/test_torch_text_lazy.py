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
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.models import delay as td
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
