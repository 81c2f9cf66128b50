"""The port's mesh and tensor/data parallelism (``parallel/mesh.py``, the
collectives of ``nn/qwen3.py`` and ``models/delay.py``, ``DelayEngine``
and ``DelayBatchServer`` with ``mesh=``, ``TTSTrainer(mesh=)``) in gloo
processes at world sizes 2 and 4, against the JAX package on the CPU,
unsharded (its GSPMD shardings change no number). The counterparts of
``tests/test_sharding.py`` (all but ``test_graft_entry_single_device``,
which checks JAX's own entry point): the train-step loss under TP + DP and
on a multislice mesh within rel 2e-5, ``delay_forward`` under TP within
atol 2e-4, greedy engine (both loops) and server tokens and a greedy
prefill + decode equal to JAX's (the server through ``run``, ``run_events``
and ``run_drain``), the server's ``ValueError`` for data > 1;
beyond them, the int8 TP engine equal to the int8 single-rank engine, and
``TTSTrainer(mesh=)`` of each family from the weights of JAX's
``TTSTrainer`` and equal to it over three steps (loss rel 2e-5, gradient
norm rel 1e-4), its per-rank train state restored bit for bit: Delay and
Local tensor-parallel at both world sizes (Delay data-parallel too at 4),
Realtime data-parallel, as its spec table allows (rvq and rvq - 1
codebook tables on "model": no model axis of 2 or more divides both, and
JAX's trainer and the port's raise the same ``ValueError``). Each world size is one spawn of its ranks, which run
every case (``torch_parallel_ranks.mesh_cases``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mosstts_tpu.core import config as jconfig
from mosstts_tpu.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu.engine.batch_server import DelayBatchServer
from mosstts_tpu.engine.delay_engine import DelayEngine
from mosstts_tpu.models.delay import (delay_decode_step, delay_forward, delay_prefill,
                                      delay_train_step, init_delay_params, make_sampling)
from mosstts_tpu.parallel import mesh as jmesh
from mosstts_tpu.train.trainer import TTSTrainer as JTrainer
from mosstts_tpu_torch.train.trainer import synthetic_tts_batch
from test_torch_train import jax_config
from torch_parallel_ranks import LOCAL, N_VQ, QWEN, SMALL_VOCAB, family_cfg, mesh_cases
from torch_spawn import run_ranks

CFG = DelayConfig(language_config=tiny_qwen3(**QWEN), n_vq=N_VQ)
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def jax_numerics():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.clear_caches()  # the flag is not in JAX's cache keys (test_torch_train.jax_numerics)
    jax.config.update("jax_disable_most_optimizations", True)
    with jax.default_matmul_precision("highest"):
        yield
    jax.config.update("jax_disable_most_optimizations", old)
    jax.clear_caches()


def _prompts(rng, B, T, audio_start=None):
    ids = rng.integers(0, 500, (B, T, CFG.channels))
    ids[:, 1, 0] = CFG.im_start_token_id
    if audio_start is not None:
        ids[:, audio_start, 0] = CFG.audio_start_token_id
    ids[:, -1, 0] = CFG.audio_assistant_gen_slot_token_id
    return ids


@pytest.fixture(scope="module")
def ref():
    """The weights, the inputs of every case and JAX's results."""
    params = init_delay_params(jax.random.PRNGKey(1), CFG, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    B, T = 4, 12
    inp = {"batch": {"input_ids": rng.integers(0, 500, (B, T, CFG.channels)),
                     "attention_mask": np.ones((B, T), bool),
                     "labels": rng.integers(0, 500, (B, T, CFG.channels))}}
    out = {}
    _, loss, _ = jax.jit(lambda p, b: delay_train_step(p, CFG, b))(
        params, {k: jnp.asarray(v) for k, v in inp["batch"].items()})
    out["train"] = float(loss)

    ids = rng.integers(0, 500, (2, 9, CFG.channels))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None], (2, 9)).copy()
    inp["forward"] = {"ids": ids, "pos": pos, "mask": np.ones((2, 9), bool)}
    t, a, _ = jax.jit(lambda p: delay_forward(p, CFG, jnp.asarray(ids), positions=jnp.asarray(pos),
                                              kv_valid=jnp.ones((2, 9), bool)))(params)
    out["forward"] = (np.asarray(t), np.asarray(a))

    greedy = make_sampling(text_temperature=0, audio_temperature=0)
    ids = _prompts(rng, 4, 10, audio_start=4)
    inp["decode"] = {"ids": ids, "mask": np.ones((4, 10), bool)}

    def decode(p):
        st = delay_prefill(p, CFG, jnp.asarray(ids), jnp.ones((4, 10), bool), max_new_tokens=8,
                           cache_len=64, rng=jax.random.PRNGKey(3), sampling=greedy,
                           dtype=jnp.float32)
        for _ in range(6):
            st = delay_decode_step(p, CFG, st, greedy, attend_len=64)
        return st.out

    out["decode"] = np.asarray(jax.jit(decode)(params))

    ids = _prompts(rng, 4, 8)
    inp["engine"] = {"ids": ids}
    eng = DelayEngine(params, CFG, dtype=jnp.float32, cache_bucket=32)
    gen = dict(max_new_tokens=12, text_temperature=0.0, audio_temperature=0.0)
    out["engine"] = {od: eng.generate(ids, on_device=od, **gen) for od in (False, True)}

    grids = []
    for i in range(3):
        g = rng.integers(0, 500, (8 + i, CFG.channels))
        g[1, 0] = CFG.im_start_token_id
        g[-1, 0] = CFG.audio_assistant_gen_slot_token_id
        grids.append(g)
    inp["server"] = {"grids": grids}
    server = DelayBatchServer(params, CFG, slots=2, cache_len=128, out_capacity=32,
                              prompt_bucket=16, dtype=jnp.float32, sampling=greedy)
    rids = [server.submit(g, max_new_tokens=10) for g in grids]
    done = {c.request_id: c for c in server.run(max_steps=300)}
    out["server"] = [(done[r].start_length, done[r].tokens) for r in rids]

    # JAX's TTSTrainer of each family: three steps (the first update's
    # learning rate is 0, the second's is not)
    inp["trainer"], out["trainer"] = {}, {}
    try:  # on 2 of the 8 virtual CPU devices' "model" axis
        JTrainer("realtime", _jax_family_cfg("realtime"), mesh=jmesh.make_mesh(4, 2))
        out["realtime_tp_error"] = None
    except ValueError as e:
        out["realtime_tp_error"] = str(e)
    for family in ("delay", "local", "realtime"):
        brng = np.random.default_rng(3)
        batches = [synthetic_tts_batch(family, family_cfg(family), brng, batch=4, seq=10)
                   for _ in range(3)]
        jt = JTrainer(family, _jax_family_cfg(family), peak_lr=1e-3, warmup_steps=1)
        inp["trainer"][family] = dict(tree=jax.device_get(jt.params), batches=batches)
        out["trainer"][family] = [jt.train_step(b) for b in batches]
    return jax.device_get(params), inp, out


def _jax_family_cfg(family):
    """The JAX twin of ``torch_parallel_ranks.family_cfg``."""
    if family == "delay":
        return DelayConfig(language_config=tiny_qwen3(**SMALL_VOCAB), n_vq=N_VQ)
    if family == "local":
        return jconfig.LocalConfig(language_config=tiny_qwen3(**SMALL_VOCAB), **LOCAL)
    cfg = jax_config("realtime")
    return dataclasses.replace(cfg, language_config=dataclasses.replace(
        cfg.language_config, vocab_size=512))


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """world size -> rank 0's results of every case."""
    tree, inp, _ = ref
    res = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"mesh{world}")
        res[world] = run_ranks(mesh_cases, world, tmp, tree, inp, str(tmp))
    return res


def _same_grids(got, want):
    assert len(got) == len(want)
    for (gs, gt), (ws, wt) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(np.asarray(gt), np.asarray(wt))


@pytest.mark.parametrize("world", WORLDS)
def test_delay_train_step_sharded_matches_single(ref, port, world):
    np.testing.assert_allclose(port[world]["train"], ref[2]["train"], rtol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_delay_forward_tensor_parallel_matches(ref, port, world):
    (t, a), (jt, ja) = port[world]["forward"], ref[2]["forward"]
    np.testing.assert_allclose(t, jt, atol=2e-4)
    np.testing.assert_allclose(a, ja, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_delay_engine_sharded_generate_matches_single(ref, port, world):
    _same_grids(port[world]["engine"][False], ref[2]["engine"][False])


@pytest.mark.parametrize("world", WORLDS)
def test_delay_engine_sharded_on_device_generate(ref, port, world):
    _same_grids(port[world]["engine"][True], ref[2]["engine"][True])


@pytest.mark.parametrize("loop", ["run", "run_events", "run_drain"])
@pytest.mark.parametrize("world", WORLDS)
def test_batch_server_model_parallel_matches_single(ref, port, world, loop):
    """Each of the server's loops under TP gives the unsharded JAX
    server's greedy grids (its ``run``)."""
    _same_grids(port[world][f"server_{loop}"], ref[2]["server"])
    assert port[world]["server_error"] and "data=1" in port[world]["server_error"]


@pytest.mark.parametrize("mode", ["server_kv_quant", "server_page_size_paged",
                                  "server_kv_quant_page_size_paged"])
@pytest.mark.parametrize("world", WORLDS)
def test_batch_server_cache_modes_under_mesh(port, world, mode):
    """The int8, paged and int8 paged caches under TP (each rank's KV
    heads) give the unsharded server's greedy grids in the same mode."""
    sharded, single = port[world][mode]
    _same_grids(sharded, single)


@pytest.mark.parametrize("world", WORLDS)
def test_delay_decode_sharded_matches_single(ref, port, world):
    np.testing.assert_array_equal(port[world]["decode"], ref[2]["decode"])


@pytest.mark.parametrize("world", WORLDS)
def test_dcn_multislice_mesh_matches_single(ref, port, world):
    d = port[world]["dcn"]
    assert d["names"] == ("data", "model")
    # slice-major: each slice a contiguous block of ranks holding whole
    # model-axis groups
    assert d["ranks"] == np.arange(world).reshape(2, world // 2).tolist()
    np.testing.assert_allclose(d["loss"], ref[2]["train"], rtol=2e-5)
    assert d["error"] and "dcn=3" in d["error"]


@pytest.mark.parametrize("world", WORLDS)
def test_int8_tensor_parallel_engine_matches_single_rank(port, world):
    _same_grids(port[world]["int8"], port[world]["int8_solo"])


@pytest.mark.parametrize("family", ["delay", "local", "realtime"])
@pytest.mark.parametrize("world", WORLDS)
def test_trainer_mesh_matches_unsharded(ref, port, world, family):
    """Against JAX's unsharded trainer."""
    t = port[world]["trainer"][family]
    if family == "realtime":  # refused on a model axis, by JAX and by the port
        assert t["shape"] == (world, 1)
        assert "divisible by 2" in ref[2]["realtime_tp_error"]
        assert "does not divide over model=2" in port[world]["realtime_tp_error"]
    else:  # tensor-parallel
        assert t["shape"][1] > 1 and t["sharded"] > 0
    want = ref[2]["trainer"][family]
    assert len(t["recs"]) == len(want) == 3
    for got, w in zip(t["recs"], want):
        assert got["step"] == w["step"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-4)
    assert t["restored"]
