"""Rank bodies of the port's parallel tests: what each gloo rank runs (the
tests compute their references with the JAX package in the pytest process
and spawn these through ``torch_spawn.run_ranks``). This module imports no
JAX, so a rank starts in the time torch takes to import. Each body runs
every case of its test file for one world size and returns rank 0's
results; a disagreement between ranks fails inside the ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mosstts_tpu_torch.core import config as C
from mosstts_tpu_torch.utils.convert import load_tree_

# the tests' small configurations (the JAX references are built from the
# same numbers): 4 KV heads, so "model" may be 2 or 4 ranks; the full vocab,
# which holds the special tokens the prompts carry
QWEN = dict(num_attention_heads=4, num_key_value_heads=4)
SMALL_VOCAB = dict(QWEN, vocab_size=512)  # the trainers' (their ids stay below 512)
N_VQ = 8
LOCAL = dict(n_vq=4, additional_mlp_ffn_hidden_size=32, local_ffn_hidden_size=48,
             local_hidden_size=24, local_num_layers=2)


def delay_cfg():
    return C.DelayConfig(language_config=C.tiny_qwen3(**QWEN), n_vq=N_VQ)


def family_cfg(family: str):
    """The trainer tests' configuration of each family (a 512-token vocab)."""
    import dataclasses

    from mosstts_tpu_torch.train.trainer import tiny_config

    if family == "delay":
        return C.DelayConfig(language_config=C.tiny_qwen3(**SMALL_VOCAB), n_vq=N_VQ)
    if family == "local":
        return C.LocalConfig(language_config=C.tiny_qwen3(**SMALL_VOCAB), **LOCAL)
    cfg = tiny_config(family)
    return dataclasses.replace(cfg, language_config=dataclasses.replace(
        cfg.language_config, vocab_size=512))


def _same_on_all_ranks(x: torch.Tensor) -> None:
    """Every rank holds the same values."""
    x = torch.as_tensor(x).contiguous()
    ref = x.clone()
    dist.broadcast(ref, 0)
    assert torch.equal(ref, x), "ranks disagree"


def _greedy():
    from mosstts_tpu_torch.models.delay import make_sampling

    return make_sampling(text_temperature=0.0, audio_temperature=0.0)


def _delay_params(tree):
    from mosstts_tpu_torch.models.delay import DelayParams

    return load_tree_(DelayParams(delay_cfg()), tree)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_mesh.py


def _rows(batch, axis):
    n = len(batch["input_ids"]) // axis.size
    return {k: torch.as_tensor(v[axis.index * n:(axis.index + 1) * n]) for k, v in batch.items()}


def _train_loss(tree, batch, mesh):
    from mosstts_tpu_torch.models.delay import delay_train_step
    from mosstts_tpu_torch.parallel.mesh import delay_param_specs, mesh_axis, shard_params

    p = shard_params(_delay_params(tree), mesh, delay_param_specs())
    _, loss, _ = delay_train_step(p, delay_cfg(), _rows(batch, mesh_axis(mesh, "data")))
    _same_on_all_ranks(loss)
    return float(loss)


def _trainer_from_tree(family, tree, mesh, **kw):
    """A ``TTSTrainer(mesh=)`` whose parameters are this rank's blocks of
    the weights ``tree`` (a JAX trainer's, unsharded)."""
    from mosstts_tpu_torch.parallel import mesh as pm
    from mosstts_tpu_torch.train.trainer import _FAMILIES, TTSTrainer

    cfg = family_cfg(family)
    tr = TTSTrainer(family, cfg, mesh=mesh, **kw)
    full = load_tree_(_FAMILIES[family][0](cfg, generator=torch.Generator().manual_seed(0)),
                      tree)
    pm.shard_params(full, mesh, getattr(pm, f"{family}_param_specs")())
    with torch.no_grad():
        for (name, p), (name2, w) in zip(tr.params.named_parameters(),
                                         full.named_parameters()):
            assert name == name2 and p.shape == w.shape, (name, name2)
            p.copy_(w)
    return tr


def mesh_cases(rank, world, tree, inp, tmp):
    from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
    from mosstts_tpu_torch.engine.delay_engine import DelayEngine
    from mosstts_tpu_torch.models.delay import delay_decode_step, delay_forward, delay_prefill
    from mosstts_tpu_torch.ops.sampling import row_keys
    from mosstts_tpu_torch.parallel.mesh import delay_param_specs, make_mesh, shard_params
    from mosstts_tpu_torch.train.trainer import TTSTrainer

    cfg, out = delay_cfg(), {}
    tp_mesh = make_mesh(data=1, model=world, device="cpu")
    dp_tp = (2, world // 2)

    out["train"] = _train_loss(tree, inp["batch"], make_mesh(*dp_tp, device="cpu"))
    dcn = make_mesh(*dp_tp, dcn=2, device="cpu")
    out["dcn"] = dict(loss=_train_loss(tree, inp["batch"], dcn), ranks=dcn.mesh.tolist(),
                      names=dcn.mesh_dim_names)
    try:
        make_mesh(*dp_tp, dcn=3, device="cpu")
        out["dcn"]["error"] = None
    except ValueError as e:
        out["dcn"]["error"] = str(e)

    p = shard_params(_delay_params(tree), tp_mesh, delay_param_specs())
    f = inp["forward"]
    with torch.no_grad():
        t, a, _ = delay_forward(p, cfg, torch.as_tensor(f["ids"]),
                                positions=torch.as_tensor(f["pos"]),
                                kv_valid=torch.as_tensor(f["mask"]))
    _same_on_all_ranks(t)
    out["forward"] = (t.numpy(), a.numpy())

    d = inp["decode"]
    st = delay_prefill(p, cfg, torch.as_tensor(d["ids"]), torch.as_tensor(d["mask"]),
                       max_new_tokens=8, cache_len=64, rng=row_keys(3, len(d["ids"])),
                       sampling=_greedy(), dtype=torch.float32)
    for _ in range(6):
        st = delay_decode_step(p, cfg, st, _greedy(), attend_len=64)
    out["decode"] = st.out.numpy()

    e = inp["engine"]
    gen = dict(max_new_tokens=12, text_temperature=0.0, audio_temperature=0.0)
    eng = DelayEngine(_delay_params(tree), cfg, dtype=torch.float32, cache_bucket=32,
                      device="cpu", mesh=make_mesh(*dp_tp, device="cpu"))
    out["engine"] = {od: eng.generate(e["ids"], on_device=od, **gen) for od in (False, True)}
    for od in (False, True):
        _same_on_all_ranks(torch.as_tensor(np.stack([g for _, g in out["engine"][od]])))

    # int8: the sharded engine's quantized weights are one device's
    q8 = DelayEngine(_delay_params(tree), cfg, dtype=torch.float32, cache_bucket=32,
                     device="cpu", mesh=make_mesh(data=1, model=world, device="cpu")).quantize()
    out["int8"] = q8.generate(e["ids"], **gen)
    if rank == 0:
        solo = DelayEngine(_delay_params(tree), cfg, dtype=torch.float32, cache_bucket=32,
                           device="cpu").quantize()
        out["int8_solo"] = solo.generate(e["ids"], **gen)

    s = inp["server"]
    for loop in ("run", "run_events", "run_drain"):
        server = DelayBatchServer(_delay_params(tree), cfg, slots=2, cache_len=128,
                                  out_capacity=32, prompt_bucket=16, dtype=torch.float32,
                                  sampling=_greedy(),
                                  mesh=make_mesh(data=1, model=world, device="cpu"))
        rids = [server.submit(g, max_new_tokens=10) for g in s["grids"]]
        done = {c.request_id: c for c in getattr(server, loop)(max_steps=300)}
        out[f"server_{loop}"] = [(done[r].start_length, done[r].tokens) for r in rids]
    # the other cache modes: sharded against the same server unsharded
    for mode in (dict(kv_quant=True), dict(paged=True, page_size=32),
                 dict(paged=True, page_size=32, kv_quant=True)):
        key = "server_" + "_".join(sorted(mode))
        got = []
        for mesh in ((make_mesh(data=1, model=world, device="cpu"),)
                     + ((None,) if rank == 0 else ())):
            server = DelayBatchServer(_delay_params(tree), cfg, slots=2, cache_len=128,
                                      out_capacity=32, prompt_bucket=16, dtype=torch.float32,
                                      sampling=_greedy(), mesh=mesh, **mode)
            rids = [server.submit(g, max_new_tokens=10) for g in s["grids"]]
            done = {c.request_id: c for c in server.run(max_steps=300)}
            got.append([(done[r].start_length, done[r].tokens) for r in rids])
        out[key] = got
    try:
        DelayBatchServer(_delay_params(tree), cfg, slots=2, mesh=make_mesh(*dp_tp, device="cpu"))
        out["server_error"] = None
    except ValueError as err:
        out["server_error"] = str(err)

    # TTSTrainer(mesh=) of each family from JAX's trainer's weights, and its
    # per-rank train state: Delay and Local tensor-parallel (Delay with a
    # "data" axis too at world 4); Realtime data-parallel, since JAX's spec
    # table puts its rvq and rvq - 1 codebook tables on "model", which no
    # model axis of 2 or more divides (JAX and the port refuse it alike)
    out["trainer"] = {}
    try:
        TTSTrainer("realtime", family_cfg("realtime"), device="cpu",
                   mesh=make_mesh(world // 2, 2, device="cpu"))
        out["realtime_tp_error"] = None
    except ValueError as e:
        out["realtime_tp_error"] = str(e)
    shapes = {"delay": (world // 2, 2), "local": (1, world), "realtime": (world, 1)}
    for family, shape in shapes.items():
        t = inp["trainer"][family]
        kw = dict(device="cpu", peak_lr=1e-3, warmup_steps=1)
        tr = _trainer_from_tree(family, t["tree"], make_mesh(*shape, device="cpu"), **kw)
        recs = [tr.train_step(b) for b in t["batches"]]
        path = f"{tmp}/{family}-{world}"
        tr.save_state(path)
        back = TTSTrainer(family, family_cfg(family), seed=99, device="cpu",
                          mesh=make_mesh(*shape, device="cpu")).restore_state(path)
        same = all(torch.equal(a, b) for a, b in zip(tr.params.parameters(),
                                                        back.params.parameters()))
        same = same and all(torch.equal(tr.opt.mu[n], back.opt.mu[n]) for n in tr.opt.mu)
        same = same and back.step_idx == tr.step_idx and back.opt.count == tr.opt.count
        out["trainer"][family] = dict(recs=recs, restored=same, shape=shape,
                                      sharded=len(tr.sharded_names()))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_pipeline.py


def _qwen_params(tree, n_layers):
    from mosstts_tpu_torch.nn.qwen3 import Qwen3Params

    return load_tree_(Qwen3Params(C.tiny_qwen3(**QWEN, num_hidden_layers=n_layers),
                                  with_embed=False), tree)


def _pp_loss_and_grads(params, cfg, inp, mesh, n_micro, remat=False):
    from mosstts_tpu_torch.parallel.pipeline import pipelined_qwen3_forward
    from mosstts_tpu_torch.train.optim import value_and_grad

    def loss_fn(p):
        h = pipelined_qwen3_forward(p, cfg, torch.as_tensor(inp["x"]),
                                    positions=torch.as_tensor(inp["pos"]),
                                    kv_valid=torch.as_tensor(inp["valid"]), mesh=mesh,
                                    n_micro=n_micro, remat=remat)
        return (h * h).mean(), {}

    loss, _, grads = value_and_grad(params, loss_fn)
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def pipeline_cases(rank, world, trees, inp, cases):
    from mosstts_tpu_torch.parallel.mesh import qwen3_param_specs, shard_params
    from mosstts_tpu_torch.parallel.pipeline import make_pp_mesh, pipelined_qwen3_forward
    from mosstts_tpu_torch.train.trainer import TTSTrainer, synthetic_tts_batch

    out = {}
    x, pos, valid = (torch.as_tensor(inp[k]) for k in ("x", "pos", "valid"))
    for S, M in cases["forward"]:
        if S != world:
            continue
        cfg = C.tiny_qwen3(**QWEN, num_hidden_layers=8)
        with torch.no_grad():
            h = pipelined_qwen3_forward(_qwen_params(trees[8], 8), cfg, x, positions=pos,
                                        kv_valid=valid, mesh=make_pp_mesh(S, device="cpu"),
                                        n_micro=M)
        _same_on_all_ranks(h)
        out[("forward", S, M)] = h.numpy()

    cfg8 = C.tiny_qwen3(**QWEN, num_hidden_layers=8)
    pp = make_pp_mesh(world, device="cpu")
    out["grad"] = _pp_loss_and_grads(_qwen_params(trees[8], 8), cfg8, inp, pp, 4)
    for name, g in out["grad"][1].items():
        _same_on_all_ranks(torch.as_tensor(g))

    cfg4 = C.tiny_qwen3(**QWEN, num_hidden_layers=4)
    out["remat"] = [_pp_loss_and_grads(_qwen_params(trees[4], 4), cfg4, inp, pp, 2, remat=r)
                    for r in (False, True)]

    if world == 4:  # ("stage", "model"): TP inside each stage
        mesh = make_pp_mesh(2, model=2, device="cpu")
        p = shard_params(_qwen_params(trees[8], 8), mesh, {"layers": qwen3_param_specs()["layers"]})
        with torch.no_grad():
            h = pipelined_qwen3_forward(p, cfg8, x, positions=pos, kv_valid=valid, mesh=mesh,
                                        n_micro=4)
        _same_on_all_ranks(h)
        out["tp"] = h.numpy()

    # TTSTrainer(pipeline=) against the plain trainer (on rank 0)
    fcfg = C.DelayConfig(language_config=C.tiny_qwen3(**SMALL_VOCAB, num_hidden_layers=4),
                         n_vq=4)
    batch = synthetic_tts_batch("delay", fcfg, np.random.default_rng(3), batch=4, seq=10)
    meshes = [make_pp_mesh(world, device="cpu")]
    if world == 4:
        meshes.append(make_pp_mesh(2, model=2, device="cpu"))
    recs = []
    for mesh in meshes:
        tr = TTSTrainer("delay", fcfg, seed=7, device="cpu", pipeline=(mesh, 2))
        recs.append([tr.train_step(batch) for _ in range(2)])
    out["trainer"] = recs
    if rank == 0:
        plain = TTSTrainer("delay", fcfg, seed=7, device="cpu")
        out["trainer_plain"] = [plain.train_step(batch) for _ in range(2)]
    try:
        TTSTrainer("local", fcfg, device="cpu", pipeline=(make_pp_mesh(world, device="cpu"), 2))
        out["local_error"] = None
    except ValueError as e:
        out["local_error"] = str(e)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_ring.py


def ring_cases(rank, world, cases):
    from mosstts_tpu_torch.parallel.mesh import make_mesh
    from mosstts_tpu_torch.parallel.ring_attn import ring_gqa_attention

    meshes = {(1, world): make_mesh(data=1, model=world, device="cpu")}
    if world == 4:
        meshes[(2, 2)] = make_mesh(data=2, model=2, device="cpu")
    out = {}
    for key, c in cases.items():
        mesh = meshes[c["mesh"]]
        q, k, v, pos, valid = (torch.as_tensor(c[n]) for n in ("q", "k", "v", "pos", "valid"))
        try:
            o = ring_gqa_attention(mesh, q, k, v, q_positions=pos, kv_positions=pos,
                                   kv_valid=valid, scale=c["scale"], window=c["window"],
                                   layout=c["layout"])
        except ValueError as e:
            out[key] = e
            continue
        _same_on_all_ranks(o)
        out[key] = o.numpy()
    return out
