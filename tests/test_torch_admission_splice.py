"""The servers' admission splices against the JAX package's splice programs
on the CPU, bit for bit, on random states (not only prefill-made ones).

Each port splice is a list of row copies (``ops.kernels.graph_loop.Part``)
run by ``RowCopy`` at int32 control words, the one program that serves
every slot (on the card one ``copy_rows_kernel`` launch inside the
admission's graph; here its plain version): the Delay server's
``splice_parts`` against JAX's jitted ``_insert_fn`` over linear float32,
bfloat16 and int8 caches and ``_insert_paged_fn(n0)`` over float32 and
int8 page pools, with ``table_entry_parts``/``table_clear_parts`` against
``_table_entry_fn``/``_table_clear_fn``; the Local server's
``local_splice_parts`` against ``_insert_local_row`` (``unfinished`` set,
``small.out`` then zeros); the Realtime server's ``rt_splice_parts``
against ``_splice_rt_rows`` with k < kb and the padding rows' index out of
range, dropped. Then one server round per family, through ``run`` and
``run_events``, whose grids equal the JAX server's on the same weights.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.engine import batch_server as jbs
from mosstts_tpu.engine import local_batch_server as jlbs
from mosstts_tpu.engine import realtime_batch_server as jrbs
from mosstts_tpu.models import delay as jd
from mosstts_tpu.models import local as jl
from mosstts_tpu.models import realtime as jr
from mosstts_tpu.nn import qwen3 as jq
from mosstts_tpu_torch.engine import batch_server as tbs
from mosstts_tpu_torch.engine.local_batch_server import LocalBatchServer, local_splice_parts
from mosstts_tpu_torch.engine.realtime_batch_server import RealtimeBatchServer, rt_splice_parts
from mosstts_tpu_torch.models import delay as td
from mosstts_tpu_torch.models import local as tl
from mosstts_tpu_torch.models import realtime as tr
from mosstts_tpu_torch.nn import qwen3 as tq
from mosstts_tpu_torch.ops.kernels import graph_loop as gl
from tests.test_torch_events import BUDGETS, CFG, GREEDY, KW, _assert_same, _grid
from tests.test_torch_events import _serve as _serve_delay
from tests.test_torch_events import fast_jax_compiles, one_thread, setup  # noqa: F401

L, KVH, HD = 2, 2, 4  # layers, KV heads, head dim of the random caches


def _ns():
    """What JAX's splice-program factories read of a server: its cache."""
    return SimpleNamespace(_jit={})


def _rand(rng, shape, kind):
    if kind == "bool":
        return rng.random(shape) < 0.5
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    if kind == "int32":
        return rng.integers(0, 1000, shape).astype(np.int32)
    if kind == "int64":
        return rng.integers(0, 1000, shape).astype(np.int64)
    if kind == "key":
        return rng.integers(0, 1 << 32, shape).astype(np.uint32)
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, kind):
    """A numpy field as (JAX array, torch tensor) of the same values."""
    if kind == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    if kind == "key":
        return jnp.asarray(x), torch.from_numpy(x.astype(np.int64))
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _state(rng, spec):
    """``spec``: name -> (shape, kind) or a cache (class name, [(shape,
    kind)]): the JAX and the torch field values."""
    jx, tt = {}, {}
    for name, v in spec.items():
        if isinstance(v[0], str):
            pairs = [_both(_rand(rng, shape, "f32" if kind == "bf16" else kind), kind)
                     for shape, kind in v[1]]
            jx[name] = getattr(jq, v[0])(*[p[0] for p in pairs])
            tt[name] = getattr(tq, v[0])(*[p[1] for p in pairs])
        else:
            shape, kind = v
            jx[name], tt[name] = _both(_rand(rng, shape, kind), kind)
    return jx, tt


def _linear_cache(B, S, kind):
    shape = (L, B, KVH, S, HD)
    if kind == "int8":
        return ("QuantKVCache", [(shape, "int8")] * 2 + [(shape[:4], "f32")] * 2)
    return ("KVCache", [(shape, kind)] * 2)


def _paged_cache(B, S, P, psz, kind):
    shape = (L, P, KVH, psz, HD)
    bufs = ([(shape, "int8")] * 2 + [(shape[:4], "f32")] * 2 if kind == "int8" else
            [(shape, "f32")] * 2)
    return ("QuantPagedKVCache" if kind == "int8" else "PagedKVCache",
            bufs + [((B, S // psz), "int32")])


def _delay_spec(B, S, cache, out):
    return dict(cache=cache, kv_valid=((B, S), "bool"), cur_ids=((B, 1, 3), "int64"),
                pos=((B,), "int32"), step=((B,), "int32"), rng=((B, 2), "key"),
                is_stopping=((B,), "bool"), is_audio=((B,), "bool"),
                audio_lengths=((B,), "int32"), delayed=((B,), "int32"),
                seen=((B, 2, 9), "bool"), out=((B, out, 3), "int32"),
                out_valid=((B, out), "bool"))


def _fix_table(rng, jx, tt, P):
    """Page-table entries in range (a random int32 would index nowhere)."""
    t = rng.integers(0, P, tuple(tt["cache"].table.shape)).astype(np.int32)
    jx["cache"] = jx["cache"]._replace(table=jnp.asarray(t))
    tt["cache"] = tt["cache"]._replace(table=torch.from_numpy(t))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_fields(want, got, skip=()):
    for name in want._fields:
        if name in skip:
            continue
        w, g = getattr(want, name), getattr(got, name)
        if isinstance(g, tuple):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
        else:
            np.testing.assert_array_equal(_np(g).astype(np.int64) if name == "rng" else _np(g),
                                          _np(w).astype(np.int64) if name == "rng" else _np(w),
                                          err_msg=name)


def _ctrl(n=gl.CTRL_WORDS, **words):
    c = torch.zeros(n, dtype=torch.int32)
    for k, v in words.items():
        c[getattr(gl, k.upper())] = v
    return c


def _splice(parts, ctrl):
    gl.RowCopy(parts, ctrl)()


# ---- the Delay server ---------------------------------------------------------------
@pytest.mark.parametrize("row", [0, 2, 3])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_delay_splice_equals_jax_insert_row(kind, row):
    """``splice_parts`` at ``ctrl[SLOT] = row`` == JAX's ``_insert_fn()``
    (``_insert_row``, row traced), every field and the cache."""
    rng = np.random.default_rng(100 + row)
    B, S = 4, 24
    jb, tb = _state(rng, _delay_spec(B, S, _linear_cache(B, S, kind), 10))
    js, ts = _state(rng, _delay_spec(1, S, _linear_cache(1, S, kind), 4))
    want = jbs.DelayBatchServer._insert_fn(_ns())(jd.DelayGenState(**jb), jd.DelayGenState(**js),
                                               row)
    big = td.DelayGenState(**tb)
    ctrl = _ctrl(slot=row)
    _splice(tbs.splice_parts(big, td.DelayGenState(**ts), ctrl), ctrl)
    _assert_fields(want, big)


@pytest.mark.parametrize("row,pages", [(1, (5, 2)), (3, (7,)), (0, (1, 6, 3, 4))])
@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_splice_and_table_programs_equal_jax(kind, row, pages):
    """``splice_parts(n0)`` with the pages and table row in the control
    words == JAX's ``_insert_paged_fn(n0)``; then a table entry and a row
    clear == ``_table_entry_fn`` and ``_table_clear_fn``."""
    rng = np.random.default_rng(7 * row + len(pages))
    B, S, P, psz = 4, 64, 9, 16
    npp, n0 = S // psz, len(pages)
    jb, tb = _state(rng, _delay_spec(B, S, _paged_cache(B, S, P, psz, kind), 10))
    _fix_table(rng, jb, tb, P)
    js, ts = _state(rng, _delay_spec(1, S, _linear_cache(1, S, kind), 4))
    trow = np.zeros(npp, np.int32)
    trow[:n0] = pages
    want = jbs.DelayBatchServer._insert_paged_fn(_ns(), n0)(
        jd.DelayGenState(**jb), jd.DelayGenState(**js), row, jnp.asarray(pages, jnp.int32),
        jnp.asarray(trow))
    big = td.DelayGenState(**tb)
    ctrl = _ctrl(gl.CTRL_WORDS + npp, slot=row)
    ctrl[gl.TABLE_ROW:] = torch.from_numpy(trow)
    _splice(tbs.splice_parts(big, td.DelayGenState(**ts), ctrl, n0), ctrl)
    _assert_fields(want, big)

    table = big.cache.table
    col, pg = n0 % npp, 8
    want_t = jbs.DelayBatchServer._table_entry_fn(_ns())(jnp.asarray(table.numpy()), row, col, pg)
    ctrl[gl.ENTRY], ctrl[gl.PAGE] = row * npp + col, pg
    _splice(tbs.table_entry_parts(table, ctrl), ctrl)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_t))
    want_t = jbs.DelayBatchServer._table_clear_fn(_ns())(jnp.asarray(table.numpy()), row)
    _splice(tbs.table_clear_parts(table), ctrl)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_t))


def test_a_slot_out_of_range_drops_the_whole_splice():
    """The server's ``_aim_nowhere`` words (slot = slots, every page =
    num_pages) leave the running state as it was: JAX's ``mode="drop"``."""
    rng = np.random.default_rng(3)
    B, S, P, psz = 3, 32, 5, 16
    _, tb = _state(rng, _delay_spec(B, S, _paged_cache(B, S, P, psz, "f32"), 8))
    _, ts = _state(rng, _delay_spec(1, S, _linear_cache(1, S, "f32"), 4))
    big = td.DelayGenState(**tb)
    before = [t.clone() for t in list(big.cache) + list(big[1:])]
    ctrl = _ctrl(gl.CTRL_WORDS + S // psz, slot=B)
    ctrl[gl.TABLE_ROW:] = P
    _splice(tbs.splice_parts(big, td.DelayGenState(**ts), ctrl, S // psz), ctrl)
    for a, b in zip(before, list(big.cache) + list(big[1:])):
        assert torch.equal(a, b)


# ---- the Local server -------------------------------------------------------------
def _local_spec(B, S, out):
    return dict(cache=_linear_cache(B, S, "f32"), kv_valid=((B, S), "bool"),
                cur_ids=((B, 1, 3), "int64"), pos=((B,), "int32"), step=((B,), "int32"),
                rng=((B, 2), "key"), unfinished=((B,), "bool"), seen_text=((B, 11), "bool"),
                seen_audio=((B, 2, 9), "bool"), out=((B, out, 3), "int32"))


@pytest.mark.parametrize("row,pos0", [(0, 31), (2, 7)])
def test_local_splice_equals_jax_insert_local_row(row, pos0):
    """``local_splice_parts`` at ``ctrl[SLOT]``, ``ctrl[POS0]`` == JAX's
    ``_insert_local_row`` (row and cursor traced) on a random small state
    whose ``unfinished`` is False and ``out`` is not zero: the slot is
    unfinished and its output is ``small.out`` then zeros, as in JAX; the
    slot takes ``small``'s key (per-slot keys, the port's design), the
    other rows keep theirs."""
    rng = np.random.default_rng(row)
    B, S = 3, 40
    jb, tb = _state(rng, _local_spec(B, S, 9))
    js, ts = _state(rng, _local_spec(1, S, 1))
    js["unfinished"], ts["unfinished"] = jnp.zeros(1, bool), torch.zeros(1, dtype=torch.bool)
    js["out"] = jnp.asarray(ts["out"].numpy())
    want = jlbs.LocalBatchServer._insert_fn(_ns())(jl.LocalGenState(**jb), jl.LocalGenState(**js),
                                                row, pos0)
    depth = tq.KVCache(torch.zeros(1), torch.zeros(1))
    big = tl.LocalGenState(**tb, depth=depth)
    rng_before = big.rng.clone()
    ctrl = _ctrl(slot=row, pos0=pos0)
    _splice(local_splice_parts(big, tl.LocalGenState(**ts, depth=depth), ctrl,
                               torch.ones(1, dtype=torch.bool)), ctrl)
    _assert_fields(want, big, skip=("rng",))
    assert bool(big.unfinished[row]) and not big.out[row, 1:].any()
    want_rng = rng_before.clone()
    want_rng[row] = ts["rng"][0]
    assert torch.equal(big.rng, want_rng)


# ---- the Realtime server ------------------------------------------------------------
def _rt_spec(B, S, scalar):
    cur = ((), "int32") if scalar else ((B,), "int32")
    return dict(cache=_linear_cache(B, S, "f32"), kv_valid=((B, S), "bool"), cur_len=cur,
                last_audio=((B, 4), "int32"), is_stopping=((B,), "bool"),
                history=((B, 6, 4), "int32"), hist_len=cur, rng=((B, 2), "key"))


@pytest.mark.parametrize("attend", [32, 16], ids=["full-cache", "attend-16"])
@pytest.mark.parametrize("rows", [(4, 0, 2), (3,), (1, 4)])
def test_rt_splice_equals_jax_splice_rt_rows(rows, attend):
    """``rt_splice_parts`` over kb = the next power of two rows, the
    padding rows' index ``slots`` == JAX's ``_splice_rt_rows`` (traced
    (kb,) rows, ``mode="drop"``): the padding rows are dropped. With a
    small state of ``attend`` < S cache slots, JAX's small state is the
    same zero-padded to S: the masks equal, and the cache equals over the
    first ``attend`` slots (the rest is never read). Each slot takes its
    row's key; the other rows keep theirs."""
    rng = np.random.default_rng(len(rows) + attend)
    B, S, k = 5, 32, len(rows)
    kb = 1 << (k - 1).bit_length()
    idx = np.asarray(list(rows) + [B] * (kb - k), np.int32)
    jb, tb = _state(rng, _rt_spec(B, S, False))
    _, ts = _state(rng, _rt_spec(kb, attend, True))
    js = {}
    for name, v in ts.items():
        if name == "cache":
            js[name] = jq.KVCache(*[jnp.asarray(np.pad(c.numpy(), [(0, 0)] * 3 + [(0, S - attend),
                                                                              (0, 0)]))
                                    for c in v])
        elif name == "kv_valid":
            js[name] = jnp.asarray(np.pad(v.numpy(), [(0, 0), (0, S - attend)]))
        else:
            js[name] = jnp.asarray(v.numpy().astype(np.uint32) if name == "rng" else v.numpy())
    want = jax.jit(jrbs._splice_rt_rows)(jr.RealtimeState(**jb), jr.RealtimeState(**js),
                                         jnp.asarray(idx))
    big = tr.RealtimeState(**tb)
    rng_before = big.rng.clone()
    _splice(rt_splice_parts(big, tr.RealtimeState(**ts), kb), torch.from_numpy(idx))
    _assert_fields(want, big, skip=("rng", "cache"))
    for w, g in zip(want.cache, big.cache):
        np.testing.assert_array_equal(g.numpy()[:, :, :, :attend], np.asarray(w)[:, :, :, :attend])
        rest = [b for b in range(B) if b not in rows]
        np.testing.assert_array_equal(g.numpy()[:, rest], np.asarray(w)[:, rest])
    want_rng = rng_before.clone()
    want_rng[list(rows)] = ts["rng"][:k]
    assert torch.equal(big.rng, want_rng)


# ---- one server round per family, run and run_events ---------------------------------
@pytest.fixture(scope="module")
def delay_round(setup):
    grids = [_grid(setup[2], f"splice round {i}", seed=60 + i) for i in range(5)]
    js = jbs.DelayBatchServer(setup[0], CFG, dtype=jnp.float32,
                              sampling=jd.make_sampling(**GREEDY), cache_len=256, **KW)
    return grids, _serve_delay(js, grids, "run")


@pytest.mark.parametrize("loop", ["run", "run_events"])
@pytest.mark.parametrize("mode", [{}, dict(paged=True, page_size=64, kv_quant=True)],
                         ids=["linear", "paged-q8"])
def test_delay_server_round_equals_jax(setup, delay_round, mode, loop):
    """Greedy: the Delay server's completions through ``run`` and
    ``run_events`` (admissions through the splice program) == JAX's ``run``
    (JAX's own tests hold its ``run_events`` equal to its ``run``)."""
    grids, want = delay_round
    srv = tbs.DelayBatchServer(setup[1], CFG, dtype=torch.float32,
                               sampling=td.make_sampling(**GREEDY), cache_len=256, **KW, **mode)
    got = _serve_delay(srv, grids, loop)
    _assert_same(want, got)
    assert all(c.steps <= n for c, n in zip(got, BUDGETS))


@pytest.fixture(scope="module")
def rt_round():
    from mosstts_tpu.processing.realtime_processor import RealtimeProcessor
    from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer
    from tests.test_torch_realtime import CFG as RCFG
    from tests.test_torch_realtime import RVQ, _turn, numpy_params, port_params
    from tests.test_torch_realtime import TCFG as RTCFG

    jp = numpy_params()
    proc = RealtimeProcessor(ByteFallbackTokenizer(), channels=RVQ)
    load = [(_turn(proc, f"q{i}", i), proc.tokenizer.encode(t))
            for i, t in enumerate(["one", "a second reply to feed", "three"])]
    kw = dict(slots=2, cache_len=128, max_frames=32, prompt_bucket=32)
    want = _rt_serve(jrbs.RealtimeBatchServer(jp, RCFG, dtype=jnp.float32, **kw), load, "run")
    return port_params(jp), RTCFG, kw, load, want


def _rt_serve(server, load, run):
    rids = [server.submit(g, t, max_new_tokens=n, prefill_text_len=4,
                          sampling=dict(temperature=0.0))
            for (g, t), n in zip(load, (10, 14, 7))]
    done = {c.request_id: c for c in getattr(server, run)()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("loop", ["run", "run_events"])
def test_realtime_server_round_equals_jax(rt_round, loop):
    """Greedy: the Realtime server's streams through ``run`` and
    ``run_events`` (batch-k admissions spliced by the row copy, padding
    rows dropped) == JAX's ``run``, frames and step counts."""
    tp, tcfg, kw, load, want = rt_round
    got = _rt_serve(RealtimeBatchServer(tp, tcfg, dtype=torch.float32, **kw), load, loop)
    for w, g in zip(want, got):
        assert g.frames.shape[0] > 0 and g.steps == w.steps
        np.testing.assert_array_equal(g.frames, w.frames)


@pytest.fixture(scope="module")
def local_round():
    from tests.test_torch_local import CFG as LCFG
    from tests.test_torch_local import GREEDY as LGREEDY
    from tests.test_torch_local import NVQ, TCFG as LTCFG, numpy_params, port_params

    jp = numpy_params(seed=6)
    rng = np.random.default_rng(21)
    grids = []
    for T in (8, 14, 11):
        g = rng.integers(0, 500, (T, LCFG.channels)).astype(np.int64)
        g[..., 1:] = rng.integers(0, 1024, (T, NVQ))
        g[2, 0] = LCFG.audio_start_token_id
        grids.append(g)
    kw = dict(slots=2, out_capacity=32, prompt_bucket=32, cache_len=128, **LGREEDY)
    js = jlbs.LocalBatchServer(jp, LCFG, dtype=jnp.float32, **kw)
    return port_params(jp), LTCFG, kw, grids, _local_serve(js, grids, "run")


def _local_serve(server, grids, run):
    rids = [server.submit(g, max_new_tokens=n) for g, n in zip(grids, (9, 6, 12))]
    done = {c.request_id: c for c in getattr(server, run)(max_steps=400)}
    return [done[r] for r in rids]


@pytest.mark.parametrize("loop", ["run", "run_events"])
def test_local_server_round_equals_jax(local_round, loop):
    """Greedy: the Local server's grids through ``run`` and ``run_events``
    (admissions spliced by the row copy, the slot's ``unfinished`` and
    ``out`` as JAX sets them) == JAX's ``run``."""
    tp, tcfg, kw, grids, want = local_round
    got = _local_serve(LocalBatchServer(tp, tcfg, dtype=torch.float32, **kw), grids, loop)
    for w, g in zip(want, got):
        assert (w.start_length, w.steps) == (g.start_length, g.steps)
        np.testing.assert_array_equal(g.tokens, w.tokens)
