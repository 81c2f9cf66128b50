"""Continuous-batching server for the Delay model family.

Ports ``mosstts_tpu/engine/batch_server.py``: ``DelayBatchServer`` with
``submit``, ``step``, ``step_block``, ``run`` (pipelined and sequential),
``run_events``, ``run_drain``, ``warmup``, ``utilization`` and
``total_dispatches``. A fixed pool of batch slots decodes in lock-step;
whenever a slot finishes its utterance a queued request is prefilled at
batch 1 and spliced into that slot mid-flight, so the card never drains.
Each slot has its own cache cursor (``pos``), step counter, delay-pattern
counters, repetition-penalty mask, sampling knobs and threefry key, all
advanced by the one decode step.

Four cache modes: the linear cache in ``dtype`` or in int8 (``kv_quant``),
each also over a shared page pool (``paged``): slots borrow fixed-size pages
as their utterances grow and return them on completion, so KV memory is
sized for the expected load. The allocator runs off the host mirrors of
``pos`` with no device sync; pool exhaustion triggers recompute preemption
(the slot's prompt plus what it generated is requeued at the front). Its
table writes are JAX's ``_table_entry_fn`` and ``_table_clear_fn``: one
row-copy launch each at the entry, page or row the host writes into the
control words first.

``self.state`` is one set of static buffers for the server's whole life,
and the decode steps advance it in place (``engine/step_graph.DecodeSteps``):
on the card each step is the replay of a CUDA graph of the step, one per
attend bucket (the JAX server's ``_step_fn``), and a block of k steps one
launch of a graph that loops over it on the card (its ``_block_fn``, a
``fori_loop`` program; ``step_graph.DeviceLoop``). An admission prefills
into a second static state of batch 1, a linear cache of ``cache_len``
slots kept for the server's life, through ``step_graph.Prefills``: on the
card one CUDA graph per prompt bucket (the JAX server's ``_prefill_fn``),
captured at the bucket's second admission or in ``warmup()`` and kept for
the server's life (at most ``cache_len / prompt_bucket`` graphs, as JAX
keeps a program per bucket), drawing from JAX's key for the request,
``PRNGKey(_request_seed(...))`` split to one row; the same program then
splices that state's row, its key included, into the slot: one launch of
the row-copy kernel (``graph_loop.RowCopy`` over ``splice_parts``; JAX's
``_insert_fn``, paged its ``_insert_paged_fn(n0)``) at the slot, and
paged the bucket's n0 pages and the table row, that the host writes into
the server's int32 control words (``_ctrl``) before the launch, so one
graph serves every slot, as JAX's traced ``row`` does. ``graphs=False``
runs prefills and steps eagerly, to compare (the splice the same kernel,
launched eagerly), and the CPU always does (its plain version). The
per-slot sampling controls are static (slots,) buffers that an admission
rewrites.

``run_events`` (JAX ``_event_fn``) decodes until a scheduling event
through ``models.delay.delay_decode_until_event``: on the card one launch
of a loop graph whose condition kernel reads the watched stop flags after
every step, so it stops after the step at which the event holds, as JAX
does. ``run_drain`` (JAX ``_drain_fn``) stages the whole queue on the
device once and runs JAX's scheduler there: on the card each attend
bucket's segment is one launch of a loop graph whose body admits the next
request into the first free slot (an admission kernel that writes the
slot into the control words, then, per prompt bucket, an IF node that
gathers the staged prompt row and replays the bucket's admission graph,
the one ``run`` replays: prefill and splice), decodes one
step and writes stopped slots' frames into their request's result row
(a collect kernel); the host reads the queue cursor, the slots' flags and
cursors once per segment and the results once at the end.

Differences from the JAX server, by design: the splice copies lanes and
pages into the running state in place; the pipelined ``run`` snapshots the
stop flags with a non-blocking copy to pinned host memory plus a CUDA
event, enqueued before the next block, and waits on that event only after
the block is enqueued. A request's seed goes through the same integer hash
as in JAX into its key, and the draws are JAX's threefry bits, so a seeded
request reproduces whatever slot it lands in, and sampled streams equal
JAX's. A preempted request resumes with its own sampling overrides and seed
(the JAX server requeues it without them, so it resumes at the server's
defaults). The server serves whatever params it is given, int8 weights
(``DelayEngine.quantize``) included, in all four cache modes.

``mesh=`` (``parallel.mesh.make_mesh``) serves the model tensor-parallel over
``"model"``: the params are sharded in place (``delay_param_specs``), each
rank's caches hold its KV heads, and every rank runs the same scheduler on
the same requests (SPMD), its steps' collectives inside the graphs. The
batch-1 prefill splice cannot split the batch, so, as in JAX, a mesh with
``data > 1`` raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DelayConfig
from ..models.delay import (
    SENTINEL,
    DelayGenState,
    DelayParams,
    DelaySampling,
    delay_decode_until_event,
    make_sampling,
    rank_delay_config,
)
from ..nn.qwen3 import init_kv_cache, init_paged_kv_cache, init_quant_kv_cache
from ..ops import sampling as sampling_ops
from ..ops.kernels import graph_loop, launches
from ..ops.kernels.graph_loop import Part, RowCopy
from .delay_engine import attend_bucket
from .polling import request_seed, run_pipelined
from .step_graph import DecodeSteps, Prefills, host_tensor, zero_state


@dataclass
class _Request:
    request_id: int
    input_ids: np.ndarray  # (T, C)
    max_new_tokens: int
    start_length: int
    sampling: Optional[dict] = None  # per-request generation config
    seed: Optional[int] = None  # caller rng seed; None = derive from id


@dataclass
class CompletedRequest:
    request_id: int
    start_length: int
    tokens: np.ndarray  # (start .. prompt+generated, C) reference output shape
    steps: int


_ROW_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "rng", "is_stopping", "is_audio",
               "audio_lengths", "delayed", "seen")


def splice_parts(big: DelayGenState, small: DelayGenState, ctrl: torch.Tensor,
                 n0: Optional[int] = None) -> list:
    """An admission's splice of the batch-1 state ``small`` into the slot
    ``ctrl[SLOT]`` of ``big`` as row-copy parts (``graph_loop.RowCopy``;
    JAX's ``_insert_row``, a traced row): every per-row field, the key
    included, ``out``/``out_valid`` with the tail past ``small``'s capacity
    zeroed, and the slot's cache lane (each cache field's batch on axis 1).
    Paged, ``n0`` pages (JAX's ``_insert_paged_fn(n0)``): the small linear
    cache's first ``n0`` pages of slots into the pool pages
    ``ctrl[TABLE_ROW + j]`` instead, and the slot's table row from the
    words at ``TABLE_ROW`` on (the pages, then zeros: the trash page)."""
    S, R = graph_loop.SLOT, graph_loop.TABLE_ROW
    if n0 is None:
        parts = [Part(bf, sf, dst_word=S, dst_axis=1, src_axis=1)
                 for bf, sf in zip(big.cache, small.cache)]
    else:
        pool = big.cache
        psz, npp = pool.page_size, pool.table.shape[1]
        parts = [Part(pb, sb[:, :, :, j * psz:(j + 1) * psz], dst_word=R + j, dst_axis=1,
                      src_axis=1)
                 for pb, sb in zip(pool[:-1], small.cache) for j in range(n0)]
        parts.append(Part(pool.table, ctrl[R:R + npp].view(1, npp), dst_word=S))
    parts += [Part(getattr(big, f), getattr(small, f), dst_word=S) for f in _ROW_FIELDS]
    for f in ("out", "out_valid"):
        dst, src = getattr(big, f), getattr(small, f)
        n = src.shape[1]
        parts += [Part(dst[:, :n], src, dst_word=S), Part(dst[:, n:], None, dst_word=S)]
    return parts


def table_entry_parts(table: torch.Tensor, ctrl: torch.Tensor) -> list:
    """JAX's ``_table_entry_fn``, ``table[row, col] = page``: the entry
    ``ctrl[ENTRY]`` (``row * width + col``) takes the page ``ctrl[PAGE]``."""
    return [Part(table.view(-1), ctrl[graph_loop.PAGE:graph_loop.PAGE + 1],
                 dst_word=graph_loop.ENTRY)]


def table_clear_parts(table: torch.Tensor) -> list:
    """JAX's ``_table_clear_fn``, ``table[row] = 0``: the row ``ctrl[SLOT]``
    at the trash page."""
    return [Part(table, None, dst_word=graph_loop.SLOT)]


def _pages(Tb: int, page_size: int) -> int:
    """The pages a prompt bucket's admission fills (page size 0: linear,
    none)."""
    return -(-Tb // page_size) if page_size else 0


def _run_splice(splices: dict, page_size: int, key: tuple) -> None:
    """The end of a prefill program at ``key``: the splice of its bucket."""
    splices[_pages(key[0], page_size)]()


def request_key(seed: int) -> np.ndarray:
    """A request's row key: JAX's ``PRNGKey(seed)`` split into one row, as
    its ``delay_prefill`` splits a scalar key (2,) int64."""
    return sampling_ops.split(sampling_ops.prng_key(seed)[None], 1)[0, 0].numpy()


def _request_seed(seed: Optional[int], request_id: int) -> int:
    """The JAX server's per-request key seed (``batch_server.py:903-906``,
    its key ``PRNGKey`` of it, ``request_key``):
    an explicit seed reproduces across processes and server lifetimes, and
    the request id enters only unseeded streams."""
    return request_seed(0xD317A9, seed if seed is not None else request_id)


class DelayBatchServer:
    """Ports ``mosstts_tpu.engine.batch_server.DelayBatchServer``. The server
    runs where ``params`` live (the card, or the CPU for tests). ``graphs``
    (on the card): replay each decode step as a CUDA graph; False runs the
    steps eagerly, to compare. The graphs read ``params`` where they are:
    build a new server after quantizing them."""

    def __init__(
        self,
        params: DelayParams,
        config: DelayConfig,
        *,
        slots: int = 8,
        cache_len: int = 2048,
        out_capacity: int = 1024,
        prompt_bucket: int = 64,
        dtype=torch.bfloat16,
        sampling: Optional[DelaySampling] = None,
        top_k_text: int = 50,
        top_k_audio: int = 25,
        kv_quant: bool = False,
        poll_every: int = 4,
        paged: bool = False,
        page_size: int = 128,
        num_pages: Optional[int] = None,
        graphs: bool = True,
        mesh=None,
    ):
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import delay_param_specs, shard_params

            if mesh.size(mesh.mesh_dim_names.index("data")) != 1:
                raise ValueError("DelayBatchServer mesh must have data=1 (batch-1 prefill "
                                 "splice); shard the backbone on 'model' only")
            shard_params(params, mesh, delay_param_specs())
        self.params = params
        self.config = config
        self._cache_config = rank_delay_config(config, params)  # this rank's KV heads
        self.device = params.text_head.device
        self.slots = slots
        self.cache_len = cache_len
        self.out_capacity = out_capacity
        self.prompt_bucket = prompt_bucket
        self.dtype = dtype
        self.sampling = sampling or make_sampling(device=self.device)
        self.top_k_text = top_k_text
        self.top_k_audio = top_k_audio
        # int8 KV cache for the running batch and the per-request prefills
        self.kv_quant = kv_quant
        # Device stop flags are read every ``poll_every`` steps (or when the
        # host step mirror says a slot hit its budget). pos/step advance by
        # exactly 1 per decode step for every row, so they are mirrored on
        # the host and a step needs no device sync.
        self.poll_every = poll_every
        # Paged KV: the slots' logical [0, cache_len) map through a page
        # table into a shared pool of ``num_pages`` pages (default: 1 trash
        # page + 60% of the linear footprint). Admission waits in the queue
        # when the prompt doesn't fit; decode-time growth draws one page at
        # a time from the free list.
        self.paged = paged
        self.page_size = page_size
        if paged:
            if cache_len % page_size:
                raise ValueError(f"cache_len {cache_len} is not a multiple of page_size "
                                 f"{page_size}")
            full = slots * (cache_len // page_size)
            self.num_pages = num_pages if num_pages else 1 + (full * 6) // 10
            self._free_pages = list(range(self.num_pages - 1, 0, -1))
            self._slot_pages: Dict[int, List[int]] = {s: [] for s in range(slots)}

        self._ids = itertools.count()
        self._queue: List[_Request] = []
        self._active: Dict[int, _Request] = {}  # slot -> request
        self.state = self._empty_state()
        self.total_steps = 0
        self.util_sum = 0.0  # sum over steps of active/slots (mean = /total_steps)
        self.total_preemptions = 0
        self.total_dispatches = 0  # decode programs run: a step, a block, an event block,
        # a drain segment (the JAX server's count of device programs)
        # host mirrors of state.pos / state.step
        self._pos_host = np.zeros(self.slots, np.int64)
        self._step_host = np.full(self.slots, self.out_capacity, np.int64)

        # Per-slot sampling: host arrays hold the transformed knobs of each
        # slot's request; the static (slots,) device tensors are rewritten
        # from them only when an admission changes a slot.
        d = self.sampling

        def _f(x):
            return float(torch.as_tensor(x).float())

        self._samp_default = {
            "text_temperature": _f(d.text_temperature),
            "text_top_p": _f(d.text_top_p),
            "audio_temperature": _f(d.audio_temperature),
            "audio_top_p": _f(d.audio_top_p),
            "audio_repetition_penalty": _f(d.audio_repetition_penalty),
            "text_do_sample": bool(d.text_do_sample),
            "audio_do_sample": bool(d.audio_do_sample),
        }
        self._samp_host = {
            k: np.full(self.slots, v, np.bool_ if isinstance(v, bool) else np.float32)
            for k, v in self._samp_default.items()
        }
        dev = self.device
        self._samp_dev = DelaySampling(
            audio_rp_cross_batch=torch.as_tensor(bool(d.audio_rp_cross_batch), device=dev),
            **{k: torch.as_tensor(v, device=dev) for k, v in self._samp_host.items()})
        self._samp_stale = False
        self._steps = DecodeSteps(params, config, self.state, self._samp_dev, graphs=graphs)
        # the admissions' static batch-1 state (a linear cache of cache_len
        # slots) and sampling, and the prefill graphs over them
        self._small = zero_state(self._cache_config, 1, cache_len, 1, dtype=dtype,
                                 kv_quant=kv_quant, device=dev)
        self._prefill_samp = make_sampling(
            audio_rp_cross_batch=bool(d.audio_rp_cross_batch), device=dev)
        # the admissions' control words (graph_loop: SLOT, the paged table
        # row at TABLE_ROW, a table entry's ENTRY and PAGE), written by the
        # host before a launch; run_drain's loops use them as theirs
        npp = cache_len // page_size if paged else 0
        self._ctrl = torch.zeros(graph_loop.CTRL_WORDS + npp, dtype=torch.int32, device=dev)
        # the splice of _small into the slot, per page count (0: linear)
        self._splices: Dict[int, RowCopy] = {}
        if paged:
            table = self.state.cache.table
            self._table_entry = RowCopy(table_entry_parts(table, self._ctrl), self._ctrl, 1)
            self._table_clear = RowCopy(table_clear_parts(table), self._ctrl, 1)
        # each bucket's admission program: the prefill, then the splice (the
        # hook holds the splices, not the server: no reference cycle)
        self._prefills = Prefills(self._steps, self._small, self._prefill_samp,
                                  after=functools.partial(_run_splice, self._splices,
                                                          page_size if paged else 0))
        self._splice(prompt_bucket)  # linear: every bucket's splice, made before any capture
        # run_drain's static staging buffers per (prompt buckets, nqcap), and
        # their loop graphs per attend bucket (JAX's compiled _drain_fn
        # programs), kept for the server's life
        self._drains: Dict[tuple, "_Drain"] = {}

    # ------------------------------------------------------------------
    def _empty_state(self) -> DelayGenState:
        B, C, dev = self.slots, self.config.channels, self.device
        lc = self._cache_config.language_config
        if self.paged:
            cache = init_paged_kv_cache(lc, B, self.cache_len, self.num_pages,
                                        page_size=self.page_size, dtype=self.dtype,
                                        quant=self.kv_quant, device=dev)
        elif self.kv_quant:
            cache = init_quant_kv_cache(lc, B, self.cache_len, device=dev)
        else:
            cache = init_kv_cache(lc, B, self.cache_len, dtype=self.dtype, device=dev)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return DelayGenState(
            cache=cache,
            kv_valid=full((B, self.cache_len), False, torch.bool),
            cur_ids=full((B, 1, C), 0, torch.int64),
            pos=full((B,), 0, torch.int32),
            step=full((B,), self.out_capacity, torch.int32),  # idle: out writes drop
            rng=full((B, 2), 0, torch.int64),
            is_stopping=full((B,), True, torch.bool),  # idle slots are "stopped"
            is_audio=full((B,), False, torch.bool),
            audio_lengths=full((B,), 0, torch.int32),
            delayed=full((B,), SENTINEL, torch.int32),
            seen=full((B, self.config.n_vq, self.config.audio_emb_vocab), False, torch.bool),
            out=full((B, self.out_capacity, C), 0, torch.int32),
            out_valid=full((B, self.out_capacity), False, torch.bool),
        )

    # ---- per-slot sampling -------------------------------------------
    def _request_sampling_values(self, overrides: Optional[dict]) -> dict:
        """Server defaults with the request's overrides applied
        (temperature <= 0 = greedy)."""
        vals = dict(self._samp_default)
        overrides = overrides or {}
        for chan in ("text", "audio"):
            t = overrides.get(f"{chan}_temperature")
            if t is not None:
                vals[f"{chan}_temperature"] = t if t > 0 else 1.0
                vals[f"{chan}_do_sample"] = t > 0
        for k in ("text_top_p", "audio_top_p", "audio_repetition_penalty"):
            if overrides.get(k) is not None:
                vals[k] = overrides[k]
        return vals

    def _set_slot_sampling(self, slot: int, overrides: dict) -> None:
        h = self._samp_host
        for k, v in self._request_sampling_values(overrides).items():
            h[k][slot] = v
        self._samp_stale = True

    def _sync_sampling(self) -> None:
        """Rewrite the static per-slot sampling tensors from the host arrays
        if an admission changed them."""
        if self._samp_stale:
            for k, v in self._samp_host.items():
                getattr(self._samp_dev, k).copy_(host_tensor(v, self.device), non_blocking=True)
            self._samp_stale = False

    # ---- host page allocator (driven by the pos mirrors: no syncs) ----
    def _grow_pages(self, slot: int, upto_slot: int) -> bool:
        """Ensure slot's logical pages cover write position ``upto_slot``,
        drawing from the free list and patching the device table. Returns
        False when the pool is exhausted."""
        need = min(upto_slot // self.page_size + 1, self.cache_len // self.page_size)
        pages = self._slot_pages[slot]
        while len(pages) < need:
            if not self._free_pages:
                return False
            pg = self._free_pages.pop()
            graph_loop.set_words(self._ctrl, graph_loop.ENTRY,
                                 [slot * self.state.cache.table.shape[1] + len(pages), pg])
            self._table_entry()
            pages.append(pg)
        return True

    def _free_slot_pages(self, slot: int) -> None:
        """Return slot's pages to the pool; its table row then points at the
        trash page 0, so the idle row's writes land there instead of in
        pages now owned by other slots."""
        self._free_pages.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        graph_loop.set_words(self._ctrl, graph_loop.SLOT, [slot])
        self._table_clear()

    # ---- decode ----------------------------------------------------------
    def _step_kw(self, attend: int) -> dict:
        return dict(attend_len=attend, uniform_slots=False, top_k_text=self.top_k_text,
                    top_k_audio=self.top_k_audio)

    def _decode_steps(self, attend: int, k: int) -> None:
        """``k`` decode steps of the whole batch at attend bucket ``attend``,
        in place: on the card one replay of that bucket's graph, or for k >
        1 one launch of a graph looping over it k times (JAX's
        ``_block_fn``)."""
        self._sync_sampling()
        if k == 1:
            self._steps.step(**self._step_kw(attend))
        else:
            self._steps.loop_block(k, **self._step_kw(attend))

    def _dispatch_block(self, k: int) -> int:
        """Admit queued requests into free slots, then run ``k`` decode
        steps. Returns the steps run (0 if nothing is active). A slot that
        hits its token budget mid-block overshoots by at most k-1 masked
        steps (k <= poll_every, which submit() reserves as cache slack);
        _collect trims the output to the requested count."""
        self._fill_free_slots()
        if not self._active:
            return 0
        if self.paged:
            # Grow every active slot's pages to cover the whole block; a slot
            # that cannot grow is preempted. Dispatch only when every slot
            # still active is grown: an ungrown slot's writes would route
            # through table entry 0 (the shared trash page) and lose its KV.
            # On total preemption the pool is free again: re-admit and grow
            # again. The attempt bound breaks an admit -> grow-fail ->
            # preempt livelock (a preempt-merged prompt outgrowing the pool).
            attempts = 0
            while True:
                for slot in sorted(self._active):
                    if not self._grow_pages(slot, int(self._pos_host[slot]) + k - 1):
                        self._preempt(slot)
                if self._active:
                    break
                attempts += 1
                if attempts > self.slots + 2:
                    return 0
                self._fill_free_slots()
                if not self._active:
                    return 0
        active = sorted(self._active)
        max_pos = int(self._pos_host[active].max())
        attend = attend_bucket(max_pos + k + 1, 256, self.cache_len)
        self._decode_steps(attend, k)
        self.total_steps += k
        self.total_dispatches += 1
        self.util_sum += k * (len(self._active) / self.slots)
        self._pos_host += k
        self._step_host += k
        return k

    def step_block(self, k: Optional[int] = None) -> List[CompletedRequest]:
        """One poll window: admit, run ``k`` (default poll_every) decode
        steps, then collect. The building block for hosts that interleave
        their own work between windows; completions lag <= k-1 steps."""
        k = self.poll_every if k is None else k
        if self._dispatch_block(k) == 0:
            return []
        return self._collect()

    # ------------------------------------------------------------------
    def submit(self, input_ids: np.ndarray, *, max_new_tokens: int = 256,
               sampling: Optional[dict] = None, seed: Optional[int] = None) -> int:
        """Queue a request, a (T, C) grid from the processor; returns its id.

        ``sampling`` overrides the server defaults for this request: any of
        text_temperature / text_top_p / audio_temperature / audio_top_p /
        audio_repetition_penalty (temperature <= 0 = greedy). Raises
        ``ValueError`` for an unknown override, a malformed grid, or a
        request the cache (linear) or the pool (paged) can never hold."""
        if sampling:
            bad = set(sampling) - {f"{c}_temperature" for c in ("text", "audio")} \
                - {"text_top_p", "audio_top_p", "audio_repetition_penalty"}
            if bad:
                raise ValueError(f"unknown sampling overrides: {sorted(bad)}")
        input_ids = np.asarray(input_ids, np.int64)
        if input_ids.ndim != 2 or input_ids.shape[1] != self.config.channels:
            raise ValueError(f"expected (T, {self.config.channels}) grid")
        cfg = self.config
        matches = np.nonzero(input_ids[:, 0] == cfg.im_start_token_id)[0]
        start_idx = int(matches[-1]) + 3 if len(matches) else 0
        Tb = (-(-input_ids.shape[0] // self.prompt_bucket)) * self.prompt_bucket
        budget = min(max_new_tokens, self.out_capacity)
        if not self.paged:
            # KV writes past cache_len would be dropped: reject here rather
            # than produce silently degraded audio
            if Tb + budget + self.poll_every > self.cache_len:
                raise ValueError(
                    f"prompt ({Tb} bucketed) + max_new_tokens ({budget}) exceeds "
                    f"cache_len={self.cache_len}; raise cache_len or use paged mode")
        else:
            # a request the pool can never hold, even alone, would preempt
            # itself forever
            worst = min(-(-(Tb + budget) // self.page_size), self.cache_len // self.page_size)
            if worst > self.num_pages - 1:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool has "
                    f"{self.num_pages - 1}; raise num_pages or shorten the prompt")
        rid = next(self._ids)
        self._queue.append(_Request(
            request_id=rid, input_ids=input_ids, max_new_tokens=budget,
            start_length=input_ids.shape[0] - start_idx,
            sampling=dict(sampling) if sampling else None, seed=seed))
        return rid

    @torch.no_grad()
    def _admit(self, slot: int, req: _Request) -> bool:
        T = req.input_ids.shape[0]
        Tb = ((T + self.prompt_bucket - 1) // self.prompt_bucket) * self.prompt_bucket
        pages = None
        if self.paged:
            n0 = -(-Tb // self.page_size)
            if len(self._free_pages) < n0:
                return False  # the request waits for pages to free up
            pages = [self._free_pages.pop() for _ in range(n0)]
            self._slot_pages[slot] = pages
        ids = np.full((1, Tb, self.config.channels), self.config.audio_pad_code, np.int64)
        ids[..., 0] = self.config.pad_token_id
        ids[0, Tb - T:] = req.input_ids
        mask = np.zeros((1, Tb), bool)
        mask[0, Tb - T:] = True
        self._set_slot_sampling(slot, req.sampling or {})
        for k, v in self._samp_host.items():
            getattr(self._prefill_samp, k).fill_(v[slot].item())
        self._prefill_into(slot, host_tensor(ids, self.device), host_tensor(mask, self.device),
                           _request_seed(req.seed, req.request_id), pages)
        self._active[slot] = req
        return True

    def _splice(self, Tb: int) -> RowCopy:
        """The splice of bucket ``Tb``'s admissions, made at its first use,
        outside any capture."""
        n0 = _pages(Tb, self.page_size if self.paged else 0)
        rc = self._splices.get(n0)
        if rc is None:
            rc = self._splices[n0] = RowCopy(
                splice_parts(self.state, self._small, self._ctrl, n0 if self.paged else None),
                self._ctrl)
        return rc

    def _aim(self, slot: int, pages=()) -> None:
        """Point the next splice at ``slot`` (paged: its ``pages``, the
        table row's rest at the trash page 0)."""
        row = list(pages) + [0] * (self._ctrl.shape[0] - graph_loop.TABLE_ROW - len(pages))
        graph_loop.set_words(self._ctrl, graph_loop.SLOT,
                             [slot] + [0] * (graph_loop.TABLE_ROW - graph_loop.SLOT - 1) + row)

    def _aim_nowhere(self) -> None:
        """A slot and pages out of range: the splice drops every row (a
        capture's eager warm-up must not write into the pool)."""
        n = self._ctrl.shape[0] - graph_loop.TABLE_ROW
        self._aim(self.slots, [self.num_pages] * n if self.paged else ())

    def _prefill_into(self, slot: int, ids, mask, seed: int, pages=None) -> None:
        """The admission program of the bucket ``ids.shape[1]`` (one graph
        replay on the card): prefill the batch-1 prompt ``ids``/``mask``
        into the static admission state, drawing from the key of ``seed``
        (``request_key``), with the prefill sampling as it stands, and
        splice it into ``slot`` (paged: into ``pages``), its key with it,
        at the control words the host writes first."""
        self._small.rng.copy_(host_tensor(request_key(seed)[None], self.device),
                              non_blocking=True)
        Tb = ids.shape[1]
        self._splice(Tb)
        self._aim(slot, pages or ())
        self._prefills.run(ids, mask, top_k_text=self.top_k_text, top_k_audio=self.top_k_audio)
        # mirror the spliced cursors (delay_prefill sets pos=Tb, step=0)
        self._pos_host[slot] = Tb
        self._step_host[slot] = 0

    def _fill_free_slots(self) -> None:
        if not self._queue:
            return
        busy = set(self._active)
        for slot in range(self.slots):
            if not self._queue:
                break
            if slot not in busy:
                if not self._admit(slot, self._queue[0]):
                    break  # FIFO: wait for pages rather than skip ahead
                self._queue.pop(0)

    def step(self, *, poll: Optional[bool] = None) -> List[CompletedRequest]:
        """Admit queued requests into free slots, run one decode step of the
        whole batch, and collect completions.

        The step needs no host sync: the attend bucket comes from the host
        pos mirror. The stop flags are read every ``poll_every`` steps, or
        when the host step mirror proves a slot hit its token budget; pass
        ``poll=True`` to force a read. A finished slot may idle for up to
        poll_every-1 masked steps before it is collected."""
        self._fill_free_slots()
        if not self._active:
            return []
        if self.paged:
            # the pos mirrors say which slots write into a fresh logical page
            # this step; draw from the free list, preempting on exhaustion
            for slot in sorted(self._active):
                if not self._grow_pages(slot, int(self._pos_host[slot])):
                    self._preempt(slot)
            if not self._active:
                return []
        # the attend bucket covers the furthest active cursor (idle slots keep
        # advancing; their writes and reads are masked or dropped)
        active = sorted(self._active)
        max_pos = int(self._pos_host[active].max())
        self._decode_steps(attend_bucket(max_pos + 2, 256, self.cache_len), 1)
        self.total_steps += 1
        self.total_dispatches += 1
        self.util_sum += len(self._active) / self.slots
        self._pos_host += 1
        self._step_host += 1
        if poll is None:
            poll = (self.total_steps % self.poll_every == 0
                    or any(self._step_host[s] >= self._active[s].max_new_tokens
                           for s in active))
        return self._collect() if poll else []

    def _preempt(self, slot: int) -> None:
        """Pool exhausted: evict this slot, folding its generated tokens into
        the prompt and requeueing it at the front (recompute preemption: one
        extra prefill instead of a failure). Progress needs the pool to hold
        at least one full stream."""
        req = self._active.pop(slot)
        self.total_preemptions += 1
        n = int(min(self._step_host[slot], req.max_new_tokens))
        gen = self.state.out[slot, :n].cpu().numpy()
        self._free_slot_pages(slot)
        # delay_prefill rebuilds the state machine from the grid's last text
        # token; a fold ending inside the delay-drain window would rebuild as
        # "not generating audio", so trim back to the last gen-slot row and
        # let the resumed decode decide the drain again
        cfg = self.config
        while n and gen[n - 1, 0] in (cfg.audio_assistant_delay_slot_token_id,
                                      cfg.audio_end_token_id):
            n -= 1
        merged = np.concatenate([req.input_ids, gen[:n].astype(np.int64)], axis=0)
        self._queue.insert(0, _Request(
            request_id=req.request_id, input_ids=merged,
            max_new_tokens=req.max_new_tokens - n, start_length=req.start_length + n,
            sampling=req.sampling, seed=req.seed))

    def _collect(self, stopped: Optional[np.ndarray] = None) -> List[CompletedRequest]:
        """One transfer for the stop flags (unless given), then one transfer
        of the whole out buffer for the finished slots' grids."""
        if stopped is None:
            stopped = self.state.is_stopping.cpu().numpy()
        finished = [(slot, req) for slot, req in sorted(self._active.items())
                    if stopped[slot] or self._step_host[slot] >= req.max_new_tokens]
        if not finished:
            return []
        outs_all = self.state.out.cpu().numpy()
        done: List[CompletedRequest] = []
        for slot, req in finished:
            n = int(min(self._step_host[slot], req.max_new_tokens))
            full = np.concatenate([req.input_ids, outs_all[slot, :n].astype(np.int64)], axis=0)
            start_idx = req.input_ids.shape[0] - req.start_length
            done.append(CompletedRequest(request_id=req.request_id,
                                         start_length=req.start_length,
                                         tokens=full[start_idx:], steps=n))
            del self._active[slot]
            if self.paged:
                self._free_slot_pages(slot)
        return done

    def run(self, max_steps: int = 100000, pipelined: bool = True) -> List[CompletedRequest]:
        """Drain the queue and the active slots; returns completions in
        finish order. ``pipelined`` hides each poll's host round trip
        behind the next block of ``poll_every`` decode steps
        (``polling.run_pipelined``): EOS detection lags up to one block
        (masked idle steps that the processor's im_end trim discards);
        budget completions come from the host mirrors and stay exact."""
        if pipelined:
            return run_pipelined(self, lambda room: self._dispatch_block(
                min(self.poll_every, room)), lambda: self.state.is_stopping, max_steps)
        out: List[CompletedRequest] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self._active and not self._queue:
                break
        return out

    # ---- event-driven dispatch -------------------------------------------
    def _dispatch_event(self, max_k: int) -> Tuple[int, Optional[np.ndarray]]:
        """Admit queued requests, then decode until a scheduling event (JAX
        ``_dispatch_event``). Returns ``(steps executed, stop flags | None)``:
        the flags are read after the block, and no admission happens in
        between, so they map onto the current occupants."""
        self._fill_free_slots()
        attempts = 0
        while True:  # recompute the geometry whenever the occupancy changes
            if not self._active:
                return 0, None
            active = sorted(self._active)
            max_pos = int(self._pos_host[active].max())
            # one graph per attend bucket: cap the block at the bucket's end
            attend = attend_bucket(max_pos + 2, 256, self.cache_len)
            k_bucket = attend - max_pos - 1
            budget = np.full(self.slots, 1 << 30, np.int64)
            for s, req in self._active.items():
                budget[s] = req.max_new_tokens - self._step_host[s]
            k_cap = int(min(max_k, k_bucket, int(budget[active].min())))
            if k_cap <= 0:
                return 0, None
            if not self.paged:
                break
            # _dispatch_block's growth rule: every slot still active after
            # the grow pass covers the whole block
            for slot in active:
                if not self._grow_pages(slot, int(self._pos_host[slot]) + k_cap - 1):
                    self._preempt(slot)
            if self._active:
                break
            attempts += 1
            if attempts > self.slots + 2:
                return 0, None
            # total preemption: the pool is free again; re-admit and
            # recompute (a preempt-merged prompt may pass the old max_pos)
            self._fill_free_slots()
        # watch only the current occupants: a preempted row's stale flag or
        # budget must not end the block
        watch = np.zeros(self.slots, bool)
        watch[sorted(self._active)] = True
        self._sync_sampling()
        _, did, flags = delay_decode_until_event(
            self._steps, watch, budget, k_cap, top_k_text=self.top_k_text,
            top_k_audio=self.top_k_audio, attend_len=attend)
        self.total_steps += did
        self.total_dispatches += 1
        self.util_sum += did * (len(self._active) / self.slots)
        self._pos_host += did
        self._step_host += did
        return did, flags

    def run_events(self, max_steps: int = 100000) -> List[CompletedRequest]:
        """Drain the queue and the active slots with event-driven dispatch
        (JAX ``run_events``): each block decodes until a slot needs the
        scheduler (EOS or budget), so a stretch with no completions costs
        one dispatch. Completions in finish order; the token streams equal
        ``run()``'s, and a block ends after the step that emitted a watched
        row's EOS, on the card as on the CPU."""
        out: List[CompletedRequest] = []
        steps = 0
        while True:
            if self._active:
                # budget completions are host-knowable: free those slots
                # before dispatching so the block admits into them
                out.extend(self._collect(stopped=np.zeros(self.slots, bool)))
            if not (self._active or self._queue):
                break
            did, flags = self._dispatch_event(max_steps - steps)
            steps += did
            got = self._collect(stopped=flags) if flags is not None else []
            out.extend(got)
            if did == 0 and not got:
                # no progress is possible (max_steps used up, or a paged
                # admission failed): surface what is left in the queue
                if self._queue:
                    logging.getLogger(__name__).warning(
                        "run_events() stopping with %d undrained request(s) still queued "
                        "(ids %s)", len(self._queue), [r.request_id for r in self._queue])
                break
        return out

    # ---- the drain scheduler -------------------------------------------------
    @torch.no_grad()
    def run_drain(self, max_steps: int = 100000) -> List[CompletedRequest]:
        """Drain the queue with JAX's drain scheduler (``_drain_fn``,
        ``run_drain``): the queue is staged on the device once (left-padded
        prompts (nqcap, t_max, C) with nqcap rounded up to 16, masks, prompt
        bucket indices, budgets, keys and sampling rows), then each step
        admits the next request into the first free slot while one is free
        (its bucket's prefill from its staged row, spliced into the slot),
        decodes one step, and writes the stopped slots' frames into their
        request's result row (JAX's ``(qi < qn | any(active)) & ~any(active
        & pos >= attend) & i < max_steps`` is checked after every step). A
        segment keeps one attend bucket until an active row reaches it: on
        the card one launch of the drain graph (module docstring), then one
        read of the queue cursor, the slots and the step count; the results
        are read once at the end. Returns the completions in queue order,
        each request with its prompt bucket, ``min(max_new_tokens,
        out_capacity)`` budget, sampling overrides and seed, ``steps =
        min(step, budget)``. Linear cache and an idle server only;
        ``util_sum`` is not updated."""
        if self.paged:
            raise ValueError("run_drain requires the linear cache; use run()/run_events for "
                             "paged serving")
        if self._active:
            raise ValueError("run_drain requires an idle pool")
        reqs = list(self._queue)
        self._queue.clear()
        if not reqs:
            return []
        cfg, pb = self.config, self.prompt_bucket
        C, NQ = cfg.channels, len(reqs)
        nqcap = -(-NQ // 16) * 16
        tbs = [-(-r.input_ids.shape[0] // pb) * pb for r in reqs]
        buckets = tuple(sorted(set(tbs)))
        t_max = buckets[-1]
        prompts = np.full((nqcap, t_max, C), cfg.audio_pad_code, np.int64)
        prompts[..., 0] = cfg.pad_token_id
        masks = np.zeros((nqcap, t_max), bool)
        qbucket = np.zeros(nqcap, np.int32)
        qbudget = np.zeros(nqcap, np.int32)
        qkeys = np.zeros((nqcap, 2), np.int64)
        vals = {k: np.zeros(nqcap, v.dtype) for k, v in self._samp_host.items()}
        for idx, r in enumerate(reqs):
            T = r.input_ids.shape[0]
            prompts[idx, t_max - T:] = r.input_ids
            masks[idx, t_max - T:] = True
            qbucket[idx] = buckets.index(tbs[idx])
            qbudget[idx] = min(r.max_new_tokens, self.out_capacity)
            qkeys[idx] = request_key(_request_seed(r.seed, r.request_id))
            for k, v in self._request_sampling_values(r.sampling).items():
                vals[k][idx] = v
        dr = self._drains.get((buckets, nqcap))
        if dr is None:
            dr = self._drains[buckets, nqcap] = _Drain(self, buckets, nqcap)
        self._sync_sampling()
        if self._steps.graphs:
            dr.capture_steps(self)
        dr.stage(prompts, masks, qbucket, qbudget, qkeys, vals, NQ, max_steps)

        pos_floor = t_max  # any admission lands at its bucket, <= t_max
        prev_i = -1
        while True:
            attend = attend_bucket(pos_floor + 2, 256, self.cache_len)
            qi, act, pos, i = dr.segment(self, attend)
            self.total_dispatches += 1
            done = qi >= NQ and not act.any()
            stuck = i == prev_i and attend >= self.cache_len
            if done or i >= max_steps or stuck:
                if not done:
                    logging.getLogger(__name__).warning(
                        "run_drain() stopped with work remaining (steps=%d, stuck=%s)", i, stuck)
                break
            prev_i = i
            pos_floor = max(int(np.max(np.where(act, pos, 0))), t_max if qi < NQ else 0)
        self.total_steps += i
        # the slots' sampling rows now hold the drained requests': the next
        # admission rewrites them all from the host arrays
        self._samp_stale = True
        # per-step occupancy is not tracked: util_sum is not updated, as in JAX
        self._pos_host[:] = pos
        self._step_host[:] = 1 << 30
        res, rsteps = dr.results(NQ)
        out: List[CompletedRequest] = []
        for idx, req in enumerate(reqs):
            n = int(rsteps[idx])
            full = np.concatenate([req.input_ids, res[idx, :n].astype(np.int64)], axis=0)
            start_idx = req.input_ids.shape[0] - req.start_length
            out.append(CompletedRequest(request_id=req.request_id,
                                        start_length=req.start_length,
                                        tokens=full[start_idx:], steps=n))
        return out

    def warmup(self, *, prompt_lens=(64,), attend_upto: Optional[int] = None) -> None:
        """Run every path the serving loop can hit once before live traffic:
        dummy requests of each prompt length in ``prompt_lens`` through
        submit/run (the kernel build, an eager prefill and the splice), on
        the card the capture of each of their buckets' prefill graphs, then
        a decode step on the idle state at every attend bucket up to
        ``attend_upto`` (default: the full cache), which on the card
        captures the bucket's graph (one eager step, then the capture).
        ``run_events`` and ``run_drain`` replay the same graphs. Idle rows'
        cache writes are masked and their out writes drop, and an admission
        overwrites every per-row field, so the extra steps cannot leak into
        later requests."""
        if self._active or self._queue:
            raise RuntimeError("warmup on a busy server")
        cfg = self.config
        for T in prompt_lens:
            g = np.full((int(T), cfg.channels), cfg.audio_pad_code, np.int64)
            g[:, 0] = cfg.pad_token_id
            g[-1, 0] = cfg.audio_assistant_gen_slot_token_id
            self.submit(g, max_new_tokens=2)
        self.run()
        self._aim_nowhere()
        for Tb in sorted({-(-int(T) // self.prompt_bucket) * self.prompt_bucket
                          for T in prompt_lens}):
            self._splice(Tb)
            self._prefills.capture(Tb, top_k_text=self.top_k_text, top_k_audio=self.top_k_audio)
        upto = min(attend_upto or self.cache_len, self.cache_len)
        pos = 2
        while True:
            a = attend_bucket(pos, 256, self.cache_len)
            self._decode_steps(a, 1)
            if a >= upto:
                break
            pos = a + 1
        self.state.pos.cpu()  # wait for the device

    @property
    def utilization(self) -> float:
        return len(self._active) / self.slots


class _Drain:
    """``run_drain``'s static device buffers for one (prompt buckets,
    nqcap): the staged queue (prompts, masks, bucket indices, budgets, keys,
    sampling rows), the scheduler's slot state (``active``, ``slot_rid``,
    ``budget``), the result rows and the control words
    (``graph_loop.CTRL_WORDS``: the step count, the cap, the queue cursor
    and size, the admission's slot and request), and, on the card, one drain
    graph per attend bucket (``graph_loop.build_drain``) with the copy
    segments it gathers and splices with. The server holds its drains and
    passes itself to their methods (no reference back: the server's graphs
    go with it)."""

    def __init__(self, server: DelayBatchServer, buckets: tuple, nqcap: int):
        self.buckets, self.nqcap = buckets, nqcap
        dev, cfg = server.device, server.config
        C, slots, t_max = cfg.channels, server.slots, buckets[-1]

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.prompts = z((nqcap, t_max, C), torch.int64)
        self.masks = z((nqcap, t_max), torch.bool)
        self.qbucket = z((nqcap,), torch.int32)
        self.qbudget = z((nqcap,), torch.int32)
        self.qkeys = z((nqcap, 2), torch.int64)
        self.qsamp = {k: z((nqcap,), torch.bool if v.dtype == np.bool_ else torch.float32)
                      for k, v in server._samp_host.items()}
        self.active = z((slots,), torch.bool)
        self.slot_rid = z((slots,), torch.int32)
        self.budget = z((slots,), torch.int32)
        self.res = z((nqcap + 1, server.out_capacity, C), torch.int32)
        self.rsteps = z((nqcap + 1,), torch.int32)
        # the server's control words: the admission kernel writes the slot
        # the admission program's splice reads
        self.ctrl = server._ctrl
        self._host_ctrl = np.zeros(graph_loop.CTRL_WORDS, np.int32)  # the CPU loop's
        self._qbucket_host = np.zeros(nqcap, np.int32)
        self._execs: Dict[int, int] = {}  # attend -> executable drain graph
        self.launches = 0  # drain graph launches
        # attend -> the IF handles its drain graph's admission kernel sets:
        # each graph its own, since its build writes them
        self._handles: Dict[int, torch.Tensor] = {}
        self._gathers = None

    def __del__(self):
        graph_loop.release(getattr(self, "_execs", {}))

    def _samp(self, sv: DelayBatchServer) -> list:
        """(slot tensor, staged rows, admission 0-dim tensor) per sampling
        field, 4-byte fields first."""
        names = sorted(self.qsamp, key=lambda k: self.qsamp[k].dtype == torch.bool)
        return [(getattr(sv._samp_dev, k), self.qsamp[k], getattr(sv._prefill_samp, k))
                for k in names]

    def stage(self, prompts, masks, qbucket, qbudget, qkeys, vals, NQ: int, cap: int) -> None:
        dev = self.ctrl.device
        for dst, src in ((self.prompts, prompts), (self.masks, masks), (self.qbucket, qbucket),
                         (self.qbudget, qbudget), (self.qkeys, qkeys)):
            dst.copy_(host_tensor(src, dev), non_blocking=True)
        for k, v in vals.items():
            self.qsamp[k].copy_(host_tensor(v, dev), non_blocking=True)
        self.active.zero_()
        self.slot_rid.zero_()
        self.budget.fill_(1 << 30)
        self.res.zero_()
        self.rsteps.zero_()
        ctrl = np.zeros(graph_loop.CTRL_WORDS, np.int32)
        ctrl[graph_loop.LIMIT], ctrl[graph_loop.QN] = min(cap, (1 << 31) - 1), NQ
        self._host_ctrl[:] = ctrl
        self._qbucket_host[:] = qbucket
        self._done = (0, 0)  # the steps run and requests admitted so far
        graph_loop.set_words(self.ctrl, 0, ctrl)

    def capture_steps(self, sv: DelayBatchServer) -> None:
        """Capture the step graph of every attend bucket a drain of these
        prompts can reach, where missing, before the drain begins: an idle
        step each (the pool is idle, and an admission overwrites every row
        it takes)."""
        a = attend_bucket(self.buckets[-1] + 2, 256, sv.cache_len)
        while True:
            if sv._steps._key(**sv._step_kw(a)) not in sv._steps._captured:
                sv._decode_steps(a, 1)
            if a >= sv.cache_len:
                break
            a = attend_bucket(a + 1, 256, sv.cache_len)

    @staticmethod
    def _prefill_key(sv: DelayBatchServer, tb: int) -> tuple:
        return Prefills._key(tb, sv.top_k_text, sv.top_k_audio, None)

    def segment(self, sv: DelayBatchServer, attend: int):
        """One attend bucket's segment of the scheduler. Returns the queue
        cursor, the slots' ``active`` and ``pos``, and the step count, on
        the host."""
        if not sv._steps.graphs:
            return self._segment_eager(sv, attend)
        ex = self._exec(sv, attend)
        graph_loop.launch(ex, sv.device)
        self.launches += 1
        ctrl, act, pos = self._read(sv)
        i0, q0 = self._done
        di, qi = int(ctrl[graph_loop.I]) - i0, int(ctrl[graph_loop.QI])
        self._done = (int(ctrl[graph_loop.I]), qi)
        launches.add_replay(sv._steps._captured[sv._steps._key(**sv._step_kw(attend))][1],
                            times=di)
        for q in range(q0, qi):
            prompt = sv._prefills._prompts[self._prefill_key(sv, self.buckets[self._qbucket_host[q]])]
            launches.add_replay(prompt.launches)
        launches.add_replay({"loop_cond": di + 1, "drain_admit": di, "drain_collect": di,
                             "row_copy": qi - q0})
        return qi, act, pos, int(ctrl[graph_loop.I])

    def _read(self, sv: DelayBatchServer):
        """The control words, ``active`` and ``pos``, copied back behind the
        launch with one wait."""
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               for t in (self.ctrl, self.active, sv.state.pos)]
        for o, t in zip(out, (self.ctrl, self.active, sv.state.pos)):
            o.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return out[0].numpy().copy(), out[1].numpy().copy(), out[2].numpy().astype(np.int64)

    def _segment_eager(self, sv: DelayBatchServer, attend: int):
        """The segment's loop on the host: the same admission, step, collect
        and condition as the drain graph's, through the plain versions."""
        st, ctrl, samp = sv.state, self._host_ctrl, self._samp(sv)
        t_max = self.buckets[-1]
        while graph_loop.loop_cond_plain(
                graph_loop.DRAIN, int(ctrl[graph_loop.I]), int(ctrl[graph_loop.LIMIT]),
                active=self.active, pos=st.pos, attend=attend, qi=int(ctrl[graph_loop.QI]),
                qn=int(ctrl[graph_loop.QN])):
            j = graph_loop.drain_admit_plain(ctrl, self.active, self.slot_rid, self.budget,
                                             self._qbucket_host, self.qbudget, self.qkeys,
                                             sv._small.rng, samp)
            if j >= 0:
                tb, qi = self.buckets[j], int(ctrl[graph_loop.ADM_QI])
                sv._aim(int(ctrl[graph_loop.SLOT]))  # as the admission kernel writes it
                sv._prefills.run(self.prompts[qi:qi + 1, t_max - tb:],
                                 self.masks[qi:qi + 1, t_max - tb:], top_k_text=sv.top_k_text,
                                 top_k_audio=sv.top_k_audio)
            sv._steps.step(**sv._step_kw(attend))
            graph_loop.drain_collect_plain(self.active, st.is_stopping, st.step, self.budget,
                                           self.slot_rid, st.out, self.res, self.rsteps)
            ctrl[graph_loop.I] += 1
        return (int(ctrl[graph_loop.QI]), self.active.cpu().numpy(),
                st.pos.cpu().numpy().astype(np.int64), int(ctrl[graph_loop.I]))

    def _exec(self, sv: DelayBatchServer, attend: int) -> int:
        """The drain graph at ``attend``, built at first use over the
        decode step's graph (``capture_steps``) and every bucket's
        admission graph (prefill and splice), captured here where missing
        (its eager warm-up splices nowhere)."""
        ex = self._execs.get(attend)
        if ex is not None:
            return ex
        steps, st = sv._steps, sv.state
        key = steps._key(**sv._step_kw(attend))
        sv._aim_nowhere()  # the admission kernel writes the slot before any splice
        for tb in self.buckets:
            sv._prefills.capture(tb, top_k_text=sv.top_k_text, top_k_audio=sv.top_k_audio)
        prompts = [sv._prefills._prompts[self._prefill_key(sv, tb)] for tb in self.buckets]
        if self._gathers is None:
            t_max = self.buckets[-1]
            self._gathers = [graph_loop.seg_table([
                Part(p.ids, self.prompts[:, t_max - tb:], src_word=graph_loop.ADM_QI),
                Part(p.mask, self.masks[:, t_max - tb:], src_word=graph_loop.ADM_QI),
            ], sv.device) for p, tb in zip(prompts, self.buckets)]
        samp = self._samp(sv)
        n_f32 = sum(1 for d, _, _ in samp if d.dtype != torch.bool)
        f, u = samp[:n_f32], samp[n_f32:]
        P = graph_loop.MAX_SAMP
        handles = self._handles[attend] = torch.zeros(len(self.buckets), dtype=torch.int64,
                                                      device=sv.device)
        dargs = graph_loop.DrainArgs(
            ctrl=self.ctrl.data_ptr(), slots=sv.slots, n_buckets=len(self.buckets),
            active=self.active.data_ptr(), slot_rid=self.slot_rid.data_ptr(),
            budget=self.budget.data_ptr(), qbucket=self.qbucket.data_ptr(),
            qbudget=self.qbudget.data_ptr(), qkeys=self.qkeys.data_ptr(),
            small_rng=sv._small.rng.data_ptr(), handles=handles.data_ptr(),
            n_f32=len(f), n_u8=len(u),
            f_dst=(ctypes.c_void_p * P)(*[d.data_ptr() for d, _, _ in f]),
            f_src=(ctypes.c_void_p * P)(*[q.data_ptr() for _, q, _ in f]),
            f_pre=(ctypes.c_void_p * P)(*[p.data_ptr() for _, _, p in f]),
            u_dst=(ctypes.c_void_p * P)(*[d.data_ptr() for d, _, _ in u]),
            u_src=(ctypes.c_void_p * P)(*[q.data_ptr() for _, q, _ in u]),
            u_pre=(ctypes.c_void_p * P)(*[p.data_ptr() for _, _, p in u]),
            is_stopping=st.is_stopping.data_ptr(), step=st.step.data_ptr(),
            out=st.out.data_ptr(), results=self.res.data_ptr(), rsteps=self.rsteps.data_ptr(),
            out_row=st.out[0].numel())
        cargs = graph_loop.cond_args(graph_loop.DRAIN, self.ctrl, active=self.active,
                                     pos=st.pos, attend=attend)
        ex = graph_loop.build_drain(steps._captured[key][0].raw_cuda_graph(),
                                    [p.graph.raw_cuda_graph() for p in prompts], cargs, dargs,
                                    self._gathers, handles)
        self._execs[attend] = ex
        return ex

    def results(self, NQ: int):
        """The result rows and step counts of the ``NQ`` requests, on the
        host (one read)."""
        return self.res[:NQ].cpu().numpy(), self.rsteps[:NQ].cpu().numpy()
