"""Continuous-batching server for the Delay model family.

Ports ``mosstts_tpu/engine/batch_server.py``: ``DelayBatchServer`` with
``submit``, ``step``, ``step_block``, ``run`` (pipelined and sequential),
``warmup`` and ``utilization``. A fixed pool of batch slots decodes in
lock-step; whenever a slot finishes its utterance a queued request is
prefilled at batch 1 and spliced into that slot mid-flight, so the card
never drains. Each slot has its own cache cursor (``pos``), step counter,
delay-pattern counters, repetition-penalty mask, sampling knobs and
``torch.Generator``, all advanced by the one decode step.

Four cache modes: the linear cache in ``dtype`` or in int8 (``kv_quant``),
each also over a shared page pool (``paged``): slots borrow fixed-size pages
as their utterances grow and return them on completion, so KV memory is
sized for the expected load. The allocator runs off the host mirrors of
``pos`` with no device sync; pool exhaustion triggers recompute preemption
(the slot's prompt plus what it generated is requeued at the front).

Differences from the JAX server, by design: each decode step is an eager
PyTorch call (no jit, so nothing to compile and no program cache); the
splice copies lanes and pages into the running state in place; the
pipelined ``run`` snapshots the stop flags with a non-blocking copy to
pinned host memory plus a CUDA event, enqueued before the next block, and
waits on that event only after the block is enqueued. A request's seed
goes through the same integer hash as in JAX into the slot's generator, so
a seeded request reproduces whatever slot it lands in; the draws are
PyTorch's, not JAX's threefry bits, so cross-framework parity holds for
greedy requests. A preempted request resumes with its own sampling
overrides and seed (the JAX server requeues it without them, so it resumes
at the server's defaults). ``run_events``, ``run_drain`` and ``mesh=`` are
not ported. The server serves whatever params it is given, int8 weights
(``DelayEngine.quantize``) included, in all four cache modes.
"""
from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import DelayConfig
from ..models.delay import (
    SENTINEL,
    DelayGenState,
    DelayParams,
    DelaySampling,
    delay_decode_step,
    delay_prefill,
    make_sampling,
)
from ..nn.qwen3 import init_kv_cache, init_paged_kv_cache, init_quant_kv_cache
from ..ops.sampling import row_generators
from .delay_engine import attend_bucket


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


_ROW_FIELDS = ("kv_valid", "cur_ids", "pos", "step", "is_stopping", "is_audio",
               "audio_lengths", "delayed", "seen")


@torch.no_grad()
def _splice_fields(big: DelayGenState, small: DelayGenState, r: int) -> DelayGenState:
    """Copy the batch-1 state ``small``'s per-row fields into row ``r`` of
    ``big`` in place; the row's generator becomes ``small``'s."""
    for name in _ROW_FIELDS:
        getattr(big, name)[r].copy_(getattr(small, name)[0])
    for name in ("out", "out_valid"):
        dst, src = getattr(big, name)[r], getattr(small, name)[0]
        dst.zero_()
        dst[: src.shape[0]].copy_(src)
    rng = list(big.rng)
    rng[r] = small.rng[0]
    return big._replace(rng=rng)


@torch.no_grad()
def _insert_row(big: DelayGenState, small: DelayGenState, row: int) -> DelayGenState:
    """Splice a batch-1 prefilled state into slot ``row`` of the running
    batch: every per-row field and the slot's cache lane (each cache field
    has the batch on axis 1), in place."""
    for bf, sf in zip(big.cache, small.cache):
        bf[:, row].copy_(sf[:, 0])
    return _splice_fields(big, small, row)


@torch.no_grad()
def _insert_row_paged(big: DelayGenState, small: DelayGenState, row: int,
                      pages: List[int], n0: int) -> DelayGenState:
    """Paged splice: copy the batch-1 linear prefill cache's first ``n0``
    pages of slots into the freshly allocated pool ``pages`` and point slot
    ``row``'s table at them (the rest of the row at the trash page 0). Pool
    buffers pair with the small cache's fieldwise (k, v[, k_scale,
    v_scale]); the table is the pool's last field."""
    pool = big.cache
    psz = pool.page_size
    idx = torch.as_tensor(pages, dtype=torch.long, device=pool.table.device)
    for pb, sb in zip(pool[:-1], small.cache):
        blk = sb[:, 0, :, : n0 * psz]  # (L, KV, n0*P[, hd])
        blk = blk.reshape(blk.shape[:2] + (n0, psz) + blk.shape[3:]).transpose(1, 2)
        pb[:, idx] = blk.to(pb.dtype)
    pool.table[row].zero_()
    pool.table[row, :n0] = idx.to(torch.int32)
    return _splice_fields(big, small, row)


def _request_seed(seed: Optional[int], request_id: int) -> int:
    """The JAX server's per-request key seed (``batch_server.py:903-906``):
    an int-only hash, so an explicit seed reproduces across processes and
    server lifetimes, and the request id enters only unseeded streams."""
    return hash((0xD317A9, seed if seed is not None else request_id)) & 0x7FFFFFFF


class DelayBatchServer:
    """Ports ``mosstts_tpu.engine.batch_server.DelayBatchServer``. The server
    runs where ``params`` live (the card, or the CPU for tests)."""

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
    ):
        self.params = params
        self.config = config
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
        # host mirrors of state.pos / state.step
        self._pos_host = np.zeros(self.slots, np.int64)
        self._step_host = np.full(self.slots, self.out_capacity, np.int64)

        # Per-slot sampling: host arrays hold the transformed knobs of each
        # slot's request; the (slots,) device tensors are rebuilt only when
        # an admission changes a slot.
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
        self._batch_sampling: Optional[DelaySampling] = None

    # ------------------------------------------------------------------
    def _empty_state(self) -> DelayGenState:
        B, C, dev = self.slots, self.config.channels, self.device
        lc = self.config.language_config
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
            rng=row_generators(0, B, dev),
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
        self._batch_sampling = None  # device tensors are stale

    def _slot_sampling(self, slot: int) -> DelaySampling:
        """Scalar DelaySampling for this slot (the admission prefill)."""
        h = self._samp_host
        return make_sampling(
            text_temperature=(float(h["text_temperature"][slot])
                              if h["text_do_sample"][slot] else 0.0),
            text_top_p=float(h["text_top_p"][slot]),
            audio_temperature=(float(h["audio_temperature"][slot])
                               if h["audio_do_sample"][slot] else 0.0),
            audio_top_p=float(h["audio_top_p"][slot]),
            audio_repetition_penalty=float(h["audio_repetition_penalty"][slot]),
            audio_rp_cross_batch=bool(self.sampling.audio_rp_cross_batch),
            device=self.device,
        )

    def _batch_sampling_dev(self) -> DelaySampling:
        if self._batch_sampling is None:
            h = {k: torch.as_tensor(v, device=self.device) for k, v in self._samp_host.items()}
            self._batch_sampling = DelaySampling(
                audio_rp_cross_batch=torch.as_tensor(self.sampling.audio_rp_cross_batch,
                                                     device=self.device), **h)
        return self._batch_sampling

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
            self.state.cache.table[slot, len(pages)] = pg
            pages.append(pg)
        return True

    def _free_slot_pages(self, slot: int) -> None:
        """Return slot's pages to the pool; its table row then points at the
        trash page 0, so the idle row's writes land there instead of in
        pages now owned by other slots."""
        self._free_pages.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.state.cache.table[slot].zero_()

    # ---- decode ----------------------------------------------------------
    def _decode_steps(self, attend: int, k: int) -> None:
        """``k`` decode steps of the whole batch at attend bucket ``attend``."""
        samp = self._batch_sampling_dev()
        for _ in range(k):
            self.state = delay_decode_step(
                self.params, self.config, self.state, samp, top_k_text=self.top_k_text,
                top_k_audio=self.top_k_audio, attend_len=attend)

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
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_request_seed(req.seed, req.request_id))
        self._set_slot_sampling(slot, req.sampling or {})
        small = delay_prefill(
            self.params, self.config, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device), max_new_tokens=self.out_capacity,
            cache_len=self.cache_len, rng=[gen], sampling=self._slot_sampling(slot),
            top_k_text=self.top_k_text, top_k_audio=self.top_k_audio, dtype=self.dtype,
            kv_quant=self.kv_quant)
        if self.paged:
            self.state = _insert_row_paged(self.state, small, slot, pages, n0)
        else:
            self.state = _insert_row(self.state, small, slot)
        self._active[slot] = req
        # mirror the spliced cursors (delay_prefill sets pos=Tb, step=0)
        self._pos_host[slot] = Tb
        self._step_host[slot] = 0
        return True

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

    def _snap_flags(self):
        """Start copying the stop flags to the host: on the card a
        non-blocking copy into pinned memory and an event recorded after it,
        both enqueued before the next block, so reading the flags later
        waits for the copy only, not for the block behind it."""
        flags = self.state.is_stopping
        if flags.device.type != "cuda":
            return flags.clone(), None
        host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        host.copy_(flags, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def run(self, max_steps: int = 100000, pipelined: bool = True) -> List[CompletedRequest]:
        """Drain the queue and the active slots; returns completions in
        finish order.

        ``pipelined`` hides each poll's host round trip behind device work:
        the stop flags are snapshotted at a poll boundary, the next
        poll_every decode steps are enqueued, and only then are the flags
        read. EOS detection lags up to one block (masked idle steps that the
        processor's im_end trim discards); budget completions come from the
        host mirrors and stay exact."""
        out: List[CompletedRequest] = []
        if not pipelined:
            for _ in range(max_steps):
                out.extend(self.step())
                if not self._active and not self._queue:
                    break
            return out
        pending = None  # (flag snapshot, its event, slot -> request_id)
        steps = 0
        while True:
            # budget completions are host-knowable: free those slots before
            # dispatching so the block admits into them
            if self._active:
                out.extend(self._collect(stopped=np.zeros(self.slots, bool)))
            did = 0
            k = min(self.poll_every, max_steps - steps)
            if k > 0 and (self._active or self._queue):
                did = self._dispatch_block(k)
                steps += did
            if pending is not None:
                flags, event, snap_rids = pending
                if event is not None:
                    event.synchronize()
                flags = flags.numpy()
                # a slot freed and readmitted since the snapshot carries the
                # old occupant's flag: trust only unchanged occupants
                stopped = np.zeros(self.slots, bool)
                for slot, rid in snap_rids.items():
                    if slot in self._active and self._active[slot].request_id == rid:
                        stopped[slot] = flags[slot]
                out.extend(self._collect(stopped=stopped))
                pending = None
            if not (self._active or self._queue):
                break
            if did == 0:
                # max_steps exhausted, or (paged) nothing could be admitted:
                # no progress is possible; surface what is left in the queue
                if self._queue:
                    logging.getLogger(__name__).warning(
                        "batch server run() stopping with %d undrained request(s) still "
                        "queued (ids %s)", len(self._queue),
                        [r.request_id for r in self._queue])
                break
            if self._active:
                pending = (*self._snap_flags(),
                           {s: r.request_id for s, r in self._active.items()})
        return out

    def warmup(self, *, prompt_lens=(64,), attend_upto: Optional[int] = None) -> None:
        """Run every path the serving loop can hit once before live traffic:
        dummy requests of each prompt length in ``prompt_lens`` through
        submit/run (the kernel build, prefill and splice), then a decode step
        on the idle state at every attend bucket up to ``attend_upto``
        (default: the full cache). Idle rows' cache writes are masked and
        their out writes drop, and an admission overwrites every per-row
        field, so the extra steps cannot leak into later requests."""
        if self._active or self._queue:
            raise RuntimeError("warmup on a busy server")
        cfg = self.config
        for T in prompt_lens:
            g = np.full((int(T), cfg.channels), cfg.audio_pad_code, np.int64)
            g[:, 0] = cfg.pad_token_id
            g[-1, 0] = cfg.audio_assistant_gen_slot_token_id
            self.submit(g, max_new_tokens=2)
        self.run()
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
