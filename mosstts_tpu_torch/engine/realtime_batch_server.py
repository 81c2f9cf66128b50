"""Continuous-batching server for the Realtime (streaming) family.

Ports ``mosstts_tpu/engine/realtime_batch_server.py``:
``RealtimeBatchServer`` with ``submit`` (per-conversation sampling
overrides), ``step``, ``step_block``, ``run`` (pipelined and sequential),
``run_events``, ``partial_frames``, ``cancel``, ``warmup`` and
``total_steps``. A fixed pool of slots decodes frames in lock-step; queued
conversations are admitted into freed slots mid-flight: the admissions of
one prompt bucket prefill together as one batch-k group (k rounded up to a
power of two by repeating the last one) into a fresh state, and their rows
are spliced into the slots (``rt_splice_parts``). Each slot has its own
cache cursor and frame counter (the per-row ``RealtimeState``), its own
sampling controls, its own text feed (``_text_rest``) and its own
threefry key.

``self.state`` is one set of static buffers for the server's whole life.
The frames advance it in place through ``engine/step_graph.RealtimeSteps``:
on the card each frame is the replay of a CUDA graph of
``realtime_decode_step``, one per attend bucket (the JAX server's
``_step_fn``). An admission is the replay of one CUDA graph per ``(kb,
prompt bucket, attend)`` (the JAX server's ``_admit_fn``): a (k bucket,
attend bucket) has a static kb-row admission state, its linear cache
``attend`` slots long (what the prefill reads and writes), sampling
buffers and keys (``_Admission``); the graph returns that state to a
new conversation's and prefills the group into it
(``step_graph.RealtimePrefills`` with ``fresh``), then splices the rows
into the first ``attend`` slots of theirs, the rest of each slot's mask
cleared, each slot taking its admission row's key: one launch of the
row-copy kernel (``rt_splice_parts``, JAX's ``_splice_rt_rows``) at the
(kb,) int32 slots the host writes into ``_Admission.rows``, a padding
row's out of range and dropped, as JAX's ``mode="drop"`` drops it, so
one graph serves every slot combination. Only ``warmup()``
captures: it keeps the admission states of the (k bucket, attend bucket)
pairs of the prompt buckets it is given, captures their graphs, and
captures the frame graphs of the attend buckets it walks. An admission of a
prompt bucket it did not name runs eagerly, every time, into a transient
admission state freed after the splice (its splice the same kernel,
launched eagerly): a capture mid-serve would stall
every slot's frames. ``run_events`` (JAX ``_event_fn``) decodes until a
scheduling event: on the card one launch of a loop graph whose body feeds
frame i its text column from the staged (slots, ``_KMAX``) tokens (a feed
kernel indexed by the loop's device counter), replays the frame graph, and
reads the watched stop flags (a condition kernel), so the block ends after
the frame at which the event holds, as JAX's does. ``graphs=False``
runs the frames and admissions eagerly on the card, to compare; the CPU
always does.

Differences from the JAX server, by design: a conversation draws from its
slot's threefry key, ``PRNGKey`` of its request id's seed
(``polling.request_seed``), written at admission, so a sampled stream
depends on its own request only; the JAX server draws every slot from one
shared key, so its sampled streams depend on the cohort
(``realtime_batch_server.py:409-413``). Greedy streams equal JAX's and the
solo engine's. The pipelined ``run`` snapshots the stop flags with a
non-blocking copy to pinned host memory and a CUDA event.
"""
from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import RealtimeConfig
from ..models.realtime import (RealtimeParams, RealtimeSampling, RealtimeState,
                               init_realtime_srv_state, init_realtime_state, make_rt_sampling)
from ..ops.kernels.graph_loop import Part, RowCopy, set_words
from ..ops.sampling import prng_key, row_keys
from .delay_engine import _round_up, attend_bucket
from .polling import request_seed, run_pipelined
from .step_graph import RealtimePrefills, RealtimeSteps, host_tensor


@dataclass
class _RTRequest:
    request_id: int
    grid: np.ndarray  # (T, 1+rvq) turn grid from RealtimeProcessor
    text_ids: List[int]
    max_new_tokens: int
    prefill_text_len: int
    sampling: Optional[dict] = None  # per-request generation config


@dataclass
class CompletedStream:
    request_id: int
    frames: np.ndarray  # (T, rvq) generated frames, trimmed at EOS
    steps: int  # frames generated (incl. any post-EOS poll slack)


def rt_splice_parts(big: RealtimeState, small: RealtimeState, k: int) -> list:
    """JAX's ``_splice_rt_rows`` as row-copy parts (``graph_loop.RowCopy``):
    row i < ``k`` of the batch-k scalar-cursor state ``small`` into the slot
    ``rows[i]`` of ``big``, the control words being the (k,) int32 row
    indices: its cache lane, mask, last frame, stop flag, history and key,
    with ``small``'s scalar cursors. ``small``'s cache may hold fewer slots
    than ``big``'s: its rows fill the slots' first ones, and the rest of
    each slot's mask is cleared (what the cache holds there is never read).
    A row index of ``slots`` or more is dropped (JAX's ``mode="drop"``: the
    k bucket's padding rows). The keys go with the rows."""
    A = small.kv_valid.shape[1]
    parts = []
    for i in range(k):
        parts += [Part(bf[:, :, :, :A], sf[:, i:i + 1], dst_word=i, dst_axis=1, src_axis=1)
                  for bf, sf in zip(big.cache, small.cache)]
        parts += [Part(big.kv_valid[:, A:], None, dst_word=i),
                  Part(big.kv_valid[:, :A], small.kv_valid[i:i + 1], dst_word=i)]
        parts += [Part(getattr(big, f), getattr(small, f)[i:i + 1], dst_word=i)
                  for f in ("last_audio", "is_stopping", "history", "rng")]
        parts += [Part(big.cur_len, small.cur_len.view(1), dst_word=i),
                  Part(big.hist_len, small.hist_len.view(1), dst_word=i)]
    return parts


@torch.no_grad()
def _splice_rt_rows_(big: RealtimeState, small: RealtimeState, rows: torch.Tensor) -> None:
    """Splice the first ``len(rows)`` rows of ``small`` into slots ``rows``
    of ``big`` in place (``rt_splice_parts``, one row copy)."""
    RowCopy(rt_splice_parts(big, small, rows.shape[0]), rows.to(torch.int32))()


_SEED_SALT = 0x52D417  # ``polling.request_seed``'s salt for this family


class _Admission:
    """A (k bucket, attend bucket)'s admission: a kb-row scalar-cursor
    state (a linear cache of ``attend`` slots) with kb keys of its own,
    kb-row sampling buffers, the (kb,) int32 slots its rows go to
    (``rows``; a padding row's is out of range) and the admission programs
    over them (one per prompt bucket: the prefill, then the splice of the
    rows into the server's slots, JAX's ``_admit_fn``), which share the
    frames' capture stream and pool and are captured only ahead
    (``warmup()``)."""

    def __init__(self, server: "RealtimeBatchServer", kb: int, attend: int):
        dev = server.device
        self.state = init_realtime_state(server.config, kb, attend, server.max_frames,
                                         row_keys(0, kb), dtype=server.dtype, device=dev)
        self.sampling = make_rt_sampling(*(np.zeros(kb, np.float32) for _ in range(3)),
                                         np.zeros(kb, bool), device=dev)
        self.rows = torch.full((kb,), server.slots, dtype=torch.int32, device=dev)
        splice = RowCopy(rt_splice_parts(server.state, self.state, kb), self.rows)
        self.prefills = RealtimePrefills(server._steps, self.state, self.sampling, fresh=True,
                                         capture_on_use=False, after=lambda key: splice())


class RealtimeBatchServer:
    """Ports ``mosstts_tpu.engine.realtime_batch_server.RealtimeBatchServer``.
    The server runs where ``params`` live. ``graphs`` (on the card): replay
    each frame as a CUDA graph; False runs the frames eagerly, to compare.
    The graphs read ``params`` where they are: build a new server after
    quantizing them."""

    # the event block's text-feed width (JAX ``_KMAX``)
    _KMAX = 128

    def __init__(self, params: RealtimeParams, config: RealtimeConfig, *, slots: int = 8,
                 cache_len: int = 1024, max_frames: int = 256, prompt_bucket: int = 16,
                 dtype=torch.bfloat16, sampling: Optional[RealtimeSampling] = None,
                 top_k: int = 30, poll_every: int = 4, text_pad_id: int = 151655,
                 pad_token_id: int = 151643, graphs: bool = True):
        self.params = params
        self.config = config
        self.device = params.text_emb.device
        self.slots = slots
        self.cache_len = cache_len
        self.max_frames = max_frames
        self.prompt_bucket = prompt_bucket
        self.dtype = dtype
        self.sampling = sampling or make_rt_sampling()
        self.top_k = top_k
        self.poll_every = poll_every
        self.text_pad_id = text_pad_id
        self.pad_token_id = pad_token_id

        self._ids = itertools.count()
        self._queue: List[_RTRequest] = []
        self._active: Dict[int, _RTRequest] = {}
        self._text_rest: Dict[int, List[int]] = {}  # slot -> tokens to feed
        dev = self.device
        self.state = init_realtime_srv_state(config, slots, cache_len, max_frames,
                                             row_keys(0, slots), dtype=dtype, device=dev)
        # the event loop's staged text columns (JAX's (slots, _KMAX) matrix)
        self._toks = torch.full((slots, self._KMAX), text_pad_id, dtype=torch.int64,
                                device=dev)
        self.total_steps = 0
        # host mirrors (exact): frames generated per slot since admission,
        # and an upper bound on each slot's cache cursor (cursors freeze at
        # EOS, so prefill_len + steps only over-covers): the attend bucket
        # needs no device read
        self._step_host = np.full(slots, 1 << 30, np.int64)
        self._ub_host = np.zeros(slots, np.int64)

        # per-slot sampling: raw values on the host; the static (slots,)
        # tensors are rewritten from them when an admission changes a slot
        d = self.sampling
        self._samp_default = {
            "temperature": float(d.temperature),
            "top_p": float(d.top_p),
            "repetition_penalty": float(d.repetition_penalty),
            "do_sample": bool(d.do_sample),
        }
        self._samp_host = {
            k: np.full(slots, v, np.bool_ if isinstance(v, bool) else np.float32)
            for k, v in self._samp_default.items()
        }
        self._samp_dev = make_rt_sampling(**self._samp_host, device=dev)
        self._samp_stale = False
        self._steps = RealtimeSteps(params, config, self.state, self._samp_dev, graphs=graphs)
        # (k bucket, attend bucket) -> its static admission, kept by warmup()
        self._admissions: Dict[tuple, _Admission] = {}

    # ---- per-slot sampling -------------------------------------------
    def _set_slot_sampling(self, slot: int, overrides: dict) -> None:
        h, sd = self._samp_host, self._samp_default
        for k in sd:
            h[k][slot] = sd[k]
        if overrides.get("temperature") is not None:
            # an explicit temperature decides: 0 greedy, > 0 sampled
            t = overrides["temperature"]
            h["temperature"][slot] = t
            h["do_sample"][slot] = t != 0.0
        for k in ("top_p", "repetition_penalty"):
            if overrides.get(k) is not None:
                h[k][slot] = overrides[k]
        self._samp_stale = True

    def _sync_sampling(self) -> None:
        """Rewrite the static per-slot sampling tensors if an admission
        changed them."""
        if self._samp_stale:
            for static, value in zip(self._samp_dev, make_rt_sampling(**self._samp_host)):
                static.copy_(host_tensor(value, self.device), non_blocking=True)
            self._samp_stale = False

    # ------------------------------------------------------------------
    def submit(self, grid: np.ndarray, text_ids: List[int], *, max_new_tokens: int = 128,
               prefill_text_len: int = 12, sampling: Optional[dict] = None) -> int:
        """Queue a conversation turn: a (T, 1+rvq) grid from the processor
        and the whole text token stream (the first ``prefill_text_len`` go
        into the prefill, the rest feed one per frame). ``sampling``
        overrides the server defaults for this conversation: temperature
        (0 = greedy), top_p, repetition_penalty."""
        if sampling:
            bad = set(sampling) - {"temperature", "top_p", "repetition_penalty"}
            if bad:
                raise ValueError(f"unknown sampling overrides: {sorted(bad)}")
        grid = np.asarray(grid, np.int64)
        if grid.ndim != 2 or grid.shape[1] != self.config.rvq + 1:
            raise ValueError(f"expected (T, {self.config.rvq + 1}) grid")
        prefix = list(text_ids[:prefill_text_len])
        if not prefix:
            raise ValueError("need at least one text token to prefill")
        Tb = _round_up(grid.shape[0] + len(prefix), self.prompt_bucket)
        max_new_tokens = min(max_new_tokens, self.max_frames)
        if Tb + max_new_tokens + self.poll_every > self.cache_len:
            raise ValueError(f"prompt ({Tb} slots) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds cache_len={self.cache_len}")
        rid = next(self._ids)
        self._queue.append(_RTRequest(
            request_id=rid, grid=grid, text_ids=list(text_ids), max_new_tokens=max_new_tokens,
            prefill_text_len=prefill_text_len, sampling=dict(sampling) if sampling else None))
        return rid

    def _prompt_rows(self, req: _RTRequest) -> np.ndarray:
        """The grid plus the prefix rows, ``audio_bos`` on the last prefix
        row's channel 1 (as ``RealtimeEngine.prefill`` builds them)."""
        cfg = self.config
        prefix = req.text_ids[:req.prefill_text_len]
        seg = np.full((len(prefix), cfg.rvq + 1), cfg.audio_pad_token, np.int64)
        seg[:, 0] = prefix
        seg[len(prefix) - 1, 1] = cfg.audio_bos_token
        return np.concatenate([req.grid, seg], axis=0)

    def _admit_attend(self, Tb: int) -> int:
        return attend_bucket(Tb, max(self.prompt_bucket, 128), self.cache_len)

    @torch.no_grad()
    def _prefill_group(self, ids: np.ndarray, valid: np.ndarray, slots: List[int],
                       seeds: List[int], sampling: RealtimeSampling) -> None:
        """Prefill the kb prompt rows ``ids``/``valid`` as one batch with
        the per-row ``sampling`` (on the host) into the admission state of
        the k bucket and the prompt's attend bucket (the static one
        ``warmup()`` kept, else a transient one), returned to a new
        conversation's in the program,
        row i drawing from the key ``PRNGKey(seeds[i])`` (the padding rows
        past ``len(slots)`` from ``PRNGKey(0)``), and splice the first
        ``len(slots)`` rows, their keys with them, into ``slots``, in the
        same program (the padding rows' slot is out of range: dropped)."""
        kb, Tb = ids.shape[:2]
        dev, k = self.device, len(slots)
        attend = self._admit_attend(Tb)
        adm = self._admissions.get((kb, attend)) or _Admission(self, kb, attend)
        for static, value in zip(adm.sampling, sampling):
            static.copy_(host_tensor(value, dev), non_blocking=True)
        keys = np.stack([prng_key(seed).numpy() for seed in list(seeds) + [0] * (kb - k)])
        adm.state.rng.copy_(host_tensor(keys, dev), non_blocking=True)
        set_words(adm.rows, 0, list(slots) + [self.slots] * (kb - k))
        adm.prefills.run(host_tensor(ids, dev), host_tensor(valid, dev), attend_len=attend,
                         top_k=self.top_k)

    def _admit_group(self, Tb: int, group) -> None:
        """Admit every (slot, request, prompt rows) of ``group``, all in the
        prompt bucket ``Tb``, through one batch-k prefill; k is rounded up
        to a power of two by repeating the last admission (its rows are not
        spliced), so a bucket sees O(log slots) batch shapes."""
        cfg = self.config
        k = len(group)
        kb = 1
        while kb < k:
            kb *= 2
        padded = group + [group[-1]] * (kb - k)
        ids = np.full((kb, Tb, cfg.rvq + 1), cfg.audio_pad_token, np.int64)
        ids[..., 0] = self.pad_token_id
        valid = np.zeros((kb, Tb), bool)
        for i, (_slot, _req, rows) in enumerate(padded):
            ids[i, Tb - rows.shape[0]:] = rows
            valid[i, Tb - rows.shape[0]:] = True
        for slot, req, _rows in group:
            self._set_slot_sampling(slot, req.sampling or {})
        h = self._samp_host
        samp_slots = np.array([s for s, _r, _w in padded], np.int64)
        sampling = make_rt_sampling(**{name: h[name][samp_slots].copy() for name in h})
        seeds = [request_seed(_SEED_SALT, req.request_id) for _s, req, _w in group]
        self._prefill_group(ids, valid, [s for s, _r, _w in group], seeds, sampling)
        for slot, req, _rows in group:
            self._active[slot] = req
            self._text_rest[slot] = list(req.text_ids[req.prefill_text_len:])
            self._step_host[slot] = 1  # the prefill produced the first frame
            self._ub_host[slot] = Tb

    def _fill_free_slots(self) -> None:
        busy = set(self._active)
        groups: Dict[int, list] = {}
        for slot in range(self.slots):
            if not self._queue:
                break
            if slot not in busy:
                req = self._queue.pop(0)
                rows = self._prompt_rows(req)
                Tb = _round_up(rows.shape[0], self.prompt_bucket)
                groups.setdefault(Tb, []).append((slot, req, rows))
        for Tb, group in sorted(groups.items()):
            self._admit_group(Tb, group)

    # ------------------------------------------------------------------
    def _attend(self, active) -> int:
        max_ub = int(self._ub_host[active].max())
        return attend_bucket(max_ub + 2, max(self.prompt_bucket, 128), self.cache_len)

    def _frame(self, active) -> None:
        """One frame of every slot, each active slot fed the next token of
        its text (a pad once it has none)."""
        toks = np.full(self.slots, self.text_pad_id, np.int64)
        for slot in active:
            rest = self._text_rest[slot]
            if rest:
                toks[slot] = rest.pop(0)
        self._sync_sampling()
        self._steps.step(host_tensor(toks, self.device), attend_len=self._attend(active),
                         top_k=self.top_k)
        self.total_steps += 1
        self._step_host[active] += 1
        self._ub_host[active] += 1

    def step(self, *, poll: Optional[bool] = None) -> List[CompletedStream]:
        """Admit queued requests, decode one frame for every slot in
        lock-step, collect completions. Idle and finished slots ride along
        frozen (their cursor and cache stay put; the frame they compute
        never reaches a result)."""
        self._fill_free_slots()
        if not self._active:
            return []
        active = sorted(self._active)
        self._frame(active)
        if poll is None:
            poll = (self.total_steps % self.poll_every == 0
                    or any(self._step_host[s] >= self._active[s].max_new_tokens
                           for s in active))
        return self._collect() if poll else []

    def step_block(self, n: int) -> List[CompletedStream]:
        """``n`` lock-step frames back to back (one admission pass, one
        poll); the block ends early when a slot reaches its budget."""
        self._fill_free_slots()
        if not self._active:
            return []
        active = sorted(self._active)
        for _ in range(n):
            if any(self._step_host[s] >= self._active[s].max_new_tokens for s in active):
                break
            self._frame(active)
        return self._collect()

    def _trim(self, hist: np.ndarray, slot: int, max_new: int) -> np.ndarray:
        """The frames written so far for ``slot``, clamped to its budget and
        trimmed at the first audio-EOS frame (reference
        streaming_mossttsrealtime.py:854-878)."""
        n = int(min(self._step_host[slot], max_new, self.max_frames))
        frames = hist[slot, :n]
        eos = np.nonzero(frames[:, 0] == self.config.audio_eos_token)[0]
        if len(eos):
            frames = frames[: int(eos[0])]
        return frames

    def _hist_bucket(self, n: int) -> int:
        """Exponential frame buckets (64, 128, 256, ...) for
        ``partial_frames``' transfer."""
        nb = 64
        while nb < n:
            nb *= 2
        return min(nb, self.max_frames)

    def partial_frames(self) -> Dict[int, np.ndarray]:
        """For streaming consumers: request_id -> the EOS-trimmed frames
        generated so far, for every conversation in flight, in one
        transfer of the history's first frame bucket over the furthest
        active cursor (a host mirror: no device read to size it)."""
        if not self._active:
            return {}
        n = int(max(min(self._step_host[s], self._active[s].max_new_tokens, self.max_frames)
                    for s in self._active))
        nb = self._hist_bucket(max(n, 1))
        hist = self.state.history[:, :nb].cpu().numpy()
        return {req.request_id: self._trim(hist, slot, req.max_new_tokens).copy()
                for slot, req in sorted(self._active.items())}

    def _free(self, slot: int) -> None:
        """Free ``slot``: its row freezes (``is_stopping``) and parks."""
        del self._active[slot]
        del self._text_rest[slot]
        self._step_host[slot] = 1 << 30
        self.state.is_stopping[slot] = True

    def cancel(self, request_id: int) -> bool:
        """Abort one conversation (a client that disconnected): a queued
        request is dropped; an active one frees its slot at once, its frames
        never collected. Returns True if the request was found."""
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]
                return True
        slot = next((s for s, req in self._active.items() if req.request_id == request_id),
                    None)
        if slot is None:
            return False
        self._free(slot)
        return True

    def _collect(self, stopped: Optional[np.ndarray] = None) -> List[CompletedStream]:
        if stopped is None:
            stopped = self.state.is_stopping.cpu().numpy()
        finished = [(slot, req) for slot, req in sorted(self._active.items())
                    if stopped[slot] or self._step_host[slot] >= req.max_new_tokens]
        if not finished:
            return []
        hist = self.state.history.cpu().numpy()  # one transfer of the whole buffer
        done: List[CompletedStream] = []
        for slot, req in finished:
            # clamped to the budget: a block can run a few frames past it
            frames = self._trim(hist, slot, req.max_new_tokens)
            done.append(CompletedStream(request_id=req.request_id, frames=frames.copy(),
                                        steps=int(self._step_host[slot])))
            self._free(slot)
        return done

    def _poll_window(self, room: int) -> int:
        """Admit and decode up to ``min(poll_every, room)`` frames, ending
        early when a slot reaches its budget (the host mirror is exact);
        returns the frames run."""
        did = 0
        while did < min(self.poll_every, room) and (self._active or self._queue):
            if any(self._step_host[s] >= r.max_new_tokens for s, r in self._active.items()):
                break
            self.step(poll=False)
            did += 1
        return did

    def run(self, max_steps: int = 100000, block: int = 1,
            pipelined: bool = True) -> List[CompletedStream]:
        """Drain the queue and the active slots; completions in finish order.

        ``pipelined`` (block 1) hides each poll's host round trip behind the
        next ``poll_every`` frames (``polling.run_pipelined``): EOS is seen
        up to one block late (frozen frames the trim drops); budget
        completions come from the host mirrors and stay exact."""
        if block == 1 and pipelined:
            return run_pipelined(self, self._poll_window, lambda: self.state.is_stopping,
                                 max_steps)
        done: List[CompletedStream] = []
        steps = 0
        while steps < max_steps:
            if block > 1:
                done.extend(self.step_block(block))
                steps += block
            else:
                done.extend(self.step())
                steps += 1
            if not self._active and not self._queue:
                break
        return done

    # ---- event-driven dispatch -------------------------------------------
    def _dispatch_event(self, max_k: int):
        """Admit, then decode until a scheduling event (a watched slot
        stopped, or the block's cap: a budget, the attend bucket's end,
        ``_KMAX``). Returns ``(frames run, stop flags | None)``; no
        admission happens in between, so the flags map onto the current
        occupants."""
        self._fill_free_slots()
        if not self._active:
            return 0, None
        active = sorted(self._active)
        max_ub = int(self._ub_host[active].max())
        attend = attend_bucket(max_ub + 2, max(self.prompt_bucket, 128), self.cache_len)
        budget = np.full(self.slots, 1 << 30, np.int64)
        for s, req in self._active.items():
            budget[s] = req.max_new_tokens - self._step_host[s]
        k_cap = int(min(max_k, attend - max_ub - 1, int(budget[active].min()), self._KMAX))
        if k_cap <= 0:
            return 0, None
        toks = np.full((self.slots, self._KMAX), self.text_pad_id, np.int64)
        watch = np.zeros(self.slots, bool)
        for slot in active:
            watch[slot] = True
            rest = self._text_rest[slot][:k_cap]
            if rest:
                toks[slot, :len(rest)] = rest
        self._sync_sampling()
        self._toks.copy_(host_tensor(toks, self.device), non_blocking=True)
        did, flags = self._steps.loop_event(self._toks, watch, budget, k_cap, attend_len=attend,
                                            top_k=self.top_k)
        self.total_steps += did
        self._step_host[active] += did
        self._ub_host[active] += did
        for slot in active:
            del self._text_rest[slot][:did]
        return did, flags

    def run_events(self, max_steps: int = 100000) -> List[CompletedStream]:
        """Drain the queue and the active slots with event-driven dispatch:
        each block decodes until a slot needs the scheduler (EOS or
        budget); the frame streams equal ``run()``'s, and a block ends after
        the frame that stopped a watched slot, on the card as on the
        CPU."""
        out: List[CompletedStream] = []
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
                if self._queue:
                    logging.getLogger(__name__).warning(
                        "run_events() stopping with %d undrained stream(s) still queued",
                        len(self._queue))
                break
        return out

    # ------------------------------------------------------------------
    @torch.no_grad()
    def warmup(self, prompt_lens=(64,), attend_upto: Optional[int] = None,
               k_buckets: Optional[List[int]] = None) -> None:
        """Run every admission shape the load can hit (each prompt bucket at
        each k bucket) into the static admission state it keeps for its (k
        bucket, attend bucket) and capture its graph, and capture the frame
        graph of every attend bucket up to ``attend_upto``, so nothing is
        built mid-serve; then return the slots to idle, in place (the graphs
        keep their buffers). A prompt bucket not named here admits eagerly."""
        assert not self._active and not self._queue, "warmup on a busy server"
        cfg = self.config
        upto = attend_upto or self.cache_len
        if k_buckets is None:
            k_buckets, kb = [], 1
            while kb < self.slots:
                k_buckets.append(kb)
                kb *= 2
            k_buckets.append(kb)
        sd = self._samp_default
        for T in prompt_lens:
            Tb = _round_up(T, self.prompt_bucket)
            for kb in k_buckets:
                ids = np.full((kb, Tb, cfg.rvq + 1), cfg.audio_pad_token, np.int64)
                ids[..., 0] = self.pad_token_id
                ids[:, -1, 0] = self.text_pad_id
                ids[:, -1, 1] = cfg.audio_bos_token
                sampling = make_rt_sampling(**{
                    k: np.full(kb, v, np.bool_ if isinstance(v, bool) else np.float32)
                    for k, v in sd.items()})
                slots = list(range(min(kb, self.slots)))
                attend = self._admit_attend(Tb)
                if (kb, attend) not in self._admissions:
                    self._admissions[kb, attend] = _Admission(self, kb, attend)
                self._prefill_group(ids, np.ones((kb, Tb), bool), slots, [0] * len(slots),
                                    sampling)
                adm = self._admissions[kb, attend]
                set_words(adm.rows, 0, [self.slots] * kb)  # the capture's warm-up splices nowhere
                adm.prefills.capture(Tb, attend_len=attend, top_k=self.top_k)
        a = max(self.prompt_bucket, 128)
        toks = host_tensor(np.full(self.slots, self.text_pad_id, np.int64), self.device)
        self._sync_sampling()
        while True:
            self._steps.step(toks, attend_len=a, top_k=self.top_k)
            if a >= min(upto, self.cache_len):
                break
            a = attend_bucket(a + 1, max(self.prompt_bucket, 128), self.cache_len)
        # back to a clean idle pool (warmup dirtied the slots and cursors)
        st = self.state
        for buf in st.cache:
            buf.zero_()
        for t in (st.kv_valid, st.cur_len, st.history, st.hist_len):
            t.zero_()
        st.last_audio.fill_(cfg.audio_pad_token)
        st.is_stopping.fill_(True)
        self._step_host[:] = 1 << 30
        self._ub_host[:] = 0
