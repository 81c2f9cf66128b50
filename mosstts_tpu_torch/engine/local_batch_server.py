"""Continuous-batching server for the Local (depth-transformer) family.

Ports ``mosstts_tpu/engine/local_batch_server.py``: ``LocalBatchServer``
with ``submit``, ``step``, ``step_block``, ``run`` (pipelined and
sequential), ``run_events``, ``warmup`` and ``utilization``. A fixed pool
of slots decodes frames in lock-step (a backbone step and the cached depth
pass per frame); a finished slot admits a queued request mid-flight: a
batch-1 prefill at the prompt bucket (``_admit``), spliced into the slot
(``local_splice_parts``, JAX ``_insert_local_row``). Each slot has its own
cursors (the per-row ``LocalGenState``), so its backbone KV writes at its
own slot, only advancing rows validate their next slot, and stopped or idle
rows freeze.

``self.state`` is one set of static buffers for the server's whole life.
The frames advance it in place through ``engine/step_graph.LocalSteps``:
on the card each frame is the replay of a CUDA graph of
``local_frame_step``, one per attend bucket (the JAX server's
``_step_fn``), and its k-step ``_block_fn`` one launch of a graph that
loops over that graph on the card (``step_graph.DeviceLoop``). An admission, as in
JAX, is a scalar-cursor prefill spliced into the slot: on the card the
replay of a CUDA graph of ``local_prefill_split`` per prompt bucket (the
JAX server's ``_prefill_fn``; ``step_graph.LocalPrefills``) into a static
batch-1 state (``_small``), then, in the same graph, the splice
(``local_splice_parts``, JAX's ``_insert_fn``): one launch of the
row-copy kernel at the slot and cursor the host writes into the control
words (``_ctrl``), so one graph serves every slot, the request's key
riding in through ``_small``. Only ``warmup()`` captures: the
admission graphs of the prompt buckets it is given and the frame graphs of
the attend buckets it walks. A prompt bucket it did not name admits
eagerly, every time: a capture mid-serve would stall every slot's
frames. ``run_events`` (JAX ``_event_fn``) decodes until a scheduling
event: on the card one launch of a loop graph whose condition kernel
reads the watched rows' flags after every frame, so the block ends after
the frame at which the event holds, as JAX's does. ``graphs=False`` runs the frames and admissions eagerly on
the card, to compare; the CPU always does.

A difference from the JAX server, by design: each slot draws from its own
threefry key, ``PRNGKey`` of the request id's seed (``polling.request_seed``),
written at admission, so a sampled request depends on its own draws only;
the JAX server draws every slot from one shared key. Greedy grids equal
JAX's and the solo engine's.
"""
from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import LocalConfig
from ..models.local import LocalGenState, LocalParams, init_local_state, make_local_sampling
from ..ops.kernels import graph_loop
from ..ops.kernels.graph_loop import Part, RowCopy
from ..ops.sampling import prng_key, row_keys
from .delay_engine import _round_up, attend_bucket
from .polling import request_seed, run_pipelined
from .step_graph import LocalPrefills, LocalSteps, host_tensor


@dataclass
class _LocalRequest:
    request_id: int
    input_ids: np.ndarray  # (T, C)
    max_new_tokens: int


@dataclass
class CompletedLocal:
    request_id: int
    start_length: int
    tokens: np.ndarray  # ids from the last audio_start (the engine's output format)
    steps: int


def local_splice_parts(big: LocalGenState, small: LocalGenState, ctrl: torch.Tensor,
                       true: torch.Tensor) -> list:
    """JAX's ``_insert_local_row`` (a traced row and cursor) as row-copy
    parts (``graph_loop.RowCopy``): the batch-1 scalar-cursor prefilled
    state ``small`` into the slot ``ctrl[SLOT]`` of ``big``, its cursor
    ``ctrl[POS0]``, its frame count 0, ``unfinished`` True (``true``, a
    (1,) bool), its output ``small.out`` then zeros, and, by the port's
    design, its key (JAX keeps one shared key)."""
    S = graph_loop.SLOT
    parts = [Part(bf, sf, dst_word=S, dst_axis=1, src_axis=1)
             for bf, sf in zip(big.cache, small.cache)]
    parts += [Part(getattr(big, f), getattr(small, f), dst_word=S)
              for f in ("kv_valid", "cur_ids", "seen_text", "seen_audio", "rng")]
    n = small.out.shape[1]
    return parts + [Part(big.pos, ctrl[graph_loop.POS0:graph_loop.POS0 + 1], dst_word=S),
                    Part(big.step, None, dst_word=S), Part(big.unfinished, true, dst_word=S),
                    Part(big.out[:, :n], small.out, dst_word=S),
                    Part(big.out[:, n:], None, dst_word=S)]


_SEED_SALT = 0x10CA1  # ``polling.request_seed``'s salt for this family


class LocalBatchServer:
    """Ports ``mosstts_tpu.engine.local_batch_server.LocalBatchServer``. The
    server runs where ``params`` live. ``graphs`` (on the card): replay each
    frame and admission as a CUDA graph; False runs them eagerly, to
    compare. The graphs read ``params`` where they are: build a new server
    after quantizing them."""

    def __init__(self, params: LocalParams, config: LocalConfig, *, slots: int = 8,
                 cache_len: int = 1024, out_capacity: int = 256, prompt_bucket: int = 32,
                 dtype=torch.bfloat16, layers: Optional[List[dict]] = None,
                 do_samples: Optional[List[bool]] = None,
                 n_vq_for_inference: Optional[int] = None, eos_token_id: int = 151653,
                 poll_every: int = 4, graphs: bool = True):
        self.params = params
        self.config = config
        self.device = params.text_emb.device
        self.slots = slots
        self.cache_len = cache_len
        self.out_capacity = out_capacity
        self.prompt_bucket = prompt_bucket
        self.dtype = dtype
        self.n_vq_infer = int(n_vq_for_inference or config.n_vq)
        self.eos_token_id = eos_token_id
        self.poll_every = poll_every

        self._ids = itertools.count()
        self._queue: List[_LocalRequest] = []
        self._active: Dict[int, _LocalRequest] = {}
        dev = self.device
        self.state = init_local_state(config, slots, cache_len, out_capacity,
                                      row_keys(0, slots), per_row=True, dtype=dtype,
                                      device=dev)
        self.sampling = make_local_sampling(layers, do_samples, config.channels, device=dev)
        self._steps = LocalSteps(params, config, self.state, self.sampling, graphs=graphs)
        # the static batch-1 admission state (a scalar cursor): each
        # admission prefills into it, then is spliced into its slot at the
        # control words (SLOT, POS0) in the same program, the key with it
        self._small = init_local_state(config, 1, cache_len, 1, row_keys(0, 1),
                                       dtype=dtype, device=dev)
        self._ctrl = torch.zeros(graph_loop.CTRL_WORDS, dtype=torch.int32, device=dev)
        splice = RowCopy(local_splice_parts(
            self.state, self._small, self._ctrl, torch.ones(1, dtype=torch.bool, device=dev)),
            self._ctrl)
        self._prefills = LocalPrefills(self._steps, self._small, capture_on_use=False,
                                       after=lambda key: splice())
        self.total_steps = 0
        self.util_sum = 0.0  # sum over steps of active/slots (mean = /total_steps)
        self._pos_host = np.zeros(slots, np.int64)  # upper bound (freezes lag)
        self._step_host = np.full(slots, 1 << 30, np.int64)

    def _frame_kw(self, attend: int) -> dict:
        return dict(attend_len=attend, n_vq_infer=self.n_vq_infer,
                    eos_token_id=self.eos_token_id)

    def _attend(self, active, ahead: int) -> int:
        return attend_bucket(int(self._pos_host[active].max()) + ahead, 256, self.cache_len)

    # ------------------------------------------------------------------
    def submit(self, input_ids: np.ndarray, *, max_new_tokens: int = 256) -> int:
        """Queue a (T, C) prompt grid; ``max_new_tokens`` is clamped to
        ``out_capacity``. A grid of the wrong width, or a prompt bucket plus
        budget plus poll slack past ``cache_len``, raises ValueError."""
        input_ids = np.asarray(input_ids, np.int64)
        if input_ids.ndim != 2 or input_ids.shape[1] != self.config.channels:
            raise ValueError(f"expected (T, {self.config.channels}) grid")
        Tb = _round_up(input_ids.shape[0], self.prompt_bucket)
        max_new_tokens = min(max_new_tokens, self.out_capacity)
        if Tb + max_new_tokens + self.poll_every > self.cache_len:
            raise ValueError(f"prompt ({Tb}) + max_new_tokens ({max_new_tokens}) exceeds "
                             f"cache_len={self.cache_len}")
        rid = next(self._ids)
        self._queue.append(_LocalRequest(request_id=rid, input_ids=input_ids,
                                         max_new_tokens=max_new_tokens))
        return rid

    def _aim(self, slot: int, pos0: int = 0) -> None:
        """Point the next splice at ``slot``, its cursor at ``pos0``."""
        graph_loop.set_words(self._ctrl, graph_loop.SLOT,
                             [slot] + [0] * (graph_loop.POS0 - graph_loop.SLOT - 1) + [pos0])

    @torch.no_grad()
    def _admit(self, slot: int, req: _LocalRequest) -> None:
        """The bucket's admission program: a batch-1 prefill of the
        request's grid, left-padded to its prompt bucket, into ``_small``,
        spliced into ``slot`` with the key made from the request id, which
        the host writes into ``_small`` first."""
        cfg = self.config
        T = req.input_ids.shape[0]
        Tb = _round_up(T, self.prompt_bucket)
        ids = np.full((1, Tb, cfg.channels), cfg.audio_pad_code, np.int64)
        ids[..., 0] = cfg.pad_token_id
        ids[0, Tb - T:] = req.input_ids
        mask = np.zeros((1, Tb), bool)
        mask[0, Tb - T:] = True
        dev = self.device
        self._small.rng.copy_(host_tensor(
            prng_key(request_seed(_SEED_SALT, req.request_id)).numpy()[None], dev),
            non_blocking=True)  # a prefill draws nothing: the key rides into the slot
        # local_prefill_split leaves pos = Tb-1 (the cur_ids row's slot)
        self._aim(slot, Tb - 1)
        self._prefills.run(host_tensor(ids, dev), host_tensor(mask, dev),
                           n_vq_infer=self.n_vq_infer)
        self._active[slot] = req
        self._pos_host[slot] = Tb - 1
        self._step_host[slot] = 0

    def _fill_free_slots(self) -> None:
        busy = set(self._active)
        for slot in range(self.slots):
            if not self._queue:
                break
            if slot not in busy:
                self._admit(slot, self._queue.pop(0))

    # ------------------------------------------------------------------
    def _advance(self, active, k: int) -> None:
        """The host mirrors after ``k`` frames of the ``active`` slots."""
        self.total_steps += k
        self.util_sum += k * (len(self._active) / self.slots)
        self._pos_host[active] += k
        self._step_host[active] += k

    def step(self, *, poll: Optional[bool] = None) -> List[CompletedLocal]:
        """Admit, decode one frame for every slot in lock-step, then collect
        if ``poll`` (by default every ``poll_every`` steps, and whenever a
        slot reaches its budget)."""
        self._fill_free_slots()
        if not self._active:
            return []
        active = sorted(self._active)
        self._steps.step(**self._frame_kw(self._attend(active, 2)))
        self._advance(active, 1)
        if poll is None:
            poll = (self.total_steps % self.poll_every == 0
                    or any(self._step_host[s] >= self._active[s].max_new_tokens
                           for s in active))
        return self._collect() if poll else []

    def _dispatch_block(self, k: int) -> int:
        """Admit, then ``k`` frames at one attend bucket (JAX's one-program
        block: k replays here); returns the frames run. Budget overshoot is
        bounded by k - 1 frames (``submit`` reserves ``poll_every`` slots of
        slack); EOS-frozen rows hold their cursor, so the host mirrors only
        over-count."""
        self._fill_free_slots()
        if not self._active:
            return 0
        active = sorted(self._active)
        kw = self._frame_kw(self._attend(active, k + 1))
        if k == 1:
            self._steps.step(**kw)
        else:
            self._steps.loop_block(k, **kw)
        self._advance(active, k)
        return k

    def step_block(self, k: Optional[int] = None) -> List[CompletedLocal]:
        """One poll window: admit, ``k`` (default ``poll_every``) frames, then
        collect."""
        k = self.poll_every if k is None else k
        if self._dispatch_block(k) == 0:
            return []
        return self._collect()

    def _dispatch_event(self, max_k: int):
        """Admit, then decode until a scheduling event (a watched slot
        finished, or the block's cap: a budget or the attend bucket's end).
        Returns ``(frames run, finished mask | None)``; no admission happens
        in between, so the mask maps onto the current occupants."""
        self._fill_free_slots()
        if not self._active:
            return 0, None
        active = sorted(self._active)
        max_pos = int(self._pos_host[active].max())
        attend = attend_bucket(max_pos + 2, 256, self.cache_len)
        budget = np.full(self.slots, 1 << 30, np.int64)
        for s, req in self._active.items():
            budget[s] = req.max_new_tokens - self._step_host[s]
        k_cap = int(min(max_k, attend - max_pos - 1, int(budget[active].min())))
        if k_cap <= 0:
            return 0, None
        watch = np.zeros(self.slots, bool)
        watch[active] = True
        did, unfinished = self._steps.loop_event(watch, budget, k_cap,
                                                 **self._frame_kw(attend))
        finished = ~unfinished
        self._advance(active, did)
        return did, finished

    def run_events(self, max_steps: int = 100000) -> List[CompletedLocal]:
        """Drain the queue and the active slots with event-driven dispatch:
        each block decodes until a slot needs the scheduler (EOS or budget);
        the grids equal ``run()``'s, and a block ends after the frame that
        finished a watched slot, on the card as on the CPU."""
        done: List[CompletedLocal] = []
        steps = 0
        while True:
            if self._active:
                # budget completions are host-knowable: free those slots
                # before dispatching so the block admits into them
                done.extend(self._collect(stopped=np.zeros(self.slots, bool)))
            if not (self._active or self._queue):
                break
            did, finished = self._dispatch_event(max_steps - steps)
            steps += did
            got = self._collect(stopped=finished) if finished is not None else []
            done.extend(got)
            if did == 0 and not got:
                if self._queue:
                    logging.getLogger(__name__).warning(
                        "run_events() stopping with %d undrained request(s) still queued",
                        len(self._queue))
                break
        return done

    def _collect(self, stopped: Optional[np.ndarray] = None) -> List[CompletedLocal]:
        if stopped is None:
            stopped = ~self.state.unfinished.cpu().numpy()
        finished = [(slot, req) for slot, req in sorted(self._active.items())
                    if stopped[slot] or self._step_host[slot] >= req.max_new_tokens]
        if not finished:
            return []
        outs_all = self.state.out.cpu().numpy()  # one transfer of the whole buffer
        cfg = self.config
        done: List[CompletedLocal] = []
        for slot, req in finished:
            n = int(min(self._step_host[slot], req.max_new_tokens, self.out_capacity))
            gen = outs_all[slot, :n]
            # trim after the first EOS row on the text channel (the engine
            # keeps the EOS frame; frames past it are frozen repeats)
            eos = np.nonzero(gen[:, 0] == self.eos_token_id)[0]
            if len(eos):
                gen = gen[: int(eos[0]) + 1]
            full = np.concatenate([req.input_ids, gen.astype(np.int64)], axis=0)
            T = req.input_ids.shape[0]
            matches = np.nonzero(full[:, 0] == cfg.audio_start_token_id)[0]
            start_idx = int(matches[-1]) if len(matches) else 0
            done.append(CompletedLocal(request_id=req.request_id,
                                       start_length=T - start_idx - 1,  # reference :472
                                       tokens=full[start_idx:], steps=len(gen)))
            del self._active[slot]
            self._step_host[slot] = 1 << 30
            self.state.unfinished[slot] = False
        return done

    def run(self, max_steps: int = 100000, pipelined: bool = True) -> List[CompletedLocal]:
        """Drain the queue and the active slots; completions in finish order.

        ``pipelined`` hides each poll's host round trip behind the next
        block of ``poll_every`` frames (``polling.run_pipelined``): EOS is
        seen up to one block late (frozen frames the EOS trim drops);
        budget completions come from the host mirrors and stay exact."""
        if pipelined:
            return run_pipelined(self, lambda room: self._dispatch_block(
                min(self.poll_every, room)), lambda: ~self.state.unfinished, max_steps)
        done: List[CompletedLocal] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self._active and not self._queue:
                break
        return done

    def warmup(self, *, prompt_lens=(32,), attend_upto: Optional[int] = None) -> None:
        """Run each prompt bucket's admission (a short request each) and
        capture its graph (a bucket not named here admits eagerly), and
        capture the frame graph of every attend bucket up to ``attend_upto``
        (JAX compiles the same programs). Idle rows are frozen
        (``unfinished`` False), so the extra idle frames cannot leak into
        later requests."""
        assert not self._active and not self._queue, "warmup on a busy server"
        cfg = self.config
        for T in prompt_lens:
            g = np.full((int(T), cfg.channels), cfg.audio_pad_code, np.int64)
            g[:, 0] = cfg.pad_token_id
            g[min(2, T - 1), 0] = cfg.audio_start_token_id
            self.submit(g, max_new_tokens=2)
        self.run()
        self._aim(self.slots)  # out of range: a capture's eager warm-up splices nowhere
        for T in prompt_lens:
            self._prefills.capture(_round_up(int(T), self.prompt_bucket),
                                   n_vq_infer=self.n_vq_infer)
        upto = min(attend_upto or self.cache_len, self.cache_len)
        pos = 2
        while True:
            a = attend_bucket(pos, 256, self.cache_len)
            self._steps.step(**self._frame_kw(a))
            if a >= upto:
                break
            pos = a + 1

    @property
    def utilization(self) -> float:
        return len(self._active) / self.slots
