"""Step-wise inference engine for MossTTSRealtime (prefill/step/finish).

Ports ``mosstts_tpu/engine/realtime_engine.py``: ``RealtimeEngine`` with
``random_init``, ``quantize``, ``prefill`` (the left-padded
``prefill_bucket`` grid with ``audio_bos`` planted on the last prefix row),
``step_async``/``step``/``step_block``, ``fetch_frames``, ``finish``,
``generate``, ``is_finished``, ``generated_tokens``,
``reset_generation_state(keep_cache=True)`` for multi-turn cache reuse,
and the cache growth toward ``max_context``.

The engine keeps one static ``RealtimeState`` (batch, cache length) and
advances it in place through ``engine/step_graph.RealtimeSteps``: on the
card every frame is the replay of a CUDA graph of ``realtime_decode_step``,
one per attend bucket (the JAX engine's jitted, state-donated
``_step_fn``). A step enqueues its replay and a device copy of the frame,
and returns without waiting; ``fetch_frames`` brings many frames to the
host in one transfer, as JAX does. A prefill is the replay of a CUDA graph
of ``realtime_prefill_step`` per ``(T, attend_len, top_k)``
(``step_graph.RealtimePrefills``, the JAX engine's ``_prefill_fn``) into
the same state, at its cursor: a later turn of the same length and attend
bucket replays the first turn's graph. A key's first prefill runs eagerly,
its second captures; the engine keeps its ``PREFILL_GRAPHS`` most recent
keys. ``graphs=False`` runs the same frames and prefills eagerly on the
card; the CPU always does.

A new conversation (``reset_generation_state(keep_cache=False)``) at the
same batch and cache length zeroes that state in place and writes its
keys anew, so its graphs serve every later conversation. When a
conversation outgrows the cache, a cache twice as long (or more) is made,
the old one copied in, and the state's decode steps and prefills and
every graph over the old buffers are dropped and built anew over the new
ones (``_ensure_capacity``).

Each row draws from its own threefry key, row b of ``split(PRNGKey(seed),
B)`` (``ops/sampling.row_keys``), split per frame as JAX splits its one
key: greedy frames equal JAX's, and so do a batch of one's sampled frames
when its key is JAX's (the JAX engine draws the whole batch from
``PRNGKey(seed)`` itself).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.config import RealtimeConfig
from ..models.realtime import (RealtimeParams, RealtimeState, init_realtime_params,
                               init_realtime_state, make_rt_sampling)
from ..nn.qwen3 import KVCache
from ..ops.quant import quantize_tree_
from ..ops.sampling import row_keys
from .delay_engine import PREFILL_GRAPHS, _round_up, attend_bucket
from .step_graph import RealtimePrefills, RealtimeSteps, host_tensor


class RealtimeEngine:
    """Ports ``mosstts_tpu.engine.realtime_engine.RealtimeEngine``:
    prefill/step/finish over a carried ``RealtimeState``. ``params`` is a
    ``RealtimeParams`` module on ``device``, float or, after
    ``quantize()``, with int8 matmul weights. ``graphs`` (on the card):
    replay each frame and prefill as a CUDA graph; False runs them eagerly,
    to compare."""

    def __init__(self, params: RealtimeParams, config: RealtimeConfig, *,
                 dtype=torch.bfloat16, max_length: int = 1000, cache_len: int = 4096,
                 max_context: int = 32768, prefill_bucket: int = 16, top_k: int = 30,
                 device=None, graphs: bool = True):
        self.params = params
        self.config = config
        self.dtype = dtype
        self.max_length = max_length
        self.cache_len = cache_len
        self.max_context = max_context
        self.prefill_bucket = prefill_bucket
        self.top_k = top_k
        self.device = torch.device(device) if device is not None else params.text_emb.device
        self.graphs = graphs

        self._steps: Optional[RealtimeSteps] = None  # the static state's frames
        self._prefills: Optional[RealtimePrefills] = None  # and its prefills
        self._live = False  # a conversation is under way in the static state
        self._samp_key = None  # the sampling values the static sampling holds
        # frames: host arrays, and device copies of frames not fetched yet
        self._generated: List = []
        self._batch: Optional[int] = None
        self._seed = 0
        # host mirrors: the cache cursor and each row's sticky EOS
        self._host_len = 0
        self._stopped: Optional[np.ndarray] = None

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[RealtimeConfig] = None,
                    dtype=torch.bfloat16, device="cuda", **kw) -> "RealtimeEngine":
        """Random weights drawn directly on ``device`` from ``seed``."""
        config = config or RealtimeConfig()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_realtime_params(config, generator=gen, dtype=dtype, device=device)
        return cls(params, config, dtype=dtype, device=device, **kw)

    def quantize(self, mode: str = "int8") -> "RealtimeEngine":
        """Ports ``RealtimeEngine.quantize``: weight-only int8 serving, in
        place (``ops.quant.quantize_tree_``). The frame graphs read the float
        weights' addresses, so they are dropped (JAX drops its compiled
        programs); the state, the cache included, is kept."""
        if mode != "int8":
            raise ValueError(f"unknown quantization mode: {mode}")
        quantize_tree_(self.params)
        if self._steps is not None:
            old = self._steps
            self._set_steps(old.state, old.sampling)
        return self

    def _set_steps(self, state: Optional[RealtimeState], sampling=None) -> None:
        """Frames and prefills over the static ``state`` (None drops
        both, and with them every graph)."""
        self._steps = self._prefills = None  # the old graphs go first
        if state is None:
            return
        self._steps = RealtimeSteps(self.params, self.config, state, sampling,
                                    graphs=self.graphs)
        self._prefills = RealtimePrefills(self._steps, state, sampling,
                                          max_graphs=PREFILL_GRAPHS)

    # ------------------------------------------------------------------
    @property
    def state(self) -> Optional[RealtimeState]:
        """The conversation's state, None between conversations."""
        return self._steps.state if self._live else None

    @property
    def is_finished(self) -> bool:
        """Host-side: the sticky EOS of the fetched frames, no device read.
        Frames not fetched yet may already hold an EOS; a few more steps are
        then enqueued, in which stopped rows repeat their frame."""
        if self._stopped is None:
            return False
        return bool(self._stopped.all())

    @property
    def generated_tokens(self) -> List[np.ndarray]:
        self._materialize_generated()
        return list(self._generated)

    def reset_generation_state(self, keep_cache: bool = True) -> None:
        """Start a new turn; with ``keep_cache`` the backbone cache and its
        mask carry over for multi-turn context (reference :78-87)."""
        self._generated = []
        self._stopped = None
        if not keep_cache or not self._live:
            self._live = False
            self._host_len = 0
        else:
            st = self._steps.state
            st.is_stopping.zero_()
            st.last_audio.fill_(self.config.audio_pad_token)
            st.hist_len.zero_()

    # ------------------------------------------------------------------
    def _note_frames(self, frames_np: np.ndarray) -> None:
        """Update the host EOS mirror from fetched frames (B, rvq) or
        (T, B, rvq)."""
        if self._stopped is None:
            return
        f = frames_np if frames_np.ndim == 3 else frames_np[None]
        self._stopped |= (f[..., 0] == self.config.audio_eos_token).any(axis=0)

    def fetch_frames(self, handles: List[torch.Tensor]) -> List[np.ndarray]:
        """Fetch K in-flight frames in one host transfer."""
        if not handles:
            return []
        stacked = torch.stack(handles).cpu().numpy()  # (K, B, rvq)
        self._note_frames(stacked)
        return [stacked[i] for i in range(stacked.shape[0])]

    def _materialize_generated(self) -> None:
        pending = [(i, h) for i, h in enumerate(self._generated)
                   if not isinstance(h, np.ndarray)]
        if not pending:
            return
        for (i, _), f in zip(pending, self.fetch_frames([h for _, h in pending])):
            self._generated[i] = f

    # ------------------------------------------------------------------
    def _new_state(self, B: int) -> None:
        """A zeroed static state of ``B`` rows at ``cache_len`` drawing from
        the row keys of ``self._seed``: the one already there, zeroed
        in place (its graphs kept), when its shape fits."""
        H = self.max_length + 64
        st = self._steps.state if self._steps is not None else None
        if st is not None and st.kv_valid.shape == (B, self.cache_len) and \
                st.history.shape[1] == H:
            for buf in st.cache:
                buf.zero_()
            for t in (st.kv_valid, st.cur_len, st.is_stopping, st.history, st.hist_len):
                t.zero_()
            st.last_audio.fill_(self.config.audio_pad_token)
            st.rng.copy_(host_tensor(row_keys(self._seed, B).numpy(), self.device),
                         non_blocking=True)
            return
        self._set_steps(None)  # the old cache and graphs go first
        dev = self.device
        st = init_realtime_state(self.config, B, self.cache_len, H,
                                 row_keys(self._seed, B), dtype=self.dtype,
                                 device=dev)
        self._samp_key = None
        self._set_steps(st, make_rt_sampling(device=dev))

    def _set_sampling(self, temperature, top_p, repetition_penalty, do_sample) -> None:
        """Write the sampling values into the static sampling, if they
        changed."""
        key = (temperature, top_p, repetition_penalty, do_sample)
        if key == self._samp_key:
            return
        for static, value in zip(self._steps.sampling,
                                 make_rt_sampling(temperature, top_p, repetition_penalty,
                                                  do_sample)):
            static.copy_(value)
        self._samp_key = key

    def _ensure_capacity(self, needed_total: int) -> None:
        """Grow the backbone cache toward ``max_context`` instead of
        overflowing: a cache of ``attend_bucket(needed, cache_len,
        max_context)`` slots, the old one copied into its head. The frame
        and prefill graphs read the old buffers' addresses, so the decode
        steps, the prefills and all their graphs are built anew over the new
        state."""
        if needed_total <= self.cache_len or not self._live:
            return
        new_len = attend_bucket(needed_total, self.cache_len, self.max_context)
        if new_len < needed_total:
            raise RuntimeError(f"conversation exceeds max_context={self.max_context} slots; "
                               "reset the conversation.")
        old = self._steps
        st = old.state
        pad = new_len - self.cache_len

        def grow(t: torch.Tensor, dim: int) -> torch.Tensor:
            shape = list(t.shape)
            shape[dim] = pad
            return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=dim)

        new = st._replace(cache=KVCache(grow(st.cache.k, 3), grow(st.cache.v, 3)),
                          kv_valid=grow(st.kv_valid, 1))
        sampling = old.sampling
        self._set_steps(None)
        del old, st
        self._set_steps(new, sampling)
        self.cache_len = new_len

    def _attend_bucket(self, needed: int) -> int:
        return attend_bucket(needed, max(self.prefill_bucket, 128), self.cache_len)

    # ------------------------------------------------------------------
    def _normalize_input_ids(self, input_ids) -> List[np.ndarray]:
        if isinstance(input_ids, np.ndarray):
            if input_ids.ndim == 2:
                return [input_ids]
            if input_ids.ndim == 3:
                return [input_ids[i] for i in range(input_ids.shape[0])]
        if isinstance(input_ids, (list, tuple)):
            return [np.asarray(x) for x in input_ids]
        raise ValueError("input_ids must be [T, C] or [B, T, C] or a list of [T, C].")

    def _normalize_text_prefix(self, text_prefix_ids, batch: int) -> List[List[int]]:
        if text_prefix_ids is None:
            raise ValueError("text_prefix_ids must be provided for prefill.")
        if isinstance(text_prefix_ids, np.ndarray):
            text_prefix_ids = text_prefix_ids.tolist()
        if isinstance(text_prefix_ids, (list, tuple)):
            if len(text_prefix_ids) == 0:
                return [[] for _ in range(batch)]
            if isinstance(text_prefix_ids[0], (int, np.integer)):
                return [list(text_prefix_ids)]
            if len(text_prefix_ids) == 1 and batch > 1:
                return [list(text_prefix_ids[0])] * batch
            if len(text_prefix_ids) != batch:
                raise ValueError("text_prefix_ids batch size mismatch.")
            return [list(x) for x in text_prefix_ids]
        raise ValueError("text_prefix_ids must be list-like.")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, input_ids, text_prefix_ids, *, max_prefill_len: Optional[int] = None,
                temperature: float = 0.8, top_p: float = 0.6, top_k: int = 30,
                do_sample: bool = True, repetition_penalty: Optional[float] = 1.1,
                seed: Optional[int] = None, text_pad_id: int = 151655,
                pad_token_id: int = 151643) -> np.ndarray:
        """The turn grid plus the first text rows (``audio_bos`` planted on
        the last prefix row's channel 1), left-padded to a multiple of
        ``prefill_bucket``, prefilled at the cache cursor; returns the first
        frame (B, rvq) (reference :122-208). ``seed`` makes a new
        conversation's keys."""
        cfg = self.config
        grids = self._normalize_input_ids(input_ids)
        B = len(grids)
        prefixes = self._normalize_text_prefix(text_prefix_ids, B)

        rows = []
        for grid, prefix in zip(grids, prefixes):
            if max_prefill_len is not None:
                prefix = prefix[:max_prefill_len]
            if len(prefix) == 0:
                raise ValueError("Prefill requires at least one text token.")
            seg = np.full((len(prefix), cfg.rvq + 1), cfg.audio_pad_token, np.int64)
            seg[:, 0] = prefix
            seg[len(prefix) - 1, 1] = cfg.audio_bos_token
            rows.append(np.concatenate([np.asarray(grid, np.int64), seg], axis=0))

        max_len = _round_up(max(r.shape[0] for r in rows), self.prefill_bucket)
        ids = np.full((B, max_len, cfg.rvq + 1), cfg.audio_pad_token, np.int64)
        ids[..., 0] = pad_token_id
        valid = np.zeros((B, max_len), bool)
        for i, r in enumerate(rows):
            ids[i, max_len - r.shape[0]:] = r
            valid[i, max_len - r.shape[0]:] = True

        self.top_k = top_k
        if not self._live or self._batch != B:
            if seed is not None:
                self._seed = seed
            self._new_state(B)
            self._batch = B
            self._host_len = 0
            self._live = True
        # the cursor is mirrored on the host: no device read for the check
        used = self._host_len
        self._ensure_capacity(used + max_len)
        self._set_sampling(temperature, top_p, repetition_penalty, do_sample)

        dev = self.device
        st = self._prefills.run(host_tensor(ids, dev), host_tensor(valid, dev),
                                attend_len=self._attend_bucket(used + max_len), top_k=top_k)
        self._host_len = used + max_len
        self._stopped = np.zeros((B,), bool)
        frame_np = st.last_audio.cpu().numpy().copy()  # the first frame, off the static buffer
        self._note_frames(frame_np)
        self._generated = [frame_np]
        return frame_np

    @torch.no_grad()
    def step_async(self, text_token, *, temperature: float = 0.8, top_p: float = 0.6,
                   top_k: int = 30, do_sample: bool = True,
                   repetition_penalty: Optional[float] = 1.1,
                   text_pad_id: int = 151655) -> torch.Tensor:
        """Enqueue one frame and return its device copy without waiting;
        ``fetch_frames`` brings many to the host in one transfer. The
        prefill's ``top_k`` holds for the conversation (as in JAX)."""
        if not self._live or not self._generated:
            raise ValueError("You must call prefill() before step().")
        B = self._batch
        if text_token is None:
            toks = [text_pad_id] * B
        elif isinstance(text_token, (int, np.integer)):
            toks = [int(text_token)]
        elif isinstance(text_token, np.ndarray):
            toks = text_token.tolist()
        else:
            toks = list(text_token)
        if len(toks) != B:
            raise ValueError(f"text_token batch size mismatch: got {len(toks)}, expected {B}.")
        self._ensure_capacity(self._host_len + 1)
        self._set_sampling(temperature, top_p, repetition_penalty, do_sample)
        self._steps.step(host_tensor(np.asarray(toks, np.int64), self.device),
                         attend_len=self._attend_bucket(self._host_len + 1), top_k=self.top_k)
        self._host_len += 1
        frame = self._steps.state.last_audio.clone()
        self._generated.append(frame)
        return frame

    def step(self, text_token, **kw) -> np.ndarray:
        """One frame, synchronously (prefill() must come first)."""
        if self.is_finished:
            self._materialize_generated()
            return self._generated[-1]
        handle = self.step_async(text_token, **kw)
        frame_np = self.fetch_frames([handle])[0]
        self._generated[-1] = frame_np
        return frame_np

    def step_block(self, token_rows: List, **kw) -> List[np.ndarray]:
        """One step per entry of ``token_rows`` (a per-row token list, or
        None for pads), then one transfer for all the frames."""
        if self.is_finished or not token_rows:
            return []
        start = len(self._generated)
        frames = self.fetch_frames([self.step_async(t, **kw) for t in token_rows])
        for i, f in enumerate(frames):
            self._generated[start + i] = f
        return frames

    def finish(self, max_steps: Optional[int] = None, drain_block: int = 8,
               **sampling_kw) -> List[np.ndarray]:
        """Drain with text pads until EOS (reference :273-299), in blocks of
        ``drain_block`` steps with one transfer each: EOS is seen up to a
        block late, and the frames past it are frozen repeats that the EOS
        trim drops."""
        outputs: List[np.ndarray] = []
        steps_left = max_steps if max_steps is not None else self.max_length
        while steps_left > 0 and not self.is_finished:
            block = min(drain_block, steps_left)
            start = len(self._generated)
            frames = self.fetch_frames([self.step_async(None, **sampling_kw)
                                        for _ in range(block)])
            for i, f in enumerate(frames):
                self._generated[start + i] = f
            steps_left -= block
            outputs.extend(frames)
        return outputs

    # ------------------------------------------------------------------
    def generate(self, input_ids, text_ids: List[List[int]], *,
                 max_length: Optional[int] = None, prefill_text_len: int = 12,
                 text_pad_id: int = 151655, seed: Optional[int] = None,
                 **sampling_kw) -> List[np.ndarray]:
        """The non-streaming batch path (reference inferencer.py:178-297):
        one real text token per frame while any remains, then pads; each
        row's frames trimmed at its first EOS. ``seed`` goes to the
        prefill."""
        self.reset_generation_state(keep_cache=False)
        grids = self._normalize_input_ids(input_ids)
        B = len(grids)
        prefixes = [t[:prefill_text_len] for t in text_ids]
        rest = [t[prefill_text_len:] for t in text_ids]
        self.prefill(grids, prefixes, seed=seed, **sampling_kw)
        limit = max_length or self.max_length
        step_i = 0
        while not self.is_finished and step_i < limit:
            # a block of steps, then one fetch for the whole block
            block = min(8, limit - step_i)
            start = len(self._generated)
            handles = []
            for _ in range(block):
                toks = [rest[b][step_i] if step_i < len(rest[b]) else text_pad_id
                        for b in range(B)]
                handles.append(self.step_async(toks, text_pad_id=text_pad_id, **sampling_kw))
                step_i += 1
            for i, f in enumerate(self.fetch_frames(handles)):
                self._generated[start + i] = f
        self._materialize_generated()
        frames = np.stack(self._generated, axis=1)  # (B, T, rvq)
        out = []
        for b in range(B):
            row = frames[b]
            eos = np.nonzero(row[:, 0] == self.config.audio_eos_token)[0]
            out.append(row[: int(eos[0])] if len(eos) else row)
        return out
