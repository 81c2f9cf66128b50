"""Host-facing generation engine for MossTTSLocal (the depth-transformer
family).

Ports ``mosstts_tpu/engine/local_engine.py``: ``LocalEngine`` with
``random_init``, ``quantize("int8")`` and ``generate`` (the reference's
generation contract, moss_tts_local/README.md S7 and CustomMixin._sample:
per-channel sampling from ``layers`` and ``do_samples``,
``n_vq_for_inference`` variable bitrate, EOS on the text channel, and
(start_length, ids from the last ``audio_start``) per row).

The engine keeps one static ``LocalGenState`` for its last (batch,
cache length) only, the cache sized by ``cache_bucket`` as JAX sizes it:
a call at another key frees the old state and its graphs before it makes
its own. A call prefills into that state in place, then advances it one
frame at a time through ``engine/step_graph.LocalSteps``: on the card every
frame is the replay of a CUDA graph of ``local_frame_step`` per attend
bucket (``delay_engine.attend_bucket``, the JAX engine's jitted,
state-donated ``_step_fn``), and every prefill the replay of a CUDA graph
of ``local_prefill_split`` per prompt length and ``n_vq_infer``
(``step_graph.LocalPrefills``, the JAX engine's ``_prefill_fn``; a key's
first prefill runs eagerly, its second captures; the engine keeps its
``PREFILL_GRAPHS`` most recent keys, since lengths are not bucketed).
``graphs=False`` runs the same frames and prefills eagerly on the card, to
compare; the CPU always does. The stop flags are read every ``poll_every``
frames, as in JAX.

Each row draws from its own threefry key, row b of ``split(PRNGKey(seed),
B)`` (``ops/sampling.row_keys``), split per frame as JAX splits its one
key: greedy frames equal JAX's (the JAX engine draws the whole batch from
one key, so sampled frames differ).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import LocalConfig
from ..models.local import LocalParams, init_local_params, init_local_state, make_local_sampling
from ..ops.quant import quantize_tree_
from ..ops.sampling import row_keys
from .delay_engine import PREFILL_GRAPHS, _round_up, attend_bucket
from .step_graph import LocalPrefills, LocalSteps, host_tensor


class LocalEngine:
    """Ports ``mosstts_tpu.engine.local_engine.LocalEngine``. ``params`` is
    a ``LocalParams`` module on ``device``, float or, after ``quantize()``,
    with int8 matmul weights. ``graphs`` (on the card): replay each frame
    and prefill as a CUDA graph; False runs them eagerly, to compare."""

    def __init__(self, params: LocalParams, config: LocalConfig, *, dtype=torch.bfloat16,
                 cache_bucket: int = 256, device=None, graphs: bool = True):
        self.params = params
        self.config = config
        self.dtype = dtype
        self.cache_bucket = cache_bucket
        self.device = torch.device(device) if device is not None else params.text_emb.device
        self.graphs = graphs
        self._steps: Optional[LocalSteps] = None  # frames over the static state
        self._prefills: Optional[LocalPrefills] = None  # and its prefills
        # generate() runs one call at a time: the static state serves one
        self._lock = threading.Lock()

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[LocalConfig] = None,
                    dtype=torch.bfloat16, device="cuda", **kw) -> "LocalEngine":
        """Random weights drawn directly on ``device`` from ``seed``."""
        config = config or LocalConfig()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_local_params(config, generator=gen, dtype=dtype, device=device)
        return cls(params, config, dtype=dtype, device=device, **kw)

    def quantize(self, mode: str = "int8") -> "LocalEngine":
        """Ports ``LocalEngine.quantize``: weight-only int8 serving, in
        place (``ops.quant.quantize_tree_``). The frame graphs read the float
        weights' addresses, so they are dropped (JAX drops its compiled
        programs); the static state is kept."""
        if mode != "int8":
            raise ValueError(f"unknown quantization mode: {mode}")
        with self._lock:
            quantize_tree_(self.params)
            if self._steps is not None:
                old = self._steps
                self._set_steps(old.state, old.sampling)
        return self

    def _set_steps(self, state, sampling=None) -> None:
        """Frames and prefills over the static ``state`` (None drops
        both, and with them every graph)."""
        self._steps = self._prefills = None  # the old graphs go first
        if state is None:
            return
        self._steps = LocalSteps(self.params, self.config, state, sampling, graphs=self.graphs)
        self._prefills = LocalPrefills(self._steps, state, max_graphs=PREFILL_GRAPHS)

    def _static(self, B: int, cache_len: int) -> LocalSteps:
        """The frames over the static state of ``B`` rows and ``cache_len``
        slots: the one there if it has that shape, else a new one (the old
        state and its graphs freed first)."""
        st = self._steps.state if self._steps is not None else None
        if st is not None and st.kv_valid.shape == (B, cache_len):
            return self._steps
        self._set_steps(None)
        dev = self.device
        st = init_local_state(self.config, B, cache_len, cache_len, row_keys(0, B),
                              dtype=self.dtype, device=dev)
        self._set_steps(st, make_local_sampling(None, None, self.config.channels, device=dev))
        return self._steps

    @torch.no_grad()
    def generate(
        self,
        input_ids,
        attention_mask=None,
        *,
        max_new_tokens: int = 1000,
        layers: Optional[List[dict]] = None,
        do_samples: Optional[List[bool]] = None,
        n_vq_for_inference: Optional[int] = None,
        eos_token_id: int = 151653,
        seed: int = 0,
        poll_every: int = 8,
        streamer=None,
    ) -> List[Tuple[int, np.ndarray]]:
        """Ports ``LocalEngine.generate``: prefill the left-padded (B, T, C)
        grid, then up to ``max_new_tokens`` frames, stopping when every row
        has emitted ``eos_token_id`` (read every ``poll_every`` frames).
        ``streamer``: an object with put(np.ndarray)/end() that receives
        each frame's text-channel tokens (reference CustomMixin :435-436).
        Returns (start_length, ids from the last audio_start row) per row."""
        cfg = self.config
        input_ids = np.asarray(input_ids, np.int64)
        B, T, C = input_ids.shape
        if attention_mask is None:
            attention_mask = np.ones((B, T), bool)
        n_vq_infer = int(n_vq_for_inference or cfg.n_vq)
        cache_len = _round_up(T + max_new_tokens + 1, self.cache_bucket)
        dev = self.device
        with self._lock:
            frames = self._static(B, cache_len)
            st = frames.state
            st.rng.copy_(host_tensor(row_keys(seed, B).numpy(), dev), non_blocking=True)
            for static, value in zip(frames.sampling,
                                     make_local_sampling(layers, do_samples, cfg.channels)):
                static.copy_(value)
            self._prefills.run(host_tensor(input_ids, dev),
                               host_tensor(np.asarray(attention_mask, bool), dev),
                               n_vq_infer=n_vq_infer)
            steps = 0
            while steps < max_new_tokens:
                attend = attend_bucket(T + steps + 1, self.cache_bucket, cache_len)
                frames.step(attend_len=attend, n_vq_infer=n_vq_infer, eos_token_id=eos_token_id)
                steps += 1
                if streamer is not None:
                    streamer.put(st.cur_ids[:, 0, 0].cpu().numpy().copy())
                if steps % poll_every == 0 and not bool(st.unfinished.any()):
                    break
            out = st.out[:, :steps].cpu().numpy()

        if streamer is not None:
            streamer.end()
        full = np.concatenate([input_ids, out.astype(np.int64)], axis=1)
        results: List[Tuple[int, np.ndarray]] = []
        for b in range(B):
            matches = np.nonzero(full[b, :, 0] == cfg.audio_start_token_id)[0]
            start_idx = int(matches[-1]) if len(matches) else 0
            # reference: start_length = prompt_len - start_idx - 1 (:472)
            results.append((T - start_idx - 1, full[b, start_idx:]))
        return results
