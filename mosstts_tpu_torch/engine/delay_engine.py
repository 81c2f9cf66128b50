"""Host-facing generation engine for the Delay model family (MOSS-TTS 8B,
MOSS-TTSD, MOSS-VoiceGenerator, MOSS-SoundEffect).

Ports ``mosstts_tpu/engine/delay_engine.py``: ``attend_bucket``,
``DelayEngine`` with ``random_init`` and ``generate``. Each decode step runs
eagerly, and the host polls the stop flags every ``poll_every`` steps. The
JAX package's ``on_device`` loop is one ``lax.while_loop`` program; here
``on_device=True`` runs the same eager loop (a CUDA graph of the step is
later work).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DelayConfig
from ..models.delay import (
    DelayParams,
    delay_decode_step,
    delay_prefill,
    init_delay_params,
    make_sampling,
)
from ..ops.sampling import row_generators


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def attend_bucket(needed: int, base: int, cap: int) -> int:
    """Ports ``mosstts_tpu.engine.delay_engine.attend_bucket``: smallest
    base * 2^k >= needed, capped."""
    b = base
    while b < needed:
        b *= 2
    return min(b, cap)


class DelayEngine:
    """Ports ``mosstts_tpu.engine.delay_engine.DelayEngine`` (solo engine,
    linear KV cache in ``dtype``, or int8 with per-slot scales when
    ``kv_quant``). ``params`` is a ``DelayParams`` module on ``device``.
    ``quantize()`` (int8 weights) is not ported yet."""

    def __init__(self, params: DelayParams, config: DelayConfig, *, dtype=torch.bfloat16,
                 cache_bucket: int = 256, top_k_text: int = 50, top_k_audio: int = 25,
                 kv_quant: bool = False, device=None):
        self.params = params
        self.config = config
        self.dtype = dtype
        self.cache_bucket = cache_bucket
        self.top_k_text = top_k_text
        self.top_k_audio = top_k_audio
        self.kv_quant = kv_quant
        self.device = torch.device(device) if device is not None else params.text_head.device

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[DelayConfig] = None,
                    dtype=torch.bfloat16, device="cuda", **kw) -> "DelayEngine":
        """Random weights drawn directly on ``device`` from ``seed``."""
        config = config or DelayConfig()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_delay_params(config, generator=gen, dtype=dtype, device=device)
        return cls(params, config, dtype=dtype, device=device, **kw)

    @torch.no_grad()
    def generate(
        self,
        input_ids: np.ndarray,  # (B, T, 1+n_vq) left-padded
        attention_mask: Optional[np.ndarray] = None,  # (B, T) bool
        *,
        max_new_tokens: int = 1000,
        text_temperature: float = 1.5,
        text_top_p: float = 1.0,
        text_top_k: int = 50,
        audio_temperature: float = 1.7,
        audio_top_p: float = 0.8,
        audio_top_k: int = 25,
        audio_repetition_penalty: float = 1.0,
        audio_rp_cross_batch: bool = False,
        seed: int = 0,
        on_device: bool = False,
        poll_every: int = 8,
    ) -> List[Tuple[int, np.ndarray]]:
        """Batched synthesis; returns per-sample (start_length, token grid)
        as the JAX engine does, so ``processor.decode`` consumes it."""
        cfg, dev = self.config, self.device
        input_ids = np.asarray(input_ids, np.int64)
        B, T, C = input_ids.shape
        if C != cfg.channels:
            raise ValueError(f"input_ids must have {cfg.channels} channels, got {C}")
        if attention_mask is None:
            attention_mask = np.ones((B, T), bool)

        self.top_k_text = text_top_k
        self.top_k_audio = audio_top_k
        sampling = make_sampling(
            text_temperature=text_temperature, text_top_p=text_top_p,
            audio_temperature=audio_temperature, audio_top_p=audio_top_p,
            audio_repetition_penalty=audio_repetition_penalty,
            audio_rp_cross_batch=audio_rp_cross_batch, device=dev,
        )
        cache_len = _round_up(T + max_new_tokens + 1, self.cache_bucket)
        ids_dev = torch.as_tensor(input_ids, device=dev)
        mask_dev = torch.as_tensor(np.asarray(attention_mask, bool), device=dev)

        state = delay_prefill(
            self.params, cfg, ids_dev, mask_dev, max_new_tokens=max_new_tokens,
            cache_len=cache_len, rng=row_generators(seed, B, dev), sampling=sampling,
            top_k_text=self.top_k_text, top_k_audio=self.top_k_audio, dtype=self.dtype,
            kv_quant=self.kv_quant,
        )
        steps = 1
        while steps < max_new_tokens:
            attend = attend_bucket(T + steps + 1, self.cache_bucket, cache_len)
            state = delay_decode_step(
                self.params, cfg, state, sampling, top_k_text=self.top_k_text,
                top_k_audio=self.top_k_audio, attend_len=attend, uniform_slots=True,
            )
            steps += 1
            if steps % poll_every == 0 and bool(state.is_stopping.all()):
                break

        out = state.out[:, :steps].cpu().numpy().astype(np.int64)  # (B, steps, C)
        full = np.concatenate([input_ids, out], axis=1)
        # slice from the last <|im_start|> + 3 (reference generate :518-524)
        results: List[Tuple[int, np.ndarray]] = []
        for b in range(B):
            matches = np.nonzero(input_ids[b, :, 0] == cfg.im_start_token_id)[0]
            start_idx = int(matches[-1]) + 3 if len(matches) else 0
            results.append((T - start_idx, full[b, start_idx:]))
        return results
