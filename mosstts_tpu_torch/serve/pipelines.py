"""The MOSS-TTS serving pipeline on the port.

Ports ``mosstts_tpu/serve/pipelines.py``: ``DelayBackend``,
``_generate_and_decode`` and ``synthesize``. The processor, the tokenizer,
the engine and the codec (its ``audio_tokenizer``) are the port's own. Each
call returns (sample_rate, waveform, status). ``demo_backend`` builds the
whole stack from random weights, the counterpart of the JAX package's
``serve.backend`` demo mode. The shared batching pool and reference audio
given as a file path (which needs the codec's encoder) are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..codec.model import MossAudioTokenizer
from ..core.config import CodecConfig, DelayConfig
from ..engine.delay_engine import DelayEngine
from ..processing.delay_processor import DelayProcessor
from ..processing.tokenizer import ByteFallbackTokenizer

# Recommended sampling defaults per app (the JAX package's pipelines.DEFAULTS)
DEFAULTS = {
    "moss_tts": dict(temperature=1.7, top_p=0.8, top_k=25, repetition_penalty=1.0),
    "moss_ttsd": dict(temperature=1.1, top_p=0.9, top_k=50, repetition_penalty=1.1),
    "voice_generator": dict(temperature=1.5, top_p=0.6, top_k=50, repetition_penalty=1.1),
    "sound_effect": dict(temperature=1.5, top_p=0.6, top_k=50, repetition_penalty=1.2),
}


@dataclass
class DelayBackend:
    engine: DelayEngine
    processor: DelayProcessor
    sample_rate: int = 24000
    # demo (random-init) backends kickstart generation-mode prompts with an
    # <audio_start> row so every flow produces audio without trained weights
    demo: bool = False


def demo_backend(
    config: DelayConfig,
    codec_config: Optional[CodecConfig] = None,
    *,
    seed: int = 0,
    dtype=torch.bfloat16,
    device="cuda",
    **engine_kw,
) -> DelayBackend:
    """A demo ``DelayBackend`` with random weights drawn on ``device`` from
    ``seed``: the engine in ``dtype``, the codec (when ``codec_config`` is
    given) in float32, and the byte-fallback tokenizer. ``engine_kw`` goes to
    ``DelayEngine`` (e.g. ``cache_bucket``). Without a codec the processor
    builds prompts but cannot decode audio, so ``synthesize`` needs one."""
    engine = DelayEngine.random_init(seed=seed, config=config, dtype=dtype, device=device,
                                     **engine_kw)
    codec = (None if codec_config is None else
             MossAudioTokenizer.random_init(seed=seed, config=codec_config, device=device))
    processor = DelayProcessor(ByteFallbackTokenizer(), audio_tokenizer=codec, config=config)
    return DelayBackend(engine=engine, processor=processor, demo=True)


def _generate_and_decode(
    backend: DelayBackend, conversations, mode: str, *,
    max_new_tokens: int, temperature: float, top_p: float, top_k: int,
    repetition_penalty: float, text_temperature: float = 1.5,
    text_top_p: float = 1.0, text_top_k: int = 50, seed: int = 0,
    rp_exact_mode: bool = False,
) -> Tuple[np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines._generate_and_decode``."""
    batch = backend.processor(conversations, mode=mode)
    if backend.demo and mode == "generation":
        c = backend.engine.config
        ids, mask = batch["input_ids"], batch["attention_mask"]
        B, T, C = ids.shape
        row = np.full((B, 1, C), c.audio_pad_code, dtype=ids.dtype)
        row[..., 0] = c.audio_start_token_id
        batch = {
            "input_ids": np.concatenate([ids, row], axis=1),
            "attention_mask": np.concatenate([mask, np.ones((B, 1), bool)], axis=1),
        }
    out = backend.engine.generate(
        batch["input_ids"], batch["attention_mask"],
        max_new_tokens=max_new_tokens,
        text_temperature=text_temperature, text_top_p=text_top_p, text_top_k=text_top_k,
        audio_temperature=temperature, audio_top_p=top_p, audio_top_k=top_k,
        audio_repetition_penalty=repetition_penalty,
        audio_rp_cross_batch=rp_exact_mode, seed=seed,
    )
    messages = backend.processor.decode(out)
    if not messages or messages[0] is None:
        raise RuntimeError("The model did not return a decodable audio result.")
    wavs = list(messages[0].audio_codes_list)
    if not wavs:
        raise RuntimeError("No audio segments were generated.")
    return np.concatenate([np.asarray(w).reshape(-1) for w in wavs]), messages[0].content


def synthesize(
    backend: DelayBackend,
    text: str,
    *,
    mode: str = "Direct",  # Direct | Clone | Continuation | Continuation + Clone
    reference_audio: Optional[np.ndarray] = None,  # (T, n_vq) audio codes
    duration_tokens: Optional[int] = None,
    max_new_tokens: int = 2000,
    seed: int = 0,
    **sampling,
) -> Tuple[int, np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines.synthesize``. A reference is
    given as audio codes; a wave file path needs the codec's encoder, which
    is not ported yet."""
    t0 = time.monotonic()
    kw = {**DEFAULTS["moss_tts"], **sampling}
    proc = backend.processor
    if reference_audio is not None and not isinstance(reference_audio, np.ndarray):
        raise NotImplementedError("reference audio from a file needs codec encode, "
                                  "which is not ported yet; pass audio codes")
    ref_codes = reference_audio

    if mode == "Direct":
        conversations = [[proc.build_user_message(text=text, tokens=duration_tokens)]]
        gen_mode = "generation"
    elif mode in ("Clone", "Continuation", "Continuation + Clone", "Continuation+Clone"):
        if ref_codes is None:
            raise ValueError(f"{mode} mode requires reference audio.")
        if mode == "Clone":
            conversations = [[proc.build_user_message(text=text, reference=[ref_codes],
                                                      tokens=duration_tokens)]]
            gen_mode = "generation"
        else:
            reference = [ref_codes] if "Clone" in mode else None
            conversations = [[
                proc.build_user_message(text=text, reference=reference),
                proc.build_assistant_message(audio_codes_list=[ref_codes]),
            ]]
            gen_mode = "continuation"
    else:
        raise ValueError(f"Unknown mode: {mode}")

    wav, _ = _generate_and_decode(
        backend, conversations, gen_mode,
        max_new_tokens=max_new_tokens, seed=seed,
        temperature=kw["temperature"], top_p=kw["top_p"], top_k=kw["top_k"],
        repetition_penalty=kw["repetition_penalty"],
    )
    status = (
        f"Done | mode={mode} | elapsed={time.monotonic() - t0:.2f}s | "
        f"audio_temperature={kw['temperature']:.2f}, audio_top_p={kw['top_p']:.2f}, "
        f"audio_top_k={kw['top_k']}, audio_repetition_penalty={kw['repetition_penalty']:.2f}"
    )
    return backend.sample_rate, wav, status
