"""High-level serving pipelines: the apps of the four Delay checkpoints.

Ports ``mosstts_tpu/serve/pipelines.py``: ``DelayBackend``,
``_generate_and_decode`` (routing through the backend's serving pool when it
has one), ``synthesize`` (MOSS-TTS: Direct, Clone, Continuation, reference
audio as a wave file or as codes), ``synthesize_dialogue`` (MOSS-TTSD, with
per-speaker cloning from wave files), ``generate_voice``
(MOSS-VoiceGenerator) and ``generate_sound_effect`` (MOSS-SoundEffect). The
processor, the tokenizer, the engine, the pool and the codec (its
``audio_tokenizer``) are the port's own. Each call returns (sample_rate,
waveform, status). ``demo_backend`` builds the whole stack from random
weights, the counterpart of the JAX package's ``serve.backend`` demo mode.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codec.model import MossAudioTokenizer
from ..core.config import CodecConfig, DelayConfig
from ..engine.delay_engine import DelayEngine
from ..processing.delay_processor import DelayProcessor
from ..processing.tokenizer import ByteFallbackTokenizer
from ..utils import audio as audio_io
from . import text_norm

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
    # optional shared continuous-batching pool (serve/pool.py): when set,
    # _generate_and_decode routes through it so concurrent callers share
    # batch slots instead of running solo generates
    pool: Optional[object] = None


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
    given) in float32, its batch-1 100-frame encode and decode programs
    captured (``MossAudioTokenizer.warmup``), and the byte-fallback
    tokenizer. ``engine_kw`` goes to
    ``DelayEngine`` (e.g. ``cache_bucket``). Without a codec the processor
    builds prompts but cannot decode audio, so ``synthesize`` needs one."""
    engine = DelayEngine.random_init(seed=seed, config=config, dtype=dtype, device=device,
                                     **engine_kw)
    codec = (None if codec_config is None else
             MossAudioTokenizer.random_init(seed=seed, config=codec_config, device=device))
    if codec is not None:  # capture the codec's serving programs ahead of traffic
        codec.warmup(decode_levels=config.n_vq)
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
    use_pool = (
        backend.pool is not None
        and not rp_exact_mode  # the cross-batch penalty ties rows together
        # top-k widths are static for the pool's server; requests needing
        # other widths run solo
        and backend.pool.supports(text_top_k=text_top_k, audio_top_k=top_k)
    )
    gen = backend.pool.generate if use_pool else backend.engine.generate
    out = gen(
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


# --------------------------------------------------------------------------
# MOSS-TTS: Direct / Clone / Continuation / Continuation+Clone
# --------------------------------------------------------------------------

def synthesize(
    backend: DelayBackend,
    text: str,
    *,
    mode: str = "Direct",  # Direct | Clone | Continuation | Continuation + Clone
    reference_audio: Optional[str | np.ndarray] = None,  # wave path or (T, n_vq) codes
    duration_tokens: Optional[int] = None,
    max_new_tokens: int = 2000,
    seed: int = 0,
    **sampling,
) -> Tuple[int, np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines.synthesize``. A reference given
    as a wave file path is encoded by the backend's codec."""
    t0 = time.monotonic()
    kw = {**DEFAULTS["moss_tts"], **sampling}
    proc = backend.processor

    ref_codes = None
    if reference_audio is not None:
        if isinstance(reference_audio, np.ndarray):
            ref_codes = reference_audio
        else:
            ref_codes = proc.encode_audios_from_path([str(reference_audio)])[0]

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


# --------------------------------------------------------------------------
# MOSS-TTSD: multi-speaker dialogue with per-speaker cloning
# --------------------------------------------------------------------------

def synthesize_dialogue(
    backend: DelayBackend,
    dialogue_text: str,
    *,
    speakers: Optional[Dict[int, Tuple[str, str]]] = None,  # id -> (wav path, prompt text)
    speaker_count: Optional[int] = None,
    do_text_normalize: bool = True,
    sample_rate_normalize: bool = False,
    max_new_tokens: int = 4000,
    seed: int = 0,
    **sampling,
) -> Tuple[int, np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines.synthesize_dialogue``: each
    speaker's wave is encoded by the backend's codec, and so is their
    concatenation, the assistant's prompt audio."""
    t0 = time.monotonic()
    kw = {**DEFAULTS["moss_ttsd"], **sampling}
    proc = backend.processor
    speakers = speakers or {}
    if speaker_count is None:
        tags = re.findall(r"\[S?(\d+)\]", dialogue_text or "")
        speaker_count = max([int(t) for t in tags] + [len(speakers), 1])

    normalized = (dialogue_text or "").strip()
    if do_text_normalize:
        normalized = text_norm.normalize_text(normalized)
    normalized = text_norm.validate_dialogue_text(normalized, speaker_count)

    if not speakers:
        conversations, mode = [[proc.build_user_message(text=normalized)]], "generation"
        mode_name = "Generation"
    else:
        cloned = sorted(speakers)
        prompt_text_map = {
            sid: text_norm.normalize_prompt_text(ptext, sid)
            for sid, (_, ptext) in sorted(speakers.items())
        }
        conversation_text = text_norm.build_prefixed_text(normalized, prompt_text_map, cloned)
        if do_text_normalize:
            conversation_text = text_norm.normalize_text(conversation_text)
        conversation_text = text_norm.validate_dialogue_text(conversation_text, speaker_count)

        wavs, srs = [], []
        for sid in cloned:
            wav, sr = audio_io.read_wav(speakers[sid][0])
            wavs.append(audio_io.to_mono(wav))
            srs.append(sr)
        if sample_rate_normalize:
            min_sr = min(srs)
            wavs = [audio_io.resample(w, sr, min_sr) for w, sr in zip(wavs, srs)]
            srs = [min_sr] * len(wavs)
        target = backend.sample_rate
        wavs = [audio_io.resample(w, sr, target) for w, sr in zip(wavs, srs)]

        encoded = proc.encode_audios_from_wav(wavs, sampling_rate=target)
        reference_codes: List[Optional[np.ndarray]] = [None] * speaker_count
        for sid, codes in zip(cloned, encoded):
            reference_codes[sid - 1] = codes
        concat_prompt = np.concatenate(wavs, axis=-1)
        prompt_codes = proc.encode_audios_from_wav([concat_prompt], sampling_rate=target)[0]

        conversations = [[
            proc.build_user_message(text=conversation_text, reference=reference_codes),
            proc.build_assistant_message(audio_codes_list=[prompt_codes]),
        ]]
        mode, mode_name = "continuation", "voice_clone_and_continuation"

    wav, _ = _generate_and_decode(
        backend, conversations, mode,
        max_new_tokens=max_new_tokens, seed=seed,
        temperature=kw["temperature"], top_p=kw["top_p"], top_k=kw["top_k"],
        repetition_penalty=kw["repetition_penalty"],
    )
    status = (
        f"Done | mode={mode_name} | speakers={speaker_count} | "
        f"elapsed={time.monotonic() - t0:.2f}s"
    )
    return backend.sample_rate, wav, status


# --------------------------------------------------------------------------
# MOSS-VoiceGenerator: instruction-driven voice design
# --------------------------------------------------------------------------

def generate_voice(
    backend: DelayBackend, text: str, instruction: str, *,
    max_new_tokens: int = 2000, seed: int = 0, **sampling,
) -> Tuple[int, np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines.generate_voice``."""
    kw = {**DEFAULTS["voice_generator"], **sampling}
    conv = [backend.processor.build_user_message(text=text, instruction=instruction or None)]
    t0 = time.monotonic()
    wav, _ = _generate_and_decode(
        backend, [conv], "generation",
        max_new_tokens=max_new_tokens, seed=seed,
        temperature=kw["temperature"], top_p=kw["top_p"], top_k=kw["top_k"],
        repetition_penalty=kw["repetition_penalty"],
    )
    return backend.sample_rate, wav, f"Done | elapsed={time.monotonic() - t0:.2f}s"


# --------------------------------------------------------------------------
# MOSS-SoundEffect: ambient-sound description + duration
# --------------------------------------------------------------------------

def generate_sound_effect(
    backend: DelayBackend, ambient_sound: str, duration_seconds: float, *,
    max_new_tokens: Optional[int] = None, seed: int = 0, **sampling,
) -> Tuple[int, np.ndarray, str]:
    """Ports ``mosstts_tpu.serve.pipelines.generate_sound_effect``."""
    kw = {**DEFAULTS["sound_effect"], **sampling}
    ambient_sound = (ambient_sound or "").strip()
    if not ambient_sound:
        raise ValueError("Please enter an ambient sound description.")
    expected_tokens = max(1, int(float(duration_seconds) * text_norm.TOKENS_PER_SECOND))
    conv = [backend.processor.build_user_message(
        ambient_sound=ambient_sound, tokens=expected_tokens
    )]
    t0 = time.monotonic()
    wav, _ = _generate_and_decode(
        backend, [conv], "generation",
        max_new_tokens=max_new_tokens or expected_tokens + backend.engine.config.n_vq + 64,
        seed=seed,
        temperature=kw["temperature"], top_p=kw["top_p"], top_k=kw["top_k"],
        repetition_penalty=kw["repetition_penalty"],
    )
    return backend.sample_rate, wav, (
        f"Done | tokens={expected_tokens} | elapsed={time.monotonic() - t0:.2f}s"
    )
