"""Streaming session layer for MossTTSRealtime: text buffering/segmentation,
prefill triggering, chunked waveform decoding with crossfade, BPE-stable
delta tokenization, and the LLM-delta -> audio bridge.

Ports ``mosstts_tpu/engine/streaming.py``: ``BufferedAudioTracker``,
``stream_with_prebuffer``, ``AudioTokenCache``, ``RealtimeStreamingSession``,
``AudioStreamDecoder``, ``TextDeltaTokenizer``, ``sanitize_audio_tokens``
and ``RealtimeTextStreamBridge``. Host-side numpy logic, copied: the device
work happens in the port's ``RealtimeEngine`` (CUDA-graph frames on the
card) and in its codec (``codec/model.py``: ``decode`` and ``streaming()``,
which carry the causal decoder's state from one chunk to the next). The
cross-fade of two windows computes as the JAX package's C library does
(``utils/native.py``).

Contract parity: reference streaming_mossttsrealtime.py:422-990.
"""
from __future__ import annotations

import contextlib
import os
import re
import time
from collections import OrderedDict
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import audio as audio_io
from ..utils.native import crossfade
from .realtime_engine import RealtimeEngine


class BufferedAudioTracker:
    """How far ahead of realtime playback the emitted audio is.

    Serving parity with the reference app's buffer tracking
    (moss_tts_realtime/app.py:182-200,257-261): the clock starts at the
    first emitted chunk; ``buffered_seconds`` is emitted-audio-time minus
    elapsed wall time (a client playing in realtime has this much runway).
    """

    def __init__(self, sample_rate: int):
        self.sample_rate = int(sample_rate)
        self._t_first: Optional[float] = None
        self._samples = 0

    def add(self, chunk: np.ndarray) -> None:
        n = int(np.asarray(chunk).size)
        if n == 0:
            return
        if self._t_first is None:
            self._t_first = time.monotonic()
        self._samples += n

    def buffered_seconds(self) -> float:
        if self._t_first is None:
            return 0.0
        runway = self._samples / self.sample_rate - (time.monotonic() - self._t_first)
        return max(0.0, runway)

    def wait_until_below(self, threshold_seconds: float, poll: float = 0.01) -> None:
        """Backpressure: stall generation while the client-side buffer holds
        more than ``threshold_seconds`` of unplayed audio."""
        if threshold_seconds <= 0:
            return
        while self.buffered_seconds() > threshold_seconds:
            time.sleep(poll)


def stream_with_prebuffer(
    chunks: Iterable[np.ndarray],
    sample_rate: int,
    *,
    prebuffer_seconds: float = 0.0,
    buffer_threshold_seconds: float = 0.0,
) -> Iterator[np.ndarray]:
    """Wrap a chunk stream with an initial prebuffer and playback-rate
    backpressure (reference app.py:481-512 prebuffer, :257-261 throttle).

    ``prebuffer_seconds`` holds back the stream start until that much audio
    is banked, so playback never underruns on the first chunks;
    ``buffer_threshold_seconds`` then throttles generation whenever the
    emitted-but-unplayed runway exceeds the threshold, bounding server-side
    burst memory and keeping cancellation responsive."""
    tracker = BufferedAudioTracker(sample_rate)
    held: List[np.ndarray] = []
    held_samples = 0
    prebuffering = prebuffer_seconds > 0
    for chunk in chunks:
        chunk = np.asarray(chunk)
        if prebuffering:
            held.append(chunk)
            held_samples += chunk.size
            if held_samples / sample_rate >= prebuffer_seconds:
                prebuffering = False
                for c in held:
                    tracker.add(c)
                    yield c
                held, held_samples = [], 0
            continue
        tracker.wait_until_below(buffer_threshold_seconds)
        tracker.add(chunk)
        yield chunk
    for c in held:  # stream ended while still prebuffering
        tracker.add(c)
        yield c


class AudioTokenCache:
    """LRU of codec encodes for on-disk audio (voice prompts, user wavs),
    keyed by (resolved path, mtime_ns, encode-kwargs signature) so edits
    invalidate (reference app.py:364-390)."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = int(max_entries)
        self._store: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _key(self, path: str, encode_kwargs: Optional[dict]) -> Tuple:
        resolved = os.path.realpath(os.path.expanduser(path))
        sig = tuple(sorted((encode_kwargs or {}).items()))
        return (resolved, os.stat(resolved).st_mtime_ns, sig)

    def get_or_encode(self, path: str, encode_fn, encode_kwargs: Optional[dict] = None
                      ) -> np.ndarray:
        key = self._key(path, encode_kwargs)
        tokens = self._store.get(key)
        if tokens is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return tokens
        self.misses += 1
        tokens = np.asarray(encode_fn(path))
        self._store[key] = tokens
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)
        return tokens


class RealtimeStreamingSession:
    """Manage text-to-audio streaming for a single conversation
    (reference :422-675)."""

    _split_pattern = re.compile(
        r"[。！？!?\.…]\s*"
        r"|[,，;；:：—–\-]\s*"
        r"|\)\s*|\]\s*"
        r"|\n"
    )

    def __init__(
        self,
        inferencer: RealtimeEngine,
        processor,
        codec=None,
        codec_sample_rate: int = 24000,
        codec_encode_kwargs: Optional[dict] = None,
        prefill_text_len: int = 12,
        text_buffer_size: int = 32,
        min_text_chunk_chars: int = 8,
        temperature: float = 0.8,
        top_p: float = 0.6,
        top_k: int = 30,
        do_sample: bool = True,
        repetition_penalty: Optional[float] = 1.1,
        token_cache: Optional["AudioTokenCache"] = None,
    ):
        self.inferencer = inferencer
        self.token_cache = token_cache
        self.processor = processor
        self.tokenizer = processor.tokenizer
        self.codec = codec
        self.codec_sample_rate = codec_sample_rate
        self.codec_encode_kwargs = codec_encode_kwargs or {}
        self.prefill_text_len = prefill_text_len
        self.text_buffer_size = text_buffer_size
        self.min_text_chunk_chars = min_text_chunk_chars
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.do_sample = do_sample
        self.repetition_penalty = repetition_penalty

        self._voice_prompt_tokens: Optional[np.ndarray] = None
        self._turn_input_ids: Optional[np.ndarray] = None
        self._turn_idx = 0
        self._text_cache = ""
        self._pending_tokens: List[int] = []
        self._prefilled = False
        self._text_ended = False

    # --------------------------- voice prompt -----------------------------
    def set_voice_prompt_tokens(self, audio_tokens: np.ndarray):
        self._voice_prompt_tokens = audio_tokens

    def set_voice_prompt(self, audio, sample_rate: Optional[int] = None):
        """Accept RVQ tokens, a waveform, or a wav path (reference
        :479-528)."""
        if isinstance(audio, np.ndarray) and audio.ndim == 2:
            if self.processor.channels in audio.shape:
                self._voice_prompt_tokens = audio
                return
        if self.codec is None:
            raise ValueError("codec is required to encode waveform prompts.")
        if isinstance(audio, (str, bytes)) and self.token_cache is not None:
            self._voice_prompt_tokens = self.token_cache.get_or_encode(
                audio if isinstance(audio, str) else audio.decode(),
                self._encode_wav_path, self.codec_encode_kwargs,
            )
            return
        waveform = audio
        if isinstance(audio, (str, bytes)):
            wav, sr = audio_io.read_wav(audio)
            waveform = audio_io.to_mono(wav)
            sample_rate = sr
        self._voice_prompt_tokens = self._encode_waveform(waveform, sample_rate)

    def _encode_wav_path(self, path: str) -> np.ndarray:
        wav, sr = audio_io.read_wav(path)
        return self._encode_waveform(audio_io.to_mono(wav), sr)

    def _encode_waveform(self, waveform, sample_rate: Optional[int]) -> np.ndarray:
        waveform = np.asarray(waveform, np.float32)
        if sample_rate is not None and sample_rate != self.codec_sample_rate:
            waveform = audio_io.resample(waveform, sample_rate, self.codec_sample_rate)
        enc = self.codec.batch_encode([waveform], **self.codec_encode_kwargs)
        codes = np.asarray(enc.audio_codes)  # (NQ, 1, T)
        return codes[:, 0, : int(enc.audio_codes_lengths[0])]

    def clear_voice_prompt(self):
        self._voice_prompt_tokens = None

    # ----------------------------- lifecycle ------------------------------
    def reset_turn(
        self,
        user_text: Optional[str] = None,
        user_audio_tokens: Optional[np.ndarray] = None,
        input_ids: Optional[np.ndarray] = None,
        include_system_prompt: Optional[bool] = None,
        reset_cache: bool = False,
    ):
        if include_system_prompt is None:
            include_system_prompt = self._turn_idx == 0
        if input_ids is None:
            if user_text is None or user_audio_tokens is None:
                raise ValueError(
                    "user_text and user_audio_tokens are required when input_ids is not provided."
                )
            user_prompt = self.processor.make_user_prompt(user_text, user_audio_tokens)
            if include_system_prompt:
                system_prompt = self.processor.make_ensemble(self._voice_prompt_tokens)
                input_ids = np.concatenate([system_prompt, user_prompt], axis=0)
            else:
                input_ids = user_prompt
        self._turn_input_ids = input_ids
        self._turn_idx += 1
        self._text_cache = ""
        self._pending_tokens = []
        self._prefilled = False
        self._text_ended = False
        self.inferencer.reset_generation_state(keep_cache=not reset_cache)

    # ------------------------------- input --------------------------------
    def push_text_tokens(self, tokens: Iterable[int]) -> List[np.ndarray]:
        self._pending_tokens.extend(int(t) for t in tokens)
        return self._drain_pending_tokens()

    def push_text(self, text_fragment: str) -> List[np.ndarray]:
        self._text_cache += text_fragment
        for segment in self._extract_text_segments(force=False):
            self._pending_tokens.extend(self._tokenize(segment))
        return self._drain_pending_tokens()

    def end_text(self) -> List[np.ndarray]:
        self._text_ended = True
        if self._text_cache:
            self._pending_tokens.extend(self._tokenize(self._text_cache))
            self._text_cache = ""
        return self._drain_pending_tokens()

    def drain(self, max_steps: Optional[int] = None) -> List[np.ndarray]:
        if not self._prefilled:
            return []
        return self.inferencer.finish(
            max_steps=max_steps,
            temperature=self.temperature, top_p=self.top_p, top_k=self.top_k,
            do_sample=self.do_sample, repetition_penalty=self.repetition_penalty,
        )

    # ------------------------------ internals ------------------------------
    def _tokenize(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def _extract_text_segments(self, force: bool) -> List[str]:
        segments: List[str] = []
        if force:
            if self._text_cache:
                segments.append(self._text_cache)
                self._text_cache = ""
            return segments
        while self._text_cache:
            cut_idx = None
            if len(self._text_cache) >= self.min_text_chunk_chars:
                for match in self._split_pattern.finditer(self._text_cache):
                    if match.end() >= self.min_text_chunk_chars:
                        cut_idx = match.end()
                        break
            if cut_idx is None and len(self._text_cache) >= self.text_buffer_size:
                ws = self._text_cache.rfind(" ")
                if ws != -1:
                    cut_idx = ws + 1
            if cut_idx is None:
                break
            segments.append(self._text_cache[:cut_idx])
            self._text_cache = self._text_cache[cut_idx:]
        return segments

    def _prefill_if_needed(self) -> List[np.ndarray]:
        if self._prefilled:
            return []
        if not self._pending_tokens and not self._text_ended:
            return []
        if len(self._pending_tokens) < self.prefill_text_len and not self._text_ended:
            return []
        if self._turn_input_ids is None:
            raise ValueError("reset_turn must be called before streaming text.")
        prefill_len = (
            len(self._pending_tokens) if self._text_ended
            else min(len(self._pending_tokens), self.prefill_text_len)
        )
        if prefill_len == 0:
            return []
        prefix = [self._pending_tokens.pop(0) for _ in range(prefill_len)]
        frame = self.inferencer.prefill(
            [self._turn_input_ids], [prefix],
            temperature=self.temperature, top_p=self.top_p, top_k=self.top_k,
            do_sample=self.do_sample, repetition_penalty=None,
        )
        self._prefilled = True
        return [frame]

    # frames are fetched from the device in blocks of this many steps: steps
    # enqueue without waiting, so one host transfer serves the whole block,
    # small enough to keep the first chunk early
    fetch_block = 4

    def _drain_pending_tokens(self) -> List[np.ndarray]:
        outputs = self._prefill_if_needed()
        if not self._prefilled:
            return outputs
        B = self.inferencer._batch or 1
        while self._pending_tokens and not self.inferencer.is_finished:
            block = self._pending_tokens[: self.fetch_block]
            del self._pending_tokens[: self.fetch_block]
            outputs.extend(
                self.inferencer.step_block(
                    [[t] * B for t in block],
                    temperature=self.temperature, top_p=self.top_p,
                    top_k=self.top_k, do_sample=self.do_sample,
                    repetition_penalty=self.repetition_penalty,
                )
            )
        return outputs


def _linear_blend(prev_tail: np.ndarray, wav: np.ndarray, n: int) -> np.ndarray:
    """Join two windows with an ``n``-sample linear equal-gain ramp:
    ``[prev_tail minus its last n | ramp(prev_tail_end, wav_start) |
    rest of wav]`` (``utils.native.crossfade``: the JAX package's C
    library's samples)."""
    return crossfade(prev_tail, wav, n)


class AudioStreamDecoder:
    """Token frames -> seamless wav chunks: accumulate frames, decode every
    full ``chunk_frames`` window through the (causal-streaming) codec, and
    stitch consecutive windows with a linear crossfade whose width is
    ``overlap_frames`` worth of samples, scaled down proportionally for a
    short final window.

    Output contract (the JAX package's, pinned sample for sample by
    tests/test_torch_realtime_stream.py against its golden; parity target
    reference streaming_mossttsrealtime.py:679-804): chunk i>0 opens
    with its head blended against the retained tail of chunk i-1; when the
    final window's proportional overlap is narrower than the retained tail,
    the unblended part of that tail is re-emitted ahead of the seam.

    A window is decoded in the codec's 4-frame chunks (0.32 s), the last
    one zero-padded: on the card each is one replay of the codec's decode
    graph at (batch 1, 4 frames, levels), a short flush too, the stream's
    state copied into the graph's buffers and back per call
    (``engine/step_graph.CodecChunks``)."""

    def __init__(self, codec, chunk_frames: int = 40, overlap_frames: int = 4,
                 decode_kwargs: Optional[dict] = None,
                 first_chunk_frames: Optional[int] = None):
        self.codec = codec
        self.chunk_frames = chunk_frames
        self.overlap_frames = overlap_frames
        self.decode_kwargs = decode_kwargs or {}
        # TTFA lever: emit the FIRST window after only this many frames
        # (e.g. 1 = first audible samples one frame after prefill), then
        # settle into chunk_frames windows. None keeps uniform windows.
        self.first_chunk_frames = first_chunk_frames
        self._chunks_out = 0
        self._pending: Optional[np.ndarray] = None  # (T, C) undecoded frames
        self._tail: Optional[np.ndarray] = None  # retained end of last chunk

    def push_tokens(self, audio_tokens: np.ndarray):
        audio_tokens = np.asarray(audio_tokens)
        if audio_tokens.ndim != 2:
            raise ValueError(f"Expected [T, C] audio tokens, got {audio_tokens.shape}")
        self._pending = (audio_tokens if self._pending is None
                         else np.concatenate([self._pending, audio_tokens]))

    @property
    def _pending_frames(self) -> int:
        return 0 if self._pending is None else self._pending.shape[0]

    def _take(self, n: int) -> np.ndarray:
        head, rest = self._pending[:n], self._pending[n:]
        self._pending = rest if rest.shape[0] else None
        return head

    def _window(self) -> int:
        if self._chunks_out == 0 and self.first_chunk_frames:
            return min(self.first_chunk_frames, self.chunk_frames)
        return self.chunk_frames

    def audio_chunks(self) -> Iterable[np.ndarray]:
        while self._pending_frames >= self._window():
            wav = self._decode(self._take(self._window()),
                               chunk_duration=0.32)
            self._chunks_out += 1
            yield self._emit(wav, final=False)

    def flush(self) -> Optional[np.ndarray]:
        if self._pending_frames == 0:
            return None
        wav = self._decode(self._take(self._pending_frames))
        return self._emit(wav, final=True)

    def _decode(self, tokens: np.ndarray, chunk_duration: float = 0.32) -> np.ndarray:
        kw = dict(self.decode_kwargs)
        if "chunk_duration" in kw:
            override = kw.pop("chunk_duration")
            cd = None if override is None or float(override) <= 0 else float(override)
        else:
            cd = chunk_duration
        decoded = self.codec.decode(tokens.T, chunk_duration=cd, **kw)
        wav = decoded["audio"][0] if isinstance(decoded, dict) else decoded
        wav = np.asarray(wav)
        if wav.ndim > 1:
            wav = wav.reshape(-1)
        return wav

    def _emit(self, wav: np.ndarray, *, final: bool) -> np.ndarray:
        if self.overlap_frames <= 0:
            return wav
        # seam width: overlap_frames' share of THIS chunk's samples (a short
        # flush narrows the seam), capped by what the last chunk retained
        width = 0
        if self.chunk_frames > 0:
            width = int(wav.size * (self.overlap_frames / self.chunk_frames))
        if self._tail is None:
            self._tail = None if final else wav[-width:].copy()
            return wav
        width = min(width, self._tail.size)
        if width == 0:
            return wav
        out = _linear_blend(self._tail, wav, width)
        self._tail = None if final else wav[-width:].copy()
        return out


class TextDeltaTokenizer:
    """LLM delta text -> stable incremental token ids. Tokenizations are
    not prefix-stable, so the accumulated text is re-encoded on every delta
    and only ids a safety margin behind the end are released; flush drops
    the margin. Emission is monotonic — once released, an id is never
    retracted (contract of reference :807-851)."""

    def __init__(self, tokenizer, *, hold_back: int = 3):
        self.tokenizer = tokenizer
        self.hold_back = max(0, int(hold_back))
        self._text = ""
        self._all_ids: List[int] = []
        self._emitted = 0

    @property
    def text(self) -> str:
        return self._text

    @property
    def token_ids(self) -> List[int]:
        return list(self._all_ids)

    def _release(self, margin: int) -> List[int]:
        """Re-encode the accumulated text and release every id up to
        ``len - margin`` that hasn't been released yet."""
        self._all_ids = self.tokenizer.encode(self._text, add_special_tokens=False)
        upto = max(self._emitted, len(self._all_ids) - margin)
        out = self._all_ids[self._emitted:upto]
        self._emitted = upto
        return out

    def push_delta(self, delta: str) -> List[int]:
        if not delta:
            return []
        self._text += str(delta)
        return self._release(self.hold_back)

    def flush(self) -> List[int]:
        return self._release(0)


def sanitize_audio_tokens(tokens: np.ndarray, *, codebook_size: int,
                          audio_eos_token: int):
    """Trim rows at/after EOS or out-of-range codes; returns (tokens, stop)
    (reference _sanitize_audio_tokens :854-878)."""
    tokens = np.asarray(tokens)
    if tokens.ndim == 1:
        tokens = tokens[None]
    if tokens.size == 0:
        return tokens, False
    eos_rows = np.nonzero(tokens[:, 0] == audio_eos_token)[0]
    invalid = np.nonzero(((tokens < 0) | (tokens >= codebook_size)).any(axis=1))[0]
    stop_idx = None
    if eos_rows.size:
        stop_idx = int(eos_rows[0])
    if invalid.size:
        stop_idx = int(invalid[0]) if stop_idx is None else min(stop_idx, int(invalid[0]))
    if stop_idx is not None:
        return tokens[:stop_idx], True
    return tokens, False


def _maybe_codec_streaming(codec, *, batch_size: int):
    if codec is None or not hasattr(codec, "streaming"):
        return contextlib.nullcontext()
    return codec.streaming(batch_size=batch_size)


class RealtimeTextStreamBridge:
    """LLM streaming text deltas -> TTS wav chunks (reference :888-990)."""

    def __init__(self, session: RealtimeStreamingSession, decoder: AudioStreamDecoder,
                 *, codebook_size: Optional[int] = None,
                 audio_eos_token: Optional[int] = None, batch_size: int = 1):
        self.session = session
        self.decoder = decoder
        self.batch_size = int(batch_size)
        if codebook_size is None:
            codebook_size = int(getattr(getattr(session, "codec", None), "codebook_size", 1024))
        if audio_eos_token is None:
            audio_eos_token = int(session.inferencer.config.audio_eos_token)
        self.codebook_size = int(codebook_size)
        self.audio_eos_token = int(audio_eos_token)

    def push_text_delta(self, delta: str) -> Iterator[np.ndarray]:
        yield from self._decode_audio_frames(self.session.push_text(delta))

    def push_text_tokens(self, token_ids: Sequence[int]) -> Iterator[np.ndarray]:
        if not token_ids:
            return
        yield from self._decode_audio_frames(self.session.push_text_tokens(token_ids))

    def finish(self, *, drain_step: int = 1,
               max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
        """End the text, then drain until EOS, or, with ``max_frames``,
        until the turn holds that many frames (the JAX bridge drains until
        EOS only, which a model that never emits one never reaches)."""
        yield from self._decode_audio_frames(self.session.end_text())
        while True:
            step = drain_step
            if max_frames is not None:
                step = min(step, max_frames - len(self.session.inferencer.generated_tokens))
                if step <= 0:
                    break
            more = self.session.drain(max_steps=step)
            if not more:
                break
            yield from self._decode_audio_frames(more)
            if self.session.inferencer.is_finished:
                break
        final = self.decoder.flush()
        if final is not None and final.size > 0:
            yield final

    def stream_from_text_deltas(self, deltas: Iterable[str], *, drain_step: int = 1,
                                max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
        with _maybe_codec_streaming(getattr(self.session, "codec", None),
                                    batch_size=self.batch_size):
            for delta in deltas:
                yield from self.push_text_delta(delta)
            yield from self.finish(drain_step=drain_step, max_frames=max_frames)

    def _decode_audio_frames(self, frames: List[np.ndarray]) -> Iterator[np.ndarray]:
        for frame in frames:
            tokens = np.asarray(frame)
            if tokens.ndim == 3:
                tokens = tokens[0]
            if tokens.ndim != 2:
                raise ValueError(f"Expected [B, C] audio tokens, got {tokens.shape}")
            if tokens.shape[0] != 1:
                raise ValueError("This bridge supports batch_size=1 decoding.")
            tokens, stop = sanitize_audio_tokens(
                tokens, codebook_size=self.codebook_size,
                audio_eos_token=self.audio_eos_token,
            )
            if tokens.size == 0:
                if stop:
                    break
                continue
            self.decoder.push_tokens(tokens)
            for wav in self.decoder.audio_chunks():
                if wav.size:
                    yield wav
            if stop:
                break
