"""HTTP serving front end (stdlib, dependency-free).

Ports ``mosstts_tpu/serve/http_server.py``:

    GET  /healthz                     -> {"ok": true}
    POST /tts           {"text", "mode", "reference_b64?", ...} -> WAV bytes
    POST /ttsd          {"dialogue", ...}                       -> WAV bytes
    POST /sound_effect  {"ambient", "seconds", ...}             -> WAV bytes
    POST /voice_gen     {"text", "instruction", ...}            -> WAV bytes
    POST /stream        {"text", "user_text?", ...} -> chunked PCM16 (Realtime)
    GET  /metrics                     -> last synthesis metrics JSON
    GET  /player (or /) -> the in-browser streaming player page

An unknown route answers 404. ``--pool-slots N`` shares one
continuous-batching pool of N slots (``serve/pool.py``) across concurrent
Delay requests; 0 runs a solo generate per request, one at a time.
``--rt-pool-slots N`` shares one Realtime pool of N slots across
concurrent ``/stream`` sessions; 0 runs a solo streaming session per
request. The solo sessions share one engine, so they run one at a time
(the JAX server lets them run at once over one engine state), and a solo
stream ends at ``max_frames`` (default 1024) as a pooled one does (the JAX
solo path drains until EOS only). A stream
answers with ``X-Sample-Rate`` (and ``X-Pooled: 1`` through the pool) and
chunked PCM16 whose chunk extensions carry the live TTFA and RTF
(``<size>;ttfa=..ms;rtf=..``).

Run on the card (random demo weights):
    python3 -m mosstts_tpu_torch.serve.http_server --port 7860 --pool-slots 16 \
        --rt-pool-slots 4
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..engine.metrics import SynthesisMetrics
from ..utils.native import float_to_pcm16

_STATE = {"last_metrics": None, "lock": threading.Lock(), "args": None, "pool": None,
          "token_cache": None, "rt_pool": None,
          # a DelayBackend, and a Realtime (engine, processor, codec), that a
          # program embedding the server built itself (chip_smoke.py's 8B and
          # 1.7B backends), served in place of the demo ones
          "backend": None, "rt_backend": None,
          # building a pool holds build_lock, not the global lock, so that
          # /metrics and _record() on other threads never wait for it
          "build_lock": threading.Lock(),
          # the solo /stream sessions' one engine: one session at a time
          "rt_lock": threading.Lock()}


def _token_cache():
    """The process-wide voice-prompt encode LRU (reference app.py:364-390)."""
    with _STATE["lock"]:
        if _STATE["token_cache"] is None:
            from ..engine.streaming import AudioTokenCache

            _STATE["token_cache"] = AudioTokenCache(max_entries=32)
        return _STATE["token_cache"]


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(float_to_pcm16(np.nan_to_num(wav)).tobytes())
    return buf.getvalue()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _json_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _send(self, code: int, body: bytes, ctype: str, extra=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code=200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    # -------------------------------------------------------------- GET
    def do_GET(self):
        if self.path == "/healthz":
            return self._send_json({"ok": True})
        if self.path == "/metrics":
            with _STATE["lock"]:
                m = _STATE["last_metrics"]
            return self._send_json(m or {})
        if self.path in ("/", "/player"):
            from .web_player import PLAYER_HTML

            return self._send(200, PLAYER_HTML.encode(), "text/html; charset=utf-8")
        self._send_json({"error": "not found"}, 404)

    # -------------------------------------------------------------- POST
    def do_POST(self):
        try:
            body = self._json_body()
            if self.path == "/tts":
                return self._tts(body)
            if self.path == "/ttsd":
                return self._ttsd(body)
            if self.path == "/sound_effect":
                return self._sfx(body)
            if self.path == "/voice_gen":
                return self._voice(body)
            if self.path == "/stream":
                return self._stream(body)
            self._send_json({"error": "not found"}, 404)
        except Exception as e:  # serving surface: report, don't crash
            self._send_json({"error": f"{type(e).__name__}: {e}"}, 400)

    def _sampling(self, body):
        return {
            k: body[k]
            for k in ("temperature", "top_p", "top_k", "repetition_penalty")
            if k in body
        }

    def _record(self, metrics: SynthesisMetrics):
        with _STATE["lock"]:
            _STATE["last_metrics"] = metrics.report()

    def _backend(self):
        from .backend import load_delay_backend

        a = _STATE["args"]
        backend = _STATE["backend"] or load_delay_backend(
            a.model_path, a.codec_path, device=getattr(a, "device", "cuda"))
        if getattr(a, "pool_slots", 0):
            with _STATE["lock"]:
                pool = _STATE.get("pool")
            if pool is None:
                with _STATE["build_lock"]:
                    with _STATE["lock"]:
                        pool = _STATE.get("pool")
                    if pool is None:
                        from .pool import DelayServingPool

                        # sized for the /tts default max_new_tokens=2000:
                        # the server clamps each request to out_capacity
                        # and the cache must hold prompt + generation +
                        # poll slack
                        pool = DelayServingPool(
                            backend.engine.params, backend.engine.config,
                            slots=a.pool_slots, dtype=backend.engine.dtype,
                            kv_quant=backend.engine.kv_quant,
                            out_capacity=2048, cache_len=4096,
                        )
                        with _STATE["lock"]:
                            _STATE["pool"] = pool
            backend.pool = pool
        return backend

    def _tts(self, body):
        from .pipelines import synthesize

        backend = self._backend()
        ref = None
        if body.get("reference_b64"):
            with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
                f.write(base64.b64decode(body["reference_b64"]))
                ref = f.name
        try:
            m = SynthesisMetrics(sample_rate=backend.sample_rate)
            sr, wav, status = synthesize(
                backend, body["text"], mode=body.get("mode", "Direct"),
                reference_audio=ref,
                duration_tokens=body.get("duration_tokens"),
                max_new_tokens=int(body.get("max_new_tokens", 2000)),
                seed=int(body.get("seed", 0)), **self._sampling(body),
            )
        finally:
            if ref is not None:
                os.unlink(ref)
        m.add_audio(wav.size)
        self._record(m)
        self._send(200, _wav_bytes(wav, sr), "audio/wav", {"X-Status": status})

    def _ttsd(self, body):
        from .pipelines import synthesize_dialogue

        backend = self._backend()
        m = SynthesisMetrics(sample_rate=backend.sample_rate)
        sr, wav, status = synthesize_dialogue(
            backend, body["dialogue"],
            max_new_tokens=int(body.get("max_new_tokens", 4000)),
            seed=int(body.get("seed", 0)), **self._sampling(body),
        )
        m.add_audio(wav.size)
        self._record(m)
        self._send(200, _wav_bytes(wav, sr), "audio/wav", {"X-Status": status})

    def _sfx(self, body):
        from .pipelines import generate_sound_effect

        backend = self._backend()
        sr, wav, status = generate_sound_effect(
            backend, body["ambient"], float(body.get("seconds", 4.0)),
            seed=int(body.get("seed", 0)), **self._sampling(body),
        )
        self._send(200, _wav_bytes(wav, sr), "audio/wav", {"X-Status": status})

    def _voice(self, body):
        from .pipelines import generate_voice

        backend = self._backend()
        sr, wav, status = generate_voice(
            backend, body["text"], body.get("instruction", ""),
            max_new_tokens=int(body.get("max_new_tokens", 2000)),
            seed=int(body.get("seed", 0)), **self._sampling(body),
        )
        self._send(200, _wav_bytes(wav, sr), "audio/wav", {"X-Status": status})

    def _rt_pool(self, engine):
        """The shared Realtime pool (``--rt-pool-slots``), built at the
        first pooled stream: concurrent /stream sessions share batch slots
        instead of each running a solo session."""
        a = _STATE["args"]
        if not getattr(a, "rt_pool_slots", 0):
            return None
        with _STATE["lock"]:
            pool = _STATE.get("rt_pool")
        if pool is not None:
            return pool
        with _STATE["build_lock"]:
            with _STATE["lock"]:
                pool = _STATE.get("rt_pool")
            if pool is None:
                from .pool import RealtimeServingPool

                pool = RealtimeServingPool(
                    engine.params, engine.config, slots=a.rt_pool_slots,
                    dtype=engine.dtype, cache_len=4096, max_frames=2048)
                # run the admission shapes and capture the frame graphs now
                # (the first request pays once), not inside a live stream
                pool.warmup(prompt_lens=(32, 64), attend_upto=512)
                with _STATE["lock"]:
                    _STATE["rt_pool"] = pool
        return pool

    # ---- shared chunked-PCM16 plumbing (solo + pooled /stream) --------
    def _begin_chunked(self, sample_rate: int, extra=None):
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Sample-Rate", str(sample_rate))
        for k, v in (extra or {}).items():
            self.send_header(k, str(v))
        self.end_headers()

    def _chunk_emitter(self, m: SynthesisMetrics):
        """One emit() for both stream paths: PCM16 conversion + live
        TTFA/RTF riding as chunked-encoding chunk extensions
        (``<size>;ttfa=..;rtf=..`` — standards-compliant, ignored by plain
        clients, parseable by ours)."""

        def emit(chunk: np.ndarray):
            pcm = float_to_pcm16(np.nan_to_num(chunk)).tobytes()
            m.add_audio(chunk.size)
            ttfa = m.ttfa if m.ttfa is not None else 0.0
            rtf = m.rtf if m.rtf is not None else 0.0
            ext = f";ttfa={ttfa * 1000:.0f}ms;rtf={rtf:.2f}"
            self.wfile.write(f"{len(pcm):X}{ext}\r\n".encode())
            self.wfile.write(pcm)
            self.wfile.write(b"\r\n")

        return emit

    def _stream(self, body):
        """Ports ``Handler._stream``: chunked PCM16 streaming over the
        Realtime path.

        Serving-UX parity with the reference realtime app: initial prebuffer
        (``prebuffer_seconds``) and playback-rate backpressure
        (``buffer_threshold_seconds``) via stream_with_prebuffer
        (reference app.py:182-200,257-261,481-512); voice-prompt codec
        encodes go through the process-wide AudioTokenCache LRU
        (app.py:364-390). Live TTFA/RTF per chunk ride as chunked-encoding
        chunk extensions (``<size>;ttfa=..;rtf=..``) — standards-compliant,
        ignored by plain clients, parseable by ours."""
        from .backend import load_realtime_backend

        a = _STATE["args"]
        engine, proc, codec = _STATE["rt_backend"] or load_realtime_backend(
            a.model_path, a.codec_path, device=getattr(a, "device", "cuda"))
        pool = self._rt_pool(engine)
        if pool is not None and pool.supports(top_k=int(body.get("top_k", 30))):
            return self._stream_pooled(body, pool, proc, codec)
        with _STATE["rt_lock"]:
            self._stream_solo(body, engine, proc, codec)

    def _stream_solo(self, body, engine, proc, codec):
        """One streaming session on the shared engine (the caller holds
        ``rt_lock``)."""
        from ..engine.streaming import (
            AudioStreamDecoder,
            RealtimeStreamingSession,
            RealtimeTextStreamBridge,
            stream_with_prebuffer,
        )

        session = RealtimeStreamingSession(
            engine, proc, codec=codec,
            temperature=float(body.get("temperature", 0.8)),
            top_p=float(body.get("top_p", 0.6)),
            top_k=int(body.get("top_k", 30)),
            repetition_penalty=body.get("repetition_penalty", 1.1),
            token_cache=_token_cache(),
        )
        if body.get("voice_prompt"):
            session.set_voice_prompt(body["voice_prompt"])
        rng = np.random.default_rng(int(body.get("seed", 0)))
        user_audio = rng.integers(0, 1024, (int(body.get("user_audio_frames", 4)),
                                            engine.config.rvq))
        session.reset_turn(user_text=body.get("user_text", ""),
                           user_audio_tokens=user_audio)
        decoder = AudioStreamDecoder(
            codec, chunk_frames=int(body.get("chunk_frames", 12)),
            overlap_frames=int(body.get("overlap_frames", 2)),
            first_chunk_frames=int(body.get("first_chunk_frames", 2)))
        bridge = RealtimeTextStreamBridge(session, decoder)
        m = SynthesisMetrics(sample_rate=codec.sampling_rate)

        self._begin_chunked(codec.sampling_rate)
        emit = self._chunk_emitter(m)

        with codec.streaming(batch_size=1):
            chunks = bridge.stream_from_text_deltas(
                [body["text"]], max_frames=int(body.get("max_frames", 1024)))
            for wav in stream_with_prebuffer(
                chunks, codec.sampling_rate,
                prebuffer_seconds=float(body.get("prebuffer_seconds", 0.0)),
                buffer_threshold_seconds=float(
                    body.get("buffer_threshold_seconds", 0.0)),
            ):
                emit(wav)
        self.wfile.write(b"0\r\n\r\n")
        self._record(m)

    def _stream_pooled(self, body, pool, proc, codec):
        """/stream through the shared RealtimeServingPool: the turn grid is
        built host-side (same construction as the solo session's
        reset_turn), the conversation is admitted into the continuous-
        batching server, and frames arrive incrementally via
        partial_frames() — concurrent streams share batch slots instead of
        time-slicing the chip. The shared engine object is never mutated
        (no per-request session state). Client-visible behavior matches
        the solo path: prebuffer/backpressure honored, same chunk
        extensions; a client disconnect CANCELS the pooled conversation
        (frees its slot) instead of decoding dead work to the frame
        budget."""
        from ..engine.streaming import (
            AudioStreamDecoder,
            stream_with_prebuffer,
        )

        # voice prompt: RVQ tokens directly, or a wav path through the
        # process-wide encode LRU (same as the solo path)
        voice_tokens = None
        vp = body.get("voice_prompt")
        if vp is not None:
            vp_arr = np.asarray(vp) if not isinstance(vp, str) else None
            if vp_arr is not None and vp_arr.ndim == 2:
                voice_tokens = vp_arr
            else:
                from ..utils import audio as audio_io

                def encode(path):
                    wav, sr = audio_io.read_wav(path)
                    wav = audio_io.to_mono(wav).astype(np.float32)
                    if sr != codec.sampling_rate:
                        wav = audio_io.resample(wav, sr, codec.sampling_rate)
                    enc = codec.batch_encode([wav])
                    codes = np.asarray(enc.audio_codes)
                    return codes[:, 0, : int(enc.audio_codes_lengths[0])]

                voice_tokens = _token_cache().get_or_encode(vp, encode)

        rng = np.random.default_rng(int(body.get("seed", 0)))
        user_audio = rng.integers(
            0, 1024, (int(body.get("user_audio_frames", 4)), proc.channels))
        user_prompt = proc.make_user_prompt(body.get("user_text", ""),
                                            user_audio)
        system_prompt = proc.make_ensemble(voice_tokens)
        grid = np.concatenate([system_prompt, user_prompt], axis=0)
        text_ids = proc.tokenizer.encode(body["text"],
                                         add_special_tokens=False)
        sampling = {
            "temperature": float(body.get("temperature", 0.8)),
            "top_p": float(body.get("top_p", 0.6)),
            "repetition_penalty": float(body.get("repetition_penalty", 1.1)),
        }
        handle = pool.open_stream(
            grid, text_ids,
            max_new_tokens=int(body.get("max_frames", 1024)),
            sampling=sampling)

        decoder = AudioStreamDecoder(
            codec, chunk_frames=int(body.get("chunk_frames", 12)),
            overlap_frames=int(body.get("overlap_frames", 2)),
            first_chunk_frames=int(body.get("first_chunk_frames", 2)))
        m = SynthesisMetrics(sample_rate=codec.sampling_rate)

        self._begin_chunked(codec.sampling_rate, {"X-Pooled": "1"})
        emit = self._chunk_emitter(m)

        def wav_chunks():
            for block in handle.frames():
                # EOS rows never reach here (the server trims at EOS);
                # drop out-of-range rows individually (reference
                # _sanitize_audio_tokens :854-878 — its bridge's
                # stop-within-a-fetch-group behavior is an accident of
                # group size, and with trained weights invalid rows only
                # occur at EOS, so per-row dropping is equivalent)
                valid = ((block >= 0)
                         & (block < codec.codebook_size)).all(axis=1)
                clean = block[valid]
                if len(clean):
                    decoder.push_tokens(clean)
                    yield from decoder.audio_chunks()
            tail = decoder.flush()
            if tail is not None:
                yield tail

        completed = False
        try:
            with codec.streaming(batch_size=1):
                for wav in stream_with_prebuffer(
                    wav_chunks(), codec.sampling_rate,
                    prebuffer_seconds=float(body.get("prebuffer_seconds",
                                                     0.0)),
                    buffer_threshold_seconds=float(
                        body.get("buffer_threshold_seconds", 0.0)),
                ):
                    emit(wav)
            self.wfile.write(b"0\r\n\r\n")
            completed = True
        finally:
            if not completed:
                # client gone (BrokenPipe) or mid-stream error: free the
                # slot NOW — otherwise the pool decodes this abandoned
                # conversation to its max_frames budget while live streams
                # queue behind it
                pool.cancel(handle)
        self._record(m)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--codec-path", default=None)
    ap.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    ap.add_argument("--pool-slots", type=int, default=0,
                    help="share one continuous-batching pool of this many slots across "
                         "concurrent requests (0 = a solo generate per request)")
    ap.add_argument("--rt-pool-slots", type=int, default=0,
                    help="share one Realtime pool of this many slots across concurrent "
                         "/stream sessions (0 = a solo streaming session per request)")
    args = ap.parse_args(argv)
    _STATE["args"] = args
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"mosstts-tpu (PyTorch port) serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
