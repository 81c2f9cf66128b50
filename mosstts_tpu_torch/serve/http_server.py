"""HTTP serving front end (stdlib, dependency-free).

Ports ``mosstts_tpu/serve/http_server.py`` for the Delay apps:

    GET  /healthz                     -> {"ok": true}
    POST /tts           {"text", "mode", "reference_b64?", ...} -> WAV bytes
    POST /ttsd          {"dialogue", ...}                       -> WAV bytes
    POST /sound_effect  {"ambient", "seconds", ...}             -> WAV bytes
    POST /voice_gen     {"text", "instruction", ...}            -> WAV bytes
    GET  /metrics                     -> last synthesis metrics JSON
    GET  /player (or /) -> the in-browser streaming player page

``POST /stream`` (the Realtime family's streaming path) answers 501 until
that family is ported (ROADMAP A.8); an unknown route answers 404.
``--pool-slots N``
shares one continuous-batching pool of N slots (``serve/pool.py``) across
concurrent requests; 0 runs a solo generate per request, one at a time.

Run on the card (random demo weights):
    python3 -m mosstts_tpu_torch.serve.http_server --port 7860 --pool-slots 16
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
          # a DelayBackend that a program embedding the server built itself
          # (chip_smoke.py's 8B backend), served in place of the demo one
          "backend": None,
          # building the pool holds build_lock, not the global lock, so that
          # /metrics and _record() on other threads never wait for it
          "build_lock": threading.Lock()}

STREAM_NOT_PORTED = ("POST /stream is the Realtime family's streaming path, which is not "
                     "ported yet (ROADMAP A.8)")


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
                return self._send_json({"error": STREAM_NOT_PORTED}, 501)
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
    args = ap.parse_args(argv)
    _STATE["args"] = args
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"mosstts-tpu (PyTorch port) serving on http://{args.host}:{args.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
