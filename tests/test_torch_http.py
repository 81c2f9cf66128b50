"""The port's HTTP front end on the CPU: the demo backend (random weights,
bf16 engine, f32 codec) behind a ``ThreadingHTTPServer`` on port 0 with a 2-slot
serving pool. ``/tts`` with a base64 reference wave, ``/ttsd``,
``/sound_effect`` and ``/voice_gen`` return WAV bytes; ``/healthz``,
``/metrics`` and the player page answer; ``/stream`` streams chunked PCM16
from the demo Realtime backend, solo and through a 2-slot Realtime pool
(three concurrent streams), with the sample-rate header and the live TTFA
in the chunk extensions; an unknown route answers 404. The backends' and
the CLI's ``realtime`` run too. Every request has its own timeout.
"""
import base64
import io
import json
import socket
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from mosstts_tpu_torch.serve import http_server as hs
from mosstts_tpu_torch.utils.audio import write_wav

WAIT = 300  # seconds per request
HOP = 1920  # samples per 12.5 Hz frame at 24 kHz


class Args:
    model_path = None
    codec_path = None
    device = "cpu"
    pool_slots = 2
    rt_pool_slots = 0


@pytest.fixture(scope="module")
def server():
    old = hs._STATE["args"], hs._STATE["pool"], hs._STATE["last_metrics"]
    hs._STATE["args"], hs._STATE["pool"], hs._STATE["last_metrics"] = Args(), None, None
    hs._STATE["rt_pool"] = None
    srv = ThreadingHTTPServer(("127.0.0.1", 0), hs.Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=WAIT)
        for name in ("pool", "rt_pool"):
            if hs._STATE[name] is not None:
                hs._STATE[name].close()
        hs._STATE["rt_pool"] = None
        hs._STATE["args"], hs._STATE["pool"], hs._STATE["last_metrics"] = old


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=WAIT)


def _wav(resp):
    assert resp.headers["Content-Type"] == "audio/wav"
    assert resp.headers["X-Status"].startswith("Done")
    with wave.open(io.BytesIO(resp.read())) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 24000)
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert pcm.size > 0 and pcm.size % HOP == 0
    return pcm


def _reference_b64(tmp_path):
    t = np.arange(24000) / 24000
    rng = np.random.default_rng(0)
    path = tmp_path / "ref.wav"
    write_wav(path, (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size))
              .astype(np.float32), 24000)
    return base64.b64encode(path.read_bytes()).decode()


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=WAIT) as r:
        assert json.loads(r.read()) == {"ok": True}


def test_tts_clone_with_reference_b64_through_the_pool(server, tmp_path):
    """Two concurrent Clone requests share the pool; then /metrics reports
    the last one."""
    body = {"text": "clone this voice", "mode": "Clone", "reference_b64": _reference_b64(tmp_path),
            "max_new_tokens": 48, "seed": 1}
    out, errors = {}, []

    def fetch(i):
        try:
            with _post(server + "/tts", dict(body, seed=i)) as r:
                out[i] = _wav(r)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert hs._STATE["pool"] is not None and hs._STATE["pool"].server.total_steps > 0
    with urllib.request.urlopen(server + "/metrics", timeout=WAIT) as r:
        m = json.loads(r.read())
    assert m["audio_s"] > 0 and m["ttfa_s"] is not None and m["rtf_x"] > 0


def test_ttsd_sound_effect_and_voice_gen(server):
    with _post(server + "/ttsd", {"dialogue": "[S1]Hello there. [S2]Hi!",
                                  "max_new_tokens": 48}) as r:
        _wav(r)
    with _post(server + "/sound_effect", {"ambient": "rain on a tin roof", "seconds": 1.0}) as r:
        _wav(r)
    with _post(server + "/voice_gen", {"text": "hello", "instruction": "a calm voice",
                                       "max_new_tokens": 48}) as r:
        _wav(r)


def test_tts_error_answers_400(server):
    """Too few frames for the 32-level delay pattern to yield audio: the
    pipeline raises and the server answers 400 with the error."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/tts", {"text": "hi", "max_new_tokens": 6})
    assert e.value.code == 400 and "error" in json.loads(e.value.read())


def _stream(server, body):
    """POST /stream on a raw socket: (headers, [chunk extensions], PCM16
    samples) of the chunked answer."""
    host, port = server.rsplit("/", 1)[1].split(":")
    data = json.dumps(body).encode()
    with socket.create_connection((host, int(port)), timeout=WAIT) as sock:
        sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\nConnection: close\r\n\r\n" % len(data) + data)
        raw = b""
        while chunk := sock.recv(1 << 16):
            raw += chunk
    head, rest = raw.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    assert lines[0].split()[1] == "200", raw[:300]
    headers = dict(line.split(": ", 1) for line in lines[1:])
    exts, pcm = [], b""
    while True:
        size_line, rest = rest.split(b"\r\n", 1)
        size, _, ext = size_line.decode().partition(";")
        if int(size, 16) == 0:
            break
        exts.append(ext)
        pcm, rest = pcm + rest[:int(size, 16)], rest[int(size, 16) + 2:]
    return headers, exts, np.frombuffer(pcm, "<i2")


STREAM = {"text": "hello from the stream", "user_text": "hi", "max_frames": 24,
          "chunk_frames": 4, "first_chunk_frames": 2}


def test_stream_501_and_unknown_route_404(server):
    """(Named when ``/stream`` answered 501.) A solo ``/stream``: chunked
    PCM16 at the codec's rate, each chunk's extension carrying the TTFA
    and RTF, at most ``max_frames`` frames of audio; an unknown route
    answers 404."""
    headers, exts, pcm = _stream(server, STREAM)
    assert headers["X-Sample-Rate"] == "24000" and "X-Pooled" not in headers
    assert headers["Transfer-Encoding"] == "chunked"
    assert exts and all(e.startswith("ttfa=") and ";rtf=" in e for e in exts)
    assert 0 < pcm.size <= 24 * HOP
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=WAIT)
    assert e.value.code == 404


def test_stream_through_the_realtime_pool(server):
    """Three concurrent pooled streams share a 2-slot Realtime pool (built
    and warmed at the first one); each returns audio with the pooled
    header and its TTFA."""
    hs._STATE["args"].rt_pool_slots = 2
    out, errors = {}, []

    def fetch(i):
        try:
            out[i] = _stream(server, dict(STREAM, seed=i, temperature=0.0))
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
    finally:
        hs._STATE["args"].rt_pool_slots = 0
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for headers, exts, pcm in out.values():
        assert headers["X-Pooled"] == "1" and headers["X-Sample-Rate"] == "24000"
        assert exts[0].startswith("ttfa=") and 0 < pcm.size <= 24 * HOP
    pool = hs._STATE["rt_pool"]
    assert pool is not None and pool.server.total_steps > 0 and not pool.server._active


def test_player_page(server):
    for path in ("/player", "/"):
        with urllib.request.urlopen(server + path, timeout=WAIT) as r:
            assert r.headers.get("Content-Type", "").startswith("text/html")
            html = r.read().decode()
        assert "AudioContext" in html and "/metrics" in html


def test_checkpoints_and_other_families_raise(tmp_path):
    """Checkpoint directories load through the backend loaders (a codec
    ``save_pretrained`` wrote, and Delay, Local and Realtime directories in
    the reference's layout, written from the demo backends' weights); a
    path that does not exist raises ``FileNotFoundError`` (JAX would serve
    random weights); the Local demo backend builds and generates on the
    CPU."""
    import torch

    from mosstts_tpu_torch.engine.local_engine import LocalEngine
    from mosstts_tpu_torch.processing.local_processor import LocalProcessor
    from mosstts_tpu_torch.serve import backend
    from mosstts_tpu_torch.tools.hf_checkpoint import same_params, write_hf_checkpoint
    from mosstts_tpu_torch.utils import checkpoints

    for fn in (backend.load_delay_backend, backend.load_local_backend,
               backend.load_realtime_backend):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "no-such-checkpoint"), device="cpu")
    with pytest.raises(FileNotFoundError):
        backend.load_codec(str(tmp_path / "no-such-codec"), device="cpu")

    local = backend.load_local_backend(device="cpu")
    assert isinstance(local.engine, LocalEngine) and isinstance(local.processor, LocalProcessor)
    assert local.engine.params.text_emb.device.type == "cpu"
    start, grid = local.engine.generate(
        local.processor([[local.processor.build_user_message(text="hi")]])["input_ids"],
        max_new_tokens=3)[0]
    assert start == 0 and grid.shape == (4, local.engine.config.channels)

    codec_dir = tmp_path / "codec"
    local.processor.audio_tokenizer.save_pretrained(codec_dir)
    codec = backend.load_codec(str(codec_dir), device="cpu")
    assert same_params(codec.params, local.processor.audio_tokenizer.params)
    delay = backend.load_delay_backend(device="cpu")
    engine, proc, rt_codec = backend.load_realtime_backend(device="cpu")
    for name, params, cfg, table, load in (
            ("delay", delay.engine.params, delay.engine.config, checkpoints.delay_table,
             backend.load_delay_backend),
            ("local", local.engine.params, local.engine.config, checkpoints.local_table,
             backend.load_local_backend),
            ("realtime", engine.params, engine.config, checkpoints.realtime_table,
             backend.load_realtime_backend)):
        write_hf_checkpoint(tmp_path / name, params, cfg, table(cfg), shard_bytes=8 << 20)
        loaded = load(str(tmp_path / name), str(codec_dir), device="cpu")
        got = loaded[0] if name == "realtime" else loaded.engine
        assert got.config == cfg and got.dtype == torch.bfloat16
        assert same_params(got.params, params), name
    assert not backend.load_delay_backend(str(tmp_path / "delay"), device="cpu").demo
    assert engine.config.rvq == proc.channels == rt_codec.config.n_q // 2
    assert engine.params.text_emb.device.type == "cpu"


def test_cli_clone_from_a_wave_file(tmp_path):
    """``cli tts --mode Clone --reference x.wav`` writes a wave, and so does
    ``cli realtime``."""
    from mosstts_tpu_torch.serve import cli

    ref = tmp_path / "ref.wav"
    ref.write_bytes(base64.b64decode(_reference_b64(tmp_path)))
    out = tmp_path / "out.wav"
    cli.main(["tts", "--text", "clone me", "--mode", "Clone", "--reference", str(ref),
              "--device", "cpu", "--max-new-tokens", "48",
              "--output", str(out)])
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000 and w.getnframes() > 0
    cli.main(["realtime", "--text", "stream this text", "--device", "cpu",
              "--max-frames", "12", "--output", str(out)])
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000 and 0 < w.getnframes() <= 12 * HOP
