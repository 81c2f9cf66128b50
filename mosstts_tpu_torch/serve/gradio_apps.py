"""Gradio UIs for the five serving flows (optional dependency).

Ports ``mosstts_tpu/serve/gradio_apps.py``: UI parity with the reference
apps (clis/moss_tts_app.py, moss_ttsd_app.py, moss_voice_generator_app.py,
moss_sound_effect_app.py, moss_tts_realtime/app.py) on top of the same
pipelines the CLI and HTTP server use, with the same components, labels,
ranges, defaults and event wiring.

The click handlers are plain functions of a backend (``tts_handler``,
``ttsd_handler``, ``voice_handler``, ``sfx_handler``, ``realtime_handler``),
where the JAX package defines them inside each builder: they take exactly
the JAX closures' arguments and return their shapes, and they run without
gradio (the tests hold them against the JAX demos' handlers; the smoke
drives them on the card). Only the builders and ``main`` import gradio
(``pip install gradio``), so this module imports without it.

Launch (the models on ``--device``, the card by default):

    python3 -m mosstts_tpu_torch.serve.gradio_apps {tts|ttsd|voice|sfx|realtime} [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..engine.metrics import SynthesisMetrics
from ..engine.streaming import (
    AudioStreamDecoder,
    AudioTokenCache,
    RealtimeStreamingSession,
    RealtimeTextStreamBridge,
    stream_with_prebuffer,
)
from . import text_norm
from .backend import load_delay_backend, load_realtime_backend
from .pipelines import (
    DEFAULTS,
    generate_sound_effect,
    generate_voice,
    synthesize,
    synthesize_dialogue,
)

MAX_SPEAKERS = 5


def _gradio():
    """The ``gradio`` module, imported when a UI is built."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use the CLI (mosstts_tpu_torch.serve.cli) or the "
            "HTTP server (mosstts_tpu_torch.serve.http_server) instead, or pip install gradio."
        ) from e
    return gr


def _ui_error(message: str) -> Exception:
    """gradio's ``Error`` (shown in the UI) where gradio imports, else a
    ``ValueError`` with the same message."""
    try:
        import gradio as gr
    except ImportError:
        return ValueError(message)
    return gr.Error(message)


def _sampling_sliders(defaults):
    gr = _gradio()
    t = gr.Slider(0.0, 2.5, value=defaults["temperature"], label="audio_temperature")
    p = gr.Slider(0.0, 1.0, value=defaults["top_p"], label="audio_top_p")
    k = gr.Slider(0, 200, value=defaults["top_k"], step=1, label="audio_top_k")
    r = gr.Slider(0.8, 2.0, value=defaults["repetition_penalty"],
                  label="audio_repetition_penalty")
    return t, p, k, r


# --------------------------------------------------------------------------
# click handlers: plain functions of a backend
# --------------------------------------------------------------------------

def tts_handler(backend):
    """The TTS demo's click handler over ``backend`` (JAX
    ``build_tts_demo.run``): ``((sr, wav), status)``."""

    def run(text, mode, reference, duration_enabled, duration_tokens,
            temperature, top_p, top_k, rp, max_new_tokens):
        sr, wav, status = synthesize(
            backend, text, mode=mode, reference_audio=reference,
            duration_tokens=int(duration_tokens) if duration_enabled else None,
            max_new_tokens=int(max_new_tokens),
            temperature=temperature, top_p=top_p, top_k=int(top_k),
            repetition_penalty=rp,
        )
        return (sr, wav), status

    return run


def ttsd_handler(backend):
    """The TTSD demo's click handler over ``backend`` (JAX
    ``build_ttsd_demo.run``): the first ``MAX_SPEAKERS`` of
    ``speaker_inputs`` are the reference waves, the rest their prompt
    texts; a speaker given only one of the two raises ``_ui_error``."""

    def run(dialogue, speaker_count, normalize, sr_norm,
            temperature, top_p, top_k, rp, max_new_tokens, *speaker_inputs):
        refs = speaker_inputs[:MAX_SPEAKERS]
        prompts = speaker_inputs[MAX_SPEAKERS:]
        speakers = {}
        for i in range(int(speaker_count)):
            if refs[i] and (prompts[i] or "").strip():
                speakers[i + 1] = (refs[i], prompts[i])
            elif bool(refs[i]) != bool((prompts[i] or "").strip()):
                raise _ui_error(f"S{i+1} needs both reference audio and prompt text.")
        sr, wav, status = synthesize_dialogue(
            backend, dialogue, speakers=speakers, speaker_count=int(speaker_count),
            do_text_normalize=normalize, sample_rate_normalize=sr_norm,
            max_new_tokens=int(max_new_tokens),
            temperature=temperature, top_p=top_p, top_k=int(top_k),
            repetition_penalty=rp,
        )
        return (sr, wav), status

    return run


def voice_handler(backend):
    """The VoiceGenerator demo's click handler over ``backend`` (JAX
    ``build_voice_demo.run``)."""

    def run(text, instruction, temperature, top_p, top_k, rp, mx):
        sr, wav, status = generate_voice(
            backend, text, instruction, max_new_tokens=int(mx),
            temperature=temperature, top_p=top_p, top_k=int(top_k),
            repetition_penalty=rp,
        )
        return (sr, wav), status

    return run


def sfx_handler(backend):
    """The SoundEffect demo's click handler over ``backend`` (JAX
    ``build_sfx_demo.run``)."""

    def run(ambient, seconds, temperature, top_p, top_k, rp):
        sr, wav, status = generate_sound_effect(
            backend, ambient, seconds,
            temperature=temperature, top_p=top_p, top_k=int(top_k),
            repetition_penalty=rp,
        )
        return (sr, wav), status

    return run


def realtime_handler(engine, processor, codec, token_cache: AudioTokenCache):
    """The Realtime demo's streaming handler (JAX
    ``build_realtime_demo.run_stream``), a generator: one
    ``RealtimeStreamingSession`` a call on ``engine`` (voice prompts encoded
    through ``token_cache``), its chunks through ``AudioStreamDecoder`` and
    ``stream_with_prebuffer``; it yields ``((sr, wav), live)`` per chunk,
    then ``(None, "done | <metrics json>")``. The turn drains until the
    engine reports EOS, as in JAX."""

    def run_stream(text, voice_prompt, temperature, top_p, top_k, rp,
                   chunk_frames, prebuffer_s, buffer_threshold_s):
        session = RealtimeStreamingSession(
            engine, processor, codec=codec, temperature=temperature, top_p=top_p,
            top_k=int(top_k), repetition_penalty=rp, token_cache=token_cache,
        )
        if voice_prompt:
            session.set_voice_prompt(voice_prompt)
        user_audio = np.zeros((1, engine.config.rvq), np.int64)
        session.reset_turn(user_text="", user_audio_tokens=user_audio)
        decoder = AudioStreamDecoder(codec, chunk_frames=int(chunk_frames),
                                     overlap_frames=2)
        bridge = RealtimeTextStreamBridge(session, decoder)
        metrics = SynthesisMetrics(sample_rate=codec.sampling_rate)
        with codec.streaming(batch_size=1):
            chunks = stream_with_prebuffer(
                bridge.stream_from_text_deltas([text]),
                codec.sampling_rate,
                prebuffer_seconds=float(prebuffer_s),
                buffer_threshold_seconds=float(buffer_threshold_s),
            )
            for i, wav in enumerate(chunks):
                metrics.add_audio(wav.size)
                rep = metrics.report()
                live = (f"chunk {i + 1} | ttfa={1000 * (rep['ttfa_s'] or 0):.0f}ms"
                        f" | rtf={rep['rtf_x']} | audio={rep['audio_s']}s")
                yield (codec.sampling_rate, wav), live
        yield None, f"done | {metrics.json()}"

    return run_stream


# --------------------------------------------------------------------------
# the five UIs
# --------------------------------------------------------------------------

def build_tts_demo(model_path=None, codec_path=None, *, device="cuda"):
    gr = _gradio()
    backend = load_delay_backend(model_path, codec_path, device=device)

    def update_duration(text):
        lang, default, lo, hi = text_norm.estimate_duration_tokens(text or "")
        return gr.update(value=default, minimum=lo, maximum=hi,
                         label=f"duration tokens ({lang})")

    with gr.Blocks(title="MOSS-TTS (PyTorch)") as demo:
        gr.Markdown("# MOSS-TTS — zero-shot TTS / cloning / continuation (PyTorch)")
        text = gr.Textbox(label="Text", lines=4)
        mode = gr.Radio(["Direct", "Clone", "Continuation", "Continuation + Clone"],
                        value="Direct", label="Mode")
        reference = gr.Audio(label="Reference audio", type="filepath")
        duration_enabled = gr.Checkbox(False, label="Duration control")
        duration_tokens = gr.Slider(1, 4000, value=100, step=1, label="duration tokens")
        text.change(update_duration, text, duration_tokens)
        t, p, k, r = _sampling_sliders(DEFAULTS["moss_tts"])
        mx = gr.Slider(16, 16000, value=2000, step=1, label="max_new_tokens")
        btn = gr.Button("Synthesize")
        audio = gr.Audio(label="Output")
        status = gr.Textbox(label="Status")
        btn.click(tts_handler(backend), [text, mode, reference, duration_enabled,
                                         duration_tokens, t, p, k, r, mx], [audio, status])
    return demo


def build_ttsd_demo(model_path=None, codec_path=None, *, device="cuda"):
    gr = _gradio()
    backend = load_delay_backend(model_path, codec_path, device=device)
    with gr.Blocks(title="MOSS-TTSD (PyTorch)") as demo:
        gr.Markdown("# MOSS-TTSD — multi-speaker dialogue (PyTorch)")
        dialogue = gr.Textbox(label="Dialogue ([S1].. [S2]..)", lines=6)
        count = gr.Slider(1, MAX_SPEAKERS, value=2, step=1, label="Speakers")
        normalize = gr.Checkbox(True, label="Text normalization")
        sr_norm = gr.Checkbox(False, label="Resample refs to lowest SR")
        refs, prompts = [], []
        for i in range(MAX_SPEAKERS):
            with gr.Row(visible=i < 2):
                refs.append(gr.Audio(label=f"S{i+1} reference", type="filepath"))
                prompts.append(gr.Textbox(label=f"S{i+1} prompt text"))
        t, p, k, r = _sampling_sliders(DEFAULTS["moss_ttsd"])
        mx = gr.Slider(16, 48000, value=4000, step=1, label="max_new_tokens")
        btn = gr.Button("Synthesize dialogue")
        audio = gr.Audio(label="Output")
        status = gr.Textbox(label="Status")
        btn.click(ttsd_handler(backend), [dialogue, count, normalize, sr_norm, t, p, k, r, mx,
                                          *refs, *prompts], [audio, status])
    return demo


def build_voice_demo(model_path=None, codec_path=None, *, device="cuda"):
    gr = _gradio()
    backend = load_delay_backend(model_path, codec_path, device=device)
    with gr.Blocks(title="MOSS-VoiceGenerator (PyTorch)") as demo:
        gr.Markdown("# MOSS-VoiceGenerator — instruction-driven voice design (PyTorch)")
        text = gr.Textbox(label="Text", lines=3)
        instruction = gr.Textbox(label="Voice instruction", lines=2)
        t, p, k, r = _sampling_sliders(DEFAULTS["voice_generator"])
        mx = gr.Slider(16, 16000, value=2000, step=1, label="max_new_tokens")
        btn = gr.Button("Generate")
        audio = gr.Audio(label="Output")
        status = gr.Textbox(label="Status")
        btn.click(voice_handler(backend), [text, instruction, t, p, k, r, mx], [audio, status])
    return demo


def build_sfx_demo(model_path=None, codec_path=None, *, device="cuda"):
    gr = _gradio()
    backend = load_delay_backend(model_path, codec_path, device=device)
    with gr.Blocks(title="MOSS-SoundEffect (PyTorch)") as demo:
        gr.Markdown("# MOSS-SoundEffect (PyTorch)")
        ambient = gr.Textbox(label="Ambient sound description")
        seconds = gr.Slider(1, 60, value=4, step=0.5, label="Duration (s)")
        t, p, k, r = _sampling_sliders(DEFAULTS["sound_effect"])
        btn = gr.Button("Generate")
        audio = gr.Audio(label="Output")
        status = gr.Textbox(label="Status")
        btn.click(sfx_handler(backend), [ambient, seconds, t, p, k, r], [audio, status])
    return demo


def build_realtime_demo(model_path=None, codec_path=None, *, device="cuda"):
    gr = _gradio()
    engine, proc, codec = load_realtime_backend(model_path, codec_path, device=device)
    token_cache = AudioTokenCache(max_entries=32)  # voice-prompt encode LRU
    with gr.Blocks(title="MOSS-TTS-Realtime (PyTorch)") as demo:
        gr.Markdown("# MOSS-TTS-Realtime — streaming synthesis (PyTorch)")
        text = gr.Textbox(label="Text", lines=4)
        voice = gr.Audio(label="Voice prompt (optional)", type="filepath")
        t = gr.Slider(0.0, 2.0, value=0.8, label="temperature")
        p = gr.Slider(0.0, 1.0, value=0.6, label="top_p")
        k = gr.Slider(0, 100, value=30, step=1, label="top_k")
        r = gr.Slider(0.8, 2.0, value=1.1, label="repetition_penalty")
        cf = gr.Slider(4, 50, value=12, step=1, label="chunk frames")
        pb = gr.Slider(0.0, 20.0, value=0.0, step=0.05, label="initial buffer (s)")
        bt = gr.Slider(0.0, 60.0, value=0.0, step=0.5,
                       label="backpressure threshold (s, 0 = off)")
        btn = gr.Button("Stream")
        audio = gr.Audio(label="Streaming output", streaming=True, autoplay=True)
        status = gr.Textbox(label="TTFA / RTF (live)")
        btn.click(realtime_handler(engine, proc, codec, token_cache),
                  [text, voice, t, p, k, r, cf, pb, bt], [audio, status])
    return demo


BUILDERS = {
    "tts": build_tts_demo,
    "ttsd": build_ttsd_demo,
    "voice": build_voice_demo,
    "sfx": build_sfx_demo,
    "realtime": build_realtime_demo,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("app", choices=sorted(BUILDERS))
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--codec-path", default=None)
    ap.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args()
    demo = BUILDERS[args.app](args.model_path, args.codec_path, device=args.device)
    demo.queue(max_size=16, default_concurrency_limit=1)
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
