"""Command-line serving apps: the Delay checkpoints' app flows as
subcommands.

Ports ``mosstts_tpu/serve/cli.py``:

    python3 -m mosstts_tpu_torch.serve.cli tts --text "..." [--mode Clone --reference x.wav]
    python3 -m mosstts_tpu_torch.serve.cli ttsd --dialogue "[S1]... [S2]..." \\
        [--speaker 1:ref.wav:"prompt"]
    python3 -m mosstts_tpu_torch.serve.cli voice-gen --text "..." --instruction "..."
    python3 -m mosstts_tpu_torch.serve.cli sound-effect --ambient "rain" --seconds 4
    python3 -m mosstts_tpu_torch.serve.cli realtime --text "..." [--voice-prompt x.wav]

Each writes the wave to ``--output`` and prints its path and a status line
(``realtime`` streams the text as simulated LLM deltas through the
Realtime session and prints the time to the first audio and the realtime
factor). The models run on ``--device`` (the card by default) with random
demo weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..utils.audio import write_wav


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--model-path", default=None, help="checkpoint dir (not ported yet)")
    p.add_argument("--codec-path", default=None)
    p.add_argument("--device", default="cuda", help="where the models run (cuda or cpu)")
    p.add_argument("--output", default="out.wav")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=2000)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)


def _sampling_kwargs(args) -> dict:
    kw = {}
    for k in ("temperature", "top_p", "top_k", "repetition_penalty"):
        v = getattr(args, k)
        if v is not None:
            kw[k] = v
    return kw


def _backend(args):
    from .backend import load_delay_backend

    return load_delay_backend(args.model_path, args.codec_path, device=args.device)


def _write(args, sr, wav, status):
    write_wav(args.output, wav, sr)
    print(f"{status}\nwrote {args.output} ({wav.size / sr:.2f}s @ {sr}Hz)")


def cmd_tts(args):
    from .pipelines import synthesize

    _write(args, *synthesize(
        _backend(args), args.text, mode=args.mode, reference_audio=args.reference,
        duration_tokens=args.duration_tokens, max_new_tokens=args.max_new_tokens,
        seed=args.seed, **_sampling_kwargs(args),
    ))


def cmd_ttsd(args):
    from .pipelines import synthesize_dialogue

    speakers = {}
    for spec in args.speaker or []:
        sid, path, prompt = spec.split(":", 2)
        speakers[int(sid)] = (path, prompt)
    _write(args, *synthesize_dialogue(
        _backend(args), args.dialogue, speakers=speakers,
        do_text_normalize=not args.no_normalize,
        sample_rate_normalize=args.sample_rate_normalize,
        max_new_tokens=args.max_new_tokens, seed=args.seed,
        **_sampling_kwargs(args),
    ))


def cmd_voice_gen(args):
    from .pipelines import generate_voice

    _write(args, *generate_voice(
        _backend(args), args.text, args.instruction,
        max_new_tokens=args.max_new_tokens, seed=args.seed, **_sampling_kwargs(args),
    ))


def cmd_sound_effect(args):
    from .pipelines import generate_sound_effect

    _write(args, *generate_sound_effect(
        _backend(args), args.ambient, args.seconds, seed=args.seed, **_sampling_kwargs(args),
    ))


def cmd_realtime(args):
    """Ports ``mosstts_tpu.serve.cli.cmd_realtime``."""
    from ..engine.streaming import (
        AudioStreamDecoder,
        RealtimeStreamingSession,
        RealtimeTextStreamBridge,
    )
    from .backend import load_realtime_backend

    engine, proc, codec = load_realtime_backend(args.model_path, args.codec_path,
                                                device=args.device)
    session = RealtimeStreamingSession(
        engine, proc, codec=codec,
        temperature=args.temperature if args.temperature is not None else 0.8,
        top_p=args.top_p if args.top_p is not None else 0.6,
        top_k=args.top_k if args.top_k is not None else 30,
        repetition_penalty=args.repetition_penalty
        if args.repetition_penalty is not None else 1.1,
    )
    if args.voice_prompt:
        session.set_voice_prompt(args.voice_prompt)

    rng = np.random.default_rng(args.seed)
    user_audio = rng.integers(0, 1024, (args.user_audio_frames, engine.config.rvq))
    session.reset_turn(user_text=args.user_text, user_audio_tokens=user_audio)

    decoder = AudioStreamDecoder(codec, chunk_frames=args.chunk_frames,
                                 overlap_frames=args.overlap_frames)
    bridge = RealtimeTextStreamBridge(session, decoder)

    # simulate an LLM delta stream from the text
    words = args.text.split(" ")
    deltas = [w + " " for w in words[:-1]] + [words[-1]]

    t0 = time.monotonic()
    ttfa = None
    chunks = []
    with codec.streaming(batch_size=1):
        for delta in deltas:
            for wav in bridge.push_text_delta(delta):
                if ttfa is None:
                    ttfa = time.monotonic() - t0
                chunks.append(wav)
        for wav in bridge.finish(max_frames=args.max_frames):
            if ttfa is None:
                ttfa = time.monotonic() - t0
            chunks.append(wav)
    elapsed = time.monotonic() - t0
    if not chunks:
        print("no audio generated")
        return
    full = np.concatenate(chunks)
    sr = codec.sampling_rate
    rtf = (full.size / sr) / elapsed if elapsed > 0 else float("inf")
    write_wav(args.output, full, sr)
    print(
        f"Done | TTFA={ttfa:.3f}s | RTF={rtf:.2f}x | chunks={len(chunks)} | "
        f"elapsed={elapsed:.2f}s\nwrote {args.output} ({full.size / sr:.2f}s @ {sr}Hz)"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mosstts-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tts", help="MOSS-TTS zero-shot / clone / continuation")
    _add_common(p)
    p.add_argument("--text", required=True)
    p.add_argument("--mode", default="Direct",
                   choices=["Direct", "Clone", "Continuation", "Continuation + Clone"])
    p.add_argument("--reference", default=None, help="reference wav path")
    p.add_argument("--duration-tokens", type=int, default=None)
    p.set_defaults(fn=cmd_tts)

    p = sub.add_parser("ttsd", help="MOSS-TTSD multi-speaker dialogue")
    _add_common(p)
    p.add_argument("--dialogue", required=True, help="[S1]hi [S2]hello ...")
    p.add_argument("--speaker", action="append",
                   help="id:ref.wav:prompt text (repeatable)")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--sample-rate-normalize", action="store_true")
    p.set_defaults(fn=cmd_ttsd)

    p = sub.add_parser("voice-gen", help="MOSS-VoiceGenerator instruction-driven voice")
    _add_common(p)
    p.add_argument("--text", required=True)
    p.add_argument("--instruction", default="")
    p.set_defaults(fn=cmd_voice_gen)

    p = sub.add_parser("sound-effect", help="MOSS-SoundEffect generation")
    _add_common(p)
    p.add_argument("--ambient", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.set_defaults(fn=cmd_sound_effect)

    p = sub.add_parser("realtime", help="MOSS-TTS-Realtime streaming demo")
    _add_common(p)
    p.add_argument("--text", required=True, help="text to stream (simulated LLM deltas)")
    p.add_argument("--user-text", default="hello")
    p.add_argument("--user-audio-frames", type=int, default=8)
    p.add_argument("--voice-prompt", default=None, help="voice prompt wav path")
    p.add_argument("--chunk-frames", type=int, default=12)
    p.add_argument("--overlap-frames", type=int, default=2)
    p.add_argument("--max-frames", type=int, default=1024,
                   help="end the stream after this many frames if no EOS came")
    p.set_defaults(fn=cmd_realtime)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
