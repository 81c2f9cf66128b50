"""Where the time of the 8B Delay decode step goes, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.profile_step [--batch 1 4] [--int8] [--trace-dir DIR]

Builds ``delay_8b()`` (random bf16 weights made on the card) and the
``codec_1p6b()`` codec with ``serve.pipelines.demo_backend``, then for each
batch size (and, with ``--int8``, for each batch size again after
``engine.quantize()``, in the same process):

- prefill of a ``--prompt``-token prompt into a ``--cache``-slot cache, the
  first one of the process (cold) and a second one (warm), host clock;
- the mean wall time of ``--steps`` greedy decode steps after 3 warm-up
  steps, attending ``--attend`` slots, host clock;
- a ``torch.profiler`` window of 4 more steps: device time per step (the sum
  of the kernels' self device time), kernels launched per step, the idle
  share (1 - device time / step wall time) and the top kernels by device
  time;
- a ``cProfile`` window of 4 more steps: the Python functions with the most
  host time of their own per step (cProfile slows the host; these say where
  the host time goes, not how much there is).

Then the codec's decode of 100 frames (8 s of audio) at batch 1, host
clock. The card's ``nvidia-smi`` line comes first and one JSON object of
the numbers last. Host-clock numbers move with the machine; compare two
versions only within one run.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch

from ..core.config import codec_1p6b, delay_8b
from ..models import delay as td
from ..ops.sampling import row_generators
from ..serve.pipelines import demo_backend
from .kernel_inputs import card_line

WINDOW = 4  # decode steps inside the profiler window


def _wall(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def profile_batch(engine, B: int, args, trace_dir) -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = engine.config, engine.device
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(1000, 1200, size=(B, args.prompt, cfg.channels)),
                       device=dev)
    ids[..., 1:] = cfg.audio_pad_code
    ids[:, -1, 0] = cfg.audio_start_token_id
    mask = torch.ones((B, args.prompt), dtype=torch.bool, device=dev)
    samp = td.make_sampling(text_temperature=0.0, audio_temperature=0.0, device=dev)

    def prefill():
        return td.delay_prefill(engine.params, cfg, ids, mask, max_new_tokens=args.steps + 16,
                                cache_len=args.cache, rng=row_generators(0, B, dev),
                                sampling=samp, dtype=engine.dtype)

    _, cold = _wall(prefill)
    st, warm = _wall(prefill)

    def step(st):
        return td.delay_decode_step(engine.params, cfg, st, samp, attend_len=args.attend,
                                    uniform_slots=True)

    for _ in range(3):
        st = step(st)

    def steps():
        s = st
        for _ in range(args.steps):
            s = step(s)
        return s

    st, wall = _wall(steps)
    wall /= args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WINDOW):
            st = step(st)
        torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    for _ in range(WINDOW):
        st = step(st)
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, callers)
    host_top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:args.top]
    evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in evts) / WINDOW / 1e3
    kernels = sum(e.count for e in evts) / WINDOW
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:args.top]
    if trace_dir is not None:
        prof.export_chrome_trace(str(trace_dir / f"decode_step_b{B}.json"))
    return dict(
        batch=B, prefill_cold_ms=cold * 1e3, prefill_warm_ms=warm * 1e3,
        step_wall_ms=wall * 1e3, step_device_ms=device_ms, kernels_per_step=kernels,
        idle_share=1.0 - device_ms / (wall * 1e3),
        top=[dict(ms_per_step=e.self_device_time_total / WINDOW / 1e3,
                  calls_per_step=e.count / WINDOW, name=e.key[:100]) for e in top],
        host_top=[dict(ms_per_step=v[2] / WINDOW * 1e3, calls_per_step=v[1] / WINDOW,
                       name=f"{Path(k[0]).name}:{k[1]}:{k[2]}") for k, v in host_top],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--prompt", type=int, default=200, help="prompt tokens")
    ap.add_argument("--cache", type=int, default=512, help="KV cache slots")
    ap.add_argument("--attend", type=int, default=256, help="cache slots a step attends")
    ap.add_argument("--steps", type=int, default=16, help="timed decode steps")
    ap.add_argument("--top", type=int, default=12, help="kernels listed per batch")
    ap.add_argument("--int8", action="store_true",
                    help="profile again after engine.quantize() (int8 weights)")
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write a chrome trace of each profiler window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool profiles a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card, flush=True)
    if args.trace_dir is not None:
        args.trace_dir.mkdir(parents=True, exist_ok=True)

    backend = demo_backend(delay_8b(), codec_1p6b(), seed=0, dtype=torch.bfloat16,
                           device="cuda")
    res = dict(card=card, args={k: str(v) for k, v in vars(args).items()}, batches=[])
    for weights in ("bf16", "int8") if args.int8 else ("bf16",):
        if weights == "int8":
            backend.engine.quantize()
            torch.cuda.empty_cache()
        for B in args.batch:
            r = dict(weights=weights, **profile_batch(backend.engine, B, args, args.trace_dir))
            res["batches"].append(r)
            print(f"{weights} B={B}: prefill T={args.prompt} cold {r['prefill_cold_ms']:.1f} ms, "
                  f"warm {r['prefill_warm_ms']:.1f} ms; decode step wall "
                  f"{r['step_wall_ms']:.2f} ms, device {r['step_device_ms']:.2f} ms, "
                  f"{r['kernels_per_step']:.0f} kernels, idle share {r['idle_share']:.3f}",
                  flush=True)
            for t in r["top"]:
                print(f"   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:6.0f}  {t['name']}")
            print("   host, own time under cProfile:")
            for t in r["host_top"]:
                print(f"   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:6.0f}  {t['name']}")

    codec = backend.processor.audio_tokenizer
    codes = np.random.default_rng(1).integers(0, 1024, size=(32, 1, 100))
    codec.decode(codes[:, :, :13])  # warm-up
    _, codec_s = _wall(lambda: codec.decode(codes))
    res["codec_decode_100_frames_ms"] = codec_s * 1e3
    print(f"codec decode 100 frames B=1: {codec_s * 1e3:.1f} ms", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
