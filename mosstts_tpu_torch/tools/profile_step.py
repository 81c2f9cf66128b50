"""Where the time of the 8B Delay decode step goes, on one NVIDIA GPU.

    python3 -m mosstts_tpu_torch.tools.profile_step [--batch 1 4] [--int8] [--graph]
        [--hidden-out-layers] [--trace-dir DIR]

Builds ``delay_8b()`` (random bf16 weights made on the card) and the
``codec_1p6b()`` codec with ``serve.pipelines.demo_backend``, then for each
batch size (and, with ``--int8``, for each batch size again after
``engine.quantize()``, in the same process):

- prefill of a ``--prompt``-token prompt into a ``--cache``-slot static
  state through ``engine/step_graph.Prefills``, as the engine runs it: the
  first one at that prompt length (cold, eager) and the third (warm: with
  ``--graph`` a replay of the graph the second captured), host clock;
- the mean wall time of ``--steps`` greedy decode steps after 3 warm-up
  steps, attending ``--attend`` slots, host clock: eager steps, and with
  ``--graph`` then CUDA-graph steps over a state of their own
  (``engine/step_graph.DecodeSteps``, as the engine and the server run
  them; the first warm-up step captures the graph), each with the rows
  below;
- a ``torch.profiler`` window of 4 more steps: device time per step (the sum
  of the kernels' self device time), device kernels per step, the idle
  share (1 - device time / step wall time), the top kernels by device
  time, and the decode attention's device kernels per step and their time
  (one ``decode_kernel`` launch per layer), and the device kernels and
  time of ``csrc/w8_gemm.cu`` per step (int8 weights: one per W8A16
  call);
- a ``cProfile`` window of 4 more steps: the Python functions with the most
  host time of their own per step (cProfile slows the host; these say where
  the host time goes, not how much there is).

With ``--hidden-out-layers`` each of these runs is made twice, with the
default heads and with ``hidden_out_layers = [-1] * C`` (every head
sourced from the last layer through ``output_hidden_states``: the same
logits, through the per-head product of JAX's ``delay_forward``, which
with int8 heads makes a bf16 copy of the audio heads per call).

Then the codec's decode of 100 frames (8 s of audio) at batch 1, one
chunk: a replay of the backend's warmed graph and the same chunk eagerly
(``graphs=False``), each its median wall of 5 calls (host clock) and one
call's device time and kernels under the profiler. The card's
``nvidia-smi`` line comes first and one JSON object of the numbers last,
and the peak device memory of each batch's run. Host-clock
numbers move with the machine; compare two versions only within one run.
The bf16 products run at PyTorch's default flags (``ops.basic.dense`` does
not depend on the reduced-precision reduction flag).
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch

from ..codec.model import MossAudioTokenizer
from ..core.config import codec_1p6b, delay_8b
from ..engine.step_graph import DecodeSteps, Prefills, zero_state
from ..models import delay as td
from ..serve.pipelines import demo_backend
from .kernel_inputs import card_line

WINDOW = 4  # decode steps inside the profiler window
BURST = 64  # throwaway kernels that open a profiler window


def _wall(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


@contextlib.contextmanager
def device_profile(cpu: bool = False):
    """``torch.profiler.profile`` of the device's activity (and the host's,
    with ``cpu``), opened by ``BURST`` throwaway ``spin_kernel`` launches
    (``torch.cuda._sleep(0)``; ``device_events`` leaves them out): a
    session can lose the records of the first kernels launched in it, 4
    and more once much work has run in the process
    (``tools/profiler_sessions.py``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        for _ in range(BURST):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def device_events(prof) -> list:
    """The device events of a ``device_profile`` session, its opening burst
    left out (``key_averages``)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]


def call_times(fn, n: int = 5) -> dict:
    """The median wall ms of ``n`` calls of ``fn`` (host clock, the card
    synchronised around each), then one more call's device ms (the sum of
    its device activity, copies included, ``device_profile``) and device
    kernels."""
    walls = sorted(_wall(fn)[1] * 1e3 for _ in range(n))
    with device_profile() as prof:
        fn()
    evts = device_events(prof)
    return dict(wall_ms=walls[n // 2], device_ms=sum(e.self_device_time_total for e in evts) / 1e3,
                kernels=sum(e.count for e in evts if not e.key.startswith(("Memcpy", "Memset"))))


def profile_batch(engine, B: int, args, trace_dir, graphs: bool = False, hol=None) -> dict:
    cfg, dev = engine.config, engine.device
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(1000, 1200, size=(B, args.prompt, cfg.channels)),
                       device=dev)
    ids[..., 1:] = cfg.audio_pad_code
    ids[:, -1, 0] = cfg.audio_start_token_id
    mask = torch.ones((B, args.prompt), dtype=torch.bool, device=dev)
    samp = td.make_sampling(text_temperature=0.0, audio_temperature=0.0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    st = zero_state(cfg, B, args.cache, args.cache, dtype=engine.dtype, kv_quant=False,
                    device=dev)
    runner = DecodeSteps(engine.params, cfg, st, samp, graphs=graphs)
    prefills = Prefills(runner, st, samp)

    def prefill():
        prefills.run(ids, mask, top_k_text=engine.top_k_text, top_k_audio=engine.top_k_audio,
                     hidden_out_layers=hol)

    _, cold = _wall(prefill)
    _wall(prefill)  # with graphs: the capture, then its first replay
    _, warm = _wall(prefill)

    def step():
        runner.step(attend_len=args.attend, uniform_slots=True, top_k_text=engine.top_k_text,
                    top_k_audio=engine.top_k_audio, hidden_out_layers=hol)

    for _ in range(3):
        step()

    def steps():
        for _ in range(args.steps):
            step()

    _, wall = _wall(steps)
    wall /= args.steps
    with device_profile(cpu=True) as prof:
        for _ in range(WINDOW):
            step()
        torch.cuda.synchronize()
    host = cProfile.Profile()
    host.enable()
    for _ in range(WINDOW):
        step()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, callers)
    host_top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:args.top]
    evts = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in evts) / WINDOW / 1e3
    kernels = sum(e.count for e in evts) / WINDOW
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:args.top]
    attn = [e for e in evts if "decode_kernel" in e.key]
    w8 = [e for e in evts if "mosstts::w8::" in e.key]
    if trace_dir is not None:
        name = f"decode_step_b{B}{'_graph' if graphs else ''}{'_hol' if hol else ''}.json"
        prof.export_chrome_trace(str(trace_dir / name))
    return dict(
        batch=B, steps="graph" if graphs else "eager",
        heads="default" if hol is None else "hidden_out_layers",
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, prefill_cold_ms=cold * 1e3, prefill_warm_ms=warm * 1e3,
        step_wall_ms=wall * 1e3, step_device_ms=device_ms, kernels_per_step=kernels,
        idle_share=1.0 - device_ms / (wall * 1e3),
        decode_attention=dict(kernels_per_step=sum(e.count for e in attn) / WINDOW,
                              ms_per_step=sum(e.self_device_time_total for e in attn)
                              / WINDOW / 1e3),
        w8_gemm=dict(kernels_per_step=sum(e.count for e in w8) / WINDOW,
                     ms_per_step=sum(e.self_device_time_total for e in w8) / WINDOW / 1e3),
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
    ap.add_argument("--graph", action="store_true",
                    help="after the eager steps, profile CUDA-graph steps the same way")
    ap.add_argument("--hidden-out-layers", action="store_true",
                    help="profile each run again with hidden_out_layers = [-1] * C")
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write a chrome trace of each profiler window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool profiles a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        hols = (None, (-1,) * backend.engine.config.channels)[:1 + args.hidden_out_layers]
        for B, graphs, hol in ((B, g, h) for B in args.batch
                               for g in (False, True)[:1 + args.graph] for h in hols):
            r = dict(weights=weights, **profile_batch(backend.engine, B, args, args.trace_dir,
                                                      graphs, hol))
            res["batches"].append(r)
            print(f"{weights} B={B} {r['steps']} steps, {r['heads']} heads: prefill T={args.prompt} cold "
                  f"{r['prefill_cold_ms']:.1f} ms, warm {r['prefill_warm_ms']:.1f} ms; decode step "
                  f"wall {r['step_wall_ms']:.3f} ms, device {r['step_device_ms']:.3f} ms, "
                  f"{r['kernels_per_step']:.0f} kernels, idle share {r['idle_share']:.3f}; "
                  f"peak {r['peak_gib']:.2f} GiB", flush=True)
            da = r["decode_attention"]
            print(f"   decode attention: {da['kernels_per_step']:.0f} device kernels per step "
                  f"(one per layer), {da['ms_per_step']:.3f} ms/step", flush=True)
            if weights == "int8":
                w8 = r["w8_gemm"]
                print(f"   csrc/w8_gemm.cu: {w8['kernels_per_step']:.0f} device kernels per step "
                      f"(one per W8A16 call), {w8['ms_per_step']:.3f} ms/step", flush=True)
            for t in r["top"]:
                print(f"   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:6.0f}  {t['name']}")
            print("   host, own time under cProfile:")
            for t in r["host_top"]:
                print(f"   {t['ms_per_step']:8.3f} ms/step  x{t['calls_per_step']:6.0f}  {t['name']}")

    # the backend's codec replays its warmed 100-frame decode graph; an
    # eager codec over the same weights runs the same chunk op by op
    codec = backend.processor.audio_tokenizer
    eager = MossAudioTokenizer(codec.params, codec.config, graphs=False)
    codes = np.random.default_rng(1).integers(0, 1024, size=(32, 1, 100))
    eager.decode(codes[:, :, :13])  # warm-up
    res["codec_decode_100_frames"] = {}
    for label, c in (("graph", codec), ("eager", eager)):
        r = res["codec_decode_100_frames"][label] = call_times(lambda: c.decode(codes))
        print(f"codec decode 100 frames B=1, {label}: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms, {r['kernels']} device kernels", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
