"""The bf16 serving path's times for the ``mosstts_tpu_torch`` of any
checkout, so that two commits can be compared on one NVIDIA GPU.

    python3 mosstts_tpu_torch/tools/bf16_path.py --root DIR [--label NAME]

Run it as a file: it imports ``mosstts_tpu_torch`` and ``chip_smoke`` from
``--root``, a checkout (e.g. an archive of another commit unpacked under the
git-ignored ``build/``), so the same script measures either tree. At
``delay_8b()`` width with random bf16 weights (seed 0), in one process:

- the Delay audio-head product ``models.delay._audio_head_logits`` on a
  decode step's hidden state (B, 1, 4096), B = 1 and 16: device time per
  call, the sum of its kernels' device time over 20 calls under
  ``torch.profiler``;
- greedy decode steps at B = 1 and 16 (that checkout's
  ``tools.profile_step.profile_batch``: prompt 200, cache 512, attend 256,
  16 timed steps): step wall time (host clock), device time, idle share;
- twice, a 16-slot ``DelayBatchServer`` with a linear bf16 KV cache serving
  the smoke's 24 requests (``chip_smoke.server_traffic``; the options of
  the smoke's phase 5): useful frames/s and ms per step, host clock.

One JSON line last. Host clocks move between machines and runs: compare two
trees only within one call, alternating their order (A B B A).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn``: its kernels' self device time summed
    over ``n`` calls under ``torch.profiler``, divided by ``n``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in evts) / n / 1e3


def serve(params, cfg, server_cls, make_sampling, traffic) -> dict:
    import torch

    prompts, budgets = traffic(cfg)
    server = server_cls(params, cfg, slots=16, cache_len=1024, out_capacity=128,
                        prompt_bucket=32, page_size=128, dtype=torch.bfloat16,
                        sampling=make_sampling(text_temperature=1.7, audio_temperature=1.7,
                                               audio_top_p=0.8, device="cuda"))
    server.warmup(prompt_lens=(64, 96), attend_upto=256)
    server.total_steps, server.util_sum, server.total_preemptions = 0, 0.0, 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rids = {server.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if sorted(c.request_id for c in done) != sorted(rids):
        raise AssertionError(f"server: {len(done)} of {len(rids)} requests completed")
    frames = sum(min(c.steps, rids[c.request_id]) for c in done)
    steps = server.total_steps
    return dict(steps=steps, frames=frames, wall_s=wall, frames_per_s=frames / wall,
                ms_per_step=wall / steps * 1e3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="the checkout to measure")
    ap.add_argument("--label", default=None, help="a name for the tree in the output")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    import chip_smoke
    from mosstts_tpu_torch.core.config import delay_8b
    from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
    from mosstts_tpu_torch.models import delay as td
    from mosstts_tpu_torch.serve.pipelines import demo_backend
    from mosstts_tpu_torch.tools import profile_step
    from mosstts_tpu_torch.tools.kernel_inputs import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    label = args.label or root.name
    res = dict(label=label, root=str(root), card=card_line())
    print(f"[{label}] {res['card']}", flush=True)
    cfg = delay_8b()
    engine = demo_backend(cfg, seed=0, dtype=torch.bfloat16, device="cuda").engine
    heads = engine.params.audio_heads
    g = torch.Generator(device="cuda").manual_seed(1)
    for B in (1, 16):
        h = torch.randn((B, 1, cfg.language_config.hidden_size), generator=g,
                        device="cuda").to(torch.bfloat16)
        res[f"audio_heads_b{B}_device_ms"] = device_ms(lambda: td._audio_head_logits(h, heads))
        print(f"[{label}] audio heads B={B}: {res[f'audio_heads_b{B}_device_ms']:.4f} ms device "
              "per call", flush=True)
    pargs = argparse.Namespace(prompt=200, cache=512, attend=256, steps=16, top=5)
    for B in (1, 16):
        r = profile_step.profile_batch(engine, B, pargs, None)
        res[f"step_b{B}"] = {k: r[k] for k in ("step_wall_ms", "step_device_ms", "idle_share",
                                              "kernels_per_step")}
        print(f"[{label}] decode step B={B}: wall {r['step_wall_ms']:.2f} ms, device "
              f"{r['step_device_ms']:.2f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['kernels_per_step']:.0f} kernels", flush=True)
    for rep in (0, 1):
        r = serve(engine.params, cfg, DelayBatchServer, td.make_sampling,
                  chip_smoke.server_traffic)
        res[f"server_{rep}"] = r
        print(f"[{label}] server linear bf16 #{rep}: {r['steps']} steps, {r['frames']} frames "
              f"in {r['wall_s']:.2f} s = {r['frames_per_s']:.1f} frames/s "
              f"({r['ms_per_step']:.1f} ms/step)", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
