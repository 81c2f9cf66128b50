"""The continuous-batching server's admission and step times for the
``mosstts_tpu_torch`` of any checkout, so that two commits can be compared
on one NVIDIA GPU.

    python3 mosstts_tpu_torch/tools/admission_path.py --root DIR [--label NAME]

Run it as a file: it imports ``mosstts_tpu_torch`` and ``chip_smoke`` from
``--root``, a checkout (e.g. an archive of another commit unpacked under the
git-ignored ``build/``), so the same script measures either tree. At
``delay_8b()`` width with random weights (seed 0) quantized to int8
(``engine.quantize()``), in one process, on a 16-slot ``DelayBatchServer``
with a linear bf16 KV cache (the smoke's phase 5 options: cache_len 1024,
prompt bucket 32), warmed up at the prompt lengths 64, 96 and 200:

- the admission of a 200-row prompt (its batch-1 prefill at bucket 224 and
  the splice into a slot, ``_admit``), warm: the median of 9 of the wall
  time to the device's end (host clock) and of the device time between two
  CUDA events (``timed``, which ``chip_smoke.py`` phase 9a uses too);
- admissions of prompts of mixed lengths, each on a fresh server, one
  after another, each timed alone (host clock, to the device's end, and
  to the host's return from ``_admit``):
  ``spread``, 96 lengths uniform in [40, 960] (29 prompt buckets, most of
  them new to the server, so many admissions are a bucket's first or
  second use), and ``clone``, 96 voice-cloning prompts (a 30-row template,
  20-120 text tokens, a reference of 3-12 s at 12.5 frames/s: 7 buckets).
  Where the tree has prefill graphs, also how the admissions ran
  (``Prefills.counts``: eager first uses, captures, replays of a graph
  already captured) and the hit rate (replays / admissions);
- twice, the smoke's 24 requests (``chip_smoke.server_traffic``) through
  ``run()``: useful frames/s and ms per server step, host clock.

One JSON line last. Host clocks move between machines and runs: compare two
trees only within one call, alternating their order (A B B A).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

N = 9  # warm admissions timed
MIXED = 96  # admissions of each mixed-length load


def prompt_grid(cfg, T: int, seed: int) -> np.ndarray:
    """A random T-row prompt grid ending in the gen-slot token."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1000, (T, cfg.channels))
    g[:, 1:] = rng.integers(0, 1024, (T, cfg.n_vq))
    g[-1, 0] = cfg.audio_assistant_gen_slot_token_id
    return g


def timed(fn, n: int = N):
    """Median wall (host clock, to the device's end) and median device time
    (CUDA events) of ``n`` calls of ``fn``, in ms."""
    walls, device = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        device.append(start.elapsed_time(end))
    return float(np.median(walls)), float(np.median(device))


def mixed_lengths(load: str, n: int = MIXED, seed: int = 11) -> list:
    """The prompt lengths of a mixed-length load (see the module docstring)."""
    rng = np.random.default_rng(seed)
    if load == "spread":
        return [int(t) for t in rng.integers(40, 961, n)]
    text = rng.integers(20, 121, n)
    frames = np.round(12.5 * rng.uniform(3.0, 12.0, n)).astype(int)
    return [int(t) for t in 30 + text + frames]


def admit_each(srv, cfg, lengths, seed: int) -> dict:
    """Admit a prompt of each of ``lengths`` into slot 0 of the idle
    ``srv``, one after another (a seeded sampled request each), each timed
    alone from the queue to the device's end (and to ``_admit``'s return:
    the host's issue time); the slot is freed after each."""
    walls, issues = [], []
    for i, T in enumerate(lengths):
        srv.submit(prompt_grid(cfg, T, seed + i), max_new_tokens=48, seed=seed + i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv._admit(0, srv._queue.pop(0))
        issues.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        srv._active.clear()
    prefills = getattr(srv, "_prefills", None)
    counts = dict(prefills.counts) if prefills is not None else None
    buckets = {-(-T // srv.prompt_bucket) for T in lengths}
    return dict(admissions=len(lengths), buckets=len(buckets), total_s=sum(walls) / 1e3,
                median_ms=float(np.median(walls)), p90_ms=float(np.percentile(walls, 90)),
                max_ms=max(walls), counts=counts,
                hit_rate=None if counts is None else counts["replay"] / len(lengths),
                walls_ms=walls, issue_ms=issues)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, required=True, help="the checkout to measure")
    ap.add_argument("--label", default=None, help="a name for the tree in the output")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this tool times a GPU")
    import chip_smoke
    from mosstts_tpu_torch.core.config import delay_8b
    from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
    from mosstts_tpu_torch.models.delay import make_sampling
    from mosstts_tpu_torch.serve.pipelines import demo_backend
    from mosstts_tpu_torch.tools.kernel_inputs import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = args.label or root.name
    res = dict(label=label, root=str(root), card=card_line())
    print(f"[{label}] {res['card']}", flush=True)
    cfg = delay_8b()
    engine = demo_backend(cfg, seed=0, dtype=torch.bfloat16, device="cuda").engine
    engine.quantize()

    def server():
        srv = DelayBatchServer(engine.params, cfg, slots=16, cache_len=1024, out_capacity=128,
                               prompt_bucket=32, page_size=128, dtype=torch.bfloat16,
                               sampling=make_sampling(text_temperature=1.7,
                                                      audio_temperature=1.7, audio_top_p=0.8,
                                                      device="cuda"))
        srv.warmup(prompt_lens=(64, 96, 200), attend_upto=256)
        return srv

    srv = server()
    grid = prompt_grid(cfg, 200, 35)

    def admit():  # as serving admits: from the queue into a free slot
        srv.submit(grid, max_new_tokens=48, seed=35)
        srv._admit(0, srv._queue.pop(0))

    admit()  # warm
    wall, device = timed(admit)
    res["admission_t200"] = dict(wall_ms=wall, device_ms=device)
    print(f"[{label}] admission of a 200-row prompt, warm, median of {N}: wall {wall:.2f} ms, "
          f"device {device:.2f} ms", flush=True)
    del srv
    for load in ("spread", "clone"):
        srv = server()
        lengths = mixed_lengths(load)
        r = res[f"admissions_{load}"] = admit_each(srv, cfg, lengths, seed=100)
        print(f"[{label}] {load} load: {r['admissions']} admissions of {min(lengths)}-"
              f"{max(lengths)} rows over {r['buckets']} prompt buckets: total "
              f"{r['total_s']:.3f} s, median {r['median_ms']:.2f} ms, p90 {r['p90_ms']:.2f} ms, "
              f"max {r['max_ms']:.2f} ms; prefill runs {r['counts']}, hit rate {r['hit_rate']}",
              flush=True)
        del srv
    prompts, budgets = chip_smoke.server_traffic(cfg)
    for rep in (0, 1):
        srv = server()
        srv.total_steps, srv.util_sum, srv.total_preemptions = 0, 0.0, 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        rids = {srv.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if sorted(c.request_id for c in done) != sorted(rids):
            raise AssertionError(f"server: {len(done)} of {len(rids)} requests completed")
        frames = sum(min(c.steps, rids[c.request_id]) for c in done)
        r = dict(steps=srv.total_steps, frames=frames, wall_s=wall, frames_per_s=frames / wall,
                 ms_per_step=wall / srv.total_steps * 1e3)
        res[f"server_{rep}"] = r
        print(f"[{label}] server int8 weights, linear bf16 KV #{rep}: {r['steps']} steps, "
              f"{r['frames']} frames in {r['wall_s']:.2f} s = {r['frames_per_s']:.1f} frames/s "
              f"({r['ms_per_step']:.2f} ms/step)", flush=True)
        del srv
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
