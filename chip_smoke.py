#!/usr/bin/env python3
"""Drive the PyTorch port's Delay TTS paths once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. device: the card's name and power limit; TF32 off.
2. build: nvcc builds the CUDA kernels from ``mosstts_tpu_torch/csrc``, one
   process per source, all started together.
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes (max error within tolerance; device time per call, from
   CUDA-graph replays so that host launch cost is left out; the plain
   version's time; ``F.scaled_dot_product_attention``'s where that one call
   computes the same function; the least time the card could take, from the
   bytes and operations this call's data needs), then the backbone and a
   greedy generate of a small float32 model on the card (kernels) against
   the same model on the CPU (plain versions).
3b. a 2-slot ``DelayBatchServer`` of that small model, 4 greedy requests:
   linear and paged grids on the card equal the CPU's, and on the card
   paged equals linear for the f32 and the int8 cache.
4. solo path at MOSS-TTS 8B width (``delay_8b()``, random bf16 weights made
   on the card, the ``codec_1p6b()`` codec in f32): three ``synthesize``
   requests and one greedy batch-4 ``DelayEngine.generate``.
5. continuous batching at the same width, reusing phase 4's weights: a
   16-slot ``DelayBatchServer`` serves 24 sampled requests (8 admitted
   mid-flight) in each cache mode: linear bf16, linear int8, paged bf16,
   paged int8.
The kernels' launch counts are set to 0 just before phase 4 and before each
mode of phase 5 and read just after, and must show every prefill and every
decode step went through the kernels.

Then one JSON line with the kernels' numbers, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device the
script raises before printing any result.
"""
from __future__ import annotations

import copy
import gc
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from mosstts_tpu_torch.core.config import DelayConfig, codec_1p6b, delay_8b, tiny_qwen3  # noqa: E402
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer  # noqa: E402
from mosstts_tpu_torch.engine.delay_engine import DelayEngine  # noqa: E402
from mosstts_tpu_torch.models.delay import make_sampling  # noqa: E402
from mosstts_tpu_torch.nn import qwen3  # noqa: E402
from mosstts_tpu_torch.ops.kernels import _build, decode_attn, flash, paged_attn  # noqa: E402
from mosstts_tpu_torch.serve.pipelines import demo_backend, synthesize  # noqa: E402
from mosstts_tpu_torch.tools.kernel_inputs import (  # noqa: E402
    bound, card_line, decode_bound, decode_inputs)

DEV = "cuda"
L8, B8, KV8, S8, HD8, H8 = 36, 4, 8, 512, 128, 32  # 8B layers / heads; batch 4, cache 512
BS, SS, PS = 16, 1024, 128  # the server's batch, capacity and page size at 8B width
# Tolerance, kernel vs plain, elementwise in bf16: both compute in f32 from the
# same bf16 inputs and round once to bf16, so their f32 results differ only
# by summation order (~1e-6) and may round one bf16 ulp (2^-7 relative)
# apart. Allow two ulps at the reference's magnitude plus 1e-5 for the
# summation error of results near zero.
REL_TOL, ABS_TOL = 2.0 ** -6, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int = 36, reps: int = 7) -> float:
    """Device time per call: ``n`` calls (call i gets i, so callers can
    rotate layers and keep L2 cold) captured in one CUDA graph, the median
    over ``reps`` replays timed with CUDA events. Launched one by one from
    Python, a call of a few microseconds would time the host's enqueue."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(out)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, rows=None) -> float:
    err = (out.float() - ref.float()).abs()
    bound = REL_TOL * ref.float().abs() + ABS_TOL
    if rows is not None:
        err, bound = err[rows], bound[rows]
    worst = float(err.max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {worst}")
    log(f"  {name}: max_abs_err={worst:.3e} (tol {REL_TOL:.4g}*|ref|+{ABS_TOL:g})")
    return worst


def library_ms(fn) -> float | None:
    """Device time of the one PyTorch call that computes the same function,
    or None (with the reason logged) where this PyTorch build refuses it."""
    try:
        return time_ms(fn)
    except RuntimeError as e:
        log(f"  (library call refused: {str(e).splitlines()[0]})")
        return None


def fmt_ms(ms) -> str:
    return "refused" if ms is None else f"{ms:.4f} ms"


def phase_kernels() -> dict:
    g = torch.Generator(device=DEV).manual_seed(0)
    bf = torch.bfloat16
    kc = torch.randn((L8, B8, KV8, S8, HD8), generator=g, device=DEV).to(bf)
    vc = torch.randn((L8, B8, KV8, S8, HD8), generator=g, device=DEV).to(bf)
    scale = HD8 ** -0.5

    # flash: B=4 left-padded prompts of T=160, kv-major over cache layers
    T = 160
    q = torch.randn((B8, T, H8, HD8), generator=g, device=DEV).to(bf)
    flash_err = 0.0
    for q_start, pads, layers in ((0, (0, 17, 40, 95), (0, 35)), (192, (0, 0, 5, 9), (35,))):
        valid = torch.zeros((B8, S8), dtype=torch.bool, device=DEV)
        for b, p in enumerate(pads):
            valid[b, p:q_start + T] = True
        rows = valid[:, q_start:q_start + T]  # queries at real positions
        for li in layers:
            args = (q, kc[li], vc[li], valid, q_start)
            out = flash.flash_attention(*args, scale=scale, kv_major=True)
            ref = flash.flash_attention_ref(*args, scale=scale, kv_major=True)
            flash_err = max(flash_err, check_close(
                f"flash q_start={q_start} layer={li}", out, ref, rows))
    # the server's admissions: one left-padded prompt of T=64 or 96 rows at
    # batch 1 and q_start 0 (a tensor, as qwen3_forward passes it); the
    # int8 caches attend the prompt's own (B, T, KV, hd) k/v, the bf16 ones
    # a kv-major linear cache of the server's 1024 slots
    zero = torch.zeros((), dtype=torch.int32, device=DEV)
    kc1, vc1 = (torch.randn((1, KV8, SS, HD8), generator=g, device=DEV).to(bf) for _ in "kv")
    for T1 in (64, 96):
        q1 = torch.randn((1, T1, H8, HD8), generator=g, device=DEV).to(bf)
        k1, v1 = (torch.randn((1, T1, KV8, HD8), generator=g, device=DEV).to(bf) for _ in "kv")
        valid1 = torch.zeros((1, SS), dtype=torch.bool, device=DEV)
        valid1[0, 11:T1] = True
        rows = valid1[:, :T1]
        for kv_major, k_all, v_all, valid_all in (
                (False, k1, v1, valid1[:, :T1]),
                (True, kc1, vc1, valid1)):
            args = (q1, k_all, v_all, valid_all, zero)
            out = flash.flash_attention(*args, scale=scale, kv_major=kv_major)
            ref = flash.flash_attention_ref(*args, scale=scale, kv_major=kv_major)
            flash_err = max(flash_err, check_close(
                f"flash B=1 T={T1} kv_major={kv_major}", out, ref, rows))
    valid = torch.zeros((B8, S8), dtype=torch.bool, device=DEV)
    for b, p in enumerate((0, 17, 40, 95)):
        valid[b, p:T] = True
    flash_ms = time_ms(lambda i: flash.flash_attention(
        q, kc[i % L8], vc[i % L8], valid, 0, scale=scale, kv_major=True))
    flash_plain_ms = time_ms(lambda i: flash.flash_attention_ref(
        q, kc[i % L8], vc[i % L8], valid, 0, scale=scale, kv_major=True))
    # the same function in one call: causal and left-pad mask as one boolean mask
    causal = torch.arange(S8, device=DEV)[None, :] <= torch.arange(T, device=DEV)[:, None]
    sdpa_mask = (causal[None] & valid[:, None, :])[:, None]  # (B, 1, T, S)
    qt = q.transpose(1, 2)
    flash_lib_ms = library_ms(lambda i: F.scaled_dot_product_attention(
        qt, kc[i % L8], vc[i % L8], attn_mask=sdpa_mask, scale=scale, enable_gqa=True))
    # bound: the keys each row needs (valid, before its last query) read once,
    # q read and the output written once; 4 * hd operations per (query, key) pair
    pairs = float((sdpa_mask[:, 0] & valid[:, :T, None]).sum())  # real queries only
    keys = float(valid[:, :T].sum())
    flash_bound = bound(2 * keys * KV8 * HD8 * 2 + 2 * q.numel() * 2 + valid.numel(),
                        4 * HD8 * H8 * pairs, bf)
    log(f"  flash B={B8} T={T} S={S8}: kernel {flash_ms:.4f} ms")
    log(f"  flash B={B8} T={T} S={S8}: plain {flash_plain_ms:.4f} ms")
    log(f"  flash B={B8} T={T} S={S8}: sdpa {fmt_ms(flash_lib_ms)}")
    log(f"  flash B={B8} T={T} S={S8}: bound {flash_bound['bound_ms']:.5f} ms "
        f"({flash_bound['bound_by']})")

    # decode: one token per row over the same cache; ragged attend lengths
    qd = torch.randn((B8, H8, HD8), generator=g, device=DEV).to(bf)
    valid = torch.rand((B8, S8), generator=g, device=DEV) < 0.7
    valid[:, 0] = True
    decode_err, decode_ms, decode_plain_ms = 0.0, {}, {}
    for a in (256, 512, 300):
        for li in (0, 35):
            args = (qd, kc, vc, valid, li)
            out = decode_attn.decode_attention(*args, scale=scale, attend_len=a)
            ref = decode_attn.decode_attention_ref(*args, scale=scale, attend_len=a)
            decode_err = max(decode_err, check_close(f"decode attend={a} layer={li}", out, ref))
        decode_ms[a] = time_ms(lambda i: decode_attn.decode_attention(
            qd, kc, vc, valid, i % L8, scale=scale, attend_len=a))
        decode_plain_ms[a] = time_ms(lambda i: decode_attn.decode_attention_ref(
            qd, kc, vc, valid, i % L8, scale=scale, attend_len=a))
        log(f"  decode B={B8} attend={a}: kernel {decode_ms[a]:.4f} ms")
        log(f"  decode B={B8} attend={a}: plain {decode_plain_ms[a]:.4f} ms")
    qs = qd[:, :, None]  # (B, H, 1, hd)
    dmask = valid[:, None, None, :256]
    decode_lib_ms = library_ms(lambda i: F.scaled_dot_product_attention(
        qs, kc[i % L8, :, :, :256], vc[i % L8, :, :, :256], attn_mask=dmask, scale=scale,
        enable_gqa=True))
    decode_bd = decode_bound(qd, valid, 256, KV8, HD8 * 2)
    log(f"  decode B={B8} attend=256: sdpa {fmt_ms(decode_lib_ms)}")
    log(f"  decode B={B8} attend=256: bound {decode_bd['bound_ms']:.5f} ms "
        f"({decode_bd['bound_by']})")
    torch.cuda.synchronize()
    return {
        "flash": dict(max_abs_err=flash_err, ms=flash_ms, plain_ms=flash_plain_ms,
                      library_ms=flash_lib_ms, **flash_bound),
        "decode": dict(max_abs_err=decode_err, ms=decode_ms[256], plain_ms=decode_plain_ms[256],
                       library_ms=decode_lib_ms, **decode_bd),
    }


def phase_kernels_server() -> dict:
    """The four decode kernels at the server's 8B shapes
    (``tools/kernel_inputs.decode_inputs``): B=16 rows, KV=8, H=32, hd=128,
    capacity 1024, attend 256, 512 and 1024; int8 values and scales from the
    port's cache quantizer; a shuffled page table with P=128 whose rows
    leave 0-3 tail pages unallocated (on the poisoned trash page 0, masked
    by kv_valid). The linear bf16 kernel's numbers come back as
    ``decode_b16``."""
    scale = HD8 ** -0.5
    q, valid, kernels = decode_inputs(BS, seed=1)
    numbers = {}
    for name, (kernel, plain, args, row_bytes, extra) in kernels.items():
        err, ms, plain_ms = 0.0, {}, {}
        for a in (256, 512, 1024):
            for li in (0, L8 - 1):
                out = kernel(*args(li), scale=scale, attend_len=a)
                ref = plain(*args(li), scale=scale, attend_len=a)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name}: non-finite output")
                err = max(err, check_close(f"{name} B={BS} attend={a} layer={li}", out, ref))
            ms[a] = time_ms(lambda i: kernel(*args(i % L8), scale=scale, attend_len=a))
            plain_ms[a] = time_ms(lambda i: plain(*args(i % L8), scale=scale, attend_len=a))
            log(f"  {name} B={BS} attend={a}: kernel {ms[a]:.4f} ms")
            log(f"  {name} B={BS} attend={a}: plain {plain_ms[a]:.4f} ms")
        bd = decode_bound(q, valid, 256, KV8, row_bytes, extra)
        log(f"  {name} B={BS} attend=256: bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
        numbers[name] = dict(max_abs_err=err, ms=ms[256], plain_ms=plain_ms[256],
                             library_ms=None, **bd)
    # the linear bf16 kernel has one call that computes the same function
    kc, vc = kernels["decode"][2](0)[1:3]
    dmask = valid[:, None, None, :256]
    numbers["decode"]["library_ms"] = library_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kc[i % L8, :, :, :256], vc[i % L8, :, :, :256], attn_mask=dmask,
        scale=scale, enable_gqa=True))
    log(f"  decode B={BS} attend=256: sdpa {fmt_ms(numbers['decode']['library_ms'])}")
    numbers["decode_b16"] = numbers.pop("decode")
    torch.cuda.synchronize()
    return numbers


def phase_small_reference() -> None:
    """A small float32 model (head dim 128, so the kernels dispatch) on the
    card against the same weights on the CPU, where the plain versions run."""
    cfg = DelayConfig(language_config=tiny_qwen3(
        hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128), n_vq=4)
    cpu_backend = demo_backend(cfg, seed=1, dtype=torch.float32, device="cpu", cache_bucket=64)
    cpu, proc = cpu_backend.engine, cpu_backend.processor
    gpu = DelayEngine(copy.deepcopy(cpu.params).to(DEV), cfg, dtype=torch.float32,
                      device=DEV, cache_bucket=64)
    lc = cfg.language_config
    rng = np.random.default_rng(0)
    B, T, S = 2, 40, 64
    x = torch.tensor(rng.normal(size=(B, T, lc.hidden_size)).astype(np.float32))
    valid = torch.zeros((B, S), dtype=torch.bool)
    valid[0, :T], valid[1, 9:T] = True, True
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    outs = {}
    for dev, eng in (("cpu", cpu), (DEV, gpu)):
        cache = qwen3.init_kv_cache(lc, B, S, dtype=torch.float32, device=dev)
        h, _ = qwen3.qwen3_forward(eng.params.backbone, lc, x.to(dev), positions=pos.to(dev),
                                   kv_valid=valid.to(dev), cache=cache, cache_offset=0)
        v1 = valid.clone()
        v1[:, T] = True
        h1, _ = qwen3.qwen3_forward(
            eng.params.backbone, lc, x[:, -1:].to(dev) * 0.5, kv_valid=v1.to(dev),
            positions=torch.full((B, 1), T, dtype=torch.int32, device=dev), cache=cache,
            cache_offset=torch.tensor(T, dtype=torch.int32, device=dev), attend_len=T + 8)
        outs[dev] = (h.cpu(), h1.cpu())
    rows = valid[:, :T]
    err = max(float((outs[DEV][0] - outs["cpu"][0]).abs()[rows].max()),
              float((outs[DEV][1] - outs["cpu"][1]).abs().max()))
    if not err <= 1e-4:  # float32 on both sides: summation order only
        raise AssertionError(f"small backbone, card vs CPU: max abs err {err}")
    log(f"  small f32 backbone prefill+decode, card (kernels) vs CPU (plain): "
        f"max_abs_err={err:.3e} (tol 1e-4)")

    codes = rng.integers(0, 1024, size=(7, cfg.n_vq))
    convs = [[proc.build_user_message(text=t), proc.build_assistant_message([codes[:n]])]
             for t, n in (("one", 7), ("a longer second prompt", 4))]
    batch = proc(convs, mode="continuation")
    kw = dict(max_new_tokens=24, text_temperature=0.0, audio_temperature=0.0)
    a = cpu.generate(batch["input_ids"], batch["attention_mask"], **kw)
    b = gpu.generate(batch["input_ids"], batch["attention_mask"], **kw)
    for (la, ga), (lb, gb) in zip(a, b):
        if la != lb or not np.array_equal(ga, gb):
            raise AssertionError("small greedy generate: card grid differs from CPU grid")
    log(f"  small f32 greedy generate (B=2, continuation, 24 frames): card grid == CPU grid")


SMALL_CFG = DelayConfig(language_config=tiny_qwen3(
    hidden_size=256, intermediate_size=512, num_attention_heads=4, num_key_value_heads=2,
    head_dim=128), n_vq=4)


def phase_small_server() -> None:
    """A 2-slot server of the small f32 model (head dim 128, so the kernels
    dispatch) with the same weights on the card and on the CPU: 4 greedy
    continuation requests, two admitted mid-flight. The page pool is the
    default 60% of the linear footprint, so pages are recycled."""
    cfg = SMALL_CFG
    cpu_backend = demo_backend(cfg, seed=2, dtype=torch.float32, device="cpu")
    cpu_params, proc = cpu_backend.engine.params, cpu_backend.processor
    gpu_params = copy.deepcopy(cpu_params).to(DEV)
    rng = np.random.default_rng(3)
    grids = []
    for i in range(4):
        codes = rng.integers(0, 1024, size=(6, cfg.n_vq))
        conv = [proc.build_user_message(text=f"server request {i}"),
                proc.build_assistant_message([codes])]
        grids.append(proc([conv], mode="continuation")["input_ids"][0])

    def serve(params, dev, **mode):
        srv = DelayBatchServer(params, cfg, slots=2, cache_len=256, out_capacity=64,
                               prompt_bucket=32, dtype=torch.float32, page_size=64,
                               sampling=make_sampling(text_temperature=0.0,
                                                      audio_temperature=0.0, device=dev),
                               **mode)
        rids = [srv.submit(g, max_new_tokens=24) for g in grids]
        done = {c.request_id: c for c in srv.run(max_steps=1000)}
        if sorted(done) != sorted(rids):
            raise AssertionError(f"small server {mode}: requests {rids}, completed {sorted(done)}")
        return [(done[r].start_length, done[r].tokens) for r in rids], srv.total_preemptions

    def same(a, b) -> bool:
        return all(la == lb and np.array_equal(ga, gb) for (la, ga), (lb, gb) in zip(a, b))

    results = {}
    for name, mode in (("linear", {}), ("paged", dict(paged=True)),
                       ("linear int8", dict(kv_quant=True)),
                       ("paged int8", dict(paged=True, kv_quant=True))):
        results[name] = serve(gpu_params, DEV, **mode)
    for name in ("linear", "paged"):
        cpu = serve(cpu_params, "cpu", **({"paged": True} if name == "paged" else {}))
        if not same(results[name][0], cpu[0]):
            raise AssertionError(f"small f32 server, {name}: card grids differ from CPU grids")
        log(f"  small f32 server ({name}, 2 slots, 4 greedy requests): card grids == CPU grids")
    for lin, pag in (("linear", "paged"), ("linear int8", "paged int8")):
        if not same(results[lin][0], results[pag][0]):
            raise AssertionError(f"small server on the card: {pag} grids differ from {lin}")
        log(f"  small server on the card: {pag} grids == {lin} grids "
            f"({results[pag][1]} preemptions)")


COUNTERS = {  # kernel name -> (module, attribute) of its launch count
    "flash": (flash, "LAUNCHES"),
    "decode": (decode_attn, "LAUNCHES"),
    "decode_q8": (decode_attn, "LAUNCHES_Q8"),
    "paged": (paged_attn, "LAUNCHES"),
    "paged_q8": (paged_attn, "LAUNCHES_Q8"),
}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def phase_main_path():
    cfg = delay_8b()
    t0 = time.perf_counter()
    backend = demo_backend(cfg, codec_1p6b(), seed=0, dtype=torch.bfloat16, device=DEV)
    engine, proc = backend.engine, backend.processor
    torch.cuda.synchronize()
    log(f"  init on card: delay_8b bf16 + codec_1p6b f32 in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    calls = []
    generate = engine.generate

    def recorded_generate(input_ids, attention_mask=None, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(input_ids, attention_mask, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        frames = out[0][1].shape[0] - out[0][0]  # generated frames (first from the prefill)
        calls.append(dict(batch=len(out), prompt=int(np.shape(input_ids)[1]),
                          frames=int(frames), wall_s=wall))
        return out

    engine.generate = recorded_generate
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    for i, (text, seed) in enumerate((("Hello from the port on a GPU.", 1),
                                      ("The quick brown fox jumps over the lazy dog.", 2),
                                      ("Speech synthesis at eight billion parameters.", 3))):
        t = time.perf_counter()
        sr, wav, _ = synthesize(backend, text, max_new_tokens=112, seed=seed)
        if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()):
            raise AssertionError(f"synthesize #{i}: bad waveform {wav.shape}")
        c = calls[-1]
        log(f"  synthesize #{i}: prompt {c['prompt']} tokens, {c['frames']} frames, "
            f"wave {wav.size / sr:.2f} s at {sr} Hz, request {time.perf_counter() - t:.2f} s, "
            f"generate {c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s)")

    prompts = ["Hi.", "A longer second prompt for the batch.", "Third.",
               "The fourth and longest prompt of this batch of four requests."]
    batch = proc([[proc.build_user_message(text=p)] for p in prompts], mode="generation")
    if batch["attention_mask"].all():
        raise AssertionError("expected left-padded prompts")
    out = engine.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=96,
                          text_temperature=0.0, audio_temperature=0.0)
    for start, grid in out:
        if grid.shape != (start + calls[-1]["frames"], cfg.channels) or grid.min() < 0:
            raise AssertionError(f"bad grid {grid.shape}")
    c = calls[-1]
    log(f"  generate B=4 greedy: prompt {c['prompt']} tokens, {c['frames']} frames/row, "
        f"{c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s)")
    torch.cuda.synchronize()
    counts = read_counts()

    L = cfg.language_config.num_hidden_layers
    prefills = len(calls)
    steps = sum(c["frames"] - 1 for c in calls)
    if counts["flash"] < L * prefills or counts["decode"] < L * steps:
        raise AssertionError(f"launch counts {counts} below {L} x {prefills} prefills / "
                             f"{L} x {steps} decode steps")
    log(f"  launches: flash {counts['flash']} for {prefills} prefills (>= {L} each), "
        f"decode {counts['decode']} for {steps} decode steps (>= {L} each)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, engine.params


SERVER_MODES = (  # name, DelayBatchServer options, the decode kernel it runs
    ("linear bf16", {}, "decode"),
    ("linear int8", dict(kv_quant=True), "decode_q8"),
    ("paged bf16", dict(paged=True), "paged"),
    ("paged int8", dict(paged=True, kv_quant=True), "paged_q8"),
)


def server_traffic(cfg, n: int = 24, seed: int = 0):
    """The JAX benchmark's batch-server load (``bench.py:684-696``): random
    prompt grids of 48-96 rows ending in the gen-slot token, budgets drawn
    from 48-96 frames."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        T = int(rng.integers(48, 96))
        grid = rng.integers(0, 1000, (T, cfg.channels))
        grid[:, 1:] = rng.integers(0, 1024, (T, cfg.n_vq))
        grid[-1, 0] = cfg.audio_assistant_gen_slot_token_id
        prompts.append(grid)
    return prompts, [int(x) for x in rng.integers(48, 96, n)]


def phase_server(params) -> dict:
    """``DelayBatchServer(slots=16, cache_len=1024, out_capacity=128,
    prompt_bucket=32, page_size=128)`` over phase 4's 8B weights, one cache
    mode at a time: 24 requests into 16 slots, sampled at text and audio
    temperature 1.7, audio top-p 0.8."""
    cfg = delay_8b()
    L = cfg.language_config.num_hidden_layers
    prompts, budgets = server_traffic(cfg)
    counts = {}
    for name, mode, kernel in SERVER_MODES:
        server = DelayBatchServer(
            params, cfg, slots=BS, cache_len=SS, out_capacity=128, prompt_bucket=32,
            page_size=PS, dtype=torch.bfloat16,
            sampling=make_sampling(text_temperature=1.7, audio_temperature=1.7,
                                   audio_top_p=0.8, device=DEV), **mode)
        t = time.perf_counter()
        server.warmup(prompt_lens=(64, 96), attend_upto=256)
        warm_s = time.perf_counter() - t
        server.total_steps, server.util_sum, server.total_preemptions = 0, 0.0, 0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        rids = {server.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        mode_counts = read_counts()
        if sorted(c.request_id for c in done) != sorted(rids):
            raise AssertionError(f"server {name}: {len(done)} of {len(rids)} requests completed")
        for c in done:
            if (c.tokens.ndim != 2 or c.tokens.shape[1] != cfg.channels
                    or c.tokens.shape[0] != c.start_length + c.steps or c.tokens.min() < 0
                    or not 0 < c.steps <= rids[c.request_id]):
                raise AssertionError(f"server {name}: malformed grid {c.tokens.shape}, "
                                     f"{c.steps} steps for budget {rids[c.request_id]}")
        steps, admissions = server.total_steps, len(rids) + server.total_preemptions
        if mode_counts[kernel] < L * steps or mode_counts["flash"] < L * admissions:
            raise AssertionError(f"server {name}: launch counts {mode_counts} below {L} x "
                                 f"{steps} steps ({kernel}) / {L} x {admissions} prefills (flash)")
        frames = sum(min(c.steps, rids[c.request_id]) for c in done)
        kv_bytes = sum(t.numel() * t.element_size() for t in server.state.cache if t.ndim > 2)
        log(f"  server {name}: {len(done)} requests, {steps} steps, {frames} frames in "
            f"{wall:.2f} s = {frames / wall:.1f} frames/s ({wall / steps * 1e3:.1f} ms/step), "
            f"mean utilization {server.util_sum / steps:.3f}, "
            f"{server.total_preemptions} preemptions, KV cache {kv_bytes / 2**30:.3f} GiB, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(warmup {warm_s:.2f} s)")
        log(f"  server {name}: launches {kernel} {mode_counts[kernel]} (>= {L} x {steps}), "
            f"flash {mode_counts['flash']} (>= {L} x {admissions})")
        counts[name] = mode_counts
        del server, done
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def main() -> None:
    log("phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products, as the JAX package
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = torch.cuda.get_device_name(0)
    log(f"  {name}; nvidia-smi: {card_line()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off")

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    flash._entry()
    for entry in ("mosstts_decode_attention", "mosstts_decode_attention_q8",
                  "mosstts_paged_decode_attention", "mosstts_paged_decode_attention_q8"):
        decode_attn._entry(entry)
    log(f"  {lib.relative_to(Path(__file__).resolve().parent)} in "
        f"{time.perf_counter() - t0:.2f} s")

    log("phase 3: kernels vs plain (bf16, main-path shapes) and a small f32 reference")
    numbers = phase_kernels()
    numbers.update(phase_kernels_server())
    # decode's line keeps its B=4 times (PR 1's shape) and the worse error of both shapes
    numbers["decode"]["max_abs_err"] = max(numbers["decode"]["max_abs_err"],
                                           numbers.pop("decode_b16")["max_abs_err"])
    phase_small_reference()
    log("phase 3b: small f32 continuous-batching server, card vs CPU and paged vs linear")
    phase_small_server()

    log("phase 4: solo path at MOSS-TTS 8B width")
    solo_counts, params = phase_main_path()
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 5: continuous batching at MOSS-TTS 8B width")
    server_counts = phase_server(params)

    launches = {name: solo_counts[name] + sum(c[name] for c in server_counts.values())
                for name in COUNTERS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched on the main paths: {launches}")
    kernels = [
        dict(name="flash_attention", route="cuda", source="mosstts_tpu_torch/csrc/flash_attn.cu",
             replaces="mosstts_tpu/ops/pallas/flash.py:83", launches=launches["flash"],
             **numbers["flash"]),
        dict(name="decode_attention", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:189", launches=launches["decode"],
             **numbers["decode"]),
        dict(name="decode_attention_q8", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:250",
             launches=launches["decode_q8"], **numbers["decode_q8"]),
        dict(name="paged_decode_attention", route="cuda",
             source="mosstts_tpu_torch/csrc/paged_attn.cu",
             replaces="mosstts_tpu/ops/pallas/paged_attn.py:180", launches=launches["paged"],
             **numbers["paged"]),
        dict(name="paged_decode_attention_q8", route="cuda",
             source="mosstts_tpu_torch/csrc/paged_attn.cu",
             replaces="mosstts_tpu/ops/pallas/paged_attn.py:243",
             launches=launches["paged_q8"], **numbers["paged_q8"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
