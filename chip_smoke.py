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
6. int8 weights at the same width: phase 4's engine keeps one batch-4
   prefill's logits in bf16, is quantized in place (``engine.quantize()``),
   and its int8 logits for the same prefill must agree with the same int8
   model computed by the plain versions on the card, and stay correlated
   with the bf16 logits (``phase_int8`` says why not as closely as the
   2-layer check of phase 3); then phase 4's solo requests and phase 5's
   server in the linear bf16 and the paged int8 KV modes run on the int8
   weights, every matmul through the W8A16 kernel.
The kernels' launch counts are set to 0 just before phases 4 and 6 and each
server mode and read just after, and must show every prefill and every
decode step went through the kernels. Phase 3 adds the int8-weight GEMMs
(W8A16 at the 8B decode and prefill shapes, W8A8 and int4 at their tools'
shapes, each tool's walk driven once) and ``decode_attention_q8t`` (bf16
and f32 scales), and a small int8-weight model, card against CPU, and its
int8 against its bf16 weights on the card and on the CPU
(``tests/test_quant.py``'s thresholds, at the rows with a clear argmax).

Then one JSON line with the kernels' numbers, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device the
script raises before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
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
from mosstts_tpu_torch.models.delay import delay_forward  # noqa: E402
from mosstts_tpu_torch.nn import qwen3  # noqa: E402
from mosstts_tpu_torch.ops.kernels import _build, decode_attn, flash, paged_attn, w8_gemm  # noqa: E402
from mosstts_tpu_torch.ops.quant import is_quantized  # noqa: E402
from mosstts_tpu_torch.serve.pipelines import demo_backend, synthesize  # noqa: E402
from mosstts_tpu_torch.tools import probe_int4, tune_mm8  # noqa: E402
from mosstts_tpu_torch.tools.kernel_inputs import (  # noqa: E402
    bound, card_line, decode_bound, decode_inputs, gemm_bound, time_ms)

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


def library_ms(fn, n: int = 36) -> float | None:
    """Device time of the one PyTorch call that computes the same function,
    or None (with the reason logged) where this PyTorch build refuses it."""
    try:
        return time_ms(fn, n=n)
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


# Tolerance, GEMM kernel vs plain: both sum exact products in float32, in
# another order (the difference stays far under 1e-4 of the sum of the terms'
# magnitudes, ``absref``), and a bf16 output may round one ulp (2^-7) apart.
# Relative to the result alone would fail where a sum cancels to near zero.
GEMM_TOL = 1e-4


def check_gemm(name: str, out, ref, absref) -> float:
    err = (out.float() - ref.float()).abs()
    ulp = 2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0
    worst = float(err.max())
    if not bool((err <= ulp * ref.float().abs() + GEMM_TOL * absref + 1e-6).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {worst}")
    log(f"  {name}: max_abs_err={worst:.3e} (tol {ulp:g}*|ref|+{GEMM_TOL:g}*sum|terms|+1e-6)")
    return worst


def library_agrees(name: str, x, w, w_lib) -> None:
    """Log how far ``torch._weight_int8pack_mm`` on the library's layout
    ``w_lib`` lies from the plain W8A16 version on ``w``: the same int8
    values, but the library rounds the scales and its output to bf16, so
    this is a reading of the yardstick, not a check of a kernel."""
    got = torch._weight_int8pack_mm(x, *w_lib).float()
    ref = w8_gemm.w8a16_gemm_ref(x, *w, torch.float32).reshape(got.shape)
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"  {name}: torch._weight_int8pack_mm vs plain W8A16, max abs difference {rel:.2e} "
        f"of the largest output (its scales and output in bf16)")


GEMM_8B = (  # name, K, N, stacked count (0: one (K, N) per layer), output dtype
    ("wq", 4096, 4096, 0, torch.bfloat16),
    ("wk", 4096, 1024, 0, torch.bfloat16),
    ("w_gate", 4096, 12288, 0, torch.bfloat16),
    ("w_down", 12288, 4096, 0, torch.bfloat16),
    ("text_head", 4096, 151936, 0, torch.bfloat16),
    ("audio_heads", 4096, 1025, 32, torch.float32),
)


def phase_kernels_gemm() -> dict:
    """The int8-weight GEMMs. W8A16 at the 8B model's decode (M = 1, 16) and
    prefill (M = 96, 640) shapes over random int8 layer stacks (36 layers of
    each backbone weight, so call i reads layer i % 36 cold from device
    memory, as a decode step does), the text head and the 32-head audio stack
    (f32 out); beside each, PyTorch's own int8 weight-only GEMM
    ``torch._weight_int8pack_mm`` on the same int8 values (the yardstick:
    its CUDA op takes the weights as (N, K), transposed once outside the
    timing, and the scales and the output in x's dtype, bf16), and the bf16
    ``torch.matmul`` of the same shape, what the bf16 path pays. W8A16 with
    unit scales, W8A8 and int4 at their tools' shapes
    (``tools/probe_int4.py``, ``tools/tune_mm8.py``), with
    ``torch._weight_int8pack_mm`` and ``torch._int_mm`` as yardsticks;
    each tool's walk is then driven once with the counts at 0, and those
    are their launches. ``decode_attention_q8t`` runs one call per layer of
    an 8B step at the server's B=16 with bf16 scales, for its launches (its
    kernel checks are in ``phase_kernels_server``)."""
    g = torch.Generator(device=DEV).manual_seed(5)
    bf = torch.bfloat16
    numbers, err16 = {}, 0.0
    for name, K, N, count, out_dtype in GEMM_8B:
        L = 1 if name.endswith("head") or count else L8
        shape = ((count,) if count else (L,)) + (K, N)
        q = torch.empty(shape, dtype=torch.int8, device=DEV).random_(-127, 128, generator=g)
        sc = torch.rand(shape[:-2] + (N,), generator=g, device=DEV) * 0.019 + 0.001
        # the bf16 weights of the same shape; enough layers to leave L2 cold
        nb = 1 if count or L == 1 else min(L8, max(2, -(-200_000_000 // (K * N * 2))))
        wb = torch.randn((nb, count or 1, K, N) if count else (nb, K, N), generator=g,
                         device=DEV).to(bf)
        # the library's layout: (N, K) int8 (the audio stack as one (count * N, K)
        # weight, so one call), bf16 scales
        qt = (q.permute(0, 2, 1).reshape(count * N, K) if count else q.transpose(1, 2)).contiguous()
        sb = sc.reshape(-1).to(bf)
        if count:  # one call over the whole stack
            pick, lib_pick = (lambda i: (q, sc)), (lambda i: (qt, sb))
        else:
            pick = (lambda i, q=q, sc=sc, L=L: (q[i % L], sc[i % L]))
            lib_pick = (lambda i, L=L: (qt[i % L], sb.view(L, N)[i % L]))
        Ms = (1, 16) + ((96, 640) if name in ("wq", "wk", "w_gate", "w_down") else ())
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=DEV).to(bf)
            for li in ((0, L - 1) if L > 1 else (0,)):
                qi, si = pick(li)
                out = w8_gemm.w8a16_gemm(x, qi, si, out_dtype)
                ref = w8_gemm.w8a16_gemm_ref(x, qi, si, out_dtype)
                absref = w8_gemm.w8a16_gemm_ref(x.abs(), qi.abs(), si, torch.float32)
                err16 = max(err16, check_gemm(f"w8a16 {name} M={M} layer={li}", out, ref, absref))
                del out, ref, absref
            n = 36 if qi.numel() < 2e8 else 8
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, *pick(i), out_dtype), n=n)
            plain_ms = time_ms(lambda i: w8_gemm.w8a16_gemm_ref(x, *pick(i), out_dtype), n=n)
            if count:
                bf16_ms = time_ms(lambda i: torch.bmm(x.expand(count, M, K), wb[0],
                                                      out_dtype=torch.float32), n=n)
            else:
                bf16_ms = time_ms(lambda i: torch.matmul(x, wb[i % nb]), n=n)
            lib_ms = library_ms(lambda i: torch._weight_int8pack_mm(x, *lib_pick(i)),
                                n=n if M <= 16 else 8)
            bd = gemm_bound(M, K, N, count=count or 1,
                            out_bytes=4 if out_dtype == torch.float32 else 2)
            log(f"  w8a16 {name} M={M} K={K} N={N}{f' x{count}' if count else ''}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._weight_int8pack_mm "
                f"{fmt_ms(lib_ms)}, bf16 matmul (what the bf16 path pays) {bf16_ms:.4f} ms, "
                f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}), "
                f"{(count or 1) * K * N / ms / 1e6:.0f} GB/s of int8 weights")
            if lib_ms is not None and M == 16:
                library_agrees(f"w8a16 {name} M={M}", x, pick(0), lib_pick(0))
            if name == "w_gate" and M == 16:
                numbers["w8a16"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)
        del q, sc, wb, qt, sb
        torch.cuda.empty_cache()
    numbers["w8a16"]["max_abs_err"] = err16

    # W8A8 at tools/tune_mm8.py's defaults: B=128, 16 layers of (4096, 12288)
    x, w8, scale = tune_mm8.make_inputs(128, 16, 4096, 12288)
    err = 0.0
    for li in (0, 15):
        out = w8_gemm.w8a8_gemm(x, w8[li], scale[li])
        ref = w8_gemm.w8a8_gemm_ref(x, w8[li], scale[li])
        x8, xs = w8_gemm.quant_rows(x)
        absref = w8_gemm.w8a16_gemm_ref(x8.abs().to(bf), w8[li].abs(), scale[li],
                                        torch.float32) * xs
        err = max(err, check_gemm(f"w8a8 B=128 layer={li}", out, ref, absref))
    ms = time_ms(lambda i: w8_gemm.w8a8_gemm(x, w8[i % 16], scale[i % 16]))
    plain_ms = time_ms(lambda i: w8_gemm.w8a8_gemm_ref(x, w8[i % 16], scale[i % 16]), n=8)
    x8 = w8_gemm.quant_rows(x)[0]
    lib_ms = library_ms(lambda i: torch._int_mm(x8, w8[i % 16]))
    bd = gemm_bound(128, 4096, 12288, out_bytes=4, ops_dtype=torch.int8)
    log(f"  w8a8 B=128 D=4096 O=12288: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch._int_mm {fmt_ms(lib_ms)}, bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    numbers["w8a8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)
    reset_counts()
    walk = tune_mm8.mm8_w8a8(x, w8, scale)
    launches = read_counts()
    rel = tune_mm8.rel_err(walk, tune_mm8.xla_ref(x, w8, scale))
    log(f"  tools/tune_mm8 mm8_w8a8 walk (16 layers): {launches['w8a8']} launches; "
        f"max rel difference from the plain W8A16 walk {rel:.2e} (not a check: the tool's "
        f"tanh chain amplifies any rounding difference from layer to layer)")
    numbers["w8a8"]["launches"] = launches["w8a8"]
    del x, w8, scale, x8
    torch.cuda.empty_cache()

    # tools/probe_int4.py's shapes: B=64, D=4096, O=12288, 16 layers. Its
    # mm8_pallas is W8A16 with unit scales and f32 output
    x, w8, packed = probe_int4.make_inputs()
    ones = torch.ones(12288, device=DEV)
    w8t = w8.transpose(1, 2).contiguous()
    ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, w8[i % 16], ones, torch.float32))
    lib_ms = library_ms(lambda i: torch._weight_int8pack_mm(x, w8t[i % 16], ones.to(bf)))
    bd = gemm_bound(64, 4096, 12288, scale=False, out_bytes=4)
    log(f"  w8a16 unit scales (mm8_pallas) B=64 D=4096 O=12288: kernel {ms:.4f} ms, "
        f"torch._weight_int8pack_mm {fmt_ms(lib_ms)}, bound {bd['bound_ms']:.5f} ms "
        f"({bd['bound_by']})")
    del w8, w8t
    err = 0.0
    for li in (0, 15):
        out = w8_gemm.int4_gemm(x, packed[li])
        ref = w8_gemm.int4_gemm_ref(x, packed[li])
        lo, hi = w8_gemm.unpack_int4(packed[li])
        xa = x.float().abs()
        absref = xa[:, :2048] @ lo.float().abs() + xa[:, 2048:] @ hi.float().abs()
        err = max(err, check_gemm(f"int4 B=64 layer={li}", out, ref, absref))
    ms = time_ms(lambda i: w8_gemm.int4_gemm(x, packed[i % 16]))
    plain_ms = time_ms(lambda i: w8_gemm.int4_gemm_ref(x, packed[i % 16]), n=8)
    bd = gemm_bound(64, 4096, 12288, w_bytes=0.5, scale=False, out_bytes=4)
    log(f"  int4 B=64 D=4096 O=12288: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    numbers["int4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **bd)
    reset_counts()
    walk = probe_int4.walk_p4(x, packed)
    launches = read_counts()
    rel = tune_mm8.rel_err(walk, probe_int4.walk_plain4(x, packed))
    if not rel < 1e-5:
        raise AssertionError(f"tools/probe_int4 int4 walk disagrees with plain: {rel}")
    log(f"  tools/probe_int4 walk_p4 (16 layers): {launches['int4']} launches, "
        f"max rel err vs plain {rel:.2e}")
    numbers["int4"]["launches"] = launches["int4"]
    del x, packed
    torch.cuda.empty_cache()

    # decode_attention_q8t: one call per layer of an 8B step, bf16 scales
    q, valid, kernels = decode_inputs(BS, seed=2)
    _, _, args, _, _ = kernels["decode_q8t_bf16"]
    reset_counts()
    for li in range(L8):
        decode_attn.decode_attention_q8t(*args(li), scale=HD8 ** -0.5, attend_len=256)
    numbers["q8t_launches"] = read_counts()["decode_q8t"]
    log(f"  decode_attention_q8t, one call per layer at B={BS}, attend 256: "
        f"{numbers['q8t_launches']} launches")
    del q, valid, kernels
    torch.cuda.empty_cache()
    return numbers


def phase_small_int8() -> None:
    """The small model (head dim 128) in bf16 with int8 weights, prefill
    logits on the card (the W8A16 kernel, flash) against the same model on
    the CPU (plain versions). Tolerance: both round to bf16 at the same
    points but sum in other orders, so values may differ by a few bf16 ulps
    that the layers carry on; on the CPU the same model with f32 against
    bf16 activations differs by 0.84% of the largest logit, correlation
    0.99997. Allow 2% of the largest logit and correlation >= 0.9999.

    Then int8 against bf16 weights, on the card and on the CPU, with the
    thresholds of ``tests/test_quant.py`` (argmax agreement > 0.95,
    correlation > 0.999), the agreement counted at the rows with a clear
    argmax (``logit_agreement``): with 152k random logits per row many rows
    are near-ties, and which of them flip depends on the summation order
    (all rows, text: 0.9494 on an NVIDIA H100 and 0.9448 on the CPU of the
    same machine, for the same model and inputs). All rows are logged."""
    cfg = SMALL_CFG
    cpu = demo_backend(cfg, seed=4, dtype=torch.bfloat16, device="cpu").engine
    cpu_bf16 = copy.deepcopy(cpu.params)
    bf16_params = copy.deepcopy(cpu.params).to(DEV)
    cpu.quantize()
    gpu_params = copy.deepcopy(cpu.params).to(DEV)
    if not is_quantized(gpu_params.backbone.layers.wq) or gpu_params.text_head.device.type != "cuda":
        raise AssertionError("small int8 model: weights did not move to the card quantized")
    rng = np.random.default_rng(0)
    B, T, S = 8, 60, 64  # ~420 real positions, so one argmax flip moves agreement 0.24%
    ids = torch.tensor(rng.integers(0, 1000, (B, T, cfg.channels)))
    ids[..., 1:] = torch.tensor(rng.integers(0, 1024, (B, T, cfg.n_vq)))
    valid = torch.zeros((B, S), dtype=torch.bool)
    for b, pad in enumerate(rng.integers(0, 16, B)):
        valid[b, pad:T] = True
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    outs = {}
    launches = w8_gemm.LAUNCHES_W8A16
    for key, dev, params in (("cpu", "cpu", cpu.params), ("card", DEV, gpu_params),
                             ("card bf16", DEV, bf16_params), ("cpu bf16", "cpu", cpu_bf16)):
        cache = qwen3.init_kv_cache(cfg.language_config, B, S, dtype=torch.bfloat16, device=dev)
        t, a, _ = delay_forward(params, cfg, ids.to(dev), positions=pos.to(dev),
                                kv_valid=valid.to(dev), cache=cache, cache_offset=0)
        outs[key] = (t.cpu(), a[..., :-1].cpu())
    if w8_gemm.LAUNCHES_W8A16 - launches < 7 * cfg.language_config.num_hidden_layers + 2:
        raise AssertionError("small int8 model: the card's forward did not go through W8A16")
    rows = valid[:, :T]
    # the JAX package's own check of int8 weights (tests/test_quant.py:36-41),
    # int8 against bf16 weights of this 2-layer model; argmax agreement
    # counted at the clear rows (``logit_agreement``), all rows logged
    for where, i8, b16 in (("card", "card", "card bf16"), ("CPU", "cpu", "cpu bf16")):
        stats = [logit_agreement(outs[i8][i][rows], outs[b16][i][rows]) for i in (0, 1)]
        if not (min(st[1] for st in stats) > 0.95 and stats[0][2] > 0.999):
            raise AssertionError(f"small model, int8 vs bf16 weights on the {where}: (agreement, "
                                 f"at clear rows, correlation) text {stats[0]}, audio {stats[1]}")
        log(f"  small model, int8 vs bf16 weights on the {where}: argmax agreement at all rows "
            f"text {stats[0][0]:.4f}, audio {stats[1][0]:.4f}; at clear rows {stats[0][1]:.4f}, "
            f"{stats[1][1]:.4f} (> 0.95); correlation text {stats[0][2]:.6f} (> 0.999), audio "
            f"{stats[1][2]:.6f}")
    for i, what in ((0, "text"), (1, "audio")):
        got, ref = outs["card"][i][rows], outs["cpu"][i][rows]
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        corr = float(np.corrcoef(got.flatten().numpy(), ref.flatten().numpy())[0, 1])
        if not (err <= 0.02 * top and corr >= 0.9999):
            raise AssertionError(f"small int8 model {what} logits, card vs CPU: max abs err "
                                 f"{err} of {top}, correlation {corr}")
        log(f"  small int8-weight bf16 model, {what} logits card (kernels) vs CPU (plain): "
            f"max_abs_err={err:.3e} of max {top:.3f} (tol 2%), correlation {corr:.6f} "
            f"(tol 0.9999)")


COUNTERS = {  # kernel name -> (module, attribute) of its launch count
    "flash": (flash, "LAUNCHES"),
    "decode": (decode_attn, "LAUNCHES"),
    "decode_q8": (decode_attn, "LAUNCHES_Q8"),
    "paged": (paged_attn, "LAUNCHES"),
    "paged_q8": (paged_attn, "LAUNCHES_Q8"),
    "decode_q8t": (decode_attn, "LAUNCHES_Q8T"),
    "w8a16": (w8_gemm, "LAUNCHES_W8A16"),
    "w8a8": (w8_gemm, "LAUNCHES_W8A8"),
    "int4": (w8_gemm, "LAUNCHES_INT4"),
}
# kernels no serving path runs, as in the JAX package: their launches come
# from phase 3's drive of the path that does run them (a tool's walk, or
# decode_attention_q8t once per layer)
OFF_PATH = ("decode_q8t", "w8a8", "int4")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def drive_solo(backend, label: str):
    """Three ``synthesize`` requests and one greedy batch-4 ``generate`` on
    ``backend`` at 8B width, with the launch counts set to 0 just before and
    read just after. Returns (counts, prefills, decode steps)."""
    cfg = backend.engine.config
    engine, proc = backend.engine, backend.processor
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
            raise AssertionError(f"{label} synthesize #{i}: bad waveform {wav.shape}")
        c = calls[-1]
        log(f"  {label} synthesize #{i}: prompt {c['prompt']} tokens, {c['frames']} frames, "
            f"wave {wav.size / sr:.2f} s at {sr} Hz, request {time.perf_counter() - t:.2f} s, "
            f"generate {c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s, "
            f"{c['wall_s'] / max(c['frames'] - 1, 1) * 1e3:.1f} ms/step)")

    batch = four_prompts(proc)
    out = engine.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=96,
                          text_temperature=0.0, audio_temperature=0.0)
    for start, grid in out:
        if grid.shape != (start + calls[-1]["frames"], cfg.channels) or grid.min() < 0:
            raise AssertionError(f"{label}: bad grid {grid.shape}")
    c = calls[-1]
    log(f"  {label} generate B=4 greedy: prompt {c['prompt']} tokens, {c['frames']} frames/row, "
        f"{c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s, "
        f"{c['wall_s'] / max(c['frames'] - 1, 1) * 1e3:.1f} ms/step)")
    torch.cuda.synchronize()
    counts = read_counts()
    del engine.generate  # back to the class's method
    prefills = len(calls)
    steps = sum(c["frames"] - 1 for c in calls)
    L = cfg.language_config.num_hidden_layers
    if counts["flash"] < L * prefills or counts["decode"] < L * steps:
        raise AssertionError(f"{label}: launch counts {counts} below {L} x {prefills} prefills / "
                             f"{L} x {steps} decode steps")
    log(f"  {label} launches: flash {counts['flash']} for {prefills} prefills (>= {L} each), "
        f"decode {counts['decode']} for {steps} decode steps (>= {L} each)")
    log(f"  {label} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, prefills, steps


def four_prompts(proc):
    prompts = ["Hi.", "A longer second prompt for the batch.", "Third.",
               "The fourth and longest prompt of this batch of four requests."]
    batch = proc([[proc.build_user_message(text=p)] for p in prompts], mode="generation")
    if batch["attention_mask"].all():
        raise AssertionError("expected left-padded prompts")
    return batch


def phase_main_path():
    cfg = delay_8b()
    t0 = time.perf_counter()
    backend = demo_backend(cfg, codec_1p6b(), seed=0, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    log(f"  init on card: delay_8b bf16 + codec_1p6b f32 in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counts, _, _ = drive_solo(backend, "bf16")
    return counts, backend


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


def phase_server(params, modes=SERVER_MODES, label: str = "", w8_per_pass: int = 0) -> dict:
    """``DelayBatchServer(slots=16, cache_len=1024, out_capacity=128,
    prompt_bucket=32, page_size=128)`` over phase 4's 8B weights, one cache
    mode at a time: 24 requests into 16 slots, sampled at text and audio
    temperature 1.7, audio top-p 0.8. With ``w8_per_pass`` (int8 weights)
    every prefill and decode step must also launch the W8A16 kernel at
    least that many times."""
    cfg = delay_8b()
    L = cfg.language_config.num_hidden_layers
    prompts, budgets = server_traffic(cfg)
    counts = {}
    for name, mode, kernel in modes:
        name = f"{label}{name}"
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
        if (mode_counts[kernel] < L * steps or mode_counts["flash"] < L * admissions
                or mode_counts["w8a16"] < w8_per_pass * (steps + admissions)):
            raise AssertionError(f"server {name}: launch counts {mode_counts} below {L} x "
                                 f"{steps} steps ({kernel}) / {L} x {admissions} prefills (flash)"
                                 f" / {w8_per_pass} x {steps + admissions} passes (w8a16)")
        frames = sum(min(c.steps, rids[c.request_id]) for c in done)
        kv_bytes = sum(t.numel() * t.element_size() for t in server.state.cache if t.ndim > 2)
        log(f"  server {name}: {len(done)} requests, {steps} steps, {frames} frames in "
            f"{wall:.2f} s = {frames / wall:.1f} frames/s ({wall / steps * 1e3:.1f} ms/step), "
            f"mean utilization {server.util_sum / steps:.3f}, "
            f"{server.total_preemptions} preemptions, KV cache {kv_bytes / 2**30:.3f} GiB, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(warmup {warm_s:.2f} s)")
        log(f"  server {name}: launches {kernel} {mode_counts[kernel]} (>= {L} x {steps}), "
            f"flash {mode_counts['flash']} (>= {L} x {admissions})"
            + (f", w8a16 {mode_counts['w8a16']} (>= {w8_per_pass} x {steps + admissions})"
               if w8_per_pass else ""))
        counts[name] = mode_counts
        del server, done
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


@contextlib.contextmanager
def plain_w8a16():
    """Within: every int8 dense layer and head computes through the W8A16
    kernel's plain version, on the card (the reference for phase 6)."""
    kernel = w8_gemm.w8a16_gemm
    w8_gemm.w8a16_gemm = w8_gemm.w8a16_gemm_ref
    try:
        yield
    finally:
        w8_gemm.w8a16_gemm = kernel


CLEAR = 0.1  # a clear argmax: top-1 above top-2 by this share of the row's logit std


def logit_agreement(got, ref):
    """(argmax agreement at all rows, at the rows where ``ref``'s argmax is
    clear, correlation) of two (..., V) logit tensors. With random weights
    many rows are near-ties that any rounding decides (the top two of 1025
    or 152k Gaussian logits lie ~0.2-0.3 std apart on average); a clear row
    has its top two ``CLEAR`` std apart."""
    got, ref = got.float(), ref.float()
    same = got.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > CLEAR * ref.std(dim=-1)
    corr = float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1])
    return float(same.float().mean()), float(same[clear].float().mean()), corr


def phase_int8(backend):
    """Phase 6 on phase 4's engine: the bf16 logits of one batch-4 prefill,
    ``engine.quantize()`` in place, and the int8 logits of the same prefill
    (kernels) held against the same int8 model through the plain versions
    and against the bf16 logits; then the solo requests and the server in
    two KV modes on the int8 weights. Every prefill and decode step runs 7
    W8A16 launches per layer plus one for the text head and one for the 32
    audio heads.

    The logit checks run at full width over the first 2 of the 36 layers
    (the depth of the JAX package's own check, ``tests/test_quant.py``):
    int8 against bf16 weights with its thresholds (argmax agreement > 0.95
    at all rows, as there, and at the rows with a clear argmax,
    ``logit_agreement``; correlation > 0.999), kernels against plain versions within argmax
    agreement > 0.99 there, correlation > 0.9999: summing in another order
    alone moves 2-layer logits by ~1e-5 of correlation at width 1024 on the
    CPU, more at 4096 (the first run here measured 0.99996, NVIDIA H100).
    Over all 36 layers of random
    weights a difference grows from layer to layer, whatever its source:
    the first runs of this phase measured, on an NVIDIA H100, int8 against
    bf16 argmax agreement 0.497 (text) / 0.844 (audio), correlation 0.9964,
    and the kernels against the plain versions (a bf16 rounding apart here
    and there) 0.848 / 0.940, correlation 0.99973. Those are logged, with
    only a text correlation > 0.99 required."""
    engine, proc = backend.engine, backend.processor
    cfg = engine.config
    per_pass = 7 * cfg.language_config.num_hidden_layers + 2
    cut = dataclasses.replace(cfg, language_config=dataclasses.replace(
        cfg.language_config, num_hidden_layers=2))
    batch = four_prompts(proc)
    ids = torch.as_tensor(batch["input_ids"], device=DEV)
    mask = torch.as_tensor(batch["attention_mask"], device=DEV)
    B, T, _ = ids.shape

    def prefill_logits(c):  # the model of config c: the first c's layers of the 36
        cache = qwen3.init_kv_cache(c.language_config, B, 256, dtype=torch.bfloat16, device=DEV)
        valid = torch.zeros((B, 256), dtype=torch.bool, device=DEV)
        valid[:, :T] = mask
        pos = torch.arange(T, dtype=torch.int32, device=DEV)[None].expand(B, T)
        t, a, _ = delay_forward(engine.params, c, ids, positions=pos, kv_valid=valid,
                                cache=cache, cache_offset=0)
        return t[mask], a[mask][..., :-1]  # real positions; the masked pad column dropped

    bf16 = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    bf16_bytes = param_bytes(engine.params)
    t0 = time.perf_counter()
    engine.quantize()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    int8_bytes = param_bytes(engine.params)
    log(f"  engine.quantize() in {quant_s:.2f} s: Delay parameters {bf16_bytes / 1e9:.2f} GB "
        f"(bf16) -> {int8_bytes / 1e9:.2f} GB (int8 matmul weights), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    reset_counts()
    kern = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    if read_counts()["w8a16"] < per_pass:
        raise AssertionError("int8 prefill did not go through the W8A16 kernel")
    with plain_w8a16():
        plain = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    n = int(mask.sum())
    for d in (2, 36):
        rows = {}
        for what, got, ref in (("int8 kernels vs plain versions", kern[d], plain[d]),
                               ("int8 (kernels) vs bf16", kern[d], bf16[d]),
                               ("int8 (plain versions) vs bf16", plain[d], bf16[d])):
            rows[what] = [logit_agreement(got[i], ref[i]) for i in (0, 1)]
            (at, ct, rt), (aa, ca, ra) = rows[what]
            log(f"  {what}, prefill logits over {d} layers (B={B}, T={T}, {n} positions): "
                f"argmax agreement text {at:.4f}, audio {aa:.4f}; at clear rows {ct:.4f}, "
                f"{ca:.4f}; correlation text {rt:.7f}, audio {ra:.7f}")
        k, b = rows["int8 kernels vs plain versions"], rows["int8 (kernels) vs bf16"]
        if d == 2 and not (min(k[0][1], k[1][1]) > 0.99 and k[0][2] > 0.9999):
            raise AssertionError(f"2 layers, int8 kernels vs plain versions: {rows}")
        if d == 2 and not (min(b[0][0], b[1][0], b[0][1], b[1][1]) > 0.95 and b[0][2] > 0.999):
            raise AssertionError(f"2 layers, int8 vs bf16 weights: {rows}")
        if not min(r[0][2] for r in rows.values()) > 0.99:
            raise AssertionError(f"{d} layers: a text correlation under 0.99: {rows}")
    log("  checked: 2 layers, kernels vs plain argmax at clear rows > 0.99, correlation > "
        "0.9999; int8 vs bf16 argmax at all and at clear rows > 0.95, correlation > 0.999; "
        "36 layers, text correlation > 0.99")
    del bf16, kern, plain
    torch.cuda.empty_cache()

    counts, prefills, steps = drive_solo(backend, "int8")
    if counts["w8a16"] < per_pass * (prefills + steps):
        raise AssertionError(f"int8 solo: {counts['w8a16']} W8A16 launches below {per_pass} x "
                             f"({prefills} prefills + {steps} decode steps)")
    log(f"  int8 launches: w8a16 {counts['w8a16']} (>= {per_pass} x ({prefills} prefills + "
        f"{steps} decode steps))")
    gc.collect()
    torch.cuda.empty_cache()
    server_counts = phase_server(engine.params, modes=(SERVER_MODES[0], SERVER_MODES[3]),
                                 label="int8 weights, ", w8_per_pass=per_pass)
    return counts, server_counts


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
    decode_attn._entry("mosstts_decode_attention_q8t", 1)
    w8_gemm._entry("mosstts_w8a16_gemm")
    w8_gemm._entry("mosstts_int4_gemm")
    w8_gemm._entry("mosstts_w8a8_gemm", 2)
    log(f"  {lib.relative_to(Path(__file__).resolve().parent)} in "
        f"{time.perf_counter() - t0:.2f} s")

    log("phase 3: kernels vs plain (bf16, main-path shapes) and a small f32 reference")
    numbers = phase_kernels()
    numbers.update(phase_kernels_server())
    # decode's line keeps its B=4 times (PR 1's shape) and the worse error of both shapes
    numbers["decode"]["max_abs_err"] = max(numbers["decode"]["max_abs_err"],
                                           numbers.pop("decode_b16")["max_abs_err"])
    # decode_attention_q8t's line: the bf16-scale times, the worse error of both scale types
    numbers["decode_q8t"] = numbers.pop("decode_q8t_bf16")
    numbers["decode_q8t"]["max_abs_err"] = max(numbers["decode_q8t"]["max_abs_err"],
                                               numbers.pop("decode_q8t_f32")["max_abs_err"])
    numbers.update(phase_kernels_gemm())
    phase_small_reference()
    phase_small_int8()
    log("phase 3b: small f32 continuous-batching server, card vs CPU and paged vs linear")
    phase_small_server()

    log("phase 4: solo path at MOSS-TTS 8B width")
    solo_counts, backend = phase_main_path()
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 5: continuous batching at MOSS-TTS 8B width")
    server_counts = phase_server(backend.engine.params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 6: int8 weights at MOSS-TTS 8B width")
    int8_counts, int8_server_counts = phase_int8(backend)

    runs = [solo_counts, int8_counts, *server_counts.values(), *int8_server_counts.values()]
    launches = {name: sum(c[name] for c in runs) for name in COUNTERS}
    if not all(launches[name] for name in COUNTERS if name not in OFF_PATH):
        raise AssertionError(f"a kernel was never launched on the main paths: {launches}")
    launches.update(decode_q8t=numbers.pop("q8t_launches"), w8a8=numbers["w8a8"].pop("launches"),
                    int4=numbers["int4"].pop("launches"))
    if not all(launches[name] for name in OFF_PATH):
        raise AssertionError(f"an off-path kernel was never launched on its path: {launches}")
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
        dict(name="decode_attention_q8t", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:414",
             launches=launches["decode_q8t"], **numbers["decode_q8t"]),
        dict(name="w8a16_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/tune_mm8.py:165", launches=launches["w8a16"], **numbers["w8a16"]),
        dict(name="w8a8_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/tune_mm8.py:85", launches=launches["w8a8"], **numbers["w8a8"]),
        dict(name="int4_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/probe_int4.py:102", launches=launches["int4"], **numbers["int4"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
