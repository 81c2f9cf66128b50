"""Inputs, bounds and timing shared by ``chip_smoke.py`` and the port's card
tools (``profile_decode``, ``tune_mm8``, ``probe_int4``).

``decode_inputs(B)`` makes, on the card, a bf16 (L=36, B, KV=8, S=1024,
hd=128) K/V cache of random values with about 70% of the slots valid, its
int8 form (the port's cache quantizer, scales also in bf16 for
``decode_attention_q8t``) and both laid into a page pool of 128-slot pages
under a shuffled table in which row b leaves its last ``b % 4`` logical
pages unallocated: they ride the trash page 0, which holds a large poison
value that ``kv_valid`` masks. ``bound``, ``decode_bound`` and
``gemm_bound`` give the least time the card could take for a call, from the
published peaks of an NVIDIA H100 SXM; ``time_ms`` a call's device time from
CUDA-graph replays.
"""
from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from ..nn.qwen3 import _quantize_kv_block
from ..ops.kernels import decode_attn, paged_attn

L, KV, H, HD, S, P = 36, 8, 32, 128, 1024, 128  # 8B layers and heads; capacity, page
# NVIDIA H100 SXM data sheet, at 700 W: HBM bytes per second and dense
# tensor-core operations per second by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
POISON = 1e4  # the trash page's values and scales (int8 values: 127)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound(nbytes: float, nops: float, dtype) -> dict:
    """The least time in ms the card could take: the larger of the bytes
    over HBM bandwidth and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def gemm_bound(M: int, K: int, N: int, *, count: int = 1, w_bytes: float = 1.0,
               out_bytes: int = 2, scale: bool = True, ops_dtype=torch.bfloat16) -> dict:
    """Bound of one int8-weight GEMM call: bf16 x (M, K) read once, the
    ``count`` (K, N) weights (``w_bytes`` per value: 1 for int8, 0.5 for
    packed int4) and, with ``scale``, their f32 scales read once, the
    (M, count * N) output written once; 2 * M * K * N * count operations at
    the peak of ``ops_dtype``."""
    nbytes = (M * K * 2 + count * K * N * w_bytes + (count * N * 4 if scale else 0)
              + M * count * N * out_bytes)
    return bound(nbytes, 2.0 * M * K * N * count, ops_dtype)


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


def decode_bound(q, kv_valid, attend: int, kv_heads: int, row_bytes: float,
                 extra_bytes: float = 0.0) -> dict:
    """Bound of one decode-attention call: each valid attended slot's K and V
    rows (``row_bytes`` each per KV head, scales included) read once, q and
    kv_valid read and the output written once, plus ``extra_bytes`` (a page
    table); 4 * hd operations per query head and valid slot (q.k and p.v)."""
    B, Hq, hd = q.shape
    n_valid = float(kv_valid[:, :attend].sum())
    nbytes = (2 * n_valid * kv_heads * row_bytes + 2 * q.numel() * q.element_size()
              + B * attend + extra_bytes)
    return bound(nbytes, 4 * hd * Hq * n_valid, q.dtype)


def decode_inputs(B: int, seed: int = 1):
    """(q, kv_valid, kernels) for a batch of ``B`` rows on the card.
    ``kernels`` maps each decode kernel's short name to (wrapper, plain
    version, args(layer) -> the positional arguments of both, K/V bytes per
    slot and KV head, other bytes the call reads)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (L, B, KV, S, HD)
    kc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    (kq, ks), (vq, vs) = (_quantize_kv_block(x.view(L * B, KV, S, HD)) for x in (kc, vc))
    kq, vq, ks, vs = kq.view(shape), vq.view(shape), ks.view(shape[:4]), vs.view(shape[:4])
    q = torch.randn((B, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    valid = torch.rand((B, S), generator=g, device="cuda") < 0.7
    valid[:, 0] = True

    mp = S // P
    num_pages = 1 + B * mp
    table = torch.tensor(np.random.default_rng(seed).permutation(np.arange(1, num_pages))
                         .reshape(B, mp), dtype=torch.int32, device="cuda")
    for b in range(B):
        n_free = b % 4
        if n_free:
            table[b, mp - n_free:] = 0
            valid[b, (mp - n_free) * P:] = False
    kp, vp = (paged_attn.scatter_pages(x, table, num_pages, POISON) for x in (kc, vc))
    kqp, vqp = (paged_attn.scatter_pages(x, table, num_pages, 127) for x in (kq, vq))
    ksp, vsp = (paged_attn.scatter_pages(x, table, num_pages, POISON) for x in (ks, vs))
    table_bytes = table.numel() * 4
    ksb, vsb = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    kernels = {
        "decode": (decode_attn.decode_attention, decode_attn.decode_attention_ref,
                   lambda li: (q, kc, vc, valid, li), HD * 2, 0.0),
        "decode_q8": (decode_attn.decode_attention_q8, decode_attn.decode_attention_q8_ref,
                      lambda li: (q, kq, ks, vq, vs, valid, li), HD + 4, 0.0),
        "decode_q8t_bf16": (decode_attn.decode_attention_q8t, decode_attn.decode_attention_q8t_ref,
                            lambda li: (q, kq, ksb, vq, vsb, valid, li), HD + 2, 0.0),
        "decode_q8t_f32": (decode_attn.decode_attention_q8t, decode_attn.decode_attention_q8t_ref,
                           lambda li: (q, kq, ks, vq, vs, valid, li), HD + 4, 0.0),
        "paged": (paged_attn.paged_decode_attention, paged_attn.paged_decode_attention_ref,
                  lambda li: (q, kp, vp, table, valid, li), HD * 2, table_bytes),
        "paged_q8": (paged_attn.paged_decode_attention_q8,
                     paged_attn.paged_decode_attention_q8_ref,
                     lambda li: (q, kqp, ksp, vqp, vsp, table, valid, li), HD + 4, table_bytes),
    }
    return q, valid, kernels
